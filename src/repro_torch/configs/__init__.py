"""Config registry of the port: only the configs whose family the port
builds (the dense family: ``llama3.2-1b``; griffin: ``recurrentgemma-2b``)."""

from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B

ASSIGNED = (LLAMA3_2_1B, RECURRENTGEMMA_2B)

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in ASSIGNED}


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key in REGISTRY:
        return REGISTRY[key]
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; the port builds: {sorted(REGISTRY)}")


__all__ = ["ArchConfig", "smoke_variant", "get_config", "REGISTRY", "ASSIGNED"]
