"""Config registry of the port: the reference's ten assigned architectures
and the paper's own workloads (``bert_paper.PAPER_CONFIGS``: bert-10b ...
gpt2-20b, LayerNorm + GeLU dense decoders), as ``repro/configs/__init__.py``
registers them, and the dry run's cells (``SHAPES`` x ``ASSIGNED``,
``cells``), copied from ``repro/configs/__init__.py:43-59``."""

from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.configs.bert_paper import PAPER_CONFIGS
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA3_2_1B
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as LLAMA_3_2_VISION_90B
from repro_torch.configs.qwen1_5_110b import CONFIG as QWEN1_5_110B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM_125M
from repro_torch.configs.yi_9b import CONFIG as YI_9B

ASSIGNED = (RECURRENTGEMMA_2B, LLAMA_3_2_VISION_90B, QWEN1_5_110B, GRANITE_8B, LLAMA3_2_1B,
            YI_9B, WHISPER_LARGE_V3, XLSTM_125M, DEEPSEEK_MOE_16B, DBRX_132B)

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in ASSIGNED}
REGISTRY.update(PAPER_CONFIGS)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key in REGISTRY:
        return REGISTRY[key]
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


# -- shapes (assignment): seq_len x global_batch -----------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}


def cells(include_skips: bool = False):
    """All (arch, shape) assignment cells; long_500k only for sub-quadratic
    archs unless include_skips (the skip itself is recorded in EXPERIMENTS)."""
    for cfg in ASSIGNED:
        for shape_name, spec in SHAPES.items():
            skip = shape_name == "long_500k" and not cfg.sub_quadratic
            if skip and not include_skips:
                continue
            yield cfg, shape_name, spec, skip


__all__ = ["ArchConfig", "smoke_variant", "get_config", "REGISTRY", "ASSIGNED", "SHAPES",
           "cells"]
