"""RG-LRU scan Hopper kernel (replaces the Pallas ``repro.kernels.rglru``)."""

from repro_torch.kernels.rglru.kernel import rglru, rglru_plain

__all__ = ["rglru", "rglru_plain"]
