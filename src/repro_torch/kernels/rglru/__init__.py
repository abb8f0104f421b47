"""RG-LRU scan Hopper kernel (replaces the Pallas ``repro.kernels.rglru``)."""

from repro_torch.kernels.rglru.kernel import (plan_scan_chunks, rglru, rglru_chunked_plain,
                                              rglru_coeffs_plain, rglru_gated,
                                              rglru_gated_plain, rglru_plain)

__all__ = ["plan_scan_chunks", "rglru", "rglru_chunked_plain", "rglru_coeffs_plain",
           "rglru_gated", "rglru_gated_plain", "rglru_plain"]
