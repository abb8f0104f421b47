"""RG-LRU scan Hopper kernel (replaces the Pallas ``repro.kernels.rglru``),
its backward and the autograd Functions of the two."""

from repro_torch.kernels.rglru.kernel import (RgLruFn, RgLruGatedFn, plan_bwd_chunks,
                                              plan_scan_chunks, rglru, rglru_bwd,
                                              rglru_bwd_plain, rglru_chunk_starts_plain,
                                              rglru_chunked_plain, rglru_coeffs_plain,
                                              rglru_gated, rglru_gated_bwd,
                                              rglru_gated_bwd_plain, rglru_gated_plain,
                                              rglru_gated_starts_plain, rglru_gated_with_starts,
                                              rglru_plain, rglru_with_starts)

__all__ = ["RgLruFn", "RgLruGatedFn", "plan_bwd_chunks", "plan_scan_chunks", "rglru",
           "rglru_bwd", "rglru_bwd_plain", "rglru_chunk_starts_plain", "rglru_chunked_plain",
           "rglru_coeffs_plain", "rglru_gated", "rglru_gated_bwd", "rglru_gated_bwd_plain",
           "rglru_gated_plain", "rglru_gated_starts_plain", "rglru_gated_with_starts",
           "rglru_plain", "rglru_with_starts"]
