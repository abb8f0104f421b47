"""Flash-attention Hopper kernels (replace the Pallas
``repro.kernels.flash_attention``): tensor-core prefill, split-K decode and
the fp32 CUDA-core kernel, one wrapper."""

from repro_torch.kernels.flash_attention.kernel import (
    attention_plain,
    decode_partials,
    decode_partials_plain,
    flash_attention,
    merge_partials_plain,
    plan_decode_splits,
    route,
)

__all__ = ["flash_attention", "attention_plain", "route", "plan_decode_splits",
           "decode_partials", "decode_partials_plain", "merge_partials_plain"]
