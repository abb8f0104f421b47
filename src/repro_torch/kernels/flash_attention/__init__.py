"""Flash-attention Hopper kernels (replace the Pallas
``repro.kernels.flash_attention``): tensor-core prefill, split-K decode,
the paged split-K kernel of the continuous-batching engine and the fp32
CUDA-core kernel, one wrapper; the forward with its log-sum-exp,
the FlashAttention-2 backward and the autograd Function of the two."""

from repro_torch.kernels.flash_attention.kernel import (
    FlashAttentionFn,
    attention_plain,
    attention_plain_lse,
    decode_partials,
    decode_partials_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_on,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    merge_partials_plain,
    paged_attention,
    paged_attention_plain,
    paged_body,
    paged_route,
    padded_head_dim,
    plan_decode_splits,
    plan_paged_splits,
    route,
)

__all__ = ["flash_attention", "attention_plain", "route", "plan_decode_splits",
           "decode_partials", "decode_partials_plain", "merge_partials_plain",
           "attention_plain_lse", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_on", "flash_attention_bwd_plain", "FlashAttentionFn",
           "paged_attention", "paged_attention_plain", "paged_route", "paged_body",
           "plan_paged_splits", "padded_head_dim"]
