"""Flash-attention Hopper kernel (replaces the Pallas
``repro.kernels.flash_attention``)."""

from repro_torch.kernels.flash_attention.kernel import attention_plain, flash_attention

__all__ = ["flash_attention", "attention_plain"]
