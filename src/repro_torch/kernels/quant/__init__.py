"""The blockwise int8 quantizer as Hopper kernels (no TPU kernel: the
reference's jnp ``repro/core/quant.py``, which XLA fuses)."""

from repro_torch.kernels.quant.kernel import (
    BLOCK,
    Dither,
    dequantize,
    dequantize_plain,
    n_blocks,
    quantize,
    quantize_plain,
)

__all__ = ["BLOCK", "Dither", "n_blocks", "quantize", "quantize_plain", "dequantize",
           "dequantize_plain"]
