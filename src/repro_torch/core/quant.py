"""Int8 blockwise quantization (the port of ``repro/core/quant.py``): the
building blocks of the int8 wires (``core/comm.py``,
``core/collectives.py``).

* **qwZ** (weights): the int8 gather wire quantizes each fp32 shard with
  nearest rounding, gathers the int8 values and fp32 block scales and
  dequantizes to the compute dtype; :func:`quantize_state` is the
  deployment-time conversion to stored ``{'q', 's'}`` serving weights.
* **qgZ** (gradients): the staged int8 reduce-scatter of hop 1 and the
  int8 hop-2 all-reduce quantize each stage's fp32 partial sums with
  stochastic rounding, unbiased in expectation.

A buffer ``[..., L]`` is stored as int8 ``[..., L]`` and fp32 scales
``[..., ceil(L / 128)]``, one absmax / 127 a block of 128 values; the last
block of a row may be short (quantized against its own absmax).  Both
functions run the hand-written kernels for a CUDA tensor and their plain
versions for a CPU one (``kernels/quant/kernel.py``).

Stochastic rounding differs from the reference's in two ways, both on
purpose.  The reference draws ``u`` from ``jax.random`` (threefry, which
the port does not reproduce) and rounds ``floor(v + u)`` in fp32, which
for |v| >= 64 rounds ``v + u`` up to ``v + 1`` for the largest draws, so a
value on the grid does not always come back (ROADMAP Queue 3).  The port
rounds ``floor(v) + (u < v - floor(v))``, exact in fp32, with ``u`` a
counter-based hash of the value's index under a 64-bit key
(:func:`dither_key`) that folds in the same components as the reference's
``_dither_key``: a fixed constant, the payload's salt, the stage, the
global rank and the step component.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant import BLOCK, Dither, dequantize, n_blocks, quantize

__all__ = ["BLOCK", "Dither", "n_blocks", "dither_key", "quantize_flat", "dequantize_flat",
           "quantize_state"]

QGZ_SEED = 0x9F2C             # the reference's ``_QGZ_SEED``
_M64 = (1 << 64) - 1


def _fold(key: int, value: int) -> int:
    """splitmix64 of ``key`` xor ``value`` (host integers, 64 bits)."""
    z = ((key ^ (value & _M64)) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def dither_key(salt: int, stage: int, rank: int, step: int | torch.Tensor) -> Dither:
    """The dither of one quantize: ``QGZ_SEED`` folded with ``salt`` (the
    payload: a pool or bucket index), ``stage`` (the exchange's place in its
    collective), the global ``rank`` and the step component, a host int
    (the training step) or an int32 0-dim device tensor (a payload's
    fingerprint, read by the kernel)."""
    key = QGZ_SEED
    for v in (salt, stage, rank):
        key = _fold(key, v)
    if isinstance(step, torch.Tensor):
        return Dither(key, step)
    return Dither(_fold(key, step))


def quantize_flat(flat: torch.Tensor, *, key: Dither | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flat [..., L]`` -> ``(int8 [..., L], fp32 [..., ceil(L/128)])``:
    nearest rounding (half to even) with ``key=None`` (the qwZ weight
    wire), else stochastic rounding under ``key`` (the gradient wires)."""
    return quantize(flat, key)


def dequantize_flat(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_flat` (ragged tails follow the scale count)."""
    return dequantize(q, scale, dtype)


def quantize_state(params: dict[str, torch.Tensor]) -> dict[str, dict]:
    """fp32 flat pools -> ``{'q': int8, 's': fp32}`` per pool, nearest
    rounding: the stored serving weights (``quant_gather=True``)."""
    out = {}
    for name, flat in params.items():
        q, s = quantize_flat(flat)
        out[name] = {"q": q, "s": s}
    return out
