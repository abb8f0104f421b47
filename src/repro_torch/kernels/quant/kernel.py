"""The blockwise int8 quantizer: the Hopper kernels' wrappers and their
plain PyTorch versions.

The CUDA kernels are ``kernels/csrc/quant.cu``; its note says why they
exist (no TPU kernel: the reference's jnp ``quantize_flat`` /
``dequantize_flat``, which XLA fuses into one pass each), what bounds them
and what the design does about it.  :func:`quantize` and
:func:`dequantize` launch them for CUDA tensors and use
:func:`quantize_plain` and :func:`dequantize_plain` for CPU tensors; there
is no other route and no fall-back when a build or launch fails.

A row ``[..., L]`` is cut into blocks of ``BLOCK`` = 128 values (the last
one short when L is not a multiple); each block is stored as int8 values
and one fp32 scale, ``absmax / 127`` (1 for an all-zero block).  Nearest
rounding is half to even.  Stochastic rounding is
``q = floor(v) + (u < v - floor(v))``, exact in fp32 (the subtraction is
exact), so a value on the grid comes back unchanged and P(round up) is the
fraction.  ``u`` is a counter-based dither, ``(hash32(i) >> 8) * 2^-24``
of the value's flat index ``i`` in the call (plus ``offset``), keyed by a
:class:`Dither`: the plain version and the kernel compute it with the same
32-bit integer operations, so they agree bitwise in both modes.  The hash
is two rounds of :func:`mix32`, the first keyed by the key's low word
(xored with ``mix32`` of the step scalar when that is a device tensor),
the second by its high word.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.kernels import build as K

BLOCK = 128
_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x21F0AAAD, 0x735A2D97   # both < 2^31: products fit int64
_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256            # 8 warps; quantize: a warp a block of 128 values
BLOCKS_PER_SM = 16

# Launches of the CUDA kernels since the last reset (plain integers), and
# quantize's by rounding mode.
launches_quantize = 0
launches_dequantize = 0
launches_quantize_by_mode = {"nearest": 0, "stochastic": 0}


@dataclasses.dataclass(frozen=True)
class Dither:
    """The stochastic-rounding key: a 64-bit host integer and, where the
    step component lives on the device (a payload's fingerprint), an int32
    0-dim tensor on the data's device that the kernel reads itself, so
    nothing waits for it on the host."""

    key: int
    step: Union[torch.Tensor, None] = None


def n_blocks(length: int) -> int:
    """Scale entries for a row of ``length`` values (ragged-aware)."""
    return -(-length // BLOCK)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit bijective integer mix on int64 tensors holding values in
    ``[0, 2^32)`` (products stay below 2^63): the CUDA ``mix32``."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _M32
    return x ^ (x >> 15)


def dither_u(dither: Dither, index: torch.Tensor) -> torch.Tensor:
    """The dither ``u`` in ``[0, 1)`` at flat indices ``index`` (int64,
    ``[0, 2^32)``), fp32.  The key's low word is xored with the mixed step
    scalar when there is one (an int64 0-dim tensor then)."""
    lo = dither.key & _M32
    if dither.step is not None:
        lo = mix32(dither.step.to(torch.int64) & _M32) ^ lo
    h = mix32(mix32(index ^ lo) ^ ((dither.key >> 32) & _M32))
    return (h >> 8).to(torch.float32) * 2.0 ** -24


def _blocks(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``[R, L]`` fp32 -> ``[R, nb, BLOCK]``, zero-padded."""
    pad = nb * BLOCK - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[0], nb, BLOCK)


def quantize_plain(x: torch.Tensor, dither: Dither | None = None, *,
                   offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., L]`` fp32 / bf16 -> ``(q int8 [..., L], scale fp32 [...,
    ceil(L / 128)])``: nearest rounding, or stochastic with ``dither``."""
    *lead, L = x.shape
    nb = n_blocks(L)
    rows = x.reshape(-1, L).float()
    blocks = _blocks(rows, nb)
    absmax = torch.amax(blocks.abs(), dim=-1)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    v = blocks / scale[..., None]
    if dither is None:
        q = torch.round(v)
    else:
        r = torch.arange(rows.shape[0], dtype=torch.int64, device=x.device)[:, None]
        col = torch.arange(nb * BLOCK, dtype=torch.int64, device=x.device)
        index = ((offset + r * L + col) & _M32).reshape(-1, nb, BLOCK)
        f = torch.floor(v)
        q = f + (dither_u(dither, index) < v - f).to(torch.float32)
    q = torch.clamp(q, -127, 127).to(torch.int8).reshape(-1, nb * BLOCK)[:, :L]
    return q.reshape(*lead, L), scale.reshape(*lead, nb)


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                     *, chunks: int = 1) -> torch.Tensor:
    """``q · scale`` rounded to ``dtype``.  With ``chunks`` = k > 1, ``q``
    is ``[k, ..., L]`` and the result the fp32 sum of the k dequantized
    chunks in chunk order: ``q0 · s0``, then ``fma(qc, sc, acc)`` (the
    product exact in fp64, the sum rounded once to fp32), as the
    reference's fused reduction rounds on the CPU."""
    *lead, L = q.shape
    nb = scale.shape[-1]

    def product(q_, s_, dt):
        x = _blocks(q_.reshape(-1, L).to(dt), nb) * s_.reshape(-1, nb, 1).to(dt)
        return x.reshape(-1, nb * BLOCK)[:, :L].reshape(*q_.shape)

    if chunks == 1:
        return product(q, scale, torch.float32).to(dtype)
    acc = product(q[0], scale[0], torch.float32)
    for c in range(1, chunks):
        acc = (acc.double() + product(q[c], scale[c], torch.float64)).float()
    return acc


def _check_quantize(x: torch.Tensor, dither: Dither | None, offset: int) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize takes fp32/bf16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"quantize: no rows in {tuple(x.shape)}")
    if offset < 0 or offset + x.numel() > 2 ** 32:
        raise ValueError(f"quantize: indices {offset} + {x.numel()} pass 2^32")
    if dither is not None and dither.step is not None and (
            dither.step.dtype != torch.int32 or dither.step.numel() != 1
            or dither.step.device != x.device):
        raise ValueError("quantize: the dither's step must be one int32 on the data's device")


def _blocks_for(work: int, device: torch.device) -> int:
    return max(1, min(-(-work // THREADS), K.sm_count(device.index) * BLOCKS_PER_SM))


def quantize(x: torch.Tensor, dither: Dither | None = None, *,
             offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_plain`'s function: the kernel on a CUDA tensor."""
    global launches_quantize
    _check_quantize(x, dither, offset)
    if x.device.type == "cpu":
        return quantize_plain(x, dither, offset=offset)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    x = x.contiguous()
    *lead, L = x.shape
    nb = n_blocks(L)
    rows = x.numel() // L
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*lead, nb), dtype=torch.float32, device=x.device)
    vec = int(L % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
              and q.data_ptr() % 4 == 0)
    step = 0 if dither is None or dither.step is None else dither.step.data_ptr()
    key = 0 if dither is None else dither.key
    err = K.library().quantize_launch(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, L, nb,
        int(x.dtype == torch.bfloat16), int(dither is not None), key & _M32,
        (key >> 32) & _M32, step, offset, vec, _blocks_for(rows * nb * 32, x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    K.check(err, "quantize")
    launches_quantize += 1
    launches_quantize_by_mode["nearest" if dither is None else "stochastic"] += 1
    if K.LISTENERS:
        K.report("quantize", K.tensor_bytes(x, q, s))
    return q, s


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
               *, chunks: int = 1) -> torch.Tensor:
    """:func:`dequantize_plain`'s function: the kernel on a CUDA tensor.
    ``chunks`` > 1 gives the fp32 sum of ``q``'s first-dim chunks."""
    global launches_dequantize
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"dequantize takes int8 values and fp32 scales, got {q.dtype}, "
                        f"{scale.dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"dequantize writes fp32/bf16, got {dtype}")
    *lead, L = q.shape
    if tuple(scale.shape) != (*lead, n_blocks(L)):
        raise ValueError(f"dequantize: scales {tuple(scale.shape)} do not match values "
                         f"{tuple(q.shape)}")
    if chunks < 1 or (chunks > 1 and (not lead or lead[0] != chunks or dtype != torch.float32)):
        raise ValueError(f"dequantize: {chunks} chunks of {tuple(q.shape)} to {dtype}")
    if q.device != scale.device:
        raise ValueError(f"dequantize: values on {q.device}, scales on {scale.device}")
    if q.device.type == "cpu":
        return dequantize_plain(q, scale, dtype, chunks=chunks)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {q.device}")
    q, scale = q.contiguous(), scale.contiguous()
    out = torch.empty(q.shape[1:] if chunks > 1 else q.shape, dtype=dtype, device=q.device)
    rows = out.numel() // L
    vec = int(L % 4 == 0 and q.data_ptr() % 4 == 0
              and out.data_ptr() % (4 * out.element_size()) == 0)
    err = K.library().dequantize_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, L, n_blocks(L), chunks,
        int(dtype == torch.bfloat16), vec, _blocks_for(rows * -(-L // 4), q.device),
        torch.cuda.current_stream(q.device).cuda_stream)
    K.check(err, "dequantize")
    launches_dequantize += 1
    if K.LISTENERS:
        K.report("dequantize", K.tensor_bytes(q, scale, out))
    return out
