"""RG-LRU scan: the Hopper kernel's wrapper and its plain PyTorch version.

The CUDA kernel is ``kernels/csrc/rglru.cu`` (see the note there: which
TPU kernel it replaces, what bounds it, what the design does about it).
:func:`rglru` launches it for CUDA tensors and uses :func:`rglru_plain` for
CPU tensors; there is no other route and no fall-back when a build or
launch fails.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as K

_DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel since the last reset (plain integer).
launches = 0


def rglru_plain(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over dim 1 with an fp32 carry, in the
    Pallas kernel's order (``repro/kernels/rglru/kernel.py``); ``h_{-1}`` is
    ``h0`` or 0.  a, b [B, T, C] -> h [B, T, C] in ``a.dtype``."""
    h = (torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(a.dtype)
    return out


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru: want a, b [B, T, C] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru takes one of {_DTYPES} for a and b; got {a.dtype}, {b.dtype}")
    if h0 is not None:
        if h0.shape != (a.shape[0], a.shape[2]):
            raise ValueError(f"rglru: h0 {tuple(h0.shape)} is not [B, C] = "
                             f"{(a.shape[0], a.shape[2])}")
        if h0.dtype != torch.float32:
            raise TypeError(f"rglru: h0 must be float32, got {h0.dtype}")
    if not (a.device == b.device and (h0 is None or h0.device == a.device)):
        raise ValueError("rglru: a, b and h0 on different devices")


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """The RG-LRU recurrence over a sequence, any T and C.  With ``h0=None``
    it is the Pallas kernel's function; with T = 1 and the cached state as
    ``h0`` it is the decode step ``a * h_prev + b``.  The final state is
    ``h[:, -1]``."""
    global launches
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("rglru: a, b and h0 must be contiguous")
    bsz, t, c = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    err = K.library().rglru_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(), h.data_ptr(),
        bsz, t, c, int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    K.check(err, "rglru")
    launches += 1
    return h
