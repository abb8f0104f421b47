"""RMSNorm: the Hopper kernel's wrapper and its plain PyTorch version.

The CUDA kernel is ``kernels/csrc/rmsnorm.cu`` (see the note there: which
TPU kernel it replaces, what bounds it, what the design does about it).
:func:`rmsnorm` launches it for a CUDA tensor and uses
:func:`rms_norm_plain` for a CPU tensor; there is no other route and no
fall-back when a build or launch fails.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as K

EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROW_BYTES = 48 * 1024  # the row is staged in static-limit shared memory

# Launches of the CUDA kernel since the last reset (plain integer).
launches = 0


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = EPS) -> torch.Tensor:
    """The fp32 math of ``repro/models/layers.py::rms_norm``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes fp32/bf16, got x {x.dtype}, scale {scale.dtype}")
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not match "
                         f"x {tuple(x.shape)} on the last dim")
    if x.device != scale.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """``y = x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim,
    any leading shape, output in ``x.dtype``."""
    global launches
    _check(x, scale)
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    d = x.shape[-1]
    if d * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"rmsnorm: row of {d} x {x.dtype} exceeds {MAX_ROW_BYTES} bytes")
    y = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n == 0:
        return y
    err = K.library().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n, d, float(eps),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    K.check(err, "rmsnorm")
    launches += 1
    return y
