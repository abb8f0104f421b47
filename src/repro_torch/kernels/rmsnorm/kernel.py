"""RMSNorm: the Hopper kernels' wrappers, their plain PyTorch versions and
the autograd Function that joins them.

The CUDA kernels are ``kernels/csrc/rmsnorm.cu`` (forward) and
``kernels/csrc/rmsnorm_bwd.cu`` (its gradient, two routes chosen by
:func:`bwd_route`); the note at the top of each
says which TPU kernel it replaces or differentiates, what bounds it, and
what the design does about it.  :func:`rmsnorm` and :func:`rmsnorm_bwd`
launch them for CUDA tensors and use :func:`rms_norm_plain` and
:func:`rms_norm_bwd_plain` for CPU tensors; there is no other route and no
fall-back when a build or launch fails.  :class:`RmsNormFn` is the
autograd Function of the training path: its forward is :func:`rmsnorm`,
its backward :func:`rmsnorm_bwd`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build as K

EPS = 1e-6
_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 128             # a block: 4 warps, or one row of more lanes
MAX_LANES = 256           # a row across at most 8 warps
VECS_PER_LANE = (1, 2, 4, 8, 10, 16)   # the kernel's instantiations
REG_BUDGET = 192          # 32-bit words a lane for its row and its 1 + scale

# The backward's routes (kernels/csrc/rmsnorm_bwd.cu), chosen by
# :func:`bwd_route`: "regs" holds a bf16 row in registers and reads it once,
# "smem" takes every other shape.
BWD_ROUTES = ("regs", "smem")
BWD_REGS_D_STEP = 256     # "regs": d a multiple of 256 (8 bf16 a lane a vector) ...
BWD_REGS_MAX_D = 2048     # ... up to 8 vectors a lane (registers)

# Launches of the CUDA kernels since the last reset (plain integers):
# the forward, and the backward (one a call: its row pass and its fold), in
# all and by route.
launches = 0
launches_bwd = 0
launches_bwd_by_route = dict.fromkeys(BWD_ROUTES, 0)
BWD_WARPS = 4             # rows a block of the backward, one warp each
BWD_BLOCKS_PER_SM = 4
BWD_MAX_SMEM = 227 * 1024  # bytes of shared memory a block may ask for


class RmsPlan(NamedTuple):
    lanes: int            # lanes that hold a row (more than 32: several warps)
    vecs_per_lane: int    # 16-byte vectors of the row each lane holds
    rows_per_block: int   # max(THREADS, lanes) / lanes


def plan_rmsnorm(n: int, d: int, dtype: torch.dtype, *, sms: int = 132) -> RmsPlan:
    """Lanes per row, vectors per lane and rows per block of the kernel for
    ``n`` rows of ``d`` elements of ``dtype``.  A row of at least 32 vectors
    (16 bytes each) takes a whole warp, a shorter one the fewest lanes (a
    power of two) that give each lane one vector.  With fewer rows than
    ``sms`` (decode) a row spreads over up to ``MAX_LANES`` lanes at one
    vector a lane instead, so each lane's serial share is short; at any
    ``n`` a row whose share would not fit a lane's registers
    (``REG_BUDGET``) spreads over more warps until it does.  The rows of a
    block's groups cover the ``n`` rows with the grid striding over them.
    Raises for a ``d`` that does not fit ``MAX_LANES`` lanes."""
    if dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes fp32/bf16, got {dtype}")
    if n < 0 or d < 1:
        raise ValueError(f"rmsnorm: no plan for {n} rows of {d}")
    per_vec = 16 // (torch.finfo(dtype).bits // 8)
    nvec = -(-d // per_vec)
    fits = [v for v in VECS_PER_LANE if v * (4 + per_vec) <= REG_BUDGET]
    lanes = min(MAX_LANES if n < sms else 32, 1 << (nvec - 1).bit_length())
    while -(-nvec // lanes) > fits[-1] and lanes < MAX_LANES:
        lanes *= 2
    need = -(-nvec // lanes)
    vpl = next((v for v in fits if v >= need), None)
    if vpl is None:
        raise ValueError(f"rmsnorm: a row of {d} x {dtype} does not fit the kernel's "
                         f"registers ({need} vectors a lane over {lanes} lanes)")
    return RmsPlan(lanes, vpl, max(THREADS, lanes) // lanes)


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
    n = x.numel() // d if d else 0
    y = torch.empty_like(x)
    if n == 0:
        return y
    sms = K.sm_count(x.get_device())
    plan = plan_rmsnorm(n, d, x.dtype, sms=sms)
    err = K.library().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n, d, float(eps),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        plan.lanes.bit_length() - 1, plan.vecs_per_lane, sms,
        torch.cuda.current_stream(x.device).cuda_stream)
    K.check(err, "rmsnorm")
    launches += 1
    if K.LISTENERS:
        K.report("rmsnorm", K.tensor_bytes(x, scale, y))
    return y


def rms_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                       eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """The vjp of :func:`rms_norm_plain` (of ``repro/models/layers.py::rms_norm``)
    at ``dy``, in fp32: with ``r = rsqrt(mean(x^2) + eps)``, ``s' = 1 + scale``
    and ``g = dy``, ``dx = r * (s' g - x r^2 mean(s' g x))`` in ``x.dtype`` and
    ``dscale = sum over rows of g * (x r)`` in ``scale.dtype``."""
    d = x.shape[-1]
    xf, g = x.float(), dy.float()
    sp = 1.0 + scale.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    sg = sp * g
    c = torch.mean(sg * xf, dim=-1, keepdim=True)
    dx = r * (sg - xf * (c * (r * r)))
    dscale = (g * (xf * r)).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def plan_rmsnorm_bwd(n: int, *, sms: int = 132) -> int:
    """Blocks of the backward's row pass: ``BWD_WARPS`` rows at a time each,
    striding over the ``n`` rows, at most ``BWD_BLOCKS_PER_SM`` a SM.  Each
    block writes one fp32 row of dscale partials, folded in block order."""
    return max(1, min(-(-n // BWD_WARPS), BWD_BLOCKS_PER_SM * sms))


def bwd_route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The backward's CUDA route for rows of ``d`` elements of ``dtype`` (x
    and dy): ``"regs"`` for bf16 with ``d`` a multiple of
    ``BWD_REGS_D_STEP`` up to ``BWD_REGS_MAX_D`` and rows 16-byte aligned
    (``aligned``: x, dy and dx start on 16 bytes), else ``"smem"``."""
    if dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_bwd takes fp32/bf16, got {dtype}")
    regs = (dtype == torch.bfloat16 and aligned and 0 < d <= BWD_REGS_MAX_D
            and d % BWD_REGS_D_STEP == 0)
    return "regs" if regs else "smem"


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of :func:`rmsnorm` at ``dy``; dx in ``x.dtype``,
    dscale in ``scale.dtype``."""
    global launches_bwd
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm_bwd: dy {dy.dtype} {tuple(dy.shape)} on {dy.device} "
                         f"does not match x {x.dtype} {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x, scale and dy must be contiguous")
    d = x.shape[-1]
    if BWD_WARPS * 4 * d > BWD_MAX_SMEM:
        raise ValueError(f"rmsnorm_bwd: rows of {d} exceed the kernel's shared memory "
                         f"(one fp32 row a warp, {BWD_MAX_SMEM} bytes)")
    n = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if n == 0:
        return dx, torch.zeros_like(scale)
    sms = K.sm_count(x.get_device())
    blocks = plan_rmsnorm_bwd(n, sms=sms)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    r = bwd_route(x.dtype, d, all(t.data_ptr() % 16 == 0 for t in (x, dy, dx)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
              dscale.data_ptr(), n, d, float(eps))
    if r == "regs":
        err = K.library().rmsnorm_bwd_regs_launch(
            *common, int(scale.dtype == torch.bfloat16), blocks, stream)
    else:
        err = K.library().rmsnorm_bwd_launch(
            *common, int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), blocks,
            stream)
    K.check(err, f"rmsnorm_bwd ({r})")
    launches_bwd += 1
    launches_bwd_by_route[r] += 1
    if K.LISTENERS:
        K.report("rmsnorm_bwd", K.tensor_bytes(x, scale, dy, dx, dscale))
    return dx, dscale


class RmsNormFn(torch.autograd.Function):
    """RMSNorm with its hand-written gradient: the forward kernel, then the
    backward kernel (their plain versions on the CPU).  Saves x and scale;
    the backward recomputes ``rsqrt(mean(x^2) + eps)`` per row."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None
