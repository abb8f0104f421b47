"""AdamW over flat parameter shards (the port of ``repro/optim/adamw.py``).

Model states are flat fp32 vectors, so the optimizer is elementwise on each
shard: m and v are laid out exactly like the parameters.  Weight-decay and
padding masks come from the layout's static segment ranges
(``core/flat_param.py``).  Plain fp32 tensor operations, as the reference
computes AdamW outside any Pallas kernel; the scalars (``lr``, the bias
corrections) are fp32 tensors on the shard's device, each operation in the
reference's order, so each rounds where the reference rounds.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_max: float = 3e-4
    lr_min_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(step: int, oc: OptConfig, *, device) -> torch.Tensor:
    """Linear warmup to ``lr_max`` over ``warmup_steps`` (step 0 has lr 0),
    then a cosine to ``lr_min_ratio * lr_max`` at ``total_steps``; fp32 on
    ``device`` (the shard's: no default, so no caller gets a CPU scalar)."""
    s = _f32(step, device)
    warm = s / max(oc.warmup_steps, 1)
    frac = torch.clamp((s - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1),
                       0.0, 1.0)
    cos = oc.lr_min_ratio + (1 - oc.lr_min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return oc.lr_max * torch.where(s < oc.warmup_steps, warm, cos)


def adamw_shard_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                       step: int, oc: OptConfig, *, decay_mask: torch.Tensor,
                       pad_mask: torch.Tensor, lr: torch.Tensor | None = None,
                       grad_scale: torch.Tensor | None = None):
    """One AdamW step on a flat shard, all fp32 of one shape.  Returns new
    ``(p, m, v)``.  ``grad_scale`` folds the accumulation denominator and
    the global-norm clip factor into the gradient (``core/schedule.py``)."""
    if grad_scale is not None:
        g = g * grad_scale
    lr = lr_schedule(step, oc, device=p.device) if lr is None else lr
    t = _f32(step, p.device) + 1.0
    m = oc.b1 * m + (1 - oc.b1) * g
    v = oc.b2 * v + (1 - oc.b2) * g * g
    mhat = m / (1 - torch.pow(_f32(oc.b1, p.device), t))
    vhat = v / (1 - torch.pow(_f32(oc.b2, p.device), t))
    upd = mhat / (torch.sqrt(vhat) + oc.eps) + oc.weight_decay * decay_mask * p
    p = (p - lr * upd) * pad_mask
    return p, m, v
