"""Griffin recurrent residual block (the port of the griffin part of
``repro/models/recurrent.py``; the xLSTM blocks come with the other
families).

The RG-LRU recurrence runs through the port's Hopper kernel
(``kernels/rglru``) at both of the reference's call sites: the
``lax.associative_scan`` of prefill and ``rglru_step`` at decode (T = 1
from the cached fp32 state).  Gate projections are diagonal, as the
reference's documented simplification of Griffin's block-diagonal maps.
Dtypes follow the reference exactly: the gate math and the recurrence are
fp32, the conv state is stored as bf16 and ``h`` as fp32 whatever the
compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flat_param import LayoutBuilder
from repro_torch.kernels.rglru import rglru
from repro_torch.models import layers as L
from repro_torch.models.blocks import (apply_norm, mlp_apply, mlp_layout, norm_layout,
                                       strip_prefix)
from repro_torch.models.dims import shard_dim

LRU_C = 8.0


def griffin_rec_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    d = cfg.d_model
    r = cfg.lru_width or d
    rl = shard_dim(r, tp, "lru_width")
    std = 1.0 / math.sqrt(d)
    norm_layout(cfg, tp, pb, "ln1")
    pb.add("rec.wx", (d, rl), std=std)
    pb.add("rec.wy", (d, rl), std=std)
    pb.add("rec.conv_w", (cfg.conv_width, rl), std=0.5)
    pb.add("rec.conv_b", (rl,), init="zeros", decay=False)
    pb.add("rec.wi", (rl,), std=0.02, decay=False)
    pb.add("rec.bi", (rl,), init="zeros", decay=False)
    pb.add("rec.wr", (rl,), std=0.02, decay=False)
    pb.add("rec.br", (rl,), init="zeros", decay=False)
    pb.add("rec.lam", (rl,), init="lru", decay=False)
    pb.add("rec.wo", (rl, d), std=1.0 / math.sqrt(r) / math.sqrt(2 * cfg.n_layers))
    norm_layout(cfg, tp, pb, "ln2")
    mlp_layout(cfg, tp, pb, "mlp.")
    b.extend(pb)


def _causal_conv1d(x, w, bias, state=None):
    """Depthwise causal conv; x [b, t, c], w [cw, c].

    state: [b, cw-1, c] previous inputs (decode); returns (y, new_state).
    """
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
        ext = torch.cat([pad, x], dim=1)
    else:
        ext = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(ext[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(cw))
    y = y + bias.to(x.dtype)
    new_state = ext[:, -(cw - 1):] if cw > 1 else None
    return y, new_state


def _softplus(x):
    # exact log(1 + e^x): F.softplus switches to the identity above its
    # threshold of 20, jax.nn.softplus does not
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(t, x, prefix):
    """Per-channel gates -> (a, b) of the recurrence h = a*h_prev + b, fp32."""
    xf = x.float()
    r_gate = torch.sigmoid(xf * t[prefix + "wr"].float() + t[prefix + "br"].float())
    i_gate = torch.sigmoid(xf * t[prefix + "wi"].float() + t[prefix + "bi"].float())
    # log a_base = -softplus(-lam)  (= log sigmoid(lam), stable)
    log_a_base = -_softplus(-t[prefix + "lam"].float())
    log_a = LRU_C * r_gate * log_a_base
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6, 1.0)) * (i_gate * xf)
    return a, b


def rglru_scan(t, x, prefix: str = "rec."):
    """RG-LRU over a sequence from h = 0 (the kernel).  x [b, T, rl] -> (h in
    x's dtype, the fp32 final state [b, rl], copied out of the sequence)."""
    a, b = _rglru_coeffs(t, x, prefix)
    hs = rglru(a, b)
    return hs.to(x.dtype), hs[:, -1].clone()


def rglru_step(t, x1, h_prev, prefix: str = "rec."):
    """One decode step (the kernel at T = 1 from ``h_prev``); x1 [b, rl],
    h_prev [b, rl] fp32 state.  Returns (y in x1's dtype, new fp32 state)."""
    a, b = _rglru_coeffs(t, x1[:, None, :], prefix)
    h = rglru(a, b, h_prev)[:, 0]
    return h.to(x1.dtype), h


def griffin_rec_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, cache=None, prefix: str = ""):
    """Returns (x, new_cache).  Decode writes the new conv state and ``h``
    IN PLACE into ``cache``'s tensors (JAX returns new arrays) and returns
    the same dict; prefill returns a fresh {conv (bf16), h (fp32)}."""
    if ctx.tp != 1:
        raise NotImplementedError("tensor parallelism comes with the multi-chip slice")
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    xa = h @ tt["rec.wx"]
    xb = F.gelu(h @ tt["rec.wy"], approximate="tanh")
    if ctx.mode == "decode":
        xa, conv_state = _causal_conv1d(xa, tt["rec.conv_w"], tt["rec.conv_b"], cache["conv"])
        y1, h_state = rglru_step(tt, xa[:, 0], cache["h"])
        rec = y1[:, None, :]
        cache["conv"].copy_(conv_state.to(torch.bfloat16))  # in place
        cache["h"].copy_(h_state)                           # in place
        new_cache = cache
    else:
        xa, conv_state = _causal_conv1d(xa, tt["rec.conv_w"], tt["rec.conv_b"])
        rec, h_last = rglru_scan(tt, xa, "rec.")
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {"conv": conv_state.to(torch.bfloat16).contiguous(), "h": h_last}
    out = (rec * xb) @ tt["rec.wo"]
    x = x + out
    h = apply_norm(cfg, tt, x, "ln2")
    x = x + mlp_apply(cfg, tt, h, ctx, "mlp.")
    return x, new_cache


def make_rec_cache(cfg: ArchConfig, tp: int, batch: int, *,
                   device: torch.device | str):
    rl = shard_dim(cfg.lru_width or cfg.d_model, tp)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, rl), dtype=torch.bfloat16,
                            device=device),
        "h": torch.zeros((batch, rl), dtype=torch.float32, device=device),
    }
