"""Griffin recurrent residual block (the port of the griffin part of
``repro/models/recurrent.py``; the xLSTM blocks come with the other
families).

The RG-LRU recurrence, with its gate math, runs through the port's Hopper
kernel (``kernels/rglru``, ``rglru_gated``) at both of the reference's call
sites: ``_rglru_coeffs`` + ``lax.associative_scan`` at prefill and
``rglru_step`` at decode (T = 1 from the cached fp32 state, updated in
place).  In training the scan runs as the kernel's autograd Function
(``RgLruGatedFn``: its backward is the kernel of ``csrc/rglru_bwd.cu``);
the causal conv stays eager PyTorch, as the reference computes it outside
any kernel, so its gradient is autograd's and keeps the reference's bf16
rounding after each tap.  Gate projections are diagonal, as the reference's documented
simplification of Griffin's block-diagonal maps.  Dtypes follow the
reference exactly: the gate math and the recurrence are fp32, the conv
state is stored as bf16 and ``h`` as fp32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flat_param import LayoutBuilder
from repro_torch.kernels.rglru import rglru_coeffs_plain, rglru_gated
from repro_torch.models import layers as L
from repro_torch.models.blocks import (apply_norm, mlp_apply, mlp_layout, norm_layout,
                                       strip_prefix)
from repro_torch.models.dims import shard_dim

GATE_NAMES = ("wr", "br", "wi", "bi", "lam")


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


def _rglru_coeffs(t, x, prefix):
    """Per-channel gates -> (a, b) of the recurrence h = a*h_prev + b, fp32
    (the kernel computes the same gates inside ``rglru_gated``)."""
    return rglru_coeffs_plain(x, *(t[prefix + n] for n in GATE_NAMES))


def rglru_scan(t, x, prefix: str = "rec."):
    """RG-LRU over a sequence from h = 0 (the kernel, gates fused in; as
    ``RgLruGatedFn`` when autograd records the call).  x [b, T, rl] -> (h in
    x's dtype, the fp32 final state [b, rl], which carries no gradient)."""
    return rglru_gated(x, *(t[prefix + n] for n in GATE_NAMES))


def rglru_step(t, x1, state, prefix: str = "rec."):
    """One decode step (the kernel at T = 1): x1 [b, rl]; the fp32 state
    [b, rl] is read and then overwritten IN PLACE with the new one.  Returns
    (y in x1's dtype, ``state``)."""
    h, state = rglru_gated(x1[:, None, :], *(t[prefix + n] for n in GATE_NAMES),
                           state, state_out=state)
    return h[:, 0], state


def griffin_rec_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, cache=None, prefix: str = ""):
    """Returns (x, new_cache).  Decode writes the new conv state and ``h``
    IN PLACE into ``cache``'s tensors (JAX returns new arrays) and returns
    the same dict; prefill returns a fresh {conv (bf16), h (fp32)}.  At
    tp > 1 the LRU width is sharded (``rl = lru_width / tp`` channels a
    rank: the conv, the gates and the RG-LRU run on them) and ``rec.wo``'s
    output is summed over the model group."""
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    xa = h @ tt["rec.wx"]
    xb = F.gelu(h @ tt["rec.wy"], approximate="tanh")
    if ctx.mode == "decode":
        xa, conv_state = _causal_conv1d(xa, tt["rec.conv_w"], tt["rec.conv_b"], cache["conv"])
        y1, _ = rglru_step(tt, xa[:, 0], cache["h"])         # h in place
        rec = y1[:, None, :]
        cache["conv"].copy_(conv_state.to(torch.bfloat16))  # in place
        new_cache = cache
    else:
        xa, conv_state = _causal_conv1d(xa, tt["rec.conv_w"], tt["rec.conv_b"])
        rec, h_last = rglru_scan(tt, xa, "rec.")
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {"conv": conv_state.to(torch.bfloat16).contiguous(), "h": h_last}
    x = x + L.tp_psum((rec * xb) @ tt["rec.wo"], ctx)
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
