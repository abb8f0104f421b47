"""Recurrent blocks: Griffin's RG-LRU residual block and xLSTM's mLSTM and
sLSTM blocks (the port of ``repro/models/recurrent.py``).

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

xLSTM's recurrences are no Pallas kernel in the reference (``lax.scan``
and ``jnp``), so they stay plain PyTorch here: the mLSTM cell a timestep
(or ``mlstm_chunkwise`` when ``ctx.mlstm_chunk`` divides the sequence),
the sLSTM step a timestep, each a short launch sequence.  The sLSTM's
four input products run as one product over the whole sequence before
its time loop and its four recurrent products as one batched product a
step; in training the loop is ``SlstmScanFn``, whose backward is the
reverse loop written out.  As in the reference, the xLSTM weights are
stored model-sharded but gathered whole at use (``_add_gathered``), and
every model rank computes the whole cell.
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

M_INIT = -1e30          # the stabiliser state m before the first step
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


def rglru_scan(t, x, prefix: str = "rec.", shapes_only: bool = False):
    """RG-LRU over a sequence from h = 0 (the kernel, gates fused in; as
    ``RgLruGatedFn`` when autograd records the call).  x [b, T, rl] -> (h in
    x's dtype, the fp32 final state [b, rl], which carries no gradient)."""
    return rglru_gated(x, *(t[prefix + n] for n in GATE_NAMES), shapes_only=shapes_only)


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
        rec, h_last = rglru_scan(tt, xa, "rec.", ctx.shapes_only)
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


# ---------------------------------------------------------------------------
# xLSTM blocks (model-replicated compute; weights stored sharded)
# ---------------------------------------------------------------------------

def _gathered(shape_full, tp):
    """Stored shape for a fully-model-gathered tensor (dim -1 padded)."""
    *lead, last = shape_full
    pad = ((last + tp - 1) // tp) * tp
    return tuple(lead) + (pad // tp,), pad


def _add_gathered(pb: LayoutBuilder, name, shape_full, tp, **kw):
    stored, pad = _gathered(shape_full, tp)
    pb.add(name, stored, model_gather=tp, model_gather_dim=len(stored) - 1, **kw)
    return pad


def mlstm_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    d = cfg.d_model
    inner = int(cfg.expand * d)
    nh = cfg.n_heads
    std = 1.0 / math.sqrt(d)
    istd = 1.0 / math.sqrt(inner)
    norm_layout(cfg, tp, pb, "ln1")
    _add_gathered(pb, "m.wup", (d, 2 * inner), tp, std=std)
    _add_gathered(pb, "m.conv_w", (cfg.conv_width, inner), tp, std=0.5)
    _add_gathered(pb, "m.conv_b", (inner,), tp, init="zeros", decay=False)
    _add_gathered(pb, "m.wq", (inner, inner), tp, std=istd)
    _add_gathered(pb, "m.wk", (inner, inner), tp, std=istd)
    _add_gathered(pb, "m.wv", (inner, inner), tp, std=istd)
    _add_gathered(pb, "m.wif", (inner, 2 * nh), tp, std=istd, decay=False)
    _add_gathered(pb, "m.bif", (2 * nh,), tp, init="zeros", decay=False)
    _add_gathered(pb, "m.hnorm", (inner,), tp, init="zeros", decay=False)
    _add_gathered(pb, "m.wo", (inner, d), tp, std=istd / math.sqrt(2 * cfg.n_layers))
    b.extend(pb)


def mlstm_chunkwise(q, k, v, ilog, flog, chunk: int):
    """Chunkwise-parallel mLSTM (the reference's GLA-style form): within a
    chunk of ``chunk`` steps dense products, the [dk, dv] state carried
    from chunk to chunk.  q/k/v [b, T, nh, dh] (k pre-scaled); ilog/flog
    [b, T, nh] fp32.  Returns h [b, T, nh, dh] fp32 and the final (C, n, m)."""
    b, t, nh, dh = q.shape
    nc, L_ = t // chunk, chunk
    dev = q.device
    C = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((b, nh, dh), dtype=torch.float32, device=dev)
    m = torch.full((b, nh), M_INIT, dtype=torch.float32, device=dev)
    mask = torch.tril(torch.ones((L_, L_), dtype=torch.bool, device=dev))[None, :, :, None]
    hs = []
    for c in range(nc):
        sl = slice(c * L_, (c + 1) * L_)
        qf, kf, vf = (a[:, sl].float() for a in (q, k, v))
        il, fl = ilog[:, sl].float(), flog[:, sl].float()
        bcum = torch.cumsum(fl, dim=1)                       # [b, L, nh]
        btot = bcum[:, -1]                                   # [b, nh]
        # D[j, i] = bcum_j - bcum_i + ilog_i: step i's weight at step j
        D = bcum[:, :, None, :] - bcum[:, None, :, :] + il[:, None, :, :]
        D = torch.where(mask, D, float("-inf"))
        m_loc = torch.amax(D, dim=2)                         # [b, L, nh]
        m_new = torch.maximum(bcum + m[:, None, :], m_loc)
        W = torch.exp(D - m_new[:, :, None, :])              # [b, L, L, nh]
        a = torch.exp(bcum + m[:, None, :] - m_new)          # [b, L, nh]
        s = torch.einsum("bjhd,bihd->bjih", qf, kf)
        h_intra = torch.einsum("bjih,bihd->bjhd", s * W, vf)
        h_inter = torch.einsum("bjhd,bhdv->bjhv", qf, C) * a[..., None]
        n_intra = torch.einsum("bjih,bihd->bjhd", W, kf)
        n_all = n_intra + n[:, None] * a[..., None]
        qn = torch.einsum("bjhd,bjhd->bjh", qf, n_all)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
        hs.append((h_intra + h_inter) / denom[..., None])
        # the carry to the next chunk
        m_next = torch.maximum(btot + m, torch.amax(btot[:, None] - bcum + il, dim=1))
        dec = torch.exp(btot + m - m_next)
        wgt = torch.exp(btot[:, None] - bcum + il - m_next[:, None])
        C = C * dec[..., None, None] + torch.einsum("bihd,bihv,bih->bhdv", kf, vf, wgt)
        n = n * dec[..., None] + torch.einsum("bihd,bih->bhd", kf, wgt)
        m = m_next
    return torch.cat(hs, dim=1), (C, n, m)


def _mlstm_cell(q, k, v, ilog, flog, carry):
    """One timestep (the reference's cell, 17 launches).  q/k/v [b, nh,
    dh]; ilog/flog [b, nh]."""
    C, n, m = carry
    b, nh, dh = q.shape
    a = flog + m
    m_new = torch.maximum(a, ilog)
    fp, ip = torch.stack((a, ilog)).sub_(m_new).exp_()[..., None]
    ipk = ip * k
    C = torch.baddbmm((C * fp[..., None]).view(b * nh, dh, dh), ipk.view(b * nh, dh, 1),
                      v.reshape(b * nh, 1, dh)).view(b, nh, dh, dh)
    n = torch.addcmul(ipk, fp, n)
    qn = torch.linalg.vecdot(n, q)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    h = torch.bmm(q.reshape(b * nh, 1, dh), C.view(b * nh, dh, dh)).view(b, nh, dh)
    return (C, n, m_new), h / denom[..., None]


def _mlstm_scan(q, k, v, ilog, flog):
    """The cell over [b, T, ...] from the zero state (m at ``M_INIT``)."""
    b, t, nh, dh = q.shape
    dev = q.device
    carry = (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((b, nh, dh), dtype=torch.float32, device=dev),
             torch.full((b, nh), M_INIT, dtype=torch.float32, device=dev))
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for i in range(t):
        carry, h = _mlstm_cell(qf[:, i], kf[:, i], vf[:, i], ilog[:, i], flog[:, i], carry)
        hs.append(h)
    return torch.stack(hs, dim=1), carry


def mlstm_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, cache=None, prefix: str = ""):
    """Returns (x, new_cache).  Decode writes the new C, n, m and conv
    state IN PLACE into ``cache``'s tensors and returns the same dict;
    prefill returns a fresh {C, n, m (fp32), conv (bf16)}."""
    tt = strip_prefix(t, prefix)
    d = cfg.d_model
    inner = int(cfg.expand * d)
    nh = cfg.n_heads
    dh = inner // nh
    bsz, tq, _ = x.shape

    h0 = apply_norm(cfg, tt, x, "ln1")
    up = h0 @ tt["m.wup"][:, :2 * inner]
    xin, z = up[..., :inner], up[..., inner:]
    conv_state = cache["conv"] if ctx.mode == "decode" else None
    xc, conv_state = _causal_conv1d(xin, tt["m.conv_w"][:, :inner], tt["m.conv_b"][:inner],
                                    conv_state)
    xc = F.silu(xc)
    q = (xc @ tt["m.wq"][:, :inner]).reshape(bsz, tq, nh, dh)
    k = (xc @ tt["m.wk"][:, :inner]).reshape(bsz, tq, nh, dh) / math.sqrt(dh)
    v = (xin @ tt["m.wv"][:, :inner]).reshape(bsz, tq, nh, dh)
    iflog = (xc @ tt["m.wif"][:, :2 * nh] + tt["m.bif"][:2 * nh]).float()
    ilog, flog = iflog[..., :nh], F.logsigmoid(iflog[..., nh:])

    if ctx.mode == "decode":
        carry, h = _mlstm_cell(q[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                               ilog[:, 0], flog[:, 0], (cache["C"], cache["n"], cache["m"]))
        hseq = h[:, None]
        for name, new in zip(("C", "n", "m"), carry):
            cache[name].copy_(new)                              # in place
        cache["conv"].copy_(conv_state.to(torch.bfloat16))      # in place
        new_cache = cache
    else:
        chunk = ctx.mlstm_chunk
        if chunk and tq % chunk == 0 and tq > chunk:
            hseq, carry = mlstm_chunkwise(q, k, v, ilog, flog, chunk)
        else:
            hseq, carry = _mlstm_scan(q, k, v, ilog, flog)
        new_cache = None
        if ctx.mode == "prefill":
            conv = (conv_state.to(torch.bfloat16).contiguous() if conv_state is not None
                    else torch.zeros((bsz, cfg.conv_width - 1, inner), dtype=torch.bfloat16,
                                     device=x.device))
            new_cache = {"C": carry[0], "n": carry[1], "m": carry[2], "conv": conv}

    hflat = hseq.reshape(bsz, tq, inner).to(x.dtype)
    hflat = L.rms_norm(hflat, tt["m.hnorm"][:inner])
    out = (hflat * F.silu(z)) @ tt["m.wo"][:, :d]
    return x + out, new_cache


def slstm_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    std = 1.0 / math.sqrt(d)
    norm_layout(cfg, tp, pb, "ln1")
    for g in SLSTM_GATES:
        _add_gathered(pb, f"s.w{g}", (d, d), tp, std=std)
        _add_gathered(pb, f"s.r{g}", (nh, dh, dh), tp, std=1.0 / math.sqrt(dh), decay=False)
        _add_gathered(pb, f"s.b{g}", (d,), tp, init="zeros", decay=False)
    _add_gathered(pb, "s.hnorm", (d,), tp, init="zeros", decay=False)
    _add_gathered(pb, "s.wo", (d, d), tp, std=std / math.sqrt(2 * cfg.n_layers))
    norm_layout(cfg, tp, pb, "ln2")
    mlp_layout(cfg, tp, pb, "mlp.", d_ff=4 * d)
    b.extend(pb)


SLSTM_GATES = ("z", "i", "f", "o")
SLSTM_N_FLOOR = 1e-6


def _slstm_steps(px, r, c, n, h, m, saved=None, shapes_only: bool = False):
    """The sLSTM recurrence over ``px`` [T, nh, b, 4, dh] (each step's
    input products and biases, gates z, i, f, o), heads leading: the
    state c, n, h, m [nh, b, dh] fp32, ``r`` [nh, dh, 4 dh] the four
    recurrent matrices side by side.  Each step is one batched product
    (``baddbmm``: the recurrent products added to the input ones) and the
    gate math of the reference's ``_slstm_step``, 15 launches.  Returns
    (hs [T, nh, b, dh], (c, n, h, m)).  ``saved``: (pre [T, nh, b, 4, dh],
    c, n, m [T + 1, nh, b, dh]) that each step writes its pre-activations
    and states into, for :class:`SlstmScanFn`'s backward.  ``shapes_only``
    (``L.Ctx.shapes_only``): the steps are skipped, ``hs`` left unwritten."""
    steps = px.shape[0]
    hs = px.new_empty((steps, *h.shape))
    if shapes_only:
        return hs, (c, n, h, m)
    for i in range(steps):
        if saved is None:
            pre = torch.baddbmm(px[i].flatten(2), h, r).view(px.shape[1:])
            m_out = c_out = n_out = None
        else:
            pre = saved[0][i]
            torch.baddbmm(px[i].flatten(2), h, r, out=pre.flatten(2))
            c_out, n_out, m_out = (buf[i + 1] for buf in saved[1:])
        z = torch.tanh(pre[:, :, 0])
        ilog = pre[:, :, 1]
        a = F.logsigmoid(pre[:, :, 2]).add_(m)
        o = torch.sigmoid(pre[:, :, 3])
        m = torch.maximum(a, ilog, out=m_out)
        fp, ip = torch.stack((a, ilog)).sub_(m).exp_()
        c = torch.addcmul(fp * c, ip, z, out=c_out)
        n = torch.addcmul(ip, fp, n, out=n_out)
        h = torch.mul(o, c, out=hs[i]).div_(torch.clamp_min(n, SLSTM_N_FLOOR))
    return hs, (c, n, h, m)


def _zero_slstm_state(shape, device, dtype=torch.float32):
    zeros = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)]
    return (*zeros, torch.full(shape, M_INIT, dtype=dtype, device=device))


class SlstmScanFn(torch.autograd.Function):
    """The sLSTM recurrence from the zero state with its backward written
    out: the forward is :func:`_slstm_steps` writing each step's
    pre-activations and states into buffers it saves; the backward
    recomputes every step's gate values at once from them and walks the
    steps in reverse, 18 launches a step, one batched product carrying dh
    back through the recurrent matrices.  The gradients of ``max`` split
    at a tie and ``max(n, 1e-6)`` passes where n is above the floor, as
    autodiff of the reference's step does.  px [T, nh, b, 4, dh], r [nh,
    dh, 4 dh] (fp32) -> hs [T, nh, b, dh] fp32."""

    @staticmethod
    def forward(ctx, px, r, shapes_only=False):
        steps, nh, b, _, dh = px.shape
        c, n, h, m = _zero_slstm_state((nh, b, dh), px.device, px.dtype)
        pre = torch.empty_like(px)
        states = [torch.empty((steps + 1, nh, b, dh), dtype=px.dtype, device=px.device)
                  for _ in range(3)]
        for buf, val in zip(states, (c, n, m)):
            buf[0].copy_(val)
        hs, _ = _slstm_steps(px, r, c, n, h, m, saved=(pre, *states), shapes_only=shapes_only)
        ctx.save_for_backward(pre, *states, hs, r)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        pre, c_all, n_all, m_all, hs, r = ctx.saved_tensors
        steps, nh, b, _, dh = pre.shape
        # every step's gate values and the chain rule's factors, at once
        z = torch.tanh(pre[:, :, :, 0])
        ilog = pre[:, :, :, 1]
        a = F.logsigmoid(pre[:, :, :, 2]) + m_all[:-1]
        o = torch.sigmoid(pre[:, :, :, 3])
        m = m_all[1:]
        fp = torch.exp(a - m)
        ip = torch.exp(ilog - m)
        n = n_all[1:]
        inv = 1.0 / torch.clamp_min(n, SLSTM_N_FLOOR)
        y = c_all[1:] * inv
        pass_n = (n > SLSTM_N_FLOOR).float() + 0.5 * (n == SLSTM_N_FLOOR).float()
        kn = -y * inv * pass_n                     # d y / d n
        sel = (a > ilog).float() + 0.5 * (a == ilog).float()   # d m / d a
        nsel = 1.0 - sel
        ipz = ip * (1.0 - z * z)                   # d c / d pre_z, over dc
        fpc, fpn = fp * c_all[:-1], fp * n_all[:-1]
        fac_f = torch.sigmoid(-pre[:, :, :, 2])    # d logsigmoid
        yo = y * o * (1.0 - o)                     # d h / d pre_o, over dh
        rt = r.transpose(1, 2)
        dpre = torch.empty_like(pre)
        zero = pre.new_zeros((nh, b, dh))
        dc, dn, dm = zero, zero, zero
        dhi = dhs[steps - 1]
        for i in range(steps - 1, -1, -1):
            dy = dhi * o[i]
            dc = torch.addcmul(dc, dy, inv[i])
            dn = torch.addcmul(dn, dy, kn[i])
            g1 = torch.addcmul(dc * fpc[i], dn, fpn[i])
            g2 = torch.addcmul(dn, dc, z[i]).mul_(ip[i])
            dm = dm - g1 - g2
            d = dpre[i]
            torch.mul(dc, ipz[i], out=d[:, :, 0])
            torch.addcmul(g2, dm, nsel[i], out=d[:, :, 1])
            dm = torch.addcmul(g1, dm, sel[i])          # d a: the carry of m
            torch.mul(dm, fac_f[i], out=d[:, :, 2])
            torch.mul(dhi, yo[i], out=d[:, :, 3])
            dc, dn = dc * fp[i], dn * fp[i]
            if i:
                dhi = torch.baddbmm(dhs[i - 1], d.flatten(2), rt)
        # the recurrent matrices' gradient: every step's h_prev against its dpre
        h_prev = torch.cat([zero[None], hs[:-1]])  # [T, nh, b, dh]
        dr = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(nh, dh, steps * b),
                       dpre.permute(1, 0, 2, 3, 4).reshape(nh, steps * b, 4 * dh))
        return dpre, dr, None


def _heads_first(s: torch.Tensor, nh: int) -> torch.Tensor:
    """[b, d] -> [nh, b, dh]."""
    return s.view(s.shape[0], nh, -1).transpose(0, 1).contiguous()


def _heads_last(s: torch.Tensor) -> torch.Tensor:
    """[nh, b, dh] -> [b, d]."""
    return s.transpose(0, 1).reshape(s.shape[1], -1)


def slstm_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, cache=None, prefix: str = ""):
    """Returns (x, new_cache).  Decode writes the new c, n, h, m IN PLACE
    into ``cache``'s tensors and returns the same dict; prefill returns a
    fresh {c, n, h, m} (fp32 [b, d]).  The four input products run as one
    fp32 product over the sequence, the recurrence one batched product a
    step (in training as :class:`SlstmScanFn`)."""
    tt = strip_prefix(t, prefix)
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    bsz, tq, _ = x.shape
    h0 = apply_norm(cfg, tt, x, "ln1").float()
    w = torch.cat([tt[f"s.w{g}"][:, :d] for g in SLSTM_GATES], dim=1).float()
    bias = torch.cat([tt[f"s.b{g}"][:d] for g in SLSTM_GATES]).float()
    px = torch.addmm(bias, h0.reshape(bsz * tq, d), w)          # [b T, 4 d]
    px = px.view(bsz, tq, 4, nh, dh).permute(1, 3, 0, 2, 4).contiguous()  # [T, nh, b, 4, dh]
    r = torch.stack([tt[f"s.r{g}"].float() for g in SLSTM_GATES], dim=2).reshape(nh, dh, 4 * dh)

    if ctx.mode == "decode":
        state = [_heads_first(cache[k], nh) for k in ("c", "n", "h", "m")]
        hs, new = _slstm_steps(px, r, *state)
        for k, v in zip(("c", "n", "h", "m"), new):
            cache[k].copy_(_heads_last(v))                       # in place
        new_cache = cache
    elif L._records_grad(px, r):
        hs, new_cache = SlstmScanFn.apply(px, r, ctx.shapes_only), None
    else:
        hs, new = _slstm_steps(px, r, *_zero_slstm_state((nh, bsz, dh), x.device))
        new_cache = None
        if ctx.mode == "prefill":
            new_cache = {k: _heads_last(v).contiguous() for k, v in zip(("c", "n", "h", "m"), new)}
    hseq = hs.permute(2, 0, 1, 3).reshape(bsz, tq, d)

    hseq = L.rms_norm(hseq.to(x.dtype), tt["s.hnorm"][:d])
    x = x + hseq @ tt["s.wo"][:, :d]
    h = apply_norm(cfg, tt, x, "ln2")
    x = x + mlp_apply(cfg, tt, h, ctx, "mlp.")
    return x, new_cache


def make_mlstm_cache(cfg: ArchConfig, batch: int, *, device: torch.device | str):
    inner = int(cfg.expand * cfg.d_model)
    nh = cfg.n_heads
    dh = inner // nh
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), M_INIT, dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, inner), dtype=torch.bfloat16,
                            device=device),
    }


def make_slstm_cache(cfg: ArchConfig, batch: int, *, device: torch.device | str):
    d = cfg.d_model
    zeros = {k: torch.zeros((batch, d), dtype=torch.float32, device=device)
             for k in ("c", "n", "h")}
    return {**zeros, "m": torch.full((batch, d), M_INIT, dtype=torch.float32, device=device)}
