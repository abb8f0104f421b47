"""Dense, MoE, gated cross-attention and whisper decoder layers (the port
of ``repro/models/blocks.py``).

Each sub-block provides ``*_layout(cfg, tp, b)`` (appends its segments to a
LayoutBuilder) and ``*_apply`` (a plain function over unflattened tensors).
Self-attention runs in prefill mode, in contiguous decode at a scalar
position, and at per-request positions (a ``[b]`` tensor ``ctx.pos``: the
continuous-batching engine), over a contiguous cache or a paged KV pool
(``ctx.pages``).  Norms are RMSNorm or, with ``cfg.norm == "ln"``,
LayerNorm with a bias; MLPs SwiGLU, GeGLU or the biased GeLU MLP
(``cfg.mlp == "gelu"``: whisper and the paper's BERT-style models).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant as Q
from repro_torch.core.flat_param import LayoutBuilder
from repro_torch.models import layers as L
from repro_torch.models.dims import AttnDims, attn_dims, shard_dim


def attn_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = "attn.",
                *, bias: bool = False) -> AttnDims:
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    d = cfg.d_model
    std = 1.0 / math.sqrt(d)
    out_std = 1.0 / math.sqrt(ad.hq_pad * ad.head_dim) / math.sqrt(2 * cfg.n_layers)
    b.add(prefix + "wq", (d, ad.q_cols_local), std=std)
    b.add(prefix + "wk", (d, ad.kv_cols_stored), std=std,
          model_gather=ad.kv_gather, model_gather_dim=1)
    b.add(prefix + "wv", (d, ad.kv_cols_stored), std=std,
          model_gather=ad.kv_gather, model_gather_dim=1)
    b.add(prefix + "wo", (ad.q_cols_local, d), std=out_std)
    if bias:
        b.add(prefix + "bq", (ad.q_cols_local,), init="zeros", decay=False)
        b.add(prefix + "bk", (ad.kv_cols_stored,), init="zeros", decay=False,
              model_gather=ad.kv_gather, model_gather_dim=0)
        b.add(prefix + "bv", (ad.kv_cols_stored,), init="zeros", decay=False,
              model_gather=ad.kv_gather, model_gather_dim=0)
        b.add(prefix + "bo", (shard_dim(d, tp),), init="zeros", decay=False,
              model_gather=tp, model_gather_dim=0)
    return ad


def attn_qkv(t, x, kv_x, ad: AttnDims, ctx: L.Ctx, prefix: str, *, bias: bool):
    """Project to q [b,t,hkv_local,g,dh], k/v [b,t,hkv_local,dh]."""
    bsz, tq, _ = x.shape
    tk = kv_x.shape[1]
    q = x @ t[prefix + "wq"]
    k = kv_x @ t[prefix + "wk"]
    v = kv_x @ t[prefix + "wv"]
    if bias:
        q = q + t[prefix + "bq"].to(q.dtype)
        k = k + t[prefix + "bk"].to(k.dtype)
        v = v + t[prefix + "bv"].to(v.dtype)
    q = q.reshape(bsz, tq, ad.hkv_local, ad.q_per_kv_local, ad.head_dim)
    k = k.reshape(bsz, tk, ad.hkv_local, ad.head_dim)
    v = v.reshape(bsz, tk, ad.hkv_local, ad.head_dim)
    return q, k, v


def attn_out(t, attn: torch.Tensor, ad: AttnDims, ctx: L.Ctx, prefix: str, *, bias: bool):
    """attn [b,t,hkv_local,g,dh] -> [b,t,d] (full, post-psum)."""
    bsz, tq = attn.shape[:2]
    if ad.hq != ad.hq_pad:  # multiplying by a mask of ones is the identity
        hmask = L.local_head_mask(ad.hq, ad.hq_pad, ad.hq_local, ctx).to(attn.device)
        attn = attn * hmask.reshape(1, 1, ad.hkv_local, ad.q_per_kv_local, 1).to(attn.dtype)
    out = L.tp_psum(attn.reshape(bsz, tq, ad.q_cols_local) @ t[prefix + "wo"], ctx)
    if bias:
        out = out + t[prefix + "bo"].to(out.dtype)
    return out


def _rope5(q: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary over [b, t, hkv, g, dh] (fold grouped head dims)."""
    b, tq, hkv, g, dh = q.shape
    out = L.rotary(q.reshape(b, tq, hkv * g, dh), positions, theta)
    return out.reshape(b, tq, hkv, g, dh)


def _paged_kv_write(cache: dict, pages, k: torch.Tensor, v: torch.Tensor,
                    absp: torch.Tensor, valid_tok: torch.Tensor) -> None:
    """Scatter this tick's k/v token rows into the paged block pool IN
    PLACE (the reference returns an updated copy).

    cache: {"k", "v"[, "ks", "vs"]}, k/v [n_blocks, block_size, h, dh]
    (int8 pools add fp32 scale pages [n_blocks, block_size, h, n_scale]);
    k/v [b, tq, h, dh]; absp [b, tq] absolute positions; valid_tok [b, tq].
    A padding row (``valid_tok`` False) writes zeros into the garbage block
    0, which therefore stays all zeros: the reference drops such writes
    (``mode="drop"``), and every row writing there writes the same zeros,
    so the scatter is deterministic.  Int8 pools quantize each (token,
    head) row against its own absmax (``quant.quantize_flat``, nearest);
    blocks are only written incrementally, never re-quantized.
    """
    bs, width = cache["k"].shape[1], cache["k"].shape[-1]
    if k.shape[-1] != width:  # a pool at a padded head dim (L.paged_attention)
        k, v = (torch.nn.functional.pad(t, (0, width - t.shape[-1])) for t in (k, v))
    tables = pages.block_tables
    slot = torch.clamp(absp // bs, max=tables.shape[1] - 1)
    blk = torch.where(valid_tok, torch.gather(tables.long(), 1, slot), 0)
    off = absp % bs
    if "ks" in cache:
        qk, sk = Q.quantize_flat(k.float())
        qv, sv = Q.quantize_flat(v.float())
        rows = {"k": qk, "v": qv, "ks": sk, "vs": sv}
    else:
        rows = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    keep = valid_tok[..., None, None]
    for name, val in rows.items():
        cache[name][blk, off] = torch.where(keep, val, torch.zeros_like(val))


def _paged_kv_read(cache: dict, pages, q: torch.Tensor, kv_valid_len: torch.Tensor):
    """Attention of q over the pool through the block tables (the
    reference gathers a contiguous ``[b, max_blocks * block_size, h, dh]``
    view and dequantizes it; the port's ``paged`` route reads the pages
    where they lie, dequantizing int8 pages in shared memory: no view is
    made on the card).  A row of valid length 0 is dead: zero output."""
    return L.paged_attention(q, cache["k"], cache["v"], pages.block_tables, kv_valid_len,
                             k_scale=cache.get("ks"), v_scale=cache.get("vs"))


def self_attention(t, x, ctx: L.Ctx, ad: AttnDims, cfg: ArchConfig, *,
                   prefix: str = "attn.", causal: bool = True, window: int = 0,
                   use_rope: bool = True, bias: bool = False, cache=None):
    """Self attention in prefill, contiguous decode or cache-less mode.

    cache: None, or dict(k, v) of [b, cap, hkv, dh] for decode, or one
    layer's paged pool (``ctx.pages`` set).  Returns (out, new_cache).
    Decode writes the new tokens' k/v into ``cache`` IN PLACE (JAX returns
    an updated copy) and returns the same dict.
    """
    bsz, tq, _ = x.shape
    q, k, v = attn_qkv(t, x, x, ad, ctx, prefix, bias=bias)

    if ctx.mode == "decode" and (ctx.pages is not None or isinstance(ctx.pos, torch.Tensor)):
        # Continuous batching: per-request positions [b] (a ragged batch),
        # optionally over a paged block pool.  tq > 1 is a chunk of tokens a
        # slot (chunked prefill interleaved with decode); rows at or past a
        # slot's n_new are padding whose writes are dropped and whose
        # outputs the scheduler ignores: their valid length is 0, so the
        # paged route skips them (a dead row's attention is zero).
        if window:
            raise NotImplementedError("paged / vector-position decode needs window == 0")
        pages = ctx.pages
        absp = ctx.pos.to(x.device).long()[:, None] + torch.arange(tq, device=x.device)[None, :]
        if use_rope:
            q = _rope5(q, absp, cfg.rope_theta)
            k = L.rotary(k, absp, cfg.rope_theta)
        if pages is not None:
            n_new = pages.n_new
            valid_tok = (torch.arange(tq, device=x.device)[None, :] < n_new.to(x.device)[:, None]
                         if n_new is not None
                         else torch.ones((bsz, tq), dtype=torch.bool, device=x.device))
            _paged_kv_write(cache, pages, k, v, absp, valid_tok)
            out = _paged_kv_read(cache, pages, q, torch.where(valid_tok, absp + 1, 0))
        else:  # the contiguous vector-position reference: every row is a token
            bidx = torch.arange(bsz, device=x.device)[:, None]
            cache["k"][bidx, absp] = k.to(cache["k"].dtype)  # in place
            cache["v"][bidx, absp] = v.to(cache["v"].dtype)  # in place
            out = L.attention(q, cache["k"], cache["v"], causal=False, window=0,
                              kv_valid_len=absp + 1)
        # a cache dtype wider than the compute dtype (fp32 KV under bf16
        # compute) must not leak into the residual stream
        out = out.to(x.dtype)
        return attn_out(t, out, ad, ctx, prefix, bias=bias), cache

    if ctx.mode == "decode":
        pos = ctx.pos
        positions = torch.full((bsz, tq), pos, dtype=torch.int64, device=x.device)
        if use_rope:
            q = _rope5(q, positions, cfg.rope_theta)
            k = L.rotary(k, positions, cfg.rope_theta)
        cap = cache["k"].shape[1]
        slot = pos % cap if window else pos
        if slot + tq > cap:
            raise ValueError(f"decode position {pos} + {tq} exceeds the cache "
                             f"capacity {cap}")
        cache["k"][:, slot:slot + tq] = k.to(cache["k"].dtype)  # in place
        cache["v"][:, slot:slot + tq] = v.to(cache["v"].dtype)  # in place
        valid = min(pos + 1, cap)
        out = L.attention(q, cache["k"], cache["v"], causal=False, window=0,
                          kv_valid_len=valid)
        return attn_out(t, out, ad, ctx, prefix, bias=bias), cache

    positions = torch.arange(tq, device=x.device).expand(bsz, tq)
    if use_rope:
        q = _rope5(q, positions, cfg.rope_theta)
        k = L.rotary(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, causal=causal, window=window)
    new_cache = None
    if ctx.mode == "prefill":
        cap = ctx.cache_len if not window else min(window, ctx.cache_len)
        if tq >= cap:
            # slot of absolute position a is a % cap (matches decode writes)
            k_keep = torch.roll(k[:, tq - cap:], tq % cap, dims=1)
            v_keep = torch.roll(v[:, tq - cap:], tq % cap, dims=1)
        else:
            pad = (0, 0, 0, 0, 0, cap - tq)
            k_keep = torch.nn.functional.pad(k, pad)
            v_keep = torch.nn.functional.pad(v, pad)
        new_cache = {"k": k_keep.to(ctx.compute_dtype).contiguous(),
                     "v": v_keep.to(ctx.compute_dtype).contiguous()}
    return attn_out(t, out, ad, ctx, prefix, bias=bias), new_cache


def cross_attention(t, x, kv_src, ctx: L.Ctx, ad: AttnDims, cfg: ArchConfig, *,
                    prefix: str = "xattn.", bias: bool = False, cache=None):
    """Cross attention against a source sequence (the VLM's vision rows,
    whisper's encoder output), non-causal over all of its keys, no rotary
    on either side; ``bias`` adds ``bq``, ``bk``, ``bv`` and ``bo`` (the
    decoder's).  Prefill returns the projected source K/V as the cache
    ({k, v} [b, src, hkv, dh] in the compute dtype); decode reads them from
    ``cache`` and projects only the queries.  Returns (out, cache)."""
    bsz, tq, _ = x.shape
    if ctx.mode == "decode" and cache is not None:
        q = x @ t[prefix + "wq"]
        if bias:
            q = q + t[prefix + "bq"].to(q.dtype)
        q = q.reshape(bsz, tq, ad.hkv_local, ad.q_per_kv_local, ad.head_dim)
        out = L.attention(q, cache["k"], cache["v"], causal=False)
        return attn_out(t, out, ad, ctx, prefix, bias=bias), cache
    q, k, v = attn_qkv(t, x, kv_src, ad, ctx, prefix, bias=bias)
    out = L.attention(q, k, v, causal=False)
    new_cache = None
    if ctx.mode == "prefill":
        new_cache = {"k": k.to(ctx.compute_dtype).contiguous(),
                     "v": v.to(ctx.compute_dtype).contiguous()}
    return attn_out(t, out, ad, ctx, prefix, bias=bias), new_cache


def make_kv_cache(cfg: ArchConfig, tp: int, batch: int, cache_len: int, *,
                  window: int = 0, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str):
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    cap = min(window, cache_len) if window else cache_len
    shape = (batch, cap, ad.hkv_local, ad.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def make_cross_cache(cfg: ArchConfig, tp: int, batch: int, src_len: int, *,
                     dtype: torch.dtype = torch.bfloat16, device: torch.device | str):
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    shape = (batch, src_len, ad.hkv_local, ad.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def norm_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, name: str):
    d_local = shard_dim(cfg.d_model, tp)
    b.add(name + ".scale", (d_local,), init="zeros", decay=False,
          model_gather=tp, model_gather_dim=0)
    if cfg.norm == "ln":
        b.add(name + ".bias", (d_local,), init="zeros", decay=False,
              model_gather=tp, model_gather_dim=0)


def apply_norm(cfg: ArchConfig, t, x, name: str):
    if cfg.norm == "ln":
        return L.layer_norm(x, t[name + ".scale"], t[name + ".bias"])
    return L.rms_norm(x, t[name + ".scale"])


def mlp_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = "mlp.",
               d_ff: int | None = None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    f_local = shard_dim(f, tp, "d_ff")
    std, dstd = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp in ("swiglu", "geglu"):
        b.add(prefix + "wg", (d, f_local), std=std)
        b.add(prefix + "wu", (d, f_local), std=std)
        b.add(prefix + "wd", (f_local, d), std=dstd)
    else:  # gelu: biased, b2 stored sharded and gathered over the model group
        b.add(prefix + "w1", (d, f_local), std=std)
        b.add(prefix + "b1", (f_local,), init="zeros", decay=False)
        b.add(prefix + "wd", (f_local, d), std=dstd)
        b.add(prefix + "b2", (shard_dim(d, tp),), init="zeros", decay=False,
              model_gather=tp, model_gather_dim=0)


def mlp_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, prefix: str = "mlp."):
    """Column-parallel gate and up projections (GeLU: ``w1`` and ``b1``),
    row-parallel down projection, then the psum over the model group (GeLU:
    then ``+ b2``)."""
    if cfg.mlp == "swiglu":
        out = L.mlp_swiglu(x, t[prefix + "wg"], t[prefix + "wu"], t[prefix + "wd"])
    elif cfg.mlp == "geglu":
        out = L.mlp_geglu(x, t[prefix + "wg"], t[prefix + "wu"], t[prefix + "wd"])
    else:
        out = L.mlp_gelu(x, t[prefix + "w1"], t[prefix + "b1"], t[prefix + "wd"])
    out = L.tp_psum(out, ctx)
    if cfg.mlp == "gelu":
        out = out + t[prefix + "b2"].to(out.dtype)
    return out


def strip_prefix(t: dict, prefix: str) -> dict:
    """The tensors named ``prefix...``, without the prefix.  Names under
    other prefixes are left out: the JAX package strips ``len(prefix)``
    characters from every name, so in its griffin super-layers ``rec1.x``
    shadows ``rec0.x`` and both recurrent sub-layers run ``rec1``'s
    weights; here each sub-layer runs its own."""
    if not prefix:
        return t
    return {name[len(prefix):]: v for name, v in t.items() if name.startswith(prefix)}


def dense_layer_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    norm_layout(cfg, tp, pb, "ln1")
    attn_layout(cfg, tp, pb, "attn.", bias=cfg.qkv_bias)
    norm_layout(cfg, tp, pb, "ln2")
    mlp_layout(cfg, tp, pb, "mlp.")
    b.extend(pb)


def dense_layer_apply(cfg: ArchConfig, ad: AttnDims, t, x, ctx: L.Ctx,
                      cache=None, prefix: str = "", *, window: int = 0,
                      causal: bool = True):
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    a, new_cache = self_attention(
        tt, h, ctx, ad, cfg, prefix="attn.", causal=causal, window=window,
        use_rope=cfg.use_rope, bias=cfg.qkv_bias, cache=cache)
    x = x + a
    h = apply_norm(cfg, tt, x, "ln2")
    x = x + mlp_apply(cfg, tt, h, ctx, "mlp.")
    return x, new_cache


# ---------------------------------------------------------------------------
# gated cross-attention layer (llama-3.2-vision)
# ---------------------------------------------------------------------------

def cross_layer_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    norm_layout(cfg, tp, pb, "ln1")
    attn_layout(cfg, tp, pb, "xattn.")
    pb.add("gate_attn", (1,), init="zeros", decay=False)
    norm_layout(cfg, tp, pb, "ln2")
    mlp_layout(cfg, tp, pb, "mlp.")
    pb.add("gate_mlp", (1,), init="zeros", decay=False)
    b.extend(pb)


def _gate(g: torch.Tensor, x: torch.Tensor, ctx: L.Ctx) -> torch.Tensor:
    """``tanh(g)`` in fp32, cast to x's dtype.  The gate is stored whole on
    every model rank; in training at tp > 1 its gradient is summed over
    the model group (:func:`layers.tp_replicated`)."""
    return torch.tanh(L.tp_replicated(g, ctx).float()).to(x.dtype)


def cross_layer_apply(cfg: ArchConfig, ad: AttnDims, t, x, ctx: L.Ctx, cache=None,
                      prefix: str = ""):
    """The gated cross-attention layer: ``x + tanh(gate_attn) xattn(ln1
    x, vision)``, then ``+ tanh(gate_mlp) mlp(ln2 x)``.  The gates are zero
    at init (the layer is then the identity)."""
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    a, new_cache = cross_attention(tt, h, ctx.vision, ctx, ad, cfg, prefix="xattn.",
                                   cache=cache)
    x = x + _gate(tt["gate_attn"], x, ctx) * a
    h = apply_norm(cfg, tt, x, "ln2")
    x = x + _gate(tt["gate_mlp"], x, ctx) * mlp_apply(cfg, tt, h, ctx, "mlp.")
    return x, new_cache


# ---------------------------------------------------------------------------
# whisper decoder layer (its encoder layers are dense layers, non-causal)
# ---------------------------------------------------------------------------

def encdec_dec_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    norm_layout(cfg, tp, pb, "ln1")
    attn_layout(cfg, tp, pb, "attn.", bias=True)
    norm_layout(cfg, tp, pb, "lnx")
    attn_layout(cfg, tp, pb, "xattn.", bias=True)
    norm_layout(cfg, tp, pb, "ln2")
    mlp_layout(cfg, tp, pb, "mlp.")
    b.extend(pb)


def encdec_dec_apply(cfg: ArchConfig, ad: AttnDims, t, x, ctx: L.Ctx, cache=None,
                     prefix: str = ""):
    """The decoder layer: causal biased self-attention (no rotary), biased
    cross-attention over ``ctx.enc_out`` (decode: over the K/V its prefill
    cached), the MLP; each after its LayerNorm (``ln1``, ``lnx``, ``ln2``).
    The cache is ``{"self": KV cache, "cross": cross cache}``."""
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    a, nc_self = self_attention(tt, h, ctx, ad, cfg, prefix="attn.", causal=True,
                                use_rope=False, bias=True,
                                cache=cache.get("self") if cache else None)
    x = x + a
    h = apply_norm(cfg, tt, x, "lnx")
    a, nc_cross = cross_attention(tt, h, ctx.enc_out, ctx, ad, cfg, prefix="xattn.", bias=True,
                                  cache=cache.get("cross") if cache else None)
    x = x + a
    h = apply_norm(cfg, tt, x, "ln2")
    x = x + mlp_apply(cfg, tt, h, ctx, "mlp.")
    new_cache = None
    if nc_self is not None or nc_cross is not None:
        new_cache = {"self": nc_self, "cross": nc_cross}
    return x, new_cache


# ---------------------------------------------------------------------------
# MoE layer (deepseek-moe / dbrx)
# ---------------------------------------------------------------------------

def moe_layer_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = ""):
    pb = LayoutBuilder(prefix)
    norm_layout(cfg, tp, pb, "ln1")
    attn_layout(cfg, tp, pb, "attn.", bias=cfg.qkv_bias)
    norm_layout(cfg, tp, pb, "ln2")
    d, f = cfg.d_model, cfg.d_ff
    e_local = shard_dim(cfg.n_experts, tp, "n_experts")
    std = 1.0 / math.sqrt(d)
    dstd = 1.0 / math.sqrt(f) / math.sqrt(2 * cfg.n_layers)
    pb.add("router.w", (d, e_local), std=std, model_gather=tp, model_gather_dim=1)
    pb.add("moe.wg", (e_local, d, f), std=std)
    pb.add("moe.wu", (e_local, d, f), std=std)
    pb.add("moe.wd", (e_local, f, d), std=dstd)
    if cfg.n_shared_experts:
        mlp_layout(cfg, tp, pb, "shared.", d_ff=cfg.n_shared_experts * f)
    b.extend(pb)


def moe_capacity(n: int, cfg: ArchConfig) -> int:
    """Slots an expert for ``n`` tokens: ``ceil(n k / E * capacity_factor)``
    rounded up to a multiple of 4, at least 4 (the reference's
    expression, float for float)."""
    cap = int(math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(4, ((cap + 3) // 4) * 4)


def moe_route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig,
              live: torch.Tensor | None = None):
    """The router of ``n`` tokens: fp32 softmax over the experts, the top-k
    picks with their gates renormalised over the k, and each assignment's
    slot in its expert (``pos_in_e``: the assignments before it, token-major,
    to the same expert).  ``live`` [n] bool: rows outside it (the engine's
    dead rows) take no slot and are never kept.  Returns ``(probs [n, E],
    gate_vals [n, k], gate_idx [n, k], pos_in_e [n k], keep [n k] bool,
    cap)``."""
    n = x2d.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(n, cfg)
    probs = torch.softmax((x2d @ router_w).float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = gate_idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, e)
    live_k = None if live is None else live.repeat_interleave(k)
    if live_k is not None:
        onehot = onehot * live_k[:, None]
    pos_in_e = (torch.cumsum(onehot, 0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = pos_in_e < cap if live_k is None else (pos_in_e < cap) & live_k
    return probs, gate_vals, gate_idx, pos_in_e, keep, cap


def _moe_dispatch_tokens(x2d: torch.Tensor, t, cfg: ArchConfig, ctx: L.Ctx,
                         live: torch.Tensor | None = None):
    """GShard-style capacity dispatch with expert parallelism over the
    model group (``repro/models/blocks.py::_moe_dispatch_tokens``).
    x2d [n, d] -> (out [n, d], aux fp32 scalar).

    The kept assignments go to their unique (expert, slot) rows of a
    ``[E, cap + 1, d]`` buffer whose extra row per expert takes the dropped
    (and dead) ones and is cut off, so the scatter's and the combine's
    meaningful rows each see one assignment: no sum whose order could vary,
    and the recompute routes and sums as the forward did."""
    n, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx, pos_in_e, keep, cap = moe_route(x2d, t["router.w"], cfg, live)
    flat_e = gate_idx.reshape(-1)
    slot = flat_e * (cap + 1) + torch.where(keep, pos_in_e, cap)
    tok = x2d.repeat_interleave(k, dim=0)
    buf = x2d.new_zeros((e * (cap + 1), d)).index_copy(0, slot, tok)
    buf = buf.view(e, cap + 1, d)[:, :cap]
    if ctx.tp > 1:      # ship expert slabs to their owner ranks
        buf = ctx.comm.model_all_to_all(buf.contiguous(), to_owners=True)
    h = torch.nn.functional.silu(torch.bmm(buf, t["moe.wg"])) * torch.bmm(buf, t["moe.wu"])
    out = torch.bmm(h, t["moe.wd"])                      # [E_local, tp cap, d]
    if ctx.tp > 1:
        out = ctx.comm.model_all_to_all(out, to_owners=False)
    picked = torch.nn.functional.pad(out, (0, 0, 0, 1)).reshape(e * (cap + 1), d)
    picked = picked.index_select(0, slot)                # [n k, d]; dropped: zeros
    w = (gate_vals.reshape(-1) * keep).to(picked.dtype)
    y = torch.sum((picked * w[:, None]).reshape(n, k, d), dim=1)
    # switch-style load-balance loss (top-1)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(gate_idx[:, 0], e).float(), dim=0)
    return y, e * torch.sum(me * ce)


def moe_chunk(n: int) -> int:
    """Tokens a dispatch: 4096, 2048 or 1024 where ``n`` is larger and a
    multiple of it, else ``n``."""
    for cand in (4096, 2048, 1024):
        if n > cand and n % cand == 0:
            return cand
    return n


def _live_rows(x: torch.Tensor, ctx: L.Ctx) -> torch.Tensor | None:
    """The engine's live rows of ``x`` [b, s, d] as [b s] bool (rows past
    a slot's ``n_new`` are dead), None where every row is a token."""
    pages = ctx.pages
    if ctx.mode != "decode" or pages is None or pages.n_new is None:
        return None
    s = x.shape[1]
    live = torch.arange(s, device=x.device)[None, :] < pages.n_new.to(x.device)[:, None]
    return live.reshape(-1)


def moe_ffn(t, x: torch.Tensor, cfg: ArchConfig, ctx: L.Ctx):
    """Token-parallel MoE (``repro/models/blocks.py::moe_ffn``): at tp > 1
    each model rank routes its 1/tp of the tokens, the outputs are gathered
    over the model group (the adjoint a reduce-scatter) and aux is the
    model group's mean; fewer tokens than ranks, or a count tp does not
    divide (decode), take the replicated path, the exchange kept.  Chunks
    of :func:`moe_chunk` tokens dispatch one at a time.  aux is scaled by
    ``chunk / n`` twice, as the reference does (ROADMAP Queue 3).  The
    engine's dead rows (:func:`_live_rows`) take no expert slot; the
    capacity is still that of all ``n`` rows."""
    b, s, d = x.shape
    n = b * s
    tp = ctx.tp
    x2d = x.reshape(n, d)
    live = _live_rows(x, ctx)
    shard_tokens = tp > 1 and n % tp == 0 and n >= tp
    if shard_tokens:
        n = n // tp
        lo = ctx.tp_index() * n
        x2d = x2d[lo:lo + n]
        live = None if live is None else live[lo:lo + n]
    chunk = moe_chunk(n)
    ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, n, chunk):
        yc, a = _moe_dispatch_tokens(x2d[c0:c0 + chunk], t, cfg, ctx,
                                     None if live is None else live[c0:c0 + chunk])
        ys.append(yc)
        aux = aux + a
    aux = aux * (chunk / n)
    y = torch.cat(ys) if len(ys) > 1 else ys[0]
    if shard_tokens:
        y = ctx.comm.model_all_gather(y, axis=0)
        aux = ctx.comm.model_psum(aux) / tp
    out = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, t, x, ctx, "shared.")
    return out, aux * (chunk / n)


def moe_layer_apply(cfg: ArchConfig, ad: AttnDims, t, x, ctx: L.Ctx, cache=None,
                    prefix: str = ""):
    tt = strip_prefix(t, prefix)
    h = apply_norm(cfg, tt, x, "ln1")
    a, new_cache = self_attention(
        tt, h, ctx, ad, cfg, prefix="attn.", causal=True,
        use_rope=cfg.use_rope, bias=cfg.qkv_bias, cache=cache)
    x = x + a
    h = apply_norm(cfg, tt, x, "ln2")
    y, aux = moe_ffn(tt, h, cfg, ctx)
    return (x + y, aux), new_cache
