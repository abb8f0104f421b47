"""Dense transformer layer (the port of the dense part of
``repro/models/blocks.py``).

Each sub-block provides ``*_layout(cfg, tp, b)`` (appends its segments to a
LayoutBuilder) and ``*_apply`` (a plain function over unflattened tensors).
Self-attention runs in prefill mode, in contiguous decode at a scalar
position, and at per-request positions (a ``[b]`` tensor ``ctx.pos``: the
continuous-batching engine), over a contiguous cache or a paged KV pool
(``ctx.pages``).
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
    bs = cache["k"].shape[1]
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
    where they lie, dequantizing int8 pages in its load: no view is made
    on the card)."""
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
        # outputs the scheduler ignores.
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
            out = _paged_kv_read(cache, pages, q, absp + 1)
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


def make_kv_cache(cfg: ArchConfig, tp: int, batch: int, cache_len: int, *,
                  window: int = 0, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str):
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    cap = min(window, cache_len) if window else cache_len
    shape = (batch, cap, ad.hkv_local, ad.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def norm_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, name: str):
    b.add(name + ".scale", (shard_dim(cfg.d_model, tp),), init="zeros", decay=False,
          model_gather=tp, model_gather_dim=0)


def apply_norm(cfg: ArchConfig, t, x, name: str):
    return L.rms_norm(x, t[name + ".scale"])


def mlp_layout(cfg: ArchConfig, tp: int, b: LayoutBuilder, prefix: str = "mlp."):
    d = cfg.d_model
    f_local = shard_dim(cfg.d_ff, tp, "d_ff")
    b.add(prefix + "wg", (d, f_local), std=1.0 / math.sqrt(d))
    b.add(prefix + "wu", (d, f_local), std=1.0 / math.sqrt(d))
    b.add(prefix + "wd", (f_local, d),
          std=1.0 / math.sqrt(cfg.d_ff) / math.sqrt(2 * cfg.n_layers))


def mlp_apply(cfg: ArchConfig, t, x, ctx: L.Ctx, prefix: str = "mlp."):
    """Column-parallel gate and up projections, row-parallel down
    projection, then the psum over the model group."""
    if cfg.mlp == "swiglu":
        out = L.mlp_swiglu(x, t[prefix + "wg"], t[prefix + "wu"], t[prefix + "wd"])
    elif cfg.mlp == "geglu":
        out = L.mlp_geglu(x, t[prefix + "wg"], t[prefix + "wu"], t[prefix + "wd"])
    else:
        raise NotImplementedError(f"mlp {cfg.mlp!r}: the port runs swiglu and geglu so far")
    return L.tp_psum(out, ctx)


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
