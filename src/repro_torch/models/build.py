"""Model registry: ArchConfig -> ModelDef (the port of
``repro/models/build.py``: the dense, MoE, VLM, encoder-decoder, griffin and
xLSTM families, RMSNorm or LayerNorm, SwiGLU, GeGLU or GeLU MLPs) and the
parameter counts."""

from __future__ import annotations

import functools
import math

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flat_param import LayoutBuilder
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models.dims import AttnDims, attn_dims, pad_to_tp, shard_dim
from repro_torch.models.lm import ModelDef, Pool


def _embed_pool(cfg: ArchConfig, tp: int) -> Pool:
    b = LayoutBuilder()
    b.add("emb.table", (cfg.vocab, shard_dim(cfg.d_model, tp)), std=0.02)
    if cfg.family == "encdec":   # learned positions: the tokens', the audio frames'
        b.add("emb.pos", (cfg.max_seq, shard_dim(cfg.d_model, tp)), std=0.02)
        b.add("emb.audio_pos", (cfg.n_audio_frames, shard_dim(cfg.d_model, tp)), std=0.02)
    return Pool("embed", b.build(), 1, apply=None)


def _head_pool(cfg: ArchConfig, tp: int, vocab_padded: int) -> Pool:
    b = LayoutBuilder()
    d_local = shard_dim(cfg.d_model, tp)
    b.add("final.scale", (d_local,), init="zeros", decay=False,
          model_gather=tp, model_gather_dim=0)
    if cfg.norm == "ln":
        b.add("final.bias", (d_local,), init="zeros", decay=False,
              model_gather=tp, model_gather_dim=0)
    b.add("head.w", (cfg.d_model, vocab_padded // tp), std=1.0 / math.sqrt(cfg.d_model))
    return Pool("head", b.build(), 1, apply=None)


def _wrap(apply):
    """Normalize sub-layer applies to ((x, aux), cache)."""

    def f(t, x, ctx, cache):
        out, nc = apply(t, x, ctx, cache)
        if isinstance(out, tuple):
            return out, nc
        return (out, 0.0), nc

    return f


def build_model(cfg: ArchConfig, tp: int) -> ModelDef:
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    vocab_padded = pad_to_tp(cfg.vocab, tp)
    if cfg.family == "dense":
        b = LayoutBuilder()
        B.dense_layer_layout(cfg, tp, b)
        apply = _wrap(lambda t, x, ctx, cache: B.dense_layer_apply(
            cfg, ad, t, x, ctx, cache, window=cfg.window))
        pools = (Pool(
            "layers", b.build(), cfg.n_layers, apply,
            make_cache=lambda bsz, clen, dtype, device: B.make_kv_cache(
                cfg, tp, bsz, clen, window=cfg.window, dtype=dtype, device=device)),)
    elif cfg.family == "moe":
        b = LayoutBuilder()
        B.moe_layer_layout(cfg, tp, b)
        pools = (Pool(
            "layers", b.build(), cfg.n_layers,
            lambda t, x, ctx, cache: B.moe_layer_apply(cfg, ad, t, x, ctx, cache),
            make_cache=lambda bsz, clen, dtype, device: B.make_kv_cache(
                cfg, tp, bsz, clen, dtype=dtype, device=device)),)
    elif cfg.family == "vlm":
        pools = (_vlm_pool(cfg, tp, ad),)
    elif cfg.family == "encdec":
        pools = _encdec_pools(cfg, tp, ad)
    elif cfg.family == "xlstm":
        every = cfg.slstm_every or 4
        pattern = ("m",) * (every - 1) + ("s",)
        n_super, rem = divmod(cfg.n_layers, len(pattern))
        pools = (_xlstm_pool(cfg, tp, pattern, n_super, "x"),)
        if rem:
            pools += (_xlstm_pool(cfg, tp, ("m",) * rem, 1, "xtail"),)
    elif cfg.family == "griffin":
        pattern = cfg.pattern or ("rec", "rec", "attn")
        n_super, rem = divmod(cfg.n_layers, len(pattern))
        pools = (_griffin_pool(cfg, tp, ad, pattern, n_super, "g"),)
        if rem:
            pools += (_griffin_pool(cfg, tp, ad, pattern[:rem], 1, "gtail"),)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return ModelDef(cfg=cfg, tp=tp, pools=pools,
                    embed=_embed_pool(cfg, tp),
                    head=_head_pool(cfg, tp, vocab_padded),
                    vocab_padded=vocab_padded)


def _griffin_pool(cfg: ArchConfig, tp: int, ad: AttnDims, pattern, stack: int,
                  name: str) -> Pool:
    """One pool of ``stack`` super-layers, each the sub-layers of ``pattern``
    under the prefixes ``rec0.``, ``rec1.``, ``attn0.``, ...; its cache is
    ``{prefix: rec cache | KV cache}``."""
    b = LayoutBuilder()
    kinds = []
    counts = {"rec": 0, "attn": 0}
    for kind in pattern:
        prefix = f"{kind}{counts[kind]}."
        counts[kind] += 1
        kinds.append((kind, prefix))
        if kind == "rec":
            R.griffin_rec_layout(cfg, tp, b, prefix=prefix)
        else:
            B.dense_layer_layout(cfg, tp, b, prefix=prefix)

    def apply(t, x, ctx, cache):
        nc = {}
        for kind, prefix in kinds:
            sub = cache.get(prefix) if cache else None
            if kind == "rec":
                x, c = R.griffin_rec_apply(cfg, t, x, ctx, sub, prefix=prefix)
            else:
                x, c = B.dense_layer_apply(
                    cfg, ad, t, x, ctx, sub, prefix=prefix, window=cfg.window)
            nc[prefix] = c
        if all(v is None for v in nc.values()):
            nc = None
        return (x, 0.0), nc

    def make_cache(bsz, clen, dtype, device):
        """The rec caches keep bf16 conv and fp32 h whatever ``dtype`` is."""
        return {prefix: (R.make_rec_cache(cfg, tp, bsz, device=device) if kind == "rec"
                         else B.make_kv_cache(cfg, tp, bsz, clen, window=cfg.window,
                                              dtype=dtype, device=device))
                for kind, prefix in kinds}

    return Pool(name, b.build(), stack, apply, make_cache)


def _vlm_pool(cfg: ArchConfig, tp: int, ad: AttnDims) -> Pool:
    """One pool of super-layers, each ``cross_interval`` dense layers
    (prefixes ``s0.``, ``s1.``, ...) and one gated cross-attention layer
    (``x.``); its cache is ``{"s0": KV cache, ..., "x": cross cache}``."""
    n_self = cfg.cross_interval
    n_super, rem = divmod(cfg.n_layers, n_self + 1)
    if rem:
        raise ValueError("vlm layer count must divide by (interval+1)")
    b = LayoutBuilder()
    for i in range(n_self):
        B.dense_layer_layout(cfg, tp, b, prefix=f"s{i}.")
    B.cross_layer_layout(cfg, tp, b, prefix="x.")

    def apply(t, x, ctx, cache):
        nc = {}
        for i in range(n_self):
            sub = cache.get(f"s{i}") if cache else None
            x, nc[f"s{i}"] = B.dense_layer_apply(cfg, ad, t, x, ctx, sub, prefix=f"s{i}.")
        x, nc["x"] = B.cross_layer_apply(cfg, ad, t, x, ctx, cache.get("x") if cache else None,
                                         prefix="x.")
        if all(v is None for v in nc.values()):
            nc = None
        return (x, 0.0), nc

    def make_cache(bsz, clen, dtype, device):
        c = {f"s{i}": B.make_kv_cache(cfg, tp, bsz, clen, dtype=dtype, device=device)
             for i in range(n_self)}
        c["x"] = B.make_cross_cache(cfg, tp, bsz, cfg.n_vision_tokens, dtype=dtype,
                                    device=device)
        return c

    return Pool("layers", b.build(), n_super, apply, make_cache)


def _encdec_pools(cfg: ArchConfig, tp: int, ad: AttnDims) -> tuple[Pool, Pool]:
    """whisper: the ``enc`` pool, ``n_encoder_layers`` dense layers with
    non-causal self-attention and no cache (``lm.forward`` runs it over the
    audio frames first), and the ``dec`` pool, ``n_layers`` decoder layers
    whose cache is ``{"self": KV cache, "cross": cross cache over the
    n_audio_frames}``."""
    be = LayoutBuilder()
    B.dense_layer_layout(cfg, tp, be)
    enc = Pool("enc", be.build(), cfg.n_encoder_layers, _wrap(
        lambda t, x, ctx, cache: B.dense_layer_apply(cfg, ad, t, x, ctx, cache, causal=False)))
    bd = LayoutBuilder()
    B.encdec_dec_layout(cfg, tp, bd)

    def make_cache(bsz, clen, dtype, device):
        return {"self": B.make_kv_cache(cfg, tp, bsz, clen, dtype=dtype, device=device),
                "cross": B.make_cross_cache(cfg, tp, bsz, cfg.n_audio_frames, dtype=dtype,
                                            device=device)}

    dec = Pool("dec", bd.build(), cfg.n_layers, _wrap(
        lambda t, x, ctx, cache: B.encdec_dec_apply(cfg, ad, t, x, ctx, cache)), make_cache)
    return enc, dec


def _xlstm_pool(cfg: ArchConfig, tp: int, pattern, stack: int, name: str) -> Pool:
    """One pool of ``stack`` super-layers, each the mLSTM (``m``) and sLSTM
    (``s``) blocks of ``pattern`` under the prefixes ``m0.``, ``m1.``, ...,
    ``s0.``; its cache is ``{prefix: mLSTM | sLSTM state}``, fp32 states
    (and a bf16 conv window) whatever the cache dtype."""
    b = LayoutBuilder()
    kinds = []
    counts = {"m": 0, "s": 0}
    for kind in pattern:
        prefix = f"{kind}{counts[kind]}."
        counts[kind] += 1
        kinds.append((kind, prefix))
        (R.mlstm_layout if kind == "m" else R.slstm_layout)(cfg, tp, b, prefix=prefix)

    def apply(t, x, ctx, cache):
        nc = {}
        for kind, prefix in kinds:
            sub = cache.get(prefix) if cache else None
            block = R.mlstm_apply if kind == "m" else R.slstm_apply
            x, nc[prefix] = block(cfg, t, x, ctx, sub, prefix=prefix)
        if all(v is None for v in nc.values()):
            nc = None
        return (x, 0.0), nc

    def make_cache(bsz, clen, dtype, device):
        return {prefix: (R.make_mlstm_cache if kind == "m" else R.make_slstm_cache)(
            cfg, bsz, device=device) for kind, prefix in kinds}

    return Pool(name, b.build(), stack, apply, make_cache)


@functools.lru_cache(maxsize=None)
def _counts(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) parameters: an expert segment (``moe.*``) counts
    ``top_k / n_experts`` of its size as active (rounded down per pool, as
    the reference)."""
    total = active = 0
    for pool in build_model(cfg, tp=1).all_pools():
        for seg in pool.layout.segments:
            n = seg.size * pool.stack
            total += n
            active += (int(n * cfg.top_k / max(cfg.n_experts, 1))
                       if seg.name.startswith("moe.") else n)
    return total, active


def exact_param_count(cfg: ArchConfig) -> int:
    return _counts(cfg)[0]


def active_param_count(cfg: ArchConfig) -> int:
    """The parameters a token runs through (MoE: k of the E experts)."""
    return _counts(cfg)[1]
