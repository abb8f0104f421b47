"""Model assembly: pools of stacked layers + embedding / head, with every
parameter gather routed through the ``CommEngine`` (the port of
``repro/models/lm.py``: the serve entry points and the training loss).

A ``Pool`` is a stack of identical layers whose parameters live in one flat
buffer per layer and model coordinate (``[stack, tp, flat_len]`` in all).
The forward pass loops over the stack; each layer's flat row is gathered
(one call per layer, the paper's coalesced gather), unflattened into views
(the segments stored sharded over the model axis gathered along it at tp >
1), and applied.  A rank's flat rows of a pool are a ``[stack, 1, S]``
tensor (its model coordinate's), or, on the training path, a list of
``[S]`` rows that each carry a gradient.

Two schedules (``CommEngine.prefetch`` selects):

* **serial** — gather layer i, compute layer i;
* **prefetch** — layer i+1's gather is issued before layer i's compute
  (``CommEngine.gather_ahead``: at p > 1 on a card, on a side stream that
  the compute stream waits on through an event; elsewhere in program
  order).  The same gathers run on the same rows and the same compute in
  the same order, so the two schedules give bitwise-equal results.

In train mode each layer's compute runs under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` wraps it
in the reference: the serial schedule checkpoints gather + compute, so the
backward re-gathers; the prefetch schedule checkpoints unflatten + compute
from the gathered buffer, which is the saved input (the reference's stored
carry), so the backward recomputes from it without a re-gather.

Two more carries of the prefetch schedule, in train mode for pools of more
than one layer (``CommEngine.prefetch_carry`` / ``carry_offload``), change
only what the forward keeps for the backward; the forward is the prefetch
loop's, the backward's operations are the stored carry's, so losses and
gradients are bitwise the stored carry's:

* **remat** — the checkpoint's inputs are the layer input and the fp32
  row; the forward computes from the prefetched buffer and drops it, the
  backward's recompute re-gathers the row (at p > 1 one more all-gather a
  pool row and micro-step).
* **host offload** — the gathered buffer, a checkpoint input, goes to a
  pinned host slot as the layer starts (``CommEngine.host_stash``, after
  the next layer's gather is issued) and comes back to the card when the
  backward's recompute needs it; the layer input stays on the card.

A pool that reads an encoder output (``ctx.enc_out``: whisper's decoder)
keeps the stored carry under both, as the reference does (its custom VJP
would drop the encoder output's gradient); the encoder pools, which run
first over the audio frames, take every carry.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.hostoffload import Carry
from repro_torch.core.flat_param import FlatLayout
from repro_torch.kernels.quant.kernel import mix32
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class Pool:
    name: str
    layout: FlatLayout
    stack: int
    # apply(tensors, x, ctx, cache) -> ((x, aux), new_cache)
    apply: Callable | None
    # make_cache(batch, cache_len, dtype, device) -> cache (nested dict of
    # tensors) for ONE layer
    make_cache: Callable | None = None


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    tp: int
    pools: tuple[Pool, ...]
    embed: Pool
    head: Pool
    vocab_padded: int

    def pool(self, name: str) -> Pool:
        for p in (*self.pools, self.embed, self.head):
            if p.name == name:
                return p
        raise KeyError(name)

    def all_pools(self) -> tuple[Pool, ...]:
        return (self.embed, *self.pools, self.head)

    def global_flat_shapes(self) -> dict[str, tuple[int, int, int]]:
        return {p.name: (p.stack, self.tp, p.layout.flat_len) for p in self.all_pools()}


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict of tensors (a pool's
    cache: ``{k, v}`` for the dense family, ``{prefix: {...}}`` for griffin
    and xLSTM, ``{"s0": {k, v}, ..., "x": {k, v}}`` for the VLM)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: list):
    """Stack same-structured nested dicts leaf by leaf along a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer_cache(caches, i: int):
    """Layer i's cache as views of the stacked pool cache, so decode's
    in-place writes land in ``caches``."""
    return None if caches is None else _tree_map(lambda a: a[i], caches)


def _pool_caches(caches, new: list):
    """Decode updated ``caches`` in place; prefill returns fresh per-layer
    caches, stacked here along the pool's stack dim.  An empty pool (a
    griffin model with fewer layers than its pattern) has none."""
    if caches is not None:
        return caches
    if not new or new[0] is None:
        return None
    return _stack(new)


def _row(flat_rows, i: int):
    """Layer i's flat row: of a ``[stack, 1, S]`` pool tensor, the i-th of a
    list of rows (the training path's leaves), or of each leaf of a stored
    int8 serving pool ``{'q': [stack, 1, S], 's': [stack, 1, nb]}``."""
    if isinstance(flat_rows, dict):
        return {k: v[i, 0] for k, v in flat_rows.items()}
    return flat_rows[i] if isinstance(flat_rows, (list, tuple)) else flat_rows[i, 0]


def _layer_from_full(pool: Pool, comm, ctx: L.Ctx, x, full):
    (x, aux), _ = pool.apply(comm.unflatten(pool, full), x, ctx, None)
    return x, aux


def _layer_from_row(pool: Pool, comm, ctx: L.Ctx, x, row):
    return _layer_from_full(pool, comm, ctx, x, comm.gather_flat(row, seed=ctx.step_seed))


def _checkpointed(fn, *args):
    """``fn(*args)`` under non-reentrant activation checkpointing: only the
    inputs are saved and the backward recomputes ``fn``.  The layers draw
    no random numbers, so the RNG state is not stashed."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _training(ctx: L.Ctx) -> bool:
    """Train mode with autograd recording: the layers run checkpointed.
    (The encoder pools run in train mode at a prefill too, without
    gradients: no cache, non-causal attention over every frame.)"""
    return ctx.mode == "train" and torch.is_grad_enabled()


def _apply_pool(pool: Pool, flat_rows, x, ctx: L.Ctx, comm, caches=None):
    """Run a pool over its stack.  flat_rows: [stack, 1, S_local], or a
    list of [S_local] rows."""
    if comm.prefetch and pool.stack > 1:
        # the encoder output carries gradient into the layers that read it:
        # those keep the stored carry (the reference's routing)
        carries = _training(ctx) and ctx.enc_out is None
        if carries and comm.carry_offload == "host":
            return _apply_pool_prefetch_offload(pool, flat_rows, x, ctx, comm)
        if carries and comm.prefetch_carry == "remat":
            return _apply_pool_prefetch_remat(pool, flat_rows, x, ctx, comm)
        return _apply_pool_prefetch(pool, flat_rows, x, ctx, comm, caches)
    return _apply_pool_serial(pool, flat_rows, x, ctx, comm, caches)


def _apply_pool_serial(pool, flat_rows, x, ctx, comm, caches):
    """Reference schedule: gather layer i, then compute layer i; in train
    mode both under one checkpoint, so the backward re-gathers."""
    aux_tot, new = 0.0, []
    for i in range(pool.stack):
        if _training(ctx):
            x, aux = _checkpointed(functools.partial(_layer_from_row, pool, comm, ctx), x,
                                   _row(flat_rows, i))
            nc = None
        else:
            tensors = comm.gather(pool, _row(flat_rows, i), seed=ctx.step_seed)
            (x, aux), nc = pool.apply(tensors, x, ctx, _layer_cache(caches, i))
        aux_tot += aux
        new.append(nc)
    return x, aux_tot, _pool_caches(caches, new)


def _apply_pool_prefetch(pool, flat_rows, x, ctx, comm, caches):
    """Lookahead schedule: layer i+1's gather is issued before layer i's
    compute.  The reference's wrap-around gather of row 0 on the last layer
    (its result is discarded) is not issued.  In train mode layer i's
    unflatten + compute run under a checkpoint whose saved input is the
    gathered buffer (the stored carry)."""
    aux_tot, new = 0.0, []
    cur = comm.gather_ahead(_row(flat_rows, 0), seed=ctx.step_seed)
    for i in range(pool.stack):
        nxt = (comm.gather_ahead(_row(flat_rows, i + 1), seed=ctx.step_seed)
               if i + 1 < pool.stack else None)
        if _training(ctx):
            x, aux = _checkpointed(functools.partial(_layer_from_full, pool, comm, ctx), x, cur)
            nc = None
        else:
            tensors = comm.unflatten(pool, cur)
            (x, aux), nc = pool.apply(tensors, x, ctx, _layer_cache(caches, i))
        aux_tot += aux
        new.append(nc)
        cur = nxt
    return x, aux_tot, _pool_caches(caches, new)


def _layer_from_carry(pool: Pool, comm, ctx: L.Ctx, carry: list, x, row):
    """The layer from the prefetched buffer in ``carry``, taken out so that
    nothing keeps it, in the forward; from a re-gather of ``row`` in the
    backward's recompute (the remat carry)."""
    full = carry.pop() if carry else comm.gather_flat(row, seed=ctx.step_seed)
    return _layer_from_full(pool, comm, ctx, x, full)


def _apply_pool_prefetch_remat(pool, flat_rows, x, ctx, comm):
    """The prefetch loop with the remat carry: layer i+1's gather is issued
    before layer i's compute, which reads the prefetched buffer; its
    checkpoint keeps the layer input and the row (a leaf the state holds
    anyway), so the backward re-gathers the row, recomputes the layer from
    it and runs the same gather adjoint (the reference's
    ``_apply_pool_prefetch_remat``, with a custom VJP there)."""
    aux_tot = 0.0
    cur = comm.gather_ahead(_row(flat_rows, 0), seed=ctx.step_seed)
    for i in range(pool.stack):
        nxt = (comm.gather_ahead(_row(flat_rows, i + 1), seed=ctx.step_seed)
               if i + 1 < pool.stack else None)
        x, aux = _checkpointed(functools.partial(_layer_from_carry, pool, comm, ctx, [cur]),
                               x, _row(flat_rows, i))
        aux_tot += aux
        cur = nxt
    return x, aux_tot, None


class _HostCarry:
    """Saved-tensor hooks of one checkpointed layer of the host-offloaded
    carry: the pack hook moves exactly the layer's gathered buffer (matched
    by identity, never by shape) into its pinned slot; every other saved
    tensor, the layer input, stays as it is.  The unpack hook brings the
    buffer back to the card."""

    def __init__(self, stash, key, buf: torch.Tensor):
        self.stash, self.key, self.buf = stash, key, buf

    def pack(self, t: torch.Tensor):
        if self.buf is not None and t is self.buf:
            return self.stash.put(self.key, t)
        return t

    def unpack(self, packed):
        return self.stash.get(packed) if isinstance(packed, Carry) else packed


def _apply_pool_prefetch_offload(pool, flat_rows, x, ctx, comm):
    """The prefetch loop with the stored carry in host memory: as
    :func:`_apply_pool_prefetch`, but each layer's checkpoint saves its
    gathered buffer into the pinned slot ``(pool, layer)`` of
    ``comm.host_stash`` (the copy issued after layer i+1's gather), and the
    backward's recompute fetches it back (the reference's
    ``_apply_pool_prefetch_offload``)."""
    stash, tag = comm.host_stash, comm.carry_tag(pool.name)
    aux_tot = 0.0
    cur = comm.gather_ahead(_row(flat_rows, 0), seed=ctx.step_seed)
    for i in range(pool.stack):
        nxt = (comm.gather_ahead(_row(flat_rows, i + 1), seed=ctx.step_seed)
               if i + 1 < pool.stack else None)
        hooks = _HostCarry(stash, (tag, i), cur)
        with torch.autograd.graph.saved_tensors_hooks(hooks.pack, hooks.unpack):
            x, aux = _checkpointed(functools.partial(_layer_from_full, pool, comm, ctx), x, cur)
        hooks.buf = None      # the graph keeps the hooks: they must not keep the buffer
        aux_tot += aux
        cur = nxt
    return x, aux_tot, None


def embed_tokens(model: ModelDef, t_embed, tokens, ctx: L.Ctx, *, pos=None):
    """The token rows, plus the learned positions where the model has them
    (``emb.pos``, enc-dec): positions ``0 ... t - 1`` for ``pos`` None,
    ``pos[b] + i`` for a [b] tensor, else ``pos`` for every token (a decode
    step at a scalar position)."""
    x = L.embed_lookup(t_embed["emb.table"], tokens, ctx)
    if "emb.pos" in t_embed:
        b, t = tokens.shape
        ar = torch.arange(t, device=tokens.device)
        if pos is None:
            positions = ar.expand(b, t)
        elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
            positions = pos.to(tokens.device).long()[:, None] + ar[None, :]
        else:
            positions = torch.full((b, t), int(pos), dtype=torch.int64, device=tokens.device)
        x = x + L.embed_lookup(t_embed["emb.pos"], positions, ctx)
    return x.to(ctx.compute_dtype)


def encode_audio(model: ModelDef, t_embed, audio, ctx: L.Ctx):
    """whisper's stub frontend: the precomputed frame embeddings ``audio``
    [b, n_frames, d] plus the learned frame positions."""
    b, frames = audio.shape[:2]
    positions = torch.arange(frames, device=audio.device).expand(b, frames)
    pe = L.embed_lookup(t_embed["emb.audio_pos"], positions, ctx)
    return (audio + pe).to(ctx.compute_dtype)


def lm_logits(model: ModelDef, t_head, x, ctx: L.Ctx):
    if model.cfg.norm == "ln":
        x = L.layer_norm(x, t_head["final.scale"], t_head["final.bias"])
    else:
        x = L.rms_norm(x, t_head["final.scale"])
    return x @ t_head["head.w"]


def forward(model: ModelDef, flat: dict[str, torch.Tensor], comm, ctx: L.Ctx,
            batch: dict[str, torch.Tensor], caches: dict | None = None):
    """Embedding -> pools -> final hidden states.  The VLM's batch carries
    ``vision`` [b, n_vision_tokens, d] outside decode; enc-dec's carries
    ``audio`` [b, n_audio_frames, d] there, which the ``enc`` pools encode
    first (train mode, no cache) into ``ctx.enc_out`` for the decoder.

    Returns (hidden, aux_loss, new_caches, t_head).
    """
    t_embed = comm.gather(model.embed, _row(flat["embed"], 0), seed=ctx.step_seed)
    aux_total = 0.0
    new_caches: dict[str, Any] = {}
    encdec = model.cfg.family == "encdec"
    if encdec and ctx.mode != "decode":
        # decode reads the encoder output's K/V from the cross caches
        enc_x = encode_audio(model, t_embed, batch["audio"], ctx)
        enc_ctx = dataclasses.replace(ctx, mode="train", pos=None)
        for pool in model.pools:
            if pool.name.startswith("enc"):
                enc_x, aux, _ = _apply_pool(pool, flat[pool.name], enc_x, enc_ctx, comm)
                aux_total += aux
        ctx = dataclasses.replace(ctx, enc_out=enc_x)
    if model.cfg.family == "vlm" and ctx.mode != "decode":
        # decode reads the vision rows' K/V from the cross layers' caches
        ctx = dataclasses.replace(ctx, vision=batch["vision"].to(ctx.compute_dtype))
    x = embed_tokens(model, t_embed, batch["tokens"], ctx, pos=ctx.pos)
    for pool in model.pools:
        if encdec and pool.name.startswith("enc"):
            continue
        pool_cache = caches.get(pool.name) if caches is not None else None
        x, aux, nc = _apply_pool(pool, flat[pool.name], x, ctx, comm, pool_cache)
        aux_total += aux
        if nc is not None:
            new_caches[pool.name] = nc
    t_head = comm.gather(model.head, _row(flat["head"], 0), seed=ctx.step_seed)
    return x, aux_total, new_caches, t_head


def loss_fn(model: ModelDef, flat, comm, ctx: L.Ctx, batch: dict[str, torch.Tensor]):
    """Token cross-entropy + the router's aux loss (0 for the families the
    port builds).  batch: tokens / targets / mask [b, T].  Returns
    ``(loss, {"loss": ce, "aux": aux})``."""
    hidden, aux, _, t_head = forward(model, flat, comm, ctx, batch)
    logits = lm_logits(model, t_head, hidden, ctx)
    ce = L.tp_cross_entropy(logits, batch["targets"], batch["mask"],
                            vocab_real=model.cfg.vocab, vocab_padded=model.vocab_padded,
                            ctx=ctx)
    loss = ce + model.cfg.router_aux_weight * aux
    return loss, {"loss": ce, "aux": aux}


def prefill(model: ModelDef, flat, comm, ctx: L.Ctx, batch):
    """Forward over the prompt, returning per-pool caches + last logits."""
    ctx = dataclasses.replace(ctx, mode="prefill")
    hidden, _, new_caches, t_head = forward(model, flat, comm, ctx, batch)
    logits = lm_logits(model, t_head, hidden[:, -1:].contiguous(), ctx)
    return logits, new_caches


def decode_step(model: ModelDef, flat, comm, ctx: L.Ctx, tokens: torch.Tensor,
                pos, caches: dict, *, pages=None, rows: torch.Tensor | None = None):
    """Tokens [b, tq] at absolute position ``pos`` (an int), or at
    per-request positions (a [b] tensor: row i of request b is at
    ``pos[b] + i``), over contiguous caches or, with ``pages``
    (``runtime/paged.PageState``), over paged KV pools; the caches update
    in place.  Logits [b, tq, V]; with ``rows`` [b] only those of token
    ``rows[b]`` of each request, [b, 1, V] (the final norm and the head run
    on those rows alone)."""
    ctx = dataclasses.replace(ctx, mode="decode", pos=pos, pages=pages)
    hidden, _, new_caches, t_head = forward(
        model, flat, comm, ctx, {"tokens": tokens}, caches)
    if rows is not None:
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        rows.to(hidden.device)][:, None]
    logits = lm_logits(model, t_head, hidden, ctx)
    return logits, new_caches


def init_caches(model: ModelDef, batch: int, cache_len: int, *,
                dtype: torch.dtype = torch.bfloat16, device: torch.device | str):
    """Initial caches for every pool (one layer's ``make_cache`` repeated
    along the pool's stack dim: zeros, and xLSTM's stabiliser states at
    their start value)."""
    caches = {}
    for pool in model.pools:
        if pool.make_cache is None:
            continue
        one = pool.make_cache(batch, cache_len, dtype, device)
        caches[pool.name] = _tree_map(
            lambda a: a.unsqueeze(0).repeat(pool.stack, *(1,) * a.dim()), one)
    return caches


def greedy_sample(logits_local: torch.Tensor, ctx: L.Ctx, vocab_real: int) -> torch.Tensor:
    """Argmax over the vocab-parallel logits (this rank's columns
    ``tp_index * V/tp ...``), padded vocab columns masked; at tp > 1 the
    local argmax, the pmax of the maxima and the pmin of the candidate
    indices (ties go to the lowest global column)."""
    vl = logits_local.shape[-1]
    start = ctx.tp_index() * vl
    lg = logits_local.float()
    col = start + torch.arange(vl, device=lg.device)
    lg = torch.where(col < vocab_real, lg, torch.full_like(lg, L.NEG_INF))
    return _global_argmax(lg, start, ctx)


def _global_argmax(scores: torch.Tensor, start: int, ctx: L.Ctx) -> torch.Tensor:
    """The global column of each row's largest score over the model group:
    the local argmax, then at tp > 1 the pmax of the maxima and the pmin of
    the candidates' columns (ties go to the lowest global column)."""
    local_arg = torch.argmax(scores, dim=-1) + start
    if ctx.tp == 1:
        return local_arg
    local_max = torch.amax(scores, dim=-1)
    gmax = ctx.comm.model_pmax(local_max)
    cand = torch.where(local_max >= gmax, local_arg,
                       torch.full_like(local_arg, torch.iinfo(torch.int64).max))
    return ctx.comm.model_pmin(cand)


# Salt of the sampler's counter hash (distinct from the quantizer's keys).
SAMPLER_SALT = 0x5EED0A17


def gumbel_noise(seed: torch.Tensor, pos: torch.Tensor, cols: int, start: int = 0) -> torch.Tensor:
    """Gumbel(0, 1) noise [b, cols] for the vocab columns ``start ...
    start + cols`` of request b: ``-log(-log(u))`` with ``u`` a counter
    hash of (request seed, token position, global column), the quantizer's
    ``mix32`` rounds: ``k1 = mix32(seed ^ SAMPLER_SALT)``, ``k2 = mix32(k1 ^
    pos)``, ``h = mix32(mix32(col ^ k2) ^ k1)``, ``u = ((h >> 9) + 0.5) /
    2^23`` in (0, 1).  A draw is a function of (seed, position, column)
    alone: the same in any slot, batch, chunking or vocab shard, and the
    same integer bits on the CPU and the card (the logs may round an ulp
    apart there)."""
    m32 = 0xFFFFFFFF
    k1 = mix32((seed.to(torch.int64) & m32) ^ SAMPLER_SALT)
    k2 = mix32(k1 ^ (pos.to(device=k1.device, dtype=torch.int64) & m32))
    col = torch.arange(start, start + cols, dtype=torch.int64, device=k1.device)
    h = mix32(mix32(col[None, :] ^ k2[:, None]) ^ k1[:, None])
    u = ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def sample_tokens(logits_local: torch.Tensor, ctx: L.Ctx, vocab_real: int, *,
                  seed: torch.Tensor, pos: torch.Tensor, temperature: torch.Tensor,
                  top_k: int = 0) -> torch.Tensor:
    """Seeded categorical sampler over the vocab-parallel logits [b, V/tp]
    (this rank's columns ``tp_index * V/tp ...``) -> [b] global ids (the
    port of ``repro/models/lm.py::sample_tokens``).

    Exact Gumbel-max: ``argmax(logits / T + G)`` with G drawn by
    :func:`gumbel_noise` from (request seed [b], position of the sampled
    token [b], global vocab column), so decoding is reproducible per (seed,
    position) and distinct across both.  Rows with ``temperature == 0``
    take the noiseless argmax, bitwise :func:`greedy_sample`.  ``top_k``
    keeps the columns at or above the k-th largest logit (exact: ties at
    the threshold stay).  At tp > 1 each shard draws its own columns' noise
    (the same draws as at tp 1), the shards' top-k values are gathered over
    the model group and the global k-th taken as the threshold (the true
    top-k, where the reference keeps the union of per-shard top-k: ROADMAP
    Queue 3), and the argmax is :func:`greedy_sample`'s pmax / pmin (ties
    to the lowest global column).  So a draw is bitwise the same at any tp.
    What is held: the draw's determinism, greedy parity, the law
    softmax(logits / T) over the kept columns.  What is not: JAX's bits
    (its noise is threefry, ``jax.random.gumbel``), so a sampled row does
    not match the reference's token for token.
    """
    b, vl = logits_local.shape
    start = ctx.tp_index() * vl
    lg = logits_local.float()
    col = start + torch.arange(vl, device=lg.device)
    lg = torch.where(col < vocab_real, lg, torch.full_like(lg, L.NEG_INF))
    if top_k:
        k = min(top_k, vl * ctx.tp)
        top = torch.topk(lg, min(top_k, vl), dim=-1).values
        if ctx.tp > 1:
            top = ctx.comm.model_all_gather(top, axis=-1)
        thr = torch.topk(top, k, dim=-1).values[:, -1:] if ctx.tp > 1 else top[:, k - 1:k]
        lg = torch.where(lg < thr, torch.full_like(lg, L.NEG_INF), lg)
    temp = temperature.to(device=lg.device, dtype=torch.float32)[:, None]
    g = gumbel_noise(seed.to(lg.device), pos, vl, start)
    # masked lanes stay masked: NEG_INF / T + G is still below any real score
    scores = torch.where(temp > 0, lg / torch.clamp_min(temp, 1e-6) + g, lg)
    return _global_argmax(scores, start, ctx)
