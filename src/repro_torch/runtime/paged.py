"""Paged KV-cache allocator + paged decode step (the port of
``repro/runtime/paged.py``).

Contiguous serving caches reserve ``cache_len`` slots a request up front;
ragged traffic at very different lengths leaves most of them dead.  The
paged layout replaces the per-request axis with a shared pool of fixed-size
blocks:

    contiguous:  k [stack, batch, cache_len, heads, dh]
    paged:       k [stack, n_blocks, block_size, heads, dh]
                 block_tables [batch, max_blocks] int32

Each request owns a list of blocks; table entry ``i`` maps token positions
``[i * block_size, (i + 1) * block_size)`` to a block.  Blocks return to
the free list the moment a request completes, so the resident batch is
bounded by live tokens, not by the worst-case length.  Over ranks the
placement is the contiguous caches': each data rank owns its allocator and
its pool of ``n_blocks_local`` blocks (table entries are rank-local ids)
and runs its rows of the global batch; heads go over the model group
(``hkv_local`` a rank, int8 scale pages placed alike), with the head-slot
replication of DESIGN.md §3 where ``n_kv_heads < tp``.

Block 0 of every rank's pool is reserved as the *garbage block*: it is
never allocated, unset table entries point at it, and the step writes
padding rows there as zeros, so it stays all zeros and reads through an
unset entry are zeros that the per-request valid lengths mask out of the
softmax.

Bitwise discipline: attention runs on the flash kernel's ``paged`` route
(``kernels/flash_attention``), whose split plan depends only on the batch,
the KV heads and the capacity ``max_blocks * block_size``; the
contiguous reference step (:func:`build_contiguous_step`) runs the same
kernel over its ``[b, capacity, ...]`` cache as a pool of one block a
request, on the same plan, so paged decode is bitwise equal to it
(``tests/test_torch_paged.py`` on the CPU, ``chip_smoke.py``'s
``serve_paged`` on the card).

Int8 KV blocks (``kv_dtype='int8'``) reuse ``core/quant.py``'s absmax block
quantizer (nearest rounding): each token row is quantized once, when it is
written, per (token, head, 128 values of head_dim), with fp32 scale pages
beside the values; blocks are never re-quantized.  Per element the error is
at most 1/254 of the row block's absmax.  The kernel dequantizes pages in
shared memory.

Rows past a slot's ``n_new`` (the padding of a chunk-width tick, and every
row of an idle slot) reach attention with valid length 0: the ``paged``
route skips them and gives them zero output, which nothing reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.core.autotune import resolve_config
from repro_torch.core.mics import KV_DTYPES, MiCSConfig
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import padded_head_dim
from repro_torch.models import lm
from repro_torch.models.lm import ModelDef
from repro_torch.runtime.serving import local_rows, serve_engine

_KV_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PageState:
    """Per-step paged-cache state threaded through ``Ctx.pages``.

    block_tables: [b, max_blocks] int32 block ids.
    block_size:   tokens a block.
    n_new:        [b] int32 tokens consumed a slot this tick, or None (all
                  ``tq`` rows valid: plain decode).
    """

    block_tables: Any
    block_size: int
    n_new: Any = None


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold ``n_tokens`` cache positions."""
    return -(-max(n_tokens, 0) // block_size)


class PagedKVAllocator:
    """Host-side free-list allocator for one rank's block pool.

    Block 0 is the reserved garbage block (never handed out).  Allocation
    is lowest-id-first so refilled slots reuse just-freed blocks: the
    pool's steady-state working set stays compact.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> lowest id

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n blocks, or None (and no change) if the pool can't supply them."""
        if n < 0:
            raise ValueError("negative block count")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if not 0 < b < self.n_blocks:
                raise ValueError(f"bad block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(sorted(blocks, reverse=True))
        self._free.sort(reverse=True)

    def reset(self) -> None:
        """Return every block to the pool (outstanding tables invalid).

        The rebuild path: after a crash or a KV-dtype change the pools are
        re-initialised and every resident request replays from its prompt,
        so the allocator forgets all outstanding allocations at once."""
        self._free = list(range(self.n_blocks - 1, 0, -1))


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

def _check_paged_support(model: ModelDef) -> None:
    if model.cfg.window:
        raise NotImplementedError(
            "paged KV serving requires window == 0 (no rolling caches)")
    for pool in model.pools:
        if pool.make_cache is None:
            raise NotImplementedError(
                f"pool {pool.name!r} has no KV cache (family "
                f"{model.cfg.family!r} is not paged-servable)")
        one = pool.make_cache(1, 8, torch.float32, "cpu")
        if set(one) != {"k", "v"} or not isinstance(one["k"], torch.Tensor) \
                or one["k"].dim() != 4:
            raise NotImplementedError(
                f"pool {pool.name!r} cache is not a plain k/v dict "
                f"(family {model.cfg.family!r} is not paged-servable)")


def paged_cache_local(model: ModelDef, n_blocks_local: int, block_size: int,
                      kv_dtype: str = "bf16", *, device: str | torch.device = "cuda"):
    """One rank's zero paged pools, stacked over each pool's layers.

    Leaves a pool: k / v [stack, n_blocks, block_size, h_local, dh] (+ fp32
    scale pages ks / vs [stack, n_blocks, block_size, h_local, n_scale] when
    ``kv_dtype='int8'``).  A head dim outside the flash kernels' is stored
    zero-padded to ``padded_head_dim`` (bert-50b's 204 at 256), the width
    the ``paged`` route reads; the step's writes pad to it.
    """
    _check_paged_support(model)
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}")
    dev = resolve_device(device)
    caches = {}
    for pool in model.pools:
        one = pool.make_cache(1, block_size, torch.float32, "cpu")
        *rest, dh = one["k"].shape[1:]                   # [stack, nb, bs, h, dh]
        shape = (pool.stack, n_blocks_local, *rest, padded_head_dim(dh))
        if kv_dtype == "int8":
            sc = (*shape[:-1], Q.n_blocks(shape[-1]))
            caches[pool.name] = {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.zeros(sc, dtype=torch.float32, device=dev),
                "vs": torch.zeros(sc, dtype=torch.float32, device=dev)}
        else:
            dt = _KV_TORCH[kv_dtype]
            caches[pool.name] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                                 "v": torch.zeros(shape, dtype=dt, device=dev)}
    return caches


def init_paged_caches(model: ModelDef, topo: MiCSTopology, n_blocks_local: int,
                      block_size: int, kv_dtype: str = "bf16", *,
                      device: str | torch.device = "cuda"):
    """This rank's zero paged pools (:func:`paged_cache_local`):
    ``n_blocks_local`` blocks of its data rank, ``hkv_local`` heads of its
    model coordinate."""
    if model.tp != topo.model_size:
        raise ValueError(f"the model is built for tp = {model.tp}, the topology has "
                         f"tp = {topo.model_size}")
    return paged_cache_local(model, n_blocks_local, block_size, kv_dtype, device=device)


def pages_from_contiguous(model: ModelDef, topo: MiCSTopology, contig: dict, paged: dict,
                          tables, lengths, *, block_size: int, kv_dtype: str = "bf16",
                          data_rank: int = 0):
    """Copy a contiguous prefill cache into an allocated paged pool, in place.

    contig: this rank's ``lm.prefill`` caches (k / v [stack, b, cap, H, dh]
    for its ``b = B / dp`` rows; the slot of position a is a for
    window-free models); paged: its pools from :func:`init_paged_caches`;
    tables [B, max_blocks] rank-local block ids and lengths [B] prompt
    lengths of the global batch, of which data rank ``data_rank`` takes its
    rows.  Int8 pools quantize each (token, head) row of the fp32 values,
    as the engine's writes do.  Returns ``paged``.
    """
    tables = np.asarray(tables)
    lengths = np.asarray(lengths)
    dp = topo.data_parallel_size
    if tables.shape[0] % dp:
        raise ValueError(f"tables of {tables.shape[0]} rows do not divide over {dp} data ranks")
    per = tables.shape[0] // dp
    for pool in model.pools:
        dst = paged[pool.name]
        dev = dst["k"].device
        for b in range(per):
            row = data_rank * per + b
            n = int(lengths[row])
            if n == 0:
                continue
            posn = np.arange(n)
            blk = torch.as_tensor(tables[row, posn // block_size], dtype=torch.long, device=dev)
            off = torch.as_tensor(posn % block_size, dtype=torch.long, device=dev)
            src_k = contig[pool.name]["k"][:, b, :n].to(device=dev, dtype=torch.float32)
            src_v = contig[pool.name]["v"][:, b, :n].to(device=dev, dtype=torch.float32)
            pad = (0, dst["k"].shape[-1] - src_k.shape[-1])  # a pool at a padded head dim
            src_k, src_v = F.pad(src_k, pad), F.pad(src_v, pad)
            if kv_dtype == "int8":
                (qk, sk), (qv, sv) = Q.quantize_flat(src_k), Q.quantize_flat(src_v)
                rows = {"k": qk, "v": qv, "ks": sk, "vs": sv}
            else:
                rows = {"k": src_k, "v": src_v}
            for name, val in rows.items():
                dst[name][:, blk, off] = val.to(dst[name].dtype)
    return paged


# ---------------------------------------------------------------------------
# the paged decode / chunk step
# ---------------------------------------------------------------------------

def _rows(x, dtype, dev, rows: slice) -> torch.Tensor:
    """This data rank's ``rows`` of a step input (numpy or tensor) as a
    ``dtype`` tensor on ``dev``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=dtype)[rows].to(dev)


def _check_pools(caches: dict, kv_dtype: str, block_size: int) -> None:
    want = torch.int8 if kv_dtype == "int8" else _KV_TORCH[kv_dtype]
    for name, pool in caches.items():
        k = pool["k"]
        if k.dtype != want or k.dim() != 5 or k.shape[2] != block_size \
                or ("ks" in pool) != (kv_dtype == "int8"):
            raise ValueError(f"pool {name!r}: {k.dtype} {tuple(k.shape)}, this step takes "
                             f"{kv_dtype} pages of {block_size} tokens")


def build_paged_step(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig, *,
                     max_blocks: int, block_size: int | None = None, chunk: int = 1,
                     kv_dtype: str | None = None, top_k: int = 0,
                     device: str | torch.device = "cuda", groups=None):
    """The continuous-batching step over a paged KV pool: this rank's part,
    on ``device`` (``groups``: its ``MiCSGroups`` of ``topo``, needed at
    more than one rank).

    step(params, caches, tokens [B, chunk], pos [B], n_new [B],
         tables [B, max_blocks], seeds [B], temps [B])
      -> (next_tok [B], logits_row [b, vocab_padded / tp], caches)

    The inputs are the global batch's ``B = dp * b`` slots (tables of
    rank-local block ids); this data rank runs its ``b`` rows over its pools
    and returns their logit rows (its vocab columns), and the sampled
    tokens of every rank, gathered over the data group.

    One call advances every slot by up to ``chunk`` tokens: decode slots
    consume 1 (``n_new=1``), prefill slots up to ``chunk`` (chunked prefill
    interleaved with decode), idle slots 0.  The caches (the pools of
    :func:`init_paged_caches` at ``kv_dtype``) are written in place.  The
    sampled token comes from the logit row of each slot's last consumed
    token (the final norm and the head run on that row alone); the
    scheduler ignores it mid-prompt.  Inputs may be numpy arrays or
    tensors.  The key axis of every attention is ``max_blocks *
    block_size`` whatever the chunking, and a row's result does not depend
    on the other rows, so a request's hidden states and sampled tokens are
    bitwise independent of where its chunk boundaries fall at a fixed
    ``chunk`` (the matmuls and norms of another width may round
    differently).  A ``policy="auto"`` config is first resolved by the
    autotuner in serve mode: the chosen KV dtype (at most as lossy as
    ``mcfg.kv_dtype``), prefetch and planner residency land on
    ``step.mcfg``, the config the step runs; ``kv_dtype`` / ``block_size``
    given here override the config's.
    """
    mcfg, _ = resolve_config(mcfg, model, topo, mode="serve")
    block_size = block_size if block_size is not None else mcfg.kv_block_size
    kv_dtype = kv_dtype if kv_dtype is not None else mcfg.kv_dtype
    _check_paged_support(model)
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}")
    dev = resolve_device(device)
    comm, ctx = serve_engine(model, topo, mcfg, groups, max_blocks * block_size)

    @torch.inference_mode()
    def step(params, caches, tokens, pos, n_new, tables, seeds, temps):
        _check_pools(caches, kv_dtype, block_size)
        mine = local_rows(comm, len(tokens))
        tokens = _rows(tokens, torch.long, dev, mine)
        if tokens.shape[1] != chunk:
            raise ValueError(f"tokens {tuple(tokens.shape)}: this step takes {chunk} a slot")
        pos, n_new = _rows(pos, torch.long, dev, mine), _rows(n_new, torch.long, dev, mine)
        tables = _rows(tables, torch.int32, dev, mine)
        if tables.shape[1] != max_blocks:
            raise ValueError(f"tables {tuple(tables.shape)}: want [B, {max_blocks}]")
        pages = PageState(block_tables=tables, block_size=block_size, n_new=n_new)
        logits, caches = lm.decode_step(model, params, comm, ctx, tokens, pos, caches,
                                        pages=pages, rows=torch.clamp_min(n_new - 1, 0))
        lgt = logits[:, 0]
        nxt = lm.sample_tokens(lgt, ctx, model.cfg.vocab,
                               seed=_rows(seeds, torch.long, dev, mine), pos=pos + n_new,
                               temperature=_rows(temps, torch.float32, dev, mine), top_k=top_k)
        return comm.data_all_gather(nxt), lgt, caches

    step.comm = comm   # its counter: the run's collectives
    step.mcfg = mcfg
    return step


def build_contiguous_step(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig,
                          cache_len: int, *, top_k: int = 0,
                          device: str | torch.device = "cuda", groups=None):
    """Vector-position contiguous-cache decode step: the bitwise reference
    for the paged engine (the same per-request positions, placement and
    sampler, ``lm.init_caches`` caches [stack, b, cache_len, h, dh] of this
    rank's rows, one token a slot a call).

    step(params, caches, tokens [B, 1], pos [B], seeds [B], temps [B])
      -> (next_tok [B], logits_row [b, vocab_padded / tp], caches)

    A ``policy="auto"`` config is resolved as :func:`build_paged_step`'s.
    """
    dev = resolve_device(device)
    mcfg, _ = resolve_config(mcfg, model, topo, mode="serve")
    comm, ctx = serve_engine(model, topo, mcfg, groups, cache_len)
    if model.cfg.window:
        raise NotImplementedError("vector-position decode needs window == 0")

    @torch.inference_mode()
    def step(params, caches, tokens, pos, seeds, temps):
        mine = local_rows(comm, len(tokens))
        tokens = _rows(tokens, torch.long, dev, mine)
        if tokens.shape[1] != 1:
            raise ValueError(f"tokens {tuple(tokens.shape)}: the contiguous step takes one a slot")
        pos = _rows(pos, torch.long, dev, mine)
        logits, caches = lm.decode_step(model, params, comm, ctx, tokens, pos, caches)
        lgt = logits[:, 0]
        nxt = lm.sample_tokens(lgt, ctx, model.cfg.vocab,
                               seed=_rows(seeds, torch.long, dev, mine), pos=pos + 1,
                               temperature=_rows(temps, torch.float32, dev, mine), top_k=top_k)
        return comm.data_all_gather(nxt), lgt, caches

    step.comm = comm
    step.mcfg = mcfg
    return step
