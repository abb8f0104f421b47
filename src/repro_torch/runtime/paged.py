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
bounded by live tokens, not by the worst-case length.  The port serves on
one rank: one allocator, one pool (serving over ranks, where each data
rank owns its allocator and pool, is ROADMAP Queue 1 item 6b).

Block 0 is reserved as the *garbage block*: it is never allocated, unset
table entries point at it, and the step writes padding rows there as
zeros, so it stays all zeros and reads through an unset entry are zeros
that the per-request valid lengths mask out of the softmax.

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
its load.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import quant as Q
from repro_torch.core.comm import CommEngine
from repro_torch.core.mics import KV_DTYPES, SCORES_BF16_UNNEEDED, UNPORTED_TRAIN, MiCSConfig
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import ModelDef
from repro_torch.runtime.serving import refuse_world

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
    ``kv_dtype='int8'``).
    """
    _check_paged_support(model)
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}")
    dev = resolve_device(device)
    caches = {}
    for pool in model.pools:
        one = pool.make_cache(1, block_size, torch.float32, "cpu")
        shape = (pool.stack, n_blocks_local, *one["k"].shape[1:])  # [stack, nb, bs, h, dh]
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
    """The zero paged pools of a one-rank world (:func:`paged_cache_local`)."""
    refuse_world(topo)
    return paged_cache_local(model, n_blocks_local, block_size, kv_dtype, device=device)


def pages_from_contiguous(model: ModelDef, topo: MiCSTopology, contig: dict, paged: dict,
                          tables, lengths, *, block_size: int, kv_dtype: str = "bf16"):
    """Copy a contiguous prefill cache into an allocated paged pool, in place.

    contig: ``lm.prefill``'s caches (k / v [stack, B, cap, H, dh], the slot of
    position a is a for window-free models); paged: pools from
    :func:`init_paged_caches`; tables [B, max_blocks] block ids; lengths [B]
    prompt lengths.  Int8 pools quantize each (token, head) row of the
    fp32 values, as the engine's writes do.  Returns ``paged``.
    """
    refuse_world(topo)
    tables = np.asarray(tables)
    lengths = np.asarray(lengths)
    for pool in model.pools:
        dst = paged[pool.name]
        dev = dst["k"].device
        for b in range(tables.shape[0]):
            n = int(lengths[b])
            if n == 0:
                continue
            posn = np.arange(n)
            blk = torch.as_tensor(tables[b, posn // block_size], dtype=torch.long, device=dev)
            off = torch.as_tensor(posn % block_size, dtype=torch.long, device=dev)
            src_k = contig[pool.name]["k"][:, b, :n].to(device=dev, dtype=torch.float32)
            src_v = contig[pool.name]["v"][:, b, :n].to(device=dev, dtype=torch.float32)
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

def _serve_ctx(topo: MiCSTopology, mcfg: MiCSConfig, cache_len: int):
    refuse_world(topo)
    if mcfg.policy != "manual":
        raise NotImplementedError(f"policy {mcfg.policy!r} needs {UNPORTED_TRAIN['policy'][1]}")
    if mcfg.scores_bf16:
        raise NotImplementedError(SCORES_BF16_UNNEEDED)
    comm = CommEngine.from_config(topo, mcfg)
    ctx = L.Ctx(mode="decode", tp=topo.model_size, cache_len=cache_len,
                compute_dtype=mcfg.gather_dtype)
    return comm, ctx


def _rows(x, dtype, dev) -> torch.Tensor:
    """A step input (numpy or tensor) as a ``dtype`` tensor on ``dev``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=dtype).to(dev)


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
                     device: str | torch.device = "cuda"):
    """The continuous-batching step over a paged KV pool, on ``device``.

    step(params, caches, tokens [B, chunk], pos [B], n_new [B],
         tables [B, max_blocks], seeds [B], temps [B])
      -> (next_tok [B], logits_row [B, vocab_padded], caches)

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
    differently).
    """
    block_size = block_size if block_size is not None else mcfg.kv_block_size
    kv_dtype = kv_dtype if kv_dtype is not None else mcfg.kv_dtype
    _check_paged_support(model)
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}")
    dev = resolve_device(device)
    comm, ctx = _serve_ctx(topo, mcfg, max_blocks * block_size)

    @torch.inference_mode()
    def step(params, caches, tokens, pos, n_new, tables, seeds, temps):
        _check_pools(caches, kv_dtype, block_size)
        tokens = _rows(tokens, torch.long, dev)
        if tokens.shape[1] != chunk:
            raise ValueError(f"tokens {tuple(tokens.shape)}: this step takes {chunk} a slot")
        pos, n_new = _rows(pos, torch.long, dev), _rows(n_new, torch.long, dev)
        tables = _rows(tables, torch.int32, dev)
        if tables.shape[1] != max_blocks:
            raise ValueError(f"tables {tuple(tables.shape)}: want [B, {max_blocks}]")
        pages = PageState(block_tables=tables, block_size=block_size, n_new=n_new)
        logits, caches = lm.decode_step(model, params, comm, ctx, tokens, pos, caches,
                                        pages=pages, rows=torch.clamp_min(n_new - 1, 0))
        lgt = logits[:, 0]
        nxt = lm.sample_tokens(lgt, ctx, model.cfg.vocab, seed=_rows(seeds, torch.long, dev),
                               pos=pos + n_new, temperature=_rows(temps, torch.float32, dev),
                               top_k=top_k)
        return nxt, lgt, caches

    return step


def build_contiguous_step(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig,
                          cache_len: int, *, top_k: int = 0,
                          device: str | torch.device = "cuda"):
    """Vector-position contiguous-cache decode step: the bitwise reference
    for the paged engine (the same per-request positions and sampler,
    ``lm.init_caches`` caches [stack, b, cache_len, h, dh], one token a
    slot a call).

    step(params, caches, tokens [B, 1], pos [B], seeds [B], temps [B])
      -> (next_tok [B], logits_row [B, vocab_padded], caches)
    """
    dev = resolve_device(device)
    comm, ctx = _serve_ctx(topo, mcfg, cache_len)
    if model.cfg.window:
        raise NotImplementedError("vector-position decode needs window == 0")

    @torch.inference_mode()
    def step(params, caches, tokens, pos, seeds, temps):
        tokens = _rows(tokens, torch.long, dev)
        if tokens.shape[1] != 1:
            raise ValueError(f"tokens {tuple(tokens.shape)}: the contiguous step takes one a slot")
        pos = _rows(pos, torch.long, dev)
        logits, caches = lm.decode_step(model, params, comm, ctx, tokens, pos, caches)
        lgt = logits[:, 0]
        nxt = lm.sample_tokens(lgt, ctx, model.cfg.vocab, seed=_rows(seeds, torch.long, dev),
                               pos=pos + 1, temperature=_rows(temps, torch.float32, dev),
                               top_k=top_k)
        return nxt, lgt, caches

    return step
