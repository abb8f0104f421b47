"""Serving runtime: fixed-batch prefill + KV-cache decode with the seeded
sampler (the port of ``repro/runtime/serving.py``'s ``build_serve_steps``,
``pad_ragged_batch`` and ``resize_for_serve_world``); the
continuous-batching engine is ``runtime/paged.py``, ``runtime/batching.py``
and ``runtime/resilient.py``.

Inference uses the same flat-pool parameter gathering as training, so the
weights' memory scales as 1/p: every step re-gathers every layer through
the ``CommEngine`` (the staged gather over the partition group at p > 1,
the lookahead on a side stream; at p = 1 the cast of each fp32 row to the
wire dtype).  With ``quant_gather`` the weights are stored int8
(``quant.quantize_state``: ``{'q': int8, 's': fp32 block scales}`` a pool)
and each layer's row is gathered as it is and dequantized every step.

Over ranks (the reference's ``shard_map`` specs, each rank running its own
part): the batch goes over the data ranks, each running its ``B / dp``
rows; heads and vocab columns go over the model group, so a rank's KV
caches hold ``attn_dims(...).hkv_local`` heads (where ``n_kv_heads < tp``
the one head its query group reads: DESIGN.md §3's head-slot replication)
and its logits its ``V / tp`` columns of its rows.  xLSTM's states are
not cut over the model group: every model rank holds and computes its
rows' whole state (the reference's replicated cell).  The sampled tokens are
gathered over the data group, so every rank's host loop holds the global
``[B, 1]`` tokens.
"""

from __future__ import annotations

import torch

from repro_torch.core.autotune import rerank_serve_world, resolve_config, resolve_world
from repro_torch.core.comm import CommEngine
from repro_torch.core.mics import SCORES_BF16_UNNEEDED, MiCSConfig, local_flat_shapes
from repro_torch.core.quant import n_blocks
from repro_torch.core.topology import MiCSTopology, elastic_host_topology
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import ModelDef


def pad_ragged_batch(topo: MiCSTopology, batch: dict):
    """Pad every batch leaf to the next multiple of dp with dummy rows.

    Returns ``(padded_batch, row_mask)``; ``row_mask`` is a bool [B] marking
    real rows (the decode step emits token -1 for the others).
    """
    dp = topo.data_parallel_size
    b = batch["tokens"].shape[0]
    pad = (-b) % dp
    device = batch["tokens"].device
    mask = torch.arange(b + pad, device=device) < b
    if pad:
        batch = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))], dim=0)
                 for k, v in batch.items()}
    return batch, mask


def _check_params(model: ModelDef, topo: MiCSTopology, params: dict, device: torch.device,
                  quantized: bool = False) -> None:
    """Each pool this rank's fp32 ``[stack, 1, S / p]``, or with
    ``quantized`` a stored ``{'q': int8 [stack, 1, S / p], 's': fp32
    [stack, 1, ceil(S / p / 128)]}``, on ``device``'s type."""
    for name, (stack, one, flat) in local_flat_shapes(model, topo).items():
        pool = params[name]
        if quantized:
            if not isinstance(pool, dict) or set(pool) != {"q", "s"}:
                raise ValueError(f"pool {name!r}: quant_gather serves stored int8 pools "
                                 "{'q', 's'} (quant.quantize_state)")
            want = {"q": (torch.int8, (stack, one, flat)),
                    "s": (torch.float32, (stack, one, n_blocks(flat)))}
        else:
            if isinstance(pool, dict):
                raise ValueError(f"pool {name!r} is stored int8: serve it with quant_gather")
            pool, want = {"": pool}, {"": (torch.float32, (stack, one, flat))}
        for k, (dtype, shape) in want.items():
            t = pool[k]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"pool {name!r}{'.' + k if k else ''}: want {dtype} {shape}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            if t.device.type != device.type:
                raise ValueError(f"pool {name!r} is on {t.device}, the serve steps on {device}")


def serve_engine(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig, groups,
                 cache_len: int) -> tuple[CommEngine, L.Ctx]:
    """The ``CommEngine`` over ``groups`` (this rank's ``MiCSGroups`` of
    ``topo``; ``ValueError`` without them at more than one rank, or for a
    parked rank) and the decode context of every serve step.  ``mcfg`` is
    a resolved config (``core/autotune.resolve_config(mode="serve")``)."""
    if mcfg.scores_bf16:
        raise NotImplementedError(SCORES_BF16_UNNEEDED)
    if model.tp != topo.model_size:
        raise ValueError(f"the model is built for tp = {model.tp}, the topology has "
                         f"tp = {topo.model_size}")
    if groups is not None and groups.parked:
        raise ValueError(f"rank {groups.rank} is parked outside the {topo.world_size}-rank "
                         "world: it serves nothing")
    comm = CommEngine.from_config(topo, mcfg, groups=groups)
    ctx = L.Ctx(mode="decode", tp=topo.model_size, cache_len=cache_len,
                compute_dtype=mcfg.gather_dtype, comm=comm, mlstm_chunk=mcfg.mlstm_chunk)
    return comm, ctx


def local_rows(comm: CommEngine, n_rows: int) -> slice:
    """This data rank's rows of a global batch of ``n_rows`` (a multiple of
    dp): ``[d * n_rows / dp, (d + 1) * n_rows / dp)``."""
    dp = comm.topo.data_parallel_size
    if n_rows % dp:
        raise ValueError(f"a batch of {n_rows} rows does not divide over {dp} data ranks "
                         "(pad_ragged_batch pads it)")
    per = n_rows // dp
    d = comm.data_rank()
    return slice(d * per, (d + 1) * per)


def build_serve_steps(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig,
                      cache_len: int, *, top_k: int = 0,
                      device: str | torch.device = "cuda", groups=None):
    """Returns ``(prefill_fn, decode_fn)`` running this rank's part on
    ``device``.  ``groups``: the rank's ``launch.mesh.MiCSGroups`` of
    ``topo``, needed at more than one rank (``ValueError`` without).

    ``prefill_fn(params, batch) -> (logits [b, 1, V / tp], caches)``: the
    global batch's tokens [B, T] (and the VLM's ``vision`` [B,
    n_vision_tokens, d], enc-dec's ``audio`` [B, n_audio_frames, d]), of which this data rank runs its ``b = B / dp``
    rows; ``params`` are the rank's shards (``init_params(...,
    topo=, rank=)``; with ``mcfg.quant_gather`` stored int8 pools,
    ``quant.quantize_state`` of them); the caches are the rank's.
    ``decode_fn(params, caches, tokens, pos, seeds=None, temps=None,
    row_mask=None) -> (logits [b, 1, V / tp], next_tokens [B, 1], caches)``
    takes the global tokens [B, 1] (and [B] seeds, temperatures and row
    mask) and samples the token at ``pos + 1`` with ``lm.sample_tokens``
    (``top_k``); without ``temps`` (every row at temperature 0) it takes
    ``lm.greedy_sample``, the same argmax without drawing noise.  The
    sampled rows are gathered over the data group (``all_gather:data``),
    so every rank returns the global tokens; rows where ``row_mask`` is
    False emit -1.  The caches are updated in place.  A ``policy="auto"``
    config is first resolved by the autotuner in serve mode (forward
    gathers only, no gradient sync); ``prefill_fn.mcfg`` is the config the
    steps run.
    """
    dev = resolve_device(device)
    mcfg, _ = resolve_config(mcfg, model, topo, mode="serve")
    comm, ctx = serve_engine(model, topo, mcfg, groups, cache_len)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        _check_params(model, topo, params, dev, mcfg.quant_gather)
        mine = local_rows(comm, batch["tokens"].shape[0])
        keys = ("tokens",) + {"vlm": ("vision",), "encdec": ("audio",)}.get(
            model.cfg.family, ())
        return lm.prefill(model, params, comm, ctx, {k: batch[k][mine].to(dev) for k in keys})

    @torch.inference_mode()
    def decode_fn(params, caches, tokens, pos, seeds=None, temps=None, row_mask=None):
        _check_params(model, topo, params, dev, mcfg.quant_gather)
        n = tokens.shape[0]
        mine = local_rows(comm, n)
        tokens = tokens[mine].to(dev)
        logits, new_caches = lm.decode_step(model, params, comm, ctx, tokens,
                                            int(pos), caches)
        if temps is None:
            nxt = lm.greedy_sample(logits[:, -1], ctx, model.cfg.vocab)
        else:
            b = tokens.shape[0]
            seeds = torch.zeros(n, dtype=torch.int64) if seeds is None else seeds
            nxt = lm.sample_tokens(
                logits[:, -1], ctx, model.cfg.vocab,
                seed=torch.as_tensor(seeds)[mine].to(dev),
                pos=torch.full((b,), int(pos) + 1, dtype=torch.int64, device=dev),
                temperature=torch.as_tensor(temps)[mine].to(dev), top_k=top_k)
        nxt = comm.data_all_gather(nxt)
        if row_mask is not None:
            nxt = torch.where(row_mask.to(dev), nxt, torch.full_like(nxt, -1))
        return logits, nxt[:, None], new_caches

    prefill_fn.comm = decode_fn.comm = comm   # its counter: the run's collectives
    prefill_fn.mcfg = decode_fn.mcfg = mcfg
    return prefill_fn, decode_fn


def resize_for_serve_world(model: ModelDef, mcfg: MiCSConfig, n_devices: int, *, tp: int = 1,
                           partition_size: int | None = None, available: int, seq: int = 0,
                           arrival_rate: float = 0.0
                           ) -> tuple[MiCSTopology, MiCSConfig, dict]:
    """(topology, config, ledger info) for serving on the first ``n_devices``
    of ``available`` ranks: the rebuild path of the resilient serve loop
    (``runtime/resilient.py``) at every world change, as
    ``train_loop.resize_for_world`` is the train loop's.

    1. ``autotune.resolve_world(mode="serve")`` re-picks the partition
       group for the survivors (the paper's §3.1 rule under
       ``mcfg.hbm_budget_gb``; the keep rule without a budget);
    2. ``topology.elastic_host_topology`` lays them out contiguously (tp
       pinned: flat layouts are TP-local);
    3. ``autotune.rerank_serve_world`` re-ranks the serve policy on the new
       link geometry with its numerics pinned (the wire and compute dtype,
       the KV dtype and block size stay ``mcfg``'s), so the re-ranked
       policy cannot break the bitwise replay.

    ``info`` is the rule's record plus ``world`` and ``serve_rerank``, the
    re-ranked policy's summary (``seq``: the positions a request holds;
    ``arrival_rate``: the offered load the re-rank prices)."""
    p, mcfg2, info = resolve_world(model, mcfg, n_devices=n_devices, tp=tp,
                                   partition_size=partition_size, mode="serve", seq=seq)
    topo = elastic_host_topology(n_devices, p, tp, available=available)
    mcfg3, plan = rerank_serve_world(model, topo, mcfg2, seq=seq, arrival_rate=arrival_rate)
    chosen = plan.chosen
    info = dict(info, world=n_devices, serve_rerank={
        "gather": chosen.gather.topology,
        "wire": chosen.gather.wire_dtype,
        "prefetch": chosen.gather.prefetch,
        "kv_dtype": mcfg3.kv_dtype,            # pinned, not chosen.kv_dtype
        "max_resident_requests": mcfg3.max_resident_requests,
        "t_decode_s": chosen.t_decode_s,
        "tokens_per_s": chosen.tokens_per_s,
    })
    return topo, mcfg3, info
