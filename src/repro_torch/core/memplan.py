"""Analytical per-device HBM footprint model: the memory planner (the port of
``repro/core/memplan.py``).

MiCS's scale-aware partitioning rule (§3.1) is a *memory* rule: choose the
minimal partition group whose aggregate device memory holds the model
states, so collectives stay small and fast.  The autotuner
(``core/autotune.py``) ranks policies by predicted communication time; this
module supplies the other half of the decision — what each candidate
*costs in HBM* — so the planner can reject configurations that would run
the card out of memory and implement the paper's rule analytically
(:func:`min_partition_size`).

The footprint of one training step decomposes per device into

* **arguments** — the state (fp32 param / m / v shards, exactly the bytes
  ``core/mics.init_state`` allocates) plus the batch on the card;
* **transients** — what the step allocates on top: the fp32 gradient
  accumulator, the gathered buffers the backward keeps (the prefetch
  carry), the cotangent of one gathered buffer, the layers' checkpointed
  inputs, the loss's logits, and at p > 1 or with replicas the wires'
  scratch.

The component names and the decision procedures are the reference's.  The
reference calibrates its transients against the XLA *CPU* backend's
``memory_analysis()``; this module prices what the port's eager step
allocates, each term against ``torch.cuda.max_memory_allocated`` and
``torch.cuda.memory_snapshot`` read inside one step on the card
(``tools/memplan_probe.py``), within the reference's :data:`MEM_RTOL`.
The terms the port prices differently, and why:

* ``args``: no step scalar — ``state["step"]`` is a host int
  (``core/mics.build_train_step``).  The batch adds the enc-dec model's
  bf16 audio frames and the VLM's bf16 vision rows when ``local_batch`` and
  ``seq`` are given.
* ``gather_buffers`` (train): only the head's gathered buffer, which the
  logits' matmul keeps for the backward (``models/lm.lm_logits``); the
  embedding's buffer is dropped after the lookup (its backward keeps the
  indices), and a layer's buffer is either the prefetch carry or dropped
  with its layer (``models/lm._apply_pool_*``).  Serve mode keeps the
  reference's rule (every pool's buffer, two for a prefetching pool).
* ``grad_loop_buffer``: none — each row's gradient is added into the
  accumulator in place by its post-accumulate hook
  (``core/mics.accumulate_grads``); there is no loop carry to double.
* ``boundary_reduced``: none — hop 2 reduces the accumulator's buckets in
  place (``CommEngine.hop2_``, ``core/schedule._reduce_bucketed``) and
  AdamW runs ``UPDATE_SLICE`` elements at a time after the backward has
  freed its activations and logits, so its temporaries never add to the
  backward's peak.
* ``gather_adjoint``: the full buffer's cotangent in the compute dtype and
  its fp32 cast (``CommEngine.gather_flat_adjoint``): ``cb + 4`` bytes an
  element of the largest buffer (4 for the fp32 wire, where the cast is
  the tensor itself).  They live only after the loss's backward has freed
  the logits and the head's buffer (``models/layers._CrossEntropy``, the
  head's matmul), so the term is what they exceed ``logits_ce`` and the
  head's ``gather_buffers`` by (the step's peak is the larger of the two
  moments).
* ``prefetch_carry``: stored — the checkpoints keep each layer's gathered
  buffer in the compute dtype (``stack * flat_len * cb``; the reference's
  fp32 stack and rotated shard copy do not exist: a row is a view of its
  shard); remat and host — one re-gathered (or fetched-back) buffer,
  ``flat_len * cb`` (the checkpoint keeps the row, a view; the host slots
  are pinned host memory).  An enc-dec decoder pool keeps the stored carry
  under either, as in the reference (``models/lm._apply_pool``).
* ``activation_ckpt``: an encoder pool's checkpointed inputs are its audio
  frames (``n_audio_frames`` a row), not ``seq`` tokens.
* ``logits_ce``: the saved logits in the compute dtype, the backward's
  fp32 probabilities and their cast back (``models/layers._CrossEntropy``):
  ``2 * cb + 4`` bytes a logit (8 at bf16, the reference's figure; 12 at
  fp32); ``final_activations`` the [b, T, d] activations beside them
  (:data:`FINAL_ACTIVATIONS`), which the reference leaves out.
* ``hop2_staging`` (replicas): none on the fp32 wire (the bucket is reduced
  in place), two buckets' bf16 casts on the bf16 wire; the int8 wire keeps
  the reference's rule.
* ``qgz_scratch`` (the int8 hop 1): the stage's int8 payload and its
  exchanged copy, values and scales (``2 * (1 + 4/128)`` bytes an
  element), plus the first stage's fp32 sum (at most half the buffer, 2
  bytes an element); the fp32 input is ``gather_adjoint``'s.  The
  reference's 133 bytes an element is XLA CPU's unfused dither chain.
* serve: the paged pool is written in place (``models/blocks._paged_kv_write``)
  and read through the block table by the ``paged`` kernel route, so there
  is no ``kv_pool_update`` double buffer and no ``kv_gather_view``; the
  plan rows are int64 but the block table (int32); a head dim outside the
  flash kernels' is stored at its padded width (``kv_token_bytes``).

A train step peaks at one of three moments, and the plan is the largest
(:attr:`MemPlan.moment`; the allocator's trace shows each,
``tools/memplan_probe.py``):

* ``loss`` — the loss's backward: the terms above (:attr:`MemPlan.components`,
  the reference's decomposition);
* ``layer`` — the backward of the pool row whose recompute saves most: the
  state, the accumulator, the carry and the checkpoints, plus what the row's
  recompute keeps for its backward (``layer_saved``: the whole row traced
  once on fake tensors under ``saved_tensors_hooks``, counted by storage —
  the xLSTM recurrences' per-chunk states and gates of
  ``models/recurrent.mlstm_chunkwise`` at ``mlstm_chunk`` and
  ``SlstmScanFn``'s states, MoE's ``[E, cap + 1, d]`` dispatch buffers, slots
  and routing, the layers' products and norms) and its cotangents
  (``layer_cotangent``: the gathered row's, ``flat_len * cb``, and the
  activations' into and out of the row, ``2 * b * T * d * cb``,
  :func:`layer_cotangent_bytes`), and the backward's transients
  (``layer_backward``: the family's :data:`LAYER_BACKWARD_SHARE` of the
  saved bytes, read off the card).  Priced for the families whose rows run
  without a frontend (:data:`LAYER_FAMILIES`);
* ``boundary`` — AdamW after the backward (``core/schedule._AdamW``): the
  state and the accumulator, plus :data:`BOUNDARY_TEMPS` fp32 temporaries of
  the largest update slice (``min(UPDATE_SLICE, row shard)``: the update's
  passes and the slice's two masks), two more with host moments.  It is
  the peak of a step whose activations are small beside its state.

A budget bounds what the caching allocator *reserves*
(``torch.cuda.max_memory_reserved``), which runs above the allocated peak:
the gates (:func:`fits`, used by :func:`min_partition_size` and
``core/autotune.rank_policies``) hold :attr:`MemPlan.reserved_bytes`, the
plan times :data:`RESERVE_FACTOR`, to it.  Where an xLSTM step peaks (in a
row's backward, or at its boundary) the allocator reserves more than that,
and the plan carries the excess as a term of its own
(:attr:`MemPlan.reserve_excess`: :data:`LAYER_RESERVE_SHARE` of the row's
saved bytes, :data:`BOUNDARY_RESERVE_SHARE` of the update's temporaries):
the allocated plan stays a prediction of ``max_memory_allocated``.  A gate prices the batch, the
checkpointed activations and the logits only when it is given
``local_batch`` and ``seq``; the train launcher, the train loop and
``core/mics.build_train_step`` pass them.

The p > 1 and replica terms (``int8_wire_scratch``, ``reorder_copy``,
``hop2_*``, ``qgz_scratch``) are the port's allocations read from its code;
one card runs no NCCL world, so none of them has been measured on a card.

Degenerate cases are first-class: a single-device world (p = 1, nothing on
the wire, no hop 2), a partition group spanning the whole world (ZeRO-3,
no replication, no hop-2 staging), and budgets smaller than any candidate
(:class:`MemoryBudgetError`, never a silent empty plan).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref

from repro_torch.core.comm import GatherPolicy, SyncPolicy
from repro_torch.core.linkmodel import GIB
from repro_torch.core.quant import BLOCK
from repro_torch.core.schedule import UPDATE_SLICE

# Documented tolerance of the transient-footprint model against the card's
# measured peak (the reference's figure; argument bytes carry none).
MEM_RTOL = 0.35
# The caching allocator's reserve over the plan.  The one-card train runs
# the planner is held on (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W) read
# reserved / plan from 1.035 (recurrentgemma-2b, stored carry) to 1.1415
# (its host carry: the fetched-back buffers wait on another stream before
# their blocks are reused); a budget holds the plan times this.
RESERVE_FACTOR = 1.16

# bytes/element of the gathered compute buffer, per gather wire dtype (the
# int8 wire dequantizes into the bf16 compute dtype).
_COMPUTE_BYTES = {"fp32": 4, "bf16": 2, "int8": 2}
# int8 wire scratch: q payload + one f32 absmax scale per BLOCK elements.
_INT8_BYTES = 1.0 + 4.0 / BLOCK
# Per-element scratch of the qgZ hop-1 wire on the largest in-flight
# cotangent buffer: the int8 payload and its exchanged copy (values and
# scales), plus the first stage's fp32 sum, at most half the buffer
# (core/collectives.quantized_reduce_scatter).
QGZ_SCRATCH_BYTES_PER_ELEM = 2 * _INT8_BYTES + 2.0
# Per-token bytes of the train batch on the card: tokens and targets int32,
# mask fp32 (data/pipeline.py).
BATCH_BYTES_PER_TOKEN = 12.0
# Per-element bytes of the enc-dec audio frames and the VLM's vision rows.
_FRAME_BYTES = 2.0


# The backward's own transients at the ``layer`` moment beyond the row's
# cotangents (:func:`layer_cotangent_bytes`), as a share of what the row
# saves, for each family whose rows the moment traces (their rows take no
# frontend input, as the VLM's vision rows and enc-dec's encoder output do,
# so one row runs from its input activations and gathered buffer alone):
# read off an H100 with ``tools/memplan_probe.py --rows``, one row of each
# of chip_smoke.py's train runs (dense: the larger of llama3.2-1b's and
# bert-10b's; PERF.md §6).
# Griffin's row frees its saved tensors as its backward walks back and peaks
# under saved + cotangents (-0.23): no term.
LAYER_BACKWARD_SHARE = {"dense": 0.281, "moe": 0.316, "xlstm": 0.042, "griffin": 0.0}
LAYER_FAMILIES = tuple(LAYER_BACKWARD_SHARE)
# What the caching allocator reserves beyond RESERVE_FACTOR x the plan when
# an xLSTM step peaks (MemPlan.reserve_excess), read off an H100
# (tools/memplan_probe.py on xlstm-125m's train run; PERF.md §6).  In a
# row's backward, where its chunkwise recurrences free and allocate blocks
# of many sizes: a share of what the row saves (0.104 read with AdamW slices
# of 2^24, which move the step's peak there).  At the boundary: the update
# slice's temporaries whole, in segments of their own, since the small
# blocks the xLSTM backward frees hold none of them (0.68 and 0.95 of them
# read in two runs; the other families' losses free blocks that hold them).
LAYER_RESERVE_SHARE = {"xlstm": 0.105}
BOUNDARY_RESERVE_SHARE = {"xlstm": 1.0}
# [b, T, d] activations of the compute dtype live at the loss's backward
# beyond the checkpoints (the last row's output, which the final norm saves,
# and the norm's output, which the head's product saves, among them), read
# off an H100: llama3.2-1b's train_4k as rank 0 of 16 x 16 at tp 16, where
# the vocabulary's shard no longer dwarfs them, peaked 203 MB = 3.03 of
# them over the plan without this term (launch/dryrun.py, chip_smoke.py).
FINAL_ACTIVATIONS = 3
# fp32 temporaries of one AdamW update slice at the boundary's peak
# (optim/adamw.adamw_shard_update's passes and core/schedule._slice_masks'
# decay and padding masks), read off the allocator's trace on an H100
# (xlstm-125m: 8 + 2 row-size temporaries at its boundary peak,
# tools/memplan_probe.py).
BOUNDARY_TEMPS = 10
# With host moments (offload_opt) the slice's m and v come to the card.
BOUNDARY_HOST_TEMPS = 2


class MemoryBudgetError(ValueError):
    """No candidate fits the HBM budget (raised instead of an empty plan)."""


# KV-cache element bytes per kv_dtype (int8 adds f32 scales separately).
_KV_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def _kv_head_dim(head_dim: int) -> int:
    """The width a pool stores a head at: ``head_dim``, padded to the
    flash kernels' next head dim where it is none of theirs
    (``runtime/paged.paged_cache_local``)."""
    from repro_torch.kernels.flash_attention import padded_head_dim

    return padded_head_dim(head_dim)


def kv_token_bytes(model, kv_dtype: str = "bf16") -> float:
    """Per-device HBM bytes one cached token costs across all layers.

    Prices the paged KV pool (``runtime/paged.py``): k + v at ``kv_dtype``
    over the rank-local KV head slots at the stored head width, plus the
    per-(token, head, 128-block) f32 scale pages of the int8 layout.
    """
    from repro_torch.models.dims import attn_dims

    cfg = model.cfg
    tp = max(int(getattr(model, "tp", 1)), 1)
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim, tp)
    dh = _kv_head_dim(ad.head_dim)
    per_layer = 2.0 * ad.hkv_local * dh * _KV_BYTES[kv_dtype]
    if kv_dtype == "int8":
        per_layer += 2.0 * ad.hkv_local * math.ceil(dh / BLOCK) * 4.0
    return per_layer * cfg.n_layers


def max_resident_requests(
    model,
    topo,
    gather: GatherPolicy,
    sync: SyncPolicy,
    *,
    hbm_bytes: float,
    ctx_len: int,
    kv_block_size: int = 16,
    kv_dtype: str = "bf16",
) -> int:
    """How many requests of ``ctx_len`` positions fit per device.

    Free HBM after the serve-mode base footprint (param shards + gather
    buffers), divided by one request's block-rounded KV bytes.  This is
    what sizes the paged pool (``MiCSConfig.max_resident_requests == 0``).
    """
    base = predict_footprint(model, topo, gather, sync, mode="serve")
    free = float(hbm_bytes) - base.total_bytes
    blocks = math.ceil(max(ctx_len, 1) / kv_block_size)
    per_req = blocks * kv_block_size * kv_token_bytes(model, kv_dtype)
    return max(int(free // per_req), 0)


# graceful-degradation dtype order: each step right is lossier but smaller
_KV_LADDER = ("fp32", "bf16", "int8")


def degradation_levels(
    model,
    topo,
    gather: GatherPolicy,
    sync: SyncPolicy,
    *,
    hbm_bytes: float,
    ctx_len: int,
    kv_block_size: int = 16,
    kv_ceiling: str = "bf16",
    tighten: float = 0.5,
) -> list[dict]:
    """Price a graceful-degradation ladder for the serving scheduler.

    Returns ordered ``{"kv_dtype", "resident_cap", "label"}`` levels for
    :class:`repro_torch.runtime.batching.DegradationLadder` (plain dicts —
    core does not import runtime):

    - level 0: the configured operating point — ``kv_ceiling`` KV at the
      full :func:`max_resident_requests` residency;
    - level 1: same dtype, residency tightened by ``tighten``;
    - level 2+: one lossier KV dtype per level (bf16 → int8), each priced
      at its own (larger) planner residency, again tightened.

    Every cap is at least 1, so the ladder degrades throughput and
    numerics but can never deadlock admission.
    """
    if kv_ceiling not in _KV_LADDER:
        raise ValueError(f"unknown kv dtype {kv_ceiling!r}")
    if not 0.0 < tighten <= 1.0:
        raise ValueError("tighten must be in (0, 1]")

    def cap(dt):
        return max_resident_requests(
            model, topo, gather, sync, hbm_bytes=hbm_bytes, ctx_len=ctx_len,
            kv_block_size=kv_block_size, kv_dtype=dt)

    r0 = cap(kv_ceiling)
    levels = [
        {"kv_dtype": kv_ceiling, "resident_cap": max(r0, 1),
         "label": "configured"},
        {"kv_dtype": kv_ceiling, "resident_cap": max(int(r0 * tighten), 1),
         "label": "tightened"},
    ]
    for dt in _KV_LADDER[_KV_LADDER.index(kv_ceiling) + 1:]:
        levels.append({"kv_dtype": dt,
                       "resident_cap": max(int(cap(dt) * tighten), 1),
                       "label": f"kv_{dt}"})
    return levels


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """The sizes the footprint model needs — duck-types MiCSTopology so the
    planner runs device-free (partition-group auto-sizing iterates these
    without building process groups)."""

    partition_size: int
    replication_degree: int = 1


@dataclasses.dataclass(frozen=True)
class MemPlan:
    """Predicted per-device HBM footprint of one step.  ``state_bytes`` is
    the part of ``args_bytes`` that ``init_state`` (train) or
    ``init_params`` (serve) allocates."""

    components: dict           # the loss's backward: transient component -> bytes
    args_bytes: float          # state + batch (+ KV pool, plan rows)
    mode: str
    state_bytes: float = 0.0
    moments: dict = dataclasses.field(default_factory=dict)  # other moment -> components
    reserves: dict = dataclasses.field(default_factory=dict)  # moment -> the allocator's excess

    @property
    def moment(self) -> str:
        """The moment the step peaks at: ``loss``, or the larger of
        ``moments`` (``layer``, ``boundary``) where it exceeds it."""
        best, most = "loss", sum(self.components.values())
        for name, comp in self.moments.items():
            if sum(comp.values()) > most:
                best, most = name, sum(comp.values())
        return best

    @property
    def peak_components(self) -> dict:
        """The transients of :attr:`moment`."""
        m = self.moment
        return dict(self.components) if m == "loss" else dict(self.moments[m])

    @property
    def temp_bytes(self) -> float:
        return float(sum(self.peak_components.values()))

    @property
    def total_bytes(self) -> float:
        return self.args_bytes + self.temp_bytes

    @property
    def total_gb(self) -> float:
        return self.total_bytes / GIB

    @property
    def reserve_excess(self) -> float:
        """What the allocator reserves beyond :data:`RESERVE_FACTOR` x the
        plan when the step peaks at :attr:`moment` (``reserves``: xLSTM's
        ``layer`` and ``boundary``), else 0."""
        return float(self.reserves.get(self.moment, 0.0))

    @property
    def reserved_bytes(self) -> float:
        """What the caching allocator is priced to reserve for the step:
        the measure a budget holds (:func:`fits`)."""
        return self.total_bytes * RESERVE_FACTOR + self.reserve_excess

    def describe(self) -> dict:
        return {
            "args_bytes": self.args_bytes,
            "state_bytes": self.state_bytes,
            "temp_bytes": self.temp_bytes,
            "total_bytes": self.total_bytes,
            "total_gib": self.total_gb,
            "reserved_gib": self.reserved_bytes / GIB,
            "reserve_excess": self.reserve_excess,
            "components": dict(self.components),
            "moment": self.moment,
            "moments": {"loss": float(sum(self.components.values())),
                        **{k: float(sum(v.values())) for k, v in self.moments.items()}},
            "moment_components": {k: dict(v) for k, v in self.moments.items()},
            "mode": self.mode,
        }


def fits(total_bytes: float, hbm_budget_gb: float, reserve_excess: float = 0.0) -> bool:
    """Whether a plan of ``total_bytes`` allocated fits a budget of
    ``hbm_budget_gb`` GiB once the allocator's reserve is counted
    (``reserve_excess``: :attr:`MemPlan.reserve_excess`)."""
    return total_bytes * RESERVE_FACTOR + reserve_excess <= float(hbm_budget_gb) * GIB


def _pool_shapes(model) -> dict:
    return model.global_flat_shapes()


def predict_footprint(
    model,
    topo,
    gather: GatherPolicy,
    sync: SyncPolicy,
    *,
    micro_steps: int = 1,
    mode: str = "train",
    local_batch: int = 0,
    seq: int = 0,
    boundary: str = "bucketed",
    hop2_bucket_mb: float = 32.0,
    offload_opt: bool = False,
    kv_pages_tokens: int = 0,
    kv_dtype: str = "bf16",
    decode_batch: int = 0,
    decode_ctx: int = 0,
    decode_chunk: int = 0,
    kv_max_blocks: int = 0,
    mlstm_chunk: int = 0,
) -> MemPlan:
    """Per-device HBM footprint of one training / serving step.

    ``topo`` needs only ``partition_size`` and ``replication_degree``
    (:class:`DeviceGrid` suffices).  ``local_batch`` / ``seq`` size the
    batch, activation-checkpoint and logits terms; pass 0 to price model
    states and communication buffers only (what ``resolve_config`` does).
    All byte counts are per device.

    Host offload shifts bytes out of this budget: with
    ``gather.carry_offload='host'`` the stored carry's buffers leave HBM
    (one fetched-back buffer remains, as remat's one re-gathered buffer),
    and with ``offload_opt=True`` the fp32 ``m`` / ``v`` shards leave the
    arguments (2 x state shard bytes).  Their *time* is priced by the
    autotuner on the link model's ``host`` tier.

    In train mode the plan is the largest of the step's moments (module
    docstring): ``mlstm_chunk`` is the chunkwise mLSTM's chunk the step runs
    (``MiCSConfig.mlstm_chunk``; 0: the timestep scan), which the ``layer``
    moment traces.
    """
    p = max(int(topo.partition_size), 1)
    repl = max(int(getattr(topo, "replication_degree", 1)), 1)
    cb = _COMPUTE_BYTES[gather.wire_dtype]
    shapes = _pool_shapes(model)
    scanned = {pl.name for pl in model.pools}
    train = mode == "train"
    cfg = getattr(model, "cfg", None)

    shard4 = {name: stack * math.ceil(flat_len / p) * 4
              for name, (stack, _tp, flat_len) in shapes.items()}
    s4 = float(sum(shard4.values()))          # one fp32 state copy / device

    # -- arguments (exact): fp32 params (+ m + v unless host-offloaded)
    # shards, the batch --
    state_copies = 1.0 if offload_opt else 3.0
    state = state_copies * s4 if train else s4
    args = state
    if train and local_batch and seq:
        # tokens + targets (int32) + mask (f32), stacked over micro-steps,
        # and the stub frontends' bf16 rows
        args += micro_steps * local_batch * seq * BATCH_BYTES_PER_TOKEN
        frames = _frontend_rows(cfg)
        if frames:
            args += micro_steps * local_batch * frames * cfg.d_model * _FRAME_BYTES

    comp: dict[str, float] = {}

    def add(name: str, nbytes: float):
        if nbytes > 0:
            comp[name] = comp.get(name, 0.0) + float(nbytes)

    # -- gather buffers ------------------------------------------------------
    prefetching = gather.prefetch
    max_flat = 0
    for name, (stack, _tp, flat_len) in shapes.items():
        max_flat = max(max_flat, flat_len)
        if train:
            if name == model.head.name:
                add("gather_buffers", flat_len * cb)   # the logits' matmul keeps it
            continue
        nbuf = 2 if (prefetching and name in scanned and stack > 1) else 1
        add("gather_buffers", flat_len * cb * nbuf)
    if gather.wire_dtype == "int8" and p > 1:
        # in-flight (q, scales) payloads of the largest gather
        add("int8_wire_scratch", 2 * max_flat * _INT8_BYTES)
    if gather.topology == "outer_first" and p > 1:
        add("reorder_copy", max_flat * cb)

    if not train:
        if local_batch and seq:
            for name, (stack, _tp, flat_len) in shapes.items():
                if name in scanned and cfg is not None:
                    add("activation_ckpt",
                        stack * local_batch * seq * cfg.d_model * cb)
        # paged-KV serving (runtime/paged.py): the block pool is an argument
        # like the param shards, exact by construction, written in place
        if kv_pages_tokens:
            args += kv_pages_tokens * kv_token_bytes(model, kv_dtype)
        if decode_batch and decode_chunk:
            # the engine step's plan rows on the card: tokens [b, chunk],
            # pos, n_new, seeds (int64), block table [b, max_blocks] (int32),
            # temps (f32)
            args += decode_batch * (decode_chunk * 8 + 3 * 8 + kv_max_blocks * 4 + 4)
        if decode_batch and decode_ctx and cfg is not None:
            tp = max(int(getattr(model, "tp", 1)), 1)
            vocab = int(getattr(model, "vocab_padded", cfg.vocab))
            add("decode_logits", decode_batch * (vocab // tp) * 8)
        return MemPlan(components=comp, args_bytes=args, mode=mode, state_bytes=state)

    # -- gradient accumulator (summed into in place) --------------------------
    add("grad_accum", s4)

    # -- prefetch-carry backward residual (GatherPolicy.prefetch_carry) ------
    family = getattr(cfg, "family", None)
    offload_carry = getattr(gather, "carry_offload", "none") == "host"
    for name, (stack, _tp, flat_len) in shapes.items():
        if not (prefetching and name in scanned and stack > 1):
            continue
        eligible = not (family == "encdec" and not name.startswith("enc"))
        if eligible and (gather.prefetch_carry == "remat" or offload_carry):
            add("prefetch_carry", flat_len * cb)
        else:
            add("prefetch_carry", stack * flat_len * cb)

    # -- activation checkpoints + logits / CE workspace ----------------------
    if local_batch and seq and cfg is not None:
        for name, (stack, _tp, flat_len) in shapes.items():
            if name in scanned:
                rows = (cfg.n_audio_frames if family == "encdec" and name.startswith("enc")
                        else seq)
                add("activation_ckpt", stack * local_batch * rows * cfg.d_model * cb)
        tp = max(int(getattr(model, "tp", 1)), 1)
        vocab = int(getattr(model, "vocab_padded", cfg.vocab))
        add("logits_ce", local_batch * seq * (vocab // tp) * (2 * cb + 4))
        add("final_activations", FINAL_ACTIVATIONS * local_batch * seq * cfg.d_model * cb)

    # -- backward: the largest buffer's cotangent and its fp32 cast, live only
    # after the loss's backward has freed the logits and the head's buffer --
    after_loss = comp.get("logits_ce", 0.0) + comp.get("gather_buffers", 0.0)
    add("gather_adjoint", max_flat * (cb + 4 if cb < 4 else 4) - after_loss)

    # -- hop-2 staging (replication-group boundary) ---------------------------
    if repl > 1 and sync.mode == "2hop":
        max_shard4 = max(shard4.values())
        eff = max_shard4 if boundary == "serial" \
            else min(hop2_bucket_mb * 1e6, max_shard4)
        if sync.hop2_wire_dtype == "bf16":
            add("hop2_staging", eff)                 # two buckets' bf16 casts
        elif sync.hop2_wire_dtype == "int8":
            add("hop2_staging", 2 * eff)
            add("hop2_qgz_scratch", 2 * eff / 4 * _INT8_BYTES)

    # -- qgZ hop-1 scratch ----------------------------------------------------
    if sync.hop1_wire_dtype == "int8" and p > 1:
        add("qgz_scratch", max_flat * QGZ_SCRATCH_BYTES_PER_ELEM)

    moments, reserves = {}, {}
    # -- the largest row's backward -------------------------------------------
    if local_batch and seq and cfg is not None and family in LAYER_FAMILIES:
        tp = max(int(getattr(model, "tp", 1)), 1)
        saved = layer_saved_bytes(cfg, tp, local_batch, seq, mlstm_chunk=mlstm_chunk,
                                  compute_bytes=cb)
        name = max(saved, key=saved.get)
        flat_len = shapes[name][2]
        moments["layer"] = {k: v for k, v in (
            ("grad_accum", comp["grad_accum"]),
            ("prefetch_carry", comp.get("prefetch_carry", 0.0)),
            ("activation_ckpt", comp.get("activation_ckpt", 0.0)),
            ("layer_saved", saved[name]),
            ("layer_cotangent", layer_cotangent_bytes(flat_len, local_batch, seq, cfg.d_model, cb)),
            ("layer_backward", LAYER_BACKWARD_SHARE[family] * saved[name]),
        ) if v > 0}
        reserves["layer"] = LAYER_RESERVE_SHARE.get(family, 0.0) * saved[name]
    # -- the boundary's AdamW -------------------------------------------------
    row_shard = max(math.ceil(flat_len / p) for _s, _t, flat_len in shapes.values())
    temps = BOUNDARY_TEMPS + (BOUNDARY_HOST_TEMPS if offload_opt else 0)
    update = temps * 4.0 * min(UPDATE_SLICE, row_shard)
    moments["boundary"] = {"grad_accum": comp["grad_accum"], "boundary_update": update}
    reserves["boundary"] = BOUNDARY_RESERVE_SHARE.get(family, 0.0) * update
    return MemPlan(components=comp, args_bytes=args, mode=mode, state_bytes=state,
                   moments=moments, reserves={k: v for k, v in reserves.items() if v})


def layer_cotangent_bytes(flat_len: int, local_batch: int, seq: int, d_model: int,
                          compute_bytes: int) -> float:
    """The ``layer`` moment's ``layer_cotangent``: the gathered row's
    cotangent (``flat_len`` elements) and the activations' into and out of
    the row, in the compute dtype of ``compute_bytes``."""
    return float(flat_len * compute_bytes + 2 * local_batch * seq * d_model * compute_bytes)


def layer_saved_bytes(cfg, tp: int, local_batch: int, seq: int, *, mlstm_chunk: int = 0,
                      compute_bytes: int = 2) -> dict:
    """``{pool: bytes}``: what one row of each layer pool of ``cfg`` at
    ``tp`` saves for its backward when its checkpoint recomputes it, over
    ``local_batch`` x ``seq`` tokens in the compute dtype of
    ``compute_bytes`` — every tensor its autograd graph keeps
    (:func:`saved_bytes`), less the row's inputs (the gathered buffer and
    the activations, priced as the carry and the checkpoints).  The row runs
    on fake tensors (``FakeTensorMode``: shapes only, nothing allocated; the
    kernels' plain versions, whose autograd Functions save what the card's
    do), its model axis over a fake group that moves no data
    (``launch/mesh.MiCSGroups``).  xLSTM's recurrences save a fixed set a
    timestep or a chunk, so its rows are traced at two and three of them
    and the bytes extended in a line to ``seq`` (exact: every term is a
    count of steps or chunks times their size, or a constant)."""
    if cfg.family == "xlstm":
        unit = mlstm_chunk if mlstm_chunk and seq % mlstm_chunk == 0 and seq > mlstm_chunk \
            else 1
        t0, t1 = 2 * unit, 3 * unit      # the same form as seq's: chunkwise, or the scan
        if seq > t1:
            a = dict(_traced_saved(cfg, tp, local_batch, t0, mlstm_chunk, compute_bytes))
            b = dict(_traced_saved(cfg, tp, local_batch, t1, mlstm_chunk, compute_bytes))
            return {k: a[k] + (b[k] - a[k]) * (seq - t0) / (t1 - t0) for k in a}
    return dict(_traced_saved(cfg, tp, local_batch, seq, mlstm_chunk, compute_bytes))


@functools.lru_cache(maxsize=64)
def _traced_saved(cfg, tp: int, local_batch: int, seq: int, mlstm_chunk: int,
                  compute_bytes: int) -> tuple:
    """:func:`layer_saved_bytes` of one traced row a layer pool, at ``seq``:
    ``((pool, bytes), ...)`` (a tuple: the cache hands it to every caller)."""
    import datetime

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.comm import CommEngine
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.launch.mesh import FAKE_BACKEND, MiCSGroups
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.build import build_model

    dtype = torch.float32 if compute_bytes == 4 else torch.bfloat16
    model = build_model(cfg, tp=tp)
    topo = MiCSTopology(model=tp)
    groups = (MiCSGroups(topo, 0, backend=FAKE_BACKEND, timeout=datetime.timedelta(0))
              if tp > 1 else None)
    comm = CommEngine(topo, groups=groups, compute_dtype=dtype)
    ctx = L.Ctx(mode="train", tp=tp, compute_dtype=dtype, comm=comm, mlstm_chunk=mlstm_chunk,
                shapes_only=True)
    out = {}
    with FakeTensorMode(), torch.enable_grad():
        for pool in model.pools:
            full = torch.empty(pool.layout.flat_len, dtype=dtype).requires_grad_()
            x = torch.empty(local_batch, seq, cfg.d_model, dtype=dtype).requires_grad_()
            out[pool.name] = float(saved_bytes(
                lambda: lm._layer_from_full(pool, comm, ctx, x, full), exclude=(x, full)))
    return tuple(out.items())


def saved_bytes(fn, exclude=()) -> int:
    """The bytes of the storages that ``fn()``'s autograd graph keeps for
    its backward once ``fn`` has returned (a node the output does not reach
    is freed with what it saved), each storage once, less those of
    ``exclude`` (its inputs)."""
    import torch

    def key(t):
        return t.untyped_storage()._cdata

    skip = {key(t) for t in exclude}
    packed = []

    def pack(t):
        packed.append((weakref.ref(t), t.untyped_storage().nbytes()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()  # noqa: F841  (holds the graph while the saved tensors are read)
    alive = {}
    for ref, nbytes in packed:
        t = ref()
        if t is not None and key(t) not in skip:
            alive[key(t)] = nbytes
    return sum(alive.values())


def _frontend_rows(cfg) -> int:
    """Rows a sequence of the stub frontend adds to the batch: enc-dec's
    audio frames, the VLM's vision rows, else 0."""
    family = getattr(cfg, "family", None)
    if family == "encdec":
        return int(cfg.n_audio_frames)
    if family == "vlm":
        return int(cfg.n_vision_tokens)
    return 0


# ---------------------------------------------------------------------------
# scale-aware partition-group auto-sizing (the paper's §3.1 rule)
# ---------------------------------------------------------------------------

def partition_size_candidates(data_extent: int) -> list[int]:
    """Partition-group sizes a data axis of ``data_extent`` admits,
    ascending — every divisor, so the minimal fitting one is exact."""
    if data_extent < 1:
        raise ValueError(f"data_extent must be >= 1, got {data_extent}")
    return [d for d in range(1, data_extent + 1) if data_extent % d == 0]


def min_partition_size(
    model,
    *,
    data_extent: int,
    hbm_budget_gb: float,
    gather: GatherPolicy = GatherPolicy(),
    sync: SyncPolicy = SyncPolicy(),
    micro_steps: int = 1,
    mode: str = "train",
    local_batch: int = 0,
    seq: int = 0,
    boundary: str = "bucketed",
    hop2_bucket_mb: float = 32.0,
    carries: tuple = ("stored",),
    offload_opt: bool = False,
    extra_replication: int = 1,
    mlstm_chunk: int = 0,
) -> tuple[int, str, MemPlan]:
    """The paper's scale-aware partitioning rule, analytically.

    Walks partition-group sizes ascending (divisors of ``data_extent``)
    and returns the first ``(p, carry, plan)`` whose predicted per-device
    footprint fits ``hbm_budget_gb`` GiB (:func:`fits`: its reserve) — the
    *minimal* group that fits,
    trying each entry of ``carries`` in order at every size (pass
    ``("stored", "remat", "host")`` to let the remat and host-offload
    mitigations rescue a smaller group before growing it; ``"host"`` is
    skipped when the gather policy does not prefetch).
    ``extra_replication`` multiplies the replication degree for
    data-parallel axes the group cannot span.  Raises
    :class:`MemoryBudgetError` when even the whole data axis (ZeRO-3 scale)
    does not fit, naming the smallest candidate.
    """
    best = None
    for p in partition_size_candidates(data_extent):
        grid = DeviceGrid(
            partition_size=p,
            replication_degree=(data_extent // p) * max(extra_replication, 1))
        for carry in carries:
            if carry == "host":
                if not gather.prefetch:
                    continue
                g2 = dataclasses.replace(
                    gather, prefetch_carry="stored", carry_offload="host")
            else:
                g2 = dataclasses.replace(
                    gather, prefetch_carry=carry, carry_offload="none")
            plan = predict_footprint(
                model, grid, g2, sync, micro_steps=micro_steps, mode=mode,
                local_batch=local_batch, seq=seq, boundary=boundary,
                hop2_bucket_mb=hop2_bucket_mb, offload_opt=offload_opt,
                mlstm_chunk=mlstm_chunk)
            if best is None or plan.total_bytes < best[2].total_bytes:
                best = (p, carry, plan)
            if fits(plan.total_bytes, hbm_budget_gb, plan.reserve_excess):
                return p, carry, plan
    assert best is not None
    raise MemoryBudgetError(
        f"no partition group fits hbm_budget_gb={hbm_budget_gb}: the "
        f"smallest candidate (p={best[0]}, prefetch_carry={best[1]!r}) "
        f"reserves {best[2].reserved_bytes / GIB:.3f} GiB per device "
        f"(args {best[2].args_bytes / GIB:.3f} + "
        f"temp {best[2].temp_bytes / GIB:.3f}, x {RESERVE_FACTOR} + "
        f"{best[2].reserve_excess / GIB:.3f} for the "
        f"allocator); raise the budget, shrink the model, or grow the world")
