"""The MiCS engine (the port of ``repro/core/mics.py``): its configuration,
the state's initialisation and the training step.

One step is one gradient-accumulation boundary over ``micro_steps``
micro-steps.  Each micro-step runs the loss forward and backward on this
rank's slice of the batch: every layer's flat shard is gathered over the
partition group before use (the cast to the wire dtype at p = 1), its
compute is checkpointed, and the gather's adjoint (hop 1) hands each
shard's gradient back in fp32, where it is added to the fp32 accumulator in
micro-step order (0 + g1 + g2 ...).  At the boundary
``core/schedule.apply_boundary`` runs hop 2, the exact global-norm clip
and AdamW on the flat fp32 shards (or the approximate clip's pipeline,
with ``clip_mode="approx"``).  ``prefetch_carry="remat"`` and
``carry_offload="host"`` change what the forward keeps of each gathered
layer for the backward (``models/lm.py``); ``offload_opt`` keeps AdamW's m
and v in pinned host memory (``core/hostoffload.py``).  The wires
(``quant_gather``: the int8 gather; ``hop1_wire_dtype`` and
``compress_hop2``: bf16 or int8 gradient wires, the int8 ones rounded as
``grad_rounding`` says) are the ``CommEngine``'s; the step's counter
``state["step"]`` (a host int) rides the context into every gather's
backward and into the boundary as the int8 wires' dither seed.  At tp > 1
(Megatron tensor parallelism under every partition group) a rank holds its
model coordinate's shards, the layers sum their row-parallel outputs over
the model group and the loss is vocab-parallel.  All collectives belong to one
``CommEngine`` over the process groups of ``launch/mesh.MiCSGroups``.
Unlike the reference's jitted step, which returns a new state, this step
updates the state's tensors in place and returns them.
"""

from __future__ import annotations

import dataclasses
import zlib

import torch

from repro_torch.core import hostoffload
from repro_torch.core.comm import (CARRY_OFFLOADS, GRAD_ROUNDINGS, HOP1_WIRE_DTYPES,
                                   PREFETCH_CARRIES, CommEngine)
from repro_torch.core.schedule import BOUNDARY_SCHEDULES, CLIP_MODES, apply_boundary, plan_boundary
from repro_torch.core.topology import MODEL_AXIS, MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import ModelDef
from repro_torch.optim.adamw import OptConfig

HOP2_WIRES = (False, True, "fp32", "bf16", "int8")
KV_DTYPES = ("fp32", "bf16", "int8")

# Training knobs the port refuses at anything but this value, with the
# ROADMAP Queue 1 item each waits for.
_PLANNER_ITEM = "ROADMAP Queue 1 item 8, the link model, memory planner and autotuner"
UNPORTED_TRAIN = {
    "policy": ("manual", f"the link-model autotuner ({_PLANNER_ITEM})"),
    "hbm_budget_gb": (None, f"the memory planner ({_PLANNER_ITEM})"),
}
# bf16 attention scores halve the HBM traffic of materialised scores in the
# reference (``repro/models/layers.py:164``); the port's flash kernels never
# materialise them, so the knob is declared unneeded (PERF.md §6).
SCORES_BF16_UNNEEDED = (
    "scores_bf16=True: declared unneeded (PERF.md §6, 'scores_bf16'): the port's flash "
    "kernels never write the scores to HBM, so bf16 scores would save no traffic; the "
    "kernels keep fp32 scores")
# Families the port trains on a CUDA device: each kernel their layers reach
# has a hand-written backward (griffin's RG-LRU since slice 7).
CUDA_TRAIN_FAMILIES = ("dense", "griffin")


@dataclasses.dataclass(frozen=True)
class MiCSConfig:
    """The knobs of the reference's ``MiCSConfig`` that the port reads (names
    and defaults as the reference).  Values outside a knob's set raise
    ``ValueError`` here; a known value the port does not run raises
    ``NotImplementedError`` where it would be used (``CommEngine.from_config``,
    ``build_serve_steps``, :func:`build_train_step`), naming the ROADMAP
    item it waits for."""

    micro_steps: int = 1
    hierarchical: bool = True           # staged gather (False: flat)
    gather_order: str = "inner_first"   # 'inner_first' | 'outer_first'
    gather_dtype: torch.dtype = torch.bfloat16
    sync_mode: str = "2hop"             # '2hop' | 'allreduce_slice' (Fig 14)
    hierarchy_inner: int | None = None  # staged gather's inner factor
    compress_hop2: bool | str = False   # hop-2 wire: False / 'fp32', True / 'bf16', 'int8'
    scores_bf16: bool = False           # bf16 attention scores (default only)
    quant_gather: bool = False          # the int8 gather wire (qwZ; stored int8 serving)
    hop1_wire_dtype: str = "fp32"       # 'fp32' | 'bf16' | 'int8' (qgZ)
    grad_rounding: str = "stochastic"   # the int8 gradient wires: 'stochastic' | 'nearest'
    prefetch: bool = True               # lookahead gathers
    prefetch_carry: str = "stored"      # 'stored' | 'remat' (backward re-gather)
    policy: str = "manual"              # (default only)
    boundary_schedule: str = "bucketed"  # 'serial' | 'bucketed'
    hop2_bucket_mb: float = 32.0
    clip_mode: str = "exact"            # 'exact' | 'approx' (one bucket stale)
    carry_offload: str = "none"         # 'none' | 'host' (the stored carry in host memory)
    offload_opt: bool = False           # AdamW m and v in pinned host memory
    hbm_budget_gb: float | None = None  # (default only)
    kv_dtype: str = "bf16"              # paged-KV block dtype: 'fp32' | 'bf16' | 'int8'
    kv_block_size: int = 16             # tokens per paged-KV block
    max_resident_requests: int = 0      # serving residency cap a rank (carried, not derived)

    def __post_init__(self):
        if self.gather_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gather_dtype must be float32 or bfloat16, "
                             f"got {self.gather_dtype}")
        if self.gather_order not in ("inner_first", "outer_first"):
            raise ValueError(f"unknown gather_order {self.gather_order!r}")
        if self.micro_steps < 1:
            raise ValueError(f"micro_steps must be >= 1, got {self.micro_steps}")
        for name, allowed in (("policy", ("manual", "auto")),
                              ("boundary_schedule", BOUNDARY_SCHEDULES),
                              ("clip_mode", CLIP_MODES),
                              ("prefetch_carry", PREFETCH_CARRIES),
                              ("carry_offload", CARRY_OFFLOADS),
                              ("hop1_wire_dtype", HOP1_WIRE_DTYPES),
                              ("grad_rounding", GRAD_ROUNDINGS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r} "
                                 f"(expected one of {allowed})")
        if self.clip_mode == "approx" and self.boundary_schedule != "bucketed":
            raise ValueError("clip_mode='approx' requires boundary_schedule='bucketed' "
                             "(the approximate clip is a property of the bucket pipeline)")
        if self.carry_offload == "host" and not (self.prefetch
                                                 and self.prefetch_carry == "stored"):
            raise ValueError("carry_offload='host' requires prefetch=True and "
                             "prefetch_carry='stored' (it offloads the stored carry)")
        if self.compress_hop2 not in HOP2_WIRES:
            raise ValueError(f"compress_hop2 must be a bool or one of fp32/bf16/int8, "
                             f"got {self.compress_hop2!r}")
        if self.hop2_bucket_mb <= 0:
            raise ValueError(f"hop2_bucket_mb must be > 0, got {self.hop2_bucket_mb}")
        if self.hbm_budget_gb is not None and self.hbm_budget_gb <= 0:
            raise ValueError(f"hbm_budget_gb must be > 0, got {self.hbm_budget_gb}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r} (expected one of {KV_DTYPES})")
        if self.kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {self.kv_block_size}")
        if self.max_resident_requests < 0:
            raise ValueError("max_resident_requests must be >= 0 (0 = no cap), "
                             f"got {self.max_resident_requests}")


def local_flat_shapes(model: ModelDef, topo: MiCSTopology) -> dict[str, tuple[int, int, int]]:
    """One rank's pool shapes ``[stack, 1, flat_len / p]`` (the reference's
    ``P(None, model, partition_axes)``: the global ``[stack, tp, flat_len]``
    cut to the rank's model coordinate and its chunk of the partition
    group)."""
    p = topo.partition_size
    return {name: (stack, 1, flat // p)
            for name, (stack, _tp, flat) in model.global_flat_shapes().items()}


def init_params(model: ModelDef, seed: int = 0, *, device: str | torch.device = "cuda",
                topo: MiCSTopology = MiCSTopology(), rank: int = 0) -> dict[str, torch.Tensor]:
    """``rank``'s fp32 flat pools ``{pool: [stack, 1, flat_len / p]}`` from
    ``seed``: chunk ``topo.partition_coord(rank)`` of each full row of the
    rank's model coordinate.

    The ``params`` part of the reference's ``init_state`` (no m, v, step):
    each segment is normal(0, std), zeros or ones as its layout says.  Each
    pool draws its full rows, one at a time, from its own
    ``torch.Generator`` on ``device``, seeded with crc32("<seed>:<pool
    name>") (32 bits: the CPU generator ignores higher bits), in the order
    (layer, model coordinate), so pools do not depend on each other's sizes
    and the state is a function of ``(model, seed)``, not of the topology.
    As in the reference, tp > 1 draws another logical model than tp = 1
    (``repro_torch.convert.tp_params_from_full`` cuts a tp = 1 model into
    tp shards instead).  The draws differ from JAX's; ``repro_torch.convert``
    carries JAX weights over where equal values are needed.
    """
    dev = resolve_device(device)
    shapes = local_flat_shapes(model, topo)
    coord = topo.rank_coords(rank)[MODEL_AXIS]
    params = {}
    for pool in model.all_pools():
        gen = torch.Generator(device=dev)
        gen.manual_seed(zlib.crc32(f"{seed}:{pool.name}".encode()))
        stack, _, shard = shapes[pool.name]
        lo = topo.partition_coord(rank) * shard
        rows = torch.empty((stack, 1, shard), dtype=torch.float32, device=dev)
        for i in range(stack):
            for j in range(model.tp):
                row = pool.layout.init_flat(gen, device=dev)
                if j == coord:
                    rows[i, 0] = row[lo:lo + shard]
        params[pool.name] = rows
    return params


def init_state(model: ModelDef, seed: int = 0, *, device: str | torch.device = "cuda",
               topo: MiCSTopology = MiCSTopology(), rank: int = 0, offload_opt: bool = False):
    """``{"params", "m", "v", "step"}``: ``rank``'s params from
    :func:`init_params`, zero m and v (fp32 flat shards like the params:
    on ``device``, or with ``offload_opt`` in host memory, pinned for a
    card), step 0.  The reference's offloaded state has no m and v; the
    port keeps them in the state as host tensors."""
    params = init_params(model, seed, device=device, topo=topo, rank=rank)
    return {"params": params, "m": _zero_moments(params, offload_opt),
            "v": _zero_moments(params, offload_opt), "step": 0}


def _zero_moments(params: dict, offload_opt: bool = False) -> dict:
    """Zero fp32 moments like ``params``: beside them, or with
    ``offload_opt`` in host memory (pinned when ``params`` are on a card)."""
    if not offload_opt:
        return {k: torch.zeros_like(p) for k, p in params.items()}
    return {k: hostoffload.pinned_zeros(p.shape, p.dtype, p.device)
            for k, p in params.items()}


def refuse_unported(mcfg: MiCSConfig, topo: MiCSTopology, family: str = "dense",
                    device: torch.device = torch.device("cpu")) -> None:
    """Raise ``NotImplementedError`` for a training setting the port does not
    run (it never runs the default program under another name), and for a
    model ``family`` the port does not train on ``device`` (a resolved
    ``torch.device``; only its type is read, so the check needs no card)."""
    if device.type == "cuda" and family not in CUDA_TRAIN_FAMILIES:
        raise NotImplementedError(
            f"family {family!r} does not train on a CUDA device: the port trains "
            f"{CUDA_TRAIN_FAMILIES} there (ROADMAP Queue 1 item 7, the other families)")
    for name, (default, item) in UNPORTED_TRAIN.items():
        if getattr(mcfg, name) != default:
            raise NotImplementedError(
                f"{name}={getattr(mcfg, name)!r}: {item} is not ported yet; "
                "the port trains with the default")
    if mcfg.scores_bf16:
        raise NotImplementedError(SCORES_BF16_UNNEEDED)


def _check_state(model: ModelDef, topo: MiCSTopology, state: dict, dev: torch.device,
                 offload_opt: bool = False) -> None:
    """The state's placement: every tensor fp32 of this rank's shape, the
    params on ``dev``, m and v on ``dev`` or, with ``offload_opt``, in host
    memory (pinned for a card), and nowhere else."""
    for part in ("params", "m", "v"):
        host = offload_opt and part != "params"
        for name, shape in local_flat_shapes(model, topo).items():
            t = state[part][name]
            placed = (hostoffload.is_host_resident(t, dev) if host
                      else t.device.type == dev.type)
            if tuple(t.shape) != shape or t.dtype != torch.float32 or not placed:
                where = ("pinned host memory" if dev.type == "cuda" else "host memory"
                         ) if host else str(dev)
                raise ValueError(f"state[{part!r}][{name!r}]: want fp32 {shape} in {where}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def build_train_step(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig, oc: OptConfig,
                     *, device: str | torch.device = "cuda", groups=None):
    """Returns ``step_fn(state, batch) -> (state, metrics)`` on ``device``.

    ``state``: this rank's shards (:func:`init_state`; with
    ``mcfg.offload_opt`` its m and v are host tensors, ``init_state(...,
    offload_opt=True)``); ``batch``: this rank's slice, tokens / targets /
    mask ``[micro_steps, b, T]`` (numpy or tensors).  ``groups``: the
    ``launch.mesh.MiCSGroups`` of ``topo``, needed at p > 1 or with more
    than one replica (``ValueError`` without).
    ``metrics``: fp32 0-dim tensors ``loss`` and ``aux`` (means over the
    micro-steps and the data ranks) and ``grad_norm`` (before the clip).  The
    state's params, m and v are updated in place; the returned state holds
    them and ``step + 1``.  ``step_fn.comm`` is the step's ``CommEngine``,
    ``step_fn.describe()`` the record of its settings.  ``state["step"]``
    is the int8 wires' dither seed: each step draws its own rounding."""
    dev = resolve_device(device)
    refuse_unported(mcfg, topo, model.cfg.family, dev)
    if model.tp != topo.model_size:
        raise ValueError(f"the model is built for tp = {model.tp}, the topology has "
                         f"tp = {topo.model_size}")
    comm = CommEngine.from_config(topo, mcfg, groups=groups)
    boundary = plan_boundary(model, topo, mode=mcfg.boundary_schedule,
                             bucket_mb=mcfg.hop2_bucket_mb, clip_mode=mcfg.clip_mode)
    ctx = L.Ctx(mode="train", tp=topo.model_size, compute_dtype=mcfg.gather_dtype,
                comm=comm)
    s = mcfg.micro_steps
    denom = float(s * topo.data_parallel_size)

    def step_fn(state, batch):
        _check_state(model, topo, state, dev, mcfg.offload_opt)
        batch = {k: torch.as_tensor(batch[k]).to(dev) for k in ("tokens", "targets", "mask")}
        if batch["tokens"].shape[0] != s:
            raise ValueError(f"batch has {batch['tokens'].shape[0]} micro-steps, "
                             f"the step runs {s}")
        step_ctx = dataclasses.replace(ctx, step_seed=int(state["step"]))
        grads, loss_sum, aux_sum = accumulate_grads(model, comm, step_ctx, state["params"],
                                                    batch)
        new_p, new_m, new_v, gnorm = apply_boundary(boundary, comm, model, topo, oc, state,
                                                     grads, denom, offload_opt=mcfg.offload_opt,
                                                     seed=step_ctx.step_seed)
        means = comm.replica_mean(torch.stack([loss_sum / s, aux_sum / s]).detach())
        metrics = {"loss": means[0], "aux": means[1], "grad_norm": gnorm}
        return {"params": new_p, "m": new_m, "v": new_v, "step": state["step"] + 1}, metrics

    step_fn.comm = comm   # its counter is the run's census of collectives
    step_fn.describe = lambda: {
        **comm.describe(), "boundary": boundary.describe(),
        "optimizer": {"offload_opt": mcfg.offload_opt,
                      "moments": "host" if mcfg.offload_opt else "device"}}
    return step_fn


def accumulate_grads(model: ModelDef, comm: CommEngine, ctx: L.Ctx, params: dict,
                     batch: dict[str, torch.Tensor]):
    """The micro-step loop of one step: for each micro-batch (dim 0 of
    ``batch``'s tokens / targets / mask), the loss forward and backward, each
    pool row's fp32 gradient added to its row of the accumulator in
    micro-step order.  Returns ``(grads, loss_sum, aux_sum)``: the fp32
    gradient sums like ``params``, and the fp32 sums of the micro-steps'
    ``loss`` and ``aux`` metrics."""
    dev = next(iter(params.values())).device
    grads = {name: torch.zeros_like(p) for name, p in params.items()}
    rows = {}
    for name, p in params.items():
        rows[name] = []
        for i in range(p.shape[0]):
            row = p[i, 0].detach().requires_grad_(True)
            row.register_post_accumulate_grad_hook(_accumulate_into(grads[name][i, 0]))
            rows[name].append(row)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    # Every model rank holds the same loss and seeds its backward with 1/tp.
    # Each psum's backward is a psum and each model gather's a
    # reduce-scatter (the reference's transposes), which add the tp seeds
    # back to one: the gradients are the loss's own.  The reference seeds
    # every rank with 1 under shard_map(..., check_vma=False), so its
    # gradients at tp > 1 are tp times these (ROADMAP Queue 3).  1/tp is
    # exact for tp a power of two.
    seed = torch.full((), 1.0 / ctx.tp, dtype=torch.float32, device=dev)
    for mb in range(batch["tokens"].shape[0]):
        micro = {k: v[mb] for k, v in batch.items()}
        loss, metrics = lm.loss_fn(model, rows, comm, ctx, micro)
        loss.backward(seed)
        loss_sum = loss_sum + metrics["loss"].detach()
        aux_sum = aux_sum + metrics["aux"]
    return grads, loss_sum, aux_sum


def _accumulate_into(dst: torch.Tensor):
    """A row's hook: add its fp32 gradient (the hop-1 adjoint's output) to
    the accumulator row and drop it."""

    def hook(row: torch.Tensor) -> None:
        dst.add_(row.grad)
        row.grad = None

    return hook
