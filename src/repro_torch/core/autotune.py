"""Bandwidth-aware GatherPolicy / SyncPolicy autotuner (the port of
``repro/core/autotune.py``: the paper's §3-§4 decision procedure, run
analytically over a :mod:`repro_torch.core.linkmodel` profile).

Every collective of a step belongs to the ``CommEngine``, whose
``CommCounter`` counts calls and bytes by ``kind:stage``.  Given a model, a
MiCS topology and a link profile this module

1. **predicts** that census analytically (:func:`predict_traffic` — per-pool
   flat-buffer sizes x the port's schedule's collective event counts x
   ring-algorithm byte fractions, in the census's units;
   :func:`census_from_counter` turns a ``CommCounter.snapshot()`` into the
   same units and :func:`compare_census` holds the two stage by stage),
2. **costs** every candidate policy with the α-β model over the profile's
   two link tiers (:func:`rank_policies` — topology x inner factor x wire
   dtype x hop-2 compression x boundary schedule: the hop-2 stage is costed
   per bucket size as hidden-vs-exposed pipeline time,
   :func:`cost_hop2_schedule`), returning a ranked :class:`Plan`,
3. **resolves** ``MiCSConfig(policy="auto")`` into the concrete winning
   config (:func:`resolve_config`), which ``build_train_step``,
   ``build_serve_steps`` and the paged engine's builders call, and
4. **gates on memory** (``hbm_budget_gb``): every candidate is priced per
   device by the memory planner (``core/memplan.py``), infeasible
   candidates are filtered from selection, the remat and host carries join
   the grid, and :func:`resolve_scale` implements the paper's §3.1 rule —
   the minimal partition-group size whose aggregate memory holds the model
   states.

The per-stage byte identity worth knowing: a staged gather moves exactly the
same per-participant total as the flat gather —

    M(i-1)/p + M(o-1)/o  ==  M(p-1)/p        (p = i*o)

— hierarchical staging never saves bytes, it *moves them between tiers*
(only M(o-1)/p of an outer-first gather crosses the slow tier, vs the whole
M(p-1)/p of a flat ring that bottlenecks on it).  That is the MiCS §3.3
argument, and why the ranking depends on the link table.

Numerics policy: the tuner ranks lossy candidates (int8 gather wire,
bf16/int8 hop-2, int8 qgZ hop-1) alongside lossless ones, but only
*selects* them when the config opted into that exact mechanism
(``quant_gather=True`` — the int8 *weight* wire, whose gradient adjoint
stays exact; ``compress_hop2=True``/``"bf16"``/``"int8"`` — the hop-2 wire,
with ``"int8"`` also permitting the milder bf16; ``hop1_wire_dtype="int8"``
— the lossy qgZ gradient wire).  ``policy="auto"`` never changes training
numerics beyond what the flag the user set already meant.  At p = 1 every
topology and wire moves nothing, so the candidates tie on time and the
reference's sort order breaks the tie: an ``auto`` run on one card is
bitwise the manual run of the same chosen fields.

The decision procedures are the reference's.  What differs is what they
read: the event counts are the port's eager schedule's
(:func:`_event_counts`), the footprints the port's planner's, the default
profile the card's (``h100-p5``), and the resolved ``gather_dtype`` a
``torch`` dtype.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import memplan as M
from repro_torch.core.comm import WIRE_DTYPES, GatherPolicy, SyncPolicy, policies_from_config
from repro_torch.core.linkmodel import GIB, LinkProfile, get_profile
from repro_torch.core.quant import BLOCK
from repro_torch.core.schedule import plan_boundary
from repro_torch.core.topology import POD_AXIS, MiCSTopology, hierarchy_factors

# int8 collectives ship two payloads per stage (q int8 + one f32 absmax
# scale per BLOCK elements) — ~1.03 bytes/element on the wire.
INT8_WIRE_BYTES = 1.0 + 4.0 / BLOCK
# census bytes-per-element on the wire, by wire dtype.
_WIRE_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": INT8_WIRE_BYTES}
# gradient reduce-scatter element bytes under the uncompressed hop-1 wire
# (hop1_wire_dtype='fp32'): the adjoint runs in the gather wire dtype for
# float wires and in fp32 for int8 gathers (straight-through — the int8
# *gather* never quantizes its cotangent; that is qgZ's job, below).
_GRAD_BYTES_HOP1_FP32 = {"fp32": 4.0, "bf16": 2.0, "int8": 4.0}


def grad_wire_bytes(gather_wire: str, hop1_wire: str) -> float:
    """Adjoint reduce-scatter bytes/element for (gather wire, hop-1 wire).

    ``hop1_wire='fp32'`` is the legacy uncompressed adjoint (dtype follows
    the gather); ``'bf16'`` narrows the cotangent; ``'int8'`` is the qgZ
    per-stage block-quantized reduce-scatter — int8 payload + f32 scale
    traffic on every hop regardless of the forward wire (this is what flips
    the int8 *weight*-gather ranking in training: its fp32 straight-through
    adjoint stops dominating the gradient bytes)."""
    if hop1_wire == "int8":
        return INT8_WIRE_BYTES
    if hop1_wire == "bf16":
        return 2.0
    return _GRAD_BYTES_HOP1_FP32[gather_wire]


# Per-element HBM bytes of one qgZ stage's quantize + dequantize-accumulate
# (read fp32, write int8+scales; read int8+scales, accumulate fp32) — the
# compute overhead int8 hop-1 pays per stage on top of its wire time.
QGZ_COMPUTE_BYTES_PER_ELEM = 10.0


# ---------------------------------------------------------------------------
# stage structure: (label, group size, positions, wire fraction) per stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One ring stage of a gather policy over the partition group.

    ``wire_frac``: per-participant wire bytes of this stage as a fraction of
    the full gathered buffer M (census convention).  ``positions`` is one
    representative replica group in partition-group linear coordinates
    (slowest axis major) — what the link tier is decided from.
    """

    label: str                 # 'flat' | 'inner' | 'outer'
    group_size: int
    positions: tuple[int, ...]
    wire_frac: float


def _partition_axis_sizes(topo: MiCSTopology) -> list[int]:
    return [topo.axis_size(a) for a in topo.partition_axes]


def resolve_inner(topo: MiCSTopology, inner: int | None) -> tuple[int, int]:
    """(outer, inner) factorization a candidate actually runs with: the
    collectives' own (``topology.hierarchy_factors``)."""
    return hierarchy_factors(topo, inner)


def island_size(topo: MiCSTopology, profile: LinkProfile) -> int:
    """Fast-tier island extent in partition-group linear coordinates.

    Single-axis groups are contiguous ranks sharing the profile's node;
    multi-axis groups additionally cross the slowest mesh axis (pod) at
    every ``p / size(slowest)`` positions, whichever boundary comes first.
    """
    p = topo.partition_size
    sizes = _partition_axis_sizes(topo)
    if len(sizes) > 1:
        return min(profile.node_size, p // sizes[0])
    return min(profile.node_size, p)


def _hop2_tier(topo: MiCSTopology, profile: LinkProfile) -> str:
    """Link tier of the replication-group all-reduce.

    Replication peers are same-local-rank devices of *different* partition
    groups: stride ``p`` apart along the data axis (and across pods when a
    pod axis replicates).  Unlike partition stages, their coordinates live
    in the data-axis space, where the fast island is the profile's full
    node_size.
    """
    if POD_AXIS in topo.replication_axes \
            and topo.axis_size(POD_AXIS) > 1:
        return "inter"
    p = topo.partition_size
    positions = range(0, topo.replication_degree * p, p)
    return profile.group_tier(positions)


def gather_stages(topology: str, topo: MiCSTopology,
                  inner: int | None = None) -> list[StageSpec]:
    """Ring stages of one full-buffer gather under ``topology``.

    The same (label -> wire_frac) set describes the adjoint reduce-scatter:
    the stages run in reverse with identical per-stage wire bytes.
    """
    p = topo.partition_size
    if p == 1:
        return []
    if topology == "flat":
        return [StageSpec("flat", p, tuple(range(p)), (p - 1) / p)]
    outer, inner_f = resolve_inner(topo, inner)
    if outer == 1 or inner_f == 1:  # staging degenerates to one collective
        return [StageSpec("flat", p, tuple(range(p)), (p - 1) / p)]
    inner_grp = tuple(range(inner_f))                 # contiguous fast run
    outer_grp = tuple(range(0, p, inner_f))           # strided slow group
    if topology == "inner_first":
        return [
            StageSpec("inner", inner_f, inner_grp, (inner_f - 1) / p),
            StageSpec("outer", outer, outer_grp, (outer - 1) / outer),
        ]
    if topology == "outer_first":
        return [
            StageSpec("outer", outer, outer_grp, (outer - 1) / p),
            StageSpec("inner", inner_f, inner_grp, (inner_f - 1) / inner_f),
        ]
    raise ValueError(f"unknown topology {topology!r}")


# ---------------------------------------------------------------------------
# collective event counts per schedule
# ---------------------------------------------------------------------------

def _event_counts(stack: int, s: int, *, scanned: bool, prefetch: bool,
                  mode: str, carry: str = "stored") -> dict[str, float]:
    """How many gather / reduce-scatter events one pool contributes per step
    under the port's eager schedule (``models/lm.py``, ``core/mics.py``).

    * scanned pools of more than one layer under the prefetch schedule:
      every layer's row is gathered once a micro-step (the lookahead issues
      layer i+1's gather before layer i's compute; no wrap-around gather is
      issued and nothing is hoisted out of the micro-step loop), so
      ``s·stack`` gathers with the stored or the host carry; the remat
      carry re-gathers each row in the backward (``2·s·stack``).  Every
      gather has its one adjoint reduce-scatter (``s·stack``).
    * scanned pools under the serial schedule, and one-layer pools: the
      checkpoint holds gather + compute, so the backward's recompute
      re-gathers (``2·s·stack``), one adjoint each (``s·stack``).
    * embed / head pools: gathered each micro-step, outside any
      checkpoint (``s·stack`` each, one adjoint each).
    * serving: one gather a row (``stack``).

    The reference's counts differ where XLA transforms its loops: its
    prefetch issues a wrap-around lookahead and hoists the prologue gather
    and the embed / head gathers out of the micro-step loop
    (``s·stack + 1``, ``stack`` and ``s·(stack + 1)`` adjoints).
    """
    if mode == "serve":
        return {"ag": float(stack), "rs": 0.0}
    if scanned and prefetch and stack > 1:
        ag = 2 * s * stack if carry == "remat" else s * stack
    elif scanned:
        ag = 2 * s * stack        # forward + checkpoint re-gather
    else:
        ag = s * stack            # embed / head, each micro-step
    return {"ag": float(ag), "rs": float(s * stack)}


# ---------------------------------------------------------------------------
# the analytical census
# ---------------------------------------------------------------------------

def predict_traffic(
    model,
    topo: MiCSTopology,
    gather: GatherPolicy,
    sync: SyncPolicy,
    *,
    micro_steps: int = 1,
    mode: str = "train",
    profile: LinkProfile | None = None,
    boundary: str = "serial",
    hop2_bucket_mb: float = 32.0,
) -> dict:
    """Analytical per-stage wire-byte census of one training / serving step.

    Returns ``{"by_stage": {label: {wire_bytes, count, group_size, tier,
    events}}, "local_copy_bytes": float}`` in the units of
    :func:`census_from_counter` so the two can be compared stage by stage
    (:func:`compare_census`).  ``tier`` is resolved against ``profile``
    when given (cost-model input), else marked ``"?"``.

    ``boundary`` / ``hop2_bucket_mb`` set how many collectives hop 2
    issues: one a pool under ``serial`` (the reference's count), one a
    bucket of the boundary plan under ``bucketed``; its bytes do not
    depend on them.  An enc-dec decoder pool keeps the stored carry under
    remat, as the port's schedule does.
    """
    p = topo.partition_size
    s = int(micro_steps)
    by_stage: dict[str, dict] = {}
    local_copy = 0.0

    def acc(label: str, spec: StageSpec, nbytes: float, events: float,
            ncoll: float, tier: str = "?"):
        e = by_stage.setdefault(label, {
            "wire_bytes": 0.0, "count": 0.0, "events": 0.0,
            "group_size": spec.group_size, "tier": tier,
        })
        e["wire_bytes"] += nbytes
        e["count"] += ncoll
        e["events"] += events

    def stage_tier(spec: StageSpec) -> str:
        if profile is None:
            return "?"
        isl = island_size(topo, profile)
        return "intra" if len({q // isl for q in spec.positions}) <= 1 \
            else "inter"

    stages = gather_stages(gather.topology, topo, gather.inner)
    hop1_int8 = sync.hop1_wire_dtype == "int8" and p > 1
    hop2_int8 = sync.hop2_wire_dtype == "int8"
    wire_b = _WIRE_BYTES[gather.wire_dtype]
    grad_b = grad_wire_bytes(gather.wire_dtype, sync.hop1_wire_dtype)
    hop2_b = _WIRE_BYTES[sync.hop2_wire_dtype]
    colls_per_event = 2 if gather.wire_dtype == "int8" else 1
    # qgZ ships two payloads per stage (int8 q + f32 scales, both as
    # all-to-alls); a float adjoint is one reduce-scatter per stage.
    rs_colls_per_event = 2 if hop1_int8 else 1
    # int8 hop 2 = quantized exchange (2 all-to-alls) + quantized AG (2).
    hop2_colls = 4 if hop2_int8 else 1
    reorder = (gather.topology == "outer_first"
               and any(st.label == "outer" for st in stages))

    scanned = {pl.name for pl in model.pools}
    carry = "host" if getattr(gather, "carry_offload", "none") == "host" \
        else gather.prefetch_carry
    encdec = getattr(getattr(model, "cfg", None), "family", None) == "encdec"
    hop2_calls: dict[str, int] = {}
    if (mode == "train" and sync.mode == "2hop" and topo.replication_degree > 1
            and boundary == "bucketed"):
        plan = plan_boundary(model, topo, mode=boundary, bucket_mb=hop2_bucket_mb)
        for ref in plan.buckets:
            hop2_calls[ref.pool] = hop2_calls.get(ref.pool, 0) + 1
    for pool in model.all_pools():
        stack, _tp, flat_len = model.global_flat_shapes()[pool.name]
        pool_carry = "stored" if encdec and not pool.name.startswith("enc") else carry
        n = _event_counts(stack, s, scanned=pool.name in scanned,
                          prefetch=gather.prefetch, mode=mode,
                          carry=pool_carry)
        m_gather = flat_len * wire_b
        m_grad = flat_len * grad_b
        for st in stages:
            acc(f"param_gather.{st.label}", st,
                n["ag"] * st.wire_frac * m_gather, n["ag"],
                n["ag"] * colls_per_event, stage_tier(st))
            if mode == "train" and n["rs"] and sync.mode == "2hop":
                acc(f"grad_rs.{st.label}", st,
                    n["rs"] * st.wire_frac * m_grad, n["rs"],
                    n["rs"] * rs_colls_per_event, stage_tier(st))
        if reorder:
            local_copy += (n["ag"] + (n["rs"] if mode == "train" else 0.0)) \
                * flat_len * wire_b

        # hop 2: replication-group all-reduce once per step per pool
        if (mode == "train" and sync.mode == "2hop"
                and topo.replication_degree > 1):
            r = topo.replication_degree
            ob = stack * (flat_len / p) * hop2_b
            spec = StageSpec("hop2", r, tuple(range(0, r * p, p)), 0.0)
            acc("hop2", spec, 2.0 * ob * (r - 1) / r, 1.0,
                hop2_colls * hop2_calls.get(pool.name, 1),
                _hop2_tier(topo, profile) if profile else "?")

    return {"by_stage": by_stage, "local_copy_bytes": local_copy}


# CommCounter stage names (core/collectives.Group.name) -> census stage
# labels; the multi-axis partition groups are 'axis:<axis>' (the slowest
# partition axis outer).
_KIND_PREFIX = {"all_gather": "param_gather", "reduce_scatter": "grad_rs",
                "all_to_all": "grad_rs"}


def census_from_counter(snapshot: dict, topo: MiCSTopology, gather: GatherPolicy, *,
                        steps: int = 1) -> dict:
    """A ``CommCounter.snapshot()`` in :func:`predict_traffic`'s
    ``by_stage`` units, a step (the snapshot counted ``steps`` steps of a
    run under ``gather``): the port's counterpart of the reference's HLO
    census.

    The mapping, from the counter's ``kind:stage``:

    * ``all_gather:partition`` / ``:outer`` / ``:inner`` →
      ``param_gather.flat`` / ``.outer`` / ``.inner``
      (``all_gather:axis:<a>``: ``.outer`` for the slowest partition axis,
      else ``.inner``); the int8 wire's values and scales are two calls;
    * ``reduce_scatter:`` and the qgZ ``all_to_all:`` of the same stages →
      ``grad_rs.*`` (the qgZ values and scales are two calls);
    * ``all_reduce:replication``, and the int8 hop 2's
      ``all_to_all:replication`` and ``all_gather:replication`` → ``hop2``.

    The counter's bytes are each call's payload, the larger of its input
    and output: the stage's full buffer.  A ring moves ``(g - 1) / g`` of
    it a participant (twice that for an all-reduce), g the stage's group
    size, which is the census's wire bytes.  Everything else (the model
    axis, the data group's gathers and means, the norm's all-reduce) is
    outside the tuner's scope and left out.
    """
    axes = tuple(topo.partition_axes)
    staged = gather.topology != "flat" and topo.partition_size > 1
    outer, inner = resolve_inner(topo, gather.inner) if staged else (1, 1)
    sizes = {"partition": ("flat", topo.partition_size), "outer": ("outer", outer),
             "inner": ("inner", inner)}
    for i, ax in enumerate(axes if len(axes) > 1 else ()):
        sizes[f"axis:{ax}"] = ("outer" if i == 0 else "inner", topo.axis_size(ax))
    by_stage: dict[str, dict] = {}
    for key, calls in snapshot["calls"].items():
        kind, stage = key.split(":", 1)
        if stage == "replication" and kind in ("all_reduce", "all_to_all", "all_gather"):
            label, g = "hop2", topo.replication_degree
        elif kind in _KIND_PREFIX and stage in sizes:
            sub, g = sizes[stage]
            label = f"{_KIND_PREFIX[kind]}.{sub}"
        else:
            continue
        frac = (g - 1) / g * (2.0 if kind == "all_reduce" else 1.0)
        e = by_stage.setdefault(label, {"wire_bytes": 0.0, "count": 0.0, "group_size": g})
        e["wire_bytes"] += float(snapshot["bytes"][key]) * frac / steps
        e["count"] += calls / steps
    return by_stage


def compare_census(predicted: dict, measured: dict,
                   prefixes: tuple[str, ...] = ("param_gather", "grad_rs",
                                                "hop2")) -> dict:
    """Stage-by-stage predicted-vs-measured wire bytes and collective
    counts (census units).

    Only CommEngine-owned stages are compared (tensor-parallel traffic is
    out of the tuner's scope).
    """
    keys = {k for k in (*predicted, *measured)
            if k.split(".")[0] in {p.split(".")[0] for p in prefixes}}
    out = {}
    for k in sorted(keys):
        pred = predicted.get(k, {}).get("wire_bytes", 0.0)
        meas = measured.get(k, {}).get("wire_bytes", 0.0)
        out[k] = {
            "predicted_wire_bytes": pred,
            "measured_wire_bytes": meas,
            "ratio": (meas / pred) if pred else (1.0 if not meas else float("inf")),
            "predicted_count": predicted.get(k, {}).get("count", 0.0),
            "measured_count": measured.get(k, {}).get("count", 0.0),
        }
    return out


# ---------------------------------------------------------------------------
# hop-2 boundary-schedule costing (hidden vs exposed time per bucket size)
# ---------------------------------------------------------------------------

# Per-element HBM bytes of the compute a bucketed hop-2 can hide behind the
# next bucket's collective: reading the fp32 reduction result, writing the
# decompressed fp32 value (bf16 hop-2 wire), and the squared-norm partial's
# read.  Under the EXACT clip this is all that can hide — the global-norm
# barrier pins every AdamW shard update after the last bucket's partial
# (core/schedule.py's ordering argument).  Under the APPROX clip
# (``clip_mode='approx'``) bucket k-1's AdamW pipelines under bucket k's
# collective too, adding :data:`ADAMW_STREAM_BYTES_PER_ELEM` of hideable
# work per element.
HOP2_HIDE_BYTES_PER_ELEM = 12.0
# HBM bytes/element of one AdamW shard update: read p/m/v/g fp32 (16),
# write p/m/v fp32 (12) — the compute the approx-clip pipeline interleaves
# between hop-2 collectives.
ADAMW_STREAM_BYTES_PER_ELEM = 28.0

DEFAULT_HOP2_BUCKET_MB = 32.0
HOP2_BUCKET_MB_CANDIDATES = (4.0, 32.0, 128.0)


def cost_hop2_schedule(
    model,
    topo: MiCSTopology,
    profile: str | LinkProfile,
    sync: SyncPolicy,
    *,
    boundary: str = "serial",
    bucket_mb: float = DEFAULT_HOP2_BUCKET_MB,
    clip_mode: str = "exact",
) -> dict:
    """α-β cost of the boundary hop-2 under a schedule.

    ``serial``: one all-reduce per pool, fully exposed (the seed boundary —
    the optimizer waits for the whole tree).  ``bucketed``: fixed-byte
    buckets software-pipelined against the per-bucket norm/decompress
    compute (core/schedule.py); bucket *k*'s collective hides behind bucket
    *k−1*'s compute, so the exposed time under the exact clip is

        t_c[0] + Σ_{k≥1} max(0, t_c[k] − t_x[k−1])

    where ``t_c`` is each bucket's ring time and ``t_x`` the hideable
    compute (:data:`HOP2_HIDE_BYTES_PER_ELEM` over the profile's HBM
    bandwidth).  Smaller buckets expose less head time but pay one
    ``2(r−1)·α`` startup per bucket — the trade the tuner ranks
    ``hop2_bucket_mb`` over.

    ``clip_mode='approx'`` removes the global clip barrier: each bucket's
    AdamW update (:data:`ADAMW_STREAM_BYTES_PER_ELEM` more hideable bytes)
    pipelines under the next bucket's collective, and the head term
    ``t_c[0]`` drops too — bucket 0's clip factor needs no hop-2 result
    (the running norm through bucket −1 is empty, factor 1), so its
    collective hides under the pre-boundary backward epilogue.  Exposed
    time can reach zero — the fully-overlapped step.

    Returns ``{"t_total_s", "t_exposed_s", "t_hidden_s", "n_buckets",
    "clip_mode"}`` (zeros when hop 2 is absent).
    """
    profile = get_profile(profile)
    r = topo.replication_degree
    out = {"t_total_s": 0.0, "t_exposed_s": 0.0, "t_hidden_s": 0.0,
           "n_buckets": 0, "clip_mode": clip_mode}
    if r <= 1 or sync.mode != "2hop":
        return out
    tier = _hop2_tier(topo, profile)
    hop2_b = _WIRE_BYTES[sync.hop2_wire_dtype]
    quantized = sync.hop2_wire_dtype == "int8"
    # plan_boundary validates (boundary, clip_mode) compatibility.
    plan = plan_boundary(model, topo, mode=boundary, bucket_mb=bucket_mb,
                         clip_mode=clip_mode)
    approx = plan.clip_mode == "approx"
    hide_b = HOP2_HIDE_BYTES_PER_ELEM + (
        ADAMW_STREAM_BYTES_PER_ELEM if approx else 0.0)

    t_c: list[float] = []   # per-payload collective time, canonical order
    t_x: list[float] = []   # per-payload hideable compute time
    for n in plan.hop2_payload_elems():
        wire = 2.0 * n * hop2_b * (r - 1) / r
        t_c.append(profile.ring_time(tier, r, wire)
                   + (r - 1) * profile.link(tier).alpha)  # 2(r-1) hops
        if quantized:
            # quantize + dequantize both legs of the decomposed all-reduce
            t_c[-1] += profile.hbm_time(2 * n * QGZ_COMPUTE_BYTES_PER_ELEM)
        t_x.append(profile.hbm_time(n * hide_b))

    total = sum(t_c)
    if boundary == "serial" or not t_c:
        exposed = total
    else:
        head = 0.0 if approx else t_c[0]
        exposed = head + sum(
            max(0.0, t_c[k] - t_x[k - 1]) for k in range(1, len(t_c)))
    out.update(t_total_s=total, t_exposed_s=exposed,
               t_hidden_s=total - exposed, n_buckets=len(t_c))
    return out


# ---------------------------------------------------------------------------
# alpha-beta costing + ranking
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One costed (GatherPolicy, SyncPolicy, boundary schedule) combination."""

    gather: GatherPolicy
    sync: SyncPolicy
    t_comm_s: float                      # modeled collective seconds / step
    t_by_stage: dict
    bytes_by_stage: dict
    inter_wire_bytes: float              # slow-tier bytes / step
    lossy_wire: bool
    lossy_hop2: bool
    lossy_hop1: bool = False             # qgZ/bf16-compressed hop-1 wire
    boundary: str = "serial"             # hop-2 boundary schedule
    hop2_bucket_mb: float = DEFAULT_HOP2_BUCKET_MB
    clip_mode: str = "exact"             # boundary clip (approx = pipelined)
    n_hop2_buckets: int = 0
    t_hop2_total_s: float = 0.0          # full hop-2 ring time
    t_hop2_exposed_s: float = 0.0        # what actually serializes the step
    mem_bytes: float = 0.0               # memplan per-device footprint
    reserve_excess: float = 0.0          # memplan's reserve beyond RESERVE_FACTOR
    # -- serve-mode decode pricing (mode="serve" only) --------------------
    kv_dtype: str = "bf16"               # paged KV block dtype
    resident_requests: int = 0           # predicted residents per device
    t_decode_s: float = 0.0              # modeled decode-step seconds
    tokens_per_s: float = 0.0            # modeled global decode throughput

    def describe(self) -> dict:
        return {
            "gather": dataclasses.asdict(self.gather),
            "sync": dataclasses.asdict(self.sync),
            "t_comm_s": self.t_comm_s,
            "t_by_stage": dict(self.t_by_stage),
            "bytes_by_stage": {
                k: v["wire_bytes"] for k, v in self.bytes_by_stage.items()},
            "inter_wire_bytes": self.inter_wire_bytes,
            "lossy": self.lossy_wire or self.lossy_hop2 or self.lossy_hop1,
            "boundary": self.boundary,
            "hop2_bucket_mb": self.hop2_bucket_mb,
            "clip_mode": self.clip_mode,
            "carry_offload": self.gather.carry_offload,
            "n_hop2_buckets": self.n_hop2_buckets,
            "t_hop2_total_s": self.t_hop2_total_s,
            "t_hop2_exposed_s": self.t_hop2_exposed_s,
            "t_hop2_hidden_s": self.t_hop2_total_s - self.t_hop2_exposed_s,
            "mem_bytes": self.mem_bytes,
            "mem_gib": self.mem_bytes / GIB,
            "kv_dtype": self.kv_dtype,
            "resident_requests": self.resident_requests,
            "t_decode_s": self.t_decode_s,
            "tokens_per_s": self.tokens_per_s,
        }


@dataclasses.dataclass(frozen=True)
class Plan:
    """Ranked autotuning outcome for one (model, topo, profile)."""

    profile: LinkProfile
    mode: str
    micro_steps: int
    candidates: tuple[Candidate, ...]    # best first
    chosen: Candidate
    hbm_budget_gb: float | None = None   # GiB gate the ranking was filtered on

    def describe(self) -> dict:
        return {
            "profile": self.profile.name,
            "mode": self.mode,
            "micro_steps": self.micro_steps,
            "hbm_budget_gb": self.hbm_budget_gb,
            "chosen": self.chosen.describe(),
            "ranking": [c.describe() for c in self.candidates],
        }

    def table(self, top: int | None = 8) -> str:
        """Human-readable ranked table (what ``launch/train.py`` and
        ``launch/serve.py`` print under ``--policy auto``)."""
        budget = "" if self.hbm_budget_gb is None \
            else f" hbm_budget={self.hbm_budget_gb:g}GiB"
        serve = self.mode == "serve"
        head = (f"  {'rank':>4} {'topology':<12} {'inner':>5} {'wire':>5} "
                f"{'pf':>3} {'kv':>5} {'res':>5} "
                f"{'t_comm_ms':>10} {'t_dec_ms':>9} {'tok_s':>9} "
                f"{'mem_GB':>7}") if serve else (
                f"  {'rank':>4} {'topology':<12} {'inner':>5} {'wire':>5} "
                f"{'hop1':>5} {'hop2':>5} {'sched':>6} {'bkt_MB':>6} "
                f"{'clip':>6} {'carry':>6} {'off':>4} "
                f"{'t_comm_ms':>10} {'h2_exp_ms':>9} {'inter_MB':>9} "
                f"{'mem_GB':>7}")
        rows = [f"autotune[{self.profile.name}] mode={self.mode}{budget} "
                f"(chosen marked *):", head]
        cands = self.candidates[:top] if top else self.candidates
        for i, c in enumerate(cands):
            mark = "*" if c is self.chosen else " "
            mem = f"{c.mem_bytes / GIB:.2f}" if c.mem_bytes else "-"
            if serve:
                rows.append(
                    f" {mark}{i:>4} {c.gather.topology:<12} "
                    f"{str(c.gather.inner or '-'):>5} "
                    f"{c.gather.wire_dtype:>5} "
                    f"{'y' if c.gather.prefetch else 'n':>3} "
                    f"{c.kv_dtype:>5} {c.resident_requests:>5} "
                    f"{c.t_comm_s * 1e3:>10.3f} "
                    f"{c.t_decode_s * 1e3:>9.3f} "
                    f"{c.tokens_per_s:>9.0f} "
                    f"{mem:>7}")
                continue
            sched = "bucket" if c.boundary == "bucketed" else "serial"
            bkt = f"{c.hop2_bucket_mb:g}" if c.boundary == "bucketed" else "-"
            off = "host" if c.gather.carry_offload == "host" else "-"
            rows.append(
                f" {mark}{i:>4} {c.gather.topology:<12} "
                f"{str(c.gather.inner or '-'):>5} {c.gather.wire_dtype:>5} "
                f"{c.sync.hop1_wire_dtype:>5} "
                f"{c.sync.hop2_wire_dtype:>5} {sched:>6} {bkt:>6} "
                f"{c.clip_mode:>6} {c.gather.prefetch_carry:>6} {off:>4} "
                f"{c.t_comm_s * 1e3:>10.3f} "
                f"{c.t_hop2_exposed_s * 1e3:>9.3f} "
                f"{c.inter_wire_bytes / 1e6:>9.2f} "
                f"{mem:>7}")
        if self.chosen not in cands:
            rows.append(f"  ... chosen: {self.chosen.describe()['gather']}")
        return "\n".join(rows)


def cost_candidate(
    model,
    topo: MiCSTopology,
    profile: LinkProfile,
    gather: GatherPolicy,
    sync: SyncPolicy,
    *,
    micro_steps: int = 1,
    mode: str = "train",
    boundary: str = "serial",
    hop2_bucket_mb: float = DEFAULT_HOP2_BUCKET_MB,
    clip_mode: str = "exact",
) -> Candidate:
    """α-β time of one candidate: per-stage ring times over the profile's
    tiers + the outer-first reorder copy.  The hop-2 stage is costed by the
    boundary schedule (:func:`cost_hop2_schedule`): only its *exposed* time
    enters ``t_comm_s`` — under the bucketed pipeline the hidden fraction
    overlaps boundary compute and no longer serializes the step, and the
    approx clip (``clip_mode='approx'``) additionally pipelines AdamW
    under the collectives.  A host-offloaded carry
    (``gather.carry_offload='host'``) adds a ``host_offload`` stage: the
    2 x stack x flat_len bytes/micro-step each scanned pool streams over
    the profile's host tier (the price of freeing that HBM)."""
    pred = predict_traffic(model, topo, gather, sync,
                           micro_steps=micro_steps, mode=mode,
                           profile=profile)
    hop1_int8 = (sync.hop1_wire_dtype == "int8"
                 and topo.partition_size > 1 and mode == "train")
    t_by_stage: dict[str, float] = {}
    total = 0.0
    inter_bytes = 0.0
    for label, e in pred["by_stage"].items():
        if label == "hop2":
            continue  # costed by the boundary schedule below
        g = e["group_size"]
        hops = g - 1
        link = profile.link(e["tier"])
        t = e["events"] * hops * link.alpha + e["wire_bytes"] / link.bandwidth
        if hop1_int8 and label.startswith("grad_rs"):
            # quantize/dequantize-accumulate compute of each qgZ stage:
            # the stage streams ~g/(g-1) of its wire elements through HBM.
            elems = e["wire_bytes"] / INT8_WIRE_BYTES * g / max(hops, 1)
            t += profile.hbm_time(elems * QGZ_COMPUTE_BYTES_PER_ELEM)
        t_by_stage[label] = t
        total += t
        if e["tier"] == "inter":
            inter_bytes += e["wire_bytes"]
    hop2 = {"t_total_s": 0.0, "t_exposed_s": 0.0, "n_buckets": 0}
    if mode == "train" and "hop2" in pred["by_stage"]:
        hop2 = cost_hop2_schedule(model, topo, profile, sync,
                                  boundary=boundary, bucket_mb=hop2_bucket_mb,
                                  clip_mode=clip_mode)
        t_by_stage["hop2"] = hop2["t_exposed_s"]
        total += hop2["t_exposed_s"]
        if pred["by_stage"]["hop2"]["tier"] == "inter":
            inter_bytes += pred["by_stage"]["hop2"]["wire_bytes"]
    if pred["local_copy_bytes"]:
        t_by_stage["reorder.copy"] = profile.copy_time(
            pred["local_copy_bytes"])
        total += t_by_stage["reorder.copy"]
    if (mode == "train"
            and getattr(gather, "carry_offload", "none") == "host"):
        # d2h (forward put) + h2d (backward get) of every scanned pool's
        # carried buffer, once per layer per micro-step.  Priced serially
        # on the host tier — pessimistic (the streams overlap layer
        # compute on a real DMA engine), which keeps host-carry rows from
        # outranking in-HBM ones on time; they win only through the memory
        # gate, which is their purpose.
        cb = M._COMPUTE_BYTES[gather.wire_dtype]
        host_bytes = 0.0
        host_events = 0
        scanned = {pl.name for pl in model.pools}
        for name, (stack, _tp, flat_len) in \
                model.global_flat_shapes().items():
            if name in scanned and stack > 1:
                host_bytes += 2.0 * micro_steps * stack * flat_len * cb
                host_events += 2 * micro_steps * stack
        if host_bytes:
            t_by_stage["host_offload"] = profile.xfer_time(
                "host", host_bytes, host_events)
            total += t_by_stage["host_offload"]
    return Candidate(
        gather=gather, sync=sync, t_comm_s=total, t_by_stage=t_by_stage,
        bytes_by_stage=pred["by_stage"], inter_wire_bytes=inter_bytes,
        lossy_wire=gather.wire_dtype == "int8",
        lossy_hop2=sync.hop2_wire_dtype != "fp32",
        lossy_hop1=sync.hop1_wire_dtype != "fp32",
        boundary=boundary, hop2_bucket_mb=hop2_bucket_mb,
        clip_mode=clip_mode,
        n_hop2_buckets=hop2["n_buckets"],
        t_hop2_total_s=hop2["t_total_s"],
        t_hop2_exposed_s=hop2["t_exposed_s"],
    )


# kv_dtype permission ladder: MiCSConfig.kv_dtype is a numerics *ceiling*
# — the serve tuner may pick any dtype at or below its lossiness, never a
# lossier one the user did not opt into.
KV_DTYPES = ("fp32", "bf16", "int8")
_KV_LOSS = {d: i for i, d in enumerate(KV_DTYPES)}
DEFAULT_SERVE_CTX = 2048


def cost_decode_step(
    model,
    topo: MiCSTopology,
    profile: str | LinkProfile,
    gather: GatherPolicy,
    *,
    resident: int,
    ctx_len: int,
    kv_dtype: str = "bf16",
    chunk: int = 1,
    t_comm_s: float | None = None,
) -> dict:
    """Roofline model of one continuous-batching decode step.

    Decode re-gathers every layer's weights each step, so the step time is
    the interplay of a batch-independent weight stream and batch-dependent
    attention/GEMM work:

    * ``t_comm`` — the gather wire time (``cost_candidate`` serve mode);
    * ``t_weights`` — streaming the gathered buffers out of HBM once;
    * ``t_flops`` — ``2 * P_local * resident * chunk`` matmul FLOPs;
    * ``t_kv`` — reading every resident request's block-rounded KV pages
      (``memplan.kv_token_bytes``) for attention.

    Under a prefetched gather the wire time overlaps the previous layer's
    compute (``max``); a serial gather exposes it (``sum``).  ``resident``
    is per-device rows; throughput scales by the data-parallel width.
    """
    profile = get_profile(profile)
    weight_bytes = 0.0
    n_params_local = 0.0
    cb = M._COMPUTE_BYTES[gather.wire_dtype]
    for _name, (stack, _tp, flat_len) in model.global_flat_shapes().items():
        weight_bytes += stack * flat_len * cb
        n_params_local += stack * flat_len
    if t_comm_s is None:
        t_comm_s = cost_candidate(model, topo, profile, gather,
                                  SyncPolicy("2hop", "fp32", "fp32"),
                                  mode="serve").t_comm_s
    t_comm = t_comm_s
    t_weights = profile.hbm_time(weight_bytes)
    t_flops = 2.0 * n_params_local * resident * chunk / profile.peak_flops
    kv_bytes = resident * ctx_len * M.kv_token_bytes(model, kv_dtype)
    t_kv = profile.hbm_time(kv_bytes)
    t_compute = t_weights + t_flops + t_kv
    t_step = max(t_comm, t_compute) if gather.prefetch \
        else t_comm + t_compute
    dp = getattr(topo, "data_parallel_size", 1)
    tok_s = resident * chunk * dp / t_step if t_step > 0 else 0.0
    return {"t_step_s": t_step, "t_comm_s": t_comm, "t_weights_s": t_weights,
            "t_flops_s": t_flops, "t_kv_s": t_kv, "tokens_per_s": tok_s}


def enumerate_candidates(
    topo: MiCSTopology,
    *,
    prefetch: bool = True,
    wires: tuple[str, ...] = WIRE_DTYPES,
    hop1_wires: tuple[str, ...] = ("fp32", "int8"),
    mode: str = "train",
) -> list[tuple[GatherPolicy, SyncPolicy]]:
    """Candidate grid: topology x inner x wire dtype x hop-1 x hop-2 wire.

    The hop-1 axis defaults to {fp32, int8}: bf16 hop-1 is a manual option
    (``MiCSConfig(hop1_wire_dtype="bf16")``) but is dominated in the grid —
    it is lossy like qgZ while moving 2x its bytes.  Serving has no
    gradients, so the hop-1 axis collapses there; likewise at p == 1.
    """
    p = topo.partition_size
    gathers: list[GatherPolicy] = []
    for wire in wires:
        gathers.append(GatherPolicy("flat", wire, None, prefetch))
        if p < 4:
            continue  # staging degenerates below 2x2
        if len(topo.partition_axes) > 1:
            inners: list[int | None] = [None]  # factorization = axis split
        else:
            inners = [d for d in range(2, p) if p % d == 0]
        for inner in inners:
            for topology in ("inner_first", "outer_first"):
                gathers.append(GatherPolicy(topology, wire, inner, prefetch))
    hop2_wires = ("fp32", "bf16", "int8") \
        if topo.replication_degree > 1 else ("fp32",)
    if mode != "train" or p == 1:
        hop1s: tuple[str, ...] = ("fp32",)
    else:
        hop1s = tuple(dict.fromkeys(hop1_wires))  # de-dup, keep order
    return [(g, SyncPolicy("2hop", hop1_wire_dtype=h1, hop2_wire_dtype=h2))
            for g in gathers for h2 in hop2_wires for h1 in hop1s]


def enumerate_hop2_schedules(topo: MiCSTopology,
                             mode: str = "train") -> list[tuple[str, float]]:
    """Boundary-schedule axis of the candidate grid: the serial reference
    plus the bucketed pipeline at each :data:`HOP2_BUCKET_MB_CANDIDATES`
    size.  Collapses to one entry when hop 2 is absent (no replication, or
    serving — the boundary never runs)."""
    if mode != "train" or topo.replication_degree <= 1:
        return [("bucketed", DEFAULT_HOP2_BUCKET_MB)]
    return [("serial", DEFAULT_HOP2_BUCKET_MB)] + [
        ("bucketed", mb) for mb in HOP2_BUCKET_MB_CANDIDATES]


def rank_policies(
    model,
    topo: MiCSTopology,
    profile: str | LinkProfile,
    *,
    micro_steps: int = 1,
    prefetch: bool = True,
    mode: str = "train",
    allow_int8: bool = False,
    allow_bf16_hop2: bool = False,
    allow_int8_hop1: bool = False,
    allow_int8_hop2: bool = False,
    allow_approx_clip: bool = False,
    hbm_budget_gb: float | None = None,
    local_batch: int = 0,
    seq: int = 0,
    offload_opt: bool = False,
    mlstm_chunk: int = 0,
    kv_ceiling: str = "bf16",
    kv_block_size: int = 16,
    serve_ctx: int = 0,
    max_resident: int = 0,
    arrival_rate: float = 0.0,
) -> Plan:
    """Cost every candidate and rank by modeled collective time.

    The chosen plan is the fastest candidate whose numerics the caller
    opted into (``allow_int8`` — int8 gather wire, ``allow_bf16_hop2`` /
    ``allow_int8_hop2`` — the compressed hop-2 wires (the int8 opt-in also
    permits the milder bf16), ``allow_int8_hop1`` — the qgZ hop-1 wire);
    the full ranking (including lossy rows) is kept for the printed
    table.

    ``hbm_budget_gb`` adds the memory planner's gate (core/memplan.py):
    every candidate is priced per device and held to the budget with the
    allocator's reserve (``memplan.fits``), the ``prefetch_carry='remat'``
    and ``carry_offload='host'`` mitigations join the grid, infeasible
    candidates are excluded from selection (they stay in the ranking,
    marked by their ``mem_bytes``), and
    :class:`repro_torch.core.memplan.MemoryBudgetError` is raised — never a
    silently empty plan — when nothing numerics-eligible fits.
    ``local_batch``/``seq`` size the activation terms (0 = model states +
    comm buffers only); ``mlstm_chunk`` is the step's chunkwise mLSTM,
    which the planner's ``layer`` moment traces.

    The approx clip joins the grid on every bucketed-boundary candidate
    (``clip_mode`` column) but is selected only under
    ``allow_approx_clip`` — like the lossy wires, it changes numerics
    (one-bucket-stale clip factor) and must be opted into
    (``MiCSConfig(clip_mode="approx")``).  ``offload_opt`` is a config
    passthrough that shifts the m/v shards off-device in the footprint
    pricing; it is not a ranked axis (it has no policy interaction).
    """
    profile = get_profile(profile)
    carries = ("stored",) if hbm_budget_gb is None \
        else ("stored", "remat", "host")
    serve = mode == "serve"
    # serving ranks the prefetch toggle itself (overlap vs serial gathers
    # changes the decode roofline); training takes it as a caller input.
    prefetches = (True, False) if serve else (prefetch,)
    cands = []
    for pf in prefetches:
      for g, s in enumerate_candidates(topo, prefetch=pf, mode=mode):
        for boundary, bucket_mb in enumerate_hop2_schedules(topo, mode):
            clips = ("exact", "approx") if (
                boundary == "bucketed" and mode == "train"
                and topo.replication_degree > 1) else ("exact",)
            for clip in clips:
                for carry in carries:
                    if carry != "stored" and not (
                            g.prefetch and mode == "train"):
                        continue   # carries only differ with a backward
                    if carry == "host":
                        g2 = dataclasses.replace(
                            g, prefetch_carry="stored", carry_offload="host")
                    else:
                        g2 = dataclasses.replace(g, prefetch_carry=carry)
                    c = cost_candidate(model, topo, profile, g2, s,
                                       micro_steps=micro_steps, mode=mode,
                                       boundary=boundary,
                                       hop2_bucket_mb=bucket_mb,
                                       clip_mode=clip)
                    if serve:
                        if getattr(model, "cfg", None) is None:
                            # duck-typed planner stubs carry no attention
                            # dims: rank the gather axes alone, without
                            # the KV/residency grid (defaults sort these
                            # by t_comm_s, the pre-KV serve behavior)
                            mem = M.predict_footprint(
                                model, topo, g2, s, mode="serve")
                            cands.append(dataclasses.replace(
                                c, mem_bytes=mem.total_bytes))
                            continue
                        # KV-dtype axis: residency from the free HBM after
                        # the base footprint, decode step from the roofline.
                        ctx = serve_ctx or DEFAULT_SERVE_CTX
                        # (under a budget, what its reserve lets the
                        # allocator hand out)
                        cap_bytes = hbm_budget_gb * GIB / M.RESERVE_FACTOR \
                            if hbm_budget_gb else float(profile.hbm_bytes)
                        for kv in KV_DTYPES:
                            res = M.max_resident_requests(
                                model, topo, g2, s, hbm_bytes=cap_bytes,
                                ctx_len=ctx, kv_block_size=kv_block_size,
                                kv_dtype=kv)
                            if max_resident:
                                res = min(res, max_resident)
                            dec = cost_decode_step(
                                model, topo, profile, g2,
                                resident=max(res, 1), ctx_len=ctx,
                                kv_dtype=kv, t_comm_s=c.t_comm_s)
                            blocks = -(-ctx // kv_block_size)
                            mem_kv = M.predict_footprint(
                                model, topo, g2, s, mode="serve",
                                kv_pages_tokens=res * blocks * kv_block_size,
                                kv_dtype=kv)
                            cands.append(dataclasses.replace(
                                c, mem_bytes=mem_kv.total_bytes,
                                kv_dtype=kv, resident_requests=res,
                                t_decode_s=dec["t_step_s"],
                                tokens_per_s=dec["tokens_per_s"]))
                        continue
                    mem = M.predict_footprint(
                        model, topo, g2, s, micro_steps=micro_steps,
                        mode=mode, local_batch=local_batch, seq=seq,
                        boundary=boundary, hop2_bucket_mb=bucket_mb,
                        offload_opt=offload_opt and mode == "train",
                        mlstm_chunk=mlstm_chunk)
                    cands.append(dataclasses.replace(
                        c, mem_bytes=mem.total_bytes, reserve_excess=mem.reserve_excess))
    # modeled time first; among time-ties the smaller footprint wins (which
    # is what makes remat the tie-break choice at p=1, where the extra
    # backward re-gather moves zero wire bytes).  Exact clip and the
    # in-HBM carry sort before approx/host on full ties — reference
    # numerics and no host traffic unless they buy something.  Serving
    # sorts by the decode roofline instead (throughput breaks ties).
    if serve:
        cands.sort(key=lambda c: (c.t_decode_s, -c.tokens_per_s,
                                  c.t_comm_s, _KV_LOSS[c.kv_dtype],
                                  c.gather.topology, c.gather.wire_dtype,
                                  not c.gather.prefetch, c.mem_bytes))
    else:
        cands.sort(key=lambda c: (c.t_comm_s, c.gather.topology,
                              c.gather.wire_dtype, c.sync.hop1_wire_dtype,
                              c.sync.hop2_wire_dtype,
                              c.boundary, c.hop2_bucket_mb,
                              c.clip_mode != "exact",
                              c.mem_bytes, c.gather.prefetch_carry,
                              c.gather.carry_offload != "none"))

    def hop2_ok(c: Candidate) -> bool:
        wire = c.sync.hop2_wire_dtype
        if wire == "bf16":
            return allow_bf16_hop2 or allow_int8_hop2
        if wire == "int8":
            return allow_int8_hop2
        return True

    def fits(c: Candidate) -> bool:
        return hbm_budget_gb is None or M.fits(c.mem_bytes, hbm_budget_gb, c.reserve_excess)
    kv_cap = _KV_LOSS.get(kv_ceiling, _KV_LOSS["bf16"])
    eligible = [c for c in cands
                if (allow_int8 or not c.lossy_wire)
                and hop2_ok(c)
                and (allow_int8_hop1 or not c.lossy_hop1)
                and (allow_approx_clip or c.clip_mode == "exact")
                and (not serve or _KV_LOSS[c.kv_dtype] <= kv_cap)]
    feasible = [c for c in eligible if fits(c)]
    if hbm_budget_gb is not None and eligible and not feasible:
        smallest = min(eligible, key=lambda c: c.mem_bytes)
        raise M.MemoryBudgetError(
            f"no eligible policy fits hbm_budget_gb={hbm_budget_gb} on "
            f"p={topo.partition_size}: the smallest candidate "
            f"({smallest.gather.topology}/{smallest.gather.wire_dtype}, "
            f"prefetch_carry={smallest.gather.prefetch_carry!r}) reserves "
            f"{(smallest.mem_bytes * M.RESERVE_FACTOR + smallest.reserve_excess) / GIB:.3f} "
            f"GiB per device (plan x {M.RESERVE_FACTOR} for the allocator); grow the "
            f"partition group (memplan.min_partition_size) or the budget")
    pool = feasible or eligible or cands
    # a target arrival rate prefers the lowest-latency candidate that still
    # meets the demanded decode throughput; none meeting it -> fastest.
    meeting = [c for c in pool
               if not arrival_rate or c.tokens_per_s >= arrival_rate]
    chosen = (meeting or pool)[0]
    return Plan(profile=profile, mode=mode, micro_steps=micro_steps,
                candidates=tuple(cands), chosen=chosen,
                hbm_budget_gb=hbm_budget_gb)


# ---------------------------------------------------------------------------
# MiCSConfig resolution (policy="auto")
# ---------------------------------------------------------------------------

def resolve_config(mcfg, model, topo: MiCSTopology, *,
                   mode: str = "train", local_batch: int = 0, seq: int = 0,
                   arrival_rate: float = 0.0):
    """Resolve ``MiCSConfig(policy="auto")`` into concrete policy fields.

    Returns ``(resolved_config, plan)``; manual configs pass through with
    ``plan=None``.  The winning GatherPolicy/SyncPolicy is mapped back onto
    the legacy config fields so ``CommEngine.from_config`` (the one place
    those fields are interpreted) reconstructs exactly the chosen policies.

    With ``mcfg.hbm_budget_gb`` set, the memory planner gates the ranking
    (core/memplan.py): infeasible candidates are filtered out, the
    ``prefetch_carry='remat'`` mitigation joins the grid (chosen only when
    the stored carry does not fit — it costs one extra all-gather per
    layer), and a clear :class:`repro_torch.core.memplan.MemoryBudgetError` is
    raised when nothing fits on this topology's partition group.  Use
    :func:`resolve_scale` to pick the partition-group *size* itself — the
    paper's §3.1 minimal-group rule.
    """
    if getattr(mcfg, "policy", "manual") != "auto":
        return mcfg, None
    plan = rank_policies(
        model, topo, mcfg.link_profile,
        micro_steps=mcfg.micro_steps, prefetch=mcfg.prefetch, mode=mode,
        # per-mechanism permissions: quant_gather opts into the int8
        # *weight* wire only (its adjoint stays exact) — the lossy qgZ
        # gradient wire needs its own explicit hop1_wire_dtype opt-in
        allow_int8=mcfg.quant_gather,
        allow_bf16_hop2=mcfg.compress_hop2 in (True, "bf16", "int8"),
        allow_int8_hop2=mcfg.compress_hop2 == "int8",
        allow_int8_hop1=mcfg.hop1_wire_dtype == "int8",
        # approx clip is an approximation permission like the lossy wires
        allow_approx_clip=getattr(mcfg, "clip_mode", "exact") == "approx",
        hbm_budget_gb=getattr(mcfg, "hbm_budget_gb", None),
        local_batch=local_batch, seq=seq,
        offload_opt=getattr(mcfg, "offload_opt", False),
        mlstm_chunk=getattr(mcfg, "mlstm_chunk", 0),
        # serve axes: the configured kv_dtype is the numerics ceiling, the
        # configured residency (0 = planner-derived) caps the pool sizing
        kv_ceiling=getattr(mcfg, "kv_dtype", "bf16"),
        kv_block_size=getattr(mcfg, "kv_block_size", 16),
        serve_ctx=seq,
        max_resident=getattr(mcfg, "max_resident_requests", 0),
        arrival_rate=arrival_rate,
    )
    g, s = plan.chosen.gather, plan.chosen.sync
    if g.wire_dtype == "fp32":
        gather_dtype = torch.float32
    else:  # bf16 wire, and int8's dequantized compute dtype
        gather_dtype = torch.bfloat16
    resolved = dataclasses.replace(
        mcfg,
        policy="manual",
        hierarchical=g.topology != "flat",
        gather_order=g.topology if g.topology != "flat" else "inner_first",
        hierarchy_inner=g.inner,
        gather_dtype=gather_dtype,
        quant_gather=g.wire_dtype == "int8",
        sync_mode="2hop",
        compress_hop2=(s.hop2_wire_dtype
                       if s.hop2_wire_dtype != "fp32" else False),
        hop1_wire_dtype=s.hop1_wire_dtype,
        prefetch_carry=g.prefetch_carry,
        carry_offload=getattr(g, "carry_offload", "none"),
        boundary_schedule=plan.chosen.boundary,
        hop2_bucket_mb=plan.chosen.hop2_bucket_mb,
        clip_mode=plan.chosen.clip_mode,
    )
    if mode == "serve":
        # decode-policy round-trip: the winning KV dtype, prefetch toggle
        # and planner-derived residency land back on the config so the
        # paged engine (runtime/paged.py) builds exactly what was ranked.
        resolved = dataclasses.replace(
            resolved,
            prefetch=g.prefetch,
            kv_dtype=plan.chosen.kv_dtype,
            max_resident_requests=plan.chosen.resident_requests,
        )
    return resolved, plan


def resolve_scale(model, mcfg, *, data_extent: int, mode: str = "train",
                  local_batch: int = 0, seq: int = 0,
                  extra_replication: int = 1):
    """The paper's §3.1 scale-aware partitioning rule for ``MiCSConfig``.

    Returns ``(partition_size, carry, mem_plan)`` — the *minimal*
    partition-group size over a data axis of ``data_extent`` whose
    predicted per-device footprint fits ``mcfg.hbm_budget_gb`` GiB, trying
    the stored carry first, the remat mitigation second and the
    host-offloaded carry (``carry == "host"`` ->
    ``MiCSConfig(carry_offload="host")``) third at every size (a smaller
    group rescued by remat or host offload beats a larger stored one:
    smaller groups keep collectives on faster tiers, which is the whole
    point of scale-aware partitioning).  With ``mcfg.offload_opt`` the
    m/v shards leave the footprint too, shrinking the minimal group
    further.  Raises
    :class:`repro_torch.core.memplan.MemoryBudgetError` when even the full data
    axis (ZeRO-3 scale) does not fit.  ``extra_replication`` covers the
    data-parallel axes the group cannot span (pods, the dp2 leftover of a
    narrow tp) so hop-2 staging is priced even at p == data_extent.
    ``resolve_world`` applies this before the train loop builds a
    world's topology.
    """
    if getattr(mcfg, "hbm_budget_gb", None) is None:
        raise ValueError("resolve_scale needs MiCSConfig.hbm_budget_gb")
    gp, sp = policies_from_config(mcfg)
    carries = ("stored", "remat", "host") if gp.prefetch and mode == "train" \
        else ("stored",)
    return M.min_partition_size(
        model, data_extent=data_extent, hbm_budget_gb=mcfg.hbm_budget_gb,
        gather=gp, sync=sp, micro_steps=mcfg.micro_steps, mode=mode,
        local_batch=local_batch, seq=seq,
        boundary=mcfg.boundary_schedule,
        hop2_bucket_mb=mcfg.hop2_bucket_mb, carries=carries,
        offload_opt=getattr(mcfg, "offload_opt", False) and mode == "train",
        extra_replication=extra_replication, mlstm_chunk=getattr(mcfg, "mlstm_chunk", 0))


def resolve_world(model, mcfg, *, n_devices: int, tp: int = 1,
                  partition_size: int | None = None, mode: str = "train",
                  local_batch: int = 0, seq: int = 0):
    """Re-pick partition-group size + carry for an ``n_devices`` world.

    The elastic train loop's policy half (runtime/train_loop.py calls this
    on every :class:`repro_torch.core.faults.WorldChangeError` — pod loss or
    grow-back — before rebuilding the mesh): with ``mcfg.hbm_budget_gb``
    set it re-runs :func:`resolve_scale` so the degraded/grown world gets
    the paper's §3.1 minimal-fitting group (and the carry mitigation that
    rescued it); without a budget it keeps the previous ``partition_size``
    where it still divides the new data extent, else the largest divisor
    below it.  Everything here is analytic and deterministic, which is what
    makes an in-loop resume bitwise-reproducible by a cold restore with the
    same arguments (the elastic loop's contract, tests/test_torch_elastic.py).

    Returns ``(partition_size, mcfg2, info)`` where ``mcfg2`` carries the
    chosen carry/offload fields and ``info`` is a ledger-friendly dict.
    """
    if n_devices <= 0 or n_devices % max(tp, 1):
        raise ValueError(
            f"world of {n_devices} devices cannot carry tp={tp} "
            f"(flat layouts are TP-local: tp must divide the world)")
    data_extent = n_devices // max(tp, 1)
    if getattr(mcfg, "hbm_budget_gb", None) is not None:
        p, carry, mem_plan = resolve_scale(
            model, mcfg, data_extent=data_extent, mode=mode,
            local_batch=local_batch, seq=seq)
        if carry == "host":
            mcfg2 = dataclasses.replace(
                mcfg, prefetch_carry="stored", carry_offload="host")
        else:
            mcfg2 = dataclasses.replace(
                mcfg, prefetch_carry=carry, carry_offload="none")
        info = {"rule": "resolve_scale", "carry": carry,
                "hbm_budget_gb": mcfg.hbm_budget_gb,
                "mem_gib": mem_plan.total_bytes / GIB,
                "reserved_gib": mem_plan.reserved_bytes / GIB}
    else:
        prefer = min(partition_size or data_extent, data_extent)
        p = max(d for d in range(1, prefer + 1) if data_extent % d == 0)
        mcfg2, info = mcfg, {"rule": "keep", "carry": mcfg.prefetch_carry}
    info.update(partition_size=p, data_extent=data_extent, tp=tp,
                n_devices=n_devices)
    return p, mcfg2, info


def rerank_serve_world(model, topo: MiCSTopology, mcfg, *, seq: int = 0,
                       arrival_rate: float = 0.0):
    """Re-rank the serve policy grid for a changed world, numerics pinned.

    The resilient serve loop's policy half (runtime/resilient.py): after a
    preemption/grow-back the survivors' link geometry changed, so the
    gather topology, prefetch and planner residency that won on the old
    world may lose on the new one — :func:`rank_policies(mode="serve")` is
    re-run under the *same* ``hbm_budget_gb``.

    Numerics are pinned on purpose: the wire/compute dtype
    (``gather_dtype``/``quant_gather``), the KV dtype and the KV block
    size are copied back from the pre-fault config after the re-rank, so
    only bitwise-neutral axes (gather topology, inner factor, prefetch,
    residency) may move.  That is what keeps replayed completions
    bitwise-identical to the fault-free run — paged attention is invariant
    to the block table's layout and to the gather's staging (a gather moves
    bits), not to dtype changes.

    Returns ``(mcfg2, plan)``; ``plan`` is the ranked serve table (always
    produced, even for manual configs — the re-rank is the point).
    """
    base = dataclasses.replace(mcfg, policy="auto", max_resident_requests=0)
    resolved, plan = resolve_config(base, model, topo, mode="serve", seq=seq,
                                    arrival_rate=arrival_rate)
    # the re-resolved config is concrete (policy="manual"), so downstream
    # builders cannot re-rank away the pins below
    pinned = dataclasses.replace(
        resolved,
        gather_dtype=mcfg.gather_dtype, quant_gather=mcfg.quant_gather,
        kv_dtype=mcfg.kv_dtype, kv_block_size=mcfg.kv_block_size)
    return pinned, plan
