"""CommEngine: the single construction point for every parameter gather
and gradient sync (the port of ``repro/core/comm.py``).

MiCS gathers each layer's flat shard across its partition group of size p
before the layer runs, in stages (§3.3: ``GatherPolicy.topology`` is
``flat``, ``inner_first`` or the paper's ``outer_first``), reduce-scatters
the layer's gradient back over the same group in the backward (hop 1, the
gather's exact adjoint: :class:`GatherFlat`) and all-reduces gradients
across replicas once per accumulation boundary (hop 2, §3.4).  The
collectives run over the process groups of ``launch/mesh.MiCSGroups``
(``core/collectives.py``).  At p = 1 the gather is the cast of the fp32 row
to the wire dtype and its adjoint the cast back; with one replica hop 2 is
the identity.  Every collective adds to the engine's :class:`CommCounter`.

At tp > 1 the engine also owns the model axis (``groups.model``): the
reassembly of the segments stored sharded over it
(:meth:`CommEngine.unflatten`, the reference's ``model_gather_fn_for``)
and the layers' psums, gathers and maxima (``model_*``).  The partition
gather and its adjoint run unchanged on each model coordinate's rows.

The gather policy also carries what the prefetch schedule keeps of each
gathered layer for the backward (``prefetch_carry``: the buffer itself, or
``remat``, a re-gather) and where (``carry_offload``: ``host`` keeps the
stored buffer in pinned host memory); :attr:`CommEngine.host_stash` is the
run's host memory for that carry and for host-resident optimizer moments
(``core/hostoffload.py``).

The wires (ZeRO++'s qwZ / qgZ on the MiCS hierarchy, ``core/quant.py``):
the gather ships the row in the wire dtype, or under ``int8`` quantized
(nearest rounding) to int8 values and fp32 block scales, dequantized to
the compute dtype after the gather (:class:`QuantGatherFlat`; at p = 1 the
plain cast); a stored ``{'q', 's'}`` serving row is gathered as it is and
dequantized.  Hop 1 (``SyncPolicy.hop1_wire_dtype``) reduce-scatters the
cotangent in its own dtype (``fp32``), cast to bf16 (``bf16``) or as the
staged int8 exchange (``int8``); hop 2 (``hop2_wire_dtype``) all-reduces
fp32, bf16 (also at one replica, where it rounds the gradient, as the
reference does) or int8.  The int8 gradient wires round stochastically
(``grad_rounding``) under a dither keyed by the payload's salt, the stage,
the rank and the step seed that the train step threads through the
gathers and the boundary.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collectives as C
from repro_torch.core import quant as Q
from repro_torch.core.flat_param import model_gather_fn_for
from repro_torch.core.hostoffload import HostStash
from repro_torch.core.topology import MiCSTopology, hierarchy_factors

GATHER_TOPOLOGIES = ("flat", "inner_first", "outer_first")
WIRE_DTYPES = ("fp32", "bf16", "int8")
SYNC_MODES = ("2hop", "allreduce_slice")
HOP1_WIRE_DTYPES = ("fp32", "bf16", "int8")
HOP2_WIRE_DTYPES = ("fp32", "bf16", "int8")
PREFETCH_CARRIES = ("stored", "remat")
CARRY_OFFLOADS = ("none", "host")
GRAD_ROUNDINGS = ("stochastic", "nearest")

_WIRE_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GatherPolicy:
    """How a flat-param pool is gathered across its partition group:
    ``topology`` (the staged order, §3.3), ``inner`` (the intra-"node"
    factor of a single-axis staged gather; default
    ``topology.default_hierarchy_inner``), the wire dtype, the one-layer
    lookahead, and what the lookahead keeps for the backward: the gathered
    buffer (``stored``) or nothing, the backward re-gathering it
    (``remat``); the stored buffer in HBM or in pinned host memory
    (``carry_offload``)."""

    topology: str = "inner_first"  # 'flat' | 'inner_first' | 'outer_first'
    wire_dtype: str = "bf16"       # 'fp32' | 'bf16' | 'int8' (ZeRO++ qwZ)
    inner: int | None = None
    prefetch: bool = True
    prefetch_carry: str = "stored"  # 'stored' | 'remat'
    carry_offload: str = "none"     # 'none' | 'host'

    def __post_init__(self):
        if self.topology not in GATHER_TOPOLOGIES:
            raise ValueError(f"unknown gather topology {self.topology!r}")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {self.wire_dtype!r}")
        if self.prefetch_carry not in PREFETCH_CARRIES:
            raise ValueError(f"unknown prefetch_carry {self.prefetch_carry!r}")
        if self.carry_offload not in CARRY_OFFLOADS:
            raise ValueError(f"unknown carry_offload {self.carry_offload!r}")


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """How gradients synchronize (paper §3.4): ``2hop`` (hop-1
    reduce-scatter in the backward, hop-2 all-reduce at the boundary) or
    the Fig-14 ``allreduce_slice`` ablation; each hop's wire (``fp32``,
    ``bf16`` or ``int8``), and the int8 wires' rounding (``stochastic``,
    unbiased in expectation, or ``nearest``)."""

    mode: str = "2hop"
    hop1_wire_dtype: str = "fp32"
    hop2_wire_dtype: str = "fp32"
    grad_rounding: str = "stochastic"

    def __post_init__(self):
        for name, value, allowed in (("mode", self.mode, SYNC_MODES),
                                     ("hop1_wire_dtype", self.hop1_wire_dtype, HOP1_WIRE_DTYPES),
                                     ("hop2_wire_dtype", self.hop2_wire_dtype, HOP2_WIRE_DTYPES),
                                     ("grad_rounding", self.grad_rounding, GRAD_ROUNDINGS)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r} (expected one of {allowed})")
        if self.hop1_wire_dtype != "fp32" and self.mode != "2hop":
            raise ValueError("hop-1 wire compression requires the 2hop schedule (the "
                             "allreduce_slice ablation has no staged hop 1 to compress)")

    @property
    def stochastic(self) -> bool:
        return self.grad_rounding == "stochastic"


def _hop2_wire(compress_hop2) -> str:
    if compress_hop2 is False or compress_hop2 == "fp32":
        return "fp32"
    if compress_hop2 is True or compress_hop2 == "bf16":
        return "bf16"
    return compress_hop2


def policies_from_config(mcfg) -> tuple[GatherPolicy, SyncPolicy]:
    """Interpret a ``MiCSConfig``'s flags as the two policies (the one place
    they are read)."""
    if mcfg.quant_gather:
        wire = "int8"
    else:
        wire = "bf16" if mcfg.gather_dtype == torch.bfloat16 else "fp32"
    gather = GatherPolicy(topology=mcfg.gather_order if mcfg.hierarchical else "flat",
                          wire_dtype=wire, inner=mcfg.hierarchy_inner, prefetch=mcfg.prefetch,
                          prefetch_carry=mcfg.prefetch_carry, carry_offload=mcfg.carry_offload)
    sync = SyncPolicy(mode=mcfg.sync_mode, hop1_wire_dtype=mcfg.hop1_wire_dtype,
                      hop2_wire_dtype=_hop2_wire(mcfg.compress_hop2),
                      grad_rounding=mcfg.grad_rounding)
    return gather, sync


class GatherFlat(torch.autograd.Function):
    """The gather of one flat row with its hop-1 adjoint: the forward casts
    the fp32 row to ``dtype`` (the wire dtype; the compute dtype for the
    int8 wire at p = 1, where nothing is on the wire) and gathers it with
    the policy's topology; the backward is
    :meth:`CommEngine.gather_flat_adjoint` (hop 1 on the policy's wire in
    the cotangent's own dtype, bf16 under the bf16 wire as the reference's,
    then the cast back to fp32).  ``seed`` (the training step, or None)
    reaches the backward as a plain argument."""

    @staticmethod
    def forward(ctx, row, engine, dtype, seed):
        ctx.engine, ctx.seed = engine, seed
        return engine._policy_all_gather(row.to(dtype))

    @staticmethod
    def backward(ctx, ct):
        return ctx.engine.gather_flat_adjoint(ct, seed=ctx.seed), None, None, None


class QuantGatherFlat(torch.autograd.Function):
    """The qwZ gather (the reference's ``_build_gather_vjp(quantized=True)``):
    the forward quantizes the fp32 row with nearest rounding, gathers its
    int8 values and fp32 block scales with the policy's topology and
    dequantizes them to the compute dtype; the backward is
    straight-through, hop 1 of the fp32 cotangent on the policy's wire
    (the quantizer is never differentiated)."""

    @staticmethod
    def forward(ctx, row, engine, seed):
        ctx.engine, ctx.seed = engine, seed
        return engine._quant_gather(row)

    @staticmethod
    def backward(ctx, ct):
        return ctx.engine.gather_flat_adjoint(ct, seed=ctx.seed), None, None


class CommEngine:
    """Owns every parameter gather and gradient sync of one run.

    Over more than one rank (p > 1, replicas or tp > 1), ``groups`` (a
    ``launch.mesh.MiCSGroups`` of ``topo``) carries the collectives; without
    groups of this topology the engine raises ``ValueError``."""

    def __init__(self, topo: MiCSTopology, gather_policy: GatherPolicy = GatherPolicy(),
                 sync_policy: SyncPolicy = SyncPolicy(), *, groups=None,
                 compute_dtype: torch.dtype = torch.bfloat16):
        if topo.world_size > 1:
            if groups is None or groups.topo != topo:
                raise ValueError(
                    f"a {topo.world_size}-rank topology (p = {topo.partition_size}, "
                    f"{topo.replication_degree} replicas, tp = {topo.model_size}) needs the "
                    f"MiCSGroups of that topology, got "
                    f"{None if groups is None else groups.topo}")
            if (gather_policy.topology != "flat" and len(topo.partition_axes) == 1
                    and topo.partition_size > 1):
                outer, inner = hierarchy_factors(topo, gather_policy.inner)
                if outer > 1 and inner > 1:
                    groups.stage_groups(inner)
        self.topo = topo
        self.gather_policy = gather_policy
        self.sync_policy = sync_policy
        self.groups = groups
        self.compute_dtype = compute_dtype
        self.counter = C.CommCounter()
        self._model_gather_fn = (model_gather_fn_for(groups, self.counter)
                                 if topo.model_size > 1 else None)
        self._side: dict = {}
        self._host_stash: HostStash | None = None
        self._carry_tags: dict[str, int] = {}

    @classmethod
    def from_config(cls, topo: MiCSTopology, mcfg, *, groups=None) -> "CommEngine":
        return cls(topo, *policies_from_config(mcfg), groups=groups,
                   compute_dtype=mcfg.gather_dtype)

    @property
    def prefetch(self) -> bool:
        return self.gather_policy.prefetch

    @property
    def prefetch_carry(self) -> str:
        return self.gather_policy.prefetch_carry

    @property
    def carry_offload(self) -> str:
        return self.gather_policy.carry_offload

    @property
    def host_stash(self) -> HostStash:
        """The run's host memory (made on first use): the offloaded carry's
        slots and the copies of host-resident optimizer moments."""
        if self._host_stash is None:
            self._host_stash = HostStash()
        return self._host_stash

    def carry_tag(self, pool_name: str) -> int:
        """A pool's stable number among the carry slots' keys."""
        return self._carry_tags.setdefault(pool_name, len(self._carry_tags))

    def gather_out_dtype(self) -> torch.dtype:
        """The gathered buffer's dtype: the wire dtype, or the compute dtype
        under the int8 wire."""
        if self.gather_policy.wire_dtype == "int8":
            return self.compute_dtype
        return _WIRE_TORCH[self.gather_policy.wire_dtype]

    def describe(self) -> dict:
        """The static record of the engine's policies and groups."""
        topo = self.topo
        outer, inner = (hierarchy_factors(topo, self.gather_policy.inner)
                        if topo.partition_size > 1 else (1, 1))
        return {"gather": dataclasses.asdict(self.gather_policy),
                "sync": dataclasses.asdict(self.sync_policy),
                "partition_axes": list(topo.partition_axes),
                "replication_axes": list(topo.replication_axes),
                "partition_size": topo.partition_size,
                "replication_degree": topo.replication_degree,
                "hierarchy": {"outer": outer, "inner": inner},
                "compute_dtype": str(self.compute_dtype).removeprefix("torch."),
                "wires": {"gather": self.gather_policy.wire_dtype,
                          "hop1": self.sync_policy.hop1_wire_dtype,
                          "hop2": self.sync_policy.hop2_wire_dtype,
                          "grad_rounding": self.sync_policy.grad_rounding},
                "backend": None if self.groups is None else self.groups.backend}

    # -- the policy's collectives ------------------------------------------
    def _policy_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        gp = self.gather_policy
        return C.partition_all_gather(x, self.topo, self.groups,
                                      hierarchical=gp.topology != "flat", order=gp.topology,
                                      inner=gp.inner, counter=self.counter)

    def _policy_reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        gp = self.gather_policy
        if self.topo.partition_size == 1:
            return g
        if gp.topology == "flat":
            return C.hop1_reduce_scatter(g, self.topo, self.groups, counter=self.counter)
        return C.hierarchical_reduce_scatter(g, self.topo, self.groups, order=gp.topology,
                                             inner=gp.inner, counter=self.counter)

    def _adjoint(self, ct: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        """Hop 1 (§3.4) on the policy's wire, returned in ``ct``'s dtype:
        the staged reduce-scatter in ``ct``'s own dtype (``fp32``), of
        ``ct`` cast to bf16 (``bf16``), or at p > 1 the staged int8
        exchange (``int8``, ``seed`` keying its stochastic dither); or the
        Fig-14 ablation's full all-reduce and slice."""
        if self.sync_policy.mode == "allreduce_slice":
            return C.alternative_sync(ct, self.topo, self.groups, counter=self.counter)
        hop1 = self.sync_policy.hop1_wire_dtype
        if hop1 == "int8" and self.topo.partition_size > 1:
            gp = self.gather_policy
            out = C.quantized_reduce_scatter(
                ct, self.topo, self.groups, topology=gp.topology, inner=gp.inner,
                stochastic=self.sync_policy.stochastic, seed=seed, counter=self.counter)
            return out.to(ct.dtype)
        if hop1 == "bf16":
            return self._policy_reduce_scatter(ct.to(torch.bfloat16)).to(ct.dtype)
        return self._policy_reduce_scatter(ct)

    def _quant_gather(self, row: torch.Tensor) -> torch.Tensor:
        """The qwZ forward: quantize (nearest), gather values and scales,
        dequantize to the compute dtype."""
        q, s = Q.quantize_flat(row)
        return Q.dequantize_flat(self._policy_all_gather(q), self._policy_all_gather(s),
                                 self.compute_dtype)

    # -- the gather API ----------------------------------------------------
    def gather_flat(self, row, *, seed: int | None = None) -> torch.Tensor:
        """Gather one layer's flat shard into the full flat buffer, in
        :meth:`gather_out_dtype`; when ``row`` carries a gradient, as
        :class:`GatherFlat` or :class:`QuantGatherFlat`, ``seed`` (the
        training step) keying the int8 hop-1 wire's dither.  ``row`` may be
        a stored serving row ``{'q': int8, 's': fp32}``
        (``quant.quantize_state``): its values and scales are gathered as
        they are and dequantized to the compute dtype."""
        if isinstance(row, dict):
            return Q.dequantize_flat(self._policy_all_gather(row["q"]),
                                     self._policy_all_gather(row["s"]), self.compute_dtype)
        grad = torch.is_grad_enabled() and row.requires_grad
        if self.gather_policy.wire_dtype == "int8" and self.topo.partition_size > 1:
            return QuantGatherFlat.apply(row, self, seed) if grad else self._quant_gather(row)
        dtype = self.gather_out_dtype()
        if grad:
            return GatherFlat.apply(row, self, dtype, seed)
        return self._policy_all_gather(row.to(dtype))

    def gather_flat_adjoint(self, ct: torch.Tensor, *, seed: int | None = None) -> torch.Tensor:
        """The hop-1 adjoint of :meth:`gather_flat`: the full-buffer
        cotangent in, this rank's fp32 shard cotangent out.  Under the int8
        gather the cotangent goes to hop 1 in fp32, and at p = 1 (the
        forward a plain cast) it is only cast back, as the reference's."""
        if self.gather_policy.wire_dtype == "int8":
            if self.topo.partition_size == 1:
                return ct.to(torch.float32)
            return self._adjoint(ct.to(torch.float32), seed)
        return self._adjoint(ct, seed).to(torch.float32)

    def gather_ahead(self, row, *, seed: int | None = None) -> torch.Tensor:
        """:meth:`gather_flat` issued ahead of the compute that uses it: at
        p > 1 on a card, on a side stream (a staged gather's second stage
        follows its first there), joined to the current stream by an event,
        the buffer marked as used by the current stream.  Elsewhere the plain
        gather.  Either way the same bits.  A stored ``{'q', 's'}`` row at
        p = 1 dequantizes on the current stream, which uses it."""
        lead = row["q"] if isinstance(row, dict) else row
        if self.topo.partition_size == 1 or not lead.is_cuda:
            return self.gather_flat(row, seed=seed)
        cur = torch.cuda.current_stream(lead.device)
        side = self._side.get(lead.device)
        if side is None:
            side = self._side[lead.device] = torch.cuda.Stream(lead.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            full = self.gather_flat(row, seed=seed)
            done = torch.cuda.Event()
            done.record(side)
        cur.wait_event(done)
        full.record_stream(cur)
        return full

    def unflatten(self, pool, full: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rebuild layer tensors as views of the gathered buffer, the
        segments stored sharded over the model axis gathered along it."""
        return pool.layout.unflatten(full, model_gather_fn=self._model_gather_fn)

    def gather(self, pool, row, *, seed: int | None = None) -> dict[str, torch.Tensor]:
        return self.unflatten(pool, self.gather_flat(row, seed=seed))

    # -- gradient synchronization --------------------------------------------
    def hop2_(self, g: torch.Tensor, *, async_op: bool = False, salt: int = 0,
              seed: int | None = None):
        """Hop 2 (§3.4): the replication-group all-reduce of the contiguous
        fp32 ``g`` in place at the accumulation boundary, on the policy's
        wire: fp32; bf16 (``g`` cast, all-reduced and cast back; at one
        replica the round trip alone, as the reference's); int8 with more
        than one replica (:func:`collectives.quantized_all_reduce`, ``salt``
        and ``seed`` keying its dither).  Returns ``g``, or with ``async_op``
        the work to wait on, whose ``wait()`` also finishes the wire (the
        bf16 cast back; int8's sum, second leg and write-back).  Nothing is
        issued under the Fig-14 ablation (its backward already summed over
        every data rank)."""
        if self.sync_policy.mode != "2hop":
            return C.Work(None) if async_op else g
        wire = self.sync_policy.hop2_wire_dtype
        if wire == "int8" and self.topo.replication_degree > 1:
            return C.quantized_all_reduce(g, self.topo, self.groups, salt=salt,
                                          stochastic=self.sync_policy.stochastic, seed=seed,
                                          out=g, async_op=async_op, counter=self.counter)
        if wire == "bf16":
            wire_g = g.to(torch.bfloat16)
            work = C.hop2_all_reduce(wire_g, self.topo, self.groups, async_op=True,
                                     counter=self.counter)
            work = C.Work(work, lambda: g.copy_(wire_g))
            if async_op:
                return work
            work.wait()
            return g
        return C.hop2_all_reduce(g, self.topo, self.groups, async_op=async_op,
                                 counter=self.counter)

    def norm_all_reduce_(self, sq: torch.Tensor) -> torch.Tensor:
        """The squared gradient norm's sum over the partition group, then
        over the model group (the reference's psum over the partition and
        model axes), in place.  Every model-sharded segment is stored once,
        so the sum counts each parameter once."""
        if self.topo.partition_size > 1:
            C.all_reduce_(sq, self.groups.partition, counter=self.counter)
        if self.topo.model_size > 1:
            C.all_reduce_(sq, self.groups.model, counter=self.counter)
        return sq

    def partition_coord(self) -> int:
        """This rank's index within its partition group."""
        return 0 if self.groups is None else self.groups.partition_coord

    def data_rank(self) -> int:
        """This rank's index among the data ranks (its rows of a batch)."""
        return 0 if self.groups is None else self.topo.data_rank(self.groups.rank)

    def data_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' ``x`` (dim 0: each rank's rows) stacked in data-rank
        order over the data group (``all_gather:data``); ``x`` itself at dp 1."""
        if self.topo.data_parallel_size == 1:
            return x
        return C.all_gather(x, self.groups.data, counter=self.counter)

    def replica_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over every data rank."""
        return C.replica_mean(x, self.topo, self.groups, counter=self.counter)

    # -- the model axis (tensor parallelism) ---------------------------------
    def model_coord(self) -> int:
        """This rank's coordinate on the model axis."""
        return 0 if self.groups is None else self.groups.model_coord

    def model_psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model group (its backward a psum too)."""
        return C.model_all_reduce(x, self.groups.model, counter=self.counter)

    def model_all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Tiled gather along ``axis`` over the model group (its backward
        the reduce-scatter)."""
        return C.model_all_gather(x, self.groups.model, axis=axis, counter=self.counter)

    def model_all_to_all(self, x: torch.Tensor, *, to_owners: bool) -> torch.Tensor:
        """The expert exchange over the model group (``C.model_all_to_all``)."""
        return C.model_all_to_all(x, self.groups.model, to_owners=to_owners,
                                  counter=self.counter)

    def model_pmax(self, x: torch.Tensor) -> torch.Tensor:
        return C.model_pmax(x, self.groups.model, counter=self.counter)

    def model_pmin(self, x: torch.Tensor) -> torch.Tensor:
        return C.model_pmin(x, self.groups.model, counter=self.counter)
