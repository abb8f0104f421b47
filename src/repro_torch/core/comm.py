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

Still refused, naming the ROADMAP Queue 1 item they wait for: the int8
gather wire and the bf16 / int8 gradient wires (item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collectives as C
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

_WIRE_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
_WIRE_ITEM = "ROADMAP Queue 1 item 4, the int8 and bf16 wires"


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
    the Fig-14 ``allreduce_slice`` ablation, both with fp32 wires; the
    compressed wires raise."""

    mode: str = "2hop"
    hop1_wire_dtype: str = "fp32"
    hop2_wire_dtype: str = "fp32"

    def __post_init__(self):
        for name, value, allowed in (("mode", self.mode, SYNC_MODES),
                                     ("hop1_wire_dtype", self.hop1_wire_dtype, HOP1_WIRE_DTYPES),
                                     ("hop2_wire_dtype", self.hop2_wire_dtype, HOP2_WIRE_DTYPES)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r} (expected one of {allowed})")
        if self.hop1_wire_dtype != "fp32" or self.hop2_wire_dtype != "fp32":
            raise NotImplementedError(
                f"hop-1 wire {self.hop1_wire_dtype!r} / hop-2 wire {self.hop2_wire_dtype!r}: "
                f"the compressed gradient wires wait for {_WIRE_ITEM}; the port runs fp32")


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
                      hop2_wire_dtype=_hop2_wire(mcfg.compress_hop2))
    return gather, sync


class GatherFlat(torch.autograd.Function):
    """The gather of one flat row with its hop-1 adjoint: the forward casts
    the fp32 row to the wire dtype and gathers it with the policy's
    topology; the backward is :meth:`CommEngine._adjoint` (the staged
    reduce-scatter in the cotangent's own dtype: bf16 under the bf16 wire,
    as the reference's) followed by the cast back to fp32."""

    @staticmethod
    def forward(ctx, row, engine, dtype):
        ctx.engine = engine
        return engine._policy_all_gather(row.to(dtype))

    @staticmethod
    def backward(ctx, ct):
        return ctx.engine.gather_flat_adjoint(ct), None, None


class CommEngine:
    """Owns every parameter gather and gradient sync of one run.

    Over more than one rank (p > 1, replicas or tp > 1), ``groups`` (a
    ``launch.mesh.MiCSGroups`` of ``topo``) carries the collectives; without
    groups of this topology the engine raises ``ValueError``."""

    def __init__(self, topo: MiCSTopology, gather_policy: GatherPolicy = GatherPolicy(),
                 sync_policy: SyncPolicy = SyncPolicy(), *, groups=None):
        if gather_policy.wire_dtype == "int8":
            raise NotImplementedError(f"the int8 gather wire waits for {_WIRE_ITEM}")
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
        self.counter = C.CommCounter()
        self._model_gather_fn = (model_gather_fn_for(groups, self.counter)
                                 if topo.model_size > 1 else None)
        self._side: dict = {}
        self._host_stash: HostStash | None = None
        self._carry_tags: dict[str, int] = {}

    @classmethod
    def from_config(cls, topo: MiCSTopology, mcfg, *, groups=None) -> "CommEngine":
        return cls(topo, *policies_from_config(mcfg), groups=groups)

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

    def _adjoint(self, ct: torch.Tensor) -> torch.Tensor:
        """Hop 1 (§3.4), the staged reduce-scatter in ``ct``'s own dtype, or
        the Fig-14 ablation's full all-reduce and slice."""
        if self.sync_policy.mode == "allreduce_slice":
            return C.alternative_sync(ct, self.topo, self.groups, counter=self.counter)
        return self._policy_reduce_scatter(ct)

    # -- the gather API ----------------------------------------------------
    def gather_flat(self, row: torch.Tensor) -> torch.Tensor:
        """Gather one layer's flat shard into the full flat buffer, in the
        wire dtype; when ``row`` carries a gradient, as :class:`GatherFlat`."""
        dtype = self.gather_out_dtype()
        if torch.is_grad_enabled() and row.requires_grad:
            return GatherFlat.apply(row, self, dtype)
        return self._policy_all_gather(row.to(dtype))

    def gather_flat_adjoint(self, ct: torch.Tensor) -> torch.Tensor:
        """The hop-1 adjoint of :meth:`gather_flat`: the full-buffer
        cotangent in, this rank's fp32 shard cotangent out."""
        return self._adjoint(ct).to(torch.float32)

    def gather_ahead(self, row: torch.Tensor) -> torch.Tensor:
        """:meth:`gather_flat` issued ahead of the compute that uses it: at
        p > 1 on a card, on a side stream (a staged gather's second stage
        follows its first there), joined to the current stream by an event,
        the buffer marked as used by the current stream.  Elsewhere the plain
        gather.  Either way the same bits."""
        if self.topo.partition_size == 1 or not row.is_cuda:
            return self.gather_flat(row)
        cur = torch.cuda.current_stream(row.device)
        side = self._side.get(row.device)
        if side is None:
            side = self._side[row.device] = torch.cuda.Stream(row.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            full = self.gather_flat(row)
            done = torch.cuda.Event()
            done.record(side)
        cur.wait_event(done)
        full.record_stream(cur)
        return full

    def unflatten(self, pool, full: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rebuild layer tensors as views of the gathered buffer, the
        segments stored sharded over the model axis gathered along it."""
        return pool.layout.unflatten(full, model_gather_fn=self._model_gather_fn)

    def gather(self, pool, row: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.unflatten(pool, self.gather_flat(row))

    # -- gradient synchronization --------------------------------------------
    def hop2_(self, g: torch.Tensor, *, async_op: bool = False):
        """Hop 2 (§3.4): the replication-group all-reduce of the contiguous
        ``g`` in place at the accumulation boundary.  Returns ``g``, or with
        ``async_op`` the work to wait on.  Nothing is issued with one replica
        or under the Fig-14 ablation (its backward already summed over
        every data rank)."""
        if self.sync_policy.mode != "2hop":
            return C.Work(None) if async_op else g
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

    def model_pmax(self, x: torch.Tensor) -> torch.Tensor:
        return C.model_pmax(x, self.groups.model, counter=self.counter)

    def model_pmin(self, x: torch.Tensor) -> torch.Tensor:
        return C.model_pmin(x, self.groups.model, counter=self.counter)
