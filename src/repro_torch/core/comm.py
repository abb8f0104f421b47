"""CommEngine: the single construction point for every parameter gather
and gradient sync (the port of ``repro/core/comm.py``).

MiCS gathers each layer's flat shard across its partition group of size p
before the layer runs, reduce-scatters the layer's gradient back over the
same group in the backward (hop 1, the gather's adjoint) and all-reduces
gradients across replicas once per accumulation boundary (hop 2, paper
§3.4).  On one card p = 1, tp = 1 and data parallel 1, so nothing moves
between devices: the gather is the cast of the fp32 row to the wire dtype,
exactly what ``repro/core/comm.py`` does when ``partition_size == 1``; its
adjoint is the cotangent cast back to fp32 (:class:`GatherFlat`); hop 2 is
the identity.  p > 1, data parallel > 1 (NCCL process groups) and the
int8 / bf16 wires raise ``NotImplementedError``: they come with the
multi-chip collectives slice and the int8-wire slice (ROADMAP Queue 1 items
2 and 4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.topology import MiCSTopology

WIRE_DTYPES = ("fp32", "bf16", "int8")
SYNC_MODES = ("2hop", "allreduce_slice")
HOP1_WIRE_DTYPES = ("fp32", "bf16", "int8")
HOP2_WIRE_DTYPES = ("fp32", "bf16", "int8")

_WIRE_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GatherPolicy:
    """How a flat-param pool is gathered.  The staged order of the gather
    (the reference's ``topology`` and ``inner``) only shapes a gather across
    a partition group of p > 1 and joins this policy with that slice."""

    wire_dtype: str = "bf16"       # 'fp32' | 'bf16' | 'int8' (ZeRO++ qwZ)
    prefetch: bool = True          # one-layer lookahead gather

    def __post_init__(self):
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire dtype {self.wire_dtype!r}")


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """How gradients synchronize (paper §3.4): ``2hop`` (hop-1
    reduce-scatter in the backward, hop-2 all-reduce at the boundary) with
    fp32 wires is what the port runs; the Fig-14 ``allreduce_slice``
    ablation and the compressed wires raise."""

    mode: str = "2hop"
    hop1_wire_dtype: str = "fp32"
    hop2_wire_dtype: str = "fp32"

    def __post_init__(self):
        for name, value, allowed in (("mode", self.mode, SYNC_MODES),
                                     ("hop1_wire_dtype", self.hop1_wire_dtype, HOP1_WIRE_DTYPES),
                                     ("hop2_wire_dtype", self.hop2_wire_dtype, HOP2_WIRE_DTYPES)):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r} (expected one of {allowed})")
        if self.mode != "2hop":
            raise NotImplementedError(
                "sync_mode='allreduce_slice' (the Fig-14 ablation) comes with the "
                "multi-chip collectives slice (ROADMAP Queue 1 item 2, multi-rank MiCS "
                "collectives)")
        if self.hop1_wire_dtype != "fp32" or self.hop2_wire_dtype != "fp32":
            raise NotImplementedError(
                f"hop-1 wire {self.hop1_wire_dtype!r} / hop-2 wire {self.hop2_wire_dtype!r}: "
                "the compressed gradient wires wait for ROADMAP Queue 1 item 4, int8 and bf16 "
                "wires; "
                "the port runs fp32")


def _hop2_wire(compress_hop2) -> str:
    if compress_hop2 is False or compress_hop2 == "fp32":
        return "fp32"
    if compress_hop2 is True or compress_hop2 == "bf16":
        return "bf16"
    return compress_hop2


def policies_from_config(mcfg) -> tuple[GatherPolicy, SyncPolicy]:
    """Interpret a ``MiCSConfig``'s flags as the two policies.  A
    staged-gather or sync setting other than what the port runs raises
    rather than run the default program under another name."""
    if (not mcfg.hierarchical or mcfg.gather_order != "inner_first"
            or mcfg.hierarchy_inner is not None):
        raise NotImplementedError(
            f"hierarchical={mcfg.hierarchical}, gather_order={mcfg.gather_order!r}, "
            f"hierarchy_inner={mcfg.hierarchy_inner}: the staged gather order over "
            "p > 1 comes with the multi-chip collectives slice")
    if mcfg.quant_gather:
        wire = "int8"
    else:
        wire = "bf16" if mcfg.gather_dtype == torch.bfloat16 else "fp32"
    sync = SyncPolicy(mode=mcfg.sync_mode, hop1_wire_dtype=mcfg.hop1_wire_dtype,
                      hop2_wire_dtype=_hop2_wire(mcfg.compress_hop2))
    return GatherPolicy(wire_dtype=wire, prefetch=mcfg.prefetch), sync


class GatherFlat(torch.autograd.Function):
    """The gather of one flat row with its hop-1 adjoint, at p = 1: the
    forward casts the fp32 row to the wire dtype; the backward is the
    reduce-scatter over the partition group in the cotangent's own dtype
    (the fp32 hop-1 wire; the identity at p = 1) followed by the transpose
    of the cast, back to fp32, where the reference's autodiff rounds it."""

    @staticmethod
    def forward(ctx, row, dtype):
        return row.to(dtype)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(torch.float32), None


class CommEngine:
    """Owns every parameter gather and gradient sync of one run."""

    def __init__(self, topo: MiCSTopology, gather_policy: GatherPolicy = GatherPolicy(),
                 sync_policy: SyncPolicy = SyncPolicy()):
        if topo.model_size != 1:
            raise NotImplementedError(
                "tensor parallelism (tp > 1) comes with the multi-chip collectives slice")
        if topo.partition_size != 1:
            raise NotImplementedError(
                f"partition size {topo.partition_size} > 1: the staged all-gather over "
                "NCCL process groups comes with the multi-chip collectives slice")
        if gather_policy.wire_dtype == "int8":
            raise NotImplementedError("the int8 gather wire comes with the int8-wire slice")
        self.topo = topo
        self.gather_policy = gather_policy
        self.sync_policy = sync_policy

    @classmethod
    def from_config(cls, topo: MiCSTopology, mcfg) -> "CommEngine":
        return cls(topo, *policies_from_config(mcfg))

    @property
    def prefetch(self) -> bool:
        return self.gather_policy.prefetch

    def gather_out_dtype(self) -> torch.dtype:
        return _WIRE_TORCH[self.gather_policy.wire_dtype]

    def gather_flat(self, row: torch.Tensor) -> torch.Tensor:
        """Gather one layer's flat shard into the full flat buffer, in the
        wire dtype.  At p = 1 this is the cast (a no-op for the fp32 wire);
        when ``row`` carries a gradient it runs as :class:`GatherFlat`."""
        if torch.is_grad_enabled() and row.requires_grad:
            return GatherFlat.apply(row, self.gather_out_dtype())
        return row.to(self.gather_out_dtype())

    def unflatten(self, pool, full: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rebuild layer tensors as views of the gathered buffer."""
        return pool.layout.unflatten(full)

    def gather(self, pool, row: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.unflatten(pool, self.gather_flat(row))

    # -- gradient synchronization ------------------------------------------
    def hop2_(self, g: torch.Tensor) -> torch.Tensor:
        """Hop 2 (§3.4): the replication-group all-reduce of ``g`` at the
        accumulation boundary, in place, as an NCCL all-reduce is.  With
        one replica it is the identity."""
        if self.topo.replication_degree != 1:
            raise NotImplementedError(
                f"replication degree {self.topo.replication_degree} > 1: hop 2 over "
                "NCCL process groups comes with the multi-chip collectives slice")
        return g

    def partition_coord(self) -> int:
        """This device's index within its partition group."""
        return 0
