"""CommEngine: the single construction point for every parameter gather
(the port of the serving part of ``repro/core/comm.py``).

MiCS gathers each layer's flat shard across its partition group of size p
before the layer runs (ZeRO-3-style serving).  On one card p = 1 and
tp = 1, so the gather moves nothing between devices: it is the cast of the
fp32 row to the wire dtype, exactly what ``repro/core/comm.py`` does when
``partition_size == 1``.  p > 1 (NCCL process groups for the staged
all-gather) and the int8 wire raise ``NotImplementedError``: they come with
the multi-chip collectives slice and the int8-wire slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.topology import MiCSTopology

WIRE_DTYPES = ("fp32", "bf16", "int8")

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


def policies_from_config(mcfg) -> GatherPolicy:
    """Interpret a ``MiCSConfig``'s flags as a GatherPolicy (the reference
    also returns a SyncPolicy; gradient sync comes with the training
    slice).  A staged-gather setting other than the default raises rather
    than run the default program under another name."""
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
    return GatherPolicy(wire_dtype=wire, prefetch=mcfg.prefetch)


class CommEngine:
    """Owns every parameter gather of one run."""

    def __init__(self, topo: MiCSTopology, gather_policy: GatherPolicy = GatherPolicy()):
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

    @classmethod
    def from_config(cls, topo: MiCSTopology, mcfg) -> "CommEngine":
        return cls(topo, policies_from_config(mcfg))

    @property
    def prefetch(self) -> bool:
        return self.gather_policy.prefetch

    def gather_out_dtype(self) -> torch.dtype:
        return _WIRE_TORCH[self.gather_policy.wire_dtype]

    def gather_flat(self, row: torch.Tensor) -> torch.Tensor:
        """Gather one layer's flat shard into the full flat buffer, in the
        wire dtype.  At p = 1 this is the cast (a no-op for the fp32 wire)."""
        return row.to(self.gather_out_dtype())

    def unflatten(self, pool, full: torch.Tensor) -> dict[str, torch.Tensor]:
        """Rebuild layer tensors as views of the gathered buffer."""
        return pool.layout.unflatten(full)

    def gather(self, pool, row: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.unflatten(pool, self.gather_flat(row))
