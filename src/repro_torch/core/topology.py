"""MiCS topology without a mesh (the port of ``repro/core/topology.py``).

The JAX package factors its device mesh into ``(pod, repl, shard, dp2,
model)`` axes; partition groups are the ``shard`` axis, replication groups
``(pod, repl, dp2)``.  This slice runs on one card, so the topology only
carries the axis sizes.  Process groups over NCCL come with the
multi-chip collectives slice.
"""

from __future__ import annotations

import dataclasses
import math

POD_AXIS = "pod"
REPL_AXIS = "repl"
SHARD_AXIS = "shard"
DP2_AXIS = "dp2"
MODEL_AXIS = "model"

MICS_AXES = (POD_AXIS, REPL_AXIS, SHARD_AXIS, DP2_AXIS, MODEL_AXIS)
PARTITION_AXES = (SHARD_AXIS,)
REPLICATION_AXES = (POD_AXIS, REPL_AXIS, DP2_AXIS)
DATA_AXES = PARTITION_AXES + REPLICATION_AXES


@dataclasses.dataclass(frozen=True)
class MiCSTopology:
    """Axis sizes of a MiCS layout; ``shard`` is the partition group."""

    pod: int = 1
    repl: int = 1
    shard: int = 1
    dp2: int = 1
    model: int = 1

    def __post_init__(self):
        for ax in MICS_AXES:
            if getattr(self, ax) < 1:
                raise ValueError(f"axis {ax!r} must be >= 1")

    def _size(self, axes) -> int:
        return math.prod(getattr(self, a) for a in axes)

    @property
    def partition_size(self) -> int:  # p
        return self._size(PARTITION_AXES)

    @property
    def replication_degree(self) -> int:  # n / p
        return self._size(REPLICATION_AXES)

    @property
    def model_size(self) -> int:
        return self.model

    @property
    def data_parallel_size(self) -> int:
        return self._size(DATA_AXES)
