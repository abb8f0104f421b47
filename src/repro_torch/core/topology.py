"""MiCS topology over ranks (the port of ``repro/core/topology.py``).

The JAX package factors its device mesh into ``(pod, repl, shard, dp2,
model)`` axes.  The port keeps the axis sizes and lays the ranks out in C
order over them, the order of the reference's ``make_host_mesh`` and
``make_mics_mesh``: rank ``r``'s coordinates are ``np.unravel_index(r,
shape)``.  A partition group (default: the ``shard`` axis) is then a run of
consecutive ranks, as in the paper; a replication group (default ``(pod,
repl, dp2)``) holds the ranks with the same shard of the model states.
ZeRO-3 is the degenerate case where the partition axes are every data axis
of size > 1 and nothing is replicated.  The process groups themselves are
built by ``repro_torch.launch.mesh.MiCSGroups``.
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
DATA_AXES = tuple(a for a in MICS_AXES if a != MODEL_AXIS)

# H100 SXM device memory, for the partition-size heuristic.
HBM_BYTES_PER_CARD = 80 * 10**9
# Adam mixed precision: fp32 master + fp32 m + fp32 v + fp32 grad accumulator.
MODEL_STATE_BYTES_PER_PARAM = 16


@dataclasses.dataclass(frozen=True)
class MiCSTopology:
    """Axis sizes of a MiCS layout, and which axes partition the model
    states (``partition_axes``, slowest first: staged gathers run over them
    in that order) and which replicate them (``replication_axes``: hop 2
    runs over these)."""

    pod: int = 1
    repl: int = 1
    shard: int = 1
    dp2: int = 1
    model: int = 1
    partition_axes: tuple[str, ...] = PARTITION_AXES
    replication_axes: tuple[str, ...] = REPLICATION_AXES

    def __post_init__(self):
        for ax in MICS_AXES:
            if getattr(self, ax) < 1:
                raise ValueError(f"axis {ax!r} must be >= 1")
        for ax in self.partition_axes + self.replication_axes:
            if ax not in DATA_AXES:
                raise ValueError(f"axis {ax!r} is not a data axis of {DATA_AXES}")
        for axes in (self.partition_axes, self.replication_axes):
            # mesh order keeps every group's ranks ascending, the order in
            # which a process group ranks its members
            if list(axes) != sorted(axes, key=MICS_AXES.index):
                raise ValueError(f"axes {axes} are not in mesh order {MICS_AXES}")
        overlap = set(self.partition_axes) & set(self.replication_axes)
        if overlap:
            raise ValueError(f"axes {sorted(overlap)} both partition and replication")
        for ax in DATA_AXES:
            if (getattr(self, ax) > 1 and ax not in self.partition_axes
                    and ax not in self.replication_axes):
                raise ValueError(f"axis {ax!r} of size {getattr(self, ax)} neither "
                                 "partitions nor replicates the model states")

    # -- sizes ---------------------------------------------------------------
    def axis_size(self, name: str) -> int:
        return getattr(self, name)

    def _size(self, axes) -> int:
        return math.prod(getattr(self, a) for a in axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in MICS_AXES)

    @property
    def partition_size(self) -> int:  # p
        return self._size(self.partition_axes)

    @property
    def replication_degree(self) -> int:  # n / p
        return self._size(self.replication_axes)

    @property
    def model_size(self) -> int:
        return self.model

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Every axis that carries data parallelism (the batch is cut over these)."""
        return DATA_AXES

    @property
    def data_parallel_size(self) -> int:
        return self._size(DATA_AXES)

    @property
    def world_size(self) -> int:
        return self._size(MICS_AXES)

    # -- ranks -----------------------------------------------------------------
    def rank_coords(self, rank: int) -> dict[str, int]:
        """``rank``'s coordinate on each axis (C order over ``MICS_AXES``)."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} outside a world of {self.world_size}")
        coords = {}
        for ax in reversed(MICS_AXES):
            rank, coords[ax] = divmod(rank, getattr(self, ax))
        return {ax: coords[ax] for ax in MICS_AXES}

    def coords_rank(self, coords) -> int:
        """The inverse of :meth:`rank_coords`; a missing axis is coordinate 0."""
        rank = 0
        for ax in MICS_AXES:
            c = coords.get(ax, 0)
            if not 0 <= c < getattr(self, ax):
                raise ValueError(f"coordinate {c} outside axis {ax!r} of size "
                                 f"{getattr(self, ax)}")
            rank = rank * getattr(self, ax) + c
        return rank

    def _linear(self, rank: int, axes) -> int:
        coords = self.rank_coords(rank)
        idx = 0
        for ax in axes:
            idx = idx * getattr(self, ax) + coords[ax]
        return idx

    def partition_coord(self, rank: int) -> int:
        """``rank``'s index within its partition group: which chunk of each
        flat row it holds (the reference's ``_partition_coord``)."""
        return self._linear(rank, self.partition_axes)

    def data_rank(self, rank: int) -> int:
        """``rank``'s slice of the global batch (the reference's batch spec
        ``P(data_axes)``: the data axes in mesh order)."""
        return self._linear(rank, DATA_AXES)

    def _groups(self, axes) -> list[list[int]]:
        """Ranks that differ only on ``axes``, one list a setting of the other
        axes (in mesh order), each ordered by its linear index over ``axes``."""
        others = [a for a in MICS_AXES if a not in axes]
        out = []
        for o in range(self._size(others)):
            fixed = {}
            for ax in reversed(others):
                o, fixed[ax] = divmod(o, getattr(self, ax))
            group = []
            for i in range(self._size(axes)):
                coords = dict(fixed)
                for ax in reversed(axes):
                    i, coords[ax] = divmod(i, getattr(self, ax))
                group.append(self.coords_rank(coords))
            out.append(group)
        return out

    def partition_groups(self) -> list[list[int]]:
        """The ranks of each partition group (paper Fig 3)."""
        return self._groups(self.partition_axes)

    def replication_groups(self) -> list[list[int]]:
        """The ranks holding the same shard (the paper's replication groups)."""
        return self._groups(self.replication_axes)

    def axis_groups(self, axis: str) -> list[list[int]]:
        """The ranks that differ only on ``axis``."""
        return self._groups((axis,))


def elastic_host_topology(n_devices: int, partition_size: int, tp: int = 1, *,
                          available: int) -> MiCSTopology:
    """MiCSTopology over the first ``n_devices`` ranks of a launch world of
    ``available`` ranks (the reference's "first ``n_devices`` surviving
    devices").

    The elastic train loop's layout half (the policy half is
    ``core/autotune.resolve_world``): after a world change the survivors are
    re-factored as ``(pod=1, repl=n/(p·tp), shard=p, dp2=1, model=tp)`` —
    partition groups stay runs of consecutive ranks (the paper's rule), the
    TP degree is pinned (flat layouts are TP-local, the checkpointer's one
    resharding invariant), and everything else reshards freely on restore.
    """
    if n_devices <= 0:
        raise ValueError(f"need at least one device, got {n_devices}")
    if n_devices % (partition_size * tp):
        raise ValueError(
            f"world of {n_devices} devices does not factor as "
            f"partition_size={partition_size} x tp={tp}")
    if n_devices > available:
        raise ValueError(
            f"world of {n_devices} devices exceeds the {available} available")
    return MiCSTopology(repl=n_devices // (partition_size * tp), shard=partition_size,
                        model=tp)


def choose_partition_size(param_count: int, *, data_axis: int, model_axis: int = 1,
                          hbm_bytes: int = HBM_BYTES_PER_CARD,
                          state_bytes_per_param: int = MODEL_STATE_BYTES_PER_PARAM,
                          reserve_fraction: float = 0.35) -> int:
    """Paper §5.1.1 heuristic: the smallest partition group (a power of two
    up to ``data_axis``) whose memory holds one model-state replica, with
    ``reserve_fraction`` of each card left for activations and buffers."""
    budget = hbm_bytes * (1.0 - reserve_fraction)
    per_device_full = param_count * state_bytes_per_param / model_axis
    p = 1
    while p <= data_axis:
        if per_device_full / p <= budget:
            return p
        p *= 2
    raise ValueError(f"model with {param_count / 1e9:.1f}B params does not fit even with "
                     f"p={data_axis} (needs {per_device_full / data_axis / 1e9:.1f} GB/device)")


def default_hierarchy_inner(p: int) -> int:
    """Default intra-"node" factor: the largest power of two <= sqrt(p) that
    divides p.  The single source of the staged gather's, its adjoint's and
    :func:`hierarchy_factors`' default."""
    inner = 1
    while inner * inner <= p // 2 and p % (inner * 2) == 0:
        inner *= 2
    return inner


def hierarchy_factors(topo: MiCSTopology, inner: int | None = None) -> tuple[int, int]:
    """The partition group as ``(outer, inner)`` for staged collectives: the
    axis split itself when it spans several axes (slow axis outer), else
    ``inner`` (default :func:`default_hierarchy_inner`) within the one axis."""
    p = topo.partition_size
    if len(topo.partition_axes) > 1:
        outer = topo.axis_size(topo.partition_axes[0])
        return outer, p // outer
    if inner is None:
        inner = default_hierarchy_inner(p)
    if p % inner != 0:
        raise ValueError(f"inner factor {inner} does not divide p={p}")
    return p // inner, inner
