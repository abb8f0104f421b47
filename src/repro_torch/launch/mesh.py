"""Process groups of a MiCS run (the counterpart of ``repro/launch/mesh.py``).

    torchrun --nproc-per-node 4 -m repro_torch.launch.train ... \
        --dist-backend gloo --partition-size 4

:func:`init_distributed` joins the world that ``torchrun`` describes in
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``;
:func:`make_mics_topology` lays the world out as ``(repl, shard, model)``
(the reference's ``make_mics_topology`` over a one-pod mesh; ``model`` is
the innermost axis, so a model group is ``tp`` consecutive ranks);
:class:`MiCSGroups` builds every process group of that topology.

The backend is an argument, never a fall-back: ``nccl`` takes one card a
rank (it refuses two ranks on one card), ``gloo`` runs anywhere and carries
CUDA tensors through pinned host buffers (``core/collectives.py``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.core.collectives import Group
from repro_torch.core.topology import (
    DATA_AXES,
    MODEL_AXIS,
    REPL_AXIS,
    REPLICATION_AXES,
    SHARD_AXIS,
    MiCSTopology,
    choose_partition_size,
    default_hierarchy_inner,
)

BACKENDS = ("nccl", "gloo")
# The dry run's one rank of a production world (``launch/dryrun.py``): its
# groups hold no process group, and its collectives move no data
# (``core/collectives._run``).  The launchers refuse it.
FAKE_BACKEND = "fake"


def init_distributed(backend: str, *, timeout: datetime.timedelta,
                     init_method: str = "env://") -> tuple[int, int]:
    """Join the process group of ``RANK`` / ``WORLD_SIZE`` (and, with the
    default ``env://``, ``MASTER_ADDR`` / ``MASTER_PORT``) over ``backend``,
    with ``timeout`` on every collective; on a host with a card, select card
    ``LOCAL_RANK % device_count``.  Returns ``(rank, world_size)``.

    ``nccl`` with more ranks on this host (``LOCAL_WORLD_SIZE``) than cards
    raises before any collective."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local_world > cards:
            raise RuntimeError(
                f"backend nccl takes one card a rank: {local_world} ranks on this host, "
                f"{cards} card(s), and NCCL refuses two ranks on one card; run with "
                "--dist-backend gloo to share a card")
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    return rank, world


def make_mics_topology(world: int, partition_size: int | None = None, *, zero3: bool = False,
                       tp: int = 1, param_count: int | None = None) -> MiCSTopology:
    """``world`` ranks as ``(repl, shard = p, model = tp)``.

    ``partition_size`` defaults to the paper's heuristic (§5.1.1, from
    ``param_count``).  ``zero3=True`` is the ZeRO-3 baseline: every data
    axis of size > 1 partitions, nothing replicates."""
    if world % tp:
        raise ValueError(f"tp {tp} does not divide the world of {world}")
    data = world // tp
    if partition_size is None:
        if param_count is None:
            raise ValueError("need partition_size or param_count")
        partition_size = choose_partition_size(param_count, data_axis=data, model_axis=tp)
    if data % partition_size:
        raise ValueError(f"partition size {partition_size} does not divide the {data} "
                         "data ranks")
    repl = data // partition_size
    if zero3:
        part = tuple(a for a, n in ((REPL_AXIS, repl), (SHARD_AXIS, partition_size))
                     if n > 1) or (SHARD_AXIS,)
        return MiCSTopology(repl=repl, shard=partition_size, model=tp, partition_axes=part,
                            replication_axes=())
    return MiCSTopology(repl=repl, shard=partition_size, model=tp,
                        replication_axes=REPLICATION_AXES)


def launch_world() -> int:
    """The ranks of the launch world (1 outside ``torch.distributed``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def meet(payload):
    """One call of every live process of the launch world on the default
    group: rank 0's ``payload`` for everyone (the elastic loops' world-change
    meeting, where a parked process waits)."""
    box = [payload]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class MiCSGroups:
    """Every process group of ``topo``, seen from ``rank``.

    ``world``; ``data`` (the ranks of one model coordinate: loss means and
    the Fig-14 all-reduce); this rank's ``partition`` and ``replication``
    group; for a partition group on one axis with p = outer x inner (both
    > 1), the two stage groups of the staged gather (``outer``: the same
    local rank, strided by ``inner``; ``inner``: runs of ``inner``
    consecutive ranks; the reference's ``_stage_groups``); for a partition
    group over several axes, one group an axis (``axis[name]``).  At tp > 1,
    the ``model`` group (the ranks that differ only on the model axis, in
    model-coordinate order) and, for each g with 1 < g < tp dividing tp,
    the contiguous runs of g ranks of a model group that reassemble one KV
    head (the reference's ``axis_index_groups`` in
    ``flat_param.model_gather_fn_for``; :meth:`kv`).

    The topology lies over the first ``topo.world_size`` ranks of the launch
    world (the elastic loop's world after a preemption; all of it otherwise):
    ``world`` is a group of those ranks.  A rank of the launch world outside
    them is *parked* (:attr:`parked`): it holds no group and runs no step.
    ``new_group`` is collective over the launch world, so every live process
    creates every group, in the same order, including the groups it is not
    in, parked ones too.  :meth:`release` destroys this rank's groups when
    the world changes.

    ``backend="fake"`` lays out the same groups for one rank of a world that
    is not there (the dry run): no ``torch.distributed`` call is made, and
    every collective over them completes at once without moving data."""

    def __init__(self, topo: MiCSTopology, rank: int, *, backend: str,
                 timeout: datetime.timedelta, inner: int | None = None):
        if backend not in (*BACKENDS, FAKE_BACKEND):
            raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")
        if backend != FAKE_BACKEND and dist.get_world_size() < topo.world_size:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks, the "
                             f"topology {topo.world_size}")
        self.topo, self.rank, self.backend = topo, rank, backend
        self.parked = rank >= topo.world_size
        self.timeout = timeout
        self._handles = []
        self.world = self._mine("world", [list(range(topo.world_size))])
        self.data = self._mine("data", topo._groups(DATA_AXES))
        self.partition = self._mine("partition", topo.partition_groups())
        self.replication = self._mine("replication", topo.replication_groups())
        self.partition_coord = None if self.parked else topo.partition_coord(rank)
        self.model_coord = None if self.parked else topo.rank_coords(rank)[MODEL_AXIS]
        self.model = None
        self._kv: dict[int, Group] = {}
        tp = topo.model_size
        if tp > 1:
            models = topo.axis_groups(MODEL_AXIS)
            self.model = self._mine("model", models)
            for g in range(2, tp):
                if tp % g == 0:
                    self._kv[g] = self._mine("kv", [m[i * g:(i + 1) * g] for m in models
                                                    for i in range(tp // g)])
        p = topo.partition_size
        self.inner = None
        self.outer_group = self.inner_group = None
        self.axis: dict[str, Group] = {}
        if len(topo.partition_axes) > 1:
            for ax in topo.partition_axes:
                self.axis[ax] = self._mine(f"axis:{ax}", topo.axis_groups(ax))
        elif p > 1:
            inner = default_hierarchy_inner(p) if inner is None else inner
            if p % inner:
                raise ValueError(f"inner={inner} does not divide p={p}")
            self.inner = inner
            if 1 < inner < p:
                parts = topo.partition_groups()
                self.outer_group = self._mine(
                    "outer", [g[r::inner] for g in parts for r in range(inner)])
                self.inner_group = self._mine(
                    "inner", [g[o * inner:(o + 1) * inner] for g in parts
                              for o in range(p // inner)])

    def _mine(self, name: str, groups: list[list[int]]) -> Group | None:
        """Create one process group each of ``groups`` (on every rank of the
        launch world) and return the one holding this rank (None for a
        parked rank)."""
        mine = None
        for ranks in groups:
            if list(ranks) != sorted(ranks):
                raise ValueError(f"group {ranks} is not ascending")
            if self.backend == FAKE_BACKEND:
                if self.rank not in ranks:
                    continue
                handle = None
            else:
                handle = dist.new_group(ranks=list(ranks), timeout=self.timeout,
                                        backend=self.backend)
            if self.rank in ranks:
                mine = Group(name, tuple(ranks), handle, self.backend)
                self._handles.append(handle)
        if mine is None and not self.parked:
            raise ValueError(f"rank {self.rank} is in no {name} group")
        return mine

    def release(self) -> None:
        """Destroy the process groups this rank belongs to (a local call: the
        world changed, and the next world's groups replace them)."""
        for handle in self._handles:
            if handle is not None:
                dist.destroy_process_group(handle)
        self._handles = []

    def kv(self, g: int) -> Group:
        """The run of ``g`` consecutive ranks of this rank's model group
        (1 < g < tp) that reassembles its KV head."""
        if g not in self._kv:
            raise ValueError(f"no KV gather group of {g} ranks at tp = {self.topo.model_size}")
        return self._kv[g]

    def stage_groups(self, inner: int) -> tuple[Group, Group]:
        """``(outer, inner)`` stage groups of the single-axis staged gather
        with factor ``inner``; raises if these groups were built for another."""
        if inner != self.inner or self.outer_group is None:
            raise ValueError(f"the groups were built for inner={self.inner}, the gather "
                             f"asks for inner={inner}")
        return self.outer_group, self.inner_group
