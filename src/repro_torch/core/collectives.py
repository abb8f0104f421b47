"""MiCS collectives over process groups: the flat and staged all-gather, the
staged reduce-scatter (its exact adjoint) and the gradient syncs (the port
of ``repro/core/collectives.py``'s float collectives).

The reference's mesh axes and ``axis_index_groups`` become
``torch.distributed`` groups (:class:`Group`, built by
``repro_torch.launch.mesh.MiCSGroups``).  The paper's three-stage gather
(§3.3) over a partition group p = outer x inner:

* ``outer_first`` (paper-faithful): all-gather over the outer groups (same
  local rank, strided by ``inner``), then over the inner groups (runs of
  ``inner`` consecutive ranks), then the chunk reorder;
* ``inner_first``: inner groups first, so each rank holds a contiguous
  block and the outer gather needs no reorder.

The adjoint runs the stages in reverse, each gather a reduce-scatter over
the same groups and the reorder its inverse.  Every gather is tiled along
dim ``axis`` (``all_gather_into_tensor``), every reduce-scatter a sum
(``reduce_scatter_tensor``).

A gloo group cannot take a CUDA tensor, so for a gloo group and a CUDA
tensor each op runs through pinned host buffers: copy to the host, run the
gloo op, copy back (:func:`_run`, the one code path of every op).  The
group's backend decides this.  Every op adds its call, its bytes (the
larger of its input and output) and its host seconds to a
:class:`CommCounter` when given one.

The model axis (Megatron tensor parallelism, the reference's ``psum`` /
``all_gather`` / ``pmax`` over ``'model'``) has its own ops at the end:
:class:`ModelAllReduce` and :class:`ModelAllGather` are autograd Functions
whose backward is the reference's transpose under ``check_vma=False`` (a
psum's is a psum, a tiled gather's a reduce-scatter over the same group),
and :func:`model_pmax` / :func:`model_pmin` carry no gradient.

The quantized collectives (``quantized_reduce_scatter``,
``quantized_all_reduce``) wait for ROADMAP Queue 1 item 4, the int8 and
bf16 wires.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.topology import MiCSTopology, default_hierarchy_inner


@dataclasses.dataclass(frozen=True)
class Group:
    """One process group: ``name`` labels its stage in the counter
    (``partition``, ``outer``, ``inner``, ``axis:<axis>``, ``replication``,
    ``data``, ``world``); ``ranks`` are its members' global ranks,
    ascending, in the order of their place in the group."""

    name: str
    ranks: tuple[int, ...]
    handle: Any
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


class CommCounter:
    """Calls and bytes by ``"<kind>:<stage>"`` (the port's census of its
    collectives) and the host seconds spent issuing and waiting on them."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.seconds = 0.0

    def add(self, kind: str, stage: str, nbytes: int, seconds: float) -> None:
        key = f"{kind}:{stage}"
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)
        self.seconds += seconds

    def snapshot(self) -> dict:
        return {"calls": dict(sorted(self.calls.items())),
                "bytes": dict(sorted(self.bytes.items())), "seconds": self.seconds}


class Work:
    """The handle of an issued op: :meth:`wait` finishes it (for a
    host-staged op, the copy back to the card) and counts its wait."""

    def __init__(self, work, finish=None, counter: CommCounter | None = None):
        self._work, self._finish, self._counter = work, finish, counter

    def wait(self) -> None:
        t0 = time.perf_counter()
        if self._work is not None:
            self._work.wait()
            if self._finish is not None:
                self._finish()
            self._work = None
        if self._counter is not None:
            self._counter.seconds += time.perf_counter() - t0


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _run(op, out: torch.Tensor, inp: torch.Tensor, group: Group, kind: str,
         counter: CommCounter | None) -> Work:
    """Issue ``op(out, inp)`` over ``group`` (``out is inp`` for an op in
    place); a gloo group and a CUDA tensor go through pinned host buffers."""
    t0 = time.perf_counter()
    finish = None
    if group.backend == "gloo" and inp.is_cuda:
        h_in = _pinned(inp)
        h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype,
                                                    pin_memory=True)
        work = op(h_out, h_in, group=group.handle, async_op=True)
        finish = lambda: out.copy_(h_out)  # noqa: E731
    else:
        work = op(out, inp, group=group.handle, async_op=True)
    if counter is not None:
        counter.add(kind, group.name, max(out.numel(), inp.numel()) * out.element_size(),
                    time.perf_counter() - t0)
    return Work(work, finish, counter)


def _ag_op(out, inp, **kw):
    return dist.all_gather_into_tensor(out, inp, **kw)


def _rs_op(out, inp, **kw):
    return dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, **kw)


def _ar_op(out, inp, **kw):
    return dist.all_reduce(out, op=dist.ReduceOp.SUM, **kw)


def _max_op(out, inp, **kw):
    return dist.all_reduce(out, op=dist.ReduceOp.MAX, **kw)


def _min_op(out, inp, **kw):
    return dist.all_reduce(out, op=dist.ReduceOp.MIN, **kw)


def all_gather(x: torch.Tensor, group: Group, *, axis: int = 0,
               counter: CommCounter | None = None) -> torch.Tensor:
    """Tiled all-gather of ``x`` along ``axis`` over ``group``, in group order."""
    x = x.movedim(axis, 0).contiguous()
    out = x.new_empty((group.size * x.shape[0], *x.shape[1:]))
    _run(_ag_op, out, x, group, "all_gather", counter).wait()
    return out.movedim(0, axis)


def reduce_scatter(g: torch.Tensor, group: Group, *, axis: int = 0,
                   counter: CommCounter | None = None) -> torch.Tensor:
    """Tiled sum-reduce-scatter of ``g`` along ``axis`` over ``group``:
    member i keeps chunk i of the sum."""
    g = g.movedim(axis, 0).contiguous()
    if g.shape[0] % group.size:
        raise ValueError(f"dim of {g.shape[0]} does not divide over {group.size} ranks")
    out = g.new_empty((g.shape[0] // group.size, *g.shape[1:]))
    _run(_rs_op, out, g, group, "reduce_scatter", counter).wait()
    return out.movedim(0, axis)


_REDUCE_OPS = {"sum": (_ar_op, "all_reduce"), "max": (_max_op, "all_reduce_max"),
               "min": (_min_op, "all_reduce_min")}


def all_reduce_(x: torch.Tensor, group: Group, *, async_op: bool = False,
                counter: CommCounter | None = None, op: str = "sum") -> Work | torch.Tensor:
    """All-reduce of the contiguous ``x`` over ``group`` in place, a sum (or
    ``op`` ``max`` / ``min``, counted as ``all_reduce_max`` /
    ``all_reduce_min``).  Returns ``x``, or with ``async_op`` the
    :class:`Work` to wait on."""
    if not x.is_contiguous():
        raise ValueError("all_reduce_ runs in place on a contiguous tensor")
    fn, kind = _REDUCE_OPS[op]
    work = _run(fn, x, x, group, kind, counter)
    if async_op:
        return work
    work.wait()
    return x


# ---------------------------------------------------------------------------
# all-gather
# ---------------------------------------------------------------------------

def flat_all_gather(x: torch.Tensor, group: Group, *, axis: int = 0,
                    counter: CommCounter | None = None) -> torch.Tensor:
    """The single-collective all-gather over the whole partition group."""
    return all_gather(x, group, axis=axis, counter=counter)


def hierarchical_all_gather(x: torch.Tensor, topo: MiCSTopology, groups, *, axis: int = 0,
                            order: str = "inner_first", inner: int | None = None,
                            counter: CommCounter | None = None) -> torch.Tensor:
    """All-gather this rank's shard ``x`` (1/p of the buffer along ``axis``)
    over its partition group in stages; equal to :func:`flat_all_gather`."""
    p = topo.partition_size
    if p == 1:
        return x
    if len(topo.partition_axes) > 1:
        return _hierarchical_multi_axis(x, topo, groups, axis=axis, order=order,
                                        counter=counter)
    return _hierarchical_single_axis(x, groups, p, axis=axis, order=order, inner=inner,
                                     counter=counter)


def _factor(p: int, inner: int | None) -> tuple[int, int]:
    if inner is None:
        inner = default_hierarchy_inner(p)
    if p % inner != 0:
        raise ValueError(f"inner={inner} does not divide p={p}")
    return p // inner, inner


def _hierarchical_single_axis(x, groups, p: int, *, axis: int, order: str,
                              inner: int | None, counter) -> torch.Tensor:
    outer, inner = _factor(p, inner)
    if inner == 1 or outer == 1:
        return all_gather(x, groups.partition, axis=axis, counter=counter)
    outer_g, inner_g = groups.stage_groups(inner)
    if order == "outer_first":
        # paper-faithful: stage 1 over the outer (slow) groups, stage 2 over
        # the inner (fast) ones, stage 3 the reorder
        g1 = all_gather(x, outer_g, axis=axis, counter=counter)
        g2 = all_gather(g1, inner_g, axis=axis, counter=counter)
        # g2's chunks run (local rank r, node o); rank i = o * inner + r owns
        # chunk i, so the canonical order is (o, r)
        return _reorder_chunks(g2, axis, inner, outer)
    if order == "inner_first":
        g1 = all_gather(x, inner_g, axis=axis, counter=counter)
        return all_gather(g1, outer_g, axis=axis, counter=counter)
    raise ValueError(f"unknown order {order!r}")


def _hierarchical_multi_axis(x, topo: MiCSTopology, groups, *, axis: int, order: str,
                             counter) -> torch.Tensor:
    """The partition group spans several axes (e.g. ``(pod, shard)``); chunk
    ownership is major on the first (slowest) axis."""
    axes = topo.partition_axes
    if order == "inner_first":
        out = x
        for name in reversed(axes):  # fast axes first: contiguous blocks
            out = all_gather(out, groups.axis[name], axis=axis, counter=counter)
        return out
    if order == "outer_first":
        out = x
        for name in axes:  # slow axes first, then the reorder
            out = all_gather(out, groups.axis[name], axis=axis, counter=counter)
        sizes = [topo.axis_size(a) for a in axes]
        return _reorder_chunks(out, axis, math.prod(sizes[1:]), sizes[0])
    raise ValueError(f"unknown order {order!r}")


def _reorder_chunks(buf: torch.Tensor, axis: int, inner: int, outer: int) -> torch.Tensor:
    """Paper stage 2: chunks ``[r, o]`` -> ``[o, r]`` along ``axis``."""
    shape = tuple(buf.shape)
    n = shape[axis]
    chunk = n // (inner * outer)
    resh = buf.reshape(shape[:axis] + (inner, outer, chunk) + shape[axis + 1:])
    return resh.transpose(axis, axis + 1).reshape(shape)


# ---------------------------------------------------------------------------
# reduce-scatter (the exact adjoint of the staged gather)
# ---------------------------------------------------------------------------

def hierarchical_reduce_scatter(g: torch.Tensor, topo: MiCSTopology, groups, *,
                                axis: int = 0, order: str = "inner_first",
                                inner: int | None = None,
                                counter: CommCounter | None = None) -> torch.Tensor:
    """Reduce-scatter ``g`` over the partition group in stages: the linear
    transpose of :func:`hierarchical_all_gather` with the same ``order`` and
    ``inner`` (stages reversed, each gather a reduce-scatter over the same
    groups, the reorder inverted), in ``g``'s own dtype."""
    p = topo.partition_size
    if p == 1:
        return g
    if len(topo.partition_axes) > 1:
        return _hier_rs_multi_axis(g, topo, groups, axis=axis, order=order, counter=counter)
    return _hier_rs_single_axis(g, groups, p, axis=axis, order=order, inner=inner,
                                counter=counter)


def _hier_rs_single_axis(g, groups, p: int, *, axis: int, order: str, inner: int | None,
                         counter) -> torch.Tensor:
    outer, inner = _factor(p, inner)
    if inner == 1 or outer == 1:
        return reduce_scatter(g, groups.partition, axis=axis, counter=counter)
    outer_g, inner_g = groups.stage_groups(inner)
    if order == "outer_first":
        # forward: AG(outer) -> AG(inner) -> reorder [r, o] -> [o, r]
        # adjoint: reorder [o, r] -> [r, o] -> RS(inner) -> RS(outer)
        g = _reorder_chunks(g, axis, outer, inner)
        g = reduce_scatter(g, inner_g, axis=axis, counter=counter)
        return reduce_scatter(g, outer_g, axis=axis, counter=counter)
    if order == "inner_first":
        # forward: AG(inner) -> AG(outer); adjoint: RS(outer) -> RS(inner)
        g = reduce_scatter(g, outer_g, axis=axis, counter=counter)
        return reduce_scatter(g, inner_g, axis=axis, counter=counter)
    raise ValueError(f"unknown order {order!r}")


def _hier_rs_multi_axis(g, topo: MiCSTopology, groups, *, axis: int, order: str,
                        counter) -> torch.Tensor:
    axes = topo.partition_axes
    if order == "inner_first":
        # the forward gathered fast -> slow, so the adjoint scatters slow -> fast
        out = g
        for name in axes:
            out = reduce_scatter(out, groups.axis[name], axis=axis, counter=counter)
        return out
    if order == "outer_first":
        sizes = [topo.axis_size(a) for a in axes]
        out = _reorder_chunks(g, axis, sizes[0], math.prod(sizes[1:]))  # the inverse
        for name in reversed(axes):
            out = reduce_scatter(out, groups.axis[name], axis=axis, counter=counter)
        return out
    raise ValueError(f"unknown order {order!r}")


# ---------------------------------------------------------------------------
# the partition-group gather front end and the gradient syncs (§3.4)
# ---------------------------------------------------------------------------

def partition_all_gather(x: torch.Tensor, topo: MiCSTopology, groups, *, axis: int = 0,
                         hierarchical: bool = True, order: str = "inner_first",
                         inner: int | None = None,
                         counter: CommCounter | None = None) -> torch.Tensor:
    """Gather a model-state shard across its partition group (§3.2): one
    call a layer on its flat buffer, the coalesced communication of §4."""
    if topo.partition_size == 1:
        return x
    if hierarchical:
        return hierarchical_all_gather(x, topo, groups, axis=axis, order=order, inner=inner,
                                       counter=counter)
    return flat_all_gather(x, groups.partition, axis=axis, counter=counter)


def hop1_reduce_scatter(g: torch.Tensor, topo: MiCSTopology, groups, *, axis: int = 0,
                        counter: CommCounter | None = None) -> torch.Tensor:
    """Hop 1 as one reduce-scatter over the whole partition group."""
    if topo.partition_size == 1:
        return g
    return reduce_scatter(g, groups.partition, axis=axis, counter=counter)


def hop2_all_reduce(g: torch.Tensor, topo: MiCSTopology, groups, *, async_op: bool = False,
                    counter: CommCounter | None = None) -> Work | torch.Tensor:
    """Hop 2: the replication-group all-reduce of the contiguous ``g`` in
    place, once per accumulation boundary.  Returns ``g``, or with
    ``async_op`` the :class:`Work` to wait on; with one replica nothing is
    issued."""
    if topo.replication_degree == 1:
        return Work(None) if async_op else g
    return all_reduce_(g, groups.replication, async_op=async_op, counter=counter)


def alternative_sync(g_full: torch.Tensor, topo: MiCSTopology, groups, *, axis: int = 0,
                     counter: CommCounter | None = None) -> torch.Tensor:
    """The Fig-14 ablation (DeepSpeed's default): all-reduce the full
    gradient over every data rank each micro-step, then keep this rank's
    chunk.  Strictly redundant."""
    summed = all_reduce_(g_full.contiguous().clone(), groups.data, counter=counter) \
        if topo.data_parallel_size > 1 else g_full
    p = topo.partition_size
    if p == 1:
        return summed
    size = summed.shape[axis] // p
    return summed.narrow(axis, groups.partition_coord * size, size)


def replica_mean(x: torch.Tensor, topo: MiCSTopology, groups,
                 counter: CommCounter | None = None) -> torch.Tensor:
    """The mean of ``x`` over every data rank (the loss metrics)."""
    dp = topo.data_parallel_size
    if dp == 1:
        return x
    return all_reduce_(x.contiguous().clone(), groups.data, counter=counter) / dp


# ---------------------------------------------------------------------------
# the model axis (tensor parallelism)
# ---------------------------------------------------------------------------

class ModelAllReduce(torch.autograd.Function):
    """``psum`` over a model-axis group; its backward is a psum of the
    cotangent over the same group (the reference's transpose)."""

    @staticmethod
    def forward(ctx, x, group, counter):
        ctx.group, ctx.counter = group, counter
        return all_reduce_(x.contiguous().clone(), group, counter=counter)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_(ct.contiguous().clone(), ctx.group, counter=ctx.counter), None, None


class ModelAllGather(torch.autograd.Function):
    """Tiled all-gather along ``axis`` over a model-axis group (the whole
    group, or a sub-group of ranks sharing one KV head), contiguous; its
    backward is the tiled sum-reduce-scatter of the cotangent over the same
    group."""

    @staticmethod
    def forward(ctx, x, group, axis, counter):
        ctx.group, ctx.axis, ctx.counter = group, axis, counter
        return all_gather(x, group, axis=axis, counter=counter).contiguous()

    @staticmethod
    def backward(ctx, ct):
        g = reduce_scatter(ct, ctx.group, axis=ctx.axis, counter=ctx.counter)
        return g.contiguous(), None, None, None


def model_all_reduce(x: torch.Tensor, group: Group, *,
                     counter: CommCounter | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``group``; as :class:`ModelAllReduce` when
    autograd records the call."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ModelAllReduce.apply(x, group, counter)
    return all_reduce_(x.contiguous().clone(), group, counter=counter)


def model_all_gather(x: torch.Tensor, group: Group, *, axis: int,
                     counter: CommCounter | None = None) -> torch.Tensor:
    """Tiled all-gather of ``x`` along ``axis`` over ``group``, contiguous
    (the kernels take contiguous inputs); as :class:`ModelAllGather` when
    autograd records the call."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ModelAllGather.apply(x, group, axis, counter)
    return all_gather(x, group, axis=axis, counter=counter).contiguous()


def model_pmax(x: torch.Tensor, group: Group, *,
               counter: CommCounter | None = None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, without a gradient."""
    return all_reduce_(x.detach().contiguous().clone(), group, counter=counter, op="max")


def model_pmin(x: torch.Tensor, group: Group, *,
               counter: CommCounter | None = None) -> torch.Tensor:
    """The elementwise min of ``x`` over ``group``, without a gradient."""
    return all_reduce_(x.detach().contiguous().clone(), group, counter=counter, op="min")
