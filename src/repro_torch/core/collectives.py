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
group's backend decides this.  A ``fake`` group (the dry run's world,
``launch/dryrun.py``) moves no data: each op completes at once and leaves
its output as it was.  Every op adds its call, its bytes (the larger of its
input and output) and its host seconds to a :class:`CommCounter` when given
one.

The model axis (Megatron tensor parallelism, the reference's ``psum`` /
``all_gather`` / ``pmax`` over ``'model'``) has its own ops at the end:
:class:`ModelAllReduce` and :class:`ModelAllGather` are autograd Functions
whose backward is the reference's transpose under ``check_vma=False`` (a
psum's is a psum, a tiled gather's a reduce-scatter over the same group),
and :func:`model_pmax` / :func:`model_pmin` carry no gradient.

The quantized collectives (ZeRO++'s qgZ on the MiCS hierarchy):
:func:`quantized_reduce_scatter` is hop 1 on an int8 wire, each stage of
the float reduce-scatter of the same topology an exchange of int8 values
and fp32 block scales (``all_to_all_single``, counted as
``all_to_all:<stage>``, the values and the scales as two calls) whose
chunks are dequantized and summed in fp32, so the error enters once a
stage and never compounds; :func:`quantized_all_reduce` is the int8 hop 2,
an exchange leg, the fp32 sum, a requantize and an all-gather leg.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import quant as Q
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
    backend: str      # 'nccl', 'gloo', or 'fake' (no data moves)

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
    place); a gloo group and a CUDA tensor go through pinned host buffers,
    and a fake group issues nothing."""
    t0 = time.perf_counter()
    finish = work = None
    if group.backend == "gloo" and inp.is_cuda:
        h_in = _pinned(inp)
        h_out = h_in if out is inp else torch.empty(out.shape, dtype=out.dtype,
                                                    pin_memory=True)
        work = op(h_out, h_in, group=group.handle, async_op=True)
        finish = lambda: out.copy_(h_out)  # noqa: E731
    elif group.backend != "fake":
        work = op(out, inp, group=group.handle, async_op=True)
    if counter is not None:
        counter.add(kind, group.name, max(out.numel(), inp.numel()) * out.element_size(),
                    time.perf_counter() - t0)
    return Work(work, finish, counter)


def _ag_op(out, inp, **kw):
    return dist.all_gather_into_tensor(out, inp, **kw)


def _rs_op(out, inp, **kw):
    return dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM, **kw)


def _a2a_op(out, inp, **kw):
    return dist.all_to_all_single(out, inp, **kw)


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


def all_to_all(x: torch.Tensor, group: Group, *, async_op: bool = False,
               counter: CommCounter | None = None) -> tuple[torch.Tensor, Work]:
    """Equal-split all-to-all of ``x``'s dim 0 over ``group`` (the
    reference's ``lax.all_to_all(x, axis, 0, 0)``): member j receives chunk
    j of every member's ``x``, stacked in member order.  Returns ``(out,
    work)``; the work is waited on unless ``async_op``."""
    x = x.contiguous()
    if x.shape[0] % group.size:
        raise ValueError(f"dim of {x.shape[0]} does not divide over {group.size} ranks")
    out = torch.empty_like(x)
    work = _run(_a2a_op, out, x, group, "all_to_all", counter)
    if not async_op:
        work.wait()
    return out, work


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
# the quantized collectives (qgZ: int8 + fp32 block scales on the wire)
# ---------------------------------------------------------------------------

def step_component(g: torch.Tensor, seed: int | None):
    """The dither key's step component: the threaded step counter when the
    caller has one, else the payload's fingerprint, the bits of its fp32
    sum as an int32 0-dim tensor on its device (the quantize kernel reads
    it, so the host never waits for it)."""
    if seed is not None:
        return seed
    return torch.sum(g, dtype=torch.float32).view(torch.int32)


def _quant_exchange_stage(g: torch.Tensor, group: Group, key, counter) -> torch.Tensor:
    """One qgZ stage over ``group`` (k members): quantize this rank's fp32
    ``[n]`` as ``[k, n / k]`` chunks, exchange values and scales (member j
    receives chunk j of every member), dequantize and sum the k chunks in
    fp32, in member order.  Returns the group-reduced chunk ``[n / k]``."""
    k = group.size
    if k == 1:
        return g
    n = g.shape[0]
    if n % k:
        raise ValueError(f"buffer length {n} does not divide over {k} ranks")
    q, s = Q.quantize_flat(g.reshape(k, n // k), key=key)
    qx, _ = all_to_all(q, group, counter=counter)
    sx, _ = all_to_all(s, group, counter=counter)
    return Q.dequantize(qx, sx, torch.float32, chunks=k)


def _quant_stage_plan(topo: MiCSTopology, groups, topology: str, inner: int | None):
    """The stage groups of the quantized hop 1, in order, and the
    ``outer_first`` pre-reorder's factors (passed to :func:`_reorder_chunks`
    as given) or None.

    COUPLED to :func:`_hier_rs_single_axis` / :func:`_hier_rs_multi_axis`
    and ``CommEngine._policy_reduce_scatter`` (``flat``: the partition
    group): the stage order, the groups and the reorder must stay in
    lockstep, or chunks reach the wrong owners.  Grid-exact data (the
    quantizer then loses nothing) holds the two to the same bits
    (``tests/test_torch_collectives.py``)."""
    if topology == "flat":
        return [groups.partition], None
    if topology not in ("inner_first", "outer_first"):
        raise ValueError(f"unknown topology {topology!r}")
    if len(topo.partition_axes) > 1:
        axes = topo.partition_axes
        if topology == "inner_first":
            return [groups.axis[a] for a in axes], None
        sizes = [topo.axis_size(a) for a in axes]
        return [groups.axis[a] for a in reversed(axes)], (sizes[0], math.prod(sizes[1:]))
    outer, inner = _factor(topo.partition_size, inner)
    if inner == 1 or outer == 1:
        return [groups.partition], None
    outer_g, inner_g = groups.stage_groups(inner)
    if topology == "inner_first":
        return [outer_g, inner_g], None
    return [inner_g, outer_g], (outer, inner)


def quantized_reduce_scatter(g: torch.Tensor, topo: MiCSTopology, groups, *,
                             topology: str = "inner_first", inner: int | None = None,
                             salt: int = 0, stochastic: bool = True, seed: int | None = None,
                             counter: CommCounter | None = None) -> torch.Tensor:
    """Hop 1 on the int8 wire: the staged reduce-scatter of ``topology`` /
    ``inner`` with every stage an int8 exchange and fp32 accumulation in
    between; fp32 ``[n / p]`` out.  Each stage's error is at most one
    quantization step of that stage's fp32 partial sums (additive, never
    compounding); with ``stochastic`` each stage is unbiased in
    expectation, its dither keyed by ``salt``, the stage, the global rank
    and ``seed`` (the training step; None: the payload's fingerprint)."""
    g = g.float()
    if topo.partition_size == 1:
        return g
    if g.dim() != 1:
        raise ValueError(f"quantized_reduce_scatter takes a flat [N] buffer, got "
                         f"{tuple(g.shape)}")
    stages, reorder = _quant_stage_plan(topo, groups, topology, inner)
    if reorder is not None:
        g = _reorder_chunks(g, 0, *reorder)
    step = step_component(g, seed) if stochastic else None
    for i, group in enumerate(stages):
        key = Q.dither_key(salt, i, groups.rank, step) if stochastic else None
        g = _quant_exchange_stage(g, group, key, counter)
    return g


def quantized_all_reduce(g: torch.Tensor, topo: MiCSTopology, groups, *, salt: int = 0,
                         stochastic: bool = True, seed: int | None = None,
                         out: torch.Tensor | None = None, async_op: bool = False,
                         counter: CommCounter | None = None):
    """Hop 2 on the int8 wire over the replication group (r replicas): the
    payload zero-padded to r chunks and quantized, an exchange leg, the
    fp32 sum of the chunks this rank owns, a requantize, an all-gather leg
    of values and scales, a dequantize to fp32 and the padding dropped.
    The blocks follow the payload, so the result depends on how a gradient
    is cut into payloads (serial and bucketed boundaries agree to
    quantization error, not bitwise).

    Writes the result into ``out`` (fresh when None) and returns it; with
    ``async_op`` returns the :class:`Work` of the exchange leg, whose
    ``wait()`` runs the sum, the second leg and the write-back (the leg's
    buffers stay referenced until then)."""
    r = topo.replication_degree
    src = g.float()
    if out is None:
        out = torch.empty_like(src)
    if r == 1:
        if out is not g:
            out.copy_(src)
        return Work(None) if async_op else out
    if src.dim() != 1:
        raise ValueError(f"quantized_all_reduce takes a flat [N] buffer, got "
                         f"{tuple(src.shape)}")
    group = groups.replication
    n = src.shape[0]
    m = -(-n // r)
    x = torch.nn.functional.pad(src, (0, r * m - n)) if r * m != n else src
    step = step_component(src, seed) if stochastic else None

    def key(stage):
        return Q.dither_key(salt, stage, groups.rank, step) if stochastic else None

    q, s = Q.quantize_flat(x.reshape(r, m), key=key(0))
    qx, q_work = all_to_all(q, group, async_op=True, counter=counter)
    sx, s_work = all_to_all(s, group, async_op=True, counter=counter)
    held = [q, s]     # the exchange leg's inputs, referenced until its wait

    def finish():
        s_work.wait()
        red = Q.dequantize(qx, sx, torch.float32, chunks=r)
        q2, s2 = Q.quantize_flat(red, key=key(1))
        qg = all_gather(q2, group, counter=counter)
        sg = all_gather(s2, group, counter=counter)
        full = Q.dequantize(qg.reshape(r, m), sg.reshape(r, -1), torch.float32)
        out.copy_(full.reshape(-1)[:n])
        held.clear()

    work = Work(q_work, finish)
    if async_op:
        return work
    work.wait()
    return out


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


def _tiled_exchange(x: torch.Tensor, group: Group, to_owners: bool,
                    counter: CommCounter | None) -> torch.Tensor:
    """The reference's two tiled ``lax.all_to_all`` of expert parallelism
    over a group of k members, built from the dim-0 :func:`all_to_all`:
    ``to_owners`` (``split_axis=0, concat_axis=1``) takes ``[E, c, d]`` to
    ``[E / k, k c, d]``, member j receiving experts ``j E / k ...`` of every
    member, stacked in member order along dim 1; the other
    (``split_axis=1, concat_axis=0``) is its inverse, ``[E / k, k c, d]``
    back to ``[E, c, d]``."""
    k = group.size
    if to_owners:
        e, c = x.shape[:2]
        out, _ = all_to_all(x, group, counter=counter)          # [k, E / k, c, d] by member
        return out.reshape(k, e // k, c, *x.shape[2:]).transpose(0, 1).reshape(
            e // k, k * c, *x.shape[2:])
    el, kc = x.shape[:2]
    parts = x.reshape(el, k, kc // k, *x.shape[2:]).transpose(0, 1)  # [k, E / k, c, d]
    out, _ = all_to_all(parts, group, counter=counter)
    return out.reshape(k * el, kc // k, *x.shape[2:])


class ModelAllToAll(torch.autograd.Function):
    """The expert exchange over a model-axis group (:func:`_tiled_exchange`);
    its backward is the reverse exchange of the cotangent (a permutation's
    transpose is its inverse)."""

    @staticmethod
    def forward(ctx, x, group, to_owners, counter):
        ctx.group, ctx.to_owners, ctx.counter = group, to_owners, counter
        return _tiled_exchange(x, group, to_owners, counter)

    @staticmethod
    def backward(ctx, ct):
        return (_tiled_exchange(ct.contiguous(), ctx.group, not ctx.to_owners, ctx.counter),
                None, None, None)


def model_all_to_all(x: torch.Tensor, group: Group, *, to_owners: bool,
                     counter: CommCounter | None = None) -> torch.Tensor:
    """:func:`_tiled_exchange` of ``x`` over ``group``; as
    :class:`ModelAllToAll` when autograd records the call."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ModelAllToAll.apply(x, group, to_owners, counter)
    return _tiled_exchange(x, group, to_owners, counter)
