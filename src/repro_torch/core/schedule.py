"""Boundary scheduler: the gradient-accumulation boundary as a plan and two
schedules (the port of ``repro/core/schedule.py``, exact clip).

The boundary of one training step is ``hop-2 all-reduce -> global-norm
clip -> AdamW`` (paper §3.4: the cross-replica sync runs once per
accumulation boundary).  :func:`plan_boundary` cuts each pool's flat
gradient into fixed-byte buckets in one canonical order (pools in
``model.all_pools()`` order, offsets ascending).  The ``serial`` schedule
runs hop 2 on whole pools, then the norm; the ``bucketed`` one issues
bucket k's hop 2 asynchronously, then waits on bucket k-1's and takes its
squared-norm partial, so that the collective overlaps the compute.  Every
rank issues every bucket, in the plan's order.  Hop 2 is elementwise, so a
bucket of the reduced buffer is the reduction of the bucket (bitwise for
two replicas, whose sum does not depend on order).

Both schedules fold the squared-norm partials in the plan's order, each
the sum of a freshly written square of a contiguous tensor of the bucket's
length, then sum the fold over the partition group in one fp32
all-reduce, so they are bitwise equal at every bucket size; the denominator
(``micro_steps * data_parallel``) and the clip factor are folded into one
``grad_scale`` of the AdamW update.  The approximate clip and the
host-offloaded optimizer states are refused (``core/mics.py``).  The
update writes params, m and v in place, a slice of a stack row at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flat_param import partition_buckets
from repro_torch.core.topology import MiCSTopology
from repro_torch.optim.adamw import OptConfig, adamw_shard_update, lr_schedule

BOUNDARY_SCHEDULES = ("serial", "bucketed")
CLIP_MODES = ("exact", "approx")

# fp32 gradient accumulator bytes per element: what a bucket's byte budget
# is measured in.
GRAD_ITEMSIZE = 4


@dataclasses.dataclass(frozen=True)
class BucketRef:
    """One bucket: a static ``[lo, hi)`` slice of ``pool``'s flattened local
    gradient shard."""

    pool: str
    lo: int
    hi: int

    @property
    def elems(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class BoundaryPlan:
    """Static schedule of one gradient-accumulation boundary."""

    mode: str                          # 'serial' | 'bucketed'
    bucket_mb: float
    shard_elems: dict                  # pool -> local grad elements
    buckets: tuple                     # BucketRef, canonical order
    clip_mode: str = "exact"

    def __post_init__(self):
        if self.mode not in BOUNDARY_SCHEDULES:
            raise ValueError(f"unknown boundary schedule {self.mode!r} "
                             f"(expected one of {BOUNDARY_SCHEDULES})")
        if self.clip_mode not in CLIP_MODES:
            raise ValueError(f"unknown clip_mode {self.clip_mode!r} "
                             f"(expected one of {CLIP_MODES})")
        if self.clip_mode != "exact":
            raise NotImplementedError(
                "clip_mode='approx' (the one-bucket-stale clip pipeline) waits for "
                "ROADMAP Queue 1 item 3, the training knobs that run on one card; the "
                "port runs the exact clip")

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def describe(self) -> dict:
        per_pool: dict[str, int] = {}
        for b in self.buckets:
            per_pool[b.pool] = per_pool.get(b.pool, 0) + 1
        return {"mode": self.mode, "clip_mode": self.clip_mode,
                "bucket_mb": self.bucket_mb, "n_buckets": self.n_buckets,
                "n_hop2_collectives": (len(self.shard_elems) if self.mode == "serial"
                                       else self.n_buckets),
                "buckets_per_pool": per_pool,
                "max_bucket_bytes": max((b.elems * GRAD_ITEMSIZE for b in self.buckets),
                                        default=0)}


def plan_boundary(model, topo: MiCSTopology, *, mode: str, bucket_mb: float,
                  clip_mode: str = "exact") -> BoundaryPlan:
    """Bucketize every pool's local gradient shard into fixed-byte buckets.
    The serial schedule uses the plan only to order the squared-norm
    partials, so it stays bitwise comparable to the bucketed one."""
    p = topo.partition_size
    shard_elems, buckets = {}, []
    for pool in model.all_pools():
        stack, _tp, flat_len = model.global_flat_shapes()[pool.name]
        n = stack * (flat_len // p)
        shard_elems[pool.name] = n
        for lo, hi in partition_buckets(n, bucket_mb, GRAD_ITEMSIZE):
            buckets.append(BucketRef(pool.name, lo, hi))
    return BoundaryPlan(mode=mode, bucket_mb=float(bucket_mb), shard_elems=shard_elems,
                        buckets=tuple(buckets), clip_mode=clip_mode)


def _sq(bucket: torch.Tensor) -> torch.Tensor:
    """One bucket's squared-norm partial (fp32), summed over a fresh
    contiguous square so its order depends only on the bucket's length."""
    return torch.sum(torch.square(bucket))


def _reduce_serial(plan: BoundaryPlan, comm, flat_grads: dict):
    """Reference: whole-pool hop 2 first, then per-bucket norm partials."""
    for g in flat_grads.values():
        comm.hop2_(g)
    return [_sq(flat_grads[b.pool][b.lo:b.hi]) for b in plan.buckets]


def _reduce_bucketed(plan: BoundaryPlan, comm, flat_grads: dict):
    """Software pipeline: issue bucket k's hop 2, then wait on bucket k-1's
    and take its squared-norm partial; the drain takes the last bucket."""
    sq_parts, pending = [], None
    for ref in plan.buckets:
        bucket = flat_grads[ref.pool][ref.lo:ref.hi]
        work = comm.hop2_(bucket, async_op=True)
        if pending is not None:
            pending[0].wait()
            sq_parts.append(_sq(pending[1]))
        pending = (work, bucket)
    if pending is not None:
        pending[0].wait()
        sq_parts.append(_sq(pending[1]))
    return sq_parts


# Elements of a row that one AdamW update takes at a time.  Its elementwise
# passes hold about ten fp32 temporaries of the slice (2.7 GB at 2^26)
# rather than of the whole row (26 GB for recurrentgemma-2b's 655M-element
# embedding or head row), and, being elementwise, give bitwise the result
# of a whole-row update.
UPDATE_SLICE = 1 << 26


def _slice_masks(layout, lo: int, n: int, one: torch.Tensor):
    """``(decay_mask, pad_mask)`` of a row's elements ``[lo, lo + n)``,
    each the 0-d ``one`` where its mask would hold only ones (the same
    product, bitwise), so a slice that no no-decay segment and no padding
    reaches builds no mask."""
    hi, device = lo + n, one.device
    decays = all(max(s, lo) >= min(e, hi) for s, e in layout.nodecay_ranges())
    dm = one if decays else layout.decay_mask_for_shard(lo, n, device=device)
    pm = one if hi <= layout.raw_len else layout.padding_mask_for_shard(lo, n, device=device)
    return dm, pm


def apply_boundary(plan: BoundaryPlan, comm, model, topo: MiCSTopology, oc: OptConfig,
                   state: dict, grads: dict, denom: float):
    """Run one accumulation boundary under ``plan``: hop 2 on ``grads``
    (per-pool fp32 accumulated sums ``[stack, 1, shard_len]``, reduced in
    place), the exact global-norm clip, then AdamW with ``clip / denom``
    folded into the gradient, written into ``state``'s params, m and v in
    place, ``UPDATE_SLICE`` elements of a row at a time.  Returns
    ``(params, m, v, grad_norm)``."""
    flat_grads = {name: grads[name].reshape(-1) for name in plan.shard_elems}
    if plan.mode == "bucketed":
        sq_parts = _reduce_bucketed(plan, comm, flat_grads)
    else:
        sq_parts = _reduce_serial(plan, comm, flat_grads)

    device = next(iter(grads.values())).device
    sq = torch.zeros((), dtype=torch.float32, device=device)
    for part in sq_parts:               # fixed left fold, canonical order
        sq = sq + part
    sq = comm.norm_all_reduce_(sq)      # the psum over the partition group
    gnorm = torch.sqrt(sq) / denom
    clip = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    grad_scale = clip / denom

    step = state["step"]
    lr = lr_schedule(step, oc, device=device)
    start = comm.partition_coord()
    params, m, v = state["params"], state["m"], state["v"]
    one = torch.ones((), dtype=torch.float32, device=device)
    for pool in model.all_pools():
        name = pool.name
        g = grads[name]
        shard_len = g.shape[-1]
        for lo in range(0, shard_len, UPDATE_SLICE):
            n = min(UPDATE_SLICE, shard_len - lo)
            dm, pm = _slice_masks(pool.layout, start * shard_len + lo, n, one)
            for i in range(g.shape[0]):
                part = (i, 0, slice(lo, lo + n))
                p_new, m_new, v_new = adamw_shard_update(
                    params[name][part], g[part], m[name][part], v[name][part], step, oc,
                    decay_mask=dm, pad_mask=pm, lr=lr, grad_scale=grad_scale)
                params[name][part].copy_(p_new)
                m[name][part].copy_(m_new)
                v[name][part].copy_(v_new)
    return params, m, v, gnorm
