"""Boundary scheduler: the gradient-accumulation boundary as a plan and two
schedules (the port of ``repro/core/schedule.py``).

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
``grad_scale`` of the AdamW update.  The update writes params, m and v in
place, a slice of a stack row at a time.

**The approximate clip** (``clip_mode="approx"``, bucketed only) takes the
exact clip's last barrier off the boundary: bucket k's AdamW runs while
bucket k+1's hop 2 is in flight, with the clip factor of the running
squared norm through bucket k-1 (one bucket stale); the drain folds the
last partial first, so the last bucket sees the whole norm.  The running
norm is a prefix of the whole, so each bucket is at most under-clipped;
the reported ``grad_norm`` is the exact path's fold and one all-reduce,
bitwise the exact ``grad_norm``.  When the clip does not bind every prefix
factor is exactly 1.0 and the update runs the exact path's elementwise
operations (eager PyTorch fuses nothing), so the whole trajectory is
bitwise the exact clip's; the reference holds that only to the last ulp of
the params, since XLA fuses the two programs differently.

**The compressed hop-2 wires.**  Under ``bf16`` a bucket's cast is the
cast's bucket, so both schedules stay bitwise equal.  Under ``int8`` each
payload is block-quantized (``collectives.quantized_all_reduce``), its
blocks following the payload, so the serial and bucketed schedules agree
to quantization error, not bitwise; each payload's dither is salted by
its place (the pool index under ``serial``, the plan-order bucket index
under ``bucketed``: offsets repeat across pools) and seeded by the step.
The async int8 hop 2's ``wait()`` runs its sum, its second leg and the
write-back, so the one-bucket-ahead issue stays.

**Host-resident moments** (``offload_opt=True``): m and v are pinned host
tensors of the state; each slice's pair is fetched to the card one slice
ahead on the stash's copy stream, updated, and written back there
(``core/hostoffload.py``).  The values are the in-HBM path's, bitwise.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.flat_param import partition_buckets
from repro_torch.core.topology import MiCSTopology
from repro_torch.optim.adamw import OptConfig, adamw_shard_update, lr_schedule

BOUNDARY_SCHEDULES = ("serial", "bucketed")
CLIP_MODES = ("exact", "approx")

# The approximate clip's bound on a short run's final loss, relative to the
# exact clip's (the reference's ``APPROX_CLIP_LOSS_RTOL``).
APPROX_CLIP_LOSS_RTOL = 0.05

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
        if self.clip_mode == "approx" and self.mode != "bucketed":
            raise ValueError("clip_mode='approx' requires the bucketed schedule (the "
                             "approximate clip is a property of the bucket pipeline)")

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def hop2_payload_elems(self) -> list:
        """Element counts of the hop-2 collectives this plan issues, in
        order: one whole-pool payload a pool under ``serial``, one a bucket
        under ``bucketed`` (what ``autotune.cost_hop2_schedule`` costs)."""
        if self.mode == "serial":
            return list(self.shard_elems.values())   # all_pools() order
        return [b.elems for b in self.buckets]

    def describe(self) -> dict:
        per_pool: dict[str, int] = {}
        for b in self.buckets:
            per_pool[b.pool] = per_pool.get(b.pool, 0) + 1
        return {"mode": self.mode, "clip_mode": self.clip_mode,
                "bucket_mb": self.bucket_mb, "n_buckets": self.n_buckets,
                "n_hop2_collectives": len(self.hop2_payload_elems()),
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


def _reduce_serial(plan: BoundaryPlan, comm, flat_grads: dict, seed=None):
    """Reference: whole-pool hop 2 first (salt: the pool index), then
    per-bucket norm partials."""
    for i, g in enumerate(flat_grads.values()):
        comm.hop2_(g, salt=i, seed=seed)
    return [_sq(flat_grads[b.pool][b.lo:b.hi]) for b in plan.buckets]


def _reduce_bucketed(plan: BoundaryPlan, comm, flat_grads: dict, seed=None):
    """Software pipeline: issue bucket k's hop 2 (salt: k), then wait on
    bucket k-1's and take its squared-norm partial; the drain takes the
    last bucket."""
    sq_parts, pending = [], None
    for i, ref in enumerate(plan.buckets):
        bucket = flat_grads[ref.pool][ref.lo:ref.hi]
        work = comm.hop2_(bucket, async_op=True, salt=i, seed=seed)
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


def _exact_parts(model, grads: dict) -> list:
    """The exact path's update order: ``(pool, row, lo, n)`` for each pool,
    each ``UPDATE_SLICE`` of a row's shard and each row."""
    parts = []
    for pool in model.all_pools():
        stack, _, shard_len = grads[pool.name].shape
        for lo in range(0, shard_len, UPDATE_SLICE):
            n = min(UPDATE_SLICE, shard_len - lo)
            parts.extend((pool, i, lo, n) for i in range(stack))
    return parts


def _bucket_parts(pool, ref: BucketRef, shard_len: int) -> list:
    """Bucket ``ref`` of the flattened ``[stack x shard]`` pool cut at the
    rows' edges and into ``UPDATE_SLICE`` pieces: ``(pool, row, lo, n)``."""
    parts, pos = [], ref.lo
    while pos < ref.hi:
        i, lo = divmod(pos, shard_len)
        n = min(UPDATE_SLICE, shard_len - lo, ref.hi - pos)
        parts.append((pool, i, lo, n))
        pos += n
    return parts


def _moments(state: dict, parts: list, stash, device: torch.device):
    """``(m, v, store)`` of each part in ``parts``' order: views of the
    state's moments, or, with ``stash`` (the moments in host memory), device
    copies fetched one part ahead on the copy stream and written back by
    ``store(m_new, v_new)``."""
    m, v = state["m"], state["v"]

    def views(k):
        pool, i, lo, n = parts[k]
        sl = (i, 0, slice(lo, lo + n))
        return m[pool.name][sl], v[pool.name][sl]

    if stash is None:
        for k in range(len(parts)):
            mk, vk = views(k)
            yield mk, vk, lambda mn, vn, mk=mk, vk=vk: (mk.copy_(mn), vk.copy_(vn))
        return
    fetch = lambda k: [stash.fetch(h, device) for h in views(k)]  # noqa: E731
    ahead = fetch(0) if parts else None
    for k in range(len(parts)):
        (md, m_ev), (vd, v_ev) = ahead
        ahead = fetch(k + 1) if k + 1 < len(parts) else None
        stash.ready(m_ev, device)
        stash.ready(v_ev, device)
        mk, vk = views(k)
        yield md, vd, lambda mn, vn, mk=mk, vk=vk: (stash.write_back(mk, mn),
                                                      stash.write_back(vk, vn))


class _AdamW:
    """AdamW on the boundary's parts, in the order of the ``parts`` it is
    built with: each call updates one ``(pool, row, lo, n)`` slice of the
    params in place and its m and v in place or through the host."""

    def __init__(self, comm, oc: OptConfig, state: dict, grads: dict, parts: list, stash):
        device = next(iter(grads.values())).device
        self.oc, self.grads, self.params, self.step = oc, grads, state["params"], state["step"]
        self.lr = lr_schedule(self.step, oc, device=device)
        self.start = comm.partition_coord()
        self.one = torch.ones((), dtype=torch.float32, device=device)
        self.moments = _moments(state, parts, stash, device)
        self._masks = (None, None)   # the last slice's masks: rows share them

    def __call__(self, part, grad_scale: torch.Tensor) -> None:
        pool, i, lo, n = part
        name = pool.name
        key = (name, lo, n)
        if self._masks[0] != key:
            shard_len = self.grads[name].shape[-1]
            self._masks = (key, _slice_masks(pool.layout, self.start * shard_len + lo, n,
                                             self.one))
        dm, pm = self._masks[1]
        sl = (i, 0, slice(lo, lo + n))
        m_in, v_in, store = next(self.moments)
        p_new, m_new, v_new = adamw_shard_update(
            self.params[name][sl], self.grads[name][sl], m_in, v_in, self.step, self.oc,
            decay_mask=dm, pad_mask=pm, lr=self.lr, grad_scale=grad_scale)
        self.params[name][sl].copy_(p_new)
        store(m_new, v_new)


def _clip(sq: torch.Tensor, denom: float, oc: OptConfig):
    """``(grad_norm, grad_scale)`` of a squared norm: the global-norm clip
    factor and the mean's denominator in one factor."""
    gnorm = torch.sqrt(sq) / denom
    clip = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return gnorm, clip / denom


def _boundary_approx(plan: BoundaryPlan, comm, flat_grads: dict, bucket_parts: list,
                     denom: float, oc: OptConfig, update: _AdamW, seed=None) -> torch.Tensor:
    """The approximate clip's pipeline (module docstring).  Per bucket i:
    issue its hop 2, wait on bucket i-1's, run bucket i-1's AdamW with the
    clip factor of the running squared norm through bucket i-2, then fold
    bucket i-1's partial (summed over the partition group) into it.  The
    drain folds the last partial before the last update.  ``bucket_parts``:
    each bucket's update parts (:func:`_bucket_parts`).  Returns the exact
    path's ``grad_norm``."""
    device = next(iter(flat_grads.values())).device
    running = torch.zeros((), dtype=torch.float32, device=device)
    sq_local = torch.zeros((), dtype=torch.float32, device=device)

    def fold(bucket):
        nonlocal running, sq_local
        part = _sq(bucket)
        running = running + comm.norm_all_reduce_(part.clone())
        sq_local = sq_local + part

    def step(parts):
        _, grad_scale = _clip(running, denom, oc)
        for part in parts:
            update(part, grad_scale)

    pending = None
    for i, (ref, parts) in enumerate(zip(plan.buckets, bucket_parts)):
        bucket = flat_grads[ref.pool][ref.lo:ref.hi]
        work = comm.hop2_(bucket, async_op=True, salt=i, seed=seed)
        if pending is not None:
            pending[0].wait()
            step(pending[1])            # stale: the norm through the bucket before
            fold(pending[2])
        pending = (work, parts, bucket)
    if pending is not None:
        pending[0].wait()
        fold(pending[2])                # the whole norm for the last bucket
        step(pending[1])
    return torch.sqrt(comm.norm_all_reduce_(sq_local)) / denom


def apply_boundary(plan: BoundaryPlan, comm, model, topo: MiCSTopology, oc: OptConfig,
                   state: dict, grads: dict, denom: float, *, offload_opt: bool = False,
                   seed: int | None = None):
    """Run one accumulation boundary under ``plan``: hop 2 on ``grads``
    (per-pool fp32 accumulated sums ``[stack, 1, shard_len]``, reduced in
    place), the global-norm clip (exact, or the approximate pipeline), then
    AdamW with ``clip / denom`` folded into the gradient, written into
    ``state``'s params, m and v in place, ``UPDATE_SLICE`` elements of a row
    at a time.  With ``offload_opt`` the state's m and v are host tensors,
    streamed through ``comm.host_stash``.  ``seed`` (the step) keys the
    int8 hop-2 wire's dither.  Returns ``(params, m, v, grad_norm)``."""
    flat_grads = {name: grads[name].reshape(-1) for name in plan.shard_elems}
    device = next(iter(grads.values())).device
    stash = comm.host_stash if offload_opt else None
    if plan.clip_mode == "approx":
        pools = {p.name: p for p in model.all_pools()}
        bucket_parts = [_bucket_parts(pools[ref.pool], ref, grads[ref.pool].shape[-1])
                        for ref in plan.buckets]
        parts = [part for bp in bucket_parts for part in bp]
        update = _AdamW(comm, oc, state, grads, parts, stash)
        gnorm = _boundary_approx(plan, comm, flat_grads, bucket_parts, denom, oc, update,
                                 seed)
    else:
        if plan.mode == "bucketed":
            sq_parts = _reduce_bucketed(plan, comm, flat_grads, seed)
        else:
            sq_parts = _reduce_serial(plan, comm, flat_grads, seed)
        sq = torch.zeros((), dtype=torch.float32, device=device)
        for part in sq_parts:               # fixed left fold, canonical order
            sq = sq + part
        sq = comm.norm_all_reduce_(sq)      # the psum over the partition group
        gnorm, grad_scale = _clip(sq, denom, oc)
        parts = _exact_parts(model, grads)
        update = _AdamW(comm, oc, state, grads, parts, stash)
        for part in parts:
            update(part, grad_scale)
    if stash is not None:
        stash.join(device)
    return state["params"], state["m"], state["v"], gnorm
