"""Flat parameter pools: ZeRO-3 / MiCS uniform model-state partitioning
(the port of ``repro/core/flat_param.py``).

Every block's TP-local tensors are flattened and concatenated into one fp32
vector, padded so any partition-group size divides it.  Gathering a layer
is then one collective over one contiguous buffer (the paper's coalesced
communication, §4).  Segment metadata records how to rebuild the tensors.
The offsets, padding and per-segment init recipe are the JAX package's, so
the two packages agree on every pool's shape; the random draws differ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Mapping

import torch

from repro_torch.core import collectives as C

# Any partition-group size we ever use (<= 32 data-parallel participants in
# ZeRO-3 multi-pod mode) times the 128-lane alignment of the reference.
PAD_MULTIPLE = 32 * 128


@dataclasses.dataclass(frozen=True)
class Segment:
    """One logical tensor inside a flat pool (shapes are TP-local)."""

    name: str
    shape: tuple[int, ...]
    offset: int            # element offset into the flat vector
    decay: bool            # weight decay applies to this segment
    init: str              # 'normal' | 'zeros' | 'ones' | 'lru'
    std: float             # stddev for 'normal'
    model_gather: int = 1  # all-gather group size over the model axis at use
    model_gather_dim: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def end(self) -> int:
        return self.offset + self.size


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static description of a flat pool; shared by every layer in a stack."""

    segments: tuple[Segment, ...]
    raw_len: int
    flat_len: int

    @staticmethod
    def build(segments: Iterable[Segment]) -> "FlatLayout":
        segs = tuple(segments)
        raw = segs[-1].end if segs else 0
        flat = ((raw + PAD_MULTIPLE - 1) // PAD_MULTIPLE) * PAD_MULTIPLE
        flat = max(flat, PAD_MULTIPLE)
        return FlatLayout(segs, raw, flat)

    def seg(self, name: str) -> Segment:
        for s in self.segments:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def param_count(self) -> int:
        return self.raw_len

    def unflatten(self, flat: torch.Tensor, *,
                  model_gather_fn: Callable | None = None) -> dict[str, torch.Tensor]:
        """Rebuild tensors from a gathered flat vector, as views of it (no
        copy).  ``model_gather_fn(segment, tensor)`` reassembles the
        segments stored sharded over the model axis (``model_gather`` > 1;
        none at tp = 1: leave it None).  When ``flat`` carries a gradient
        the views come from :class:`Unflatten`, whose backward writes each
        segment's cotangent into one buffer."""
        if torch.is_grad_enabled() and flat.requires_grad:
            views = Unflatten.apply(flat, self)
        else:
            views = tuple(flat[s.offset:s.end].view(s.shape) for s in self.segments)
        out = {}
        for s, t in zip(self.segments, views):
            if s.model_gather > 1 and model_gather_fn is not None:
                t = model_gather_fn(s, t)
            out[s.name] = t
        return out

    # -- masks ----------------------------------------------------------------
    def nodecay_ranges(self) -> list[tuple[int, int]]:
        rng = [(s.offset, s.end) for s in self.segments if not s.decay]
        rng.append((self.raw_len, self.flat_len))  # padding never decays
        return rng

    def decay_mask_for_shard(self, shard_start: int, shard_len: int, *,
                             device=None) -> torch.Tensor:
        """fp32 decay mask of the shard ``[shard_start, shard_start +
        shard_len)``: 0 on segments without weight decay and on the
        padding, 1 elsewhere."""
        mask = torch.ones(shard_len, dtype=torch.float32, device=device)
        for lo, hi in self.nodecay_ranges():
            lo, hi = max(lo - shard_start, 0), min(hi - shard_start, shard_len)
            if lo < hi:
                mask[lo:hi] = 0.0
        return mask

    def padding_mask_for_shard(self, shard_start: int, shard_len: int, *,
                               device=None) -> torch.Tensor:
        """1.0 for real parameters, 0.0 for the padded tail."""
        gidx = shard_start + torch.arange(shard_len, device=device)
        return (gidx < self.raw_len).float()

    def flatten(self, tensors: Mapping[str, torch.Tensor],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        parts = []
        cursor = 0
        for s in self.segments:
            if s.offset != cursor:
                raise ValueError("segments are not contiguous")
            parts.append(tensors[s.name].reshape(-1).to(dtype))
            cursor = s.end
        device = parts[0].device if parts else None
        pad = self.flat_len - self.raw_len
        if pad:
            parts.append(torch.zeros(pad, dtype=dtype, device=device))
        return torch.cat(parts) if parts else torch.zeros(
            self.flat_len, dtype=dtype)

    def init_flat(self, gen: torch.Generator, *, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Full flat vector init: per-segment normal(0, std), zeros, ones or
        the RG-LRU ``lru`` init, written straight into one buffer.  ``gen``
        must live on ``device``."""
        out = torch.zeros(self.flat_len, dtype=dtype, device=device)
        for s in self.segments:
            view = out[s.offset:s.end]
            if s.init == "normal":
                view.normal_(0.0, s.std, generator=gen)
            elif s.init == "ones":
                view.fill_(1.0)
            elif s.init == "lru":
                # RG-LRU Λ such that the per-channel decay a = sigmoid(Λ) is
                # uniform in [0.9, 0.999] (Griffin appendix initialization).
                view.uniform_(0.9, 0.999, generator=gen)
                view.copy_(torch.log(view) - torch.log1p(-view))
            elif s.init != "zeros":
                raise ValueError(f"unknown init {s.init!r}")
        return out


class Unflatten(torch.autograd.Function):
    """A layout's segments as views of a gathered flat buffer, with the
    transpose of that slicing as the backward: every segment's cotangent is
    written into one zero buffer of the flat dtype (the padding stays 0).
    Autograd through plain views would instead build a full-size zero
    gradient for each segment and sum them."""

    @staticmethod
    def forward(ctx, flat, layout):
        ctx.layout, ctx.dtype, ctx.device = layout, flat.dtype, flat.device
        ctx.set_materialize_grads(False)
        return tuple(flat[s.offset:s.end].view(s.shape) for s in layout.segments)

    @staticmethod
    def backward(ctx, *cts):
        layout = ctx.layout
        buf = torch.zeros(layout.flat_len, dtype=ctx.dtype, device=ctx.device)
        for seg, ct in zip(layout.segments, cts):
            if ct is not None:
                buf[seg.offset:seg.end] = ct.reshape(-1)
        return buf, None


# ---------------------------------------------------------------------------
# fixed-byte bucketization (the boundary scheduler's unit)
# ---------------------------------------------------------------------------

def bucket_elems(bucket_mb: float, itemsize: int = 4) -> int:
    """Elements per fixed-byte bucket (>= 1 even for degenerate sizes)."""
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be > 0, got {bucket_mb}")
    return max(1, int(bucket_mb * 1e6) // itemsize)


def partition_buckets(n_elems: int, bucket_mb: float,
                      itemsize: int = 4) -> tuple[tuple[int, int], ...]:
    """``[0, n_elems)`` as contiguous ``(lo, hi)`` buckets of at most
    ``bucket_mb`` megabytes each, in order, every element once."""
    if n_elems <= 0:
        return ()
    per = bucket_elems(bucket_mb, itemsize)
    return tuple((lo, min(lo + per, n_elems)) for lo in range(0, n_elems, per))


class LayoutBuilder:
    """Accumulates segments with automatic offsets."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._segments: list[Segment] = []
        self._cursor = 0

    def add(
        self,
        name: str,
        shape: tuple[int, ...],
        *,
        decay: bool = True,
        init: str = "normal",
        std: float | None = None,
        model_gather: int = 1,
        model_gather_dim: int = 0,
    ) -> None:
        if std is None:
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            std = 1.0 / math.sqrt(max(fan_in, 1))
        seg = Segment(
            name=self.prefix + name,
            shape=tuple(int(d) for d in shape),
            offset=self._cursor,
            decay=decay,
            init=init,
            std=float(std),
            model_gather=int(model_gather),
            model_gather_dim=int(model_gather_dim),
        )
        self._segments.append(seg)
        self._cursor += seg.size

    def extend(self, other: "LayoutBuilder") -> None:
        """Inline another builder's segments (namespaced) after ours."""
        for s in other._segments:
            self._segments.append(dataclasses.replace(s, offset=self._cursor))
            self._cursor += s.size

    def build(self) -> FlatLayout:
        return FlatLayout.build(self._segments)


# ---------------------------------------------------------------------------
# model-axis gathering of sharded small segments
# ---------------------------------------------------------------------------

def model_gather_fn_for(groups, counter=None) -> Callable:
    """The ``model_gather_fn`` of :meth:`FlatLayout.unflatten` over the
    model axis of ``groups`` (a ``launch.mesh.MiCSGroups`` at tp > 1): a
    segment with ``model_gather`` g is gathered along its
    ``model_gather_dim`` over the whole model group when g = tp (norm
    scales), else over the run of g ranks sharing one KV head (the
    reference's ``axis_index_groups``).  The backward is the reduce-scatter
    over the same group, so these parameters need no gradient fix-up."""
    tp = groups.topo.model_size

    def fn(seg: Segment, t: torch.Tensor) -> torch.Tensor:
        g = seg.model_gather
        group = groups.model if g == tp else groups.kv(g)
        return C.model_all_gather(t, group, axis=seg.model_gather_dim, counter=counter)

    return fn
