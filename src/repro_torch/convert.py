"""Weight and training-state carry-over from the JAX package's flat pools
to the port's.

Both packages lay out a model as the same flat pools (``{"embed",
"layers", "head"}``, each ``[stack, tp, flat_len]`` fp32, same segment
offsets), so carrying weights over is a checked copy.  With it, the two
packages compute the same function on the same weights, and train from
the same state; :func:`shard_from_jax` cuts a JAX global state into one
rank's shards (:func:`shard_params` a rank's serving weights, fp32 or
stored int8), and :func:`tp_params_from_full` cuts a tp = 1 model into
the tp shards of the same function.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.topology import MODEL_AXIS, MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef


def _carry(name: str, arr, shape: tuple, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.shape != shape:
        raise ValueError(f"pool {name!r}: shape {arr.shape} != {shape}")
    if arr.dtype != dtype:
        raise ValueError(f"pool {name!r}: dtype {arr.dtype} != {np.dtype(dtype).name}")
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(model: ModelDef, params: Mapping, *,
                    device: str | torch.device = "cuda") -> dict:
    """``params``: ``np.asarray`` of each pool of the JAX package's
    ``init_state(...)["params"]`` (fp32 ``[stack, tp, S]``), or of its
    ``quant.quantize_state`` of them (``{'q': int8 [stack, tp, S], 's':
    fp32 [stack, tp, ceil(S / 128)]}`` a pool: the same stored bytes for
    both packages' int8 serving).  Raises on a missing, extra or misshapen
    pool."""
    dev = resolve_device(device)
    want = model.global_flat_shapes()
    if set(params) != set(want):
        raise ValueError(f"pools {sorted(params)} != the model's {sorted(want)}")
    out = {}
    for name, shape in want.items():
        pool = params[name]
        if isinstance(pool, Mapping):
            if set(pool) != {"q", "s"}:
                raise ValueError(f"pool {name!r}: a stored int8 pool has 'q' and 's', got "
                                 f"{sorted(pool)}")
            nb = -(-shape[-1] // 128)
            out[name] = {"q": _carry(f"{name}.q", pool["q"], shape, np.int8).to(dev),
                         "s": _carry(f"{name}.s", pool["s"], (*shape[:-1], nb),
                                     np.float32).to(dev)}
        else:
            out[name] = _carry(name, pool, shape, np.float32).to(dev)
    return out


def state_from_jax(model: ModelDef, state: Mapping, *,
                   device: str | torch.device = "cuda") -> dict:
    """A JAX ``init_state`` (or a mid-run state): ``params``, ``m`` and ``v``
    pool dicts of arrays and ``step``, as the port's training state
    (``repro_torch.core.mics.init_state``'s layout; ``step`` an int)."""
    out = {part: params_from_jax(model, {k: np.asarray(v) for k, v in state[part].items()},
                                 device=device)
           for part in ("params", "m", "v")}
    out["step"] = int(np.asarray(state["step"]))
    return out


def _shard(t: torch.Tensor, topo: MiCSTopology, rank: int, dev) -> torch.Tensor:
    """``rank``'s piece of a global ``[stack, tp, n]`` pool leaf: its model
    coordinate's row, chunk ``topo.partition_coord(rank)`` of its ``n / p``
    (a fresh tensor)."""
    p, coord = topo.partition_size, topo.partition_coord(rank)
    m = topo.rank_coords(rank)[MODEL_AXIS]
    n = t.shape[-1] // p
    piece = t[:, m:m + 1, coord * n:(coord + 1) * n]
    return piece.clone(memory_format=torch.contiguous_format).to(dev)


def shard_params(model: ModelDef, topo: MiCSTopology, rank: int, params: Mapping, *,
                 device: str | torch.device = "cuda") -> dict:
    """``rank``'s serving shards of global pools: fp32 ``[stack, tp,
    flat_len]`` tensors, or stored int8 ones (``{'q': int8 [stack, tp,
    flat_len], 's': fp32 [stack, tp, flat_len / 128]}``, the quantizer's
    blocks of 128 values), each leaf cut as :func:`shard_state` cuts a pool.
    Every flat length is a multiple of 128 p (``PAD_MULTIPLE``), so a
    rank's scales are those of its own values' blocks: the shard of a
    stored pool is ``quant.quantize_state`` of the rank's fp32 shard."""
    dev = resolve_device(device)
    out = {}
    for name, pool in params.items():
        if isinstance(pool, Mapping):
            out[name] = {k: _shard(torch.as_tensor(v), topo, rank, dev) for k, v in pool.items()}
        else:
            out[name] = _shard(torch.as_tensor(pool), topo, rank, dev)
    return out


def shard_state(model: ModelDef, topo: MiCSTopology, rank: int, state: Mapping, *,
                device: str | torch.device = "cuda") -> dict:
    """``rank``'s training state from a global one (``params``, ``m``, ``v``
    pool dicts of ``[stack, tp, flat_len]`` tensors and ``step``): the
    reference's ``P(None, model, partition_axes)``, each pool cut to the
    rank's model coordinate and to its chunk ``topo.partition_coord(rank)``
    of the partition group, as fresh tensors (the step updates them in
    place)."""
    out = {part: shard_params(model, topo, rank, state[part], device=device)
           for part in ("params", "m", "v")}
    out["step"] = int(state["step"])
    return out


def shard_from_jax(model: ModelDef, topo: MiCSTopology, rank: int, state: Mapping, *,
                   device: str | torch.device = "cuda") -> dict:
    """``rank``'s port training state from a JAX global state (``params``,
    ``m``, ``v`` pool dicts of arrays and ``step``): :func:`shard_state` of
    :func:`state_from_jax`."""
    return shard_state(model, topo, rank, state_from_jax(model, state, device="cpu"),
                       device=device)


def _sharded_dim(seg_tp, seg_1) -> int | None:
    """The one dim along which a segment is cut over the model axis (None
    where the two layouts store it whole)."""
    diff = [i for i, (a, b) in enumerate(zip(seg_tp.shape, seg_1.shape)) if a != b]
    if len(seg_tp.shape) != len(seg_1.shape) or len(diff) > 1:
        raise ValueError(f"segment {seg_tp.name}: shapes {seg_tp.shape} at tp and "
                         f"{seg_1.shape} at tp 1 differ in more than one dim")
    return diff[0] if diff else None


def tp_params_from_full(model_tp: ModelDef, model_1: ModelDef, params_1: Mapping) -> dict:
    """A tp = 1 model's pools cut into ``model_tp``'s tp shards: the same
    function, stored as the tensor-parallel layers store it.

    ``params_1``: some or all of ``model_1``'s pools, ``[stack, 1, flat_len]``
    fp32 (tensors, or numpy arrays for a numpy result).  Returns the same
    pools as ``[stack, tp, flat_len_tp]``.  Each segment is cut along the
    one dim its tp layout shards: the columns of a column-parallel weight
    (``wq``, ``wk`` / ``wv`` and their biases, ``wg`` / ``wu``, ``rec.wx`` /
    ``rec.wy``, the head), the rows of a row-parallel one (``wo``, ``wd``,
    ``rec.wo``), the channels of the RG-LRU's per-channel weights, the
    ``model_gather_dim`` of the gathered segments (norm scales and
    LayerNorm biases, ``bo``, ``b2``; the KV projections of ranks that
    share a head take its consecutive slices) and the ``d`` of the
    embedding tables (enc-dec's learned positions too).  Rank m takes slice m.  Where tp pads
    a dim (Q heads to a multiple of tp, KV heads, the vocab), the padding
    is zeros: a padded Q head's ``wq`` columns and ``wo`` rows are 0, and
    its output is masked anyway.  Segments pair by position in the two
    layouts (a name may repeat).  A checking aid, with no counterpart in
    the JAX package: it lets a tp > 1 run be held to a tp = 1 run on the
    same weights."""
    tp = model_tp.tp
    out = {}
    for name, full in params_1.items():
        as_numpy = isinstance(full, np.ndarray)
        full = torch.as_tensor(full)
        pool_tp, pool_1 = model_tp.pool(name), model_1.pool(name)
        stack = pool_tp.stack
        if tuple(full.shape) != (stack, 1, pool_1.layout.flat_len):
            raise ValueError(f"pool {name!r}: shape {tuple(full.shape)} != "
                             f"{(stack, 1, pool_1.layout.flat_len)}")
        rows = torch.zeros((stack, tp, pool_tp.layout.flat_len), dtype=full.dtype,
                           device=full.device)
        # by position: a name may repeat (the sLSTM's ``s.wo``, ROADMAP Queue 3)
        for seg, s1 in zip(pool_tp.layout.segments, pool_1.layout.segments, strict=True):
            if seg.name != s1.name:
                raise ValueError(f"pool {name!r}: segment {seg.name!r} at tp, {s1.name!r} at tp 1")
            whole = full[:, 0, s1.offset:s1.end].reshape(stack, *s1.shape)
            dim = _sharded_dim(seg, s1)
            for j in range(tp):
                if dim is None:
                    piece = whole
                else:
                    n = seg.shape[dim]
                    piece = whole.narrow(dim + 1, min(j * n, s1.shape[dim]),
                                         max(0, min(n, s1.shape[dim] - j * n)))
                dst = rows[:, j, seg.offset:seg.end].view(stack, *seg.shape)
                dst[tuple(slice(0, k) for k in (stack, *piece.shape[1:]))] = piece
        out[name] = rows.numpy() if as_numpy else rows
    return out
