"""Weight and training-state carry-over from the JAX package's flat pools
to the port's.

Both packages lay out a model as the same flat pools (``{"embed",
"layers", "head"}``, each ``[stack, tp, flat_len]`` fp32, same segment
offsets), so carrying weights over is a checked copy.  With it, the two
packages compute the same function on the same weights, and train from
the same state; :func:`shard_from_jax` cuts a JAX global state into one
rank's shards.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef


def params_from_jax(model: ModelDef, params: Mapping[str, np.ndarray], *,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """``params``: ``np.asarray`` of each pool of the JAX package's
    ``init_state(...)["params"]``.  Raises on a missing, extra or misshapen
    pool."""
    dev = resolve_device(device)
    want = model.global_flat_shapes()
    if set(params) != set(want):
        raise ValueError(f"pools {sorted(params)} != the model's {sorted(want)}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name])
        if arr.shape != shape:
            raise ValueError(f"pool {name!r}: shape {arr.shape} != {shape}")
        if arr.dtype != np.float32:
            raise ValueError(f"pool {name!r}: dtype {arr.dtype} != float32")
        out[name] = torch.from_numpy(np.array(arr, copy=True)).to(dev)
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


def shard_from_jax(model: ModelDef, topo: MiCSTopology, rank: int, state: Mapping, *,
                   device: str | torch.device = "cuda") -> dict:
    """``rank``'s port training state from a JAX global state (``params``,
    ``m``, ``v`` pool dicts of arrays and ``step``): the reference's
    ``P(None, model, partition_axes)``, the last dim cut over the partition
    group at ``topo.partition_coord(rank)``."""
    full = state_from_jax(model, state, device="cpu")
    p, coord = topo.partition_size, topo.partition_coord(rank)
    dev = resolve_device(device)
    out = {}
    for part in ("params", "m", "v"):
        out[part] = {}
        for name, t in full[part].items():
            n = t.shape[-1] // p
            out[part][name] = t[..., coord * n:(coord + 1) * n].contiguous().to(dev)
    out["step"] = full["step"]
    return out
