"""MiCS configuration and parameter initialisation (the port of the parts of
``repro/core/mics.py`` the serve path reads).  The training step, with
optimizer state and the two-hop gradient sync, comes with the training
slice."""

from __future__ import annotations

import dataclasses
import zlib

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef


@dataclasses.dataclass(frozen=True)
class MiCSConfig:
    """The knobs the serve path reads (names and defaults as the reference).
    Those marked "default only" raise ``NotImplementedError`` when set to
    anything else, in ``CommEngine.from_config`` or ``build_serve_steps``."""

    hierarchical: bool = True           # staged gather (default only: p > 1)
    gather_order: str = "inner_first"   # (default only: p > 1)
    gather_dtype: torch.dtype = torch.bfloat16
    hierarchy_inner: int | None = None  # (default only: p > 1)
    scores_bf16: bool = False           # bf16 attention scores (default only)
    quant_gather: bool = False          # int8 wire (default only)
    prefetch: bool = True               # lookahead gathers

    def __post_init__(self):
        if self.gather_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gather_dtype must be float32 or bfloat16, "
                             f"got {self.gather_dtype}")


def init_params(model: ModelDef, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """fp32 flat pools ``{pool: [stack, tp, flat_len]}`` from ``seed``.

    The ``params`` part of the reference's ``init_state`` (no m, v, step):
    each segment is normal(0, std), zeros or ones as its layout says.  Each
    pool draws from its own ``torch.Generator`` on ``device``, seeded with
    crc32("<seed>:<pool name>") (32 bits: the CPU generator ignores higher
    bits), so pools do not depend on each other's sizes.
    The draws differ from JAX's; ``repro_torch.convert`` carries JAX weights
    over where equal values are needed.
    """
    dev = resolve_device(device)
    params = {}
    for pool in model.all_pools():
        gen = torch.Generator(device=dev)
        gen.manual_seed(zlib.crc32(f"{seed}:{pool.name}".encode()))
        rows = torch.empty((pool.stack, model.tp, pool.layout.flat_len),
                           dtype=torch.float32, device=dev)
        for i in range(pool.stack):
            for j in range(model.tp):
                rows[i, j] = pool.layout.init_flat(gen, device=dev)
        params[pool.name] = rows
    return params
