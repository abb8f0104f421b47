"""Numeric building blocks (the port of ``repro/models/layers.py``).

Plain functions on tensors, in the JAX package's layouts.  :func:`rms_norm`
and :func:`attention` are the call sites of the port's Hopper kernels: for
a CUDA tensor they launch the kernel, for a CPU tensor they run its plain
PyTorch version (``repro_torch/kernels/*/kernel.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Context threaded through block applications."""

    mode: str = "train"            # train | prefill | decode
    tp: int = 1
    pos: Any = None                # decode: current absolute position (int)
    cache_len: int = 0             # KV-cache capacity
    compute_dtype: torch.dtype = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, scale, eps)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [b, t, h, dh]; positions: [b, t] absolute token positions."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs              # [b, t, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(
    q: torch.Tensor,                 # [b, tq, hkv, g, dh]
    k: torch.Tensor,                 # [b, tk, hkv, dh]
    v: torch.Tensor,                 # [b, tk, hkv, dh]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,               # absolute position of q[:, 0]
    kv_valid_len: int | None = None,  # decode: number of valid cache entries
) -> torch.Tensor:
    """Scaled-dot-product GQA attention -> [b, tq, hkv, g, dh]."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_valid_len=kv_valid_len)


def mlp_swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


def mlp_geglu(x, wg, wu, wd):
    h = F.gelu(x @ wg, approximate="tanh") * (x @ wu)
    return h @ wd


def embed_lookup(table_local: torch.Tensor, ids: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """table_local: [vocab, d/tp] -> [b, t, d] (tp = 1 only in this slice)."""
    if ctx.tp != 1:
        raise NotImplementedError("tensor parallelism comes with the multi-chip slice")
    return F.embedding(ids, table_local)


def local_head_mask(hq: int, hq_pad: int, hq_local: int, ctx: Ctx) -> torch.Tensor:
    """1.0 for real Q heads, 0.0 for padded heads, per model rank."""
    if hq == hq_pad:
        return torch.ones(hq_local, dtype=torch.float32)
    if ctx.tp != 1:
        raise NotImplementedError("tensor parallelism comes with the multi-chip slice")
    return (torch.arange(hq_local) < hq).float()
