"""Numeric building blocks (the port of ``repro/models/layers.py``).

Plain functions on tensors, in the JAX package's layouts.  :func:`rms_norm`
and :func:`attention` are the call sites of the port's Hopper kernels: for
a CUDA tensor they launch the kernel, for a CPU tensor they run its plain
PyTorch version (``repro_torch/kernels/*/kernel.py``).  When an input
carries a gradient they run as the kernels' autograd Functions
(``RmsNormFn``, ``FlashAttentionFn``), whose backward is a kernel too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention
from repro_torch.kernels.rmsnorm import RmsNormFn, rmsnorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Context threaded through block applications."""

    mode: str = "train"            # train | prefill | decode
    tp: int = 1
    pos: Any = None                # decode: current absolute position (int)
    cache_len: int = 0             # KV-cache capacity
    compute_dtype: torch.dtype = torch.bfloat16


def _records_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if _records_grad(x, scale):
        return RmsNormFn.apply(x, scale, eps)
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
    if _records_grad(q, k, v):
        return FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                      window, q_offset, kv_valid_len)
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
        raise NotImplementedError(
            "tensor parallelism (tp > 1) waits for ROADMAP Queue 1 item 2")
    return F.embedding(ids, table_local)


class _CrossEntropy(torch.autograd.Function):
    """The fp32 softmax cross-entropy of ``tp_cross_entropy`` at tp = 1 with
    a backward that recomputes the probabilities from the saved logits:
    one fp32 copy of the logits lives at a time, in the forward and in the
    backward, and the gradient is the reference's autodiff written out,
    ``exp(lg - m) * (w / denom)`` with ``-w`` added at the target, where
    ``w = ct / max(sum(mask), 1) * mask`` (the max carries no gradient)."""

    @staticmethod
    def forward(ctx, logits, targets, mask, vocab_real):
        e = _masked_f32(logits, vocab_real)
        m = torch.amax(e, dim=-1, keepdim=True)
        tgt = torch.gather(e, -1, targets[..., None])
        denom = torch.sum(e.sub_(m).exp_(), dim=-1, keepdim=True)
        del e
        nll = (torch.log(denom) + m - tgt)[..., 0]
        msum = torch.clamp_min(torch.sum(mask), 1.0)
        ctx.save_for_backward(logits, targets, mask, m, denom, msum)
        ctx.vocab_real = vocab_real
        return torch.sum(nll * mask) / msum

    @staticmethod
    def backward(ctx, ct):
        logits, targets, mask, m, denom, msum = ctx.saved_tensors
        w = (ct / msum * mask)[..., None]
        e = _masked_f32(logits, ctx.vocab_real)
        e.sub_(m).exp_().mul_(w / denom)
        idx = targets[..., None]
        e.scatter_(-1, idx, torch.gather(e, -1, idx) - w)
        return e.to(logits.dtype), None, None, None


def _masked_f32(logits: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """A fresh fp32 copy of the logits, padded vocab columns at NEG_INF."""
    lg = logits.to(torch.float32, copy=True)
    if lg.shape[-1] > vocab_real:
        lg[..., vocab_real:] = NEG_INF
    return lg


def tp_cross_entropy(logits_local: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                     *, vocab_real: int, vocab_padded: int, ctx: Ctx) -> torch.Tensor:
    """Softmax cross-entropy over the vocab in fp32, mean over the masked
    tokens (``repro/models/layers.py::tp_cross_entropy`` at tp = 1).
    logits [b, t, V], targets [b, t] int, mask [b, t] fp32."""
    if ctx.tp != 1:
        raise NotImplementedError(
            "tensor parallelism (tp > 1) waits for ROADMAP Queue 1 item 2")
    if logits_local.shape[-1] != vocab_padded:
        raise ValueError(f"logits have {logits_local.shape[-1]} columns, want {vocab_padded}")
    return _CrossEntropy.apply(logits_local, targets.long(), mask.float(), vocab_real)


def local_head_mask(hq: int, hq_pad: int, hq_local: int, ctx: Ctx) -> torch.Tensor:
    """1.0 for real Q heads, 0.0 for padded heads, per model rank."""
    if hq == hq_pad:
        return torch.ones(hq_local, dtype=torch.float32)
    if ctx.tp != 1:
        raise NotImplementedError(
            "tensor parallelism (tp > 1) waits for ROADMAP Queue 1 item 2")
    return (torch.arange(hq_local) < hq).float()
