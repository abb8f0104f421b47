"""Numeric building blocks (the port of ``repro/models/layers.py``).

Plain functions on tensors, in the JAX package's layouts.  :func:`rms_norm`
and :func:`attention` are the call sites of the port's Hopper kernels: for
a CUDA tensor they launch the kernel, for a CPU tensor they run its plain
PyTorch version (``repro_torch/kernels/*/kernel.py``).  When an input
carries a gradient they run as the kernels' autograd Functions
(``RmsNormFn``, ``FlashAttentionFn``), whose backward is a kernel too.

At tp > 1 (Megatron tensor parallelism) activations are full ``d_model``
on every model rank: the embedding table is stored ``[vocab, d/tp]`` and
gathered, row-parallel outputs are summed (:func:`tp_psum`) and the loss
is vocab-parallel (:func:`tp_cross_entropy`), each collective through the
``CommEngine`` that ``Ctx.comm`` carries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention
from repro_torch.kernels.flash_attention import paged_attention  # noqa: F401 (a call site)
from repro_torch.kernels.rmsnorm import RmsNormFn, rmsnorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Context threaded through block applications."""

    mode: str = "train"            # train | prefill | decode
    tp: int = 1
    pos: Any = None                # decode: absolute position (int), or [b] per request
    pages: Any = None              # decode over a paged KV pool: runtime/paged.PageState
    cache_len: int = 0             # KV-cache capacity
    compute_dtype: torch.dtype = torch.bfloat16
    comm: Any = None               # the CommEngine of the model axis (tp > 1)
    step_seed: int | None = None   # the training step: the int8 wires' dither seed

    def tp_index(self) -> int:
        """This rank's coordinate on the model axis."""
        return 0 if self.tp == 1 else self.comm.model_coord()


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
    kv_valid_len: Any = None,        # decode: valid cache entries, an int or a [b] / [b, tq] tensor
) -> torch.Tensor:
    """Scaled-dot-product GQA attention -> [b, tq, hkv, g, dh].  Per-row
    valid lengths (a tensor ``kv_valid_len``: the ragged rows of continuous
    batching) take the flash kernel's ``paged`` route."""
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
    """table_local: [vocab, d/tp] (d sharded over model) -> [b, t, d] full."""
    emb_local = F.embedding(ids, table_local)
    if ctx.tp == 1:
        return emb_local
    return ctx.comm.model_all_gather(emb_local, axis=-1)


def tp_psum(x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The sum of a row-parallel output over the model group."""
    return x if ctx.tp == 1 else ctx.comm.model_psum(x)


class _CrossEntropy(torch.autograd.Function):
    """The vocab-parallel fp32 softmax cross-entropy of
    ``tp_cross_entropy`` with a backward that recomputes the probabilities
    from the saved local logits: one fp32 copy of them lives at a time, in
    the forward and in the backward.  The forward takes the reference's
    collectives over the model group (``comm``, None at tp = 1): the pmax
    of the stabiliser and the psums of ``denom`` and of the target's logit.
    The backward is the reference's autodiff written out, ``exp(lg - m) *
    (w / denom)`` with ``-w`` added at the target on the rank whose columns
    hold it, where ``w = ct / max(sum(mask), 1) * mask`` summed over the
    model group: the transposes of the two psums (the max carries no
    gradient)."""

    @staticmethod
    def forward(ctx, logits, targets, mask, vocab_real, start, comm):
        e = _masked_f32(logits, vocab_real, start)
        vl = e.shape[-1]
        m = torch.amax(e, dim=-1, keepdim=True)
        tl = targets[..., None] - start
        in_range = (tl >= 0) & (tl < vl)
        tgt = torch.where(in_range, torch.gather(e, -1, tl.clamp(0, vl - 1)), 0.0)
        if comm is not None:
            m = comm.model_pmax(m)
        denom = torch.sum(e.sub_(m).exp_(), dim=-1, keepdim=True)
        del e
        if comm is not None:
            denom, tgt = comm.model_psum(denom), comm.model_psum(tgt)
        nll = (torch.log(denom) + m - tgt)[..., 0]
        msum = torch.clamp_min(torch.sum(mask), 1.0)
        ctx.save_for_backward(logits, tl, in_range, mask, m, denom, msum)
        ctx.vocab_real, ctx.start, ctx.comm = vocab_real, start, comm
        return torch.sum(nll * mask) / msum

    @staticmethod
    def backward(ctx, ct):
        logits, tl, in_range, mask, m, denom, msum = ctx.saved_tensors
        w = (ct / msum * mask)[..., None]
        if ctx.comm is not None:
            w = ctx.comm.model_psum(w)
        e = _masked_f32(logits, ctx.vocab_real, ctx.start)
        e.sub_(m).exp_().mul_(w / denom)
        idx = tl.clamp(0, e.shape[-1] - 1)
        e.scatter_(-1, idx, torch.gather(e, -1, idx) - w * in_range)
        return e.to(logits.dtype), None, None, None, None, None


def _masked_f32(logits: torch.Tensor, vocab_real: int, start: int = 0) -> torch.Tensor:
    """A fresh fp32 copy of the local logits (global columns ``start ...``),
    the padded vocab columns (global column >= ``vocab_real``) at NEG_INF."""
    lg = logits.to(torch.float32, copy=True)
    real = vocab_real - start
    if lg.shape[-1] > real:
        lg[..., max(real, 0):] = NEG_INF
    return lg


def tp_cross_entropy(logits_local: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                     *, vocab_real: int, vocab_padded: int, ctx: Ctx) -> torch.Tensor:
    """Vocab-parallel (Megatron-style) softmax cross-entropy in fp32, mean
    over the masked tokens (``repro/models/layers.py::tp_cross_entropy``).
    logits [b, t, V/tp] (this rank's columns ``tp_index * V/tp ...``),
    targets [b, t] int (global vocab ids), mask [b, t] fp32."""
    if logits_local.shape[-1] * ctx.tp != vocab_padded:
        raise ValueError(f"logits have {logits_local.shape[-1]} columns a rank over tp = "
                         f"{ctx.tp}, want {vocab_padded} in all")
    start = ctx.tp_index() * logits_local.shape[-1]
    return _CrossEntropy.apply(logits_local, targets.long(), mask.float(), vocab_real, start,
                               None if ctx.tp == 1 else ctx.comm)


def local_head_mask(hq: int, hq_pad: int, hq_local: int, ctx: Ctx) -> torch.Tensor:
    """1.0 for real Q heads, 0.0 for padded heads, per model rank."""
    if hq == hq_pad:
        return torch.ones(hq_local, dtype=torch.float32)
    base = ctx.tp_index() * hq_local
    return ((base + torch.arange(hq_local)) < hq).float()
