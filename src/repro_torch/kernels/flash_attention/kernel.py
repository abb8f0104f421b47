"""Flash attention: the Hopper kernel's wrapper and its plain PyTorch
version, in the model layer's GQA layout.

The CUDA kernel is ``kernels/csrc/flash_attention.cu`` (see the note there:
which TPU kernel it replaces, what bounds it, what the design does about
it).  :func:`flash_attention` launches it for CUDA tensors and uses
:func:`attention_plain` for CPU tensors; there is no other route and no
fall-back when a build or launch fails.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build as K

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)

# Launches of the CUDA kernel since the last reset (plain integer).
launches = 0


def mask_bias(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
              kv_valid_len: int | None, device) -> torch.Tensor:
    """[tq, tk] additive fp32 mask (0 allowed, NEG_INF blocked), as
    ``repro/models/layers.py::_mask_bias``."""
    q_pos = q_offset + torch.arange(tq, device=device)
    k_pos = torch.arange(tk, device=device)
    diff = q_pos[:, None] - k_pos[None, :]
    blocked = torch.zeros((tq, tk), dtype=torch.bool, device=device)
    if causal:
        blocked |= diff < 0
    if window:
        blocked |= diff >= window
    if kv_valid_len is not None:
        blocked |= (k_pos >= kv_valid_len)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(blocked, torch.full_like(zero, NEG_INF), zero)


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_valid_len: int | None = None):
    """The direct masked-softmax form of ``repro/models/layers.py::attention``:
    q pre-scaled by 1/sqrt(dh) and cast back to its type, fp32 scores, fp32
    row max and normaliser, probabilities cast to v's type for the PV
    product.  q [b,tq,hkv,g,dh], k/v [b,tk,hkv,dh] -> [b,tq,hkv,g,dh]."""
    dh = q.shape[-1]
    tq, tk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qs = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs.float(), k.float())
    s = s + mask_bias(tq, tk, causal=causal, window=window, q_offset=q_offset,
                      kv_valid_len=kv_valid_len, device=q.device)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp_min(denom, 1e-30)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _check(q, k, v, window, q_offset, kv_valid_len) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q [b,tq,hkv,g,dh], k/v [b,tk,hkv,dh]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hkv, _, dh = q.shape
    if k.shape[0] != b or k.shape[2] != hkv or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch, kv heads or head dim")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {_DTYPES} for q, k and v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    for name, val in (("window", window), ("q_offset", q_offset)):
        if not isinstance(val, int) or val < 0:
            raise ValueError(f"flash_attention: {name} must be an int >= 0, got {val!r}")
    if kv_valid_len is not None and (not isinstance(kv_valid_len, int) or kv_valid_len < 0):
        raise ValueError(f"flash_attention: kv_valid_len must be None or an int >= 0, "
                         f"got {kv_valid_len!r}")
    # A query row that sees no key has no defined softmax (the kernel would
    # write 0, the masked-softmax form the mean of v), so such inputs are
    # refused.  With every row's keys in [pos - window + 1, min(pos, kv_len - 1)],
    # the last row is the first to lose its keys.
    tq, tk = q.shape[1], k.shape[1]
    kv_len = tk if kv_valid_len is None else min(tk, kv_valid_len)
    last = q_offset + tq - 1
    if tq and b and (kv_len == 0 or (window and last - window + 1 > kv_len - 1)):
        raise ValueError(
            f"flash_attention: query position {last} sees no key (tk {tk}, "
            f"kv_valid_len {kv_valid_len}, window {window})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """GQA attention; output in ``q.dtype``.  ``q_offset`` is the absolute
    position of q[:, 0]; keys at or beyond ``kv_valid_len`` are masked."""
    global launches
    _check(q, k, v, window, q_offset, kv_valid_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_valid_len=kv_valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    b, tq, hkv, g, dh = q.shape
    tk = k.shape[1]
    kv_len = tk if kv_valid_len is None else min(tk, kv_valid_len)
    o = torch.empty_like(q)
    if b == 0 or tq == 0 or hkv == 0 or g == 0:
        return o
    err = K.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, tq, tk, hkv, g, dh, int(causal), window, q_offset, kv_len,
        1.0 / math.sqrt(dh), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    K.check(err, "flash_attention")
    launches += 1
    return o
