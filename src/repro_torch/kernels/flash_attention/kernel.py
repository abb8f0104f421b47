"""Flash attention: the Hopper kernels' wrapper and their plain PyTorch
versions, in the model layer's GQA layout.

For a CUDA tensor :func:`flash_attention` takes one of three routes, chosen
by :func:`route` from the dtype and the number of packed query rows
``tq * g`` before any launch (the note at the top of each source says which
TPU kernel it replaces, what bounds it and what the design does about it):

* ``"mma"`` -- bf16 with more than 16 rows (prefill):
  ``kernels/csrc/flash_attention_mma.cu``, tensor cores;
* ``"split"`` -- bf16 with at most 16 rows (decode): split-K partials
  (``kernels/csrc/flash_attention_split.cu``) over the chunks of
  :func:`plan_decode_splits`, then a merge kernel;
* ``"fma"`` -- fp32: ``kernels/csrc/flash_attention.cu`` on CUDA cores
  (fp32's tolerance rules out TF32 tensor cores);

and, for per-row valid lengths (a ``[b]`` or ``[b, tq]`` tensor
``kv_valid_len``: the continuous-batching engine's ragged rows; a row of
length 0 is dead and its output exactly zero), the ``"paged"`` route of
:func:`paged_attention`: split-K partials over a paged KV pool read
through a block table, one block a (split, 64 packed rows, batch row, KV
head), then a merge that reads each live row's splits and zeroes the dead
ones (``kernels/csrc/flash_attention_paged.cu``, on the plan of
:func:`plan_paged_splits`).  Its body (:func:`paged_body`) follows the
pages and the head dim: over bf16 or int8 pages (bf16 queries) ``wgmma``
(warpgroup tensor cores, keys by TMA through the table) at 64 and 128,
``mma`` (``mma.sync``) at the others; over fp32 pages (bf16 or fp32
queries, fp32 out) ``fma`` on CUDA cores.  A contiguous ``[b, tk, hkv,
dh]`` cache is the pool of ``b`` blocks of ``tk`` keys with the table
``[[0], [1], ...]``, so the contiguous and the paged engine steps run the
same kernel on the same plan.

A CPU tensor takes :func:`attention_plain` (:func:`paged_attention_plain`
for the paged route).  Nothing is caught and retried: a build or launch
error raises.

The training path differentiates through :class:`FlashAttentionFn`: its
forward, :func:`flash_attention_fwd`, also writes the rows' log-sum-exp
(the ``mma`` route for bf16 at any row count, ``fma`` for fp32), and its
backward, :func:`flash_attention_bwd`, is the FlashAttention-2 backward,
on one of four routes chosen by :func:`bwd_route`:

* ``"wgmma"`` -- bf16, head dim 64 or 128, g dividing 64 (llama's train
  path): ``kernels/csrc/flash_attention_bwd_wgmma.cu``, warpgroup tensor
  cores fed by TMA;
* ``"wgmma256"`` -- bf16, head dim 256, one KV head (any g) or g dividing
  64 (recurrentgemma's train path):
  ``kernels/csrc/flash_attention_bwd_wgmma256.cu``, dK and dV split by
  output between two warpgroups, each key tile's rows cut into pieces of
  about equal work (:func:`plan_dkdv_pieces`) and folded in order;
* ``"mma"`` -- the other bf16 head dims and group sizes:
  ``kernels/csrc/flash_attention_bwd.cu`` on ``mma.sync``, with whole rows
  of output at head dims 16 to 128 and, at head dim 256, each block owning
  128 of the 256 output columns;
* ``"fma"`` -- fp32, the same file on CUDA cores;

and :func:`flash_attention_bwd_plain` on the CPU.  :func:`flash_attention_bwd_on`
launches a named route that the shape allows (every bf16 shape also takes
``mma``), so a caller can time one route beside another.

Every launch and plain version takes the softmax ``scale`` (1/sqrt(dh) by
default): ``models/layers.attention`` runs a head dim outside ``HEAD_DIMS``
(bert-50b's 204) zero-padded to :func:`padded_head_dim` at the true head
dim's scale.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build as K
from repro_torch.kernels.quant.kernel import dequantize_plain

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("mma", "split", "fma", "paged")
SPLIT_MAX_ROWS = 16      # one mma tile of packed query rows
SPLIT_MIN_CHUNK = 32     # keys; a chunk is a multiple of 16
SPLIT_BLOCKS_PER_SM = 2  # the split plan's target
PAGED_KEYS = 64          # keys a paged key tile; a paged chunk is a multiple of it
PAGED_BODIES = ("wgmma", "mma", "fma")
_PAGED_BODY_ARG = {"mma": 0, "wgmma": 1, "fma": 2}   # flash_paged_launch's `body`
PAGED_WGMMA_HEAD_DIMS = (64, 128)

BWD_ROUTES = ("wgmma", "wgmma256", "mma", "fma")
# The wgmma route: head dims whose rows 128-byte TMA boxes tile, and group
# sizes for which its tiles of packed (position, group head) rows (128 rows
# at dh 64, 64 at dh 128) hold whole positions: g dividing 64.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_TILE_ROWS = 64
# The wgmma256 route's dK/dV blocks: 64 keys, row tiles of 64 packed rows;
# its plan cuts each key tile's row tiles into pieces for about
# PIECE_WAVES waves of blocks (one a SM), none shorter than PIECE_MIN_TILES
# tiles unless its key tile is.
WGMMA256_KEYS = 64
WGMMA256_ROWS = 64
PIECE_WAVES = 2
PIECE_MIN_TILES = 4

# Calls that took the CUDA route since the last reset (plain integers), in
# all and by route; the backward's likewise.
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
launches_bwd = 0
launches_bwd_by_route = dict.fromkeys(BWD_ROUTES, 0)
launches_paged_by_form = {f"paged:{body}": 0 for body in PAGED_BODIES}


def padded_head_dim(dh: int) -> int:
    """The head dim the kernels run ``dh`` at: ``dh`` where it is one of
    ``HEAD_DIMS``, else the next larger one (zero-padded); ``ValueError``
    past the largest."""
    for d in HEAD_DIMS:
        if d >= dh:
            return d
    raise ValueError(f"flash_attention: head dim {dh} pads to none of {HEAD_DIMS}")


def _scale(dh: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(dh) if scale is None else scale


def paged_route(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    """The CUDA route for per-row valid lengths, ``"paged"``: bf16 queries
    over bf16 or int8 pages, and bf16 or fp32 queries over fp32 pages (the
    reference keeps fp32 pages fp32 and promotes the query).  fp32 queries
    over bf16 or int8 pages have no route (``TypeError``)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8)) or (
            q_dtype in _DTYPES and kv_dtype == torch.float32):
        return "paged"
    raise TypeError(f"paged attention has no route for q {q_dtype} over {kv_dtype} pages")


def paged_body(dh: int, kv_dtype: torch.dtype = torch.bfloat16) -> str:
    """The ``paged`` route's kernel body for head dim ``dh`` over pages of
    ``kv_dtype``: ``"fma"`` (CUDA cores, fp32 out) for fp32 pages; else
    ``"wgmma"`` at ``PAGED_WGMMA_HEAD_DIMS`` (a tile row is one or two
    128-byte TMA halves) and ``"mma"`` at the other head dims."""
    if kv_dtype == torch.float32:
        return "fma"
    return "wgmma" if dh in PAGED_WGMMA_HEAD_DIMS else "mma"


def route(dtype: torch.dtype, rows: int, *, with_lse: bool = False) -> str:
    """The CUDA route for ``rows = tq * g`` packed query rows of ``dtype``.
    Only ``mma`` and ``fma`` write the log-sum-exp, so ``with_lse`` takes
    ``mma`` for bf16 at any row count."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        return "mma" if rows > SPLIT_MAX_ROWS or with_lse else "split"
    raise TypeError(f"flash_attention has no route for {dtype}")


def bwd_route(dtype: torch.dtype, dh: int, g: int, hkv: int) -> str:
    """The backward's CUDA route for ``hkv`` KV heads of group size ``g``:
    ``"wgmma"`` for bf16 at a head dim of ``WGMMA_HEAD_DIMS`` with a ``g``
    that divides ``WGMMA_TILE_ROWS`` (a TMA box holds 64 / g whole
    positions); ``"wgmma256"`` for bf16 at head dim 256 with one KV head
    (its packed rows are plain rows [b, T g, dh], which a box takes at any
    g) or such a ``g``; ``"mma"`` for the other bf16 shapes; ``"fma"`` for
    fp32."""
    if dtype == torch.float32:
        return "fma"
    if dtype == torch.bfloat16:
        whole = g >= 1 and WGMMA_TILE_ROWS % g == 0
        if dh in WGMMA_HEAD_DIMS and whole:
            return "wgmma"
        if dh == 256 and (hkv == 1 or whole):
            return "wgmma256"
        return "mma"
    raise TypeError(f"flash_attention_bwd has no route for {dtype}")


def bwd_routes(dtype: torch.dtype, dh: int, g: int, hkv: int) -> tuple[str, ...]:
    """The routes :func:`flash_attention_bwd_on` takes for the shape: the
    rule's route, and ``"mma"`` for every bf16 shape."""
    r = bwd_route(dtype, dh, g, hkv)
    return (r,) if r in ("mma", "fma") else (r, "mma")


def rows_seeing(k0: int, kend: int, tq: int, g: int, *, causal: bool, window: int,
                q_offset: int) -> tuple[int, int]:
    """Packed query rows ``[lo, hi)`` whose positions see some key of
    ``[k0, kend)``, as ``flash_mma.cuh``'s ``rows_seeing`` computes them."""
    plo = max(k0 - q_offset if causal else 0, 0)
    phi = min(kend - 1 + window - 1 - q_offset if window else tq - 1, tq - 1)
    lo = plo * g
    return lo, ((phi + 1) * g if kend > k0 and phi >= plo else lo)


@functools.lru_cache(maxsize=64)
def plan_dkdv_pieces(b: int, hkv: int, tq: int, tk: int, g: int, *, causal: bool, window: int,
                     q_offset: int, kv_len: int, sms: int = 132):
    """The ``wgmma256`` route's dK/dV blocks: ``(pieces, tiles)``.  Key
    tile ``kt`` of (batch, KV head) ``bh`` is key tile id ``bh *
    ktiles + kt``; its keys see the packed rows of :func:`rows_seeing`, in
    tiles of ``WGMMA256_ROWS``.  Those tiles are cut into pieces of at most
    ``size`` tiles -- the work of all key tiles over ``PIECE_WAVES`` waves
    of ``sms`` blocks, at least ``PIECE_MIN_TILES`` -- a key tile's pieces
    differing by at most one tile.  ``pieces``: ``(key tile id, first row,
    end row, slot)`` in launch order, longest first (ties in slot order);
    slots number the pieces key tile by key tile, rows ascending, which is
    the order the fold sums them in.  ``tiles[key tile id] = (first slot,
    pieces)``; a key tile no row sees (past ``kv_len``) has none."""
    ktiles = -(-tk // WGMMA256_KEYS)
    ranges = []
    for kt in range(ktiles):
        k0 = kt * WGMMA256_KEYS
        kend = min(k0 + WGMMA256_KEYS, kv_len)
        lo, hi = rows_seeing(k0, kend, tq, g, causal=causal, window=window, q_offset=q_offset)
        ranges.append((lo, hi, -(-(hi - lo) // WGMMA256_ROWS)))
    total = b * hkv * sum(n for _, _, n in ranges)
    size = max(PIECE_MIN_TILES, -(-total // (PIECE_WAVES * sms)))
    pieces, tiles = [], []
    for bh in range(b * hkv):
        for kt, (lo, hi, n) in enumerate(ranges):
            m = -(-n // size)
            tiles.append((len(pieces), m))
            t = 0
            for p in range(m):
                nt = n // m + (p < n % m)
                pieces.append((bh * ktiles + kt, lo + t * WGMMA256_ROWS,
                               min(hi, lo + (t + nt) * WGMMA256_ROWS), len(pieces)))
                t += nt
    pieces.sort(key=lambda pc: -(pc[2] - pc[1]))   # stable: ties keep slot order
    return tuple(pieces), tuple(tiles)


def rowstat_rows(tq: int, g: int) -> int:
    """Rows of the backward's packed (lse, delta) table a (batch, KV head):
    ``tq * g`` rounded up to even, so each row of 8-byte pairs starts on 16
    bytes, as the wgmma routes' tensor maps need."""
    return tq * g + (tq * g) % 2


def plan_decode_splits(b: int, hkv: int, kv_len: int, *, sms: int = 132,
                       multiple: int = 16) -> tuple[int, int]:
    """``(nsplit, chunk)``: keys ``[0, kv_len)`` cut into ``nsplit`` chunks
    of ``chunk`` keys (the last one cut short), so that ``b * hkv * nsplit``
    blocks reach about ``SPLIT_BLOCKS_PER_SM`` on each of ``sms`` SMs.
    ``chunk`` is a multiple of ``multiple`` and no smaller than
    ``SPLIT_MIN_CHUNK``, which stops the split first on short caches."""
    want = max(1, -(-sms * SPLIT_BLOCKS_PER_SM // (b * hkv)))
    chunk = -(-max(kv_len, 1) // want)
    chunk = max(SPLIT_MIN_CHUNK, -(-chunk // multiple) * multiple)
    return -(-max(kv_len, 1) // chunk), chunk


def plan_paged_splits(b: int, hkv: int, capacity: int, *, sms: int = 132) -> tuple[int, int]:
    """The ``paged`` route's ``(nsplit, chunk)`` over the capacity
    ``max_blocks * block_size``: :func:`plan_decode_splits` with chunks of
    whole ``PAGED_KEYS`` tiles.  A function of the shapes alone -- never of
    the tables, the lengths or which rows are live -- so a live row's bits
    do not depend on what the other slots do, and the paged and contiguous
    forms share it.  It is sized for one live row block a (batch row, KV
    head), a decode-only tick at any chunk width (the engine's 8 slots x 8
    KV heads over 576 positions: 5 chunks of 128 keys); the rows of a
    prefill chunk multiply the blocks."""
    return plan_decode_splits(b, hkv, capacity, sms=sms, multiple=PAGED_KEYS)


def mask_bias(tq: int, tk: int, *, causal: bool, window: int, q_offset: int,
              kv_valid_len, device) -> torch.Tensor:
    """[tq, tk] additive fp32 mask (0 allowed, NEG_INF blocked), as
    ``repro/models/layers.py::_mask_bias``; [b, tq, tk] for per-row valid
    lengths (``kv_valid_len`` a [b] or [b, tq] tensor: row i of request b
    sees keys ``j < kv_valid_len[b, i]``)."""
    q_pos = q_offset + torch.arange(tq, device=device)
    k_pos = torch.arange(tk, device=device)
    diff = q_pos[:, None] - k_pos[None, :]
    blocked = torch.zeros((tq, tk), dtype=torch.bool, device=device)
    if causal:
        blocked |= diff < 0
    if window:
        blocked |= diff >= window
    if isinstance(kv_valid_len, torch.Tensor):
        kvl = kv_valid_len if kv_valid_len.dim() == 2 else kv_valid_len[:, None]
        blocked = blocked[None] | (k_pos[None, None, :] >= kvl.to(device)[:, :, None])
    elif kv_valid_len is not None:
        blocked |= (k_pos >= kv_valid_len)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(blocked, torch.full_like(zero, NEG_INF), zero)


def visible_pairs(tq: int, kv_len: int, *, causal: bool, window: int, q_offset: int) -> int:
    """The (query, key) pairs of one (batch row, head) that the masks allow:
    query i at position ``q_offset + i`` sees the keys below ``kv_len``, up
    to itself if ``causal``, and within ``window`` of it if set."""
    pos = q_offset + np.arange(tq)
    hi = np.minimum(kv_len, pos + 1) if causal else np.full(tq, kv_len)
    lo = np.maximum(pos - window + 1, 0) if window else 0
    return int(np.clip(hi - lo, 0, None).sum())


def attention_work(q, k, *, kv_len: int, causal: bool, window: int, q_offset: int,
                   backward: bool = False) -> tuple[float, float]:
    """``(dot_flops, nbytes)`` of one flash launch on q [b, tq, hkv, g, dh]
    and k [b, tk, hkv, dh], the counts of its ``bound_ms``: forward, 4 dh a
    visible pair and head (q k^T and p v) over q read, o written and the
    first ``kv_len`` keys and values read; backward, 10 dh (s, dp, dv, dq
    and dk) over q, o, dO, k, v and lse read and dq, dk, dv written."""
    b, tq, hkv, g, dh = q.shape
    pairs = visible_pairs(tq, kv_len, causal=causal, window=window, q_offset=q_offset)
    pairs *= b * hkv * g
    if backward:
        return 10.0 * dh * pairs, float((4 * q.numel() + 4 * k.numel()) * q.element_size()
                                        + b * hkv * g * tq * 4)
    return 4.0 * dh * pairs, float((2 * q.numel() + 2 * b * kv_len * hkv * dh)
                                   * q.element_size())


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_valid_len=None, scale: float | None = None):
    """The direct masked-softmax form of ``repro/models/layers.py::attention``:
    q pre-scaled by ``scale`` (1/sqrt(dh) by default) and cast back to its
    type, fp32 scores, fp32 row max and normaliser, probabilities cast to
    v's type for the PV product.  q [b,tq,hkv,g,dh], k/v [b,tk,hkv,dh] ->
    [b,tq,hkv,g,dh]."""
    return attention_plain_lse(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               kv_valid_len=kv_valid_len, scale=scale)[0]


def attention_plain_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_valid_len=None, scale: float | None = None):
    """:func:`attention_plain` and the rows' fp32 log-sum-exp of the scaled,
    masked scores, ``m + log(sum exp(s - m))``, as [b, hkv, g, tq].
    ``kv_valid_len``: an int, or a [b] / [b, tq] tensor of per-row valid
    lengths."""
    dh = q.shape[-1]
    tq, tk = q.shape[1], k.shape[1]
    scale = _scale(dh, scale)
    qs = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs.float(), k.float())
    bias = mask_bias(tq, tk, causal=causal, window=window, q_offset=q_offset,
                     kv_valid_len=kv_valid_len, device=q.device)
    s = s + (bias[:, None, None] if bias.dim() == 3 else bias)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    lse = (m + torch.log(torch.clamp_min(denom, 1e-30)))[..., 0]
    p = p / torch.clamp_min(denom, 1e-30)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v), lse


def _kv_len(tk: int, kv_valid_len: int | None) -> int:
    return tk if kv_valid_len is None else min(tk, kv_valid_len)


def decode_partials_plain(q, k, v, *, nsplit: int, chunk: int, causal: bool = True,
                          window: int = 0, q_offset: int = 0,
                          kv_valid_len: int | None = None) -> torch.Tensor:
    """The split route's first kernel: for each packed row r = (position,
    group head) and each chunk s of ``chunk`` keys of ``[0, kv_len)``, fp32
    ``(m, l, acc)`` with m the chunk's max allowed score, p = exp(s - m) (0
    where masked), l = sum p and acc = p @ v with p rounded to v's type.  A
    chunk with no allowed key gives m = NEG_INF, l = 0, acc = 0.
    -> fp32 [b, hkv, nsplit, tq * g, dh + 2] holding (m, l, acc[dh])."""
    b, tq, hkv, g, dh = q.shape
    kv_len = _kv_len(k.shape[1], kv_valid_len)
    span = nsplit * chunk
    if span < kv_len:
        raise ValueError(f"{nsplit} chunks of {chunk} keys do not cover {kv_len}")
    qs = (q.float() * (1.0 / math.sqrt(dh))).to(q.dtype).float()
    qs = qs.permute(0, 2, 1, 3, 4).reshape(b, hkv, tq * g, dh)
    kk = torch.nn.functional.pad(k[:, :kv_len].float(), (0, 0, 0, 0, 0, span - kv_len))
    vv = torch.nn.functional.pad(v[:, :kv_len], (0, 0, 0, 0, 0, span - kv_len))
    s = torch.einsum("bhrd,bkhd->bhrk", qs, kk)                       # [b, hkv, rows, span]
    allowed = mask_bias(tq, span, causal=causal, window=window, q_offset=q_offset,
                        kv_valid_len=kv_len, device=q.device) == 0
    allowed = allowed.repeat_interleave(g, dim=0)                     # [rows, span]
    s = s.reshape(b, hkv, tq * g, nsplit, chunk)
    allowed = allowed.reshape(tq * g, nsplit, chunk)
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)                                         # [b, hkv, rows, nsplit]
    p = torch.where(allowed, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    vv = vv.reshape(b, nsplit, chunk, hkv, dh)
    acc = torch.einsum("bhrsk,bskhd->bhrsd", p.to(v.dtype).float(), vv.float())
    part = torch.cat([m[..., None], l[..., None], acc], dim=-1)      # [b, hkv, rows, nsplit, dh+2]
    return part.permute(0, 1, 3, 2, 4).contiguous()


def merge_partials_plain(part: torch.Tensor, tq: int, g: int, dtype: torch.dtype) -> torch.Tensor:
    """The split route's merge: o = sum_s w_s acc_s / max(sum_s w_s l_s,
    1e-30) with w_s = exp(m_s - max_s m_s), and w_s = 0 for an empty chunk
    (m_s = NEG_INF).  part [b, hkv, nsplit, tq * g, dh + 2] -> o
    [b, tq, hkv, g, dh] in ``dtype``."""
    b, hkv, _, rows, dh2 = part.shape
    m, l, acc = part[..., 0], part[..., 1], part[..., 2:]
    mx = torch.amax(m, dim=2, keepdim=True)
    w = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp(m - mx))
    den = torch.clamp_min((w * l).sum(2), 1e-30)                      # [b, hkv, rows]
    o = (w[..., None] * acc).sum(2) / den[..., None]                  # [b, hkv, rows, dh]
    return o.reshape(b, hkv, tq, g, dh2 - 2).permute(0, 2, 1, 3, 4).to(dtype)


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
    kv_len = _kv_len(tk, kv_valid_len)
    last = q_offset + tq - 1
    if tq and b and (kv_len == 0 or (window and last - window + 1 > kv_len - 1)):
        raise ValueError(
            f"flash_attention: query position {last} sees no key (tk {tk}, "
            f"kv_valid_len {kv_valid_len}, window {window})")


def _cuda_ready(*ts) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: its tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention: its tensors must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_partials(q, k, v, kv_len: int, nsplit: int, chunk: int, causal: bool,
                     window: int, q_offset: int, stream: int, scale: float) -> torch.Tensor:
    b, tq, hkv, g, dh = q.shape
    part = torch.empty((b, hkv, nsplit, tq * g, dh + 2), dtype=torch.float32, device=q.device)
    err = K.library().flash_split_partials_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(), b, tq, k.shape[1], hkv,
        g, dh, int(causal), window, q_offset, kv_len, nsplit, chunk, scale, stream)
    K.check(err, "flash_attention (split partials)")
    return part


def _launch_merge(part: torch.Tensor, tq: int, g: int, stream: int) -> torch.Tensor:
    b, hkv, nsplit, _, dh2 = part.shape
    o = torch.empty((b, tq, hkv, g, dh2 - 2), dtype=torch.bfloat16, device=part.device)
    err = K.library().flash_split_merge_launch(
        part.data_ptr(), o.data_ptr(), b, tq, hkv, g, dh2 - 2, nsplit, stream)
    K.check(err, "flash_attention (split merge)")
    return o


def _launch_dense(r: str, q, k, v, o, lse, causal: bool, window: int, q_offset: int,
                  kv_len: int, stream: int, scale: float) -> None:
    """One launch of the ``mma`` or ``fma`` kernel; ``lse`` (fp32
    [b, hkv, g, tq]) or None, which the serve path passes."""
    b, tq, hkv, g, dh = q.shape
    fn = K.library().flash_mma_launch if r == "mma" else K.library().flash_fma_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), b, tq, k.shape[1], hkv, g, dh,
             int(causal), window, q_offset, kv_len, scale, stream)
    K.check(err, f"flash_attention ({r})")


def decode_partials(q, k, v, *, nsplit: int, chunk: int, causal: bool = True,
                    window: int = 0, q_offset: int = 0,
                    kv_valid_len: int | None = None) -> torch.Tensor:
    """The split route's first kernel alone (bf16, ``tq * g <= 16``) ->
    fp32 [b, hkv, nsplit, tq * g, dh + 2]; :func:`decode_partials_plain`
    for CPU tensors.  Not counted: :func:`flash_attention` counts its route."""
    _check(q, k, v, window, q_offset, kv_valid_len)
    kv_len = _kv_len(k.shape[1], kv_valid_len)
    if chunk <= 0 or chunk % 16 or nsplit * chunk < kv_len:
        raise ValueError(f"decode_partials: {nsplit} chunks of {chunk} keys for {kv_len}")
    if q.device.type == "cpu":
        return decode_partials_plain(q, k, v, nsplit=nsplit, chunk=chunk, causal=causal,
                                     window=window, q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    if route(q.dtype, q.shape[1] * q.shape[3]) != "split":
        raise ValueError(f"decode_partials takes bf16 with tq * g <= {SPLIT_MAX_ROWS}; got "
                         f"{q.dtype}, {q.shape[1] * q.shape[3]} rows")
    _cuda_ready(q, k, v)
    return _launch_partials(q, k, v, kv_len, nsplit, chunk, causal, window, q_offset,
                            _stream(q), _scale(q.shape[-1], None))


def _row_lengths(kv_valid_len: torch.Tensor, b: int, tq: int) -> torch.Tensor:
    """Per-row valid lengths as [b, tq] (a [b] tensor holds for every row)."""
    kvl = kv_valid_len if kv_valid_len.dim() == 2 else kv_valid_len[:, None]
    if kvl.dim() != 2 or kvl.shape[0] != b or kvl.shape[1] not in (1, tq):
        raise ValueError(f"kv_valid_len {tuple(kv_valid_len.shape)}: want [{b}] or [{b}, {tq}]")
    return kvl.expand(b, tq)


def paged_attention_plain(q, k_pages, v_pages, tables, kv_valid_len, *, k_scale=None,
                          v_scale=None, scale: float | None = None):
    """The paged route's function, plainly: the pool gathered through the
    block table into a contiguous view ``[b, max_blocks * block_size, hkv,
    dh]`` (int8 pages dequantized to q's type, ``dequantize_plain``), then
    :func:`attention_plain` with the per-row mask (row i of request b sees
    keys ``j < kv_valid_len[b, i]``); a dead row (valid length 0) gives
    exact zeros."""
    b, mb = tables.shape
    kvl = _row_lengths(kv_valid_len, b, q.shape[1])

    def view(pages):
        pv = pages[tables.long()]                       # [b, mb, bs, hkv, ...]
        return pv.reshape(b, mb * pv.shape[2], *pv.shape[3:])

    k, v = view(k_pages), view(v_pages)
    if k_scale is not None:
        k = dequantize_plain(k, view(k_scale), q.dtype)
        v = dequantize_plain(v, view(v_scale), q.dtype)
    o = attention_plain(q, k, v, causal=False, kv_valid_len=kvl, scale=scale)
    return o.masked_fill((kvl.to(o.device) == 0)[:, :, None, None, None], 0)


def _check_paged(q, k_pages, v_pages, tables, k_scale, v_scale) -> None:
    if q.dim() != 5 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: want q [b,tq,hkv,g,dh], pages [nb,bs,hkv,dh]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, _, hkv, _, dh = q.shape
    if tuple(k_pages.shape[2:]) != (hkv, dh):
        raise ValueError(f"paged_attention: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree on kv heads or head dim")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {dh} not in {HEAD_DIMS}")
    if tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)}, want [{b}, max_blocks]")
    int8 = k_pages.dtype == torch.int8
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention: int8 pages take fp32 scale pages, others none")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.shape != k_scale.shape
                 or tuple(k_scale.shape) != (*k_pages.shape[:3], -(-dh // 128))):
        raise ValueError(f"paged_attention: scale pages {tuple(k_scale.shape)}, want fp32 "
                         f"{(*k_pages.shape[:3], -(-dh // 128))}")
    ts = [q, k_pages, v_pages, tables] + ([k_scale, v_scale] if int8 else [])
    if len({t.device for t in ts}) != 1:
        raise ValueError("paged_attention: its tensors lie on different devices")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    tables: torch.Tensor, kv_valid_len: torch.Tensor, *,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """GQA attention of q [b, tq, hkv, g, dh] over a paged KV pool: pages
    [n_blocks, block_size, hkv, dh] (int8 with fp32 scale pages [...,
    ceil(dh / 128)], or q's type), key j of request b at row
    ``j % block_size`` of block ``tables[b, j // block_size]``; row i of
    request b sees keys ``j < kv_valid_len[b, i]`` (a [b] or [b, tq]
    tensor); a row of valid length 0 is dead and its output is exactly
    zero.  CUDA: the ``paged`` route (:func:`paged_route`), body
    :func:`paged_body`, on the plan of :func:`plan_paged_splits` over the
    capacity ``max_blocks * block_size``, then its merge; CPU:
    :func:`paged_attention_plain`.  ``scale``: the softmax scale, 1/sqrt(dh)
    by default.  -> [b, tq, hkv, g, dh] in q's type, fp32 over fp32 pages
    (the promoted type)."""
    global launches
    _check_paged(q, k_pages, v_pages, tables, k_scale, v_scale)
    b, tq, hkv, g, dh = q.shape
    kvl = _row_lengths(kv_valid_len, b, tq)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, tables, kvl, k_scale=k_scale,
                                     v_scale=v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    r = paged_route(q.dtype, k_pages.dtype)
    body = paged_body(dh, k_pages.dtype)
    mb, bs = tables.shape[1], k_pages.shape[1]
    int8 = k_pages.dtype == torch.int8
    if body == "wgmma" and int8 and mb > 1 and math.gcd(bs, PAGED_KEYS) * dh % 128:
        raise ValueError(f"paged_attention: int8 pages at head dim {dh} take an even block "
                         f"size (a TMA box of whole 128-byte rows); got {bs}")
    tables = tables.to(torch.int32).contiguous()
    kvl = kvl.to(torch.int64).contiguous()  # the engine's lengths go in as they are
    scales = (k_scale, v_scale) if k_scale is not None else ()
    _cuda_ready(q, k_pages, v_pages, tables, kvl, *scales)
    o = torch.empty_like(q, dtype=torch.promote_types(q.dtype, k_pages.dtype)
                         if body == "fma" else q.dtype)
    if b == 0 or tq == 0 or hkv == 0 or g == 0:
        return o
    nsplit, chunk = plan_paged_splits(b, hkv, mb * bs, sms=K.sm_count(q.get_device()))
    # written only for (live row, split) pairs with keys, read only there
    part = torch.empty((b, hkv, nsplit, tq * g, dh + 2), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = K.library().flash_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale), ptr(v_scale),
        tables.data_ptr(), kvl.data_ptr(), part.data_ptr(), o.data_ptr(), b, tq, hkv, g, dh,
        bs, mb, k_pages.shape[0], int(int8), _PAGED_BODY_ARG[body],
        int(q.dtype == torch.float32), nsplit, chunk, _scale(dh, scale), _stream(q))
    K.check(err, f"flash_attention (paged, {body})")
    launches += 1
    launches_by_route[r] += 1
    launches_paged_by_form[f"paged:{body}"] += 1
    if K.LISTENERS:  # the live keys a head reads (a read of the lengths)
        cap = tables.shape[1] * bs
        lens = torch.clamp(kvl if kvl.dim() == 2 else kvl[:, None].expand(b, tq), max=cap)
        live = torch.clamp(lens.max(dim=1).values, max=cap).sum().item()
        per_key = hkv * dh * k_pages.element_size() + (hkv * 4 * -(-dh // 128) if int8 else 0)
        n_live = int((lens > 0).sum().item())
        K.report("flash_attention", 2 * live * per_key + n_live * hkv * g * dh * (
            q.element_size() + o.element_size()), 4.0 * dh * hkv * g * lens.sum().item())
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid_len=None, scale: float | None = None) -> torch.Tensor:
    """GQA attention; output in ``q.dtype``.  ``q_offset`` is the absolute
    position of q[:, 0]; keys at or beyond ``kv_valid_len`` are masked.
    A [b] or [b, tq] tensor ``kv_valid_len`` (per-row lengths, no causal
    or window mask) is :func:`paged_attention` over k / v as a pool of one
    block a request.  ``scale``: the softmax scale, 1/sqrt(dh) by default."""
    global launches
    if isinstance(kv_valid_len, torch.Tensor):
        if causal or window or q_offset:
            raise ValueError("flash_attention: per-row valid lengths take no causal, window "
                             "or q_offset mask")
        tables = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
        return paged_attention(q, k, v, tables, kv_valid_len, scale=scale)
    _check(q, k, v, window, q_offset, kv_valid_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _cuda_ready(q, k, v)
    b, tq, hkv, g, dh = q.shape
    scale = _scale(dh, scale)
    tk = k.shape[1]
    kv_len = _kv_len(tk, kv_valid_len)
    if b == 0 or tq == 0 or hkv == 0 or g == 0:
        return torch.empty_like(q)
    r = route(q.dtype, tq * g)
    stream = _stream(q)
    if r == "split":
        nsplit, chunk = plan_decode_splits(b, hkv, kv_len, sms=K.sm_count(q.get_device()))
        o = _launch_merge(_launch_partials(q, k, v, kv_len, nsplit, chunk, causal, window,
                                           q_offset, stream, scale), tq, g, stream)
    else:
        o = torch.empty_like(q)
        _launch_dense(r, q, k, v, o, None, causal, window, q_offset, kv_len, stream, scale)
    launches += 1
    launches_by_route[r] += 1
    if K.LISTENERS:
        flops, nbytes = attention_work(q, k, kv_len=kv_len, causal=causal, window=window,
                                       q_offset=q_offset)
        K.report("flash_attention", nbytes, flops)
    return o


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, q_offset: int = 0,
                        kv_valid_len: int | None = None, scale: float | None = None):
    """The forward of the training path: ``(o, lse)``, o as
    :func:`flash_attention` and lse the rows' fp32 log-sum-exp
    [b, hkv, g, tq] that the backward reads.  bf16 takes ``mma`` at any row
    count (``split`` writes no lse), fp32 ``fma``; counted as forward
    launches."""
    global launches
    _check(q, k, v, window, q_offset, kv_valid_len)
    if q.device.type == "cpu":
        return attention_plain_lse(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _cuda_ready(q, k, v)
    b, tq, hkv, g, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hkv, g, tq), dtype=torch.float32, device=q.device)
    if b == 0 or tq == 0 or hkv == 0 or g == 0:
        return o, lse
    r = route(q.dtype, tq * g, with_lse=True)
    kv_len = _kv_len(k.shape[1], kv_valid_len)
    _launch_dense(r, q, k, v, o, lse, causal, window, q_offset, kv_len, _stream(q),
                  _scale(dh, scale))
    launches += 1
    launches_by_route[r] += 1
    if K.LISTENERS:
        flops, nbytes = attention_work(q, k, kv_len=kv_len, causal=causal, window=window,
                                       q_offset=q_offset)
        K.report("flash_attention", nbytes, flops)
    return o, lse


def _bwd_terms_plain(q, k, v, o, lse, do, *, causal, window, q_offset, kv_valid_len, scale):
    """The backward's per-pair terms in the kernels' arithmetic: fp32
    ``(qs, P, dS)`` with qs = q scaled and rounded to its type, P [b, hkv,
    g, tq, tk] (0 where masked) and dS = P (dP - delta) rounded to the
    inputs' type (dP rounded first)."""
    tq, tk, dh = q.shape[1], k.shape[1], q.shape[-1]
    dt = q.dtype
    qs = (q.float() * _scale(dh, scale)).to(dt).float()
    dof = do.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    allowed = mask_bias(tq, tk, causal=causal, window=window, q_offset=q_offset,
                        kv_valid_len=kv_valid_len, device=q.device) == 0
    p = torch.where(allowed, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (dof * o.float()).sum(-1).permute(0, 2, 3, 1)            # [b, hkv, g, tq]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float()).to(dt).float()
    return qs, p, (p * (dp - delta[..., None])).to(dt).float()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                              q_offset: int = 0, kv_valid_len: int | None = None,
                              scale: float | None = None):
    """The FlashAttention-2 backward of :func:`attention_plain`, in the
    kernels' arithmetic: ``P = exp(s - lse)`` (0 where masked) from the
    scaled q rounded to its type, ``delta = rowsum(dO o)``,
    ``dP = dO v^T`` rounded to the inputs' type (where the reference's
    autodiff rounds the cotangent of its bf16 probabilities),
    ``dS = P (dP - delta)``; ``dv = P^T dO`` with P rounded to v's type,
    ``dk = dS^T qs`` and ``dq = scale (dS k)`` with dS rounded to the
    inputs' type (the tensor cores' operand), dq rounded before and after
    the scale as the reference's cast back to q's type does.  fp32 rounds
    nowhere.  ``scale``: the forward's, 1/sqrt(dh) by default.  -> (dq, dk,
    dv) in the inputs' type."""
    dt = q.dtype
    qs, p, ds = _bwd_terms_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                 q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    return _dq_plain(ds, k, dt, scale), dk.to(dt), dv.to(dt)


def _dq_plain(ds, k, dt, scale=None):
    dqs = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return (dqs.to(dt).float() * _scale(k.shape[-1], scale)).to(dt)


def flash_attention_bwd_pieces_plain(q, k, v, o, lse, do, *, causal: bool = True,
                                     window: int = 0, q_offset: int = 0,
                                     kv_valid_len: int | None = None, sms: int = 132):
    """The ``wgmma256`` route's dK and dV in its order: each piece of
    :func:`plan_dkdv_pieces` (for ``sms`` SMs) sums its rows' terms into
    fp32 partials of its key tile's 64 keys, and the fold adds a key tile's
    partials in slot order from 0, then rounds once; keys no piece covers
    get 0.  dq as :func:`flash_attention_bwd_plain`.  Same result as that
    up to the order of the sums."""
    b, tq, hkv, g, dh = q.shape
    tk, dt = k.shape[1], q.dtype
    qs, p, ds = _bwd_terms_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                 q_offset=q_offset, kv_valid_len=kv_valid_len, scale=None)
    # packed rows r = position g + head: [b, hkv, tq g, tk] and [b, hkv, tq g, dh]
    rows = lambda t: t.permute(0, 1, 3, 2, 4).reshape(b, hkv, tq * g, tk)  # noqa: E731
    pr, dsr = rows(p.to(dt).float()), rows(ds)
    qr = qs.permute(0, 2, 1, 3, 4).reshape(b, hkv, tq * g, dh)
    dor = do.float().permute(0, 2, 1, 3, 4).reshape(b, hkv, tq * g, dh)
    pieces, tiles = plan_dkdv_pieces(b, hkv, tq, tk, g, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=_kv_len(tk, kv_valid_len), sms=sms)
    ktiles = -(-tk // WGMMA256_KEYS)
    by_slot = {pc[3]: pc for pc in pieces}
    dk = torch.zeros(b, tk, hkv, dh, device=q.device)
    dv = torch.zeros_like(dk)
    for kid, (first, count) in enumerate(tiles):
        bh, kt = divmod(kid, ktiles)
        bi, h = divmod(bh, hkv)
        k0, k1 = kt * WGMMA256_KEYS, min(kt * WGMMA256_KEYS + WGMMA256_KEYS, tk)
        sum_k = torch.zeros(k1 - k0, dh, device=q.device)
        sum_v = torch.zeros_like(sum_k)
        for slot in range(first, first + count):
            _, r0, r1, _ = by_slot[slot]
            sum_k = sum_k + dsr[bi, h, r0:r1, k0:k1].T @ qr[bi, h, r0:r1]
            sum_v = sum_v + pr[bi, h, r0:r1, k0:k1].T @ dor[bi, h, r0:r1]
        dk[bi, k0:k1, h] = sum_k
        dv[bi, k0:k1, h] = sum_v
    return _dq_plain(ds, k, dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_valid_len: int | None = None,
                        scale: float | None = None):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd` at ``do``, from its
    output ``o`` and log-sum-exp ``lse`` (``scale``: the forward's).  CUDA:
    the route of :func:`bwd_route` (:func:`flash_attention_bwd_on`); CPU:
    :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, window, q_offset, kv_valid_len)
    r = bwd_route(q.dtype, q.shape[-1], q.shape[3], q.shape[2])
    return flash_attention_bwd_on(r, q, k, v, o, lse, do, causal=causal, window=window,
                                  q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)


_PIECE_TABLES: dict = {}


def _piece_table(plan, device) -> tuple[torch.Tensor, int]:
    """``plan``'s pieces (int4 each) then its tiles (int2 each) as one int32
    tensor on ``device``, made once a plan and device; and the piece count."""
    key = (plan, device)
    if key not in _PIECE_TABLES:
        pieces, tiles = plan
        flat = [v for pc in pieces for v in pc] + [v for tl in tiles for v in tl]
        _PIECE_TABLES[key] = torch.tensor(flat, dtype=torch.int32).to(device)
    return _PIECE_TABLES[key], len(plan[0])


def flash_attention_bwd_on(route: str, q, k, v, o, lse, do, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0, kv_valid_len: int | None = None,
                           scale: float | None = None):
    """:func:`flash_attention_bwd` on ``route``, one of :func:`bwd_routes`
    for the shape (another raises, on any device).  CUDA: the delta launch (with the
    scaled q and packed row stats for bf16), then the route's: dK and dV by
    key tile and dQ by query tile (``wgmma``, ``mma``, ``fma``), or dK and
    dV by the pieces of :func:`plan_dkdv_pieces`, their fold and dQ
    (``wgmma256``); counted as one backward call on ``route``.  CPU:
    :func:`flash_attention_bwd_plain`, whatever ``route``."""
    global launches_bwd
    _check(q, k, v, window, q_offset, kv_valid_len)
    b, tq, hkv, g, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {o.dtype} {tuple(o.shape)} and do "
                         f"{do.dtype} {tuple(do.shape)} must match q {q.dtype} "
                         f"{tuple(q.shape)}")
    if lse.shape != (b, hkv, g, tq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {lse.dtype} {tuple(lse.shape)}, want "
                         f"fp32 {(b, hkv, g, tq)}")
    r = route
    if r not in bwd_routes(q.dtype, dh, g, hkv):
        raise ValueError(f"flash_attention_bwd: route {r!r} does not take {q.dtype} dh {dh} "
                         f"g {g} hkv {hkv}; it takes {bwd_routes(q.dtype, dh, g, hkv)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window,
                                         q_offset=q_offset, kv_valid_len=kv_valid_len,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _cuda_ready(q, k, v, o, do, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or tq == 0 or hkv == 0 or g == 0:
        return dq, dk.zero_(), dv.zero_()
    stream = _stream(q)
    scale = _scale(dh, scale)
    tk = k.shape[1]
    kv_len = _kv_len(tk, kv_valid_len)
    delta = torch.empty_like(lse)
    # bf16: the scaled q and each packed row's (lse, delta), which the dK / dV
    # kernels load a tile at a time by asynchronous copies
    tma = r in ("wgmma", "wgmma256")
    rs_rows = rowstat_rows(tq, g) if tma else tq * g
    qs = torch.empty_like(q) if r != "fma" else None
    rowstat = (torch.empty((b, hkv, rs_rows, 2), dtype=torch.float32, device=q.device)
               if r != "fma" else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = K.library()
    err = lib.flash_bwd_delta_launch(q.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                     delta.data_ptr(), ptr(qs), ptr(rowstat), b * tq * hkv * g,
                                     tq, hkv, g, dh, rs_rows, scale,
                                     int(q.dtype == torch.bfloat16), stream)
    K.check(err, "flash_attention_bwd (delta)")
    outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (b, tq, tk, hkv, g, dh)
    rest = (int(causal), window, q_offset, kv_len, scale, stream)
    if r == "wgmma":
        err = lib.flash_bwd_wgmma_launch(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         do.data_ptr(), rowstat.data_ptr(), *outs, *shape,
                                         rs_rows, *rest)
    elif r == "wgmma256":
        plan = plan_dkdv_pieces(b, hkv, tq, tk, g, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len,
                                sms=K.sm_count(q.get_device()))
        table, npieces = _piece_table(plan, q.device)
        # fp32 partial dK and dV of each piece: [npieces, 2, 64 keys x 256]
        partials = torch.empty((max(npieces, 1), 2, WGMMA256_KEYS * dh), dtype=torch.float32,
                               device=q.device)
        err = lib.flash_bwd_wgmma256_launch(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), rowstat.data_ptr(),
            table.data_ptr(), npieces, table.data_ptr() + 16 * npieces, partials.data_ptr(),
            *outs, b, tq, tk, hkv, g, rs_rows, *rest)
    else:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        if r == "fma":
            err = lib.flash_bwd_fma_launch(*args, *outs, *shape, *rest)
        else:  # mma: at dh 256 the entry point splits the output columns
            err = lib.flash_bwd_mma_launch(*args, qs.data_ptr(), rowstat.data_ptr(), *outs,
                                           *shape, *rest)
    K.check(err, f"flash_attention_bwd ({r})")
    launches_bwd += 1
    launches_bwd_by_route[r] += 1
    if K.LISTENERS:
        flops, nbytes = attention_work(q, k, kv_len=_kv_len(k.shape[1], kv_valid_len),
                                       causal=causal, window=window, q_offset=q_offset,
                                       backward=True)
        K.report("flash_attention_bwd", nbytes, flops)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its hand-written gradient: :func:`flash_attention_fwd`
    (o and the log-sum-exp), then :func:`flash_attention_bwd`, both at
    ``scale``.  Saves q, k, v, o and lse; the backward recomputes the
    probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_valid_len, scale=None):
        kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
                  scale=scale)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
