"""RG-LRU scan: the Hopper kernel's wrappers and their plain PyTorch versions.

The CUDA kernel is ``kernels/csrc/rglru.cu`` (see the note there: which
TPU kernel it replaces, what bounds it, what the design does about it).  It
has two entry points over one chunked scan (:func:`plan_scan_chunks`):

* :func:`rglru` -- the TPU kernel's function, ``h_t = a_t * h_{t-1} + b_t``
  from precomputed ``(a, b)``;
* :func:`rglru_gated` -- the model's: the gate math of
  ``repro/models/recurrent.py::_rglru_coeffs`` computed in the kernel from
  ``x`` and the per-channel weights, so a and b never reach device memory.

Each launches the kernel for CUDA tensors and uses its plain version
(:func:`rglru_plain`, :func:`rglru_gated_plain`) for CPU tensors; there is
no other route and no fall-back when a build or launch fails.

Both entry points have a gradient.  A call that autograd records runs as
an autograd Function (:class:`RgLruFn`, :class:`RgLruGatedFn`) whose
backward is the kernel of ``kernels/csrc/rglru_bwd.cu``
(:func:`rglru_bwd`, :func:`rglru_gated_bwd`; their plain versions
:func:`rglru_bwd_plain`, :func:`rglru_gated_bwd_plain` on the CPU), over
the chunks of :func:`plan_bwd_chunks`.  Its forward runs on that plan too
(:func:`rglru_with_starts`, :func:`rglru_gated_with_starts`) and hands the
backward each chunk's entering h (fp32 [B, nchunks, C]), which the
backward would otherwise fold again.  As in the reference's
``rglru_scan``, such a call starts from h = 0 (a given ``h0`` or
``state_out`` raises), and its last state ``h_last`` carries no gradient.
Calls autograd does not record (serving) launch the forward alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as K

_DTYPES = (torch.float32, torch.bfloat16)
LRU_C = 8.0
FORMS = ("ab", "gated")
CHUNK_MIN = 64            # steps; shorter T runs as one chunk
CHUNK_ALIGN = 8           # the kernel's unroll
THREADS = 128             # a block: 128 channels of one (batch, chunk)
BLOCKS_PER_SM = 12        # resident blocks a SM (the kernel's __launch_bounds__)
WAVES = 2                 # the plan's chunks fill this many waves of blocks
BWD_CHUNK_MAX = 64        # steps: the backward keeps a chunk's fp32 h in shared memory

# Calls that launched the CUDA kernel since the last reset (plain integers),
# in all and by entry point: "ab" for rglru, "gated" for rglru_gated; the
# backward's likewise.
launches = 0
launches_by_form = dict.fromkeys(FORMS, 0)
launches_bwd = 0
launches_bwd_by_form = dict.fromkeys(FORMS, 0)


def _recorded(*ts: torch.Tensor | None) -> bool:
    """Whether autograd records a call on ``ts``: grad mode is on and some
    input requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def plan_scan_chunks(B: int, T: int, C: int, *, sms: int = 132) -> tuple[int, int]:
    """``(nchunks, chunk_len)``: steps ``[0, T)`` cut into ``nchunks`` chunks
    of ``chunk_len`` (the last one cut short), as many as fill ``WAVES``
    waves of ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs and no more
    (the gated form is bound by instruction issue, and more, shorter chains
    keep more of it busy than one exactly full wave).  ``chunk_len`` is a
    multiple of ``CHUNK_ALIGN`` and no shorter than ``CHUNK_MIN``, so T = 1
    (decode) and short T run as one chunk, as does any T when the channels
    alone fill the waves."""
    chunk_blocks = max(B * -(-C // THREADS), 1)
    want = max(1, WAVES * sms * BLOCKS_PER_SM // chunk_blocks)
    chunk = -(-max(T, 1) // want)
    chunk = max(CHUNK_MIN, -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN)
    if chunk >= T:
        return 1, max(T, 1)
    return -(-T // chunk), chunk


def plan_bwd_chunks(B: int, T: int, C: int, *, sms: int = 132) -> tuple[int, int]:
    """The backward's ``(nchunks, chunk_len)``: :func:`plan_scan_chunks`'
    chunks cut to at most ``BWD_CHUNK_MAX`` steps, so that a block's 128
    channels of fp32 h over a chunk fit in 32 KB of shared memory."""
    _, chunk_len = plan_scan_chunks(B, T, C, sms=sms)
    chunk = min(chunk_len, BWD_CHUNK_MAX)
    return -(-max(T, 1) // chunk), chunk


def softplus_exact(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` with no threshold: ``F.softplus`` switches to the
    identity above 20, ``jax.nn.softplus`` does not."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_coeffs_plain(x, wr, br, wi, bi, lam) -> tuple[torch.Tensor, torch.Tensor]:
    """The gates of ``repro/models/recurrent.py::_rglru_coeffs`` -> fp32
    ``(a, b)`` of the recurrence ``h = a * h_prev + b``.  x [..., C], the
    weights [C]."""
    xf = x.float()
    r_gate = torch.sigmoid(xf * wr.float() + br.float())
    i_gate = torch.sigmoid(xf * wi.float() + bi.float())
    # log a_base = -softplus(-lam)  (= log sigmoid(lam), stable)
    log_a_base = -softplus_exact(-lam.float())
    log_a = LRU_C * r_gate * log_a_base
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6, 1.0)) * (i_gate * xf)
    return a, b


def rglru_plain(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over dim 1 with an fp32 carry, in the
    Pallas kernel's order (``repro/kernels/rglru/kernel.py``); ``h_{-1}`` is
    ``h0`` or 0.  a, b [B, T, C] -> h [B, T, C] in ``a.dtype``."""
    h = (torch.zeros(a.shape[0], a.shape[2], dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(a.dtype)
    return out


def _chunks(a: torch.Tensor, b: torch.Tensor, nchunks: int, chunk_len: int):
    """fp32 a, b [B, T, C] padded past T (a = 1, b = 0 leave a carry as it
    is) and cut to [B, nchunks, chunk_len, C]."""
    bsz, t, c = a.shape
    if nchunks < 1 or chunk_len < 1 or not (nchunks - 1) * chunk_len < t <= nchunks * chunk_len:
        raise ValueError(f"rglru: {nchunks} chunks of {chunk_len} steps do not cut T = {t}")
    pad = nchunks * chunk_len - t
    af = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    return (af.reshape(bsz, nchunks, chunk_len, c), bf.reshape(bsz, nchunks, chunk_len, c))


def rglru_chunk_starts_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None,
                             *, nchunks: int, chunk_len: int) -> torch.Tensor:
    """The kernel's pass 1 and its fold, in its order: each chunk's
    ``(prod a, h from 0)``, then ``h0`` (or 0) and the earlier chunks'
    summaries folded into the h entering each chunk -> fp32
    [B, nchunks, C], the chunk starts the forward hands the backward."""
    af, bf = _chunks(a, b, nchunks, chunk_len)
    prod = torch.ones_like(af[:, :, 0])
    hl = torch.zeros_like(prod)
    for s in range(chunk_len):            # pass 1, all chunks at once
        prod = prod * af[:, :, s]
        hl = af[:, :, s] * hl + bf[:, :, s]
    carry = torch.zeros_like(prod[:, 0]) if h0 is None else h0.float()
    carries = []
    for k in range(nchunks):              # the fold: chunk k starts from carries[k]
        carries.append(carry)
        carry = prod[:, k] * carry + hl[:, k]
    return torch.stack(carries, dim=1)


def rglru_chunked_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None,
                        *, nchunks: int, chunk_len: int) -> torch.Tensor:
    """The kernel's two passes over ``nchunks`` chunks of ``chunk_len``
    steps, in its order: :func:`rglru_chunk_starts_plain` gives each
    chunk's carry, then pass 2 rescans each chunk from it.  Same result as
    :func:`rglru_plain` up to the fold's rounding."""
    bsz, t, c = a.shape
    h = rglru_chunk_starts_plain(a, b, h0, nchunks=nchunks, chunk_len=chunk_len)
    af, bf = _chunks(a, b, nchunks, chunk_len)
    out = torch.empty_like(af)
    for s in range(chunk_len):            # pass 2
        h = af[:, :, s] * h + bf[:, :, s]
        out[:, :, s] = h
    return out.reshape(bsz, nchunks * chunk_len, c)[:, :t].to(a.dtype)


def rglru_gated_plain(x, wr, br, wi, bi, lam, h0=None, *, state_out=None):
    """:func:`rglru_coeffs_plain`, then :func:`rglru_plain` from ``h0`` (or
    0), then h cast to ``x.dtype``.  Returns ``(h, h_last)`` with the fp32
    last state ``h[:, -1]`` written into ``state_out`` when given (which may
    be ``h0``: it is read first), else into a new tensor."""
    a, b = rglru_coeffs_plain(x, wr, br, wi, bi, lam)
    hs = rglru_plain(a, b, h0)
    if state_out is None:
        state_out = torch.empty(hs.shape[0], hs.shape[2], dtype=torch.float32,
                                device=hs.device)
    state_out.copy_(hs[:, -1])
    return hs.to(x.dtype), state_out


def _reverse_scan_plain(a: torch.Tensor, b: torch.Tensor, dh: torch.Tensor, *,
                        nchunks: int, chunk_len: int, h_starts: torch.Tensor | None = None):
    """The backward kernel's scan passes on fp32 a, b, dh [B, T, C] from
    h = 0, in its order -> fp32 ``(g, h_prev)``: g_t = dh_t + a_{t+1} g_{t+1}
    (0 past T) and h_{t-1} recomputed.  Pass 1 gives each chunk (prod a,
    h from 0, Q = sum_t dh_t prod_{s <= t} a_s); the later chunks' (prod, Q)
    fold into the gradient flowing in from behind in reverse order; each
    chunk's starting h is ``h_starts`` (the forward's hand-over, fp32
    [B, nchunks, C]) or, without it, the earlier chunks' (prod, h) folded in
    chunk order; pass 2 walks each chunk backward for g and forward for
    h_prev."""
    bsz, t, c = a.shape
    if nchunks < 1 or chunk_len < 1 or not (nchunks - 1) * chunk_len < t <= nchunks * chunk_len:
        raise ValueError(f"rglru backward: {nchunks} chunks of {chunk_len} steps do not cut "
                         f"T = {t}")
    pad = nchunks * chunk_len - t   # a = 1, b = 0, dh = 0 past T change nothing
    shape = (bsz, nchunks, chunk_len, c)
    af = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0).reshape(shape)
    bf = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(shape)
    df = torch.nn.functional.pad(dh, (0, 0, 0, pad)).reshape(shape)
    prod = torch.ones(bsz, nchunks, c, dtype=torch.float32, device=a.device)
    hl, q_sum = torch.zeros_like(prod), torch.zeros_like(prod)
    for s in range(chunk_len):            # pass 1, all chunks at once
        prod = prod * af[:, :, s]
        hl = af[:, :, s] * hl + bf[:, :, s]
        q_sum = q_sum + df[:, :, s] * prod
    h, q = torch.zeros_like(prod[:, 0]), torch.zeros_like(prod[:, 0])
    h_in, q_in = [], [None] * nchunks
    for k in range(nchunks):              # the folds
        h_in.append(h)
        h = prod[:, k] * h + hl[:, k]
        j = nchunks - 1 - k
        q_in[j] = q
        q = prod[:, j] * q + q_sum[:, j]
    h = torch.stack(h_in, dim=1) if h_starts is None else h_starts.float()
    q = torch.stack(q_in, dim=1)
    h_prev, g = torch.empty_like(af), torch.empty_like(af)
    for s in range(chunk_len):            # pass 2: forward walk
        h_prev[:, :, s] = h
        h = af[:, :, s] * h + bf[:, :, s]
    for s in reversed(range(chunk_len)):  # backward walk
        g[:, :, s] = df[:, :, s] + q
        q = af[:, :, s] * g[:, :, s]
    cut = lambda u: u.reshape(bsz, nchunks * chunk_len, c)[:, :t]  # noqa: E731
    return cut(g), cut(h_prev)


def rglru_bwd_plain(a: torch.Tensor, b: torch.Tensor, dh: torch.Tensor, *, nchunks: int,
                    chunk_len: int, h_starts: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_plain` from h = 0 at ``dh`` (the
    cotangent of h), in the backward kernel's passes, from the forward's
    chunk starts ``h_starts`` when given:
    ``(da, db) = (g h_prev, g)`` in a's dtype."""
    g, h_prev = _reverse_scan_plain(a.float(), b.float(), dh.float(), nchunks=nchunks,
                                    chunk_len=chunk_len, h_starts=h_starts)
    return (g * h_prev).to(a.dtype), g.to(a.dtype)


def _gated_gates_plain(x, wr, br, wi, bi, lam):
    """The gates in the kernels' arithmetic (``csrc/rglru.cuh``: exp(2 log_a)
    as a a) -> fp32 ``(xf, r, i, L, a, e2, s, m, u)`` with L = log a_base,
    s = 1 - a^2, m = sqrt(clip(s, 1e-6, 1)), u = i x; b = m u."""
    xf = x.float()
    r = torch.sigmoid(xf * wr.float() + br.float())
    i = torch.sigmoid(xf * wi.float() + bi.float())
    log_a_base = -softplus_exact(-lam.float())
    a = torch.exp(LRU_C * r * log_a_base)
    e2 = a * a
    s = 1.0 - e2
    return xf, r, i, log_a_base, a, e2, s, torch.sqrt(torch.clamp(s, 1e-6, 1.0)), i * xf


def rglru_gated_starts_plain(x, wr, br, wi, bi, lam, *, nchunks: int, chunk_len: int):
    """The chunk starts the gated forward kernel hands its backward (from
    h = 0), in the kernels' arithmetic -> fp32 [B, nchunks, C]."""
    *_, a, _, _, m, u = _gated_gates_plain(x, wr, br, wi, bi, lam)
    return rglru_chunk_starts_plain(a, m * u, nchunks=nchunks, chunk_len=chunk_len)


def rglru_gated_bwd_plain(x, wr, br, wi, bi, lam, dh, *, nchunks: int, chunk_len: int,
                          h_starts: torch.Tensor | None = None):
    """The gradient of :func:`rglru_gated_plain`'s h (from h = 0) at ``dh``,
    in the backward kernel's passes and arithmetic, from the forward's
    chunk starts ``h_starts`` when given: the scan's g and the
    recomputed h_prev, then per element in fp32, with s = 1 - a^2 and
    m = sqrt(clip(s, 1e-6, 1)),
    ``d log_a = g h_prev a - [1e-6 < s < 1] a^2 g i x / m`` (the clip's
    gradient is 0 where it binds), ``d pre_r = d log_a 8 L r (1 - r)``,
    ``d pre_i = g m x i (1 - i)``,
    ``dx = d pre_r wr + d pre_i wi + g m i``; the weights' gradients sum
    over batch and time, ``dlam = sigmoid(-lam) 8 sum(d log_a r)``.
    Returns ``(dx, dwr, dbr, dwi, dbi, dlam)`` in the inputs' dtypes."""
    xf, r, i, log_a_base, a, e2, s, m, u = _gated_gates_plain(x, wr, br, wi, bi, lam)
    wrf, wif, lamf = wr.float(), wi.float(), lam.float()
    g, h_prev = _reverse_scan_plain(a, m * u, dh.float(), nchunks=nchunks, chunk_len=chunk_len,
                                    h_starts=h_starts)
    binds = (s > 1e-6) & (s < 1.0)
    dlog_a = g * h_prev * a - torch.where(binds, e2 * g * u / m, torch.zeros_like(g))
    dpre_r = dlog_a * LRU_C * log_a_base * (r * (1.0 - r))
    du = g * m
    dpre_i = du * xf * (i * (1.0 - i))
    dx = dpre_r * wrf + dpre_i * wif + du * i
    sums = [v.sum(dim=(0, 1)) for v in (dpre_r * xf, dpre_r, dpre_i * xf, dpre_i, dlog_a * r)]
    sums[4] = torch.sigmoid(-lamf) * (LRU_C * sums[4])
    return (dx.to(x.dtype), *(v.to(wr.dtype) for v in sums))


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None) -> None:
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru: want a, b [B, T, C] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru takes one of {_DTYPES} for a and b; got {a.dtype}, {b.dtype}")
    _check_state("h0", h0, a)
    if not (a.device == b.device and (h0 is None or h0.device == a.device)):
        raise ValueError("rglru: a, b and h0 on different devices")


def _check_state(name: str, s: torch.Tensor | None, x: torch.Tensor) -> None:
    if s is None:
        return
    if s.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"rglru: {name} {tuple(s.shape)} is not [B, C] = "
                         f"{(x.shape[0], x.shape[2])}")
    if s.dtype != torch.float32:
        raise TypeError(f"rglru: {name} must be float32, got {s.dtype}")


def _check_gated(x, ws, h0, state_out) -> None:
    if x.dim() != 3 or x.shape[1] < 1:
        raise ValueError(f"rglru_gated: want x [B, T >= 1, C]; got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rglru_gated takes one of {_DTYPES} for x; got {x.dtype}")
    if any(w.shape != (x.shape[2],) for w in ws):
        raise ValueError(f"rglru_gated: the gate weights must be [C] = [{x.shape[2]}]; got "
                         f"{[tuple(w.shape) for w in ws]}")
    if ws[0].dtype not in _DTYPES or any(w.dtype != ws[0].dtype for w in ws):
        raise TypeError(f"rglru_gated: the gate weights take one of {_DTYPES}, all "
                        f"alike; got {[w.dtype for w in ws]}")
    _check_state("h0", h0, x)
    _check_state("state_out", state_out, x)
    if any(t.device != x.device for t in (*ws, h0, state_out) if t is not None):
        raise ValueError("rglru_gated: x, the weights, h0 and state_out on different devices")


def _plan(x: torch.Tensor) -> tuple[int, int]:
    """The chunk plan for ``x``'s card (for a CPU tensor, as for 132 SMs)."""
    sms = K.sm_count(x.get_device()) if x.device.type == "cuda" else 132
    return plan_scan_chunks(*x.shape, sms=sms)


def _cuda_ready(x: torch.Tensor, *ts) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"rglru: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, *ts) if t is not None):
        raise ValueError("rglru: every tensor must be contiguous")


def _summary(x: torch.Tensor, nchunks: int) -> torch.Tensor | None:
    """Pass 1's fp32 scratch [B, nchunks, C, 2] (the forward's (prod a,
    h from 0), the backward's (prod a, Q)), or None for one chunk."""
    if nchunks == 1:
        return None
    return torch.empty((x.shape[0], nchunks, x.shape[2], 2), dtype=torch.float32,
                       device=x.device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _count(form: str) -> None:
    global launches
    launches += 1
    launches_by_form[form] += 1


def _refuse_state_under_grad(what: str, h0, state_out=None) -> None:
    if h0 is not None or state_out is not None:
        raise ValueError(f"{what}: autograd records this call, and its gradient starts "
                         "from h = 0 as the reference's rglru_scan does; h0 and state_out "
                         "are for calls it does not record (serving, torch.no_grad)")


def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """The RG-LRU recurrence over a sequence, any T and C.  With ``h0=None``
    it is the Pallas kernel's function; with T = 1 and the cached state as
    ``h0`` it is the decode step ``a * h_prev + b``.  The final state is
    ``h[:, -1]``.  A call autograd records runs as :class:`RgLruFn` (no
    ``h0``)."""
    _check(a, b, h0)
    if _recorded(a, b, h0):
        _refuse_state_under_grad("rglru", h0)
        return RgLruFn.apply(a, b)
    return _rglru_fwd(a, b, h0)


def _starts(x: torch.Tensor, nchunks: int) -> torch.Tensor:
    """The chunk starts the forward hands the backward: fp32 [B, nchunks, C]."""
    return torch.empty((x.shape[0], nchunks, x.shape[2]), dtype=torch.float32, device=x.device)


def _rglru_fwd(a, b, h0, plan=None, starts=None):
    """The ``(a, b)`` form over ``plan`` (default :func:`plan_scan_chunks`'),
    writing the chunk starts into ``starts`` when given."""
    if a.device.type == "cpu":
        if starts is not None:
            starts.copy_(rglru_chunk_starts_plain(a, b, h0, nchunks=plan[0], chunk_len=plan[1]))
        return rglru_plain(a, b, h0)
    _cuda_ready(a, b, h0)
    bsz, t, c = a.shape
    nchunks, chunk_len = _plan(a) if plan is None else plan
    summary = _summary(a, nchunks)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    err = K.library().rglru_launch(
        a.data_ptr(), b.data_ptr(), _ptr(h0), h.data_ptr(), None, _ptr(starts), _ptr(summary),
        bsz, t, c, nchunks, chunk_len, int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    K.check(err, "rglru")
    _count("ab")
    if K.LISTENERS:
        K.report("rglru", K.tensor_bytes(a, b, h0, h, starts))
    return h


def rglru_with_starts(a: torch.Tensor, b: torch.Tensor, *, plan: tuple[int, int]):
    """:func:`rglru` from h = 0 over ``plan = (nchunks, chunk_len)`` (the
    backward's, :func:`plan_bwd_chunks`), also returning the h entering
    each chunk, fp32 [B, nchunks, C], for :func:`rglru_bwd`: ``(h,
    starts)``.  Not recorded by autograd (:class:`RgLruFn` calls it)."""
    _check(a, b, None)
    _check_plan("rglru", a, plan, cap=None)
    starts = _starts(a, plan[0])
    return _rglru_fwd(a, b, None, plan, starts), starts


def rglru_gated(x, wr, br, wi, bi, lam, h0=None, *, state_out=None, shapes_only=False):
    """The griffin block's RG-LRU from ``x`` [B, T, C] (T >= 1) and the
    per-channel weights ``wr, br, wi, bi, lam`` [C]: the gates of
    :func:`rglru_coeffs_plain`, then the recurrence from ``h0`` (fp32
    [B, C], or 0).  Returns ``(h, h_last)``: h [B, T, C] in ``x.dtype``, and
    the fp32 last state written into ``state_out`` when given, else into a
    new tensor.  ``state_out`` may be ``h0`` (the decode step's in-place
    update) only when the plan runs one chunk, as it does at T = 1.
    ``shapes_only`` (a trace of shapes on fake tensors) writes nothing: h,
    the last state and the chunk starts are left as allocated."""
    ws = (wr, br, wi, bi, lam)
    _check_gated(x, ws, h0, state_out)
    if _recorded(x, *ws, h0):
        _refuse_state_under_grad("rglru_gated", h0, state_out)
        return RgLruGatedFn.apply(x, *ws, shapes_only)
    return _rglru_gated_fwd(x, ws, h0, state_out, shapes_only=shapes_only)


def _rglru_gated_fwd(x, ws, h0, state_out, plan=None, starts=None, shapes_only=False):
    """The gated form over ``plan`` (default :func:`plan_scan_chunks`'),
    writing the chunk starts into ``starts`` when given (from h = 0)."""
    nchunks, chunk_len = _plan(x) if plan is None else plan
    if (nchunks > 1 and h0 is not None and state_out is not None
            and h0.untyped_storage().data_ptr() == state_out.untyped_storage().data_ptr()):
        raise ValueError(f"rglru_gated: h0 and state_out share memory, which only a "
                         f"one-chunk plan may update in place; T = {x.shape[1]} takes "
                         f"{nchunks} chunks")
    if shapes_only:
        return torch.empty_like(x), (torch.empty((x.shape[0], x.shape[2]), dtype=torch.float32,
                                                 device=x.device)
                                     if state_out is None else state_out)
    if x.device.type == "cpu":
        if starts is not None:
            starts.copy_(rglru_gated_starts_plain(x, *ws, nchunks=nchunks, chunk_len=chunk_len))
        return rglru_gated_plain(x, *ws, h0, state_out=state_out)
    _cuda_ready(x, *ws, h0, state_out)
    bsz, t, c = x.shape
    summary = _summary(x, nchunks)
    h = torch.empty_like(x)
    if state_out is None:
        state_out = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return h, state_out
    err = K.library().rglru_gated_launch(
        x.data_ptr(), *(w.data_ptr() for w in ws), _ptr(h0), h.data_ptr(),
        state_out.data_ptr(), _ptr(starts), _ptr(summary), bsz, t, c, nchunks, chunk_len,
        int(x.dtype == torch.bfloat16), int(ws[0].dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    K.check(err, "rglru_gated")
    _count("gated")
    if K.LISTENERS:
        K.report("rglru", K.tensor_bytes(x, *ws, h0, h, state_out, starts))
    return h, state_out


def rglru_gated_with_starts(x, wr, br, wi, bi, lam, *, plan: tuple[int, int],
                            shapes_only: bool = False):
    """:func:`rglru_gated` from h = 0 over ``plan = (nchunks, chunk_len)``
    (the backward's, :func:`plan_bwd_chunks`), also returning the h
    entering each chunk, fp32 [B, nchunks, C], for :func:`rglru_gated_bwd`:
    ``(h, h_last, starts)``.  The kernel writes the starts from its own
    fold; the CPU takes :func:`rglru_gated_starts_plain`.  Not recorded by
    autograd (:class:`RgLruGatedFn` calls it)."""
    ws = (wr, br, wi, bi, lam)
    _check_gated(x, ws, None, None)
    _check_plan("rglru_gated", x, plan, cap=None)
    starts = _starts(x, plan[0])
    h, h_last = _rglru_gated_fwd(x, ws, None, None, plan, starts, shapes_only=shapes_only)
    return h, h_last, starts


def _bwd_plan(x: torch.Tensor) -> tuple[int, int]:
    sms = K.sm_count(x.get_device()) if x.device.type == "cuda" else 132
    return plan_bwd_chunks(*x.shape, sms=sms)


def _check_plan(what: str, x: torch.Tensor, plan, cap: int | None) -> tuple[int, int]:
    nchunks, chunk_len = plan
    t = x.shape[1]
    if not (1 <= chunk_len <= (cap or chunk_len) and (nchunks - 1) * chunk_len < t
            <= nchunks * chunk_len):
        raise ValueError(f"{what}: {nchunks} chunks of {chunk_len} steps do not cut T = {t}"
                         + (f" (at most {cap} steps a chunk)" if cap else ""))
    return nchunks, chunk_len


def _check_bwd(what: str, x: torch.Tensor, dh: torch.Tensor, plan, h_starts) -> tuple[int, int]:
    if dh.shape != x.shape or dh.dtype != x.dtype or dh.device != x.device:
        raise ValueError(f"{what}: dh {dh.dtype} {tuple(dh.shape)} must match "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    nchunks, chunk_len = _check_plan(what, x, plan if plan is not None else _bwd_plan(x),
                                     cap=BWD_CHUNK_MAX)
    if h_starts is not None and (h_starts.shape != (x.shape[0], nchunks, x.shape[2])
                                 or h_starts.dtype != torch.float32
                                 or h_starts.device != x.device):
        raise ValueError(f"{what}: h_starts {h_starts.dtype} {tuple(h_starts.shape)} is not "
                         f"fp32 [B, nchunks, C] = {(x.shape[0], nchunks, x.shape[2])} on "
                         f"{x.device}")
    if h_starts is None and nchunks > 1 and x.device.type == "cuda":
        raise ValueError(f"{what}: {nchunks} chunks need the forward's chunk starts "
                         "(h_starts, from rglru_with_starts / rglru_gated_with_starts)")
    return nchunks, chunk_len


def _count_bwd(form: str) -> None:
    global launches_bwd
    launches_bwd += 1
    launches_bwd_by_form[form] += 1


def rglru_bwd(a: torch.Tensor, b: torch.Tensor, dh: torch.Tensor, *,
              plan: tuple[int, int] | None = None, h_starts: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(da, db)``: the gradient of :func:`rglru` (from h = 0) at ``dh``,
    over ``plan = (nchunks, chunk_len)`` (default :func:`plan_bwd_chunks`),
    from the chunk starts of :func:`rglru_with_starts` on that plan (which
    CUDA needs for more than one chunk).  CUDA: the kernel; CPU:
    :func:`rglru_bwd_plain`."""
    _check(a, b, None)
    nchunks, chunk_len = _check_bwd("rglru_bwd", a, dh, plan, h_starts)
    if a.device.type == "cpu":
        return rglru_bwd_plain(a, b, dh, nchunks=nchunks, chunk_len=chunk_len,
                               h_starts=h_starts)
    _cuda_ready(a, b, dh, h_starts)
    da, db = torch.empty_like(a), torch.empty_like(b)
    summary = _summary(a, nchunks)
    err = K.library().rglru_bwd_launch(
        a.data_ptr(), b.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
        _ptr(h_starts), _ptr(summary), *a.shape, nchunks, chunk_len,
        int(a.dtype == torch.bfloat16), torch.cuda.current_stream(a.device).cuda_stream)
    K.check(err, "rglru_bwd")
    _count_bwd("ab")
    if K.LISTENERS:
        K.report("rglru_bwd", K.tensor_bytes(a, b, dh, da, db, h_starts))
    return da, db


def rglru_gated_bwd(x, wr, br, wi, bi, lam, dh, *, plan: tuple[int, int] | None = None,
                    h_starts: torch.Tensor | None = None):
    """``(dx, dwr, dbr, dwi, dbi, dlam)``: the gradient of
    :func:`rglru_gated`'s h (from h = 0) at ``dh``, over ``plan =
    (nchunks, chunk_len)`` (default :func:`plan_bwd_chunks`), from the chunk
    starts of :func:`rglru_gated_with_starts` on that plan (which CUDA needs
    for more than one chunk).  CUDA: the kernel's three launches, counted as
    one call; CPU: :func:`rglru_gated_bwd_plain`."""
    ws = (wr, br, wi, bi, lam)
    _check_gated(x, ws, None, None)
    nchunks, chunk_len = _check_bwd("rglru_gated_bwd", x, dh, plan, h_starts)
    if x.device.type == "cpu":
        return rglru_gated_bwd_plain(x, *ws, dh, nchunks=nchunks, chunk_len=chunk_len,
                                     h_starts=h_starts)
    _cuda_ready(x, *ws, dh, h_starts)
    bsz, t, c = x.shape
    dx = torch.empty_like(x)
    dws = [torch.empty_like(w) for w in ws]
    partials = torch.empty((5, bsz * nchunks, c), dtype=torch.float32, device=x.device)
    summary = _summary(x, nchunks)
    err = K.library().rglru_gated_bwd_launch(
        x.data_ptr(), *(w.data_ptr() for w in ws), dh.data_ptr(), dx.data_ptr(),
        partials.data_ptr(), _ptr(h_starts), _ptr(summary), *(w.data_ptr() for w in dws), bsz,
        t, c, nchunks, chunk_len, int(x.dtype == torch.bfloat16),
        int(wr.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    K.check(err, "rglru_gated_bwd")
    _count_bwd("gated")
    if K.LISTENERS:
        K.report("rglru_bwd", K.tensor_bytes(x, *ws, dh, dx, *dws, h_starts))
    return (dx, *dws)


class RgLruFn(torch.autograd.Function):
    """:func:`rglru` from h = 0 with its hand-written gradient
    (:func:`rglru_bwd`).  The forward runs on the backward's plan and saves
    a, b and the chunk starts; the backward recomputes h from them."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.plan = _bwd_plan(a)
        h, starts = rglru_with_starts(a, b, plan=ctx.plan)
        ctx.save_for_backward(a, b, starts)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, b, starts = ctx.saved_tensors
        return rglru_bwd(a, b, dh.contiguous(), plan=ctx.plan, h_starts=starts)


class RgLruGatedFn(torch.autograd.Function):
    """:func:`rglru_gated` from h = 0 with its hand-written gradient
    (:func:`rglru_gated_bwd`): returns ``(h, h_last)``, ``h_last`` marked
    non-differentiable.  The forward runs on the backward's plan and saves
    x, the weights and the chunk starts; the backward recomputes the gates
    and h from them."""

    @staticmethod
    def forward(ctx, x, wr, br, wi, bi, lam, shapes_only=False):
        ctx.plan = _bwd_plan(x)
        h, h_last, starts = rglru_gated_with_starts(x, wr, br, wi, bi, lam, plan=ctx.plan,
                                                    shapes_only=shapes_only)
        ctx.save_for_backward(x, wr, br, wi, bi, lam, starts)
        ctx.mark_non_differentiable(h_last)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, _dh_last):
        *saved, starts = ctx.saved_tensors
        return (*rglru_gated_bwd(*saved, dh.contiguous(), plan=ctx.plan, h_starts=starts),
                None)
