"""The RG-LRU backward on the CPU: the plain versions of the backward
kernel (``repro_torch.kernels.rglru``: ``rglru_gated_bwd_plain`` and the
``(a, b)`` form's ``rglru_bwd_plain``) against ``jax.vjp`` of the JAX
package's functions on the same numpy inputs, and the autograd Functions
(``RgLruGatedFn``, ``RgLruFn``) on the CPU against autograd through the
plain forwards; and the chunk starts the forward hands the backward
(``rglru_gated_starts_plain``, ``rglru_chunk_starts_plain``) against the
backward's own fold, bitwise.  The gated form's oracle is
``repro.models.recurrent.rglru_scan`` (its ``_rglru_coeffs`` and the
``lax.associative_scan``, which the reference's training path
differentiates); the ``(a, b)`` form's is that scan alone.  A
``pallas_call`` has no VJP, so the Pallas kernel itself is held only on its
forward (``tests/test_torch_kernels.py``).  The CUDA kernel is held to these
plain versions on the card (``tests/test_torch_bwd_routes.py``, ``gpu``;
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.models import recurrent as JR  # noqa: E402
from repro_torch.kernels.rglru import kernel as RG  # noqa: E402

NAMES = ("wr", "br", "wi", "bi", "lam")
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Max |port - JAX| as a fraction of max |JAX| over each gradient, measured
# on the CPU with this file's inputs.  fp32: the same fp32 math in other
# orders (the reverse scan's, the sums over batch and time), whose ulps the
# recurrence amplifies by up to 1 / (1 - a); measured <= 2.7e-6 (gated) and
# 1.4e-7 (``(a, b)``).  bf16: both compute in fp32 and round each gradient
# to bf16 once, so a value a few fp32 ulps apart may round to the
# neighbouring bf16 value, at most 2^-7 of it; measured <= 1.4e-4.
REL_TOL = {"fp32": 1e-5, "bf16": 1e-2}


def _pair(arr, dt):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(port, ref, dt, what):
    p = port.float().detach().numpy()
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    err, scale = float(np.abs(p - r).max()), float(np.abs(r).max())
    assert err <= REL_TOL[dt] * scale, f"{what}: max |err| {err} > {REL_TOL[dt]} x {scale}"


def _inputs(shape, dt, seed, *, clip=False):
    """x, dh [B, T, C] and the gate weights [C] as (JAX, torch) pairs.  The
    weights are drawn at a spread that moves the gates; ``clip`` puts lam
    in (17, 18), where 1 - a^2 < 1e-6 and the clip binds."""
    rng = np.random.default_rng(seed)
    c = shape[2]
    u = rng.uniform(0.9, 0.999, size=c)
    vals = {"wr": rng.normal(size=c), "br": 0.5 * rng.normal(size=c),
            "wi": rng.normal(size=c), "bi": 0.5 * rng.normal(size=c),
            "lam": rng.uniform(17.0, 18.0, size=c) if clip else np.log(u) - np.log1p(-u)}
    x = _pair(rng.normal(size=shape), dt)
    dh = _pair(rng.normal(size=shape), dt)
    return x, dh, {n: _pair(vals[n], dt) for n in NAMES}


SHAPE = (2, 150, 24)   # one shape, so JAX compiles its oracle once a dtype
CASES = {
    # id: (shape, plan (nchunks, chunk_len) or None for one chunk, clip)
    "one-chunk": (SHAPE, None, False),
    "chunks": (SHAPE, (3, 64), False),          # 150 = 64 + 64 + 22
    "chunks-of-8": (SHAPE, (19, 8), False),
    "T1": ((2, 1, 24), None, False),
    "clip-binds": (SHAPE, (3, 64), True),
}


@jax.jit
def _gated_vjp(x, t, dh):
    """``jax.vjp`` of the reference's ``rglru_scan`` at ``dh``."""
    _, vjp = jax.vjp(lambda x_, t_: JR.rglru_scan(t_, x_), x, t)
    return vjp(dh)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rglru_gated_bwd_plain_matches_jax_vjp(case, dt):
    shape, plan, clip = CASES[case]
    (xj, xt), (dj, dt_), ws = _inputs(shape, dt, seed=len(case), clip=clip)
    dxj, dtj = _gated_vjp(xj, {"rec." + n: p[0] for n, p in ws.items()}, dj)
    if clip:   # the clip binds almost everywhere: b's path gives d log_a nothing
        a, _ = RG.rglru_coeffs_plain(xt, *(ws[n][1] for n in NAMES))
        assert float((1.0 - a.double() ** 2 < 1e-6).float().mean()) > 0.9
    nchunks, chunk_len = plan or (1, shape[1])
    wts = [ws[n][1] for n in NAMES]
    # the chunk starts the gated forward hands over are, bitwise, the h the
    # backward's own fold starts each chunk from (its h_prev at the chunk's
    # first step); the backward from them is the backward without them
    starts = RG.rglru_gated_starts_plain(xt, *wts, nchunks=nchunks, chunk_len=chunk_len)
    *_, a, _, _, m, u = RG._gated_gates_plain(xt, *wts)
    _, h_prev = RG._reverse_scan_plain(a, m * u, dt_.float(), nchunks=nchunks,
                                       chunk_len=chunk_len)
    assert starts.dtype == torch.float32 and torch.equal(starts, h_prev[:, ::chunk_len])
    got = RG.rglru_gated_bwd_plain(xt, *wts, dt_, nchunks=nchunks, chunk_len=chunk_len,
                                   h_starts=starts)
    own = RG.rglru_gated_bwd_plain(xt, *wts, dt_, nchunks=nchunks, chunk_len=chunk_len)
    assert all(torch.equal(p, q) for p, q in zip(got, own))
    assert got[0].dtype == xt.dtype and got[0].shape == xt.shape
    _close(got[0], dxj, dt, "dx")
    for n, g in zip(NAMES, got[1:]):
        assert g.dtype == ws[n][1].dtype and g.shape == (shape[2],)
        _close(g, dtj["rec." + n], dt, f"d{n}")


def _combine(lhs, rhs):
    """``repro/models/recurrent.py::rglru_scan``'s combine."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


@jax.jit
def _scan_vjp(a, b, dh):
    """``jax.vjp`` of the reference's associative scan on fp32 a, b (its h
    cast to the inputs' type, as the kernel's output is) at ``dh``."""
    def scan(a_, b_):
        _, h = lax.associative_scan(_combine, (a_.astype(jnp.float32),
                                               b_.astype(jnp.float32)), axis=1)
        return h.astype(a_.dtype)

    _, vjp = jax.vjp(scan, a, b)
    return vjp(dh)


@pytest.mark.parametrize("plan", [None, (4, 16)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rglru_bwd_plain_matches_jax_vjp_of_the_scan(plan, dt):
    """The ``(a, b)`` form from h = 0: ``(da, db)`` against ``jax.vjp`` of
    the reference's associative scan."""
    rng = np.random.default_rng(5)
    shape = (2, 60, 12)
    aj, at = _pair(rng.uniform(0.7, 0.999, size=shape), dt)
    bj, bt = _pair(0.1 * rng.normal(size=shape), dt)
    dj, dt_ = _pair(rng.normal(size=shape), dt)

    daj, dbj = _scan_vjp(aj, bj, dj)
    nchunks, chunk_len = plan or (1, shape[1])
    starts = RG.rglru_chunk_starts_plain(at, bt, nchunks=nchunks, chunk_len=chunk_len)
    _, h_prev = RG._reverse_scan_plain(at.float(), bt.float(), dt_.float(), nchunks=nchunks,
                                       chunk_len=chunk_len)
    assert torch.equal(starts, h_prev[:, ::chunk_len])
    da, db = RG.rglru_bwd_plain(at, bt, dt_, nchunks=nchunks, chunk_len=chunk_len,
                                h_starts=starts)
    assert da.dtype == at.dtype and db.dtype == at.dtype
    _close(da, daj, dt, "da")
    _close(db, dbj, dt, "db")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rglru_gated_fn_matches_autograd_of_plain(dt):
    """On the CPU ``rglru_gated`` under autograd runs ``RgLruGatedFn`` (the
    plain forward, the plain backward over ``plan_bwd_chunks``' plan);
    autograd through ``rglru_gated_plain`` is the yardstick.  ``h_last``
    carries no gradient."""
    tdt = DTYPES[dt][1]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 200, 16, generator=gen).to(tdt)
    ws = [(0.5 * torch.randn(16, generator=gen)).to(tdt) for _ in range(4)]
    ws.append(torch.full((16,), 3.0).to(tdt))
    dh = torch.randn(2, 200, 16, generator=gen).to(tdt)
    plan = RG.plan_bwd_chunks(2, 200, 16)
    assert plan[0] > 1
    # the Function's forward hands its backward the chunk starts
    _, _, starts = RG.rglru_gated_with_starts(x, *ws, plan=plan)
    assert torch.equal(starts, RG.rglru_gated_starts_plain(x, *ws, nchunks=plan[0],
                                                           chunk_len=plan[1]))
    ins1 = [t.clone().requires_grad_() for t in (x, *ws)]
    RG.rglru_gated_plain(*ins1)[0].backward(dh)
    ins2 = [t.clone().requires_grad_() for t in (x, *ws)]
    h, h_last = RG.rglru_gated(*ins2)
    assert "RgLruGatedFn" in type(h.grad_fn).__name__
    assert not h_last.requires_grad
    assert torch.equal(h, RG.rglru_gated_plain(x, *ws)[0])
    h.backward(dh)
    for a, b, what in zip(ins2, ins1, ("x", *NAMES)):
        _close(a.grad, b.grad.float().numpy(), dt, f"d{what}")


def test_rglru_fn_matches_autograd_of_plain():
    gen = torch.Generator().manual_seed(4)
    a = 0.7 + 0.299 * torch.rand(2, 150, 8, generator=gen)
    b = 0.1 * torch.randn(2, 150, 8, generator=gen)
    dh = torch.randn(2, 150, 8, generator=gen)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    RG.rglru_plain(a1, b1).backward(dh)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = RG.rglru(a2, b2)
    assert "RgLruFn" in type(h.grad_fn).__name__
    h.backward(dh)
    _close(a2.grad, a1.grad.numpy(), "fp32", "da")
    _close(b2.grad, b1.grad.numpy(), "fp32", "db")


def test_recorded_calls_refuse_a_given_state():
    """The gradient starts from h = 0, as the reference's rglru_scan does:
    under autograd a given h0 or state_out raises; without it they run."""
    x = torch.zeros(1, 4, 8, requires_grad=True)
    ws = [torch.zeros(8) for _ in range(5)]
    h0 = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="h = 0"):
        RG.rglru_gated(x, *ws, h0)
    with pytest.raises(ValueError, match="h = 0"):
        RG.rglru_gated(x, *ws, state_out=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="h = 0"):
        RG.rglru(x, torch.zeros(1, 4, 8), h0)
    with torch.no_grad():
        RG.rglru_gated(x, *ws, h0, state_out=h0)
        RG.rglru(x, torch.zeros(1, 4, 8), h0)


@pytest.mark.parametrize("B,T,C,sms", [
    (2, 2048, 2560, 132),     # recurrentgemma's train shape: 32 chunks of 64
    (4, 2560, 2560, 132),     # the serve prefill's plan (72 steps) cut to 64
    (1, 256, 2560, 132), (2, 1, 2560, 132), (3, 1001, 2500, 132), (2, 50, 8, 132),
    (16, 4096, 4096, 132), (1, 100000, 128, 8),
])
def test_plan_bwd_chunks_fits_shared_memory_and_covers_t(B, T, C, sms):
    nchunks, chunk_len = RG.plan_bwd_chunks(B, T, C, sms=sms)
    fwd_chunks, fwd_len = RG.plan_scan_chunks(B, T, C, sms=sms)
    assert 1 <= chunk_len <= RG.BWD_CHUNK_MAX
    assert (nchunks - 1) * chunk_len < T <= nchunks * chunk_len
    assert chunk_len == min(fwd_len, RG.BWD_CHUNK_MAX)
    if fwd_len <= RG.BWD_CHUNK_MAX:
        assert (nchunks, chunk_len) == (fwd_chunks, fwd_len)
    if (B, T, C) == (2, 2048, 2560):
        assert (nchunks, chunk_len) == (32, 64)


def test_bwd_rejects():
    x = torch.zeros(1, 10, 8)
    ws = [torch.zeros(8) for _ in range(5)]
    with pytest.raises(ValueError, match="dh"):
        RG.rglru_gated_bwd(x, *ws, torch.zeros(1, 9, 8))
    with pytest.raises(ValueError, match="do not cut"):
        RG.rglru_gated_bwd(x, *ws, torch.zeros(1, 10, 8), plan=(1, 5))
    with pytest.raises(ValueError, match="do not cut"):
        RG.rglru_bwd(x, x, torch.zeros(1, 10, 8), plan=(1, 128))   # past BWD_CHUNK_MAX
    with pytest.raises(ValueError, match="do not cut"):
        RG.rglru_bwd_plain(x, x, x, nchunks=3, chunk_len=5)


def test_bwd_cpu_calls_are_not_counted():
    before = (RG.launches_bwd, dict(RG.launches_bwd_by_form))
    x = torch.zeros(1, 4, 8)
    RG.rglru_gated_bwd(x, *(torch.zeros(8) for _ in range(5)), x)
    RG.rglru_bwd(x, x, x)
    assert (RG.launches_bwd, RG.launches_bwd_by_form) == before
