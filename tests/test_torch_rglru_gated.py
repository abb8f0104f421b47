"""The RG-LRU with its gate math fused (``repro_torch.kernels.rglru``:
``rglru_gated`` and its plain version, the chunked scan's plan and its
two-pass mirror) and RMSNorm's plan, on the CPU.  The CUDA kernels run only
on the card (``gpu`` tests in ``tests/test_torch_kernels.py``); here the
plain versions are held against the JAX package: its ``_rglru_coeffs``
followed by the Pallas ``rglru_scan`` (interpret mode), and its
``rglru_step``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru import rglru_scan as pallas_rglru_scan  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.core.flat_param import LayoutBuilder  # noqa: E402
from repro_torch.kernels.rglru import kernel as RG  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RN  # noqa: E402

NAMES = ("wr", "br", "wi", "bi", "lam")
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: relative to max |h|: the ulps of the gates' exp / sigmoid are
# amplified by up to 1 / (1 - a) over the recurrence.  bf16: the kernel
# test's RGLRU_TOL (tests/test_kernels.py's test_rglru).
FP32_REL = 1e-4
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(arr, dt):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dt]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _weights(c, dt, seed, lru_init=False):
    """Gate weights [c] as (JAX dict, torch tuple).  Drawn with numpy at a
    spread that moves the gates; with ``lru_init`` from the port's own
    ``LayoutBuilder`` init (std 0.02 gates, zero biases, ``lru`` Λ)."""
    if lru_init:
        b = LayoutBuilder()
        for n in ("wi", "wr"):
            b.add(n, (c,), std=0.02)
        for n in ("bi", "br"):
            b.add(n, (c,), init="zeros")
        b.add("lam", (c,), init="lru")
        lay = b.build()
        flat = lay.init_flat(torch.Generator().manual_seed(seed), device="cpu")
        vals = {n: v.numpy() for n, v in lay.unflatten(flat).items()}
    else:
        rng = np.random.default_rng(seed)
        u = rng.uniform(0.9, 0.999, size=c)
        vals = {"wr": rng.normal(size=c), "br": rng.normal(size=c) * 0.5,
                "wi": rng.normal(size=c), "bi": rng.normal(size=c) * 0.5,
                "lam": np.log(u) - np.log1p(-u)}
    pairs = {n: _pair(vals[n], dt) for n in NAMES}
    return ({"rec." + n: p[0] for n, p in pairs.items()}, tuple(pairs[n][1] for n in NAMES))


def _assert_h(got, want, dt):
    if dt == "fp32":
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=FP32_REL * np.abs(want).max())
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# ---------------------------------------------------------------------------
# rglru_gated's plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,lru_init", [
    ((2, 64, 128), False),
    ((3, 100, 72), False),       # ragged T and C
    ((2, 24, 2560), True),       # full width, the port's init
])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_gated_plain_matches_jax_scan(shape, lru_init, dt):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=shape), dt)
    tj, wt = _weights(shape[2], dt, seed=1, lru_init=lru_init)
    a, b = JR._rglru_coeffs(tj, xj, "rec.")
    hj = pallas_rglru_scan(a, b, interpret=True)
    h, h_last = RG.rglru_gated_plain(xt, *wt)
    assert h.dtype == xt.dtype and h.shape == xt.shape
    assert h_last.dtype == torch.float32 and h_last.shape == (shape[0], shape[2])
    _assert_h(h, hj.astype(xj.dtype), dt)
    _assert_h(h_last, hj[:, -1], "fp32")
    assert torch.equal(RG.rglru_gated(xt, *wt)[0], h)    # CPU tensor -> plain version


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("aliased", [False, True])
def test_gated_plain_step_matches_jax_rglru_step(dt, aliased):
    """T = 1 from a cached state: the reference's ``rglru_step``; with the
    state updated in place (``state_out`` is ``h0``) as the decode does."""
    rng = np.random.default_rng(2)
    c = 96
    xj, xt = _pair(rng.normal(size=(4, c)), dt)
    h0 = rng.normal(size=(4, c)).astype(np.float32)
    tj, wt = _weights(c, dt, seed=3)
    yj, hj = JR.rglru_step(tj, xj, jnp.asarray(h0), "rec.")
    state = torch.from_numpy(h0.copy())
    out = state if aliased else torch.empty_like(state)
    y, h_last = RG.rglru_gated(xt[:, None, :], *wt, state, state_out=out)
    assert h_last is out
    _assert_h(y[:, 0], yj, dt)
    _assert_h(h_last, hj, "fp32")


def test_gated_plain_is_coeffs_then_scan():
    """The fused form is exactly the model's three steps on the CPU:
    coefficients, the sequential scan, the cast."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 30, 40)).astype(np.float32)).to(torch.bfloat16)
    _, wt = _weights(40, "bf16", seed=5)
    h0 = torch.from_numpy(rng.normal(size=(2, 40)).astype(np.float32))
    a, b = RG.rglru_coeffs_plain(x, *wt)
    hs = RG.rglru_plain(a, b, h0)
    h, h_last = RG.rglru_gated_plain(x, *wt, h0)
    assert torch.equal(h, hs.to(torch.bfloat16))
    assert torch.equal(h_last, hs[:, -1])


# ---------------------------------------------------------------------------
# the chunked scan: plan and two-pass mirror
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,nchunks,chunk_len", [
    ((2, 100, 24), 4, 32),       # last chunk cut short
    ((2, 96, 24), 3, 32),        # chunks fill T
    ((1, 50, 8), 1, 50),         # one chunk
    ((3, 257, 40), 9, 32),       # a chunk of one step at the end
    ((2, 200, 16), *RG.plan_scan_chunks(2, 200, 16)),
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_plain_matches_sequential(shape, nchunks, chunk_len, with_h0):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(0.7, 0.999, size=shape).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32))
    h0 = (torch.from_numpy(rng.normal(size=(shape[0], shape[2])).astype(np.float32))
          if with_h0 else None)
    got = RG.rglru_chunked_plain(a, b, h0, nchunks=nchunks, chunk_len=chunk_len)
    np.testing.assert_allclose(_np(got), _np(RG.rglru_plain(a, b, h0)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nchunks,chunk_len", [(2, 32), (5, 32), (3, 20)])  # short, empty last
def test_chunked_plain_refuses_plans_that_do_not_cut_t(nchunks, chunk_len):
    a = torch.ones(1, 100, 4)
    with pytest.raises(ValueError, match="do not cut"):
        RG.rglru_chunked_plain(a, a, nchunks=nchunks, chunk_len=chunk_len)


@pytest.mark.parametrize("B,T,C,sms", [
    (4, 2560, 2560, 132),        # recurrentgemma prefill
    (4, 1, 2560, 132),           # decode
    (4, 64, 2560, 132),          # short T
    (2, 100, 72, 132),
    (1, 4097, 8, 132),
    (3, 1001, 2500, 132),
    (64, 512, 8192, 132),        # B * C fills the card alone
    (4, 2560, 2560, 114),        # another SM count
])
def test_plan_scan_chunks(B, T, C, sms):
    nchunks, chunk_len = RG.plan_scan_chunks(B, T, C, sms=sms)
    assert (nchunks - 1) * chunk_len < T <= nchunks * chunk_len      # covers T exactly
    assert RG.plan_scan_chunks(B, T, C, sms=sms) == (nchunks, chunk_len)
    blocks = B * -(-C // RG.THREADS) * nchunks
    waves = RG.WAVES * sms * RG.BLOCKS_PER_SM
    if nchunks > 1:
        assert chunk_len % RG.CHUNK_ALIGN == 0 and chunk_len >= RG.CHUNK_MIN
        assert blocks <= waves                                      # no more than planned
    if T <= RG.CHUNK_MIN or 2 * B * -(-C // RG.THREADS) > waves:
        assert (nchunks, chunk_len) == (1, T)
    if (B, T, C, sms) == (4, 2560, 2560, 132):                      # the path: 36 x 72
        assert blocks > 0.9 * waves and 64 <= chunk_len <= 128


def test_gated_refuses_aliased_state_with_chunks():
    """The decode's in-place state is safe with one chunk only: with more,
    pass 2's first chunk would read h0 while its last writes state_out."""
    x = torch.zeros(1, 256, 8)
    assert RG.plan_scan_chunks(1, 256, 8)[0] > 1
    _, wt = _weights(8, "fp32", seed=7)
    state = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="share memory"):
        RG.rglru_gated(x, *wt, state, state_out=state)
    with pytest.raises(ValueError, match="share memory"):
        RG.rglru_gated(x, *wt, state[:, :8], state_out=state)       # a view of it
    RG.rglru_gated(x, *wt, state, state_out=torch.zeros(1, 8))       # not aliased
    RG.rglru_gated(x[:, :1], *wt, state, state_out=state)            # one chunk


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("x,ws,h0,err", [
    (_t(2, 0, 8), (_t(8),) * 5, None, ValueError),                       # T = 0
    (_t(2, 8), (_t(8),) * 5, None, ValueError),                          # rank
    (_t(2, 4, 8), (_t(8),) * 4 + (_t(7),), None, ValueError),            # a weight's shape
    (_t(2, 4, 8), (_t(8),) * 5, _t(2, 7), ValueError),                   # h0 shape
    (_t(2, 4, 8, dtype=torch.float16), (_t(8),) * 5, None, TypeError),   # x fp16
    (_t(2, 4, 8), (_t(8),) * 4 + (_t(8, dtype=torch.bfloat16),), None, TypeError),  # mixed
    (_t(2, 4, 8), (_t(8),) * 5, _t(2, 8, dtype=torch.bfloat16), TypeError),         # h0 bf16
])
def test_gated_rejects(x, ws, h0, err):
    with pytest.raises(err):
        RG.rglru_gated(x, *ws, h0)


def test_cpu_calls_are_not_counted():
    """The counters count kernel launches; the plain versions launch none."""
    before = (RG.launches, dict(RG.launches_by_form), RN.launches)
    _, wt = _weights(8, "fp32", seed=8)
    RG.rglru_gated(_t(1, 4, 8), *wt)
    RG.rglru(_t(1, 4, 8), _t(1, 4, 8))
    RN.rmsnorm(_t(2, 8), _t(8))
    assert (RG.launches, RG.launches_by_form, RN.launches) == before


# ---------------------------------------------------------------------------
# RMSNorm's plan
# ---------------------------------------------------------------------------

def _rows_visited(plan, n, grid):
    """The rows that the kernel's loop gives each group of ``lanes`` lanes,
    as the kernel computes them: a block's groups stepping together, the
    grid striding over the rows."""
    lanes_log2 = plan.lanes.bit_length() - 1
    threads = max(RN.THREADS, plan.lanes)
    groups = threads >> lanes_log2
    seen = []
    for blk in range(grid):
        for tid in range(0, threads, plan.lanes):          # the first lane of each group
            group = tid >> lanes_log2
            base = blk * groups
            while base < n:
                if base + group < n:
                    seen.append(base + group)
                base += grid * groups
    return seen


@pytest.mark.parametrize("n,d,dt", [
    (2048, 2048, torch.bfloat16), (4, 2048, torch.bfloat16),
    (10240, 2560, torch.bfloat16), (4, 2560, torch.bfloat16),
    (64, 2048, torch.float32), (4, 2560, torch.float32),
    (7, 1000, torch.bfloat16), (9, 100, torch.float32), (33, 1, torch.bfloat16),
    (5, 4096, torch.bfloat16), (3, 3072, torch.float32),
    (4, 16384, torch.bfloat16), (1024, 4096, torch.bfloat16), (1024, 3072, torch.float32),
    (1024, 4096, torch.float32), (1024, 8192, torch.bfloat16), (512, 24576, torch.bfloat16),
    (512, 12288, torch.float32), (4, 32768, torch.bfloat16), (4, 16384, torch.float32),
])
def test_plan_rmsnorm_covers_every_element_and_row(n, d, dt):
    plan = RN.plan_rmsnorm(n, d, dt)
    per_vec = 16 // torch.tensor([], dtype=dt).element_size()
    nvec = -(-d // per_vec)
    fits = max(v for v in RN.VECS_PER_LANE if v * (4 + per_vec) <= RN.REG_BUDGET)
    assert plan.lanes in (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert plan.lanes * plan.rows_per_block == max(RN.THREADS, plan.lanes)
    assert plan.lanes * plan.vecs_per_lane >= nvec                       # every element
    assert plan.vecs_per_lane in RN.VECS_PER_LANE
    assert plan.vecs_per_lane * (4 + per_vec) <= RN.REG_BUDGET
    if nvec >= 32 and n >= 132:     # a warp a row, more only where a warp's share won't fit
        assert plan.lanes == 32 or -(-nvec // (plan.lanes // 2)) > fits
    rows_needed = -(-n // plan.rows_per_block)
    for grid in {1, 3, min(rows_needed, 528), rows_needed}:              # every row, once
        assert sorted(_rows_visited(plan, n, grid)) == list(range(n))
    assert RN.plan_rmsnorm(n, d, dt) == plan


def test_plan_rmsnorm_path_shapes():
    """At prefill a row of the serve paths is one warp holding 8 (d 2048) or
    10 (d 2560) vectors a lane; at decode ([4, d]) a row is a block of 8
    warps holding 1 or 2."""
    assert RN.plan_rmsnorm(2048, 2048, torch.bfloat16) == (32, 8, 4)
    assert RN.plan_rmsnorm(10240, 2560, torch.bfloat16) == (32, 10, 4)
    assert RN.plan_rmsnorm(4, 2048, torch.bfloat16) == (256, 1, 1)
    assert RN.plan_rmsnorm(4, 2560, torch.bfloat16) == (256, 2, 1)


@pytest.mark.parametrize("n,d,dt", [
    (1024, 32769, torch.bfloat16), (1024, 16385, torch.float32), (1, 40000, torch.bfloat16),
    (4, 32769, torch.bfloat16), (4, 16385, torch.float32),   # past 8 warps of 16 vectors
])
def test_plan_rmsnorm_raises_past_its_d_limit(n, d, dt):
    with pytest.raises(ValueError, match="registers"):
        RN.plan_rmsnorm(n, d, dt)
