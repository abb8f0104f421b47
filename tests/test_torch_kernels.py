"""The port's kernel modules on the CPU: each plain PyTorch version against
the Pallas kernel it replaces (interpret mode) and the jnp layer function
of the JAX package, plus the wrappers' input checks.  The CUDA kernels
themselves run only on the card (``gpu`` marker; ``chip_smoke.py`` holds
them against the plain versions at the serve path's shapes)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_gqa  # noqa: E402
from repro.kernels.rglru import rglru_ref, rglru_scan  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_nd  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.flash_attention import attention_plain, flash_attention  # noqa: E402
from repro_torch.kernels.rglru import rglru, rglru_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rms_norm_plain, rmsnorm  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):  # tests/test_kernels.py's tolerances
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=2e-5, atol=2e-5)


def _pair(arr, name):
    """The same numpy values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (4, 16, 256), (2, 8, 8, 512), (4, 16, 2048)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rmsnorm_plain_matches_pallas_and_layer(shape, dt):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=shape), dt)
    s = rng.normal(size=shape[-1]) * 0.2
    sj, st = jnp.asarray(s, jnp.float32), torch.from_numpy(s.astype(np.float32))
    got = rms_norm_plain(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(rmsnorm_nd(xj, sj, interpret=True)), **_tol(dt))
    np.testing.assert_allclose(_np(got), _np(JL.rms_norm(xj, sj)), **_tol(dt))
    assert torch.equal(TL.rms_norm(xt, st), got)  # CPU tensor -> plain version


def test_rmsnorm_bf16_scale_on_path():
    """On the serve path the scale comes out of the bf16 gathered buffer."""
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(4, 16, 2048)), "bf16")
    sj, st = _pair(rng.normal(size=2048) * 0.2, "bf16")
    np.testing.assert_allclose(_np(rms_norm_plain(xt, st)), _np(JL.rms_norm(xj, sj)),
                               **_tol("bf16"))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(b, tq, tk, hkv, g, dh, dt, seed=0):
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(b, tq, hkv, g, dh)), dt)
    k = _pair(rng.normal(size=(b, tk, hkv, dh)), dt)
    v = _pair(rng.normal(size=(b, tk, hkv, dh)), dt)
    return q, k, v


@pytest.mark.parametrize("g,hkv", [(2, 2), (4, 1), (1, 4), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attention_plain_matches_pallas(g, hkv, causal, window, dt):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 128, 128, hkv, g, 32, dt)
    got = attention_plain(qt, kt, vt, causal=causal, window=window)
    want = flash_attention_gqa(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attention_plain_ragged_matches_layer(causal, window, dt):
    """T = 100: no multiple of any Pallas block, so only the layer function."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 100, 100, 2, 4, 64, dt, seed=1)
    got = attention_plain(qt, kt, vt, causal=causal, window=window)
    want = JL.attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))
    assert torch.equal(TL.attention(qt, kt, vt, causal=causal, window=window), got)


@pytest.mark.parametrize("kv_valid_len", [1, 17, 40])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attention_plain_decode_matches_layer(kv_valid_len, dt):
    """tq = 1 over a 40-entry cache, as blocks.self_attention's decode."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 1, 40, 2, 4, 16, dt, seed=2)
    pos = kv_valid_len - 1
    got = attention_plain(qt, kt, vt, causal=False, q_offset=pos, kv_valid_len=kv_valid_len)
    want = JL.attention(qj, kj, vj, causal=False, q_offset=pos, kv_valid_len=kv_valid_len)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attention_plain_offset_chunk_matches_layer(dt):
    """A causal chunk of 7 queries at absolute position 33 over 40 keys."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 7, 40, 2, 3, 64, dt, seed=3)
    kw = dict(causal=True, window=0, q_offset=33, kv_valid_len=40)
    np.testing.assert_allclose(_np(attention_plain(qt, kt, vt, **kw)),
                               _np(JL.attention(qj, kj, vj, **kw)), **_tol(dt))


# attention at recurrentgemma's shape: head_dim 256, MQA (1 KV head, g = 10)

def test_attention_plain_dh256_mqa_matches_pallas():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 128, 128, 1, 10, 256, "fp32", seed=4)
    got = attention_plain(qt, kt, vt, causal=True, window=64)
    want = flash_attention_gqa(qj, kj, vj, causal=True, window=64,
                               block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("fp32"))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attention_plain_dh256_window_matches_layer(dt):
    """T = 160 past a window of 64, as griffin's local attention."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 160, 160, 1, 10, 256, dt, seed=5)
    got = attention_plain(qt, kt, vt, causal=True, window=64)
    np.testing.assert_allclose(_np(got), _np(JL.attention(qj, kj, vj, causal=True, window=64)),
                               **_tol(dt))
    assert torch.equal(TL.attention(qt, kt, vt, causal=True, window=64), got)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def _rglru_tol(name):  # tests/test_kernels.py's test_rglru tolerances
    return dict(rtol=5e-2, atol=5e-2) if name == "bf16" else dict(rtol=1e-5, atol=1e-5)


def _ab(shape, dt, seed=0):
    """a in (0.7, 0.999) and b ~ 0.1 N(0, 1), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    return _pair(rng.uniform(0.7, 0.999, size=shape), dt), _pair(rng.normal(size=shape) * 0.1, dt)


@pytest.mark.parametrize("shape", [(2, 128, 128), (1, 512, 256), (3, 96, 64)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rglru_plain_matches_pallas(shape, dt):
    (aj, at), (bj, bt) = _ab(shape, dt)
    got = rglru_plain(at, bt)
    assert got.dtype == at.dtype and got.shape == at.shape
    np.testing.assert_allclose(_np(got), _np(rglru_scan(aj, bj, interpret=True)),
                               **_rglru_tol(dt))
    # the associative-scan oracle reorders the products (fp32 rounding)
    ref_tol = dict(rtol=1e-4, atol=1e-6) if dt == "fp32" else _rglru_tol(dt)
    np.testing.assert_allclose(_np(got), _np(rglru_ref(aj, bj)), **ref_tol)
    assert torch.equal(rglru(at, bt), got)  # CPU tensor -> plain version


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rglru_h0_ragged_matches_loop(dt):
    """A start state h0 (fp32) at a T and C no Pallas block divides."""
    (_, at), (_, bt) = _ab((3, 100, 72), dt, seed=1)
    h0 = np.random.default_rng(2).normal(size=(3, 72)).astype(np.float32)
    a, b = _np(at), _np(bt)
    h, want = h0.copy(), np.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = rglru(at, bt, torch.from_numpy(h0))
    assert got.dtype == at.dtype
    np.testing.assert_allclose(_np(got), want, **_rglru_tol(dt))


def test_rglru_decode_form_is_rglru_step():
    """T = 1 from the cached state is recurrent.py's rglru_step, a * h + b."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.7, 0.999, size=(4, 1, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 1, 40)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32))
    assert torch.equal(rglru(a, b, h0)[:, 0], a[:, 0] * h0 + b[:, 0])


# ---------------------------------------------------------------------------
# wrapper input checks (they run before any dispatch, on any device)
# ---------------------------------------------------------------------------

def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,err", [
    ((_t(2, 8, 2, 2, 16), _t(2, 8, 2, 16), _t(2, 8, 2, 8)), ValueError),    # v shape
    ((_t(2, 8, 2, 16), _t(2, 8, 2, 16), _t(2, 8, 2, 16)), ValueError),      # q rank
    ((_t(2, 8, 2, 2, 48), _t(2, 8, 2, 48), _t(2, 8, 2, 48)), ValueError),   # head dim
    ((_t(2, 8, 2, 2, 16), _t(2, 8, 4, 16), _t(2, 8, 4, 16)), ValueError),   # kv heads
    ((_t(2, 8, 2, 2, 16, dtype=torch.float16), _t(2, 8, 2, 16, dtype=torch.float16),
      _t(2, 8, 2, 16, dtype=torch.float16)), TypeError),                    # fp16
    ((_t(2, 8, 2, 2, 16), _t(2, 8, 2, 16, dtype=torch.bfloat16),
      _t(2, 8, 2, 16, dtype=torch.bfloat16)), TypeError),                   # mixed
])
def test_flash_attention_rejects(args, err):
    with pytest.raises(err):
        flash_attention(*args)


def test_flash_attention_rejects_bad_lengths():
    q, k = _t(1, 1, 1, 1, 16), _t(1, 4, 1, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, kv_valid_len=-1)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, window=-2)


@pytest.mark.parametrize("tq,kw", [
    (1, dict(causal=False, kv_valid_len=0)),                       # empty cache
    (1, dict(causal=False, window=2, q_offset=5, kv_valid_len=4)),  # window past the cache
    (3, dict(causal=True, window=4, q_offset=5, kv_valid_len=3)),   # last row's window
])
def test_flash_attention_rejects_rows_without_keys(tq, kw):
    """A row where every key is masked has no defined softmax: the wrapper
    refuses it on every device instead of returning whatever its route gives."""
    q, k = _t(1, tq, 1, 1, 16), _t(1, 8, 1, 16)
    with pytest.raises(ValueError, match="sees no key"):
        flash_attention(q, k, k, **kw)


def test_flash_attention_accepts_row_with_one_key():
    """The edge of the check above: the last row keeps exactly one key."""
    q, k = _t(1, 1, 1, 1, 16), torch.ones(1, 8, 1, 16)
    out = flash_attention(q, k, k, causal=False, window=2, q_offset=4, kv_valid_len=4)
    assert torch.equal(out, torch.ones_like(q))


@pytest.mark.parametrize("x,s,err", [
    (_t(4, 8), _t(7), ValueError),
    (_t(4, 8), _t(4, 8), ValueError),
    (_t(4, 8, dtype=torch.float16), _t(8), TypeError),
    (torch.zeros(4, 8, dtype=torch.int32), _t(8), TypeError),
])
def test_rmsnorm_rejects(x, s, err):
    with pytest.raises(err):
        rmsnorm(x, s)


@pytest.mark.parametrize("shapes,h0,err", [
    (((2, 8, 4), (2, 8, 5)), None, ValueError),                  # b's shape
    (((2, 8), (2, 8)), None, ValueError),                        # rank
    (((2, 8, 4), (2, 8, 4)), (2, 8), ValueError),                # h0 shape
    (((2, 8, 4), (2, 8, 4)), (4,), ValueError),                  # h0 rank
])
def test_rglru_rejects_shapes(shapes, h0, err):
    a, b = (_t(*s) for s in shapes)
    with pytest.raises(err):
        rglru(a, b, None if h0 is None else _t(*h0))


@pytest.mark.parametrize("da,db,dh", [
    (torch.float16, torch.float16, None),     # fp16
    (torch.float32, torch.bfloat16, None),    # mixed
    (torch.float32, torch.float32, torch.bfloat16),  # h0 not fp32
])
def test_rglru_rejects_dtypes(da, db, dh):
    with pytest.raises(TypeError):
        rglru(_t(2, 8, 4, dtype=da), _t(2, 8, 4, dtype=db),
              None if dh is None else _t(2, 4, dtype=dh))


def test_build_refuses_outside_a_checkout(monkeypatch, tmp_path):
    """An installed copy (no src/repro_torch beside it) must not build its
    kernels into a directory shared by every checkout."""
    monkeypatch.setattr(KB, "CHECKOUT", tmp_path)
    with pytest.raises(RuntimeError, match="checkout"):
        KB.build_library()
    assert not (tmp_path / "build").exists()


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_cuda_kernels_match_plain(cuda_device, dt):
    tdt = DTYPES[dt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(64, 2048, generator=gen, device=cuda_device).to(tdt)
    s = 0.2 * torch.randn(2048, generator=gen, device=cuda_device)
    np.testing.assert_allclose(_np(rmsnorm(x, s).cpu()), _np(rms_norm_plain(x, s).cpu()),
                               **_tol(dt))
    for tq, tk, causal, q_offset, kvl in ((100, 100, True, 0, None), (1, 64, False, 40, 41)):
        q = torch.randn(2, tq, 2, 4, 64, generator=gen, device=cuda_device).to(tdt)
        k = torch.randn(2, tk, 2, 64, generator=gen, device=cuda_device).to(tdt)
        v = torch.randn(2, tk, 2, 64, generator=gen, device=cuda_device).to(tdt)
        kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kvl)
        np.testing.assert_allclose(_np(flash_attention(q, k, v, **kw).cpu()),
                                   _np(attention_plain(q, k, v, **kw).cpu()), **_tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_cuda_griffin_kernels_match_plain(cuda_device, dt):
    """RG-LRU (ragged T and C, with and without h0) and dh-256 MQA attention."""
    tdt = DTYPES[dt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a = (0.7 + 0.29 * torch.rand(3, 100, 72, generator=gen, device=cuda_device)).to(tdt)
    b = (0.1 * torch.randn(3, 100, 72, generator=gen, device=cuda_device)).to(tdt)
    h0 = torch.randn(3, 72, generator=gen, device=cuda_device)
    for h in (None, h0):
        np.testing.assert_allclose(_np(rglru(a, b, h).cpu()), _np(rglru_plain(a, b, h).cpu()),
                                   **_rglru_tol(dt))
    q = torch.randn(2, 160, 1, 10, 256, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(2, 160, 1, 256, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(2, 160, 1, 256, generator=gen, device=cuda_device).to(tdt)
    for kw in (dict(causal=True, window=64), dict(causal=False, q_offset=200, kv_valid_len=64)):
        qq = q if kw["causal"] else q[:, :1].contiguous()
        np.testing.assert_allclose(_np(flash_attention(qq, k, v, **kw).cpu()),
                                   _np(attention_plain(qq, k, v, **kw).cpu()), **_tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("want,shape,kw", [
    # mma: M-tiles that cut a position's heads; a window cutting a key tile;
    # q_offset with kv_valid_len inside a key tile
    ("mma", (2, 103, 103, 1, 10, 256), dict(causal=True)),
    ("mma", (2, 300, 300, 1, 10, 256), dict(causal=True, window=100)),
    ("mma", (2, 128, 256, 2, 4, 64), dict(causal=True, q_offset=64, kv_valid_len=150)),
    # split: kv_valid_len inside a chunk; one key; a causal window that empties chunks
    ("split", (2, 1, 544, 8, 4, 64), dict(causal=False, kv_valid_len=520)),
    ("split", (2, 1, 100, 1, 10, 256), dict(causal=False, kv_valid_len=1)),
    ("split", (2, 2, 544, 1, 8, 128), dict(causal=True, window=64, q_offset=300,
                                           kv_valid_len=302)),
    ("fma", (2, 100, 100, 2, 4, 64), dict(causal=True, window=32)),
])
def test_cuda_flash_routes_at_tile_edges(cuda_device, want, shape, kw):
    """Each route against the plain version at its tile edges, bitwise
    repeatable from call to call, and counted under its route."""
    from repro_torch.kernels.flash_attention import kernel as FA

    b, tq, tk, hkv, g, dh = shape
    dt = "fp32" if want == "fma" else "bf16"
    tdt = DTYPES[dt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(tdt)
    assert FA.route(tdt, tq * g) == want
    before = FA.launches_by_route[want]
    out = flash_attention(q, k, v, **kw)
    assert FA.launches_by_route[want] == before + 1
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    np.testing.assert_allclose(_np(out.cpu()), _np(attention_plain(q, k, v, **kw).cpu()),
                               **_tol(dt))
    if want == "split":
        kv_len = min(tk, kw.get("kv_valid_len") or tk)
        nsplit, chunk = FA.plan_decode_splits(b, hkv, kv_len)
        got = FA.decode_partials(q, k, v, nsplit=nsplit, chunk=chunk, **kw)
        ref = FA.decode_partials_plain(q, k, v, nsplit=nsplit, chunk=chunk, **kw)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **_tol(dt))


def _rglru_inputs(shape, dt, wdt, gen, dev):
    """x ~ N(0, 1) in ``dt`` and gate weights [C] in ``wdt`` at the model's
    scale: gates std 0.02 and biases 0.1, Λ with sigmoid(Λ) in (0.9, 0.999)."""
    c = shape[2]
    x = torch.randn(shape, generator=gen, device=dev).to(dt)
    u = 0.9 + 0.099 * torch.rand(c, generator=gen, device=dev)
    ws = (0.02 * torch.randn(c, generator=gen, device=dev),
          0.1 * torch.randn(c, generator=gen, device=dev),
          0.02 * torch.randn(c, generator=gen, device=dev),
          0.1 * torch.randn(c, generator=gen, device=dev),
          torch.log(u) - torch.log1p(-u))
    return x, tuple(w.to(wdt) for w in ws)


def _assert_rglru_h(got, want, dt):
    """fp32: within 1e-4 of max |h| (the gates' exp / sigmoid ulps, card
    against CPU-style math, amplified by up to 1 / (1 - a)); bf16: RGLRU_TOL."""
    got, want = _np(got.cpu()), _np(want.cpu())
    if dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **_rglru_tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dt,wdt,state", [
    ((4, 2560, 2560), "bf16", "bf16", None),       # recurrentgemma prefill
    ((4, 1, 2560), "bf16", "bf16", "aliased"),     # decode: state updated in place
    ((2, 1000, 72), "fp32", "fp32", "h0"),         # T not a multiple of chunk_len, C < block
    ((3, 1001, 2500), "bf16", "fp32", "h0"),       # C not a multiple of the block width
    ((2, 40, 200), "fp32", "bf16", None),          # T < chunk_len: one chunk
    ((1, 1, 130), "fp32", "fp32", "aliased"),
])
def test_cuda_rglru_gated_matches_plain(cuda_device, shape, dt, wdt, state):
    """The gated kernel against its plain version at the path's shapes and
    the plan's edges, bitwise repeatable, counted as the gated form."""
    from repro_torch.kernels.rglru import kernel as RG

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, ws = _rglru_inputs(shape, DTYPES[dt][1], DTYPES[wdt][1], gen, cuda_device)
    h0 = None if state is None else torch.randn(shape[0], shape[2], generator=gen,
                                                device=cuda_device)
    want, want_last = RG.rglru_gated_plain(x, *ws, h0)
    before = dict(RG.launches_by_form)
    runs = []
    for _ in range(2):
        s_in = None if h0 is None else h0.clone()
        out = s_in if state == "aliased" else None
        runs.append(RG.rglru_gated(x, *ws, s_in, state_out=out))
        if state == "aliased":
            assert runs[-1][1] is s_in
    assert RG.launches_by_form == {"ab": before["ab"], "gated": before["gated"] + 2}
    (h, h_last), (h2, h_last2) = runs
    assert h.dtype == x.dtype and torch.equal(h, h2) and torch.equal(h_last, h_last2)
    _assert_rglru_h(h, want, dt)
    _assert_rglru_h(h_last, want_last, "fp32")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dt,with_h0", [
    ((4, 2560, 2560), "fp32", False),              # the TPU kernel's function at the path shape
    ((4, 1, 2560), "fp32", True),
    ((3, 1001, 2500), "fp32", True),
    ((2, 100, 72), "bf16", False),
])
def test_cuda_rglru_ab_matches_plain(cuda_device, shape, dt, with_h0):
    """The (a, b) kernel, chunked, against the sequential plain version,
    bitwise repeatable."""
    tdt = DTYPES[dt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    a = (0.7 + 0.299 * torch.rand(shape, generator=gen, device=cuda_device)).to(tdt)
    b = (0.1 * torch.randn(shape, generator=gen, device=cuda_device)).to(tdt)
    h0 = torch.randn(shape[0], shape[2], generator=gen, device=cuda_device) if with_h0 else None
    h = rglru(a, b, h0)
    assert torch.equal(h, rglru(a, b, h0))
    np.testing.assert_allclose(_np(h.cpu()), _np(rglru_plain(a, b, h0).cpu()),
                               **_rglru_tol(dt))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dt,sdt,offset", [
    (2048, 2048, "bf16", "bf16", 0),               # llama prefill
    (4, 2560, "bf16", "bf16", 0),                  # recurrentgemma decode
    (10240, 2560, "bf16", "bf16", 0),              # recurrentgemma prefill
    (64, 2048, "fp32", "bf16", 0),
    (37, 1000, "bf16", "fp32", 0),                 # ragged d: the scalar path
    (8, 2048, "bf16", "bf16", 1),                  # unaligned slices: the scalar path
    (9, 100, "fp32", "fp32", 0),                   # a row shorter than a warp's vectors
    (4, 2048, "bf16", "bf16", 0),                  # llama decode: a row across 8 warps
    (1024, 4096, "fp32", "fp32", 0),               # rows too wide for a warp's registers
    (1024, 8192, "bf16", "bf16", 0),
])
def test_cuda_rmsnorm_matches_plain(cuda_device, n, d, dt, sdt, offset):
    """RMSNorm's warp-per-row kernel against its plain version, bitwise
    repeatable."""
    tdt, sdtype = DTYPES[dt][1], DTYPES[sdt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xb = torch.randn(n * d + offset, generator=gen, device=cuda_device).to(tdt)
    sb = (0.2 * torch.randn(d + offset, generator=gen, device=cuda_device)).to(sdtype)
    x, s = xb[offset:].view(n, d), sb[offset:]
    y = rmsnorm(x, s)
    assert torch.equal(y, rmsnorm(x, s))
    np.testing.assert_allclose(_np(y.cpu()), _np(rms_norm_plain(x, s).cpu()), **_tol(dt))


def _rel_close(got, want, rel, what):
    """max |got - want| <= rel * max |want|, on the CPU in fp32."""
    g, w = got.float().cpu(), want.float().cpu()
    err, scale = (g - w).abs().max().item(), w.abs().max().item()
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"


# The backward kernels against their plain versions: bf16 rounds dP, P and
# dS to bf16 at the same places in both, so they differ by exp2 against exp
# and the order of sums (the forward tests' 2e-2, as a fraction of the
# largest |gradient|); fp32 by the order of sums alone.
BWD_REL = {"bf16": 2e-2, "fp32": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dt,sdt,offset", [
    (8192, 2048, "bf16", "bf16", 0),               # llama train: 4 x 2048 tokens
    (64, 2048, "fp32", "bf16", 0),
    (37, 1000, "bf16", "fp32", 0),                 # ragged d: the scalar path
    (8, 2048, "bf16", "bf16", 1),                  # unaligned rows: the scalar path
    (1024, 4096, "fp32", "fp32", 0),               # 64 KB of partials: the opt-in
    (3, 2560, "bf16", "bf16", 0),                  # fewer rows than a block's warps
])
def test_cuda_rmsnorm_bwd_matches_plain(cuda_device, n, d, dt, sdt, offset):
    """RMSNorm's backward kernel against its plain version, bitwise
    repeatable (no atomics: dscale's partials fold in block order)."""
    from repro_torch.kernels.rmsnorm import rms_norm_bwd_plain, rmsnorm_bwd

    tdt, sdtype = DTYPES[dt][1], DTYPES[sdt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    xb = torch.randn(n * d + offset, generator=gen, device=cuda_device).to(tdt)
    gb = torch.randn(n * d + offset, generator=gen, device=cuda_device).to(tdt)
    s = (0.2 * torch.randn(d, generator=gen, device=cuda_device)).to(sdtype)
    x, dy = xb[offset:].view(n, d), gb[offset:].view(n, d)
    dx, ds = rmsnorm_bwd(x, s, dy)
    dx2, ds2 = rmsnorm_bwd(x, s, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    assert dx.dtype == tdt and ds.dtype == sdtype
    rdx, rds = rms_norm_bwd_plain(x, s, dy)
    _rel_close(dx, rdx, BWD_REL[dt], "dx")
    _rel_close(ds, rds, BWD_REL["bf16" if "bf16" in (dt, sdt) else "fp32"], "dscale")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kw,dt", [
    ((4, 512, 512, 8, 4, 64), dict(causal=True), "bf16"),              # llama, T 512
    ((2, 300, 300, 2, 4, 64), dict(causal=True), "bf16"),              # ragged tiles
    ((2, 256, 256, 2, 4, 64), dict(causal=True, window=64), "bf16"),
    ((2, 200, 200, 4, 1, 64), dict(causal=True), "bf16"),              # g = 1
    ((2, 128, 256, 2, 4, 64), dict(causal=True, q_offset=64, kv_valid_len=150), "bf16"),
    ((2, 3, 40, 2, 2, 64), dict(causal=True, q_offset=30), "bf16"),    # 6 rows: mma + lse
    ((2, 160, 160, 2, 4, 16), dict(causal=True), "bf16"),
    ((2, 160, 160, 2, 4, 32), dict(causal=False), "bf16"),
    ((2, 160, 160, 2, 4, 128), dict(causal=True, window=50), "bf16"),
    ((2, 200, 200, 2, 4, 64), dict(causal=True), "fp32"),
    ((2, 130, 130, 1, 3, 256), dict(causal=True, window=40), "fp32"),
    ((2, 70, 70, 2, 2, 16), dict(causal=False, kv_valid_len=50), "fp32"),
])
def test_cuda_flash_bwd_matches_plain(cuda_device, shape, kw, dt):
    """The forward's log-sum-exp and the FlashAttention-2 backward kernels
    against their plain versions, each bitwise repeatable; the forward's
    output with the log-sum-exp asked for equals the serve route's."""
    from repro_torch.kernels.flash_attention import kernel as FA

    b, tq, tk, hkv, g, dh = shape
    tdt = DTYPES[dt][1]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(b, tk, hkv, dh, generator=gen, device=cuda_device).to(tdt)
    do = torch.randn(b, tq, hkv, g, dh, generator=gen, device=cuda_device).to(tdt)
    o, lse = FA.flash_attention_fwd(q, k, v, **kw)
    ro, rlse = FA.attention_plain_lse(q, k, v, **kw)
    _rel_close(o, ro, BWD_REL[dt], "o")
    _rel_close(lse, rlse, 1e-5, "lse")
    if FA.route(tdt, tq * g) != "split":
        assert torch.equal(o, FA.flash_attention(q, k, v, **kw))
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for got, rep, ref, what in zip(grads, again, want, ("dq", "dk", "dv")):
        assert torch.equal(got, rep), f"{what}: not bitwise repeatable"
        assert got.dtype == tdt and got.shape == ref.shape
        _rel_close(got, ref, BWD_REL[dt], what)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (3, 127), (5, 129), (2, 684), (4, 4096), (3, 4, 301)])
def test_cuda_quantizer_matches_plain_bitwise(cuda_device, shape, dt):
    """The int8 quantizer's kernels (``csrc/quant.cu``) against their plain
    versions, bitwise: ragged and aligned rows, nearest and stochastic
    rounding (a host step and a device fingerprint), dequantize to fp32
    and bf16 and an exchange stage's chunk sum."""
    from repro_torch.core.quant import dither_key
    from repro_torch.kernels.quant import kernel as QK

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = (3 * torch.randn(shape, generator=gen, device=cuda_device)).to(DTYPES[dt][1])
    if shape[-1] >= 256:
        x[..., :128] = 0
    fp = torch.tensor(-5, dtype=torch.int32, device=cuda_device)
    for key in (None, dither_key(1, 2, 3, 4), dither_key(1, 2, 3, fp)):
        q, s = QK.quantize(x, key)
        qp, sp = QK.quantize_plain(x, key)
        assert torch.equal(q, qp) and torch.equal(s, sp)
        for od in (torch.float32, torch.bfloat16):
            assert torch.equal(QK.dequantize(q, s, od), QK.dequantize_plain(q, s, od))
        if len(shape) == 2 and shape[0] > 1:
            k = shape[0]
            assert torch.equal(QK.dequantize(q, s, torch.float32, chunks=k),
                               QK.dequantize_plain(q, s, torch.float32, chunks=k))
