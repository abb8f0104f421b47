"""The port's griffin recurrent block (``repro_torch.models.recurrent``)
against the JAX package's (``repro.models.recurrent``), on smoke
recurrentgemma-2b weights made by JAX and carried over, on the CPU (the
RG-LRU kernel's plain version).  fp32 throughout; port against JAX within
1e-5 (the two compute the same fp32 ops in different orders)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.flat_param import LayoutBuilder as JaxLayoutBuilder  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.flat_param import LayoutBuilder  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


@pytest.fixture(scope="module")
def layer():
    """One rec layer's tensors, drawn by JAX, as JAX arrays and torch views."""
    cfg_j = jax_smoke(jax_get_config("recurrentgemma-2b"))
    cfg_t = smoke_variant(get_config("recurrentgemma-2b"))
    bj, bt = JaxLayoutBuilder(), LayoutBuilder()
    JR.griffin_rec_layout(cfg_j, 1, bj)
    TR.griffin_rec_layout(cfg_t, 1, bt)
    lj, lt = bj.build(), bt.build()
    assert [(s.name, s.shape, s.offset, s.init, s.std) for s in lt.segments] == \
        [(s.name, s.shape, s.offset, s.init, s.std) for s in lj.segments]
    flat = lj.init_flat(jax.random.key(0))
    return cfg_j, cfg_t, lj.unflatten(flat), lt.unflatten(torch.from_numpy(np.array(flat)))


def _x(shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_rec_apply_train_matches_jax(layer):
    cfg_j, cfg_t, tj, tt = layer
    xj, xt = _x((2, 16, cfg_t.d_model))
    want, _ = JR.griffin_rec_apply(cfg_j, tj, xj, JL.Ctx(mode="train", tp=1))
    got, cache = TR.griffin_rec_apply(cfg_t, tt, xt, TL.Ctx(mode="train", tp=1))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_rec_apply_prefill_and_decode_match_jax(layer):
    """Prefill on 15 tokens, then one decode step from JAX's cache: outputs
    within 1e-5, h (fp32) within 1e-5, conv (bf16, as the reference stores
    it) within one bf16 ulp of JAX's."""
    cfg_j, cfg_t, tj, tt = layer
    xj, xt = _x((2, 16, cfg_t.d_model), seed=1)
    cj = JL.Ctx(mode="prefill", tp=1, cache_len=16)
    ct = TL.Ctx(mode="prefill", tp=1, cache_len=16, compute_dtype=torch.float32)
    want, wcache = JR.griffin_rec_apply(cfg_j, tj, xj[:, :15], cj)
    got, gcache = TR.griffin_rec_apply(cfg_t, tt, xt[:, :15], ct)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert gcache["conv"].dtype == torch.bfloat16 and gcache["h"].dtype == torch.float32
    np.testing.assert_allclose(_np(gcache["h"]), _np(wcache["h"]), **TOL)
    d = np.abs(_np(gcache["conv"]) - _np(wcache["conv"]))
    assert (d <= _bf16_ulp(_np(wcache["conv"]))).all()

    # decode from JAX's cache, written in place into the port's copy of it
    state = {"conv": torch.from_numpy(_np(wcache["conv"])).to(torch.bfloat16),
             "h": torch.from_numpy(np.array(_np(wcache["h"])))}
    conv_ptr, h_ptr = state["conv"].data_ptr(), state["h"].data_ptr()
    dj = JL.Ctx(mode="decode", tp=1, pos=jnp.int32(15), cache_len=16)
    dt = TL.Ctx(mode="decode", tp=1, pos=15, cache_len=16, compute_dtype=torch.float32)
    want1, wcache1 = JR.griffin_rec_apply(cfg_j, tj, xj[:, 15:16], dj, wcache)
    got1, gcache1 = TR.griffin_rec_apply(cfg_t, tt, xt[:, 15:16], dt, state)
    np.testing.assert_allclose(_np(got1), _np(want1), **TOL)
    assert gcache1 is state
    assert state["conv"].data_ptr() == conv_ptr and state["h"].data_ptr() == h_ptr
    np.testing.assert_allclose(_np(state["h"]), _np(wcache1["h"]), **TOL)
    d = np.abs(_np(state["conv"]) - _np(wcache1["conv"]))
    assert (d <= _bf16_ulp(_np(wcache1["conv"]))).all()


def test_rglru_decode_matches_scan(layer):
    """Prefill 15 then decode 1 equals the full sequence at position 15,
    within the port.  Tolerance 2e-2, as the reference's own test: the conv
    state carried into the decode step is stored as bf16."""
    _, cfg_t, _, tt = layer
    _, x = _x((2, 16, cfg_t.d_model), seed=2)
    full, _ = TR.griffin_rec_apply(cfg_t, tt, x, TL.Ctx(mode="train", tp=1))
    ctx_p = TL.Ctx(mode="prefill", tp=1, cache_len=16, compute_dtype=torch.float32)
    _, cache = TR.griffin_rec_apply(cfg_t, tt, x[:, :15], ctx_p)
    ctx_d = TL.Ctx(mode="decode", tp=1, pos=15, cache_len=16, compute_dtype=torch.float32)
    last, _ = TR.griffin_rec_apply(cfg_t, tt, x[:, 15:16], ctx_d, cache)
    np.testing.assert_allclose(_np(last[:, 0]), _np(full[:, 15]), rtol=2e-2, atol=2e-2)


def test_causal_conv_state_handoff():
    """Conv over 12 steps equals conv over 8, then 4 from the 8's state; and
    both equal the reference's."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    x = rng.normal(size=(1, 12, 8)).astype(np.float32)
    wt, bt, xt = map(torch.from_numpy, (w, bias, x))
    full, _ = TR._causal_conv1d(xt, wt, bt)
    y1, st = TR._causal_conv1d(xt[:, :8], wt, bt)
    y2, st2 = TR._causal_conv1d(xt[:, 8:], wt, bt, st)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(full), rtol=1e-6, atol=1e-6)
    assert torch.equal(st2, xt[:, -3:])
    want, _ = JR._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(_np(full), _np(want), **TOL)


def test_rglru_coeffs_match_jax_at_large_lambda():
    """Gate math in fp32, with Λ past F.softplus's threshold of 20, where an
    identity shortcut would differ from jax.nn.softplus."""
    rng = np.random.default_rng(4)
    c = 16
    t = {"wr": rng.normal(size=c), "br": rng.normal(size=c), "wi": rng.normal(size=c),
         "bi": rng.normal(size=c), "lam": np.linspace(-30.0, 30.0, c)}
    t = {"rec." + k: v.astype(np.float32) for k, v in t.items()}
    x = rng.normal(size=(2, 5, c)).astype(np.float32)
    aj, bj = JR._rglru_coeffs({k: jnp.asarray(v) for k, v in t.items()}, jnp.asarray(x), "rec.")
    at, bt = TR._rglru_coeffs({k: torch.from_numpy(v) for k, v in t.items()},
                              torch.from_numpy(x), "rec.")
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(_np(at), _np(aj), **TOL)
    np.testing.assert_allclose(_np(bt), _np(bj), **TOL)


def test_rec_layers_use_their_own_weights():
    """In a griffin pool, ``rec0.`` runs rec0's weights: the reference's
    prefix strip lets ``rec1.`` shadow them, the port's does not."""
    from repro_torch.core.mics import init_params
    from repro_torch.models.build import build_model

    model = build_model(smoke_variant(get_config("recurrentgemma-2b")), tp=1)
    pool = model.pool("g")
    row = init_params(model, seed=0, device="cpu")["g"][0, 0]
    t = pool.layout.unflatten(row.clone())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 6, 64)).astype(np.float32))
    ctx = TL.Ctx(mode="train", tp=1)
    cfg = model.cfg
    base, _ = TR.griffin_rec_apply(cfg, t, x, ctx, prefix="rec0.")
    t["rec1.rec.wx"].mul_(2.0)                         # rec1's weights: no effect
    same, _ = TR.griffin_rec_apply(cfg, t, x, ctx, prefix="rec0.")
    t["rec0.rec.wx"].mul_(2.0)                         # rec0's own: changes it
    other, _ = TR.griffin_rec_apply(cfg, t, x, ctx, prefix="rec0.")
    assert torch.equal(base, same)
    assert not torch.allclose(base, other)


# Gradients of one recurrent layer, port against jax.vjp, as a fraction of
# each gradient's max |value|, measured on the CPU with the test below.
# fp32: the same math in other orders; measured <= 6.8e-7.  bf16: both
# round every matmul's output, the conv's product and sum after each tap
# and the RG-LRU's output to bf16 at the same places, with sums in other
# orders; measured <= 1.03e-2 (rec.wx), about one bf16 ulp of the largest
# gradient.
GRAD_REL_TOL = {"fp32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rec_apply_grads_match_jax_vjp(layer, dt):
    """The input's and every weight's gradient of one ``griffin_rec_apply``
    in train mode, against ``jax.vjp`` of the reference's, on the same
    weights, input and cotangent.  bf16 casts weights and input to bf16 as
    the bf16 gather does, which covers the conv's bf16 rounding after each
    tap (eager autograd here, XLA's autodiff there) and the RG-LRU's
    Function (its plain backward on the CPU)."""
    cfg_j, cfg_t, tj, tt = layer
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, cfg_t.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    tj = {k: v.astype(jdt) for k, v in tj.items()}

    @jax.jit
    def vjp(t, x_, ct_):
        _, f = jax.vjp(lambda t_, xx: JR.griffin_rec_apply(cfg_j, t_, xx,
                                                           JL.Ctx(mode="train", tp=1))[0], t, x_)
        return f(ct_)

    dtj, dxj = vjp(tj, jnp.asarray(x, jdt), jnp.asarray(ct, jdt))
    tt = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tdt).requires_grad_()
          for k, v in tj.items()}
    xt = torch.from_numpy(np.array(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt)
    xt.requires_grad_()
    y, _ = TR.griffin_rec_apply(cfg_t, tt, xt, TL.Ctx(mode="train", tp=1, compute_dtype=tdt))
    y.backward(torch.from_numpy(np.array(jnp.asarray(ct, jdt).astype(jnp.float32))).to(tdt))
    tol = GRAD_REL_TOL[dt]
    for name, got, want in [("x", xt.grad, dxj)] + [(k, tt[k].grad, dtj[k]) for k in sorted(tt)]:
        assert got is not None and got.dtype == tdt, name
        w = _np(want)
        err, scale = float(np.abs(_np(got) - w).max()), float(np.abs(w).max())
        assert err <= tol * scale, f"d{name}: max |err| {err} > {tol} x {scale}"
