"""The port's backward kernels' plain versions against ``jax.vjp`` of the
JAX package's layer functions (``repro.models.layers.rms_norm`` and
``.attention``, which the reference's training path differentiates), on
the same numpy inputs, and the autograd Functions on the CPU against
autograd through their plain forwards.  The CUDA kernels are held against
these plain versions on the card (``tests/test_torch_kernels.py``, ``gpu``;
``chip_smoke.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RN  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Max |port - JAX| as a fraction of max |JAX| over each gradient.  fp32:
# the same math in other orders (measured <= 9e-7).  bf16: the reference
# rounds every product's output to bf16 and its autodiff keeps dS in fp32
# for dq and dk, where the kernels' arithmetic (which the plain version
# mirrors) rounds dS to bf16 as the tensor cores' operand and takes
# delta = rowsum(dO o) from the bf16 output; measured <= 7.5e-3 of max |g|
# on these cases, so 2e-2, the forward tests' bf16 tolerance.
REL_TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _pair(arr, name):
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _close(port, ref, name, what):
    p = port.float().detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(jnp.asarray(ref, jnp.float32)) if not isinstance(ref, torch.Tensor) \
        else ref.float().detach().numpy()
    err, scale = float(np.abs(p - r).max()), float(np.abs(r).max())
    assert err <= REL_TOL[name] * scale, f"{what}: max |err| {err} > {REL_TOL[name]} x {scale}"


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (4, 16, 256), (2, 8, 2048)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rms_norm_bwd_plain_matches_jax_vjp(shape, dt):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=shape), dt)
    sj, st = _pair(0.2 * rng.normal(size=shape[-1]), dt)
    gj, gt = _pair(rng.normal(size=shape), dt)
    _, vjp = jax.vjp(JL.rms_norm, xj, sj)
    dxj, dsj = vjp(gj)
    dx, ds = RN.rms_norm_bwd_plain(xt, st, gt)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype and ds.shape == st.shape
    _close(dx, dxj, dt, "dx")
    _close(ds, dsj, dt, "dscale")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_rms_norm_fn_matches_autograd_of_plain(dt):
    """On the CPU ``RmsNormFn`` runs the plain forward and the plain
    backward; autograd through the plain forward is the yardstick."""
    tdt = DTYPES[dt][1]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(6, 5, 96, generator=gen).to(tdt)
    s = (0.2 * torch.randn(96, generator=gen)).to(tdt)
    dy = torch.randn(6, 5, 96, generator=gen).to(tdt)
    x1, s1 = x.clone().requires_grad_(), s.clone().requires_grad_()
    RN.rms_norm_plain(x1, s1).backward(dy)
    x2, s2 = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = TL.rms_norm(x2, s2)                      # the layer routes to RmsNormFn
    assert y.grad_fn is not None and "RmsNormFn" in type(y.grad_fn).__name__
    assert torch.equal(y, RN.rms_norm_plain(x, s))
    y.backward(dy)
    _close(x2.grad, x1.grad, dt, "dx")
    _close(s2.grad, s1.grad, dt, "dscale")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # id: (b, T, hkv, g, dh, causal, window)
    "gqa-causal-dh16": (2, 64, 2, 4, 16, True, 0),
    "gqa-window-dh64": (2, 64, 2, 4, 64, True, 16),
    "g1-full": (2, 40, 2, 1, 16, False, 0),
    "T1024-causal": (1, 1024, 2, 2, 16, True, 0),      # the reference's 512-query chunks
    "T1024-window": (1, 1024, 1, 2, 16, True, 100),    # its windowed KV slabs
    "mqa-g10-dh256-window": (1, 80, 1, 10, 256, True, 24),  # recurrentgemma's heads
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_attention_bwd_plain_matches_jax_vjp(case, dt):
    b, t, hkv, g, dh, causal, window = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng.normal(size=(b, t, hkv, g, dh)), dt)
    kj, kt = _pair(rng.normal(size=(b, t, hkv, dh)), dt)
    vj, vt = _pair(rng.normal(size=(b, t, hkv, dh)), dt)
    dj, dot = _pair(rng.normal(size=(b, t, hkv, g, dh)), dt)
    out, vjp = jax.vjp(lambda q, k, v: JL.attention(q, k, v, causal=causal, window=window),
                       qj, kj, vj)
    dqj, dkj, dvj = vjp(dj)
    o, lse = FA.attention_plain_lse(qt, kt, vt, causal=causal, window=window)
    assert lse.shape == (b, hkv, g, t) and lse.dtype == torch.float32
    _close(o, out, dt, "o")
    dq, dk, dv = FA.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal=causal,
                                              window=window)
    for got, want, what in ((dq, dqj, "dq"), (dk, dkj, "dk"), (dv, dvj, "dv")):
        assert got.dtype == qt.dtype and got.shape == tuple(want.shape)
        _close(got, want, dt, what)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_flash_attention_fn_matches_autograd_of_plain(dt):
    """``FlashAttentionFn`` on the CPU (plain forward with its log-sum-exp,
    plain backward) against autograd through ``attention_plain``, with a
    q_offset and kv_valid_len as well as the masks."""
    tdt = DTYPES[dt][1]
    gen = torch.Generator().manual_seed(4)
    for kw in (dict(causal=True, window=0, q_offset=0, kv_valid_len=None),
               dict(causal=True, window=9, q_offset=0, kv_valid_len=None),
               dict(causal=True, window=0, q_offset=20, kv_valid_len=30)):
        tq = 24 if kw["q_offset"] == 0 else 8
        q = torch.randn(2, tq, 2, 3, 32, generator=gen).to(tdt)
        k = torch.randn(2, 32 if kw["q_offset"] else tq, 2, 32, generator=gen).to(tdt)
        v = torch.randn(*k.shape, generator=gen).to(tdt)
        do = torch.randn(*q.shape, generator=gen).to(tdt)
        ins1 = [t.clone().requires_grad_() for t in (q, k, v)]
        FA.attention_plain(*ins1, **kw).backward(do)
        ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
        o = TL.attention(*ins2, **kw)             # the layer routes to FlashAttentionFn
        assert "FlashAttentionFn" in type(o.grad_fn).__name__
        assert torch.equal(o, FA.attention_plain(q, k, v, **kw))
        o.backward(do)
        for a, b_, what in zip(ins2, ins1, ("dq", "dk", "dv")):
            _close(a.grad, b_.grad, dt, f"{what} {kw}")


def test_flash_attention_bwd_rejects():
    q = torch.zeros(1, 4, 1, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    o, lse = FA.attention_plain_lse(q, k, k)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd(q, k, k, o, lse[..., :2], q)
    with pytest.raises(ValueError, match="must match q"):
        FA.flash_attention_bwd(q, k, k, o, lse, q[:, :2])
    with pytest.raises(ValueError, match="does not match x"):
        RN.rmsnorm_bwd(torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, 4))
