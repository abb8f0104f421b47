"""The bf16 routes of the port's flash attention, on the CPU: the route
choice, the split plan, the split route's partial + merge form, and the
mma route's rounding, each held against ``repro.models.layers.attention``
of the JAX package on the same numpy inputs.  The CUDA kernels themselves
run only on the card (``tests/test_torch_kernels.py``'s ``gpu`` tests and
``chip_smoke.py`` hold them against the plain versions here).

Tolerances: fp32 1e-5 (the same function, sums in another order); bf16
2e-2 (tests/test_kernels.py's, one bf16 ulp at the outputs' scale: the
routes round P to bf16 before the PV product where the reference rounds
the normalised probabilities)."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _pair(arr, name):
    """The same numpy values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(arr, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _qkv(b, tq, tk, hkv, g, dh, dt, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(b, tq, hkv, g, dh)), dt),
            _pair(rng.normal(size=(b, tk, hkv, dh)), dt),
            _pair(rng.normal(size=(b, tk, hkv, dh)), dt))


# ---------------------------------------------------------------------------
# route and split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rows,want", [
    (torch.bfloat16, 512 * 4, "mma"),      # llama prefill: T 512, g 4
    (torch.bfloat16, 2560 * 10, "mma"),    # recurrentgemma prefill: T 2560, g 10
    (torch.bfloat16, 4, "split"),          # llama decode
    (torch.bfloat16, 10, "split"),         # recurrentgemma decode
    (torch.bfloat16, 16, "split"),         # a chunk that fills one mma tile
    (torch.bfloat16, 17, "mma"),
    (torch.float32, 4, "fma"),
    (torch.float32, 25600, "fma"),
])
def test_route(dtype, rows, want):
    assert FA.route(dtype, rows) == want


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        FA.route(torch.float16, 4)


@pytest.mark.parametrize("b,hkv,kv_len,want", [
    (4, 8, 520, (9, 64)),       # llama decode: about 9 splits of 64
    (4, 1, 2048, (64, 32)),     # recurrentgemma decode: 64 splits, not 1 block a row
    (4, 8, 1, (1, 32)),
    (4, 1, 1, (1, 32)),
    (2, 8, 520, None),
    (1, 1, 100_000, None),
    (64, 8, 4096, None),
])
def test_plan_decode_splits(b, hkv, kv_len, want):
    nsplit, chunk = FA.plan_decode_splits(b, hkv, kv_len)
    if want is not None:
        assert (nsplit, chunk) == want
    assert chunk % 16 == 0 and chunk >= FA.SPLIT_MIN_CHUNK
    # the chunks cover [0, kv_len) exactly once, in order, none empty
    bounds = [(s * chunk, min((s + 1) * chunk, kv_len)) for s in range(nsplit)]
    assert bounds[0][0] == 0 and bounds[-1][1] == kv_len
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    # about two blocks per SM (the chunk's rounding up to 16 may cost a few),
    # unless the smallest chunk already stops the split
    assert b * hkv * nsplit >= 0.95 * 2 * 132 or chunk == FA.SPLIT_MIN_CHUNK


# ---------------------------------------------------------------------------
# split route: partials + merge
# ---------------------------------------------------------------------------

SPLIT_CASES = {
    # name: (b, tq, tk, hkv, g, dh, kw, (nsplit, chunk) or None for the plan)
    "llama decode, kv_valid_len inside a split":
        (2, 1, 544, 8, 4, 64, dict(causal=False, q_offset=0, kv_valid_len=520), None),
    "recurrentgemma decode":
        (1, 1, 2048, 1, 10, 256, dict(causal=False, q_offset=0, kv_valid_len=2048), None),
    "splits wholly past kv_valid_len":
        (2, 1, 544, 2, 4, 64, dict(causal=False, q_offset=0, kv_valid_len=100), (17, 32)),
    "window leaves splits empty":
        (2, 1, 544, 1, 10, 64, dict(causal=True, window=64, q_offset=500,
                                    kv_valid_len=501), (17, 32)),
    "chunk of 4 positions, causal":
        (2, 4, 64, 2, 4, 32, dict(causal=True, q_offset=60, kv_valid_len=64), (2, 32)),
}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_partials_merge_match_attention(case, dt):
    b, tq, tk, hkv, g, dh, kw, plan = SPLIT_CASES[case]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(b, tq, tk, hkv, g, dh, dt, seed=len(case))
    kv_len = min(tk, kw["kv_valid_len"])
    nsplit, chunk = plan or FA.plan_decode_splits(b, hkv, kv_len)
    part = FA.decode_partials_plain(qt, kt, vt, nsplit=nsplit, chunk=chunk, **kw)
    assert part.shape == (b, hkv, nsplit, tq * g, dh + 2) and part.dtype == torch.float32
    assert torch.isfinite(part[..., 1:]).all()
    # an empty chunk is (NEG_INF, 0, 0): weight 0 in the merge
    empty = part[..., 0] == FA.NEG_INF
    assert (part[..., 1][empty] == 0).all() and (part[..., 2:][empty] == 0).all()
    assert bool(empty.any()) == ("empty" in case or "past" in case)
    got = FA.merge_partials_plain(part, tq, g, qt.dtype)
    assert got.dtype == qt.dtype and got.shape == qt.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(FA.attention_plain(qt, kt, vt, **kw)), **TOL[dt])
    np.testing.assert_allclose(_np(got), _np(JL.attention(qj, kj, vj, **kw)), **TOL[dt])
    # the CPU wrapper takes the plain version
    assert torch.equal(FA.decode_partials(qt, kt, vt, nsplit=nsplit, chunk=chunk, **kw), part)


def test_decode_partials_refuses_a_short_plan():
    (_, qt), (_, kt), (_, vt) = _qkv(1, 1, 100, 1, 4, 16, "bf16", seed=0)
    with pytest.raises(ValueError):
        FA.decode_partials(qt, kt, vt, nsplit=3, chunk=32, causal=False)   # 96 < 100 keys
    with pytest.raises(ValueError):
        FA.decode_partials(qt, kt, vt, nsplit=4, chunk=40, causal=False)   # not a multiple of 16


# ---------------------------------------------------------------------------
# mma route: its rounding and tiling, mirrored on the CPU
# ---------------------------------------------------------------------------

def _mma_route_mirror(q, k, v, *, causal, window, q_offset=0, kv_valid_len=None, bc):
    """What the mma kernel computes: M-tiles of 64 packed (position, group
    head) rows; key tiles of ``bc`` keys from the M-tile's first allowed key
    rounded down to a tile; online softmax with fp32 scores, max and sum; P
    rounded to bf16 before the PV product; o = acc / max(l, 1e-30)."""
    b, tq, hkv, g, dh = q.shape
    kv_len = k.shape[1] if kv_valid_len is None else min(k.shape[1], kv_valid_len)
    rows = tq * g
    qs = (q.float() * (1.0 / math.sqrt(dh))).to(torch.bfloat16).float()
    qs = qs.permute(0, 2, 1, 3, 4).reshape(b, hkv, rows, dh)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)  # [b, hkv, tk, dh]
    out = torch.zeros(b, hkv, rows, dh)
    for r0 in range(0, rows, 64):
        r = torch.arange(r0, min(r0 + 64, rows))
        pos = q_offset + r // g
        lo = (pos - window + 1).clamp_min(0) if window else torch.zeros_like(pos)
        hi = (pos + 1).clamp_max(kv_len) if causal else torch.full_like(pos, kv_len)
        m = torch.full((b, hkv, len(r)), FA.NEG_INF)
        l = torch.zeros(b, hkv, len(r))
        acc = torch.zeros(b, hkv, len(r), dh)
        for k0 in range(int(lo.min()) // bc * bc, int(hi.max()), bc):
            j = torch.arange(k0, min(k0 + bc, int(hi.max())))
            allowed = (j[None] >= lo[:, None]) & (j[None] < hi[:, None])
            s = torch.einsum("bhrd,bhkd->bhrk", qs[:, :, r], kf[:, :, j])
            s = torch.where(allowed, s, torch.full_like(s, FA.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(allowed, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrk,bhkd->bhrd", p.to(torch.bfloat16).float(), vf[:, :, j])
            m = m_new
        out[:, :, r] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hkv, tq, g, dh).permute(0, 2, 1, 3, 4).to(torch.bfloat16)


@pytest.mark.parametrize("b,t,hkv,g,dh,window,bc", [
    (2, 200, 2, 4, 64, 0, 64),       # llama's head dim and group; ragged M-tiles
    (1, 300, 1, 10, 256, 128, 32),   # recurrentgemma's; M-tiles cut a position's heads
])
def test_mma_route_rounding_matches_layer(b, t, hkv, g, dh, window, bc):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(b, t, t, hkv, g, dh, "bf16", seed=dh)
    got = _mma_route_mirror(qt, kt, vt, causal=True, window=window, bc=bc)
    want = JL.attention(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bf16"])
    np.testing.assert_allclose(_np(got), _np(FA.attention_plain(qt, kt, vt, causal=True,
                                                                 window=window)), **TOL["bf16"])


def test_mma_route_mirror_offset_chunk():
    """q_offset 64, tq 128, kv_valid_len 150 inside a key tile."""
    kw = dict(causal=True, window=0, q_offset=64, kv_valid_len=150)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 128, 256, 2, 4, 64, "bf16", seed=7)
    got = _mma_route_mirror(qt, kt, vt, bc=64, **kw)
    np.testing.assert_allclose(_np(got), _np(JL.attention(qj, kj, vj, **kw)), **TOL["bf16"])


# ---------------------------------------------------------------------------
# cache helpers take no default device
# ---------------------------------------------------------------------------

def test_cache_helpers_need_a_device():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import blocks, recurrent
    from repro_torch.models.build import build_model
    from repro_torch.models.lm import init_caches

    cfg = smoke_variant(get_config("recurrentgemma-2b"))
    model = build_model(dataclasses.replace(cfg, n_layers=3), tp=1)
    with pytest.raises(TypeError):
        init_caches(model, 2, 16)
    with pytest.raises(TypeError):
        blocks.make_kv_cache(cfg, 1, 2, 16)
    with pytest.raises(TypeError):
        recurrent.make_rec_cache(cfg, 1, 2)
    caches = init_caches(model, 2, 16, device="cpu")
    assert all(t.device.type == "cpu" for c in caches.values() for d in c.values()
               for t in d.values())
