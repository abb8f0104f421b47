"""The port's configs, dims and flat-pool layouts against the JAX package's:
field for field, no arrays needed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.models.build import exact_param_count as jax_param_count  # noqa: E402
from repro.models.dims import attn_dims as jax_attn_dims  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.mics import init_params  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.models.dims import attn_dims  # noqa: E402

ARCHS = ("llama3.2-1b", "recurrentgemma-2b", "granite-8b", "yi-9b", "qwen1.5-110b",
         "deepseek-moe-16b", "dbrx-132b")
ARCH = ARCHS[0]


def _cfgs(smoke: bool, arch: str = ARCH):
    j, t = jax_get_config(arch), get_config(arch)
    return (jax_smoke(j), smoke_variant(t)) if smoke else (j, t)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_fields_match(smoke, arch):
    j, t = _cfgs(smoke, arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_model_def_matches(smoke, tp, arch):
    cj, ct = _cfgs(smoke, arch)
    mj, mt = jax_build_model(cj, tp), build_model(ct, tp)
    assert mt.tp == mj.tp and mt.vocab_padded == mj.vocab_padded
    assert mt.global_flat_shapes() == mj.global_flat_shapes()
    for pj, pt in zip(mj.all_pools(), mt.all_pools(), strict=True):
        assert (pt.name, pt.stack) == (pj.name, pj.stack)
        assert (pt.layout.raw_len, pt.layout.flat_len) == (pj.layout.raw_len,
                                                           pj.layout.flat_len)
        assert len(pt.layout.segments) == len(pj.layout.segments)
        for sj, st in zip(pj.layout.segments, pt.layout.segments):
            assert dataclasses.asdict(st) == dataclasses.asdict(sj), st.name


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("heads", [(32, 8, 64), (4, 2, 16), (10, 1, 256), (20, 20, 64)])
def test_attn_dims_match(heads, tp):
    hq, hkv, dh = heads
    args = (hq * dh, hq, hkv, dh, tp)
    try:
        want = jax_attn_dims(*args)
    except ValueError:
        with pytest.raises(ValueError):
            attn_dims(*args)
        return
    assert dataclasses.asdict(attn_dims(*args)) == dataclasses.asdict(want)


def test_full_width_pool_sizes():
    """llama3.2-1b's flat pools: 1,498,484,736 fp32 values (6.0 GB)."""
    m = build_model(get_config(ARCH), tp=1)
    shapes = m.global_flat_shapes()
    assert shapes["embed"] == (1, 1, 262_668_288)
    assert shapes["layers"] == (16, 1, 60_821_504)
    assert shapes["head"] == (1, 1, 262_672_384)
    assert m.head.layout.raw_len == 262_670_336
    total = sum(s * t * n for s, t, n in shapes.values())
    assert total == 1_498_484_736
    assert get_config(ARCH).param_count() == jax_param_count(jax_get_config(ARCH))


def test_full_width_pool_sizes_recurrentgemma():
    """recurrentgemma-2b's flat pools: 3,314,122,752 fp32 values (13.26 GB):
    8 super-layers (rec, rec, attn) in ``g`` and a (rec, rec) tail."""
    m = build_model(get_config("recurrentgemma-2b"), tp=1)
    shapes = m.global_flat_shapes()
    assert [p.name for p in m.pools] == ["g", "gtail"]
    assert shapes["embed"] == (1, 1, 655_360_000)
    assert shapes["g"] == (8, 1, 230_756_352)
    assert shapes["gtail"] == (1, 1, 157_347_840)
    assert shapes["head"] == (1, 1, 655_364_096)
    total = sum(s * t * n for s, t, n in shapes.values())
    assert total == 3_314_122_752
    assert get_config("recurrentgemma-2b").param_count() == \
        jax_param_count(jax_get_config("recurrentgemma-2b"))


def test_init_params_lru_decay_range():
    """``rec.lam`` gets the RG-LRU init: sigmoid(Λ) uniform in [0.9, 0.999]."""
    m = build_model(smoke_variant(get_config("recurrentgemma-2b")), tp=1)
    params = init_params(m, seed=0, device="cpu")
    pool = m.pool("g")
    lams = [seg for seg in pool.layout.segments if seg.name.endswith("rec.lam")]
    assert [s.name for s in lams] == ["rec0.rec.lam", "rec1.rec.lam"]
    for i in range(pool.stack):
        for seg in lams:
            a = torch.sigmoid(params["g"][i, 0, seg.offset:seg.end].double())
            assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
            assert float(a.max() - a.min()) > 0.05  # spread, not a constant


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_layout(arch):
    """Per segment: zeros where the layout says zeros, normal(0, std) where
    it says normal, zero padding; deterministic in the seed, distinct pools."""
    m = build_model(smoke_variant(get_config(arch)), tp=1)
    a = init_params(m, seed=3, device="cpu")
    b = init_params(m, seed=3, device="cpu")
    c = init_params(m, seed=4, device="cpu")
    for name, shape in m.global_flat_shapes().items():
        assert a[name].shape == shape and a[name].dtype == torch.float32
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    pool = m.pools[0]
    layers = pool.layout
    row = a[pool.name][0, 0]
    for seg in layers.segments:
        vals = row[seg.offset:seg.end]
        if seg.init == "zeros":
            assert int(vals.abs().sum()) == 0, seg.name
        elif seg.init == "normal":
            assert abs(float(vals.std()) - seg.std) < 0.25 * seg.std, seg.name
    assert int(row[layers.raw_len:].abs().sum()) == 0
    assert not torch.equal(a[pool.name][0, 0], a[pool.name][1, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_unflatten_round_trip(arch):
    """unflatten returns views of the flat buffer; flatten inverts it and
    zero-pads to flat_len."""
    layout = build_model(smoke_variant(get_config(arch)), tp=1).pools[0].layout
    flat = torch.arange(layout.flat_len, dtype=torch.float32)
    flat[layout.raw_len:] = 0
    tensors = layout.unflatten(flat)
    for seg in layout.segments:
        t = tensors[seg.name]
        assert tuple(t.shape) == seg.shape
        assert t.data_ptr() == flat.data_ptr() + 4 * seg.offset  # a view, no copy
    assert torch.equal(layout.flatten(tensors), flat)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_layout_shards_experts_and_gathers_the_router(arch, tp):
    """At tp > 1 a rank stores E / tp experts (``shard_dim(n_experts, tp)``,
    dim 0 of ``moe.*``) and 1 / tp of the router's columns, which the
    layer gets gathered along dim 1 (``model_gather = tp``);
    ``convert.tp_params_from_full`` cuts each along that dim (its
    ``_sharded_dim``), so the shards put back together are the tp = 1
    tensors."""
    from repro_torch.convert import _sharded_dim, tp_params_from_full

    cfg = smoke_variant(get_config(arch))
    m1, mt = build_model(cfg, 1), build_model(cfg, tp)
    l1, lt = m1.pool("layers").layout, mt.pool("layers").layout
    router = lt.seg("router.w")
    assert router.shape == (cfg.d_model, cfg.n_experts // tp)
    assert (router.model_gather, router.model_gather_dim) == (tp, 1)
    assert _sharded_dim(router, l1.seg("router.w")) == 1
    for name in ("moe.wg", "moe.wu", "moe.wd"):
        assert lt.seg(name).shape[0] == cfg.n_experts // tp and lt.seg(name).model_gather == 1
        assert _sharded_dim(lt.seg(name), l1.seg(name)) == 0
    full = init_params(m1, seed=1, device="cpu")
    cut = tp_params_from_full(mt, m1, {"layers": full["layers"]})["layers"]
    for name, dim in (("router.w", 1), ("moe.wg", 0), ("moe.wd", 0)):
        s1, st = l1.seg(name), lt.seg(name)
        whole = full["layers"][0, 0, s1.offset:s1.end].reshape(s1.shape)
        parts = [cut[0, j, st.offset:st.end].reshape(st.shape) for j in range(tp)]
        assert torch.equal(torch.cat(parts, dim=dim), whole)
