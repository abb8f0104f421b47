"""The port's MiCS collectives (``repro_torch.core.collectives`` behind
``CommEngine``) in one 4-rank gloo world on the CPU against the JAX
package's ``repro.core.collectives`` on 4 virtual devices, on the same
numpy inputs (``torch_dist_cases.py``): every gather bitwise equal (flat,
``inner_first`` / ``outer_first`` at p 4 with inner 2, multi-axis ``pod x
shard`` in both orders), every reduce-scatter, hop 2 and the Fig-14
``alternative_sync`` within 1e-6 relative in fp32 and 2 bf16 ulps of the
largest value in bf16, the three gather topologies bitwise equal to each
other, and the rank layout equal to the JAX mesh's device order."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro.core import collectives as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402

FP32_REL = 1e-6
BF16_ULPS = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    jax_proc = K.start("jax_dist_oracle.py", "collectives", str(out))
    port = K.start("torch_dist_harness.py", "collectives", str(out))
    K.finish(port, 240)
    K.finish(jax_proc, 240)
    return (K.load_ranks(str(out / "port_collectives.rank{r}.npz")),
            dict(np.load(out / "jax_collectives.npz")))


def _topo(layout):
    return T.MiCSTopology(**K.topo_kwargs(layout))


@pytest.mark.parametrize("layout", list(K.LAYOUTS))
def test_rank_layout_is_the_jax_mesh(results, layout):
    """Rank r is device r of ``make_host_mesh``; the partition and
    replication groups are the reference's, ranks for device ids."""
    _, want = results
    topo = _topo(layout)
    devices = want[f"groups.{layout}.devices"]
    assert devices.reshape(-1).tolist() == list(range(K.WORLD))
    for r in range(K.WORLD):
        c = topo.rank_coords(r)
        assert devices[tuple(c[a] for a in T.MICS_AXES)] == r
        assert topo.coords_rank(c) == r
    assert topo.partition_groups() == want[f"groups.{layout}.partition"].tolist()
    assert topo.replication_groups() == want[f"groups.{layout}.replication"].tolist()


@pytest.mark.parametrize("name", list(K.GATHERS))
def test_gather_matches_jax_bitwise(results, name):
    got, want = results
    assert got[name].shape == want[name].shape
    assert np.array_equal(got[name], want[name])
    # and it is the flat gather of the shards, in rank-chunk order
    lay, _, _, _, axis = K.GATHERS[name]
    x = K.gather_input(name)
    for members in _topo(lay).partition_groups():
        for r in members:
            assert np.array_equal(got[name][r], np.concatenate([x[m] for m in members],
                                                               axis=axis))


@pytest.mark.parametrize("layout,names", [
    ("A", ("flat@A", "inner_first@A", "outer_first@A")),
    ("Z3", ("inner_first@Z3", "outer_first@Z3")),
])
def test_gather_topologies_bitwise_equal(results, layout, names):
    got, _ = results
    for n in names[1:]:
        assert np.array_equal(got[n], got[names[0]]), n


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("name", list(K.REDUCE_SCATTERS))
def test_reduce_scatter_matches_jax(results, name):
    got, want = results
    dt = K.REDUCE_SCATTERS[name][3]
    assert got[name].shape == want[name].shape == (K.WORLD, K.RS_LEN // _topo(
        K.REDUCE_SCATTERS[name][0]).partition_size)
    err, scale = np.abs(got[name] - want[name]).max(), np.abs(want[name]).max()
    bound = FP32_REL * scale if dt == "fp32" else BF16_ULPS * _bf16_ulp(scale)
    assert err <= bound, f"{name}: max |err| {err} > {bound}"


@pytest.mark.parametrize("name", list(K.REDUCE_SCATTERS))
def test_reduce_scatter_repeats_bitwise(results, name):
    got, _ = results
    assert np.array_equal(got[name], got[name + ".again"])


@pytest.mark.parametrize("name", list(K.SYNCS))
def test_sync_matches_jax(results, name):
    got, want = results
    assert got[name].shape == want[name].shape
    err, scale = np.abs(got[name] - want[name]).max(), np.abs(want[name]).max()
    assert err <= FP32_REL * scale, f"{name}: max |err| {err}"


@pytest.mark.parametrize("topology", ["flat", "inner_first", "outer_first"])
def test_engine_gather_and_its_adjoint(results, topology):
    """``CommEngine.gather_flat`` at p 4: the full buffer is the shards in
    rank order; autograd's backward is the sum of every rank's cotangent,
    this rank's chunk; the counter saw one gather and one reduce-scatter a
    stage (flat: the partition group; staged: outer and inner)."""
    got, _ = results
    x = K.full_input("engine")
    ct = K.full_input("engine_ct", 4 * K.RS_LEN)
    n = K.RS_LEN
    for r in range(K.WORLD):
        assert np.array_equal(got[f"engine.{topology}.full"][r], x.reshape(-1))
        want = ct.sum(axis=0)[r * n:(r + 1) * n]
        assert np.allclose(got[f"engine.{topology}.grad"][r], want, rtol=FP32_REL, atol=1e-6)
    want_calls = [1, 0, 0, 1, 0, 0] if topology == "flat" else [0, 1, 1, 0, 1, 1]
    assert got[f"engine.{topology}.calls"].tolist() == [want_calls] * K.WORLD


@pytest.mark.parametrize("inner,outer,axis", [(2, 2, 0), (2, 4, 0), (4, 2, 1), (1, 3, 0)])
def test_reorder_chunks_is_the_reference(inner, outer, axis):
    rng = np.random.default_rng(inner * 10 + outer)
    shape = [3, 5]
    shape[axis] = inner * outer * 4
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(JC._reorder_chunks(x, axis, inner, outer))
    got = C._reorder_chunks(torch.from_numpy(x), axis, inner, outer).numpy()
    assert np.array_equal(got, want)
    back = C._reorder_chunks(torch.from_numpy(got), axis, outer, inner).numpy()
    assert np.array_equal(back, x)


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32, 64])
def test_hierarchy_factors_are_the_reference(p):
    assert T.default_hierarchy_inner(p) == JT.default_hierarchy_inner(p)
    if p > 1:
        topo = T.MiCSTopology(shard=p)
        inner = JT.default_hierarchy_inner(p)
        assert T.hierarchy_factors(topo) == (p // inner, inner)
        assert T.hierarchy_factors(T.MiCSTopology(pod=2, shard=p, partition_axes=(
            "pod", "shard"), replication_axes=())) == (2, p)


@pytest.mark.parametrize("params", [1.2e9, 8e9, 30e9, 200e9])
def test_choose_partition_size_is_the_reference(params):
    kw = dict(data_axis=16, model_axis=1, hbm_bytes=80 * 10**9)
    if params > 100e9:   # does not fit even at p = 16: both refuse
        for fn in (T.choose_partition_size, JT.choose_partition_size):
            with pytest.raises(ValueError, match="does not fit"):
                fn(int(params), **kw)
        return
    assert T.choose_partition_size(int(params), **kw) == JT.choose_partition_size(
        int(params), **kw)


def test_topology_refuses_bad_axes():
    with pytest.raises(ValueError, match="mesh order"):
        T.MiCSTopology(pod=2, shard=2, partition_axes=("shard", "pod"), replication_axes=())
    with pytest.raises(ValueError, match="neither"):
        T.MiCSTopology(repl=2, replication_axes=())
    with pytest.raises(ValueError, match="both"):
        T.MiCSTopology(partition_axes=("shard",), replication_axes=("shard",))
