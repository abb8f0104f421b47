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


# ---------------------------------------------------------------------------
# the int8 and bf16 wires
# ---------------------------------------------------------------------------
# The reference's jitted quantizer computes its scale as absmax x fl(1/127)
# (XLA rewrites the division by a constant), its eager one and the port as
# absmax / 127 (IEEE); 4.5% of fp32 scales differ by one ulp between the
# two.  So the reductions that quantize their fp32 partial sums are held to
# two fp32 ulps of the largest value (measured: 0 for the one-stage cases,
# one ulp at most for the others); the gathers and the bf16 hop 2 bitwise.
QUANT_ULPS = 2


@pytest.mark.parametrize("name", list(K.QWIRES))
def test_int8_gather_matches_jax_bitwise(results, name):
    """The qwZ gather (nearest rounding, bf16 compute dtype): the
    dequantized buffer bitwise the reference's ``CommEngine.gather_flat``
    under ``wire_dtype='int8'``, on every rank."""
    got, want = results
    key = f"qgather:{name}"
    p = _topo(K.QWIRES[name][0]).partition_size
    assert got[key].shape == want[key].shape == (K.WORLD, p * K.QLEN)
    assert np.array_equal(got[key], want[key])


@pytest.mark.parametrize("name", list(K.QWIRES))
def test_quantized_reduce_scatter_matches_jax(results, name):
    """qgZ hop 1 with nearest rounding against the reference's
    ``quantized_reduce_scatter`` at the same layout and topology."""
    got, want = results
    key = f"qrs:{name}"
    p = _topo(K.QWIRES[name][0]).partition_size
    assert got[key].shape == want[key].shape == (K.WORLD, K.QRS_LEN // p)
    err = np.abs(got[key] - want[key]).max()
    assert err <= QUANT_ULPS * np.spacing(np.abs(want[key]).max()), (name, err)
    # and it is the float reduce-scatter to within the quantization error
    x = K.full_input("qrs:" + K.QWIRES[name][0], K.QRS_LEN)
    topo = _topo(K.QWIRES[name][0])
    n = K.QRS_LEN // p
    for members in topo.partition_groups():
        total = sum(x[m] for m in members)
        for r in members:
            c = topo.partition_coord(r)
            step = len(members) * np.abs(x).max() / 127
            assert np.abs(got[key][r] - total[c * n:(c + 1) * n]).max() <= step


@pytest.mark.parametrize("seeded", ["fingerprint", "step"])
@pytest.mark.parametrize("name", list(K.QWIRES))
def test_quantized_reduce_scatter_is_psum_scatter_on_the_grid(results, name, seeded):
    """The port's ``quant_rs_routing``: on grid-exact data (one contributor,
    every block's absmax 127, so the quantizer loses nothing) the quantized
    hop 1 with stochastic rounding is bitwise the float reduce-scatter,
    each rank holding its partition coordinate's chunk of its group's sum,
    with the dither keyed by the payload's fingerprint or by a step.  A
    stage plan out of step with the float one sends chunks to the wrong
    owners and fails here (the reference fails its own such check:
    ROADMAP Queue 3)."""
    got, _ = results
    key = ("qgrid:" if seeded == "fingerprint" else "qgrid_seeded:") + name
    x = K.grid_input()
    topo = _topo(K.QWIRES[name][0])
    n = K.GRID_LEN // topo.partition_size
    for members in topo.partition_groups():
        total = sum(x[m] for m in members)
        for r in members:
            c = topo.partition_coord(r)
            assert np.array_equal(got[key][r], total[c * n:(c + 1) * n]), (name, r)


def test_quantized_all_reduce_matches_jax(results):
    """The int8 hop 2 at layout B (2 replicas, a payload of 1001 that does
    not divide over them) with nearest rounding, against the reference's
    ``quantized_all_reduce``; the async form (waited) gives the same bits."""
    got, want = results
    assert got["qar"].shape == want["qar"].shape == (K.WORLD, K.QAR_LEN)
    err = np.abs(got["qar"] - want["qar"]).max()
    assert err <= QUANT_ULPS * np.spacing(np.abs(want["qar"]).max()), err
    assert np.array_equal(got["qar.async"], got["qar"])
    for group in _topo("B").replication_groups():
        for r in group[1:]:
            assert np.array_equal(got["qar"][r], got["qar"][group[0]])


def test_bf16_hop2_matches_jax_bitwise(results):
    got, want = results
    assert np.array_equal(got["hop2_bf16"], want["hop2_bf16"])
    assert np.array_equal(got["hop2_bf16.async"], got["hop2_bf16"])


def test_int8_gather_adjoint_counts_and_bytes(results):
    """One qwZ gather and its qgZ adjoint at A (``outer_first``, inner 2):
    the gather moves values and scales at each stage (2 ``all_gather`` a
    stage), the adjoint exchanges them at each stage (2 ``all_to_all`` a
    stage: PERF.md §4); q and s together are at most 0.55 of the bytes a
    bf16 wire would carry for the same payload; the gradient is the sum of
    the ranks' cotangents within the quantization error."""
    import json

    got, _ = results
    for r in range(K.WORLD):
        calls = json.loads(str(got["qengine.calls"][r]))
        assert calls == {"all_gather:inner": 2, "all_gather:outer": 2,
                         "all_to_all:inner": 2, "all_to_all:outer": 2}
        nbytes = json.loads(str(got["qengine.bytes"][r]))
        # bf16 wire: the gather's outputs (2 x 2 and 4 x 2 shards) and the
        # adjoint's stage inputs (4 and 2 shards' worth), 2 bytes a value
        bf16 = 2 * K.QLEN * (2 + 4 + 4 + 2)
        assert sum(nbytes.values()) <= 0.55 * bf16, nbytes
    ct = K.full_input("qengine_ct", 4 * K.QLEN)
    ct = np.asarray(torch.from_numpy(ct).bfloat16().float())
    total = ct.sum(axis=0)
    for r in range(K.WORLD):
        want = total[r * K.QLEN:(r + 1) * K.QLEN]
        assert np.abs(got["qengine.grad"][r] - want).max() <= 2 * np.abs(ct).max() / 127 * 2
