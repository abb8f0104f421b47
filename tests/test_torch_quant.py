"""The port's blockwise int8 quantizer (``repro_torch.core.quant``, the
plain versions of ``kernels/quant``) against the JAX package's
``repro.core.quant`` on the CPU, and the int8 serving weights.

* Nearest rounding (the qwZ weight wire, the stored serving weights) is
  bitwise the reference's: ``quantize_flat``'s values and scales at ragged
  lengths, leading dims, fp32 and bf16 input and all-zero blocks,
  ``dequantize_flat`` to bf16 and fp32, ``quantize_state`` of a model's
  pools.
* Stochastic rounding (the gradient wires) cannot match the reference's
  bits (its dither is threefry's); it is held to its own properties: the
  same key repeats, each key component changes the draw, every error is
  below one quantization step, the mean over 256 keys lies within 4 sigma
  of the value, and grid values come back exactly at a size where the
  reference's ``floor(v + u)`` does not (pinned below).
* The dither's hash on fixed vectors.
* Prefill and decode from the same stored int8 bytes: the port's serve
  steps against the reference's ``build_serve_steps(quant_gather=True)``
  at the bf16 serving tolerance of ``test_torch_serving.py``.
* The wire settings build, and invalid values raise ``ValueError``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core.comm import CommEngine as JaxCommEngine  # noqa: E402
from repro.core.comm import SyncPolicy as JaxSyncPolicy  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import init_state  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.core.comm import CommEngine, GatherPolicy, SyncPolicy  # noqa: E402
from repro_torch.core.mics import MiCSConfig, build_train_step  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.kernels.quant import kernel as QK  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402
from test_torch_serving import BF16_ATOL, _f32, _tie_rec_weights  # noqa: E402

LENGTHS = (1, 127, 128, 129, 300)
M32 = 0xFFFFFFFF


def _data(shape, seed, zero_block=True):
    """Normal values at a scale that varies by row, the first block of
    each row zero where the row has a full one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 1e3, size=(*shape[:-1], 1))
    x = x.astype(np.float32)
    if zero_block and shape[-1] >= 2 * Q.BLOCK:
        x[..., :Q.BLOCK] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("lead", [(), (3, 4)], ids=["flat", "3x4"])
@pytest.mark.parametrize("length", LENGTHS + (4 * Q.BLOCK + 44,))
def test_nearest_quantize_is_the_reference_bitwise(length, lead, dtype):
    x = _data((*lead, length), length + len(lead))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.bfloat16(), xj.astype(jnp.bfloat16)
    q, s = Q.quantize_flat(xt)
    jq, js = JQ.quantize_flat(xj)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (*lead, Q.n_blocks(length)) == np.asarray(js).shape
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = Q.dequantize_flat(q, s, td)
        assert got.dtype == td
        want = np.asarray(JQ.dequantize_flat(jq, js, jd).astype(jnp.float32))
        assert np.array_equal(got.float().numpy(), want)
    # nearest: within half a step of the value
    err = np.abs(Q.dequantize_flat(q, s, torch.float32).numpy() - xt.float().numpy())
    step = np.repeat(s.numpy(), Q.BLOCK, axis=-1)[..., :length]
    assert (err <= 0.5 * step * (1 + 1e-5)).all()   # fp32 rounding of q * scale at a tie


def test_all_zero_blocks_and_ties():
    """A zero block gets scale 1 and values 0; ties round half to even, as
    ``jnp.round`` does."""
    x = torch.zeros(3 * Q.BLOCK)
    x[Q.BLOCK] = 127.0                      # block 1: scale 1
    x[Q.BLOCK + 1:Q.BLOCK + 7] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    q, s = Q.quantize_flat(x)
    assert s.tolist() == [1.0, 1.0, 1.0]
    assert q[:Q.BLOCK].abs().sum() == 0 and q[2 * Q.BLOCK:].abs().sum() == 0
    assert q[Q.BLOCK + 1:Q.BLOCK + 7].tolist() == [0, 2, 2, 0, -2, -2]
    jq, js = JQ.quantize_flat(jnp.asarray(x.numpy()))
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))


def test_quantize_state_through_params_from_jax(topo1):
    """The reference's stored int8 pools carried over with
    ``params_from_jax`` are bitwise the port's ``quantize_state`` of the
    same fp32 pools."""
    model_j = jax_build_model(jax_smoke(jax_get_config("llama3.2-1b")), tp=1)
    model_t = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    params_j = init_state(model_j, topo1, seed=1)["params"]
    stored_j = {k: {"q": np.asarray(v["q"]), "s": np.asarray(v["s"])}
                for k, v in JQ.quantize_state(params_j).items()}
    carried = params_from_jax(model_t, stored_j, device="cpu")
    ours = Q.quantize_state(params_from_jax(
        model_t, {k: np.asarray(v) for k, v in params_j.items()}, device="cpu"))
    assert carried.keys() == ours.keys() == model_t.global_flat_shapes().keys()
    for name in ours:
        for part in ("q", "s"):
            assert torch.equal(carried[name][part], ours[name][part]), (name, part)
    with pytest.raises(ValueError, match="'q' and 's'"):
        params_from_jax(model_t, dict(stored_j, head={"q": stored_j["head"]["q"]}),
                        device="cpu")
    with pytest.raises(ValueError, match="head.s"):
        params_from_jax(model_t, dict(stored_j, head={"q": stored_j["head"]["q"],
                                                      "s": stored_j["head"]["s"][..., :-1]}),
                        device="cpu")


# ---------------------------------------------------------------------------
# the dither
# ---------------------------------------------------------------------------

def _mix32(x: int) -> int:
    """The 32-bit mix written out on a Python int (the spec the tensor and
    CUDA forms follow)."""
    x &= M32
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & M32
    x ^= x >> 15
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def _u_python(key: int, i: int, step_scalar: int | None = None) -> float:
    """The dither written out on Python ints."""
    lo = key & M32
    if step_scalar is not None:
        lo ^= _mix32(step_scalar & M32)
    h = _mix32(_mix32(i ^ lo) ^ ((key >> 32) & M32))
    return (h >> 8) * 2.0 ** -24


def test_hash_on_fixed_vectors():
    # mix32 pinned on fixed inputs (a change of the hash changes every
    # stochastic draw, so it must show here)
    assert [_mix32(v) for v in (0, 1, 2, 0xFFFFFFFF, 0x9F2C)] == MIX32_PINNED
    xs = torch.tensor([0, 1, 2, 0xFFFFFFFF, 0x9F2C, 123456789, 0x80000000], dtype=torch.int64)
    assert QK.mix32(xs).tolist() == [_mix32(int(v)) for v in xs]
    d = Q.dither_key(3, 1, 2, 7)
    assert d.key == DITHER_KEY_PINNED and d.step is None
    idx = torch.tensor([0, 1, 127, 128, 2 ** 20 + 5, 2 ** 32 - 1], dtype=torch.int64)
    assert QK.dither_u(d, idx).tolist() == [_u_python(d.key, int(i)) for i in idx]
    # a device step scalar (a payload's fingerprint) folds into the low word
    fp = torch.tensor(-12345, dtype=torch.int32)
    df = Q.dither_key(3, 1, 2, fp)
    assert df.key != d.key and df.step is fp
    assert QK.dither_u(df, idx).tolist() == [_u_python(df.key, int(i), -12345) for i in idx]


MIX32_PINNED = [0x0, 0x86D2FA73, 0x0DA7F4E7, 0x99B5E683, 0x151CCDAE]
DITHER_KEY_PINNED = 0x3A8AC26777FE7596


def test_key_components_change_the_draw():
    x = torch.from_numpy(_data((1000,), 5, zero_block=False))
    base = Q.quantize_flat(x, key=Q.dither_key(0, 0, 0, 0))
    again = Q.quantize_flat(x, key=Q.dither_key(0, 0, 0, 0))
    assert torch.equal(base[0], again[0]) and torch.equal(base[1], again[1])
    for args in ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)):
        other = Q.quantize_flat(x, key=Q.dither_key(*args))
        assert torch.equal(other[1], base[1])                # scales do not depend on it
        assert not torch.equal(other[0], base[0]), args
    # the call's index offset shifts the draw
    off = QK.quantize_plain(x, Q.dither_key(0, 0, 0, 0), offset=7)
    assert not torch.equal(off[0], base[0])


def test_stochastic_rounding_is_unbiased_within_one_step():
    x = torch.from_numpy(_data((4 * Q.BLOCK,), 11, zero_block=False))
    draws = []
    for k in range(256):
        q, s = Q.quantize_flat(x, key=Q.dither_key(k, 0, 0, 17))
        deq = Q.dequantize_flat(q, s, torch.float32)
        step = s.repeat_interleave(Q.BLOCK)
        assert ((deq - x).abs() < step).all(), k           # below one step, every element
        draws.append(deq.double())
    mean = torch.stack(draws).mean(0)
    v = x.double() / step.double()
    frac = v - torch.floor(v)
    sigma = step.double() * torch.sqrt(frac * (1 - frac) / 256)
    assert ((mean - x.double()).abs() <= 4 * sigma + 1e-9 * x.double().abs()).all()


GRID_N = 1 << 21     # >= 2^20 values with |v| >= 64


def _grid(n=GRID_N, seed=3):
    """Integers of magnitude 64..127, each block's absmax pinned to 127, so
    the scale is exactly 1 and every value lies on the grid."""
    rng = np.random.default_rng(seed)
    v = rng.integers(64, 128, size=n).astype(np.float32)
    v *= np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    v[::Q.BLOCK] = 127.0
    return v


@pytest.mark.parametrize("key", [(0, 0, 0, 0), (1, 1, 3, 1234), (7, 0, 2, -5)])
def test_grid_values_come_back_exactly_under_stochastic_rounding(key):
    v = _grid()
    q, s = Q.quantize_flat(torch.from_numpy(v), key=Q.dither_key(*key))
    assert (s == 1.0).all()
    assert np.array_equal(Q.dequantize_flat(q, s, torch.float32).numpy(), v)


def test_reference_floor_v_plus_u_rounds_grid_values_up():
    """The reference's defect, pinned (ROADMAP Queue 3): ``floor(v + u)`` in
    fp32 rounds ``100 + u`` to 101 for the largest ``u`` below 1 that
    ``jax.random.uniform`` can return (its mantissa construction gives
    multiples of 2^-23), and on grid data of 2^22 values a seeded key
    moves some values by a whole step, where the port's exact form moves
    none (the test above)."""
    u_max = jnp.float32(1.0 - 2.0 ** -23)
    assert float(jnp.floor(jnp.float32(100.0) + u_max)) == 101.0
    assert float(jnp.floor(jnp.float32(0.0) + u_max)) == 0.0     # exact where v + u is
    v = _grid(1 << 22)
    out = np.asarray(JQ.dequantize_flat(*JQ.quantize_flat(jnp.asarray(v), key=jax.random.key(0)),
                                        dtype=jnp.float32))
    moved = np.flatnonzero(out != v)
    assert len(moved) > 0 and np.all(np.abs(out[moved] - v[moved]) == 1.0)
    assert np.all(np.abs(v[moved]) >= 64)


# ---------------------------------------------------------------------------
# int8 serving weights: the same stored bytes on both sides
# ---------------------------------------------------------------------------

SERVE_CASES = {"llama3.2-1b": ("llama3.2-1b", 2, 16, 24),
               "recurrentgemma-2b": ("recurrentgemma-2b", 2, 40, 44)}
STEPS = 4


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_int8_serving_matches_jax(case, topo1):
    """Prefill and 4 greedy decode steps from ``quantize_state`` of the same
    pools (the reference's, carried over), the same fed tokens: logits
    within the bf16 serving tolerance (``test_torch_serving.BF16_ATOL``;
    the gather's dequantize is bitwise the same, the layers' bf16 sums
    differ in order as there)."""
    arch, b, t0, cache = SERVE_CASES[case]
    model_j = jax_build_model(jax_smoke(jax_get_config(arch)), tp=1)
    model_t = build_model(smoke_variant(get_config(arch)), tp=1)
    params_j = init_state(model_j, topo1, seed=1)["params"]
    params_np = _tie_rec_weights(model_j, {k: np.asarray(v) for k, v in params_j.items()})
    params_j = {k: jax.device_put(params_np[k], v.sharding) for k, v in params_j.items()}
    stored_j = JQ.quantize_state(params_j)
    stored_t = params_from_jax(model_t, {k: {p: np.asarray(a) for p, a in v.items()}
                                         for k, v in stored_j.items()}, device="cpu")
    tokens = np.random.default_rng(2).integers(0, model_j.cfg.vocab, (b, t0)).astype(np.int32)

    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.bfloat16,
                                                           quant_gather=True), cache_len=cache)
    pt, dt = build_serve_steps(model_t, MiCSTopology(), MiCSConfig(quant_gather=True), cache,
                               device="cpu")
    lj, cj = pj(stored_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = pt(stored_t, {"tokens": torch.from_numpy(tokens).long()})
    atol = BF16_ATOL[case]
    np.testing.assert_allclose(_f32(lt), _f32(lj), rtol=0, atol=atol)
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        lj, nxt_j, cj = dj(stored_j, cj, tok_j, jnp.int32(t0 + i))
        lt, _, ct = dt(stored_t, ct, torch.from_numpy(np.array(tok_j)).long(), t0 + i)
        np.testing.assert_allclose(_f32(lt), _f32(lj), rtol=0, atol=atol,
                                   err_msg=f"decode step {i}")
        tok_j = nxt_j
    # fp32 pools are refused when the steps serve stored int8, and back
    fp32 = params_from_jax(model_t, params_np, device="cpu")
    with pytest.raises(ValueError, match="quant_gather"):
        pt(fp32, {"tokens": torch.from_numpy(tokens).long()})
    p_bf16, _ = build_serve_steps(model_t, MiCSTopology(), MiCSConfig(), cache, device="cpu")
    with pytest.raises(ValueError, match="stored int8"):
        p_bf16(stored_t, {"tokens": torch.from_numpy(tokens).long()})


def test_int8_serving_prefetch_equals_serial_bitwise():
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    from repro_torch.core.mics import init_params

    stored = Q.quantize_state(init_params(model, 0, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 12)))
    outs = []
    for prefetch in (True, False):
        pf, _ = build_serve_steps(model, MiCSTopology(),
                                  MiCSConfig(quant_gather=True, prefetch=prefetch), 16,
                                  device="cpu")
        outs.append(pf(stored, {"tokens": tokens})[0])
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the wire settings
# ---------------------------------------------------------------------------

def test_bf16_hop2_at_one_replica_rounds_like_the_reference(topo1):
    """With one replica the bf16 hop-2 wire is the round trip through bf16
    alone, bitwise the reference's ``CommEngine.hop2``."""
    g = np.random.default_rng(8).standard_normal(1000).astype(np.float32)
    eng = CommEngine(MiCSTopology(), sync_policy=SyncPolicy(hop2_wire_dtype="bf16"))
    got = eng.hop2_(torch.from_numpy(g.copy()))
    want = JaxCommEngine(topo1, sync_policy=JaxSyncPolicy(hop2_wire_dtype="bf16")).hop2(
        jnp.asarray(g))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), g)
    work = eng.hop2_(torch.from_numpy(g.copy()), async_op=True)
    work.wait()


WIRE_SETTINGS = {
    "quant_gather": dict(quant_gather=True),
    "hop1_bf16": dict(hop1_wire_dtype="bf16"),
    "hop1_int8": dict(hop1_wire_dtype="int8", grad_rounding="nearest"),
    "hop2_bf16": dict(compress_hop2="bf16"),
    "hop2_true": dict(compress_hop2=True),
    "hop2_int8": dict(compress_hop2="int8"),
}


@pytest.mark.parametrize("name", list(WIRE_SETTINGS))
def test_wire_settings_build_and_train_at_p1(name):
    """Each wire builds a train step at p = 1 whose record names it, and a
    step runs: at p = 1 nothing is on the wire but the bf16 hop-2 round
    trip and the int8 gather's cast to the compute dtype."""
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    mc = MiCSConfig(micro_steps=1, **WIRE_SETTINGS[name])
    step = build_train_step(model, MiCSTopology(), mc, OptConfig(warmup_steps=0),
                            device="cpu")
    wires = step.describe()["wires"]
    assert wires["gather"] == ("int8" if mc.quant_gather else "bf16")
    assert wires["hop1"] == mc.hop1_wire_dtype
    assert wires["hop2"] == {True: "bf16", "bf16": "bf16", "int8": "int8"}.get(
        mc.compress_hop2, "fp32")
    from repro_torch.core.mics import init_state

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (1, 2, 16)),
             "targets": rng.integers(0, 256, (1, 2, 16)), "mask": np.ones((1, 2, 16), np.float32)}
    state, m = step(init_state(model, 0, device="cpu"), batch)
    assert state["step"] == 1 and np.isfinite(m["loss"].item())


@pytest.mark.parametrize("kw", [dict(hop1_wire_dtype="int4"), dict(grad_rounding="floor"),
                                dict(compress_hop2="int4"), dict(compress_hop2="fp16")])
def test_invalid_wire_values_raise(kw):
    with pytest.raises(ValueError):
        MiCSConfig(**kw)


def test_invalid_policies_raise():
    with pytest.raises(ValueError, match="hop2_wire_dtype"):
        SyncPolicy(hop2_wire_dtype="fp8")
    with pytest.raises(ValueError, match="grad_rounding"):
        SyncPolicy(grad_rounding="up")
    with pytest.raises(ValueError, match="2hop"):
        SyncPolicy(mode="allreduce_slice", hop1_wire_dtype="bf16")
    with pytest.raises(ValueError, match="wire dtype"):
        GatherPolicy(wire_dtype="int4")
    eng = CommEngine(MiCSTopology(), GatherPolicy(wire_dtype="int8"),
                     compute_dtype=torch.float32)
    assert eng.gather_out_dtype() == torch.float32
    row = torch.randn(256)
    assert torch.equal(eng.gather_flat(row), row)
    with pytest.raises(TypeError):
        Q.quantize_flat(torch.zeros(8, dtype=torch.float16))
    with pytest.raises(ValueError, match="scales"):
        Q.dequantize_flat(torch.zeros(300, dtype=torch.int8), torch.ones(2))


@pytest.mark.parametrize("k", [2, 4])
def test_dequantize_chunk_sum(k):
    """The exchange stage's fused sum: ``q0 s0``, then one fma a chunk, in
    chunk order (written out here in numpy's float64); for 2 chunks it is
    bitwise the reference's jitted ``jnp.sum`` of the dequantized chunks
    (XLA fuses it into the same fma on the CPU), for 4 within two fp32
    ulps of the sum of magnitudes (XLA's order of the 4)."""
    x = torch.from_numpy(_data((k, 700), 21 + k, zero_block=False))
    q, s = Q.quantize_flat(x)
    got = QK.dequantize(q, s, torch.float32, chunks=k).numpy()
    qn = q.numpy().astype(np.float64)
    sn = np.repeat(s.numpy(), Q.BLOCK, axis=-1)[:, :700].astype(np.float64)
    want = (qn[0] * sn[0]).astype(np.float32)
    for c in range(1, k):
        want = (want.astype(np.float64) + qn[c] * sn[c]).astype(np.float32)
    assert np.array_equal(got, want)
    ref = np.asarray(jax.jit(lambda a, b: jnp.sum(JQ.dequantize_flat(a, b, dtype=jnp.float32),
                                                  axis=0))(q.numpy(), s.numpy()))
    if k == 2:
        assert np.array_equal(got, ref)
    else:
        ulp = np.spacing(np.abs(qn * sn).sum(0).astype(np.float32))
        assert (np.abs(got - ref) <= 2 * ulp).all()


def test_dataclass_dither_is_frozen():
    d = Q.dither_key(0, 0, 0, 0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        d.key = 1
