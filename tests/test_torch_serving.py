"""The port's fixed-batch serve path (prefill + greedy decode) against the
JAX package's, on the same weights carried over with
``repro_torch.convert.params_from_jax``, on the CPU (plain kernel versions).
"""

import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import init_state  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.mics import MiCSConfig  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps, pad_ragged_batch  # noqa: E402

B, T0, STEPS, CACHE = 2, 16, 4, 24
# bf16: both packages round activations to bf16 after every matmul and norm,
# with sums taken in different orders.  Measured on the CPU with this file's
# _run_jax / _run_torch: max |diff| of the logits over prefill + 4 decode
# steps 4.3e-2, about 3 bf16 ulps at the logits' scale (|logit| <= 2.9);
# fp32 on the same inputs differs by 4e-6.
BF16_ATOL = 5e-2


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.fixture(scope="module")
def setup(topo1):
    cfg_j = jax_smoke(jax_get_config("llama3.2-1b"))
    model_j = jax_build_model(cfg_j, tp=1)
    params_j = init_state(model_j, topo1, seed=1)["params"]
    params_np = {k: np.asarray(v) for k, v in params_j.items()}
    model_t = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    params_t = params_from_jax(model_t, params_np, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg_j.vocab, (B, T0)).astype(np.int32)
    return model_j, params_j, model_t, params_t, tokens


def _run_jax(setup, topo1, gather_dtype, feed=None):
    model_j, params_j, _, _, tokens = setup
    prefill_fn, decode_fn = jax_serve_steps(
        model_j, topo1, JaxMiCSConfig(gather_dtype=gather_dtype), cache_len=CACHE)
    logits, caches = prefill_fn(params_j, {"tokens": jnp.asarray(tokens)})
    out = {"prefill": _f32(logits), "decode": [], "tokens": [], "caches": []}
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        if feed is not None:
            tok = jnp.asarray(feed[i], jnp.int32)
        logits, tok, caches = decode_fn(params_j, caches, tok, jnp.int32(T0 + i))
        out["decode"].append(_f32(logits))
        out["tokens"].append(np.asarray(tok))
    out["caches"] = {k: _f32(v) for k, v in caches["layers"].items()}
    return out


def _run_torch(setup, gather_dtype, prefetch=True, feed=None):
    _, _, model_t, params_t, tokens = setup
    prefill_fn, decode_fn = build_serve_steps(
        model_t, MiCSTopology(), MiCSConfig(gather_dtype=gather_dtype, prefetch=prefetch),
        CACHE, device="cpu")
    logits, caches = prefill_fn(params_t, {"tokens": torch.from_numpy(tokens).long()})
    out = {"prefill": logits.clone(), "decode": [], "tokens": []}
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    for i in range(STEPS):
        if feed is not None:
            tok = torch.from_numpy(np.array(feed[i])).long()
        logits, tok, caches = decode_fn(params_t, caches, tok, T0 + i)
        out["decode"].append(logits.clone())
        out["tokens"].append(tok.numpy().copy())
    out["caches"] = {k: v.clone() for k, v in caches["layers"].items()}
    return out


def test_serve_matches_jax_fp32(setup, topo1):
    want = _run_jax(setup, topo1, jnp.float32)
    got = _run_torch(setup, torch.float32)
    np.testing.assert_allclose(_f32(got["prefill"]), want["prefill"], rtol=1e-4, atol=1e-4)
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(got["decode"][i]), want["decode"][i],
                                   rtol=1e-4, atol=1e-4, err_msg=f"decode step {i}")
        np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i])
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(got["caches"][name]), want["caches"][name],
                                   rtol=1e-5, atol=1e-5, err_msg=f"cache {name}")


def test_serve_matches_jax_bf16(setup, topo1):
    want = _run_jax(setup, topo1, jnp.bfloat16)
    # feed both packages the same tokens: a bf16 near-tie may round either way
    got = _run_torch(setup, torch.bfloat16, feed=_jax_feed(want))
    np.testing.assert_allclose(_f32(got["prefill"]), want["prefill"], rtol=0, atol=BF16_ATOL)
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(got["decode"][i]), want["decode"][i],
                                   rtol=0, atol=BF16_ATOL, err_msg=f"decode step {i}")


def _jax_feed(want):
    """The tokens JAX fed its decode steps: prefill's argmax, then each
    step's sampled token."""
    first = want["prefill"][:, -1:].argmax(-1).astype(np.int32)
    return [first] + want["tokens"][:-1]


def test_serial_equals_prefetch_bitwise(setup):
    a = _run_torch(setup, torch.bfloat16, prefetch=False)
    b = _run_torch(setup, torch.bfloat16, prefetch=True)
    assert torch.equal(a["prefill"], b["prefill"])
    for x, y in zip(a["decode"], b["decode"]):
        assert torch.equal(x, y)
    for name in ("k", "v"):
        assert torch.equal(a["caches"][name], b["caches"][name])


def test_pad_ragged_batch():
    topo = MiCSTopology(repl=2, shard=2)
    batch, mask = pad_ragged_batch(topo, {"tokens": torch.ones(5, 3, dtype=torch.long)})
    assert batch["tokens"].shape == (8, 3)
    assert mask.tolist() == [True] * 5 + [False] * 3
    assert int(batch["tokens"][5:].abs().sum()) == 0


def test_decode_temperature_refused(setup):
    _, _, model_t, params_t, tokens = setup
    prefill_fn, decode_fn = build_serve_steps(
        model_t, MiCSTopology(), MiCSConfig(), CACHE, device="cpu")
    _, caches = prefill_fn(params_t, {"tokens": torch.from_numpy(tokens).long()})
    with pytest.raises(NotImplementedError, match="sampler"):
        decode_fn(params_t, caches, torch.zeros(B, 1, dtype=torch.long), T0,
                  temps=torch.full((B,), 0.7))


def test_serve_cli_cpu():
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b",
         "--smoke", "--device", "cpu", "--decode-tokens", "4"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "sampled ids:" in proc.stdout


@pytest.mark.parametrize("flag", [["--continuous"], ["--policy", "auto"], ["--quant-gather"]])
def test_serve_cli_refuses_later_slices(flag):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as ei:
        main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", *flag])
    assert ei.value.code == 2


def test_prefill_caches_match_init_caches_layout(setup):
    """Prefill returns per-pool caches stacked like ``init_caches`` builds
    them, in the compute dtype, padded to the cache capacity."""
    from repro_torch.models.lm import init_caches

    _, _, model_t, params_t, tokens = setup
    prefill_fn, _ = build_serve_steps(model_t, MiCSTopology(), MiCSConfig(), CACHE,
                                      device="cpu")
    _, caches = prefill_fn(params_t, {"tokens": torch.from_numpy(tokens).long()})
    zeros = init_caches(model_t, B, CACHE, dtype=torch.bfloat16, device="cpu")
    assert caches.keys() == zeros.keys() == {"layers"}
    for name in ("k", "v"):
        got, want = caches["layers"][name], zeros["layers"][name]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert int(got[:, :, T0:].abs().sum()) == 0  # unwritten slots stay zero


def test_params_from_jax_rejects_mismatch(setup):
    _, params_j, model_t, _, _ = setup
    good = {k: np.asarray(v) for k, v in params_j.items()}
    bad_shape = dict(good, head=good["head"][..., :-1])
    with pytest.raises(ValueError, match="head"):
        params_from_jax(model_t, bad_shape, device="cpu")
    with pytest.raises(ValueError, match="pools"):
        params_from_jax(model_t, {k: v for k, v in good.items() if k != "embed"},
                        device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(model_t, dict(good, embed=good["embed"].astype(np.float64)),
                        device="cpu")
