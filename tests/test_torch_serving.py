"""The port's fixed-batch serve path (prefill + greedy decode) against the
JAX package's, on the same weights carried over with
``repro_torch.convert.params_from_jax``, on the CPU (plain kernel versions).

Three models: smoke llama3.2-1b, and smoke recurrentgemma-2b at 6 layers
(pool ``g`` x2) and at 5 layers (``g`` x1 + ``gtail`` x1).  The griffin
prompt (40) is longer than the smoke window (32), so the attention cache is
rolled at prefill and the decode writes wrap around it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
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

STEPS = 4
# case id -> (arch, n_layers or None for the smoke default, batch, prompt, cache_len)
CASES = {
    "llama3.2-1b": ("llama3.2-1b", None, 2, 16, 24),
    "recurrentgemma-2b": ("recurrentgemma-2b", None, 2, 40, 44),
    "recurrentgemma-2b-L5": ("recurrentgemma-2b", 5, 2, 40, 44),
}
# bf16: both packages round activations to bf16 after every matmul and norm,
# with sums taken in different orders.  Measured on the CPU with this file's
# _run_jax / _run_torch, max |diff| of the logits over prefill + 4 decode
# steps: llama 4.3e-2, about 3 bf16 ulps at the logits' scale
# (|logit| <= 2.9); fp32 on the same inputs differs by 4e-6.
# recurrentgemma (prompt 40, |logit| <= 3.5) is noisier in bf16 in both
# packages: the port is 9.0e-2 (6 layers) and 8.6e-2 (5 layers) from JAX,
# while JAX's own bf16 run is up to 1.45e-1 from its fp32 run.  Its bound is
# 8 bf16 ulps at |logit| < 4, and the port must also stay as close to JAX's
# bf16 run as that run is to JAX's fp32 run.
BF16_ATOL = {"llama3.2-1b": 5e-2, "recurrentgemma-2b": 1.25e-1,
             "recurrentgemma-2b-L5": 1.25e-1}
# fp32, free-running decode: griffin stores its conv state as bf16 even at
# fp32 (as the reference does), so an fp32 input that differs by ~1e-6
# between the packages can round to the neighbouring bf16 value (measured:
# 1 of 384 conv-state elements after prefill at 6 layers).  That one-ulp
# difference enters the next 3 decode steps: logits then differ by up to
# 4.7e-4 and the fp32 cache leaves by up to 9.5e-4 after 4 steps (5 layers;
# 1.9e-4 and 3.0e-4 at 6).  Each step from equal state is held to
# 1e-4 / 1e-5 in test_decode_steps_match_jax_fp32.
FREE_RUN_ATOL = {"llama3.2-1b": (1e-4, 1e-5), "recurrentgemma-2b": (1e-3, 2e-3),
                 "recurrentgemma-2b-L5": (1e-3, 2e-3)}


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _leaves(tree, path=""):
    """{"pool/prefix/leaf": array} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _from_leaves(template, leaves, path=""):
    """A nested dict shaped like ``template`` with each tensor replaced by
    ``leaves[path]`` (numpy) in the template's dtype."""
    if isinstance(template, dict):
        return {k: _from_leaves(v, leaves, f"{path}/{k}" if path else k)
                for k, v in template.items()}
    return torch.from_numpy(np.array(leaves[path])).to(template.dtype)


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7).astype(np.float32)


def _assert_cache_close(got, want, atol, what):
    """Every leaf in JAX's dtype; fp32 leaves within ``atol``; bf16 leaves
    (griffin's conv state) within ``atol`` plus one bf16 ulp: an fp32 value
    that differs slightly between the packages may round to either
    neighbour."""
    assert got.keys() == want.keys(), what
    for name, (dtype, arr) in want.items():
        g = got[name]
        assert str(g.dtype).removeprefix("torch.") == dtype, (what, name)
        if dtype == "bfloat16":
            d = np.abs(_f32(g) - arr)
            assert (d <= atol + _bf16_ulp(np.maximum(np.abs(arr), np.abs(_f32(g))))).all(), \
                (what, name, float(d.max()))
        else:
            np.testing.assert_allclose(_f32(g), arr, rtol=atol, atol=atol,
                                       err_msg=f"{what}: cache {name}")


def _tie_rec_weights(model_j, params_np):
    """Copy each griffin super-layer's ``rec1.*`` segments over its
    ``rec0.*`` ones.  The reference strips a sub-layer's prefix from every
    name of the super-layer, so ``rec1.x`` shadows ``rec0.x`` and both of its
    recurrent sub-layers run ``rec1``'s weights; the port gives each its
    own.  With rec0 == rec1 the two compute the same function."""
    out = dict(params_np)
    for pool in model_j.pools:
        segs = {s.name: s for s in pool.layout.segments}
        arr = None
        for name, s0 in segs.items():
            if name.startswith("rec0."):
                s1 = segs["rec1." + name[len("rec0."):]]
                if arr is None:
                    arr = np.array(out[pool.name], copy=True)
                arr[..., s0.offset:s0.end] = arr[..., s1.offset:s1.end]
        if arr is not None:
            out[pool.name] = arr
    return out


@pytest.fixture(scope="module", params=list(CASES))
def setup(request, topo1):
    arch, n_layers, b, t0, cache = CASES[request.param]
    cfg_j, cfg_t = jax_smoke(jax_get_config(arch)), smoke_variant(get_config(arch))
    if n_layers is not None:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    model_j = jax_build_model(cfg_j, tp=1)
    params_j = init_state(model_j, topo1, seed=1)["params"]
    params_np = _tie_rec_weights(model_j, {k: np.asarray(v) for k, v in params_j.items()})
    params_j = {k: jax.device_put(params_np[k], v.sharding) for k, v in params_j.items()}
    model_t = build_model(cfg_t, tp=1)
    params_t = params_from_jax(model_t, params_np, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg_j.vocab, (b, t0)).astype(np.int32)
    return dict(case=request.param, model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, tokens=tokens, B=b, T0=t0, CACHE=cache)


def _cache_np(caches):
    return {k: (str(v.dtype).removeprefix("torch."), _f32(v))
            for k, v in _leaves(caches).items()}


def _run_jax(s, topo1, gather_dtype, feed=None):
    """Prefill + STEPS greedy steps; ``states[i]`` is the cache before step i
    (``states[0]`` the prefill's), ``states[-1]`` the final one.  Runs
    without ``feed`` are kept in ``s`` and reused across tests."""
    key = ("jax", jnp.dtype(gather_dtype).name)
    if feed is None and key in s:
        return s[key]
    prefill_fn, decode_fn = jax_serve_steps(
        s["model_j"], topo1, JaxMiCSConfig(gather_dtype=gather_dtype), cache_len=s["CACHE"])
    logits, caches = prefill_fn(s["params_j"], {"tokens": jnp.asarray(s["tokens"])})
    out = {"prefill": _f32(logits), "decode": [], "tokens": [], "states": [_cache_np(caches)]}
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        if feed is not None:
            tok = jnp.asarray(feed[i], jnp.int32)
        logits, tok, caches = decode_fn(s["params_j"], caches, tok, jnp.int32(s["T0"] + i))
        out["decode"].append(_f32(logits))
        out["tokens"].append(np.asarray(tok))
        out["states"].append(_cache_np(caches))
    out["caches"] = out["states"][-1]
    if feed is None:
        s[key] = out
    return out


def _run_torch(s, gather_dtype, prefetch=True, feed=None, states=None):
    """As _run_jax; with ``states`` (JAX's), each decode step starts from
    JAX's cache of that step instead of the port's own."""
    prefill_fn, decode_fn = build_serve_steps(
        s["model_t"], MiCSTopology(), MiCSConfig(gather_dtype=gather_dtype, prefetch=prefetch),
        s["CACHE"], device="cpu")
    logits, caches = prefill_fn(s["params_t"], {"tokens": torch.from_numpy(s["tokens"]).long()})
    out = {"prefill": logits.clone(), "decode": [], "tokens": [], "states": [_leaves(caches)]}
    out["states"][0] = {k: v.clone() for k, v in out["states"][0].items()}
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    for i in range(STEPS):
        if feed is not None:
            tok = torch.from_numpy(np.array(feed[i])).long()
        if states is not None:
            caches = _from_leaves(caches, {k: a for k, (_, a) in states[i].items()})
        logits, tok, caches = decode_fn(s["params_t"], caches, tok, s["T0"] + i)
        out["decode"].append(logits.clone())
        out["tokens"].append(tok.numpy().copy())
        out["states"].append({k: v.clone() for k, v in _leaves(caches).items()})
    out["caches"] = out["states"][-1]
    return out


def test_serve_matches_jax_fp32(setup, topo1):
    want = _run_jax(setup, topo1, jnp.float32)
    got = _run_torch(setup, torch.float32)
    logit_atol, cache_atol = FREE_RUN_ATOL[setup["case"]]
    np.testing.assert_allclose(_f32(got["prefill"]), want["prefill"], rtol=1e-4, atol=1e-4)
    _assert_cache_close(got["states"][0], want["states"][0], 1e-5, "prefill")
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(got["decode"][i]), want["decode"][i],
                                   rtol=logit_atol, atol=logit_atol, err_msg=f"decode step {i}")
        np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i])
    # every cache leaf (k, v; griffin also conv, h), in JAX's dtypes
    _assert_cache_close(got["caches"], want["caches"], cache_atol, "final")


def test_decode_steps_match_jax_fp32(setup, topo1):
    """Each greedy step from JAX's own cache of that step (so an earlier
    one-ulp rounding of griffin's bf16 conv state does not carry over):
    logits within 1e-4, equal tokens, the updated cache within 1e-5."""
    want = _run_jax(setup, topo1, jnp.float32)
    got = _run_torch(setup, torch.float32, feed=_jax_feed(want), states=want["states"])
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(got["decode"][i]), want["decode"][i],
                                   rtol=1e-4, atol=1e-4, err_msg=f"decode step {i}")
        np.testing.assert_array_equal(got["tokens"][i], want["tokens"][i])
        _assert_cache_close(got["states"][i + 1], want["states"][i + 1], 1e-5, f"step {i}")


def test_serve_matches_jax_bf16(setup, topo1):
    want = _run_jax(setup, topo1, jnp.bfloat16)
    feed = _jax_feed(want)
    # feed both packages the same tokens: a bf16 near-tie may round either way
    got = _run_torch(setup, torch.bfloat16, feed=feed)
    atol = BF16_ATOL[setup["case"]]
    np.testing.assert_allclose(_f32(got["prefill"]), want["prefill"], rtol=0, atol=atol)
    for i in range(STEPS):
        np.testing.assert_allclose(_f32(got["decode"][i]), want["decode"][i],
                                   rtol=0, atol=atol, err_msg=f"decode step {i}")
    # no farther from JAX's bf16 run than that run is from JAX's fp32 run
    ref = _run_jax(setup, topo1, jnp.float32, feed=feed)
    outs = lambda r: [_f32(r["prefill"])] + [_f32(x) for x in r["decode"]]  # noqa: E731
    gap = max(np.abs(a - b).max() for a, b in zip(outs(got), outs(want)))
    noise = max(np.abs(a - b).max() for a, b in zip(outs(want), outs(ref)))
    assert gap <= noise, (gap, noise)


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
    assert a["caches"].keys() == b["caches"].keys()
    for name in a["caches"]:
        assert torch.equal(a["caches"][name], b["caches"][name]), name


def test_pad_ragged_batch():
    topo = MiCSTopology(repl=2, shard=2)
    batch, mask = pad_ragged_batch(topo, {"tokens": torch.ones(5, 3, dtype=torch.long)})
    assert batch["tokens"].shape == (8, 3)
    assert mask.tolist() == [True] * 5 + [False] * 3
    assert int(batch["tokens"][5:].abs().sum()) == 0


def test_decode_temperature_refused(setup):
    """Temperature > 0 is no longer refused: the decode step samples the
    token at ``pos + 1`` with the seeded sampler (``lm.sample_tokens``),
    and rows at temperature 0 take the greedy argmax, as without ``temps``."""
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx

    prefill_fn, decode_fn = build_serve_steps(
        setup["model_t"], MiCSTopology(), MiCSConfig(), setup["CACHE"], device="cpu", top_k=5)
    b, tok = setup["B"], torch.zeros(setup["B"], 1, dtype=torch.long)
    seeds, temps = torch.arange(b) + 3, torch.tensor([0.7] + [0.0] * (b - 1))
    outs = []
    for kw in (dict(seeds=seeds, temps=temps), {}):
        _, caches = prefill_fn(setup["params_t"],
                               {"tokens": torch.from_numpy(setup["tokens"]).long()})
        outs.append(decode_fn(setup["params_t"], caches, tok, setup["T0"], **kw))
    (logits, sampled, _), (_, greedy, _) = outs
    want = lm.sample_tokens(logits[:, -1], Ctx(), setup["model_t"].cfg.vocab, seed=seeds,
                            pos=torch.full((b,), setup["T0"] + 1), temperature=temps, top_k=5)
    assert torch.equal(sampled[:, 0], want)
    assert torch.equal(sampled[1:], greedy[1:])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_serve_cli_cpu(arch):
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--decode-tokens", "4"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "sampled ids:" in proc.stdout


@pytest.mark.parametrize("flag", [["--continuous"], ["--policy", "auto"], ["--quant-gather"]])
def test_serve_cli_refuses_later_slices(flag, capsys, monkeypatch):
    """``--policy auto`` serves on the autotuner's choice (its ranked table
    and the chosen serve policy printed first); ``--quant-gather`` serves from stored int8 weights and ``--continuous``
    through the resilient engine, whose every fault kind runs (``grow``
    needs ranks to win back: on one process the plan is refused before
    anything runs, as one that empties the world); under ``torchrun``
    (``WORLD_SIZE`` > 1) the fixed-batch path, which serves on one rank,
    and a missing ``--dist-backend`` are refused."""
    from repro_torch.launch.serve import main

    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", *flag]
    if flag == ["--quant-gather"]:
        main([*argv, "--decode-tokens", "2"])
        assert "int8 weights" in capsys.readouterr().out
        return
    if flag == ["--policy", "auto"]:
        main([*argv, "--decode-tokens", "2", "--link-profile", "efa-400g"])
        out = capsys.readouterr().out
        assert "autotune[efa-400g] mode=serve" in out and "serve policy: kv_dtype=" in out
        assert "decoded 2 tokens x2" in out and "sampled ids:" in out
        return
    if flag == ["--continuous"]:
        main([*argv, "--requests", "2", "--decode-tokens", "2",
              "--fault-plan", "slow@1x2,crash@2"])
        out = capsys.readouterr().out
        assert "served 2/2 requests" in out and '"kind": "crash"' in out
        for plan in ("grow@3x1", "preempt@1", "evict@2"):
            with pytest.raises(SystemExit) as ei:
                main([*argv, "--fault-plan", plan])
            assert ei.value.code == 2
        assert "the launch world has 1" in capsys.readouterr().err
        monkeypatch.setenv("WORLD_SIZE", "2")
        fixed_batch = [*argv[:-1], "--dist-backend", "gloo"]   # no --continuous
        for args in (argv, fixed_batch):
            with pytest.raises(SystemExit) as ei:
                main(args)
            assert ei.value.code == 2
        err = capsys.readouterr().err
        assert "--dist-backend nccl or gloo is required" in err
        assert "the fixed-batch path serves on one rank" in err
        return


def test_prefill_caches_match_init_caches_layout(setup):
    """Prefill returns per-pool caches stacked like ``init_caches`` builds
    them: the same nested structure, shapes and dtypes (KV in the compute
    dtype, padded to the cache capacity; griffin conv bf16 and h fp32)."""
    from repro_torch.models.lm import init_caches

    prefill_fn, _ = build_serve_steps(setup["model_t"], MiCSTopology(), MiCSConfig(),
                                      setup["CACHE"], device="cpu")
    _, caches = prefill_fn(setup["params_t"],
                           {"tokens": torch.from_numpy(setup["tokens"]).long()})
    zeros = init_caches(setup["model_t"], setup["B"], setup["CACHE"], dtype=torch.bfloat16,
                        device="cpu")
    assert caches.keys() == zeros.keys() == {p.name for p in setup["model_t"].pools}
    got, want = _leaves(caches), _leaves(zeros)
    assert got.keys() == want.keys()
    t0 = setup["T0"]
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype, name
        if name.endswith(("/k", "/v")) and w.shape[2] > t0:
            assert int(got[name][:, :, t0:].abs().sum()) == 0  # unwritten slots stay zero


def test_griffin_caches_and_pools():
    """recurrentgemma's caches: bf16 conv and fp32 h whatever the compute
    dtype, a KV cache of min(window, cache_len) slots; pools g (+ gtail)."""
    from repro_torch.models.lm import init_caches

    cfg = smoke_variant(get_config("recurrentgemma-2b"))
    for n_layers, pools in ((6, {"g": 2}), (5, {"g": 1, "gtail": 1})):
        model = build_model(dataclasses.replace(cfg, n_layers=n_layers), tp=1)
        assert {p.name: p.stack for p in model.pools} == pools
        caches = init_caches(model, 3, 44, dtype=torch.float32, device="cpu")
        g = caches["g"]
        assert set(g) == {"rec0.", "rec1.", "attn0."}
        assert g["rec0."]["conv"].dtype == torch.bfloat16
        assert g["rec0."]["conv"].shape == (pools["g"], 3, cfg.conv_width - 1, cfg.lru_width)
        assert g["rec1."]["h"].dtype == torch.float32
        assert g["rec1."]["h"].shape == (pools["g"], 3, cfg.lru_width)
        assert g["attn0."]["k"].dtype == torch.float32
        assert g["attn0."]["k"].shape == (pools["g"], 3, cfg.window, 1, cfg.head_dim)
        if "gtail" in caches:
            assert set(caches["gtail"]) == {"rec0.", "rec1."}


def test_params_from_jax_rejects_mismatch(setup):
    good = {k: np.asarray(v) for k, v in setup["params_j"].items()}
    model_t = setup["model_t"]
    bad_shape = dict(good, head=good["head"][..., :-1])
    with pytest.raises(ValueError, match="head"):
        params_from_jax(model_t, bad_shape, device="cpu")
    with pytest.raises(ValueError, match="pools"):
        params_from_jax(model_t, {k: v for k, v in good.items() if k != "embed"},
                        device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(model_t, dict(good, embed=good["embed"].astype(np.float64)),
                        device="cpu")
    for pool in model_t.pools:  # every layer pool is checked, griffin's too
        with pytest.raises(ValueError, match=pool.name):
            params_from_jax(model_t, dict(good, **{pool.name: good[pool.name][:, :, :-1]}),
                            device="cpu")
