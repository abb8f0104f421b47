"""The port's VLM backbone (``repro_torch/models/blocks.py``:
``cross_attention``, the gated cross-attention layer; ``models/build.py``'s
super-layer of ``cross_interval`` dense layers and one cross layer;
``models/lm.py``'s ``vision`` input) against the JAX package on the CPU,
at fp32, on inputs made from numpy seeds:

* ``cross_attention`` and ``cross_layer_apply`` at train, prefill and
  decode (the cached vision K/V), with both gates at 1.0;
* smoke llama-3.2-vision-90b (one super-layer of 4 + 1 layers, 16 vision
  rows): the loss and every pool's gradient with ``vision``, the
  fixed-batch prefill and greedy decode;
* the train step slicing ``vision`` by micro-step, the caches' nesting,
  the paged engine's refusal, the configs.

The gates are zero at init (``tanh(0) = 0``: the cross layer is then the
identity and a wrong cross-attention would pass every comparison), so every
test here sets them to 1.0 first.

The shadowing (ROADMAP Queue 3): the reference's sub-layers strip
``len(prefix)`` characters from every name of the pool.  The dense layers'
prefixes ``s0.`` ... ``s3.`` are three characters and the cross layer's
``x.`` two, so the four dense layers run ``s3.``'s norms and MLP and the
cross layer's ``xattn.*`` projections as their attention (``x.xattn.wq``
strips to ``attn.wq``, and ``x.`` comes last); the cross layer runs its
own.  The model tests copy the weights the reference runs over each
sub-layer's own (``torch_dist_cases.tie_shadowed``) and read the port's
gradients on the reference's basis (``torch_dist_cases.on_jax_basis``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.models.build import exact_param_count as jax_exact_param_count  # noqa: E402
from repro.models.dims import attn_dims as jax_attn_dims  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.flat_param import LayoutBuilder  # noqa: E402
from repro_torch.core.mics import MiCSConfig, accumulate_grads, build_train_step  # noqa: E402
from repro_torch.core.mics import init_params, init_state  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import build_model, exact_param_count  # noqa: E402
from repro_torch.models.dims import attn_dims  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402
import torch_dist_cases as K  # noqa: E402

# Port against JAX at fp32, as a fraction of the largest reference value
# (measured on the CPU with this file's inputs: cross attention and the
# cross layer <= 5.3e-7, the loss 0, gradients <= 1.1e-6, prefill and
# decode logits <= 8.2e-7).
TOL = 1e-5
ARCH = "llama-3.2-vision-90b"
GATE = 1.0
T = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what="", tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max |err| {err} > {tol} x {scale}"


def _cfg():
    return smoke_variant(get_config(ARCH)), jax_smoke(jax_get_config(ARCH))


def _dims(cfg_t, cfg_j):
    return (attn_dims(cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.resolved_head_dim, 1),
            jax_attn_dims(cfg_j.d_model, cfg_j.n_heads, cfg_j.n_kv_heads,
                          cfg_j.resolved_head_dim, 1))


def _vision(cfg, b, seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _cross_weights(cfg, seed: int) -> dict:
    """Random tensors of one cross layer's tp = 1 layout (std 0.2, the
    norm scales near 0), both gates at ``GATE``."""
    rng = np.random.default_rng(seed)
    b = LayoutBuilder()
    B.cross_layer_layout(cfg, 1, b)
    out = {s.name: (rng.standard_normal(s.shape) * (0.05 if s.name.endswith("scale") else 0.2)
                    ).astype(np.float32) for s in b.build().segments}
    out["gate_attn"][:] = out["gate_mlp"][:] = GATE
    return out


@pytest.mark.parametrize("what", ["cross_attention", "cross_layer"])
def test_cross_layer_train_prefill_decode_match_jax(what):
    """Cross attention (non-causal over all 16 vision rows) and the gated
    layer at train and prefill over 8 queries, then a decode step from the
    prefill's cached vision K/V: outputs and caches."""
    cfg_t, cfg_j = _cfg()
    ad_t, ad_j = _dims(cfg_t, cfg_j)
    w = _cross_weights(cfg_t, 1)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    vis = _vision(cfg_t, 2, 3)

    def port(x, mode, cache=None):
        ctx = L.Ctx(mode=mode, compute_dtype=torch.float32,
                    vision=None if mode == "decode" else torch.from_numpy(vis))
        with torch.no_grad():
            if what == "cross_attention":
                return B.cross_attention(t, torch.from_numpy(x), ctx.vision, ctx, ad_t, cfg_t,
                                         cache=cache)
            return B.cross_layer_apply(cfg_t, ad_t, t, torch.from_numpy(x), ctx, cache)

    def ref(x, mode, cache=None):
        ctx = JL.Ctx(mode=mode, compute_dtype=jnp.float32,
                     vision=None if mode == "decode" else jnp.asarray(vis))
        if what == "cross_attention":
            return JB.cross_attention(w, x, ctx.vision, ctx, ad_j, cfg_j, cache=cache)
        return JB.cross_layer_apply(cfg_j, ad_j, w, x, ctx, cache)

    for mode in ("train", "prefill"):
        yj, cj = jax.jit(lambda x: ref(x, mode))(x[:, :8])
        yt, ct = port(x[:, :8], mode)
        _close(yt.numpy(), yj, f"{what} {mode}")
        assert (ct is None) == (cj is None) == (mode == "train")
    for name in ("k", "v"):
        _close(ct[name].numpy(), cj[name], f"{what} cache {name}")
        assert ct[name].shape == (2, 16, 2, 16)
    yj, _ = jax.jit(lambda x, c: ref(x, "decode", c))(x[:, 8:], cj)
    yt, new = port(x[:, 8:], "decode", ct)
    assert new is ct
    _close(yt.numpy(), yj, f"{what} decode")


def test_gates_zero_make_the_layer_the_identity():
    """At init (both gates 0) the cross layer returns its input bitwise:
    why every other test sets them to 1.0."""
    cfg_t, _ = _cfg()
    ad_t, _ = _dims(*_cfg())
    w = {k: torch.from_numpy(v) for k, v in _cross_weights(cfg_t, 4).items()}
    w["gate_attn"].zero_()
    w["gate_mlp"].zero_()
    x = torch.randn(2, 5, 64)
    ctx = L.Ctx(mode="train", compute_dtype=torch.float32, vision=torch.randn(2, 16, 64))
    y, _ = B.cross_layer_apply(cfg_t, ad_t, w, x, ctx)
    assert torch.equal(y, x)


def test_gate_gradient_is_summed_over_the_model_group():
    """A gate is stored whole on every model rank (no model gather): in
    training at tp > 1 its gradient, each rank's share of the loss's, is
    summed over the model group (``layers.tp_replicated``); at tp 1, and
    without autograd, the gate passes as it is."""
    class Comm:
        calls = 0

        def model_psum(self, x):
            Comm.calls += 1
            return 2.0 * x            # two ranks holding the same share

    g = torch.tensor([0.5], requires_grad=True)
    ctx = L.Ctx(mode="train", tp=2, comm=Comm())
    x = torch.randn(2, 3, 4)
    (B._gate(g, x, ctx) * x).sum().backward()
    want = (1.0 - torch.tanh(torch.tensor(0.5)) ** 2) * x.sum()
    assert Comm.calls == 1 and torch.allclose(g.grad, 2.0 * want)
    assert L.tp_replicated(g, L.Ctx(mode="train")) is g
    with torch.no_grad():
        assert L.tp_replicated(g, ctx) is g


def test_reference_shadowing_is_the_documented_one():
    """The VLM super-layer's shadowing: each dense layer runs ``s3.``'s
    norms and MLP and the cross layer's ``xattn.*`` as its attention; the
    cross layer runs its own weights."""
    model = build_model(_cfg()[0], tp=1)
    (pool,) = model.pools
    assert K.sublayer_prefixes(model, pool) == ["s0.", "s1.", "s2.", "s3.", "x."]
    reads = K.reference_reads(pool.layout, K.sublayer_prefixes(model, pool))
    for own, won in reads.items():
        if own.startswith("x."):
            assert won == own
        elif own[3:].startswith("attn."):
            assert won == "x.x" + own[3:]
        else:
            assert won == "s3." + own[3:]


def _set_gates(model, params: dict, value: float = GATE) -> dict:
    """The flat rows with both gates of every cross layer at ``value``."""
    lay = model.pool("layers").layout
    rows = np.array(params["layers"], copy=True)
    for name in ("x.gate_attn", "x.gate_mlp"):
        sg = lay.seg(name)
        rows[..., sg.offset:sg.end] = value
    return dict(params, layers=rows)


@pytest.fixture(scope="module")
def vlm():
    """The smoke model in both packages from the port's ``init_params``
    (the reference's layout and init scales), the gates at 1.0 and the
    shadowing tied, one micro-batch of 2 x 16 with its vision rows."""
    cfg_t, cfg_j = _cfg()
    model_j = jax_build_model(cfg_j, tp=1)
    model = build_model(cfg_t, tp=1)
    assert [(p.name, p.stack) for p in model.pools] == [("layers", 1)]
    params_np = {k: v.numpy() for k, v in init_params(model, 5, device="cpu").items()}
    params_np = K.tie_shadowed(model_j, _set_gates(model, params_np))
    rng = np.random.default_rng(6)
    shape = (1, 2, T)
    batch = {"tokens": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "targets": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "mask": (rng.uniform(size=shape) < 0.9).astype(np.float32),
             "vision": _vision(cfg_t, 2, 7, lead=(1,))}
    return model, model_j, params_np, batch


def _jax_loss_and_grads(model_j, topo1, params_np, batch):
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.comm import CommEngine as JaxCommEngine
    from repro.core.mics import batch_pspecs, state_pspecs
    from repro.models import lm as JLM

    comm = JaxCommEngine.from_config(topo1, JaxMiCSConfig(gather_dtype=jnp.float32))
    ctx = JL.Ctx(mode="train", compute_dtype=jnp.float32)

    def loss_and_grads(params, mb):
        (loss, _), g = jax.value_and_grad(
            lambda p: JLM.loss_fn(model_j, p, comm, ctx, mb), has_aux=True)(params)
        return loss, g

    pspec = state_pspecs(model_j, topo1)["params"]
    fn = jax.jit(shard_map(loss_and_grads, mesh=topo1.mesh,
                           in_specs=(pspec, batch_pspecs(model_j, topo1, micro=False)),
                           out_specs=(P(), pspec), check_vma=False))
    loss, grads = fn({k: jnp.asarray(v) for k, v in params_np.items()},
                     {k: jnp.asarray(v[0]) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_loss_and_grads_with_vision_match_jax(vlm, topo1):
    """``accumulate_grads`` (one micro-step with its vision rows, fp32)
    against ``jax.grad`` of the reference's loss, gates at 1.0, the
    shadowing tied, the gradients on the reference's basis; the gates'
    own gradients are nonzero."""
    model, model_j, params_np, batch = vlm
    want_loss, want = _jax_loss_and_grads(model_j, topo1, params_np, batch)
    params = params_from_jax(model, params_np, device="cpu")
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32))
    grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train",
                                                         compute_dtype=torch.float32),
                                      params, {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(loss.item(), want_loss, "loss")
    got = K.on_jax_basis(model, grads)
    for name, w in want.items():
        assert np.abs(w).max() > 0
        _close(got[name], w, f"grad {name}")
    lay = model.pool("layers").layout
    for gate in ("x.gate_attn", "x.gate_mlp"):
        sg = lay.seg(gate)
        assert abs(float(want["layers"][0, 0, sg.offset])) > 0, gate


def test_train_step_slices_vision_by_micro_step(vlm):
    """``build_train_step`` on 2 micro-steps: its loss is the mean of
    ``loss_fn`` on each micro-step's tokens with that micro-step's vision
    rows, and not with the rows swapped."""
    model, _, params_np, batch = vlm
    two = {k: np.concatenate([v, v[:, ::-1].copy()]) if k != "vision"
           else np.concatenate([v, _vision(model.cfg, 2, 8, lead=(1,))]) for k, v in batch.items()}
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32))
    ctx = L.Ctx(mode="train", compute_dtype=torch.float32)
    params = params_from_jax(model, params_np, device="cpu")

    def loss_of(mb, vision):
        micro = {k: torch.as_tensor(two[k][mb]) for k in ("tokens", "targets", "mask")}
        with torch.no_grad():
            return lm.loss_fn(model, params, comm, ctx, dict(
                micro, vision=torch.as_tensor(two["vision"][vision])))[1]["loss"].item()

    want = (loss_of(0, 0) + loss_of(1, 1)) / 2
    swapped = (loss_of(0, 1) + loss_of(1, 0)) / 2
    assert abs(want - swapped) > 1e-4
    state = init_state(model, 0, device="cpu")
    state["params"] = {k: v.clone() for k, v in params.items()}
    step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=2,
                                                              gather_dtype=torch.float32),
                            OptConfig(total_steps=4, warmup_steps=0), device="cpu")
    _, m = step(state, two)
    assert abs(m["loss"].item() - want) <= TOL * abs(want)


def test_serve_prefill_and_decode_match_jax(vlm, topo1):
    """The fixed batch: prefill of 2 x 16 with the vision rows, then 3
    greedy steps over the cached cross K/V: logits within TOL, tokens
    equal."""
    model, model_j, params_np, _ = vlm
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, 256, (2, 16)).astype(np.int32)
    vis = _vision(model.cfg, 2, 10)
    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32), 24)
    pt, dt = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32), 24,
                               device="cpu")
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_jax(model, params_np, device="cpu")
    lj, cj = pj(params_j, {"tokens": jnp.asarray(tokens), "vision": jnp.asarray(vis)})
    lt, ct = pt(params, {"tokens": torch.from_numpy(tokens).long(),
                         "vision": torch.from_numpy(vis)})
    _close(lt.numpy(), lj, "prefill")
    assert set(ct["layers"]) == {"s0", "s1", "s2", "s3", "x"}
    _close(ct["layers"]["x"]["k"].float().numpy(), cj["layers"]["x"]["k"], "cross k cache")
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(3):
        lj, tok_j, cj = dj(params_j, cj, tok_j, jnp.int32(16 + i))
        lt, tok_t, ct = dt(params, ct, tok_t, 16 + i)
        _close(lt.numpy(), lj, f"decode {i}")
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_caches_nest_by_sub_layer():
    """``init_caches``: ``{"s0": {k, v}, ..., "x": {k, v}}`` a super-layer,
    the self-attention caches at the cache length, the cross cache at the
    vision rows, stacked over the pool's super-layers; the layer views
    write through."""
    cfg = dataclasses.replace(_cfg()[0], n_layers=10)
    model = build_model(cfg, tp=1)
    caches = lm.init_caches(model, 2, 24, device="cpu")["layers"]
    assert set(caches) == {"s0", "s1", "s2", "s3", "x"}
    assert caches["s2"]["k"].shape == (2, 2, 24, 2, 16)
    assert caches["x"]["v"].shape == (2, 2, 16, 2, 16)
    assert caches["x"]["k"].dtype == torch.bfloat16
    lm._layer_cache(caches, 1)["x"]["k"].fill_(1.0)
    assert caches["x"]["k"][1].eq(1.0).all() and not caches["x"]["k"][0].any()


def test_paged_engine_refuses_the_vlm():
    """As the reference's: the VLM's cache is not a plain k/v dict."""
    model = build_model(_cfg()[0], tp=1)
    with pytest.raises(NotImplementedError, match="not a plain k/v dict"):
        PG.build_paged_step(model, MiCSTopology(), MiCSConfig(), max_blocks=2, device="cpu")
    with pytest.raises(NotImplementedError, match="not a plain k/v dict"):
        PG.init_paged_caches(model, MiCSTopology(), 4, 16, device="cpu")


def test_layer_count_must_divide_and_configs_are_the_reference():
    for full in (False, True):
        cfg_t, cfg_j = _cfg() if not full else (get_config(ARCH), jax_get_config(ARCH))
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert exact_param_count(cfg_t) == jax_exact_param_count(cfg_j)
    assert (_cfg()[0].n_layers, _cfg()[0].n_vision_tokens) == (5, 16)
    with pytest.raises(ValueError, match="divide"):
        build_model(dataclasses.replace(_cfg()[0], n_layers=6), tp=1)
