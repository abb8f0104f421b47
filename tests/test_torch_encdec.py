"""The port's encoder-decoder family (whisper-large-v3) and its LayerNorm +
GeLU layers against the JAX package on the CPU, at fp32, on inputs made
from numpy seeds:

* ``layers.layer_norm`` and ``layers.mlp_gelu``;
* one encoder layer (a dense layer, non-causal, biased MLP) and one decoder
  layer (causal biased self-attention, biased cross-attention over the
  encoder output, the MLP) at train, prefill and decode (the cached self
  and cross K/V);
* smoke whisper (2 encoder + 2 decoder layers, 16 audio frames): the
  fixed-batch prefill, 3 greedy decode steps and their tokens; one
  micro-step's loss and every pool's gradient, the encoder's included,
  under the serial schedule and under prefetch with the stored, remat and
  host carries (serial == prefetch bitwise within the port under each);
* the train step slicing ``audio`` by micro-step, the caches' nesting, the
  paged engine's refusal, the launcher's.

Every norm scale, norm bias and linear bias is zero at init, where a
swapped scale and bias, or a dropped bias, would pass: every test here sets
them to random values first (``torch_dist_cases.numpy_params``: 0.1 std).
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
from repro.models.dims import attn_dims as jax_attn_dims  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.flat_param import LayoutBuilder  # noqa: E402
from repro_torch.core.mics import MiCSConfig, accumulate_grads, build_train_step  # noqa: E402
from repro_torch.core.mics import init_state  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.models.dims import attn_dims  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402
import torch_dist_cases as K  # noqa: E402

# Port against JAX at fp32, as a fraction of the largest reference value
# (measured on the CPU with this file's inputs: layer_norm and mlp_gelu
# <= 2.2e-7, in bf16 0 and 4.6e-3 of their 1e-2; the layers and caches <=
# 6.9e-7, the loss 0, gradients <= 8.7e-7, prefill and decode logits <=
# 8.1e-7).
TOL = 1e-5
ARCH = "whisper-large-v3"
T = 16
CAP = 24
CARRIES = {"stored": {}, "remat": {"prefetch_carry": "remat"},
           "host": {"carry_offload": "host"}}


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


def _dims(cfg):
    return (attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 1),
            jax_attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 1))


def _audio(cfg, b, seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((*lead, b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _weights(layout_fn, cfg, seed: int) -> dict:
    """Random tensors of one layer's tp = 1 layout: weights std 0.2, norm
    scales and every bias 0.1 (nonzero: they are zero at init)."""
    rng = np.random.default_rng(seed)
    b = LayoutBuilder()
    layout_fn(cfg, 1, b)
    return {s.name: (rng.standard_normal(s.shape) * (0.2 if s.init == "normal" else 0.1)
                     ).astype(np.float32) for s in b.build().segments}


def test_layer_norm_and_mlp_gelu_match_jax():
    """LayerNorm (fp32 statistics, ``(1 + scale)``, then the bias) on
    inputs with a mean far from 0 and in bf16, and the biased tanh-GeLU
    MLP; each in fp32 and bf16 against the reference's function."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 3).astype(np.float32)
    sc, bi = (rng.standard_normal(64).astype(np.float32) * 0.3 for _ in range(2))
    w1 = rng.standard_normal((64, 96)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(96).astype(np.float32) * 0.3
    w2 = rng.standard_normal((96, 64)).astype(np.float32) * 0.2
    for tdt, jdt, tol in ((torch.float32, jnp.float32, TOL), (torch.bfloat16, jnp.bfloat16, 1e-2)):
        t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
        j = lambda a: jnp.asarray(a).astype(jdt)   # noqa: E731
        got = L.layer_norm(t(x), t(sc), t(bi))
        assert got.dtype == tdt
        _close(got.float().numpy(), JL.layer_norm(j(x), j(sc), j(bi)).astype(jnp.float32),
               f"layer_norm {tdt}", tol)
        _close(L.mlp_gelu(t(x), t(w1), t(b1), t(w2)).float().numpy(),
               JL.mlp_gelu(j(x), j(w1), j(b1), j(w2)).astype(jnp.float32),
               f"mlp_gelu {tdt}", tol)


def test_swapped_norm_scale_and_bias_differ():
    """Why the weights are random: at init (scale and bias 0) LayerNorm
    with the two swapped is the same function; with them random, not."""
    x = torch.randn(2, 7, 64)
    zero = torch.zeros(64)
    assert torch.equal(L.layer_norm(x, zero, zero), L.layer_norm(x, zero.clone(), zero.clone()))
    sc, bi = torch.randn(64) * 0.1, torch.randn(64) * 0.1
    assert (L.layer_norm(x, sc, bi) - L.layer_norm(x, bi, sc)).abs().max() > 1e-2


def test_encoder_layer_matches_jax():
    """One encoder layer (the dense layer, non-causal, LayerNorm, no
    attention biases: ``qkv_bias`` is False) over the 16 frames."""
    cfg_t, cfg_j = _cfg()
    ad_t, ad_j = _dims(cfg_t)
    w = _weights(B.dense_layer_layout, cfg_t, 1)
    assert "ln1.bias" in w and "mlp.b2" in w and "attn.bq" not in w
    x = _audio(cfg_t, 2, 2)
    yj, _ = jax.jit(lambda x: JB.dense_layer_apply(
        cfg_j, ad_j, w, x, JL.Ctx(mode="train", compute_dtype=jnp.float32), causal=False))(x)
    with torch.no_grad():
        yt, _ = B.dense_layer_apply(cfg_t, ad_t, {k: torch.from_numpy(v) for k, v in w.items()},
                                    torch.from_numpy(x),
                                    L.Ctx(mode="train", compute_dtype=torch.float32),
                                    causal=False)
    _close(yt.numpy(), yj, "encoder layer")


def test_decoder_layer_train_prefill_decode_match_jax():
    """One decoder layer at train and prefill over 8 tokens attending to 16
    encoder rows, then a decode step from the prefill's caches (the self
    K/V at the cache length, the cross K/V of the encoder rows): outputs
    and caches."""
    cfg_t, cfg_j = _cfg()
    ad_t, ad_j = _dims(cfg_t)
    w = _weights(B.encdec_dec_layout, cfg_t, 3)
    assert {"lnx.bias", "attn.bq", "xattn.bo", "mlp.b1"} <= set(w)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    enc = _audio(cfg_t, 2, 5)

    def port(x, mode, cache=None, pos=None):
        ctx = L.Ctx(mode=mode, compute_dtype=torch.float32, cache_len=CAP, pos=pos,
                    enc_out=None if mode == "decode" else torch.from_numpy(enc))
        with torch.no_grad():
            return B.encdec_dec_apply(cfg_t, ad_t, t, torch.from_numpy(x), ctx, cache)

    def ref(x, mode, cache=None, pos=None):
        ctx = JL.Ctx(mode=mode, compute_dtype=jnp.float32, cache_len=CAP, pos=pos,
                     enc_out=None if mode == "decode" else jnp.asarray(enc))
        return JB.encdec_dec_apply(cfg_j, ad_j, w, x, ctx, cache)

    for mode in ("train", "prefill"):
        yj, cj = jax.jit(lambda x: ref(x, mode))(x[:, :8])
        yt, ct = port(x[:, :8], mode)
        _close(yt.numpy(), yj, f"decoder {mode}")
        assert (ct is None) == (cj is None) == (mode == "train")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            _close(ct[part][name].numpy(), cj[part][name], f"cache {part}.{name}")
    assert ct["self"]["k"].shape == (2, CAP, 4, 16) and ct["cross"]["k"].shape == (2, 16, 4, 16)
    yj, _ = jax.jit(lambda x, c: ref(x, "decode", c, jnp.int32(8)))(x[:, 8:], cj)
    yt, new = port(x[:, 8:], "decode", ct, 8)
    assert new["self"] is ct["self"] and new["cross"] is ct["cross"]
    _close(yt.numpy(), yj, "decoder decode")


@pytest.fixture(scope="module")
def whisper():
    """The smoke model in both packages from ``K.numpy_params`` (every norm
    scale and bias random), one micro-batch of 2 x 16 tokens with 2 x 16
    audio frames."""
    cfg_t, cfg_j = _cfg()
    model_j = jax_build_model(cfg_j, tp=1)
    model = build_model(cfg_t, tp=1)
    assert [(p.name, p.stack) for p in model.pools] == [("enc", 2), ("dec", 2)]
    params_np = K.numpy_params(model, "encdec")
    rng = np.random.default_rng(6)
    shape = (1, 2, T)
    batch = {"tokens": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "targets": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "mask": (rng.uniform(size=shape) < 0.9).astype(np.float32),
             "audio": _audio(cfg_t, 2, 7, lead=(1,))}
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


def _port_grads(model, params_np, batch, **knobs):
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32,
                                                             **knobs))
    params = params_from_jax(model, params_np, device="cpu")
    grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train",
                                                         compute_dtype=torch.float32),
                                      params, {k: torch.as_tensor(v) for k, v in batch.items()})
    return loss, grads


@pytest.fixture(scope="module")
def reference_grads(whisper, topo1):
    model, model_j, params_np, batch = whisper
    return _jax_loss_and_grads(model_j, topo1, params_np, batch)


@pytest.mark.parametrize("carry", list(CARRIES))
def test_loss_and_grads_match_jax_under_each_carry(whisper, reference_grads, carry):
    """``accumulate_grads`` (one micro-step with its audio frames, fp32)
    under prefetch with ``carry`` against ``jax.grad`` of the reference's
    loss: the loss and every pool's gradient, the encoder's included (it
    reaches the encoder only through the decoder's cross K/V projections);
    and bitwise the serial schedule's."""
    model, _, params_np, batch = whisper
    want_loss, want = reference_grads
    loss, grads = _port_grads(model, params_np, batch, **CARRIES[carry])
    _close(loss.item(), want_loss, "loss")
    for name, w in want.items():
        assert np.abs(w).max() > 0, name
        _close(grads[name].numpy(), w, f"grad {name}")
    serial_loss, serial = _port_grads(model, params_np, batch, prefetch=False)
    assert torch.equal(loss, serial_loss)
    for name in grads:
        assert torch.equal(grads[name], serial[name]), name


def test_encoder_gradient_flows_through_the_cross_projections(whisper):
    """The encoder's gradient is the cross K/V projections' alone: with the
    decoder's ``xattn.wk`` and ``xattn.wv`` (and their biases' share of the
    keys) zeroed, the encoder pool's gradient is exactly zero; with them
    in place it is not.  A dropped encoder gradient would not move the
    loss."""
    model, _, params_np, batch = whisper
    _, grads = _port_grads(model, params_np, batch)
    assert grads["enc"].abs().max() > 0 and grads["embed"].abs().max() > 0
    lay = model.pool("dec").layout
    cut = np.array(params_np["dec"], copy=True)
    for name in ("xattn.wk", "xattn.wv"):
        seg = lay.seg(name)
        cut[..., seg.offset:seg.end] = 0.0
    _, grads = _port_grads(model, dict(params_np, dec=cut), batch)
    assert not grads["enc"].any()
    emb = model.embed.layout.seg("emb.audio_pos")
    assert not grads["embed"][..., emb.offset:emb.end].any()


def test_train_step_slices_audio_by_micro_step(whisper):
    """``build_train_step`` on 2 micro-steps: its loss is the mean of
    ``loss_fn`` on each micro-step's tokens with that micro-step's audio,
    and not with the audio swapped."""
    model, _, params_np, batch = whisper
    two = {k: np.concatenate([v, v[:, ::-1].copy()]) if k != "audio"
           else np.concatenate([v, _audio(model.cfg, 2, 8, lead=(1,))]) for k, v in batch.items()}
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=torch.float32))
    ctx = L.Ctx(mode="train", compute_dtype=torch.float32)
    params = params_from_jax(model, params_np, device="cpu")

    def loss_of(mb, audio):
        micro = {k: torch.as_tensor(two[k][mb]) for k in ("tokens", "targets", "mask")}
        with torch.no_grad():
            return lm.loss_fn(model, params, comm, ctx, dict(
                micro, audio=torch.as_tensor(two["audio"][audio])))[1]["loss"].item()

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


def test_serve_prefill_and_decode_match_jax(whisper, topo1):
    """The fixed batch: prefill of 2 x 16 tokens over 2 x 16 audio frames,
    then 3 greedy steps over the cached self and cross K/V (the learned
    position of each step's token): logits within TOL, tokens equal."""
    model, model_j, params_np, _ = whisper
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, 256, (2, T)).astype(np.int32)
    audio = _audio(model.cfg, 2, 10)
    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32), CAP)
    pt, dt = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32),
                               CAP, device="cpu")
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_jax(model, params_np, device="cpu")
    lj, cj = pj(params_j, {"tokens": jnp.asarray(tokens), "audio": jnp.asarray(audio)})
    lt, ct = pt(params, {"tokens": torch.from_numpy(tokens).long(),
                         "audio": torch.from_numpy(audio)})
    _close(lt.numpy(), lj, "prefill")
    assert set(ct) == {"dec"} and set(ct["dec"]) == {"self", "cross"}
    _close(ct["dec"]["cross"]["k"].float().numpy(), cj["dec"]["cross"]["k"], "cross k cache")
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(3):
        lj, tok_j, cj = dj(params_j, cj, tok_j, jnp.int32(T + i))
        lt, tok_t, ct = dt(params, ct, tok_t, T + i)
        _close(lt.numpy(), lj, f"decode {i}")
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_caches_nest_self_and_cross():
    """``init_caches``: no cache for the encoder pool; the decoder's
    ``{"self": {k, v}, "cross": {k, v}}`` a layer, the self cache at the
    cache length, the cross cache at the audio frames, stacked."""
    model = build_model(_cfg()[0], tp=1)
    caches = lm.init_caches(model, 2, CAP, device="cpu")
    assert set(caches) == {"dec"}
    assert caches["dec"]["self"]["k"].shape == (2, 2, CAP, 4, 16)
    assert caches["dec"]["cross"]["v"].shape == (2, 2, 16, 4, 16)


def test_paged_engine_and_train_launcher_refuse_encdec():
    """As the reference's: the encoder pool has no KV cache, so enc-dec is
    not paged-servable; the train launcher's data pipeline makes no audio
    frames (neither does the reference's)."""
    from repro_torch.launch import train as launch_train

    model = build_model(_cfg()[0], tp=1)
    with pytest.raises(NotImplementedError, match="has no KV cache"):
        PG.build_paged_step(model, MiCSTopology(), MiCSConfig(), max_blocks=2, device="cpu")
    with pytest.raises(NotImplementedError, match="has no KV cache"):
        PG.init_paged_caches(model, MiCSTopology(), 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="audio frames"):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                           "--checkpoint-dir", "unused"])


def test_stub_batch_draws_audio_after_the_prompts():
    """``launch/serve.stub_batch``: the prompts, then the audio frames, from
    one ``default_rng(seed)`` (the reference launcher's order), bf16."""
    from repro_torch.launch.serve import stub_batch

    cfg = _cfg()[0]
    out = stub_batch(cfg, 2, 5, 3, "cpu")
    rng = np.random.default_rng(3)
    assert np.array_equal(out["tokens"].numpy(), rng.integers(0, cfg.vocab, (2, 5)))
    want = torch.from_numpy(rng.normal(size=(2, 16, 64))).to(torch.bfloat16)
    assert out["audio"].dtype == torch.bfloat16 and torch.equal(out["audio"], want)


def test_configs_are_the_reference():
    for full in (False, True):
        cfg_t, cfg_j = _cfg() if not full else (get_config(ARCH), jax_get_config(ARCH))
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    cfg = get_config(ARCH)
    assert (cfg.norm, cfg.mlp, cfg.use_rope, cfg.qkv_bias) == ("ln", "gelu", False, False)
    embed = build_model(cfg, tp=1).embed.layout
    assert embed.seg("emb.pos").shape == (32768, 1280)
    assert embed.seg("emb.audio_pos").shape == (1500, 1280)
