"""The port's xLSTM family (``repro_torch/models/recurrent.py``: the mLSTM
cell, its chunkwise form and block, the sLSTM step, scan and block;
``models/build.py``'s xLSTM pools) against the JAX package on the CPU, at
fp32, on inputs made from numpy seeds:

* ``mlstm_chunkwise`` (chunk 8) and the cell's scan against the
  reference's, and the chunkwise form against the reference's cell within
  the reference's own 2e-3 (``tests/test_recurrent.py``);
* ``mlstm_apply`` and ``slstm_apply`` at train, prefill and decode (the
  state hand-off), and their gradients against ``jax.vjp``;
* smoke xlstm-125m through ``params_from_jax``: one ``build_train_step``
  step against the reference's (the loss, every gradient through AdamW's
  first moment), greedy serve tokens and logits, each sub-layer running
  its own weights, and the reference's chunkwise-equals-scan training;
* the layouts cut over tp (``tp_params_from_full``), the caches' nesting,
  the paged engine's refusal.

The shadowing (ROADMAP Queue 3): the reference's sub-layers strip
``len(prefix)`` characters from every name, so in a super-layer ``m0.``,
``m1.``, ``m2.``, ``s0.`` all three mLSTM blocks run ``m2.``'s ``m.*``
weights and all four blocks ``s0.``'s ``ln1.scale``; the port runs each
sub-layer's own.  The tests that run the whole model copy the shadowing
weights over the shadowed ones first (``torch_dist_cases.tie_shadowed``),
so both packages compute the same function, and read the port's gradients
on the reference's basis (``torch_dist_cases.on_jax_basis``: a shadowed
segment's gradient added to the one that shadows it).

Tolerances: the same fp32 math in other orders of sums (the sLSTM's four
products as one, its backward written out); measured errors are in
``TOL``'s comment.
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
from repro.core.mics import build_train_step as jax_train_step  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.models.build import exact_param_count as jax_exact_param_count  # noqa: E402
from repro.optim.adamw import OptConfig as JaxOptConfig  # noqa: E402
from repro.runtime.serving import build_serve_steps as jax_serve_steps  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import _sharded_dim, params_from_jax, state_from_jax  # noqa: E402
from repro_torch.convert import tp_params_from_full  # noqa: E402
from repro_torch.core.flat_param import LayoutBuilder  # noqa: E402
from repro_torch.core.mics import MiCSConfig, build_train_step  # noqa: E402
from repro_torch.core.mics import init_params, init_state  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models.build import build_model, exact_param_count  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime import paged as PG  # noqa: E402
from repro_torch.runtime.serving import build_serve_steps  # noqa: E402
import torch_dist_cases as K  # noqa: E402

# Port against JAX at fp32, as a fraction of the largest reference value
# (measured on the CPU with this file's inputs: the chunkwise form 2.9e-7,
# the cell's scan 2.3e-7, their states <= 1.1e-7, the blocks at train,
# prefill and decode <= 1.3e-6, the step's loss 0).
TOL = 1e-5
# A block's gradients at these weights (std 0.3, gradients up to ~1e3):
# JAX's own fp32 gradients are up to 1.2e-5 of their scale from its fp64
# ones (mLSTM dx, m.wk; measured), the port's up to 8.9e-6 (mLSTM dx).
BLOCK_GRAD_TOL = 3e-5
# The whole smoke model (4 blocks, the recurrences' ill-conditioned
# denominators compounding): the step's first moment, so its gradients,
# measured up to 1.7e-5 of a pool's largest (embed), serve logits up to
# 6.4e-5 of the largest |logit| (a decode step), the blocks' own rounding
# carried through the model.
MODEL_TOL = 1e-4
REF_CHUNK_TOL = 2e-3          # tests/test_recurrent.py: chunkwise against the cell
ARCH = "xlstm-125m"
T = 32


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


def _ctx(mode="train", chunk=0):
    return (L.Ctx(mode=mode, compute_dtype=torch.float32, mlstm_chunk=chunk),
            JL.Ctx(mode=mode, compute_dtype=jnp.float32, mlstm_chunk=chunk))


# ---------------------------------------------------------------------------
# the reference's shadowing, neutralised
# ---------------------------------------------------------------------------

def test_reference_shadowing_is_the_documented_one():
    """The xLSTM super-layer's shadowing: the three mLSTM blocks run
    ``m2.``'s ``m.*``, all four blocks ``s0.``'s ``ln1.scale``; nothing
    else is shadowed."""
    model = build_model(_cfg()[0], tp=1)
    (pool,) = model.pools
    reads = K.reference_reads(pool.layout, K.sublayer_prefixes(model, pool))
    moved = {own: won for own, won in reads.items() if own != won}
    assert K.sublayer_prefixes(model, pool) == ["m0.", "m1.", "m2.", "s0."]
    for own, won in moved.items():
        if own.endswith("ln1.scale"):
            assert won == "s0.ln1.scale"
        else:
            assert own.startswith(("m0.m.", "m1.m.")) and won == "m2." + own[3:]
    assert len(moved) == 3 + 2 * 10       # 3 ln1 scales, m0 / m1's 10 m.* segments


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

def _mlstm_inputs(b=2, t=64, nh=2, dh=16, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, nh, dh)).astype(np.float32)
    k = (rng.normal(size=(b, t, nh, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.normal(size=(b, t, nh, dh)).astype(np.float32)
    ilog = rng.normal(size=(b, t, nh)).astype(np.float32)
    flog = np.asarray(jax.nn.log_sigmoid(rng.normal(size=(b, t, nh)).astype(np.float32) + 2.0))
    return q, k, v, ilog, flog.copy()


def _jax_cell_scan(q, k, v, ilog, flog):
    b, t, nh, dh = q.shape
    carry = (jnp.zeros((b, nh, dh, dh)), jnp.zeros((b, nh, dh)), jnp.full((b, nh), -1e30))

    def step(c, xs):
        return JR._mlstm_cell(*xs, c)

    carry, hs = jax.lax.scan(step, carry, tuple(jnp.moveaxis(jnp.asarray(a), 1, 0)
                                                for a in (q, k, v, ilog, flog)))
    return jnp.moveaxis(hs, 0, 1), carry


@pytest.mark.parametrize("form", ["chunkwise", "cell"])
def test_mlstm_recurrence_matches_jax(form):
    """The chunkwise form at chunk 8 against the reference's, and the
    cell's scan against the reference's cell, outputs and final (C, n, m);
    the chunkwise form against the reference's cell within 2e-3."""
    ins = _mlstm_inputs()
    want_cell = jax.jit(_jax_cell_scan)(*ins)
    if form == "chunkwise":
        want = jax.jit(lambda *a: JR.mlstm_chunkwise(*a, 8))(*ins)
        got = R.mlstm_chunkwise(*(torch.from_numpy(a) for a in ins), 8)
    else:
        want = want_cell
        got = R._mlstm_scan(*(torch.from_numpy(a) for a in ins))
    _close(got[0].numpy(), want[0], f"{form} h")
    for name, g, w in zip("Cnm", got[1], want[1]):
        _close(g.numpy(), w, f"{form} {name}")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_cell[0]), rtol=REF_CHUNK_TOL,
                               atol=REF_CHUNK_TOL)


def _block_weights(cfg, kind: str, seed: int) -> dict:
    """Random tensors of one block's tp = 1 layout: projections std 0.3,
    the norm scales near 0 (their zero init), the sLSTM's recurrent
    matrices std 0.5 (so the recurrence matters)."""
    rng = np.random.default_rng(seed)
    b = LayoutBuilder()
    (R.mlstm_layout if kind == "m" else R.slstm_layout)(cfg, 1, b)
    out = {}
    for s in b.build().segments:
        std = 0.05 if "norm" in s.name or s.name.endswith("scale") else (
            0.5 if s.name.startswith("s.r") else 0.3)
        out[s.name] = (rng.standard_normal(s.shape) * std).astype(np.float32)
    return out


def _apply(kind):
    return ((R.mlstm_apply, JR.mlstm_apply) if kind == "m" else (R.slstm_apply, JR.slstm_apply))


def _cache_close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for name in want:
        w = np.asarray(want[name], np.float32)
        g = got[name].float().numpy()
        assert got[name].dtype == {jnp.float32: torch.float32,
                                   jnp.bfloat16: torch.bfloat16}[want[name].dtype.type], name
        if name == "conv":   # bf16 even at fp32: an fp32 value 1e-6 apart may round an ulp apart
            assert np.abs(g - w).max() <= 2 ** -7 * max(np.abs(w).max(), 1e-30), what
        else:
            _close(g, w, f"{what} {name}")


@pytest.mark.parametrize("kind,chunk", [("m", 0), ("m", 8), ("s", 0)])
def test_block_train_prefill_decode_match_jax(kind, chunk):
    """One block at train and prefill over 16 tokens (mLSTM: the scan, or
    chunkwise at chunk 8; the sLSTM always scans), then prefill of 15
    tokens and a decode step from its cache: outputs and states."""
    cfg_t, cfg_j = _cfg()
    w = _block_weights(cfg_t, kind, 11)
    x = np.random.default_rng(12).standard_normal((2, 16, 64)).astype(np.float32)
    port, ref = _apply(kind)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    for mode in ("train", "prefill"):
        ct, cj = _ctx(mode, chunk)
        yj, cache_j = jax.jit(lambda x, w: ref(cfg_j, w, x, cj))(x, w)
        with torch.no_grad():
            yt, cache_t = port(cfg_t, t, torch.from_numpy(x), ct)
        _close(yt.numpy(), yj, f"{kind} {mode}")
        if mode == "train":
            assert cache_t is None and cache_j is None
        else:
            _cache_close(cache_t, cache_j, f"{kind} prefill cache")
    ct, cj = _ctx("prefill", chunk)
    _, cache_j = jax.jit(lambda x, w: ref(cfg_j, w, x, cj))(x[:, :15], w)
    with torch.no_grad():
        _, cache_t = port(cfg_t, t, torch.from_numpy(x[:, :15]), ct)
    ct, cj = _ctx("decode", chunk)
    yj, new_j = jax.jit(lambda x, w, c: ref(cfg_j, w, x, cj, c))(x[:, 15:], w, cache_j)
    with torch.no_grad():
        yt, new_t = port(cfg_t, t, torch.from_numpy(x[:, 15:]), ct, cache_t)
    assert new_t is cache_t              # decode updates the cache in place
    _close(yt.numpy(), yj, f"{kind} decode")
    _cache_close(new_t, new_j, f"{kind} decode cache")


@pytest.mark.parametrize("kind", ["m", "s"])
def test_block_grads_match_jax_vjp(kind):
    """The block's gradients in training (the sLSTM through
    ``SlstmScanFn``'s written-out backward; the mLSTM chunkwise at chunk 8
    through autograd) against ``jax.vjp`` of the reference's block: the
    input's on its own scale, the weights' on the scale of the largest
    weight gradient (``s.bi``'s is zero but for rounding: a constant
    added to every input-gate logit scales c and n alike), within
    ``BLOCK_GRAD_TOL``."""
    cfg_t, cfg_j = _cfg()
    w = _block_weights(cfg_t, kind, 21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ct_ = rng.standard_normal((2, 16, 64)).astype(np.float32)
    port, ref = _apply(kind)
    ct, cj = _ctx("train", 8)
    gx_j, gw_j = jax.jit(lambda x, w, ct: jax.vjp(lambda x, w: ref(cfg_j, w, x, cj)[0],
                                                  x, w)[1](ct))(x, w, ct_)
    xt = torch.from_numpy(x).requires_grad_()
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    y, _ = port(cfg_t, t, xt, ct)
    y.backward(torch.from_numpy(ct_))
    _close(xt.grad.numpy(), gx_j, f"{kind} dx", BLOCK_GRAD_TOL)
    scale = max(float(np.abs(g).max()) for g in gw_j.values())
    for name, g in gw_j.items():
        err = float(np.abs(t[name].grad.numpy() - np.asarray(g)).max())
        assert err <= BLOCK_GRAD_TOL * scale, f"{kind} d{name}: {err} > {BLOCK_GRAD_TOL} x {scale}"


def _slstm_autograd(px, r):
    """The reference's ``_slstm_step`` math, step by step under autograd,
    over the heads-first layout of ``_slstm_steps``."""
    steps, nh, b, _, dh = px.shape
    c, n, h, m = R._zero_slstm_state((nh, b, dh), px.device, px.dtype)
    hs = []
    for i in range(steps):
        pre = (px[i].flatten(2) + torch.bmm(h, r)).view(nh, b, 4, dh)
        z, ilog = torch.tanh(pre[:, :, 0]), pre[:, :, 1]
        flog, o = torch.nn.functional.logsigmoid(pre[:, :, 2]), torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(flog + m, ilog)
        fp, ip = torch.exp(flog + m - m_new), torch.exp(ilog - m_new)
        c, n, m = fp * c + ip * z, fp * n + ip, m_new
        h = o * (c / torch.clamp_min(n, R.SLSTM_N_FLOOR))
        hs.append(h)
    return torch.stack(hs)


def test_slstm_scan_fn_matches_autograd_of_the_steps():
    """``SlstmScanFn``'s written-out backward against autograd through the
    same step math, fp64, with large pre-activations and small input
    gates."""
    gen = torch.Generator().manual_seed(3)
    steps, nh, b, dh = 9, 2, 3, 4
    px = 2.0 * torch.randn(steps, nh, b, 4, dh, generator=gen, dtype=torch.float64)
    px[:, :, :, 1] -= 6.0
    r = 0.5 * torch.randn(nh, dh, 4 * dh, generator=gen, dtype=torch.float64)
    ct = torch.randn(steps, nh, b, dh, generator=gen, dtype=torch.float64)
    got = [t.clone().requires_grad_() for t in (px, r)]
    want = [t.clone().requires_grad_() for t in (px, r)]
    hs = R.SlstmScanFn.apply(*got)
    hs_want = _slstm_autograd(*want)
    assert torch.allclose(hs, hs_want, rtol=1e-12, atol=1e-14)
    hs.backward(ct)
    hs_want.backward(ct)
    for g, w in zip(got, want):
        assert torch.allclose(g.grad, w.grad, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the model: loss and gradients, a train step, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm():
    """The smoke model in both packages, the port's ``init_params`` (the
    reference's layout and init scales; JAX's own init costs seconds to
    compile) tied (``K.tie_shadowed``)."""
    cfg_t, cfg_j = _cfg()
    model_j = jax_build_model(cfg_j, tp=1)
    model = build_model(cfg_t, tp=1)
    params_np = K.tie_shadowed(model_j, {k: v.numpy() for k, v in init_params(
        model, 3, device="cpu").items()})
    assert [(p.name, p.stack) for p in model.pools] == [("x", 1)]
    return model, model_j, params_np


# Segments whose gradient is zero but for rounding (a constant added to
# every input-gate logit scales the sLSTM's c and n alike), so the step's
# AdamW, which moves a weight by about lr times its gradient's sign, may
# move them either way.
NOISE_GRADS = ("s.bi",)


def _unshadowed(model) -> dict:
    """{pool: the segments one sub-layer reads in both packages, but those
    of ``NOISE_GRADS``}."""
    out = {}
    for pool in model.all_pools():
        if pool.name in ("embed", "head"):
            out[pool.name] = [s.name for s in pool.layout.segments]
            continue
        reads = K.reference_reads(pool.layout, K.sublayer_prefixes(model, pool))
        shared = {won for own, won in reads.items() if own != won}
        out[pool.name] = [n for n, won in reads.items()
                          if n == won and n not in shared and not n.endswith(NOISE_GRADS)]
    return out


def test_train_step_matches_jax(xlstm, topo1):
    """One ``build_train_step`` step (2 micro-steps of 2 x 32, fp32 gather,
    the mLSTM's timestep scan: the chunkwise form's gradients are held in
    the block test) against the reference's, as ``tests/test_system.py``
    builds it, from the tied init state and zero moments, the clip off (a
    shadowed segment's gradient differs by basis, and so does the global
    norm): the loss; AdamW's first moment, linear in the gradient (0.1 x
    the micro-steps' mean), of every pool on the reference's basis
    (``K.on_jax_basis``), so every gradient, within ``MODEL_TOL``; and on
    every segment a single sub-layer reads in both packages the second
    moment (quadratic in the gradient: no basis to read it on) within
    ``MODEL_TOL`` and the parameters within ``2 lr`` (a weight moves by
    about lr times its gradient's sign, and a gradient at rounding level
    may take either sign)."""
    model, model_j, params_np = xlstm
    rng = np.random.default_rng(7)
    cfg = model.cfg
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 2, T)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (2, 2, T)).astype(np.int32),
             "mask": np.ones((2, 2, T), np.float32)}
    lr = 1e-3
    oc = dict(total_steps=10, warmup_steps=0, lr_max=lr, clip_norm=1e9)
    zeros = {k: np.zeros_like(v) for k, v in params_np.items()}
    state = state_from_jax(model, {"params": params_np, "m": zeros, "v": zeros, "step": 0},
                           device="cpu")
    state_j = {"params": {k: jnp.asarray(v) for k, v in params_np.items()},
               "m": {k: jnp.asarray(v) for k, v in zeros.items()},
               "v": {k: jnp.asarray(v) for k, v in zeros.items()}, "step": jnp.int32(0)}
    step_j = jax_train_step(model_j, topo1, JaxMiCSConfig(micro_steps=2, gather_dtype=jnp.float32),
                            JaxOptConfig(**oc))
    new_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    step = build_train_step(model, MiCSTopology(), MiCSConfig(
        micro_steps=2, gather_dtype=torch.float32), OptConfig(**oc), device="cpu")
    new, m = step(state, batch)
    _close(m["loss"].item(), float(m_j["loss"]), "loss")
    got_m = K.on_jax_basis(model, new["m"])
    for name, want in new_j["m"].items():
        assert np.abs(want).max() > 0
        _close(got_m[name], want, f"m {name}", MODEL_TOL)
    for name, segs in _unshadowed(model).items():
        lay = model.pool(name).layout
        for part in ("v", "params"):
            got, want = new[part][name].numpy(), np.asarray(new_j[part][name])
            scale = float(np.abs(want).max())
            for seg in segs:
                sg = lay.seg(seg)
                err = float(np.abs(got[..., sg.offset:sg.end] - want[..., sg.offset:sg.end]).max())
                bound = 2 * lr if part == "params" else MODEL_TOL * scale
                assert err <= bound, f"{part} {name}/{seg}: {err} > {bound}"
        assert not np.array_equal(new["params"][name].numpy(), params_np[name])


def test_chunkwise_training_equals_the_scan():
    """The reference's ``mlstm_chunk_train_equiv`` (``tests/dist_harness.py``)
    in the port: two steps of 2 micro-steps of 2 x 32 from
    ``init_state(seed=4)`` with ``mlstm_chunk`` 8 give the losses of the
    timestep scan, within its rtol 5e-3 and atol 1e-2; the two differ
    (the chunkwise form is another order of sums)."""
    model = build_model(_cfg()[0], tp=1)
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, 256, (2, 2, T)), "targets": rng.integers(0, 256, (2, 2, T)),
                "mask": np.ones((2, 2, T), np.float32)} for _ in range(2)]
    losses = {}
    for chunk in (0, 8):
        step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=2, mlstm_chunk=chunk),
                                OptConfig(total_steps=10, warmup_steps=0, lr_max=1e-3),
                                device="cpu")
        state = init_state(model, 4, device="cpu")
        losses[chunk] = [step(state, b)[1]["loss"].item() for b in batches]
    np.testing.assert_allclose(losses[8], losses[0], rtol=5e-3, atol=1e-2)
    assert losses[8] != losses[0]


def test_greedy_serve_matches_jax(xlstm, topo1):
    """Prefill of 2 x 16 then 4 greedy steps at the serving default
    ``mlstm_chunk`` 0 (the chunkwise prefill's hand-off is held in the
    block test): logits within ``MODEL_TOL``, the tokens bitwise."""
    chunk = 0
    model, model_j, params_np = xlstm
    tokens = np.random.default_rng(9).integers(1, 256, (2, 16)).astype(np.int32)
    pj, dj = jax_serve_steps(model_j, topo1, JaxMiCSConfig(gather_dtype=jnp.float32,
                                                           mlstm_chunk=chunk), 24)
    pt, dt = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32,
                                                                 mlstm_chunk=chunk), 24,
                               device="cpu")
    params_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    params = params_from_jax(model, params_np, device="cpu")
    lj, cj = pj(params_j, {"tokens": jnp.asarray(tokens)})
    lt, ct = pt(params, {"tokens": torch.from_numpy(tokens).long()})
    _close(lt.numpy(), lj, "prefill", MODEL_TOL)
    tok_j = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(lt[:, -1:], dim=-1)
    for i in range(4):
        lj, tok_j, cj = dj(params_j, cj, tok_j, jnp.int32(16 + i))
        lt, tok_t, ct = dt(params, ct, tok_t, 16 + i)
        _close(lt.numpy(), lj, f"decode {i}", MODEL_TOL)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_sub_layers_run_their_own_weights(xlstm):
    """Scaling ``m0.``'s ``m.wo`` changes the port's logits (the reference
    would not see it: ``m2.``'s shadows it), and scaling only ``m1.``'s
    ``ln1.scale`` does too."""
    model, _, params_np = xlstm
    params = params_from_jax(model, params_np, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, 256, (1, 8))).long()
    pt, _ = build_serve_steps(model, MiCSTopology(), MiCSConfig(gather_dtype=torch.float32), 8,
                              device="cpu")
    base = pt(params, {"tokens": tokens})[0]
    layout = model.pool("x").layout
    for seg, factor in (("m0.m.wo", 2.0), ("m1.ln1.scale", 0.0)):
        moved = {k: v.clone() for k, v in params.items()}
        sg = layout.seg(seg)
        row = moved["x"][0, 0, sg.offset:sg.end]
        row.copy_(row * factor + (1.0 if factor == 0.0 else 0.0))
        assert not torch.equal(pt(moved, {"tokens": tokens})[0], base), seg


# ---------------------------------------------------------------------------
# layouts, caches, refusals
# ---------------------------------------------------------------------------

def test_tp_cut_of_gathered_and_padded_segments():
    """``tp_params_from_full`` cuts the model-gathered xLSTM segments along
    their last dim (``_sharded_dim`` finds it), padded with zeros where tp
    does not divide it: at tp 8 the smoke model's ``m.wif`` [128, 4] is 1
    column a rank (4 real, 4 padding) and ``m.bif`` 1 value; every rank's
    gathered tensor is the tp = 1 one followed by the padding."""
    cfg = _cfg()[0]
    m1, m8 = build_model(cfg, tp=1), build_model(cfg, tp=8)
    full = np.random.default_rng(0).standard_normal(
        (1, 1, m1.pool("x").layout.flat_len)).astype(np.float32)
    cut = tp_params_from_full(m8, m1, {"x": full})["x"]
    lay1, lay8 = m1.pool("x").layout, m8.pool("x").layout
    for name in ("m0.m.wif", "m0.m.bif", "m1.m.conv_b", "s0.s.rz", "s0.s.wo"):
        s1, s8 = lay1.seg(name), lay8.seg(name)
        assert _sharded_dim(s8, s1) == len(s1.shape) - 1
        parts = [cut[0, j, s8.offset:s8.end].reshape(s8.shape) for j in range(8)]
        whole = np.concatenate(parts, axis=-1)
        n = s1.shape[-1]
        np.testing.assert_array_equal(whole[..., :n], full[0, 0, s1.offset:s1.end].reshape(s1.shape))
        assert not whole[..., n:].any()
    assert lay8.seg("m0.m.wif").shape == (128, 1) and lay8.seg("m0.m.bif").shape == (1,)


def test_caches_nest_by_prefix():
    """``init_caches``: a pool's cache is ``{prefix: state}``, stacked over
    the pool's layers; fp32 states (m at -1e30) and a bf16 conv window
    whatever the KV dtype; ``_layer_cache`` views write through."""
    model = build_model(get_config(ARCH), tp=1)
    caches = lm.init_caches(model, 2, 64, dtype=torch.float32, device="cpu")
    x = caches["x"]
    assert set(x) == {"m0.", "m1.", "m2.", "s0."}
    assert {k: (tuple(v.shape), v.dtype) for k, v in x["m0."].items()} == {
        "C": ((3, 2, 4, 384, 384), torch.float32), "n": ((3, 2, 4, 384), torch.float32),
        "m": ((3, 2, 4), torch.float32), "conv": ((3, 2, 3, 1536), torch.bfloat16)}
    assert {k: tuple(v.shape) for k, v in x["s0."].items()} == dict.fromkeys("cnhm", (3, 2, 768))
    assert torch.all(x["s0."]["m"] == -1e30) and torch.all(x["m1."]["m"] == -1e30)
    view = lm._layer_cache(caches["x"], 1)
    view["s0."]["c"].fill_(2.0)
    assert torch.all(x["s0."]["c"][1] == 2.0) and not x["s0."]["c"][0].any()
    stacked = lm._pool_caches(None, [lm._layer_cache(caches["x"], i) for i in range(3)])
    assert stacked["m2."]["C"].shape == x["m2."]["C"].shape


def test_paged_engine_refuses_xlstm():
    """As the reference's: xLSTM's cache holds no KV pages."""
    model = build_model(_cfg()[0], tp=1)
    with pytest.raises(NotImplementedError, match="not a plain k/v dict"):
        PG.build_paged_step(model, MiCSTopology(), MiCSConfig(), max_blocks=2, device="cpu")
    with pytest.raises(NotImplementedError, match="not a plain k/v dict"):
        PG.init_paged_caches(model, MiCSTopology(), 4, 16, device="cpu")


def test_configs_are_the_reference():
    """The copied config and its smoke variant field for field."""
    for full in (False, True):
        cfg_t, cfg_j = _cfg() if not full else (get_config(ARCH), jax_get_config(ARCH))
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert exact_param_count(cfg_t) == jax_exact_param_count(cfg_j)
    assert (_cfg()[0].n_layers, _cfg()[0].n_heads) == (4, 2)
