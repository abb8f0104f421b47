"""The port's training step against the JAX package's
``repro.core.mics.build_train_step`` on the CPU: the same JAX
``init_state`` carried over with ``repro_torch.convert.state_from_jax``,
the same batches, smoke llama3.2-1b, ``micro_steps=2``, 3 steps; smoke
recurrentgemma-2b's loss and gradients against ``jax.grad`` of the
reference's loss; the port's bitwise equalities between its own
schedules; and every training knob it refuses or has lifted.  ``gpu`` tests hold the
card's steps to the CPU's."""

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
from repro.core.mics import init_state as jax_init_state  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.optim.adamw import OptConfig as JaxOptConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core.comm import CommEngine  # noqa: E402
from repro_torch.core.mics import (  # noqa: E402
    MiCSConfig,
    accumulate_grads,
    build_train_step,
    init_params,
    refuse_unported,
)
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402

ARCH = "llama3.2-1b"
MICRO, BATCH, SEQ, STEPS = 2, 2, 64, 3
OPT = dict(warmup_steps=0, total_steps=10, lr_max=1e-3)
LR = OPT["lr_max"]
WIRES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Tolerances of the port against JAX after each of 3 steps (losses and
# grad norms) and after the last (params, m, v), measured on the CPU with
# this file's runs.
#  * fp32 gather: the same math in other orders of sums; measured loss
#    1.5e-7 and grad_norm 1.6e-6 relative, m 3e-5 and v 1.5e-5 of their
#    max.  Params: AdamW's step is about lr * sign(g) where |g| >> eps, so
#    an element whose gradient sits near eps moves by a different fraction
#    of lr on the two sides; measured 5.4e-5 = 0.054 lr.
#  * bf16 gather: both packages round every activation, weight and
#    gradient to bf16, in different orders, so whole bf16 ulps differ;
#    measured loss 3.1e-4 relative, grad_norm 6.2e-3 relative, m 3.7e-2 and
#    v 4.0e-2 of their max, params 4.3e-3 = 4.3 lr (a sign-like AdamW step
#    that differs moves a weight by up to 2 lr a step).
TOL = {
    "fp32": dict(loss=1e-5, grad_norm=1e-5, params=2e-4, m=1e-4, v=1e-4),
    "bf16": dict(loss=2e-3, grad_norm=2e-2, params=6 * LR, m=1e-1, v=1e-1),
}


def _batches(vocab):
    rng = np.random.default_rng(0)
    return [{"tokens": rng.integers(0, vocab, (MICRO, BATCH, SEQ)).astype(np.int32),
             "targets": rng.integers(0, vocab, (MICRO, BATCH, SEQ)).astype(np.int32),
             "mask": np.ones((MICRO, BATCH, SEQ), np.float32)} for _ in range(STEPS)]


@pytest.fixture(scope="module")
def setup(topo1):
    cfg_j = jax_smoke(jax_get_config(ARCH))
    model_j = jax_build_model(cfg_j, tp=1)
    state0 = jax_init_state(model_j, topo1, seed=0)
    init = {"params": {k: np.asarray(v) for k, v in state0["params"].items()},
            "m": {k: np.asarray(v) for k, v in state0["m"].items()},
            "v": {k: np.asarray(v) for k, v in state0["v"].items()},
            "step": int(np.asarray(state0["step"]))}
    model = build_model(smoke_variant(get_config(ARCH)), tp=1)
    return model, model_j, init, _batches(cfg_j.vocab)


@pytest.fixture(scope="module")
def jax_runs(setup, topo1):
    """Per gather wire: the JAX step's (loss, grad_norm) at each step and its
    final state, from the same initial state (the default schedules:
    prefetch, bucketed boundary)."""
    _, model_j, init, batches = setup
    out = {}
    for wire, (jdt, _) in WIRES.items():
        step = jax_train_step(model_j, topo1, JaxMiCSConfig(micro_steps=MICRO, gather_dtype=jdt),
                              JaxOptConfig(**OPT))
        state = {part: {k: jnp.asarray(v) for k, v in init[part].items()}
                 for part in ("params", "m", "v")}
        state["step"] = jnp.int32(init["step"])
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[wire] = (metrics, {part: {k: np.asarray(v) for k, v in state[part].items()}
                               for part in ("params", "m", "v")})
    return out


def _port_run(setup, mcfg, device="cpu"):
    model, _, init, batches = setup
    state = state_from_jax(model, init, device=device)
    step = build_train_step(model, MiCSTopology(), mcfg, OptConfig(**OPT), device=device)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item(), m["loss"], m["grad_norm"]))
    assert state["step"] == STEPS
    return metrics, state


@pytest.mark.parametrize("wire", list(WIRES))
def test_train_steps_match_jax(setup, jax_runs, wire):
    tol = TOL[wire]
    want_metrics, want_state = jax_runs[wire]
    got_metrics, state = _port_run(setup, MiCSConfig(micro_steps=MICRO,
                                                     gather_dtype=WIRES[wire][1]))
    for i, ((loss, gn, *_), (jloss, jgn)) in enumerate(zip(got_metrics, want_metrics)):
        assert np.isfinite(loss) and np.isfinite(gn)
        assert abs(loss - jloss) <= tol["loss"] * abs(jloss), (i, loss, jloss)
        assert abs(gn - jgn) <= tol["grad_norm"] * abs(jgn), (i, gn, jgn)
    for part in ("params", "m", "v"):
        for name, want in want_state[part].items():
            got = state[part][name].numpy()
            err = float(np.abs(got - want).max())
            bound = tol[part] if part == "params" else tol[part] * float(np.abs(want).max())
            assert err <= bound, f"{part}[{name}]: max |err| {err} > {bound}"


def _equal_states(a, b):
    return all(torch.equal(a[part][k], b[part][k]) for part in ("params", "m", "v")
               for k in a[part])


@pytest.mark.parametrize("wire", list(WIRES))
def test_serial_equals_prefetch_bitwise(setup, wire):
    """The lookahead schedule runs the same gathers on the same rows and the
    same compute in the same order: loss, every micro-step's gradient and
    the state after 3 steps are bitwise the serial schedule's."""
    model, _, init, batches = setup
    tdt = WIRES[wire][1]
    params = state_from_jax(model, init, device="cpu")["params"]
    ctx = L.Ctx(mode="train", compute_dtype=tdt)
    batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    got = {}
    for prefetch in (False, True):
        comm = CommEngine.from_config(MiCSTopology(),
                                      MiCSConfig(gather_dtype=tdt, prefetch=prefetch))
        got[prefetch] = accumulate_grads(model, comm, ctx, params, batch)
    (g0, l0, _), (g1, l1, _) = got[False], got[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert any(bool(g0[k].abs().max() > 0) for k in g0)
    m_serial, s_serial = _port_run(setup, MiCSConfig(micro_steps=MICRO, gather_dtype=tdt,
                                                     prefetch=False))
    m_pre, s_pre = _port_run(setup, MiCSConfig(micro_steps=MICRO, gather_dtype=tdt))
    assert [m[:2] for m in m_serial] == [m[:2] for m in m_pre]
    assert _equal_states(s_serial, s_pre)


@pytest.mark.parametrize("bucket_mb", [0.01, 1000.0])
def test_bucketed_boundary_equals_serial_bitwise(setup, bucket_mb):
    """Both boundary schedules fold the same squared-norm partials in the
    plan's order and run the same AdamW: bitwise equal at a bucket size that
    cuts every pool into many buckets and at one that does not cut them."""
    from repro_torch.core.schedule import plan_boundary

    model = setup[0]
    plan = plan_boundary(model, MiCSTopology(), mode="bucketed", bucket_mb=bucket_mb)
    per_pool = plan.describe()["buckets_per_pool"]
    if bucket_mb < 1:
        assert min(per_pool.values()) >= 5
    else:
        assert set(per_pool.values()) == {1}
    runs = [_port_run(setup, MiCSConfig(micro_steps=MICRO, boundary_schedule=sched,
                                        hop2_bucket_mb=bucket_mb))
            for sched in ("serial", "bucketed")]
    assert [m[:2] for m in runs[0][0]] == [m[:2] for m in runs[1][0]]
    assert _equal_states(runs[0][1], runs[1][1])


def test_same_step_twice_is_bitwise_equal(setup):
    a = _port_run(setup, MiCSConfig(micro_steps=MICRO))
    b = _port_run(setup, MiCSConfig(micro_steps=MICRO))
    assert [m[:2] for m in a[0]] == [m[:2] for m in b[0]]
    assert _equal_states(a[1], b[1])


REFUSED = {
    "scores_bf16": dict(scores_bf16=True),
}
# Knobs a slice lifted: they keep their ids below and now build a step whose
# record (``step_fn.describe()``) carries them.  The multi-rank collectives
# (ROADMAP Queue 1 item 2): the gather topology and the sync mode (at p = 1
# they move nothing).  The one-card training knobs (item 3): the remat and
# host carries, host-resident moments and the approximate clip
# (tests/test_torch_knobs.py holds what they compute).  The int8 and bf16
# wires (item 4; tests/test_torch_quant.py, test_torch_collectives.py and
# test_torch_dist_train.py hold what they compute).  The autotuner and the
# memory planner (item 8): at p = 1 every candidate moves nothing, so auto
# takes the reference's tie-break, the flat gather, and under a budget the
# smallest footprint, the remat carry (tests/test_torch_planner.py holds
# the ranking and the plan).
LIFTED = {
    "policy": (dict(policy="auto"), "gather", "topology", "flat"),
    "hbm_budget_gb": (dict(policy="auto", hbm_budget_gb=40.0), "gather", "prefetch_carry",
                      "remat"),
    "hop1_bf16": (dict(hop1_wire_dtype="bf16"), "wires", "hop1", "bf16"),
    "hop1_int8": (dict(hop1_wire_dtype="int8"), "wires", "hop1", "int8"),
    "compress_hop2": (dict(compress_hop2=True), "wires", "hop2", "bf16"),
    "hop2_int8": (dict(compress_hop2="int8"), "wires", "hop2", "int8"),
    "quant_gather": (dict(quant_gather=True), "wires", "gather", "int8"),
    "sync_mode": (dict(sync_mode="allreduce_slice"), "sync", "mode", "allreduce_slice"),
    "no_hierarchical": (dict(hierarchical=False), "gather", "topology", "flat"),
    "outer_first": (dict(gather_order="outer_first"), "gather", "topology", "outer_first"),
    "prefetch_carry": (dict(prefetch_carry="remat"), "gather", "prefetch_carry", "remat"),
    "carry_offload": (dict(carry_offload="host"), "gather", "carry_offload", "host"),
    "offload_opt": (dict(offload_opt=True), "optimizer", "offload_opt", True),
    "clip_mode": (dict(clip_mode="approx"), "boundary", "clip_mode", "approx"),
}


@pytest.mark.parametrize("knob", list(REFUSED) + list(LIFTED))
def test_refused_knob_raises(setup, knob):
    if knob in LIFTED:
        kw, part, field, value = LIFTED[knob]
        step = build_train_step(setup[0], MiCSTopology(), MiCSConfig(**kw), OptConfig(),
                                device="cpu")
        assert step.describe()[part][field] == value
        return
    with pytest.raises(NotImplementedError):
        build_train_step(setup[0], MiCSTopology(), MiCSConfig(**REFUSED[knob]), OptConfig(),
                         device="cpu")


@pytest.mark.parametrize("topo", [dict(repl=2), dict(shard=2), dict(model=2)])
def test_more_than_one_card_raises(setup, topo):
    """More than one rank (data ranks or tp > 1) needs the process groups
    of its topology (``launch.mesh.MiCSGroups``); a model built for another
    tp than the topology's is refused."""
    model = setup[0]
    if topo.get("model", 1) > 1:
        with pytest.raises(ValueError, match="built for tp = 1"):
            build_train_step(model, MiCSTopology(**topo), MiCSConfig(), OptConfig(),
                             device="cpu")
        model = build_model(model.cfg, tp=topo["model"])
    with pytest.raises(ValueError, match="MiCSGroups"):
        build_train_step(model, MiCSTopology(**topo), MiCSConfig(), OptConfig(), device="cpu")


@pytest.mark.parametrize("family,device,refused", [
    ("griffin", "cuda", False),   # the RG-LRU kernel has its backward
    ("griffin", "cpu", False),
    ("dense", "cuda", False),
    ("dense", "cpu", False),
    ("moe", "cuda", False),       # its layers reach RMSNorm and flash attention
    ("xlstm", "cuda", False),     # RMSNorm; its recurrences are plain PyTorch
    ("vlm", "cuda", False),       # RMSNorm and flash attention, non-causal in its cross layers
    ("encdec", "cuda", False),    # flash attention: the encoder's non-causal, the cross layers'
])
def test_griffin_training_refused_on_a_cuda_device(family, device, refused):
    """The family check reads only the device's type, so it runs without a
    card; a refusal names the ROADMAP item that lifts it.  Every family the
    port builds (dense, griffin, MoE, xLSTM, the VLM, enc-dec) trains on a
    CUDA device."""
    call = lambda: refuse_unported(MiCSConfig(), MiCSTopology(), family,  # noqa: E731
                                   torch.device(device))
    if refused:
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()
    else:
        call()


def test_griffin_train_step_builds_on_the_cpu():
    model = build_model(smoke_variant(get_config("recurrentgemma-2b")), tp=1)
    assert callable(build_train_step(model, MiCSTopology(), MiCSConfig(), OptConfig(),
                                     device="cpu"))


def test_griffin_shorter_than_its_pattern_trains_on_the_cpu():
    """2 layers of a (rec, rec, attn) pattern: an empty ``g`` pool (as the
    JAX package builds it) and a (rec, rec) tail; the loss and every
    gradient are finite and the empty pool's gradient is empty."""
    cfg = dataclasses.replace(smoke_variant(get_config("recurrentgemma-2b")), n_layers=2)
    model = build_model(cfg, tp=1)
    assert {p.name: p.stack for p in model.pools} == {"g": 0, "gtail": 1}
    params = init_params(model, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 2, 16)))
    batch = {"tokens": tokens, "targets": tokens, "mask": torch.ones((1, 2, 16))}
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig())
    grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train", compute_dtype=torch.bfloat16),
                                      params, batch)
    assert torch.isfinite(loss) and grads["g"].numel() == 0
    assert all(torch.isfinite(g).all() and g.abs().amax() > 0 for k, g in grads.items() if k != "g")


def test_boundary_by_slices_is_bitwise_the_whole_row_update(setup, monkeypatch):
    """AdamW runs ``UPDATE_SLICE`` elements of a row at a time; being
    elementwise, any slice length gives the whole-row update bitwise (here
    slices of 1000 elements, which cut every pool's rows and segments)."""
    from repro_torch.core import schedule

    whole = _port_run(setup, MiCSConfig(micro_steps=MICRO))
    monkeypatch.setattr(schedule, "UPDATE_SLICE", 1000)
    assert min(p.layout.flat_len for p in setup[0].all_pools()) > 1000
    sliced = _port_run(setup, MiCSConfig(micro_steps=MICRO))
    assert [m[:2] for m in whole[0]] == [m[:2] for m in sliced[0]]
    assert _equal_states(whole[1], sliced[1])


def test_slice_masks_are_the_row_masks(setup):
    """Each slice's (decay, padding) masks, ``one`` where they would hold
    only ones, put together are the whole row's masks; slices of 1000
    elements reach both kinds."""
    from repro_torch.core.schedule import _slice_masks

    one = torch.ones(())
    kinds = set()
    for pool in setup[0].all_pools():
        lay = pool.layout
        parts = [_slice_masks(lay, lo, min(1000, lay.flat_len - lo), one)
                 for lo in range(0, lay.flat_len, 1000)]
        kinds |= {(dm is one, pm is one) for dm, pm in parts}
        for j, want in enumerate((lay.decay_mask_for_shard(0, lay.flat_len),
                                  lay.padding_mask_for_shard(0, lay.flat_len))):
            got = torch.cat([m.expand(min(1000, lay.flat_len - 1000 * i))
                             for i, m in enumerate(p[j] for p in parts)])
            assert torch.equal(got, want)
    assert {(True, True), (False, True)} <= kinds


# ---------------------------------------------------------------------------
# griffin: loss and gradients against jax.grad of the reference's loss
# ---------------------------------------------------------------------------

GRIFFIN_LAYERS, GRIFFIN_B, GRIFFIN_T = 5, 2, 48   # pools g x1 + gtail x1; T past the window
# Port against JAX, as a fraction of |loss| and of each pool's max |g|,
# measured on the CPU with this file's inputs.  fp32: the same math in
# other orders; measured loss 7.7e-8, gradients <= 2.3e-6.  bf16 gather:
# both round every activation, weight and gradient to bf16, in different
# orders of sums, and the differences grow down the backward chain;
# measured loss 3.9e-4, gradients <= 4.6e-2 (embed; g 4.0e-2, gtail 3.1e-2,
# head 2.2e-2).  JAX's own bf16 gradients are up to 9.8e-2 from its fp32
# ones (embed; g 7.3e-2), so the gradient bound, 6e-2, sits between the
# two: a port whose bf16 path kept fp32, or rounded elsewhere, lands
# nearer 9.8e-2 and fails.  The loss bound is the llama test's (TOL, 2e-3).
GRIFFIN_TOL = {"fp32": dict(loss=1e-5, grads=1e-5), "bf16": dict(loss=2e-3, grads=6e-2)}


def _tie_rec_weights(model_j, params_np):
    """Copy each griffin pool's ``rec1.*`` segments over its ``rec0.*`` ones
    (ROADMAP Queue 3: the reference's sub-layers strip ``len(prefix)``
    characters from every name, so ``rec1.*`` shadows ``rec0.*`` there).
    With them equal both packages compute the same function."""
    out = dict(params_np)
    for pool in model_j.pools:
        segs = {sg.name: sg for sg in pool.layout.segments}
        arr = np.array(out[pool.name], copy=True)
        for name, s0 in segs.items():
            if name.startswith("rec0."):
                s1 = segs["rec1." + name[len("rec0."):]]
                arr[..., s0.offset:s0.end] = arr[..., s1.offset:s1.end]
        out[pool.name] = arr
    return out


def _on_jax_basis(model, grads):
    """The port's gradients as the reference's would read them: each
    ``rec0.*`` segment's gradient added to its ``rec1.*`` segment (the
    weights both sub-layers run there) and ``rec0.*`` set to 0."""
    out = {k: v.clone() for k, v in grads.items()}
    for pool in model.pools:
        segs = {sg.name: sg for sg in pool.layout.segments}
        for name, s0 in segs.items():
            if name.startswith("rec0."):
                s1 = segs["rec1." + name[len("rec0."):]]
                g = out[pool.name]
                g[..., s1.offset:s1.end] += g[..., s0.offset:s0.end]
                g[..., s0.offset:s0.end] = 0.0
    return out


@pytest.fixture(scope="module")
def griffin(topo1):
    """The port's and the reference's 5-layer smoke recurrentgemma-2b, the
    reference's init_state with rec1 tied over rec0, one micro-batch."""
    cfg_j = dataclasses.replace(jax_smoke(jax_get_config("recurrentgemma-2b")),
                                n_layers=GRIFFIN_LAYERS)
    cfg_t = dataclasses.replace(smoke_variant(get_config("recurrentgemma-2b")),
                                n_layers=GRIFFIN_LAYERS)
    model_j = jax_build_model(cfg_j, tp=1)
    params_np = _tie_rec_weights(model_j, {k: np.asarray(v) for k, v in jax_init_state(
        model_j, topo1, seed=3)["params"].items()})
    model = build_model(cfg_t, tp=1)
    assert {p.name: p.stack for p in model.pools} == {"g": 1, "gtail": 1}
    rng = np.random.default_rng(4)
    shape = (1, GRIFFIN_B, GRIFFIN_T)
    batch = {"tokens": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "targets": rng.integers(0, cfg_j.vocab, shape).astype(np.int32),
             "mask": (rng.uniform(size=shape) < 0.9).astype(np.float32)}
    return model, model_j, params_np, batch, cfg_j


def _jax_loss_and_grads(model_j, topo1, params_np, batch, jdt):
    """``jax.value_and_grad`` of ``repro.models.lm.loss_fn`` under the
    reference step's shard_map, one micro-batch."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core.comm import CommEngine as JaxCommEngine
    from repro.core.mics import batch_pspecs, state_pspecs
    from repro.models import layers as JL
    from repro.models import lm as JLM

    comm = JaxCommEngine.from_config(topo1, JaxMiCSConfig(gather_dtype=jdt))
    ctx = JL.Ctx(mode="train", tp=1, compute_dtype=jnp.dtype(jdt))

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


@pytest.mark.parametrize("wire", list(WIRES))
def test_griffin_loss_and_grads_match_jax(griffin, topo1, wire):
    """``accumulate_grads`` (one micro-step) on the CPU against
    ``jax.grad`` of the reference's loss, on the Queue 3 basis: with rec1
    tied over rec0, the reference's ``rec1.*`` gradient is the sum of the
    port's ``rec0.*`` and ``rec1.*`` and its ``rec0.*`` gradient is 0."""
    model, model_j, params_np, batch, _ = griffin
    jdt, tdt = WIRES[wire]
    tol = GRIFFIN_TOL[wire]
    want_loss, want = _jax_loss_and_grads(model_j, topo1, params_np, batch, jdt)
    params = params_from_jax(model, params_np, device="cpu")
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=tdt))
    grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train", compute_dtype=tdt),
                                      params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(loss.item() - want_loss) <= tol["loss"] * abs(want_loss)
    got = _on_jax_basis(model, grads)
    for name, w in want.items():
        g = got[name].numpy()
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert scale > 0 and err <= tol["grads"] * scale, \
            f"pool {name}: max |err| {err} > {tol['grads']} x {scale}"


def test_unknown_values_raise():
    for kw in (dict(boundary_schedule="pipelined"), dict(clip_mode="loose"),
               dict(prefetch_carry="x"), dict(micro_steps=0), dict(hop2_bucket_mb=0),
               dict(clip_mode="approx", boundary_schedule="serial"),
               dict(carry_offload="host", prefetch=False),
               dict(carry_offload="host", prefetch_carry="remat")):
        with pytest.raises(ValueError):
            MiCSConfig(**kw)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(setup):
    """Two steps of the smoke model on the card (the kernels, forward and
    backward) against the CPU (their plain versions), bf16 gather; the card
    is bitwise repeatable and serial == prefetch there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    mc = MiCSConfig(micro_steps=MICRO)
    card = _port_run(setup, mc, device="cuda")
    cpu = _port_run(setup, mc, device="cpu")
    for (lc, gc, *_), (lp, gp, *_) in zip(card[0], cpu[0]):
        assert abs(lc - lp) <= TOL["bf16"]["loss"] * abs(lp)
        assert abs(gc - gp) <= TOL["bf16"]["grad_norm"] * abs(gp)
    again = _port_run(setup, mc, device="cuda")
    serial = _port_run(setup, dataclasses.replace(mc, prefetch=False), device="cuda")
    for other in (again, serial):
        assert [m[:2] for m in card[0]] == [m[:2] for m in other[0]]
        assert _equal_states(card[1], other[1])


@pytest.mark.gpu
def test_cuda_griffin_train_step_matches_cpu(griffin):
    """Two steps of the 5-layer smoke recurrentgemma on the card (every
    kernel forward and backward, the RG-LRU's and the dh-256 attention's
    included) against the CPU (their plain versions), bf16 gather; the card
    is bitwise repeatable and serial == prefetch there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model, _, params_np, batch, _ = griffin
    oc = OptConfig(**OPT)

    def run(device, **kw):
        params = params_from_jax(model, params_np, device=device)
        state = {"params": params, "m": {k: torch.zeros_like(v) for k, v in params.items()},
                 "v": {k: torch.zeros_like(v) for k, v in params.items()}, "step": 0}
        step = build_train_step(model, MiCSTopology(), MiCSConfig(**kw), oc, device=device)
        out = []
        for _ in range(2):
            state, m = step(state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        return out, state

    card, cpu = run("cuda"), run("cpu")
    for (lc, gc), (lp, gp) in zip(card[0], cpu[0]):
        assert abs(lc - lp) <= TOL["bf16"]["loss"] * abs(lp)
        assert abs(gc - gp) <= TOL["bf16"]["grad_norm"] * abs(gp)
    for other in (run("cuda"), run("cuda", prefetch=False)):
        assert card[0] == other[0]
        assert _equal_states(card[1], other[1])
