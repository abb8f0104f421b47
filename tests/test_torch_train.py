"""The port's training step against the JAX package's
``repro.core.mics.build_train_step`` on the CPU: the same JAX
``init_state`` carried over with ``repro_torch.convert.state_from_jax``,
the same batches, smoke llama3.2-1b, ``micro_steps=2``, 3 steps; the
port's bitwise equalities between its own schedules; and every training
knob it refuses.  A ``gpu`` test holds the card's step to the CPU's."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

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
from repro_torch.convert import state_from_jax  # noqa: E402
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
    "prefetch_carry": dict(prefetch_carry="remat"),
    "carry_offload": dict(carry_offload="host"),
    "offload_opt": dict(offload_opt=True),
    "clip_mode": dict(clip_mode="approx"),
    "policy": dict(policy="auto"),
    "hbm_budget_gb": dict(hbm_budget_gb=40.0),
    "hop1_bf16": dict(hop1_wire_dtype="bf16"),
    "hop1_int8": dict(hop1_wire_dtype="int8"),
    "compress_hop2": dict(compress_hop2=True),
    "hop2_int8": dict(compress_hop2="int8"),
    "sync_mode": dict(sync_mode="allreduce_slice"),
    "quant_gather": dict(quant_gather=True),
    "no_hierarchical": dict(hierarchical=False),
    "outer_first": dict(gather_order="outer_first"),
    "scores_bf16": dict(scores_bf16=True),
}


@pytest.mark.parametrize("knob", list(REFUSED))
def test_refused_knob_raises(setup, knob):
    with pytest.raises(NotImplementedError):
        build_train_step(setup[0], MiCSTopology(), MiCSConfig(**REFUSED[knob]), OptConfig(),
                         device="cpu")


@pytest.mark.parametrize("topo", [dict(repl=2), dict(shard=2), dict(model=2)])
def test_more_than_one_card_raises(setup, topo):
    with pytest.raises(NotImplementedError):
        build_train_step(setup[0], MiCSTopology(**topo), MiCSConfig(), OptConfig(), device="cpu")


@pytest.mark.parametrize("family,device,refused", [
    ("griffin", "cuda", True),    # the RG-LRU kernel has no gradient yet
    ("griffin", "cpu", False),    # the plain version is differentiable
    ("dense", "cuda", False),
    ("dense", "cpu", False),
])
def test_griffin_training_refused_on_a_cuda_device(family, device, refused):
    """The family check reads only the device's type, so it runs without a
    card; a refusal names the ROADMAP item that lifts it."""
    call = lambda: refuse_unported(MiCSConfig(), MiCSTopology(), family,  # noqa: E731
                                   torch.device(device))
    if refused:
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
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


def test_unknown_values_raise():
    for kw in (dict(boundary_schedule="pipelined"), dict(clip_mode="loose"),
               dict(prefetch_carry="x"), dict(micro_steps=0), dict(hop2_bucket_mb=0)):
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
def test_cuda_griffin_train_step_raises():
    """On the card griffin's train step is refused where it is built, and
    its RG-LRU kernel refuses a call autograd records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = build_model(smoke_variant(get_config("recurrentgemma-2b")), tp=1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        build_train_step(model, MiCSTopology(), MiCSConfig(), OptConfig(), device="cuda")
    params = init_params(model, seed=0, device="cuda")
    tokens = torch.zeros((1, 2, 16), dtype=torch.int64, device="cuda")
    batch = {"tokens": tokens, "targets": tokens, "mask": torch.ones((1, 2, 16), device="cuda")}
    comm = CommEngine.from_config(MiCSTopology(), MiCSConfig())
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        accumulate_grads(model, comm, L.Ctx(mode="train", compute_dtype=torch.bfloat16),
                         params, batch)
