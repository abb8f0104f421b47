"""The port's MiCS training step across 4 gloo ranks on the CPU: smoke
llama3.2-1b at layout A (p 4, ``outer_first``, inner 2), layout B (p 2 x 2
replicas) and ZeRO-3 (``pod x shard``), fp32 and bf16 gather, against the
JAX package's ``build_train_step`` on 4 virtual devices at the same layout
and against the port at p = 1 on the same global batch, both within
``test_torch_train.TOL``; the Fig-14 ``allreduce_slice`` step against the
2-hop one; bitwise at p > 1: serial == prefetch, serial == bucketed
boundary, a repeated step; the train loop resumed from its
checkpoint at layout B; a griffin step at layout A against p = 1; the
launcher under ``torchrun``; the autotuner's census of each A and B run
(``core/autotune.predict_traffic``) against every rank's ``CommCounter``.  Tensor parallelism (``K.TP_TRAINS``): one
step of llama at p 2 x tp 2 and griffin at tp 4 and p 2 x tp 2 against the
JAX package at the same layout (gradients divided by the reference's
factor tp) and against the port at tp 1 on the same weights, the step's
collective counts, serial == prefetch bitwise, and the reference's
factor itself.  ``gpu`` tests run the ranks' collectives on
CUDA tensors over gloo on one card."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import state_from_jax, tp_params_from_full  # noqa: E402
from repro_torch.core.mics import MiCSConfig, build_train_step  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.train_loop import LoopConfig, train  # noqa: E402
from test_torch_train import TOL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
PARTS = ("params", "m", "v")
# The port at a TP layout against the JAX package at that layout, fp32, one
# micro-batch (gradients divided by the reference's factor tp): measured
# loss 1e-7 and gradients 2e-6 of each pool's largest value.
TOL_TP_JAX = {"loss": 1e-6, "grads": 1e-5}


def _init(npz) -> dict:
    init = {part: {k.split(".", 2)[2]: npz[k] for k in npz.files
                   if k.startswith(f"init.{part}.")} for part in PARTS}
    init["step"] = 0
    return init


def _p1_run(model, init, wire):
    """The port at p = 1 on the whole global batch, from the same state."""
    state = state_from_jax(model, init, device="cpu")
    step = build_train_step(model, MiCSTopology(), MiCSConfig(
        micro_steps=K.MICRO, gather_dtype=TDT[wire]), OptConfig(**K.OPT), device="cpu")
    metrics = []
    for b in K.train_batches():
        state, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return np.asarray(metrics), {part: {k: v.numpy() for k, v in state[part].items()}
                                 for part in PARTS}


def _p1_loop(ckdir, total, family="llama3.2-1b"):
    cfg = smoke_variant(get_config(family))
    dc = DataConfig(vocab=cfg.vocab, seq=K.SEQ, global_batch=K.MICRO * K.GLOBAL_B,
                    micro_steps=K.MICRO)
    lc = LoopConfig(total_steps=total, checkpoint_every=0, checkpoint_dir=str(ckdir),
                    log_every=0)
    stats = train(build_model(cfg, tp=1), MiCSTopology(), MiCSConfig(micro_steps=K.MICRO),
                  OptConfig(**K.OPT), dc, lc, device="cpu")
    return np.asarray(list(zip(stats.losses, stats.grad_norms)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps (4 virtual devices) and the port's 4 gloo ranks run as
    subprocesses; the port's p = 1 references run here meanwhile."""
    out = tmp_path_factory.mktemp("dist_train")
    jax_proc = K.start("jax_dist_oracle.py", "train", str(out))
    K.finish(K.start("jax_dist_oracle.py", "init", str(out)), 180)
    port = K.start("torch_dist_harness.py", "train", str(out))
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    init = _init(np.load(out / "jax_init.npz"))
    p1 = {wire: _p1_run(model, init, wire) for wire in TDT}
    p1["loop"] = _p1_loop(out / "p1_loop", 3)
    p1["griffin"] = _p1_loop(out / "p1_griffin", 1, "recurrentgemma-2b")
    K.finish(port, 300)
    K.finish(jax_proc, 300)
    return (K.load_ranks(str(out / "port_train.rank{r}.npz")),
            dict(np.load(out / "jax_train.npz")), p1, init)


def _topo(layout):
    return MiCSTopology(**K.topo_kwargs(layout))


def _global(got: dict, key: str, topo: MiCSTopology) -> np.ndarray:
    """A pool's global array from the ranks' shards: the chunks of one
    replica in partition-coordinate order."""
    members = topo.partition_groups()[0]
    return np.concatenate([got[key][r] for r in members], axis=-1)


def _check_state(got: dict, prefix: str, topo, want: dict, tol: dict):
    for part in PARTS:
        for name, w in want[part].items():
            g = _global(got, f"{prefix}.{part}.{name}", topo)
            # every replica holds the same shard
            for group in topo.replication_groups():
                for r in group[1:]:
                    assert np.array_equal(got[f"{prefix}.{part}.{name}"][r],
                                          got[f"{prefix}.{part}.{name}"][group[0]])
            err = float(np.abs(g - w).max())
            bound = tol[part] if part == "params" else tol[part] * float(np.abs(w).max())
            assert err <= bound, f"{part}[{name}]: max |err| {err} > {bound}"


def _check_metrics(got: np.ndarray, want: np.ndarray, tol: dict):
    for i, ((loss, gn), (wl, wg)) in enumerate(zip(got, want)):
        assert np.isfinite(loss) and np.isfinite(gn)
        assert abs(loss - wl) <= tol["loss"] * abs(wl), (i, loss, wl)
        assert abs(gn - wg) <= tol["grad_norm"] * abs(wg), (i, gn, wg)


@pytest.mark.parametrize("name", list(K.TRAINS))
def test_train_steps_match_jax_at_the_same_layout(runs, name):
    got, want, _, _ = runs
    wire = K.TRAINS[name][3]
    metrics = got[f"{name}.metrics"]
    assert all(np.array_equal(metrics[r], metrics[0]) for r in range(K.WORLD))
    _check_metrics(metrics[0], want[f"{name}.metrics"], TOL[wire])
    state = {part: {k.split(".", 2)[2]: want[k] for k in want
                    if k.startswith(f"{name}.{part}.")} for part in PARTS}
    _check_state(got, name, _topo(K.TRAINS[name][0]), state, TOL[wire])


@pytest.mark.parametrize("name", list(K.TRAINS))
def test_train_steps_match_the_port_at_p1(runs, name):
    got, _, p1, _ = runs
    wire = K.TRAINS[name][3]
    want_metrics, want_state = p1[wire]
    _check_metrics(got[f"{name}.metrics"][0], want_metrics, TOL[wire])
    _check_state(got, name, _topo(K.TRAINS[name][0]), want_state, TOL[wire])


def test_initial_state_does_not_depend_on_the_layout(runs):
    _, want, _, init = runs
    for part in PARTS:
        for k, v in init[part].items():
            assert np.array_equal(want[f"init.{part}.{k}"], v)


def _same(got, a: str, b: str) -> bool:
    """Runs ``a`` and ``b`` bitwise equal: metrics and final state (their
    collective counts may differ by schedule)."""
    keys = [k[len(a) + 1:] for k in got if k.startswith(a + ".")
            and k[len(a) + 1:] not in ("calls", "bytes")]
    return bool(keys) and all(np.array_equal(got[f"{a}.{k}"], got[f"{b}.{k}"]) for k in keys)


def test_serial_equals_prefetch_bitwise_at_p4(runs):
    got = runs[0]
    assert _same(got, "A:bf16.serial", "A:bf16")


def test_repeated_step_is_bitwise_at_p4(runs):
    got = runs[0]
    assert _same(got, "A:bf16.again", "A:bf16")


def test_serial_equals_bucketed_bitwise_at_two_replicas(runs):
    """Hop 2 in many buckets (0.01 MB) against whole pools: a sum of two
    replicas does not depend on its order."""
    got = runs[0]
    assert _same(got, "B:bf16.serial", "B:bf16.bucketed")


def test_allreduce_slice_matches_two_hop_at_two_replicas(runs):
    """``sync_mode="allreduce_slice"`` (Fig 14: the full gradient summed
    over all 4 data ranks each micro-step, no hop 2) against the 2-hop
    step at layout B: the same sums in other orders, within the fp32 TOL."""
    got = runs[0]
    _check_metrics(got["B:fp32.allreduce_slice.metrics"][0], got["B:fp32.metrics"][0],
                   TOL["fp32"])
    topo = _topo("B")
    want = {part: {k.split(".", 2)[2]: _global(got, k, topo) for k in got
                   if k.startswith(f"B:fp32.{part}.")} for part in PARTS}
    _check_state(got, "B:fp32.allreduce_slice", topo, want, TOL["fp32"])


def test_loop_resumes_bitwise_at_layout_B(runs):
    """``train`` over 4 ranks, checkpointing each step: 1 step then a
    resume to 3 is bitwise the 3 uninterrupted steps, and both final
    checkpoints read back equal; each rank wrote its own shards (3 parts x
    3 pools x 4 ranks)."""
    got = runs[0]
    assert np.array_equal(got["loop.whole"], got["loop.cut"])
    assert got["loop.restored_equal"].all()
    assert got["loop.meta"].tolist() == [[3, 3, 4]] * K.WORLD
    assert got["loop.files"].tolist() == [36] * K.WORLD


def test_loop_at_layout_B_matches_the_port_at_p1(runs):
    """The global batch does not depend on the topology: the 4-rank loop's
    losses and grad norms are the one-rank loop's, within the bf16 TOL."""
    got, _, p1, _ = runs
    _check_metrics(got["loop.whole"][0], p1["loop"], TOL["bf16"])


# ---------------------------------------------------------------------------
# the int8 and bf16 wires
# ---------------------------------------------------------------------------
# The wires against the JAX package at the same layout, 2 steps: the bf16
# hop 2 at the bf16 TOL (the same rounding points); the int8 wires with
# nearest rounding at 2e-3 relative on the loss (the quantization moves the
# gradients by up to a step of each block; the two sides' bf16 sums and
# the reference's jitted scale, absmax x fl(1/127), differ) and 2e-2 on
# the grad norm.
WIRE_TOL = {"B:hop2_bf16": TOL["bf16"], "B:hop2_int8": dict(loss=2e-3, grad_norm=2e-2),
            "A:qwz_qgz": dict(loss=2e-3, grad_norm=2e-2)}
# The stochastic wires over 4 steps against the fp32 wires' run: the
# reference's ``int8_hop1_convergence`` bound on the final loss.
STOCHASTIC_LOSS_RTOL = 0.05


@pytest.mark.parametrize("name", list(K.WIRE_JAX))
def test_wire_steps_match_jax_at_the_same_layout(runs, name):
    got, want, _, _ = runs
    metrics = got[f"{name}.metrics"]
    assert all(np.array_equal(metrics[r], metrics[0]) for r in range(K.WORLD))
    _check_metrics(metrics[0], want[f"{name}.metrics"], WIRE_TOL[name])
    if name == "B:hop2_bf16":
        state = {part: {k.split(".", 2)[2]: want[k] for k in want
                        if k.startswith(f"{name}.{part}.")} for part in PARTS}
        _check_state(got, name, _topo("B"), state, TOL["bf16"])


def test_hop1_bf16_under_the_bf16_gather_is_the_default_bitwise(runs):
    """The bf16 gather's cotangent is bf16 already, so the bf16 hop-1 wire
    is bitwise the default (the reference's ``hop1_bf16_bitwise``)."""
    assert _same(runs[0], "A:hop1_bf16", "A:bf16")


def test_serial_equals_bucketed_under_the_bf16_hop2_bitwise(runs):
    """A bucket's cast is the cast's bucket: the two boundaries agree
    bitwise under the bf16 hop 2 (0.01 MB buckets, some across rows), and
    the bf16 wire rounds the gradient (it is not the fp32 hop 2)."""
    got = runs[0]
    assert _same(got, "B:hop2_bf16.serial", "B:hop2_bf16.bucketed")
    assert not np.array_equal(got["B:hop2_bf16.serial.metrics"], got["B:bf16.serial.metrics"])


def test_int8_hop2_bucketed_is_serial_within_quantization_error(runs):
    """The int8 blocks follow the payload (a pool, or a 0.01 MB bucket), so
    the two boundaries differ, by less than 0.05 of the loss."""
    got = runs[0]
    a, b = got["B:hop2_int8.metrics"][0], got["B:hop2_int8.bucketed.metrics"][0]
    assert not np.array_equal(a, b)
    assert np.all(np.abs(a[:, 0] - b[:, 0]) <= 0.05 * np.abs(b[:, 0]))


@pytest.mark.parametrize("layout", ["A", "B"])
def test_stochastic_wires_converge(runs, layout):
    """Stochastic rounding over 4 steps (A: the int8 gather and hop 1; B:
    the bf16 hop 1 and int8 hop 2, bucketed): every rank the same finite
    metrics, the loss falls, and it ends within 0.05 of the fp32 wires'."""
    got = runs[0]
    m = got[f"{layout}:stochastic.metrics"]
    ref = got[f"{layout}:fp32_wires.metrics"][0]
    assert m.shape == (K.WORLD, K.WIRE_STEPS, 2) and np.isfinite(m).all()
    assert all(np.array_equal(m[r], m[0]) for r in range(K.WORLD))
    assert m[0, -1, 0] < m[0, 0, 0]
    assert abs(m[0, -1, 0] - ref[-1, 0]) <= STOCHASTIC_LOSS_RTOL * abs(ref[-1, 0])


def _wire_calls(name: str, case: tuple, steps: int) -> dict:
    """A rank's collective calls over a wire run (PERF.md §4): each pool
    row a micro-step, the gather once a stage (twice under the int8 gather:
    values and scales) and hop 1 once a stage (under the int8 wire two
    ``all_to_all``); each hop-2 payload (a pool under the serial boundary,
    a bucket under the bucketed one) a step, one ``all_reduce`` or under
    the int8 wire two ``all_to_all`` and two ``all_gather``; the norm and
    the loss means once a step."""
    from repro_torch.core.schedule import plan_boundary

    lay, _, inner, kw = case
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    topo = _topo(lay)
    rows = sum(p.stack for p in model.all_pools()) * steps * K.MICRO
    stages = ("outer", "inner") if topo.partition_size == 4 else ("partition",)
    gathers = 2 if kw.get("quant_gather") else 1
    calls = {}
    for st in stages:
        calls[f"all_gather:{st}"] = gathers * rows
        if kw.get("hop1_wire_dtype") == "int8":
            calls[f"all_to_all:{st}"] = 2 * rows
        else:
            calls[f"reduce_scatter:{st}"] = rows
    calls["all_reduce:partition"] = calls["all_reduce:data"] = steps
    if topo.replication_degree > 1:
        plan = plan_boundary(model, topo, mode=kw.get("boundary_schedule", "bucketed"),
                             bucket_mb=kw.get("hop2_bucket_mb", 32.0))
        payloads = (len(plan.shard_elems) if plan.mode == "serial" else plan.n_buckets) * steps
        if kw.get("compress_hop2") == "int8":
            calls["all_to_all:replication"] = calls["all_gather:replication"] = 2 * payloads
        else:
            calls["all_reduce:replication"] = payloads
    return dict(sorted(calls.items()))


WIRE_COUNTED = {**{n: (c, K.STEPS) for n, c in {**K.WIRE_JAX, **K.WIRE_PORT}.items()},
                **{n: (c, K.WIRE_STEPS) for n, c in K.WIRE_LONG.items()}}


@pytest.mark.parametrize("name", list(WIRE_COUNTED))
def test_wire_collective_counts(runs, name):
    got = runs[0]
    case, steps = WIRE_COUNTED[name]
    want = _wire_calls(name, case, steps)
    for r in range(K.WORLD):
        assert json.loads(str(got[f"{name}.calls"][r])) == want, r


@pytest.mark.parametrize("name", list(K.CENSUS))
def test_census_matches_the_counter(runs, name):
    """The autotuner's analytical census of a step (``predict_traffic``,
    the run's boundary and bucket size) against every rank's
    ``CommCounter`` over the run in the census's units
    (``census_from_counter``), stage by stage (``compare_census``): the
    calls of each stage the ``CommEngine`` owns equal; the wire bytes equal
    for the float wires, within ``K.CENSUS_INT8_RTOL`` for the int8 ones."""
    from repro_torch.core.autotune import census_from_counter, compare_census, predict_traffic
    from repro_torch.core.comm import policies_from_config

    lay, order, inner, wire, kw, steps = K.CENSUS[name]
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    topo = _topo(lay)
    mcfg = MiCSConfig(micro_steps=K.MICRO, gather_dtype=TDT[wire], gather_order=order,
                      hierarchy_inner=inner, **kw)
    gp, sp = policies_from_config(mcfg)
    pred = predict_traffic(model, topo, gp, sp, micro_steps=K.MICRO,
                           boundary=mcfg.boundary_schedule,
                           hop2_bucket_mb=mcfg.hop2_bucket_mb)["by_stage"]
    int8 = gp.wire_dtype == "int8" or "int8" in (sp.hop1_wire_dtype, sp.hop2_wire_dtype)
    got = runs[0]
    for r in range(K.WORLD):
        snap = {"calls": json.loads(str(got[f"{name}.calls"][r])),
                "bytes": json.loads(str(got[f"{name}.bytes"][r]))}
        cmp = compare_census(pred, census_from_counter(snap, topo, gp, steps=steps))
        assert set(cmp) == set(pred), (r, sorted(cmp))
        for stage, c in cmp.items():
            assert c["measured_count"] == c["predicted_count"], (r, stage, c)
            assert c["ratio"] == pytest.approx(1.0, rel=K.CENSUS_INT8_RTOL if int8 else 1e-12), (
                r, stage, c)


@pytest.mark.parametrize("name,bf16_run,kinds", [
    ("A:qwz_qgz", "A:bf16", ("all_gather:outer", "all_gather:inner", "all_to_all:outer",
                             "all_to_all:inner", "reduce_scatter:outer",
                             "reduce_scatter:inner")),
    ("B:hop2_int8", "B:bf16.serial", ("all_to_all:replication", "all_gather:replication",
                                      "all_reduce:replication")),
])
def test_int8_wire_bytes(runs, name, bf16_run, kinds):
    """The int8 legs (values and scales together) count at most 0.55 of
    the bytes a bf16 wire carries for the same payloads (1 + 4/128 B
    against 2 B a value): at A against the bf16 gather and hop 1 of the
    same steps; at B against the fp32 hop 2 of the same payloads, whose one
    all-reduce is counted at 4 B a value, the bf16 wire's two legs' 2 B
    each."""
    got = runs[0]
    for r in range(K.WORLD):
        mine = json.loads(str(got[f"{name}.bytes"][r]))
        ref = json.loads(str(got[f"{bf16_run}.bytes"][r]))
        ours, theirs = (sum(b.get(k, 0) for k in kinds) for b in (mine, ref))
        assert 0 < ours <= 0.55 * theirs, (r, ours, theirs)


def test_griffin_step_at_layout_A_matches_p1(runs):
    got, _, p1, _ = runs
    assert all(np.array_equal(got["griffin"][r], got["griffin"][0]) for r in range(K.WORLD))
    _check_metrics(got["griffin"][0], p1["griffin"], TOL["bf16"])


# ---------------------------------------------------------------------------
# tensor parallelism: llama at p 2 x tp 2, griffin at tp 4 and p 2 x tp 2
# ---------------------------------------------------------------------------

def _tp_config(name):
    arch, _, _, over = K.TP_TRAINS[name]
    return dataclasses.replace(smoke_variant(get_config(arch)), **over)


def _tp1_step(name):
    """The port at tp = 1 and p = 1 on the whole weights and the whole
    global batch: one step's (loss, grad_norm) and state."""
    model = build_model(_tp_config(name), tp=1)
    params = {k: torch.from_numpy(v) for k, v in K.numpy_params(model, name).items()}
    state = {"params": params, "step": 0,
             **{part: {k: torch.zeros_like(v) for k, v in params.items()} for part in ("m", "v")}}
    step = build_train_step(model, MiCSTopology(), MiCSConfig(
        micro_steps=K.MICRO, gather_dtype=TDT[K.TP_TRAINS[name][2]]), OptConfig(**K.OPT),
        device="cpu")
    state, m = step(state, K.tp_batch(name))
    return (np.asarray([[m["loss"].item(), m["grad_norm"].item()]]),
            {part: {k: v.numpy() for k, v in state[part].items()} for part in PARTS})


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The reference's losses and gradients at each TP layout and at tp 1
    (4 virtual devices) and the port's 4 gloo ranks run as subprocesses;
    the port's tp = 1 steps run here meanwhile."""
    out = tmp_path_factory.mktemp("tp_train")
    jax_proc = K.start("jax_dist_oracle.py", "tp_train", str(out))
    port = K.start("torch_dist_harness.py", "tp_train", str(out))
    tp1 = {name: _tp1_step(name) for name in K.TP_TRAINS}
    K.finish(port, 300)
    K.finish(jax_proc, 300)
    return (K.load_ranks(str(out / "port_tp_train.rank{r}.npz")),
            dict(np.load(out / "jax_tp_train.npz")), tp1)


def _tp_global(got: dict, key: str, topo: MiCSTopology) -> np.ndarray:
    """A pool's global ``[stack, tp, flat_len]`` from the ranks' shards:
    for each model coordinate, the chunks of its first partition group in
    partition-coordinate order."""
    cols = []
    for group in topo.partition_groups()[:topo.model_size]:
        cols.append(np.concatenate([got[key][r] for r in group], axis=-1))
    return np.concatenate(cols, axis=1)


def _tp_models(name):
    cfg = _tp_config(name)
    topo = _topo(K.TP_TRAINS[name][1])
    return topo, build_model(cfg, tp=topo.model_size), build_model(cfg, tp=1)


def _jax_factor(want: dict, name: str, pool: str) -> tuple[float, float]:
    """The reference's gradient at the TP layout against its gradient at tp
    1 cut the same way: the least-squares factor and the largest
    elementwise misfit of that factor, relative to the largest value."""
    topo, model, model_1 = _tp_models(name)
    cut = tp_params_from_full(model, model_1, {pool: want[f"{name}.tp1.grads.{pool}"]})[pool]
    g = want[f"{name}.grads.{pool}"]
    f = float((g * cut).sum() / (cut * cut).sum())
    return f, float(np.abs(g - f * cut).max() / np.abs(g).max())


TP_JAX = [n for n, c in K.TP_TRAINS.items() if c[2] == "fp32"]


@pytest.mark.parametrize("name", TP_JAX)
def test_tp_step_matches_jax_at_the_same_layout(tp_runs, name):
    """The loss of every rank, and the gradients of one micro-batch divided
    by the reference's factor tp (``test_reference_gradients_at_tp_are_tp_
    times``), within ``TOL_TP_JAX`` (fp32: the same sums in other orders)
    of the JAX package at the same layout, griffin on the reference's
    basis (rec0's gradient on rec1)."""
    got, want, _ = tp_runs
    topo, model, _ = _tp_models(name)
    tp = topo.model_size
    np.testing.assert_allclose(got[f"{name}.loss"].ravel(), want[f"{name}.loss"],
                               rtol=TOL_TP_JAX["loss"])
    grads = {pool: _tp_global(got, f"{name}.grads.{pool}", topo)
             for pool in model.global_flat_shapes()}
    grads = K.on_jax_basis(model, grads)
    for pool, g in grads.items():
        w = want[f"{name}.grads.{pool}"] / tp
        err = float(np.abs(g - w).max())
        assert err <= TOL_TP_JAX["grads"] * float(np.abs(w).max()), (pool, err)
    gn = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    gn_jax = np.sqrt(sum(float((want[f"{name}.grads.{p}"].astype(np.float64) ** 2).sum())
                         for p in grads)) / tp
    assert abs(gn - gn_jax) <= TOL_TP_JAX["grads"] * gn_jax


@pytest.mark.parametrize("name", list(K.TP_TRAINS))
def test_tp_step_matches_the_port_at_tp1(tp_runs, name):
    """One step at the TP layout from the cut weights equals one step at
    tp = 1 (p = 1, the whole global batch) from the whole weights: the loss
    and grad norm, and params, m and v cut the same way, within
    ``test_torch_train.TOL`` of the gather's wire (padded Q heads and
    vocab columns stay 0)."""
    got, _, tp1 = tp_runs
    topo, model, model_1 = _tp_models(name)
    wire = K.TP_TRAINS[name][2]
    metrics = got[f"{name}.metrics"]
    assert all(np.array_equal(metrics[r], metrics[0]) for r in range(K.WORLD))
    want_metrics, want_state = tp1[name]
    _check_metrics(metrics[:1], want_metrics, TOL[wire])
    for part in PARTS:
        cut = tp_params_from_full(model, model_1, want_state[part])
        for pool, w in cut.items():
            g = _tp_global(got, f"{name}.{part}.{pool}", topo)
            err = float(np.abs(g - w).max())
            tol = TOL[wire][part]
            bound = tol if part == "params" else tol * float(np.abs(w).max())
            assert err <= bound, f"{part}[{pool}]: max |err| {err} > {bound}"


def test_tp_serial_equals_prefetch_bitwise_at_p2_tp2(tp_runs):
    """The bf16 step's metrics, params, m and v (not its collective counts:
    the serial schedule gathers again in the backward)."""
    got = {k: v for k, v in tp_runs[0].items() if not k.endswith(".calls")}
    assert _same(got, "llama@P2T2:bf16.serial", "llama@P2T2:bf16")


def _tp_expected_calls(name) -> dict:
    """The step's collectives a rank under prefetch, from the layout: a
    micro-step gathers each model-sharded segment of a layer row twice
    (the forward and the checkpointed recompute) and reduce-scatters it
    once (``model`` where the whole model group gathers it, ``kv`` for a
    run of KV ranks), issues each row-parallel psum (after ``wo``,
    ``rec.wo``, ``wd``) three times (forward, recompute, backward) except
    the row's last, which the recompute stops before (non-reentrant
    checkpointing recomputes only up to the last tensor the backward
    saved); each embedding lookup's gather (the tokens; enc-dec adds its
    token and frame positions) and the final norm's segments' (its scale;
    LayerNorm adds the bias), once each and their reduce-scatters; the
    loss's pmax, its two psums and the
    backward's one.  A step adds the norm's psum over the model group,
    over the partition group at p > 1, and the loss mean over the data
    ranks when there are several; the partition gathers as at tp 1 (a
    layer pool of one row runs the serial schedule, whose checkpoint holds
    the gather: its recompute gathers the row again).  A segment whose
    name repeats later in its layout (the sLSTM's ``s.wo``, ROADMAP
    Queue 3) is gathered but never read, so it has no reduce-scatter."""
    topo, model, _ = _tp_models(name)
    tp, calls = topo.model_size, {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    for pool in model.pools:
        names = [seg.name for seg in pool.layout.segments]
        for i, seg in enumerate(pool.layout.segments):
            if seg.model_gather > 1:
                label = "model" if seg.model_gather == tp else "kv"
                add(f"all_gather:{label}", 2 * pool.stack * K.MICRO)
                if seg.name not in names[i + 1:]:
                    add(f"reduce_scatter:{label}", pool.stack * K.MICRO)
        psums = sum(seg.name.endswith(("attn.wo", "rec.wo", "mlp.wd"))
                    for seg in pool.layout.segments)
        add("all_reduce:model", (3 * psums - 1) * pool.stack * K.MICRO)
    lookups = 3 if model.cfg.family == "encdec" else 1
    head = sum(seg.model_gather > 1 for seg in model.head.layout.segments)
    add("all_gather:model", (lookups + head) * K.MICRO)    # the embedding, the final norm
    add("reduce_scatter:model", (lookups + head) * K.MICRO)
    add("all_reduce_max:model", K.MICRO)
    add("all_reduce:model", 3 * K.MICRO + 1)
    if topo.partition_size > 1:
        rows = sum(pool.stack for pool in model.all_pools())
        serial = sum(pool.stack == 1 for pool in model.pools)
        add("all_gather:partition", (rows + serial) * K.MICRO)
        add("reduce_scatter:partition", rows * K.MICRO)
        add("all_reduce:partition", 1)
    if topo.data_parallel_size > 1:
        add("all_reduce:data", 1)
    return dict(sorted(calls.items()))


@pytest.mark.parametrize("name", list(K.TP_TRAINS))
def test_tp_step_collective_counts(tp_runs, name):
    got = tp_runs[0]
    want = _tp_expected_calls(name)
    for r in range(K.WORLD):
        assert json.loads(str(got[f"{name}.calls"][r])) == want


@pytest.mark.parametrize("name", TP_JAX)
def test_reference_gradients_at_tp_are_tp_times(tp_runs, name):
    """Pins a reference caveat (ROADMAP Queue 3): under ``shard_map(...,
    check_vma=False)`` the JAX package transposes a psum to a psum and seeds
    every model rank's backward with the whole cotangent, so each of its
    gradients at tp > 1 is tp times the tp = 1 gradient of the same logical
    weights, in every pool (its grad norm too).  If the reference changes,
    this fails and the factor the parity tests divide by must be
    re-measured."""
    _, want, _ = tp_runs
    topo, model, _ = _tp_models(name)
    for pool in model.global_flat_shapes():
        f, misfit = _jax_factor(want, name, pool)
        assert abs(f - topo.model_size) <= 1e-5 * topo.model_size, (pool, f)
        assert misfit <= 1e-5, (pool, misfit)


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_launcher_trains_over_four_ranks_under_torchrun(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
         "--dist-backend", "gloo", "--partition-size", "4", "--gather-order", "outer_first",
         "--steps", "2", "--seq", "32", "--global-batch", "8", "--dist-timeout-s", "120",
         "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert any(ln.startswith("ranks: 4 over gloo, p=4") for ln in lines), out.stdout
    assert len([ln for ln in lines if ln.startswith("final loss ")]) == 1, out.stdout
    assert lines[-1].startswith("final loss ") and "over 2 steps on cpu" in lines[-1]
    assert len(list((tmp_path / "ck" / "step_00000002").glob("params.*.rank*.npy"))) == 12


def test_launcher_refuses_nccl_with_more_ranks_than_cards(tmp_path):
    """Before any collective: two ranks on a host with fewer cards."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    env = _env() | {"RANK": "0", "WORLD_SIZE": str(cards + 2),
                    "LOCAL_WORLD_SIZE": str(cards + 2), "MASTER_ADDR": "localhost",
                    "MASTER_PORT": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
         "--device", "cpu", "--dist-backend", "nccl", "--steps", "1",
         "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert "backend nccl takes one card a rank" in out.stderr, out.stderr[-2000:]


def test_launcher_needs_a_backend_over_several_ranks(tmp_path):
    env = _env() | {"RANK": "0", "WORLD_SIZE": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
         "--device", "cpu", "--steps", "1", "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and "--dist-backend" in out.stderr


# ---------------------------------------------------------------------------
# on the card: the collectives of CUDA tensors over gloo
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks' tensors live on it")


@pytest.mark.gpu
def test_cuda_collectives_over_gloo_match_the_cpu(card, tmp_path):
    """4 ranks on one card: every collective case on CUDA tensors (through
    pinned host buffers) gives bitwise the CPU run's results."""
    for device in ("cpu", "cuda"):
        sub = tmp_path / device
        sub.mkdir()
        K.finish(K.start("torch_dist_harness.py", "collectives", str(sub), device), 300)
    cpu = K.load_ranks(str(tmp_path / "cpu" / "port_collectives.rank{r}.npz"))
    cuda = K.load_ranks(str(tmp_path / "cuda" / "port_collectives.rank{r}.npz"))
    assert cpu.keys() == cuda.keys()
    for k in cpu:
        assert np.array_equal(cpu[k], cuda[k]), k


@pytest.mark.gpu
def test_nccl_with_more_ranks_than_cards_raises_on_the_card(card, monkeypatch):
    import datetime

    from repro_torch.launch.mesh import init_distributed

    n = torch.cuda.device_count() + 1
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n))
    with pytest.raises(RuntimeError, match="one card a rank"):
        init_distributed("nccl", timeout=datetime.timedelta(seconds=10))
