"""The port's serving over ranks on the CPU: one 4-rank gloo world
(``torch_dist_harness.py serve``) against the JAX package on 4 virtual
devices (``jax_dist_oracle.py serve``), the same global weights
(``K.numpy_params`` cut by ``convert.tp_params_from_full``, each rank's
shard by ``convert.shard_params``) and numpy-seeded inputs on both sides.

* the fixed-batch steps (``build_serve_steps(groups=)``), fp32 gather:
  smoke llama at A (p 4, ``outer_first``), B (p 2 x 2 replicas), p 2 x tp 2
  and tp 4 (2 KV heads over 4 model ranks: head-slot replication), smoke
  griffin at p 2 x tp 2 and tp 4 (10 Q heads padded to 12), and stored
  int8 weights at B: prefill and 3 greedy decode steps, the logits
  (rank-local rows and columns, assembled) within the tolerance below of
  the reference's, the tokens equal, the collective counts;
* ``build_paged_step(groups=)`` at p 2 x tp 2 and tp 4 with fp32 pools (a
  pool and allocator a data rank): the logit rows against the reference's,
  and bitwise the port's contiguous step over pools filled by
  ``pages_from_contiguous``;
* the vocab-parallel sampler at tp 2 and 4: every rank bitwise the port's
  tp 1 sampler on the whole logits (exact top-k), greedy rows the
  reference's;
* the resilient loop's world changes over process groups from
  ``elastic_host_topology(4, 2, tp=2)``: preempt 4 -> 2, grow 2 -> 4, a
  straggler 4 -> 3 rounded down to 2, a crash at 4, and a fault-free run on
  2 ranks, each bitwise the fault-free 4-rank run with the ledger
  accounted; its greedy completions and ledger the reference loop's;
* ``launch/serve.py --continuous`` under ``torchrun`` on 2 ranks with a
  preemption and a grow-back.
"""

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
from repro_torch.convert import shard_params, tp_params_from_full  # noqa: E402
from repro_torch.core.mics import MiCSConfig  # noqa: E402
from repro_torch.core.quant import quantize_state  # noqa: E402
from repro_torch.core.topology import MODEL_AXIS, MiCSTopology, hierarchy_factors  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.runtime.serving import resize_for_serve_world  # noqa: E402
from test_torch_train import TOL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The logits' largest difference from the reference's, relative to their
# largest |value|.  llama: TOL["fp32"]'s loss tolerance (measured 1.4e-6:
# the sums over the model ranks and the partition gathers add in other
# orders).  griffin: its conv state is bf16 even under the fp32 gather, so
# a value ~1e-6 apart between the packages may round one bf16 ulp apart
# (test_torch_tp.py's note) and that ulp reaches the next step's logits:
# TOL["fp32"]'s moment tolerance (measured 2.6e-5).
LOGIT_RTOL = {"llama3.2-1b": TOL["fp32"]["loss"], "recurrentgemma-2b": TOL["fp32"]["m"],
              "llama-3.2-vision-90b": TOL["fp32"]["loss"]}
LAUNCH_PLAN = "preempt@4x1,grow@8x1"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke steps run as fast on one thread, and the test workers and
    the gloo ranks beside them do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (4 virtual devices), the port's 4 gloo ranks and the
    launcher on 2 ranks under ``torchrun``, as subprocesses side by side."""
    out = tmp_path_factory.mktemp("dist_serve")
    jax_proc = K.start("jax_dist_oracle.py", "serve", str(out))
    port = K.start("torch_dist_harness.py", "serve", str(out))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b", "--smoke", "--device",
         "cpu", "--dist-backend", "gloo", "--dist-timeout-s", "60", "--continuous",
         "--requests", "6", "--prompt-len", "8", "--decode-tokens", "4", "--arrival-rate",
         "1", "--fault-plan", LAUNCH_PLAN],
        cwd=out, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    K.finish(port, 300)
    K.finish(jax_proc, 300)
    stdout, stderr = launcher.communicate(timeout=300)
    return (K.load_ranks(str(out / "port_serve.rank{r}.npz")), dict(np.load(out / "jax_serve.npz")),
            (launcher.returncode, stdout, stderr))


def _topo(layout: str) -> MiCSTopology:
    return MiCSTopology(**K.topo_kwargs(layout))


def _assemble(got: dict, key: str, topo: MiCSTopology) -> np.ndarray:
    """The global logits from the ranks' pieces: rows by data rank, columns
    by model coordinate (any rank of each (data rank, model coordinate)
    pair; a partition group's members hold the same rows)."""
    rows = []
    for d in range(topo.data_parallel_size):
        cols = []
        for m in range(topo.model_size):
            r = next(r for r in range(topo.world_size)
                     if topo.data_rank(r) == d and topo.rank_coords(r)[MODEL_AXIS] == m)
            cols.append(got[key][r])
        rows.append(np.concatenate(cols, axis=-1))
    return np.concatenate(rows, axis=0)


def _close(got: np.ndarray, want: np.ndarray, rtol: float, what: str) -> None:
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= rtol, f"{what}: max |err| {err:.3g} of the largest |logit| > {rtol}"


# ---------------------------------------------------------------------------
# the fixed-batch steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(K.SERVE_FIXED))
def test_fixed_batch_steps_match_jax_at_the_same_layout(runs, name):
    got, want, _ = runs
    arch, lay = K.SERVE_FIXED[name][:2]
    topo = _topo(lay)
    for step in ["prefill"] + [f"decode{i}" for i in range(K.SERVE_STEPS)]:
        _close(_assemble(got, f"{name}.{step}", topo), want[f"{name}.{step}"],
               LOGIT_RTOL[arch], f"{name} {step}")
    # every rank holds the global tokens, the reference's
    for r in range(K.WORLD):
        np.testing.assert_array_equal(got[f"{name}.tokens"][r], want[f"{name}.tokens"])


def _serve_expected_calls(name: str) -> dict:
    """The ``CommEngine``'s calls over a prefill and ``SERVE_STEPS``
    decode steps, a rank: each pool row gathered once a forward over the
    partition group (p > 1; once a stage of the staged gather; the int8
    wire's values and scales two calls); at tp > 1 each model-gathered
    segment of a layer row once a forward (``model`` over the whole model
    group, ``kv`` over a run of KV ranks), the embedding's and the final
    norm scale's gather, each row-parallel psum (after ``wo``, ``rec.wo``,
    ``wd``) once, and the greedy sampler's pmax and pmin a decode step;
    the sampled tokens gathered over the data group a decode step (dp >
    1)."""
    arch, lay, _, inner, over, int8 = K.SERVE_FIXED[name]
    topo = _topo(lay)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    model = build_model(cfg, topo.model_size)
    fwd, tp, calls = 1 + K.SERVE_STEPS, topo.model_size, {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    if topo.partition_size > 1:
        rows = sum(pool.stack for pool in model.all_pools())
        outer, inn = hierarchy_factors(topo, inner)
        for stage in (("outer", "inner") if outer > 1 and inn > 1 else ("partition",)):
            add(f"all_gather:{stage}", rows * fwd * (2 if int8 else 1))
    if tp > 1:
        for pool in model.pools:
            for seg in pool.layout.segments:
                if seg.model_gather > 1:
                    add(f"all_gather:{'model' if seg.model_gather == tp else 'kv'}",
                        pool.stack * fwd)
            psums = sum(seg.name.endswith(("attn.wo", "rec.wo", "mlp.wd"))
                        for seg in pool.layout.segments)
            add("all_reduce:model", psums * pool.stack * fwd)
        add("all_gather:model", 2 * fwd)
        add("all_reduce_max:model", K.SERVE_STEPS)
        add("all_reduce_min:model", K.SERVE_STEPS)
    if topo.data_parallel_size > 1:
        add("all_gather:data", K.SERVE_STEPS)
    return dict(sorted(calls.items()))


@pytest.mark.parametrize("name", list(K.SERVE_FIXED))
def test_fixed_batch_collective_counts(runs, name):
    want = _serve_expected_calls(name)
    for r in range(K.WORLD):
        assert json.loads(str(runs[0][f"{name}.calls"][r])) == want, r


def test_vlm_over_ranks_serves_the_tp1_tokens(runs):
    """The VLM at p 2 x tp 2 (its cross layers' heads over the model group,
    the vision rows over the data ranks) greedy-decodes the tokens of the
    port at tp 1 on the whole weights, and its logits are those of tp 1."""
    from repro_torch.runtime.serving import build_serve_steps

    name = "vlm@P2T2"
    got = runs[0]
    arch, lay = K.SERVE_FIXED[name][:2]
    model = build_model(smoke_variant(get_config(arch)), 1)
    params = {k: torch.from_numpy(v) for k, v in K.numpy_params(
        model, K.serve_weights_key(name)).items()}
    prefill_fn, decode_fn = build_serve_steps(model, MiCSTopology(), MiCSConfig(
        gather_dtype=torch.float32), K.SERVE_CACHE, device="cpu")
    prompts, tok = K.serve_inputs(name)
    logits, caches = prefill_fn(params, {"tokens": torch.from_numpy(prompts),
                                         "vision": torch.from_numpy(K.serve_vision(name))})
    _close(_assemble(got, f"{name}.prefill", _topo(lay)), logits.numpy(), LOGIT_RTOL[arch],
           "prefill against tp 1")
    tok, toks = torch.from_numpy(tok), []
    for i in range(K.SERVE_STEPS):
        logits, tok, caches = decode_fn(params, caches, tok, K.SERVE_T + i)
        toks.append(tok[:, 0].numpy())
    for r in range(K.WORLD):
        np.testing.assert_array_equal(got[f"{name}.tokens"][r], np.stack(toks, axis=1))


@pytest.mark.parametrize("layout", ["A", "B", "P2T2", "T4"])
def test_serving_shards_of_stored_int8_weights(layout):
    """A rank's stored int8 serving shard is ``quantize_state`` of its fp32
    shard (every flat length is a multiple of 128 p, so blocks never
    straddle ranks), at p > 1 and tp > 1, and its shards tile the pools."""
    topo = _topo(layout)
    cfg = smoke_variant(get_config("llama3.2-1b"))
    model, model_1 = build_model(cfg, topo.model_size), build_model(cfg, 1)
    full = tp_params_from_full(model, model_1, K.numpy_params(model_1, "int8_shards"))
    stored = quantize_state({k: torch.from_numpy(v) for k, v in full.items()})
    for r in range(K.WORLD):
        mine = shard_params(model, topo, r, stored, device="cpu")
        again = quantize_state(shard_params(model, topo, r, full, device="cpu"))
        for name in full:
            for part in ("q", "s"):
                assert torch.equal(mine[name][part], again[name][part]), (r, name, part)
    for name, pool in full.items():
        pieces = [shard_params(model, topo, r, {name: pool}, device="cpu")[name]
                  for r in topo.partition_groups()[0]]
        assert torch.equal(torch.cat(pieces, -1)[:, 0], torch.from_numpy(pool[:, 0]))


def test_resize_for_serve_world_is_the_keep_rule():
    """The serve loop's rebuild path: the reference's ``resolve_world``
    record (its keep rule, serve mode) plus ``world``, tp pinned, and
    ``serve_rerank``: the reference's re-rank of the serve policy on the
    new topology (``rerank_serve_world`` on the same profile): the same
    choice and residency, the numerics pinned to the config's (bf16 wire,
    the KV dtype and block).  The modeled decode time and throughput are
    within 1/16: the port's lookahead issues no wrap-around gather (16
    gathers of llama's 16 layers a step, the reference's 17), which is all
    of a decode step's modeled wire time at p > 1 on this profile."""
    from repro.configs import get_config as jax_get_config
    from repro.core.autotune import rerank_serve_world as jax_rerank
    from repro.core.autotune import resolve_world as jax_resolve_world
    from repro.core.mics import MiCSConfig as JaxMiCSConfig
    from repro.models.build import build_model as jax_build_model

    from repro_torch.core.linkmodel import EFA_400G

    for n, tp, p in ((4, 2, 2), (2, 2, 2), (3, 1, 4), (4, 1, 1), (2, 1, 2)):
        jmodel = jax_build_model(jax_get_config("llama3.2-1b"), tp=tp)
        model = build_model(get_config("llama3.2-1b"), tp=tp)
        mcfg = MiCSConfig(link_profile=EFA_400G, kv_block_size=16)
        topo, mcfg2, info = resize_for_serve_world(model, mcfg, n, tp=tp, partition_size=p,
                                                   available=4, seq=272)
        _, _, want = jax_resolve_world(jmodel, JaxMiCSConfig(), n_devices=n, tp=tp,
                                       partition_size=p, mode="serve")
        rerank = info.pop("serve_rerank")
        assert info == {**want, "world": n}
        assert (topo.world_size, topo.model_size, topo.partition_size) == (
            n, tp, want["partition_size"])
        _, plan = jax_rerank(jmodel, topo, JaxMiCSConfig(link_profile="efa-400g"), seq=272)
        c = plan.chosen
        assert rerank == {"gather": c.gather.topology, "wire": c.gather.wire_dtype,
                          "prefetch": c.gather.prefetch, "kv_dtype": "bf16",
                          "max_resident_requests": c.resident_requests,
                          "t_decode_s": pytest.approx(c.t_decode_s, rel=1 / 16),
                          "tokens_per_s": pytest.approx(c.tokens_per_s, rel=1 / 16)}
        assert (mcfg2.gather_dtype, mcfg2.kv_dtype, mcfg2.policy) == (
            torch.bfloat16, "bf16", "manual")
        assert mcfg2.prefetch == c.gather.prefetch


# ---------------------------------------------------------------------------
# the paged engine step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", K.SERVE_PAGED)
def test_paged_step_matches_jax_at_the_same_layout(runs, layout):
    got, want, _ = runs
    topo = _topo(layout)
    for i in range(1 + K.PAGED_STEPS):
        _close(_assemble(got, f"paged.{layout}.logits{i}", topo),
               want[f"paged.{layout}.logits{i}"], LOGIT_RTOL["llama3.2-1b"], f"step {i}")
        for r in range(K.WORLD):
            np.testing.assert_array_equal(got[f"paged.{layout}.tokens{i}"][r],
                                          want[f"paged.{layout}.tokens{i}"])
    assert got[f"paged.{layout}.garbage_zero"].all()


@pytest.mark.parametrize("layout", K.SERVE_PAGED)
def test_paged_equals_contiguous_bitwise_over_ranks(runs, layout):
    """Each data rank's pool, filled by ``pages_from_contiguous`` from its
    rows of the fixed-batch prefill, through the paged step against the
    contiguous step: tokens and logit rows bit for bit, greedy and sampled
    rows (top-k) side by side, on every rank."""
    assert runs[0][f"paged.{layout}.bitwise"].all()


# ---------------------------------------------------------------------------
# the vocab-parallel sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", K.SAMPLER_LAYOUTS)
def test_sampler_over_ranks_is_the_tp1_sampler(runs, layout):
    got, want, _ = runs
    logits = torch.from_numpy(K.sampler_logits())
    greedy = K.SAMPLER_TEMPS == 0
    for k in K.SAMPLER_TOP_K:
        ref = lm.sample_tokens(logits, Ctx(), K.VR, seed=torch.from_numpy(K.SAMPLER_SEEDS),
                               pos=torch.from_numpy(K.SAMPLER_POS),
                               temperature=torch.from_numpy(K.SAMPLER_TEMPS), top_k=k).numpy()
        for r in range(K.WORLD):
            np.testing.assert_array_equal(got[f"sampler.{layout}.{k}"][r], ref, f"top_k {k}")
            np.testing.assert_array_equal(got[f"sampler.{layout}.{k}"][r][greedy],
                                          want[f"sampler.{layout}"][r][greedy])


# ---------------------------------------------------------------------------
# the resilient loop's world changes
# ---------------------------------------------------------------------------

def _report(got: dict, run: str, r: int) -> dict:
    return json.loads(str(got[f"chaos.{run}.json"][r]))


# run -> its world changes: (kind, world, partition size)
CHAOS_LEDGERS = {
    "free2": [],
    "preempt": [("preempt", 2, 1)],
    "grow": [("grow", 4, 1)],
    "straggler": [("straggler_evict", 2, 1)],
    "crash": [("crash", 4, None)],
}


@pytest.mark.parametrize("run", list(CHAOS_LEDGERS))
def test_world_changes_are_bitwise_the_fault_free_run(runs, run):
    """Every rank's report of the run: each request completed, bitwise the
    fault-free 4-rank run's completions (greedy and sampled), the ledger
    accounted, the world changes as planned (the keep rule: p 1 on 2
    ranks, and after the grow, 2 replicas of p 1), every in-flight request
    replayed, the parked ranks back or released at the end."""
    got = runs[0]
    base = _report(got, "free4", 0)
    assert base["ledger"]["accounted"] and base["ledger"]["completed"] == len(K.CHAOS_ARRIVALS)
    for r in range(K.WORLD):
        rep = _report(got, run, r)
        assert rep["completions"] == base["completions"], r
        assert rep["ledger"]["accounted"] and rep["ledger"]["completed"] == len(K.CHAOS_ARRIVALS)
        changes = [(e["kind"], e["world"], e.get("partition_size"))
                   for e in rep["world_changes"]]
        assert changes == CHAOS_LEDGERS[run], r
        assert all(e["replayed"] > 0 and e["at_tick"] == 3 for e in rep["world_changes"])
        assert rep["ledger"]["replays"] == sum(e["replayed"] for e in rep["world_changes"])
        assert rep["world"] == (K.CHAOS_RUNS[run][0] if not changes else changes[-1][1])
        assert rep["parked_at_end"] == (r >= rep["world"])


def test_fault_free_run_matches_the_reference_loop(runs):
    """The fault-free 4-rank run against the reference's loop at the same
    layout on the same weights: the greedy requests' completions and the
    lifecycle ledger (its ticks, replays and percentiles) equal; the
    sampled ones differ (threefry noise, and the reference's union of
    per-shard top-k at tp > 1)."""
    got, want, _ = runs
    ref = json.loads(str(want["chaos.free4.json"]))
    for r in range(K.WORLD):
        rep = _report(got, "free4", r)
        greedy = {rid: c for rid, c in rep["completions"].items() if int(rid) % 2 == 0}
        assert greedy == {rid: c for rid, c in ref["completions"].items() if int(rid) % 2 == 0}
        assert rep["ledger"] == ref["ledger"] and rep["ticks"] == ref["ticks"]


def test_launcher_serves_over_two_ranks_with_world_changes(runs):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve
    --continuous --fault-plan preempt@4x1,grow@8x1``: rank 0 alone prints;
    every request served, the ledger accounted, the world changes 2 -> 1
    -> 2."""
    code, out, err = runs[2]
    assert code == 0, err[-3000:]
    assert out.count("served 6/6 requests") == 1, out
    assert "on a 2-device world" in out and '"accounted": true' in out
    text = out[out.index("crashes and world changes:") + len("crashes and world changes:"):]
    ledger = json.loads(text[:text.index("\n]") + 2])
    assert [(e["kind"], e["at_tick"], e["world"]) for e in ledger] == [
        ("preempt", 4, 1), ("grow", 8, 2)]
