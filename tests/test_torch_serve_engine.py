"""The port's resilient continuous-batching serve loop
(``repro_torch/runtime/resilient.py``) and ``launch/serve.py --continuous``
on the CPU.

* ``ResilientServeLoop`` at temperature 0 against the JAX package's on the
  same weights (``convert.params_from_jax``) and requests, smoke
  llama3.2-1b on one CPU device, fp32 gather: the same completions and the
  same lifecycle ledger, with fp32 and bf16 pools, a bounded queue and an
  engine crash;
* within the port: ``crash@k`` replays bitwise the fault-free run (sampled
  rows included); a degradation-ladder downshift to int8 pools rebuilds
  and replays; a world change on one process, with no rank to lose or win,
  raises;
* the launcher's ``--continuous`` run.
"""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_variant as jax_smoke  # noqa: E402
from repro.core.mics import MiCSConfig as JaxMiCSConfig  # noqa: E402
from repro.core.mics import init_state  # noqa: E402
from repro.models.build import build_model as jax_build_model  # noqa: E402
from repro.runtime import batching as JB  # noqa: E402
from repro.runtime import resilient as JR  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.faults import FaultPlan, WorldChangeError  # noqa: E402
from repro_torch.core.mics import MiCSConfig  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.runtime import batching as TB  # noqa: E402
from repro_torch.runtime import resilient as TR  # noqa: E402

SEED = 7
TOPO = MiCSTopology()
# slots, blocks, block size, table width, chunk: 9 + 6 positions at most
GEOMETRY = dict(slots_local=2, nb_local=10, block_size=4, max_blocks=4, chunk=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(topo1):
    model_j = jax_build_model(jax_smoke(jax_get_config("llama3.2-1b")), tp=1)
    params_np = {k: np.asarray(v)
                 for k, v in init_state(model_j, topo1, seed=SEED)["params"].items()}
    model_t = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    params_t = params_from_jax(model_t, params_np, device="cpu")
    return dict(model_j=model_j, model_t=model_t, params_t=params_t)


def _requests(B, n=6, temps=(0.0,)):
    rng = np.random.default_rng(3)
    return [B.Request(rid=i, prompt=rng.integers(1, 256, int(rng.integers(3, 10))).tolist(),
                      max_new_tokens=int(rng.integers(3, 7)), temperature=temps[i % len(temps)],
                      seed=1000 + i) for i in range(n)]


def _port_loop(s, kv="fp32", fault=None, ladder=None, **sc):
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype=kv, kv_block_size=4)
    return TR.ResilientServeLoop(
        s["model_t"], TOPO, mcfg, TR.ServeLoopConfig(**{**GEOMETRY, **sc}, seed=SEED),
        params_for=lambda model, topo: s["params_t"], fault_injector=fault, ladder=ladder,
        device="cpu")


def _jax_loop(s, topo1, kv="fp32", fault=None, ladder=None, **sc):
    mcfg = JaxMiCSConfig(gather_dtype=jnp.float32, kv_dtype=kv, kv_block_size=4)
    return JR.ResilientServeLoop(s["model_j"], topo1, mcfg,
                                 JR.ServeLoopConfig(**{**GEOMETRY, **sc}, seed=SEED),
                                 fault_injector=fault, ladder=ladder)


ARRIVALS = [0, 0, 1, 2, 2, 5]
LOOP_CASES = {
    "fp32": dict(kv="fp32"),
    "bf16 queue 3 crash@4": dict(kv="bf16", max_queue=3, plan="crash@4"),
}


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_loop_matches_reference(setup, topo1, case):
    """Temperature 0: the port's completions and lifecycle ledger equal the
    reference loop's (its ticks, sheds, replays and percentiles included)."""
    kw = dict(LOOP_CASES[case])
    plan = kw.pop("plan", None)
    from repro.core.faults import FaultPlan as JaxFaultPlan

    want = _jax_loop(setup, topo1, fault=plan and JaxFaultPlan.parse(plan), **kw).run(
        _requests(JB), ARRIVALS)
    got = _port_loop(setup, fault=plan and FaultPlan.parse(plan), **kw).run(
        _requests(TB), ARRIVALS)
    assert got["completions"] == want["completions"]
    assert got["ledger"] == want["ledger"]
    assert got["shed"] == want["shed"]
    assert got["world_changes"] == want["world_changes"]
    assert got["ledger"]["accounted"] and got["ticks"] == want["ticks"]


@pytest.mark.parametrize("at", [2, 5])
def test_crash_replays_bitwise(setup, at):
    """An engine crash at tick ``at`` replays every in-flight request from
    its prompt on fresh pools: the completions, greedy and sampled rows
    alike, are bitwise the fault-free run's."""
    temps = (0.0, 0.7, 1.1)
    base = _port_loop(setup, kv="bf16").run(_requests(TB, temps=temps), ARRIVALS)
    loop = _port_loop(setup, kv="bf16", fault=FaultPlan.parse(f"crash@{at}"))
    rep = loop.run(_requests(TB, temps=temps), ARRIVALS)
    assert rep["completions"] == base["completions"]
    assert rep["crash_retries"] == 1 and rep["world_changes"][0]["kind"] == "crash"
    assert rep["world_changes"][0]["replayed"] > 0
    assert rep["ledger"]["accounted"] and rep["ledger"]["replays"] > 0
    assert rep["ticks"] > base["ticks"]
    # block 0 stayed the zeros nothing reads
    assert not loop.caches["layers"]["k"][:, 0].any()
    with pytest.raises(TR.EngineCrashError):
        _port_loop(setup, fault=FaultPlan.parse("crash@1,crash@2,crash@3")).run(
            _requests(TB), ARRIVALS)


def _ladder(B):
    return B.DegradationLadder(
        [{"kv_dtype": "bf16", "resident_cap": 0, "label": "configured"},
         {"kv_dtype": "int8", "resident_cap": 1, "label": "kv_int8"}],
        high_water=0.75, low_water=0.25, dwell=1)


def test_ladder_downshift_rebuilds_and_replays(setup):
    """Queue pressure walks the ladder to int8 pools (residency cap 1) and
    back: each dtype change rebuilds the engine and replays the residents
    from their prompts.  The transitions and the ledger do not depend on
    the tokens; the values below are the reference loop's on the same
    requests (its two extra engine compiles are left out of the suite's
    time; ``tests/test_torch_batching.py`` holds the ladder and the replays
    to the reference's)."""
    loop = _port_loop(setup, kv="bf16", ladder=_ladder(TB))
    kinds = []
    build = loop._build_engine

    def counted_build():
        kinds.append(loop.kv_dtype)
        build()

    loop._build_engine = counted_build
    got = loop.run(_requests(TB, n=8))
    assert [(t["tick"], t["label"]) for t in got["ladder_transitions"]] == [
        (0, "kv_int8"), (39, "configured")]
    assert kinds == ["int8", "bf16"] and got["kv_dtype"] == "bf16"
    assert got["ladder_max_level"] == 1 and got["ledger"]["replays"] == 3
    assert got["ledger"]["accounted"] and got["ledger"]["completed"] == 8


def test_world_change_past_one_rank_raises(setup):
    """On one process a world change has no rank to lose or to win: a loss
    raises the reference's ``WorldChangeError``, a grow past the launch
    world ``elastic_host_topology``'s ``ValueError``; a topology of more
    than one rank needs its process groups.  World changes over ranks run
    in ``tests/test_torch_dist_serve.py``."""
    with pytest.raises(ValueError, match="exceeds the 1 available"):
        _port_loop(setup, fault=FaultPlan.parse("grow@1x1")).run(_requests(TB), ARRIVALS)
    for spec in ("preempt@1", "notice@2", "evict@1"):
        with pytest.raises(WorldChangeError, match="world of 0 devices"):
            _port_loop(setup, fault=FaultPlan.parse(spec)).run(_requests(TB), ARRIVALS)
    mcfg = MiCSConfig(gather_dtype=torch.float32)
    with pytest.raises(ValueError, match="MiCSGroups"):
        TR.ResilientServeLoop(setup["model_t"], MiCSTopology(repl=2), mcfg,
                              TR.ServeLoopConfig(**GEOMETRY), device="cpu")
    # griffin's windowed and recurrent caches are not paged (as the reference)
    griffin = build_model(smoke_variant(get_config("recurrentgemma-2b")), tp=1)
    with pytest.raises(NotImplementedError, match="window"):
        TR.ResilientServeLoop(griffin, TOPO, mcfg, TR.ServeLoopConfig(**GEOMETRY),
                              device="cpu")


def test_serve_cli_continuous(capsys):
    """``python -m repro_torch.launch.serve --arch llama3.2-1b --smoke
    --device cpu --continuous`` serves every request with its ledger
    accounted; a plan whose world leaves the launch world (one process: a
    grow) is refused; without a card the default device raises."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b",
            "--smoke", "--continuous"]
    proc = subprocess.run([*argv, "--device", "cpu"], cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "served 8/8 requests" in proc.stdout and '"accounted": true' in proc.stdout
    assert "warm engine step" in proc.stdout
    from repro_torch.launch.serve import main

    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--continuous"]
    main([*base, "--requests", "3", "--decode-tokens", "2", "--fault-plan", "crash@2",
          "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "served 3/3 requests" in out and "int8 KV" in out and '"kind": "crash"' in out
    with pytest.raises(SystemExit) as ei:
        main([*base, "--fault-plan", "grow@3x2"])
    assert ei.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            main(base[:2] + ["--continuous"])
