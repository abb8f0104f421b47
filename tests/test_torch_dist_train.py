"""The port's MiCS training step across 4 gloo ranks on the CPU: smoke
llama3.2-1b at layout A (p 4, ``outer_first``, inner 2), layout B (p 2 x 2
replicas) and ZeRO-3 (``pod x shard``), fp32 and bf16 gather, against the
JAX package's ``build_train_step`` on 4 virtual devices at the same layout
and against the port at p = 1 on the same global batch, both within
``test_torch_train.TOL``; the Fig-14 ``allreduce_slice`` step against the
2-hop one; bitwise at p > 1: serial == prefetch, serial == bucketed
boundary, a repeated step; the train loop resumed from its
checkpoint at layout B; a griffin step at layout A against p = 1; the
launcher under ``torchrun``.  ``gpu`` tests run the ranks' collectives on
CUDA tensors over gloo on one card."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
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
    (pod, repl, shard, dp2), part, rep = K.LAYOUTS[layout]
    return MiCSTopology(pod=pod, repl=repl, shard=shard, dp2=dp2, partition_axes=part,
                        replication_axes=rep)


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
    keys = [k[len(a) + 1:] for k in got if k.startswith(a + ".")]
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


def test_griffin_step_at_layout_A_matches_p1(runs):
    got, _, p1, _ = runs
    assert all(np.array_equal(got["griffin"][r], got["griffin"][0]) for r in range(K.WORLD))
    _check_metrics(got["griffin"][0], p1["griffin"], TOL["bf16"])


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
