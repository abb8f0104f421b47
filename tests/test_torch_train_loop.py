"""The port's training loop on the CPU: a run resumed from its step-2
checkpoint is bitwise the uninterrupted run, the checkpointer finds only
complete checkpoints, and the launcher trains the smoke model from the
command line, with the one-card training knobs too."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.mics import MiCSConfig, init_state  # noqa: E402
from repro_torch.core.topology import MiCSTopology  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, SyntheticLM  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.train_loop import LoopConfig, train  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _setup():
    cfg = smoke_variant(get_config("llama3.2-1b"))
    model = build_model(cfg, tp=1)
    dc = DataConfig(vocab=cfg.vocab, seq=32, global_batch=4, micro_steps=2)
    oc = OptConfig(lr_max=1e-3, total_steps=4, warmup_steps=1)
    return model, dc, oc, MiCSConfig(micro_steps=2)


def _run(model, dc, oc, mcfg, ckdir, total):
    lc = LoopConfig(total_steps=total, checkpoint_every=2, checkpoint_dir=str(ckdir),
                    log_every=0)
    return train(model, MiCSTopology(), mcfg, oc, dc, lc, device="cpu")


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    model, dc, oc, mcfg = _setup()
    whole = _run(model, dc, oc, mcfg, tmp_path / "whole", 4)
    first = _run(model, dc, oc, mcfg, tmp_path / "cut", 2)
    rest = _run(model, dc, oc, mcfg, tmp_path / "cut", 4)   # resumes from step 2
    assert len(whole.losses) == 4 and len(first.losses) == 2 and len(rest.losses) == 2
    # every save is timed: at steps 2 and 4 and once at the end
    assert len(whole.save_times) == 3 and all(t > 0 for t in whole.save_times)
    assert first.losses + rest.losses == whole.losses
    assert first.grad_norms + rest.grad_norms == whole.grad_norms
    a, meta_a = Checkpointer(tmp_path / "whole").restore(model, device="cpu")
    b, meta_b = Checkpointer(tmp_path / "cut").restore(model, device="cpu")
    assert meta_a["step"] == meta_b["step"] == 4 and a["step"] == b["step"] == 4
    assert meta_a["data_cursor"] == meta_b["data_cursor"] == 4
    for part in ("params", "m", "v"):
        for name in a[part]:
            assert torch.equal(a[part][name], b[part][name]), (part, name)


def test_checkpointer_skips_incomplete_and_checks_topology(tmp_path):
    """Only complete checkpoints count, and a restore onto another topology
    reshards (replica 0's chunks)."""
    model, *_ = _setup()
    state = init_state(model, 0, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(state, 1, topo=MiCSTopology(), data_cursor=1)
    state["step"] = 3
    path = ck.save(state, 3, topo=MiCSTopology(), data_cursor=3)
    (tmp_path / "step_00000005.tmp").mkdir()            # a writer that died
    (tmp_path / "step_old").mkdir()                     # a stray name
    assert ck.latest_step() == 3
    (path / "params.layers.npy").write_bytes(b"\x93NUMPY")  # truncated tensor
    assert ck.latest_step() == 1
    restored, meta = ck.restore(model, device="cpu")
    assert meta["step"] == 1 and restored["step"] == 0
    assert torch.equal(restored["params"]["head"], state["params"]["head"])
    # a restore onto another topology reshards: rank 0 of 2 replicas holds
    # the whole rows (p 1), replica 0's
    again, meta2 = ck.restore(model, topo=MiCSTopology(repl=2), device="cpu")
    assert meta2["topology"]["repl"] == 1 and again["step"] == 0
    for part in ("params", "m", "v"):
        for name, t in restored[part].items():
            assert torch.equal(again[part][name], t), (part, name)
    with pytest.raises(FileNotFoundError):
        ck.restore(model, 3, device="cpu")


def test_prefetch_loader_yields_the_stream_in_order():
    cfg = DataConfig(vocab=64, seq=8, global_batch=4, micro_steps=2)
    src = SyntheticLM(cfg)
    loader = PrefetchLoader(src, start_step=5)
    try:
        for want, (step, batch) in zip((5, 6, 7), loader):
            assert step == want
            ref = src.global_step_batch(want)
            assert all(np.array_equal(batch[k], ref[k]) for k in ref)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_launcher_trains_the_smoke_model(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
         "--device", "cpu", "--steps", "3", "--checkpoint-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("final loss ") and "over 3 steps on cpu" in last, out.stdout
    assert np.isfinite(float(last.split()[2]))
    assert Checkpointer(tmp_path / "ck").latest_step() == 3


def test_launcher_refuses_unported_flags(tmp_path):
    """``--policy auto`` and ``--hbm-budget-gb`` run: the ranked table, the
    modeled hop-2 on the profile and the memory plan print, the step runs on
    the chosen config (the remat carry at p 1 under a budget); a budget
    below every candidate raises ``MemoryBudgetError`` before any step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
            "--smoke", "--device", "cpu", "--steps", "1", "--policy", "auto",
            "--link-profile", "efa-100g"]
    out = subprocess.run([*base, "--hbm-budget-gb", "1", "--checkpoint-dir",
                          str(tmp_path / "ck")],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "autotune[efa-100g] mode=train hbm_budget=1GiB" in out.stdout
    assert "on efa-100g" in out.stdout and "memplan: " in out.stdout
    assert "prefetch carry remat" in out.stdout
    assert out.stdout.strip().splitlines()[-1].startswith("final loss ")
    out = subprocess.run([*base, "--hbm-budget-gb", "1e-4", "--checkpoint-dir",
                          str(tmp_path / "ck2")],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "MemoryBudgetError" in out.stderr
    assert not (tmp_path / "ck2").exists()


# The host carry offloads the stored carry, so it cannot run beside remat:
# the four knobs run in two launches.
KNOB_FLAGS = {
    "remat": (["--prefetch-carry", "remat", "--offload-opt", "--clip-mode", "approx"],
              "knobs: prefetch carry remat; AdamW moments in host memory; clip approx"),
    "carry_host": (["--carry-offload", "host", "--offload-opt", "--clip-mode", "approx"],
                   "knobs: prefetch carry stored in host memory; AdamW moments in host "
                   "memory; clip approx"),
}


@pytest.mark.parametrize("carry", list(KNOB_FLAGS))
def test_launcher_trains_with_the_knobs(tmp_path, carry):
    """The one-card knobs from the command line: 2 steps of the smoke model
    with a carry knob, the moments in host memory and the approximate clip;
    the launcher's line names them."""
    flags, line = KNOB_FLAGS[carry]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
         "--device", "cpu", "--steps", "2", "--checkpoint-dir", str(tmp_path / "ck"), *flags],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert line in lines and "clip=approx" in lines[0], out.stdout
    assert lines[-1].startswith("final loss ") and "over 2 steps on cpu" in lines[-1]
    assert np.isfinite(float(lines[-1].split()[2]))
    assert Checkpointer(tmp_path / "ck").latest_step() == 2


WIRE_FLAGS = {
    "int8": (["--quant-gather", "--hop1-wire-dtype", "int8", "--compress-hop2", "int8",
              "--grad-rounding", "nearest"],
             "wires: gather int8, hop 1 int8, hop 2 int8, int8 rounding nearest"),
    "bf16": (["--hop1-wire-dtype", "bf16", "--compress-hop2", "bf16"],
             "wires: gather bf16, hop 1 bf16, hop 2 bf16, int8 rounding stochastic"),
}


@pytest.mark.parametrize("wire", list(WIRE_FLAGS))
def test_launcher_trains_with_the_wires(tmp_path, wire):
    """The int8 and bf16 wires from the command line (at p = 1: the int8
    gather is the cast to bf16, the bf16 hop 2 rounds the gradient): 2
    steps of the smoke model; the launcher's line names the wires."""
    flags, line = WIRE_FLAGS[wire]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke",
         "--device", "cpu", "--steps", "2", "--checkpoint-dir", str(tmp_path / "ck"), *flags],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert line in lines, out.stdout
    assert lines[-1].startswith("final loss ") and np.isfinite(float(lines[-1].split()[2]))
