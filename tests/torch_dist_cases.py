"""The cases of the port's 4-rank tests and their inputs, shared by the port
harness (``torch_dist_harness.py``), the JAX oracle (``jax_dist_oracle.py``)
and the tests that compare them (``test_torch_collectives.py``,
``test_torch_dist_train.py``).  numpy only: every input is made here from a
seed with ``default_rng``, so both sides see the same values.

A rank's place is C order over ``(pod, repl, shard, dp2, model)``, which is
also the device order of the JAX package's ``make_host_mesh``: rank r is
device r, and a ``[WORLD, ...]`` array holds rank r's value at row r.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent

WORLD = 4

# name -> ((pod, repl, shard, dp2), partition axes, replication axes)
LAYOUTS = {
    "A": ((1, 1, 4, 1), ("shard",), ("pod", "repl", "dp2")),   # p 4, one replica
    "B": ((1, 2, 2, 1), ("shard",), ("pod", "repl", "dp2")),   # p 2 x 2 replicas
    "Z3": ((2, 1, 2, 1), ("pod", "shard"), ()),                 # ZeRO-3 over pod x shard
}

# gathers: name -> (layout, topology, inner, local shape, gather axis)
GATHERS = {
    "flat@A": ("A", "flat", None, (24,), 0),
    "inner_first@A": ("A", "inner_first", 2, (24,), 0),
    "outer_first@A": ("A", "outer_first", 2, (24,), 0),
    "outer_first@A_axis1": ("A", "outer_first", 2, (3, 8), 1),
    "inner_first@B": ("B", "inner_first", None, (24,), 0),
    "inner_first@Z3": ("Z3", "inner_first", None, (24,), 0),
    "outer_first@Z3": ("Z3", "outer_first", None, (24,), 0),
}

# reduce-scatters (hop 1): name -> (layout, topology, inner, dtype); each
# rank's full cotangent is [RS_LEN]
RS_LEN = 96
REDUCE_SCATTERS = {f"{topo}@{lay}:{dt}": (lay, topo, inner, dt)
                   for lay, topo, inner in (("A", "flat", None), ("A", "inner_first", 2),
                                            ("A", "outer_first", 2), ("B", "inner_first", None),
                                            ("Z3", "inner_first", None),
                                            ("Z3", "outer_first", None))
                   for dt in ("fp32", "bf16")}

# hop 2 and the Fig-14 ablation (fp32): name -> (kind, layout)
SYNCS = {"hop2@B": ("hop2", "B"), "alternative_sync@A": ("alternative_sync", "A"),
         "alternative_sync@B": ("alternative_sync", "B")}


def gather_input(name: str) -> np.ndarray:
    """``[WORLD, *local shape]`` fp32: rank r's shard at row r (the same for
    every gather of one layout and shape)."""
    layout, _, _, shape, _ = GATHERS[name]
    rng = np.random.default_rng(_seed(f"{layout}{shape}"))
    return rng.standard_normal((WORLD, *shape)).astype(np.float32)


def full_input(name: str, n: int = RS_LEN) -> np.ndarray:
    """``[WORLD, n]`` fp32: rank r's full-length gradient at row r."""
    rng = np.random.default_rng(_seed(name))
    return rng.standard_normal((WORLD, n)).astype(np.float32)


def _seed(name: str) -> int:
    """A seed from the case name that does not depend on ``PYTHONHASHSEED``."""
    return int.from_bytes(name.encode(), "little") % 2**32


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

MICRO, GLOBAL_B, SEQ, STEPS = 2, 4, 32, 2
VOCAB = 256                     # the smoke configs' vocabulary
OPT = dict(warmup_steps=0, total_steps=10, lr_max=1e-3)

# name -> (layout, gather_order, hierarchy_inner, wire); the JAX step and the
# port's run the same
TRAINS = {f"{lay}:{wire}": (lay, order, inner, wire)
          for lay, order, inner in (("A", "outer_first", 2), ("B", "inner_first", None),
                                    ("Z3", "inner_first", None))
          for wire in ("fp32", "bf16")}


def train_batches() -> list[dict[str, np.ndarray]]:
    """The global batches ``[MICRO, GLOBAL_B, SEQ]`` of each step; data rank
    d takes row d of each micro-batch (the reference's batch spec).  Each
    row masks out the same number of tokens (at random places): the loss is
    the mean over data ranks of each rank's masked mean, as the reference's
    ``pmean``, which is the global batch's masked mean only when every rank
    keeps as many tokens."""
    rng = np.random.default_rng(7)
    shape = (MICRO, GLOBAL_B, SEQ)
    out = []
    for _ in range(STEPS):
        mask = np.ones(shape, np.float32)
        drop = np.argsort(rng.uniform(size=shape), axis=-1)[..., :SEQ // 8]
        np.put_along_axis(mask, drop, 0.0, axis=-1)
        out.append({"tokens": rng.integers(0, VOCAB, shape).astype(np.int32),
                    "targets": rng.integers(0, VOCAB, shape).astype(np.int32), "mask": mask})
    return out


def data_slice(batch: dict, data_rank: int, dp: int) -> dict:
    per = GLOBAL_B // dp
    return {k: v[:, data_rank * per:(data_rank + 1) * per] for k, v in batch.items()}


def start(script: str, *args: str) -> subprocess.Popen:
    """Start ``tests/<script> args`` on the CPU (``PYTHONPATH`` src and tests)."""
    env = dict(os.environ, PYTHONPATH=f"{TESTS.parent / 'src'}:{TESTS}", JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(TESTS / script), *args], cwd=TESTS.parent,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float) -> None:
    """Wait for ``proc``; raise with its error output if it failed or hung."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{proc.args} did not finish in {timeout} s:\n{err[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args} exited {proc.returncode}:\n{err[-4000:]}")


def load_ranks(path_fmt: str) -> dict[str, np.ndarray]:
    """Every rank's npz (``path_fmt`` with ``{r}``) as ``{key: [WORLD, ...]}``."""
    ranks = [np.load(path_fmt.format(r=r)) for r in range(WORLD)]
    return {k: np.stack([z[k] for z in ranks]) for k in ranks[0].files}
