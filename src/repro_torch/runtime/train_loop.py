"""The training loop (the port of the non-elastic half of
``repro/runtime/train_loop.py``).

:func:`train` resumes from the newest complete checkpoint (state and data
cursor; the synthetic stream is seekable, so no sample is replayed or
skipped) or starts from ``init_state(seed)``, runs the step function to
``total_steps``, times each step on the host clock around work that ends
in a device synchronise, flags stragglers against an EWMA of the step
time, saves every ``checkpoint_every`` steps and once at the end.

Over several ranks (``groups``, a ``launch.mesh.MiCSGroups``) each rank
holds its shards of the state (its model coordinate's at tp > 1), takes
its slice of each step's global batch
(``SyntheticLM.host_step_batch(cursor, data_rank, dp)``, so the global
batch does not depend on the topology; the ranks of one data rank's model
group take the same slice) and writes its own shards; only rank 0 logs.

Rollback-and-retry on faults, ``ElasticConfig`` world changes and
straggler eviction come with the elastic slice (ROADMAP Queue 1 item 5, the
elastic and fault-tolerant loop): until then a failing step raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
from repro_torch.core.topology import MiCSTopology
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef
from repro_torch.optim.adamw import OptConfig

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


@dataclasses.dataclass
class LoopStats:
    losses: list
    step_times: list
    straggler_steps: list
    grad_norms: list = dataclasses.field(default_factory=list)
    save_times: list = dataclasses.field(default_factory=list)   # seconds of each save
    comm: dict = dataclasses.field(default_factory=dict)  # the CommEngine's counter


def train(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig, oc: OptConfig,
          dc: DataConfig, lc: LoopConfig, *, device: str | torch.device = "cuda",
          groups=None) -> LoopStats:
    dev = resolve_device(device)
    rank = 0 if groups is None else groups.rank
    ckpt = Checkpointer(lc.checkpoint_dir)
    source = SyntheticLM(dc)
    stats = LoopStats([], [], [])
    step_fn = build_train_step(model, topo, mcfg, oc, device=dev, groups=groups)
    data_rank, dp = topo.data_rank(rank), topo.data_parallel_size
    info = log.info if rank == 0 else (lambda *a: None)

    start = ckpt.latest_step()
    if start is not None:
        state, meta = ckpt.restore(model, topo=topo, rank=rank, device=dev,
                                   offload_opt=mcfg.offload_opt)
        cursor = meta["data_cursor"]
        info("resumed from step %d", start)
    else:
        state = init_state(model, lc.seed, device=dev, topo=topo, rank=rank,
                           offload_opt=mcfg.offload_opt)
        cursor = 0

    ewma = None
    step = state["step"]
    while step < lc.total_steps:
        batch = source.host_step_batch(cursor, data_rank, dp)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if len(stats.step_times) >= 1:
            # the first step pays for building and loading the kernels and
            # the allocator's growth; the detector warms up from the second
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if ewma is not None and dt > lc.straggler_factor * ewma and len(stats.step_times) > 3:
            stats.straggler_steps.append(step)
            if rank == 0:
                log.warning("straggler: step %d took %.2fs (ewma %.2fs)", step, dt, ewma)
        stats.losses.append(loss)
        stats.grad_norms.append(float(metrics["grad_norm"]))
        stats.step_times.append(dt)
        cursor += 1
        step += 1
        if lc.log_every and step % lc.log_every == 0:
            info("step %d loss %.4f (%.3fs)", step, loss, dt)
        if lc.checkpoint_every and step % lc.checkpoint_every == 0:
            _save(ckpt, stats, state, step, topo, cursor, groups)
    _save(ckpt, stats, state, step, topo, cursor, groups)
    stats.comm = step_fn.comm.counter.snapshot()
    return stats


def _save(ckpt: Checkpointer, stats: LoopStats, state, step: int, topo, cursor: int,
          groups) -> None:
    t0 = time.perf_counter()
    ckpt.save(state, step, topo=topo, data_cursor=cursor, groups=groups)
    stats.save_times.append(time.perf_counter() - t0)
