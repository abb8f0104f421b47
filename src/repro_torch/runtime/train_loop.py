"""Fault-tolerant, elastic training loop (the port of
``repro/runtime/train_loop.py``).

* **Checkpoint/restart** — :func:`train` resumes from the newest complete
  checkpoint (state and data cursor; the synthetic stream is seekable, so
  no sample is replayed or skipped) or starts from ``init_state(seed)``,
  runs the step function to ``total_steps``, saves every
  ``checkpoint_every`` steps (asynchronously: the writer thread overlaps
  the next steps) and once at the end (blocking).
* **Failure handling** — a step that raises is rolled back to the newest
  complete checkpoint (after the in-flight save has landed) and retried;
  a step that fails more than ``max_step_retries`` times in a row
  re-raises (the poison-step guard).  A periodic save that fails is
  retried once (``_try_save``) and counted in ``save_failures``.
* **Elastic world changes** — with an :class:`ElasticConfig`, a
  :class:`repro_torch.core.faults.WorldChangeError` (preemption or
  grow-back) is survived in the loop: with notice an emergency checkpoint
  of the still-intact state is taken (zero steps lost), without notice the
  in-flight save is awaited and the run rolls back; the new world is
  re-laid out (:func:`resize_for_world`: ``core/autotune.resolve_world``'s
  keep rule, or under ``hbm_budget_gb`` the paper's §3.1 re-pick of the
  partition size and the carry, then ``core/topology.elastic_host_topology``
  over the first n ranks), the groups and the step function are rebuilt
  with the re-picked config and the agreed
  checkpoint is restored onto the new topology.  Every change lands in
  ``LoopStats.world_changes``; the budget and backoff are
  ``ElasticConfig.max_world_changes`` / ``backoff_s``.  Without an
  ``ElasticConfig`` a world change re-raises.  The resumed trajectory is
  bitwise a cold :func:`elastic_restart` of the same checkpoint on the
  same topology.
* **Straggler detection** — a step-time EWMA flags steps slower than
  ``straggler_factor`` times it; an injected
  :class:`repro_torch.core.faults.StragglerError` (evict) rides rollback
  and retry.

Over several ranks (``groups``, a ``launch.mesh.MiCSGroups``) each rank of
the world holds its shards of the state (its model coordinate's at tp >
1), takes its slice of each step's global batch
(``SyntheticLM.host_step_batch(cursor, data_rank, dp)``, so the global
batch does not depend on the topology) and writes its own shards; only
rank 0 logs.  The world is the first n ranks of the launch world; a rank
outside it is parked: it runs no step and waits in the next meeting.  At
each world change every live process of the launch world meets in one
call on the default group (``launch/mesh.meet``), where rank 0 sends the new
world, the step to restore (its newest complete checkpoint after every
rank's save has landed) and the plan's fired events; every process then
rebuilds the groups, and the ranks of the new world restore.  At the end
rank 0 releases the parked processes in the same way.  Every
``FaultPlan`` event fires on every rank of the world at the same step, so
all ranks take the same path.  A failure that only some ranks see is
outside this design: the groups' timeout turns it into an error on the
others.  Each rank's :class:`LoopStats` counts what that rank did (a
parked rank runs no step and takes no save); the ledger of world changes
is every live process's, each entry with the counter snapshot of the
world that ended (``comm``: empty on a process parked in it) and the
rebuild's seconds (``rebuild_s``: groups, step function, restore).
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from typing import Callable

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core.autotune import resolve_world
from repro_torch.core.faults import FaultError, WorldChangeError
from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
from repro_torch.core.topology import MiCSTopology, elastic_host_topology
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MiCSGroups, launch_world, meet
from repro_torch.models.build import build_model
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
    max_step_retries: int = 2
    seed: int = 0


@dataclasses.dataclass
class ElasticConfig:
    """How the loop survives world changes (preemptible/spot capacity).

    ``max_world_changes`` bounds the rebuild budget — a flapping cluster
    re-raises rather than thrashing forever.  ``backoff_s`` sleeps
    ``backoff_s * attempt`` before each rebuild (keep 0 in tests; on a real
    cluster this is where the coordinator's membership settles)."""

    max_world_changes: int = 8
    backoff_s: float = 0.0


@dataclasses.dataclass
class LoopStats:
    losses: list
    step_times: list
    straggler_steps: list
    grad_norms: list = dataclasses.field(default_factory=list)
    save_times: list = dataclasses.field(default_factory=list)   # seconds each save blocked
    comm: dict = dataclasses.field(default_factory=dict)  # the last world's CommEngine counter
    restarts: int = 0
    world_changes: list = dataclasses.field(default_factory=list)
    emergency_saves: int = 0
    save_failures: int = 0
    saves: list = dataclasses.field(default_factory=list)  # Checkpointer.save_log


@dataclasses.dataclass
class _World:
    """The current world as one process sees it: the topology, its groups
    (None in a one-process run) and, unless this process is parked, the
    step function."""

    topo: MiCSTopology
    groups: object
    step_fn: Callable | None = None

    @property
    def parked(self) -> bool:
        return self.groups is not None and self.groups.parked


def train(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig, oc: OptConfig,
          dc: DataConfig, lc: LoopConfig, *, device: str | torch.device = "cuda",
          groups=None, fault_injector: Callable[[int], None] | None = None,
          elastic: ElasticConfig | None = None) -> LoopStats:
    dev = resolve_device(device)
    rank = 0 if groups is None else groups.rank
    ckpt = Checkpointer(lc.checkpoint_dir)
    if hasattr(fault_injector, "bind"):   # a core/faults.FaultPlan
        fault_injector.bind(ckpt)
    source = SyntheticLM(dc)
    stats = LoopStats([], [], [], saves=ckpt.save_log)
    info = log.info if rank == 0 else (lambda *a: None)
    warn = log.warning if rank == 0 else (lambda *a: None)
    cur = _World(topo, groups)

    def local_batch(t: MiCSTopology) -> int:
        """A micro-step's rows on a data rank of ``t``: what the memory
        planner prices the batch, activations and logits at."""
        return dc.global_batch // dc.micro_steps // t.data_parallel_size

    def build() -> None:
        if not cur.parked:
            cur.step_fn = build_train_step(model, cur.topo, mcfg, oc, device=dev,
                                           groups=cur.groups, local_batch=local_batch(cur.topo),
                                           seq=dc.seq)

    def load(step: int | None):
        """``(state, cursor)``: checkpoint ``step`` restored onto the current
        topology, or the seeded initial state when there is none."""
        if step is None:
            return init_state(model, lc.seed, device=dev, topo=cur.topo, rank=rank,
                              offload_opt=mcfg.offload_opt), 0
        state, meta = ckpt.restore(model, step, topo=cur.topo, rank=rank, device=dev,
                                   offload_opt=mcfg.offload_opt)
        return state, meta["data_cursor"]

    def try_save(state, step, cursor, *, blocking, emergency=False) -> bool:
        """Checkpoint, absorbing writer crashes into the stats ledger: a held
        failure of the previous async save surfaces here too (``save``
        waits for it first); one retry keeps the cadence."""
        for attempt in (0, 1):
            t0 = time.perf_counter()
            try:
                ckpt.save(state, step, topo=cur.topo, data_cursor=cursor, groups=cur.groups,
                          blocking=blocking, emergency=emergency)
                stats.save_times.append(time.perf_counter() - t0)
                return True
            except Exception as e:  # noqa: BLE001 - failure domain boundary
                stats.save_failures += 1
                warn("checkpoint save at step %d failed (%s)%s", step, e,
                     "; retrying" if attempt == 0 else "")
        return False

    def settle(absorb: type[BaseException]) -> None:
        """Let the in-flight save land; a failure of type ``absorb`` is
        counted, any other re-raised."""
        try:
            ckpt.wait()
        except absorb as e:
            stats.save_failures += 1
            warn("in-flight save lost (%s)", e)

    build()
    state, cursor = None, 0
    if not cur.parked:
        start = ckpt.latest_step(cur.groups)
        state, cursor = load(start)
        if start is not None:
            info("resumed from step %d", start)
    step = 0 if state is None else state["step"]
    ewma, measured, retries = None, 0, 0
    while True:
        if cur.parked:
            msg = meet(None)
            if msg.get("release"):
                break
        elif step >= lc.total_steps:
            break
        else:
            msg = None
            batch = source.host_step_batch(cursor, cur.topo.data_rank(rank),
                                           cur.topo.data_parallel_size)
            t0 = time.perf_counter()
            try:
                if fault_injector is not None:
                    fault_injector(step)
                state, metrics = cur.step_fn(state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                loss = float(metrics["loss"])   # surfaces device errors
            except WorldChangeError as e:
                stats.restarts += 1
                if elastic is None:
                    raise
                if len(stats.world_changes) >= elastic.max_world_changes:
                    log.error("world changed %d times; giving up", len(stats.world_changes))
                    raise
                new_world = cur.topo.world_size - e.lost + e.gained
                warn("world change at step %d (%s): %d -> %d ranks", step, e,
                     cur.topo.world_size, new_world)
                if e.notice:
                    # the old world is intact (preemption notice or grow
                    # announcement): an emergency save loses zero steps
                    if try_save(state, step, cursor, blocking=True, emergency=True):
                        stats.emergency_saves += 1
                else:
                    settle(FaultError)   # as the reference: a writer's own fault only
                if elastic.backoff_s:
                    time.sleep(elastic.backoff_s * (len(stats.world_changes) + 1))
                payload = None
                if rank == 0:
                    payload = {"event": {"at_step": int(step),
                                         "kind": "grow" if e.gained else "preempt",
                                         "lost": e.lost, "gained": e.gained,
                                         "notice": e.notice, "world": new_world},
                               "step": ckpt.latest_step(),
                               "fired": [ev.fired for ev in getattr(fault_injector, "events",
                                                                    [])],
                               "log": list(getattr(fault_injector, "log", []))}
                msg = payload if cur.groups is None else meet(payload)
            except Exception as e:  # noqa: BLE001 - failure domain boundary
                stats.restarts += 1
                retries += 1
                if retries > lc.max_step_retries:
                    raise
                warn("step %d failed (%s); rolling back", step, e)
                settle(Exception)    # a crashed writer must not end the rollback
                state = metrics = None
                state, cursor = load(ckpt.latest_step(cur.groups))
                step = state["step"]
                continue
        if msg is None:
            retries = 0
            dt = time.perf_counter() - t0
            measured += 1
            if measured > 1:
                # the first step after a (re)build pays for building and
                # loading the kernels and the allocator's growth; the
                # detector warms up from the second
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if ewma is not None and dt > lc.straggler_factor * ewma \
                    and len(stats.step_times) > 3:
                stats.straggler_steps.append(step)
                warn("straggler: step %d took %.2fs (ewma %.2fs)", step, dt, ewma)
            stats.losses.append(loss)
            stats.grad_norms.append(float(metrics["grad_norm"]))
            stats.step_times.append(dt)
            cursor += 1
            step += 1
            if lc.log_every and step % lc.log_every == 0:
                info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if lc.checkpoint_every and step % lc.checkpoint_every == 0:
                try_save(state, step, cursor, blocking=False)
            continue

        # -- a world change: every live process of the launch world -----------
        event = msg["event"]
        if cur.parked:
            stats.restarts += 1
        for ev, fired in zip(getattr(fault_injector, "events", []), msg["fired"]):
            ev.fired = fired
        if hasattr(fault_injector, "log"):
            fault_injector.log[:] = msg["log"]
        ended = {} if cur.step_fn is None else cur.step_fn.comm.counter.snapshot()
        # drop the old world's state, step function and groups (pinned
        # moments included) before the restore: the card's peak and the
        # pinned bytes never carry two worlds
        state = metrics = batch = None
        cur.step_fn = None
        if cur.groups is not None:
            cur.groups.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        new_topo, mcfg, rule = resize_for_world(
            model, mcfg, event["world"], tp=topo.model_size,
            partition_size=cur.topo.partition_size, available=launch_world(),
            local_batch=dc.global_batch // dc.micro_steps // (event["world"] // topo.model_size),
            seq=dc.seq)
        t0 = time.perf_counter()
        new_groups = None if cur.groups is None else MiCSGroups(
            new_topo, cur.groups.rank, backend=cur.groups.backend,
            timeout=cur.groups.timeout, inner=mcfg.hierarchy_inner)
        t1 = time.perf_counter()
        cur = _World(new_topo, new_groups)
        build()
        t2 = time.perf_counter()
        resumed = 0 if msg["step"] is None else msg["step"]
        if not cur.parked:
            state, cursor = load(msg["step"])
            step = state["step"]
        seconds = {"groups": t1 - t0, "step_fn": t2 - t1, "restore": time.perf_counter() - t2}
        stats.world_changes.append({**event, "resumed_step": resumed, **rule, "comm": ended,
                                    "rebuild_s": seconds})
        warn("resumed at step %d on %d ranks (p=%d, %s)", resumed, event["world"],
             new_topo.partition_size, rule["rule"])
        ewma, measured, retries = None, 0, 0

    if not cur.parked:
        try:
            ckpt.wait()
        except Exception as e:  # noqa: BLE001
            stats.save_failures += 1
            warn("final wait surfaced a crashed save (%s)", e)
        try_save(state, step, cursor, blocking=True)
        stats.comm = cur.step_fn.comm.counter.snapshot()
        if launch_world() > cur.topo.world_size:
            meet({"release": True} if rank == 0 else None)   # the parked processes
    return stats


def resize_for_world(model: ModelDef, mcfg: MiCSConfig, n_devices: int, *, tp: int = 1,
                     partition_size: int | None = None, available: int,
                     local_batch: int = 0, seq: int = 0
                     ) -> tuple[MiCSTopology, MiCSConfig, dict]:
    """(topology, config, ledger info) for a world of the first ``n_devices``
    of ``available`` ranks.

    The one rebuild path both the in-loop world-change handler and a cold
    :func:`elastic_restart` share, so the two are bitwise-interchangeable:
    ``autotune.resolve_world`` re-picks the partition size and the carry
    (the paper's §3.1 rule re-run on the survivors under
    ``mcfg.hbm_budget_gb``, the returned config carrying the carry that
    rescued the group; without a budget the keep rule, the config
    unchanged), then the survivors are re-laid out contiguously
    (``core/topology.elastic_host_topology``)."""
    p, mcfg2, info = resolve_world(model, mcfg, n_devices=n_devices, tp=tp,
                                   partition_size=partition_size, local_batch=local_batch,
                                   seq=seq)
    return elastic_host_topology(n_devices, p, tp, available=available), mcfg2, info


def elastic_restart(checkpoint_dir: str, cfg: ArchConfig, new_topo: MiCSTopology,
                    mcfg: MiCSConfig, oc: OptConfig, step: int | None = None, *,
                    device: str | torch.device = "cuda", groups=None,
                    local_batch: int = 0, seq: int = 0):
    """Resume a run on another topology (a lost or regrown world).

    Returns ``(model, state, step_fn, meta)``: this rank's shards of the
    checkpoint resharded for ``new_topo`` (``groups``: its ``MiCSGroups``,
    None on one rank) and the step function.  ``step=None`` restores the
    newest complete checkpoint; pass the step an in-loop world change
    resumed from to cold-restore exactly it (the bitwise reference of the
    elastic tests).  Pair with :func:`resize_for_world` to pick the
    ``new_topo`` and the config the in-loop path would have chosen; a
    ``policy="auto"`` config resolves at ``local_batch`` / ``seq`` (the
    loop's rows a data rank and micro-step) as the loop's step did."""
    model = build_model(cfg, tp=new_topo.model_size)
    rank = 0 if groups is None else groups.rank
    state, meta = Checkpointer(checkpoint_dir).restore(
        model, step, topo=new_topo, rank=rank, device=device, offload_opt=mcfg.offload_opt)
    step_fn = build_train_step(model, new_topo, mcfg, oc, device=device, groups=groups,
                               local_batch=local_batch, seq=seq)
    return model, state, step_fn, meta
