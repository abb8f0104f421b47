"""The fault-tolerant serve loop (the port of ``repro/runtime/resilient.py``),
on one rank or over the ranks of a launch world.

Serving has a cheap durable state: the *prompts*.  The paged engine samples
per (seed, position) (``models/lm.sample_tokens``) and a request's numerics
do not depend on the other slots, so a request replayed from its prompt
regenerates exactly the completion it would have produced.  Recovery is
therefore **re-mesh, rebuild, replay**:

1. a scripted :class:`repro_torch.core.faults.FaultPlan` raises a typed
   fault at a scheduler tick;
2. on :class:`~repro_torch.core.faults.WorldChangeError` (a preemption, a
   grow-back) the survivors are re-laid out
   (``runtime/serving.resize_for_serve_world``: the keep rule, or the
   §3.1 re-pick under ``hbm_budget_gb``, tp pinned, and the serve policy
   re-ranked on the new world with its numerics pinned),
   the process groups, the paged step and the pools are rebuilt, the
   params reloaded on the new topology (``params_for``), and every
   in-flight request is requeued from its prompt ahead of the waiting
   queue (``ContinuousBatcher.rebuild_world``);
3. :class:`~repro_torch.core.faults.StragglerError` is the "evict the slow
   host" decision: the world shrinks by one, rounded down to a multiple of
   tp, and the same rebuild runs;
4. :class:`~repro_torch.core.faults.EngineCrashError` retries in place:
   the same world, fresh pools, the params reloaded, replay, bounded by
   ``max_crash_retries``.

``notice`` on a preemption is advisory: serving's checkpoint is the prompt
queue, so both paths replay alike and the ledger records which fired.

Over ranks (``groups``, a ``launch.mesh.MiCSGroups``) every process of the
launch world runs this loop on the same requests.  The ranks of the world
hold the same host state (the batcher's plan, the fault plan, the ladder)
and each runs its data rank's slots; the engine step gathers the sampled
tokens over the data group, so every rank commits the same tokens.  A rank
outside the world is parked: it waits in the next meeting.  A world change
runs as the train loop's (``runtime/train_loop.py``): every live process
meets in one call on the default group (``launch/mesh.meet``), where rank 0
sends the change and its host state (which a parked process adopts); each
process releases its groups, builds the new world's and, unless parked,
rebuilds its engine.  At the end rank 0 releases the parked processes in
the same way, so every process returns the same report.

Every tick runs the engine's one step at the chunk width, decode-only ticks
included (the reference switches to a width-1 step for them).  A width-1
step would multiply other matrix shapes (cuBLAS picks its kernels by the
row count, and RMSNorm plans by it), so a request's bits would depend on
whether another slot was prefilling in the same tick; at one width they do
not, and a replay after a crash is bitwise the fault-free run whatever the
schedule.  A rank's shapes do not change with the world either (tp is
pinned and ``slots_local`` fixed), so a replay on any surviving world is
bitwise the fault-free run too.

Overload control rides on the batcher (deadlines / TTL, bounded queue,
typed shedding, seeded backoff) and on an optional
:class:`~repro_torch.runtime.batching.DegradationLadder`: each tick the
queue pressure feeds the ladder, and a level change sets the residency cap
or changes the KV dtype, which rebuilds the pools at the new dtype and
replays (the one recovery path whose numerics may change: that is the
degradation).  ``ServeLoopConfig.arrival_rate`` is the offered load the
re-rank of the serve policy prices at a world change.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.faults import EngineCrashError, StragglerError, WorldChangeError
from repro_torch.core.mics import MiCSConfig, init_params
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MiCSGroups, launch_world, meet
from repro_torch.runtime import paged as PG
from repro_torch.runtime.batching import ContinuousBatcher, DegradationLadder, Request, ShedError
from repro_torch.runtime.serving import resize_for_serve_world

log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class ServeLoopConfig:
    """Engine geometry + robustness budgets for :class:`ResilientServeLoop`.

    The engine half: ``slots_local`` resident slots and ``nb_local`` KV
    blocks (block 0 the garbage block), ``max_blocks`` table width,
    ``chunk`` prefill tokens a slot a tick.  The robustness half:
    ``max_crash_retries`` bounds the in-place retries (a flapping engine
    re-raises rather than thrashing), ``max_ticks`` is the deadlock guard,
    ``max_world_changes`` bounds the world rebuilds (a flapping cluster
    re-raises rather than thrashing), and ``reserve`` / ``max_queue`` /
    ``evict_cap`` / ``backoff_*`` / ``resident_cap`` pass through to the
    batcher (``resident_cap`` 0: the config's ``max_resident_requests``,
    the planner's residency of a resolved or re-ranked config, 0 = no cap).  ``arrival_rate`` is the offered load the re-rank of the serve
    policy prices at a world change (``autotune.rank_policies`` prefers the
    fastest candidate whose modeled tokens a second meet it)."""

    slots_local: int
    nb_local: int
    block_size: int
    max_blocks: int
    chunk: int = 8
    top_k: int = 0
    reserve: str = "full"
    max_queue: int = 0
    evict_cap: int = 4
    backoff_base: int = 0
    backoff_seed: int = 0
    resident_cap: int = 0
    max_world_changes: int = 8
    max_crash_retries: int = 2
    max_ticks: int = 100_000
    seed: int = 7              # default params provider: init_params(seed, topo=, rank=)
    arrival_rate: float = 0.0  # offered load the world re-rank prices


class ResilientServeLoop:
    """Continuous-batching serve loop that survives faults and overload, on
    one rank or over the ranks of ``groups`` (this process's
    ``MiCSGroups`` of ``topo``).

    ``fault_injector`` is called with every scheduler tick (a
    ``core/faults.FaultPlan`` fits directly); ``params_for(model, topo)``
    loads this rank's weights on a topology after a rebuild (default:
    ``init_params(model, sc.seed, topo=topo, rank=rank)`` on ``device``,
    the same function of the model and the seed on any world); ``ladder``
    enables graceful degradation.
    """

    def __init__(self, model, topo: MiCSTopology, mcfg: MiCSConfig, sc: ServeLoopConfig, *,
                 params_for: Callable | None = None,
                 fault_injector: Callable[[int], None] | None = None,
                 ladder: DegradationLadder | None = None,
                 device: str | torch.device = "cuda", groups=None):
        self.model = model
        self.topo = topo
        self.mcfg0 = mcfg          # the numerics of every re-rank
        self.mcfg = mcfg
        self.sc = sc
        self.device = resolve_device(device)
        self.groups = groups
        self.rank = 0 if groups is None else groups.rank
        self.warn = log.warning if self.rank == 0 else (lambda *a: None)   # rank 0 logs
        self.tp = topo.model_size
        self.world = topo.world_size
        self.fault = fault_injector
        self.ladder = ladder
        self.params_for = params_for or (
            lambda model, topo: init_params(model, sc.seed, device=self.device, topo=topo,
                                            rank=self.rank))
        self.kv_dtype = ladder.current()["kv_dtype"] if ladder else mcfg.kv_dtype
        self.world_changes: list[dict] = []
        self.crash_retries = 0
        self.pending: list = []
        self.step = self.caches = self.params = None
        self.batcher = ContinuousBatcher(
            dp=topo.data_parallel_size, slots_local=sc.slots_local, nb_local=sc.nb_local,
            block_size=sc.block_size, max_blocks=sc.max_blocks, chunk=sc.chunk,
            reserve=sc.reserve, max_queue=sc.max_queue, evict_cap=sc.evict_cap,
            backoff_base=sc.backoff_base, backoff_seed=sc.backoff_seed,
            resident_cap=(ladder.current()["resident_cap"] if ladder else self._resident_cap()))
        if not self.parked:
            self._build_engine()

    def _resident_cap(self) -> int:
        """The batcher's residency cap without a ladder: the loop's own, else
        the planner's on the current config."""
        return self.sc.resident_cap or self.mcfg.max_resident_requests

    @property
    def parked(self) -> bool:
        """This process is outside the current world (it serves nothing)."""
        return self.groups is not None and self.groups.parked

    # -- engine (re)construction ------------------------------------------

    def _fresh_pools(self) -> None:
        self.caches = None  # the old pools go before the new ones are made
        self.caches = PG.init_paged_caches(self.model, self.topo, self.sc.nb_local,
                                           self.sc.block_size, self.kv_dtype,
                                           device=self.device)

    def _build_engine(self) -> None:
        sc = self.sc
        self.step = PG.build_paged_step(
            self.model, self.topo, self.mcfg, max_blocks=sc.max_blocks,
            block_size=sc.block_size, chunk=sc.chunk, kv_dtype=self.kv_dtype,
            top_k=sc.top_k, device=self.device, groups=self.groups)
        self._fresh_pools()
        self.params = None
        self.params = self.params_for(self.model, self.topo)

    def _host_state(self) -> dict:
        """What every process of the world holds alike: a parked process
        takes it over at a meeting."""
        return {"batcher": self.batcher, "pending": self.pending,
                "world_changes": self.world_changes, "crash_retries": self.crash_retries,
                "kv_dtype": self.kv_dtype, "ladder": self.ladder,
                "fired": [ev.fired for ev in getattr(self.fault, "events", [])],
                "log": list(getattr(self.fault, "log", []))}

    def _adopt(self, state: dict) -> None:
        for key in ("batcher", "pending", "world_changes", "crash_retries", "kv_dtype",
                    "ladder"):
            setattr(self, key, state[key])
        for ev, fired in zip(getattr(self.fault, "events", []), state["fired"]):
            ev.fired = fired
        if hasattr(self.fault, "log"):
            self.fault.log[:] = state["log"]

    def _rebuild(self, event: dict) -> None:
        """Re-mesh, rebuild and replay on the world of ``event["world"]``
        ranks: the old world's engine, pools, params and groups go first."""
        ended = {} if self.step is None else self.step.comm.counter.snapshot()
        self.step = self.caches = self.params = None
        t0 = time.perf_counter()
        if self.groups is not None:
            self.groups.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        available = 1 if self.groups is None else launch_world()
        self.topo, self.mcfg, info = resize_for_serve_world(
            self.model, self.mcfg0, event["world"], tp=self.tp,
            partition_size=self.topo.partition_size, available=available,
            seq=self.sc.max_blocks * self.sc.block_size, arrival_rate=self.sc.arrival_rate)
        if self.ladder is None:       # the ladder's levels own these otherwise
            self.kv_dtype = self.mcfg.kv_dtype
            self.batcher.resident_cap = self._resident_cap()
        if self.groups is not None:
            self.groups = MiCSGroups(self.topo, self.rank, backend=self.groups.backend,
                                     timeout=self.groups.timeout,
                                     inner=self.mcfg.hierarchy_inner)
        t1 = time.perf_counter()
        if not self.parked:
            self._build_engine()
        replayed = self.batcher.rebuild_world(dp=self.topo.data_parallel_size)
        self.world = event["world"]
        self.world_changes.append({
            **event, **info, "replayed": len(replayed), "comm": ended,
            "rebuild_s": {"groups": t1 - t0, "engine": time.perf_counter() - t1}})

    def _shrink_to_tp_multiple(self, n: int) -> int:
        n -= n % self.tp
        if n < self.tp:
            raise WorldChangeError(f"world of {n} devices cannot carry tp={self.tp}", lost=0)
        return n

    # -- fault handlers ----------------------------------------------------

    def _change_world(self, e: Exception, event: dict, tick: int) -> None:
        """Every live process meets (over ranks), then rebuilds on the new
        world; the change's budget is ``max_world_changes``."""
        if len(self.world_changes) >= self.sc.max_world_changes:
            log.error("world changed %d times; giving up", len(self.world_changes))
            raise e
        event = {"at_tick": int(tick), **event,
                 "world": self._shrink_to_tp_multiple(event.pop("world"))}
        self.warn("%s at tick %d (%s): %d -> %d devices", event["kind"], tick, e,
                  self.world, event["world"])
        if self.groups is not None:
            event = meet({"event": event, "state": self._host_state()}
                         if self.rank == 0 else None)["event"]
        self._rebuild(event)

    def _on_world_change(self, e: WorldChangeError, tick: int) -> None:
        self._change_world(e, {"kind": "grow" if e.gained else "preempt", "lost": e.lost,
                               "gained": e.gained, "notice": e.notice,
                               "world": self.world - e.lost + e.gained}, tick)

    def _on_straggler(self, e: StragglerError, tick: int) -> None:
        self._change_world(e, {"kind": "straggler_evict", "lost": 1, "gained": 0,
                               "notice": False, "world": self.world - 1}, tick)

    def _on_crash(self, e: EngineCrashError, tick: int) -> None:
        self.crash_retries += 1
        if self.crash_retries > self.sc.max_crash_retries:
            raise e
        self.warn("engine crash at tick %d (%s): retrying in place", tick, e)
        # same world: fresh pools + params, replay in-flight from prompts
        self._fresh_pools()
        self.params = None
        self.params = self.params_for(self.model, self.topo)
        replayed = self.batcher.rebuild_world(dp=self.topo.data_parallel_size)
        self.world_changes.append({
            "at_tick": int(tick), "kind": "crash", "lost": 0, "gained": 0,
            "notice": False, "world": self.world, "replayed": len(replayed)})

    def _on_ladder(self, tick: int) -> None:
        if not self.ladder.update(tick, self.batcher.pressure()):
            return
        lv = self.ladder.current()
        self.batcher.resident_cap = lv["resident_cap"]
        if lv["kv_dtype"] != self.kv_dtype:
            # dtype downshift / restore: pools change layout, so this is a
            # same-world rebuild + replay (numerics change by design here)
            self.kv_dtype = lv["kv_dtype"]
            self._build_engine()
            self.batcher.rebuild_world(dp=self.topo.data_parallel_size)
        self.warn("degradation ladder -> level %d (%s) at tick %d",
                  self.ladder.level, lv.get("label", ""), tick)

    # -- the loop ----------------------------------------------------------

    def _engine_step(self, plan) -> np.ndarray:
        tok, _logits, self.caches = self.step(
            self.params, self.caches, plan.tokens, plan.pos, plan.n_new, plan.tables,
            plan.seeds, plan.temps)
        return tok.cpu().numpy()

    def run(self, requests: list[Request], arrival_ticks: list[int] | None = None) -> dict:
        """Serve ``requests`` to completion (or typed shed); return the report.

        ``arrival_ticks[i]`` is the tick request ``i`` is offered at
        (default: all at tick 0).  The report carries the completions, the
        lifecycle ledger, the fault ledger and the ladder transitions.  Over
        ranks every process of the launch world calls this with the same
        requests."""
        if arrival_ticks is None:
            arrival_ticks = [0] * len(requests)
        self.pending = sorted(zip(arrival_ticks, requests), key=lambda p: (p[0], p[1].rid))
        while True:
            if self.parked:   # until the next world change or the release
                msg = meet(None)
                self._adopt(msg["state"])
                if msg.get("release"):
                    break
                self._rebuild(msg["event"])
                continue
            b = self.batcher
            if not (self.pending or not b.idle):
                break
            if b.tick > self.sc.max_ticks:
                raise RuntimeError(f"serve loop exceeded max_ticks={self.sc.max_ticks} "
                                   "(queue deadlock?)")
            tick = b.tick
            try:
                if self.fault is not None:
                    self.fault(tick)
            except WorldChangeError as e:
                self._on_world_change(e, tick)
                continue
            except StragglerError as e:
                self._on_straggler(e, tick)
                continue
            except EngineCrashError as e:
                self._on_crash(e, tick)
                continue
            while self.pending and self.pending[0][0] <= tick:
                _, req = self.pending.pop(0)
                req.arrival = tick
                try:
                    b.submit(req)
                except ShedError:
                    pass    # typed + already in the batcher's shed ledger
            plan = b.plan_step()
            if plan.active_rows == 0:
                b.commit(plan, np.zeros(b.batch, np.int64))
            else:
                b.commit(plan, self._engine_step(plan))
            if self.ladder is not None:
                self._on_ladder(tick)
        if not self.parked and self.groups is not None and launch_world() > self.world:
            meet({"release": True, "state": self._host_state()} if self.rank == 0 else None)
        return self.report()

    def report(self) -> dict:
        return {
            "completions": {r.rid: list(r.generated) for r in self.batcher.finished},
            "shed": {r.rid: r.shed_reason for r in self.batcher.shed_requests},
            "ledger": self.batcher.ledger(),
            "world_changes": list(self.world_changes),
            "ladder_transitions": list(self.ladder.transitions) if self.ladder else [],
            "ladder_max_level": self.ladder.max_level_seen if self.ladder else 0,
            "ladder_level": self.ladder.level if self.ladder else 0,
            "crash_retries": self.crash_retries,
            "world": self.world,
            "kv_dtype": self.kv_dtype,
            "ticks": self.batcher.tick,
        }


def serve_resilient(model, topo, mcfg, sc: ServeLoopConfig, requests: list[Request],
                    arrival_ticks: list[int] | None = None, **kw) -> dict:
    """One-shot convenience wrapper around :class:`ResilientServeLoop`."""
    return ResilientServeLoop(model, topo, mcfg, sc, **kw).run(requests, arrival_ticks)
