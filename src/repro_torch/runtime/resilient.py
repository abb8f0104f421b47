"""The fault-tolerant serve loop on one rank (the port of
``repro/runtime/resilient.py``).

Serving has a cheap durable state: the *prompts*.  The paged engine samples
per (seed, position) (``models/lm.sample_tokens``) and a request's numerics
do not depend on the other slots, so a request replayed from its prompt
regenerates exactly the completion it would have produced.  Recovery is
therefore **rebuild, replay**:

1. a scripted :class:`repro_torch.core.faults.FaultPlan` raises a typed
   fault at a scheduler tick;
2. :class:`~repro_torch.core.faults.EngineCrashError` retries in place:
   fresh pools, the params reloaded, every in-flight request requeued from
   its prompt ahead of the waiting queue
   (``ContinuousBatcher.rebuild_world``), bounded by ``max_crash_retries``;
3. a world change (:class:`~repro_torch.core.faults.WorldChangeError`,
   :class:`~repro_torch.core.faults.StragglerError`'s eviction) that leaves
   no device raises ``WorldChangeError`` as the reference does; any other
   raises ``NotImplementedError``: serving over ranks, and the loop's
   world changes over process groups, are ROADMAP Queue 1 item 6b.

Overload control rides on the batcher (deadlines / TTL, bounded queue,
typed shedding, seeded backoff) and on an optional
:class:`~repro_torch.runtime.batching.DegradationLadder`: each tick the
queue pressure feeds the ladder, and a level change sets the residency cap
or changes the KV dtype, which rebuilds the pools at the new dtype and
replays (the one recovery path whose numerics may change: that is the
degradation).

Every tick runs the engine's one step at the chunk width, decode-only ticks
included (the reference switches to a width-1 step for them).  A width-1
step would multiply other matrix shapes (cuBLAS picks its kernels by the
row count, and RMSNorm plans by it), so a request's bits would depend on
whether another slot was prefilling in the same tick; at one width they do
not, and a replay after a crash is bitwise the fault-free run whatever the
schedule.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from repro_torch.core.faults import EngineCrashError, StragglerError, WorldChangeError
from repro_torch.core.mics import MiCSConfig, init_params
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.runtime import paged as PG
from repro_torch.runtime.batching import ContinuousBatcher, DegradationLadder, Request, ShedError
from repro_torch.runtime.serving import refuse_world

log = logging.getLogger("repro_torch.serve")

SERVE_OVER_RANKS = ("ROADMAP Queue 1 item 6b (serving over ranks, and the serve loop's "
                    "world changes over process groups)")


@dataclasses.dataclass
class ServeLoopConfig:
    """Engine geometry + robustness budgets for :class:`ResilientServeLoop`.

    The engine half: ``slots_local`` resident slots and ``nb_local`` KV
    blocks (block 0 the garbage block), ``max_blocks`` table width,
    ``chunk`` prefill tokens a slot a tick.  The robustness half:
    ``max_crash_retries`` bounds the in-place retries (a flapping engine
    re-raises rather than thrashing), ``max_ticks`` is the deadlock guard,
    and ``reserve`` / ``max_queue`` / ``evict_cap`` / ``backoff_*`` /
    ``resident_cap`` pass through to the batcher.  The reference's
    ``max_world_changes`` and ``arrival_rate`` (its world re-rank) come
    with world changes over ranks (ROADMAP Queue 1 item 6b)."""

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
    max_crash_retries: int = 2
    max_ticks: int = 100_000
    seed: int = 7              # default params provider: init_params(seed)


class ResilientServeLoop:
    """Continuous-batching serve loop on one rank that survives engine
    crashes and overload.

    ``fault_injector`` is called with every scheduler tick (a
    ``core/faults.FaultPlan`` fits directly); ``params_for(model, topo)``
    reloads the weights after a rebuild (default: ``init_params(model,
    sc.seed)`` on ``device``, the same values every time); ``ladder``
    enables graceful degradation.
    """

    def __init__(self, model, topo: MiCSTopology, mcfg: MiCSConfig, sc: ServeLoopConfig, *,
                 params_for: Callable | None = None,
                 fault_injector: Callable[[int], None] | None = None,
                 ladder: DegradationLadder | None = None,
                 device: str | torch.device = "cuda"):
        refuse_world(topo)
        self.model = model
        self.topo = topo
        self.mcfg = mcfg
        self.sc = sc
        self.device = resolve_device(device)
        self.world = topo.world_size
        self.fault = fault_injector
        self.ladder = ladder
        self.params_for = params_for or (
            lambda model, topo: init_params(model, sc.seed, device=self.device))
        self.kv_dtype = ladder.current()["kv_dtype"] if ladder else mcfg.kv_dtype
        self.world_changes: list[dict] = []
        self.crash_retries = 0
        self.batcher = ContinuousBatcher(
            dp=topo.data_parallel_size, slots_local=sc.slots_local, nb_local=sc.nb_local,
            block_size=sc.block_size, max_blocks=sc.max_blocks, chunk=sc.chunk,
            reserve=sc.reserve, max_queue=sc.max_queue, evict_cap=sc.evict_cap,
            backoff_base=sc.backoff_base, backoff_seed=sc.backoff_seed,
            resident_cap=(ladder.current()["resident_cap"] if ladder else sc.resident_cap))
        self._build_engine()

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
            top_k=sc.top_k, device=self.device)
        self._fresh_pools()
        self.params = self.params_for(self.model, self.topo)

    # -- fault handlers ----------------------------------------------------

    def _change_world(self, e: Exception, new_world: int, kind: str, tick: int) -> None:
        """A world change on one rank: none left raises the reference's
        ``WorldChangeError``; any other world needs serving over ranks."""
        if new_world < 1:
            raise WorldChangeError(f"world of {new_world} devices cannot carry "
                                   f"tp={self.topo.model_size}", lost=0) from e
        raise NotImplementedError(
            f"{kind} at tick {tick}: a world of {new_world} devices needs "
            f"{SERVE_OVER_RANKS}") from e

    def _on_crash(self, e: EngineCrashError, tick: int) -> None:
        self.crash_retries += 1
        if self.crash_retries > self.sc.max_crash_retries:
            raise e
        log.warning("engine crash at tick %d (%s): retrying in place", tick, e)
        # same world: fresh pools + params, replay in-flight from prompts
        self._fresh_pools()
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
        log.warning("degradation ladder -> level %d (%s) at tick %d",
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
        lifecycle ledger, the fault ledger and the ladder transitions."""
        if arrival_ticks is None:
            arrival_ticks = [0] * len(requests)
        pending = sorted(zip(arrival_ticks, requests), key=lambda p: (p[0], p[1].rid))
        b = self.batcher
        while pending or not b.idle:
            if b.tick > self.sc.max_ticks:
                raise RuntimeError(f"serve loop exceeded max_ticks={self.sc.max_ticks} "
                                   "(queue deadlock?)")
            tick = b.tick
            try:
                if self.fault is not None:
                    self.fault(tick)
            except WorldChangeError as e:
                self._change_world(e, self.world - e.lost + e.gained,
                                   "grow" if e.gained else "preempt", tick)
            except StragglerError as e:
                self._change_world(e, self.world - 1, "straggler eviction", tick)
            except EngineCrashError as e:
                self._on_crash(e, tick)
                continue
            while pending and pending[0][0] <= tick:
                _, req = pending.pop(0)
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
