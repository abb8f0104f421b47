"""Continuous-batching request scheduler for the paged serving engine.

A copy of ``repro/runtime/batching.py`` (host code on numpy): the
:class:`ContinuousBatcher` owns one
:class:`~repro_torch.runtime.paged.PagedKVAllocator` per data rank and turns a
ragged arrival queue into fixed-shape step plans for
:func:`repro_torch.runtime.paged.build_paged_step`.  Each *tick* produces one
``StepPlan`` whose rows are the ``dp * slots_local`` resident request slots:

- **prefill rows** feed up to ``chunk`` prompt tokens (``n_new > 1`` allowed),
  so long prompts are streamed in chunks interleaved with decode traffic
  instead of stalling the whole batch (bounded TTFT *and* bounded
  tokens/s);
- **decode rows** feed the previously sampled token (``n_new == 1``);
- **idle rows** carry ``n_new == 0`` — the engine drops their cache writes
  and the scheduler ignores their sampled token.

Admission is FIFO, gated on a free slot *and* a free-block budget of
``blocks_for(len(prompt) + 1)`` on the target rank.  Requests grow their
block allocation lazily, one tick ahead of the write frontier; when a rank
runs out of blocks the youngest resident request on that rank is evicted —
its blocks are freed and it is requeued at the *front* of the waiting queue
to restart from scratch (sampling is seeded per (seed, position), so a
restarted request regenerates the same tokens).

Overload protection (all off by default, so an unconfigured batcher keeps
the plain FIFO / evict-youngest semantics exactly):

- **bounded queue** — ``max_queue`` rejects submissions once the waiting
  queue is full (:class:`ShedError`, reason :data:`SHED_QUEUE_FULL`);
- **deadlines / TTLs** — per-request ``deadline_tick`` (absolute completion
  deadline) and ``ttl_ticks`` (max queue wait).  Admission is
  deadline-aware: a request that cannot possibly finish in time is rejected
  at submit (:data:`SHED_DEADLINE_SUBMIT`); queued requests are swept every
  tick and shed the moment their deadline becomes unreachable or their TTL
  expires (:data:`SHED_DEADLINE`, :data:`SHED_TTL`).  Shedding is always
  typed and ledgered — never a silent drop;
- **seeded-jitter backoff** — with ``backoff_base > 0`` an evicted or
  replayed request is requeued with a ``retry_at_tick`` gate computed by
  :func:`backoff_ticks` (exponential in the attempt count, jitter keyed by
  ``(backoff_seed, rid, attempt)`` so schedules replay deterministically);
  admission scans past gated entries without violating FIFO among the
  eligible;
- **eviction cap with aging** — evict-youngest + front-of-queue requeue can
  livelock: under sustained overload the youngest resident is always the
  freshest readmission of the same request, which is evicted again before
  it can finish (tests/test_torch_batching.py reproduces the schedule).
  ``evict_cap`` bounds that: a request evicted ``evict_cap`` times gains
  priority — it is requeued at the queue front with no backoff gate and
  becomes ineligible as an eviction victim, so its next admission sticks.

Tick counts double as the latency clock: the bench maps ticks to wall time
after the fact, so the scheduler itself stays deterministic — including
every shed/backoff/degradation decision.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any

import numpy as np

from repro_torch.runtime.paged import PagedKVAllocator, blocks_for

# -- typed load-shedding reasons (the ledger's vocabulary) -------------------
SHED_QUEUE_FULL = "queue_full"            # bounded queue rejected the submit
SHED_DEADLINE_SUBMIT = "deadline_unreachable"   # could never finish in time
SHED_DEADLINE = "deadline_expired"        # became unreachable while queued
SHED_TTL = "ttl_expired"                  # waited longer than its TTL


class ShedError(RuntimeError):
    """A request was load-shed; ``reason`` is one of the ``SHED_*`` strings.

    Raised from :meth:`ContinuousBatcher.submit` (reject-on-submit: the
    caller learns immediately, and the request is already accounted in the
    batcher's shed ledger — never a silent drop)."""

    def __init__(self, reason: str, request: "Request"):
        super().__init__(f"request {request.rid} shed: {reason}")
        self.reason = reason
        self.request = request


def backoff_ticks(base: int, attempt: int, *, rid: int = 0,
                  seed: int = 0) -> int:
    """Deterministic seeded-jitter exponential backoff, in scheduler ticks.

    ``base * 2^(attempt-1)`` plus a jitter drawn from a splitmix-style hash
    of ``(seed, rid, attempt)`` — the result lies in ``[window, 2*window)``
    and is a pure function of its arguments, so retry schedules replay
    identically across runs (the same discipline as the per-(seed,
    position) sampler)."""
    if base <= 0:
        return 0
    window = base * (1 << min(max(attempt - 1, 0), 16))
    h = (seed * 0x9E3779B97F4A7C15 + rid * 0xBF58476D1CE4E5B9
         + attempt * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 31
    h = (h * 0xD6E8FEB86659FD93) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 27
    return window + h % window


@dataclasses.dataclass
class Request:
    """One serving request plus its scheduler-side bookkeeping."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos: int | None = None
    arrival: int = 0
    deadline_tick: int | None = None   # absolute finish-by tick (None = no SLO)
    ttl_ticks: int | None = None       # max ticks waiting unadmitted

    # -- mutable scheduler state ------------------------------------------
    generated: list[int] = dataclasses.field(default_factory=list)
    prefill_done: int = 0
    next_pos: int = 0          # cache positions written so far
    blocks: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1             # global slot id, -1 while waiting
    rank: int = -1
    admit_tick: int = -1
    first_admit_tick: int = -1  # first-ever admission (survives evictions)
    first_token_tick: int = -1
    finish_tick: int = -1
    submit_tick: int = -1
    evictions: int = 0
    replays: int = 0           # world-change replays (full restart from prompt)
    retry_at_tick: int = 0     # backoff gate: not admissible before this tick
    shed_reason: str | None = None
    shed_tick: int = -1
    events: list[tuple[str, int]] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return self.eos is not None and self.eos in self.generated

    def positions_needed(self) -> int:
        # The final sampled token is returned but never written back.
        return len(self.prompt) + self.max_new_tokens - 1

    def min_ticks_left(self, chunk: int) -> int:
        """Ticks to completion under the best possible schedule.

        ``ceil(remaining_prompt / chunk)`` prefill ticks (the first token
        lands on the last of them) plus one tick per remaining token.  The
        deadline math: a request planned at tick ``t`` can finish no
        earlier than tick ``t + min_ticks_left - 1``."""
        pre = len(self.prompt) - self.prefill_done
        rem = self.max_new_tokens - len(self.generated)
        if pre > 0:
            return -(-pre // chunk) + rem - 1
        return rem

    def record(self, kind: str, tick: int) -> None:
        self.events.append((kind, tick))

    def reset(self) -> None:
        self.generated = []
        self.prefill_done = 0
        self.next_pos = 0
        self.blocks = []
        self.slot = -1
        self.rank = -1
        self.first_token_tick = -1


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Fixed-shape arrays for one engine step plus the slot -> request map."""

    tokens: np.ndarray       # [B, chunk] int32
    pos: np.ndarray          # [B] int32 first-token positions
    n_new: np.ndarray        # [B] int32 (0 = idle row)
    tables: np.ndarray       # [B, max_blocks] int32 rank-local block ids
    seeds: np.ndarray        # [B] int32
    temps: np.ndarray        # [B] float32
    requests: dict[int, Request]   # slot -> resident request this tick

    @property
    def active_rows(self) -> int:
        return int((self.n_new > 0).sum())


class DegradationLadder:
    """Graceful-degradation state machine over priced serve levels.

    ``levels`` is an ordered list of ``{"kv_dtype", "resident_cap",
    "label"}`` dicts, level 0 being the configured operating point and each
    later level a cheaper one, as the memory planner prices them
    (``repro_torch.core.memplan.degradation_levels``).  :meth:`update` walks the
    ladder with hysteresis: pressure above ``high_water`` for ``dwell``
    consecutive ticks downshifts one level; pressure below ``low_water``
    for ``dwell`` ticks restores one level.  Transitions are recorded in
    ``transitions`` and the whole machine is a pure function of the
    pressure series — deterministic and unit-testable device-free.

    Note the numerics caveat: a level that changes ``kv_dtype`` changes
    decode numerics by design (that is the degradation), so the serve
    loop's bitwise-replay guarantee holds per operating level, not across
    a downshift.
    """

    def __init__(self, levels: list[dict], *, high_water: float = 0.75,
                 low_water: float = 0.25, dwell: int = 8):
        if not levels:
            raise ValueError("ladder needs at least one level")
        if not (0.0 <= low_water < high_water):
            raise ValueError("need 0 <= low_water < high_water")
        self.levels = [dict(lv) for lv in levels]
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.dwell = max(int(dwell), 1)
        self.level = 0
        self.max_level_seen = 0
        self.transitions: list[dict] = []
        self._hot = 0   # consecutive ticks above high_water
        self._cool = 0  # consecutive ticks below low_water

    def current(self) -> dict:
        return self.levels[self.level]

    def update(self, tick: int, pressure: float) -> bool:
        """Feed one tick's pressure sample; True iff the level changed."""
        self._hot = self._hot + 1 if pressure >= self.high_water else 0
        self._cool = self._cool + 1 if pressure <= self.low_water else 0
        new = self.level
        if self._hot >= self.dwell and self.level + 1 < len(self.levels):
            new = self.level + 1
        elif self._cool >= self.dwell and self.level > 0:
            new = self.level - 1
        if new == self.level:
            return False
        self.transitions.append({
            "tick": int(tick), "from": self.level, "to": new,
            "pressure": float(pressure),
            "label": self.levels[new].get("label", str(new))})
        self.level = new
        self.max_level_seen = max(self.max_level_seen, new)
        self._hot = self._cool = 0
        return True


class ContinuousBatcher:
    """FIFO admission + chunked-prefill/decode interleaving over paged KV.

    Parameters mirror the engine: ``dp`` data ranks of ``slots_local``
    resident slots each, ``nb_local`` KV blocks per rank (block 0 is the
    engine's garbage block and never allocated), ``max_blocks`` table width
    per request and ``chunk`` tokens fed per prefill row per tick.

    ``reserve`` picks the admission discipline: ``"min"`` admits as soon
    as the first prompt chunk fits (``blocks_for(len(prompt) + 1)``) and
    relies on eviction + front-of-queue requeue when later growth finds
    the rank exhausted — maximum occupancy, but under sustained overload
    the evicted replays waste work; ``"full"`` admits only when the
    request's worst-case block count fits after subtracting every
    resident's unclaimed reservation, so growth can never fail and
    nothing is ever evicted (vLLM's conservative watermark, the right
    default for throughput benchmarks).

    Overload controls (see the module docstring; zero disables each):
    ``max_queue`` bounds the waiting queue, ``evict_cap`` is the
    per-request eviction budget before priority aging kicks in,
    ``backoff_base``/``backoff_seed`` drive the seeded-jitter retry gate,
    and ``resident_cap`` caps admitted requests per rank below
    ``slots_local`` (the degradation ladder's tightening lever).
    """

    def __init__(self, *, dp: int, slots_local: int, nb_local: int,
                 block_size: int, max_blocks: int, chunk: int = 1,
                 reserve: str = "min", max_queue: int = 0,
                 evict_cap: int = 4, backoff_base: int = 0,
                 backoff_seed: int = 0, resident_cap: int = 0):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if reserve not in ("min", "full"):
            raise ValueError("reserve must be 'min' or 'full'")
        self.reserve = reserve
        self.dp = dp
        self.slots_local = slots_local
        self.batch = dp * slots_local
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.chunk = chunk
        self.nb_local = nb_local
        self.max_queue = int(max_queue)
        self.evict_cap = int(evict_cap)
        self.backoff_base = int(backoff_base)
        self.backoff_seed = int(backoff_seed)
        self.resident_cap = int(resident_cap)
        self.allocators = [PagedKVAllocator(nb_local, block_size)
                           for _ in range(dp)]
        self.waiting: list[Request] = []
        self.resident: dict[int, Request] = {}   # slot -> request
        self.finished: list[Request] = []
        self.shed_requests: list[Request] = []
        self.tick = 0
        self.evicted = 0
        self.replayed = 0
        self.submitted = 0
        self._queue_depth: list[int] = []   # one sample per planned tick
        self._wait_ages: list[int] = []     # per waiting request per tick

    # -- queue management -------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue ``req``, or reject it with a typed :class:`ShedError`.

        Structural problems (prompt too long for the table, empty prompt)
        stay ``ValueError`` — those are caller bugs, not load.  Overload
        rejections (queue full, deadline unreachable even if admitted now)
        raise :class:`ShedError` *after* recording the request in the shed
        ledger, so every submission is accounted."""
        need = blocks_for(req.positions_needed(), self.block_size)
        if need > self.max_blocks:
            raise ValueError(
                f"request {req.rid} needs {need} blocks > max_blocks="
                f"{self.max_blocks}")
        if not req.prompt:
            raise ValueError("empty prompt")
        self.submitted += 1
        req.submit_tick = self.tick
        req.record("submit", self.tick)
        if self.max_queue and len(self.waiting) >= self.max_queue:
            self._shed(req, SHED_QUEUE_FULL)
            raise ShedError(SHED_QUEUE_FULL, req)
        if self._deadline_unreachable(req):
            self._shed(req, SHED_DEADLINE_SUBMIT)
            raise ShedError(SHED_DEADLINE_SUBMIT, req)
        self.waiting.append(req)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.resident

    def pressure(self) -> float:
        """Queue occupancy in [0, inf): the degradation ladder's signal.

        Waiting requests over the queue bound (or over the slot count when
        the queue is unbounded) — 1.0 means the backlog equals capacity."""
        cap = self.max_queue if self.max_queue else self.batch
        return len(self.waiting) / float(max(cap, 1))

    def _deadline_unreachable(self, req: Request) -> bool:
        return (req.deadline_tick is not None
                and self.tick + req.min_ticks_left(self.chunk) - 1
                > req.deadline_tick)

    def _shed(self, req: Request, reason: str) -> None:
        """Typed removal: ledger the request, free anything it held."""
        if req.slot >= 0 and self.resident.get(req.slot) is req:
            self.allocators[req.rank].free(req.blocks)
            del self.resident[req.slot]
            req.blocks = []
            req.slot = -1
        req.shed_reason = reason
        req.shed_tick = self.tick
        req.record("shed", self.tick)
        self.shed_requests.append(req)

    def _expire_waiting(self) -> None:
        """Sweep the queue for deadline/TTL expiries (typed, never silent)."""
        keep = []
        for r in self.waiting:
            if r.ttl_ticks is not None \
                    and self.tick - r.submit_tick > r.ttl_ticks:
                self._shed(r, SHED_TTL)
            elif self._deadline_unreachable(r):
                self._shed(r, SHED_DEADLINE)
            else:
                keep.append(r)
        self.waiting = keep

    def _free_slots(self, rank: int) -> list[int]:
        lo = rank * self.slots_local
        return [s for s in range(lo, lo + self.slots_local)
                if s not in self.resident]

    def _reserved_extra(self, rank: int) -> int:
        """Blocks promised to residents on ``rank`` but not yet allocated."""
        if self.reserve != "full":
            return 0
        return sum(
            max(0, blocks_for(r.positions_needed(), self.block_size)
                - len(r.blocks))
            for r in self.resident.values() if r.rank == rank)

    def _residents_on(self, rank: int) -> int:
        return sum(1 for r in self.resident.values() if r.rank == rank)

    def _try_place(self, req: Request) -> bool:
        """Place ``req`` on some rank if slot + block budget allow."""
        if self.reserve == "full":
            budget = blocks_for(req.positions_needed(), self.block_size)
        else:
            budget = blocks_for(len(req.prompt) + 1, self.block_size)
        for rank in range(self.dp):
            slots = self._free_slots(rank)
            if self.resident_cap \
                    and self._residents_on(rank) >= self.resident_cap:
                continue
            avail = (self.allocators[rank].free_blocks
                     - self._reserved_extra(rank))
            if not slots or avail < budget:
                continue
            req.slot, req.rank = slots[0], rank
            req.admit_tick = self.tick
            if req.first_admit_tick < 0:
                req.first_admit_tick = self.tick
            req.record("admit", self.tick)
            self.resident[req.slot] = req
            return True
        return False

    def _admit(self) -> None:
        """FIFO-admit waiting requests into free slots under block budget.

        Strict FIFO among the *eligible*: the scan skips entries whose
        backoff gate (``retry_at_tick``) has not elapsed — a backing-off
        request must not head-block the queue — but stops at the first
        eligible request that does not fit, so capacity is still granted
        in arrival order."""
        self._expire_waiting()
        while True:
            admitted = False
            for qi, req in enumerate(self.waiting):
                if req.retry_at_tick > self.tick:
                    continue
                if self._try_place(req):
                    self.waiting.pop(qi)
                    admitted = True
                break
            if not admitted:
                break

    def _requeue(self, victim: Request) -> None:
        """Evicted: front-of-queue requeue with backoff, cap and aging."""
        victim.reset()
        victim.evictions += 1
        self.evicted += 1
        victim.record("evict", self.tick)
        if self.evict_cap and victim.evictions >= self.evict_cap:
            # aging: priority admission, no backoff gate — and from here on
            # the victim-selection filter protects it from further eviction
            victim.retry_at_tick = self.tick
            self.waiting.insert(0, victim)
            return
        victim.retry_at_tick = self.tick + backoff_ticks(
            self.backoff_base, victim.evictions, rid=victim.rid,
            seed=self.backoff_seed)
        self.waiting.insert(0, victim)

    def _evict(self, rank: int, keep: Request | None) -> bool:
        """Evict the youngest evictable resident on ``rank`` (not ``keep``).

        Requests at their eviction cap are not eligible victims — that,
        plus their priority readmission, is what breaks the
        evict-youngest/readmit/evict-again livelock under sustained
        overload."""
        victims = [r for r in self.resident.values()
                   if r.rank == rank and r is not keep
                   and not (self.evict_cap
                            and r.evictions >= self.evict_cap)]
        if not victims:
            return False
        victim = max(victims, key=lambda r: (r.admit_tick, r.slot))
        self.allocators[rank].free(victim.blocks)
        del self.resident[victim.slot]
        self._requeue(victim)
        return True

    def _ensure_blocks(self, req: Request, n_new: int) -> bool:
        """Grow ``req.blocks`` to cover ``next_pos + n_new`` positions."""
        need = blocks_for(req.next_pos + n_new, self.block_size)
        while len(req.blocks) < need:
            got = self.allocators[req.rank].alloc(need - len(req.blocks))
            if got is not None:
                req.blocks.extend(got)
                return True
            if not self._evict(req.rank, keep=req):
                return False
        return True

    # -- world changes ----------------------------------------------------

    def rebuild_world(self, dp: int, *, nb_local: int | None = None
                      ) -> list[Request]:
        """Re-key the scheduler to a changed device world; replay in-flight.

        The serving half of a :class:`repro_torch.core.faults.WorldChangeError`
        (and of a KV-dtype degradation rebuild): every resident request
        loses its KV blocks with the old pools, so each is reset to its
        prompt and requeued *ahead* of the waiting queue in original
        admission order — per-(seed, position) sampling regenerates the
        identical completion (the chaos harness's bitwise contract).  The
        tick clock, finished/shed ledgers and counters all survive, so
        latency accounting spans the fault.  Allocators are reset in place
        for surviving ranks and created for grown ones.  Returns the
        replayed requests."""
        nb = self.nb_local if nb_local is None else nb_local
        survivors = sorted(self.resident.values(),
                           key=lambda r: (r.admit_tick, r.slot))
        for r in survivors:
            r.reset()
            r.replays += 1
            self.replayed += 1
            r.record("replay", self.tick)
            r.retry_at_tick = self.tick + backoff_ticks(
                self.backoff_base, r.evictions + r.replays, rid=r.rid,
                seed=self.backoff_seed)
        self.resident = {}
        self.waiting[:0] = survivors
        self.dp = dp
        self.batch = dp * self.slots_local
        if nb == self.nb_local:
            allocs = self.allocators[:dp]
            for a in allocs:
                a.reset()
        else:
            self.nb_local, allocs = nb, []
        allocs += [PagedKVAllocator(nb, self.block_size)
                   for _ in range(dp - len(allocs))]
        self.allocators = allocs
        return survivors

    # -- planning / commit ------------------------------------------------

    def plan_step(self) -> StepPlan:
        # shed residents whose deadline became unreachable mid-flight:
        # finishing late is worthless under an SLO, and their blocks are
        # exactly what the queue behind them is starved of
        for req in list(self.resident.values()):
            if self._deadline_unreachable(req):
                self._shed(req, SHED_DEADLINE)
        self._admit()
        self._queue_depth.append(len(self.waiting))
        self._wait_ages.extend(
            self.tick - r.submit_tick for r in self.waiting)
        B, C = self.batch, self.chunk
        tokens = np.zeros((B, C), np.int32)
        pos = np.zeros(B, np.int32)
        n_new = np.zeros(B, np.int32)
        tables = np.zeros((B, self.max_blocks), np.int32)
        seeds = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        live: dict[int, Request] = {}
        for slot in sorted(self.resident):
            req = self.resident.get(slot)
            if req is None:   # evicted earlier this same planning pass
                continue
            P = len(req.prompt)
            if req.prefill_done < P:
                n = min(C, P - req.prefill_done)
                row = req.prompt[req.prefill_done:req.prefill_done + n]
            else:
                n = 1
                row = [req.generated[-1] if req.generated
                       else req.prompt[-1]]
            if not self._ensure_blocks(req, n):
                # rank exhausted and nothing else to evict: self-evict
                self.allocators[req.rank].free(req.blocks)
                del self.resident[slot]
                self._requeue(req)
                continue
            tokens[slot, :n] = row
            pos[slot] = req.next_pos
            n_new[slot] = n
            tables[slot, :len(req.blocks)] = req.blocks
            seeds[slot] = req.seed
            temps[slot] = req.temperature
            live[slot] = req
        # A mid-pass eviction may have reclaimed the blocks of a request
        # planned earlier in this same tick; idle such rows out so nothing
        # writes into blocks it no longer owns.
        for slot in list(live):
            if self.resident.get(slot) is not live[slot]:
                tokens[slot] = 0
                pos[slot] = 0
                n_new[slot] = 0
                tables[slot] = 0
                seeds[slot] = 0
                temps[slot] = 0.0
                del live[slot]
        return StepPlan(tokens=tokens, pos=pos, n_new=n_new, tables=tables,
                        seeds=seeds, temps=temps, requests=live)

    def commit(self, plan: StepPlan, sampled: np.ndarray) -> list[Request]:
        """Advance request state with the engine's sampled tokens.

        Returns the requests that completed on this tick (their blocks and
        slots are already released).
        """
        completed = []
        for slot, req in plan.requests.items():
            n = int(plan.n_new[slot])
            if n == 0:
                continue
            req.next_pos += n
            if req.prefill_done < len(req.prompt):
                req.prefill_done += n
                if req.prefill_done < len(req.prompt):
                    continue           # mid-prefill: sampled token is noise
                req.first_token_tick = self.tick
            req.generated.append(int(sampled[slot]))
            if req.done:
                req.finish_tick = self.tick
                req.record("complete", self.tick)
                self.allocators[req.rank].free(req.blocks)
                req.blocks = []
                del self.resident[req.slot]
                req.slot = -1
                self.finished.append(req)
                completed.append(req)
        self.tick += 1
        return completed

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        done = self.finished
        ttft = [r.first_token_tick - r.arrival for r in done
                if r.first_token_tick >= 0]
        lat = [r.finish_tick - r.arrival for r in done]
        return {
            "finished": len(done),
            "waiting": len(self.waiting),
            "resident": len(self.resident),
            "evictions": self.evicted,
            "replays": self.replayed,
            "shed": len(self.shed_requests),
            "submitted": self.submitted,
            "ticks": self.tick,
            "tokens_generated": sum(len(r.generated) for r in done),
            "ttft_ticks_p50": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_ticks_p99": float(np.percentile(ttft, 99)) if ttft else 0.0,
            "latency_ticks_p50": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_ticks_p99": float(np.percentile(lat, 99)) if lat else 0.0,
        }

    def ledger(self) -> dict[str, Any]:
        """Request-lifecycle ledger: where every submission ended up.

        ``accounted`` is the no-loss invariant — completed + shed +
        still-in-flight covers 100% of submissions (the chaos harness and
        the bench burst cell both gate on it).  Percentile roll-ups cover
        end-to-end latency, TTFT, queue depth per tick and per-tick
        request wait ages, all in deterministic scheduler ticks."""
        done, shed = self.finished, self.shed_requests
        in_flight = len(self.waiting) + len(self.resident)
        lat = [r.finish_tick - r.arrival for r in done]
        ttft = [r.first_token_tick - r.arrival for r in done
                if r.first_token_tick >= 0]
        qd, ages = self._queue_depth, self._wait_ages

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {
            "submitted": self.submitted,
            "completed": len(done),
            "shed": len(shed),
            "in_flight": in_flight,
            "accounted": self.submitted == len(done) + len(shed) + in_flight,
            "shed_by_reason": dict(Counter(
                r.shed_reason for r in shed)),
            "evictions": self.evicted,
            "replays": self.replayed,
            "max_evictions_per_request": max(
                (r.evictions for r in done + shed + self.waiting
                 + list(self.resident.values())), default=0),
            "ticks": self.tick,
            "latency_ticks_p50": pct(lat, 50),
            "latency_ticks_p99": pct(lat, 99),
            "ttft_ticks_p50": pct(ttft, 50),
            "ttft_ticks_p99": pct(ttft, 99),
            "queue_depth_p50": pct(qd, 50),
            "queue_depth_p99": pct(qd, 99),
            "queue_depth_max": max(qd, default=0),
            "wait_age_ticks_p50": pct(ages, 50),
            "wait_age_ticks_p99": pct(ages, 99),
        }
