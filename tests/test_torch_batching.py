"""The port's continuous-batching scheduler (``repro_torch/runtime/batching.py``)
and block allocator (``runtime/paged.py``) against the JAX package's.

Each case runs the same operations through both packages (the reference's
``tests/test_paged.py`` and ``tests/test_batching_faults.py`` cases, with a
fake engine keyed by (request, position) so a replayed request regenerates
its stream) and records everything the scheduler decides: every
``StepPlan`` (tokens, positions, ``n_new``, tables, seeds, temperatures,
the slot -> request map), each tick's completions, every raised error and
shed reason, the allocators' free lists, each request's stream and event
log, ``stats()`` and ``ledger()``.  The two records must be equal; a few
of the reference's own properties are asserted on the port's record too.
Host code on numpy: nothing here runs a model.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.runtime import batching as JB  # noqa: E402
from repro.runtime import paged as JP  # noqa: E402
from repro_torch.runtime import batching as TB  # noqa: E402
from repro_torch.runtime import paged as TP  # noqa: E402

PKGS = {"reference": (JB, JP), "port": (TB, TP)}


def _err(fn, *a, **kw):
    """``fn``'s result, or the error it raised as (type name, shed reason)."""
    try:
        return ("ok", fn(*a, **kw))
    except (ValueError, RuntimeError) as e:  # ShedError is a RuntimeError
        return ("raised", type(e).__name__, getattr(e, "reason", None))


def _plan(plan) -> dict:
    return {"tokens": plan.tokens.tolist(), "pos": plan.pos.tolist(),
            "n_new": plan.n_new.tolist(), "tables": plan.tables.tolist(),
            "seeds": plan.seeds.tolist(), "temps": plan.temps.tolist(),
            "requests": {int(s): r.rid for s, r in plan.requests.items()},
            "active_rows": plan.active_rows}


def _fake_tokens(b, plan):
    tok = np.zeros(b.batch, np.int64)
    for slot, req in plan.requests.items():
        tok[slot] = (req.rid * 1000 + req.next_pos + int(plan.n_new[slot])) % 97
    return tok


def _tick(b, rec):
    plan = b.plan_step()
    rec.append(_plan(plan))
    done = b.commit(plan, _fake_tokens(b, plan))
    rec.append(sorted(r.rid for r in done))


def _drive(b, rec, max_ticks=500):
    for _ in range(max_ticks):
        if b.idle:
            return
        _tick(b, rec)
    raise AssertionError("scheduler did not drain")


def _final(b, reqs) -> dict:
    return {"ledger": b.ledger(), "stats": b.stats(), "dp": b.dp, "batch": b.batch,
            "tick": b.tick, "free": [list(a._free) for a in b.allocators],
            "requests": {r.rid: {"generated": list(r.generated), "events": list(r.events),
                                 "shed": (r.shed_reason, r.shed_tick),
                                 "ticks": (r.submit_tick, r.admit_tick, r.first_admit_tick,
                                           r.first_token_tick, r.finish_tick),
                                 "evictions": r.evictions, "replays": r.replays}
                         for r in reqs}}


# ---------------------------------------------------------------------------
# cases: each takes the package's (batching, paged) modules, returns a record
# ---------------------------------------------------------------------------

def allocator(B, P):
    rec = [P.blocks_for(1, 8), P.blocks_for(8, 8), P.blocks_for(9, 8), P.blocks_for(0, 8)]
    a = P.PagedKVAllocator(8, 4)
    rec += [a.free_blocks, a.alloc(7), a.alloc(1), a.free_blocks]
    a.free(rec[5])
    rec.append(a.free_blocks)
    a = P.PagedKVAllocator(6, 4)
    x, y = a.alloc(3), a.alloc(2)
    a.free(x)
    rec += [x, y, a.alloc(3), a.free_blocks]
    a.free([1, 2])
    rec += [_err(a.free, [2]), _err(a.free, [0]), _err(a.free, [6]), _err(a.alloc, -1),
            _err(P.PagedKVAllocator, 1, 4), _err(P.PagedKVAllocator, 4, 0)]
    a.reset()
    rec += [list(a._free), a.alloc(2)]
    return rec


def _requests(B, n, plen=4, max_new=6, seed0=100):
    return [B.Request(rid=i, prompt=list(range(1, plen + 1)), max_new_tokens=max_new,
                      seed=seed0 + i) for i in range(n)]


def fifo_admission_and_drain(B, P):
    b = B.ContinuousBatcher(dp=2, slots_local=2, nb_local=9, block_size=4, max_blocks=4,
                            chunk=4)
    reqs = _requests(B, 8)
    rec = [_err(b.submit, r) for r in reqs]
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def chunked_prefill_plan_shapes(B, P):
    b = B.ContinuousBatcher(dp=1, slots_local=1, nb_local=9, block_size=4, max_blocks=4,
                            chunk=3)
    req = B.Request(rid=0, prompt=list(range(1, 8)), max_new_tokens=2, temperature=0.5,
                    seed=9)
    b.submit(req)
    rec = []
    for tok in (0, 0, 42, 7):
        plan = b.plan_step()
        rec.append(_plan(plan))
        b.commit(plan, np.full(1, tok, np.int64))
    return rec + [_final(b, [req])]


def _overload(B, reserve, **kw):
    b = B.ContinuousBatcher(dp=1, slots_local=2, nb_local=6, block_size=4, max_blocks=4,
                            chunk=4, reserve=reserve, **kw)
    reqs = [B.Request(rid=i, prompt=[1, 2, 3, 4], max_new_tokens=9) for i in range(3)]
    rec = [_err(b.submit, r) for r in reqs]
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def reserve_full_never_evicts(B, P):
    return _overload(B, "full")


def eviction_requeue_is_deterministic(B, P):
    return _overload(B, "min")


def capped_eviction_streams(B, P):
    return _overload(B, "min", evict_cap=2)


def admission_respects_block_budget(B, P):
    rec = []
    for nb in (3, 2):
        b = B.ContinuousBatcher(dp=1, slots_local=2, nb_local=nb, block_size=4, max_blocks=4,
                                chunk=4)
        b.submit(B.Request(rid=0, prompt=list(range(1, 6)), max_new_tokens=2))
        rec.append(_plan(b.plan_step()))
    return rec


def submit_validates(B, P):
    b = B.ContinuousBatcher(dp=1, slots_local=1, nb_local=9, block_size=4, max_blocks=2,
                            chunk=1, max_queue=1)
    return [_err(b.submit, B.Request(rid=0, prompt=[1], max_new_tokens=99)),
            _err(b.submit, B.Request(rid=1, prompt=[], max_new_tokens=1)),
            b.ledger()["submitted"],
            _err(B.ContinuousBatcher, dp=1, slots_local=1, nb_local=2, block_size=4,
                 max_blocks=2, chunk=1, reserve="lazy"),
            _err(B.ContinuousBatcher, dp=1, slots_local=1, nb_local=2, block_size=4,
                 max_blocks=2, chunk=0)]


def _batcher(B, **kw):
    cfg = dict(dp=1, slots_local=2, nb_local=9, block_size=4, max_blocks=4, chunk=4)
    cfg.update(kw)
    return B.ContinuousBatcher(**cfg)


def min_ticks_left(B, P):
    r = B.Request(rid=0, prompt=list(range(1, 8)), max_new_tokens=5)
    rec = [r.min_ticks_left(chunk=c) for c in (4, 7, 1)]
    r.prefill_done, r.generated = 7, [1, 2]
    return rec + [r.min_ticks_left(chunk=4), r.positions_needed(), r.done]


def deadlines(B, P):
    """Unreachable at submit, exactly reachable, expiring while queued."""
    b = _batcher(B)
    reqs = [B.Request(rid=0, prompt=[1, 2], max_new_tokens=8, deadline_tick=3),
            B.Request(rid=1, prompt=[1, 2], max_new_tokens=6, deadline_tick=5)]
    rec = [_err(b.submit, r) for r in reqs]
    _drive(b, rec)
    b2 = _batcher(B, slots_local=1)
    reqs2 = [B.Request(rid=0, prompt=[1, 2], max_new_tokens=6),
             B.Request(rid=1, prompt=[1, 2], max_new_tokens=6, deadline_tick=7)]
    rec += [_err(b2.submit, r) for r in reqs2]
    _drive(b2, rec)
    return rec + [_final(b, reqs), _final(b2, reqs2)]


def ttl_expires_while_waiting(B, P):
    b = _batcher(B, slots_local=1)
    reqs = [B.Request(rid=0, prompt=[1, 2], max_new_tokens=8),
            B.Request(rid=1, prompt=[1, 2], max_new_tokens=2, ttl_ticks=3)]
    rec = [_err(b.submit, r) for r in reqs]
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def bounded_queue_rejects_on_submit(B, P):
    b = _batcher(B, slots_local=1, max_queue=2)
    reqs = [B.Request(rid=i, prompt=[1], max_new_tokens=4) for i in range(4)]
    rec = [_err(b.submit, reqs[0]), _plan(b.plan_step())]
    b.commit(b.plan_step(), np.zeros(1, np.int64))
    rec += [_err(b.submit, r) for r in reqs[1:]] + [b.pressure()]
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def backoff(B, P):
    rec = [B.backoff_ticks(4, a, rid=5, seed=9) for a in (1, 2, 3, 7, 30)]
    rec += [B.backoff_ticks(0, 3, rid=5, seed=9)]
    rec += [B.backoff_ticks(4, 2, rid=r, seed=9) for r in range(16)]
    b = _batcher(B, slots_local=1, backoff_base=4, backoff_seed=1)
    reqs = [B.Request(rid=0, prompt=[1], max_new_tokens=2),
            B.Request(rid=1, prompt=[1], max_new_tokens=2)]
    for r in reqs:
        b.submit(r)
    reqs[0].retry_at_tick = 3              # as a requeue would set it
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def _ladder(B, dwell):
    return B.DegradationLadder(
        [{"kv_dtype": "bf16", "resident_cap": 0, "label": "configured"},
         {"kv_dtype": "bf16", "resident_cap": 2, "label": "tightened"},
         {"kv_dtype": "int8", "resident_cap": 4, "label": "kv_int8"}],
        high_water=0.75, low_water=0.25, dwell=dwell)


def ladder(B, P):
    lad = _ladder(B, 3)
    rec = [lad.update(t, p) for t, p in enumerate((0.9, 0.9, 0.5, 0.9, 0.9, 0.9))]
    rec += [lad.level, lad.current()]
    lad = _ladder(B, 1)
    rec += [lad.update(t, p) for t, p in enumerate((1.0, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0))]
    rec += [lad.level, lad.max_level_seen, lad.transitions]
    rec += [_err(B.DegradationLadder, []),
            _err(B.DegradationLadder, [{"kv_dtype": "bf16", "resident_cap": 0}],
                 high_water=0.2, low_water=0.5)]
    return rec


def resident_cap_limits_admission(B, P):
    b = _batcher(B, slots_local=3, resident_cap=2)
    reqs = [B.Request(rid=i, prompt=[1], max_new_tokens=4) for i in range(3)]
    for r in reqs:
        b.submit(r)
    rec = []
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def _sustained_stream(B, evict_cap, ticks=120):
    b = B.ContinuousBatcher(dp=1, slots_local=2, nb_local=6, block_size=2, max_blocks=4,
                            chunk=2, reserve="min", evict_cap=evict_cap)
    reqs, rec = [], []
    for t in range(ticks):
        reqs.append(B.Request(rid=t, prompt=[1, 2], max_new_tokens=7, arrival=t))
        b.submit(reqs[-1])
        _tick(b, rec)
    return rec + [_final(b, reqs)]


def livelock_without_eviction_cap(B, P):
    return _sustained_stream(B, 0)


def eviction_cap_with_aging(B, P):
    return _sustained_stream(B, 3)


def rebuild_world_replays(B, P):
    """A rebuild at tick 4 (dp 2 -> 1), then a grow back to dp 2 with a new
    block count at tick 9, and the drain."""
    b = B.ContinuousBatcher(dp=2, slots_local=2, nb_local=9, block_size=4, max_blocks=4,
                            chunk=4, backoff_base=2, backoff_seed=3)
    reqs = [B.Request(rid=i, prompt=[1, 2, 3], max_new_tokens=8, seed=i) for i in range(6)]
    for r in reqs:
        b.submit(r)
    rec = []
    for _ in range(500):
        if b.idle:
            break
        if b.tick == 4:
            rec.append([r.rid for r in b.rebuild_world(dp=1)])
        if b.tick == 9:
            rec.append([r.rid for r in b.rebuild_world(dp=2, nb_local=12)])
        _tick(b, rec)
    return rec + [_final(b, reqs)]


def rebuild_world_resets_allocators(B, P):
    b = B.ContinuousBatcher(dp=2, slots_local=2, nb_local=9, block_size=4, max_blocks=4,
                            chunk=4)
    reqs = [B.Request(rid=i, prompt=[1, 2, 3], max_new_tokens=6) for i in range(4)]
    for r in reqs:
        b.submit(r)
    b.commit(b.plan_step(), np.zeros(b.batch, np.int64))
    rec = [[a.free_blocks for a in b.allocators], [r.rid for r in b.rebuild_world(dp=2)],
           [a.free_blocks for a in b.allocators]]
    _drive(b, rec)
    return rec + [_final(b, reqs)]


def multi_rank_overload_mix(B, P):
    """dp 2 under a bounded queue, deadlines, TTLs, sampled rows, resident
    cap and eviction: every control at once."""
    b = B.ContinuousBatcher(dp=2, slots_local=2, nb_local=7, block_size=2, max_blocks=8,
                            chunk=3, reserve="min", max_queue=5, evict_cap=2, backoff_base=1,
                            backoff_seed=4, resident_cap=2)
    rng = np.random.default_rng(11)
    reqs, rec = [], []
    for t in range(60):
        if len(reqs) < 24:
            n = int(rng.integers(1, 7))
            reqs.append(B.Request(
                rid=len(reqs), prompt=rng.integers(1, 50, n).tolist(),
                max_new_tokens=int(rng.integers(1, 6)), temperature=float(t % 3) / 2,
                seed=int(rng.integers(0, 1000)), arrival=t,
                deadline_tick=t + int(rng.integers(3, 14)) if t % 4 else None,
                ttl_ticks=int(rng.integers(1, 5)) if t % 3 == 0 else None))
            rec.append(_err(b.submit, reqs[-1]))
        if b.idle:
            continue
        _tick(b, rec)
    _drive(b, rec)
    return rec + [_final(b, reqs)]


CASES = [allocator, fifo_admission_and_drain, chunked_prefill_plan_shapes,
         reserve_full_never_evicts, eviction_requeue_is_deterministic, capped_eviction_streams,
         admission_respects_block_budget, submit_validates, min_ticks_left, deadlines,
         ttl_expires_while_waiting, bounded_queue_rejects_on_submit, backoff, ladder,
         resident_cap_limits_admission, livelock_without_eviction_cap, eviction_cap_with_aging,
         rebuild_world_replays, rebuild_world_resets_allocators, multi_rank_overload_mix]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_scheduler_matches_reference(case):
    want = case(*PKGS["reference"])
    got = case(*PKGS["port"])
    assert got == want


def test_port_keeps_the_reference_properties():
    """A few of the reference's assertions on the port's own runs."""
    fin = fifo_admission_and_drain(TB, TP)[-1]
    assert fin["stats"]["finished"] == 8 and fin["stats"]["evictions"] == 0
    assert all(len(f) == 8 for f in fin["free"])
    ev = eviction_requeue_is_deterministic(TB, TP)[-1]
    full = reserve_full_never_evicts(TB, TP)[-1]
    assert ev["stats"]["evictions"] > 0 and full["stats"]["evictions"] == 0
    assert ({r: v["generated"] for r, v in ev["requests"].items()}
            == {r: v["generated"] for r, v in full["requests"].items()})
    starved = livelock_without_eviction_cap(TB, TP)[-1]["requests"][0]
    assert starved["ticks"][-1] < 0 and starved["evictions"] > 20
    rescued = eviction_cap_with_aging(TB, TP)[-1]["requests"][0]
    assert 0 <= rescued["ticks"][-1] < 30 and rescued["evictions"] <= 3
    mix = multi_rank_overload_mix(TB, TP)[-1]["ledger"]
    assert mix["accounted"] and mix["shed"] > 0 and mix["completed"] > 0
    with pytest.raises(TB.ShedError) as ei:
        _batcher(TB).submit(TB.Request(rid=0, prompt=[1, 2], max_new_tokens=8,
                                       deadline_tick=3))
    assert ei.value.reason == TB.SHED_DEADLINE_SUBMIT
