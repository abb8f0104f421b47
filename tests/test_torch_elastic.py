"""The port's elastic, fault-tolerant train loop on the CPU.

The copied ``core/faults.FaultPlan`` and the re-pick (``resolve_world``,
``elastic_host_topology``) against the JAX package's; on one rank the
checkpointer's atomicity (malformed and incomplete directories, a writer
killed mid-save, an async failure surfacing at ``wait``), rollback and
retry with the poison-step guard, the data cursor across restarts,
straggler flagging and eviction, and ``crash_mid_save`` in the loop; over
4 gloo ranks (``torch_dist_harness.py elastic``) the world changes B →
abrupt −2 → grow +2, A (p 4) −2 with notice and p 2 × tp 2 −2, a crash
mid-save, the checkpointer's reshards (p 2 → p 4 → p 2, B → A → B, one
rank onto B, ``offload_opt`` onto A) and a restore onto another tp.  Every
run's ledger, loss count and cursors equal the reference's
(``jax_dist_oracle.py elastic``, 4 virtual devices), its losses within
``test_torch_train.TOL["fp32"]`` of the reference's (at tp > 1 only the
port's own: the reference's gradients there are tp× the loss's), and each
world's steps are bitwise a cold ``elastic_restart`` of the checkpoint it
resumed from."""

import dataclasses
import hashlib
import json
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro_torch.checkpoint.checkpointer import MANIFEST, Checkpointer  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.core import faults as F  # noqa: E402
from repro_torch.core.autotune import resolve_world  # noqa: E402
from repro_torch.core.mics import MiCSConfig, init_state  # noqa: E402
from repro_torch.core.topology import MICS_AXES, MiCSTopology, elastic_host_topology  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.build import build_model  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime import train_loop as TL  # noqa: E402
from test_torch_train import TOL  # noqa: E402

CFG = smoke_variant(get_config("llama3.2-1b"))
MCFG = MiCSConfig(micro_steps=K.MICRO, gather_dtype=torch.float32)
DC = DataConfig(vocab=CFG.vocab, seq=K.SEQ, global_batch=K.ELASTIC_BATCH, micro_steps=K.MICRO)
OC = OptConfig(**K.ELASTIC_OPT)
# the reference's ledger keys (the port adds "comm": the ended world's counter)
LEDGER_KEYS = ("at_step", "kind", "lost", "gained", "notice", "world", "resumed_step", "rule",
               "carry", "partition_size", "data_extent", "tp", "n_devices")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke steps run as fast on one thread, and the test workers and
    the gloo ranks beside them do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return build_model(CFG, tp=1)


# ---------------------------------------------------------------------------
# the copies against the reference
# ---------------------------------------------------------------------------

PLAN_SPECS = {
    "chain": lambda cls: cls(slow_base_s=0.0).preempt(3, devices=4, notice=False).grow(
        7, devices=4).slow(5, factor=2.0).slow(6, factor=3.0, evict=True).crash(8)
    .crash_during_save(4),
    "notice": lambda cls: cls(slow_base_s=0.0).preempt(2, devices=1).preempt(2, devices=2),
    "parse": lambda cls: cls.parse("preempt@2x4,notice@3x2,grow@5x6,slow@4x3,evict@6,crash@7"),
}


def _fire(plan, steps=range(10)) -> list:
    """Each call's raised fault (type name, lost, gained, notice), twice a
    step: a fired event does not fire again."""
    out = []
    for step in steps:
        for _ in range(2):
            try:
                plan(step)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - recorded for the comparison
                out.append((type(e).__name__, str(e), getattr(e, "lost", None),
                            getattr(e, "gained", None), getattr(e, "notice", None)))
    return out


@pytest.mark.parametrize("spec", list(PLAN_SPECS))
def test_fault_plan_is_the_reference(spec, tmp_path):
    """The same calls (or spec) give the same plan, raise the same faults
    at the same steps once each, and the hook leaves the same truncated
    manifest and raises the same error."""
    from repro.core import faults as RF

    port, ref = PLAN_SPECS[spec](F.FaultPlan), PLAN_SPECS[spec](RF.FaultPlan)
    assert port.describe() == ref.describe()
    assert _fire(port) == _fire(ref)
    assert port.describe() == ref.describe()
    assert [e.kind for e in port.pending()] == [e.kind for e in ref.pending()]
    for hook_dir, plan, mod in ((tmp_path / "port", port, F), (tmp_path / "ref", ref, RF)):
        hook_dir.mkdir()
        plan.events.append(type(plan.events[0])("crash_during_save", 9))
        with pytest.raises(mod.CrashDuringSaveError):
            plan._save_hook("pre_manifest", hook_dir, {"step": 9, "data_cursor": 9})
        plan._save_hook("pre_manifest", hook_dir, {"step": 9})   # one-shot
    assert ((tmp_path / "port" / MANIFEST).read_text()
            == (tmp_path / "ref" / MANIFEST).read_text())
    with pytest.raises(ValueError):
        json.loads((tmp_path / "port" / MANIFEST).read_text())
    for name in ("WorldChangeError", "PreemptionError", "GrowthError", "StragglerError",
                 "CrashDuringSaveError", "EngineCrashError"):
        assert [b.__name__ for b in getattr(F, name).__mro__[:-3]] == [
            b.__name__ for b in getattr(RF, name).__mro__[:-3]]


def test_save_hook_truncates_on_rank_0_only(tmp_path):
    """Every rank's writer runs the hook and raises; only rank 0 leaves the
    truncated manifest (the ranks share the ``.tmp`` directory)."""
    for rank in (1, 0):
        plan = F.FaultPlan().crash_during_save(5)
        with pytest.raises(F.CrashDuringSaveError):
            plan._save_hook("pre_manifest", tmp_path, {"step": 5, "rank": rank})
        assert (tmp_path / MANIFEST).exists() == (rank == 0)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_resolve_world_is_the_reference(tp):
    """The keep rule on a grid of worlds and previous partition sizes, its
    ledger dict and its errors: the reference's."""
    from repro.core.autotune import resolve_world as ref_resolve
    from repro.core.mics import MiCSConfig as RefConfig

    mcfg = MiCSConfig()
    for n in range(0, 13):
        for prev in (None, 1, 2, 3, 4, 8):
            got = _outcome(resolve_world, None, mcfg, n_devices=n, tp=tp,
                           partition_size=prev)
            want = _outcome(ref_resolve, None, RefConfig(), n_devices=n, tp=tp,
                            partition_size=prev)
            if got[0] == "ValueError":
                assert got == want, (n, prev)
            else:
                assert (got[0], got[2]) == (want[0], want[2]), (n, prev)
                assert got[1] is mcfg      # the keep rule changes no field


def test_resolve_world_refuses_a_budget():
    """Under ``hbm_budget_gb`` the re-pick is the paper's §3.1 rule
    (``resolve_scale``): the smallest partition group whose plan fits,
    trying the stored, remat and host carries in turn at each size, the
    carry landing on the returned config, each plan held to the budget with
    the allocator's reserve.  llama3.2-1b's model states reserve 29.7 GiB
    a card at p 1 with the stored carry, 28.8 with remat (its plan the
    AdamW boundary's: the accumulator and ten fp32 temporaries of a 2^26-
    element slice); at p 2 the stored carry reserves 16.8, at p 4 10.3.  A
    budget below every candidate raises ``MemoryBudgetError``."""
    from repro_torch.core.memplan import MemoryBudgetError

    model = build_model(get_config("llama3.2-1b"), tp=1)
    for budget, n, want in ((30.0, 4, (1, "stored")), (29.0, 4, (1, "remat")),
                            (20.0, 4, (2, "stored")), (20.0, 2, (2, "stored")),
                            (11.0, 8, (4, "stored"))):
        p, mcfg2, info = resolve_world(model, MiCSConfig(hbm_budget_gb=budget), n_devices=n,
                                       partition_size=1)
        assert (p, mcfg2.prefetch_carry, mcfg2.carry_offload) == (*want, "none"), budget
        assert info["rule"] == "resolve_scale" and info["carry"] == want[1]
        assert info["mem_gib"] < info["reserved_gib"] <= budget and info["partition_size"] == p
    with pytest.raises(MemoryBudgetError, match="smallest candidate"):
        resolve_world(model, MiCSConfig(hbm_budget_gb=1.0), n_devices=2)


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The reference's elastic runs (4 virtual devices) and the port's 4
    gloo ranks, as subprocesses from the JAX initial state."""
    out = tmp_path_factory.mktemp("elastic")
    jax_proc = K.start("jax_dist_oracle.py", "elastic", str(out))
    K.finish(K.start("jax_dist_oracle.py", "init", str(out)), 180)
    port = K.start("torch_dist_harness.py", "elastic", str(out))
    K.finish(port, 300)
    K.finish(jax_proc, 300)
    ranks = [np.load(out / f"port_elastic.rank{r}.npz") for r in range(K.WORLD)]
    return ranks, np.load(out / "jax_elastic.npz"), out


def _json(z, key):
    return json.loads(str(z[key]))


def test_elastic_host_topology_is_the_reference(dist_runs):
    """The first n of 4 ranks laid out as ``(repl, p, tp)``, and the three
    errors (no device, no factorisation, more than are available), on
    ``K.ELASTIC_GRID``: the reference's on 4 virtual devices."""
    want = _json(dist_runs[1], "grid.json")
    for n, tp, p in K.ELASTIC_GRID:
        try:
            t = elastic_host_topology(n, p, tp, available=K.WORLD)
            got = {ax: getattr(t, ax) for ax in MICS_AXES}
        except ValueError as e:
            got = {"error": "ValueError", "message": str(e)}
        assert got == want[f"{n},{tp},{p}"], (n, tp, p)


# ---------------------------------------------------------------------------
# one rank: the checkpointer
# ---------------------------------------------------------------------------

def test_latest_step_skips_malformed_and_incomplete_dirs(model, tmp_path):
    state = init_state(model, 0, device="cpu")
    ck = Checkpointer(tmp_path)
    ck.save(state, 3, topo=MiCSTopology())
    (tmp_path / "step_old").mkdir()
    (tmp_path / "step_12xy").mkdir()
    (tmp_path / "step_00000007").mkdir()               # no manifest, no tensors
    crashed = tmp_path / "step_00000009"
    crashed.mkdir()
    np.save(crashed / "params.head.npy", np.zeros(3, np.float32))
    (crashed / MANIFEST).write_text('{"step": 9, "data_c')   # truncated
    assert ck.latest_step() == 3
    _, meta = ck.restore(model, device="cpu")
    assert meta["step"] == 3 and meta["emergency"] is False
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ck.restore(model, 9, device="cpu")


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[p][k], b[p][k]) for p in ("params", "m", "v") for k in a[p])


def test_crash_mid_save_leaves_tmp_and_restores_newest_complete(model, tmp_path):
    state = init_state(model, 2, device="cpu")
    ck = Checkpointer(tmp_path)
    plan = F.FaultPlan().crash_during_save(2).bind(ck)
    ck.save(state, 1, topo=MiCSTopology(), data_cursor=1)
    with pytest.raises(F.CrashDuringSaveError):
        ck.save(state, 2, topo=MiCSTopology(), data_cursor=2)   # blocking: raises
    corpse = tmp_path / "step_00000002.tmp"
    assert (corpse / "params.head.npy").exists() and not (tmp_path / "step_00000002").exists()
    with pytest.raises(ValueError):
        json.loads((corpse / MANIFEST).read_text())
    assert ck.latest_step() == 1
    restored, meta = ck.restore(model, device="cpu")
    assert meta["step"] == 1 and _equal(restored, state)
    ck.save(state, 2, topo=MiCSTopology(), data_cursor=2, emergency=True)   # one-shot
    assert ck.latest_step() == 2 and not corpse.exists()
    assert json.loads((tmp_path / "step_00000002" / MANIFEST).read_text())["emergency"]
    assert [e["kind"] for e in plan.log] == ["crash_during_save"]


def test_async_save_copies_the_state_and_surfaces_its_failure_at_wait(model, tmp_path):
    """``blocking=False`` returns with the state copied (an in-place update
    after it does not reach the files); a writer's failure is re-raised
    once, from ``wait``."""
    state = init_state(model, 4, device="cpu")
    want = {p: {k: t.clone() for k, t in state[p].items()} for p in ("params", "m", "v")}
    ck = Checkpointer(tmp_path)
    ck.save(state, 3, topo=MiCSTopology(), blocking=False)
    for t in state["params"].values():
        t.add_(1.0)                                     # the step's in-place update
    ck.wait()
    got, _ = ck.restore(model, device="cpu")
    assert _equal(got, {**want, "step": 0})
    assert [r["blocking"] for r in ck.save_log] == [False] and ck.save_log[0]["writer_s"] > 0
    F.FaultPlan().crash_during_save(4).bind(ck)
    ck.save(state, 4, topo=MiCSTopology(), blocking=False)   # the crash is held ...
    with pytest.raises(F.CrashDuringSaveError):
        ck.wait()                                             # ... and surfaces here
    ck.wait()                                                 # once
    assert ck.latest_step() == 3


# ---------------------------------------------------------------------------
# one rank: the loop
# ---------------------------------------------------------------------------

def _recording(monkeypatch) -> list:
    served = []

    class RecordingLM(SyntheticLM):
        def host_step_batch(self, step, host_index, host_count):
            b = super().host_step_batch(step, host_index, host_count)
            served.append((int(step), hashlib.sha1(b["tokens"].tobytes()).hexdigest()))
            return b

    monkeypatch.setattr(TL, "SyntheticLM", RecordingLM)
    return served


def _loop(model, ckdir, total, every=2, **kw):
    lc = TL.LoopConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=str(ckdir),
                       log_every=0)
    return TL.train(model, MiCSTopology(), MCFG, OC, DC, lc, device="cpu", **kw)


@pytest.mark.parametrize("name", [n for n, r in K.ELASTIC_RUNS.items() if r[0] == "1"])
def test_one_rank_faults_match_the_reference(model, dist_runs, tmp_path, monkeypatch, name):
    """From the JAX initial state (a step-0 checkpoint): the evicted step's
    rollback and, with the writer killed mid-save at 4, the rollback to 2
    (not to the corpse of 4), the retried saves and the cadence: the
    reference's losses (within TOL), counters, cursors and newest step."""
    served = _recording(monkeypatch)
    init = np.load(dist_runs[2] / "jax_init.npz")
    state = state_from_jax(model, {part: {k.split(".", 2)[2]: init[k] for k in init.files
                                          if k.startswith(f"init.{part}.")}
                                   for part in ("params", "m", "v")} | {"step": 0},
                           device="cpu")
    Checkpointer(tmp_path).save(state, 0, topo=MiCSTopology())
    _, total, every = K.ELASTIC_RUNS[name]
    stats = _loop(model, tmp_path, total, every,
                  fault_injector=K.fault_plan(F.FaultPlan, name))
    want = _json(dist_runs[1], f"{name}.json")
    assert [c for c, _ in served] == want["cursors"]
    for key in ("restarts", "save_failures", "emergency_saves", "world_changes"):
        assert getattr(stats, key) == want[key], key
    assert Checkpointer(tmp_path).latest_step() == want["latest"] == total
    assert len(stats.losses) == len(want["losses"])
    np.testing.assert_allclose(stats.losses, want["losses"], rtol=TOL["fp32"]["loss"])


def test_rollback_and_retry_then_the_poison_step_guard(model, tmp_path):
    crashed = {"n": 0}

    def once(step):
        if step == 5 and not crashed["n"]:
            crashed["n"] += 1
            raise RuntimeError("injected node failure")

    stats = _loop(model, tmp_path / "once", 8, fault_injector=once)
    assert stats.restarts == 1 and len(stats.losses) == 9   # 0-4, then 4-7 again
    assert Checkpointer(tmp_path / "once").latest_step() == 8

    failures = []

    def always(step):
        if step == 2:
            failures.append(step)
            raise RuntimeError("poison step")

    with pytest.raises(RuntimeError, match="poison step"):
        _loop(model, tmp_path / "poison", 8, fault_injector=always)
    # the guard re-raises on the (max_step_retries + 1)-th failure in a row
    assert len(failures) == TL.LoopConfig().max_step_retries + 1 == 3
    assert Checkpointer(tmp_path / "poison").latest_step() == 2


def test_rollback_absorbs_a_writer_failure_of_any_kind(model, tmp_path):
    """The async save of step 4 dies of an ``OSError`` (a full disk, no
    ``FaultError``); the crash at 5 waits for it, counts it and rolls back
    to 2, the newest complete checkpoint, instead of ending the run."""

    class DiskFullThenCrash:
        def __init__(self):
            self.fired = set()

        def bind(self, ckpt):
            def hook(phase, tmp, meta):
                if meta["step"] == 4 and "disk" not in self.fired:
                    self.fired.add("disk")
                    raise OSError(28, "No space left on device")
            ckpt.fault_hook = hook

        def __call__(self, step):
            if step == 5 and "crash" not in self.fired:
                self.fired.add("crash")
                raise RuntimeError("injected node failure")

    stats = _loop(model, tmp_path, 8, fault_injector=DiskFullThenCrash())
    assert (stats.restarts, stats.save_failures) == (1, 1)
    assert len(stats.losses) == 11   # 0-4, then 2-7 again
    assert Checkpointer(tmp_path).latest_step() == 8


def test_restart_continues_the_cursor_and_replays_no_batch(model, tmp_path, monkeypatch):
    served = _recording(monkeypatch)
    _loop(model, tmp_path, 4)
    boundary = len(served)
    stats = _loop(model, tmp_path, 8)
    assert len(stats.losses) == 4
    assert [c for c, _ in served] == list(range(8)) and boundary == 4
    fresh = SyntheticLM(DC)
    for c, h in served:
        assert h == hashlib.sha1(fresh.host_step_batch(c, 0, 1)["tokens"].tobytes()).hexdigest()
    assert len({h for _, h in served}) == len(served)


def test_straggler_flagged_and_eviction_rolls_back(model, tmp_path):
    """A stalled step is flagged; an evicted one rides rollback and retry:
    8 + 4 losses (6 and 7 again from the step-6 checkpoint).  The stall is
    4x the longest step before it (timed between the plan's calls, the
    first step's warm-up left out), so it exceeds 3x the step-time EWMA
    however loaded the host is."""
    factor = 9.0
    plan = F.FaultPlan().slow(6, factor=factor).slow(8, factor=2.0, evict=True)
    calls = []

    def injector(step):
        calls.append(time.perf_counter())
        if step == 6:
            longest = max(b - a for a, b in zip(calls[1:], calls[2:]))
            plan.slow_base_s = 4 * longest / (factor - 1)
        plan(step)

    stats = _loop(model, tmp_path, 10, every=3, fault_injector=injector)
    assert 6 in stats.straggler_steps, (stats.straggler_steps, stats.step_times)
    assert stats.restarts == 1 and len(stats.losses) == 12
    assert all(np.isfinite(stats.losses))
    assert [e["kind"] for e in plan.log] == ["slow", "slow"]


def test_world_change_without_elastic_reraises(model, tmp_path):
    with pytest.raises(F.PreemptionError):
        _loop(model, tmp_path, 4, fault_injector=F.FaultPlan().preempt(1, devices=1))


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _segments_of(losses: list, ledger: list, total: int) -> list[list]:
    """The loop's losses cut into the worlds after each change."""
    segs = K.segments(ledger, total)
    n = sum(steps for _, steps in segs)
    out, i = [], len(losses) - n
    for _, steps in segs:
        out.append(losses[i:i + steps])
        i += steps
    return out


@pytest.mark.parametrize("name", K.ELASTIC_CHANGES)
def test_world_changes_match_the_reference(dist_runs, name):
    """Every rank's ledger (the reference's keys), rank 0's counters, loss
    count and cursors equal the reference's; the losses within TOL of the
    reference's (tp 1: both start from the JAX initial state)."""
    ranks, ref, _ = dist_runs
    want = _json(ref, f"{name}.json")
    got = [_json(z, f"{name}.json") for z in ranks]
    for g in got:
        assert [{k: e[k] for k in LEDGER_KEYS} for e in g["world_changes"]] == \
            want["world_changes"]
        assert g["restarts"] == want["restarts"]
    for key in ("emergency_saves", "save_failures", "cursors", "latest"):
        assert got[0][key] == want[key], key
    assert len(got[0]["losses"]) == len(want["losses"])
    # a rank computes the losses of the steps its worlds ran (a mean over
    # the data ranks): the same values as rank 0's
    assert all(set(g["losses"]) <= set(got[0]["losses"]) for g in got)
    if K.LAYOUTS[K.ELASTIC_RUNS[name][0]][0][4] == 1:
        np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=TOL["fp32"]["loss"])


@pytest.mark.parametrize("name", K.ELASTIC_CHANGES)
def test_world_changes_are_bitwise_cold_restarts(dist_runs, name):
    """Each world after a change: its steps' losses and the state it
    checkpointed at its end are bitwise those of a cold ``elastic_restart``
    of the checkpoint it resumed from, on the same topology (the same
    ``resize_for_world``), on every rank of that world."""
    ranks = dist_runs[0]
    total = K.ELASTIC_RUNS[name][1]
    got = [_json(z, f"{name}.json") for z in ranks]
    ledger = got[0]["world_changes"]
    segs = _segments_of(got[0]["losses"], ledger, total)
    checked = 0
    for i, (entry, _) in enumerate(K.segments(ledger, total)):
        for r, g in enumerate(got):
            cold = g["cold"][i]
            assert {k: cold["rule"][k] for k in cold["rule"]} == {
                k: entry[k] for k in cold["rule"]}
            if r < entry["world"]:
                assert cold["losses"] == segs[i], (i, r)
                assert cold["state_bitwise"] in (True, None), (i, r)
                checked += cold["state_bitwise"] is True
            else:
                assert cold["losses"] == []
    assert checked >= 2


def test_crash_mid_save_over_four_ranks(dist_runs):
    """The writer killed mid-save at 4 on every rank, the eviction at 5: every
    rank's stats equal, and the reference's (11 losses, 1 save failure,
    newest step 8)."""
    ranks, ref, _ = dist_runs
    got = [_json(z, "B_crash_mid_save.json") for z in ranks]
    want = _json(ref, "B_crash_mid_save.json")
    for g in got:
        assert {k: v for k, v in g.items() if k != "fired"} == \
            {k: v for k, v in got[0].items() if k != "fired"}
    for key in ("restarts", "save_failures", "cursors", "latest", "world_changes",
                "emergency_saves"):
        assert got[0][key] == want[key], key
    assert len(got[0]["losses"]) == 11 and got[0]["latest"] == 8
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=TOL["fp32"]["loss"])


@pytest.mark.parametrize("case", ["p2_p4_p2", "B_A_B", "one_to_B"])
def test_reshard_round_trips_are_bitwise(dist_runs, case):
    """Each restore onto another p, replication degree or world is bitwise
    the global state's shards at that topology (replica 0's chunks,
    memory-mapped), and a round trip gives back the first state."""
    ranks = dist_runs[0]
    assert all(bool(z[f"{case}.bitwise"]) for z in ranks)
    if case != "one_to_B":
        assert [int(z[f"{case}.restores"]) for z in ranks] == (
            [3, 3, 1, 1] if case == "p2_p4_p2" else [3] * 4)


def test_offload_opt_restore_across_topologies(dist_runs):
    """Saved at B, restored onto A with m and v in host memory and on the
    device: both bitwise the state's A shards, and one step of each the
    same bits; no memory left pinned (on the CPU nothing is)."""
    ranks = dist_runs[0]
    for z in ranks:
        assert bool(z["offload.restored_bitwise"]) and bool(z["offload.moments_in_host_memory"])
        assert bool(z["offload.step_bitwise"]) and int(z["offload.pinned_bytes"]) == 0


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_offload_opt_world_changes_pin_one_world(tmp_path, device):
    """In-loop world changes with the AdamW moments in host memory (p 4 →
    p 2 with notice; B → 2 ranks → B) are bitwise the device-resident runs:
    losses, gradient norms, ledger and the last checkpoint's files.  On the
    card, the pinned bytes at every step are this rank's m and v bytes in
    that step's world, their peak is the largest world's (the old world's
    moments are dropped before the restore), and nothing stays pinned after
    the run; the device-resident run pins nothing."""
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: pinned memory and the kernels")
        from repro_torch.kernels import build as KB

        KB.build_library()   # once, before the 4 ranks load it
    K.finish(K.start("torch_dist_harness.py", "elastic_offload", str(tmp_path), device), 600)
    for name in K.ELASTIC_OFFLOAD:
        for r in range(K.WORLD):
            res = _json(np.load(tmp_path / f"port_elastic_offload.rank{r}.npz"),
                        f"{name}.offload.json")
            on, off = res["True"], res["False"]
            assert (on["losses"], on["grad_norms"]) == (off["losses"], off["grad_norms"])
            assert on["ledger"] == off["ledger"] and len(on["ledger"]) == len(
                K.ELASTIC_PLANS[name])
            assert res["checkpoints_equal"], (name, r)
            assert on["pinned"] == on["expected"], (name, r)
            assert on["peak"] == max(on["world_bytes"]) and on["after"] == 0, (name, r)
            assert off["peak"] == off["after"] == 0 and set(off["pinned"]) <= {0}
            if device == "cuda":
                assert on["world_bytes"][0] > 0


def test_restore_onto_another_tp_raises_over_ranks(dist_runs):
    for z in dist_runs[0]:
        err = _json(z, "other_tp.error")
        assert err is not None and "TP degree is fixed" in err


def test_loop_stats_fields_are_the_reference_and_more():
    from repro.runtime.train_loop import LoopStats as RefStats

    ref = [f.name for f in dataclasses.fields(RefStats)]
    port = [f.name for f in dataclasses.fields(TL.LoopStats)]
    assert set(ref) <= set(port)
    assert {"grad_norms", "save_times", "comm"} <= set(port)
