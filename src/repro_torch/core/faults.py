"""Deterministic fault injection for elastic training (a copy of
``repro/core/faults.py``, which imports neither JAX nor the JAX package).

MiCS's premise is training gigantic models on *public cloud*, where gigantic
capacity is bought as preemptible/spot instances: devices disappear mid-run
(sometimes with a notice window, sometimes abruptly), come back later, run
slow, or die halfway through a checkpoint write.  The train loop's survival
of those events (runtime/train_loop.py) is only trustworthy if the exact
failure timeline can be scripted and replayed — this module is that script.

In the port a "device" is a rank of the launch world (one process, one
card or a share of one): ``preempt(at_step, devices=2)`` takes the last 2
ranks of the current world out of the run, ``grow`` brings parked ranks
back.  Every rank holds the same plan and calls it at the same step, so
every rank takes the same path.

A :class:`FaultPlan` is an ordered set of :class:`FaultEvent`\\ s, each firing
exactly once at its scripted step:

* ``preempt(at_step, devices)`` — raise :class:`PreemptionError` before the
  step runs: ``devices`` leave the world.  ``notice=True`` (the spot
  two-minute-warning model) lets the loop take an emergency checkpoint of
  the still-intact state; ``notice=False`` is the abrupt kill — the loop
  rolls back to the last *complete* checkpoint and recomputes.
* ``grow(at_step, devices)`` — raise :class:`GrowthError`: capacity came
  back, the loop re-resolves scale and resumes on the larger world.
* ``slow(at_step, device, factor)`` — stretch the step's wall time by
  sleeping, so the loop's EWMA straggler detector fires; ``evict=True``
  instead raises :class:`StragglerError` (the production "evict the slow
  host" decision), which the loop treats as a rollback-and-retry failure.
* ``crash_during_save(step)`` — kill the checkpoint writer *mid-write*
  (after this rank's tensors, before the manifest is complete), leaving a
  ``step_*.tmp`` dir plus a truncated manifest behind — the atomicity
  scenario ``Checkpointer.latest_step`` must survive.
* ``crash(at_step)`` — raise :class:`EngineCrashError`: the process died
  but the world did not change (the serving loop's retry path).

The plan is callable with the step index, which is exactly the
``fault_injector`` hook of ``runtime/train_loop.train``; the
checkpoint-writer leg attaches via :meth:`FaultPlan.bind` (the loop does
this automatically when it is handed a plan).  Everything is driven by step
indices and fires once, so timelines replay identically across runs.
"""

from __future__ import annotations

import dataclasses
import json
import time


class FaultError(RuntimeError):
    """Base of every injected fault."""


class WorldChangeError(FaultError):
    """The device world changed: ``lost`` devices left, ``gained`` joined.

    ``notice=True`` means the event was announced while the old world was
    still intact (spot preemption notice / scheduler grow notification), so
    the loop may take an emergency checkpoint before rebuilding.
    """

    def __init__(self, msg: str, *, lost: int = 0, gained: int = 0,
                 notice: bool = True):
        super().__init__(msg)
        self.lost = int(lost)
        self.gained = int(gained)
        self.notice = bool(notice)


class PreemptionError(WorldChangeError):
    """Devices were (or are about to be) preempted."""

    def __init__(self, msg: str, *, lost: int, notice: bool = True):
        super().__init__(msg, lost=lost, notice=notice)


class GrowthError(WorldChangeError):
    """Preempted capacity returned; the world grew back."""

    def __init__(self, msg: str, *, gained: int):
        super().__init__(msg, gained=gained, notice=True)


class StragglerError(FaultError):
    """A device is slow enough that the scheduler decided to evict it."""


class CrashDuringSaveError(FaultError):
    """The checkpoint writer died mid-write (simulated process kill)."""


class EngineCrashError(FaultError):
    """The serving engine died without the world changing (a process or
    runtime crash).  The resilient serve loop (``runtime/resilient.py``)
    retries it in place; the train loop treats it as a rollback-and-retry
    failure."""


@dataclasses.dataclass
class FaultEvent:
    """One scripted event.  ``fired`` keeps every event one-shot, so the
    post-rollback replay of a step does not re-raise its fault."""

    kind: str                # 'preempt' | 'grow' | 'slow' | 'crash_during_save'
    at_step: int
    devices: int = 0         # lost (preempt) / gained (grow) device count
    factor: float = 1.0      # slow-down multiple for 'slow'
    notice: bool = True      # preemption announced before devices vanish
    evict: bool = False      # 'slow' escalates to StragglerError
    fired: bool = False

    def describe(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()}


class FaultPlan:
    """A deterministic, scripted failure timeline.

    Events chain: ``FaultPlan().preempt(5, devices=4).grow(12, devices=4)``.
    ``slow_base_s`` scales the synthetic straggler delay (``factor`` times
    it); keep it small in tests — the *values* of the run never depend on
    wall time, only the loop's straggler EWMA does.
    """

    def __init__(self, *, slow_base_s: float = 0.05):
        self.events: list[FaultEvent] = []
        self.slow_base_s = float(slow_base_s)
        self.log: list[dict] = []      # fired events, in firing order

    # -- events -------------------------------------------------------------
    def preempt(self, at_step: int, devices: int = 1, *,
                notice: bool = True) -> "FaultPlan":
        self.events.append(FaultEvent("preempt", at_step, devices=devices,
                                      notice=notice))
        return self

    def grow(self, at_step: int, devices: int) -> "FaultPlan":
        self.events.append(FaultEvent("grow", at_step, devices=devices))
        return self

    def slow(self, at_step: int, device: int = 0, factor: float = 3.0, *,
             evict: bool = False) -> "FaultPlan":
        # `device` is advisory: a slow rank stalls every collective of the
        # step, so the delay is global either way.
        self.events.append(FaultEvent("slow", at_step, devices=device,
                                      factor=factor, evict=evict))
        return self

    def crash_during_save(self, step: int) -> "FaultPlan":
        self.events.append(FaultEvent("crash_during_save", step))
        return self

    def crash(self, at_step: int) -> "FaultPlan":
        """Engine crash with the world intact (serve-loop retry path)."""
        self.events.append(FaultEvent("crash", at_step))
        return self

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a compact spec (the reference's ``launch/serve.py
        --fault-plan``).

        Comma-separated one-shot events, each ``kind@tick`` with an
        optional ``xN`` device count (default 1):

        - ``preempt@T[xN]`` — abrupt loss of N devices at tick T;
        - ``notice@T[xN]`` — preemption announced with notice;
        - ``grow@T[xN]`` — N devices return;
        - ``slow@T[xF]`` — straggling tick (F = slowdown factor);
        - ``evict@T`` — straggler escalated to eviction;
        - ``crash@T`` — engine crash, world intact.

        Example: ``"preempt@20x4,grow@40x4,crash@60"``.
        """
        plan = cls()
        for part in filter(None, (p.strip() for p in spec.split(","))):
            try:
                kind, rest = part.split("@", 1)
                at, _, arg = rest.partition("x")
                at = int(at)
                n = float(arg) if arg else 1.0
            except ValueError:
                raise ValueError(f"bad fault spec {part!r} "
                                 "(want kind@tick[xN])") from None
            if kind == "preempt":
                plan.preempt(at, devices=int(n), notice=False)
            elif kind == "notice":
                plan.preempt(at, devices=int(n), notice=True)
            elif kind == "grow":
                plan.grow(at, devices=int(n))
            elif kind == "slow":
                plan.slow(at, factor=n)
            elif kind == "evict":
                plan.slow(at, factor=n, evict=True)
            elif kind == "crash":
                plan.crash(at)
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
        return plan

    # -- the train-loop hook ------------------------------------------------
    def __call__(self, step: int) -> None:
        """Fire this step's scripted events (the loop's ``fault_injector``)."""
        for ev in self.events:
            if ev.fired or ev.at_step != int(step) \
                    or ev.kind == "crash_during_save":
                continue
            ev.fired = True
            self.log.append(ev.describe())
            if ev.kind == "preempt":
                raise PreemptionError(
                    f"preemption at step {step}: {ev.devices} device(s) "
                    f"{'announced leaving' if ev.notice else 'lost abruptly'}",
                    lost=ev.devices, notice=ev.notice)
            if ev.kind == "grow":
                raise GrowthError(
                    f"world grew at step {step}: {ev.devices} device(s) "
                    f"returned", gained=ev.devices)
            if ev.kind == "slow":
                time.sleep(self.slow_base_s * max(ev.factor - 1.0, 0.0))
                if ev.evict:
                    raise StragglerError(
                        f"device {ev.devices} {ev.factor:g}x slow at step "
                        f"{step}: evicted")
            if ev.kind == "crash":
                raise EngineCrashError(
                    f"engine crashed at step {step} (world intact)")

    # -- the checkpoint-writer hook ----------------------------------------
    def bind(self, checkpointer) -> "FaultPlan":
        """Attach the crash-during-save leg to a ``Checkpointer``."""
        checkpointer.fault_hook = self._save_hook
        return self

    def _save_hook(self, phase: str, tmp_dir, meta: dict) -> None:
        """Checkpointer ``fault_hook``: kill the writer mid-write.

        Runs on every rank's writer thread after that rank's tensors are
        on disk but before the manifest is complete; rank 0 (``meta["rank"]``,
        0 when absent) leaves a truncated manifest in the ``.tmp`` dir (what
        a real mid-``write_text`` kill leaves) so the atomicity scan has
        something adversarial to skip.  Every rank raises, so every rank
        sees the same failure.
        """
        if phase != "pre_manifest":
            return
        for ev in self.events:
            if ev.fired or ev.kind != "crash_during_save" \
                    or ev.at_step != int(meta.get("step", -1)):
                continue
            ev.fired = True
            self.log.append(ev.describe())
            from repro_torch.checkpoint.checkpointer import MANIFEST

            if int(meta.get("rank", 0)) == 0:
                (tmp_dir / MANIFEST).write_text(json.dumps(meta)[:24])
            raise CrashDuringSaveError(
                f"checkpoint writer killed mid-save at step {meta['step']}")

    # -- introspection ------------------------------------------------------
    def pending(self) -> list[FaultEvent]:
        return [ev for ev in self.events if not ev.fired]

    def describe(self) -> dict:
        return {"events": [ev.describe() for ev in self.events],
                "fired": list(self.log)}
