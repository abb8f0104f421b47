"""The world re-pick of the elastic train loop (the port of
``resolve_world`` from ``repro/core/autotune.py``).

Only the keep rule is ported: without a memory budget the loop keeps the
previous partition size where it divides the new data extent, else the
largest divisor below it.  The rest of the reference module (the link
model's ranking of policies, ``resolve_config`` and ``resolve_scale``, the
paper's §3.1 re-pick under ``hbm_budget_gb``) waits for ROADMAP Queue 1
item 8, the link model, memory planner and autotuner.
"""

from __future__ import annotations

from repro_torch.core.mics import UNPORTED_TRAIN


def resolve_world(mcfg, *, n_devices: int, tp: int = 1, partition_size: int | None = None):
    """Re-pick the partition-group size for an ``n_devices`` world.

    The elastic train loop's policy half (runtime/train_loop.py calls this
    on every :class:`repro_torch.core.faults.WorldChangeError` before it
    rebuilds the groups): the previous ``partition_size`` where it still
    divides the new data extent, else the largest divisor below it.  It is
    deterministic, which is what makes an in-loop resume bitwise a cold
    restore with the same arguments.  ``mcfg`` is read for its carry (a
    ledger key) and its budget: ``mcfg.hbm_budget_gb`` set (the reference's
    §3.1 re-pick by ``resolve_scale``) raises ``NotImplementedError``, as
    the port has no memory planner yet; the config is never changed.

    Returns ``(partition_size, info)``; ``info`` is the ledger's dict.
    """
    if n_devices <= 0 or n_devices % max(tp, 1):
        raise ValueError(
            f"world of {n_devices} devices cannot carry tp={tp} "
            f"(flat layouts are TP-local: tp must divide the world)")
    data_extent = n_devices // max(tp, 1)
    if getattr(mcfg, "hbm_budget_gb", None) is not None:
        raise NotImplementedError(
            f"hbm_budget_gb={mcfg.hbm_budget_gb!r}: the re-pick under a memory budget "
            f"(resolve_scale) needs {UNPORTED_TRAIN['hbm_budget_gb'][1]}, which is not "
            "ported yet; the port re-picks by the keep rule")
    prefer = min(partition_size or data_extent, data_extent)
    p = max(d for d in range(1, prefer + 1) if data_extent % d == 0)
    info = {"rule": "keep", "carry": mcfg.prefetch_carry, "partition_size": p,
            "data_extent": data_extent, "tp": tp, "n_devices": n_devices}
    return p, info
