"""A rank's step counted op by op: the roofline's inputs (the counterpart of
``repro/roofline/hlo_stats.py``, which reads them off XLA's optimized HLO).

The port runs eagerly, so a step's work is the ops it dispatches.  Inside
:class:`OpCounter`:

* ``dot_flops`` — the matrix products' operations, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them (2 M N K a
  product; elementwise work is left out, as the reference leaves it out),
  plus what each hand-written kernel's wrapper reports for its launch
  (``kernels/build.report``: its ``ctypes`` call is invisible to a dispatch
  mode; flash attention's 4 dh a visible (query, key) pair and head, 10 dh
  backward);
* ``hbm_bytes`` — every op that is not a view reads each input once and
  writes each output once (eager fuses nothing), the kernels' reported
  bytes, and each collective's input and output;
* ``ici_wire_bytes`` / ``dci_wire_bytes`` — the ``CommCounter``'s bytes a
  stage at the ring's ``(g - 1) / g`` (twice that for an all-reduce), split
  by the link profile's tier of the stage's group
  (``LinkProfile.group_tier`` over its global ranks): ``ici`` the fast tier
  within a node, ``dci`` the slow one across nodes (the reference's names);
  ``by_stage`` the same by the census's stage labels
  (``core/autotune.census_from_counter``) and, for the model and data axes,
  by ``kind:stage``.

On fake tensors (``FakeTensorMode``) the same counts come from shapes
alone; on the CPU the kernels' plain versions run and are counted as the
ops they are.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import build as K

# Ops that move no bytes beyond their operands' metadata (besides views and
# the ``prim`` namespace's queries, such as a fake tensor's device).
_FREE = {"detach", "lift_fresh", "alias", "_to_copy_meta", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_",
         "_local_scalar_dense", "record_stream", "is_pinned", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}


def _nbytes(x) -> int:
    flat, _ = tree_flatten(x)
    return sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Each non-view op's input and output bytes, and the count of such ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.rpartition("::")
        if not (getattr(func, "is_view", False) or name in _FREE or ns == "prim"):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


@dataclasses.dataclass
class KernelWork:
    """What the hand-written kernels' wrappers reported."""

    launches: dict = dataclasses.field(default_factory=dict)
    dot_flops: float = 0.0
    nbytes: float = 0.0

    def __call__(self, kernel: str, dot_flops: float, nbytes: float) -> None:
        self.launches[kernel] = self.launches.get(kernel, 0) + 1
        self.dot_flops += dot_flops
        self.nbytes += nbytes


class OpCounter:
    """``with OpCounter() as oc: step(...)``: the step's products, bytes and
    kernel reports (:func:`step_stats` adds the collectives)."""

    def __enter__(self):
        self.flops = FlopCounterMode(display=False)
        self.bytes = _BytesMode()
        self.kernels = KernelWork()
        K.LISTENERS.append(self.kernels)
        self.flops.__enter__()
        self.bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self.bytes.__exit__(*exc)
        self.flops.__exit__(*exc)
        K.LISTENERS.remove(self.kernels)

    @property
    def dot_flops(self) -> float:
        return float(self.flops.get_total_flops()) + self.kernels.dot_flops

    @property
    def hbm_bytes(self) -> float:
        return float(self.bytes.bytes) + self.kernels.nbytes


_RING = {"all_gather": 1.0, "reduce_scatter": 1.0, "all_to_all": 1.0, "all_reduce": 2.0,
         "all_reduce_max": 2.0, "all_reduce_min": 2.0}


def wire_stats(snapshot: dict, groups, topo, gather, profile) -> dict:
    """The ``CommCounter`` ``snapshot`` of one step:
    ``ici_wire_bytes`` / ``dci_wire_bytes`` (the profile's intra / inter
    tier of each stage's group), ``hbm_bytes`` (each collective's input and
    output: its buffer, and the shard or the same buffer again),
    ``n_collectives``, ``by_collective`` (``kind:stage``: calls, wire bytes,
    group size, tier) and ``by_stage`` (the census's labels for the stages
    the ``CommEngine`` owns, ``kind:stage`` for the others)."""
    from repro_torch.core.autotune import census_from_counter

    by_coll, ici, dci, hbm, calls = {}, 0.0, 0.0, 0.0, 0.0
    for key, n in snapshot["calls"].items():
        kind, stage = key.split(":", 1)
        group = _group_of(groups, stage)
        g = group.size if group is not None else 1
        buf = float(snapshot["bytes"][key])
        wire = buf * (g - 1) / g * _RING.get(kind, 1.0) if g > 1 else 0.0
        tier = profile.group_tier(group.ranks) if group is not None else "intra"
        if tier == "intra":
            ici += wire
        else:
            dci += wire
        shard = buf / g if kind in ("all_gather", "reduce_scatter") else buf
        hbm += buf + shard
        calls += n
        by_coll[key] = {"count": n, "wire_bytes": wire, "group_size": g, "tier": tier}
    by_stage = census_from_counter(snapshot, topo, gather)
    owned = {f"{kind}:{stage}" for kind in ("all_gather", "reduce_scatter", "all_to_all",
                                            "all_reduce")
             for stage in ("partition", "outer", "inner", "replication")}
    for key, e in by_coll.items():
        if key not in owned and not key.split(":", 1)[1].startswith("axis:"):
            by_stage[key] = {"wire_bytes": e["wire_bytes"], "count": e["count"],
                             "group_size": e["group_size"]}
    return {"ici_wire_bytes": ici, "dci_wire_bytes": dci, "total_wire_bytes": ici + dci,
            "collective_hbm_bytes": hbm, "n_collectives": calls,
            "by_collective": dict(sorted(by_coll.items())),
            "by_stage": dict(sorted(by_stage.items()))}


def _group_of(groups, stage: str):
    """The ``launch/mesh.MiCSGroups`` group a ``CommCounter`` stage names."""
    if groups is None:
        return None
    if stage.startswith("axis:"):
        return groups.axis.get(stage.split(":", 1)[1])
    if stage == "outer":
        return groups.outer_group
    if stage == "inner":
        return groups.inner_group
    if stage == "kv":
        kv = [g for g in groups._kv.values()]
        return kv[0] if len(kv) == 1 else None
    return getattr(groups, stage, None)


def step_stats(counter: OpCounter, snapshot: dict, groups, topo, gather, profile) -> dict:
    """The record's ``stats`` of one step: its ``dot_flops`` and ``hbm_bytes``
    (the ops', the kernels' and the collectives'), the wire bytes by tier
    and stage (:func:`wire_stats`), the kernels' launches, and
    ``boundary``: the hop-2 collectives (the bucket plan's evidence)."""
    wires = wire_stats(snapshot, groups, topo, gather, profile)
    return {"dot_flops": counter.dot_flops,
            "hbm_bytes": counter.hbm_bytes + wires.pop("collective_hbm_bytes"),
            "op_count": counter.bytes.ops,
            "kernel_launches": dict(counter.kernels.launches),
            "kernel_dot_flops": counter.kernels.dot_flops,
            **wires,
            "boundary": {"hop2_ops": wires["by_stage"].get("hop2", {}).get("count", 0.0)}}
