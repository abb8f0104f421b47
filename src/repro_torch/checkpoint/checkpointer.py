"""Checkpointing of the training state with elastic resharding (the port of
``repro/checkpoint/checkpointer.py``).

A checkpoint is a directory ``step_XXXXXXXX/`` holding one ``.npy`` file a
tensor and rank (``params``, ``m``, ``v``: one per pool, each rank's fp32
flat shards ``[stack, 1, flat_len / p]`` of its model coordinate;
``<leaf>.npy`` in a one-rank run, ``<leaf>.rank<r>.npy`` otherwise) and
``manifest.json`` (step, data cursor, topology, world size, each rank's
mesh coordinates, leaf names and shard shapes, ``emergency``).

* **Sharded save** — every rank writes its own shards into
  ``step_XXXXXXXX.tmp/`` and then a done marker; rank 0 awaits every
  rank's marker, writes and fsyncs the manifest and only then renames the
  directory into place, so a crashed save never corrupts the newest
  complete checkpoint.  :meth:`Checkpointer.latest_step` skips ``.tmp``
  directories, malformed names and directories whose manifest or any
  rank's tensors are missing or truncated.
* **Async save** (``blocking=False``) — this rank's tensors are copied to
  host memory on the calling thread before :meth:`Checkpointer.save`
  returns (AdamW updates the state in place; host-resident moments are
  read after the card is idle, since their write-backs run on a copy
  stream); a writer thread writes the files.  Its failure is held and
  re-raised from the next :meth:`Checkpointer.wait` or ``save``.  The
  writer issues no collective: a gloo group must not carry operations from
  two threads, so rank 0's writer awaits the other ranks' markers on the
  file system, within the groups' timeout.  A blocking save (emergency and
  final saves) writes one tensor at a time on the calling thread, so the
  host never holds the whole state, and ends in a barrier.
* **Fault hook** — ``fault_hook(phase, tmp_dir, meta)`` (set by
  ``core/faults.FaultPlan.bind``) runs on every rank at ``"pre_manifest"``,
  after that rank's files; raising there is a writer killed mid-save.
* **Emergency save** — a preemption notice (runtime/train_loop.py) takes a
  blocking ``save(..., emergency=True)``, tagged in the manifest.
* **Elastic resharding** — a restore may target another partition size,
  replication degree or pod count at the same tp: rank r′ rebuilds its
  ``[stack, 1, flat_len / p′]`` chunk of its model coordinate from the old
  shards of replica 0 that overlap it (by the manifest's ``rank_coords``),
  read memory-mapped, so no host holds the whole model.  m and v reshard
  like the params, whether they were saved from the card or from host
  memory (``offload_opt``), and restore onto the device or into host
  memory.  Another tp raises ``ValueError``: flat layouts are TP-local.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hostoffload import pinned_zeros
from repro_torch.core.mics import local_flat_shapes
from repro_torch.core.topology import MICS_AXES, MODEL_AXIS, MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef

MANIFEST = "manifest.json"
PARTS = ("params", "m", "v")
TP_FIXED = ("elastic restore reshards pods/partition/replication freely but the TP degree "
            "is fixed (flat layouts are TP-local)")
MARKER_POLL_S = 0.01


def _fsync(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _topology(topo: MiCSTopology) -> dict:
    return {**{ax: getattr(topo, ax) for ax in MICS_AXES},
            "partition_axes": list(topo.partition_axes),
            "replication_axes": list(topo.replication_axes)}


def _saved_topology(meta: dict) -> MiCSTopology:
    """The topology a checkpoint was written from (its manifest's)."""
    t = meta["topology"]
    return MiCSTopology(**{ax: t[ax] for ax in MICS_AXES},
                        partition_axes=tuple(t["partition_axes"]),
                        replication_axes=tuple(t["replication_axes"]))


def _leaf_file(leaf: str, rank: int, world: int) -> str:
    return f"{leaf}.npy" if world == 1 else f"{leaf}.rank{rank}.npy"


def _marker(rank: int) -> str:
    return f".done.rank{rank}"


def _barrier(groups) -> None:
    if groups is not None:
        dist.barrier(group=groups.world.handle)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._worker: threading.Thread | None = None
        self._exc: BaseException | None = None
        # fault_hook(phase, tmp_dir, meta), on every rank after its files
        # (core/faults.FaultPlan.bind); raising is a writer killed mid-save
        self.fault_hook: Callable[[str, pathlib.Path, dict], None] | None = None
        # one record a save: step, blocking, seconds the caller was blocked,
        # seconds the writing took (filled in when it ends)
        self.save_log: list[dict] = []

    # -- save ----------------------------------------------------------------
    def save(self, state: dict, step: int, *, topo: MiCSTopology, data_cursor: int = 0,
             groups=None, blocking: bool = True, emergency: bool = False) -> pathlib.Path:
        """Write this rank's ``state`` (params / m / v pool dicts and
        ``step``) into the checkpoint of ``step``; returns its directory.
        Over several ranks every rank of the world calls it, with the run's
        ``groups``.  ``blocking=False`` returns once this rank's tensors are
        in host memory; :meth:`wait` joins the writer.  ``emergency`` tags
        the manifest (a save taken on a preemption notice)."""
        t0 = time.perf_counter()
        world = topo.world_size
        if world > 1 and groups is None:
            raise ValueError(f"a {world}-rank save needs the run's MiCSGroups")
        rank = 0 if groups is None else groups.rank
        self.wait()
        tmp = self.dir / f"step_{step:08d}.tmp"
        if rank == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        _barrier(groups)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # host moments' write-backs are done
        tensors = [(f"{part}.{name}", t) for part in PARTS for name, t in state[part].items()]
        meta = {"step": int(step), "state_step": int(state["step"]),
                "data_cursor": int(data_cursor), "time": time.time(),
                "topology": _topology(topo), "world_size": world,
                "rank_coords": [topo.rank_coords(r) for r in range(world)],
                "leaves": [{"name": leaf, "shape": list(t.shape)} for leaf, t in tensors],
                "emergency": bool(emergency)}
        timeout = None if groups is None else groups.timeout.total_seconds()
        record = {"step": int(step), "blocking": blocking, "emergency": bool(emergency)}
        self.save_log.append(record)
        if blocking:
            self._write(tmp, tensors, meta, rank, timeout, record)
            _barrier(groups)
        else:
            # a copy: the step updates params, m and v in place
            tensors = [(leaf, t.detach().to("cpu", copy=True)) for leaf, t in tensors]
            self._worker = threading.Thread(
                target=self._write_guarded, args=(tmp, tensors, meta, rank, timeout, record),
                daemon=True)
            self._worker.start()
        record["blocked_s"] = time.perf_counter() - t0
        return self.dir / f"step_{step:08d}"

    def wait(self) -> None:
        """Join the in-flight save; re-raise its failure, if any (once)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 - held for wait()
            self._exc = e

    def _write(self, tmp: pathlib.Path, tensors: list, meta: dict, rank: int,
               timeout: float | None, record: dict) -> None:
        """This rank's files, the fault hook, its done marker; on rank 0,
        the other ranks' markers, then the manifest and the rename."""
        t0 = time.perf_counter()
        world = meta["world_size"]
        for leaf, t in tensors:
            np.save(tmp / _leaf_file(leaf, rank, world), _host(t))
        if self.fault_hook is not None:
            # this rank's tensors are on disk, the manifest is not: the
            # mid-save kill window the atomicity contract is tested against
            self.fault_hook("pre_manifest", tmp, {**meta, "rank": rank})
        (tmp / _marker(rank)).touch()
        if rank == 0:
            deadline = None if timeout is None else time.monotonic() + timeout
            for r in range(1, world):
                while not (tmp / _marker(r)).exists():
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"rank {r} did not finish its part of checkpoint "
                                           f"{tmp.name} within {timeout} s")
                    time.sleep(MARKER_POLL_S)
            for r in range(world):
                (tmp / _marker(r)).unlink()
            mpath = tmp / MANIFEST
            mpath.write_text(json.dumps(meta, indent=1))
            _fsync(mpath)
            final = self.dir / tmp.name[:-len(".tmp")]
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        record["writer_s"] = time.perf_counter() - t0

    # -- the newest complete checkpoint ------------------------------------------
    def _complete(self, path: pathlib.Path) -> bool:
        """True iff ``path`` is a fully written ``step_<N>`` directory."""
        if path.name.endswith(".tmp") or not path.name[len("step_"):].isdigit():
            return False
        try:
            meta = json.loads((path / MANIFEST).read_text())
        except (OSError, ValueError):
            return False   # missing or truncated manifest (crashed writer)
        world = meta.get("world_size", 1)
        for leaf in meta.get("leaves", []):
            for rank in range(world):
                f = path / _leaf_file(leaf["name"], rank, world)
                if not f.exists():
                    return False
                try:
                    arr = np.load(f, mmap_mode="r")
                except (OSError, ValueError):
                    return False
                if list(arr.shape) != leaf["shape"]:
                    return False
        return True

    def latest_step(self, groups=None) -> int | None:
        """Newest complete checkpoint step, or None.  With ``groups``, every
        rank of the world calls it after its :meth:`wait` and gets rank 0's
        answer (rank 0's writer renames the directory last), so every rank
        restores the same step."""
        if groups is not None and groups.world.size > 1:
            box = [self.latest_step() if groups.rank == 0 else None]
            dist.broadcast_object_list(box, src=groups.world.ranks[0],
                                       group=groups.world.handle)
            return box[0]
        steps = sorted(int(p.name[len("step_"):]) for p in self.dir.glob("step_*")
                       if self._complete(p))
        return steps[-1] if steps else None

    # -- restore -----------------------------------------------------------------
    def restore(self, model: ModelDef, step: int | None = None, *,
                topo: MiCSTopology = MiCSTopology(), rank: int = 0,
                device: str | torch.device = "cuda",
                offload_opt: bool = False) -> tuple[dict, dict]:
        """Load ``rank``'s shards of a checkpoint onto ``device`` at ``topo``
        (m and v into host memory with ``offload_opt``, pinned for a card);
        returns ``(state, meta)``.  ``topo`` may have another partition
        size, replication degree or pod count than the checkpoint
        (``meta["topology"]`` is the saved one); another tp or other pool
        shapes raise ``ValueError``, a missing or incomplete checkpoint
        ``FileNotFoundError``."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        if not self._complete(path):
            raise FileNotFoundError(f"checkpoint {path} is missing or incomplete "
                                    f"(newest complete step: {self.latest_step()})")
        meta = json.loads((path / MANIFEST).read_text())
        saved = _saved_topology(meta)
        if saved.model_size != topo.model_size or model.tp != topo.model_size:
            raise ValueError(f"checkpoint at tp = {saved.model_size}, restore at tp = "
                             f"{topo.model_size} (model tp = {model.tp}): {TP_FIXED}")
        want = model.global_flat_shapes()
        got = {leaf["name"]: tuple(leaf["shape"]) for leaf in meta["leaves"]}
        for part in PARTS:
            for name, (stack, _, flat) in want.items():
                shape = got.get(f"{part}.{name}")
                full = None if shape is None else (shape[0], 1,
                                                   shape[2] * saved.partition_size)
                if full != (stack, 1, flat):
                    raise ValueError(f"leaf shape mismatch {part}.{name}: {shape} a rank at "
                                     f"p = {saved.partition_size} vs the model's "
                                     f"{(stack, 1, flat)}: {TP_FIXED}")
        sources = _sources(meta, saved, topo.rank_coords(rank)[MODEL_AXIS])
        coord = topo.partition_coord(rank)
        state: dict = {}
        for part in PARTS:
            state[part] = {}
            for name, (stack, _, shard) in local_flat_shapes(model, topo).items():
                host = _read_chunk(path, f"{part}.{name}", sources, saved.world_size,
                                   coord * shard, shard, stack)
                t = torch.from_numpy(host)
                if offload_opt and part != "params":
                    state[part][name] = pinned_zeros(t.shape, torch.float32, dev).copy_(t)
                else:
                    state[part][name] = t.to(dev)
        state["step"] = int(meta["state_step"])
        return state, meta


def _sources(meta: dict, saved: MiCSTopology, model_coord: int) -> list[tuple[int, int]]:
    """``(partition coordinate, rank)`` of the saved ranks of replica 0 at
    ``model_coord``, by the manifest's ``rank_coords``, in coordinate order."""
    out = []
    for r, coords in enumerate(meta["rank_coords"]):
        if coords[MODEL_AXIS] != model_coord or any(
                coords[ax] for ax in saved.replication_axes):
            continue
        idx = 0
        for ax in saved.partition_axes:
            idx = idx * getattr(saved, ax) + coords[ax]
        out.append((idx, r))
    return sorted(out)


def _read_chunk(path: pathlib.Path, leaf: str, sources: list, world: int, lo: int, n: int,
                stack: int) -> np.ndarray:
    """Elements ``[lo, lo + n)`` of the leaf's full row, ``[stack, 1, n]``
    fp32, from the saved shards that overlap them (memory-mapped)."""
    out = np.empty((stack, 1, n), np.float32)
    filled = 0
    for idx, r in sources:
        arr = np.load(path / _leaf_file(leaf, r, world), mmap_mode="r")
        if arr.dtype != np.float32:
            raise ValueError(f"{leaf}: {arr.dtype} in the checkpoint, want float32")
        k = arr.shape[-1]
        a, b = max(lo, idx * k), min(lo + n, (idx + 1) * k)
        if a < b:
            out[..., a - lo:b - lo] = arr[..., a - idx * k:b - idx * k]
            filled += b - a
    if filled != n:
        raise ValueError(f"{leaf}: the checkpoint's shards cover {filled} of the {n} "
                         f"elements at [{lo}, {lo + n})")
    return out
