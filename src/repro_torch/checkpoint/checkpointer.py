"""Checkpointing of the training state (the port of the save / restore
half of ``repro/checkpoint/checkpointer.py``).

A checkpoint is a directory ``step_XXXXXXXX/`` holding one ``.npy`` file a
tensor and rank (``params``, ``m``, ``v``: one per pool, each rank's fp32
flat shards ``[stack, 1, flat_len / p]`` of its model coordinate;
``<leaf>.npy`` in a one-rank run, ``<leaf>.rank<r>.npy`` otherwise) and
``manifest.json`` (step, data cursor, topology, world size, each rank's
mesh coordinates, leaf names and shard shapes).  Every rank
writes its own shards into ``step_XXXXXXXX.tmp/``; after a barrier rank 0
writes and fsyncs the manifest and only then renames the directory into
place, so a crashed save never corrupts the newest complete checkpoint.
:meth:`Checkpointer.latest_step` skips ``.tmp`` directories, malformed
names and directories whose manifest or any rank's tensors are missing or
truncated.  Tensors are copied to the host one at a
time, so the host never holds the whole state.  Host-resident moments
(``offload_opt``) are saved from their host tensors into the same files,
after the card is idle (their last write-back runs on a copy stream); a
restore puts m and v on the device or, with ``offload_opt``, into pinned
host memory, whichever way the checkpoint was written.

A restore reads this rank's shards onto the same topology (the same p,
replicas and tp).  The fault-injection hook, asynchronous saves and
restores onto another topology (another tp too) come with the elastic
slice (ROADMAP Queue 1 item 5, the elastic and fault-tolerant loop).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hostoffload import pinned_zeros
from repro_torch.core.mics import local_flat_shapes
from repro_torch.core.topology import MICS_AXES, MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.lm import ModelDef

MANIFEST = "manifest.json"
PARTS = ("params", "m", "v")


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


def _leaf_file(leaf: str, rank: int, world: int) -> str:
    return f"{leaf}.npy" if world == 1 else f"{leaf}.rank{rank}.npy"


def _barrier(groups) -> None:
    if groups is not None:
        dist.barrier(group=groups.world.handle)


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, state: dict, step: int, *, topo: MiCSTopology, data_cursor: int = 0,
             groups=None) -> pathlib.Path:
        """Write this rank's ``state`` (params / m / v pool dicts and
        ``step``) into the checkpoint of ``step``; returns its directory.
        Over several ranks every rank calls it, with the run's ``groups``."""
        world = topo.world_size
        if world > 1 and groups is None:
            raise ValueError(f"a {world}-rank save needs the run's MiCSGroups")
        rank = 0 if groups is None else groups.rank
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if rank == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        _barrier(groups)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # host moments' write-backs are done
        leaves = []
        for part in PARTS:
            for name, t in state[part].items():
                leaf = f"{part}.{name}"
                np.save(tmp / _leaf_file(leaf, rank, world), t.detach().cpu().numpy())
                leaves.append({"name": leaf, "shape": list(t.shape)})
        _barrier(groups)
        if rank == 0:
            meta = {"step": int(step), "state_step": int(state["step"]),
                    "data_cursor": int(data_cursor), "time": time.time(),
                    "topology": _topology(topo), "world_size": world,
                    "rank_coords": [topo.rank_coords(r) for r in range(world)],
                    "leaves": leaves}
            mpath = tmp / MANIFEST
            mpath.write_text(json.dumps(meta, indent=1))
            _fsync(mpath)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
        _barrier(groups)
        return final

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

    def latest_step(self) -> int | None:
        """Newest complete checkpoint step, or None."""
        steps = sorted(int(p.name[len("step_"):]) for p in self.dir.glob("step_*")
                       if self._complete(p))
        return steps[-1] if steps else None

    def restore(self, model: ModelDef, step: int | None = None, *,
                topo: MiCSTopology = MiCSTopology(), rank: int = 0,
                device: str | torch.device = "cuda",
                offload_opt: bool = False) -> tuple[dict, dict]:
        """Load ``rank``'s shards of a checkpoint onto ``device`` (m and v
        into host memory with ``offload_opt``, pinned for a card); returns
        ``(state, meta)``.  Raises if it is missing, incomplete, of another
        topology or of other pool shapes."""
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
        here = _topology(topo)
        if meta["topology"] != here or meta.get("world_size", 1) != topo.world_size:
            raise NotImplementedError(
                f"checkpoint topology {meta['topology']} != {here}: restores onto "
                "another topology (another p, replication or tp) come with the elastic "
                "slice (ROADMAP Queue 1 item 5, the elastic and fault-tolerant loop)")
        shapes = local_flat_shapes(model, topo)
        state: dict = {}
        for part in PARTS:
            state[part] = {}
            for name, shape in shapes.items():
                arr = np.load(path / _leaf_file(f"{part}.{name}", rank, topo.world_size))
                if arr.shape != shape or arr.dtype != np.float32:
                    raise ValueError(f"{part}.{name}: {arr.dtype} {arr.shape} in the "
                                     f"checkpoint, the model needs float32 {shape}")
                t = torch.from_numpy(arr)
                if offload_opt and part != "params":
                    state[part][name] = pinned_zeros(shape, torch.float32, dev).copy_(t)
                else:
                    state[part][name] = t.to(dev)
        state["step"] = int(meta["state_step"])
        return state, meta
