"""Checkpointing of the training state (the port of the save / restore
half of ``repro/checkpoint/checkpointer.py``).

A checkpoint is a directory ``step_XXXXXXXX/`` holding one ``.npy`` file a
tensor (``params``, ``m``, ``v``: one per pool, the global fp32 flat
arrays) and ``manifest.json`` (step, data cursor, topology, leaf names).
Writes go to ``step_XXXXXXXX.tmp/``; the manifest is fsync'd and the
directory renamed into place only then, so a crashed save never corrupts
the newest complete checkpoint.  :meth:`Checkpointer.latest_step` skips
``.tmp`` directories, malformed names and directories whose manifest or
tensors are missing or truncated.  Tensors are copied to the host one at a
time, so the host never holds the whole state.

The fault-injection hook, asynchronous saves and restores onto another
topology come with the elastic slice (ROADMAP Queue 1 item 5, the elastic and
fault-tolerant loop).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time

import numpy as np
import torch

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


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, state: dict, step: int, *, topo: MiCSTopology, data_cursor: int = 0) -> pathlib.Path:
        """Write ``state`` (params / m / v pool dicts and ``step``) as the
        checkpoint of ``step``; returns its directory."""
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        leaves = []
        for part in PARTS:
            for name, t in state[part].items():
                leaf = f"{part}.{name}"
                np.save(tmp / f"{leaf}.npy", t.detach().cpu().numpy())
                leaves.append({"name": leaf, "shape": list(t.shape)})
        meta = {"step": int(step), "state_step": int(state["step"]),
                "data_cursor": int(data_cursor), "time": time.time(),
                "topology": {ax: getattr(topo, ax) for ax in MICS_AXES}, "leaves": leaves}
        mpath = tmp / MANIFEST
        mpath.write_text(json.dumps(meta, indent=1))
        _fsync(mpath)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return final

    def _complete(self, path: pathlib.Path) -> bool:
        """True iff ``path`` is a fully written ``step_<N>`` directory."""
        if path.name.endswith(".tmp") or not path.name[len("step_"):].isdigit():
            return False
        try:
            meta = json.loads((path / MANIFEST).read_text())
        except (OSError, ValueError):
            return False   # missing or truncated manifest (crashed writer)
        for leaf in meta.get("leaves", []):
            f = path / f"{leaf['name']}.npy"
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
                topo: MiCSTopology = MiCSTopology(),
                device: str | torch.device = "cuda") -> tuple[dict, dict]:
        """Load a checkpoint onto ``device``; returns ``(state, meta)``.
        Raises if it is missing, incomplete, of another topology or of
        other pool shapes."""
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
        here = {ax: getattr(topo, ax) for ax in MICS_AXES}
        if meta["topology"] != here:
            raise NotImplementedError(
                f"checkpoint topology {meta['topology']} != {here}: restores onto "
                "another topology come with the elastic slice (ROADMAP Queue 1 item 5, the "
                "elastic and fault-tolerant loop)")
        shapes = model.global_flat_shapes()
        state: dict = {}
        for part in PARTS:
            state[part] = {}
            for name, shape in shapes.items():
                arr = np.load(path / f"{part}.{name}.npy")
                if arr.shape != shape or arr.dtype != np.float32:
                    raise ValueError(f"{part}.{name}: {arr.dtype} {arr.shape} in the "
                                     f"checkpoint, the model needs float32 {shape}")
                state[part][name] = torch.from_numpy(arr).to(dev)
        state["step"] = int(meta["state_step"])
        return state, meta
