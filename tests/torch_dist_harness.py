"""The port's side of the 4-rank tests: one gloo world of 4 CPU processes
runs every case of ``torch_dist_cases.py`` and each rank writes its results
to ``<out>/port_<mode>.rank<r>.npz``.

    python tests/torch_dist_harness.py collectives|train OUT_DIR [cpu|cuda]

``train`` starts from the JAX package's initial state, which it reads from
``OUT_DIR/jax_init.npz`` (``jax_dist_oracle.py init OUT_DIR``).  An optional
third argument puts the ``collectives`` tensors on ``cuda`` (the ranks then
share the card; gloo carries them through pinned host buffers).

The ranks meet through a ``FileStore`` in ``OUT_DIR`` (no port to pick, so
parallel test workers do not collide), run one thread each, and give every
process group a 60 s timeout, so a hang fails instead of stalling.  A rank
that raises makes ``torch.multiprocessing.spawn`` raise, and the script
exits non-zero.
"""

import datetime
import os
import pathlib
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

import torch_dist_cases as K

TIMEOUT = datetime.timedelta(seconds=60)
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _topology(layout: str):
    from repro_torch.core.topology import MiCSTopology

    (pod, repl, shard, dp2), part, rep = K.LAYOUTS[layout]
    return MiCSTopology(pod=pod, repl=repl, shard=shard, dp2=dp2, partition_axes=part,
                        replication_axes=rep)


class World:
    """This rank's MiCSGroups, one a (layout, inner), built on first use:
    every rank asks for them in the same order."""

    def __init__(self, rank: int):
        self.rank, self._groups = rank, {}

    def groups(self, layout: str, inner: int | None = None):
        from repro_torch.launch.mesh import MiCSGroups

        key = (layout, inner)
        if key not in self._groups:
            self._groups[key] = MiCSGroups(_topology(layout), self.rank, backend="gloo",
                                           timeout=TIMEOUT, inner=inner)
        return self._groups[key]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def collectives(world: World, device: str) -> dict:
    from repro_torch.core import collectives as C

    r, out = world.rank, {}
    for name, (lay, topo_name, inner, _, axis) in K.GATHERS.items():
        topo, g = _topology(lay), world.groups(lay, inner)
        x = torch.from_numpy(K.gather_input(name)[r]).to(device)
        if topo_name == "flat":
            full = C.flat_all_gather(x, g.partition, axis=axis)
        else:
            full = C.hierarchical_all_gather(x, topo, g, axis=axis, order=topo_name, inner=inner)
        out[name] = _np(full)
    for name, (lay, topo_name, inner, dt) in K.REDUCE_SCATTERS.items():
        topo, g = _topology(lay), world.groups(lay, inner)
        ct = torch.from_numpy(K.full_input(name)[r]).to(device, TDT[dt])
        if topo_name == "flat":
            shard = C.hop1_reduce_scatter(ct, topo, g)
        else:
            shard = C.hierarchical_reduce_scatter(ct, topo, g, order=topo_name, inner=inner)
        assert shard.dtype == TDT[dt]      # in the cotangent's own dtype
        out[name] = _np(shard)
        again = (C.hop1_reduce_scatter(ct, topo, g) if topo_name == "flat" else
                 C.hierarchical_reduce_scatter(ct, topo, g, order=topo_name, inner=inner))
        out[name + ".again"] = _np(again)
    for name, (kind, lay) in K.SYNCS.items():
        topo, g = _topology(lay), world.groups(lay)
        v = torch.from_numpy(K.full_input(name)[r]).to(device)
        if kind == "hop2":
            w = C.hop2_all_reduce(v, topo, g, async_op=True)
            w.wait()
            out[name] = _np(v)
        else:
            out[name] = _np(C.alternative_sync(v, topo, g))
    # the CommEngine's gather, its counter and its adjoint through autograd
    from repro_torch.core.comm import CommEngine, GatherPolicy

    topo, g = _topology("A"), world.groups("A", 2)
    row = torch.from_numpy(K.full_input("engine")[r]).to(device).requires_grad_(True)
    for topo_name in ("flat", "inner_first", "outer_first"):
        eng = CommEngine(topo, GatherPolicy(topology=topo_name, wire_dtype="fp32", inner=2),
                         groups=g)
        full = eng.gather_flat(row)
        ct = torch.from_numpy(K.full_input("engine_ct", 4 * K.RS_LEN)[r]).to(device)
        (grad,) = torch.autograd.grad(full, row, ct)
        out[f"engine.{topo_name}.full"] = _np(full)
        out[f"engine.{topo_name}.grad"] = _np(grad)
        snap = eng.counter.snapshot()
        out[f"engine.{topo_name}.calls"] = np.asarray(
            [snap["calls"].get(f"{k}:{s}", 0) for k in ("all_gather", "reduce_scatter")
             for s in ("partition", "outer", "inner")])
    return out


def _train_run(world: World, name: str, init: dict, *, device: str = "cpu", **mcfg_kw):
    """STEPS steps of case ``name`` from the JAX initial state (this rank's
    shards), each rank on its data slice; ``mcfg_kw`` overrides."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import shard_from_jax
    from repro_torch.core.mics import MiCSConfig, build_train_step
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    lay, order, inner, wire = K.TRAINS[name]
    topo, g = _topology(lay), world.groups(lay, inner)
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    state = shard_from_jax(model, topo, world.rank, init, device=device)
    mc = MiCSConfig(micro_steps=K.MICRO, gather_dtype=TDT[wire], gather_order=order,
                    hierarchy_inner=inner, **mcfg_kw)
    step = build_train_step(model, topo, mc, OptConfig(**K.OPT), device=device, groups=g)
    dr, metrics = topo.data_rank(world.rank), []
    for b in K.train_batches():
        state, m = step(state, K.data_slice(b, dr, topo.data_parallel_size))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    out = {"metrics": np.asarray(metrics, np.float64)}
    for part in ("params", "m", "v"):
        for k, v in state[part].items():
            out[f"{part}.{k}"] = _np(v)
    return out


def _prefixed(prefix: str, d: dict) -> dict:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _loop(world: World, ckdir: pathlib.Path, total: int, family: str = "llama3.2-1b",
          layout: str = "B"):
    """``runtime/train_loop.train`` at ``layout`` (seeded init, synthetic
    stream) to ``total`` steps, checkpointing every step."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import LoopConfig, train

    cfg = smoke_variant(get_config(family))
    model = build_model(cfg, tp=1)
    dc = DataConfig(vocab=cfg.vocab, seq=K.SEQ, global_batch=K.MICRO * K.GLOBAL_B,
                    micro_steps=K.MICRO)
    lc = LoopConfig(total_steps=total, checkpoint_every=1, checkpoint_dir=str(ckdir),
                    log_every=0)
    oc = OptConfig(**K.OPT)
    stats = train(model, _topology(layout), MiCSConfig(micro_steps=K.MICRO), oc, dc, lc,
                  device="cpu", groups=world.groups(layout))
    return np.asarray(list(zip(stats.losses, stats.grad_norms)), np.float64)


def train(world: World, out_dir: pathlib.Path) -> dict:
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.build import build_model

    init_npz = np.load(out_dir / "jax_init.npz")
    init = {part: {k.split(".", 2)[2]: init_npz[k] for k in init_npz.files
                   if k.startswith(f"init.{part}.")} for part in ("params", "m", "v")}
    init["step"] = 0
    out = {}
    for name in K.TRAINS:
        out.update(_prefixed(name, _train_run(world, name, init)))
    # bitwise within the port: serial == prefetch at p 4, a repeated step,
    # serial == bucketed (many buckets) at 2 replicas
    out.update(_prefixed("A:bf16.serial", _train_run(world, "A:bf16", init, prefetch=False)))
    out.update(_prefixed("A:bf16.again", _train_run(world, "A:bf16", init)))
    for sched in ("serial", "bucketed"):
        out.update(_prefixed(f"B:bf16.{sched}", _train_run(
            world, "B:bf16", init, boundary_schedule=sched, hop2_bucket_mb=0.01)))
    # the Fig-14 ablation: the full gradient all-reduced over every data
    # rank each micro-step, hop 2 skipped
    out.update(_prefixed("B:fp32.allreduce_slice", _train_run(
        world, "B:fp32", init, sync_mode="allreduce_slice")))
    # the loop at layout B: a run resumed from its step-1 checkpoint against
    # the uninterrupted one, and the checkpoint read back
    shared = out_dir / "ck"
    out["loop.whole"] = _loop(world, shared / "whole", 3)
    first = _loop(world, shared / "cut", 1)
    rest = _loop(world, shared / "cut", 3)
    out["loop.cut"] = np.concatenate([first, rest])
    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    topo = _topology("B")
    a, _ = Checkpointer(shared / "whole").restore(model, topo=topo, rank=world.rank,
                                                  device="cpu")
    b, meta = Checkpointer(shared / "cut").restore(model, topo=topo, rank=world.rank,
                                                   device="cpu")
    out["loop.restored_equal"] = np.asarray(all(
        torch.equal(a[p][k], b[p][k]) for p in ("params", "m", "v") for k in a[p]))
    out["loop.meta"] = np.asarray([meta["step"], meta["data_cursor"], meta["world_size"]])
    out["loop.files"] = np.asarray(len(list((shared / "whole" / "step_00000003").glob(
        "*.npy"))))
    # a griffin step at layout A (seeded init) against the same step at p = 1
    out["griffin"] = _loop(world, shared / "griffin", 1, "recurrentgemma-2b", "A")
    return out


def _rank_main(rank: int, mode: str, out_dir: pathlib.Path, device: str):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(K.WORLD), LOCAL_RANK=str(rank))
    from repro_torch.launch.mesh import init_distributed

    init_distributed("gloo", timeout=TIMEOUT, init_method=f"file://{out_dir / 'store'}")
    world = World(rank)
    res = collectives(world, device) if mode == "collectives" else train(world, out_dir)
    np.savez(out_dir / f"port_{mode}.rank{rank}.npz", **res)
    import torch.distributed as dist

    dist.destroy_process_group()


def main():
    mode, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    mp.spawn(_rank_main, args=(mode, out_dir, device), nprocs=K.WORLD, join=True)


if __name__ == "__main__":
    main()
