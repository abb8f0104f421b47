"""The port's side of the 4-rank tests: one gloo world of 4 CPU processes
runs every case of ``torch_dist_cases.py`` and each rank writes its results
to ``<out>/port_<mode>.rank<r>.npz``.

    python tests/torch_dist_harness.py \
        collectives|train|tp_layers|tp_train|knobs|elastic|elastic_offload|serve OUT_DIR [cpu|cuda]

``train`` and ``elastic`` start from the JAX package's initial state, which
they read from ``OUT_DIR/jax_init.npz`` (``jax_dist_oracle.py init
OUT_DIR``).  An optional
third argument puts the ``collectives`` tensors, or the ``elastic_offload``
runs, on ``cuda`` (the ranks then share the card; gloo carries the tensors
through pinned host buffers).

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

    return MiCSTopology(**K.topo_kwargs(layout))


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
    out.update(_wire_collectives(world, device))
    return out


def _wire_collectives(world: World, device: str) -> dict:
    """The int8 and bf16 wires' collectives (``K.QWIRES``, grid data, hop 2
    at B) and one int8 gather with its int8 adjoint through the engine."""
    import json

    from repro_torch.core import collectives as C
    from repro_torch.core.comm import CommEngine, GatherPolicy, SyncPolicy

    r, out = world.rank, {}
    for name, (lay, topo_name, inner) in K.QWIRES.items():
        topo, g = _topology(lay), world.groups(lay, inner)
        eng = CommEngine(topo, GatherPolicy(topology=topo_name, wire_dtype="int8", inner=inner),
                         groups=g)
        row = torch.from_numpy(K.full_input("qgather:" + lay, K.QLEN)[r]).to(device)
        full = eng.gather_flat(row)
        assert full.dtype == torch.bfloat16
        out[f"qgather:{name}"] = _np(full)
        ct = torch.from_numpy(K.full_input("qrs:" + lay, K.QRS_LEN)[r]).to(device)
        kw = dict(topology=topo_name, inner=inner)
        out[f"qrs:{name}"] = _np(C.quantized_reduce_scatter(ct, topo, g, stochastic=False, **kw))
        grid = torch.from_numpy(K.grid_input()[r]).to(device)
        out[f"qgrid:{name}"] = _np(C.quantized_reduce_scatter(grid, topo, g, **kw))
        out[f"qgrid_seeded:{name}"] = _np(C.quantized_reduce_scatter(grid, topo, g, seed=3,
                                                                     **kw))
    topo, g = _topology("B"), world.groups("B")
    v = torch.from_numpy(K.full_input("qar", K.QAR_LEN)[r]).to(device)
    out["qar"] = _np(C.quantized_all_reduce(v, topo, g, stochastic=False))
    w = v.clone()
    C.quantized_all_reduce(w, topo, g, stochastic=False, out=w, async_op=True).wait()
    out["qar.async"] = _np(w)
    eng = CommEngine(topo, sync_policy=SyncPolicy(hop2_wire_dtype="bf16"), groups=g)
    out["hop2_bf16"] = _np(eng.hop2_(v.clone()))
    w = v.clone()
    eng.hop2_(w, async_op=True).wait()
    out["hop2_bf16.async"] = _np(w)
    # one qwZ gather and its qgZ adjoint (nearest) at A outer_first, counted
    topo, g = _topology("A"), world.groups("A", 2)
    eng = CommEngine(topo, GatherPolicy(topology="outer_first", wire_dtype="int8", inner=2),
                     SyncPolicy(hop1_wire_dtype="int8", grad_rounding="nearest"), groups=g)
    row = torch.from_numpy(K.full_input("qgather:A", K.QLEN)[r]).to(device).requires_grad_(True)
    full = eng.gather_flat(row)
    ct = torch.from_numpy(K.full_input("qengine_ct", 4 * K.QLEN)[r]).to(device, torch.bfloat16)
    (grad,) = torch.autograd.grad(full, row, ct)
    out["qengine.grad"] = _np(grad)
    snap = eng.counter.snapshot()
    out["qengine.calls"] = np.asarray(json.dumps(snap["calls"]))
    out["qengine.bytes"] = np.asarray(json.dumps(snap["bytes"]))
    return out


def _train_run(world: World, name: str, init: dict, *, device: str = "cpu",
               batches=None, **mcfg_kw):
    """The steps of case ``name`` (``K.TRAINS``) on ``batches`` (default
    ``K.train_batches()``) from the JAX initial state (this rank's shards),
    each rank on its data slice; ``mcfg_kw`` overrides.  ``calls``: the
    step's collective counts over the run (JSON)."""
    import json

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
    for b in K.train_batches() if batches is None else batches:
        state, m = step(state, K.data_slice(b, dr, topo.data_parallel_size))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    snap = step.comm.counter.snapshot()
    out = {"metrics": np.asarray(metrics, np.float64),
           "calls": np.asarray(json.dumps(snap["calls"])),
           "bytes": np.asarray(json.dumps(snap["bytes"]))}
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
    # the wires: against the JAX package (nearest rounding), the port
    # against itself, and the stochastic wires over more steps
    for cases, batches in ((K.WIRE_JAX, None), (K.WIRE_PORT, None),
                           (K.WIRE_LONG, K.wire_batches(K.WIRE_STEPS))):
        for name, (lay, _, _, kw) in cases.items():
            out.update(_prefixed(name, _train_run(world, f"{lay}:bf16", init, batches=batches,
                                                  **kw)))
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


def _leaf(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).requires_grad_(True)


def tp_layers(world: World) -> dict:
    """Each case of ``K.TP_LAYER_CASES`` at tp 4 on this rank's inputs, its
    gradients through autograd with the rank's cotangent, and the
    ``CommEngine``'s count of calls a case (``<case>.calls``, JSON); the
    bf16 cases twice (``<case>.again.*``); this rank's model and KV groups
    at tp 4 and p 2 x tp 2 (``groups.<layout>.<name>``)."""
    import json

    from repro_torch.core.comm import CommEngine

    groups = world.groups("T4")
    eng = CommEngine(_topology("T4"), groups=groups)
    out = {"groups.T4.model": np.asarray(groups.model.ranks),
           "groups.T4.kv2": np.asarray(groups.kv(2).ranks)}
    p2t2 = world.groups("P2T2")
    for name in ("model", "partition", "data"):
        out[f"groups.P2T2.{name}"] = np.asarray(getattr(p2t2, name).ranks)
    p2t2_eng = CommEngine(_topology("P2T2"), groups=p2t2)
    for name in K.TP_LAYER_CASES:
        eng.counter.reset()
        p2t2_eng.counter.reset()
        if name.startswith("moe"):
            on = eng if K.moe_case_tp(name)[0] == "T4" else p2t2_eng
            res = _moe_case(name, world.rank, on)
            out[f"{name}.calls"] = np.asarray(json.dumps(on.counter.snapshot()["calls"]))
            out.update({f"{name}.{k}": _np(v) for k, v in res.items()})
            continue
        res = _tp_layer(name, world.rank, groups, eng)
        out.update({f"{name}.{k}": _np(v) for k, v in res.items()})
        out[f"{name}.calls"] = np.asarray(json.dumps(eng.counter.snapshot()["calls"]))
        if name.endswith(":bf16"):
            again = _tp_layer(name, world.rank, groups, eng)
            out.update({f"{name}.again.{k}": _np(v) for k, v in again.items()})
    for name in K.MOE_LIVE_CASES:
        on = eng if K.moe_case_tp(name)[0] == "T4" else p2t2_eng
        out[f"{name}.out"] = _np(_moe_case(name, world.rank, on)["out"])
    return out



def _tp_layer(name: str, r: int, groups, eng) -> dict:
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.flat_param import Segment, model_gather_fn_for
    from repro_torch.models import blocks, lm, recurrent
    from repro_torch.models import layers as L
    from repro_torch.models.dims import attn_dims

    kind, _, tag = name.partition(":")
    dt = TDT.get(tag, torch.float32)
    ctx = L.Ctx(mode="train", tp=K.TP, comm=eng, compute_dtype=dt)
    ins = {k: v[r] for k, v in K.tp_layer_case(name)[1].items()}
    if kind == "embed":
        table = _leaf(ins["table"])
        y = L.embed_lookup(table, torch.from_numpy(ins["ids"]).long(), ctx)
        return {"out": y, "d_table": torch.autograd.grad(y, table, _leaf(ins["ct"]))[0]}
    if kind == "xent":
        logits = _leaf(ins["logits"])
        loss = L.tp_cross_entropy(logits, torch.from_numpy(ins["targets"]),
                                  torch.from_numpy(ins["mask"]), vocab_real=K.VR,
                                  vocab_padded=K.VP, ctx=ctx)
        return {"loss": loss, "d_logits": torch.autograd.grad(loss, logits)[0]}
    if kind == "attn_out":
        ad = attn_dims(K.ATTN["d"], K.ATTN["hq"], K.ATTN["hkv"], K.ATTN["dh"], K.TP)
        attn, wo = _leaf(ins["attn"], dt), _leaf(ins["wo"], dt)
        y = blocks.attn_out({"attn.wo": wo}, attn, ad, ctx, "attn.", bias=False)
        d_attn, d_wo = torch.autograd.grad(y, (attn, wo), _leaf(ins["ct"], dt))
        return {"out": y, "d_attn": d_attn, "d_wo": d_wo}
    if kind == "mlp":
        cfg = ArchConfig(name="m", family="dense", n_layers=1, d_model=16, n_heads=4,
                         n_kv_heads=4, d_ff=32, vocab=256)
        xs = [_leaf(ins[k], dt) for k in ("x", "wg", "wu", "wd")]
        y = blocks.mlp_apply(cfg, {"mlp.wg": xs[1], "mlp.wu": xs[2], "mlp.wd": xs[3]}, xs[0],
                             ctx)
        grads = torch.autograd.grad(y, xs, _leaf(ins["ct"], dt))
        return {"out": y, **{f"d_{k}": g for k, g in zip(("x", "wg", "wu", "wd"), grads)}}
    if kind == "gather":
        g, dim = K.gather_case(name)
        seg = Segment("w", ins["local"].shape, 0, True, "normal", 1.0, model_gather=g,
                      model_gather_dim=dim)
        local = _leaf(ins["local"])
        y = model_gather_fn_for(groups, eng.counter)(seg, local)
        return {"out": y, "grad": torch.autograd.grad(y, local, _leaf(ins["ct"]))[0]}
    if kind == "head_mask":
        return {"mask": L.local_head_mask(10, 12, 3, ctx)}
    if kind == "griffin_rec":
        cfg = smoke_variant(get_config("recurrentgemma-2b"))
        t = {n: _leaf(ins[n]) for n in K.GRIFFIN_REC_CUT}
        x = _leaf(ins["x"])
        y, _ = recurrent.griffin_rec_apply(cfg, t, x, ctx)
        grads = torch.autograd.grad(y, (x, *t.values()), _leaf(ins["ct"]))
        return {"out": y, "d_x": grads[0], **{f"d_{n}": g for n, g in zip(t, grads[1:])}}
    if kind == "greedy":
        return {"ids": lm.greedy_sample(torch.from_numpy(ins["logits"]), ctx, K.VR)}
    raise KeyError(name)


def _moe_case(name: str, r: int, eng) -> dict:
    """A ``moe_*`` case on this rank's inputs over ``eng``'s model group:
    the expert exchange (``moe_a2a``) or ``moe_ffn`` with its gradients
    through autograd (cotangent ``ct`` on the output, 1 on aux)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import collectives as C
    from repro_torch.models import blocks
    from repro_torch.models import layers as L

    _, tp = K.moe_case_tp(name)
    ins = {k: v[r] for k, v in K.tp_layer_case(name)[1].items()}
    if name.startswith("moe_a2a"):
        x = _leaf(ins["x"])
        y = C.model_all_to_all(x, eng.groups.model, to_owners=True, counter=eng.counter)
        return {"out": y, "grad": torch.autograd.grad(y, x, _leaf(ins["ct"]))[0]}
    cfg = smoke_variant(get_config("deepseek-moe-16b"))
    if name.startswith("moe_live"):   # the engine's decode step: dead rows past n_new
        from repro_torch.runtime.paged import PageState

        pages = PageState(None, 0, torch.tensor(K.MOE_LIVE_N_NEW))
        ctx = L.Ctx(mode="decode", tp=tp, comm=eng, compute_dtype=torch.float32, pages=pages)
        with torch.no_grad():
            y, aux = blocks.moe_ffn({n: _leaf(ins[n]) for n in K.MOE_CUT}, _leaf(ins["x"]),
                                    cfg, ctx)
        return {"out": y, "aux": aux}
    ctx = L.Ctx(mode="train", tp=tp, comm=eng, compute_dtype=torch.float32)
    t = {n: _leaf(ins[n]) for n in K.MOE_CUT}
    x = _leaf(ins["x"])
    y, aux = blocks.moe_ffn(t, x, cfg, ctx)
    grads = torch.autograd.grad((y, aux), (x, *t.values()),
                                (_leaf(ins["ct"]), torch.ones(())))
    return {"out": y, "aux": aux, "d_x": grads[0],
            **{f"d_{n}": g for n, g in zip(t, grads[1:])}}


def tp_train(world: World) -> dict:
    """Each case of ``K.TP_TRAINS`` on the cut weights
    (``tp_params_from_full`` of ``K.numpy_params``, zero moments): one
    micro-batch's gradients through ``accumulate_grads`` (``<case>.loss``,
    ``<case>.grads.<pool>``), then one step of ``build_train_step``
    (``<case>.metrics``, ``<case>.<part>.<pool>``, the step's collective
    counts in ``<case>.calls``); the bf16 case also on the serial schedule
    (``<case>.serial.*``)."""
    import dataclasses
    import json

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import shard_state, tp_params_from_full
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, build_train_step
    from repro_torch.models import layers as L
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    out = {}
    for name, (arch, lay, wire, over) in K.TP_TRAINS.items():
        topo, g = _topology(lay), world.groups(lay)
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
        model, model_1 = build_model(cfg, topo.model_size), build_model(cfg, 1)
        params = tp_params_from_full(model, model_1, K.numpy_params(model_1, name))
        full = {"params": {k: torch.from_numpy(v) for k, v in params.items()}, "step": 0}
        for part in ("m", "v"):
            full[part] = {k: torch.zeros_like(v) for k, v in full["params"].items()}
        batch = K.data_slice(K.tp_batch(name), topo.data_rank(world.rank),
                             topo.data_parallel_size)
        runs = {"": {}, ".serial": {"prefetch": False}} if wire == "bf16" else {"": {}}
        for suffix, kw in runs.items():
            state = shard_state(model, topo, world.rank, full, device="cpu")
            step = build_train_step(model, topo, MiCSConfig(
                micro_steps=K.MICRO, gather_dtype=TDT[wire], **kw), OptConfig(**K.OPT),
                device="cpu", groups=g)
            if not suffix:
                ctx = L.Ctx(mode="train", tp=topo.model_size, compute_dtype=TDT[wire],
                            comm=step.comm)
                grads, loss, _ = accumulate_grads(model, step.comm, ctx, state["params"], {
                    k: torch.as_tensor(v[:1]) for k, v in batch.items()})
                out[f"{name}.loss"] = _np(loss)
                out.update({f"{name}.grads.{k}": _np(v) for k, v in grads.items()})
                step.comm.counter.reset()
            state, m = step(state, batch)
            key = name + suffix
            out[f"{key}.metrics"] = np.asarray([m["loss"].item(), m["grad_norm"].item()])
            out[f"{key}.calls"] = np.asarray(json.dumps(step.comm.counter.snapshot()["calls"]))
            for part in ("params", "m", "v"):
                out.update({f"{key}.{part}.{k}": _np(v) for k, v in state[part].items()})
    return out


def knobs(world: World) -> dict:
    """The one-card training knobs over ranks, the port against itself from
    the seeded ``init_state`` (``K.KNOB_RUNS``): each run's metrics, final
    state and the step's collective counts (``<run>.calls``)."""
    import json

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    out = {}
    for name, (lay, order, inner, kw, opt) in K.KNOB_RUNS.items():
        topo, g = _topology(lay), world.groups(lay, inner)
        mc = MiCSConfig(micro_steps=K.MICRO, gather_order=order, hierarchy_inner=inner, **kw)
        state = init_state(model, 0, device="cpu", topo=topo, rank=world.rank,
                           offload_opt=mc.offload_opt)
        step = build_train_step(model, topo, mc, OptConfig(**{**K.OPT, **opt}), device="cpu",
                                groups=g)
        dr, metrics = topo.data_rank(world.rank), []
        for b in K.train_batches():
            state, m = step(state, K.data_slice(b, dr, topo.data_parallel_size))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        out[f"{name}.metrics"] = np.asarray(metrics, np.float64)
        out[f"{name}.calls"] = np.asarray(json.dumps(step.comm.counter.snapshot()["calls"]))
        for part in ("params", "m", "v"):
            out.update({f"{name}.{part}.{k}": _np(v) for k, v in state[part].items()})
    return out


def _jax_init(out_dir: pathlib.Path) -> dict:
    init_npz = np.load(out_dir / "jax_init.npz")
    init = {part: {k.split(".", 2)[2]: init_npz[k] for k in init_npz.files
                   if k.startswith(f"init.{part}.")} for part in ("params", "m", "v")}
    init["step"] = 0
    return init


def elastic(world: World, out_dir: pathlib.Path) -> dict:
    """The elastic loop over the 4 ranks: each run of ``K.ELASTIC_RUNS``
    over 4 ranks through ``train(..., fault_injector=K.fault_plan(...),
    elastic=ElasticConfig())`` (tp 1 runs from the JAX initial state,
    written as a step-0 checkpoint; P2T2 from the port's seeded init), and
    after each run with world changes, each world's steps again as a cold
    ``elastic_restart`` of the checkpoint it resumed from; then the
    checkpointer's reshards (``_reshards``).  JSON a run and rank
    (``<run>.json``): the loop's stats, the cursors it fetched, the cold
    runs' losses and whether their final states equal the loop's
    checkpoints bitwise."""
    import dataclasses
    import json

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import shard_from_jax
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import train_loop as TL

    served = []

    class RecordingLM(SyntheticLM):
        def host_step_batch(self, step, host_index, host_count):
            served.append(int(step))
            return super().host_step_batch(step, host_index, host_count)

    TL.SyntheticLM = RecordingLM
    r, init = world.rank, _jax_init(out_dir)
    cfg = smoke_variant(get_config("llama3.2-1b"))
    dc = DataConfig(vocab=cfg.vocab, seq=K.SEQ, global_batch=K.ELASTIC_BATCH,
                    micro_steps=K.MICRO)
    oc, mcfg = OptConfig(**K.ELASTIC_OPT), MiCSConfig(micro_steps=K.MICRO,
                                                      gather_dtype=torch.float32)
    out = {}
    for name, (lay, total, every) in K.ELASTIC_RUNS.items():
        if lay == "1":
            continue
        topo = MiCSTopology(**K.elastic_topo_kwargs(name))
        model = build_model(cfg, tp=topo.model_size)
        ckdir = out_dir / f"elastic_{name}"
        groups = MiCSGroups(topo, r, backend="gloo", timeout=TIMEOUT)
        if topo.model_size == 1:
            Checkpointer(ckdir).save(shard_from_jax(model, topo, r, init, device="cpu"), 0,
                                     topo=topo, groups=groups)
        lc = TL.LoopConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=str(ckdir),
                           log_every=0)
        served.clear()
        plan = K.fault_plan(FaultPlan, name)
        stats = TL.train(model, topo, mcfg, oc, dc, lc, device="cpu", groups=groups,
                         fault_injector=plan, elastic=TL.ElasticConfig())
        res = {k: v for k, v in dataclasses.asdict(stats).items()
               if k not in ("step_times", "save_times", "comm", "saves")}
        res.update(cursors=list(served), fired=plan.log,
                   latest=Checkpointer(ckdir).latest_step(), cold=[])
        p_prev = topo.partition_size
        for entry, steps in K.segments(stats.world_changes, total) if name in K.ELASTIC_CHANGES \
                else ():
            # the same world again, cold: its checkpoint, the same resize
            topo_n, _, rule = TL.resize_for_world(
                model, mcfg, entry["world"], tp=topo.model_size, partition_size=p_prev,
                available=K.WORLD)
            p_prev = topo_n.partition_size
            g = MiCSGroups(topo_n, r, backend="gloo", timeout=TIMEOUT)
            cold = {"rule": rule, "losses": [], "state_bitwise": None}
            if not g.parked:
                _, state, step_fn, meta = TL.elastic_restart(
                    str(ckdir), cfg, topo_n, mcfg, oc, entry["resumed_step"], device="cpu",
                    groups=g)
                src = SyntheticLM(dc)
                for c in range(meta["data_cursor"], meta["data_cursor"] + steps):
                    state, m = step_fn(state, src.host_step_batch(
                        c, topo_n.data_rank(r), topo_n.data_parallel_size))
                    cold["losses"].append(m["loss"].item())
                end = entry["resumed_step"] + steps
                ck = Checkpointer(ckdir)
                saved_world = json.loads((ckdir / f"step_{end:08d}" / "manifest.json")
                                         .read_text())["world_size"]
                if saved_world == entry["world"]:
                    kept, _ = ck.restore(model, end, topo=topo_n, rank=r, device="cpu")
                    cold["state_bitwise"] = all(
                        torch.equal(kept[part][k], state[part][k])
                        for part in ("params", "m", "v") for k in state[part])
                del state, step_fn
            g.release()
            res["cold"].append(cold)
        out[f"{name}.json"] = np.asarray(json.dumps(res, default=float))
    TL.SyntheticLM = SyntheticLM
    out.update(_reshards(world, out_dir))
    return out


def _reshards(world: World, out_dir: pathlib.Path) -> dict:
    """The checkpointer across topologies, on a seeded random state
    (``K.numpy_params`` for params, m and v, so every tensor is non-zero):
    the round trips p 2 (2 ranks) -> p 4 -> p 2 and B -> A -> B, a one-rank
    checkpoint onto B, an ``offload_opt`` restore onto A against the
    card-resident one (and one step of each), and a restore onto another
    tp.  Each restore is held bitwise to ``shard_state`` of the global
    state at its topology (``<case>.bitwise``)."""
    import json

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import shard_state
    from repro_torch.core.hostoffload import is_host_resident, pinned_bytes
    from repro_torch.core.mics import MiCSConfig, build_train_step
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    r = world.rank
    cfg = smoke_variant(get_config("llama3.2-1b"))
    model = build_model(cfg, tp=1)
    full = {part: {k: torch.from_numpy(v) for k, v in K.numpy_params(
        model, f"reshard:{part}").items()} for part in ("params", "m", "v")}
    full["v"] = {k: v.abs() for k, v in full["v"].items()}   # a second moment
    full["step"] = 3
    topos = {"P2": MiCSTopology(shard=2), "A": _topology("A"), "B": _topology("B"),
             "1": MiCSTopology()}
    groups = {k: MiCSGroups(t, r, backend="gloo", timeout=TIMEOUT) for k, t in topos.items()
              if k != "1"}
    out = {}

    def equal(a: dict, b: dict) -> bool:
        return a["step"] == b["step"] and all(torch.equal(a[part][k], b[part][k])
                                              for part in ("params", "m", "v") for k in a[part])

    def trip(name: str, path: list[str]) -> None:
        ck = Checkpointer(out_dir / f"reshard_{name}")
        ok = []
        for i, lay in enumerate(path):
            topo, g = topos[lay], groups[lay]
            if not g.parked:
                state = (shard_state(model, topo, r, full, device="cpu") if i == 0 else
                         ck.restore(model, i - 1, topo=topo, rank=r, device="cpu")[0])
                ok.append(equal(state, shard_state(model, topo, r, full, device="cpu")))
                ck.save(state, i, topo=topo, groups=g)
            dist.barrier()
        out[f"{name}.bitwise"] = np.asarray(all(ok))
        out[f"{name}.restores"] = np.asarray(len(ok))

    trip("p2_p4_p2", ["P2", "A", "P2"])
    trip("B_A_B", ["B", "A", "B"])
    # a one-rank checkpoint (rank 0 writes it) onto the 4 ranks of B
    ck = Checkpointer(out_dir / "reshard_one")
    if r == 0:
        ck.save(shard_state(model, topos["1"], 0, full, device="cpu"), 1, topo=topos["1"])
    dist.barrier()
    state, meta = ck.restore(model, topo=topos["B"], rank=r, device="cpu")
    out["one_to_B.bitwise"] = np.asarray(
        meta["world_size"] == 1 and equal(state, shard_state(model, topos["B"], r, full,
                                                              device="cpu")))
    # offload_opt: saved from host memory at B, restored onto A with the
    # moments in host memory and on the device: the same bits, and one step
    # of each the same
    ck = Checkpointer(out_dir / "reshard_offload")
    g = groups["B"]
    ck.save(shard_state(model, topos["B"], r, full, device="cpu"), 3, topo=topos["B"], groups=g)
    runs = {}
    for offload in (True, False):
        state, _ = ck.restore(model, topo=topos["A"], rank=r, device="cpu", offload_opt=offload)
        host = all(is_host_resident(t, torch.device("cpu")) for part in ("m", "v")
                   for t in state[part].values())
        restored = equal(state, shard_state(model, topos["A"], r, full, device="cpu"))
        step = build_train_step(model, topos["A"], MiCSConfig(
            micro_steps=K.MICRO, gather_dtype=torch.float32, offload_opt=offload),
            OptConfig(**K.ELASTIC_OPT), device="cpu", groups=groups["A"])
        batch = K.data_slice(K.train_batches()[0], topos["A"].data_rank(r),
                             topos["A"].data_parallel_size)
        state, m = step(state, batch)
        runs[offload] = (state, m["loss"].item(), m["grad_norm"].item(), host, restored)
    out["offload.restored_bitwise"] = np.asarray(runs[True][4] and runs[False][4])
    out["offload.moments_in_host_memory"] = np.asarray(runs[True][3])
    out["offload.step_bitwise"] = np.asarray(runs[True][1:3] == runs[False][1:3]
                                             and equal(runs[True][0], runs[False][0]))
    out["offload.pinned_bytes"] = np.asarray(pinned_bytes())
    # another tp: the reference's reason
    try:
        ck.restore(build_model(cfg, tp=2), topo=_topology("P2T2"), rank=r, device="cpu")
        out["other_tp.error"] = np.asarray(json.dumps(None))
    except ValueError as e:
        out["other_tp.error"] = np.asarray(json.dumps(str(e)))
    for g in groups.values():
        g.release()
    return out


def elastic_offload(world: World, out_dir: pathlib.Path, device: str) -> dict:
    """An in-loop world change with the AdamW moments in host memory: each
    run of ``K.ELASTIC_OFFLOAD`` through ``train(..., elastic=)`` from the
    port's seeded init on ``device``, with ``offload_opt`` and without.
    JSON a run and rank (``<run>.offload.json``): both runs' losses and
    ledgers, the pinned bytes at every step the fault plan saw, the m and v
    bytes each world's shards of this rank hold (0 for a parked rank, and
    on the CPU, where nothing is pinned), the peak of the pinned bytes over
    the run and what stays pinned after it; and whether every file of the
    two runs' last checkpoints is the same bytes."""
    import gc
    import json

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.hostoffload import pinned_bytes, pinned_peak, reset_pinned_peak
    from repro_torch.core.mics import MiCSConfig, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import train_loop as TL

    r = world.rank
    cfg = smoke_variant(get_config("llama3.2-1b"))
    model = build_model(cfg, tp=1)
    dc = DataConfig(vocab=cfg.vocab, seq=K.SEQ, global_batch=K.ELASTIC_BATCH,
                    micro_steps=K.MICRO)
    oc = OptConfig(**K.ELASTIC_OPT)
    pinned = []

    class Watching(FaultPlan):
        def __call__(self, step):
            pinned.append(pinned_bytes())
            return super().__call__(step)

    def moment_bytes(topo) -> int:
        if device != "cuda" or r >= topo.world_size:
            return 0
        state = init_state(model, 0, device="cpu", topo=topo, rank=r)
        return sum(t.numel() * t.element_size() for part in ("m", "v")
                   for t in state[part].values())

    out = {}
    for name in K.ELASTIC_OFFLOAD:
        _, total, every = K.ELASTIC_RUNS[name]
        topo = MiCSTopology(**K.elastic_topo_kwargs(name))
        res, last = {}, {}
        for offload in (True, False):
            mcfg = MiCSConfig(micro_steps=K.MICRO, gather_dtype=torch.float32,
                              offload_opt=offload)
            ckdir = out_dir / f"offload_{name}_{offload}"
            lc = TL.LoopConfig(total_steps=total, checkpoint_every=every,
                               checkpoint_dir=str(ckdir), log_every=0)
            groups = MiCSGroups(topo, r, backend="gloo", timeout=TIMEOUT)
            pinned.clear()
            reset_pinned_peak()
            stats = TL.train(model, topo, mcfg, oc, dc, lc, device=device, groups=groups,
                             fault_injector=K.fault_plan(Watching, name),
                             elastic=TL.ElasticConfig())
            gc.collect()
            # the bytes each world this rank stepped in pins: the plan sees
            # every step a world runs, the change's own included
            topos, expected = [topo], []
            for e in stats.world_changes:
                topos.append(TL.resize_for_world(model, mcfg, e["world"],
                                                 partition_size=topos[-1].partition_size,
                                                 available=K.WORLD)[0])
            segs = K.segments([{"resumed_step": 0}] + stats.world_changes, total)
            for i, ((_, steps), t) in enumerate(zip(segs, topos)):
                if r < t.world_size:   # and the step a change fired at
                    expected += [moment_bytes(t)] * (steps + (i < len(segs) - 1))
            res[offload] = {"losses": stats.losses, "grad_norms": stats.grad_norms,
                            "ledger": [{k: v for k, v in e.items()
                                        if k not in ("comm", "rebuild_s")}
                                       for e in stats.world_changes],
                            "pinned": list(pinned), "expected": expected,
                            "world_bytes": [moment_bytes(t) for t in topos],
                            "peak": pinned_peak(), "after": pinned_bytes()}
            last[offload] = ckdir / f"step_{total:08d}"
        dist.barrier()
        res["checkpoints_equal"] = all(
            (last[True] / f.name).read_bytes() == f.read_bytes()
            for f in sorted(last[False].iterdir()) if f.suffix == ".npy")
        out[f"{name}.offload.json"] = np.asarray(json.dumps(
            {str(k): v for k, v in res.items()}, default=float))
    return out


def _serve_model(name: str):
    """``(model, model at tp 1, topology, global weights)`` of a
    ``K.SERVE_FIXED`` case (the weights cut for its tp, numpy)."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.convert import tp_params_from_full
    from repro_torch.models.build import build_model

    arch, lay, _, _, over, _ = K.SERVE_FIXED[name]
    topo = _topology(lay)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    model, model_1 = build_model(cfg, topo.model_size), build_model(cfg, 1)
    full = tp_params_from_full(model, model_1, K.numpy_params(model_1, K.serve_weights_key(name)))
    return model, model_1, topo, full


def serve(world: World) -> dict:
    """Serving over the 4 ranks: the fixed-batch steps of ``K.SERVE_FIXED``
    (each rank's prefill and decode logits, the global tokens, the
    collective counts), the paged step at ``K.SERVE_PAGED`` (its logit rows
    and tokens; paged == contiguous over pools filled by
    ``pages_from_contiguous``), the sampler at ``K.SAMPLER_LAYOUTS`` and
    the resilient loop's ``K.CHAOS_RUNS`` (JSON a run)."""
    import json

    from repro_torch.convert import shard_params
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.quant import quantize_state
    from repro_torch.runtime.serving import build_serve_steps

    r, out = world.rank, {}
    for name, (_, lay, order, inner, _, int8) in K.SERVE_FIXED.items():
        model, _, topo, full = _serve_model(name)
        params = shard_params(model, topo, r, full, device="cpu")
        if int8:
            params = quantize_state(params)
        mcfg = MiCSConfig(gather_dtype=torch.float32, gather_order=order,
                          hierarchy_inner=inner, quant_gather=int8)
        prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, K.SERVE_CACHE,
                                                  device="cpu", groups=world.groups(lay, inner))
        prompts, tok = K.serve_inputs(name)
        batch = {"tokens": torch.from_numpy(prompts)}
        if K.serve_vision(name) is not None:
            batch["vision"] = torch.from_numpy(K.serve_vision(name))
        logits, caches = prefill_fn(params, batch)
        out[f"{name}.prefill"] = _np(logits)
        tok = torch.from_numpy(tok)
        toks = []
        for i in range(K.SERVE_STEPS):
            logits, tok, caches = decode_fn(params, caches, tok, K.SERVE_T + i)
            out[f"{name}.decode{i}"] = _np(logits)
            toks.append(tok[:, 0].numpy())
        out[f"{name}.tokens"] = np.stack(toks, axis=1)
        out[f"{name}.calls"] = np.asarray(json.dumps(decode_fn.comm.counter.snapshot()["calls"]))
    out.update(_serve_paged(world))
    out.update(_serve_sampler(world))
    out.update(_serve_chaos(world))
    return out


def _serve_paged(world: World) -> dict:
    """``build_paged_step`` at each layout of ``K.SERVE_PAGED`` (fp32 gather
    and pools): the prompts in one chunk, then decode steps at its width,
    each fed the tokens it sampled (``paged.<layout>.logits<i>``: this
    rank's rows and columns; ``.tokens<i>``: the global tokens); then
    ``pages_from_contiguous`` and the paged step against the contiguous
    one, step by step (``.bitwise``)."""
    from repro_torch.convert import shard_params
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime.serving import build_serve_steps

    r, out = world.rank, {}
    for lay in K.SERVE_PAGED:
        model, _, topo, full = _serve_model(f"llama@{lay}")
        g = world.groups(lay)
        params = shard_params(model, topo, r, full, device="cpu")
        mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype="fp32", kv_block_size=K.PAGED_BS)
        dp, d = topo.data_parallel_size, topo.data_rank(r)
        tables, nb = K.paged_tables(K.PAGED_PLENS, dp)
        width = max(K.PAGED_PLENS)
        step = PG.build_paged_step(model, topo, mcfg, max_blocks=tables.shape[1],
                                   block_size=K.PAGED_BS, chunk=width, device="cpu", groups=g)
        pool = PG.init_paged_caches(model, topo, nb, K.PAGED_BS, "fp32", device="cpu")
        toks, pos = K.paged_prompts(), np.zeros(len(K.PAGED_PLENS), np.int64)
        n_new = np.asarray(K.PAGED_PLENS)
        for i in range(1 + K.PAGED_STEPS):
            t, lg, pool = step(params, pool, toks, pos, n_new, tables, K.PAGED_SEEDS,
                               np.zeros(len(n_new), np.float32))
            out[f"paged.{lay}.logits{i}"] = _np(lg)
            out[f"paged.{lay}.tokens{i}"] = t.numpy()
            pos = pos + n_new
            n_new = np.ones_like(n_new)
            toks = np.zeros_like(toks)
            toks[:, 0] = t.numpy()
        out[f"paged.{lay}.garbage_zero"] = np.asarray(not pool["layers"]["k"][:, 0].any())
        # paged == contiguous: prompts of one length prefilled by the
        # fixed-batch step, copied into this rank's pool
        b = len(K.PAGED_PLENS)
        lens = [K.PAGED_EQ_T] * b
        prompts = K.paged_prompts()[:, :K.PAGED_EQ_T]
        prefill_fn, _ = build_serve_steps(model, topo, MiCSConfig(gather_dtype=torch.float32),
                                          K.PAGED_CAP, device="cpu", groups=g)
        logits, caches = prefill_fn(params, {"tokens": torch.from_numpy(prompts)})
        mb = K.PAGED_CAP // K.PAGED_BS
        tables, nb = K.paged_tables(lens, dp, max_blocks=mb)
        pool = PG.init_paged_caches(model, topo, nb, K.PAGED_BS, "fp32", device="cpu")
        PG.pages_from_contiguous(model, topo, caches, pool, tables, lens,
                                 block_size=K.PAGED_BS, kv_dtype="fp32", data_rank=d)
        kw = dict(top_k=K.PAGED_TOP_K, device="cpu", groups=g)
        paged = PG.build_paged_step(model, topo, mcfg, max_blocks=mb, block_size=K.PAGED_BS,
                                    **kw)
        contig = PG.build_contiguous_step(model, topo, mcfg, K.PAGED_CAP, **kw)
        ctx = L.Ctx(tp=topo.model_size, comm=paged.comm)
        tp_ = tc = paged.comm.data_all_gather(
            lm.greedy_sample(logits[:, -1], ctx, model.cfg.vocab)).numpy()
        pos = np.asarray(lens)
        same = []
        for i in range(K.PAGED_STEPS):
            t1, l1, pool = paged(params, pool, tp_[:, None], pos + i, np.ones(b), tables,
                                 K.PAGED_SEEDS, K.PAGED_TEMPS)
            t2, l2, caches = contig(params, caches, tc[:, None], pos + i, K.PAGED_SEEDS,
                                    K.PAGED_TEMPS)
            same.append(bool(torch.equal(t1, t2) and torch.equal(l1, l2)))
            tp_, tc = t1.numpy(), t2.numpy()
        out[f"paged.{lay}.bitwise"] = np.asarray(same)
    return out


def _serve_sampler(world: World) -> dict:
    """``lm.sample_tokens`` at each layout of ``K.SAMPLER_LAYOUTS`` on this
    rank's model coordinate's columns of ``K.sampler_logits()``, at each
    top-k of ``K.SAMPLER_TOP_K`` (``sampler.<layout>.<k>``)."""
    from repro_torch.core.comm import CommEngine
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    out = {}
    logits = torch.from_numpy(K.sampler_logits())
    for lay in K.SAMPLER_LAYOUTS:
        topo = _topology(lay)
        eng = CommEngine(topo, groups=world.groups(lay))
        ctx = L.Ctx(tp=topo.model_size, comm=eng)
        shard = torch.chunk(logits, topo.model_size, dim=-1)[eng.model_coord()].contiguous()
        for k in K.SAMPLER_TOP_K:
            out[f"sampler.{lay}.{k}"] = lm.sample_tokens(
                shard, ctx, K.VR, seed=torch.from_numpy(K.SAMPLER_SEEDS),
                pos=torch.from_numpy(K.SAMPLER_POS),
                temperature=torch.from_numpy(K.SAMPLER_TEMPS), top_k=k).numpy()
    return out


def _serve_chaos(world: World) -> dict:
    """``ResilientServeLoop`` on each run of ``K.CHAOS_RUNS`` from
    ``elastic_host_topology(world, p, tp 2)`` over the launch world's 4
    ranks, every process running the loop (a parked one waits in the
    meetings): each rank's report as JSON (``chaos.<run>.json``; the
    ledger's seconds and counters left out)."""
    import json

    from repro_torch.convert import shard_params
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import elastic_host_topology
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.runtime.batching import Request
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    r, out = world.rank, {}
    model, _, _, full = _serve_model("llama@P2T2")
    mcfg = MiCSConfig(gather_dtype=torch.float32, kv_dtype="fp32",
                      kv_block_size=K.CHAOS_GEOMETRY["block_size"])
    for run, (n, spec) in K.CHAOS_RUNS.items():
        topo = elastic_host_topology(n, n // K.CHAOS_TP, K.CHAOS_TP,
                                     available=K.WORLD)
        groups = MiCSGroups(topo, r, backend="gloo", timeout=TIMEOUT)
        loop = ResilientServeLoop(
            model, topo, mcfg, ServeLoopConfig(**K.CHAOS_GEOMETRY, seed=0),
            params_for=lambda model, topo: shard_params(model, topo, r, full, device="cpu"),
            fault_injector=FaultPlan.parse(spec) if spec else None, device="cpu",
            groups=groups)
        rep = loop.run(K.chaos_requests(Request), K.CHAOS_ARRIVALS)
        rep["world_changes"] = [{k: v for k, v in e.items() if k not in ("comm", "rebuild_s")}
                                for e in rep["world_changes"]]
        rep["parked_at_end"] = loop.parked
        loop.groups.release()
        out[f"chaos.{run}.json"] = np.asarray(json.dumps(rep, default=str))
    return out


def _rank_main(rank: int, mode: str, out_dir: pathlib.Path, device: str):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(K.WORLD), LOCAL_RANK=str(rank))
    from repro_torch.launch.mesh import init_distributed

    init_distributed("gloo", timeout=TIMEOUT, init_method=f"file://{out_dir / 'store'}")
    world = World(rank)
    if mode == "collectives":
        res = collectives(world, device)
    elif mode == "tp_layers":
        res = tp_layers(world)
    elif mode == "tp_train":
        res = tp_train(world)
    elif mode == "knobs":
        res = knobs(world)
    elif mode == "elastic":
        res = elastic(world, out_dir)
    elif mode == "elastic_offload":
        res = elastic_offload(world, out_dir, device)
    elif mode == "serve":
        res = serve(world)
    else:
        res = train(world, out_dir)
    np.savez(out_dir / f"port_{mode}.rank{rank}.npz", **res)
    import torch.distributed as dist

    dist.destroy_process_group()


def main():
    mode, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    mp.spawn(_rank_main, args=(mode, out_dir, device), nprocs=K.WORLD, join=True)


if __name__ == "__main__":
    main()
