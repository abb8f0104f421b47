"""The JAX package's answers to the cases of ``torch_dist_cases.py`` on 4
virtual CPU devices, jitted, written to ``<out>/jax_<mode>.npz``.

    python tests/jax_dist_oracle.py \
        collectives|train|init|tp_layers|tp_train|elastic|serve OUT_DIR

``collectives``: ``repro.core.collectives`` under ``shard_map`` on
``make_host_mesh`` meshes, each device's input row r of the case's input,
its output row r of the result.  ``train``: ``repro.core.mics``'s
``init_state`` and ``build_train_step`` for the smoke llama3.2-1b, STEPS
steps a case: each step's loss and grad_norm, the initial and final global
state.  ``init``: that initial state alone, from one device (the state is
a function of the model and the seed, not of the layout).  ``tp_layers``
and ``tp_train``: the tensor-parallel cases (see those functions).
``elastic``: the reference's elastic loop on the runs of
``K.ELASTIC_RUNS`` and ``elastic_host_topology`` on ``K.ELASTIC_GRID``.
``serve``: the reference's serving at the layouts of the serve cases (see
that function).
"""

import os
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))

import pathlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_cases as K  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.core import collectives as C  # noqa: E402
from repro.core.topology import MICS_AXES, MiCSTopology, make_host_mesh  # noqa: E402

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def topology(layout: str) -> MiCSTopology:
    return topology_of(*K.LAYOUTS[layout])


def topology_of(dims, part, rep) -> MiCSTopology:
    pod, repl, shard, dp2, model = dims
    mesh = make_host_mesh(pod, repl, shard, model, dp2)
    return MiCSTopology(mesh, partition_axes=part, replication_axes=rep)


def per_device(topo: MiCSTopology, fn, x: np.ndarray, dtype=jnp.float32) -> np.ndarray:
    """``fn`` on each device's row of ``x`` ([WORLD, ...]); rows stacked."""
    spec = P(MICS_AXES)
    run = jax.jit(shard_map(lambda v: fn(v[0])[None], mesh=topo.mesh, in_specs=spec,
                            out_specs=spec, check_vma=False))
    return np.asarray(run(jnp.asarray(x, dtype)).astype(jnp.float32))


def collectives() -> dict:
    out = {}
    for lay in K.LAYOUTS:
        topo = topology(lay)
        out[f"groups.{lay}.partition"] = np.asarray(topo.partition_groups())
        out[f"groups.{lay}.replication"] = np.asarray(topo.replication_groups())
        out[f"groups.{lay}.devices"] = np.vectorize(lambda d: d.id)(topo.mesh.devices)
    for name, (lay, topo_name, inner, _, axis) in K.GATHERS.items():
        topo = topology(lay)
        if topo_name == "flat":
            fn = lambda v, topo=topo, axis=axis: C.flat_all_gather(  # noqa: E731
                v, topo.partition_axes, axis=axis)
        else:
            fn = lambda v, topo=topo, o=topo_name, i=inner, axis=axis: (  # noqa: E731
                C.hierarchical_all_gather(v, topo, axis=axis, order=o, inner=i))
        out[name] = per_device(topo, fn, K.gather_input(name))
    for name, (lay, topo_name, inner, dt) in K.REDUCE_SCATTERS.items():
        topo = topology(lay)
        if topo_name == "flat":
            fn = lambda g, topo=topo: C.hop1_reduce_scatter(g, topo)  # noqa: E731
        else:
            fn = lambda g, topo=topo, o=topo_name, i=inner: (  # noqa: E731
                C.hierarchical_reduce_scatter(g, topo, order=o, inner=i))
        out[name] = per_device(topo, fn, K.full_input(name), JDT[dt])
    for name, (kind, lay) in K.SYNCS.items():
        topo = topology(lay)
        sync = C.hop2_all_reduce if kind == "hop2" else C.alternative_sync
        fn = lambda g, topo=topo, sync=sync: sync(g, topo)  # noqa: E731
        out[name] = per_device(topo, fn, K.full_input(name))
    out.update(wire_collectives())
    return out


def wire_collectives() -> dict:
    """The reference's int8 gather, quantized hop 1 (nearest), quantized
    hop 2 (nearest) and bf16 hop 2 on the cases of ``K.QWIRES`` / layout B."""
    from repro.core.comm import CommEngine, GatherPolicy, SyncPolicy

    out = {}
    for name, (lay, topo_name, inner) in K.QWIRES.items():
        topo = topology(lay)
        eng = CommEngine(topo, GatherPolicy(topology=topo_name, wire_dtype="int8", inner=inner),
                         compute_dtype=jnp.bfloat16)
        out[f"qgather:{name}"] = per_device(topo, eng.gather_flat,
                                            K.full_input("qgather:" + lay, K.QLEN))
        fn = lambda g, topo=topo, t=topo_name, i=inner: C.quantized_reduce_scatter(  # noqa: E731
            g, topo, topology=t, inner=i, stochastic=False)
        out[f"qrs:{name}"] = per_device(topo, fn, K.full_input("qrs:" + lay, K.QRS_LEN))
    topo = topology("B")
    x = K.full_input("qar", K.QAR_LEN)
    out["qar"] = per_device(topo, lambda g: C.quantized_all_reduce(g, topo, stochastic=False), x)
    eng = CommEngine(topo, sync_policy=SyncPolicy(hop2_wire_dtype="bf16"))
    out["hop2_bf16"] = per_device(topo, eng.hop2, x)
    return out


def train() -> dict:
    from repro.configs import get_config, smoke_variant
    from repro.core.mics import MiCSConfig, build_train_step, init_state
    from repro.models.build import build_model
    from repro.optim.adamw import OptConfig

    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    batches = K.train_batches()
    out = {}
    init = None
    for name, (lay, order, inner, wire) in K.TRAINS.items():
        topo = topology(lay)
        state = init_state(model, topo, seed=0)
        if init is None:   # the state is a function of (model, seed) alone
            init = {f"init.{part}.{k}": np.asarray(v) for part in ("params", "m", "v")
                    for k, v in state[part].items()}
            out.update(init)
        step = build_train_step(model, topo, MiCSConfig(
            micro_steps=K.MICRO, gather_dtype=JDT[wire], gather_order=order,
            hierarchy_inner=inner), OptConfig(**K.OPT))
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"{name}.metrics"] = np.asarray(metrics, np.float64)
        for part in ("params", "m", "v"):
            for k, v in state[part].items():
                out[f"{name}.{part}.{k}"] = np.asarray(v)
    # the wires at bf16 gather, nearest rounding
    for name, (lay, order, inner, kw) in K.WIRE_JAX.items():
        topo = topology(lay)
        state = init_state(model, topo, seed=0)
        step = build_train_step(model, topo, MiCSConfig(
            micro_steps=K.MICRO, gather_dtype=jnp.bfloat16, gather_order=order,
            hierarchy_inner=inner, **kw), OptConfig(**K.OPT))
        metrics = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"{name}.metrics"] = np.asarray(metrics, np.float64)
        for part in ("params", "m", "v"):
            for k, v in state[part].items():
                out[f"{name}.{part}.{k}"] = np.asarray(v)
    return out


def init() -> dict:
    """The smoke llama's ``init_state(seed=0)`` on one device, as the
    ``train`` mode stores it (``init.<part>.<pool>``)."""
    from repro.configs import get_config, smoke_variant
    from repro.core.mics import init_state
    from repro.models.build import build_model

    model = build_model(smoke_variant(get_config("llama3.2-1b")), tp=1)
    state = init_state(model, MiCSTopology(make_host_mesh()), seed=0)
    return {f"init.{part}.{k}": np.asarray(v) for part in ("params", "m", "v")
            for k, v in state[part].items()}


def per_rank(topo: MiCSTopology, fn, ins: dict, n_out: int) -> list[np.ndarray]:
    """``fn(**inputs)`` -> ``n_out`` arrays on each device, each input a
    ``[WORLD, ...]`` array whose row r is device r's; the outputs stacked
    the same way (in fp32)."""
    names = list(ins) or ["_"]
    arrays = [jnp.asarray(ins[n]) for n in ins] or [jnp.zeros((K.WORLD, 1))]
    spec = P(MICS_AXES)

    def body(*vs):
        outs = fn(**{n: v[0] for n, v in zip(names, vs) if n != "_"})
        return tuple(o[None] for o in outs)

    run = jax.jit(shard_map(body, mesh=topo.mesh, in_specs=(spec,) * len(names),
                            out_specs=(spec,) * n_out, check_vma=False))
    return [np.asarray(o.astype(jnp.float32)) for o in run(*arrays)]


def tp_layers() -> dict:
    """Each case of ``K.TP_LAYER_CASES`` at tp 4 (``K.LAYOUTS['T4']``): the
    reference's layer functions under ``shard_map(..., check_vma=False)``,
    gradients by ``jax.vjp`` with each rank's cotangent."""
    from repro.configs import get_config, smoke_variant
    from repro.configs.base import ArchConfig
    from repro.core.flat_param import Segment, model_gather_fn_for
    from repro.core.topology import MODEL_AXIS
    from repro.models import blocks, lm, recurrent
    from repro.models import layers as L
    from repro.models.dims import attn_dims

    topo = topology("T4")
    out = {f"groups.{lay}.devices": np.vectorize(lambda d: d.id)(topology(lay).mesh.devices)
           for lay in ("T4", "P2T2")}
    for name in K.TP_LAYER_CASES:
        kind, _, tag = name.partition(":")
        dt = JDT.get(tag, jnp.float32)
        ctx = L.Ctx(mode="train", tp=K.TP, tp_axis=MODEL_AXIS, compute_dtype=dt)
        _, ins = K.tp_layer_case(name)
        if kind == "embed":
            def fn(table, ids, ct, ctx=ctx):
                y, vjp = jax.vjp(lambda tb: L.embed_lookup(tb, ids, ctx), table)
                return y, vjp(ct)[0]
            keys = ("out", "d_table")
        elif kind == "xent":
            def fn(logits, targets, mask, ctx=ctx):
                return jax.value_and_grad(lambda lg: L.tp_cross_entropy(
                    lg, targets, mask, vocab_real=K.VR, vocab_padded=K.VP, ctx=ctx))(logits)
            keys = ("loss", "d_logits")
        elif kind == "attn_out":
            ad = attn_dims(K.ATTN["d"], K.ATTN["hq"], K.ATTN["hkv"], K.ATTN["dh"], K.TP)

            def fn(attn, wo, ct, ctx=ctx, ad=ad, dt=dt):
                y, vjp = jax.vjp(lambda a, w: blocks.attn_out(
                    {"attn.wo": w}, a, ad, ctx, "attn.", bias=False), attn.astype(dt),
                    wo.astype(dt))
                return (y, *vjp(ct.astype(dt)))
            keys = ("out", "d_attn", "d_wo")
        elif kind == "mlp":
            cfg = ArchConfig(name="m", family="dense", n_layers=1, d_model=16, n_heads=4,
                             n_kv_heads=4, d_ff=32, vocab=256)

            def fn(x, wg, wu, wd, ct, ctx=ctx, cfg=cfg, dt=dt):
                y, vjp = jax.vjp(lambda *a: blocks.mlp_apply(
                    cfg, {"mlp.wg": a[1], "mlp.wu": a[2], "mlp.wd": a[3]}, a[0], ctx),
                    *(v.astype(dt) for v in (x, wg, wu, wd)))
                return (y, *vjp(ct.astype(dt)))
            keys = ("out", "d_x", "d_wg", "d_wu", "d_wd")
        elif kind == "gather":
            g, dim = K.gather_case(name)
            seg = Segment("w", ins["local"].shape[1:], 0, True, "normal", 1.0,
                          model_gather=g, model_gather_dim=dim)
            gather = model_gather_fn_for(MODEL_AXIS, K.TP)

            def fn(local, ct, seg=seg, gather=gather):
                y, vjp = jax.vjp(lambda t: gather(seg, t), local)
                return y, vjp(ct)[0]
            keys = ("out", "grad")
        elif kind == "head_mask":
            def fn(ctx=ctx):
                return (L.local_head_mask(10, 12, 3, ctx),)
            keys = ("mask",)
        elif kind == "griffin_rec":
            cfg = smoke_variant(get_config("recurrentgemma-2b"))
            names = list(K.GRIFFIN_REC_CUT)

            def fn(ctx=ctx, cfg=cfg, names=names, **kw):
                def f(x, *ws):
                    return recurrent.griffin_rec_apply(cfg, dict(zip(names, ws)), x, ctx)[0]
                y, vjp = jax.vjp(f, kw["x"], *(kw[n] for n in names))
                return (y, *vjp(kw["ct"]))
            keys = ("out", "d_x", *(f"d_{n}" for n in names))
        elif kind == "greedy":
            def fn(logits, ctx=ctx):
                return (lm.greedy_sample(logits[:, None, :], ctx, K.VR)[:, 0],)
            keys = ("ids",)
        elif kind.startswith("moe"):
            layout, tp = K.moe_case_tp(name)
            ctx = L.Ctx(mode="train", tp=tp, tp_axis=MODEL_AXIS, compute_dtype=jnp.float32)
            if name.startswith("moe_a2a"):
                def fn(x, ct):
                    y, vjp = jax.vjp(lambda v: jax.lax.all_to_all(
                        v, MODEL_AXIS, split_axis=0, concat_axis=1, tiled=True), x)
                    return y, vjp(ct)[0]
                keys = ("out", "grad")
            else:
                cfg = smoke_variant(get_config("deepseek-moe-16b"))
                names = list(K.MOE_CUT)

                def fn(ctx=ctx, cfg=cfg, names=names, **kw):
                    def f(x, *ws):
                        return blocks.moe_ffn(dict(zip(names, ws)), x, cfg, ctx)
                    (y, aux), vjp = jax.vjp(f, kw["x"], *(kw[n] for n in names))
                    return (y, aux, *vjp((kw["ct"], jnp.float32(1.0))))
                keys = ("out", "aux", "d_x", *(f"d_{n}" for n in names))
            res = per_rank(topology(layout), fn, ins, len(keys))
            out.update({f"{name}.{k}": v for k, v in zip(keys, res)})
            continue
        else:
            raise KeyError(name)
        res = per_rank(topo, fn, ins, len(keys))
        out.update({f"{name}.{k}": v for k, v in zip(keys, res)})
    return out


def loss_and_grads(model, topo: MiCSTopology, params: dict, batch: dict, jdt) -> tuple:
    """The reference's loss and its gradients at ``topo`` on one micro-batch
    (``[GLOBAL_B, SEQ]``), jitted under ``shard_map(..., check_vma=False)``
    as ``build_train_step`` runs them: each device's loss ``[devices]`` and
    the global gradients of its pools (hop 1 summed over each partition
    group, no hop 2)."""
    from repro.core.comm import CommEngine
    from repro.core.mics import MiCSConfig, batch_pspecs, state_pspecs
    from repro.core.topology import MODEL_AXIS
    from repro.models import layers as L
    from repro.models import lm

    comm = CommEngine.from_config(topo, MiCSConfig(gather_dtype=jdt))
    ctx = L.Ctx(mode="train", tp=topo.model_size, tp_axis=MODEL_AXIS, compute_dtype=jdt)
    pspec = state_pspecs(model, topo)["params"]

    def f(p, b):
        (loss, _), g = jax.value_and_grad(
            lambda q: lm.loss_fn(model, q, comm, ctx, b), has_aux=True)(p)
        return loss.reshape(1), g

    run = jax.jit(shard_map(f, mesh=topo.mesh,
                            in_specs=(pspec, batch_pspecs(model, topo, micro=False)),
                            out_specs=(P(MICS_AXES), pspec), check_vma=False))
    loss, grads = run({k: jnp.asarray(v) for k, v in params.items()},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(loss), {k: np.asarray(v) for k, v in grads.items()}


def tp_train() -> dict:
    """For each fp32 case of ``K.TP_TRAINS``: the reference's loss and
    gradients at the case's layout on the cut weights
    (``repro_torch.convert.tp_params_from_full`` of ``K.numpy_params``), and
    at the same layout with tp 1 on the whole weights (``<case>.tp1.*``),
    on the first micro-batch of ``K.tp_batch(case)``."""
    import dataclasses

    from repro.configs import get_config, smoke_variant
    from repro.models.build import build_model
    from repro_torch.configs import get_config as port_config
    from repro_torch.convert import tp_params_from_full
    from repro_torch.models.build import build_model as port_model

    out = {}
    for name, (arch, lay, wire, over) in K.TP_TRAINS.items():
        if wire != "fp32":
            continue
        batch = {k: v[0] for k, v in K.tp_batch(name).items()}
        topo = topology(lay)
        tp = topo.model_size
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
        pcfg = dataclasses.replace(smoke_variant(port_config(arch)), **over)
        params1 = K.numpy_params(build_model(cfg, tp=1), name)
        params = tp_params_from_full(port_model(pcfg, tp), port_model(pcfg, 1), params1)
        loss, grads = loss_and_grads(build_model(cfg, tp=tp), topo, params, batch, jnp.float32)
        loss1, grads1 = loss_and_grads(build_model(cfg, tp=1), topology_of(*K.tp1_layout(lay)),
                                       params1, batch, jnp.float32)
        out[f"{name}.loss"], out[f"{name}.tp1.loss"] = loss, loss1
        out.update({f"{name}.grads.{k}": v for k, v in grads.items()})
        out.update({f"{name}.tp1.grads.{k}": v for k, v in grads1.items()})
    return out


def elastic() -> dict:
    """The reference's ``runtime/train_loop.train`` on each run of
    ``K.ELASTIC_RUNS`` (smoke llama, fp32 gather, ``init_state(seed=0)``,
    ``K.fault_plan`` with ``ElasticConfig()``; one-rank runs on one device):
    as JSON, the losses, the ledger, the counters, the cursors of the
    batches the loop fetched and the newest checkpoint; and
    ``elastic_host_topology`` on ``K.ELASTIC_GRID`` (each topology's axis
    sizes, or the error's type and message)."""
    import dataclasses
    import json
    import tempfile

    import repro.runtime.train_loop as TL
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.configs import get_config, smoke_variant
    from repro.core.faults import FaultPlan
    from repro.core.mics import MiCSConfig
    from repro.core.topology import elastic_host_topology
    from repro.data.pipeline import DataConfig
    from repro.models.build import build_model
    from repro.optim.adamw import OptConfig

    served = []

    class RecordingLM(TL.SyntheticLM):
        def global_step_batch(self, step):
            served.append(int(step))
            return super().global_step_batch(step)

    TL.SyntheticLM = RecordingLM
    cfg = smoke_variant(get_config("llama3.2-1b"))
    dc = DataConfig(vocab=cfg.vocab, seq=K.SEQ, global_batch=K.ELASTIC_BATCH,
                    micro_steps=K.MICRO)
    out = {}
    for name, (lay, total, every) in K.ELASTIC_RUNS.items():
        topo = (MiCSTopology(make_host_mesh()) if lay == "1" else topology(lay))
        model = build_model(cfg, tp=topo.model_size)
        lc = TL.LoopConfig(total_steps=total, checkpoint_every=every, log_every=0,
                           checkpoint_dir=tempfile.mkdtemp(prefix=f"elastic_{name}_"))
        served.clear()
        stats = TL.train(model, topo, MiCSConfig(micro_steps=K.MICRO, gather_dtype=jnp.float32),
                         OptConfig(**K.ELASTIC_OPT), dc, lc,
                         fault_injector=K.fault_plan(FaultPlan, name),
                         elastic=TL.ElasticConfig())
        res = {k: v for k, v in dataclasses.asdict(stats).items() if k != "step_times"}
        res.update(cursors=list(served), latest=Checkpointer(lc.checkpoint_dir).latest_step())
        out[f"{name}.json"] = np.asarray(json.dumps(res, default=float))
    grid = {}
    for n, tp, p in K.ELASTIC_GRID:
        try:
            t = elastic_host_topology(n, p, tp)
            grid[f"{n},{tp},{p}"] = {ax: int(t.axis_size(ax)) for ax in MICS_AXES}
        except ValueError as e:
            grid[f"{n},{tp},{p}"] = {"error": type(e).__name__, "message": str(e)}
    out["grid.json"] = np.asarray(json.dumps(grid))
    return out


def _serve_setup(name: str):
    """The reference's model, topology and global weights of a
    ``K.SERVE_FIXED`` case (the port's cut of ``K.numpy_params``)."""
    import dataclasses

    from repro.configs import get_config, smoke_variant
    from repro.models.build import build_model
    from repro_torch.configs import get_config as port_config
    from repro_torch.convert import tp_params_from_full
    from repro_torch.models.build import build_model as port_model

    arch, lay, _, _, over, _ = K.SERVE_FIXED[name]
    topo = topology(lay)
    tp = topo.model_size
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    pcfg = dataclasses.replace(smoke_variant(port_config(arch)), **over)
    params = tp_params_from_full(port_model(pcfg, tp), port_model(pcfg, 1), K.numpy_params(
        build_model(cfg, tp=1), K.serve_weights_key(name)))
    return build_model(cfg, tp=tp), topo, params


def serve() -> dict:
    """The reference's serving over 4 virtual devices: ``build_serve_steps``
    on each case of ``K.SERVE_FIXED`` (prefill and decode logits, global,
    and the tokens), ``build_paged_step`` at ``K.SERVE_PAGED`` (fp32 pools:
    each step's logit rows and tokens), ``sample_tokens`` at
    ``K.SAMPLER_LAYOUTS`` (every rank's ids) and the fault-free
    ``ResilientServeLoop`` at P2T2 on ``K.chaos_requests`` (JSON)."""
    from concurrent.futures import ThreadPoolExecutor

    # each part compiled on its own thread: XLA compiles them side by side
    parts = [lambda n=n: _serve_fixed_case(n) for n in K.SERVE_FIXED]
    parts += [_serve_paged, _serve_sampler, _serve_loop]
    out = {}
    with ThreadPoolExecutor(len(parts)) as ex:
        for res in ex.map(lambda f: f(), parts):
            out.update(res)
    return out


def _serve_fixed_case(name: str) -> dict:
    from repro.core import quant as Q
    from repro.core.mics import MiCSConfig
    from repro.runtime.serving import build_serve_steps

    _, lay, order, inner, _, int8 = K.SERVE_FIXED[name]
    model, topo, params = _serve_setup(name)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    if int8:   # eager, outside jit: the port's bytes
        params = Q.quantize_state(params)
    mcfg = MiCSConfig(gather_dtype=jnp.float32, gather_order=order,
                      hierarchy_inner=inner, quant_gather=int8)
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, K.SERVE_CACHE)
    prompts, tok = K.serve_inputs(name)
    batch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    if K.serve_vision(name) is not None:
        batch["vision"] = jnp.asarray(K.serve_vision(name))
    logits, caches = prefill_fn(params, batch)
    out = {f"{name}.prefill": np.asarray(logits)}
    tok = jnp.asarray(tok, jnp.int32)
    toks = []
    for i in range(K.SERVE_STEPS):
        logits, tok, caches = decode_fn(params, caches, tok, jnp.int32(K.SERVE_T + i))
        out[f"{name}.decode{i}"] = np.asarray(logits)
        toks.append(np.asarray(tok)[:, 0])
    out[f"{name}.tokens"] = np.stack(toks, axis=1)
    return out


def _serve_paged() -> dict:
    from repro.core.mics import MiCSConfig
    from repro.runtime import paged as PG

    out = {}
    for lay in K.SERVE_PAGED:
        model, topo, params = _serve_setup(f"llama@{lay}")
        params = {k: jnp.asarray(v) for k, v in params.items()}
        tables, nb = K.paged_tables(K.PAGED_PLENS, topo.data_parallel_size)
        width = max(K.PAGED_PLENS)
        mcfg = MiCSConfig(gather_dtype=jnp.float32, kv_dtype="fp32", kv_block_size=K.PAGED_BS)
        step = PG.build_paged_step(model, topo, mcfg, max_blocks=tables.shape[1],
                                   block_size=K.PAGED_BS, chunk=width, kv_dtype="fp32")
        pool, _ = PG.init_paged_caches(model, topo, nb, K.PAGED_BS, "fp32")
        toks = K.paged_prompts().astype(np.int32)
        pos = np.zeros(len(K.PAGED_PLENS), np.int32)
        n_new = np.asarray(K.PAGED_PLENS, np.int32)
        for i in range(1 + K.PAGED_STEPS):
            t, lg, pool = step(params, pool, jnp.asarray(toks), jnp.asarray(pos),
                               jnp.asarray(n_new), jnp.asarray(tables),
                               jnp.asarray(K.PAGED_SEEDS, jnp.int32),
                               jnp.zeros(len(n_new), jnp.float32))
            out[f"paged.{lay}.logits{i}"] = np.asarray(lg)
            out[f"paged.{lay}.tokens{i}"] = np.asarray(t)
            pos = pos + n_new
            n_new = np.ones_like(n_new)
            toks = np.zeros_like(toks)
            toks[:, 0] = np.asarray(t)
    return out


def _serve_sampler() -> dict:
    from repro.core.topology import MODEL_AXIS
    from repro.models import layers as L
    from repro.models import lm

    out = {}
    for lay in K.SAMPLER_LAYOUTS:
        topo = topology(lay)
        ctx = L.Ctx(mode="decode", tp=topo.model_size, tp_axis=MODEL_AXIS)

        def body(lg):
            ids = lm.sample_tokens(lg, ctx, K.VR, seed=jnp.asarray(K.SAMPLER_SEEDS, jnp.int32),
                                   pos=jnp.asarray(K.SAMPLER_POS, jnp.int32),
                                   temperature=jnp.asarray(K.SAMPLER_TEMPS))
            return ids[None]

        run = jax.jit(shard_map(body, mesh=topo.mesh, in_specs=P(None, MODEL_AXIS),
                                out_specs=P(MICS_AXES), check_vma=False))
        out[f"sampler.{lay}"] = np.asarray(run(jnp.asarray(K.sampler_logits())))
    return out


def _serve_loop() -> dict:
    import json

    from repro.core.mics import MiCSConfig
    from repro.runtime.batching import Request
    from repro.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    model, topo, params = _serve_setup("llama@P2T2")
    params = {k: jnp.asarray(v) for k, v in params.items()}
    mcfg = MiCSConfig(gather_dtype=jnp.float32, kv_dtype="fp32",
                      kv_block_size=K.CHAOS_GEOMETRY["block_size"])
    loop = ResilientServeLoop(model, topo, mcfg, ServeLoopConfig(**K.CHAOS_GEOMETRY, seed=0),
                              params_for=lambda model, topo: params)
    rep = loop.run(K.chaos_requests(Request), K.CHAOS_ARRIVALS)
    return {"chaos.free4.json": np.asarray(json.dumps(
        {"completions": rep["completions"], "ledger": rep["ledger"], "ticks": rep["ticks"]},
        default=str))}


def main():
    mode, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
    res = {"collectives": collectives, "train": train, "init": init,
           "tp_layers": tp_layers, "tp_train": tp_train, "elastic": elastic,
           "serve": serve}[mode]()
    np.savez(out_dir / f"jax_{mode}.npz", **res)


if __name__ == "__main__":
    main()
