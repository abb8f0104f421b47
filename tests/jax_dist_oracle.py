"""The JAX package's answers to the cases of ``torch_dist_cases.py`` on 4
virtual CPU devices, jitted, written to ``<out>/jax_<mode>.npz``.

    python tests/jax_dist_oracle.py collectives|train|init OUT_DIR

``collectives``: ``repro.core.collectives`` under ``shard_map`` on
``make_host_mesh`` meshes, each device's input row r of the case's input,
its output row r of the result.  ``train``: ``repro.core.mics``'s
``init_state`` and ``build_train_step`` for the smoke llama3.2-1b, STEPS
steps a case: each step's loss and grad_norm, the initial and final global
state.  ``init``: that initial state alone, from one device (the state is
a function of the model and the seed, not of the layout).
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
    (pod, repl, shard, dp2), part, rep = K.LAYOUTS[layout]
    mesh = make_host_mesh(pod, repl, shard, 1, dp2)
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


def main():
    mode, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
    res = {"collectives": collectives, "train": train, "init": init}[mode]()
    np.savez(out_dir / f"jax_{mode}.npz", **res)


if __name__ == "__main__":
    main()
