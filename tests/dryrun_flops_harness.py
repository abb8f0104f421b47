"""The JAX package's dry-run statistics of one smoke train cell, run in a
subprocess with 16 virtual CPU devices (the pattern of autotune_harness.py).
Prints one JSON object: ``hlo_stats.analyze(...)`` of the compiled step's
``dot_flops``, ``by_stage`` and the mesh, for tests/test_torch_dryrun.py,
which holds the port's counted step (``repro_torch/launch/dryrun.py``) to it.

The cell (shared with the test through ``SMOKE_TRAIN``): smoke llama3.2-1b,
a (repl 2, shard 4, model 2) mesh, 4 micro-steps, global batch 32 x 32
tokens, the serial schedule and fp32 gather (no prefetch).
"""

import os

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=16 "
    + os.environ.get("XLA_FLAGS", "")
)

import json

import jax.numpy as jnp

from repro.configs import get_config, smoke_variant
from repro.core.mics import MiCSConfig, build_train_step, init_state_shapes, make_batch_shapes
from repro.core.topology import MiCSTopology, make_host_mesh
from repro.models.build import build_model
from repro.optim.adamw import OptConfig
from repro.roofline.hlo_stats import analyze

SMOKE_TRAIN = {"arch": "llama3.2-1b", "repl": 2, "shard": 4, "model": 2, "micro_steps": 4,
               "global_batch": 32, "seq": 32}


def main():
    c = SMOKE_TRAIN
    model = build_model(smoke_variant(get_config(c["arch"])), tp=c["model"])
    topo = MiCSTopology(make_host_mesh(1, c["repl"], c["shard"], c["model"]),
                        partition_axes=("shard",), replication_axes=("repl",))
    mcfg = MiCSConfig(micro_steps=c["micro_steps"], gather_dtype=jnp.float32, prefetch=False)
    step = build_train_step(model, topo, mcfg, OptConfig(total_steps=10))
    text = step.lower(
        init_state_shapes(model),
        make_batch_shapes(model, c["global_batch"], c["seq"], c["micro_steps"]),
    ).compile().as_text()
    mesh_shape = dict(zip(topo.mesh.axis_names, topo.mesh.devices.shape))
    stats = analyze(text, mesh_shape, partition_axes=topo.partition_axes,
                    replication_axes=topo.replication_axes)
    print(json.dumps({"dot_flops": stats["dot_flops"], "by_stage": stats["by_stage"],
                      "mesh": mesh_shape}))


if __name__ == "__main__":
    main()
