"""Training launcher of the port.

  python -m repro_torch.launch.train --arch llama3.2-1b \
      --global-batch 8 --seq 2048 --micro-steps 2 --steps 4     # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 4                           # plain path, CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --smoke --device cpu --dist-backend gloo \
      --partition-size 4 --gather-order outer_first --steps 4  # 4 ranks
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --smoke --device cpu --dist-backend gloo \
      --partition-size 2 --tp 2 --steps 4                      # p 2 x tp 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 4 --prefetch-carry remat    # the remat carry
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 4 --carry-offload host \
      --offload-opt --clip-mode approx                         # host carry and moments
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --smoke --device cpu --dist-backend gloo \
      --partition-size 2 --hop1-wire-dtype bf16 --compress-hop2 int8 \
      --steps 4                                                # the wires
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 2 --policy auto --link-profile efa-100g \
      --hbm-budget-gb 1                                        # the autotuner

Weights are random, made from ``--seed``; the data is the seeded synthetic
stream.  The flags are the reference's (``repro/launch/train.py``) plus
``--device``, ``--dist-backend`` (``nccl``: one card a rank; ``gloo``:
anywhere, CUDA tensors through pinned host buffers; required when
``WORLD_SIZE`` > 1), ``--dist-timeout-s`` and ``--tp``.  Under ``torchrun``
the world is laid out as ``(repl, shard = --partition-size, model = --tp)``
(the reference sizes its model axis from the mesh), or as ZeRO-3 with
``--zero3``.  The one-card knobs run: ``--prefetch-carry remat``,
``--carry-offload host`` (the stored carry in pinned host memory),
``--offload-opt`` (AdamW's m and v in pinned host memory) and ``--clip-mode
approx``; a line says which carry, where the moments live and which clip.
The wires: ``--quant-gather`` (the int8 gather), ``--hop1-wire-dtype``
and ``--compress-hop2`` (fp32, bf16 or int8 gradient wires) and
``--grad-rounding`` (the int8 gradient wires' rounding); a line says
which.  ``--policy auto`` hands the gather topology, the wires, the
boundary schedule and (under ``--hbm-budget-gb``, GiB) the carry to the
autotuner over ``--link-profile`` (``core/autotune.py``; the flags of the
lossy wires and the approximate clip become permissions), resolved before
the process groups are built; it prints the ranked candidates, and every
run prints the boundary's modeled hop-2 time on the profile and the memory
plan (``core/memplan.py``, GiB).  Under a budget no candidate fits raises
``MemoryBudgetError`` before any state is made.  ``--arch
llama-3.2-vision-90b`` and ``--arch whisper-large-v3`` raise
``NotImplementedError``: the VLM's steps take ``vision`` rows and enc-dec's
``audio`` frames (``core/mics.build_train_step``), which neither the
reference's launcher nor its data pipeline makes.  The paper's LayerNorm +
GeLU configs (``bert-10b`` ... ``gpt2-20b``, dense) train here.  Only rank
0 prints.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os

import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import memplan
from repro_torch.core.autotune import cost_hop2_schedule, resolve_config
from repro_torch.core.comm import policies_from_config
from repro_torch.core.linkmodel import DEFAULT_PROFILE, PROFILES, get_profile
from repro_torch.core.mics import MiCSConfig
from repro_torch.core.schedule import plan_boundary
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, MiCSGroups, init_distributed, make_mics_topology
from repro_torch.models.build import build_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.train_loop import LoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro-steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--policy", choices=["manual", "auto"], default="manual",
                    help="'auto' picks the gather policy, the wires and the boundary from "
                         "--link-profile (core/autotune.py)")
    ap.add_argument("--link-profile", default=DEFAULT_PROFILE, choices=sorted(PROFILES))
    ap.add_argument("--gather-order", default="inner_first",
                    choices=["inner_first", "outer_first"])
    ap.add_argument("--no-hierarchical", action="store_true")
    ap.add_argument("--quant-gather", action="store_true")
    ap.add_argument("--hop1-wire-dtype", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--compress-hop2", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--grad-rounding", default="stochastic", choices=["stochastic", "nearest"])
    ap.add_argument("--prefetch", type=int, default=1,
                    help="1 = lookahead gathers (default), 0 = serial")
    ap.add_argument("--prefetch-carry", default="stored", choices=["stored", "remat"])
    ap.add_argument("--carry-offload", default="none", choices=["none", "host"])
    ap.add_argument("--offload-opt", action="store_true")
    ap.add_argument("--clip-mode", default="exact", choices=["exact", "approx"])
    ap.add_argument("--hbm-budget-gb", type=float, default=0,
                    help="per-device HBM budget in GiB: the memory planner gates --policy "
                         "auto candidates on it (the remat and host carries join them); "
                         "0 = no budget")
    ap.add_argument("--boundary-schedule", default="bucketed", choices=["serial", "bucketed"])
    ap.add_argument("--hop2-bucket-mb", type=float, default=32.0)
    ap.add_argument("--partition-size", type=int, default=None,
                    help="p (default: the paper's heuristic, the smallest group that holds "
                         "one replica of the model states)")
    ap.add_argument("--zero3", action="store_true",
                    help="the ZeRO-3 baseline: partition over every data rank")
    ap.add_argument("--hierarchy-inner", type=int, default=None,
                    help="inner factor of the staged gather (default: largest power of two "
                         "<= sqrt(p))")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: the model axis, tp consecutive ranks")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="collectives backend, required when WORLD_SIZE > 1")
    ap.add_argument("--dist-timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    groups, rank = None, 0
    if world > 1:
        if args.dist_backend is None:
            ap.error(f"WORLD_SIZE={world}: --dist-backend nccl or gloo is required")
        rank, world = init_distributed(
            args.dist_backend, timeout=datetime.timedelta(seconds=args.dist_timeout_s))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if cfg.family in ("vlm", "encdec"):
        rows = {"vlm": ("vision rows", "vision"), "encdec": ("audio frames", "audio")}
        what, key = rows[cfg.family]
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family trains on batches with {what}, and the data "
            "pipeline makes none (nor do the reference's launcher and pipeline; ROADMAP "
            f"Queue 3): train it through core.mics.build_train_step with a batch's {key!r}")
    p = args.partition_size if args.partition_size is not None or world > 1 else 1
    topo = make_mics_topology(world, p, zero3=args.zero3, tp=args.tp,
                              param_count=cfg.param_count())
    model = build_model(cfg, tp=topo.model_size)
    mcfg = MiCSConfig(micro_steps=args.micro_steps,
                      hierarchical=not args.no_hierarchical,
                      gather_order=args.gather_order,
                      hierarchy_inner=args.hierarchy_inner,
                      quant_gather=args.quant_gather,
                      hop1_wire_dtype=args.hop1_wire_dtype,
                      compress_hop2=args.compress_hop2,
                      grad_rounding=args.grad_rounding,
                      prefetch=bool(args.prefetch),
                      prefetch_carry=args.prefetch_carry,
                      carry_offload=args.carry_offload,
                      offload_opt=args.offload_opt,
                      clip_mode=args.clip_mode,
                      policy=args.policy,
                      link_profile=args.link_profile,
                      boundary_schedule=args.boundary_schedule,
                      hop2_bucket_mb=args.hop2_bucket_mb,
                      hbm_budget_gb=args.hbm_budget_gb or None)
    say = print if rank == 0 else (lambda *a: None)
    local_batch = args.global_batch // args.micro_steps // topo.data_parallel_size
    mcfg, plan = resolve_config(mcfg, model, topo, mode="train", local_batch=local_batch,
                                seq=args.seq)
    if plan is not None:
        say(plan.table())
    if world > 1:
        groups = MiCSGroups(topo, rank, backend=args.dist_backend, inner=mcfg.hierarchy_inner,
                            timeout=datetime.timedelta(seconds=args.dist_timeout_s))
    bplan = plan_boundary(model, topo, mode=mcfg.boundary_schedule,
                          bucket_mb=mcfg.hop2_bucket_mb, clip_mode=mcfg.clip_mode)
    profile = get_profile(mcfg.link_profile)
    gp, sp = policies_from_config(mcfg)
    hop2 = cost_hop2_schedule(model, topo, profile, sp, boundary=mcfg.boundary_schedule,
                              bucket_mb=mcfg.hop2_bucket_mb, clip_mode=mcfg.clip_mode)
    mem = memplan.predict_footprint(
        model, topo, gp, sp, micro_steps=args.micro_steps, local_batch=local_batch,
        seq=args.seq, boundary=mcfg.boundary_schedule, hop2_bucket_mb=mcfg.hop2_bucket_mb,
        offload_opt=mcfg.offload_opt, mlstm_chunk=mcfg.mlstm_chunk)
    if world > 1:
        say(f"ranks: {world} over {args.dist_backend}, p={topo.partition_size} "
            f"({'ZeRO-3 ' if args.zero3 else ''}partition axes {list(topo.partition_axes)}), "
            f"{topo.replication_degree} replica(s), tp={topo.model_size}, gather "
            f"{'flat' if not mcfg.hierarchical else mcfg.gather_order}")
    say(f"boundary: {mcfg.boundary_schedule} x {bplan.n_buckets} buckets "
        f"({mcfg.hop2_bucket_mb:g} MB, clip={bplan.clip_mode}) - modeled hop-2 "
        f"{hop2['t_exposed_s'] * 1e6:.0f}us exposed / {hop2['t_total_s'] * 1e6:.0f}us total "
        f"on {profile.name}")
    say(f"memplan: {mem.total_gb:.3f} GiB predicted a device, {mem.reserved_bytes / 2**30:.3f} "
        f"GiB with the allocator's reserve (prefetch_carry="
        f"{mcfg.prefetch_carry}, carry_offload={mcfg.carry_offload}, "
        f"offload_opt={mcfg.offload_opt})")
    host = "host memory" + (" (pinned)" if dev.type == "cuda" else "")
    carry = ("none (serial: the backward re-gathers)" if not mcfg.prefetch else
             f"stored in {host}" if mcfg.carry_offload == "host" else
             "stored on the device" if mcfg.prefetch_carry == "stored" else "remat")
    moments = host if mcfg.offload_opt else "the device"
    say(f"knobs: prefetch carry {carry}; AdamW moments in {moments}; clip {mcfg.clip_mode}")
    say(f"wires: gather {'int8' if mcfg.quant_gather else 'bf16'}, hop 1 "
        f"{mcfg.hop1_wire_dtype}, hop 2 {mcfg.compress_hop2}, int8 rounding "
        f"{mcfg.grad_rounding}")
    oc = OptConfig(lr_max=args.lr, total_steps=args.steps,
                   warmup_steps=max(args.steps // 20, 1))
    dc = DataConfig(vocab=cfg.vocab, seq=args.seq, global_batch=args.global_batch,
                    micro_steps=args.micro_steps)
    lc = LoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                    checkpoint_dir=args.checkpoint_dir, seed=args.seed)
    stats = train(model, topo, mcfg, oc, dc, lc, device=dev, groups=groups)
    if stats.losses:
        say(f"final loss {stats.losses[-1]:.4f} over {len(stats.losses)} steps on {dev}")
    else:
        say(f"no steps to run: the checkpoint is at step {args.steps} already")
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
