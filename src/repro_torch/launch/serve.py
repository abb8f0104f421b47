"""Serving launcher of the port: fixed-batch prefill + decode, or the
resilient continuous-batching engine.

  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \\
      --prompt-len 512 --decode-tokens 32            # on the card
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 4 \\
      --prompt-len 2560 --decode-tokens 32           # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --decode-tokens 4         # plain path, CPU

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --decode-tokens 4 --quant-gather  # stored int8 weights

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --smoke --device cpu --decode-tokens 4         # MoE: 8 experts, top-2

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --continuous --requests 8 --max-queue 6 \\
      --deadline-ms 2000 --shed-policy degrade --fault-plan crash@6

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch llama3.2-1b --smoke --device cpu --dist-backend gloo \\
      --continuous --fault-plan preempt@4x1,grow@8x1   # 2 ranks, world changes

Weights are random, made from ``--seed``.  ``--quant-gather`` stores them
as int8 with fp32 block scales (``quant.quantize_state``) and dequantizes
each layer's row at every step.  The fixed-batch path serves on one rank,
as the reference's does; for the VLM (``--arch llama-3.2-vision-90b``) its
batch carries the stub vision frontend's patch embeddings, for whisper
(``--arch whisper-large-v3``) the stub audio frontend's frame embeddings,
drawn after the prompts from the same generator (:func:`stub_batch`).

``--continuous`` serves a seeded request trace through the resilient
continuous-batching engine (``runtime/resilient.py``: the paged KV pool at
``--kv-dtype`` / ``--kv-block-size``, chunked prefill interleaved with
decode, the seeded sampler at temperature 0.7 with top-k 8) with
deadline-aware admission (``--deadline-ms``, mapped to scheduler ticks by
rank 0's measured warm step), a bounded queue (``--max-queue``), graceful
degradation (``--shed-policy degrade``) and a scripted fault timeline
(``--fault-plan``, ``core/faults.FaultPlan.parse``: ``preempt``,
``notice``, ``grow``, ``slow``, ``evict``, ``crash``).  Under ``torchrun``
it spans the launch world, as the reference's ``serve_continuous`` spans
its devices: dp = world, p 1, tp 1 (``--dist-backend`` is required when
``WORLD_SIZE`` > 1, ``--dist-timeout-s`` bounds every collective), so the
plan's world changes have ranks to lose and to win back; a plan whose world
would leave the launch world (fewer than one rank, more than it has) is
refused before anything runs.  Rank 0 prints the warm tick, the served
counts and tokens/s, the request-lifecycle ledger, the world changes and
crashes and the ladder transitions.  The engine serves the dense and MoE
families (griffin's windowed and recurrent caches, xLSTM's states, the
VLM's cross caches and enc-dec's encoder are not paged, as in the
reference); an MoE
model's dead rows take no expert slot.  ``--policy auto`` hands the gather
policy, the prefetch toggle, the KV dtype (``--kv-dtype`` is then the
numerics ceiling) and the residency (from the memory planner) to the
autotuner over ``--link-profile``
(``core/autotune.resolve_config(mode="serve")``), which prints its ranked
table and the chosen serve policy first.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.autotune import resolve_config
from repro_torch.core.faults import FaultPlan
from repro_torch.core.linkmodel import DEFAULT_PROFILE, PROFILES
from repro_torch.core.mics import MiCSConfig, init_params
from repro_torch.core.quant import quantize_state
from repro_torch.core.topology import MiCSTopology, elastic_host_topology
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import BACKENDS, MiCSGroups, init_distributed, meet
from repro_torch.models.build import build_model
from repro_torch.runtime.serving import build_serve_steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plan_worlds(plan: FaultPlan, world: int) -> list[int]:
    """The world after each of ``plan``'s world-changing events, in tick
    order, from ``world`` ranks (tp 1: an eviction loses one rank)."""
    out = []
    for ev in sorted(plan.events, key=lambda e: e.at_step):
        if ev.kind == "preempt":
            world -= ev.devices
        elif ev.kind == "grow":
            world += ev.devices
        elif ev.kind == "slow" and ev.evict:
            world -= 1
        else:
            continue
        out.append(world)
    return out


def serve_continuous(cfg, mcfg: MiCSConfig, args, dev: torch.device, groups=None) -> None:
    """The resilient continuous-batching path (``runtime/resilient.py``) on
    ``groups``' world (one rank without)."""
    from repro_torch.runtime.batching import DegradationLadder, Request
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    topo = MiCSTopology() if groups is None else groups.topo
    rank = 0 if groups is None else groups.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    model = build_model(cfg, tp=1)
    block_size = mcfg.kv_block_size
    positions = args.prompt_len + args.decode_tokens
    max_blocks = -(-positions // block_size)
    sc = ServeLoopConfig(
        slots_local=4, nb_local=4 * max_blocks + 1, block_size=block_size,
        max_blocks=max_blocks, chunk=min(8, args.prompt_len), top_k=8,
        reserve="full", max_queue=args.max_queue, backoff_base=2, seed=args.seed,
        arrival_rate=args.arrival_rate)
    ladder = None
    if args.shed_policy == "degrade":
        ladder = DegradationLadder(
            [{"kv_dtype": mcfg.kv_dtype, "resident_cap": 0, "label": "configured"},
             {"kv_dtype": mcfg.kv_dtype, "resident_cap": 2, "label": "tightened"}],
            high_water=0.75, low_water=0.25, dwell=4)
    fault = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    loop = ResilientServeLoop(model, topo, mcfg, sc, fault_injector=fault, ladder=ladder,
                              device=dev, groups=groups)

    # warm the step and measure it: the tick -> wall-time price that turns
    # --deadline-ms into a scheduler-tick deadline (rank 0's, for every rank)
    B = loop.batcher.batch
    zeros = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    for _ in range(3):
        t0 = time.perf_counter()
        tok, _lg, loop.caches = loop.step(
            loop.params, loop.caches, zeros(B, sc.chunk), zeros(B), zeros(B),
            zeros(B, max_blocks), zeros(B), np.zeros(B, np.float32))
        tok.cpu()
        tick_s = time.perf_counter() - t0
    deadline_ticks = (max(1, int(args.deadline_ms / 1e3 / tick_s))
                      if args.deadline_ms > 0 else None)
    if groups is not None:
        deadline_ticks = meet(deadline_ticks)
    say(f"warm engine step: {tick_s * 1e3:.1f} ms/tick"
        + (f" -> deadline {deadline_ticks} ticks" if deadline_ticks else ""))

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, args.prompt_len).astype(int)
                    .tolist(),
                    max_new_tokens=args.decode_tokens, temperature=0.7, seed=1000 + i,
                    deadline_tick=deadline_ticks)
            for i in range(args.requests)]
    arrivals = ([int(i / args.arrival_rate) for i in range(len(reqs))]
                if args.arrival_rate > 0 else None)

    t0 = time.perf_counter()
    rep = loop.run(reqs, arrivals)
    _sync(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(t) for t in rep["completions"].values())
    say(f"served {rep['ledger']['completed']}/{len(reqs)} requests, "
        f"{tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s), "
        f"{rep['ticks']} ticks on a {rep['world']}-device world ({dev}, "
        f"{rep['kv_dtype']} KV)")
    say("lifecycle ledger:", json.dumps(rep["ledger"], indent=1))
    if rep["world_changes"]:
        say("crashes and world changes:", json.dumps(
            [{k: v for k, v in e.items() if k not in ("comm", "rebuild_s")}
             for e in rep["world_changes"]], indent=1, default=str))
    if rep["ladder_transitions"]:
        say("ladder transitions:", json.dumps(rep["ladder_transitions"], indent=1))
    if rep["shed"]:
        say("shed:", rep["shed"])
    if not rep["ledger"]["accounted"]:
        raise RuntimeError("lifecycle ledger lost a request")


def stub_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The fixed batch's inputs, from one ``np.random.default_rng(seed)``:
    the prompts ``[batch, prompt_len]``, then for the VLM the stub vision
    frontend's patch embeddings ``[batch, n_vision_tokens, d_model]`` and
    for enc-dec the stub audio frontend's frame embeddings ``[batch,
    n_audio_frames, d_model]``, normal, bf16 (the reference launcher's
    draws, in its order)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))).to(device)}
    if cfg.family == "vlm":
        out["vision"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_vision_tokens, cfg.d_model))).to(torch.bfloat16).to(device)
    if cfg.family == "encdec":
        out["audio"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.n_audio_frames, cfg.d_model))).to(torch.bfloat16).to(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--prefetch", type=int, default=1,
                    help="1 = lookahead gathers, 0 = serial")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=["manual", "auto"], default="manual",
                    help="'auto' picks the gather policy, the KV dtype and the residency "
                         "from --link-profile")
    ap.add_argument("--link-profile", default=DEFAULT_PROFILE, choices=sorted(PROFILES))
    ap.add_argument("--quant-gather", action="store_true",
                    help="store the weights int8 (+ fp32 block scales), dequantized each step")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="[--continuous] requests a tick offered (0 = all at tick 0)")
    ap.add_argument("--kv-dtype", choices=["fp32", "bf16", "int8"], default="bf16",
                    help="[--continuous] paged-KV storage dtype")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="[--continuous] paged-KV block size in token positions")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching through the resilient serve loop instead of "
                         "the fixed-batch path")
    ap.add_argument("--requests", type=int, default=8,
                    help="[--continuous] synthetic requests to serve")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="[--continuous] per-request completion SLO; mapped to scheduler "
                         "ticks via the measured warm step time (0 = no deadline)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="[--continuous] waiting-queue bound; submissions beyond it are "
                         "shed with reason queue_full (0 = unbounded)")
    ap.add_argument("--shed-policy", choices=["reject", "degrade"], default="reject",
                    help="[--continuous] 'reject' sheds typed on overload; 'degrade' also "
                         "walks the degradation ladder (residency tightening) under queue "
                         "pressure")
    ap.add_argument("--fault-plan", default="",
                    help="[--continuous] scripted fault timeline, e.g. "
                         "'preempt@20x1,grow@40x1,crash@60' (kind@tick[xN]; kinds: preempt "
                         "notice grow slow evict crash; the world changes need ranks "
                         "to lose, under torchrun)")
    ap.add_argument("--dist-backend", choices=BACKENDS, default=None,
                    help="[--continuous] collectives backend, required when WORLD_SIZE > 1")
    ap.add_argument("--dist-timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not args.continuous:
        ap.error(f"WORLD_SIZE={world}: the fixed-batch path serves on one rank; "
                 "--continuous spans the launch world")
    if world > 1 and args.dist_backend is None:
        ap.error(f"WORLD_SIZE={world}: --dist-backend nccl or gloo is required")
    if args.fault_plan:
        for n in plan_worlds(FaultPlan.parse(args.fault_plan), world):
            if not 1 <= n <= world:
                ap.error(f"--fault-plan {args.fault_plan!r} takes the world to {n} rank(s); "
                         f"the launch world has {world}")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    mcfg = MiCSConfig(prefetch=bool(args.prefetch), quant_gather=args.quant_gather,
                      kv_dtype=args.kv_dtype, kv_block_size=args.kv_block_size,
                      policy=args.policy, link_profile=args.link_profile)
    cache_len = args.prompt_len + args.decode_tokens
    rank0 = int(os.environ.get("RANK", "0")) == 0
    topo = elastic_host_topology(world, 1, available=world) if args.continuous else MiCSTopology()
    model = build_model(cfg, tp=topo.model_size)
    mcfg, plan = resolve_config(mcfg, model, topo, mode="serve", seq=cache_len,
                                arrival_rate=args.arrival_rate)
    if plan is not None and rank0:
        print(plan.table())
        print(f"serve policy: kv_dtype={mcfg.kv_dtype} kv_block_size={mcfg.kv_block_size} "
              f"max_resident_requests={mcfg.max_resident_requests}")
    if args.continuous:
        if mcfg.quant_gather:
            # the loop's params provider reloads fp32 weights on every
            # rebuild; the int8 wire stays a fixed-batch feature, as in the
            # reference
            mcfg = dataclasses.replace(mcfg, quant_gather=False)
        groups = None
        if world > 1:
            timeout = datetime.timedelta(seconds=args.dist_timeout_s)
            rank, world = init_distributed(args.dist_backend, timeout=timeout)
            groups = MiCSGroups(elastic_host_topology(world, 1, available=world), rank,
                                backend=args.dist_backend, timeout=timeout)
        serve_continuous(cfg, mcfg, args, dev, groups)
        if groups is not None:
            dist.destroy_process_group()
        return
    params = init_params(model, args.seed, device=dev)
    if mcfg.quant_gather:
        params = quantize_state(params)
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, cache_len, device=dev)

    batch = stub_batch(cfg, args.batch, args.prompt_len, args.seed, dev)

    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, batch)
    _sync(dev)
    wire = ("int8 weights" if mcfg.quant_gather else
            "bf16 gather" if mcfg.gather_dtype == torch.bfloat16 else "fp32 gather")
    print(f"prefill {args.batch}x{args.prompt_len} ({wire}): "
          f"{time.perf_counter() - t0:.3f}s")

    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    outs = []
    t0 = time.perf_counter()
    for i in range(args.decode_tokens):
        logits, tok, caches = decode_fn(params, caches, tok, args.prompt_len + i)
        outs.append(tok[:, 0])
    _sync(dev)
    dt = time.perf_counter() - t0
    ids = torch.stack(outs, dim=1).cpu().tolist() if outs else []
    print(f"decoded {args.decode_tokens} tokens x{args.batch} in {dt:.3f}s "
          f"({args.decode_tokens * args.batch / max(dt, 1e-9):.1f} tok/s) on {dev}")
    print("sampled ids:", ids)


if __name__ == "__main__":
    main()
