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

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu --continuous --requests 8 --max-queue 6 \\
      --deadline-ms 2000 --shed-policy degrade --fault-plan crash@6

Weights are random, made from ``--seed``.  ``--quant-gather`` stores them
as int8 with fp32 block scales (``quant.quantize_state``) and dequantizes
each layer's row at every step.

``--continuous`` serves a seeded request trace through the resilient
continuous-batching engine (``runtime/resilient.py``: the paged KV pool at
``--kv-dtype`` / ``--kv-block-size``, chunked prefill interleaved with
decode, the seeded sampler at temperature 0.7 with top-k 8) with
deadline-aware admission (``--deadline-ms``, mapped to scheduler ticks by
the measured warm step), a bounded queue (``--max-queue``), graceful
degradation (``--shed-policy degrade``) and a scripted fault timeline
(``--fault-plan``, ``core/faults.FaultPlan.parse``; on one rank only
``crash`` runs: the other kinds change the world, ROADMAP Queue 1 item
6b).  It prints the warm tick, the served counts and tokens/s, the
request-lifecycle ledger, crashes and ladder transitions.  The dense
family only: griffin's windowed and recurrent caches are not paged.
``--policy auto`` belongs to a later slice and is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.faults import FaultPlan
from repro_torch.core.mics import MiCSConfig, init_params
from repro_torch.core.quant import quantize_state
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.serving import build_serve_steps

LATER = {
    "policy": "--policy auto (the link-model autotuner) comes with the planner/tuner slice",
    "fault_kinds": "--fault-plan on one rank runs only 'crash': the other kinds change the "
                   "world, which serving over ranks brings (ROADMAP Queue 1 item 6b)",
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_continuous(cfg, mcfg: MiCSConfig, args, dev: torch.device) -> None:
    """The resilient continuous-batching path (``runtime/resilient.py``)."""
    from repro_torch.runtime.batching import DegradationLadder, Request
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    topo = MiCSTopology()
    model = build_model(cfg, tp=1)
    block_size = mcfg.kv_block_size
    positions = args.prompt_len + args.decode_tokens
    max_blocks = -(-positions // block_size)
    sc = ServeLoopConfig(
        slots_local=4, nb_local=4 * max_blocks + 1, block_size=block_size,
        max_blocks=max_blocks, chunk=min(8, args.prompt_len), top_k=8,
        reserve="full", max_queue=args.max_queue, backoff_base=2, seed=args.seed)
    ladder = None
    if args.shed_policy == "degrade":
        ladder = DegradationLadder(
            [{"kv_dtype": mcfg.kv_dtype, "resident_cap": 0, "label": "configured"},
             {"kv_dtype": mcfg.kv_dtype, "resident_cap": 2, "label": "tightened"}],
            high_water=0.75, low_water=0.25, dwell=4)
    fault = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    loop = ResilientServeLoop(model, topo, mcfg, sc, fault_injector=fault, ladder=ladder,
                              device=dev)

    # warm the step and measure it: the tick -> wall-time price that turns
    # --deadline-ms into a scheduler-tick deadline
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
    print(f"warm engine step: {tick_s * 1e3:.1f} ms/tick"
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
    print(f"served {rep['ledger']['completed']}/{len(reqs)} requests, "
          f"{tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s), "
          f"{rep['ticks']} ticks on a {rep['world']}-device world ({dev}, "
          f"{rep['kv_dtype']} KV)")
    print("lifecycle ledger:", json.dumps(rep["ledger"], indent=1))
    if rep["world_changes"]:
        print("crashes and world changes:", json.dumps(rep["world_changes"], indent=1,
                                                       default=str))
    if rep["ladder_transitions"]:
        print("ladder transitions:", json.dumps(rep["ladder_transitions"], indent=1))
    if rep["shed"]:
        print("shed:", rep["shed"])
    if not rep["ledger"]["accounted"]:
        raise RuntimeError("lifecycle ledger lost a request")


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
                    help="'auto' is not in this slice")
    ap.add_argument("--quant-gather", action="store_true",
                    help="store the weights int8 (+ fp32 block scales), dequantized each step")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="[--continuous] requests a tick offered (0 = all at tick 0)")
    ap.add_argument("--kv-dtype", choices=["fp32", "bf16", "int8"], default="bf16",
                    help="[--continuous] paged-KV storage dtype (fp32 pools: CPU only)")
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
                    help="[--continuous] scripted fault timeline, e.g. 'crash@6' "
                         "(kind@tick[xN]; one rank runs only crash)")
    args = ap.parse_args(argv)
    if args.policy != "manual":
        ap.error(LATER["policy"])
    if args.fault_plan and any(ev.kind != "crash"
                               for ev in FaultPlan.parse(args.fault_plan).events):
        ap.error(LATER["fault_kinds"])

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    mcfg = MiCSConfig(prefetch=bool(args.prefetch), quant_gather=args.quant_gather,
                      kv_dtype=args.kv_dtype, kv_block_size=args.kv_block_size)
    if args.continuous:
        if mcfg.quant_gather:
            # the loop's params provider reloads fp32 weights on every
            # rebuild; the int8 wire stays a fixed-batch feature, as in the
            # reference
            mcfg = dataclasses.replace(mcfg, quant_gather=False)
        serve_continuous(cfg, mcfg, args, dev)
        return
    topo = MiCSTopology()
    model = build_model(cfg, tp=topo.model_size)
    params = init_params(model, args.seed, device=dev)
    if args.quant_gather:
        params = quantize_state(params)
    cache_len = args.prompt_len + args.decode_tokens
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, cache_len, device=dev)

    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)

    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, {"tokens": tokens})
    _sync(dev)
    wire = "int8 weights" if args.quant_gather else "bf16 gather"
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
