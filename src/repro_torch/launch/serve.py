"""Serving launcher of the port: fixed-batch prefill + greedy decode.

  python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \
      --prompt-len 512 --decode-tokens 32            # on the card
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 4 \
      --prompt-len 2560 --decode-tokens 32           # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --decode-tokens 4         # plain path, CPU

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --decode-tokens 4 --quant-gather  # stored int8 weights

Weights are random, made from ``--seed``.  ``--quant-gather`` stores them
as int8 with fp32 block scales (``quant.quantize_state``) and dequantizes
each layer's row at every step.  ``--continuous`` and ``--policy auto``
belong to later slices and are refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.mics import MiCSConfig, init_params
from repro_torch.core.quant import quantize_state
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models.build import build_model
from repro_torch.runtime.serving import build_serve_steps

LATER = {
    "continuous": "continuous batching comes with the paged-KV / continuous-batching slice",
    "policy": "--policy auto (the link-model autotuner) comes with the planner/tuner slice",
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    ap.add_argument("--continuous", action="store_true", help="not in this slice")
    ap.add_argument("--policy", choices=["manual", "auto"], default="manual",
                    help="'auto' is not in this slice")
    ap.add_argument("--quant-gather", action="store_true",
                    help="store the weights int8 (+ fp32 block scales), dequantized each step")
    args = ap.parse_args(argv)
    if args.continuous:
        ap.error(LATER["continuous"])
    if args.policy != "manual":
        ap.error(LATER["policy"])

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    topo = MiCSTopology()
    model = build_model(cfg, tp=topo.model_size)
    params = init_params(model, args.seed, device=dev)
    if args.quant_gather:
        params = quantize_state(params)
    mcfg = MiCSConfig(prefetch=bool(args.prefetch), quant_gather=args.quant_gather)
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
