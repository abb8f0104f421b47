"""Time the ``paged`` flash-attention route of a checkout at the
continuous-batching engine's shapes, on the card.

    python tools/paged_bench.py [--src DIR] [--profile]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that one command can time an earlier checkout
unpacked beside this one and this one in turns, on the same card.  The
cases are ``chip_smoke.py``'s ``paged_kernel_cases`` (this checkout's:
llama's 8 KV heads at dh 64, 8 requests over a pool of blocks of 16, bf16
and int8 pages).  A case with padding rows is timed twice: with the
engine's lengths (a row past its slot's ``n_new`` dead, length 0) and
``padded``, every row given ``position + 1`` (an idle slot at position 0),
as an engine that does not mark its padding launches it.  Each time is the
median of 20 CUDA-event times with L2 flushed (``chip_smoke.time_ms``).
Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
package timed and each case's ms; with ``--profile`` also each case's
device time a call by kernel (``torch.profiler`` over 10 calls, the
engine's lengths).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def kernel_us(fn, calls: int = 10) -> dict:
    """Device microseconds a call by kernel name, over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        if us:
            out[ev.key[:80]] = us / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also the device time a call by kernel")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        print("paged_bench: no CUDA card", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))  # ahead of the src chip_smoke put first
    from repro_torch.kernels.flash_attention import kernel as FA

    if not pathlib.Path(FA.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch came from {FA.__file__}, not {src}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    out = []
    for kind, q, kp, vp, tables, kvl, sc in C.paged_kernel_cases(
            torch.Generator(device=dev).manual_seed(3), dev):
        tq = kvl.shape[1]
        base = torch.where(kvl[:, :1] > 0, kvl[:, :1] - 1, 0)
        variants = {"engine": kvl}
        if bool((kvl == 0).any()):
            variants["padded"] = torch.where(kvl > 0, kvl,
                                             base + torch.arange(1, tq + 1, device=dev))
        for name, lens in variants.items():
            ms = C.time_ms(lambda: FA.paged_attention(q, kp, vp, tables, lens, **sc), flush)
            row = {"case": kind, "lengths": name, "ms": ms}
            if args.profile and name == "engine":
                row["kernels_us"] = kernel_us(
                    lambda: FA.paged_attention(q, kp, vp, tables, lens, **sc))
            out.append(row)
    print(json.dumps({"card": card, "src": str(src), "paged": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
