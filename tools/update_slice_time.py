"""Train-step time of the one-card train runs at two AdamW update-slice sizes.

    python tools/update_slice_time.py [--runs NAME,...] [--slices 26,24] [--steps 3]

On the card, for each of ``chip_smoke.py``'s one-card train runs (the runs
of ``tools/memplan_probe.py``: its ``TRAIN`` paths, the ``train_knobs``
variants, ``train_moe``, ``train_xlstm``, ``train_whisper`` and
``train_bert``, at their shapes and depths) it builds
``core/mics.build_train_step`` and ``init_state(seed=0)`` once, runs one
step to warm up, and then ``--steps`` steps at each slice size
``core/schedule.UPDATE_SLICE = 2^k`` of ``--slices`` in the order a, b, b, a,
so that a drift of the card weighs on both.  AdamW updates a row ``2^k``
elements at a time; the result is bitwise the same at every size.  Each
run prints a JSON line: for each size, the steps' wall times (ms, the card
synchronised after each step) and the boundary's span on the stream (ms,
CUDA events around ``core/mics.apply_boundary``), and their medians.  The
lines also go to ``--out`` (default ``build/update_slice_time.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def time_run(cs, probe, name: str, dev, slices: list[int], steps: int) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import mics, schedule
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    path, layers, knobs = probe.runs(cs)[name]
    cfg = get_config(path.arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, tp=1)
    mcfg = mics.MiCSConfig(micro_steps=path.micro_steps, **knobs)
    if cfg.family == "encdec":
        batch_of = cs.whisper_batches(cfg, path, dev)
    else:
        batch_of = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                          global_batch=path.global_batch,
                                          micro_steps=path.micro_steps)).global_step_batch
    step = mics.build_train_step(model, MiCSTopology(), mcfg,
                                 OptConfig(warmup_steps=0, total_steps=1000), device=dev)
    state = mics.init_state(model, 0, device=dev, offload_opt=mcfg.offload_opt)
    spans = []
    apply_boundary = mics.apply_boundary

    def timed_boundary(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = apply_boundary(*a, **k)
        end.record()
        spans.append((start, end))
        return out

    default = schedule.UPDATE_SLICE
    order = [slices[0], slices[1], slices[1], slices[0]]
    times = {k: {"step_ms": [], "boundary_ms": []} for k in slices}
    mics.apply_boundary = timed_boundary
    try:
        i = 0
        state, _ = step(state, batch_of(i))   # warm-up
        torch.cuda.synchronize()
        for k in order:
            schedule.UPDATE_SLICE = 1 << k
            for _ in range(steps):
                i += 1
                spans.clear()
                t0 = time.perf_counter()
                state, metrics = step(state, batch_of(i))
                torch.cuda.synchronize()
                times[k]["step_ms"].append((time.perf_counter() - t0) * 1e3)
                times[k]["boundary_ms"].append(sum(s.elapsed_time(e) for s, e in spans))
    finally:
        mics.apply_boundary = apply_boundary
        schedule.UPDATE_SLICE = default
    del state, step
    torch.cuda.empty_cache()
    out = {"run": name, "arch": path.arch, "layers": cfg.n_layers, "steps": steps,
           "order": [f"2^{k}" for k in order], "default_slice": f"2^{default.bit_length() - 1}"}
    for k, t in times.items():
        out[f"2^{k}"] = {**t, "step_ms_median": statistics.median(t["step_ms"]),
                         "boundary_ms_median": statistics.median(t["boundary_ms"])}
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import torch

    import chip_smoke as cs
    import memplan_probe as probe

    names = list(probe.runs(cs))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(names), help=f"of {names}")
    ap.add_argument("--slices", default="26,24", help="two exponents k of UPDATE_SLICE = 2^k")
    ap.add_argument("--steps", type=int, default=3, help="timed steps a size and pass")
    ap.add_argument("--out", default=str(ROOT / "build" / "update_slice_time.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_slice_time: no CUDA device", file=sys.stderr)
        return 2
    slices = [int(k) for k in args.slices.split(",")]
    if len(slices) != 2:
        raise SystemExit("--slices takes two exponents")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        for name in args.runs.split(","):
            line = time_run(cs, probe, name, dev, slices, args.steps)
            line["gpu"] = card
            text = json.dumps(line)
            print(text, flush=True)
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
