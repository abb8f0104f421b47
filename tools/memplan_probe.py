"""Where a train step's device memory goes, against the memory planner.

    python tools/memplan_probe.py [--runs NAME,...] [--steps N] [--rows] [--out FILE]

On the card, for each of ``chip_smoke.py``'s one-card train runs (its
``TRAIN`` paths, the ``train_knobs`` variants, ``train_moe``,
``train_xlstm``, ``train_whisper`` and ``train_bert``, at their shapes and
depths, taken from the script's constants) it builds
``core/mics.build_train_step`` and ``init_state(seed=0)``, runs ``--steps``
steps (default 1) of the synthetic stream with the caching allocator's
history recorded, and prints a JSON line:

* ``memplan``: ``chip_smoke.memplan_record``, the plan at the run's shapes
  by component beside the step's peak and reserve and what ``init_state``
  made (no check: the script holds the runs to their limits);
* ``fwd_end_bytes``: allocated when the first micro-step's forward
  returns; ``boundary_peak_bytes``: the peak inside ``apply_boundary``;
* ``at_peak``: the live bytes at the step's peak by the innermost frame
  of the port that allocated them (the allocator's trace replayed to its
  largest point), the largest first.

With ``--rows`` each line is instead one row of the run's first layer pool
run as its checkpoint recomputes it (:func:`row_probe`): what its graph
saves beside the planner's ``layer_saved``, its forward and backward's
peak, and the share of the saved bytes that peak holds beyond them and the
row's cotangents (``core/memplan.LAYER_BACKWARD_SHARE``'s reading).

Byte counts are bytes; ``*_gb`` fields are 1e9 bytes, ``*_gib`` 2^30.  The
lines also go to ``--out`` (default ``build/memplan_probe.jsonl``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def runs(cs) -> dict:
    """name -> (TrainPath, layers or None, MiCSConfig fields): ``cs``
    (``chip_smoke``)'s one-card train runs."""
    out = {p.arch: (p, None, {}) for p in cs.TRAIN}
    knobs = next(p for p in cs.TRAIN if p.arch == cs.KNOBS_ARCH)
    out.update({f"{knobs.arch}:{name}": (knobs, None, kw) for name, kw, _ in cs.KNOB_VARIANTS})
    for path, layers, kw in ((cs.MOE_TRAIN, cs.MOE_TRAIN_LAYERS, {}),
                             (cs.XLSTM_TRAIN, None, {"mlstm_chunk": cs.XLSTM_CHUNK}),
                             (cs.WHISPER_TRAIN, None, {}),
                             (cs.BERT_TRAIN, cs.BERT_TRAIN_LAYERS, {})):
        out[path.arch] = (path, layers, kw)
    return out


def _tag(frames) -> str:
    """The innermost frame of the port (else of the caller) of an
    allocation: ``file:function``."""
    for f in frames or ():
        name = f.get("filename", "")
        if "repro_torch" in name or "memplan_probe" in name:
            return f"{pathlib.Path(name).name}:{f.get('name', '?')}"
    return "other"


def live_at_peak(trace: list, start_bytes: int) -> tuple[int, dict]:
    """Replay the allocator's trace: the largest allocated total and the
    live bytes then, by :func:`_tag` (``before`` for what was live when
    the recording began)."""
    live, total, peak, at = {}, start_bytes, start_bytes, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
        elif ev["action"] == "free_requested":
            total -= ev["size"]
            live.pop(ev["addr"], None)
        if total > peak:
            peak, at = total, i
    tags: dict[str, int] = {}
    live, before = {}, start_bytes
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            if live.pop(ev["addr"], None) is None:
                before -= ev["size"]
    for ev in live.values():
        t = _tag(ev.get("frames"))
        tags[t] = tags.get(t, 0) + ev["size"]
    tags["before"] = before
    return peak, dict(sorted(tags.items(), key=lambda kv: -kv[1]))


def row_probe(cs, name: str, dev) -> dict:
    """One row of the run's first layer pool on the card, as its checkpoint
    recomputes it in the backward: the bytes its autograd graph keeps
    (``core/memplan.saved_bytes``, beside the planner's ``layer_saved``),
    the bytes allocated when its forward returns, the peak of its forward
    and backward (a bf16 cotangent of ones into its output) above its
    inputs, and ``backward_share``: that peak less the planned saved bytes
    and ``layer_cotangent``, over the planned saved bytes."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import memplan as MP
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models.build import build_model

    path, layers, knobs = runs(cs)[name]
    cfg = get_config(path.arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, tp=1)
    chunk = knobs.get("mlstm_chunk", 0)
    comm = CommEngine(MiCSTopology())
    ctx = L.Ctx(mode="train", compute_dtype=torch.bfloat16, comm=comm, mlstm_chunk=chunk)
    pool, b = model.pools[0], path.global_batch // path.micro_steps
    gen = torch.Generator(device=dev).manual_seed(0)
    full = (0.05 * torch.randn(pool.layout.flat_len, generator=gen, device=dev)).bfloat16()
    x = torch.randn(b, path.seq, cfg.d_model, generator=gen, device=dev).bfloat16()
    full.requires_grad_()
    x.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = []
    saved = MP.saved_bytes(lambda: out.append(lm._layer_from_full(pool, comm, ctx, x, full)),
                           exclude=(x, full))
    torch.cuda.synchronize()
    fwd = torch.cuda.memory_allocated() - start
    y, aux = out.pop()
    outs, cts = [y], [torch.ones_like(y)]
    if isinstance(aux, torch.Tensor) and aux.requires_grad:
        outs.append(aux)
        cts.append(torch.ones_like(aux))
    torch.autograd.backward(outs, cts)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    plan = MP.layer_saved_bytes(cfg, 1, b, path.seq, mlstm_chunk=chunk)[pool.name]
    cot = MP.layer_cotangent_bytes(pool.layout.flat_len, b, path.seq, cfg.d_model, 2)
    del y, aux, outs, cts, full, x
    torch.cuda.empty_cache()
    return {"row": name, "family": cfg.family, "pool": pool.name, "local_batch": b,
            "seq": path.seq, "mlstm_chunk": chunk, "saved_bytes": saved,
            "plan_layer_saved": plan, "fwd_allocated_bytes": fwd, "peak_over_inputs_bytes": peak,
            "layer_cotangent": cot, "flat_len": pool.layout.flat_len,
            "backward_share": (peak - plan - cot) / plan,
            "plan_backward_share": MP.LAYER_BACKWARD_SHARE.get(cfg.family)}


def train_probe(cs, name: str, dev, steps: int = 1) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import mics
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    path, layers, knobs = runs(cs)[name]
    cfg = get_config(path.arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, tp=1)
    mcfg = mics.MiCSConfig(micro_steps=path.micro_steps, **knobs)
    if cfg.family == "encdec":
        batch_of = cs.whisper_batches(cfg, path, dev)
    else:
        source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                        global_batch=path.global_batch,
                                        micro_steps=path.micro_steps))
        batch_of = source.global_step_batch

    step = mics.build_train_step(model, MiCSTopology(), mcfg,
                                 OptConfig(warmup_steps=0, total_steps=2), device=dev)
    state, init = cs.measure_init(mics.init_state, model, 0, device=dev,
                                  offload_opt=mcfg.offload_opt)

    marks = {}
    loss_fn, apply_boundary = mics.lm.loss_fn, mics.apply_boundary

    def loss_probe(*a, **k):
        out = loss_fn(*a, **k)
        marks.setdefault("fwd_end_bytes", torch.cuda.memory_allocated())
        return out

    def boundary_probe(*a, **k):
        torch.cuda.synchronize()
        marks["pre_boundary_peak_bytes"] = max(marks.get("pre_boundary_peak_bytes", 0),
                                               torch.cuda.max_memory_allocated())
        marks["boundary_start_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = apply_boundary(*a, **k)
        torch.cuda.synchronize()
        marks["boundary_peak_bytes"] = max(marks.get("boundary_peak_bytes", 0),
                                           torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return out

    mics.lm.loss_fn, mics.apply_boundary = loss_probe, boundary_probe
    try:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(context="alloc", stacks="python",
                                                 max_entries=2_000_000)
        t0 = time.perf_counter()
        for i in range(steps):
            state, metrics = step(state, batch_of(i))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
    finally:
        mics.lm.loss_fn, mics.apply_boundary = loss_fn, apply_boundary
    peak = max(marks["pre_boundary_peak_bytes"], marks["boundary_peak_bytes"])
    trace = [ev for evs in snap["device_traces"] for ev in evs]
    replay_peak, tags = live_at_peak(trace, start)
    memplan, _ = cs.memplan_record(model, step.mcfg, path, peak, init)
    loss = metrics["loss"].item()
    del state, step, metrics
    torch.cuda.empty_cache()
    return {"run": name, "arch": path.arch, "layers": cfg.n_layers,
            "local_batch": path.global_batch // path.micro_steps, "seq": path.seq,
            "micro_steps": path.micro_steps, "knobs": knobs, "steps": steps, "loss": loss,
            "step_s": step_s, "peak_bytes": peak, "replay_peak_bytes": replay_peak,
            "memplan": memplan, **marks, "at_peak": {k: v for k, v in list(tags.items())[:14]}}


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs

    names = list(runs(cs))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(names), help=f"of {names}")
    ap.add_argument("--steps", type=int, default=1, help="train steps a run")
    ap.add_argument("--rows", action="store_true",
                    help="probe one row of each run's first layer pool instead of a step")
    ap.add_argument("--out", default=str(ROOT / "build" / "memplan_probe.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("memplan_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        for name in args.runs.split(","):
            line = (row_probe(cs, name, dev) if args.rows
                    else train_probe(cs, name, dev, args.steps))
            line["gpu"] = card
            text = json.dumps(line)
            print(text, flush=True)
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
