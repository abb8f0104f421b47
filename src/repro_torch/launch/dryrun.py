"""Multi-pod dry run: one rank of the production world, every (arch x shape x
mesh) cell (the port of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --device cpu --arch qwen1.5-110b --shape train_4k \\
        --mesh multi --policy auto --hbm-budget-gb 60
    python -m repro_torch.launch.dryrun --device cpu --all [--mesh both]

The reference lowers and compiles each cell on 256 or 512 virtual devices.
The port runs rank 0 of the same world, ``(16, 16)`` or ``(2, 16, 16)``
(``pod, data, model``; ``tp`` 16 unless ``--tp``), in one process: its
process groups are ``launch/mesh.MiCSGroups(backend="fake")``, whose
collectives complete at once and move no data, and the rank runs one step
of the cell — a train step of ``micro_steps`` (4, the paper's), a prefill
of the cell's prompt, or a decode step at the cell's context — its
products, bytes and collectives counted (``roofline/op_stats.py``).  Each
cell runs in one of three ways, written in its record's ``ran``:

* ``storage`` — on real tensors: the card (``--device cuda``, the default
  of every entry point of the port; the record adds ``measured``, the
  rank's ``max_memory_allocated`` and ``max_memory_reserved``), or the CPU
  for a smoke cell;
* ``fake`` — on fake tensors (``FakeTensorMode``): every shape, count and
  census, nothing allocated (``measured`` is null);
* ``planner`` — by the memory planner and ``autotune.predict_traffic``
  alone (no ``stats``), where an eager run cannot take the cell:
  ``reason`` says why (xLSTM's recurrences and griffin's RG-LRU on the CPU
  are timestep loops of eager ops, tens of thousands a sequence).

Each cell writes ``artifacts/dryrun/<arch>__<shape>__<mesh>[__tag].json``
under the reference's keys where the port has the counterpart: the shape
facts, ``params`` / ``active_params`` / ``micro_steps``, ``mics``,
``comm``, ``autotune`` (``--policy auto``'s plan), ``boundary``
(``plan_boundary`` with ``cost_hop2_schedule``'s prediction and
``bucket_count_match``), ``memplan`` (``predict_footprint`` at the cell's
local batch, with the §3.1 pick under ``--hbm-budget-gb``),
``autotune_cross_check`` (``compare_census`` of ``predict_traffic`` and
the rank's ``CommCounter``, the HLO census's place) and ``stats``.  The CLI
exits 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.core import memplan
from repro_torch.core.autotune import (compare_census, cost_hop2_schedule, census_from_counter,
                                       predict_traffic, resolve_config, resolve_scale)
from repro_torch.core.comm import CommEngine, policies_from_config
from repro_torch.core.linkmodel import DEFAULT_PROFILE, get_profile
from repro_torch.core.mics import MiCSConfig, build_train_step, init_params, init_state
from repro_torch.core.schedule import plan_boundary
from repro_torch.core.topology import (DP2_AXIS, POD_AXIS, REPL_AXIS, REPLICATION_AXES,
                                       SHARD_AXIS, MiCSTopology, choose_partition_size)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import FAKE_BACKEND, MiCSGroups
from repro_torch.models import lm
from repro_torch.models.build import active_param_count, build_model, exact_param_count
from repro_torch.optim.adamw import OptConfig
from repro_torch.roofline import op_stats
from repro_torch.runtime.serving import build_serve_steps

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"

TRAIN_MICRO_STEPS = 4  # paper §5.1.5 setup (s=4 gradient accumulation)
# (pods, data, model) of the production world: one pod, two pods.
WORLDS = {False: (1, 16, 16), True: (2, 16, 16)}
RAN = ("storage", "fake", "planner")
# Families whose train and prefill cells step through time in eager ops on
# the CPU: xLSTM's mLSTM scan and sLSTM backward (17 and 18 ops a token and
# block), griffin's RG-LRU plain version (a loop over the sequence).  At the
# shapes' 4,096 and 32,768 tokens a fake-tensor run is millions of ops (a
# griffin prefill cut to 4,096 tokens took 440 s), so these cells are priced
# by the planner and predict_traffic alone.
PLANNER_ONLY = {
    "xlstm": ("xlstm's recurrences are eager timestep loops (17 ops a token and block, 18 in "
              "the sLSTM's backward): the cell's fake-tensor run is millions of ops; priced by "
              "the memory planner and predict_traffic alone"),
    "griffin": ("the RG-LRU's plain version steps through the sequence on the CPU: the cell's "
                "fake-tensor run is millions of ops; priced by the memory planner and "
                "predict_traffic alone"),
}


def mesh_name(world: tuple[int, int, int]) -> str:
    pods, data, model = world
    return f"{data}x{model}" if pods == 1 else f"{pods}x{data}x{model}"


def production_topology(world: tuple[int, int, int], partition_size: int, *, tp: int,
                        zero3: bool = False) -> MiCSTopology:
    """The reference's ``make_mics_topology`` over ``world`` = (pods, data,
    model): data index d is ``(repl, shard) = divmod(d, p)`` and a model axis
    wider than ``tp`` donates its leftover to data parallelism (``dp2``)."""
    pods, data, model = world
    if data % partition_size or model % tp:
        raise ValueError(f"p {partition_size} / tp {tp} do not divide the world {world}")
    repl, dp2 = data // partition_size, model // tp
    if zero3:
        part = tuple(a for a, n in ((POD_AXIS, pods), (REPL_AXIS, repl),
                                    (SHARD_AXIS, partition_size)) if n > 1) or (SHARD_AXIS,)
        repl_axes = (DP2_AXIS,) if dp2 > 1 else ()
    else:
        part, repl_axes = (SHARD_AXIS,), REPLICATION_AXES
    return MiCSTopology(pod=pods, repl=repl, shard=partition_size, dp2=dp2, model=tp,
                        partition_axes=part, replication_axes=repl_axes)


def choose_route(cfg, kind: str, dev: torch.device, ran: str | None) -> tuple[str, str]:
    """``(ran, reason)``: ``ran`` as asked, else storage on a card and fake
    tensors on the CPU, the planner alone for :data:`PLANNER_ONLY`'s train and
    prefill cells on the CPU."""
    if ran is not None:
        return ran, ""
    if cfg.family in PLANNER_ONLY and kind != "decode" and dev.type != "cuda":
        return "planner", PLANNER_ONLY[cfg.family]
    return ("storage" if dev.type == "cuda" else "fake"), ""


def _rank_batch(cfg, seq: int, global_batch: int, micro: int, topo: MiCSTopology):
    """Rank 0's train batch ``[micro, global_batch / micro / dp, seq]``."""
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=seq, global_batch=global_batch,
                                    micro_steps=micro))
    return source.host_step_batch(0, topo.data_rank(0), topo.data_parallel_size)


def _frontend(cfg, rows: int, dev, dtype=torch.bfloat16) -> dict:
    """The stub frontends' rows of a batch (the VLM's vision, enc-dec's audio)."""
    if cfg.family == "vlm":
        return {"vision": torch.zeros((rows, cfg.n_vision_tokens, cfg.d_model), dtype=dtype,
                                      device=dev)}
    if cfg.family == "encdec":
        return {"audio": torch.zeros((rows, cfg.n_audio_frames, cfg.d_model), dtype=dtype,
                                     device=dev)}
    return {}


def run_step(model, topo, mcfg, groups, spec: dict, dev) -> tuple:
    """One step of the cell on ``dev`` under the op counter: ``(counter,
    snapshot, mcfg)``, the ``CommCounter``'s snapshot of that step."""
    cfg, kind, seq, gb = model.cfg, spec["kind"], spec["seq"], spec["global_batch"]
    dp = topo.data_parallel_size
    if kind == "train":
        micro = mcfg.micro_steps
        step = build_train_step(model, topo, mcfg, OptConfig(total_steps=1000), device=dev,
                                groups=groups)
        state = init_state(model, 0, device=dev, topo=topo, rank=0,
                           offload_opt=mcfg.offload_opt)
        batch = {k: torch.as_tensor(v) for k, v in
                 _rank_batch(cfg, seq, gb, micro, topo).items()}
        lb = batch["tokens"].shape[1]
        for k, v in _frontend(cfg, micro * lb, dev).items():
            batch[k] = v.reshape(micro, lb, *v.shape[1:])
        step.comm.counter.reset()
        with op_stats.OpCounter() as oc:
            step(state, batch)
        return oc, step.comm.counter.snapshot(), step.mcfg
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, cache_len=seq, device=dev,
                                              groups=groups)
    params = init_params(model, 0, device=dev, topo=topo, rank=0)
    if mcfg.quant_gather:
        from repro_torch.core.quant import quantize_state

        params = quantize_state(params)
    comm = prefill_fn.comm
    if kind == "prefill":
        tokens = torch.zeros((gb, seq), dtype=torch.int64)
        batch = {"tokens": tokens, **{k: v.cpu() for k, v in _frontend(cfg, gb, "cpu").items()}}
        comm.counter.reset()
        with op_stats.OpCounter() as oc:
            prefill_fn(params, batch)
        return oc, comm.counter.snapshot(), prefill_fn.mcfg
    # decode: one step at the last position of a full cache of ``seq`` (a
    # batch smaller than dp padded to a row a data rank; the cross caches of
    # the VLM and enc-dec as their zeros)
    caches = lm.init_caches(model, max(gb // dp, 1), seq, device=dev)
    tokens = torch.zeros((max(gb, dp), 1), dtype=torch.int64)
    comm.counter.reset()
    with op_stats.OpCounter() as oc:
        decode_fn(params, caches, tokens, seq - 1)
    return oc, comm.counter.snapshot(), decode_fn.mcfg


def run_cell(arch: str, shape: str, multi_pod: bool, mcfg: MiCSConfig,
             out_dir: pathlib.Path = ART, tag: str = "",
             partition_size: int | None = None, zero3: bool = False,
             tp: int | None = None, serve_footprint: bool = False, *,
             device: str | torch.device = "cuda", ran: str | None = None, cfg=None,
             world: tuple[int, int, int] | None = None, seq: int | None = None,
             global_batch: int | None = None) -> dict:
    """One cell's record (module docstring), written to ``out_dir``.
    ``cfg``, ``world``, ``seq`` and ``global_batch`` override the arch's
    config, the production world and the shape's sizes (a smoke cell);
    ``ran`` forces a route.  The rank runs on the card unless ``device``
    is ``"cpu"``."""
    cfg = get_config(arch) if cfg is None else cfg
    spec = dict(SHAPES[shape])
    spec.update({k: v for k, v in (("seq", seq), ("global_batch", global_batch)) if v})
    kind = spec["kind"]
    mode = "train" if kind == "train" else "serve"
    world = WORLDS[multi_pod] if world is None else world
    pods, data, model_axis = world
    tp = tp or model_axis
    dev = resolve_device(device)
    t0 = time.time()
    n_params = exact_param_count(cfg)
    micro = mcfg.micro_steps if kind == "train" else 1
    dp = pods * data * (model_axis // tp)
    lb = max((spec["global_batch"] // micro) // dp, 0)
    scale_plan = None
    if mcfg.hbm_budget_gb is not None and partition_size is None and not zero3:
        # the paper's §3.1 rule, analytically: the minimal partition group
        # whose plan, with the allocator's reserve, fits the budget
        sizing = build_model(cfg, tp=tp)
        partition_size, carry, scale_plan = resolve_scale(
            sizing, mcfg, data_extent=data, mode=mode,
            local_batch=lb if kind == "train" else 0, seq=spec["seq"] if kind == "train" else 0,
            extra_replication=pods * (model_axis // tp))
        mcfg = (dataclasses.replace(mcfg, prefetch_carry="stored", carry_offload="host")
                if carry == "host" else dataclasses.replace(mcfg, prefetch_carry=carry))
        print(f"memplan: p={partition_size} carry={carry} ({scale_plan.total_gb:.2f} GiB "
              f"predicted vs budget {mcfg.hbm_budget_gb:g} GiB)", flush=True)
    if partition_size is None:
        partition_size = choose_partition_size(
            n_params, data_axis=data, model_axis=tp,
            **({"state_bytes_per_param": 2} if serve_footprint else {}))
    topo = production_topology(world, partition_size, tp=tp, zero3=zero3)
    model = build_model(cfg, tp=tp)
    mcfg, plan = resolve_config(mcfg, model, topo, mode=mode,
                                local_batch=lb if kind == "train" else 0, seq=spec["seq"])
    if plan is not None:
        print(plan.table(), flush=True)
    groups = MiCSGroups(topo, 0, backend=FAKE_BACKEND, inner=mcfg.hierarchy_inner,
                        timeout=datetime.timedelta(0))
    gp, sp = policies_from_config(mcfg)
    route, reason = choose_route(cfg, kind, dev, ran)
    profile = get_profile(mcfg.link_profile)
    record = {
        "arch": cfg.name, "shape": shape, "mesh": mesh_name(world),
        "kind": kind, "seq": spec["seq"], "global_batch": spec["global_batch"],
        "zero3": zero3, "tp": topo.model_size,
        "partition_axes": list(topo.partition_axes),
        "partition_size": topo.partition_size,
        "replication_degree": topo.replication_degree,
        "params": n_params, "active_params": active_param_count(cfg),
        "micro_steps": micro,
        "mics": dataclasses.asdict(mcfg) | {
            "gather_dtype": str(mcfg.gather_dtype).removeprefix("torch."),
            "link_profile": str(getattr(mcfg.link_profile, "name", mcfg.link_profile))},
        "comm": CommEngine.from_config(topo, mcfg, groups=groups).describe(),
        "autotune": plan.describe() if plan is not None else None,
        "tag": tag, "ran": route, "reason": reason, "device": str(dev), "rank": 0,
    }
    if kind == "train":
        bplan = plan_boundary(model, topo, mode=mcfg.boundary_schedule,
                              bucket_mb=mcfg.hop2_bucket_mb, clip_mode=mcfg.clip_mode)
        record["boundary"] = bplan.describe() | {
            "predicted": cost_hop2_schedule(
                model, topo, profile, sp, boundary=mcfg.boundary_schedule,
                bucket_mb=mcfg.hop2_bucket_mb, clip_mode=mcfg.clip_mode),
            "link_profile": profile.name}

    if kind == "decode":
        # the contiguous KV caches priced as pages of the same bytes, the
        # step's logits; one token a row carries no activations to speak of
        rows = max(spec["global_batch"] // dp, 1)
        mem_plan = memplan.predict_footprint(
            model, topo, gp, sp, mode=mode, kv_pages_tokens=rows * spec["seq"],
            kv_dtype="bf16", decode_batch=rows, decode_ctx=spec["seq"])
    else:
        mem_plan = memplan.predict_footprint(
            model, topo, gp, sp, micro_steps=micro, mode=mode, local_batch=lb, seq=spec["seq"],
            boundary=mcfg.boundary_schedule, hop2_bucket_mb=mcfg.hop2_bucket_mb,
            offload_opt=mcfg.offload_opt, mlstm_chunk=mcfg.mlstm_chunk)
    record["memplan"] = mem_plan.describe() | {"hbm_budget_gb": mcfg.hbm_budget_gb,
                                               "local_batch": lb}
    if scale_plan is not None:
        record["memplan"]["resolved_partition_size"] = topo.partition_size
    predicted = predict_traffic(model, topo, gp, sp, micro_steps=micro, mode=mode,
                                boundary=mcfg.boundary_schedule,
                                hop2_bucket_mb=mcfg.hop2_bucket_mb)
    record["predicted_traffic"] = predicted["by_stage"]
    record["stats"] = record["measured"] = None

    if route != "planner":
        from torch._subclasses.fake_tensor import FakeTensorMode

        fake = (FakeTensorMode(allow_non_fake_inputs=True) if route == "fake"
                else contextlib.nullcontext())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
        t1 = time.time()
        with fake:
            counter, snap, ran_mcfg = run_step(model, topo, mcfg, groups, spec, dev)
        record["run_s"] = time.time() - t1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            record["measured"] = {"max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                                  "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
                                  "allocated_before": before[0], "reserved_before": before[1]}
        record["census"] = {"calls": snap["calls"], "bytes": snap["bytes"]}
        record["stats"] = op_stats.step_stats(counter, snap, groups, topo, gp, profile)
        record["autotune_cross_check"] = compare_census(
            predicted["by_stage"], census_from_counter(snap, topo, gp))
        if "boundary" in record:
            hop2 = record["stats"]["boundary"]["hop2_ops"]
            record["boundary"]["measured"] = {"hop2_ops": hop2}
            record["boundary"]["bucket_count_match"] = (
                topo.replication_degree == 1 or hop2 == record["boundary"]["n_hop2_collectives"])
    record["total_s"] = time.time() - t0

    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{cfg.name}__{shape}__{record['mesh']}" + (f"__{tag}" if tag else "")
    (out_dir / f"{stem}.json").write_text(json.dumps(record, indent=1, default=str))
    return record


def summary(rec: dict) -> str:
    """The cell's OK line."""
    msg = f"ran={rec['ran']} p={rec['partition_size']} mem={rec['memplan']['total_gib']:.2f}GiB"
    msg += f" ({rec['memplan']['moment']})"
    if rec["stats"] is not None:
        s = rec["stats"]
        msg += (f" flops={s['dot_flops']:.3e} hbm={s['hbm_bytes']:.3e}B "
                f"wire={s['total_wire_bytes']:.3e}B")
        bad = {k: v for k, v in rec["autotune_cross_check"].items()
               if v["predicted_count"] != v["measured_count"]}
        msg += " census=" + ("equal" if not bad else f"UNEQUAL {sorted(bad)}")
    if "boundary" in rec:
        bd, pr = rec["boundary"], rec["boundary"]["predicted"]
        msg += (f" hop2[{bd['mode']}x{bd['n_hop2_collectives']}]="
                f"{pr['t_exposed_s'] * 1e6:.0f}us exposed/{pr['t_total_s'] * 1e6:.0f}us total")
        if "bucket_count_match" in bd:
            msg += f" buckets_match={bd['bucket_count_match']}"
    if rec["reason"]:
        msg += f" [{rec['reason'][:60]}...]"
    return msg


def main(argv=None) -> int:
    global TRAIN_MICRO_STEPS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="where the rank runs: cuda (the default; storage on the card) or cpu "
                         "(fake tensors at production size)")
    ap.add_argument("--ran", choices=RAN, default=None,
                    help="force a route (default: storage on a card, fake on the CPU)")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--policy", choices=["manual", "auto"], default="manual")
    ap.add_argument("--link-profile", default=DEFAULT_PROFILE,
                    help="efa-100g, efa-400g, h100-p5 (core/linkmodel.py)")
    ap.add_argument("--hierarchical", type=int, default=1)
    ap.add_argument("--gather-order", default="inner_first",
                    choices=["inner_first", "outer_first"])
    ap.add_argument("--sync-mode", default="2hop", choices=["2hop", "allreduce_slice"])
    ap.add_argument("--partition-size", type=int, default=0)
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--bf16-scores", action="store_true")
    ap.add_argument("--quant-gather", action="store_true")
    ap.add_argument("--hop1-wire-dtype", default="fp32", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--compress-hop2", default="off", choices=["off", "bf16", "int8"])
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--prefetch-carry", default="stored", choices=["stored", "remat"])
    ap.add_argument("--carry-offload", default="none", choices=["none", "host"])
    ap.add_argument("--offload-opt", action="store_true")
    ap.add_argument("--clip-mode", default="exact", choices=["exact", "approx"])
    ap.add_argument("--hbm-budget-gb", type=float, default=0)
    ap.add_argument("--boundary-schedule", default="bucketed", choices=["serial", "bucketed"])
    ap.add_argument("--hop2-bucket-mb", type=float, default=32.0)
    ap.add_argument("--mlstm-chunk", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--serve-footprint", action="store_true")
    ap.add_argument("--micro-steps", type=int, default=TRAIN_MICRO_STEPS)
    args = ap.parse_args(argv)
    TRAIN_MICRO_STEPS = args.micro_steps

    mcfg = MiCSConfig(
        micro_steps=TRAIN_MICRO_STEPS, hierarchical=bool(args.hierarchical),
        gather_order=args.gather_order, sync_mode=args.sync_mode,
        scores_bf16=args.bf16_scores, mlstm_chunk=args.mlstm_chunk,
        quant_gather=args.quant_gather, hop1_wire_dtype=args.hop1_wire_dtype,
        compress_hop2=False if args.compress_hop2 == "off" else args.compress_hop2,
        prefetch=bool(args.prefetch), prefetch_carry=args.prefetch_carry,
        carry_offload=args.carry_offload, offload_opt=args.offload_opt,
        clip_mode=args.clip_mode, policy=args.policy, link_profile=args.link_profile,
        boundary_schedule=args.boundary_schedule, hop2_bucket_mb=args.hop2_bucket_mb,
        hbm_budget_gb=args.hbm_budget_gb or None)

    todo = ([(cfg.name, shape) for cfg, shape, _spec, _skip in cells()] if args.all
            else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in todo:
        for multi in meshes:
            label = f"{arch} x {shape} x {'multi' if multi else 'single'}"
            try:
                rec = run_cell(arch, shape, multi, mcfg, out_dir=pathlib.Path(args.out),
                               tag=args.tag, partition_size=args.partition_size or None,
                               zero3=args.zero3, tp=args.tp or None,
                               serve_footprint=args.serve_footprint, device=args.device,
                               ran=args.ran)
                print(f"OK   {label}: {summary(rec)} ({rec['total_s']:.1f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 - a failed cell is reported, the sweep goes on
                failures += 1
                print(f"FAIL {label}: {type(e).__name__}: {str(e)[:400]}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
