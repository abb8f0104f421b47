"""Roofline synthesis: dry-run records -> three-term roofline table (the
port of ``repro/roofline/analysis.py``).

    python -m repro_torch.roofline.analysis [--tag TAG] [--profile NAME]

Terms (a device, a step; constants from a link profile,
``core/linkmodel.py``, ``h100-p5`` by default):

  compute    = dot_flops / peak_flops        (dense bf16: 989e12 on h100-p5)
  memory     = hbm_bytes / hbm_bw            (3.35e12 on h100-p5)
  collective = ici_wire / intra_bw + dci_wire / inter_bw
               (intra: NVLink 4, 450 GB/s a GPU each way; inter: EFA,
               400 Gbps a GPU; ``roofline/op_stats.wire_stats`` splits the
               wire bytes by the profile's tier of each stage's group)

MODEL_FLOPS uses 6·N·D for training (N = active params for MoE) and 2·N·D
for inference shapes, divided across all devices; the ratio MODEL / counted
exposes recompute + padded-head + capacity-factor waste.  The records are
``launch/dryrun.py``'s (``artifacts/dryrun/*.json``); a record that the
planner alone priced (no ``stats``) is listed with its reason and no terms.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core.linkmodel import DEFAULT_PROFILE, LinkProfile, get_profile

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


def model_flops_per_device(rec: dict) -> float:
    n_chips = 512 if rec["mesh"] == "2x16x16" else 256
    n_active = rec["active_params"]
    tokens = rec["seq"] * rec["global_batch"] if rec["kind"] != "decode" \
        else rec["global_batch"]
    mult = 6.0 if rec["kind"] == "train" else 2.0
    return mult * n_active * tokens / n_chips


def dense_rank_dot_flops(cfg, *, tp: int, kind: str, rows: int, seq: int,
                         micro_steps: int = 1, all_pairs: bool = False) -> dict:
    """The matrix products that a rank of a dense model counts in one step
    of a dry-run cell (``op_stats``'s ``dot_flops``), worked out from the
    config: ``{"matmul", "attention", "total"}``.

    Each of the rank's matrices (its layout's 2-D segments, at the width a
    model-group gather gives them: a KV projection whose head several ranks
    share is computed whole on each) takes 2 operations a weight and token
    forward and 4 backward.  A train step's backward recomputes each layer
    up to the last tensor it saves, which leaves out the MLP's down
    projection (``torch.utils.checkpoint`` stops early).  Attention takes
    4 dh a (query, key) pair and local query head forward and 10 dh
    backward, its scores recomputed (flash's ``attention_work``), over the
    pairs the masks allow, or over every pair with ``all_pairs``, as the
    plain version computes them on the CPU.  ``rows``: the rank's rows a
    micro-step; a decode step is one token a row at position ``seq - 1``."""
    from repro_torch.kernels.flash_attention.kernel import visible_pairs
    from repro_torch.models.build import build_model
    from repro_torch.models.dims import attn_dims

    if cfg.family != "dense" or kind not in ("train", "decode"):
        raise ValueError(f"dense train and decode cells only, not {cfg.family} {kind}")
    model = build_model(cfg, tp=tp)

    def weights(segments, skip=()) -> int:
        return sum(s.shape[0] * s.shape[1] * (s.model_gather if s.model_gather_dim == 1 else 1)
                   for s in segments if len(s.shape) == 2 and s.name not in skip)

    layers = sum(weights(p.layout.segments) * p.stack for p in model.pools)
    recomputed = sum(weights(p.layout.segments, skip=("mlp.wd",)) * p.stack
                     for p in model.pools)
    head = weights(model.head.layout.segments)
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, tp)
    heads = ad.hq_local * cfg.n_layers * cfg.resolved_head_dim
    if kind == "decode":
        pairs = seq if all_pairs else visible_pairs(1, seq, causal=True, window=cfg.window,
                                                    q_offset=seq - 1)
        matmul = 2.0 * rows * (layers + head)
        attention = 4.0 * rows * pairs * heads
    else:
        pairs = seq * seq if all_pairs else visible_pairs(seq, seq, causal=True,
                                                          window=cfg.window, q_offset=0)
        tokens = micro_steps * rows * seq
        matmul = tokens * (6.0 * (layers + head) + 2.0 * recomputed)
        attention = (4.0 + 4.0 + 10.0) * micro_steps * rows * pairs * heads
    return {"matmul": matmul, "attention": attention, "total": matmul + attention}


def roofline_terms(rec: dict, profile: str | LinkProfile = DEFAULT_PROFILE) -> dict:
    prof = get_profile(profile)
    s = rec["stats"]
    compute = s["dot_flops"] / prof.peak_flops
    memory = s["hbm_bytes"] / prof.hbm_bw
    ici = s["ici_wire_bytes"] / prof.intra.bandwidth
    dci = s["dci_wire_bytes"] / prof.inter.bandwidth
    coll = ici + dci
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": coll, "ici_s": ici, "dci_s": dci}
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    mf = model_flops_per_device(rec)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "useful_ratio": mf / s["dot_flops"] if s["dot_flops"] else 0.0,
        "step_bound_s": bound,
        # fraction of bf16 peak achievable if the step ran exactly at the
        # max(term) bound — the roofline fraction reported in §Perf
        "roofline_fraction": (mf / prof.peak_flops) / bound if bound else 0.0,
    }


_SUGGESTIONS = {
    "compute": ("compute-bound: reduce padded-head / capacity-factor / remat "
                "waste, or increase per-chip batch to amortize fixed work"),
    "memory": ("memory-bound: fuse the eager elementwise passes (the step's "
               "ops each read and write HBM) and keep activations bf16"),
    "collective": ("collective-bound: shrink the gather scale (smaller "
                   "partition group / hierarchical staging) or trade TP for "
                   "data parallelism on the over-sharded axis"),
}


def load_records(tag: str = "", art: pathlib.Path = ART) -> list[dict]:
    recs = []
    for p in sorted((art / "dryrun").glob("*.json")):
        rec = json.loads(p.read_text())
        if (rec.get("tag") or "") == tag:
            recs.append(rec)
    return recs


def build_table(tag: str = "", profile: str | LinkProfile = DEFAULT_PROFILE,
                art: pathlib.Path = ART) -> list[dict]:
    rows = []
    for rec in load_records(tag, art):
        base = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
                "p": rec["partition_size"]}
        if rec.get("stats") is None:   # priced by the planner alone
            rows.append({**base, "dominant": "", "note": rec.get("reason", "")})
            continue
        t = roofline_terms(rec, profile)
        rows.append({
            **base,
            **{k: t[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "ici_s", "dci_s", "dominant",
                                 "useful_ratio", "roofline_fraction")},
            "note": _SUGGESTIONS[t["dominant"]],
        })
    return rows


def markdown_table(rows: list[dict], mesh: str | None = "16x16") -> str:
    cols = ("arch", "shape", "mesh", "p", "compute_s", "memory_s",
            "collective_s", "dci_s", "dominant", "useful_ratio",
            "roofline_fraction")
    out = ["| " + " | ".join(cols) + " |",
           "|" + "|".join("---" for _ in cols) + "|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh and r["mesh"] != mesh:
            continue
        cells = []
        for c in cols:
            v = r.get(c, "")
            cells.append(f"{v:.4g}" if isinstance(v, float) else str(v))
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", default=DEFAULT_PROFILE)
    ap.add_argument("--art", default=str(ART), help="the directory holding dryrun/")
    args = ap.parse_args(argv)
    art = pathlib.Path(args.art)
    rows = build_table(args.tag, args.profile, art)
    print(markdown_table(rows, mesh=None))
    print("\n| arch | shape | mesh | ran | reason |\n|---|---|---|---|---|")
    for rec in sorted(load_records(args.tag, art),
                      key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        print(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | {rec.get('ran', '')} | "
              f"{rec.get('reason', '')} |")
    (art / "roofline.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
