"""The cases of the port's 4-rank tests and their inputs, shared by the port
harness (``torch_dist_harness.py``), the JAX oracle (``jax_dist_oracle.py``)
and the tests that compare them (``test_torch_collectives.py``,
``test_torch_dist_train.py``, ``test_torch_tp.py``).  numpy only: every
input is made here from a seed with ``default_rng``, so both sides see the
same values.

A rank's place is C order over ``(pod, repl, shard, dp2, model)``, which is
also the device order of the JAX package's ``make_host_mesh``: rank r is
device r, and a ``[WORLD, ...]`` array holds rank r's value at row r.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent

WORLD = 4

# name -> ((pod, repl, shard, dp2, model), partition axes, replication axes)
LAYOUTS = {
    "A": ((1, 1, 4, 1, 1), ("shard",), ("pod", "repl", "dp2")),   # p 4, one replica
    "B": ((1, 2, 2, 1, 1), ("shard",), ("pod", "repl", "dp2")),   # p 2 x 2 replicas
    "Z3": ((2, 1, 2, 1, 1), ("pod", "shard"), ()),                 # ZeRO-3 over pod x shard
    "T4": ((1, 1, 1, 1, 4), ("shard",), ("pod", "repl", "dp2")),   # tp 4
    "P2T2": ((1, 1, 2, 1, 2), ("shard",), ("pod", "repl", "dp2")),  # p 2 x tp 2
}

def topo_kwargs(layout: str) -> dict:
    """The ``MiCSTopology`` keywords of ``layout`` (the port's)."""
    (pod, repl, shard, dp2, model), part, rep = LAYOUTS[layout]
    return dict(pod=pod, repl=repl, shard=shard, dp2=dp2, model=model, partition_axes=part,
                replication_axes=rep)


# gathers: name -> (layout, topology, inner, local shape, gather axis)
GATHERS = {
    "flat@A": ("A", "flat", None, (24,), 0),
    "inner_first@A": ("A", "inner_first", 2, (24,), 0),
    "outer_first@A": ("A", "outer_first", 2, (24,), 0),
    "outer_first@A_axis1": ("A", "outer_first", 2, (3, 8), 1),
    "inner_first@B": ("B", "inner_first", None, (24,), 0),
    "inner_first@Z3": ("Z3", "inner_first", None, (24,), 0),
    "outer_first@Z3": ("Z3", "outer_first", None, (24,), 0),
}

# reduce-scatters (hop 1): name -> (layout, topology, inner, dtype); each
# rank's full cotangent is [RS_LEN]
RS_LEN = 96
REDUCE_SCATTERS = {f"{topo}@{lay}:{dt}": (lay, topo, inner, dt)
                   for lay, topo, inner in (("A", "flat", None), ("A", "inner_first", 2),
                                            ("A", "outer_first", 2), ("B", "inner_first", None),
                                            ("Z3", "inner_first", None),
                                            ("Z3", "outer_first", None))
                   for dt in ("fp32", "bf16")}

# hop 2 and the Fig-14 ablation (fp32): name -> (kind, layout)
SYNCS = {"hop2@B": ("hop2", "B"), "alternative_sync@A": ("alternative_sync", "A"),
         "alternative_sync@B": ("alternative_sync", "B")}


# ---------------------------------------------------------------------------
# the int8 and bf16 wires
# ---------------------------------------------------------------------------

QBLOCK = 128
# qwZ gathers (nearest rounding) and the quantized hop 1, by layout and
# topology: name -> (layout, topology, inner).  A gather's shard is
# [QLEN] (3 quantization blocks); a reduce-scatter's full cotangent is
# [QRS_LEN], so its chunks end in ragged blocks at every stage.
QLEN = 3 * QBLOCK
QRS_LEN = 1000
QWIRES = {f"{topo}@{lay}": (lay, topo, inner)
          for lay, topo, inner in (("A", "flat", None), ("A", "inner_first", 2),
                                   ("A", "outer_first", 2), ("B", "inner_first", None),
                                   ("Z3", "inner_first", None), ("Z3", "outer_first", None))}
# Every stage of these sums 2 chunks (bitwise the reference's in any
# order); flat@A sums 4 in one stage.
QRS_BITWISE = tuple(n for n in QWIRES if n != "flat@A")
# grid-exact data: rank 0 holds integers with each block's absmax 127
# (scale 1, so the quantizer loses nothing), the other ranks zeros
GRID_LEN = 4 * 4096
# hop 2 on the int8 and bf16 wires at layout B: a payload that does not
# divide over the 2 replicas
QAR_LEN = 1001


def grid_input() -> np.ndarray:
    rng = np.random.default_rng(3)
    out = np.zeros((WORLD, GRID_LEN), np.float32)
    out[0] = rng.integers(-127, 128, size=GRID_LEN)
    out[0, ::QBLOCK] = 127.0
    return out


def gather_input(name: str) -> np.ndarray:
    """``[WORLD, *local shape]`` fp32: rank r's shard at row r (the same for
    every gather of one layout and shape)."""
    layout, _, _, shape, _ = GATHERS[name]
    rng = np.random.default_rng(_seed(f"{layout}{shape}"))
    return rng.standard_normal((WORLD, *shape)).astype(np.float32)


def full_input(name: str, n: int = RS_LEN) -> np.ndarray:
    """``[WORLD, n]`` fp32: rank r's full-length gradient at row r."""
    rng = np.random.default_rng(_seed(name))
    return rng.standard_normal((WORLD, n)).astype(np.float32)


def _seed(name: str) -> int:
    """A seed from the case name that does not depend on ``PYTHONHASHSEED``."""
    return int.from_bytes(name.encode(), "little") % 2**32


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

MICRO, GLOBAL_B, SEQ, STEPS = 2, 4, 32, 2
VOCAB = 256                     # the smoke configs' vocabulary
OPT = dict(warmup_steps=0, total_steps=10, lr_max=1e-3)

# name -> (layout, gather_order, hierarchy_inner, wire); the JAX step and the
# port's run the same
TRAINS = {f"{lay}:{wire}": (lay, order, inner, wire)
          for lay, order, inner in (("A", "outer_first", 2), ("B", "inner_first", None),
                                    ("Z3", "inner_first", None))
          for wire in ("fp32", "bf16")}


# The wires in training, bf16 gather: name -> (layout, gather_order,
# hierarchy_inner, MiCSConfig overrides).  ``WIRE_JAX`` runs are held to
# the JAX package at the same layout (nearest rounding: the stochastic
# dither cannot match the reference's threefry bits), the rest are the
# port against itself: ``A:hop1_bf16`` against ``A:bf16`` (bitwise), the
# bucketed boundary against the serial one, and the stochastic wires over
# ``WIRE_STEPS`` steps against the fp32 wires' run of as many steps.
WIRE_BUCKET_MB = 0.01
WIRE_JAX = {
    "B:hop2_bf16": ("B", "inner_first", None, {"compress_hop2": "bf16"}),
    "B:hop2_int8": ("B", "inner_first", None, {"compress_hop2": "int8",
                                               "grad_rounding": "nearest",
                                               "boundary_schedule": "serial"}),
    "A:qwz_qgz": ("A", "outer_first", 2, {"quant_gather": True, "hop1_wire_dtype": "int8",
                                          "grad_rounding": "nearest"}),
}
WIRE_STEPS = 4
WIRE_PORT = {
    "A:hop1_bf16": ("A", "outer_first", 2, {"hop1_wire_dtype": "bf16"}),
    "B:hop2_bf16.serial": ("B", "inner_first", None, {
        "compress_hop2": "bf16", "boundary_schedule": "serial",
        "hop2_bucket_mb": WIRE_BUCKET_MB}),
    "B:hop2_bf16.bucketed": ("B", "inner_first", None, {
        "compress_hop2": "bf16", "hop2_bucket_mb": WIRE_BUCKET_MB}),
    "B:hop2_int8.bucketed": ("B", "inner_first", None, {
        "compress_hop2": "int8", "grad_rounding": "nearest",
        "hop2_bucket_mb": WIRE_BUCKET_MB}),
}
# stochastic rounding, WIRE_STEPS steps each
WIRE_LONG = {
    "A:stochastic": ("A", "outer_first", 2, {"quant_gather": True, "hop1_wire_dtype": "int8"}),
    "A:fp32_wires": ("A", "outer_first", 2, {}),
    "B:stochastic": ("B", "inner_first", None, {"hop1_wire_dtype": "bf16",
                                                "compress_hop2": "int8"}),
    "B:fp32_wires": ("B", "inner_first", None, {}),
}


# The census: the autotuner's ``predict_traffic`` of a step against each
# rank's ``CommCounter`` over the run (``census_from_counter``), the train
# runs at layouts A and B above: name -> (layout, gather_order,
# hierarchy_inner, gather wire, MiCSConfig overrides, steps).  The calls
# must be equal stage by stage; the float wires' bytes too, the int8
# wires' within CENSUS_INT8_RTOL (a row's scales are ceil(n / 128), hop 2
# pads a payload to the replicas' chunks).
CENSUS = {
    **{name: (*TRAINS[name], {}, STEPS) for name in TRAINS if name[0] in "AB"},
    **{f"B:bf16.{sched}": ("B", "inner_first", None, "bf16",
                           {"boundary_schedule": sched, "hop2_bucket_mb": 0.01}, STEPS)
       for sched in ("serial", "bucketed")},
    **{name: (lay, order, inner, "bf16", kw, STEPS)
       for name, (lay, order, inner, kw) in {**WIRE_JAX, **WIRE_PORT}.items()},
}
CENSUS_INT8_RTOL = 0.05


def wire_batches(steps: int) -> list[dict[str, np.ndarray]]:
    """``steps`` global batches: :func:`train_batches`, repeated."""
    base = train_batches()
    return [base[i % len(base)] for i in range(steps)]


# The one-card training knobs over ranks (``torch_dist_harness.py knobs``),
# the port against itself on the seeded init: name -> (layout,
# gather_order, hierarchy_inner, MiCSConfig overrides, OptConfig
# overrides).  ``KNOB_CLIP_NEVER`` keeps the approximate clip inactive;
# ``KNOB_BUCKET_MB`` cuts every pool into many hop-2 buckets, some across
# rows.
KNOB_CLIP_NEVER = 1e9
KNOB_BUCKET_MB = 0.01
KNOB_RUNS = {
    "A.stored": ("A", "outer_first", 2, {}, {}),
    "A.remat": ("A", "outer_first", 2, {"prefetch_carry": "remat"}, {}),
    "B.exact": ("B", "inner_first", None, {"hop2_bucket_mb": KNOB_BUCKET_MB},
                {"clip_norm": KNOB_CLIP_NEVER}),
    "B.approx": ("B", "inner_first", None, {"hop2_bucket_mb": KNOB_BUCKET_MB,
                                            "clip_mode": "approx"},
                 {"clip_norm": KNOB_CLIP_NEVER}),
    "B.default": ("B", "inner_first", None, {}, {}),
    "B.host": ("B", "inner_first", None, {"carry_offload": "host", "offload_opt": True}, {}),
}


def train_batches() -> list[dict[str, np.ndarray]]:
    """The global batches ``[MICRO, GLOBAL_B, SEQ]`` of each step; data rank
    d takes row d of each micro-batch (the reference's batch spec).  Each
    row masks out the same number of tokens (at random places): the loss is
    the mean over data ranks of each rank's masked mean, as the reference's
    ``pmean``, which is the global batch's masked mean only when every rank
    keeps as many tokens."""
    rng = np.random.default_rng(7)
    shape = (MICRO, GLOBAL_B, SEQ)
    out = []
    for _ in range(STEPS):
        mask = np.ones(shape, np.float32)
        drop = np.argsort(rng.uniform(size=shape), axis=-1)[..., :SEQ // 8]
        np.put_along_axis(mask, drop, 0.0, axis=-1)
        out.append({"tokens": rng.integers(0, VOCAB, shape).astype(np.int32),
                    "targets": rng.integers(0, VOCAB, shape).astype(np.int32), "mask": mask})
    return out


def data_slice(batch: dict, data_rank: int, dp: int) -> dict:
    per = GLOBAL_B // dp
    return {k: v[:, data_rank * per:(data_rank + 1) * per] for k, v in batch.items()}


def start(script: str, *args: str) -> subprocess.Popen:
    """Start ``tests/<script> args`` on the CPU (``PYTHONPATH`` src and tests)."""
    env = dict(os.environ, PYTHONPATH=f"{TESTS.parent / 'src'}:{TESTS}", JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, str(TESTS / script), *args], cwd=TESTS.parent,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float) -> None:
    """Wait for ``proc``; raise with its error output if it failed or hung."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{proc.args} did not finish in {timeout} s:\n{err[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{proc.args} exited {proc.returncode}:\n{err[-4000:]}")


def load_ranks(path_fmt: str) -> dict[str, np.ndarray]:
    """Every rank's npz (``path_fmt`` with ``{r}``) as ``{key: [WORLD, ...]}``."""
    ranks = [np.load(path_fmt.format(r=r)) for r in range(WORLD)]
    return {k: np.stack([z[k] for z in ranks]) for k in ranks[0].files}


# ---------------------------------------------------------------------------
# tensor parallelism: the layers at tp 4 (layout T4: rank r is model rank r)
# ---------------------------------------------------------------------------

TP = 4
B, T = 2, 6
VP, VR = 40, 37                  # padded and real vocab of the loss cases
TP_LAYER_CASES = ("embed", "xent", "attn_out:fp32", "attn_out:bf16", "mlp:fp32", "mlp:bf16",
                  "gather:4", "gather:2", "gather:4_dim0", "head_mask", "griffin_rec",
                  "greedy", "moe_a2a@4", "moe_a2a@2", "moe_ffn@4", "moe_ffn@2", "moe_dec@4",
                  "moe_dec@2")
# The MoE cases (smoke deepseek-moe-16b: 8 experts, top-2, 2 shared experts
# of d_ff 32, d 64) at tp 4 (layout T4) and tp 2 (P2T2: two model groups
# of 2 ranks, each rank's inputs the same): the expert exchange and its
# adjoint on [8, 4, 3] slabs; moe_ffn on 2 x 8 tokens (token-sharded: 4 or
# 8 a rank) and on 3 x 1 (decode: tp does not divide 3, the replicated
# path), with each rank's expert and shared-MLP shards, the router whole
# (the layer gets it gathered).
# The engine's dead rows at tp 2 and tp 4, the port alone (the reference
# routes its padding rows): moe_ffn in decode mode over 4 slots of 8 rows,
# each slot's rows past its n_new dead, token-sharded, against the port at
# tp 1 on the full weights (``test_torch_tp.py``).
MOE_LIVE_CASES = ("moe_live@2", "moe_live@4")
MOE_LIVE_N_NEW = (8, 1, 0, 3)
MOE_CUT = {"router.w": None, "moe.wg": 0, "moe.wu": 0, "moe.wd": 0, "shared.wg": 1,
           "shared.wu": 1, "shared.wd": 0}


def moe_case_tp(name: str) -> tuple[str, int]:
    """``(layout, tp)`` of a ``moe_*@tp`` case."""
    tp = int(name.split("@")[1])
    return ("T4" if tp == 4 else "P2T2"), tp


def moe_shapes(d: int = 64, e: int = 8, f: int = 32, shared: int = 2) -> dict:
    return {"router.w": (d, e), "moe.wg": (e, d, f), "moe.wu": (e, d, f), "moe.wd": (e, f, d),
            "shared.wg": (d, shared * f), "shared.wu": (d, shared * f),
            "shared.wd": (shared * f, d)}
# attn_out: 6 Q heads over 2 KV heads of dim 4, d 16: at tp 4 the Q heads
# pad to 8, 2 a rank, so the last rank's two heads (6 and 7) are padding
ATTN = dict(d=16, hq=6, hkv=2, dh=4)
# griffin_rec: the tensor of each name and the dim tp cuts (None: full on
# every rank: the norm scales, which the layer gets gathered)
GRIFFIN_REC_CUT = {"ln1.scale": None, "rec.wx": 1, "rec.wy": 1, "rec.conv_w": 1,
                   "rec.conv_b": 0, "rec.wi": 0, "rec.bi": 0, "rec.wr": 0, "rec.br": 0,
                   "rec.lam": 0, "rec.wo": 0, "ln2.scale": None, "mlp.wg": 1, "mlp.wu": 1,
                   "mlp.wd": 0}


def _split(a: np.ndarray, axis: int, tp: int = TP) -> np.ndarray:
    """``[tp, ...]``: ``a`` cut into tp equal slices along ``axis``."""
    return np.stack(np.split(a, tp, axis=axis))


def _tile(a: np.ndarray, n: int = WORLD) -> np.ndarray:
    return np.broadcast_to(a, (n, *a.shape)).copy()


def _normal(rng, shape, std=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * std).astype(np.float32)


def griffin_rec_shapes(d: int = 64, rl: int = 64, f: int = 128, cw: int = 4) -> dict:
    """The full (tp = 1) shapes of one griffin recurrent layer's tensors at
    the smoke widths."""
    return {"ln1.scale": (d,), "rec.wx": (d, rl), "rec.wy": (d, rl), "rec.conv_w": (cw, rl),
            "rec.conv_b": (rl,), "rec.wi": (rl,), "rec.bi": (rl,), "rec.wr": (rl,),
            "rec.br": (rl,), "rec.lam": (rl,), "rec.wo": (rl, d), "ln2.scale": (d,),
            "mlp.wg": (d, f), "mlp.wu": (d, f), "mlp.wd": (f, d)}


def tp_layer_case(name: str) -> tuple[dict, dict]:
    """``(full, ranks)``: the case's tp = 1 inputs, and each rank's inputs
    at tp 4 as ``[WORLD, ...]`` (row r: rank r's)."""
    rng = np.random.default_rng(_seed("tp:" + name))
    kind = name.split(":")[0]
    if kind == "embed":
        full = {"table": _normal(rng, (24, 16)), "ids": rng.integers(0, 24, (B, T)),
                "ct": _normal(rng, (B, T, 16))}
        return full, {"table": _split(full["table"], 1), "ids": _tile(full["ids"]),
                      "ct": _tile(full["ct"])}
    if kind == "xent":
        mask = np.ones((B, T), np.float32)
        mask[0, 1] = mask[1, 4] = 0.0
        # a target in every rank's columns, the last two in the last rank's
        targets = np.asarray([[3, 12, 25, 33, 36, 0], [19, 9, 35, 30, 7, 22]])
        full = {"logits": _normal(rng, (B, T, VP), 3.0), "targets": targets, "mask": mask}
        return full, {"logits": _split(full["logits"], 2), "targets": _tile(targets),
                      "mask": _tile(mask)}
    if kind == "attn_out":
        a = ATTN
        hq_pad = 8
        attn = _normal(rng, (B, T, hq_pad, a["dh"]))
        wo = np.zeros((hq_pad * a["dh"], a["d"]), np.float32)
        wo[:a["hq"] * a["dh"]] = _normal(rng, (a["hq"] * a["dh"], a["d"]), 0.3)
        full = {"attn": attn[:, :, :a["hq"]].reshape(B, T, a["hkv"], a["hq"] // a["hkv"],
                                                     a["dh"]),
                "wo": wo[:a["hq"] * a["dh"]], "ct": _normal(rng, (B, T, a["d"]))}
        per = hq_pad // TP
        ranks = {"attn": np.stack([attn[:, :, m * per:(m + 1) * per].reshape(
                     B, T, 1, per, a["dh"]) for m in range(TP)]),
                 "wo": _split(wo, 0), "ct": _tile(full["ct"])}
        return full, ranks
    if kind == "mlp":
        d, f = 16, 32
        full = {"x": _normal(rng, (B, T, d)), "wg": _normal(rng, (d, f), 0.25),
                "wu": _normal(rng, (d, f), 0.25), "wd": _normal(rng, (f, d), 0.2),
                "ct": _normal(rng, (B, T, d))}
        return full, {"x": _tile(full["x"]), "wg": _split(full["wg"], 1),
                      "wu": _split(full["wu"], 1), "wd": _split(full["wd"], 0),
                      "ct": _tile(full["ct"])}
    if kind == "gather":
        g, dim = gather_case(name)
        local = (6, 2) if dim == 1 else (4,)
        out = (6, 2 * g) if dim == 1 else (4 * g,)
        return {}, {"local": _normal(rng, (WORLD, *local)), "ct": _normal(rng, (WORLD, *out))}
    if kind == "head_mask":
        return {}, {}
    if kind == "griffin_rec":
        full = {}
        for n, shape in griffin_rec_shapes().items():
            if n == "rec.lam":
                a = rng.uniform(0.9, 0.999, shape)
                full[n] = (np.log(a) - np.log1p(-a)).astype(np.float32)
            elif n.endswith("scale") or n in ("rec.conv_b", "rec.bi", "rec.br"):
                full[n] = _normal(rng, shape, 0.1)
            elif n in ("rec.wi", "rec.wr", "rec.conv_w"):
                full[n] = _normal(rng, shape, 0.5)
            else:
                full[n] = _normal(rng, shape, 1.0 / np.sqrt(shape[0]))
        full["x"] = _normal(rng, (B, 8, 64))
        full["ct"] = _normal(rng, (B, 8, 64))
        ranks = {n: _tile(v) if GRIFFIN_REC_CUT.get(n) is None else _split(v, GRIFFIN_REC_CUT[n])
                 for n, v in full.items()}
        return full, ranks
    if kind.startswith("moe"):
        kind, tp = name.split("@")[0], moe_case_tp(name)[1]
        if kind == "moe_a2a":
            return {}, {"x": _normal(rng, (WORLD, 8, 4, 3)),
                        "ct": _normal(rng, (WORLD, 8 // tp, tp * 4, 3))}
        full = {n: _normal(rng, shape, 1.0 / np.sqrt(shape[-2]))
                for n, shape in moe_shapes().items()}
        b, t = {"moe_ffn": (2, 8), "moe_dec": (3, 1), "moe_live": (4, 8)}[kind]
        full["x"] = _normal(rng, (b, t, 64))
        full["ct"] = _normal(rng, (b, t, 64))
        reps = WORLD // tp
        ranks = {n: _tile(v) if MOE_CUT.get(n) is None
                 else np.concatenate([_split(v, MOE_CUT[n], tp)] * reps)
                 for n, v in full.items()}
        return full, ranks
    if kind == "greedy":
        # small integers, so maxima tie within and across ranks' columns
        logits = rng.integers(0, 4, (3, VP)).astype(np.float32)
        logits[0, 38] = 9.0            # a padded column's maximum is masked
        logits[1, [5, 15, 25]] = 7.0    # a tie across ranks: the lowest wins
        logits[2, 36] = 8.0            # the last real column
        return {"logits": logits}, {"logits": _split(logits, 1)}
    raise KeyError(name)


def gather_case(name: str) -> tuple[int, int]:
    """``(model_gather, model_gather_dim)`` of a ``gather:*`` case."""
    tag = name.split(":")[1]
    return (4, 0) if tag == "4_dim0" else (int(tag), 1)


def gather_oracle(name: str) -> dict:
    """The numpy answer of a ``gather:*`` case: each rank's gathered tensor
    (its run of g ranks' slices, in model order, along the dim) and its
    input's gradient (the sum over the run of each member's cotangent
    slice at the rank's place)."""
    g, dim = gather_case(name)
    _, ranks = tp_layer_case(name)
    out, grad = [], []
    for r in range(WORLD):
        members = range(r // g * g, r // g * g + g)
        out.append(np.concatenate([ranks["local"][q] for q in members], axis=dim))
        n = ranks["local"].shape[dim + 1]
        i = r % g
        grad.append(sum(np.take(ranks["ct"][q], range(i * n, (i + 1) * n), axis=dim)
                        for q in members))
    return {"out": np.stack(out), "grad": np.stack(grad)}


def head_mask_oracle(hq: int = 10, hq_pad: int = 12) -> np.ndarray:
    """Each rank's mask of real Q heads at tp 4: rank m's heads are global
    heads ``m * hq_local ...``."""
    per = hq_pad // TP
    return np.asarray([[float(m * per + i < hq) for i in range(per)] for m in range(TP)],
                      np.float32)


# ---------------------------------------------------------------------------
# tensor parallelism: the training step
# ---------------------------------------------------------------------------

# name -> (arch, layout, wire, config overrides); each case is compared
# with the JAX package at its layout and with the port at tp = 1
TP_TRAINS = {
    "llama@P2T2:fp32": ("llama3.2-1b", "P2T2", "fp32", {}),
    "llama@P2T2:bf16": ("llama3.2-1b", "P2T2", "bf16", {}),
    # recurrentgemma's 10 Q heads: padded to 12 at tp 4, its one KV head
    # gathered over all 4 model ranks
    "griffin@T4": ("recurrentgemma-2b", "T4", "fp32", {"n_heads": 10}),
    # the reference's griffin_partition_equiv layout
    "griffin@P2T2": ("recurrentgemma-2b", "P2T2", "fp32", {}),
    # xLSTM: every block's weights gathered whole over the model group, the
    # cells computed on every model rank; the sLSTM's MLP tensor-parallel
    "xlstm@P2T2": ("xlstm-125m", "P2T2", "fp32", {}),
    # whisper: the encoder's gradient reaches it through each rank's cross
    # K/V projections (its heads' share), summed by the encoder's psums and
    # the frame positions' gather adjoint
    "whisper@P2T2": ("whisper-large-v3", "P2T2", "fp32", {}),
}
# The enc-dec cases' stub audio frames: smoke whisper's 16 frames of d 64.
TP_AUDIO = {"whisper-large-v3": (16, 64)}


def tp1_layout(layout: str) -> tuple:
    """``layout``'s mesh at tp 1: the same data axes (so the same data
    ranks and loss), no model axis."""
    (pod, repl, shard, dp2, _), part, rep = LAYOUTS[layout]
    return (pod, repl, shard, dp2, 1), part, rep


def numpy_params(model, name: str) -> dict[str, np.ndarray]:
    """Seeded random weights for every pool of ``model`` (a tp = 1 model of
    either package: the two lay out the same segments): ``{pool: [stack, 1,
    flat_len]}`` fp32, each segment normal with its layout's std (0.1 for
    the zero-initialised norm scales and biases, so their gradients and
    gathers are not of zeros), the RG-LRU's Λ from its ``lru`` range, the
    VLM's gates at ``VLM_GATE``; the padding 0.  The weights the reference
    runs in place of a sub-layer's own are copied over them
    (:func:`tie_shadowed`: griffin's ``rec1.*`` over ``rec0.*``, ...)."""
    rng = np.random.default_rng(_seed("tp_params:" + name))
    out = {}
    for pool in model.all_pools():
        rows = np.zeros((pool.stack, 1, pool.layout.flat_len), np.float32)
        for i in range(pool.stack):
            for s in pool.layout.segments:
                if s.init == "lru":
                    a = rng.uniform(0.9, 0.999, s.size)
                    v = np.log(a) - np.log1p(-a)
                else:
                    v = rng.standard_normal(s.size) * (s.std if s.init == "normal" else 0.1)
                if s.name.endswith(("gate_attn", "gate_mlp")):
                    v = np.full(s.size, VLM_GATE)
                rows[i, 0, s.offset:s.end] = v
        out[pool.name] = rows
    return tie_shadowed(model, out)


# The VLM's cross-layer gates in every case's weights: zero at init, where
# the gated layer is the identity and a wrong cross-attention would pass.
VLM_GATE = 1.0


def sublayer_prefixes(model, pool) -> list[str]:
    """The prefixes of the sub-layers a pool's super-layer holds (griffin
    ``rec0.``, ``attn0.``; xLSTM ``m0.``, ``s0.``; the VLM ``s0.``, ``x.``);
    none for the other families' pools and for the embedding and head."""
    if model.cfg.family not in ("griffin", "xlstm", "vlm") or pool.name in ("embed", "head"):
        return []
    return sorted({s.name.split(".")[0] + "." for s in pool.layout.segments})


def reference_reads(layout, prefixes) -> dict[str, str]:
    """{a sub-layer's own segment: the segment the reference runs in its
    place} (ROADMAP Queue 3): the reference's sub-layers strip
    ``len(prefix)`` characters from every name of the pool, so the last
    segment in layout order whose name strips to the same key wins."""
    names = [s.name for s in layout.segments]
    out = {}
    for prefix in prefixes:
        n = len(prefix)
        for own in names:
            if own.startswith(prefix):
                out[own] = [s for s in names if s[n:] == own[n:]][-1]
    return out


def _shadowed(model):
    """(pool, {segment name: segment}, [(own, what the reference runs)])
    for each pool with shadowed segments."""
    for pool in model.pools:
        pairs = [(own, won) for own, won in reference_reads(
            pool.layout, sublayer_prefixes(model, pool)).items() if own != won]
        if pairs:
            yield pool, {s.name: s for s in pool.layout.segments}, pairs


def tie_shadowed(model, params: dict) -> dict:
    """``params`` (numpy ``[..., flat_len]`` pools) with the segments the
    reference runs copied over each sub-layer's own: both packages then
    compute the same function."""
    out = dict(params)
    for pool, segs, pairs in _shadowed(model):
        rows = np.array(out[pool.name], copy=True)
        for own, won in pairs:
            rows[..., segs[own].offset:segs[own].end] = rows[..., segs[won].offset:segs[won].end]
        out[pool.name] = rows
    return out


def tp_batch(name: str | None = None) -> dict[str, np.ndarray]:
    """The TP steps' global batch: the first of :func:`train_batches`; for
    an enc-dec case of ``TP_TRAINS`` also its ``audio`` frames ``[MICRO,
    GLOBAL_B, frames, d]``, normal from a seed of the case's name."""
    batch = train_batches()[0]
    arch = TP_TRAINS[name][0] if name else None
    if arch in TP_AUDIO:
        rng = np.random.default_rng(_seed("tp_audio:" + name))
        batch["audio"] = rng.standard_normal((MICRO, GLOBAL_B, *TP_AUDIO[arch])).astype(
            np.float32)
    return batch


def on_jax_basis(model, grads: dict) -> dict:
    """The port's gradients as the reference reads them: each shadowed
    segment's gradient (griffin's ``rec0.*``, xLSTM's ``m0.m.*``, ...)
    added to the segment the reference runs in its place and set to 0;
    pools ``[..., flat_len]`` of ``model``'s layout (numpy or tensors),
    numpy."""
    out = {k: np.array(v, copy=True) for k, v in grads.items()}
    for pool, segs, pairs in _shadowed(model):
        g = out[pool.name]
        for own, won in pairs:
            g[..., segs[won].offset:segs[won].end] += g[..., segs[own].offset:segs[own].end]
            g[..., segs[own].offset:segs[own].end] = 0.0
    return out


# ---------------------------------------------------------------------------
# the elastic loop (``torch_dist_harness.py elastic``, ``jax_dist_oracle.py
# elastic``, ``test_torch_elastic.py``)
# ---------------------------------------------------------------------------

# The loop's data and optimizer: the smoke llama, fp32 gather (the tight
# tolerances), the train steps' batch shape
ELASTIC_OPT = dict(warmup_steps=0, total_steps=40, lr_max=1e-3)
ELASTIC_BATCH = MICRO * GLOBAL_B
# fault plans: name -> [(FaultPlan method, step, keywords)], made by either
# package's FaultPlan with ``fault_plan``
ELASTIC_PLANS = {
    # the abrupt loss of 2 ranks rolls back to step 2; the grow with notice
    # takes an emergency save at 4 (chip_smoke.py's dist_elastic)
    "B_abrupt_grow": [("preempt", 3, {"devices": 2, "notice": False}),
                      ("grow", 4, {"devices": 2})],
    # p 4 loses 2 ranks with notice: the keep rule shrinks p to 2
    "A_notice": [("preempt", 2, {"devices": 2, "notice": True})],
    # p 2 x tp 2 loses 2 ranks abruptly: p 1 x tp 2
    "P2T2_abrupt": [("preempt", 2, {"devices": 2, "notice": False})],
    # the async step-4 save dies mid-write; the eviction at 5 rolls back to
    # 2, the newest complete checkpoint
    "B_crash_mid_save": [("crash_during_save", 4, {}),
                         ("slow", 5, {"factor": 2.0, "evict": True})],
    "1_crash_mid_save": [("crash_during_save", 4, {}),
                         ("slow", 5, {"factor": 2.0, "evict": True})],
    # an eviction at 5 rolls back to the step-4 checkpoint
    "1_evict": [("slow", 5, {"factor": 2.0, "evict": True})],
}
# name -> (layout, or "1" for one rank; total_steps; checkpoint_every)
ELASTIC_RUNS = {
    "B_abrupt_grow": ("B", 5, 2),
    "A_notice": ("A", 4, 10),
    "P2T2_abrupt": ("P2T2", 4, 1),
    "B_crash_mid_save": ("B", 8, 2),
    "1_crash_mid_save": ("1", 8, 2),
    "1_evict": ("1", 8, 2),
}
# the runs with world changes, each held to cold restarts of its checkpoints
ELASTIC_CHANGES = ("B_abrupt_grow", "A_notice", "P2T2_abrupt")
# the runs again with the AdamW moments in host memory (``offload_opt``):
# p 4 -> p 2 doubles a rank's moments; B -> 2 ranks -> B parks two ranks
ELASTIC_OFFLOAD = ("A_notice", "B_abrupt_grow")


def fault_plan(cls, name: str):
    """Case ``name``'s plan from ``cls`` (either package's ``FaultPlan``)."""
    plan = cls(slow_base_s=0.0)
    for kind, at, kw in ELASTIC_PLANS[name]:
        getattr(plan, kind)(at, **kw)
    return plan


def elastic_topo_kwargs(name: str) -> dict:
    """The starting ``MiCSTopology`` keywords of run ``name`` (one rank: the
    default topology)."""
    lay = ELASTIC_RUNS[name][0]
    return {} if lay == "1" else topo_kwargs(lay)


def segments(ledger: list[dict], total: int) -> list[tuple[dict, int]]:
    """Each world change of a run and the steps its world ran: ``(entry,
    steps)``, from its ``resumed_step`` to the next change's ``at_step``
    (or ``total``)."""
    ends = [e["at_step"] for e in ledger[1:]] + [total]
    return [(e, end - e["resumed_step"]) for e, end in zip(ledger, ends)]


# (n, tp, p) for elastic_host_topology against the reference on 4 devices
# (n 5: more than are available)
ELASTIC_GRID = [(n, tp, p) for n in (0, 1, 2, 3, 4, 5) for tp in (1, 2, 4)
                for p in (1, 2, 3, 4)]


# ---------------------------------------------------------------------------
# serving over ranks (``torch_dist_harness.py serve``, ``jax_dist_oracle.py
# serve``, ``test_torch_dist_serve.py``)
# ---------------------------------------------------------------------------

# The fixed-batch steps: the global batch's prompts [SERVE_B, SERVE_T],
# prefill, then SERVE_STEPS greedy decode steps, the first fed
# ``serve_inputs``'s tokens, the next each its own; fp32 gather.
SERVE_B, SERVE_T, SERVE_STEPS = 4, 12, 3
SERVE_CACHE = SERVE_T + SERVE_STEPS + 1
# name -> (arch, layout, gather_order, hierarchy_inner, config overrides,
# stored int8 weights); each side serves the same global weights
# (``numpy_params`` of the tp 1 model, cut by ``tp_params_from_full``)
SERVE_FIXED = {
    "llama@A": ("llama3.2-1b", "A", "outer_first", 2, {}, False),
    "llama@B": ("llama3.2-1b", "B", "inner_first", None, {}, False),
    "llama@P2T2": ("llama3.2-1b", "P2T2", "inner_first", None, {}, False),
    # 2 KV heads over 4 model ranks: each rank caches the one head its Q
    # group reads (head-slot replication)
    "llama@T4": ("llama3.2-1b", "T4", "inner_first", None, {}, False),
    "griffin@P2T2": ("recurrentgemma-2b", "P2T2", "inner_first", None, {}, False),
    # 10 Q heads padded to 12, one KV head over the 4 model ranks
    "griffin@T4": ("recurrentgemma-2b", "T4", "inner_first", None, {"n_heads": 10}, False),
    # the stored int8 weights, each side quantizing with its eager
    # nearest-rounding quantizer (bitwise the same bytes)
    "llama@B:int8": ("llama3.2-1b", "B", "inner_first", None, {}, True),
    # the VLM's super-layer (4 dense + 1 gated cross layer, gates at
    # VLM_GATE) with its vision rows split over the data ranks
    "vlm@P2T2": ("llama-3.2-vision-90b", "P2T2", "inner_first", None, {}, False),
}


def serve_inputs(name: str) -> tuple[np.ndarray, np.ndarray]:
    """``(prompts [SERVE_B, SERVE_T], first decode tokens [SERVE_B, 1])``."""
    rng = np.random.default_rng(_seed("serve:" + name.split(":")[0]))
    return (rng.integers(1, VOCAB, (SERVE_B, SERVE_T)).astype(np.int64),
            rng.integers(1, VOCAB, (SERVE_B, 1)).astype(np.int64))


def serve_vision(name: str) -> np.ndarray | None:
    """The VLM case's stub vision rows ``[SERVE_B, n_vision_tokens,
    d_model]`` of its smoke config, fp32; None for the other models."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(SERVE_FIXED[name][0]))
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(_seed("vision:" + name))
    return rng.standard_normal((SERVE_B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def serve_weights_key(name: str) -> str:
    """The ``numpy_params`` seed name of a case: the same weights for a
    model and layout whatever the wire."""
    return "serve:" + name.split(":")[0]


# The paged step (fp32 pools) at P2T2 and T4: PAGED_PLENS prompts streamed
# in one chunk of max(PAGED_PLENS), then PAGED_STEPS decode steps at that
# width, each fed the tokens it sampled; blocks of PAGED_BS from one
# allocator a data rank (tables hold rank-local ids).  Then paged ==
# contiguous bitwise: prompts of PAGED_EQ_T tokens prefilled by the
# fixed-batch step, copied into pools by ``pages_from_contiguous``, and
# PAGED_STEPS decode steps of the paged and the contiguous step side by
# side, at PAGED_TEMPS with top-k PAGED_TOP_K.
SERVE_PAGED = ("P2T2", "T4")
PAGED_PLENS = [3, 7, 5, 9]
PAGED_STEPS = 3
PAGED_BS = 4
PAGED_EQ_T = 6
PAGED_CAP = 16
PAGED_TEMPS = np.array([0.0, 0.7, 0.0, 1.3], np.float32)
PAGED_SEEDS = np.arange(4, dtype=np.int64) * 101 + 5
PAGED_TOP_K = 5


def paged_tables(plens, dp: int, extra: int = PAGED_STEPS, bs: int = PAGED_BS,
                 max_blocks: int | None = None) -> tuple[np.ndarray, int]:
    """Each data rank's rows' blocks from its own allocator, lowest first
    (as the batcher hands them out; block 0 the garbage block); ``(tables
    [B, max_blocks] of rank-local ids, blocks a rank)``."""
    b = len(plens)
    per = b // dp
    need = [-(-(n + extra) // bs) for n in plens]
    nb = max(sum(need[d * per:(d + 1) * per]) for d in range(dp)) + 1
    mb = max_blocks or max(need)
    tables = np.zeros((b, mb), np.int32)
    for d in range(dp):
        nxt = 1
        for row in range(d * per, (d + 1) * per):
            tables[row, :need[row]] = np.arange(nxt, nxt + need[row])
            nxt += need[row]
    return tables, nb


def paged_prompts() -> np.ndarray:
    return np.random.default_rng(_seed("serve:paged")).integers(
        1, VOCAB, (len(PAGED_PLENS), max(PAGED_PLENS))).astype(np.int64)


# The sampler over vocab-parallel logits at tp 2 (P2T2) and 4 (T4): every
# rank samples its model coordinate's columns of the same logits
# [SAMPLER_N, VP] (``sampler_logits``: many ties, a padded column's
# maximum, a tie across every shard) at each top-k.
SAMPLER_N = 12
SAMPLER_LAYOUTS = ("P2T2", "T4")
SAMPLER_TOP_K = (0, 1, 3, 9, 30, 64)
SAMPLER_TEMPS = np.array([0.0, 0.0] + [0.0, 0.7, 1.3, 2.0] * 2 + [0.5, 0.0], np.float32)
SAMPLER_SEEDS = np.arange(SAMPLER_N, dtype=np.int64) * 7 + 1
SAMPLER_POS = np.arange(SAMPLER_N, dtype=np.int64) + 3


def sampler_logits() -> np.ndarray:
    rng = np.random.default_rng(_seed("serve:sampler"))
    lg = rng.integers(0, 6, (SAMPLER_N, VP)).astype(np.float32)
    lg[0, 38] = 50.0
    lg[1, [5, 15, 25, 35]] = 9.0
    lg[2] = rng.standard_normal(VP).astype(np.float32)
    return lg


# The resilient loop over ranks (llama, fp32 gather and pools) from
# ``elastic_host_topology(4, 2, tp=2)`` (= P2T2): each run name -> (the
# starting world, the fault plan spec); every run is held bitwise to
# "free4", and "free4"'s greedy completions to the reference's loop at
# P2T2.
CHAOS_GEOMETRY = dict(slots_local=2, nb_local=10, block_size=4, max_blocks=4, chunk=4,
                      top_k=5)
CHAOS_RUNS = {
    "free4": (4, ""),
    "free2": (2, ""),
    "preempt": (4, "preempt@3x2"),
    "grow": (2, "grow@3x2"),
    "straggler": (4, "evict@3"),
    "crash": (4, "crash@3"),
}
CHAOS_ARRIVALS = [0, 0, 1, 2, 2, 3, 5, 6]
CHAOS_TP = 2


def chaos_requests(cls) -> list:
    """8 requests of ``cls`` (either package's ``Request``): prompts of 3-9
    tokens, 3-6 new tokens, greedy and sampled alternately."""
    rng = np.random.default_rng(_seed("serve:chaos"))
    return [cls(rid=i, prompt=rng.integers(1, VOCAB, int(rng.integers(3, 10))).tolist(),
                max_new_tokens=int(rng.integers(3, 7)), temperature=(0.0, 0.7)[i % 2],
                seed=1000 + i) for i in range(len(CHAOS_ARRIVALS))]
