"""Drive the PyTorch port's serve path and its training step for both model
families it builds on one NVIDIA card; hold every CUDA kernel against its
plain PyTorch version.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its ``seconds`` (any failed
check raises and the script exits non-zero; no phase swallows an error):

1. ``build``: nvcc builds every kernel of the paths from
   ``src/repro_torch/kernels/csrc`` (seconds, card name and power limit,
   and each kernel's registers and spills).
2. For each of two serve paths, through ``build_serve_steps`` with random
   weights from ``init_params(seed=0)``, bf16 gather and the prefetch
   schedule:

   * llama3.2-1b at full width and depth (16 layers, d_model 2048, vocab
     128,256): batch 4, prompt 512, 32 greedy decode steps;
   * recurrentgemma-2b at full width and depth (26 layers: pools ``g`` x8 of
     (rec, rec, attn) and ``gtail`` (rec, rec); d_model 2560, head_dim 256,
     MQA g = 10, window 2048, vocab 256,000): batch 4, prompt 2560, 32
     greedy decode steps, cache_len 2592 (the attention cache holds 2048
     keys, is rolled at prefill, and the decode writes wrap around it).

   ``serve``: every kernel's launch counter is set to 0 just before the
   path's prefill + decode and read just after; each must equal the path's
   count (llama: RMSNorm 33 x 33, attention 16 x 33; recurrentgemma: RMSNorm
   53 x 33, attention 8 x 33, RG-LRU 18 x 33; no backward kernel), attention's
   count by route must show the prefill on the tensor-core ``mma`` route and
   every decode step on the split-K ``split`` route, never the fp32 ``fma``
   one (llama: mma 16, split 16 x 32; recurrentgemma: mma 8, split 8 x 32),
   and RG-LRU's count by entry point every call on the gated form (gate math
   fused in), never the ``(a, b)`` one (recurrentgemma: gated 18 x 33).
   ``consistency``: (a) a prefill over the prompt plus the first 8
   generated tokens agrees with decode step 8; (b) the same weights at a cut
   depth (llama 2 layers; recurrentgemma 5: ``g`` x1 + ``gtail``) give the
   same prefill logits on the card (kernels) as on the CPU (plain versions).
   ``profile``: device time of one prefill and one decode step by kernel,
   and the number of device kernels each runs.
   ``serve_int8``: the same serve (model, prompt, batch, 32 greedy steps)
   from int8 weights stored on the card (``quantize_state`` of the same
   weights, ``MiCSConfig(quant_gather=True)``): each pool row dequantized
   at every forward.  Its prefill / decode / tokens / peak numbers beside
   the bf16 ``serve`` run's, the stored bytes (int8 + scales against fp32),
   the share of generated tokens equal to the bf16 run's (reported, not
   gated); launch counts the ``serve`` run's plus one ``dequantize`` a
   gathered pool row a forward (llama 18 x 33, recurrentgemma 11 x 33,
   ``quantize`` 0); decode step 8 against a prefill of the prompt and the
   first 8 tokens; at the cut depth the card's prefill logits against the
   CPU's on the same stored bytes; a profile of one decode step.
   ``serve_paged`` (llama3.2-1b, after its ``serve_int8``): the
   continuous-batching engine through ``runtime/resilient.ResilientServeLoop``
   (the launcher's ``--continuous`` path) on the ``serve`` run's weights,
   bf16 gather and pools: 8 slots, prefill chunks of 64 tokens (every tick
   runs at that width), blocks of 16, tables of 36 blocks (576 positions),
   a pool of 8 x 36 + 1 blocks; 24 requests from seed 0 with prompts of
   64-512 tokens and 32 new tokens each, the odd ones sampled at
   temperature 0.7 with top-k 8, one arriving every 2 ticks.  Checks, each
   failing the run: the ledger (all 24 completed, accounted); paged ==
   contiguous, bit for bit (8 of the prompts prefilled, copied into a pool
   by ``pages_from_contiguous``, 16 decode steps through
   ``build_paged_step`` and ``build_contiguous_step``: tokens and logits);
   the same 16 steps on int8 pools within ``PAGED_INT8_REL_TOL`` of the
   largest |logit|; chunk placement (the prompts streamed from position 0
   and from staggered first chunks: last tokens, logits and pool bitwise);
   the ``paged`` route against its plain version at a decode tick and a
   64-token chunk over bf16 and int8 pages; a run with an engine crash at
   tick 20 whose completions are the fault-free run's bit for bit; a run
   on int8 pools (its ledger, its share of tokens equal to bf16's); each
   run's launches, set to 0 just before it and read just after: per engine
   step RMSNorm 33 and attention 16, every call on ``paged`` (``split`` and
   ``mma`` 0), ``quantize`` 32 with int8 pools.  It prints ticks, wall
   seconds and tokens/s, time to first token in ticks and ms (p50, p99),
   decode ms a tick, a profiled decode tick's busy time and idle share,
   ``peak_gb`` and the pool's GB.
3. For each of two train paths, through ``runtime/train_loop.train`` (the
   launcher's entry point), at full width and depth, ``init_state(seed=0)``,
   the synthetic stream, bf16 gather, prefetch schedule, bucketed boundary,
   exact clip, ``OptConfig(warmup_steps=0)``, 4 steps, then the loop's
   checkpoint (written, timed and removed):

   * llama3.2-1b: 2 micro-steps of 4 x 2048 tokens a step;
   * recurrentgemma-2b: 4 micro-steps of 2 x 2048 tokens a step.

   ``train``: each step's loss and grad_norm (finite); ``step_ms`` (median
   of steps 2-4, host clock around work that ends in a synchronise),
   ``tokens_per_s``, ``model_tflops`` and ``mfu`` (6 N a token, N = the
   layer pools and the head, plus attention's 12 dh an allowed (query, key)
   pair and head in each attention sub-layer: causal, and within the window
   where the model has one; against 989 TFLOP/s), ``peak_gb``.  The counters
   are set to 0 just before the run and read just after, and must be steps
   x micro-steps x the path's counts a micro-step (each layer's compute is
   checkpointed and recomputed once in the backward):
   llama RMSNorm 33 forward + 32 recomputed, its backward 33, all on
   ``regs``; attention 16 + 16, all on ``mma``, its backward 16, all on
   ``wgmma``; RG-LRU 0.  recurrentgemma RMSNorm 53 + 52, its backward 53,
   all on ``smem`` (d 2560); attention 8 + 8 on ``mma``, its backward 8,
   all on ``wgmma256`` (dh 256, one KV head); RG-LRU 18 + 18 (on the
   backward's chunk plan, handing it the chunk starts), its backward 18,
   all gated.
   ``train_consistency``: the same weights at a cut depth (llama 2 layers;
   recurrentgemma 5: ``g`` x1 + ``gtail``, so attention's backward runs),
   full width, one micro-step of 1 x 256 tokens: card against CPU (loss,
   grad_norm, every pool's gradient, the params after one AdamW step);
   bitwise on the card serial == prefetch (loss, gradients), serial ==
   bucketed boundary (params, m, v, grad_norm) and a step run twice.
   ``profile``: one train step's device time by kernel.  A profile session
   whose port kernel events fall short of the wrapper calls the launch
   counters show for it is taken again once, and marked ``events_short``
   if it is still short.
3a. ``train_knobs``, right after recurrentgemma-2b's ``train`` phase: the
   four one-card training knobs, one at a time on that path's model at full
   width and depth, data, seed, ``OptConfig`` and micro-steps, 2 steps each
   through ``build_train_step`` from ``init_state(seed=0)`` (no checkpoint;
   the state freed, and every pinned byte released, before the next):
   ``remat`` (the backward re-gathers each ``g`` row), ``carry_host`` (the
   stored carry in pinned host slots), ``offload_opt`` (m and v in pinned
   host memory) and ``approx`` (the approximate clip).  ``remat``,
   ``carry_host`` and ``offload_opt`` must give the ``train`` phase's steps
   1-2 bitwise (loss and grad norm); ``approx`` step 1 bitwise and step 2's
   loss within ``APPROX_CLIP_LOSS_RTOL`` (the clip binds at both).  Each
   variant's launches must be the path's (as ``train``), no carry slot may
   stay held after a step, and under ``offload_opt`` m and v must be pinned
   host tensors with nothing the size of a pool's moment left on the card.
   Per variant: ``peak_gb``, the pinned GB held, step 2's ``step_ms`` and the
   GB it copied down and up, its seconds; and the host's MemTotal.
3b. ``dist_train``: 4 ranks, each a process of this
   script (``--dist-worker``) started with ``torchrun``'s variables, through
   ``launch/mesh.init_distributed`` / ``MiCSGroups`` and
   ``runtime/train_loop.train``, the ``train`` phase's data, seed, global
   batch (llama: 2 micro-steps x 4 ranks x 1 x 2048) and OptConfig, prefetch,
   bucketed boundary, 3 steps (C: 2), then each rank's checkpoint shards
   (written, timed and removed).  With fewer than 4 cards the ranks share card 0 and
   the collectives run over gloo through pinned host buffers (NCCL refuses
   two ranks on one card): a correctness rehearsal, not a MiCS speed; with
   4 or more cards, over NCCL, one card a rank.  Layout A: p 4, the paper's
   ``outer_first`` gather with inner 2, full depth; its losses and grad
   norms against the ``train`` phase's steps 1-3 (step 1: loss 2e-3, grad
   norm 2e-2 relative; steps 2-3: 2%).  Layout B: p 2 x 2 replicas (hop 2
   and the bucketed boundary across replicas) at 4 layers, against a
   one-card run of that model.  Tensor parallelism: layout C, llama3.2-1b
   at full depth over p 2 x tp 2, 2 steps, against the ``train`` phase as
   A; layout D, recurrentgemma-2b cut to one (rec, rec, attn) super-layer over tp 4
   (the griffin path's 4 micro-steps x 2 x 2048 on every rank), against a
   one-card run of that model; both start from their model's weights at tp
   1 cut by ``convert.tp_params_from_full`` (the loop resumes from a step-0
   checkpoint of them).  Every rank's ``CommEngine`` counts must be
   the layout's (``dist_expected_calls``) and its kernel launches the train
   path's a micro-step x micro-steps x steps (attention on ``mma``, its
   backward on the path's route, RMSNorm's backward on the path's, the RG-LRU
   gated); on layout A one gather of the
   embedding row under ``flat``, ``inner_first`` and ``outer_first`` must
   give bitwise the same buffer, the full row.  It prints the device count,
   the backend, the ranks a card, each rank's ``step_ms``, host seconds in
   collectives and ``peak_gb``, and its own seconds.  A rank that fails
   fails the phase.
3c. ``dist_wires``: the int8 and bf16 wires, run by the same 4 worker
   processes after their layouts, on layout A's and B's process groups:
   llama3.2-1b at full width cut to 4 layers, dist_train's data, seed and
   OptConfig, 2 steps, stochastic rounding.  A-q: p 4, ``outer_first``
   inner 2, the int8 gather (qwZ) and the int8 hop 1 (qgZ); B-q: p 2 x 2
   replicas, the bf16 hop 1 and the int8 hop 2 over the bucketed boundary.
   Each step's loss within 0.05 and grad norm within 0.1 (relative) of the
   one-card fp32-wire run of the same model (layout B's reference); every
   rank's collective calls, kernel launches and quantize launches by
   rounding as ``dist_wire_expected``; the int8 legs' counted bytes (values
   and scales) at most 0.55 of a bf16 wire's for the same payloads.  Each
   rank's ``step_ms``, host seconds in collectives and ``peak_gb``.
3d. ``dist_elastic``: the elastic, fault-tolerant loop, run by the same 4
   worker processes after the wires: llama3.2-1b at full width cut to 2
   layers, dist_train's seed and OptConfig, one micro-step of 4 x 2048
   tokens a step, bf16 gather, through
   ``runtime/train_loop.train`` with a ``FaultPlan`` and ``ElasticConfig()``
   from layout B (p 2 x 2 replicas), an async checkpoint every 2 steps, 5
   steps.  Steps 0-2 run on 4 ranks; at 3 ranks 2-3 are lost abruptly and
   the run rolls back to the step-2 checkpoint; steps 2-3 run on ranks 0-1
   (the keep rule: p 2, one replica; ranks 2-3 parked); at 4 they come back
   with notice (an emergency save at 4) and step 4 runs on 4 ranks.  Every
   rank's ledger must be ``ELASTIC_LEDGER``, the batches it fetched
   ``ELASTIC_CURSORS`` (ranks 0-1: 6 losses, one emergency save), and each
   world's losses and the state it checkpointed at its end bitwise a cold
   ``elastic_restart`` of the checkpoint it resumed from, on the same
   topology; each rank's launches the train path's a micro-step x
   micro-steps x the steps it ran.  It prints the ledger with each
   rebuild's seconds (groups, step function, restore), each save's seconds
   blocked against its writer's, the checkpoint's GB, each rank's step
   times, ``peak_gb`` and launches.
4. ``kernels``: each kernel at the paths' shapes against its plain version
   on the same inputs, with its time, the plain version's, one PyTorch
   library call's where there is one, and the card's bound for the same
   work; ``launches`` sums the serve runs, the train runs, the
   ``train_knobs`` variants and every rank of ``dist_train``, ``dist_wires``
   and ``dist_elastic``.  Attention also
   runs at the tile edges of each route (fp32 cases take the ``fma``
   route), each check records its route and is called twice for a
   bitwise-equal output, prefill checks give their achieved TFLOP/s, and
   the split route's partials kernel is held alone against its plain
   version.  RMSNorm gives its plan per shape.  RG-LRU runs both entry
   points, each with its chunk plan: gated at the path's shapes, beside the
   eager sequence it replaced (``eager_ms``), and the TPU kernel's ``(a, b)``
   form; every RMSNorm and RG-LRU check is called twice for a bitwise-equal
   output.  The train paths' forward shapes are checked too: RMSNorm at
   each path's token rows, the gated RG-LRU at recurrentgemma's train
   micro-batch, and flash attention's output and log-sum-exp (as the train
   path's forward writes them) at each backward check's shape; and a rank's
   shapes in ``dist_train``'s layouts C and D (llama at tp 2: 4 KV heads of
   g 4; recurrentgemma at tp 4: one KV head of g 3 at dh 256, the RG-LRU at
   640 channels), forward and backward.  The
   backward kernels run at the train shapes and at each
   route's edges, each check naming its route and showing that the call
   took it: RMSNorm's ``regs`` route (bf16 rows held in registers) and
   ``smem`` route (fp32, ragged or wider rows); flash attention's ``wgmma``
   route (ragged T 300, window 64, g 1, dh 128), a group size it refuses
   (g 3, to ``mma``), ``mma`` at dh 32 and ``fma`` at fp32, with the
   forward's log-sum-exp and TFLOP/s (the device time a call of each of
   the flash backward's launches, delta, dK / dV, the fold and dQ, is read
   from the train steps' profiles); ``wgmma256`` at dh 256 (recurrentgemma's
   train shape, window 64, ragged T, one KV head with g 3), each beside
   ``mma`` by column halves on the same inputs (checked and timed in the
   same run), and two KV heads with g 10, which ``wgmma256`` refuses, on
   ``mma``.  ``digest``: the line ``--digest-only`` prints.  The RG-LRU backward at the train shape and
   its edges (T not a multiple of the chunk, T 1, C not a multiple of 128,
   fp32, the clip binding, the ``(a, b)`` form), each from the chunk
   starts its forward writes (held to their plain version).  All bitwise repeatable,
   with the library's autograd backward (``F.rms_norm``,
   ``F.scaled_dot_product_attention``) as ``library_ms``; the RG-LRU has
   none (no one PyTorch call computes a linear recurrence).  The int8
   quantizer (``csrc/quant.cu``, no TPU kernel: the reference's jnp,
   which XLA fuses): ``quantize`` (nearest, stochastic, stochastic keyed
   by a device fingerprint) and ``dequantize`` (to bf16 and fp32, and an
   exchange stage's chunk sum) bitwise their plain versions and bitwise
   repeatable, at a llama layer row, its embedding row, the exchange
   stage's ``[4, n / 4]``, ragged lengths, bf16 input and all-zero blocks,
   beside the eager sequence each replaces (``eager_ms``; no library call).
   The ``paged`` route (``flash_attention_paged``) at ``serve_paged``'s
   shapes (a decode tick of 8 requests at lengths 250-350, a 64-token
   chunk; bf16 and int8 pages) with SDPA over the contiguous view
   gathered beforehand as ``library_ms``.

``python3 chip_smoke.py --profile-only`` runs the ``profile`` phases alone
(both serve paths, then the train steps; no checks, no result line): it
uses only the serve API and ``build_train_step``, so the same file also
profiles an earlier checkout (one that already trains) for comparison.
``--digest-only`` prints a sha256 of llama's train-shape flash backward
on fixed inputs through ``flash_attention_fwd`` / ``flash_attention_bwd``
alone, so two checkouts' kernels can be compared bit for bit.

Before the card's name and the last line, ``{"phase_seconds": [...],
"script_s": ...}`` lists every phase line's seconds and the script's.
The last line is ``{"ok": true, "device": {...}}``.  Without a card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py's
RGLRU_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-5}  # its test_rglru's
# The gated RG-LRU at fp32, as a fraction of max |h|: the card's expf,
# division and sqrt against the CPU-style math of the plain version, whose
# ulps the recurrence amplifies by up to 1 / (1 - a)
# (tests/test_torch_rglru_gated.py holds the plain version to JAX so too).
RGLRU_GATED_FP32_REL = 1e-4
# fp32 operations of the gate math and the recurrence an element (two
# sigmoids' products, sums and divisions, log_a, b's clamp, sqrt and
# products, one FMA), for the operations side of the gated form's bound.
GATED_OPS_PER_ELEMENT = 25
# Card-vs-card and card-vs-CPU agreement of the whole bf16 model, as a
# fraction of the largest |logit|: both sides round every activation to
# bf16, in different orders (the kernels' fp32 sums versus cuBLAS's or the
# CPU's), over 16, 26, 2 or 5 layers.
REL_TOL_DECODE_VS_PREFILL = 5e-2
REL_TOL_CARD_VS_CPU = 5e-2


@dataclasses.dataclass(frozen=True)
class Path:
    arch: str
    batch: int
    prompt: int
    steps: int
    cache_len: int
    cut_layers: int          # depth of the card-vs-CPU check
    launches: dict           # kernel -> launches per forward


PATHS = (
    Path("llama3.2-1b", 4, 512, 32, 512 + 32, 2,
         {"rmsnorm": 33, "rmsnorm_bwd": 0, "flash_attention": 16, "flash_attention_bwd": 0,
          "rglru": 0, "rglru_bwd": 0, "quantize": 0, "dequantize": 0}),
    Path("recurrentgemma-2b", 4, 2560, 32, 2560 + 32, 5,
         {"rmsnorm": 53, "rmsnorm_bwd": 0, "flash_attention": 8, "flash_attention_bwd": 0,
          "rglru": 18, "rglru_bwd": 0, "quantize": 0, "dequantize": 0}),
)


@dataclasses.dataclass(frozen=True)
class TrainPath:
    arch: str
    global_batch: int
    micro_steps: int
    seq: int
    steps: int
    launches: dict           # kernel -> launches a micro-step
    attn_bwd_route: str      # the route of every attention backward
    rms_bwd_route: str       # the route of every RMSNorm backward
    cut_layers: int          # depth of the train_consistency phase
    cut_tokens: int          # its one micro-batch: 1 x cut_tokens


# Each layer's compute is checkpointed and recomputed once in the backward
# (the final norm and the head are not).  llama: RMSNorm 33 forward (2 a
# layer + the final norm) + 32 recomputed and 33 backward; attention 16 + 16
# and 16 backward.  recurrentgemma (26 sub-layers: 18 recurrent, 8
# attention): RMSNorm 53 + 52 and 53 backward; attention 8 + 8 and 8
# backward; the gated RG-LRU 18 + 18 and 18 backward.  Every attention
# forward takes ``mma``; recurrentgemma's attention backward (dh 256, one KV
# head) takes ``wgmma256``.
TRAIN = (
    TrainPath("llama3.2-1b", 8, 2, 2048, 4,
              {"rmsnorm": 65, "rmsnorm_bwd": 33, "flash_attention": 32,
               "flash_attention_bwd": 16, "rglru": 0, "rglru_bwd": 0, "quantize": 0,
               "dequantize": 0},
              "wgmma", "regs", 2, 256),
    TrainPath("recurrentgemma-2b", 8, 4, 2048, 4,
              {"rmsnorm": 105, "rmsnorm_bwd": 53, "flash_attention": 16,
               "flash_attention_bwd": 8, "rglru": 36, "rglru_bwd": 18, "quantize": 0,
               "dequantize": 0},
              "wgmma256", "smem", 5, 256),
)
# Card against CPU in the train_consistency phase, as a fraction of each
# pool's largest |gradient| (and of |loss|, |grad_norm|): both sides round
# activations and gradients to bf16, in different orders of sums.
REL_TOL_GRAD_CARD_VS_CPU = 5e-2
# Params after one AdamW step from zero moments move by about lr * sign(g);
# where the two sides' gradients differ in sign (|g| near rounding) a
# weight lands up to 2 lr apart.
ADAMW_STEP_TOL_LR = 2.5


def counter_attrs():
    """kernel -> (module, counter attribute): each wrapper adds one where it
    launches its kernel."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.quant import kernel as QK
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN

    return {"rmsnorm": (RN, "launches"), "rmsnorm_bwd": (RN, "launches_bwd"),
            "flash_attention": (FA, "launches"), "flash_attention_bwd": (FA, "launches_bwd"),
            "rglru": (RG, "launches"), "rglru_bwd": (RG, "launches_bwd"),
            "quantize": (QK, "launches_quantize"), "dequantize": (QK, "launches_dequantize")}


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.quant import kernel as QK
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN

    for mod, attr in counter_attrs().values():
        setattr(mod, attr, 0)
    for table in (FA.launches_by_route, FA.launches_bwd_by_route, RG.launches_by_form,
                  RG.launches_bwd_by_form, RN.launches_bwd_by_route,
                  QK.launches_quantize_by_mode):
        table.update(dict.fromkeys(table, 0))


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counter_attrs().items()}


# The phase clock: each phase line's ``seconds`` is the time since the line
# before it (or since the script's start), unless the phase timed itself;
# the ``summary`` line lists them.  ``start`` is the script's start.
PHASE_CLOCK = {"start": None, "last": None, "lines": []}


def emit(obj) -> None:
    if "phase" in obj and PHASE_CLOCK["last"] is not None:
        now = time.perf_counter()
        obj.setdefault("seconds", now - PHASE_CLOCK["last"])
        PHASE_CLOCK["last"] = now
        PHASE_CLOCK["lines"].append({k: obj[k] for k in ("phase", "arch", "step", "seconds")
                                     if k in obj})
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _types(mangled_args: str) -> list[str]:
    """The template's types in a mangled argument list: bf16 is the only
    type named twice in these kernels, so a back-reference (``S1_``) is bf16."""
    return ["fp32" if t == "f" else "bf16"
            for t in re.findall(r"13__nv_bfloat16|S\d*_|f", mangled_args)]


def ptxas_summary(log: str) -> list[dict]:
    """Registers, spills and static shared memory of each kernel
    instantiation, from the ``-Xptxas -v`` lines of the build log: the lines
    from one "Compiling entry function" to the next describe that function.
    Flash attention gives its head dim; RMSNorm its x and scale types,
    vectors a lane and whether it is the vector or the scalar path; RG-LRU
    (forward and backward) its form (``ab`` or ``gated``) and types.  A
    count the log does not give is None."""
    def num(pattern: str, text: str) -> int | None:
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None

    out = []
    for block in log.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        name = re.search(r"\d+((?:flash|rglru|rmsnorm)_\w*?kernel)(\w*)", mangled)
        if name is None:
            continue
        kernel, args = name.group(1), name.group(2)
        row = {"kernel": kernel}
        ints = [int(v) for v in re.findall(r"Li(\d+)E", args.split("EEv", 1)[0])]
        if kernel.startswith("flash_bwd_delta_bf16"):
            row["lanes_per_row"] = ints[0] if ints else None
        elif kernel.startswith("flash"):
            row["dh"] = ints[0] if ints else (256 if "wgmma256" in kernel else None)
            if kernel.startswith("flash_paged"):  # <dh, int8 pages>
                row["int8_pages"] = "Lb1E" in args
            if "wgmma" in kernel:  # <dh, stages[, rows a tile]>
                row["stages"] = ints[1] if len(ints) > 1 else None
                row["tile"] = ints[2] if len(ints) > 2 else None
        elif kernel.startswith("rmsnorm"):
            m = re.match(r"I(\w+?)Li(\d+)ELb(\d)E", args)  # the forward: <T, S, VPL, VEC>
            if m:
                row["types"] = _types(m.group(1))
                row["vecs_per_lane"] = int(m.group(2))
                row["vector_path"] = bool(int(m.group(3)))
            else:  # the backward: <T, S, E> (smem) or <S, VPL> (regs); the fold <S>
                m = re.match(r"I(\w+?)(?:Li(\d+)E)?E", args)
                row["types"] = _types(m.group(1)) if m else None
                row["per_lane"] = int(m.group(2)) if m and m.group(2) else None
        else:
            m = re.search(r"(Gated|Ab)(?:Source|Bwd)I(\w+?)EE", args)
            row["form"] = None if m is None else {"Gated": "gated", "Ab": "ab"}[m.group(1)]
            row["types"] = _types(m.group(2)) if m else None
        out.append({**row, "registers": num(r"Used (\d+) registers", block),
                    "spill_stores": num(r"(\d+) bytes spill stores", block),
                    "spill_loads": num(r"(\d+) bytes spill loads", block),
                    "static_smem": num(r"(\d+) bytes smem", block) or 0})
    return out


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median CUDA-event time of one call, with L2 flushed before each.
    A spin of about half a millisecond on the card after the flush lets the
    host enqueue the whole call before the card reaches the start event, so
    the time is the card's and not the Python wrapper's (see host_us)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, calls: int = 200) -> float:
    """Host time to enqueue one call (Python, checks, launches), taken
    while a spin keeps the card busy so no call waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return dt


def bound(nbytes: int, ops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cut_params(model, params, n_layers: int):
    """The flat pools of the same weights at ``n_layers`` depth: the first
    rows of the first pool, the tail pool kept whole (of each leaf of a
    stored int8 pool ``{'q', 's'}``)."""
    from repro_torch.models.build import build_model

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    small = build_model(cfg, tp=1)
    out = {}
    for name, (stack, _, _) in small.global_flat_shapes().items():
        pool = params[name]
        out[name] = ({k: v[:stack].contiguous() for k, v in pool.items()}
                     if isinstance(pool, dict) else pool[:stack].contiguous())
    return small, out


def setup_path(path: Path, dev):
    """The path's model, weights, serve steps and prompt, warmed up once
    (cuBLAS handles, allocator; not counted)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    params = init_params(model, seed=0, device=dev)
    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True)
    prefill_fn, decode_fn = build_serve_steps(model, MiCSTopology(), mcfg, path.cache_len,
                                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (path.batch, path.prompt), generator=gen, device=dev)
    logits, caches = prefill_fn(params, {"tokens": prompt})
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), path.prompt)
    del logits, caches
    torch.cuda.synchronize()
    return cfg, model, mcfg, params, prefill_fn, decode_fn, prompt


# Device kernels by kind, for the profile's ``by_kind`` sums: the first
# pattern a kernel's name contains names its kind.
KERNEL_KINDS = (("flash_bwd", "flash attention backward"), ("flash_", "flash attention"),
                ("rmsnorm_bwd", "RMSNorm backward"), ("rmsnorm", "RMSNorm"),
                ("rglru_bwd", "RG-LRU backward"), ("rglru", "RG-LRU"),
                ("dequantize", "dequantize"), ("quantize", "quantize"), ("nvjet", "GEMM"),
                ("gemm", "GEMM"),
                ("reduce_kernel", "reduction"), ("copy", "copy / cast"),
                ("elementwise", "elementwise"), ("embedding", "embedding"))


# The flash backward's launches by the profile's kernel names (the fold only
# on the wgmma256 route).
FLASH_BWD_PARTS = (("delta", "flash_bwd_delta"), ("dkdv", "flash_bwd_dkdv"),
                   ("fold", "flash_bwd_fold"), ("dq", "flash_bwd_dq"))
# The port's own kernels' kinds: each counted wrapper call launches at least
# one device kernel of these.
PORT_KINDS = ("flash attention backward", "flash attention", "RMSNorm backward", "RMSNorm",
              "RG-LRU backward", "RG-LRU", "dequantize", "quantize")


def kernel_kind(name: str) -> str:
    return next((kind for pat, kind in KERNEL_KINDS if pat in name), "other")


# What a profile session traces: the host's operators beside the card's
# kernels (the default), or the card's kernels alone, which costs far less
# to collect for a train step's ~35,000 kernels.
HOST_AND_CARD = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
CARD_ONLY = (torch.profiler.ProfilerActivity.CUDA,)


def profile_session(run, activities=HOST_AND_CARD):
    """One profiled call of ``run``: ``(wall_ms, device rows, port kernel
    events, counted wrapper calls)``, the launch counters set to 0 just
    before the call and read just after."""
    reset_counts()
    with torch.profiler.profile(activities=list(activities)) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = sum(read_counts().values())
    # device-side kernel and memcpy events only (the CPU-side aten ops carry
    # the same time again as their children's)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Activity Buffer Request"]
    ours = sum(e.count for e in rows if kernel_kind(e.key) in PORT_KINDS)
    return wall_ms, rows, ours, counted


def profile_line(arch: str, step: str, run, top: int = 12, activities=HOST_AND_CARD,
                 **extra) -> dict:
    """Device time of one call of ``run`` by kernel (it has run once before,
    so nothing is built or first-allocated in the window), the number of
    device kernels it runs, their time by kind, and the flash backward's
    device time a call of each of its launches where it ran: a ``profile``
    line with ``extra``'s fields.  A session whose port kernel
    events fall short of the wrapper calls the launch counters show for the
    same call (the profiler dropped events) is taken again once; if it is
    still short the line says ``"events_short": true`` and is no full
    profile."""
    run()
    torch.cuda.synchronize()
    for _ in range(2):
        wall_ms, rows, ours, counted = profile_session(run, activities)
        if ours >= counted:
            break
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    line = {"phase": "profile", "arch": arch, "step": step, **extra,
            "events_short": ours < counted, "port_kernel_events": ours,
            "port_calls_counted": counted, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "device_kernels": sum(e.count for e in rows), "by_kind": {},
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in rows[:top]]}
    for e in rows:
        kind = kernel_kind(e.key)
        got = line["by_kind"].setdefault(kind, {"calls": 0, "device_ms": 0.0})
        got["calls"] += e.count
        got["device_ms"] += e.self_device_time_total / 1e3
    for part, pat in FLASH_BWD_PARTS:
        hits = [e for e in rows if pat in e.key]
        if hits:
            line.setdefault("flash_bwd_ms_per_launch", {})[part] = (
                sum(e.self_device_time_total for e in hits) / 1e3 / sum(e.count for e in hits))
    return line


def profile_run(arch: str, step: str, run, top: int = 12, **extra) -> dict:
    """:func:`profile_line`, emitted."""
    line = profile_line(arch, step, run, top, **extra)
    emit(line)
    return line


def profile_path(path: Path, cfg, params, prefill_fn, decode_fn, prompt):
    """``profile``: device time of one prefill and one decode step by kernel
    (decode from the prompt's cache with its greedy token), and the number
    of device kernels each runs."""
    logits, pcache = prefill_fn(params, {"tokens": prompt})
    first_ids = torch.argmax(logits[:, -1:].float(), dim=-1)
    del logits
    profile_run(cfg.name, "prefill", lambda: prefill_fn(params, {"tokens": prompt}))
    profile_run(cfg.name, "decode", lambda: decode_fn(params, pcache, first_ids, path.prompt))
    del pcache


def serve_path(path: Path, card: str, dev):
    """Serve, consistency and profile phases of one path; returns the
    launches of its serve run, by kernel, attention's by route and
    RG-LRU's by form."""
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.runtime.serving import build_serve_steps

    cfg, model, mcfg, params, prefill_fn, decode_fn, prompt = setup_path(path, dev)
    topo = MiCSTopology()
    torch.cuda.reset_peak_memory_stats()

    # -- serve ---------------------------------------------------------------------
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    generated, step_logits = [tok], []
    t0 = time.perf_counter()
    for i in range(path.steps):
        logits, tok, caches = decode_fn(params, caches, tok, path.prompt + i)
        step_logits.append(logits)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    by_route = dict(FA.launches_by_route)
    by_form = dict(RG.launches_by_form)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ids = torch.cat(generated, dim=1)  # [b, 1 + steps]: prefill's token, then each step's
    want = {name: n * (1 + path.steps) for name, n in path.launches.items()}
    if launches != want:
        raise AssertionError(f"{path.arch}: launch counts {launches} != {want}")
    n_attn = path.launches["flash_attention"]
    want_route = {"mma": n_attn, "split": n_attn * path.steps, "fma": 0, "paged": 0}
    if by_route != want_route:
        raise AssertionError(f"{path.arch}: attention routes {by_route} != {want_route}")
    want_form = {"ab": 0, "gated": want["rglru"]}
    if by_form != want_form:
        raise AssertionError(f"{path.arch}: RG-LRU entry points {by_form} != {want_form}")
    for lg in step_logits:
        if lg.shape != (path.batch, 1, model.vocab_padded) or not torch.isfinite(lg).all():
            raise AssertionError("decode logits not finite or of the wrong shape")
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab:
        raise AssertionError("sampled ids out of the vocabulary")
    bf16 = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_s * 1e3 / path.steps,
            "tokens_per_s": path.batch * path.steps / decode_s, "peak_gb": peak_gb}
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "pools": {p.name: p.stack for p in model.pools}, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "batch": path.batch, "prompt": path.prompt,
          "decode_steps": path.steps, "cache_len": path.cache_len, "window": cfg.window,
          "gather_dtype": "bf16", "schedule": "prefetch", **bf16,
          "launches": launches, "attention_launches_by_route": by_route,
          "rglru_launches_by_form": by_form,
          "ids_row0": ids[0].tolist(), "gpu": card})
    del caches

    # -- consistency -------------------------------------------------------------
    # (a) decode step 8 (which fed the 8th generated token) against a prefill
    # over the prompt plus those 8 tokens
    ext = torch.cat([prompt, ids[:, :8]], dim=1)
    lg_pre, _ = prefill_fn(params, {"tokens": ext})
    ref = step_logits[7].float()
    err_a = (lg_pre.float() - ref).abs().max().item()
    scale_a = ref.abs().max().item()
    argmax_a = (lg_pre.float().argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not err_a <= REL_TOL_DECODE_VS_PREFILL * scale_a:
        raise AssertionError(f"{path.arch}: decode vs prefill recompute: {err_a} > "
                             f"{REL_TOL_DECODE_VS_PREFILL} x {scale_a}")
    del lg_pre, step_logits
    # (b) cut depth, same width: card (kernels) against CPU (plain versions)
    model2, params2 = cut_params(model, params, path.cut_layers)
    p_card, _ = build_serve_steps(model2, topo, mcfg, 128, device=dev)
    p_cpu, _ = build_serve_steps(model2, topo, mcfg, 128, device="cpu")
    tokens2 = prompt[:1, :128]
    lg_card, _ = p_card(params2, {"tokens": tokens2})
    lg_cpu, _ = p_cpu({k: v.cpu() for k, v in params2.items()}, {"tokens": tokens2.cpu()})
    ref_b = lg_cpu.float()
    err_b = (lg_card.float().cpu() - ref_b).abs().max().item()
    scale_b = ref_b.abs().max().item()
    if not err_b <= REL_TOL_CARD_VS_CPU * scale_b:
        raise AssertionError(f"{path.arch}: card vs CPU at depth {path.cut_layers}: "
                             f"{err_b} > {REL_TOL_CARD_VS_CPU} x {scale_b}")
    emit({"phase": "consistency", "arch": cfg.name,
          "decode_vs_prefill": {"max_abs_err": err_a, "max_abs_logit": scale_a,
                                "rel_tol": REL_TOL_DECODE_VS_PREFILL,
                                "argmax_agree": argmax_a},
          "card_vs_cpu": {"layers": path.cut_layers, "pools": model2.global_flat_shapes(),
                          "max_abs_err": err_b, "max_abs_logit": scale_b,
                          "rel_tol": REL_TOL_CARD_VS_CPU}})
    del params2, lg_card, lg_cpu

    # -- profile: where one prefill and one decode step spend the card's time --
    profile_path(path, cfg, params, prefill_fn, decode_fn, prompt)

    # -- serve_int8: the same serve from int8 weights stored on the card ------------
    from repro_torch.core.quant import quantize_state

    t0 = time.perf_counter()
    stored = quantize_state(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    int8 = serve_int8_phase(path, cfg, model, params, stored, prompt, ids, bf16,
                            (prefill_fn, decode_fn), quantize_s, card, dev)
    del stored, prefill_fn, decode_fn
    torch.cuda.empty_cache()
    # -- serve_paged: the continuous-batching engine (the dense family) ----------
    paged = None
    if cfg.family == "dense":
        paged = serve_paged_phase(cfg, model, params, card, dev)
        emit(paged)
    del params
    torch.cuda.empty_cache()
    return launches, by_route, by_form, int8, paged


def int8_serve_launches(path: Path, model) -> dict:
    """The launches of a ``serve_int8`` run (prefill + ``path.steps``
    decode steps): the ``serve`` run's, and one dequantize a gathered pool
    row a forward (every layer row, the embedding and the head)."""
    rows = sum(pool.stack for pool in model.all_pools())
    return {name: n * (1 + path.steps) for name, n in path.launches.items()} | {
        "dequantize": rows * (1 + path.steps)}


def serve_int8_phase(path: Path, cfg, model, params: dict, stored: dict, prompt, ids_bf16,
                     bf16: dict, bf16_steps: tuple, quantize_s: float, card: str,
                     dev) -> tuple:
    """``serve_int8``: ``path``'s serve (model, prompt, batch, greedy steps)
    with ``MiCSConfig(quant_gather=True)`` from ``stored`` (``quantize_state``
    of the ``serve`` run's weights ``params``, made on the card), every pool
    row dequantized on the card at every forward.  Its numbers beside the
    bf16 ``serve`` run's (``bf16``); ``peak_gb`` less the fp32 weights,
    which stay resident and unchanged through the run; the stored bytes
    against fp32; the share of generated tokens equal to the bf16 run's
    (reported, not gated); launch counts (:func:`int8_serve_launches`),
    attention's routes and RG-LRU's form as ``serve``; decode step 8 against
    a prefill over the prompt and the first 8 tokens; at the cut depth the
    card's prefill logits against the CPU's on the same stored bytes; the
    decode's time a step from bf16 (``bf16_steps``, the ``serve`` run's
    steps) and int8 weights timed in turns (bf16, int8, int8, bf16), each
    after its own prefill; a profile of one decode step.  Returns
    ``(launches, attention's by route, RG-LRU's by form)``."""
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.runtime.serving import build_serve_steps

    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True, quant_gather=True)
    topo = MiCSTopology()
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, path.cache_len, device=dev)
    logits, caches = prefill_fn(stored, {"tokens": prompt})   # warm-up, as setup_path
    decode_fn(stored, caches, torch.argmax(logits[:, -1:].float(), dim=-1), path.prompt)
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(stored, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    generated, step_logits = [tok], []
    t0 = time.perf_counter()
    for i in range(path.steps):
        logits, tok, caches = decode_fn(stored, caches, tok, path.prompt + i)
        step_logits.append(logits)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()
    by_route, by_form = dict(FA.launches_by_route), dict(RG.launches_by_form)
    fp32_bytes = sum(t.numel() * t.element_size() for t in params.values())
    peak_gb = (torch.cuda.max_memory_allocated() - fp32_bytes) / 1e9
    del caches
    ids = torch.cat(generated, dim=1)
    want = int8_serve_launches(path, model)
    if launches != want:
        raise AssertionError(f"{path.arch} int8: launch counts {launches} != {want}")
    n_attn = path.launches["flash_attention"]
    if by_route != {"mma": n_attn, "split": n_attn * path.steps, "fma": 0, "paged": 0}:
        raise AssertionError(f"{path.arch} int8: attention routes {by_route}")
    if by_form != {"ab": 0, "gated": want["rglru"]}:
        raise AssertionError(f"{path.arch} int8: RG-LRU entry points {by_form}")
    for lg in step_logits:
        if lg.shape != (path.batch, 1, model.vocab_padded) or not torch.isfinite(lg).all():
            raise AssertionError(f"{path.arch} int8: decode logits not finite or misshapen")
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab:
        raise AssertionError(f"{path.arch} int8: sampled ids out of the vocabulary")
    agree = (ids == ids_bf16).float().mean().item()
    # decode step 8 against a prefill over the prompt and the first 8 tokens
    lg_pre, _ = prefill_fn(stored, {"tokens": torch.cat([prompt, ids[:, :8]], dim=1)})
    ref = step_logits[7].float()
    err_a, scale_a = (lg_pre.float() - ref).abs().max().item(), ref.abs().max().item()
    if not err_a <= REL_TOL_DECODE_VS_PREFILL * scale_a:
        raise AssertionError(f"{path.arch} int8: decode vs prefill recompute: {err_a} > "
                             f"{REL_TOL_DECODE_VS_PREFILL} x {scale_a}")
    del lg_pre, step_logits
    # the cut depth, card against CPU on the same stored int8 bytes
    model2, stored2 = cut_params(model, stored, path.cut_layers)
    p_card, _ = build_serve_steps(model2, topo, mcfg, 128, device=dev)
    p_cpu, _ = build_serve_steps(model2, topo, mcfg, 128, device="cpu")
    tokens2 = prompt[:1, :128]
    lg_card, _ = p_card(stored2, {"tokens": tokens2})
    lg_cpu, _ = p_cpu({k: {p: t.cpu() for p, t in v.items()} for k, v in stored2.items()},
                      {"tokens": tokens2.cpu()})
    err_b = (lg_card.float().cpu() - lg_cpu.float()).abs().max().item()
    scale_b = lg_cpu.float().abs().max().item()
    if not err_b <= REL_TOL_CARD_VS_CPU * scale_b:
        raise AssertionError(f"{path.arch} int8: card vs CPU at depth {path.cut_layers}: "
                             f"{err_b} > {REL_TOL_CARD_VS_CPU} x {scale_b}")
    del stored2, lg_card, lg_cpu

    def decode_ms(steps, weights) -> float:
        """One prefill, then ``path.steps`` greedy decode steps timed."""
        logits, caches = steps[0](weights, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1:].float(), dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(path.steps):
            _, tok, caches = steps[1](weights, caches, tok, path.prompt + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / path.steps

    in_turns = {"bf16": [], "int8": []}
    for wire in ("bf16", "int8", "int8", "bf16"):
        in_turns[wire].append(decode_ms(bf16_steps, params) if wire == "bf16" else
                              decode_ms((prefill_fn, decode_fn), stored))
    int8_bytes = sum(t.numel() * t.element_size() for v in stored.values() for t in v.values())
    emit({"phase": "serve_int8", "arch": cfg.name, "layers": cfg.n_layers,
          "batch": path.batch, "prompt": path.prompt, "decode_steps": path.steps,
          "gather": "int8 stored weights (quant_gather), bf16 compute", "schedule": "prefetch",
          "prefill_ms": prefill_ms, "decode_ms_per_step": decode_s * 1e3 / path.steps,
          "tokens_per_s": path.batch * path.steps / decode_s, "peak_gb": peak_gb,
          "bf16_serve": bf16, "stored_gb": {"int8_and_scales": int8_bytes / 1e9,
                                            "fp32": fp32_bytes / 1e9},
          "decode_ms_per_step_in_turns": in_turns,
          "quantize_state_s": quantize_s, "tokens_equal_to_bf16": agree,
          "launches": launches, "attention_launches_by_route": by_route,
          "rglru_launches_by_form": by_form,
          "decode_vs_prefill": {"max_abs_err": err_a, "max_abs_logit": scale_a,
                                "rel_tol": REL_TOL_DECODE_VS_PREFILL},
          "card_vs_cpu": {"layers": path.cut_layers, "max_abs_err": err_b,
                          "max_abs_logit": scale_b, "rel_tol": REL_TOL_CARD_VS_CPU},
          "ids_row0": ids[0].tolist(), "gpu": card})
    # where one decode step from the stored weights spends the card's time
    logits, pcache = prefill_fn(stored, {"tokens": prompt})
    first_ids = torch.argmax(logits[:, -1:].float(), dim=-1)
    del logits
    profile_run(cfg.name, "decode int8", lambda: decode_fn(stored, pcache, first_ids,
                                                           path.prompt))
    del pcache
    return launches, by_route, by_form


# -- the continuous-batching engine: serve_paged --------------------------------


@dataclasses.dataclass(frozen=True)
class PagedServe:
    """The ``serve_paged`` phase's engine and trace (llama3.2-1b, bf16 pools)."""

    slots: int = 8
    chunk: int = 64            # prefill tokens a slot a tick (every tick runs at this width)
    block: int = 16
    max_blocks: int = 36       # 576 positions: the longest prompt and its new tokens
    requests: int = 24
    prompt_lo: int = 64
    prompt_hi: int = 512
    new_tokens: int = 32
    arrival_every: int = 2     # ticks between arrivals
    temperature: float = 0.7   # odd requests; the even ones greedy
    top_k: int = 8
    crash_at: int = 20
    check_rows: int = 8        # requests of the paged == contiguous and chunk checks
    check_steps: int = 16      # their decode steps


PAGED = PagedServe()
# int8 pools against bf16 pools, the decode logits of the same fed tokens,
# as a fraction of the largest |logit|: the reference's bound for its int8
# engine against its fp32 one (tests/serve_harness.py int8_kv_error).
PAGED_INT8_REL_TOL = 0.1


def paged_requests(R, vocab: int, pg: PagedServe = PAGED) -> list:
    """The phase's trace: prompts of ``prompt_lo`` to ``prompt_hi`` tokens
    and ``new_tokens`` each, from seed 0; even requests greedy, odd ones at
    ``temperature`` (top-k ``top_k`` in the engine)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(pg.prompt_lo, pg.prompt_hi + 1, pg.requests)
    return [R.Request(rid=i, prompt=rng.integers(1, vocab, int(n)).tolist(),
                      max_new_tokens=pg.new_tokens,
                      temperature=pg.temperature if i % 2 else 0.0, seed=1000 + i)
            for i, n in enumerate(lens)]


class TickClock:
    """Host times of a serve loop's ticks (each commit ends one) and of its
    engine steps (each ends in the sampled tokens' copy to the host, so the
    card is done), and the first decode-only plan."""

    def __init__(self, loop):
        self.ends, self.steps, self.decode_plan = [], [], None
        self.start = time.perf_counter()
        commit, step = loop.batcher.commit, loop._engine_step

        def timed_commit(plan, sampled):
            out = commit(plan, sampled)
            self.ends.append(time.perf_counter())
            return out

        def timed_step(plan):
            decode_only = int(plan.n_new.max()) <= 1
            if decode_only and self.decode_plan is None:
                self.decode_plan = plan
            t0 = time.perf_counter()
            tok = step(plan)
            self.steps.append((len(self.ends), decode_only, (time.perf_counter() - t0) * 1e3))
            return tok

        loop.batcher.commit, loop._engine_step = timed_commit, timed_step

    def tick_start(self, tick: int) -> float:
        return self.ends[tick - 1] if tick else self.start


def _pct(xs, q):
    return statistics.quantiles(xs, n=100, method="inclusive")[q - 1] if len(xs) > 1 else (
        xs[0] if xs else None)


def paged_kernel_cases(gen, dev, pg: PagedServe = PAGED) -> list:
    """The ``paged`` route's inputs at the phase's shapes: llama's 8 KV heads
    of g 4 at dh 64, a pool of ``slots * max_blocks + 1`` blocks of
    ``block`` tokens, 8 requests on shuffled blocks; a decode tick (valid
    lengths 250-350) and a 64-token chunk (positions at chunk starts), over
    bf16 and int8 pages."""
    from repro_torch.core import quant as Q

    b, hkv, g, dh = pg.slots, 8, 4, 64
    nb = pg.slots * pg.max_blocks + 1
    cap = pg.max_blocks * pg.block
    order = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2)) + 1
    tables = order[:b * pg.max_blocks].reshape(b, pg.max_blocks).to(torch.int32).to(dev)
    k = torch.randn(nb, pg.block, hkv, dh, generator=gen, device=dev)
    v = torch.randn(nb, pg.block, hkv, dh, generator=gen, device=dev)
    pages = {"bf16": ((k.to(torch.bfloat16), v.to(torch.bfloat16)), {})}
    (qk, sk), (qv, sv) = Q.quantize_flat(k), Q.quantize_flat(v)
    pages["int8"] = ((qk, qv), {"k_scale": sk, "v_scale": sv})
    cases = []
    for kind, tq in (("decode tick", 1), (f"{pg.chunk}-token chunk", pg.chunk)):
        if tq == 1:
            pos = torch.randint(249, 350, (b,), generator=gen, device=dev)
        else:
            pos = pg.chunk * torch.randint(0, cap // pg.chunk - 1, (b,), generator=gen,
                                           device=dev)
        kvl = pos[:, None] + torch.arange(1, tq + 1, device=dev)[None, :]
        q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=dev).to(torch.bfloat16)
        for dt, ((kp, vp), sc) in pages.items():
            cases.append((f"{kind}, {dt} pages", q, kp, vp, tables, kvl, sc))
    return cases


def paged_kernel_checks(gen, dev, flush, timed: bool = True,
                        pg: PagedServe = PAGED) -> list:
    """The ``paged`` route against ``paged_attention_plain`` on the same
    card tensors (the split route's bf16 tolerance), bitwise repeatable;
    with ``timed`` its time, the plain version's, the bound (the live keys'
    and values' bytes, and scales, q and o, against 3.35 TB/s; 4 dh
    operations an allowed (row, key) pair) and, as ``library_ms``, SDPA over
    the contiguous view gathered (and dequantized) beforehand with the same
    boolean mask: the gather is not in its time."""
    import torch.nn.functional as F

    from repro_torch.core import quant as Q
    from repro_torch.kernels.flash_attention import kernel as FA

    out = []
    for kind, q, kp, vp, tables, kvl, sc in paged_kernel_cases(gen, dev, pg):
        o = FA.paged_attention(q, kp, vp, tables, kvl, **sc)
        ref = FA.paged_attention_plain(q, kp, vp, tables, kvl, **sc)
        tol = TOL[torch.bfloat16]
        err = (o.float() - ref.float()).abs().max().item()
        if not torch.allclose(o.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"paged attention {kind}: kernel disagrees with its plain "
                                 f"version (max |err| {err}, tol {tol})")
        if not torch.equal(o, FA.paged_attention(q, kp, vp, tables, kvl, **sc)):
            raise AssertionError(f"paged attention {kind}: not bitwise repeatable")
        b, tq, hkv, g, dh = q.shape
        bs, cap = kp.shape[1], tables.shape[1] * kp.shape[1]
        row = {"case": kind, "shape": {"b": b, "tq": tq, "hkv": hkv, "g": g, "dh": dh,
                                       "block_size": bs, "max_blocks": tables.shape[1],
                                       "n_blocks": kp.shape[0]},
               "route": "paged", "pages": "int8" if sc else "bf16", "bitwise_repeat": True,
               "max_abs_err": err, "tol": tol,
               "valid_len": [int(kvl.min()), int(kvl.max())]}
        if timed:
            live = torch.clamp(kvl.max(dim=1).values, max=cap).sum().item()  # keys read a head
            per_key = hkv * dh * kp.element_size() + (hkv * 4 * -(-dh // 128) if sc else 0)
            nbytes = 2 * live * per_key + 2 * q.numel() * q.element_size()
            ops = 4 * dh * hkv * g * torch.clamp(kvl, max=cap).sum().item()
            b_ms, b_by = bound(nbytes, ops, torch.bfloat16)

            def view(p):
                return p[tables.long()].reshape(b, cap, *p.shape[2:])

            kv = [view(kp), view(vp)]
            if sc:
                kv = [Q.dequantize_flat(kv[0], view(sc["k_scale"]), torch.bfloat16),
                      Q.dequantize_flat(kv[1], view(sc["v_scale"]), torch.bfloat16)]
            ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in kv)
            qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, tq, dh).contiguous()
            mask = (torch.arange(cap, device=dev)[None, None, :] < kvl[:, :, None])[:, None]
            row.update({
                "ms": time_ms(lambda: FA.paged_attention(q, kp, vp, tables, kvl, **sc), flush),
                "host_us": host_us(lambda: FA.paged_attention(q, kp, vp, tables, kvl, **sc)),
                "plain_ms": time_ms(lambda: FA.paged_attention_plain(q, kp, vp, tables, kvl,
                                                                     **sc), flush),
                "bound_ms": b_ms, "bound_by": b_by, "live_keys": live,
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
                "library_excludes": "the gather (and dequantize) of the contiguous view"})
            del ks, vs, qs, kv, mask
        out.append(row)
    return out


def paged_consistency(cfg, model, params, dev, pg: PagedServe = PAGED) -> dict:
    """Within the port on the card, on ``check_rows`` of the trace's
    prompts, each prefilled at its own length: (a) paged == contiguous, bit
    for bit: the pool filled by ``pages_from_contiguous``, ``check_steps``
    decode steps through ``build_paged_step`` and through
    ``build_contiguous_step`` (greedy and sampled rows), tokens and logits;
    (b) int8 pools, fed the same tokens: the decode logits against the bf16
    pools' within ``PAGED_INT8_REL_TOL`` of the largest |logit|, and the
    share of equal tokens; (c) chunk placement: the prompts streamed through
    the chunk-width step from position 0 and from staggered first chunks
    give the same last tokens, logits and pool, bit for bit."""
    import numpy as np

    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import lm
    from repro_torch.runtime import batching as RB
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime.serving import build_serve_steps

    topo, n = MiCSTopology(), pg.check_rows
    cap = pg.max_blocks * pg.block
    prompts = [r.prompt for r in paged_requests(RB, cfg.vocab, pg)[:n]]
    plens = np.array([len(p) for p in prompts])
    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True, kv_block_size=pg.block)
    mcfg8 = dataclasses.replace(mcfg, kv_dtype="int8")
    prefill_fn, _ = build_serve_steps(model, topo, mcfg, cap, device=dev)
    contig = lm.init_caches(model, n, cap, dtype=torch.bfloat16, device=dev)
    tok0 = torch.zeros(n, dtype=torch.long, device=dev)
    for b, p in enumerate(prompts):
        lg, c = prefill_fn(params, {"tokens": torch.tensor([p], device=dev)})
        for name in ("k", "v"):
            contig["layers"][name][:, b] = c["layers"][name][:, 0]
        tok0[b] = torch.argmax(lg[0, -1, :cfg.vocab].float())
        del lg, c
    alloc = PG.PagedKVAllocator(pg.slots * pg.max_blocks + 1, pg.block)
    tables = np.zeros((n, pg.max_blocks), np.int32)
    for b, length in enumerate(plens):
        blocks = alloc.alloc(PG.blocks_for(int(length) + pg.check_steps, pg.block))
        tables[b, :len(blocks)] = blocks
    pools = {}
    for kv in ("bf16", "int8"):
        pools[kv] = PG.init_paged_caches(model, topo, alloc.n_blocks, pg.block, kv, device=dev)
        PG.pages_from_contiguous(model, topo, contig, pools[kv], tables, plens,
                                 block_size=pg.block, kv_dtype=kv)
    steps = {kv: PG.build_paged_step(model, topo, m, max_blocks=pg.max_blocks,
                                     block_size=pg.block, top_k=pg.top_k, device=dev)
             for kv, m in (("bf16", mcfg), ("int8", mcfg8))}
    contig_step = PG.build_contiguous_step(model, topo, mcfg, cap, top_k=pg.top_k, device=dev)
    seeds = torch.arange(n, device=dev) + 1000
    temps = torch.tensor([0.0, pg.temperature] * (n // 2), device=dev)
    ones = torch.ones(n, dtype=torch.long, device=dev)
    pos = torch.as_tensor(plens, device=dev)
    tp, tc = tok0, tok0
    bitwise, err8, scale, same8 = True, 0.0, 0.0, 0
    for s in range(pg.check_steps):
        t1, l1, pools["bf16"] = steps["bf16"](params, pools["bf16"], tp[:, None], pos + s, ones,
                                              tables, seeds, temps)
        t2, l2, contig = contig_step(params, contig, tc[:, None], pos + s, seeds, temps)
        t8, l8, pools["int8"] = steps["int8"](params, pools["int8"], tp[:, None], pos + s,
                                              ones, tables, seeds, temps)
        bitwise &= torch.equal(t1, t2) and torch.equal(l1, l2)
        err8 = max(err8, (l8.float() - l1.float()).abs().max().item())
        scale = max(scale, l1.float().abs().max().item())
        same8 += int((t8 == t1).sum())
        tp, tc = t1, t2
    if not bitwise:
        raise AssertionError("serve_paged: paged decode differs from the contiguous step")
    if not err8 <= PAGED_INT8_REL_TOL * scale:
        raise AssertionError(f"serve_paged: int8 pools' logits {err8} > {PAGED_INT8_REL_TOL} "
                             f"x {scale} from the bf16 pools'")
    del pools, contig

    chunk_step = PG.build_paged_step(model, topo, mcfg, max_blocks=pg.max_blocks,
                                     block_size=pg.block, chunk=pg.chunk, device=dev)

    def stream(first):
        pool = PG.init_paged_caches(model, topo, alloc.n_blocks, pg.block, "bf16", device=dev)
        done, nxt = np.zeros(n, np.int64), np.minimum(plens, first)
        last_t, last_l, ticks = [None] * n, [None] * n, 0
        while (done < plens).any():
            toks = np.zeros((n, pg.chunk), np.int64)
            for b in range(n):
                toks[b, :nxt[b]] = prompts[b][done[b]:done[b] + nxt[b]]
            t, lg, pool = chunk_step(params, pool, toks, done, nxt, tables, seeds.cpu().numpy(),
                                     temps.cpu().numpy())
            for b in range(n):
                if nxt[b] and done[b] + nxt[b] == plens[b]:
                    last_t[b], last_l[b] = t[b].clone(), lg[b].clone()
            done, nxt, ticks = done + nxt, np.minimum(plens - done - nxt, pg.chunk), ticks + 1
        return torch.stack(last_t), torch.stack(last_l), pool, ticks

    ta, la, pa, na = stream(np.full(n, pg.chunk))
    tb, lb, pb, nb_ = stream(1 + (7 * np.arange(n)) % pg.chunk)
    placement = (torch.equal(ta, tb) and torch.equal(la, lb)
                 and all(torch.equal(pa["layers"][k], pb["layers"][k]) for k in pa["layers"]))
    if not placement:
        raise AssertionError("serve_paged: chunk placement changed the prompts' last logits "
                             "or pool")
    return {"paged_vs_contiguous": {"rows": n, "decode_steps": pg.check_steps,
                                    "prompt_lens": plens.tolist(), "tokens_and_logits_bitwise":
                                    True},
            "int8_kv": {"max_abs_err": err8, "max_abs_logit": scale,
                        "rel_tol": PAGED_INT8_REL_TOL, "tokens_equal_share":
                        same8 / (n * pg.check_steps)},
            "chunk_placement": {"first_chunks": [pg.chunk, f"1 + 7 b mod {pg.chunk}"],
                                "engine_steps": [na, nb_], "bitwise": True}}


def serve_paged_phase(cfg, model, params, card, dev, pg: PagedServe = PAGED) -> dict:
    """``serve_paged``: the continuous-batching engine on the card through
    ``runtime/resilient.ResilientServeLoop`` (the launcher's
    ``--continuous`` path), ``pg``'s trace on ``params`` (the ``serve``
    run's), bf16 gather and pools; the checks of :func:`paged_consistency`
    and :func:`paged_kernel_checks`; then the same trace with an engine
    crash at ``crash_at`` (bitwise the fault-free completions) and on int8
    pools.  Every run's launches are held to the engine's: per engine step
    RMSNorm 33, attention 16, all on ``paged`` (``split`` and ``mma`` 0), and
    with int8 pools ``quantize`` 32 (each layer's k and v rows)."""
    import numpy as np

    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.runtime import batching as RB
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "flash_attention": cfg.n_layers}
    sc = ServeLoopConfig(slots_local=pg.slots, nb_local=pg.slots * pg.max_blocks + 1,
                         block_size=pg.block, max_blocks=pg.max_blocks, chunk=pg.chunk,
                         top_k=pg.top_k, reserve="full", seed=0)
    arrivals = [pg.arrival_every * i for i in range(pg.requests)]

    def make_loop(kv: str, fault=None):
        mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True, kv_dtype=kv,
                          kv_block_size=pg.block)
        return ResilientServeLoop(model, MiCSTopology(), mcfg, sc,
                                  params_for=lambda m, t: params, fault_injector=fault,
                                  device=dev)

    def run(loop, label: str, kv: str):
        """One counted run of the trace; its launches held to the engine's."""
        clock = TickClock(loop)
        reqs = paged_requests(RB, cfg.vocab, pg)
        torch.cuda.synchronize()
        reset_counts()
        clock.start = time.perf_counter()
        rep = loop.run(reqs, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - clock.start
        launches, by_route = read_counts(), dict(FA.launches_by_route)
        led, steps = rep["ledger"], len(clock.steps)
        if not (led["accounted"] and led["completed"] == pg.requests and led["shed"] == 0):
            raise AssertionError(f"serve_paged {label}: ledger {led}")
        want = dict.fromkeys(launches, 0) | {
            "rmsnorm": per_step["rmsnorm"] * steps,
            "flash_attention": per_step["flash_attention"] * steps,
            "quantize": 2 * per_step["flash_attention"] * steps if kv == "int8" else 0}
        want_route = {"mma": 0, "split": 0, "fma": 0,
                      "paged": per_step["flash_attention"] * steps}
        if launches != want or by_route != want_route:
            raise AssertionError(f"serve_paged {label}: launches {launches} / {by_route} != "
                                 f"{want} / {want_route} ({steps} engine steps)")
        for toks in rep["completions"].values():
            if len(toks) != pg.new_tokens or min(toks) < 0 or max(toks) >= cfg.vocab:
                raise AssertionError(f"serve_paged {label}: a completion {toks}")
        return rep, reqs, clock, wall, launches, by_route

    # the kernel on the phase's shapes, before the engine runs
    kernel = paged_kernel_checks(torch.Generator(device=dev).manual_seed(3), dev, None,
                                 timed=False, pg=pg)
    consistency = paged_consistency(cfg, model, params, dev, pg)
    torch.cuda.empty_cache()

    loop = make_loop("bf16")
    z, B = np.zeros, loop.batcher.batch
    for _ in range(2):  # warm: first use of the engine's shapes (cuBLAS, allocator)
        loop.step(loop.params, loop.caches, z((B, pg.chunk), np.int64), z(B, np.int64),
                  z(B, np.int64), z((B, pg.max_blocks), np.int32), z(B, np.int64),
                  z(B, np.float32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep, reqs, clock, wall, launches, by_route = run(loop, "bf16", "bf16")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pool_gb = sum(t.numel() * t.element_size() for p in loop.caches.values()
                  for t in p.values()) / 1e9
    tokens = sum(len(t) for t in rep["completions"].values())
    decode_ticks = [t for t, d, _ in clock.steps if d]
    tick_ms = [(clock.ends[t] - clock.tick_start(t)) * 1e3 for t in decode_ticks]
    step_ms = {"decode_only": [ms for _, d, ms in clock.steps if d],
               "with_prefill": [ms for _, d, ms in clock.steps if not d]}
    ttft_ms = [(clock.ends[r.first_token_tick] - clock.tick_start(r.arrival)) * 1e3
               for r in reqs]
    plan = clock.decode_plan
    prof = profile_line(cfg.name, "paged decode tick", lambda: loop.step(
        loop.params, loop.caches, plan.tokens, plan.pos, plan.n_new, plan.tables, plan.seeds,
        plan.temps)[0].cpu())
    del loop
    torch.cuda.empty_cache()

    crash, _, _, cwall, claunches, _ = run(
        make_loop("bf16", FaultPlan.parse(f"crash@{pg.crash_at}")), "crash", "bf16")
    if crash["completions"] != rep["completions"]:
        raise AssertionError("serve_paged: the crash run's completions differ from the "
                             "fault-free run's")
    changes = crash["world_changes"]
    if [c["kind"] for c in changes] != ["crash"] or not changes[0]["replayed"]:
        raise AssertionError(f"serve_paged: crash ledger {changes}")
    torch.cuda.empty_cache()
    int8, _, _, iwall, ilaunches, _ = run(make_loop("int8"), "int8", "int8")
    same = [a == b for rid, toks in rep["completions"].items()
            for a, b in zip(toks, int8["completions"][rid])]
    torch.cuda.empty_cache()

    led = rep["ledger"]
    return {"phase": "serve_paged", "arch": cfg.name, "layers": cfg.n_layers,
            "engine": dataclasses.asdict(pg), "gather_dtype": "bf16", "kv_dtype": "bf16",
            "requests": pg.requests, "ticks": rep["ticks"], "engine_steps": len(clock.steps),
            "decode_only_steps": len(decode_ticks), "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_ticks": {"p50": led["ttft_ticks_p50"], "p99": led["ttft_ticks_p99"]},
            "ttft_ms": {"p50": _pct(ttft_ms, 50), "p99": _pct(ttft_ms, 99)},
            "latency_ticks": {"p50": led["latency_ticks_p50"], "p99": led["latency_ticks_p99"]},
            "decode_ms_per_tick": {"p50": _pct(tick_ms, 50), "p99": _pct(tick_ms, 99)},
            "engine_step_ms_p50": {k: _pct(v, 50) for k, v in step_ms.items()},
            "profile_decode_tick": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_kernels", "events_short",
                "by_kind")},
            "peak_gb": peak_gb, "pool_gb": pool_gb, "ledger": led,
            "launches": launches, "attention_launches_by_route": by_route,
            "checks": {"ledger": f"{pg.requests} of {pg.requests} completed, accounted",
                       **consistency,
                       "crash_replay": {"at_tick": pg.crash_at, "replayed":
                                        changes[0]["replayed"], "ticks": crash["ticks"],
                                        "wall_s": cwall, "completions_bitwise": True,
                                        "launches": claunches},
                       "int8_engine": {"ledger_accounted": True, "ticks": int8["ticks"],
                                       "wall_s": iwall, "tokens_equal_to_bf16_share":
                                       sum(same) / len(same), "launches": ilaunches},
                       "paged_vs_plain": kernel,
                       "launch_counts": f"an engine step: RMSNorm {per_step['rmsnorm']}, "
                                        f"attention {per_step['flash_attention']}, all on "
                                        "paged; int8 pools: quantize twice that"},
            "gpu": card}


def train_rows(path: TrainPath) -> int:
    """Token rows of one micro-step of ``path``."""
    return path.global_batch // path.micro_steps * path.seq


def attention_layers(cfg) -> int:
    """The model's attention sub-layers: every layer of the dense family;
    the ``attn`` entries of griffin's pattern over its super-layers and
    tail (``models/build.py``)."""
    if cfg.family != "griffin":
        return cfg.n_layers
    pattern = cfg.pattern or ("rec", "rec", "attn")
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    return n_super * pattern.count("attn") + pattern[:rem].count("attn")


def train_flops(model, path: TrainPath) -> float:
    """Model flops of one step: 6 N a token, N the parameters of the layer
    pools and the head (the embedding lookup does no product), plus
    attention's 12 dh a (query, key) pair the masks allow (causal, and
    within the window where the model has one) and a head, in each
    attention sub-layer.  Recomputation is not counted."""
    cfg = model.cfg
    n = sum(seg.size * pool.stack for pool in (*model.pools, model.head)
            for seg in pool.layout.segments)
    tokens = path.global_batch * path.seq
    span = cfg.window or path.seq   # keys a query sees at most
    pairs = path.global_batch * sum(min(pos + 1, span) for pos in range(path.seq))
    attn = 12 * cfg.resolved_head_dim * pairs * cfg.n_heads * attention_layers(cfg)
    return 6 * n * tokens + attn, n


def train_phase(path: TrainPath, card: str, dev):
    """``train``: the port's training entry point, ``runtime/train_loop.train``,
    on ``path``'s model at full width and depth for ``path.steps`` steps
    from ``init_state(seed=0)`` and the synthetic stream; the launch
    counters are set to 0 just before and read just after, and must be the
    steps x micro-steps x the path's counts a micro-step."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import LoopConfig, train

    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    mcfg = MiCSConfig(micro_steps=path.micro_steps)  # bf16 wire, prefetch, bucketed, exact
    dc = DataConfig(vocab=cfg.vocab, seq=path.seq, global_batch=path.global_batch,
                    micro_steps=path.micro_steps)
    oc = OptConfig(warmup_steps=0, total_steps=path.steps)
    ckdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    lc = LoopConfig(total_steps=path.steps, checkpoint_every=0, checkpoint_dir=str(ckdir),
                    log_every=0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = train(model, MiCSTopology(), mcfg, oc, dc, lc, device=dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    tables = check_train_launches(f"train {path.arch}", path, path.steps * path.micro_steps)
    launches, by_route, bwd_by_route, rms_bwd_by_route, rglru_by_form = tables
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if len(stats.losses) != path.steps or not all(
            math.isfinite(x) for x in stats.losses + stats.grad_norms):
        raise AssertionError(f"train {path.arch}: losses {stats.losses}, grad norms "
                             f"{stats.grad_norms}")
    ck = Checkpointer(ckdir)
    if ck.latest_step() != path.steps:
        raise AssertionError(f"train {path.arch}: newest checkpoint {ck.latest_step()} != "
                             f"{path.steps}")
    ck_gb = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file()) / 1e9
    shutil.rmtree(ckdir)

    step_ms = statistics.median(stats.step_times[1:]) * 1e3
    flops, n_params = train_flops(model, path)
    tokens = path.global_batch * path.seq
    model_tflops = flops / (step_ms / 1e3) / 1e12
    line = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "global_batch": path.global_batch, "seq": path.seq,
            "micro_steps": path.micro_steps, "tokens_per_step": tokens,
            "gather_dtype": "bf16", "schedule": "prefetch", "boundary": "bucketed",
            "clip": "exact", "loss": stats.losses, "grad_norm": stats.grad_norms,
            "step_ms_all": [t * 1e3 for t in stats.step_times], "step_ms": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3), "model_params": n_params,
            "model_tflops": model_tflops, "mfu": model_tflops / (PEAK_OPS_PER_S[torch.bfloat16] / 1e12),
            "peak_gb": peak_gb, "loop_s": loop_s, "checkpoint_gb": ck_gb,
            "checkpoint_s": stats.save_times[-1], "launches": launches,
            "attention_launches_by_route": by_route,
            "attention_bwd_launches_by_route": bwd_by_route,
            "rmsnorm_bwd_launches_by_route": rms_bwd_by_route,
            "rglru_launches_by_form": rglru_by_form, "gpu": card}
    emit(line)
    return launches, line


def check_train_launches(label: str, path: TrainPath, micro: int):
    """Read the launch counters after ``micro`` micro-steps of ``path`` and
    hold them to the path's counts a micro-step, attention's forward on
    ``mma``, each backward on the path's route and the RG-LRU gated;
    returns ``(launches, attention's by route, its backward's, RMSNorm
    backward's, RG-LRU's by form)``."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN

    launches = read_counts()
    by_route, bwd_by_route = dict(FA.launches_by_route), dict(FA.launches_bwd_by_route)
    rms_bwd_by_route = dict(RN.launches_bwd_by_route)
    rglru_by_form = {"forward": dict(RG.launches_by_form),
                     "backward": dict(RG.launches_bwd_by_form)}
    want = {name: n * micro for name, n in path.launches.items()}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    want_route = {"mma": want["flash_attention"], "split": 0, "fma": 0, "paged": 0}
    if by_route != want_route:
        raise AssertionError(f"{label}: attention routes {by_route} != {want_route}")
    # every backward call on the path's route: llama's wgmma attention and
    # RMSNorm row in registers; recurrentgemma's dh-256 attention on
    # wgmma256 and its 2560-wide RMSNorm rows through shared memory
    want_bwd = dict.fromkeys(FA.BWD_ROUTES, 0) | {path.attn_bwd_route:
                                                  want["flash_attention_bwd"]}
    if bwd_by_route != want_bwd:
        raise AssertionError(f"{label}: attention backward routes {bwd_by_route}")
    want_rms = dict.fromkeys(RN.BWD_ROUTES, 0) | {path.rms_bwd_route: want["rmsnorm_bwd"]}
    if rms_bwd_by_route != want_rms:
        raise AssertionError(f"{label}: RMSNorm backward routes {rms_bwd_by_route}")
    # the model's RG-LRU is the gated form, forward and backward
    want_form = {"forward": {"ab": 0, "gated": want["rglru"]},
                 "backward": {"ab": 0, "gated": want["rglru_bwd"]}}
    if rglru_by_form != want_form:
        raise AssertionError(f"{label}: RG-LRU entry points {rglru_by_form}")
    return launches, by_route, bwd_by_route, rms_bwd_by_route, rglru_by_form


LAUNCH_TABLES = ("launches", "attention_launches_by_route", "attention_bwd_launches_by_route",
                 "rmsnorm_bwd_launches_by_route", "rglru_launches_by_form")


def add_counts(total: dict, table: dict) -> dict:
    """``table``'s counts (nested dicts of ints) added into ``total``."""
    for k, n in table.items():
        if isinstance(n, dict):
            add_counts(total.setdefault(k, {}), n)
        else:
            total[k] = total.get(k, 0) + n
    return total


# -- the one-card training knobs (train_knobs) ----------------------------------

# Each variant is one knob on the griffin train path's configuration, run 2
# steps from init_state(seed=0) and held to that path's steps 1-2:
# ``bitwise`` both steps' loss and grad norm; ``approx`` (the clip binds at
# both steps: grad norms ~30 and ~22 against clip_norm 1.0) step 1 bitwise
# and step 2's loss within the reference's approximate-clip bound.
KNOBS_ARCH = "recurrentgemma-2b"
KNOB_STEPS = 2
KNOB_VARIANTS = (("remat", {"prefetch_carry": "remat"}, "bitwise"),
                 ("carry_host", {"carry_offload": "host"}, "bitwise"),
                 ("offload_opt", {"offload_opt": True}, "bitwise"),
                 ("approx", {"clip_mode": "approx"}, "approx"))
# Variants whose next step is also profiled (device busy and idle share, time
# by kind), to tell the card's time from the host's: the approximate clip
# updates some 400 buckets of 8.4 M elements where the exact clip updates
# some 55 slices of up to 2^26.
KNOB_PROFILED = ("approx",)


def host_mem_total_gb() -> float:
    """The host's MemTotal (/proc/meminfo), GB."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemTotal in /proc/meminfo")


def train_knobs_phase(path: TrainPath, card: str, dev, train_line: dict) -> dict:
    """``train_knobs``: each of the four one-card knobs on ``path``'s model
    at full width and depth, its data, seed, OptConfig and micro-steps,
    ``KNOB_STEPS`` steps through ``build_train_step`` from
    ``init_state(seed=0)`` (no checkpoint), one variant at a time, its state
    freed before the next; held to the ``train`` phase's steps (``train_line``)
    and to the path's launch counts.  Per variant: ``peak_gb`` (reset before
    its ``init_state``), the pinned host GB held, step 2's ``step_ms`` and
    the GB it copied down and up, its seconds; for ``KNOB_PROFILED``, a
    profile of two more steps' second."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import hostoffload
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.core.schedule import APPROX_CLIP_LOSS_RTOL
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    oc = OptConfig(warmup_steps=0, total_steps=path.steps)        # the train phase's
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq, global_batch=path.global_batch,
                                    micro_steps=path.micro_steps))
    want = list(zip(train_line["loss"], train_line["grad_norm"]))[:KNOB_STEPS]
    pool_bytes = {k: s * t * f * 4 for k, (s, t, f) in model.global_flat_shapes().items()}
    variants, totals = {}, {}
    for name, kw, held_to in KNOB_VARIANTS:
        t0 = time.perf_counter()
        mcfg = MiCSConfig(micro_steps=path.micro_steps, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(model, 0, device=dev, offload_opt=mcfg.offload_opt)
        step = build_train_step(model, MiCSTopology(), mcfg, oc, device=dev)
        stash = step.comm.host_stash
        reset_counts()
        got, step_ms, moved = [], [], []
        for cursor in range(KNOB_STEPS):
            before = stash.snapshot()
            t1 = time.perf_counter()
            state, metrics = step(state, source.host_step_batch(cursor, 0, 1))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            got.append((metrics["loss"].item(), metrics["grad_norm"].item()))
            after = stash.snapshot()
            moved.append({"down_gb": (after["bytes_down"] - before["bytes_down"]) / 1e9,
                          "up_gb": (after["bytes_up"] - before["bytes_up"]) / 1e9})
            if after["live_slots"]:
                raise AssertionError(f"train_knobs {name}: {after['live_slots']} carry slots "
                                     f"held after step {cursor + 1}")
        tables = check_train_launches(f"train_knobs {name}", path,
                                      KNOB_STEPS * path.micro_steps)
        add_counts(totals, dict(zip(LAUNCH_TABLES, tables)))
        line = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "pinned_gb": hostoffload.pinned_bytes() / 1e9,
                "carry_slot_gb": stash.slot_bytes() / 1e9,
                "step_ms": step_ms[-1], "step_ms_all": step_ms,
                "copied_gb_step": moved[-1], "loss": [g[0] for g in got],
                "grad_norm": [g[1] for g in got], "launches": tables[0]}
        if held_to == "bitwise":
            if got != want:
                raise AssertionError(f"train_knobs {name}: {got} != the train phase's {want}")
        else:
            rel = abs(got[1][0] - want[1][0]) / abs(want[1][0])
            if got[0] != want[0] or not rel <= APPROX_CLIP_LOSS_RTOL:
                raise AssertionError(f"train_knobs {name}: {got} against the train phase's "
                                     f"{want} (step 2 loss within {APPROX_CLIP_LOSS_RTOL})")
            line["step2_loss_rel"] = rel
        if name in KNOB_PROFILED:
            holder, batch = [state], source.host_step_batch(KNOB_STEPS, 0, 1)

            def run():
                holder[0], _ = step(holder[0], batch)

            prof = profile_line(cfg.name, f"train {name}", run, top=10, activities=CARD_ONLY)
            line["profile"] = {k: prof[k] for k in ("events_short", "wall_ms", "device_busy_ms",
                                                    "idle_share", "device_kernels", "by_kind")}
            state = holder[0]
            del holder, run
        if mcfg.offload_opt:
            placed = {f"{part}.{k}": hostoffload.is_host_resident(t, dev)
                      for part in ("m", "v") for k, t in state[part].items()}
            if not all(placed.values()):
                raise AssertionError(f"train_knobs {name}: moments not in pinned host memory: "
                                     f"{placed}")
            # the card holds the params and nothing the size of a pool's moment
            extra = torch.cuda.memory_allocated() - sum(pool_bytes.values())
            line["device_beyond_params_gb"] = extra / 1e9
            if extra >= min(b for b in pool_bytes.values() if b):
                raise AssertionError(f"train_knobs {name}: {extra / 1e9} GB on the card beyond "
                                     "the params")
        del state, step, stash, metrics
        gc.collect()
        torch.cuda.empty_cache()
        if hostoffload.pinned_bytes():
            raise AssertionError(f"train_knobs {name}: {hostoffload.pinned_bytes()} bytes "
                                 "still pinned after the variant's state was freed")
        line["seconds"] = time.perf_counter() - t0
        variants[name] = line
    out = {"phase": "train_knobs", "arch": cfg.name, "layers": cfg.n_layers,
           "global_batch": path.global_batch, "seq": path.seq, "micro_steps": path.micro_steps,
           "steps": KNOB_STEPS, "train_phase": {"loss": [w[0] for w in want],
                                                "grad_norm": [w[1] for w in want],
                                                "peak_gb": train_line["peak_gb"],
                                                "step_ms": train_line["step_ms"]},
           "variants": variants, "approx_loss_rtol": APPROX_CLIP_LOSS_RTOL,
           "host_mem_total_gb": host_mem_total_gb(), **totals, "gpu": card}
    emit(out)
    return out


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |b|), in fp32 on the CPU."""
    a, b = a.float().cpu(), b.float().cpu()
    return (a - b).abs().max().item(), b.abs().max().item()


def train_consistency_phase(path: TrainPath, dev):
    """``train_consistency``: ``path``'s weights at its cut depth (full
    width), one micro-step of 1 x ``cut_tokens`` tokens.  Card against CPU: loss,
    grad_norm, every pool's gradient and the params after one AdamW step.
    Bitwise on the card: serial == prefetch (loss and gradients), serial ==
    bucketed boundary (params, m, v, grad_norm), and a step run twice."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, build_train_step, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import layers as L
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    topo = MiCSTopology()
    model = build_model(get_config(path.arch), tp=1)
    model2, params = cut_params(model, init_params(model, seed=0, device=dev), path.cut_layers)
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (1, 1, path.cut_tokens)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, shape, generator=gen, device=dev),
             "targets": torch.randint(0, model.cfg.vocab, shape, generator=gen, device=dev),
             "mask": torch.ones(shape, device=dev)}
    ctx = L.Ctx(mode="train", compute_dtype=torch.bfloat16)

    def grads(prefetch: bool, on):
        comm = CommEngine.from_config(topo, MiCSConfig(prefetch=prefetch))
        p = {k: v.to(on) for k, v in params.items()}
        return accumulate_grads(model2, comm, ctx, p, {k: v.to(on) for k, v in batch.items()})

    g_pre, loss_pre, _ = grads(True, dev)
    g_ser, loss_ser, _ = grads(False, dev)
    if not (torch.equal(loss_pre, loss_ser) and all(torch.equal(g_pre[k], g_ser[k]) for k in g_pre)):
        raise AssertionError("train_consistency: serial != prefetch on the card")
    g_cpu, loss_cpu, _ = grads(True, "cpu")
    grad_err = {}
    for k in g_pre:
        err, scale = _rel_err(g_pre[k], g_cpu[k])
        grad_err[k] = {"max_abs_err": err, "max_abs_grad": scale}
        if not err <= REL_TOL_GRAD_CARD_VS_CPU * scale:
            raise AssertionError(f"train_consistency: pool {k} gradient card vs CPU {err} > "
                                 f"{REL_TOL_GRAD_CARD_VS_CPU} x {scale}")
    loss_err = abs(loss_pre.item() - loss_cpu.item())
    if not loss_err <= REL_TOL_GRAD_CARD_VS_CPU * abs(loss_cpu.item()):
        raise AssertionError(f"train_consistency: loss {loss_pre.item()} vs {loss_cpu.item()}")
    del g_pre, g_ser, g_cpu

    oc = OptConfig(warmup_steps=0)

    def one_step(boundary: str, on):
        mc = MiCSConfig(micro_steps=1, boundary_schedule=boundary)
        p = {k: v.to(on, copy=True) for k, v in params.items()}
        state = {"params": p, "m": {k: torch.zeros_like(v) for k, v in p.items()},
                 "v": {k: torch.zeros_like(v) for k, v in p.items()}, "step": 0}
        return build_train_step(model2, topo, mc, oc, device=on)(state, batch)

    def same(a, b):
        return torch.equal(a[1]["grad_norm"], b[1]["grad_norm"]) and all(
            torch.equal(a[0][part][k], b[0][part][k]) for part in ("params", "m", "v")
            for k in a[0][part])

    bucketed = one_step("bucketed", dev)
    if not same(bucketed, one_step("serial", dev)):
        raise AssertionError("train_consistency: serial != bucketed boundary on the card")
    if not same(bucketed, one_step("bucketed", dev)):
        raise AssertionError("train_consistency: a step run twice differs on the card")
    cpu = one_step("bucketed", "cpu")
    gn_card, gn_cpu = bucketed[1]["grad_norm"].item(), cpu[1]["grad_norm"].item()
    if not abs(gn_card - gn_cpu) <= REL_TOL_GRAD_CARD_VS_CPU * gn_cpu:
        raise AssertionError(f"train_consistency: grad_norm {gn_card} vs {gn_cpu} on the CPU")
    param_err = {}
    for k in params:
        err, _ = _rel_err(bucketed[0]["params"][k], cpu[0]["params"][k])
        param_err[k] = err
        if not err <= ADAMW_STEP_TOL_LR * oc.lr_max:
            raise AssertionError(f"train_consistency: pool {k} params after one step card vs "
                                 f"CPU {err} > {ADAMW_STEP_TOL_LR} lr")
    emit({"phase": "train_consistency", "arch": model.cfg.name, "layers": path.cut_layers,
          "tokens": path.cut_tokens, "pools": model2.global_flat_shapes(),
          "serial_eq_prefetch": True, "serial_eq_bucketed": True, "repeat_bitwise": True,
          "card_vs_cpu": {"loss": [loss_pre.item(), loss_cpu.item()],
                          "grad_norm": [gn_card, gn_cpu], "grads": grad_err,
                          "rel_tol": REL_TOL_GRAD_CARD_VS_CPU,
                          "params_after_step_max_abs_err": param_err,
                          "params_tol": ADAMW_STEP_TOL_LR * oc.lr_max}})


def train_profile(path: TrainPath, dev, timed_steps: int = 3):
    """``profile`` of one train step at ``path``'s configuration (after one
    unprofiled step): device busy, idle share, top kernels, and the
    host-clock time of ``timed_steps`` unprofiled steps before it
    (``step_ms``), since the profiler's own host work can idle the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    state = init_state(model, 0, device=dev)
    step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=path.micro_steps),
                            OptConfig(warmup_steps=0), device=dev)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq, global_batch=path.global_batch,
                                   micro_steps=path.micro_steps)).global_step_batch(0)
    holder = [state]

    def run():
        holder[0], metrics = step(holder[0], batch)
        return metrics

    run()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(timed_steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    line = profile_run(cfg.name, "train", run, top=25, step_ms=step_ms)
    del holder, state
    torch.cuda.empty_cache()
    return line


# -- the multi-rank MiCS step ------------------------------------------------

DIST_WORLD = 4
DIST_TIMEOUT_S = 600          # every process group's: a collective waiting this long fails
# The workers' whole run (dist_train, dist_wires, dist_elastic) may take
# what the script's limit leaves once the phases after it (digest, kernels:
# ≈ 45 s) have their share: its gloo steps follow the host's speed, and a
# deadline of its own would fail a slow host that still ends in time.
SCRIPT_LIMIT_S = 1200
AFTER_DIST_S = 120


@dataclasses.dataclass(frozen=True)
class DistLayout:
    name: str
    arch: str
    repl: int
    shard: int
    tp: int
    gather_order: str
    inner: int | None
    layers: int | None       # None: full depth; else cut to this many layers
    steps: int = 3


# Layout A: one partition group of 4, the paper's three-stage gather
# (outer_first, inner 2); layout B: 2 partition groups of 2 (the staged
# gather degenerates to one flat gather at p = 2) x 2 replicas, so hop 2
# and the bucketed boundary run across replicas.  Layout C: llama at full
# depth over p 2 x tp 2 (the flat gather at p 2 under tensor parallelism:
# GQA at kv_gather 1, the vocab-parallel loss over 128,256 columns).
# Layout D: recurrentgemma-2b cut to one (rec, rec, attn) super-layer over
# tp 4 (10 Q heads padded to 12, its one KV head gathered over the 4 model
# ranks, LRU width 640 and d_ff 1920 a rank, the norm scales gathered).
# C and D start from their model's ``init_params(seed=0)`` at tp 1 cut by
# ``convert.tp_params_from_full``, written as the loop's step-0 checkpoint.
# C runs 2 steps, the others 3: on one card the 4 ranks' gloo collectives
# took the whole script past its time budget with 3 (PERF.md, PR 20).
DIST_LAYOUTS = (DistLayout("A", "llama3.2-1b", 1, 4, 1, "outer_first", 2, None),
                DistLayout("B", "llama3.2-1b", 2, 2, 1, "inner_first", None, 4),
                DistLayout("C", "llama3.2-1b", 1, 2, 2, "inner_first", None, None, steps=2),
                DistLayout("D", "recurrentgemma-2b", 1, 1, 4, "inner_first", None, 3))
# Layouts A and C against the single-card ``train`` phase (the same
# weights, data and global batch): step 1's loss and grad_norm (both sides
# round to bf16, hop 1 and the model-axis psums sum in bf16 over the ranks),
# then steps 2-3 at the reference's ``mics_fidelity`` rtol.  Layouts B and D
# against a one-card run of their cut model on the same weights.
DIST_REL_TOL = {"loss1": 2e-3, "grad_norm1": 2e-2, "later": 2e-2}


def train_launches(cfg) -> dict:
    """Kernel launches a micro-step of a model of ``cfg.n_layers``
    sub-layers: RMSNorm 2 a sub-layer + the final norm forward, the
    sub-layers' recomputed, and one backward each; attention and the
    RG-LRU one a sub-layer of their kind, recomputed, one backward."""
    n, n_attn = cfg.n_layers, attention_layers(cfg)
    return {"rmsnorm": 4 * n + 1, "rmsnorm_bwd": 2 * n + 1,
            "flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "rglru": 2 * (n - n_attn), "rglru_bwd": n - n_attn, "quantize": 0, "dequantize": 0}


def dist_model(layout: DistLayout, tp: int | None = None):
    """``layout``'s model, built for its tp (or ``tp``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.build import build_model

    cfg = get_config(layout.arch)
    if layout.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layout.layers)
    return build_model(cfg, tp=layout.tp if tp is None else tp)


def dist_train_path(layout: DistLayout) -> TrainPath:
    """The one-card train path of ``layout``'s model (its data and routes)."""
    return next(tp for tp in TRAIN if tp.arch == layout.arch)


def dist_topology(layout: DistLayout):
    from repro_torch.core.topology import MiCSTopology

    return MiCSTopology(repl=layout.repl, shard=layout.shard, model=layout.tp)


def dist_expected_calls(layout: DistLayout) -> dict:
    """The CommEngine's calls a rank over the run.  The partition group (p
    > 1): each pool row's gather (prefetch: once a micro-step, no re-gather
    in the backward) and its adjoint reduce-scatter, once a stage; one hop-2
    all-reduce a bucket of the plan a step (none with one replica); the
    norm's all-reduce over the partition group and the loss means' over the
    data ranks (more than one), once a step.  The model axis (tp > 1), a
    micro-step: each model-sharded segment of a layer row gathered twice
    (the forward and the checkpointed recompute) and reduce-scattered once
    (``model`` over the whole model group, ``kv`` over a run of KV ranks);
    each row-parallel psum (after ``wo``, ``rec.wo``, ``wd``) in the
    forward, the recompute and the backward, except the row's last, which
    the recompute stops before (non-reentrant checkpointing recomputes up to
    the last tensor the backward saved); the embedding's and the final norm
    scale's gather and reduce-scatter; the loss's pmax, its two psums and
    the backward's one; and a step's norm psum over the model group."""
    from repro_torch.core.schedule import plan_boundary
    from repro_torch.core.topology import hierarchy_factors

    model, topo = dist_model(layout), dist_topology(layout)
    steps = layout.steps
    micro = steps * dist_train_path(layout).micro_steps
    calls = {}

    def add(key, n):
        calls[key] = calls.get(key, 0) + n

    if topo.partition_size > 1:
        rows = sum(pool.stack for pool in model.all_pools())
        outer, inner = hierarchy_factors(topo, layout.inner)
        stages = ("outer", "inner") if outer > 1 and inner > 1 else ("partition",)
        for stage in stages:
            add(f"all_gather:{stage}", rows * micro)
            add(f"reduce_scatter:{stage}", rows * micro)
        add("all_reduce:partition", steps)
    if topo.replication_degree > 1:
        plan = plan_boundary(model, topo, mode="bucketed", bucket_mb=32.0)
        add("all_reduce:replication", plan.n_buckets * steps)
    if topo.data_parallel_size > 1:
        add("all_reduce:data", steps)
    tp = topo.model_size
    if tp > 1:
        for pool in model.pools:
            for seg in pool.layout.segments:
                if seg.model_gather > 1:
                    label = "model" if seg.model_gather == tp else "kv"
                    add(f"all_gather:{label}", 2 * pool.stack * micro)
                    add(f"reduce_scatter:{label}", pool.stack * micro)
            psums = sum(seg.name.endswith(("attn.wo", "rec.wo", "mlp.wd"))
                        for seg in pool.layout.segments)
            add("all_reduce:model", (3 * psums - 1) * pool.stack * micro)
        add("all_gather:model", 2 * micro)       # the embedding, the final norm scale
        add("reduce_scatter:model", 2 * micro)
        add("all_reduce_max:model", micro)
        add("all_reduce:model", 3 * micro + steps)
    return dict(sorted(calls.items()))


# -- the int8 and bf16 wires over the same 4 ranks (dist_wires) -----------------


@dataclasses.dataclass(frozen=True)
class WireRun:
    name: str
    base: str                # the DIST_LAYOUTS layout whose topology and groups it uses
    knobs: dict              # MiCSConfig's wire settings


# llama3.2-1b at full width cut to 4 layers (as layout B), dist_train's data,
# seed and OptConfig, 2 steps, stochastic rounding.  A-q: p 4 outer_first
# inner 2 with the int8 gather (qwZ) and the int8 hop 1 (qgZ); B-q: p 2 x 2
# replicas with the bf16 hop 1 and the int8 hop 2 over the bucketed boundary.
WIRE_LAYERS = 4
WIRE_STEPS = 2
WIRE_REFERENCE = "B"     # the layout whose dist_reference is the same 4-layer model's
WIRE_REF_M = "wire_reference_m.pt"   # its first moment after WIRE_STEPS, in the phase's dir
DIST_WIRES = (WireRun("A-q", "A", {"quant_gather": True, "hop1_wire_dtype": "int8"}),
              WireRun("B-q", "B", {"hop1_wire_dtype": "bf16", "compress_hop2": "int8"}))
# Against the one-card fp32-wire run of the same 4-layer model (layout B's
# dist_reference): the loss at the reference's ``int8_hop1_convergence``
# bound, the grad norm at twice it; and each at a tight bound, about ten
# times the errors first read on the card (A-q 2.7e-5 / 5.4e-4, B-q 1.0e-6
# / 1.7e-4; PERF.md).  The int8 legs' counted bytes, values and scales
# together, against a bf16 wire's for the same payloads: 1 + 4/128 B
# against 2 B a value, so at most 0.55.
WIRE_REL_TOL = {"loss": 0.05, "grad_norm": 0.1}
WIRE_TIGHT_TOL = {"loss": 1e-3, "grad_norm": 5e-3}
WIRE_BYTES_MAX = 0.55
# The norms cannot see a gradient chunk that reaches the wrong owner (the
# norm over the partition is the same), so each rank's AdamW first moment
# after the run, a linear function of its gradient chunks, is held to the
# reference's at the rank's partition coordinate: each pool's relative L2
# error at most WIRE_MOMENT_REL_TOL.  The int8 weights of the qwZ gather
# move A-q's gradients by about 5% and stochastic int8 rounding adds at
# most half a step in rms, absmax / 254 of a block of 128; a chunk of
# another owner is uncorrelated and errs by >= 1, which the same error
# against the next coordinate's chunk shows (the control, at least
# WIRE_MOMENT_CONTROL_MIN).
WIRE_MOMENT_REL_TOL = 0.1
WIRE_MOMENT_CONTROL_MIN = 0.5


def wire_layout(wr: WireRun) -> DistLayout:
    base = next(lay for lay in DIST_LAYOUTS if lay.name == wr.base)
    return dataclasses.replace(base, name=wr.name, layers=WIRE_LAYERS, steps=WIRE_STEPS)


def _wire_stages(layout: DistLayout) -> tuple[str, ...]:
    from repro_torch.core.topology import hierarchy_factors

    outer, inner = hierarchy_factors(dist_topology(layout), layout.inner)
    return ("outer", "inner") if outer > 1 and inner > 1 else ("partition",)


def _wire_payloads(layout: DistLayout) -> list[int]:
    """Elements of each hop-2 payload a step: the bucketed plan's buckets."""
    from repro_torch.core.schedule import plan_boundary

    plan = plan_boundary(dist_model(layout), dist_topology(layout), mode="bucketed",
                         bucket_mb=32.0)
    return [b.elems for b in plan.buckets]


def dist_wire_expected(wr: WireRun) -> tuple[dict, dict, dict, int]:
    """A rank's ``(collective calls, kernel launches, quantize launches by
    rounding, bf16 bytes of the same payloads)`` over a wire run.  Each
    pool row a micro-step: the gather once a stage, twice under the int8
    gather (values and scales: one quantize, one dequantize); hop 1 once a
    stage, under the int8 wire two ``all_to_all`` (each stage a stochastic
    quantize and a chunk-summing dequantize).  Each hop-2 payload (a
    bucket) a step: one ``all_reduce``, under the int8 wire two
    ``all_to_all`` and two ``all_gather`` (two stochastic quantizes, two
    dequantizes).  The norm and the loss means once a step.  The bf16 bytes
    are what a bf16 wire carries on the int8 legs: the gather's outputs and
    hop 1's stage inputs, and hop 2's two legs over the padded payload."""
    layout = wire_layout(wr)
    model, topo = dist_model(layout), dist_topology(layout)
    micro = WIRE_STEPS * dist_train_path(layout).micro_steps
    rows = sum(pool.stack for pool in model.all_pools()) * micro
    flat = sum(pool.stack * pool.layout.flat_len for pool in model.all_pools()) * micro
    int8_gather = wr.knobs.get("quant_gather", False)
    int8_hop1 = wr.knobs.get("hop1_wire_dtype") == "int8"
    stages = _wire_stages(layout)
    calls, quant = {}, {"nearest": 0, "stochastic": 0}
    bf16_bytes = 0
    for i, st in enumerate(stages):
        calls[f"all_gather:{st}"] = (2 if int8_gather else 1) * rows
        if int8_hop1:
            calls[f"all_to_all:{st}"] = 2 * rows
        else:
            calls[f"reduce_scatter:{st}"] = rows
        # a stage's gathered values (the adjoint's stage input: the same)
        values = flat * (i + 1) // len(stages) if len(stages) > 1 else flat
        bf16_bytes += 2 * values * (int(int8_gather) + int(int8_hop1))
    quant["nearest"] = rows if int8_gather else 0
    quant["stochastic"] = len(stages) * rows if int8_hop1 else 0
    deq = (rows if int8_gather else 0) + (len(stages) * rows if int8_hop1 else 0)
    calls["all_reduce:partition"] = WIRE_STEPS
    calls["all_reduce:data"] = WIRE_STEPS
    r = topo.replication_degree
    if r > 1:
        payloads = _wire_payloads(layout)
        if wr.knobs.get("compress_hop2") == "int8":
            n = len(payloads) * WIRE_STEPS
            calls["all_to_all:replication"] = calls["all_gather:replication"] = 2 * n
            quant["stochastic"] += 2 * n
            deq += 2 * n
            bf16_bytes += WIRE_STEPS * sum(2 * 2 * r * -(-e // r) for e in payloads)
        else:
            calls["all_reduce:replication"] = len(payloads) * WIRE_STEPS
    launches = {k: n * micro for k, n in train_launches(model.cfg).items()}
    launches["quantize"] = quant["nearest"] + quant["stochastic"]
    launches["dequantize"] = deq
    return dict(sorted(calls.items())), launches, quant, bf16_bytes


def moment_errors(m: dict, ref_path: pathlib.Path, topo, rank: int) -> tuple[dict, dict]:
    """Each pool's relative L2 error of this rank's first-moment chunk
    against the reference's (``ref_path``: its global ``[stack, 1, flat]``
    pools, saved on the host) at the rank's partition coordinate, and the
    control: against the next coordinate's chunk."""
    ref = torch.load(ref_path, mmap=True)
    p, c = topo.partition_size, topo.partition_coord(rank)

    def rel(t, full, k):
        n = full.shape[-1] // p
        want = full[:, :, k * n:(k + 1) * n].to(t.device)
        return float((t - want).norm() / want.norm())

    return ({name: rel(t, ref[name], c) for name, t in m.items()},
            {name: rel(t, ref[name], (c + 1) % p) for name, t in m.items()})


def dist_wire_run(wr: WireRun, groups, rank: int, dev, ref_m: pathlib.Path) -> dict:
    """One rank of one wire run: ``build_train_step`` from ``init_state(seed=0)``
    on dist_train's synthetic data, ``WIRE_STEPS`` steps, over ``groups``
    (its base layout's, already built); its first moment against
    ``ref_m`` (:func:`moment_errors`)."""
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.quant import kernel as QK
    from repro_torch.optim.adamw import OptConfig

    layout = wire_layout(wr)
    path = dist_train_path(layout)
    model, topo = dist_model(layout), dist_topology(layout)
    mcfg = MiCSConfig(micro_steps=path.micro_steps, gather_order=layout.gather_order,
                      hierarchy_inner=layout.inner, **wr.knobs)
    step = build_train_step(model, topo, mcfg, OptConfig(warmup_steps=0, total_steps=path.steps),
                            device=dev, groups=groups)
    source = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq=path.seq,
                                    global_batch=path.global_batch,
                                    micro_steps=path.micro_steps))
    state = init_state(model, 0, device=dev, topo=topo, rank=rank)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step.comm.counter.reset()
    losses, gnorms, times = [], [], []
    for i in range(WIRE_STEPS):
        batch = source.host_step_batch(i, topo.data_rank(rank), topo.data_parallel_size)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    out = {"losses": losses, "grad_norms": gnorms, "step_ms_all": [t * 1e3 for t in times],
           "step_ms": times[-1] * 1e3, "comm": step.comm.counter.snapshot(),
           "launches": read_counts(), "quantize_by_mode": dict(QK.launches_quantize_by_mode),
           **route_tables(), "wires": step.describe()["wires"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["moment_rel"], out["moment_control"] = moment_errors(state["m"], ref_m, topo, rank)
    del state, step
    torch.cuda.empty_cache()
    return out


# -- the elastic loop over the same 4 ranks (dist_elastic) -----------------------

# llama3.2-1b at full width cut to 2 layers, dist_train's seed and
# OptConfig, one micro-step of 4 x 2048 tokens a step (half of dist_train's
# 2: with 2 the phase took 114-125 s of its 120 s budget on the H100),
# bf16 gather, starting at layout B (p 2 x 2 replicas), an async checkpoint
# every 2 steps, 5 steps.  The plan: steps 0-2 on 4 ranks; at 3 ranks 2-3
# are lost abruptly (the run rolls back to the step-2 checkpoint); steps
# 2-3 on ranks 0-1 (the keep rule: p 2, one replica); at 4 they come back
# with notice (an emergency save at 4); step 4 on 4 ranks.
ELASTIC_LAYERS = 2
ELASTIC_STEPS = 5
ELASTIC_EVERY = 2
ELASTIC_MICRO_STEPS = 1
ELASTIC_GLOBAL_BATCH = 4
ELASTIC_PLAN = (("preempt", 3, {"devices": 2, "notice": False}), ("grow", 4, {"devices": 2}))
ELASTIC_LEDGER = [
    {"at_step": 3, "kind": "preempt", "lost": 2, "gained": 0, "notice": False, "world": 2,
     "resumed_step": 2, "rule": "keep", "carry": "stored", "partition_size": 2,
     "data_extent": 2, "tp": 1, "n_devices": 2},
    {"at_step": 4, "kind": "grow", "lost": 0, "gained": 2, "notice": True, "world": 4,
     "resumed_step": 4, "rule": "keep", "carry": "stored", "partition_size": 2,
     "data_extent": 4, "tp": 1, "n_devices": 4}]
# the batches each rank fetched (the one fetched when a fault fires is
# fetched again, none is skipped) and the steps it ran
ELASTIC_CURSORS = [[0, 1, 2, 3, 2, 3, 4, 4]] * 2 + [[0, 1, 2, 3, 4]] * 2
ELASTIC_STEPS_RUN = [6, 6, 4, 4]


def elastic_model():
    from repro_torch.configs import get_config
    from repro_torch.models.build import build_model

    return build_model(dataclasses.replace(get_config("llama3.2-1b"),
                                           n_layers=ELASTIC_LAYERS), tp=1)


def world_losses(losses: list, ledger: list, rank: int) -> list[list]:
    """``rank``'s losses of each world after a change (the steps from its
    ``resumed_step`` to the next change or the end), [] where the rank was
    parked: they are the last of its losses, in order."""
    ends = [e["at_step"] for e in ledger[1:]] + [ELASTIC_STEPS]
    out, i = [], len(losses)
    for e, end in reversed(list(zip(ledger, ends))):
        n = end - e["resumed_step"] if rank < e["world"] else 0
        out.append(losses[i - n:i])
        i -= n
    return out[::-1]


def dist_elastic_run(rank: int, dev, out_dir: pathlib.Path, backend: str, timeout) -> dict:
    """One rank of ``dist_elastic``: ``runtime/train_loop.train`` with the
    ``ELASTIC_PLAN`` fault plan and ``ElasticConfig()`` over the launch
    world's 4 ranks; the launch counters set to 0 just before and read
    just after.  Then each world after a change again, cold: the same
    ``resize_for_world``, ``elastic_restart`` of the checkpoint it resumed
    from and its steps, against the loop's losses and the state it
    checkpointed at the world's end, bitwise."""
    import json
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import MANIFEST, Checkpointer
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import train_loop as TL

    layout = next(lay for lay in DIST_LAYOUTS if lay.name == "B")
    path, model, topo = dist_train_path(layout), elastic_model(), dist_topology(layout)
    mcfg = MiCSConfig(micro_steps=ELASTIC_MICRO_STEPS)   # bf16, prefetch, bucketed, exact
    oc = OptConfig(warmup_steps=0, total_steps=path.steps)
    dc = DataConfig(vocab=model.cfg.vocab, seq=path.seq, global_batch=ELASTIC_GLOBAL_BATCH,
                    micro_steps=ELASTIC_MICRO_STEPS)
    ckdir = out_dir / "ck_elastic"
    lc = TL.LoopConfig(total_steps=ELASTIC_STEPS, checkpoint_every=ELASTIC_EVERY,
                       checkpoint_dir=str(ckdir), log_every=0, seed=0)
    plan = FaultPlan()
    for kind, at, kw in ELASTIC_PLAN:
        getattr(plan, kind)(at, **kw)
    fetched = []

    class RecordingLM(SyntheticLM):
        def host_step_batch(self, step, host_index, host_count):
            fetched.append(int(step))
            return super().host_step_batch(step, host_index, host_count)

    groups = MiCSGroups(topo, rank, backend=backend, timeout=timeout)
    TL.SyntheticLM = RecordingLM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        stats = TL.train(model, topo, mcfg, oc, dc, lc, device=dev, groups=groups,
                         fault_injector=plan, elastic=TL.ElasticConfig())
    finally:
        TL.SyntheticLM = SyntheticLM
    torch.cuda.synchronize()
    out = {"loop_s": time.perf_counter() - t0, "launches": read_counts(), **route_tables(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": stats.losses,
           "grad_norms": stats.grad_norms, "cursors": fetched,
           "step_ms_all": [t * 1e3 for t in stats.step_times], "restarts": stats.restarts,
           "emergency_saves": stats.emergency_saves, "save_failures": stats.save_failures,
           "ledger": stats.world_changes, "saves": stats.saves, "cold": []}
    if rank == 0:
        out["checkpoint_gb"] = sum(f.stat().st_size for f in (
            ckdir / f"step_{ELASTIC_STEPS:08d}").iterdir()) / 1e9
    in_loop = world_losses(stats.losses, stats.world_changes, rank)
    p_prev = topo.partition_size
    torch.cuda.reset_peak_memory_stats()
    for entry, losses in zip(stats.world_changes, in_loop):
        t0 = time.perf_counter()
        topo_n, _ = TL.resize_for_world(mcfg, entry["world"], tp=1, partition_size=p_prev,
                                        available=DIST_WORLD)
        p_prev = topo_n.partition_size
        g = MiCSGroups(topo_n, rank, backend=backend, timeout=timeout)
        cold = {"world": entry["world"], "from_step": entry["resumed_step"], "losses": []}
        if not g.parked:
            _, state, step_fn, meta = TL.elastic_restart(
                str(ckdir), model.cfg, topo_n, mcfg, oc, entry["resumed_step"], device=dev,
                groups=g)
            src = SyntheticLM(dc)
            for c in range(meta["data_cursor"], meta["data_cursor"] + len(losses)):
                state, m = step_fn(state, src.host_step_batch(c, topo_n.data_rank(rank),
                                                              topo_n.data_parallel_size))
                cold["losses"].append(m["loss"].item())
            end = entry["resumed_step"] + len(losses)
            saved = json.loads((ckdir / f"step_{end:08d}" / MANIFEST).read_text())
            kept, _ = Checkpointer(ckdir).restore(model, end, topo=topo_n, rank=rank, device=dev)
            cold.update(end_step=end, end_saved_by_world=saved["world_size"],
                        losses_bitwise=cold["losses"] == losses,
                        state_bitwise=saved["world_size"] == entry["world"] and all(
                            torch.equal(kept[part][k], state[part][k])
                            for part in ("params", "m", "v") for k in state[part]))
            del state, step_fn, kept
        dist.barrier()
        g.release()
        torch.cuda.empty_cache()
        cold["seconds"] = time.perf_counter() - t0
        out["cold"].append(cold)
    out["cold_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckdir)
    return out


def route_tables() -> dict:
    """The launch counters' tables by route and form, copied, under the
    keys of a dist_train line."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN

    return {"attention_launches_by_route": dict(FA.launches_by_route),
            "attention_bwd_launches_by_route": dict(FA.launches_bwd_by_route),
            "rmsnorm_bwd_launches_by_route": dict(RN.launches_bwd_by_route),
            "rglru_launches_by_form": {"forward": dict(RG.launches_by_form),
                                       "backward": dict(RG.launches_bwd_by_form)}}


def dist_worker(args) -> int:
    """One rank of ``dist_train`` (``--dist-worker``): each layout through
    ``runtime/train_loop.train`` over the ranks' process groups, then on
    layout A one gather of the embedding row under each gather topology;
    then ``dist_wires``'s runs on layouts A's and B's groups; then
    ``dist_elastic``'s run (:func:`dist_elastic_run`).  Writes
    ``rank<r>.json`` into ``--dist-out``."""
    import datetime
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.comm import CommEngine, GatherPolicy
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import MiCSGroups, init_distributed
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import LoopConfig, train

    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    rank, world = init_distributed(args.dist_backend, timeout=timeout)
    dev = torch.device("cuda", torch.cuda.current_device())
    out_dir = pathlib.Path(args.dist_out)
    result = {"rank": rank, "world": world, "device": str(dev), "layouts": {}, "wires": {}}
    kept = {}                 # the wire runs' groups: their base layouts'
    for layout in DIST_LAYOUTS:
        tp = dist_train_path(layout)
        model, topo = dist_model(layout), dist_topology(layout)
        groups = MiCSGroups(topo, rank, backend=args.dist_backend, timeout=timeout,
                            inner=layout.inner)
        mcfg = MiCSConfig(micro_steps=tp.micro_steps, gather_order=layout.gather_order,
                          hierarchy_inner=layout.inner)   # bf16, prefetch, bucketed, exact
        dc = DataConfig(vocab=model.cfg.vocab, seq=tp.seq, global_batch=tp.global_batch,
                        micro_steps=tp.micro_steps)
        ckdir = out_dir / f"ck_{layout.name}"
        lc = LoopConfig(total_steps=layout.steps, checkpoint_every=0, checkpoint_dir=str(ckdir),
                        log_every=0, seed=0)
        start = None
        if layout.tp > 1:
            t0 = time.perf_counter()
            dist_tp_start(layout, model, topo, groups, rank, ckdir, dev)
            start = {"checkpoint_step": 0, "seconds": time.perf_counter() - t0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        stats = train(model, topo, mcfg, OptConfig(warmup_steps=0, total_steps=tp.steps), dc,
                      lc, device=dev, groups=groups)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        line = {"losses": stats.losses, "grad_norms": stats.grad_norms,
                "step_ms_all": [t * 1e3 for t in stats.step_times],
                "step_ms": statistics.median(stats.step_times[1:]) * 1e3, "loop_s": loop_s,
                "checkpoint_s": stats.save_times[-1], "comm": stats.comm,
                "launches": read_counts(), "start": start, **route_tables(),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        dist.barrier(group=groups.world.handle)
        if rank == 0:
            line["checkpoint_step"] = Checkpointer(ckdir).latest_step()
            line["checkpoint_gb"] = sum(
                f.stat().st_size for f in (ckdir / f"step_{layout.steps:08d}").rglob("*")
                if f.is_file()) / 1e9
            shutil.rmtree(ckdir)
        if layout.name == "A":
            # one gather of the embedding row under each topology, bf16 wire
            row = init_params(model, 0, device=dev, topo=topo, rank=rank)["embed"][0, 0]
            bufs = {}
            for topology in ("flat", "inner_first", "outer_first"):
                eng = CommEngine(topo, GatherPolicy(topology=topology, inner=layout.inner),
                                 groups=groups)
                bufs[topology] = eng.gather_flat(row)
            full = init_params(model, 0, device=dev)["embed"][0, 0].to(torch.bfloat16)
            line["gather_check"] = {
                "elements": full.numel(),
                "topologies_bitwise_equal": all(torch.equal(b, bufs["flat"])
                                                for b in bufs.values()),
                "equal_to_the_full_row": torch.equal(bufs["flat"], full)}
            del row, bufs, full
        result["layouts"][layout.name] = line
        if any(wr.base == layout.name for wr in DIST_WIRES):
            kept[layout.name] = groups
        del groups
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for wr in DIST_WIRES:
        result["wires"][wr.name] = dist_wire_run(wr, kept[wr.base], rank, dev,
                                                 out_dir / WIRE_REF_M)
    result["wires_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["elastic"] = dist_elastic_run(rank, dev, out_dir, args.dist_backend, timeout)
    result["elastic_s"] = time.perf_counter() - t0
    (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_tp_start(layout: DistLayout, model, topo, groups, rank: int, ckdir, dev) -> None:
    """Write the step-0 checkpoint a tp > 1 layout's loop resumes from:
    its model's ``init_params(seed=0)`` at tp 1 on this card (the weights
    of the one-card runs it is held to), cut into tp shards by
    ``convert.tp_params_from_full`` one pool at a time and into this rank's
    model coordinate and partition chunk, with zero moments."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import shard_state, tp_params_from_full
    from repro_torch.core.mics import init_params

    model_1 = dist_model(layout, tp=1)
    full = init_params(model_1, 0, device=dev)
    params = {}
    for name in list(full):
        cut = tp_params_from_full(model, model_1, {name: full.pop(name)})
        params[name] = shard_state(model, topo, rank, {"params": cut, "m": {}, "v": {},
                                                       "step": 0}, device=dev)["params"][name]
        del cut
    state = {"params": params, "step": 0,
             **{part: {k: torch.zeros_like(v) for k, v in params.items()} for part in ("m", "v")}}
    Checkpointer(ckdir).save(state, 0, topo=topo, groups=groups)
    del state, params
    torch.cuda.empty_cache()


def dist_reference(layout: DistLayout, dev, on_step=None) -> list[tuple[float, float]]:
    """Layout ``layout``'s model at tp 1 on this one card over the same
    global batches and steps (``build_train_step`` at p = 1, from
    ``init_state(seed=0)``): (loss, grad_norm).  ``on_step(i, state)``
    runs after step i (from 1)."""
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import OptConfig

    tp = dist_train_path(layout)
    model = dist_model(layout, tp=1)
    step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=tp.micro_steps),
                            OptConfig(warmup_steps=0, total_steps=tp.steps), device=dev)
    source = SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq=tp.seq,
                                    global_batch=tp.global_batch, micro_steps=tp.micro_steps))
    state, out = init_state(model, 0, device=dev), []
    for i in range(layout.steps):
        state, m = step(state, source.global_step_batch(i))
        out.append((m["loss"].item(), m["grad_norm"].item()))
        if on_step is not None:
            on_step(i + 1, state)
    del state, step
    torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_train_phase(card: str, dev, train_line: dict) -> dict:
    """``dist_train``: the MiCS step over ``DIST_WORLD`` ranks through
    ``runtime/train_loop.train``.  With fewer cards than ranks, every rank
    shares card 0 and the collectives run over gloo through pinned host
    buffers (NCCL refuses two ranks on one card): a correctness rehearsal,
    not a MiCS speed.  With enough cards, NCCL, one card a rank.  Any rank's
    failure fails the phase."""
    import os
    import shutil

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DIST_WORLD else "gloo"
    t_phase = time.perf_counter()
    one_card = list(zip(train_line["loss"], train_line["grad_norm"]))
    refs = {lay.name: one_card[:lay.steps] for lay in DIST_LAYOUTS if lay.name in ("A", "C")}
    out_dir = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    def save_moment(i, state):  # the wire runs' reference first moment
        if i == WIRE_STEPS:
            torch.save({k: t.cpu() for k, t in state["m"].items()}, out_dir / WIRE_REF_M)

    for layout in DIST_LAYOUTS:
        if layout.name not in refs:
            refs[layout.name] = dist_reference(
                layout, dev, save_moment if layout.name == WIRE_REFERENCE else None)
    torch.cuda.empty_cache()
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DIST_WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DIST_WORLD), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(DIST_WORLD), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            log = open(out_dir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__).resolve()), "--dist-worker",
                 "--dist-backend", backend, "--dist-out", str(out_dir)],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = PHASE_CLOCK["start"] + SCRIPT_LIMIT_S - AFTER_DIST_S
        failed = []
        while not failed and any(p.poll() is None for p, _ in procs):
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"dist_train: the ranks had not finished {SCRIPT_LIMIT_S - AFTER_DIST_S} s "
                    f"into the script (its limit {SCRIPT_LIMIT_S} s less {AFTER_DIST_S} s for "
                    f"the phases after them)")
            failed = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            time.sleep(0.5)
        failed = failed or [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    workers_s = time.perf_counter() - t0
    if failed:
        tail = (out_dir / f"rank{failed[0]}.log").read_text()[-4000:]
        raise AssertionError(f"dist_train: rank {failed[0]} failed:\n{tail}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(DIST_WORLD)]

    lines = {}
    for layout in DIST_LAYOUTS:
        per = [rk["layouts"][layout.name] for rk in ranks]
        losses, gnorms = per[0]["losses"], per[0]["grad_norms"]
        for p in per[1:]:   # means over the data ranks: the same on every rank
            if p["losses"] != losses or p["grad_norms"] != gnorms:
                raise AssertionError(f"dist_train {layout.name}: ranks disagree on the loss")
        if not all(math.isfinite(x) for x in losses + gnorms) or len(losses) != layout.steps:
            raise AssertionError(f"dist_train {layout.name}: losses {losses}, {gnorms}")
        ref = refs[layout.name]
        rel = []
        for i, ((loss, gn), (rl, rg)) in enumerate(zip(zip(losses, gnorms), ref)):
            el, eg = abs(loss - rl) / abs(rl), abs(gn - rg) / abs(rg)
            rel.append({"loss": el, "grad_norm": eg})
            lim_l = DIST_REL_TOL["loss1"] if i == 0 else DIST_REL_TOL["later"]
            lim_g = DIST_REL_TOL["grad_norm1"] if i == 0 else DIST_REL_TOL["later"]
            if not (el <= lim_l and eg <= lim_g):
                raise AssertionError(f"dist_train {layout.name} step {i + 1}: loss {loss} vs "
                                     f"{rl}, grad_norm {gn} vs {rg}")
        want_calls = dist_expected_calls(layout)
        model = dist_model(layout)
        path = dist_train_path(layout)
        want_launches = {k: n * path.micro_steps * layout.steps
                         for k, n in train_launches(model.cfg).items()}
        for r, p in enumerate(per):
            if p["comm"]["calls"] != want_calls:
                raise AssertionError(f"dist_train {layout.name} rank {r}: collectives "
                                     f"{p['comm']['calls']} != {want_calls}")
            if p["launches"] != want_launches:
                raise AssertionError(f"dist_train {layout.name} rank {r}: launches "
                                     f"{p['launches']} != {want_launches}")
            # every call on the path's route: attention forward on mma, its
            # backward and RMSNorm's on the one-card path's, the RG-LRU gated
            if (p["attention_bwd_launches_by_route"][path.attn_bwd_route] != want_launches[
                    "flash_attention_bwd"] or p["rmsnorm_bwd_launches_by_route"][
                    path.rms_bwd_route] != want_launches["rmsnorm_bwd"]
                    or p["attention_launches_by_route"]["mma"] != want_launches[
                        "flash_attention"]
                    or p["rglru_launches_by_form"]["forward"]["gated"] != want_launches["rglru"]
                    or p["rglru_launches_by_form"]["backward"]["gated"]
                    != want_launches["rglru_bwd"]):
                raise AssertionError(f"dist_train {layout.name} rank {r}: routes {p}")
        if per[0].get("checkpoint_step") != layout.steps:
            raise AssertionError(f"dist_train {layout.name}: checkpoint at "
                                 f"{per[0].get('checkpoint_step')}")
        gc = per[0].get("gather_check")
        if layout.name == "A" and not all(
                p["gather_check"]["topologies_bitwise_equal"]
                and p["gather_check"]["equal_to_the_full_row"] for p in per):
            raise AssertionError(f"dist_train A: gather check {[p['gather_check'] for p in per]}")
        lines[layout.name] = {
            "arch": layout.arch, "steps": layout.steps, "ranks": DIST_WORLD,
            "repl": layout.repl, "shard": layout.shard, "tp": layout.tp,
            "gather_order": layout.gather_order, "inner": layout.inner,
            "layers": model.cfg.n_layers,
            "global_batch": path.global_batch, "micro_steps": path.micro_steps,
            "micro_batch_per_rank": [path.global_batch // path.micro_steps
                                     // dist_topology(layout).data_parallel_size, path.seq],
            "start": per[0]["start"],
            "loss": losses, "grad_norm": gnorms, "reference": ref, "rel_err": rel,
            "step_ms_label": ("nccl, one card a rank" if backend == "nccl" else
                              f"gloo over host, {DIST_WORLD} ranks on one card" if cards == 1
                              else f"gloo over host, {DIST_WORLD} ranks on {cards} cards"),
            "step_ms": [p["step_ms"] for p in per],
            "comm_s": [p["comm"]["seconds"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per], "loop_s": [p["loop_s"] for p in per],
            "checkpoint_s": [p["checkpoint_s"] for p in per],
            "checkpoint_gb": per[0]["checkpoint_gb"],
            "comm_calls": want_calls, "comm_bytes": per[0]["comm"]["bytes"],
            "launches_per_rank": want_launches, "gather_check": gc}
    launches = {k: sum(rk["layouts"][lay.name]["launches"][k] for rk in ranks
                       for lay in DIST_LAYOUTS) for k in want_launches}
    wires_s = max(rk["wires_s"] for rk in ranks)
    elastic_s = max(rk["elastic_s"] for rk in ranks)
    wire_lines, wire_launches = dist_wire_checks(ranks, refs[WIRE_REFERENCE], backend, cards)
    elastic_line, elastic_launches = dist_elastic_checks(ranks)
    line = {"phase": "dist_train", "arch": sorted({lay.arch for lay in DIST_LAYOUTS}),
            "device_count": cards,
            "backend": backend, "ranks": DIST_WORLD,
            "ranks_per_card": DIST_WORLD // min(cards, DIST_WORLD),
            "layouts": lines, "workers_s": workers_s - wires_s - elastic_s,
            "seconds": time.perf_counter() - t_phase - wires_s - elastic_s, "gpu": card}
    emit(line)
    emit({"phase": "dist_wires", "arch": "llama3.2-1b", "layers": WIRE_LAYERS,
          "device_count": cards, "backend": backend, "ranks": DIST_WORLD,
          "runs": wire_lines, "seconds": wires_s, "gpu": card})
    emit({"phase": "dist_elastic", **elastic_line, "device_count": cards, "backend": backend,
          "step_ms_label": ("nccl, one card a rank" if backend == "nccl" else
                            f"gloo over host, {DIST_WORLD} ranks on {cards} card(s)"),
          "seconds": elastic_s, "gpu": card})
    shutil.rmtree(out_dir)
    # for the kernel table: the launches summed over ranks and layouts
    by_route = {key: {} for key in ("attention_launches_by_route",
                                    "attention_bwd_launches_by_route",
                                    "rmsnorm_bwd_launches_by_route")}
    by_form = {"forward": {}, "backward": {}}
    for rk in ranks:
        for got in [rk["layouts"][lay.name] for lay in DIST_LAYOUTS] + [
                rk["wires"][wr.name] for wr in DIST_WIRES] + [rk["elastic"]]:
            for key, table in by_route.items():
                for route, n in got[key].items():
                    table[route] = table.get(route, 0) + n
            for way, table in by_form.items():
                for form, n in got["rglru_launches_by_form"][way].items():
                    table[form] = table.get(form, 0) + n
    # the route tables cover the wire and elastic runs too; their launches
    # stand apart
    return {"arch": "dist_train", "launches": launches, **by_route,
            "rglru_launches_by_form": by_form, "wires_launches": wire_launches,
            "elastic_launches": elastic_launches}


def dist_elastic_checks(ranks: list) -> tuple[dict, dict]:
    """``dist_elastic``'s checks on every rank's results: every rank's
    ledger (the reference's keys) ``ELASTIC_LEDGER``; the batches fetched
    ``ELASTIC_CURSORS``; ranks 0-1 6 losses from the cursors 0, 1, 2, 2, 3,
    4 and one emergency save; the same finite loss of a step on every rank
    that ran it; each world's losses and checkpointed state bitwise its
    cold restart's; each rank's launches the train path's a micro-step x
    micro-steps x the steps it ran, on the path's routes.  Returns ``(line,
    launches summed over ranks)``."""
    per = [rk["elastic"] for rk in ranks]
    keys = list(ELASTIC_LEDGER[0])
    path = dist_train_path(next(lay for lay in DIST_LAYOUTS if lay.name == "B"))
    cfg = elastic_model().cfg
    total = {}
    for r, p in enumerate(per):
        ledger = [{k: e[k] for k in keys} for e in p["ledger"]]
        if ledger != ELASTIC_LEDGER:
            raise AssertionError(f"dist_elastic rank {r}: ledger {ledger}")
        if p["cursors"] != ELASTIC_CURSORS[r] or len(p["losses"]) != ELASTIC_STEPS_RUN[r]:
            raise AssertionError(f"dist_elastic rank {r}: fetched {p['cursors']}, "
                                 f"{len(p['losses'])} losses")
        if not all(math.isfinite(x) for x in p["losses"] + p["grad_norms"]):
            raise AssertionError(f"dist_elastic rank {r}: losses {p['losses']}")
        if not set(p["losses"]) <= set(per[0]["losses"]) or p["save_failures"]:
            raise AssertionError(f"dist_elastic rank {r}: losses {p['losses']} against "
                                 f"rank 0's {per[0]['losses']}, {p['save_failures']} failed saves")
        for cold in p["cold"]:
            if r < cold["world"] and not (cold["losses_bitwise"] and cold["state_bitwise"]):
                raise AssertionError(f"dist_elastic rank {r}: cold restart {cold}")
        want = {k: n * ELASTIC_MICRO_STEPS * ELASTIC_STEPS_RUN[r]
                for k, n in train_launches(cfg).items()}
        if (p["launches"] != want or p["attention_launches_by_route"]["mma"]
                != want["flash_attention"] or p["attention_bwd_launches_by_route"][
                path.attn_bwd_route] != want["flash_attention_bwd"]
                or p["rmsnorm_bwd_launches_by_route"][path.rms_bwd_route]
                != want["rmsnorm_bwd"]):
            raise AssertionError(f"dist_elastic rank {r}: launches {p['launches']} != {want}")
        add_counts(total, p["launches"])
    if per[0]["emergency_saves"] != 1 or per[1]["emergency_saves"] != 1:
        raise AssertionError(f"dist_elastic: emergency saves "
                             f"{[p['emergency_saves'] for p in per]}")
    line = {"arch": "llama3.2-1b", "layers": cfg.n_layers, "start_layout": "B",
            "steps": ELASTIC_STEPS, "checkpoint_every": ELASTIC_EVERY,
            "plan": [[kind, at, kw] for kind, at, kw in ELASTIC_PLAN],
            "global_batch": ELASTIC_GLOBAL_BATCH, "micro_steps": ELASTIC_MICRO_STEPS,
            "seq": path.seq, "ledger": per[0]["ledger"], "losses": per[0]["losses"],
            "grad_norms": per[0]["grad_norms"], "cursors": [p["cursors"] for p in per],
            "restarts": [p["restarts"] for p in per],
            "emergency_saves": [p["emergency_saves"] for p in per],
            "rebuild_s": [[e["rebuild_s"] for e in p["ledger"]] for p in per],
            "saves": [p["saves"] for p in per], "checkpoint_gb": per[0]["checkpoint_gb"],
            "cold": [p["cold"] for p in per],
            "bitwise": all(c["losses_bitwise"] and c["state_bitwise"]
                           for r, p in enumerate(per) for c in p["cold"] if r < c["world"]),
            "step_ms": [p["step_ms_all"] for p in per], "loop_s": [p["loop_s"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per],
            "cold_peak_gb": [p["cold_peak_gb"] for p in per],
            "launches": [p["launches"] for p in per]}
    return line, total


def dist_wire_checks(ranks: list, reference: list, backend: str, cards: int):
    """``dist_wires``'s checks on every rank's results: finite losses and
    grad norms, the same on every rank, each step's within
    ``WIRE_REL_TOL`` and ``WIRE_TIGHT_TOL`` of the one-card fp32-wire run
    of the 4-layer model (``reference``: layout B's ``dist_reference``);
    each rank's first moment within ``WIRE_MOMENT_REL_TOL`` of the
    reference's chunk at its partition coordinate, the next coordinate's
    at least ``WIRE_MOMENT_CONTROL_MIN`` away; every rank's
    ``CommEngine`` calls, kernel launches (the quantizer's by rounding
    too) as :func:`dist_wire_expected`; the int8 legs' counted bytes at
    most ``WIRE_BYTES_MAX`` of a bf16 wire's.  Returns ``(lines, launches
    summed over ranks and runs)``."""
    lines, total = {}, {}
    for wr in DIST_WIRES:
        per = [rk["wires"][wr.name] for rk in ranks]
        losses, gnorms = per[0]["losses"], per[0]["grad_norms"]
        if any(p["losses"] != losses or p["grad_norms"] != gnorms for p in per[1:]):
            raise AssertionError(f"dist_wires {wr.name}: ranks disagree on the loss")
        if len(losses) != WIRE_STEPS or not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"dist_wires {wr.name}: losses {losses}, {gnorms}")
        rel = []
        for i, ((loss, gn), (rl, rg)) in enumerate(zip(zip(losses, gnorms), reference)):
            el, eg = abs(loss - rl) / abs(rl), abs(gn - rg) / abs(rg)
            rel.append({"loss": el, "grad_norm": eg})
            if not all(el <= tol["loss"] and eg <= tol["grad_norm"]
                       for tol in (WIRE_REL_TOL, WIRE_TIGHT_TOL)):
                raise AssertionError(f"dist_wires {wr.name} step {i + 1}: loss {loss} vs "
                                     f"{rl}, grad_norm {gn} vs {rg}")
        for r, pr in enumerate(per):
            if not (max(pr["moment_rel"].values()) <= WIRE_MOMENT_REL_TOL
                    and min(pr["moment_control"].values()) >= WIRE_MOMENT_CONTROL_MIN):
                raise AssertionError(f"dist_wires {wr.name} rank {r}: first moment off its "
                                     f"reference chunk by {pr['moment_rel']}, the next "
                                     f"chunk's by {pr['moment_control']}")
        layout = wire_layout(wr)
        want_calls, want_launches, want_quant, bf16_bytes = dist_wire_expected(wr)
        int8_kinds = [k for k in want_calls if k.startswith("all_to_all")
                      or (k.startswith("all_gather") and (wr.knobs.get("quant_gather")
                                                          or k.endswith("replication")))]
        ratios = []
        for r, p in enumerate(per):
            if p["comm"]["calls"] != want_calls:
                raise AssertionError(f"dist_wires {wr.name} rank {r}: collectives "
                                     f"{p['comm']['calls']} != {want_calls}")
            if p["launches"] != want_launches or p["quantize_by_mode"] != want_quant:
                raise AssertionError(f"dist_wires {wr.name} rank {r}: launches "
                                     f"{p['launches']} {p['quantize_by_mode']} != "
                                     f"{want_launches} {want_quant}")
            int8_bytes = sum(p["comm"]["bytes"][k] for k in int8_kinds)
            ratios.append(int8_bytes / bf16_bytes)
            if not 0 < ratios[-1] <= WIRE_BYTES_MAX:
                raise AssertionError(f"dist_wires {wr.name} rank {r}: int8 legs {int8_bytes} B "
                                     f"against bf16's {bf16_bytes} B")
        lines[wr.name] = {
            "base_layout": wr.base, "knobs": wr.knobs, "wires": per[0]["wires"],
            "repl": layout.repl, "shard": layout.shard, "gather_order": layout.gather_order,
            "inner": layout.inner, "steps": WIRE_STEPS, "loss": losses, "grad_norm": gnorms,
            "reference": reference[:WIRE_STEPS], "rel_err": rel,
            "rel_tol": WIRE_REL_TOL, "tight_tol": WIRE_TIGHT_TOL,
            "moment_rel_tol": WIRE_MOMENT_REL_TOL,
            "moment_rel_err": [p["moment_rel"] for p in per],
            "moment_control_rel_err": [p["moment_control"] for p in per],
            "step_ms_label": ("nccl, one card a rank" if backend == "nccl" else
                              f"gloo over host, {DIST_WORLD} ranks on {cards} card(s)"),
            "step_ms": [p["step_ms"] for p in per],
            "comm_s": [p["comm"]["seconds"] for p in per],
            "peak_gb": [p["peak_gb"] for p in per], "comm_calls": want_calls,
            "comm_bytes": per[0]["comm"]["bytes"], "int8_legs_bytes_vs_bf16": ratios,
            "launches_per_rank": want_launches, "quantize_by_mode": want_quant}
        for p in per:
            add_counts(total, p["launches"])
    return lines, total


def kernel_checks(gen, dev, flush):
    """Each kernel at the paths' shapes against its plain version, timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN

    def check(name, out, ref, tol, rtol=None):
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), rtol=tol if rtol is None else rtol,
                              atol=tol):
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max |err| {err}, tol {tol})")
        return err

    rms_checks = []
    for path, n, d in (("llama prefill", 4 * 512, 2048), ("llama decode", 4, 2048),
                       ("recurrentgemma prefill", 4 * 2560, 2560),
                       ("recurrentgemma decode", 4, 2560),
                       ("llama train", train_rows(TRAIN[0]), 2048),
                       ("recurrentgemma train", train_rows(TRAIN[1]), 2560),
                       # a rank of dist_train's layout C: 2 x 2048 rows a
                       # micro-step (layout D's rank has the one-card path's)
                       ("llama tp 2 train", 2 * 2048, 2048)):
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        s = (0.2 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        w = 1.0 + s.float()
        tol = TOL[x.dtype]
        y = RN.rmsnorm(x, s)
        err = check("rmsnorm", y, RN.rms_norm_plain(x, s), tol)
        if not torch.equal(y, RN.rmsnorm(x, s)):
            raise AssertionError(f"rmsnorm {path}: not bitwise repeatable")
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + s.numel() * s.element_size(),
                           4 * x.numel(), torch.float32)
        rms_checks.append({
            "case": path, "shape": [n, d], "dtype": "bf16", "scale_dtype": "bf16",
            "plan": RN.plan_rmsnorm(n, d, x.dtype)._asdict(), "bitwise_repeat": True,
            "max_abs_err": err, "tol": tol, "ms": time_ms(lambda: RN.rmsnorm(x, s), flush),
            "plain_ms": time_ms(lambda: RN.rms_norm_plain(x, s), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), weight=w.to(x.dtype),
                                                     eps=1e-6), flush)})

    bf, f32 = torch.bfloat16, torch.float32
    attn_cases = [
        # kind, b, tq, tk, hkv, g, dh, causal, window, q_offset, kv_valid_len, dtype
        ("llama prefill", 4, 512, 512, 8, 4, 64, True, 0, 0, None, bf),
        ("llama decode", 4, 1, 544, 8, 4, 64, False, 0, 519, 520, bf),
        ("recurrentgemma prefill", 4, 2560, 2560, 1, 10, 256, True, 2048, 0, None, bf),
        ("recurrentgemma decode", 4, 1, 2048, 1, 10, 256, False, 0, 0, 2048, bf),
        # a rank's train micro-step in dist_train: layout C (llama, tp 2: 4
        # of the 8 KV heads, their 16 Q heads) and D (recurrentgemma, tp 4:
        # 3 of the 12 padded Q heads on the one gathered KV head)
        ("llama tp 2 train", 2, 2048, 2048, 4, 4, 64, True, 0, 0, None, bf),
        ("recurrentgemma tp 4 train", 2, 2048, 2048, 1, 3, 256, True, 2048, 0, None, bf),
        ("ragged", 4, 200, 200, 8, 4, 64, True, 0, 0, None, bf),
        ("ragged", 4, 200, 200, 8, 4, 64, True, 0, 0, None, f32),
        ("window", 4, 512, 512, 8, 4, 64, True, 64, 0, None, bf),
        ("window", 4, 512, 512, 8, 4, 64, True, 64, 0, None, f32),
        ("dh256 window", 2, 512, 512, 1, 10, 256, True, 128, 0, None, f32),
        # mma route edges
        ("T 103, g 10: M-tiles cut a position's heads", 2, 103, 103, 1, 10, 256, True, 0, 0,
         None, bf),
        ("dh 256, window 100 cuts a key tile", 2, 300, 300, 1, 10, 256, True, 100, 0, None, bf),
        ("q_offset 64, tq 128, kv_valid_len 150 inside a key tile", 2, 128, 256, 2, 4, 64,
         True, 0, 64, 150, bf),
        ("dh 16", 2, 200, 200, 2, 4, 16, True, 0, 0, None, bf),
        ("dh 128", 2, 200, 200, 2, 4, 128, True, 0, 0, None, bf),
        # split route edges
        ("kv_len 1", 4, 1, 544, 8, 4, 64, False, 0, 0, 1, bf),
        ("g 1", 4, 1, 544, 8, 1, 64, False, 0, 299, 300, bf),
        ("chunk of 2 positions, causal, window 64: empty splits", 2, 2, 544, 1, 8, 128, True,
         64, 300, 302, bf),
    ]
    attn_checks = []
    for (kind, b, tq, tk, hkv, g, dh, causal, window, q_offset, kvl, dt) in attn_cases:
        q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=dev).to(dt)
        k = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
        v = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kvl)
        tol = TOL[dt]
        route = FA.route(dt, tq * g)
        out = FA.flash_attention(q, k, v, **kw)
        err = check(f"flash_attention {kind}", out, FA.attention_plain(q, k, v, **kw), tol)
        if not torch.equal(out, FA.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {kind}: route {route} is not bitwise "
                                 "repeatable")
        kv_len = tk if kvl is None else min(tk, kvl)
        extra = {}
        if kind == "recurrentgemma decode":  # the partials kernel alone
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            nsplit, chunk = FA.plan_decode_splits(b, hkv, kv_len, sms=sms)
            extra["partials"] = {"nsplit": nsplit, "chunk": chunk, "max_abs_err": check(
                "flash_attention split partials",
                FA.decode_partials(q, k, v, nsplit=nsplit, chunk=chunk, **kw),
                FA.decode_partials_plain(q, k, v, nsplit=nsplit, chunk=chunk, **kw), tol)}
        allowed = FA.mask_bias(tq, kv_len, causal=causal, window=window, q_offset=q_offset,
                               kv_valid_len=kvl, device=dev) == 0
        pairs = int(allowed.sum().item()) * b * hkv * g
        ops = 4 * dh * pairs
        nbytes = (2 * q.numel() + 2 * b * kv_len * hkv * dh) * q.element_size()
        b_ms, b_by = bound(nbytes, ops, dt)
        # the same function as one PyTorch call: [b, heads, t, dh] layout
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, tq, dh).contiguous()
        ks = k[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        vs = v[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        lib_causal = causal and not window and q_offset == 0 and tq == kv_len
        mask = None if lib_causal or not (causal or window) else allowed
        ms = time_ms(lambda: FA.flash_attention(q, k, v, **kw), flush)
        if route != "split":
            extra["tflops"] = ops / ms / 1e9
        attn_checks.append({
            "case": kind, "shape": {"b": b, "tq": tq, "tk": tk, "hkv": hkv, "g": g, "dh": dh},
            "causal": causal, "window": window, "q_offset": q_offset, "kv_valid_len": kvl,
            "dtype": "bf16" if dt == bf else "fp32", "route": route, "bitwise_repeat": True,
            "max_abs_err": err, "tol": tol, "ms": ms,
            "host_us": host_us(lambda: FA.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, **kw), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, is_causal=lib_causal, enable_gqa=True), flush),
            **extra})
        del q, k, v, qs, ks, vs

    # RG-LRU.  No single PyTorch call computes a linear recurrence (a
    # cumprod / cumsum form divides by vanishing products), so library_ms is
    # null.  Gated form first (the path's): x ~ N(0, 1) and the gate weights
    # at the model's init scale (gates std 0.02, biases 0.1, sigmoid(lam) in
    # (0.9, 0.999)); "aliased" updates the fp32 state in place, as decode does.
    def plan_of(shape):
        nchunks, chunk_len = RG.plan_scan_chunks(*shape, sms=sms)
        return {"nchunks": nchunks, "chunk_len": chunk_len}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gated_cases = [
        ("recurrentgemma prefill", (4, 2560, 2560), bf, None),
        ("recurrentgemma decode", (4, 1, 2560), bf, "aliased"),
        ("fp32", (4, 2560, 2560), f32, None),
        ("ragged", (3, 1001, 2500), bf, "h0"),
        ("recurrentgemma train", (TRAIN[1].global_batch // TRAIN[1].micro_steps,
                                  TRAIN[1].seq, 2560), bf, None),
        # dist_train's layout D: the LRU width cut over tp 4
        ("recurrentgemma tp 4 train", (2, 2048, 640), bf, None),
    ]
    rglru_checks = []
    for kind, shape, dt, state in gated_cases:
        c = shape[2]
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        u = 0.9 + 0.099 * torch.rand(c, generator=gen, device=dev)
        ws = tuple(w.to(dt) for w in (
            0.02 * torch.randn(c, generator=gen, device=dev),
            0.1 * torch.randn(c, generator=gen, device=dev),
            0.02 * torch.randn(c, generator=gen, device=dev),
            0.1 * torch.randn(c, generator=gen, device=dev), torch.log(u) - torch.log1p(-u)))
        h0 = None if state is None else torch.randn(shape[0], c, generator=gen, device=dev)

        def gated(st=None):
            st = None if h0 is None else (h0.clone() if st is None else st)
            return RG.rglru_gated(x, *ws, st, state_out=st if state == "aliased" else None)

        def eager(st=None):  # the unfused path: gate math, the (a, b) kernel, cast, state
            st = None if h0 is None else (h0.clone() if st is None else st)
            a_, b_ = RG.rglru_coeffs_plain(x, *ws)
            hs = RG.rglru(a_, b_, st)
            if state == "aliased":
                return hs.to(x.dtype), st.copy_(hs[:, -1])
            return hs.to(x.dtype), hs[:, -1].clone()

        (h, h_last), (h2, h_last2) = gated(), gated()
        if not (torch.equal(h, h2) and torch.equal(h_last, h_last2)):
            raise AssertionError(f"rglru_gated {kind}: not bitwise repeatable")
        want, want_last = RG.rglru_gated_plain(x, *ws, h0)
        if dt == bf:
            tol = RGLRU_TOL[dt]
            err = check(f"rglru_gated {kind}", h, want, tol)
        else:
            tol = RGLRU_GATED_FP32_REL * want.abs().max().item()
            err = check(f"rglru_gated {kind}", h, want, tol, rtol=0.0)
        err_last = check(f"rglru_gated {kind} h_last", h_last, want_last,
                         RGLRU_GATED_FP32_REL * want_last.abs().max().item(), rtol=0.0)
        plan = plan_of(shape)
        # x read, h written, the weights read once; h0 read and h_last written
        nbytes = (2 * x.numel() * x.element_size() + 5 * c * ws[0].element_size()
                  + (0 if h0 is None else 4 * h0.numel()) + 4 * shape[0] * c)
        b_ms, b_by = bound(nbytes, GATED_OPS_PER_ELEMENT * x.numel(), torch.float32)
        st = None if h0 is None else h0.clone()
        rglru_checks.append({
            "case": kind, "form": "gated", "shape": list(shape),
            "dtype": "bf16" if dt == bf else "fp32", "state": state, "plan": plan,
            "bitwise_repeat": True, "max_abs_err": err, "tol": tol,
            "h_last_max_abs_err": err_last,
            "ms": time_ms(lambda: gated(st), flush),
            "eager_ms": time_ms(lambda: eager(st), flush),
            "plain_ms": time_ms(lambda: RG.rglru_gated_plain(x, *ws, h0), flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del x, h, h2, want

    # The TPU kernel's own function, (a, b) form: a in (0.7, 1), b small, as
    # tests/test_kernels.py draws them.
    ab_cases = [
        ("recurrentgemma prefill", (4, 2560, 2560), f32, False),
        ("recurrentgemma decode", (4, 1, 2560), f32, True),
        ("bf16", (4, 2560, 2560), bf, False),
        ("ragged", (3, 1001, 2500), f32, True),
    ]
    for kind, shape, dt, with_h0 in ab_cases:
        a = (0.7 + 0.299 * torch.rand(shape, generator=gen, device=dev)).to(dt)
        bb = (0.1 * torch.randn(shape, generator=gen, device=dev)).to(dt)
        h0 = (torch.randn(shape[0], shape[2], generator=gen, device=dev)
              if with_h0 else None)
        tol = RGLRU_TOL[dt]
        h = RG.rglru(a, bb, h0)
        err = check(f"rglru {kind}", h, RG.rglru_plain(a, bb, h0), tol)
        if not torch.equal(h, RG.rglru(a, bb, h0)):
            raise AssertionError(f"rglru {kind}: not bitwise repeatable")
        # a, b read and h written once (+ h0 read); one FMA (2 operations) each
        nbytes = 3 * a.numel() * a.element_size() + (0 if h0 is None else h0.numel() * 4)
        b_ms, b_by = bound(nbytes, 2 * a.numel(), torch.float32)
        rglru_checks.append({
            "case": kind, "form": "ab", "shape": list(shape),
            "dtype": "bf16" if dt == bf else "fp32", "h0": with_h0, "plan": plan_of(shape),
            "bitwise_repeat": True, "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: RG.rglru(a, bb, h0), flush),
            "plain_ms": time_ms(lambda: RG.rglru_plain(a, bb, h0), flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del a, bb, h
    return rms_checks, attn_checks, rglru_checks


# -- the blockwise quantizer -----------------------------------------------------

# fp32 operations a value of quantize (abs, max, divide, round or the
# hash's ~12 integer operations and the compare, clamp, convert) and of
# dequantize (convert, multiply, convert), for the operations side of the
# bound; the bytes side bounds both by far.
QUANT_OPS_PER_VALUE = 20
DEQUANT_OPS_PER_VALUE = 3


def eager_quantize(x: torch.Tensor, stochastic: bool, gen) -> tuple:
    """The reference's ``quantize_flat`` op by op in eager PyTorch (cast,
    pad, abs, amax, divide, round or floor(v + u) with u from the
    generator, clamp, cast): the sequence the kernel replaces."""
    from repro_torch.core.quant import BLOCK, n_blocks

    *lead, L = x.shape
    nb = n_blocks(L)
    xf = torch.nn.functional.pad(x.reshape(-1, L).float(), (0, nb * BLOCK - L))
    blocks = xf.reshape(-1, nb, BLOCK)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    v = blocks / scale[..., None]
    q = torch.floor(v + torch.rand(v.shape, generator=gen, device=v.device)) if stochastic \
        else torch.round(v)
    q = q.clamp(-127, 127).to(torch.int8).reshape(-1, nb * BLOCK)[:, :L]
    return q.reshape(*lead, L), scale.reshape(*lead, nb)


def eager_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype, chunks: int = 1):
    """The reference's ``dequantize_flat`` (and an exchange stage's sum over
    the chunks) op by op in eager PyTorch."""
    from repro_torch.core.quant import BLOCK

    *lead, L = q.shape
    nb = scale.shape[-1]
    x = torch.nn.functional.pad(q.reshape(-1, L).float(), (0, nb * BLOCK - L))
    x = (x.reshape(-1, nb, BLOCK) * scale.reshape(-1, nb, 1)).reshape(-1, nb * BLOCK)[:, :L]
    x = x.reshape(*lead, L)
    return x.sum(dim=0) if chunks > 1 else x.to(dtype)


def quant_cases() -> list:
    """``quant_checks``'s cases: ``(kind, shape, dtype, modes, outs)``.
    ``modes`` are the quantize calls, ``(label, dither key or None)``;
    ``outs`` the dequantize calls ``(dtype, chunks)``, on the first mode's
    values.  Each shape is one that a path gives the quantizer: llama's
    and recurrentgemma's serving rows (quantize_state, then a bf16
    dequantize a row a forward), the A-q qgZ stages ``[2, n / 2]`` of a
    layer row's cotangent and ``[2, n / 4]`` of its half (outer 2 x inner
    2), a B-q int8 hop-2 bucket ``[2, ceil(elems / 2)]`` (stage 0, the
    chunk-summing dequantize, the gathered ``[2, m]`` back to fp32) and its
    requantized sum (stage 1); and the exchange stage ``[4, n / 4]``,
    ragged lengths, bf16 input and all-zero blocks."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import dither_key
    from repro_torch.models.build import build_model

    bf, f32 = torch.bfloat16, torch.float32
    llama = build_model(get_config("llama3.2-1b"), tp=1)
    rg = build_model(get_config("recurrentgemma-2b"), tp=1)
    layer, embed = llama.pool("layers").layout.flat_len, llama.pool("embed").layout.flat_len
    both = (("nearest", None), ("stochastic", dither_key(7, 1, 3, 11)))
    to_both = ((bf, 1), (f32, 1))
    m = -(-max(_wire_payloads(wire_layout(DIST_WIRES[1]))) // 2)
    return [
        ("llama layer row", (layer,), f32,
         (*both, ("stochastic, fingerprint step", "fingerprint")), to_both),
        ("llama embedding row", (embed,), f32, both, to_both),
        ("exchange stage [4, n/4] of the layer row", (4, layer // 4), f32, both,
         ((f32, 4),)),
        ("llama layer row, bf16", (layer,), bf, both, to_both),
        *[(f"ragged L {n}", (8, n), f32, both, to_both) for n in (1, 127, 129, 300 + 128 * 3)],
        ("all-zero blocks", (16, 1024), f32, both, to_both),
        *[(f"recurrentgemma {pool.name} row", (pool.layout.flat_len,), f32,
           (("nearest", None),), ((bf, 1),)) for pool in rg.all_pools()],
        ("A-q qgZ stage 0 [2, n/2] of the layer row", (2, layer // 2), f32,
         (("stochastic", dither_key(0, 0, 0, 1)),), ((f32, 2),)),
        ("A-q qgZ stage 1 [2, n/4] of the layer row", (2, layer // 4), f32,
         (("stochastic", dither_key(0, 1, 0, 1)),), ((f32, 2),)),
        ("B-q hop-2 bucket [2, m]", (2, m), f32, (("stochastic", dither_key(0, 0, 0, 1)),),
         ((f32, 2), (f32, 1))),
        ("B-q hop-2 bucket's sum [m]", (m,), f32, (("stochastic", dither_key(0, 1, 0, 1)),),
         ()),
    ]


def quant_checks(gen, dev, flush):
    """``quantize`` (nearest and stochastic) and ``dequantize`` against
    their plain versions at :func:`quant_cases`, bitwise, each called twice
    for equal bits, timed beside the plain version and the eager sequence
    the kernel replaces (``eager_ms``; no one PyTorch call computes either,
    so ``library_ms`` is null).  The fingerprint mode reads its step from
    an int32 on the card."""
    from repro_torch.core.quant import dither_key, n_blocks
    from repro_torch.kernels.quant import kernel as QK

    bf, f32 = torch.bfloat16, torch.float32
    fp = dither_key(7, 1, 3, torch.tensor(-123456, dtype=torch.int32, device=dev))
    q_checks, d_checks = [], []
    for kind, shape, dt, modes, outs in quant_cases():
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        if kind == "all-zero blocks":
            x[::2] = 0               # every other row all zero, the others one zero block
            x[1::2, 256:384] = 0
        nb, rows = n_blocks(shape[-1]), x.numel() // shape[-1]
        q_bytes, s_bytes = x.numel(), 4 * rows * nb
        first = None
        for mode, key in modes:
            key = fp if key == "fingerprint" else key
            q, sc = QK.quantize(x, key)
            qp, sp = QK.quantize_plain(x, key)
            q2, s2 = QK.quantize(x, key)
            if not (torch.equal(q, qp) and torch.equal(sc, sp)):
                raise AssertionError(f"quantize {kind} {mode}: kernel disagrees with its plain "
                                     f"version ({int((q != qp).sum())} values, "
                                     f"{int((sc != sp).sum())} scales)")
            if not (torch.equal(q, q2) and torch.equal(sc, s2)):
                raise AssertionError(f"quantize {kind} {mode}: not bitwise repeatable")
            b_ms, b_by = bound(x.numel() * x.element_size() + q_bytes + s_bytes,
                               QUANT_OPS_PER_VALUE * x.numel(), f32)
            stoch = key is not None
            q_checks.append({
                "case": kind, "shape": list(shape), "dtype": "bf16" if dt == bf else "fp32",
                "mode": mode, "bitwise": True, "bitwise_repeat": True, "max_abs_err": 0.0,
                "ms": time_ms(lambda: QK.quantize(x, key), flush),
                "plain_ms": time_ms(lambda: QK.quantize_plain(x, key), flush, reps=5),
                "eager_ms": time_ms(lambda: eager_quantize(x, stoch, gen), flush, reps=5),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
            del qp, sp, q2, s2
            if first is None:
                first = q, sc
            del q, sc
        q, sc = first
        del first
        for od, k in outs:
            y = QK.dequantize(q, sc, od, chunks=k)
            if not torch.equal(y, QK.dequantize_plain(q, sc, od, chunks=k)):
                raise AssertionError(f"dequantize {kind} to {od}: kernel disagrees with its "
                                     "plain version")
            if not torch.equal(y, QK.dequantize(q, sc, od, chunks=k)):
                raise AssertionError(f"dequantize {kind}: not bitwise repeatable")
            b_ms, b_by = bound(q_bytes + s_bytes + y.numel() * y.element_size(),
                               DEQUANT_OPS_PER_VALUE * x.numel(), f32)
            extra = {}
            if kind == "llama layer row" and od == bf:
                # host time to enqueue the int8 decode's dequantize of a
                # row against the bf16 decode's cast of the fp32 row
                extra = {"host_us": host_us(lambda: QK.dequantize(q, sc, od)),
                         "cast_host_us": host_us(lambda: x.to(bf)),
                         "cast_ms": time_ms(lambda: x.to(bf), flush)}
            d_checks.append({
                **extra,
                "case": kind, "shape": list(shape), "out": "bf16" if od == bf else "fp32",
                "chunks": k, "bitwise": True, "bitwise_repeat": True, "max_abs_err": 0.0,
                "ms": time_ms(lambda: QK.dequantize(q, sc, od, chunks=k), flush),
                "plain_ms": time_ms(lambda: QK.dequantize_plain(q, sc, od, chunks=k), flush,
                                    reps=5),
                "eager_ms": time_ms(lambda: eager_dequantize(q, sc, od, k), flush, reps=5),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
            del y
        del q, sc, x
        torch.cuda.empty_cache()
    return q_checks, d_checks


# The backward kernels against their plain versions, as a fraction of the
# largest |gradient| (tests/test_torch_kernels.py's BWD_REL): bf16 rounds
# dP, P and dS at the same places in both and differs by exp2 against exp
# and the order of sums; fp32 by the order of sums.  The RG-LRU backward
# is held to the same: its bf16 outputs round the same fp32 values, and in
# fp32 the card's expf, division and sqrt differ by ulps that the reverse
# scan amplifies by up to 1 / (1 - a), as the forward's do.
BWD_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# fp32 operations a element of the gated RG-LRU backward: the forward's
# gate math (GATED_OPS_PER_ELEMENT), the reverse scan and the chain rule
# to dx and the five weight sums.
GATED_BWD_OPS_PER_ELEMENT = 2 * GATED_OPS_PER_ELEMENT


def rel_check(name, outs, refs, rel):
    """Each output within ``rel`` of its reference's max |value|; the worst
    max |err|."""
    worst = 0.0
    for o, r in zip(outs, refs):
        err, scale = _rel_err(o, r)
        if not err <= rel * scale:
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max |err| {err} > {rel} x {scale})")
        worst = max(worst, err)
    return worst


def run_bwd_route(case, route, ins, kw, ref, rel):
    """The flash backward on ``route`` for ``ins`` = (q, k, v, o, lse, dO):
    counted on it, bitwise repeatable and within ``rel`` of ``ref``;
    ``(max |err|, outputs)``."""
    from repro_torch.kernels.flash_attention import kernel as FA

    before = FA.launches_bwd_by_route[route]
    out = FA.flash_attention_bwd_on(route, *ins, **kw)
    if FA.launches_bwd_by_route[route] != before + 1:
        raise AssertionError(f"flash_attention_bwd {case}: did not take the {route} route")
    if not all(torch.equal(a, r) for a, r in zip(out, FA.flash_attention_bwd_on(route, *ins,
                                                                                **kw))):
        raise AssertionError(f"flash_attention_bwd {case} ({route}): not bitwise repeatable")
    return rel_check(f"flash_attention_bwd {case} ({route})", out, ref, rel), out


def bwd_digest(outs) -> str:
    """sha256 of the outputs' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in outs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def digest_phase(dev):
    """``digest``: llama's train-shape flash backward (the ``wgmma`` route)
    on inputs from a fixed seed, through the forward and backward every
    checkout of the port has, as a sha256 of (dq, dk, dv): two checkouts
    give the same digest when their kernels give the same bits."""
    from repro_torch.kernels.flash_attention import kernel as FA

    gen = torch.Generator(device=dev).manual_seed(18)
    b, t = TRAIN[0].global_batch // TRAIN[0].micro_steps, TRAIN[0].seq
    q, do = (torch.randn(b, t, 8, 4, 64, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, t, 8, 64, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    before = dict(FA.launches_bwd_by_route)
    out = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    took = [r for r, n in FA.launches_bwd_by_route.items() if n != before.get(r, 0)]
    emit({"phase": "digest", "case": "llama train flash backward", "route": took,
          "fwd": bwd_digest((o, lse)), "bwd": bwd_digest(out)})


def backward_checks(gen, dev, flush):
    """The backward kernels at the train path's shapes and at each route's
    edges, each against its plain version on the same inputs, called twice
    for a bitwise-equal output, timed beside its bound and one PyTorch
    library call's backward (timed alone, the graph retained)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rmsnorm import kernel as RN

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf, f32 = torch.bfloat16, torch.float32
    rms = []
    for case, (n, d), dt, sdt in (
            ("llama train [8192, 2048]", (train_rows(TRAIN[0]), 2048), bf, bf),
            ("llama tp 2 train [4096, 2048]", (2 * 2048, 2048), bf, bf),
            ("fp32 scale [64, 2048]", (64, 2048), bf, f32),
            ("few rows [3, 256]", (3, 256), bf, bf),
            ("recurrentgemma train [4096, 2560]", (train_rows(TRAIN[1]), 2560), bf, bf),
            ("fp32 [1024, 4096]", (1024, 4096), f32, f32),
            ("ragged d [37, 1000], fp32 scale", (37, 1000), bf, f32)):
        x = torch.randn(n, d, generator=gen, device=dev).to(dt)
        dy = torch.randn(n, d, generator=gen, device=dev).to(dt)
        sc = (0.2 * torch.randn(d, generator=gen, device=dev)).to(sdt)
        route = RN.bwd_route(dt, d, True)
        before = RN.launches_bwd_by_route[route]
        out = RN.rmsnorm_bwd(x, sc, dy)
        if RN.launches_bwd_by_route[route] != before + 1:
            raise AssertionError(f"rmsnorm_bwd {case}: did not take the {route} route")
        if not all(torch.equal(a, b) for a, b in zip(out, RN.rmsnorm_bwd(x, sc, dy))):
            raise AssertionError(f"rmsnorm_bwd {case}: not bitwise repeatable")
        rel = BWD_REL_TOL[bf if bf in (dt, sdt) else f32]
        err = rel_check(f"rmsnorm_bwd {case}", out, RN.rms_norm_bwd_plain(x, sc, dy), rel)
        # x and dy read, dx written, scale read and dscale written once
        nbytes = 3 * x.numel() * x.element_size() + 2 * d * sc.element_size()
        b_ms, b_by = bound(nbytes, 10 * x.numel(), f32)
        xr = x.detach().requires_grad_()
        wr = (1.0 + sc.float()).to(dt).requires_grad_()
        y = F.rms_norm(xr, (d,), weight=wr, eps=RN.EPS)
        rms.append({
            "case": case, "shape": [n, d], "dtype": str(dt)[6:], "scale_dtype": str(sdt)[6:],
            "route": route, "blocks": RN.plan_rmsnorm_bwd(n, sms=sms), "bitwise_repeat": True,
            "max_abs_err": err, "rel_tol": rel,
            "ms": time_ms(lambda: RN.rmsnorm_bwd(x, sc, dy), flush),
            "plain_ms": time_ms(lambda: RN.rms_norm_bwd_plain(x, sc, dy), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.autograd.grad(y, (xr, wr), dy, retain_graph=True),
                                  flush)})
        del x, dy, xr, y

    attn = []
    cfgs = [
        # case, b, T, hkv, g, dh, causal, window, dtype
        ("llama train", TRAIN[0].global_batch // TRAIN[0].micro_steps, TRAIN[0].seq, 8, 4, 64,
         True, 0, bf),
        ("recurrentgemma train", TRAIN[1].global_batch // TRAIN[1].micro_steps, TRAIN[1].seq, 1,
         10, 256, True, 2048, bf),
        # dist_train's layouts C and D, a rank's micro-step (as kernel_checks)
        ("llama tp 2 train", 2, 2048, 4, 4, 64, True, 0, bf),
        ("recurrentgemma tp 4 train", 2, 2048, 1, 3, 256, True, 2048, bf),
        ("dh 256 window 64", 2, 512, 1, 10, 256, True, 64, bf),
        ("dh 256 ragged T 300", 2, 300, 1, 10, 256, True, 0, bf),
        ("dh 256 hkv 1 g 3: rows [b, T g, dh] at any g", 2, 512, 1, 3, 256, True, 0, bf),
        ("dh 256 hkv 2 g 10: wgmma256 refuses, mma", 1, 512, 2, 10, 256, True, 0, bf),
        ("ragged T 300", 2, 300, 2, 4, 64, True, 0, bf),
        ("window 64", 2, 512, 2, 4, 64, True, 64, bf),
        ("g 1", 2, 256, 4, 1, 64, True, 0, bf),
        ("dh 128", 2, 512, 2, 4, 128, True, 0, bf),
        ("g 3: whole positions do not fill 64 rows, wgmma refuses", 2, 256, 2, 3, 64, True, 0,
         bf),
        ("dh 32", 2, 256, 2, 4, 32, True, 0, bf),
        ("fp32", 2, 256, 2, 4, 64, True, 0, f32),
    ]
    for case, b, t, hkv, g, dh, causal, window, dt in cfgs:
        kw = dict(causal=causal, window=window)
        q = torch.randn(b, t, hkv, g, dh, generator=gen, device=dev).to(dt)
        k = torch.randn(b, t, hkv, dh, generator=gen, device=dev).to(dt)
        v = torch.randn(b, t, hkv, dh, generator=gen, device=dev).to(dt)
        do = torch.randn(b, t, hkv, g, dh, generator=gen, device=dev).to(dt)
        # the forward as the train path runs it: o (held as kernel_checks
        # holds the forward) and the log-sum-exp the backward reads
        o, lse = FA.flash_attention_fwd(q, k, v, **kw)
        o_ref, lse_ref = FA.attention_plain_lse(q, k, v, **kw)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        if not torch.allclose(o.float(), o_ref.float(), rtol=TOL[dt], atol=TOL[dt]):
            raise AssertionError(f"flash forward {case}: o disagrees with its plain version "
                                 f"(max |err| {o_err}, tol {TOL[dt]})")
        lse_err = rel_check(f"flash lse {case}", [lse], [lse_ref], 1e-5)
        del o_ref
        route = FA.bwd_route(dt, dh, g, hkv)
        ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        err, out = run_bwd_route(case, route, (q, k, v, o, lse, do), kw, ref, BWD_REL_TOL[dt])
        extra = {}
        if route == "wgmma256":  # the column-halves route on the same inputs, same run
            m_err, m_out = run_bwd_route(case, "mma", (q, k, v, o, lse, do), kw, ref,
                                         BWD_REL_TOL[dt])
            extra["mma"] = {"max_abs_err": m_err, "ms": time_ms(
                lambda: FA.flash_attention_bwd_on("mma", q, k, v, o, lse, do, **kw), flush)}
            del m_out
        del ref, out
        allowed = FA.mask_bias(t, t, causal=causal, window=window, q_offset=0,
                               kv_valid_len=None, device=dev) == 0
        pairs = int(allowed.sum().item()) * b * hkv * g
        ops = 10 * dh * pairs
        # q, o, dO, k, v and lse read, dq, dk, dv written once
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
        b_ms, b_by = bound(nbytes, ops, dt)
        ms = time_ms(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw), flush)
        if "mma" in extra:
            extra["mma"]["tflops"] = ops / extra["mma"]["ms"] / 1e9
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, t, dh).contiguous().requires_grad_()
        ks = k.permute(0, 2, 1, 3).contiguous().requires_grad_()
        vs = v.permute(0, 2, 1, 3).contiguous().requires_grad_()
        dos = do.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, t, dh).contiguous()
        lib_causal = causal and (not window or window >= t)  # a window past T masks nothing
        y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=None if lib_causal else allowed,
                                           is_causal=lib_causal, enable_gqa=True)
        attn.append({
            "case": case, "shape": {"b": b, "T": t, "hkv": hkv, "g": g, "dh": dh},
            "causal": causal, "window": window, "dtype": str(dt)[6:], "route": route,
            "bitwise_repeat": True, "max_abs_err": err, "rel_tol": BWD_REL_TOL[dt],
            "o_max_abs_err": o_err, "o_tol": TOL[dt], "lse_max_abs_err": lse_err, "ms": ms, "tflops": ops / ms / 1e9,
            "allowed_pairs": pairs,
            "host_us": host_us(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw), 50),
            "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw),
                                flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.autograd.grad(y, (qs, ks, vs), dos,
                                                              retain_graph=True), flush),
            **extra})
        del q, k, v, do, o, qs, ks, vs, y
        torch.cuda.empty_cache()
    return rms, attn, rglru_backward_checks(gen, dev, flush)


def rglru_backward_checks(gen, dev, flush):
    """The RG-LRU backward (gated, then the ``(a, b)`` form) at the train
    shape and its edges, each over ``plan_bwd_chunks``' plan from the chunk
    starts the forward kernel writes on that plan (held to their plain
    version), against its plain version on the same inputs, called twice
    for a bitwise-equal output, timed (the backward alone) beside its
    bound.  Inputs as ``kernel_checks`` draws them
    (gates std 0.02, biases 0.1, sigmoid(lam) in (0.9, 0.999)); "clip
    binds" takes lam in (17, 18), where 1 - a^2 < 1e-6."""
    from repro_torch.kernels.rglru import kernel as RG

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf, f32 = torch.bfloat16, torch.float32
    rg_train = (TRAIN[1].global_batch // TRAIN[1].micro_steps, TRAIN[1].seq, 2560)
    out = []
    for case, shape, dt, wdt, clip in (
            ("recurrentgemma train", rg_train, bf, bf, False),
            ("recurrentgemma tp 4 train (dist_train D)", (2, 2048, 640), bf, bf, False),
            ("T 1001 (not a multiple of the chunk), C 2500, fp32 weights", (3, 1001, 2500), bf,
             f32, False),
            ("T 1", (2, 1, 2560), bf, bf, False),
            ("C 300 (not a multiple of 128)", (2, 512, 300), bf, bf, False),
            ("fp32", rg_train, f32, f32, False),
            ("clip binds", (2, 512, 512), f32, f32, True)):
        c = shape[2]
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        dh = torch.randn(shape, generator=gen, device=dev).to(dt)
        u = 0.9 + 0.099 * torch.rand(c, generator=gen, device=dev)
        lam = (17.0 + torch.rand(c, generator=gen, device=dev)) if clip else (
            torch.log(u) - torch.log1p(-u))
        ws = tuple(w.to(wdt) for w in (
            0.02 * torch.randn(c, generator=gen, device=dev),
            0.1 * torch.randn(c, generator=gen, device=dev),
            0.02 * torch.randn(c, generator=gen, device=dev),
            0.1 * torch.randn(c, generator=gen, device=dev), lam))
        plan = RG.plan_bwd_chunks(*shape, sms=sms)
        _, _, starts = RG.rglru_gated_with_starts(x, *ws, plan=plan)
        want = RG.rglru_gated_starts_plain(x, *ws, nchunks=plan[0], chunk_len=plan[1])
        starts_err = rel_check(f"rglru_gated {case} chunk starts", [starts], [want],
                               RGLRU_GATED_FP32_REL)
        before = RG.launches_bwd_by_form["gated"]
        got = RG.rglru_gated_bwd(x, *ws, dh, plan=plan, h_starts=starts)
        if RG.launches_bwd_by_form["gated"] != before + 1:
            raise AssertionError(f"rglru_gated_bwd {case}: not counted as a gated launch")
        if not all(torch.equal(a, b) for a, b in zip(got, RG.rglru_gated_bwd(
                x, *ws, dh, plan=plan, h_starts=starts))):
            raise AssertionError(f"rglru_gated_bwd {case}: not bitwise repeatable")
        rel = BWD_REL_TOL[dt]
        err = rel_check(f"rglru_gated_bwd {case}", got,
                        RG.rglru_gated_bwd_plain(x, *ws, dh, nchunks=plan[0], chunk_len=plan[1]),
                        rel)
        binds = None
        if clip:  # the clip binds where 1 - a^2 < 1e-6; there b's path adds nothing to d log_a
            a, _ = RG.rglru_coeffs_plain(x, *ws)
            binds = (1.0 - a.double() ** 2 < 1e-6).float().mean().item()
            if binds < 0.5:
                raise AssertionError(f"rglru_gated_bwd {case}: the clip binds at {binds} only")
        # x and dh read, dx written; the weights read and their gradients
        # written (the chunk starts the design reads count against the bound)
        nbytes = 3 * x.numel() * x.element_size() + 10 * c * ws[0].element_size()
        b_ms, b_by = bound(nbytes, GATED_BWD_OPS_PER_ELEMENT * x.numel(), f32)
        out.append({
            "case": case, "form": "gated", "shape": list(shape), "dtype": str(dt)[6:],
            "weight_dtype": str(wdt)[6:], "plan": {"nchunks": plan[0], "chunk_len": plan[1]},
            "clip_binds_share": binds, "bitwise_repeat": True, "max_abs_err": err,
            "starts_max_abs_err": starts_err, "rel_tol": rel,
            "ms": time_ms(lambda: RG.rglru_gated_bwd(x, *ws, dh, plan=plan, h_starts=starts),
                          flush),
            "plain_ms": time_ms(lambda: RG.rglru_gated_bwd_plain(
                x, *ws, dh, nchunks=plan[0], chunk_len=plan[1]), flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del x, dh, got, starts
    for case, shape, dt in (("ab, the train shape", rg_train, f32),
                            ("ab, T 1001, C 2500", (3, 1001, 2500), bf)):
        a = (0.7 + 0.299 * torch.rand(shape, generator=gen, device=dev)).to(dt)
        b = (0.1 * torch.randn(shape, generator=gen, device=dev)).to(dt)
        dh = torch.randn(shape, generator=gen, device=dev).to(dt)
        plan = RG.plan_bwd_chunks(*shape, sms=sms)
        _, starts = RG.rglru_with_starts(a, b, plan=plan)
        before = RG.launches_bwd_by_form["ab"]
        got = RG.rglru_bwd(a, b, dh, plan=plan, h_starts=starts)
        if RG.launches_bwd_by_form["ab"] != before + 1:
            raise AssertionError(f"rglru_bwd {case}: not counted as an ab launch")
        if not all(torch.equal(p, q) for p, q in zip(got, RG.rglru_bwd(a, b, dh, plan=plan,
                                                                       h_starts=starts))):
            raise AssertionError(f"rglru_bwd {case}: not bitwise repeatable")
        rel = BWD_REL_TOL[dt]
        err = rel_check(f"rglru_bwd {case}", got,
                        RG.rglru_bwd_plain(a, b, dh, nchunks=plan[0], chunk_len=plan[1]), rel)
        # a, b, dh read, da, db written; a few operations an element
        b_ms, b_by = bound(5 * a.numel() * a.element_size(), 6 * a.numel(), f32)
        out.append({
            "case": case, "form": "ab", "shape": list(shape), "dtype": str(dt)[6:],
            "plan": {"nchunks": plan[0], "chunk_len": plan[1]}, "bitwise_repeat": True,
            "max_abs_err": err, "rel_tol": rel,
            "ms": time_ms(lambda: RG.rglru_bwd(a, b, dh, plan=plan, h_starts=starts), flush),
            "plain_ms": time_ms(lambda: RG.rglru_bwd_plain(
                a, b, dh, nchunks=plan[0], chunk_len=plan[1]), flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del a, b, dh, got, starts
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-only", action="store_true",
                    help="run only the profile phases: both serve paths and the train steps "
                         "the checkout trains on a card (no checks, no result)")
    ap.add_argument("--digest-only", action="store_true",
                    help="print only the digest of llama's train-shape flash backward (no "
                         "checks, no result), to compare two checkouts' kernels bit for bit")
    ap.add_argument("--dist-worker", action="store_true",
                    help="run as one rank of the dist_train phase (started by that phase)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"])
    ap.add_argument("--dist-out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.dist_worker:
        return dist_worker(args)

    from repro_torch.kernels import build as KB
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG

    dev = torch.device("cuda")
    card = smi()
    t_start = PHASE_CLOCK["start"] = PHASE_CLOCK["last"] = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = KB.build_library()
    KB.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib.name,
          "ptxas": ptxas_summary(lib.with_suffix(".log").read_text()), "gpu": card})
    if args.digest_only:
        digest_phase(dev)
        return 0
    if args.profile_only:
        from repro_torch.configs import get_config
        from repro_torch.core.mics import CUDA_TRAIN_FAMILIES

        for p in PATHS:
            cfg, _, _, params, prefill_fn, decode_fn, prompt = setup_path(p, dev)
            profile_path(p, cfg, params, prefill_fn, decode_fn, prompt)
            del params
            torch.cuda.empty_cache()
        for tp in TRAIN:  # an older checkout may train fewer families on a card
            if get_config(tp.arch).family in CUDA_TRAIN_FAMILIES:
                train_profile(tp, dev)
                torch.cuda.empty_cache()
        return 0

    # -- 2. the serve paths ----------------------------------------------------
    by_path, launches_by_route = {}, dict.fromkeys(FA.ROUTES, 0)
    launches_by_form = dict.fromkeys(RG.FORMS, 0)
    paged_launches = {}
    for p in PATHS:
        by_path[p.arch], by_route, by_form, int8, paged = serve_path(p, card, dev)
        by_path[f"{p.arch} serve_int8"] = int8[0]
        for r, n in (*by_route.items(), *int8[1].items()):
            launches_by_route[r] += n
        if paged is not None:  # the engine's three runs: fault-free, crash, int8 pools
            checks = paged["checks"]
            runs = {"serve_paged": paged["launches"],
                    "serve_paged crash": checks["crash_replay"]["launches"],
                    "serve_paged int8": checks["int8_engine"]["launches"]}
            for run, n in runs.items():
                by_path[f"{p.arch} {run}"] = n
                paged_launches[f"{p.arch} {run}"] = n["flash_attention"]
                launches_by_route["paged"] += n["flash_attention"]
        for f, n in (*by_form.items(), *int8[2].items()):
            launches_by_form[f] += n

    # -- 3. the train paths ------------------------------------------------------
    train_lines, train_profiles = [], []
    for tp in TRAIN:
        by_path[f"{tp.arch} train"], line = train_phase(tp, card, dev)
        train_lines.append(line)
        launches_by_route["mma"] += line["attention_launches_by_route"]["mma"]
        launches_by_form["gated"] += line["rglru_launches_by_form"]["forward"]["gated"]
        torch.cuda.empty_cache()
        if tp.arch == KNOBS_ARCH:
            knobs_line = train_knobs_phase(tp, card, dev, line)
            train_lines.append(knobs_line)
            by_path[f"{tp.arch} train_knobs"] = knobs_line["launches"]
            launches_by_route["mma"] += knobs_line["attention_launches_by_route"]["mma"]
            launches_by_form["gated"] += knobs_line["rglru_launches_by_form"]["forward"]["gated"]
        train_consistency_phase(tp, dev)
        torch.cuda.empty_cache()
        train_profiles.append(train_profile(tp, dev))
        torch.cuda.empty_cache()

    # -- 3b. the MiCS step over 4 ranks -------------------------------------------
    dist_line = dist_train_phase(card, dev, train_lines[0])
    by_path[dist_line["arch"]] = dist_line["launches"]
    by_path["dist_wires"] = dist_line["wires_launches"]
    by_path["dist_elastic"] = dist_line["elastic_launches"]
    launches_by_route["mma"] += dist_line["attention_launches_by_route"]["mma"]
    launches_by_form["gated"] += dist_line["rglru_launches_by_form"]["forward"]["gated"]
    torch.cuda.empty_cache()

    def train_sum(*keys: str) -> dict:
        """A train line's launches by route (or form) under ``keys``, summed
        over the train paths and the dist_train phase."""
        out = {}
        for line in (*train_lines, dist_line):
            table = line
            for key in keys:
                table = table[key]
            for r, n in table.items():
                out[r] = out.get(r, 0) + n
        return out

    # -- 4. kernels against their plain versions, timed ---------------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    digest_phase(dev)
    rms_bwd_checks, attn_bwd_checks, rglru_bwd_checks = backward_checks(gen, dev, flush)
    rms_checks, attn_checks, rglru_checks = kernel_checks(gen, dev, flush)
    paged_checks = paged_kernel_checks(gen, dev, flush)
    quantize_checks, dequantize_checks = quant_checks(gen, dev, flush)

    def entry(name, source, replaces, checks, by_path_n=None, **more):
        """``by_path_n``: the kernel's launches by path where its counter is
        not ``name``'s (a route of it)."""
        main = checks[0]  # the path's main shape
        per_path = by_path_n or {arch: n[name] for arch, n in by_path.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(per_path.values()), "launches_by_path": per_path,
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                **more, "checks": checks}

    emit({"kernels": [
        entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:28", rms_checks),
        entry("rmsnorm_bwd", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
              "src/repro/kernels/rmsnorm/kernel.py:28", rms_bwd_checks,
              gradient_of="src/repro/models/layers.py:62 rms_norm (the TPU kernel has no "
                          "backward)",
              sources={"regs": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                       "smem": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu"},
              launches_by_route=train_sum("rmsnorm_bwd_launches_by_route")),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
              "src/repro/kernels/flash_attention/kernel.py:86", attn_checks,
              sources={"mma": "src/repro_torch/kernels/csrc/flash_attention_mma.cu",
                       "split": "src/repro_torch/kernels/csrc/flash_attention_split.cu",
                       "fma": "src/repro_torch/kernels/csrc/flash_attention.cu",
                       "paged": "src/repro_torch/kernels/csrc/flash_attention_paged.cu"},
              launches_by_route=launches_by_route),
        # the paged route alone (the continuous-batching engine): its checks,
        # a decode tick first; its launches the serve_paged runs'
        entry("flash_attention_paged", "src/repro_torch/kernels/csrc/flash_attention_paged.cu",
              "src/repro/kernels/flash_attention/kernel.py:86", paged_checks,
              by_path_n=paged_launches,
              merge="src/repro_torch/kernels/csrc/flash_attention_split.cu flash_merge_kernel",
              call_site="src/repro/models/blocks.py:183-186 (L.attention over the paged view)"),
        entry("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
              "src/repro/kernels/flash_attention/kernel.py:86", attn_bwd_checks,
              gradient_of="src/repro/models/layers.py:145 attention (the TPU kernel has no "
                          "backward)",
              sources={"wgmma": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
                       "wgmma256": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma256.cu",
                       "mma": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                       "fma": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                       "delta (every route)":
                           "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
              device_ms_by_launch={line["arch"]: line.get("flash_bwd_ms_per_launch")
                                   for line in train_profiles},
              launches_by_route=train_sum("attention_bwd_launches_by_route")),
        # the dh-256 route alone: its checks first, its launches the train
        # paths' on it, mma's time on the same inputs beside it
        entry("flash_attention_bwd_wgmma256",
              "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma256.cu",
              "src/repro/kernels/flash_attention/kernel.py:86",
              [c for c in attn_bwd_checks if c["route"] == "wgmma256"],
              by_path_n={**{f"{line['arch']} {line['phase']}":
                            line["attention_bwd_launches_by_route"]["wgmma256"]
                            for line in train_lines},
                         "dist_train": dist_line["attention_bwd_launches_by_route"]["wgmma256"]},
              gradient_of="src/repro/models/layers.py:145 attention at head dim 256",
              mma_ms=next(c["mma"]["ms"] for c in attn_bwd_checks if "mma" in c)),
        entry("rglru", "src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru/kernel.py:47", rglru_checks,
              launches_by_form=launches_by_form),
        entry("rglru_bwd", "src/repro_torch/kernels/csrc/rglru_bwd.cu",
              "src/repro/kernels/rglru/kernel.py:47", rglru_bwd_checks,
              gradient_of="src/repro/models/recurrent.py:92 rglru_scan after :77 "
                          "_rglru_coeffs (the TPU kernel has no backward)",
              launches_by_form=train_sum("rglru_launches_by_form", "backward")),
        # no TPU kernel: the reference's jnp quantizer, which XLA fuses
        entry("quantize", "src/repro_torch/kernels/csrc/quant.cu",
              "src/repro/core/quant.py:54 quantize_flat (jnp, no Pallas kernel)",
              quantize_checks, eager_ms=quantize_checks[0]["eager_ms"]),
        entry("dequantize", "src/repro_torch/kernels/csrc/quant.cu",
              "src/repro/core/quant.py:85 dequantize_flat (jnp, no Pallas kernel)",
              dequantize_checks, eager_ms=dequantize_checks[0]["eager_ms"]),
    ], "phase": "kernels"})
    emit({"phase_seconds": PHASE_CLOCK["lines"], "script_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
