"""Drive the PyTorch port's serve path and its training step for the model
families it builds (dense, griffin, MoE, xLSTM, the VLM backbone,
enc-dec, the paper's LayerNorm + GeLU models) on one
NVIDIA card; hold every CUDA kernel against its plain PyTorch version.

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
   the ``paged`` route against its plain version at the engine's shapes
   over bf16 and int8 pages (dead rows exactly zero); a run with an engine crash at
   tick 20 whose completions are the fault-free run's bit for bit; a run
   on int8 pools (its ledger, its share of tokens equal to bf16's); each
   run's launches, set to 0 just before it and read just after: per engine
   step RMSNorm 33 and attention 16, every call on ``paged`` (``split`` and
   ``mma`` 0) and its ``wgmma`` body, ``quantize`` 32 with int8 pools.  It prints ticks, wall
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
3a'. ``serve_moe``: deepseek-moe-16b (64 experts, top 6, 2 shared) at full
   width cut to 4 layers, ``init_params(seed=0)``, bf16 gather: the fixed
   batch through ``build_serve_steps`` (batch 4, prompt 512, 16 greedy
   steps: prefill on ``mma``, decode on ``split``; RMSNorm 9 and attention
   4 a forward), the share of routed assignments the capacity dropped at
   prefill and at decode; the engine (``MOE_PAGED``: 8 slots, chunks of 64,
   8 requests of 64-256 prompt tokens and 16 new, bf16 pools; every call
   on ``paged:wgmma``), its ticks, tokens/s, step ms (timed with no spy;
   the drops from an untimed rerun that must give the same tokens), a
   profiled decode tick's idle share; a crash at tick 6 run twice (the two
   replays bitwise equal; each request's tokens equal to the fault-free
   run's up to its first row with a dropped assignment in either run: a
   replayed prefill meets other rows, and capacity drops make a row depend
   on them; the shares held and equal reported); paged == contiguous bit
   for bit on the same rows (chunk placement is not checked, for the same
   reason); one MoE layer at full width on 64 tokens against fp32 on the
   CPU (the picks first, then the outputs of the tokens routed alike).
   ``train_moe``: the same model cut to 2 layers through
   ``build_train_step``, 3 steps of 2 micro-steps of 2 x 2048 tokens,
   step 1 against its gradients with fp32 compute (``MOE_FP32_REL_TOL``:
   loss, grad norm, and the worst segment's gradient norm; two faults, the
   routed experts' gradients left out and every routed assignment dropped,
   read in the same run and caught by the limits), the counts a micro-step (RMSNorm 9 + backward 5 on ``regs``, attention
   4 on ``mma`` + backward 2 on ``wgmma``), MFU on the active parameters.
   ``serve_paged`` runs a fourth engine, on fp32 pools (``FP32_PAGED``'s
   shorter trace; every call on ``paged:fma``): paged == contiguous over
   fp32 caches bit for bit, the bf16 pools' logits within
   ``FP32_POOL_REL_TOL`` of the fp32 pools', a crash replay bitwise.
3b. ``dryrun``: ``launch/dryrun.run_cell`` on the card, llama3.2-1b as rank
   0 of the reference's 16 x 16 world at tp 16 (p 1, 16 replicas) over a
   fake process group that moves no data: ``train_4k`` (4 micro-steps of 4 x
   4,096) and ``decode_32k`` (8 rows at position 32,767), full width, each
   counted op by op (``roofline/op_stats.py``); the rank's peak within
   ``CARD_PLAN_RTOL`` of the plan and its reserve within the plan's, the
   census's calls ``predict_traffic``'s, the hop-2 collectives the bucket
   plan's, the counted products within ``DRYRUN_FLOPS_RTOL`` of the
   config's (``roofline/analysis.dense_rank_dot_flops``: the rank's
   matrices with the KV heads it shares, the layers' recompute, attention
   over the visible pairs) and the kernels' reported products within it of
   that attention.  Then ``dist_train``: 4 ranks, each a process of this
   script (``--dist-worker``) started with ``torchrun``'s variables, through
   ``launch/mesh.init_distributed`` / ``MiCSGroups`` and
   ``runtime/train_loop.train``, the ``train`` phase's data, seed, rows a
   micro-step (llama: 4 ranks x 1 x 2048, one micro-step) and OptConfig,
   prefetch, bucketed boundary, 2 steps, then each rank's checkpoint shards
   (written, timed and removed).  With fewer than 4 cards the ranks share card 0 and
   the collectives run over gloo through pinned host buffers (NCCL refuses
   two ranks on one card): a correctness rehearsal, not a MiCS speed; with
   4 or more cards, over NCCL, one card a rank.  Each layout is held to a
   one-card run of its cut model on the same weights and batches (step 1:
   loss 2e-3, grad norm 2e-2 relative; step 2: 2%).  Layout A: p 4, the
   paper's ``outer_first`` gather with inner 2, llama at 4 layers.  Layout
   B: p 2 x 2 replicas (hop 2 and the bucketed boundary across replicas) at
   4 layers.  Tensor parallelism: layout C, llama3.2-1b at 4 layers over p 2
   x tp 2; layout D, recurrentgemma-2b cut to one (rec, rec, attn) super-layer over tp 4
   (2 of the griffin path's micro-steps of 2 x 2048 on every rank).  Layout E: deepseek-moe-16b at full width
   cut to one layer over tp 4 (16 experts a rank, each rank routing 1024
   of a micro-step's 4096 tokens, the expert exchange over the model
   group), 2 steps of ``train_moe``'s batches, against a one-card run of
   that model within the reference's ``moe_tp_equiv`` tolerance (rtol
   0.03, atol 0.05).  C, D and E start from their model's weights at tp 1
   cut by ``convert.tp_params_from_full`` (the loop resumes from a step-0
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
3e. ``dist_serve``: serving over ranks, run by the same 4 worker processes
   after the elastic loop.  (a) The continuous-batching engine through
   ``runtime/resilient.ResilientServeLoop`` on llama3.2-1b at full width
   cut to 4 layers from layout C's topology (p 2 x tp 2, dp 2;
   ``elastic_host_topology(4, 2, tp 2)``), its tp 1 ``init_params(seed=0)``
   cut by ``tp_params_from_full`` and each rank's shard by
   ``shard_params``, bf16 gather and pools, 4 slots a data rank, chunks of
   64, blocks of 16, 8 requests from seed 0 (prompts 64-256, 8 new
   tokens, the odd ones at temperature 0.7 with top-k 8), one every 2
   ticks: fault-free on 4 ranks, fault-free on 2 (ranks 2-3 parked, p 1 x
   tp 2) and with ``preempt@6x2`` (ranks 2-3 lost abruptly at tick 6).
   Every run's ledger accounted and its completions bitwise the 4-rank
   run's, on every rank; the preemption's ledger; each rank's launches an
   engine step it ran RMSNorm 9 and attention 4, every call on
   ``paged:wgmma``; the 4-rank run's collectives a step (the partition
   gather of 6 rows, 11 model gathers, 8 model psums, the sampler's pmax
   and pmin, the token gather over the data group); the first tick's logit
   rows of rank 0, gathered over the model group, against data rank 0's
   rows through a one-card tp 1 paged step on the same cut weights and
   inputs, within ``DIST_SERVE_REL_TOL`` of the largest |logit|, greedy
   tokens equal where the one-card top-1 margin exceeds twice that.  (b)
   The fixed batch through ``build_serve_steps`` on layout D's groups
   (recurrentgemma-2b, 3 layers, tp 4): batch 4, prompt 512, 8 greedy
   decode steps, every step's logits held to a one-card run of the same
   cut model fed the same tokens under the same rule; launches 9 forwards
   x (RMSNorm 7, attention 1: ``mma`` at the prefill, ``split`` at each
   decode step; RG-LRU 2, gated).  It prints each run's ticks, engine
   steps, wall seconds and step times, the comparisons and the counts.
3f. xlstm-125m and the VLM backbone on one card, after the dist phases.
   ``serve_xlstm``: xlstm-125m at full width and depth (12 blocks: pool
   ``x`` x3 of three mLSTM blocks and one sLSTM block; 0.2 B parameters),
   ``init_params(seed=0)``, bf16 gather, ``mlstm_chunk`` 0 (the reference's
   serving default: the prompt through the timestep scan): batch 4, prompt
   512, 32 greedy decode steps; RMSNorm 28 a forward and no other kernel;
   the prefill of T - 1 tokens then one decode step against the prefill of
   T (the state hand-off), the prefill at ``mlstm_chunk`` 64 against the
   scan's, one mLSTM and one sLSTM block at full width against fp32 on the
   CPU; a profiled prefill and decode step.  ``train_xlstm``:
   ``build_train_step`` on the same model, 1 step of 2 micro-steps of 2 x
   1024 tokens, ``mlstm_chunk`` 64 (RMSNorm 28 + 27 recomputed, its
   backward 28 on ``regs``, a micro-step), MFU on 6 N (the recurrences' own
   operations left out), a micro-step profiled at 2 x 256 and 2 x 512 (its
   device kernels, a line through them to 2 x 1024); ``train_xlstm_probe``:
   step 1's gradients by segment against fp32 compute
   (``XLSTM_FP32_REL_TOL``) and two faults the limits must catch (the
   sLSTM's recurrent matrices given zero gradient; the mLSTM's chunk carry
   dropped).  ``serve_vlm``: llama-3.2-vision-90b at full width cut to one
   super-layer (4 self-attention layers, 1 gated cross layer; ≈ 6.4 B
   parameters), both gates set to 1.0 (zero at init: the layer is then the
   identity), the launcher's stub batch (``launch/serve.stub_batch``:
   batch 4, prompt 512, vision rows [4, 1024, 8192] bf16), 16 greedy decode
   steps; a forward RMSNorm 11 and attention 5 (the cross layer's on
   ``mma`` at the prefill, over the cached vision K/V on ``split`` at each
   decode step); the hand-off across the cached cross K/V; the cross layer
   at full width (64 tokens over the 1,024 vision rows) against fp32
   compute on the card (``fma``); a profiled decode step.
3g. whisper-large-v3 and the paper's models, after the VLM.
   ``serve_whisper``: whisper at full width and depth (32 encoder and 32
   decoder layers, 1.646 B parameters), the launcher's stub batch (batch
   4, prompt 64, audio frames [4, 1500, 1280] bf16), 32 greedy decode
   steps: attention 96 on ``mma`` at the prefill (the encoder's
   non-causal self-attention, the decoder's self and cross), 64 on
   ``split`` a decode step (self, and cross over the cached encoder K/V),
   no RMSNorm; the hand-off; the cross caches' shape; encoder layer 0 and
   decoder layer 0 against fp32 compute on the card; a profiled decode
   step and prefill.  ``serve_bert``: the paper's bert-10b at full depth
   (127 layers, 40.6 GB of fp32 rows; batch 4, prompt 512, 16 steps),
   then bert-50b cut to 2 layers at the same shapes, every attention call
   through the padded route (dh 204 to 256; ``layers.launches_padded``
   counts them), and the paged engine at that head dim (its pools stored
   at 256): 4 steps at ragged lengths, paged == contiguous bit for bit,
   int8 pools against bf16 ones.  ``train_whisper``: ``build_train_step`` at full width and
   depth, 3 steps of 2 micro-steps of 2 x (1,500 frames + 448 tokens)
   (attention 192 on ``mma`` and 96 backward on ``wgmma`` a micro-step),
   MFU from ``encdec_train_flops``; ``train_whisper_probe``: step 1's
   gradients by segment, the encoder's included, against fp32 compute
   (``WHISPER_FP32_REL_TOL``) and a fault the limits must catch (the
   encoder's gradient zeroed).  ``train_bert``: bert-10b cut to 16
   layers, 3 steps of 2 micro-steps of 4 x 512.
4. ``kernels``: each kernel at the paths' shapes against its plain version
   on the same inputs, with its time, the plain version's, one PyTorch
   library call's where there is one, and the card's bound for the same
   work; ``launches`` sums the serve runs, the train runs, the
   ``train_knobs`` variants and every rank of ``dist_train``, ``dist_wires``,
   ``dist_elastic`` and ``dist_serve``.  Attention also
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
   shapes (8 requests at lengths 250-350: the engine's decode-only tick,
   64 rows a slot of which one is live; a mixed tick, 2 slots prefilling a
   chunk, 5 decoding, 1 idle; a 64-token chunk; a one-row decode tick;
   bf16 and int8 pages), its bound from the live rows' keys, with SDPA
   over the live rows and the contiguous view gathered beforehand as
   ``library_ms``; and at a rank's shapes of ``dist_serve``'s engine (4
   slots, 17 blocks of 16 a table) with llama's KV heads over tp 2 and 4
   (4 and 2 heads a rank), bf16 pages.  The ``split`` decode at a rank's
   shapes: llama at tp 2 and 4, recurrentgemma at tp 4 (one KV head of g 3
   at dh 256, ``dist_serve``'s fixed batch; its prefill on ``mma`` too).
   The ``paged`` route's ``fma`` body (fp32 pages) at ``serve_paged``'s
   shapes under bf16 and fp32 queries, SDPA over the gathered fp32 view as
   ``library_ms``; the heads of the models this slice adds at dh 128
   (``NEW_ATTN_SHAPES``): deepseek's (16 KV heads, g 1) timed through
   ``mma`` prefill, ``split`` decode, the ``paged`` engine shapes and the
   ``wgmma`` backward, and dbrx's (g 6: its backward on ``mma``),
   granite's (g 4), yi's and qwen's (g 8) the same routes as correctness
   checks, with RMSNorm at dbrx's d 6144.  The VLM's cross attention,
   non-causal over a key length of its own (1,024 vision keys, hkv 8, g 8,
   dh 128): the prefill on ``mma``, the decode step on ``split``, a train
   micro-step's forward on ``mma`` and its backward on ``wgmma`` (tq 2048,
   tk 1024), and a ragged non-causal edge (tq 300, tk 1000) forward and
   backward on ``wgmma`` (g 4) and ``mma`` (g 3); RMSNorm forward and
   backward at xLSTM's d 768 and 1536 and the VLM's 8192.  whisper's
   attention at g 1 (20 KV heads, dh 64): the encoder's non-causal 1,500 x
   1,500 (a ragged last tile on both axes) forward at serve_whisper's
   batch and backward at train_whisper's, the cross prefill (64 over
   1,500 keys), the decode step over them on ``split``, the train cross
   (448 over 1,500) forward and backward, the decoder's causal
   self-attention prefill (64) and decode step (over 96); the paper's
   causal T 512 at 40 heads of g 1: bert-10b (dh 64) and bert-20b (dh 128)
   forward and backward, serve_bert's decode steps over 528 keys (bert-10b's
   first and last, b hkv = 160 KV streams), bert-50b's dh 204 through the
   model's call site ``layers.attention``, which pads (the prefill on
   ``mma`` and the decode step on ``split`` at 256; the forward and the
   ``wgmma256`` backward through ``FlashAttentionFn`` and autograd, with
   the pad and the cut timed), and the ``paged`` route at bert-50b's
   engine pools (40 KV heads of g 1 at 256, bf16 and int8 pages) as
   correctness checks.

The memory planner and the autotuner (``core/memplan.py``,
``core/autotune.py``) on the card: every one-card train run (``train``,
each ``train_knobs`` variant, ``train_moe``, ``train_xlstm``,
``train_whisper``, ``train_bert``) carries a ``memplan`` record, the
planner's footprint at the run's shapes by component beside its peak and
reserve, and checks that the plan's state bytes are exactly the tensors
``init_state`` made (``memory_allocated`` after it less before it printed
beside) and that the plan (the largest of its moments: the loss's
backward, the largest row's backward, the boundary) is within ``MEM_RTOL``
and the card's ``CARD_PLAN_RTOL`` of the peak and its reserved bytes
(``RESERVE_FACTOR`` x the plan, and xLSTM's excess at its moment,
``MemPlan.reserve_excess``) hold the allocator's.
``train_knobs`` gains the variant ``auto`` (``policy="auto"`` under the
card's whole memory in GiB, gated at the run's batch: the chosen config
printed, bitwise the ``train`` phase, its peak and reserve under the
budget; a budget below the smallest candidate and one between the
states-only plan and the remat run's reserve refused with
``MemoryBudgetError`` before anything is allocated);
``serve_paged`` an ``auto`` engine run on its first 8 requests (the KV
dtype and residency the planner picks, bitwise the manual engine at that
KV dtype, the serve plan beside the peak); ``dist_train`` prints the
autotuner's census by stage for layouts A-E beside the ranks'
``CommCounter`` (calls equal); ``host_link`` fits pinned copies each way
at 64 MiB and 1 GiB beside the card profile's host tier.

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
# train_moe and dist_train's layout E: deepseek-moe-16b at full width, 2
# micro-steps of 2 x 2048 tokens a step (4096 a micro-step: two dispatch
# chunks of 2048, 240 slots an expert).  Its launches a micro-step at the
# train_moe phase's 2 layers (``train_launches``): RMSNorm 5 forward + 4
# recomputed and 5 backward, all on ``regs`` (d 2048); attention 2 + 2 on
# ``mma`` and 2 backward on ``wgmma`` (dh 128, g 1 divides 64).
MOE_TRAIN_LAYERS = 2
MOE_TRAIN = TrainPath("deepseek-moe-16b", 4, 2, 2048, 3,
                      {"rmsnorm": 9, "rmsnorm_bwd": 5, "flash_attention": 4,
                       "flash_attention_bwd": 2, "rglru": 0, "rglru_bwd": 0, "quantize": 0,
                       "dequantize": 0},
                      "wgmma", "regs", MOE_TRAIN_LAYERS, 256)
# train_moe's step 1 (bf16 compute) against the same step with fp32 compute
# on the card (the fma routes), relative: bf16 rounds every activation and
# weight, and a token whose router margin is under bf16's rounding may take
# another expert or another token's slot.  ``leaf_norm``: the worst
# segment's gradient norm over its pool's rows (``moe_grad_probe``).  On an
# H100 the sound gaps read 3.0e-5 (loss), 1.2e-4 (grad norm) and 2.2e-3
# (a norm scale's segment); the probe's two faults 3.0e-5 / 4.6e-5, 1.5e-2
# / 2.5e-2 and 1.0: the grad norm's and the segments' limits sit about ten
# times over the sound gap and ten and fifty times under the faults, each
# fault must exceed one of them.  The loss at init is near ln V whatever
# the experts do, so its limit only bounds the precision.
MOE_FP32_REL_TOL = {"loss": 3e-4, "grad_norm": 1.5e-3, "leaf_norm": 2e-2}
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
    from repro_torch.models import layers as L

    for mod, attr in counter_attrs().values():
        setattr(mod, attr, 0)
    L.launches_padded = 0
    for table in (FA.launches_by_route, FA.launches_bwd_by_route, FA.launches_paged_by_form,
                  RG.launches_by_form, RG.launches_bwd_by_form, RN.launches_bwd_by_route,
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
            elif "wgmma" in kernel:  # <dh, stages[, rows a tile]>
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


def time_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
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
                ("gemm", "GEMM"), ("layer_norm_grad", "LayerNorm backward"),
                ("GammaBeta", "LayerNorm backward"), ("layer_norm", "LayerNorm"),
                ("Gelu", "GeLU"),
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
    decode_lens: tuple = (249, 350)   # the kernel cases' decode lengths (lo, hi)


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


def paged_kernel_cases(gen, dev, pg: PagedServe = PAGED, hkv: int = 8,
                       label: str = "", dtypes=("bf16", "int8"), g: int = 4,
                       dh: int = 64) -> list:
    """The ``paged`` route's inputs at the phase's shapes: llama's 8 KV heads
    of g 4 at dh 64, a pool of ``slots * max_blocks + 1`` blocks of
    ``block`` tokens, 8 requests on shuffled blocks, over bf16 and int8
    pages (``hkv`` KV heads: a rank's of them over ranks, ``label`` naming
    it; ``g`` and ``dh`` another model's heads; ``dtypes`` may add fp32
    pages, each case of them under bf16 and fp32 queries).  First the shape
    the engine launches most: a decode-only tick at the chunk width, each
    slot's row 0 live (valid lengths ``decode_lens``: 250-350 at the
    phase's) and its 63 others dead (length 0); then a mixed tick (the
    first quarter of the slots a whole chunk at chunk starts, the last one
    idle, the others decoding a row: 2, 1 and 5 of 8), a 64-token chunk
    (every row live, positions at chunk starts) and a one-row decode
    tick."""
    from repro_torch.core import quant as Q

    b, w = pg.slots, pg.chunk
    nb = pg.slots * pg.max_blocks + 1
    cap = pg.max_blocks * pg.block
    order = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(2)) + 1
    tables = order[:b * pg.max_blocks].reshape(b, pg.max_blocks).to(torch.int32).to(dev)
    k = torch.randn(nb, pg.block, hkv, dh, generator=gen, device=dev)
    v = torch.randn(nb, pg.block, hkv, dh, generator=gen, device=dev)
    pages = {"bf16": ((k.to(torch.bfloat16), v.to(torch.bfloat16)), {})}
    (qk, sk), (qv, sv) = Q.quantize_flat(k), Q.quantize_flat(v)
    pages["int8"] = ((qk, qv), {"k_scale": sk, "v_scale": sv})
    pages["fp32"] = ((k, v), {})
    rows = torch.arange(1, w + 1, device=dev)[None, :]
    decode_pos = torch.randint(*pg.decode_lens, (b,), generator=gen, device=dev)
    chunk_pos = w * torch.randint(0, cap // w - 1, (b,), generator=gen, device=dev)
    n_new = torch.tensor([w] * (b // 4) + [1] * (b - b // 4 - 1) + [0], device=dev)
    mixed_pos = torch.where(n_new == w, chunk_pos, decode_pos)
    lengths = {
        "engine decode-only tick": torch.where(rows == 1, decode_pos[:, None] + rows, 0),
        "mixed tick": torch.where(rows <= n_new[:, None], mixed_pos[:, None] + rows, 0),
        f"{w}-token chunk": chunk_pos[:, None] + rows,
        "decode tick, one row": decode_pos[:, None] + 1,
    }
    cases = []
    for kind, kvl in lengths.items():
        q = torch.randn(b, kvl.shape[1], hkv, g, dh, generator=gen, device=dev)
        for dt in dtypes:
            (kp, vp), sc = pages[dt]
            for qdt in (("bf16", "fp32") if dt == "fp32" else ("bf16",)):
                cases.append((f"{label}{kind}, {dt} pages" + (f", {qdt} q" if dt == "fp32"
                                                               else ""),
                              q.to(_pool_dtype(qdt)), kp, vp, tables, kvl, sc))
    return cases


def paged_kernel_checks(gen, dev, flush, timed: bool = True,
                        pg: PagedServe = PAGED, hkv: int = 8, label: str = "",
                        dtypes=("bf16", "int8"), g: int = 4, dh: int = 64) -> list:
    """The ``paged`` route against ``paged_attention_plain`` on the same
    card tensors (the split route's bf16 tolerance), dead rows exactly
    zero, bitwise repeatable; with ``timed`` its time, the plain
    version's, the bound (the keys and values the live rows see, their
    scales, the live rows of q and o, against 3.35 TB/s; 4 dh operations
    an allowed (row, key) pair) and, as ``library_ms``, SDPA over the live
    rows alone (one call a live-row count: the decode-only tick's q is
    [b, 1, ...]; the mixed tick's two calls, its prefilling and its
    decoding slots) against the contiguous view gathered (and dequantized)
    beforehand with the same boolean mask: the gather is not in its time."""
    import torch.nn.functional as F

    from repro_torch.core import quant as Q
    from repro_torch.kernels.flash_attention import kernel as FA

    out = []
    for kind, q, kp, vp, tables, kvl, sc in paged_kernel_cases(gen, dev, pg, hkv, label,
                                                               dtypes, g, dh):
        o = FA.paged_attention(q, kp, vp, tables, kvl, **sc)
        ref = FA.paged_attention_plain(q, kp, vp, tables, kvl, **sc)
        fp32 = kp.dtype == torch.float32     # the fma body: fp32 scores and out
        tol = TOL[torch.float32 if fp32 else torch.bfloat16]
        err = (o.float() - ref.float()).abs().max().item()
        if not torch.allclose(o.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"paged attention {kind}: kernel disagrees with its plain "
                                 f"version (max |err| {err}, tol {tol})")
        if not torch.equal(o, FA.paged_attention(q, kp, vp, tables, kvl, **sc)):
            raise AssertionError(f"paged attention {kind}: not bitwise repeatable")
        dead = kvl == 0
        if o[dead].any():
            raise AssertionError(f"paged attention {kind}: a dead row is not zero")
        b, tq, hkv, g, dh = q.shape
        bs, cap = kp.shape[1], tables.shape[1] * kp.shape[1]
        n_live = (~dead).sum(dim=1)
        row = {"case": kind, "shape": {"b": b, "tq": tq, "hkv": hkv, "g": g, "dh": dh,
                                       "block_size": bs, "max_blocks": tables.shape[1],
                                       "n_blocks": kp.shape[0]},
               "route": "paged", "body": FA.paged_body(dh, kp.dtype),
               "pages": str(kp.dtype)[6:].replace("float32", "fp32").replace("bfloat16", "bf16"),
               "q_dtype": str(q.dtype)[6:],
               "bitwise_repeat": True, "dead_rows_zero": True, "max_abs_err": err, "tol": tol,
               "live_rows": int(n_live.sum()), "dead_rows": int(dead.sum()),
               "valid_len": [int(kvl[~dead].min()), int(kvl.max())]}
        if timed:
            live = torch.clamp(kvl.max(dim=1).values, max=cap).sum().item()  # keys read a head
            per_key = hkv * dh * kp.element_size() + (hkv * 4 * -(-dh // 128) if sc else 0)
            nbytes = 2 * live * per_key + int(n_live.sum()) * hkv * g * dh * (
                q.element_size() + o.element_size())
            ops = 4 * dh * hkv * g * torch.clamp(kvl, max=cap).sum().item()
            b_ms, b_by = bound(nbytes, ops, torch.float32 if fp32 else torch.bfloat16)

            def view(p):
                return p[tables.long()].reshape(b, cap, *p.shape[2:])

            kv = [view(kp), view(vp)]
            if sc:
                kv = [Q.dequantize_flat(kv[0], view(sc["k_scale"]), torch.bfloat16),
                      Q.dequantize_flat(kv[1], view(sc["v_scale"]), torch.bfloat16)]
            ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in kv)
            calls = []  # SDPA over the live rows: a call a live-row count (a prefix a slot)
            for n in sorted(set(n_live.tolist()) - {0}):
                idx = torch.nonzero(n_live == n).flatten()
                if not bool((kvl[idx, :n] > 0).all()):
                    raise AssertionError(f"paged attention {kind}: live rows not a prefix")
                qs = q[idx, :n].permute(0, 2, 3, 1, 4).reshape(len(idx), hkv * g, n, dh).to(
                    ks.dtype)
                mask = (torch.arange(cap, device=dev)[None, None, :] < kvl[idx, :n, None])
                calls.append((qs.contiguous(), ks[idx], vs[idx], mask[:, None]))
            row.update({
                "ms": time_ms(lambda: FA.paged_attention(q, kp, vp, tables, kvl, **sc), flush),
                "host_us": host_us(lambda: FA.paged_attention(q, kp, vp, tables, kvl, **sc)),
                "plain_ms": time_ms(lambda: FA.paged_attention_plain(q, kp, vp, tables, kvl,
                                                                     **sc), flush),
                "bound_ms": b_ms, "bound_by": b_by, "live_keys": live,
                "library_ms": time_ms(lambda: [F.scaled_dot_product_attention(
                    *c[:3], attn_mask=c[3], enable_gqa=True) for c in calls], flush),
                "library_calls": len(calls),
                "library_excludes": "the gather (and dequantize) of the contiguous view"})
            del ks, vs, kv, calls
        out.append(row)
    return out


def paged_consistency(cfg, model, params, dev, pg: PagedServe = PAGED, kv: str = "bf16",
                      other: str | None = "int8", rel_tol: float = PAGED_INT8_REL_TOL,
                      placement: bool = True) -> dict:
    """Within the port on the card, on ``check_rows`` of the trace's
    prompts, each prefilled at its own length: (a) paged == contiguous, bit
    for bit: the pool of ``kv`` pages filled by ``pages_from_contiguous``,
    ``check_steps`` decode steps (one token a slot, every row live) through
    ``build_paged_step`` and through ``build_contiguous_step`` over a
    contiguous cache of the same dtype (greedy and sampled rows), tokens and
    logits; (b) ``other`` pools (int8 against bf16, or bf16 against fp32),
    fed the same tokens: the decode logits within ``rel_tol`` of the
    largest |logit|, and the share of equal tokens; (c) with ``placement``,
    chunk placement: the prompts streamed through the chunk-width step from
    position 0 and from staggered first chunks give the same last tokens,
    logits and pool, bit for bit (not for MoE: a chunk's capacity drops
    make a row depend on the rows beside it, ROADMAP Queue 3)."""
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
    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True, kv_block_size=pg.block,
                      kv_dtype=kv)
    prefill_fn, _ = build_serve_steps(model, topo, mcfg, cap, device=dev)
    contig = lm.init_caches(model, n, cap, device=dev,
                            dtype=torch.float32 if kv == "fp32" else torch.bfloat16)
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
    pools, steps = {}, {}
    for d in (kv, other) if other else (kv,):
        pools[d] = PG.init_paged_caches(model, topo, alloc.n_blocks, pg.block, d, device=dev)
        PG.pages_from_contiguous(model, topo, contig, pools[d], tables, plens,
                                 block_size=pg.block, kv_dtype=d)
        steps[d] = PG.build_paged_step(model, topo, dataclasses.replace(mcfg, kv_dtype=d),
                                       max_blocks=pg.max_blocks, block_size=pg.block,
                                       top_k=pg.top_k, device=dev)
    contig_step = PG.build_contiguous_step(model, topo, mcfg, cap, top_k=pg.top_k, device=dev)
    seeds = torch.arange(n, device=dev) + 1000
    temps = torch.tensor([0.0, pg.temperature] * (n // 2), device=dev)
    ones = torch.ones(n, dtype=torch.long, device=dev)
    pos = torch.as_tensor(plens, device=dev)
    tp, tc = tok0, tok0
    bitwise, err8, scale, same8 = True, 0.0, 0.0, 0
    for s in range(pg.check_steps):
        t1, l1, pools[kv] = steps[kv](params, pools[kv], tp[:, None], pos + s, ones, tables,
                                      seeds, temps)
        t2, l2, contig = contig_step(params, contig, tc[:, None], pos + s, seeds, temps)
        bitwise &= torch.equal(t1, t2) and torch.equal(l1, l2)
        scale = max(scale, l1.float().abs().max().item())
        if other:
            t8, l8, pools[other] = steps[other](params, pools[other], tp[:, None], pos + s,
                                                ones, tables, seeds, temps)
            err8 = max(err8, (l8.float() - l1.float()).abs().max().item())
            same8 += int((t8 == t1).sum())
        tp, tc = t1, t2
    if not bitwise:
        raise AssertionError(f"serve_paged {cfg.name} {kv}: paged decode differs from the "
                             "contiguous step")
    if not err8 <= rel_tol * scale:
        raise AssertionError(f"serve_paged {cfg.name}: {other} pools' logits {err8} > "
                             f"{rel_tol} x {scale} from the {kv} pools'")
    del pools, contig
    out = {"paged_vs_contiguous": {"rows": n, "decode_steps": pg.check_steps, "kv_dtype": kv,
                                   "prompt_lens": plens.tolist(),
                                   "tokens_and_logits_bitwise": True}}
    if other:
        out[f"{other}_kv"] = {"against": kv, "max_abs_err": err8, "max_abs_logit": scale,
                              "rel_tol": rel_tol, "tokens_equal_share":
                              same8 / (n * pg.check_steps)}
    if not placement:
        return out

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
    return {**out, "chunk_placement": {"first_chunks": [pg.chunk, f"1 + 7 b mod {pg.chunk}"],
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
    # the kernel on the phase's shapes, before the engine runs
    kernel = paged_kernel_checks(torch.Generator(device=dev).manual_seed(3), dev, None,
                                 timed=False, pg=pg)
    consistency = paged_consistency(cfg, model, params, dev, pg)
    torch.cuda.empty_cache()

    rep, reqs, clock, wall, launches, (by_route, forms), loop = engine_run(
        cfg, model, params, dev, pg, "bf16", "serve_paged", warm=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pool_gb = sum(t.numel() * t.element_size() for p in loop.caches.values()
                  for t in p.values()) / 1e9
    plan = clock.decode_plan
    prof = profile_line(cfg.name, "paged decode tick", lambda: loop.step(
        loop.params, loop.caches, plan.tokens, plan.pos, plan.n_new, plan.tables, plan.seeds,
        plan.temps)[0].cpu())
    del loop
    torch.cuda.empty_cache()

    crash = engine_crash_replay(cfg, model, params, dev, pg, "bf16", "serve_paged", rep)
    del crash["completions"]
    torch.cuda.empty_cache()
    int8, _, _, iwall, ilaunches, (_, iforms), loop = engine_run(
        cfg, model, params, dev, pg, "int8", "serve_paged int8")
    del loop
    same = [a == b for rid, toks in rep["completions"].items()
            for a, b in zip(toks, int8["completions"][rid])]
    torch.cuda.empty_cache()
    fp32 = serve_paged_fp32(cfg, model, params, dev)
    torch.cuda.empty_cache()
    auto = serve_paged_auto(cfg, model, params, dev, {"bf16": rep["completions"],
                                                      "fp32": fp32.pop("completions")})

    led = rep["ledger"]
    return {"phase": "serve_paged", "arch": cfg.name, "layers": cfg.n_layers,
            "engine": dataclasses.asdict(pg), "gather_dtype": "bf16", "kv_dtype": "bf16",
            "requests": pg.requests, **engine_summary(rep, reqs, clock, wall),
            "ttft_ticks": {"p50": led["ttft_ticks_p50"], "p99": led["ttft_ticks_p99"]},
            "latency_ticks": {"p50": led["latency_ticks_p50"], "p99": led["latency_ticks_p99"]},
            "profile_decode_tick": {k: prof[k] for k in (
                "wall_ms", "device_busy_ms", "idle_share", "device_kernels", "events_short",
                "by_kind")},
            "peak_gb": peak_gb, "pool_gb": pool_gb, "ledger": led,
            "launches": launches, "attention_launches_by_route": by_route,
            "attention_launches_by_form": forms,
            "checks": {"ledger": f"{pg.requests} of {pg.requests} completed, accounted",
                       **consistency, "crash_replay": crash,
                       "int8_engine": {"ledger_accounted": True, "ticks": int8["ticks"],
                                       "wall_s": iwall, "tokens_equal_to_bf16_share":
                                       sum(same) / len(same), "launches": ilaunches,
                                       "attention_launches_by_form": iforms},
                       "fp32_engine": fp32, "auto_engine": auto,
                       "paged_vs_plain": kernel,
                       "launch_counts": "an engine step: RMSNorm 2 L + 1, attention L, all "
                                        "on paged:wgmma; int8 pools: quantize 2 L"},
            "gpu": card}


# -- fp32 pools and the MoE family (serve_paged's fp32 run, serve_moe) -----------

# The fp32-pool engine run (a fourth serve_paged run): a shorter trace, so
# that its consistency checks and its two engine runs fit ≈ 10 s.
FP32_PAGED = dataclasses.replace(PAGED, requests=8, prompt_hi=256, new_tokens=16,
                                 max_blocks=17, crash_at=6, check_steps=8,
                                 decode_lens=(150, 250))
# fp32 pools against bf16 pools, the decode logits of the same fed tokens,
# as a fraction of the largest |logit|: only the pages' rounding differs
# (bf16 keeps 8 bits of each k and v value), the rest of the model runs in
# bf16 on both sides.
FP32_POOL_REL_TOL = 0.05

MOE_ARCH = "deepseek-moe-16b"
# serve_moe: deepseek-moe-16b at full width, cut to 4 layers (≈ 2.77 B
# parameters, 11 GB stored fp32): the fixed batch, then the engine.
MOE_SERVE_LAYERS = 4
MOE_FIXED = {"batch": 4, "prompt": 512, "steps": 16}
MOE_PAGED = PagedServe(slots=8, chunk=64, block=16, max_blocks=17, requests=8, prompt_lo=64,
                       prompt_hi=256, new_tokens=16, arrival_every=1, crash_at=6,
                       check_rows=8, check_steps=8, decode_lens=(150, 250))
# The attention heads of the models this slice adds, (name, KV heads, g) at
# head dim 128, for the kernel phase: deepseek's are timed (its serve and
# train paths run them), the others are correctness checks (their paths do
# not run on one card here).  dbrx's g 6 does not divide the paged route's
# 64 packed rows, and its backward takes ``mma``.
NEW_ATTN_SHAPES = (("deepseek-moe-16b", 16, 1), ("dbrx-132b", 8, 6), ("granite-8b", 8, 4),
                   ("yi-9b", 4, 8), ("qwen1.5-110b", 8, 8))
# One MoE layer at full width on the card (bf16) against the same layer in
# fp32 on the CPU, 1 x 64 tokens: the outputs of the tokens routed alike
# (the same k experts, in order, each kept or dropped alike) as a fraction
# of the largest |output|: bf16 rounds the router's input, the experts'
# products and the shared MLP's.
MOE_LAYER_TOKENS = 64
MOE_LAYER_REL_TOL = 5e-2


def _pool_dtype(kv: str):
    return {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[kv]


class DropSpy:
    """Within its ``with``, records each MoE dispatch's kept assignments and
    live rows on the card, without a host sync: wraps
    ``models/blocks.moe_route``, which every dispatch calls by name.  After
    ``attach(loop)`` (an engine run's serve loop) it also keeps each engine
    step's plan, so that :meth:`first_drops` can map a dropped assignment
    to its request and position.  The runs it watches are not timed."""

    def __enter__(self):
        from repro_torch.models import blocks as B

        self.blocks, self.real, self.calls, self.steps = B, B.moe_route, [], []

        def spy(x2d, router_w, cfg, live=None):
            out = self.real(x2d, router_w, cfg, live)
            keep = out[4].reshape(-1, cfg.top_k)
            self.calls.append((keep, torch.ones(keep.shape[0], dtype=torch.bool,
                                                device=keep.device) if live is None else live))
            return out

        B.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route = self.real

    def attach(self, loop) -> None:
        step = loop._engine_step

        def spied(plan):
            first = len(self.calls)
            tok = step(plan)
            self.steps.append((plan, first, len(self.calls)))
            return tok

        loop._engine_step = spied

    def dropped_share(self) -> float | None:
        """Of the live rows' assignments, the share the capacity dropped."""
        kept = sum(int(keep.sum()) for keep, _ in self.calls)
        routed = sum(int(live.sum()) * keep.shape[1] for keep, live in self.calls)
        return None if not routed else 1.0 - kept / routed

    def first_drops(self) -> dict[int, int]:
        """For each request with a live row whose assignment was dropped in
        some layer of some engine step: the least such row's position."""
        out = {}
        for plan, lo, hi in self.steps:
            b, c = plan.tokens.shape
            dropped = torch.cat([(~keep).any(dim=1) & live for keep, live in
                                 self.calls[lo:hi]]).reshape(-1, b, c).any(dim=0).cpu()
            for slot, req in plan.requests.items():
                rows = torch.nonzero(dropped[slot, :int(plan.n_new[slot])]).flatten()
                if len(rows):
                    p = int(plan.pos[slot]) + int(rows[0])
                    out[req.rid] = min(out.get(req.rid, p), p)
        return out


def engine_run(cfg, model, params, dev, pg: PagedServe, kv: str, label: str,
               fault: str | None = None, warm: bool = False, spy: DropSpy | None = None,
               mcfg=None):
    """One counted run of ``pg``'s trace through ``ResilientServeLoop`` (the
    launcher's ``--continuous`` path) on ``kv`` pools and ``params``, bf16
    gather; the ledger must account every request, each completion must be
    ``new_tokens`` ids of the vocab, and the launches must be the engine's:
    per engine step RMSNorm 2 L + 1 and attention L, every call on the
    ``paged`` route in the body of ``paged_body(dh, kv)`` (and ``quantize``
    2 L on int8 pools).  Returns ``(report, requests, TickClock, wall s,
    launches, the routes and forms, loop)``.  ``spy``: a :class:`DropSpy`
    to attach to the loop.  ``mcfg``: a resolved config to serve with (its
    ``kv_dtype`` is ``kv``; the loop caps the batcher's residency at its
    ``max_resident_requests``)."""
    import numpy as np

    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.runtime import batching as RB
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    if mcfg is None:
        mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True, kv_dtype=kv,
                          kv_block_size=pg.block)
    sc = ServeLoopConfig(slots_local=pg.slots, nb_local=pg.slots * pg.max_blocks + 1,
                         block_size=pg.block, max_blocks=pg.max_blocks, chunk=pg.chunk,
                         top_k=pg.top_k, reserve="full", seed=0)
    loop = ResilientServeLoop(model, MiCSTopology(), mcfg, sc, params_for=lambda m, t: params,
                              fault_injector=None if fault is None else FaultPlan.parse(fault),
                              device=dev)
    if warm:   # first use of the engine's shapes (cuBLAS, allocator)
        z, B = np.zeros, loop.batcher.batch
        for _ in range(2):
            loop.step(loop.params, loop.caches, z((B, pg.chunk), np.int64), z(B, np.int64),
                      z(B, np.int64), z((B, pg.max_blocks), np.int32), z(B, np.int64),
                      z(B, np.float32))
    clock = TickClock(loop)
    if spy is not None:
        spy.attach(loop)
    reqs = paged_requests(RB, cfg.vocab, pg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    clock.start = time.perf_counter()
    rep = loop.run(reqs, [pg.arrival_every * i for i in range(pg.requests)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - clock.start
    launches, by_route = read_counts(), dict(FA.launches_by_route)
    forms = dict(FA.launches_paged_by_form)
    led, steps, n_attn = rep["ledger"], len(clock.steps), cfg.n_layers
    if not (led["accounted"] and led["completed"] == pg.requests and led["shed"] == 0):
        raise AssertionError(f"{label}: ledger {led}")
    want = dict.fromkeys(launches, 0) | {
        "rmsnorm": (2 * n_attn + 1) * steps, "flash_attention": n_attn * steps,
        "quantize": 2 * n_attn * steps if kv == "int8" else 0}
    want_route = {"mma": 0, "split": 0, "fma": 0, "paged": n_attn * steps}
    form = f"paged:{FA.paged_body(cfg.resolved_head_dim, _pool_dtype(kv))}"
    want_forms = dict.fromkeys(forms, 0) | {form: n_attn * steps}
    if launches != want or by_route != want_route or forms != want_forms:
        raise AssertionError(f"{label}: launches {launches} / {by_route} / {forms} != {want} / "
                             f"{want_route} / {want_forms} ({steps} engine steps)")
    for toks in rep["completions"].values():
        if len(toks) != pg.new_tokens or min(toks) < 0 or max(toks) >= cfg.vocab:
            raise AssertionError(f"{label}: a completion {toks}")
    return rep, reqs, clock, wall, launches, (by_route, forms), loop


def engine_summary(rep, reqs, clock, wall) -> dict:
    """A run's throughput and latency: tokens/s, ticks, engine step ms (p50,
    decode-only and with prefill rows), decode ms a tick and TTFT ms."""
    decode_ticks = [t for t, d, _ in clock.steps if d]
    tick_ms = [(clock.ends[t] - clock.tick_start(t)) * 1e3 for t in decode_ticks]
    tokens = sum(len(t) for t in rep["completions"].values())
    ttft_ms = [(clock.ends[r.first_token_tick] - clock.tick_start(r.arrival)) * 1e3
               for r in reqs]
    return {"ticks": rep["ticks"], "engine_steps": len(clock.steps),
            "decode_only_steps": len(decode_ticks), "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall,
            "engine_step_ms_p50": {
                "decode_only": _pct([ms for _, d, ms in clock.steps if d], 50),
                "with_prefill": _pct([ms for _, d, ms in clock.steps if not d], 50)},
            "decode_ms_per_tick": {"p50": _pct(tick_ms, 50), "p99": _pct(tick_ms, 99)},
            "ttft_ms": {"p50": _pct(ttft_ms, 50), "p99": _pct(ttft_ms, 99)}}


def engine_crash_replay(cfg, model, params, dev, pg, kv, label, fault_free,
                        spy: DropSpy | None = None) -> dict:
    """The trace again with an engine crash at ``pg.crash_at``: its
    completions must be the fault-free run's bit for bit, after one replay
    (MoE: :func:`moe_crash_replay` holds them)."""
    crash, _, _, wall, launches, (_, forms), loop = engine_run(
        cfg, model, params, dev, pg, kv, f"{label} crash", fault=f"crash@{pg.crash_at}",
        spy=spy)
    del loop
    changes = crash["world_changes"]
    if [c["kind"] for c in changes] != ["crash"] or not changes[0]["replayed"]:
        raise AssertionError(f"{label}: crash ledger {changes}")
    equal = [a == b for rid, toks in fault_free["completions"].items()
             for a, b in zip(toks, crash["completions"][rid])]
    line = {"at_tick": pg.crash_at, "replayed": changes[0]["replayed"], "ticks": crash["ticks"],
            "wall_s": wall, "tokens_equal_share": sum(equal) / len(equal),
            "launches": launches, "attention_launches_by_form": forms,
            "completions": crash["completions"]}
    if cfg.family != "moe" and not all(equal):
        raise AssertionError(f"{label}: the crash run's completions differ from the fault-free "
                             "run's")
    line["completions_bitwise"] = all(equal)
    return line


def moe_crash_replay(cfg, model, params, dev, pg, label, fault_free,
                     free_drops: dict[int, int]) -> dict:
    """The MoE engine's crash replay.  A replayed request restarts from its
    prompt beside other rows than before, and whether a live row's
    assignment is kept depends on the rows before it in its chunk; a row
    whose assignments are all kept is computed as if alone.  So the crash
    run twice must be bitwise equal, and each request's tokens must equal
    the fault-free run's bit for bit up to its first row with a dropped
    assignment in either run: the token sampled from position p is held
    when no row of its request at a position <= p dropped one
    (``free_drops``: the fault-free run's :meth:`DropSpy.first_drops`).
    The shares of tokens held and of tokens equal are reported."""
    from repro_torch.runtime import batching as RB

    runs = []
    for _ in range(2):
        with DropSpy() as spy:
            runs.append(engine_crash_replay(cfg, model, params, dev, pg, "bf16", label,
                                            fault_free, spy=spy))
        runs[-1]["dropped_share"] = spy.dropped_share()
        runs[-1]["first_drops"] = spy.first_drops()
        torch.cuda.empty_cache()
    first, second = runs
    crash = first.pop("completions")
    if crash != second.pop("completions") or first["first_drops"] != second["first_drops"]:
        raise AssertionError(f"{label}: two crash runs' completions or drops differ")
    plens = {r.rid: len(r.prompt) for r in paged_requests(RB, cfg.vocab, pg)}
    held, differ = 0, []
    for rid, toks in fault_free["completions"].items():
        cut = min(free_drops.get(rid, math.inf), first["first_drops"].get(rid, math.inf))
        for i, (a, b) in enumerate(zip(toks, crash[rid])):
            if plens[rid] - 1 + i < cut:
                held += 1
                if a != b:
                    differ.append((rid, i))
    tokens = sum(len(t) for t in fault_free["completions"].values())
    if differ or not held:
        raise AssertionError(f"{label}: {len(differ)} of the {held} tokens before a request's "
                             f"first dropped row differ from the fault-free run's: {differ}")
    return {**first, "replay_bitwise_repeat": True, "second_run_wall_s": second["wall_s"],
            "fault_free_first_drops": free_drops,
            "tokens_before_first_drop_bitwise": {"held": held, "of": tokens,
                                                 "share": held / tokens}}


def serve_paged_fp32(cfg, model, params, dev) -> dict:
    """``serve_paged``'s fourth engine run, on fp32 pools (the ``paged``
    route's ``fma`` body), on ``FP32_PAGED``'s shorter trace: paged ==
    contiguous bit for bit over fp32 caches, bf16 pools' logits within
    ``FP32_POOL_REL_TOL`` of the fp32 pools', the engine's launches all on
    ``paged:fma``, and a crash replay bitwise the fault-free run."""
    pg = FP32_PAGED
    consistency = paged_consistency(cfg, model, params, dev, pg, kv="fp32", other="bf16",
                                    rel_tol=FP32_POOL_REL_TOL, placement=False)
    torch.cuda.empty_cache()
    rep, reqs, clock, wall, launches, (_, forms), loop = engine_run(
        cfg, model, params, dev, pg, "fp32", "serve_paged fp32", warm=True)
    pool_gb = sum(t.numel() * t.element_size() for p in loop.caches.values()
                  for t in p.values()) / 1e9
    del loop
    torch.cuda.empty_cache()
    crash = engine_crash_replay(cfg, model, params, dev, pg, "fp32", "serve_paged fp32", rep)
    del crash["completions"]
    torch.cuda.empty_cache()
    return {"engine": dataclasses.asdict(pg), "kv_dtype": "fp32", "pool_gb": pool_gb,
            **engine_summary(rep, reqs, clock, wall), "ledger_accounted": True,
            "launches": launches, "attention_launches_by_form": forms, **consistency,
            "crash_replay": crash, "completions": rep["completions"]}


# serve_paged's fifth engine run: the autotuner's serve policy (policy
# "auto", the KV ceiling bf16, the residency from the memory planner) on the
# trace of the manual run at the KV dtype it picks, held to that run bit for
# bit: the phase's first 8 requests on bf16 pools, its fp32 run's 8 on fp32.
AUTO_PAGED = {"bf16": dataclasses.replace(PAGED, requests=8), "fp32": FP32_PAGED}


def serve_paged_auto(cfg, model, params, dev, manual: dict) -> dict:
    """The engine under ``MiCSConfig(policy="auto", kv_dtype="bf16")``
    resolved as the launcher resolves it (``core/autotune.resolve_config``
    in serve mode at the phase engine's positions: the KV dtype at most
    bf16's lossiness, prefetch, the planner's residency, which caps the
    batcher's), on ``AUTO_PAGED``'s trace for the chosen KV dtype; its
    completions bit for bit ``manual[kv]``'s (the manual run's at that KV
    dtype on the same requests), and the serve plan
    (``core/memplan.predict_footprint`` with the engine's pool and plan
    rows) beside the run's peak."""
    from repro_torch.core import memplan as MP
    from repro_torch.core.autotune import resolve_config
    from repro_torch.core.comm import policies_from_config
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology

    t0 = time.perf_counter()
    mcfg, plan = resolve_config(MiCSConfig(policy="auto", kv_dtype="bf16", kv_block_size=PAGED.block),
                                model, MiCSTopology(), mode="serve",
                                seq=PAGED.max_blocks * PAGED.block)
    kv = mcfg.kv_dtype
    pg = AUTO_PAGED[kv]
    rep, reqs, clock, wall, launches, (_, forms), loop = engine_run(
        cfg, model, params, dev, pg, kv, "serve_paged auto", warm=True, mcfg=mcfg)
    peak = torch.cuda.max_memory_allocated()
    del loop
    torch.cuda.empty_cache()
    want = {rid: manual[kv][rid] for rid in rep["completions"]}
    if rep["completions"] != want:
        raise AssertionError(f"serve_paged auto ({kv} pools): completions differ from the "
                             f"manual engine's at {kv}")
    gp, sp = policies_from_config(mcfg)
    nb = pg.slots * pg.max_blocks + 1
    mem = MP.predict_footprint(model, MiCSTopology(), gp, sp, mode="serve",
                               kv_pages_tokens=nb * pg.block, kv_dtype=kv,
                               decode_batch=pg.slots, decode_ctx=pg.max_blocks * pg.block,
                               decode_chunk=pg.chunk, kv_max_blocks=pg.max_blocks)
    return {"engine": dataclasses.asdict(pg), "kv_ceiling": "bf16", "kv_dtype": kv,
            "max_resident_requests": mcfg.max_resident_requests,
            "prefetch": mcfg.prefetch, "gather": "flat" if not mcfg.hierarchical
            else mcfg.gather_order, "gather_dtype": str(mcfg.gather_dtype).removeprefix("torch."),
            "ranking": plan.table(top=6), **engine_summary(rep, reqs, clock, wall),
            "completions_equal_to_manual": True, "launches": launches,
            "attention_launches_by_form": forms,
            "memplan": {"plan_gb": mem.total_bytes / 1e9, "peak_gb": peak / 1e9,
                        "plan_over_peak": mem.total_bytes / peak, "args_gb": mem.args_bytes / 1e9,
                        "components_gb": {k: v / 1e9 for k, v in mem.components.items()},
                        "reserved_gb": torch.cuda.max_memory_reserved() / 1e9},
            "seconds": time.perf_counter() - t0}


def moe_layer_check(model, params, dev) -> dict:
    """Layer 0's MoE FFN (``blocks.moe_ffn``: router, dispatch, experts,
    shared experts) at full width on the card in bf16 against the same
    weights in fp32 on the CPU, on ``MOE_LAYER_TOKENS`` tokens: first the
    routing (a token whose top-k margin is under bf16's rounding may pick
    another expert, and a pick moves the others' slots), then the outputs
    of the tokens routed alike, within ``MOE_LAYER_REL_TOL``."""
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L

    cfg = model.cfg
    layout = model.pool("layers").layout
    names = [s.name for s in layout.segments if s.name.startswith(("router.", "moe.",
                                                                   "shared."))]
    full = layout.unflatten(params["layers"][0, 0])
    t_card = {k: full[k].to(torch.bfloat16) for k in names}
    t_cpu = {k: full[k].cpu() for k in names}
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen, device=dev)
    with torch.inference_mode():
        y_card, aux_card = B.moe_ffn(t_card, x.to(torch.bfloat16), cfg,
                                     L.Ctx(mode="prefill", compute_dtype=torch.bfloat16))
        r_card = B.moe_route(x[0].to(torch.bfloat16), t_card["router.w"], cfg)
        y_cpu, aux_cpu = B.moe_ffn(t_cpu, x.cpu(), cfg,
                                   L.Ctx(mode="prefill", compute_dtype=torch.float32))
        r_cpu = B.moe_route(x[0].cpu(), t_cpu["router.w"], cfg)
    k = cfg.top_k
    same_idx = (r_card[2].cpu() == r_cpu[2]).all(dim=1)
    same_keep = (r_card[4].cpu().reshape(-1, k) == r_cpu[4].reshape(-1, k)).all(dim=1)
    alike = same_idx & same_keep
    if not bool(torch.isfinite(y_card).all()):
        raise AssertionError("serve_moe: the MoE layer's card output is not finite")
    if int(alike.sum()) < MOE_LAYER_TOKENS // 2:
        raise AssertionError(f"serve_moe: only {int(alike.sum())} of {MOE_LAYER_TOKENS} tokens "
                             "routed alike on the card and the CPU")
    got, want = y_card[0].float().cpu()[alike], y_cpu[0][alike]
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not err <= MOE_LAYER_REL_TOL * scale:
        raise AssertionError(f"serve_moe: the MoE layer on the card is {err} > "
                             f"{MOE_LAYER_REL_TOL} x {scale} from fp32 on the CPU")
    return {"tokens": MOE_LAYER_TOKENS, "experts": cfg.n_experts, "top_k": k,
            "capacity": r_cpu[5], "same_picks": int(same_idx.sum()),
            "routed_alike": int(alike.sum()), "not_routed_alike": int((~alike).sum()),
            "dropped_assignments": {"card": int((~r_card[4]).sum()),
                                    "cpu": int((~r_cpu[4]).sum())},
            "max_abs_err": err, "max_abs_out": scale, "rel_tol": MOE_LAYER_REL_TOL,
            "aux": {"card": aux_card.item(), "cpu": aux_cpu.item()}}


def serve_moe_phase(card: str, dev) -> dict:
    """``serve_moe``: deepseek-moe-16b at full width, cut to
    ``MOE_SERVE_LAYERS`` layers, random weights from ``init_params(seed=0)``,
    bf16 gather: the fixed batch through ``build_serve_steps`` (``MOE_FIXED``:
    prefill, greedy decode steps), then the engine (``MOE_PAGED``, bf16
    pools) fault-free and with a crash replay; paged == contiguous bit for
    bit on the same rows (chunk placement is not checked: a chunk's capacity
    drops make a row depend on its neighbours); one MoE layer against fp32
    on the CPU.  Launches a forward: RMSNorm 2 L + 1, attention L (prefill
    on ``mma``, decode on ``split``, the engine on ``paged:wgmma``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_SERVE_LAYERS)
    model = build_model(cfg, tp=1)
    params = init_params(model, seed=0, device=dev)
    fx, L_ = MOE_FIXED, cfg.n_layers
    prefill_fn, decode_fn = build_serve_steps(
        model, MiCSTopology(), MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True),
        fx["prompt"] + fx["steps"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (fx["batch"], fx["prompt"]), generator=gen, device=dev)
    logits, caches = prefill_fn(params, {"tokens": prompt})   # warm (not counted)
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), fx["prompt"])
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    decode_ms, out = [], [tok]
    for i in range(fx["steps"]):
        t0 = time.perf_counter()
        lg, tok, caches = decode_fn(params, caches, tok, fx["prompt"] + i)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    launches, by_route = read_counts(), dict(FA.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd = 1 + fx["steps"]
    want = dict.fromkeys(launches, 0) | {"rmsnorm": (2 * L_ + 1) * fwd,
                                         "flash_attention": L_ * fwd}
    want_route = {"mma": L_, "split": L_ * fx["steps"], "fma": 0, "paged": 0}
    if launches != want or by_route != want_route:
        raise AssertionError(f"serve_moe: launches {launches} / {by_route} != {want} / "
                             f"{want_route}")
    ids = torch.cat(out, dim=1)
    if not (bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(lg.float()).all())
            and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab):
        raise AssertionError("serve_moe: non-finite logits or an id outside the vocab")
    with DropSpy() as spy_p:
        prefill_fn(params, {"tokens": prompt})
    with DropSpy() as spy_d:
        decode_fn(params, caches, tok, fx["prompt"] + fx["steps"] - 1)
    fixed = {"batch": fx["batch"], "prompt": fx["prompt"], "decode_steps": fx["steps"],
             "prefill_ms": prefill_ms, "decode_ms_per_step": statistics.median(decode_ms),
             "decode_tokens_per_s": fx["batch"] / (statistics.median(decode_ms) / 1e3),
             "prefill_tokens_per_s": fx["batch"] * fx["prompt"] / (prefill_ms / 1e3),
             "dropped_share": {"prefill": spy_p.dropped_share(),
                               "decode": spy_d.dropped_share()},
             "peak_gb": peak_gb, "launches": launches, "attention_launches_by_route": by_route}
    del logits, caches, lg
    torch.cuda.empty_cache()

    pg = MOE_PAGED
    rep, reqs, clock, wall, e_launches, (_, e_forms), loop = engine_run(
        cfg, model, params, dev, pg, "bf16", "serve_moe engine", warm=True)
    e_peak = torch.cuda.max_memory_allocated() / 1e9
    plan = clock.decode_plan
    prof = profile_line(cfg.name, "MoE engine decode tick", lambda: loop.step(
        loop.params, loop.caches, plan.tokens, plan.pos, plan.n_new, plan.tables, plan.seeds,
        plan.temps)[0].cpu())
    del loop
    torch.cuda.empty_cache()
    # the fault-free run again, untimed, under the spy: its drops by request
    with DropSpy() as spy_e:
        again, *_, loop = engine_run(cfg, model, params, dev, pg, "bf16",
                                     "serve_moe engine again", spy=spy_e)
    del loop
    if again["completions"] != rep["completions"]:
        raise AssertionError("serve_moe engine: the fault-free run twice differs")
    torch.cuda.empty_cache()
    crash = moe_crash_replay(cfg, model, params, dev, pg, "serve_moe engine", rep,
                             spy_e.first_drops())
    consistency = paged_consistency(cfg, model, params, dev, pg, other=None, placement=False)
    torch.cuda.empty_cache()
    layer = moe_layer_check(model, params, dev)
    del params
    torch.cuda.empty_cache()
    return {"phase": "serve_moe", "arch": cfg.name, "layers": L_, "d_model": cfg.d_model,
            "experts": cfg.n_experts, "shared_experts": cfg.n_shared_experts,
            "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
            "model_params": model_params(model),
            "gather_dtype": "bf16", "fixed_batch": fixed,
            "engine": {"config": dataclasses.asdict(pg), "kv_dtype": "bf16",
                       **engine_summary(rep, reqs, clock, wall), "peak_gb": e_peak,
                       "dropped_share": spy_e.dropped_share(),
                       "profile_decode_tick": {k: prof[k] for k in (
                           "wall_ms", "device_busy_ms", "idle_share", "device_kernels",
                           "events_short", "by_kind")},
                       "launches": e_launches, "attention_launches_by_form": e_forms,
                       "crash_replay": crash, **consistency,
                       "chunk_placement": "not checked: capacity drops make a row depend on "
                                          "the rows of its chunk (ROADMAP Queue 3)"},
            "moe_layer_vs_cpu_fp32": layer, "gpu": card}


def train_rows(path: TrainPath) -> int:
    """Token rows of one micro-step of ``path``."""
    return path.global_batch // path.micro_steps * path.seq


def attention_layers(cfg) -> int:
    """The model's causal self-attention sub-layers: every layer of the
    dense and MoE families; the ``attn`` entries of griffin's pattern over
    its super-layers and tail (``models/build.py``); none in xLSTM."""
    if cfg.family == "xlstm":
        return 0
    if cfg.family != "griffin":
        return cfg.n_layers
    pattern = cfg.pattern or ("rec", "rec", "attn")
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    return n_super * pattern.count("attn") + pattern[:rem].count("attn")


def train_flops(model, path: TrainPath) -> float:
    """Model flops of one step: 6 N a token, N the active parameters of the
    layer pools and the head (``models/build.active_param_count``: an MoE
    token runs k of the E experts; the embedding lookup does no product),
    plus attention's 12 dh a (query, key) pair the masks allow (causal, and
    within the window where the model has one) and a head, in each
    attention sub-layer.  Recomputation is not counted."""
    from repro_torch.models.build import active_param_count

    cfg = model.cfg
    n = active_param_count(cfg) - sum(seg.size for seg in model.embed.layout.segments)
    tokens = path.global_batch * path.seq
    span = cfg.window or path.seq   # keys a query sees at most
    pairs = path.global_batch * sum(min(pos + 1, span) for pos in range(path.seq))
    attn = 12 * cfg.resolved_head_dim * pairs * cfg.n_heads * attention_layers(cfg)
    return 6 * n * tokens + attn, n


# The caching allocator hands a tensor a block rounded up to 512 bytes, and
# a whole fresh segment (rounded up to 2 MiB) when less than 1 MiB of it
# would be left: what ``memory_allocated`` counts beyond a tensor's bytes.
ALLOC_SLACK_BYTES = 2 * 2**20
# The card's own limit on plan / peak, beside the reference's documented
# MEM_RTOL (0.35): the one-card train runs the planner is held on read
# 0.9961 (bert-10b) to 1.0056 (recurrentgemma-2b, remat) on an H100, so a
# lost term of a few percent of the step (the loss's workspace is 13% of
# recurrentgemma-2b's) fails here where MEM_RTOL would pass it.
CARD_PLAN_RTOL = 0.03


def measure_init(init, *args, **kw):
    """``init(*args, **kw)`` (``init_state``) and what it put on the card:
    ``memory_allocated`` after it less before it, beside the bytes of the
    state's device tensors and their count."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = init(*args, **kw)
    torch.cuda.synchronize()
    tensors = [t for part in ("params", "m", "v") for t in state[part].values() if t.is_cuda]
    return state, {"allocated_bytes": torch.cuda.memory_allocated() - before,
                   "tensor_bytes": sum(t.numel() * t.element_size() for t in tensors),
                   "tensors": len(tensors), "live_before_bytes": before}


class InitMeasured:
    """Measures (:func:`measure_init`) every ``init_state`` that ``module``
    (the train loop) calls while the context is open; ``.seen`` keeps the
    last."""

    def __init__(self, module):
        self.module, self.seen = module, None

    def __enter__(self):
        self.orig = self.module.init_state

        def init_state(*args, **kw):
            state, self.seen = measure_init(self.orig, *args, **kw)
            return state

        self.module.init_state = init_state
        return self

    def __exit__(self, *exc):
        self.module.init_state = self.orig


def memplan_record(model, mcfg, path: TrainPath, peak_bytes: int, init: dict):
    """``(record, plan)``: the memory planner (``core/memplan.predict_footprint``)
    at ``path``'s shapes under ``mcfg`` (a resolved config) beside the run's
    peak ``peak_bytes``, the allocator's reserve and what ``init_state``
    made (``init``: :func:`measure_init`).  Sizes are 1e9 bytes (``*_gb``)
    or 2^30 (``*_gib``)."""
    from repro_torch.core import memplan as MP
    from repro_torch.core.comm import policies_from_config
    from repro_torch.core.topology import MiCSTopology

    gp, sp = policies_from_config(mcfg)
    plan = MP.predict_footprint(model, MiCSTopology(), gp, sp, micro_steps=mcfg.micro_steps,
                                local_batch=path.global_batch // path.micro_steps, seq=path.seq,
                                boundary=mcfg.boundary_schedule,
                                hop2_bucket_mb=mcfg.hop2_bucket_mb, offload_opt=mcfg.offload_opt,
                                mlstm_chunk=mcfg.mlstm_chunk)
    reserved = torch.cuda.max_memory_reserved()
    out = {"plan_gb": plan.total_bytes / 1e9, "plan_gib": plan.total_gb,
           "peak_gb": peak_bytes / 1e9, "plan_over_peak": plan.total_bytes / peak_bytes,
           "reserved_gb": reserved / 1e9, "plan_reserved_gb": plan.reserved_bytes / 1e9,
           "reserved_over_plan": reserved / plan.total_bytes,
           "args_gb": plan.args_bytes / 1e9,
           "components_gb": {k: v / 1e9 for k, v in plan.components.items()},
           "moment": plan.moment,
           "moments_gb": {k: v / 1e9 for k, v in plan.describe()["moments"].items()},
           "state_bytes_plan": plan.state_bytes, "state_bytes_init": init["tensor_bytes"],
           "init_allocated_bytes": init["allocated_bytes"],
           "live_before_init_gb": init["live_before_bytes"] / 1e9, "rtol": MP.MEM_RTOL,
           "card_rtol": CARD_PLAN_RTOL, "reserve_factor": MP.RESERVE_FACTOR}
    return out, plan


def plan_against_peak(label: str, model, mcfg, path: TrainPath, peak_bytes: int,
                      init: dict) -> dict:
    """:func:`memplan_record` of the run, checked.

    Checks that the plan's state bytes are exactly the bytes of the tensors
    ``init_state`` made on the card (``init``: :func:`measure_init`), that
    ``memory_allocated`` grew by those bytes plus at most the allocator's
    rounding (``ALLOC_SLACK_BYTES`` a tensor), that the plan's total (the
    largest of its moments, ``MemPlan.moment``) is within ``MEM_RTOL`` and
    ``CARD_PLAN_RTOL`` of
    ``peak_bytes`` and that the allocator's reserve
    (``max_memory_reserved``) is within the plan's ``reserved_bytes``, what
    a budget is held to."""
    from repro_torch.core import memplan as MP

    out, plan = memplan_record(model, mcfg, path, peak_bytes, init)
    ratio, reserved = out["plan_over_peak"], torch.cuda.max_memory_reserved()
    slack = init["allocated_bytes"] - init["tensor_bytes"]
    if plan.state_bytes != init["tensor_bytes"] or not (
            0 <= slack <= init["tensors"] * ALLOC_SLACK_BYTES):
        raise AssertionError(f"{label}: the plan's state bytes {plan.state_bytes} != the "
                             f"{init['tensor_bytes']} bytes init_state made "
                             f"({init['allocated_bytes']} allocated)")
    if not abs(ratio - 1) <= min(MP.MEM_RTOL, CARD_PLAN_RTOL):
        raise AssertionError(f"{label}: the plan {plan.total_bytes / 1e9:.3f} GB is not within "
                             f"{min(MP.MEM_RTOL, CARD_PLAN_RTOL)} of the peak "
                             f"{peak_bytes / 1e9:.3f} GB")
    elif not reserved <= plan.reserved_bytes:
        raise AssertionError(f"{label}: the allocator reserved {reserved / 1e9:.3f} GB, over "
                             f"the plan's {plan.reserved_bytes / 1e9:.3f} GB with its reserve")
    return out


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
    from repro_torch.runtime import train_loop as TL
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
    with InitMeasured(TL) as init:
        stats = train(model, MiCSTopology(), mcfg, oc, dc, lc, device=dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    tables = check_train_launches(f"train {path.arch}", path, path.steps * path.micro_steps)
    launches, by_route, bwd_by_route, rms_bwd_by_route, rglru_by_form = tables
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memplan = plan_against_peak(f"train {path.arch}", model, mcfg, path,
                                torch.cuda.max_memory_allocated(), init.seen)

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
            "rglru_launches_by_form": rglru_by_form, "memplan": memplan, "gpu": card}
    emit(line)
    return launches, line


def train_moe_phase(card: str, dev) -> dict:
    """``train_moe``: ``build_train_step`` on deepseek-moe-16b at full width,
    cut to ``MOE_TRAIN_LAYERS`` layers, from ``init_state(seed=0)`` and the
    synthetic stream (``MOE_TRAIN``: bf16 gather, prefetch, bucketed
    boundary, exact clip), ``MOE_TRAIN.steps`` steps; first step 1's
    gradients by :func:`moe_grad_probe` (fp32 compute, the fma routes,
    against bf16), and step 1's loss and grad norm held to its fp32 ones
    within ``MOE_FP32_REL_TOL``.  The counters are set to 0 just before the
    bf16 run and read just after (``check_train_launches``); then a step is
    profiled (busy and idle share, time by kind).  MFU counts the active
    parameters."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    # serve_moe's engine runs leave reference cycles (a loop and its spy)
    # holding its 11 GB of weights until a collection: free them first, so
    # the phase's peak is its own
    gc.collect()
    torch.cuda.empty_cache()
    path = MOE_TRAIN
    cfg = dataclasses.replace(get_config(path.arch), n_layers=MOE_TRAIN_LAYERS)
    model = build_model(cfg, tp=1)
    oc = OptConfig(warmup_steps=0, total_steps=path.steps)
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                    global_batch=path.global_batch,
                                    micro_steps=path.micro_steps))
    probe = moe_grad_probe(model, path, source.global_step_batch(0), dev)
    fp32_step = probe["fp32"]

    step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=path.micro_steps),
                            oc, device=dev)
    state, init = measure_init(init_state, model, 0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, auxes, gnorms, step_ms = [], [], [], []
    for i in range(path.steps):
        t0 = time.perf_counter()
        state, m = step(state, source.global_step_batch(i))
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        auxes.append(m["aux"].item())
        gnorms.append(m["grad_norm"].item())
    tables = check_train_launches("train_moe", path, path.steps * path.micro_steps)
    launches, by_route, bwd_by_route, rms_bwd_by_route, _ = tables
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memplan = plan_against_peak("train_moe", model, step.mcfg, path,
                                torch.cuda.max_memory_allocated(), init)
    batch = source.global_step_batch(path.steps)   # two more steps: a warm one, the profiled
    prof = profile_line(cfg.name, "train_moe step", lambda: step(state, batch)[1]["loss"].item())
    del state, step
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + auxes + gnorms):
        raise AssertionError(f"train_moe: losses {losses}, aux {auxes}, grad norms {gnorms}")
    rel = {"loss": abs(losses[0] - fp32_step["loss"]) / abs(fp32_step["loss"]),
           "grad_norm": abs(gnorms[0] - fp32_step["grad_norm"]) / abs(fp32_step["grad_norm"])}
    if not all(rel[k] <= MOE_FP32_REL_TOL[k] for k in rel):
        raise AssertionError(f"train_moe: step 1 {losses[0]} / {gnorms[0]} against fp32 "
                             f"compute {fp32_step}: {rel} > {MOE_FP32_REL_TOL}")
    ms = statistics.median(step_ms[1:])
    flops, n_active = train_flops(model, path)
    tokens = path.global_batch * path.seq
    model_tflops = flops / (ms / 1e3) / 1e12
    line = {"phase": "train_moe", "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "experts": cfg.n_experts, "top_k": cfg.top_k,
            "global_batch": path.global_batch, "seq": path.seq, "micro_steps": path.micro_steps,
            "tokens_per_step": tokens, "gather_dtype": "bf16", "schedule": "prefetch",
            "boundary": "bucketed", "clip": "exact", "loss": losses, "aux": auxes,
            "grad_norm": gnorms, "step_ms_all": step_ms, "step_ms": ms,
            "tokens_per_s": tokens / (ms / 1e3),
            "model_params": model_params(model),
            "active_params_counted": n_active, "model_tflops": model_tflops,
            "mfu": model_tflops / (PEAK_OPS_PER_S[torch.bfloat16] / 1e12), "peak_gb": peak_gb,
            "rel_err_step1_vs_fp32": rel, "grad_probe": probe,
            "profile_step": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                  "device_kernels", "events_short", "by_kind")},
            "rel_tol_vs_fp32": MOE_FP32_REL_TOL, "launches": launches,
            "attention_launches_by_route": by_route,
            "attention_bwd_launches_by_route": bwd_by_route,
            "rmsnorm_bwd_launches_by_route": rms_bwd_by_route,
            "rglru_launches_by_form": tables[4], "memplan": memplan, "gpu": card}
    emit(line)
    return line


def moe_grad_probe(model, path: TrainPath, batch: dict, dev) -> dict:
    """Step 1's gradients (``accumulate_grads`` on ``init_params(seed=0)``
    and ``batch``) with bf16 compute against fp32 compute on the card, read
    as the loss, the global gradient norm and each segment's gradient norm
    over its pool's rows, relative to fp32's; the worst segment must be
    within ``MOE_FP32_REL_TOL["leaf_norm"]``.  ``fp32``: the loss and the
    grad norm a step reports (the gradient's over the micro-steps' mean).  Two faults are read the same
    way, and each must exceed one of the limits: the routed experts'
    gradients left out (their segments zeroed in the sound bf16 gradients)
    and every routed assignment dropped (``moe_route`` keeping none, so each
    MoE layer is its shared experts)."""
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L

    params = init_params(model, 0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def read(dtype):
        """(each segment's squared gradient norm, the mean loss)."""
        comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(micro_steps=path.micro_steps,
                                                                 gather_dtype=dtype))
        grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train", compute_dtype=dtype,
                                                             comm=comm), params, batch)
        sq = {f"{name}/{seg.name}": g[:, 0, seg.offset:seg.end].double().pow(2).sum().item()
              for name, g in grads.items() for seg in model.pool(name).layout.segments}
        del grads
        torch.cuda.empty_cache()
        return sq, loss.item() / path.micro_steps

    sq32, loss32 = read(torch.float32)
    sq16, loss16 = read(torch.bfloat16)
    route = B.moe_route

    def keep_none(*args, **kw):
        out = route(*args, **kw)
        return (*out[:4], torch.zeros_like(out[4]), out[5])

    B.moe_route = keep_none
    try:
        sq_drop, loss_drop = read(torch.bfloat16)
    finally:
        B.moe_route = route
    del params
    torch.cuda.empty_cache()
    experts = {k for k in sq16 if k.split("/", 1)[1].startswith("moe.")}
    norm32 = math.sqrt(sum(sq32.values()))

    def gaps(sq, loss):
        leaf = {k: abs(math.sqrt(sq[k]) - math.sqrt(v)) / math.sqrt(v)
                for k, v in sq32.items() if v > 0}
        worst = max(leaf, key=leaf.get)
        return {"loss": abs(loss - loss32) / abs(loss32),
                "grad_norm": abs(math.sqrt(sum(sq.values())) - norm32) / norm32,
                "leaf_norm": leaf[worst], "worst_leaf": worst}

    sound = gaps(sq16, loss16)
    faults = {"expert_grads_left_out": gaps({k: 0.0 if k in experts else v
                                             for k, v in sq16.items()}, loss16),
              "routed_experts_dropped": gaps(sq_drop, loss_drop)}
    if not sound["leaf_norm"] <= MOE_FP32_REL_TOL["leaf_norm"]:
        raise AssertionError(f"train_moe: step 1's gradient by segment against fp32 compute "
                             f"{sound} > {MOE_FP32_REL_TOL}")
    for name, f in faults.items():
        if all(f[k] <= MOE_FP32_REL_TOL[k] for k in MOE_FP32_REL_TOL):
            raise AssertionError(f"train_moe: the fault {name} ({f}) is within every limit "
                                 f"{MOE_FP32_REL_TOL}")
    return {"fp32": {"loss": loss32, "grad_norm": norm32 / path.micro_steps}, "sound": sound,
            "faults": faults, "segments": len(sq32),
            "expert_share_of_sq_norm": sum(sq16[k] for k in experts) / sum(sq16.values())}


# -- xlstm-125m and the VLM backbone on one card ----------------------------------

XLSTM_ARCH = "xlstm-125m"
XLSTM_SERVE = {"batch": 4, "prompt": 512, "steps": 32}
# RMSNorm a forward: ln1 and m.hnorm in each of the 9 mLSTM blocks; ln1,
# s.hnorm and ln2 in each of the 3 sLSTM blocks; the final norm.
XLSTM_RMS_A_FORWARD = 2 * 9 + 3 * 3 + 1
XLSTM_CHUNK = 64             # the chunkwise mLSTM: serve_xlstm's check, train_xlstm's form
# The chunkwise prefill against the scan's in fp32 compute, as a fraction of
# the largest |logit|: the two forms are one function in exact arithmetic
# (1.2e-5 apart at fp32 on the CPU, 1.7e-5 on an H100 over 512 tokens;
# in bf16 compute 4.1e-2 and 4.8e-2, each rounding moved in one block
# moving every later block's input through the 12 recurrent blocks).
XLSTM_CHUNK_FP32_REL_TOL = 1e-3
XLSTM_CHUNK_CHECK_TOKENS = 256
XLSTM_BLOCK_TOKENS = 64
# A block at full width in bf16 on the card against fp32 on the CPU, as a
# fraction of the largest |increment| the block adds to its input: bf16
# rounds every weight and activation (the recurrences run in fp32).
XLSTM_BLOCK_REL_TOL = 5e-2
# train_xlstm: 2 micro-steps of 2 x 1024 tokens, mlstm_chunk 64, one step
# (the sLSTM's eager time loop costs about 0.15 M launches a micro-step,
# each at the host's launch cost: the phase is cut in steps and in
# sequence length).  A micro-step:
# RMSNorm 28 forward + 27 recomputed (each super-layer is checkpointed; the
# final norm is not) and 28 backward, all on ``regs`` (d 768 and 1536); no
# attention, no RG-LRU.
XLSTM_TRAIN = TrainPath(XLSTM_ARCH, 4, 2, 1024, 1,
                        {"rmsnorm": 55, "rmsnorm_bwd": 28, "flash_attention": 0,
                         "flash_attention_bwd": 0, "rglru": 0, "rglru_bwd": 0, "quantize": 0,
                         "dequantize": 0},
                        "wgmma", "regs", 0, 0)
# train_xlstm's profile: one micro-step of 2 x 128 tokens (chunkwise, as
# the step's), the card's activity only (the host's op events cost the
# profiler seconds to sort): its launches grow with T, a sLSTM step and
# a mLSTM chunk each running a fixed sequence, so a micro-step at 1024 runs
# about 8 x its kernels (the embedding's, the head's and the loss's do
# not grow).
XLSTM_PROFILE_SEQ = 128
# train_xlstm's step 1 in bf16 against fp32 compute on the card, relative
# (``xlstm_grad_probe``; ``leaf_norm``: the worst segment's gradient norm).
# On an H100 (seed 0, step 1's first micro-step of 2 x 2048) the sound gaps
# read 2.4e-4 (loss), 3.7e-3 (grad norm) and 0.19 (the worst segment: an
# mLSTM's ``m.bif``, 0.2% of the norm, whose forget-gate half sums a signed
# term over every token), the same in every run; the fault (the sLSTM's
# recurrent matrices given zero gradient) 1.0 on those segments.  A read
# with the mLSTM's chunk carry dropped gave 0.51 on ``m.bif`` (at init the
# forget gates, sigma(0) = 0.5, decay a chunk's carry by 2^-64, so that
# fault moves only the chunks' first positions); at ≈ 10 s a read it is
# not repeated here.  At 2 x 1024 the sound gaps read 1.2e-5,
# 6.8e-3 and 0.315 (``m1.m.bif``, 0.14% of the norm: half the tokens sum
# its signed term), 0.9 x the segment limit, which stays as set at 2048.
XLSTM_FP32_REL_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "leaf_norm": 0.35}
XLSTM_PROBE_SHOWN = 4        # the worst segments a probe line lists, with their share of the norm
VLM_ARCH = "llama-3.2-vision-90b"
VLM_SERVE_LAYERS = 5         # one super-layer: 4 self-attention layers, 1 gated cross layer
VLM_FIXED = {"batch": 4, "prompt": 512, "steps": 16}
VLM_GATE = 1.0               # both gates: zero at init, where the cross layer is the identity
VLM_LAYER_TOKENS = 64
VLM_LAYER_REL_TOL = 5e-2     # the cross layer in bf16 against fp32 compute, as XLSTM's blocks


def _timed_serve(prefill_fn, decode_fn, params, batch: dict, steps: int):
    """The counted run of a fixed batch: the launch counters set to 0 and
    the peak reset just before the prefill, then ``steps`` greedy decode
    steps, each timed to its synchronise.  Returns (prefill logits, last
    decode logits, caches, prefill ms, decode ms a step, the ids, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prompt = batch["tokens"].shape[1]
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    decode_ms, out, lg = [], [tok], logits
    for i in range(steps):
        t0 = time.perf_counter()
        lg, tok, caches = decode_fn(params, caches, tok, prompt + i)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    return (logits, lg, caches, prefill_ms, decode_ms, torch.cat(out, dim=1),
            torch.cuda.max_memory_allocated() / 1e9)


def _handoff(prefill_fn, decode_fn, params, batch: dict, want: torch.Tensor) -> dict:
    """Prefill of the prompt's first T - 1 tokens, then one decode step of
    token T - 1 from its caches, against ``want`` (the prefill of all T
    tokens at the last position), as a fraction of the largest |logit|."""
    t = batch["tokens"].shape[1]
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, caches = prefill_fn(params, short)
    got, _, _ = decode_fn(params, caches, batch["tokens"][:, -1:], t - 1)
    err, scale = _rel_err(got[:, -1], want[:, -1])
    if not err <= REL_TOL_DECODE_VS_PREFILL * scale:
        raise AssertionError(f"decode after a prefill of T - 1 tokens is {err} > "
                             f"{REL_TOL_DECODE_VS_PREFILL} x {scale} from the prefill of T")
    return {"max_abs_err": err, "max_abs_logit": scale, "rel_tol": REL_TOL_DECODE_VS_PREFILL}


def _fixed_line(fx: dict, prefill_ms: float, decode_ms: list, peak_gb: float) -> dict:
    med = statistics.median(decode_ms)
    return {"batch": fx["batch"], "prompt": fx["prompt"], "decode_steps": fx["steps"],
            "prefill_ms": prefill_ms, "decode_ms_per_step": med,
            "decode_ms_all": decode_ms, "prefill_tokens_per_s":
                fx["batch"] * fx["prompt"] / (prefill_ms / 1e3),
            "tokens_per_s": fx["batch"] / (med / 1e3), "peak_gb": peak_gb}


def _profile_fields(prof: dict) -> dict:
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "device_kernels",
                                 "events_short", "by_kind")}


def xlstm_block_check(model, params, dev) -> dict:
    """Super-layer 0's first mLSTM block (``m0.``) and its sLSTM block
    (``s0.``) at full width in prefill over 1 x ``XLSTM_BLOCK_TOKENS``
    tokens, bf16 on the card against the same weights in fp32 on the CPU:
    the increment each adds to its input, within ``XLSTM_BLOCK_REL_TOL``."""
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as R

    cfg, bf = model.cfg, torch.bfloat16
    full = model.pool("x").layout.unflatten(params["x"][0, 0])
    gen = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn(1, XLSTM_BLOCK_TOKENS, cfg.d_model, generator=gen, device=dev).to(bf)
    out = {}
    for kind, prefix, block in (("mLSTM", "m0.", R.mlstm_apply), ("sLSTM", "s0.", R.slstm_apply)):
        names = [k for k in full if k.startswith(prefix)]
        with torch.inference_mode():
            y_card, _ = block(cfg, {k: full[k].to(bf) for k in names}, x,
                              L.Ctx(mode="prefill", compute_dtype=bf), prefix=prefix)
            y_cpu, _ = block(cfg, {k: full[k].cpu() for k in names}, x.float().cpu(),
                             L.Ctx(mode="prefill", compute_dtype=torch.float32), prefix=prefix)
        if not bool(torch.isfinite(y_card).all()):
            raise AssertionError(f"serve_xlstm: the {kind} block's card output is not finite")
        err, scale = _rel_err(y_card.float().cpu() - x.float().cpu(), y_cpu - x.float().cpu())
        if not err <= XLSTM_BLOCK_REL_TOL * scale:
            raise AssertionError(f"serve_xlstm: the {kind} block on the card is {err} > "
                                 f"{XLSTM_BLOCK_REL_TOL} x {scale} from fp32 on the CPU")
        out[kind] = {"prefix": prefix, "max_abs_err": err, "max_abs_increment": scale,
                     "rel_tol": XLSTM_BLOCK_REL_TOL}
    return out


def serve_xlstm_phase(card: str, dev) -> dict:
    """``serve_xlstm``: xlstm-125m at full width and depth (12 blocks: pool
    ``x`` x3 of (mLSTM, mLSTM, mLSTM, sLSTM)), ``init_params(seed=0)``, bf16
    gather, the reference's serving default ``mlstm_chunk`` 0 (the prompt
    through the timestep scan): the fixed batch (``XLSTM_SERVE``) through
    ``build_serve_steps``.  Launches a forward: RMSNorm 28, nothing else.
    Checks: the prefill of T - 1 tokens then one decode step against the
    prefill of T (the hand-off of C, n, m, the conv window and the sLSTM's
    c, n, h, m); the prefill at ``mlstm_chunk`` 64 (chunkwise) against the
    scan's; one mLSTM and one sLSTM block against fp32 on the CPU.  A
    profiled prefill and decode step."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    cfg = get_config(XLSTM_ARCH)
    model = build_model(cfg, tp=1)
    params = init_params(model, seed=0, device=dev)
    fx = XLSTM_SERVE

    def steps_at(chunk: int, dtype=torch.bfloat16):
        return build_serve_steps(model, MiCSTopology(), MiCSConfig(
            gather_dtype=dtype, prefetch=True, mlstm_chunk=chunk),
            fx["prompt"] + fx["steps"], device=dev)

    prefill_fn, decode_fn = steps_at(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (fx["batch"], fx["prompt"]), generator=gen,
                                     device=dev)}
    warm = {"tokens": batch["tokens"][:, :XLSTM_CHUNK]}  # the scan's launches a step alike
    logits, caches = prefill_fn(params, warm)           # warm (not counted)
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), XLSTM_CHUNK)
    del logits, caches
    logits, lg, caches, prefill_ms, decode_ms, ids, peak_gb = _timed_serve(
        prefill_fn, decode_fn, params, batch, fx["steps"])
    launches, by_route = read_counts(), dict(FA.launches_by_route)
    fwd = 1 + fx["steps"]
    want = dict.fromkeys(launches, 0) | {"rmsnorm": XLSTM_RMS_A_FORWARD * fwd}
    if launches != want or any(by_route.values()):
        raise AssertionError(f"serve_xlstm: launches {launches} / {by_route} != {want}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(lg.float()).all())
            and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab):
        raise AssertionError("serve_xlstm: non-finite logits or an id outside the vocab")
    handoff = _handoff(prefill_fn, decode_fn, params, batch, logits)
    short = {"tokens": batch["tokens"][:, :XLSTM_CHUNK_CHECK_TOKENS]}
    scan, chunked = (steps_at(c, torch.float32)[0](params, short)[0][:, -1]
                     for c in (0, XLSTM_CHUNK))
    err, scale = _rel_err(chunked, scan)
    if not err <= XLSTM_CHUNK_FP32_REL_TOL * scale:
        raise AssertionError(f"serve_xlstm: the chunkwise prefill in fp32 is {err} > "
                             f"{XLSTM_CHUNK_FP32_REL_TOL} x {scale} from the scan's")
    chunk = {"mlstm_chunk": XLSTM_CHUNK, "tokens": XLSTM_CHUNK_CHECK_TOKENS,
             "compute": "fp32", "max_abs_err": err, "max_abs_logit": scale,
             "rel_tol": XLSTM_CHUNK_FP32_REL_TOL}
    tok = ids[:, -1:]
    pos = fx["prompt"] + fx["steps"]
    prof_d = profile_line(cfg.name, "decode", lambda: decode_fn(params, caches, tok, pos),
                          activities=CARD_ONLY)
    blocks = xlstm_block_check(model, params, dev)
    del params, caches
    return {"phase": "serve_xlstm", "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "model_params": model_params(model), "gather_dtype": "bf16",
            "mlstm_chunk": 0, **_fixed_line(fx, prefill_ms, decode_ms, peak_gb),
            "launches": launches, "attention_launches_by_route": by_route,
            "rmsnorm_a_forward": XLSTM_RMS_A_FORWARD,
            "decode_vs_prefill": handoff, "chunkwise_vs_scan": chunk,
            "blocks_vs_cpu_fp32": blocks, "profile_decode": _profile_fields(prof_d),
            "gpu": card}


def model_params(model) -> int:
    """Every parameter the layout stores (a segment whose name repeats
    counts each time it is stored)."""
    return sum(seg.size * pool.stack for pool in model.all_pools()
               for seg in pool.layout.segments)


def train_xlstm_phase(card: str, dev) -> dict:
    """``train_xlstm``: ``build_train_step`` on xlstm-125m at full width and
    depth from ``init_state(seed=0)`` and the synthetic stream
    (``XLSTM_TRAIN``: bf16 gather, prefetch, bucketed boundary, exact clip,
    ``mlstm_chunk`` 64), the counters set to 0 just before the steps and
    read just after (one micro-step at ``XLSTM_PROFILE_SEQ`` profiled
    before them); its line emitted, step 1's first
    micro-step's gradients by :func:`xlstm_grad_probe` (a line of its
    own).  MFU counts 6 N a token over the layer pools
    and the head; the recurrences' own operations are left out."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, build_train_step, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models.build import build_model
    from repro_torch.optim.adamw import OptConfig

    path = XLSTM_TRAIN
    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    mcfg = MiCSConfig(micro_steps=path.micro_steps, mlstm_chunk=XLSTM_CHUNK)
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                    global_batch=path.global_batch,
                                    micro_steps=path.micro_steps))
    step = build_train_step(model, MiCSTopology(), mcfg,
                            OptConfig(warmup_steps=0, total_steps=path.steps), device=dev)
    state, init = measure_init(init_state, model, 0, device=dev)
    # the profile first: its runs warm the step's kernels and allocations up
    comm = CommEngine.from_config(MiCSTopology(), mcfg)
    ctx = L.Ctx(mode="train", compute_dtype=torch.bfloat16, comm=comm, mlstm_chunk=XLSTM_CHUNK)
    rows, seq = path.global_batch // path.micro_steps, XLSTM_PROFILE_SEQ
    mb = {k: torch.as_tensor(v[:1, :, :seq]).to(dev)
          for k, v in source.global_step_batch(path.steps).items()}
    prof = profile_line(cfg.name, f"train_xlstm micro-step {rows} x {seq}",
                        lambda: accumulate_grads(model, comm, ctx, state["params"], mb),
                        activities=CARD_ONLY)
    torch.cuda.synchronize()
    # the profile's blocks, cut for its shorter sequence, are not the step's:
    # its reserve is read from the state alone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, gnorms, step_ms = [], [], []
    for i in range(path.steps):
        t0 = time.perf_counter()
        state, m = step(state, source.global_step_batch(i))
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(m["grad_norm"].item())
    tables = check_train_launches("train_xlstm", path, path.steps * path.micro_steps)
    launches, by_route, bwd_by_route, rms_bwd_by_route, rglru_by_form = tables
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memplan = plan_against_peak("train_xlstm", model, step.mcfg, path,
                                torch.cuda.max_memory_allocated(), init)
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train_xlstm: losses {losses}, grad norms {gnorms}")
    del state, step
    torch.cuda.empty_cache()
    ms = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    flops, n_params = train_flops(model, path)
    tokens = path.global_batch * path.seq
    model_tflops = flops / (ms / 1e3) / 1e12
    line = {"phase": "train_xlstm", "arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "global_batch": path.global_batch, "seq": path.seq,
            "micro_steps": path.micro_steps, "tokens_per_step": tokens, "gather_dtype": "bf16",
            "schedule": "prefetch", "boundary": "bucketed", "clip": "exact",
            "mlstm_chunk": XLSTM_CHUNK, "loss": losses, "grad_norm": gnorms,
            "step_ms_all": step_ms, "step_ms": ms, "tokens_per_s": tokens / (ms / 1e3),
            "model_params": model_params(model), "flops_params_counted": n_params,
            "flops_note": "6 N a token; the mLSTM and sLSTM recurrences' own operations are "
                          "left out",
            "model_tflops": model_tflops,
            "mfu": model_tflops / (PEAK_OPS_PER_S[torch.bfloat16] / 1e12), "peak_gb": peak_gb,
            "profile_micro_step": {"rows": rows, "seq": seq, **_profile_fields(prof)},
            "device_kernels_step_est": prof["device_kernels"] * path.seq // seq
                                       * path.micro_steps,
            "launches": launches, "attention_launches_by_route": by_route,
            "attention_bwd_launches_by_route": bwd_by_route,
            "rmsnorm_bwd_launches_by_route": rms_bwd_by_route,
            "rglru_launches_by_form": rglru_by_form, "memplan": memplan, "gpu": card}
    emit(line)
    xlstm_grad_probe(model, source.global_step_batch(0), dev)
    return line


def xlstm_grad_probe(model, batch: dict, dev) -> dict:
    """Step 1's first micro-step's gradients (``accumulate_grads`` on
    ``init_params(seed=0)`` and ``batch[:1]``, ``mlstm_chunk`` 64; the
    micro-step's time loops make each read cost seconds) with bf16 compute
    against fp32 compute on the card, read as ``moe_grad_probe`` reads
    them: the loss, the global gradient norm and each segment's gradient
    norm relative to fp32's; each must be within ``XLSTM_FP32_REL_TOL``.
    A fault is read the same way and must exceed one limit: the sLSTM's
    recurrent matrices given zero gradient (their segments zeroed in the
    sound bf16 gradients).  The sLSTM's input-gate biases ``s.bi`` are left out of
    the segments: their gradient is zero but for rounding (a constant added
    to every input-gate logit scales c and n alike).  Its line is emitted
    before the limits are checked."""
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import layers as L

    params = init_params(model, 0, device=dev)
    batch = {k: torch.as_tensor(v[:1]).to(dev) for k, v in batch.items()}

    def read(dtype):
        comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(gather_dtype=dtype))
        grads, loss, _ = accumulate_grads(model, comm, L.Ctx(
            mode="train", compute_dtype=dtype, comm=comm, mlstm_chunk=XLSTM_CHUNK), params, batch)
        sq = {f"{name}/{seg.name}@{seg.offset}":
              g[:, 0, seg.offset:seg.end].double().pow(2).sum().item()
              for name, g in grads.items() for seg in model.pool(name).layout.segments}
        del grads
        torch.cuda.empty_cache()
        return sq, loss.item()

    sq32, loss32 = read(torch.float32)
    sq16, loss16 = read(torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    norm32 = math.sqrt(sum(sq32.values()))

    def gaps(sq, loss):
        leaf = {k: abs(math.sqrt(sq[k]) - math.sqrt(v)) / math.sqrt(v)
                for k, v in sq32.items() if v > 0 and ".s.bi@" not in k}
        worst = sorted(leaf, key=leaf.get, reverse=True)[:XLSTM_PROBE_SHOWN]
        return {"loss": abs(loss - loss32) / abs(loss32),
                "grad_norm": abs(math.sqrt(sum(sq.values())) - norm32) / norm32,
                "leaf_norm": leaf[worst[0]], "worst_leaves": {
                    k: [leaf[k], math.sqrt(sq32[k]) / norm32] for k in worst}}

    recurrent = {k for k in sq16 if re.search(r"\.s\.r[zifo]@", k)}
    sound = gaps(sq16, loss16)
    faults = {"slstm_recurrent_grads_zero": gaps({k: 0.0 if k in recurrent else v
                                                  for k, v in sq16.items()}, loss16)}
    out = {"phase": "train_xlstm_probe", "arch": model.cfg.name,
           "micro_steps_read": 1, "fp32": {"loss": loss32, "grad_norm": norm32},
           "sound": sound,
           "faults": faults, "segments": len(sq32), "limits": XLSTM_FP32_REL_TOL,
           "recurrent_share_of_sq_norm": sum(sq16[k] for k in recurrent) / sum(sq16.values())}
    emit(out)
    if not all(sound[k] <= XLSTM_FP32_REL_TOL[k] for k in XLSTM_FP32_REL_TOL):
        raise AssertionError(f"train_xlstm: step 1's gradient against fp32 compute {out}")
    for name, f in faults.items():
        if all(f[k] <= XLSTM_FP32_REL_TOL[k] for k in XLSTM_FP32_REL_TOL):
            raise AssertionError(f"train_xlstm: the fault {name} is within every limit {out}")
    return out


def vlm_layer_check(model, params, vision: torch.Tensor, dev) -> dict:
    """The gated cross layer (``x.``, gates at ``VLM_GATE``) at full width
    in prefill over 1 x ``VLM_LAYER_TOKENS`` tokens attending to the 1,024
    vision rows of the fixed batch's first request: bf16 on the card
    (cross attention on ``mma``) against fp32 compute on the card (the
    ``fma`` route), the increment it adds to its input within
    ``VLM_LAYER_REL_TOL``."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models.dims import attn_dims

    cfg, bf, f32 = model.cfg, torch.bfloat16, torch.float32
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 1)
    full = model.pool("layers").layout.unflatten(params["layers"][0, 0])
    t32 = {k: v for k, v in full.items() if k.startswith("x.")}
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn(1, VLM_LAYER_TOKENS, cfg.d_model, generator=gen, device=dev).to(bf)
    ys, routes = {}, {}
    for dt, t in ((bf, {k: v.to(bf) for k, v in t32.items()}), (f32, t32)):
        before = dict(FA.launches_by_route)
        with torch.inference_mode():
            y, _ = B.cross_layer_apply(cfg, ad, t, x.to(dt), L.Ctx(
                mode="prefill", compute_dtype=dt, vision=vision[:1].to(dt)), prefix="x.")
        ys[dt] = y.float()
        routes[str(dt)[6:]] = [r for r, n in FA.launches_by_route.items() if n != before[r]]
        del t
    if routes != {"bfloat16": ["mma"], "float32": ["fma"]}:
        raise AssertionError(f"serve_vlm: the cross layer's attention routes {routes}")
    if not bool(torch.isfinite(ys[bf]).all()):
        raise AssertionError("serve_vlm: the cross layer's card output is not finite")
    err, scale = _rel_err(ys[bf] - x.float(), ys[f32] - x.float())
    if not err <= VLM_LAYER_REL_TOL * scale:
        raise AssertionError(f"serve_vlm: the cross layer in bf16 is {err} > "
                             f"{VLM_LAYER_REL_TOL} x {scale} from fp32 compute")
    return {"tokens": VLM_LAYER_TOKENS, "vision_rows": vision.shape[1], "routes": routes,
            "max_abs_err": err, "max_abs_increment": scale, "rel_tol": VLM_LAYER_REL_TOL}


def serve_vlm_phase(card: str, dev) -> dict:
    """``serve_vlm``: llama-3.2-vision-90b at full width cut to one
    super-layer (4 self-attention layers and 1 gated cross layer; the
    embedding and head whole), ``init_params(seed=0)`` with both gates set
    to ``VLM_GATE``, bf16 gather: the fixed batch (``VLM_FIXED``) and the
    serve launcher's stub (``launch/serve.stub_batch``: the tokens, then
    normal vision rows [4, 1024, 8192] in bf16, from ``default_rng(0)``)
    through ``build_serve_steps``.  Launches a forward: RMSNorm 11,
    attention 5 (the prefill's 4 self + 1 cross on ``mma``; each decode
    step's 4 self + 1 cross, over the cached vision K/V, on ``split``).
    Checks: the prefill / decode hand-off across the cached cross K/V, and
    the cross layer against fp32 compute (:func:`vlm_layer_check`)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.launch.serve import stub_batch
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_SERVE_LAYERS)
    model = build_model(cfg, tp=1)
    n_params = model_params(model)
    params = init_params(model, seed=0, device=dev)
    layout = model.pool("layers").layout
    for gate in ("x.gate_attn", "x.gate_mlp"):
        seg = layout.seg(gate)
        params["layers"][:, 0, seg.offset:seg.end] = VLM_GATE
    fx, n_self = VLM_FIXED, cfg.cross_interval
    prefill_fn, decode_fn = build_serve_steps(
        model, MiCSTopology(), MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True),
        fx["prompt"] + fx["steps"], device=dev)
    batch = stub_batch(cfg, fx["batch"], fx["prompt"], 0, dev)
    logits, caches = prefill_fn(params, batch)          # warm (not counted)
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), fx["prompt"])
    del logits, caches
    logits, lg, caches, prefill_ms, decode_ms, ids, peak_gb = _timed_serve(
        prefill_fn, decode_fn, params, batch, fx["steps"])
    launches, by_route = read_counts(), dict(FA.launches_by_route)
    fwd = 1 + fx["steps"]
    want = dict.fromkeys(launches, 0) | {"rmsnorm": (2 * (n_self + 1) + 1) * fwd,
                                         "flash_attention": (n_self + 1) * fwd}
    want_route = {"mma": n_self + 1, "split": (n_self + 1) * fx["steps"], "fma": 0, "paged": 0}
    if launches != want or by_route != want_route:
        raise AssertionError(f"serve_vlm: launches {launches} / {by_route} != {want} / "
                             f"{want_route}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(lg.float()).all())
            and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab):
        raise AssertionError("serve_vlm: non-finite logits or an id outside the vocab")
    cross = caches["layers"]["x"]
    if tuple(cross["k"].shape) != (1, fx["batch"], cfg.n_vision_tokens, cfg.n_kv_heads,
                                   cfg.resolved_head_dim):
        raise AssertionError(f"serve_vlm: the cross cache {tuple(cross['k'].shape)}")
    handoff = _handoff(prefill_fn, decode_fn, params, batch, logits)
    tok, pos = ids[:, -1:], fx["prompt"] + fx["steps"] - 1
    prof = profile_line(cfg.name, "decode", lambda: decode_fn(params, caches, tok, pos))
    del caches, logits, lg
    torch.cuda.empty_cache()
    layer = vlm_layer_check(model, params, batch["vision"], dev)
    del params
    torch.cuda.empty_cache()
    return {"phase": "serve_vlm", "arch": cfg.name, "layers": cfg.n_layers,
            "layers_full": get_config(VLM_ARCH).n_layers, "d_model": cfg.d_model,
            "vision_rows": cfg.n_vision_tokens, "model_params": n_params,
            "model_gb_fp32": 4 * n_params / 1e9, "gates": VLM_GATE, "gather_dtype": "bf16",
            **_fixed_line(fx, prefill_ms, decode_ms, peak_gb), "launches": launches,
            "attention_launches_by_route": by_route, "decode_vs_prefill": handoff,
            "cross_layer_vs_fp32": layer, "profile_decode": _profile_fields(prof), "gpu": card}


# -- whisper-large-v3 and the paper's LayerNorm + GeLU models on one card ------------

WHISPER_ARCH = "whisper-large-v3"
WHISPER_FIXED = {"batch": 4, "prompt": 64, "steps": 32}
WHISPER_LAYER_TOKENS = 64    # the decoder layer's check: 64 tokens over the 1,500 frames
LN_LAYER_REL_TOL = 5e-2      # a layer in bf16 against fp32 compute, as the VLM's cross layer
# train_whisper: 2 micro-steps of 2 x (1,500 frames + 448 tokens), 3 steps.
# Launches a micro-step: attention 96 forward (32 encoder, 32 self, 32
# cross) + 96 recomputed, on mma, and 96 backward on wgmma (dh 64, g 1
# divides 64); LayerNorm and GeLU are PyTorch calls (no TPU kernel
# computes them), no RMSNorm.
WHISPER_TRAIN = TrainPath(WHISPER_ARCH, 4, 2, 448, 3,
                          {"rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention": 192,
                           "flash_attention_bwd": 96, "rglru": 0, "rglru_bwd": 0,
                           "quantize": 0, "dequantize": 0},
                          "wgmma", "regs", 0, 0)
# train_whisper's step 1 (bf16 compute) against fp32 compute on the card,
# relative, read as moe_grad_probe reads it (the loss, the grad norm, the
# worst segment's gradient norm).  Set before the first card run from
# train_moe's sound gaps (3.0e-5 / 1.2e-4 / 2.2e-3) and xLSTM's (its worst
# segment 0.19, a segment whose gradient is rounding), ten times over the
# gaps expected; the fault (the encoder's gradient zeroed) reads 1.0 on
# every encoder segment.  The key biases ``attn.bk`` / ``xattn.bk`` are
# left out of the segments: a bias added to every key adds the same
# q . bk to each of a row's scores, so their gradient is zero but for
# rounding.
WHISPER_FP32_REL_TOL = {"loss": 1e-3, "grad_norm": 1e-2, "leaf_norm": 5e-2}
BERT_ARCH = "bert-10b"
BERT_FIXED = {"batch": 4, "prompt": 512, "steps": 16}
BERT50_ARCH = "bert-50b"     # dh 8192 // 40 = 204: the padded route (256)
BERT50_LAYERS = 2
# train_bert: bert-10b cut to 16 of its 127 layers, 2 micro-steps of 4 x
# 512, 3 steps; attention 16 + 16 on mma and 16 backward on wgmma a
# micro-step (dh 64, g 1).
BERT_TRAIN_LAYERS = 16
BERT_TRAIN = TrainPath(BERT_ARCH, 8, 2, 512, 3,
                       {"rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention": 32,
                        "flash_attention_bwd": 16, "rglru": 0, "rglru_bwd": 0, "quantize": 0,
                        "dequantize": 0},
                       "wgmma", "regs", 0, 0)


def _serve_run(label: str, model, params, batch: dict, fx: dict, dev, want_attention: dict):
    """A fixed batch through ``build_serve_steps`` (bf16 gather, prefetch):
    warmed once, then the counted run (:func:`_timed_serve`), its launches
    held to ``want_attention`` (attention's by route; every other kernel
    0), finite logits and ids in the vocab, the T - 1 hand-off
    (:func:`_handoff`), a profiled decode step and prefill.  Returns (line,
    the run's caches)."""
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import layers as L
    from repro_torch.runtime.serving import build_serve_steps

    cfg = model.cfg
    prefill_fn, decode_fn = build_serve_steps(
        model, MiCSTopology(), MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True),
        fx["prompt"] + fx["steps"], device=dev)
    logits, caches = prefill_fn(params, batch)          # warm (not counted)
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), fx["prompt"])
    del logits, caches   # their blocks stay cached: the timed run allocates as a steady one
    logits, lg, caches, prefill_ms, decode_ms, ids, peak_gb = _timed_serve(
        prefill_fn, decode_fn, params, batch, fx["steps"])
    launches, by_route, padded = read_counts(), dict(FA.launches_by_route), L.launches_padded
    want = dict.fromkeys(launches, 0) | {"flash_attention": sum(want_attention.values())}
    want_route = dict.fromkeys(FA.ROUTES, 0) | want_attention
    if launches != want or by_route != want_route:
        raise AssertionError(f"{label}: launches {launches} / {by_route} != {want} / "
                             f"{want_route}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(torch.isfinite(lg.float()).all())
            and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab):
        raise AssertionError(f"{label}: non-finite logits or an id outside the vocab")
    handoff = _handoff(prefill_fn, decode_fn, params, batch, logits)
    tok, pos = ids[:, -1:], fx["prompt"] + fx["steps"] - 1
    prof = profile_line(cfg.name, "decode", lambda: decode_fn(params, caches, tok, pos),
                        activities=CARD_ONLY)
    prof_p = profile_line(cfg.name, "prefill", lambda: prefill_fn(params, batch),
                          activities=CARD_ONLY)
    line = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "head_dim": cfg.resolved_head_dim, "model_params": model_params(model),
            "model_gb_fp32": 4 * model_params(model) / 1e9, "gather_dtype": "bf16",
            **_fixed_line(fx, prefill_ms, decode_ms, peak_gb), "launches": launches,
            "attention_launches_by_route": by_route, "attention_launches_padded": padded,
            "decode_vs_prefill": handoff, "profile_decode": _profile_fields(prof),
            "profile_prefill": _profile_fields(prof_p)}
    return line, caches


def ln_layer_check(label: str, apply, tensors: dict, x: torch.Tensor,
                   enc_out: torch.Tensor | None = None) -> dict:
    """``apply(tensors, x, ctx)`` (one layer at full width) bf16 on the card
    (attention on ``mma``) against fp32 compute on the card (``fma``): the
    increment it adds to its input within ``LN_LAYER_REL_TOL``.  Without
    ``enc_out`` the layer runs as the encoder runs its layers (train mode,
    no cache), with it as a decoder layer's prefill over ``x`` (its cache
    at ``x``'s length) attending to ``enc_out``.  Both sides take the same
    inputs, rounded to bf16 once.  The caller draws ``x`` at std 0.1: the
    layer normalises its input first, so its increment does not depend on
    the input's scale, while a residual stream at std 1 carries bf16's own
    rounding (half an ulp of |y| ≈ 4 is 0.016, twice a layer) at 4–7% of
    the increment, which would hide the layer's compute error."""
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import layers as L

    bf, f32 = torch.bfloat16, torch.float32
    x = x.to(bf).float()
    enc_out = None if enc_out is None else enc_out.to(bf).float()
    ys, routes = {}, {}
    for dt in (bf, f32):
        before = dict(FA.launches_by_route)
        t = {k: v.to(dt) for k, v in tensors.items()}
        ctx = (L.Ctx(mode="train", compute_dtype=dt) if enc_out is None else
               L.Ctx(mode="prefill", compute_dtype=dt, cache_len=x.shape[1],
                     enc_out=enc_out.to(dt)))
        with torch.inference_mode():
            y = apply(t, x.to(dt), ctx)
        ys[dt] = y.float()
        routes[str(dt)[6:]] = sorted(r for r, n in FA.launches_by_route.items()
                                     if n != before[r])
        del t
    if routes != {"bfloat16": ["mma"], "float32": ["fma"]}:
        raise AssertionError(f"{label}: attention routes {routes}")
    if not bool(torch.isfinite(ys[bf]).all()):
        raise AssertionError(f"{label}: the card output is not finite")
    err, scale = _rel_err(ys[bf] - x.float(), ys[f32] - x.float())
    if not err <= LN_LAYER_REL_TOL * scale:
        raise AssertionError(f"{label}: bf16 is {err} > {LN_LAYER_REL_TOL} x {scale} from fp32 "
                             "compute")
    return {"tokens": x.shape[1], "routes": routes, "max_abs_err": err,
            "max_abs_increment": scale, "rel_tol": LN_LAYER_REL_TOL}


def serve_whisper_phase(card: str, dev) -> dict:
    """``serve_whisper``: whisper-large-v3 at full width and depth (32
    encoder and 32 decoder layers, d 1280, 20 heads, dh 64),
    ``init_params(seed=0)`` (norm scales and biases 0), bf16 gather: the
    fixed batch (``WHISPER_FIXED``) and the serve launcher's stub
    (``launch/serve.stub_batch``: the tokens, then normal audio frames [4,
    1500, 1280] in bf16 from ``default_rng(0)``) through
    ``build_serve_steps``.  Launches: the prefill's attention 96 on ``mma``
    (the encoder's non-causal self-attention over the 1,500 frames, the
    decoder's causal self-attention and its cross-attention over the
    encoder output, 32 each), each decode step's 64 on ``split`` (self over
    the cache, cross over the cached 1,500 encoder K/V); no RMSNorm
    (LayerNorm is a PyTorch call).  Checks: the prefill / decode hand-off; the cross
    caches' shape; encoder layer 0 and decoder layer 0 against fp32 compute
    (:func:`ln_layer_check`)."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import init_params
    from repro_torch.launch.serve import stub_batch
    from repro_torch.models import blocks as B
    from repro_torch.models.build import build_model
    from repro_torch.models.dims import attn_dims

    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, tp=1)
    params = init_params(model, seed=0, device=dev)
    fx = WHISPER_FIXED
    batch = stub_batch(cfg, fx["batch"], fx["prompt"], 0, dev)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    line, caches = _serve_run("serve_whisper", model, params, batch, fx, dev,
                              {"mma": n_enc + 2 * n_dec, "split": 2 * n_dec * fx["steps"]})
    cross = caches["dec"]["cross"]["k"]
    if tuple(cross.shape) != (n_dec, fx["batch"], cfg.n_audio_frames, cfg.n_kv_heads,
                              cfg.resolved_head_dim):
        raise AssertionError(f"serve_whisper: the cross cache {tuple(cross.shape)}")
    del caches
    torch.cuda.empty_cache()
    ad = attn_dims(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 1)
    gen = torch.Generator(device=dev).manual_seed(31)
    enc_t = model.pool("enc").layout.unflatten(params["enc"][0, 0])
    dec_t = model.pool("dec").layout.unflatten(params["dec"][0, 0])
    frames = torch.randn(1, cfg.n_audio_frames, cfg.d_model, generator=gen, device=dev)
    x = 0.1 * torch.randn(1, WHISPER_LAYER_TOKENS, cfg.d_model, generator=gen, device=dev)
    layers = {
        "encoder_layer": ln_layer_check(
            "serve_whisper encoder layer 0",
            lambda t, h, ctx: B.dense_layer_apply(cfg, ad, t, h, ctx, causal=False)[0],
            enc_t, 0.1 * frames),
        "decoder_layer": ln_layer_check(
            "serve_whisper decoder layer 0",
            lambda t, h, ctx: B.encdec_dec_apply(cfg, ad, t, h, ctx)[0],
            dec_t, x, enc_out=frames)}
    del params, enc_t, dec_t
    torch.cuda.empty_cache()
    return {"phase": "serve_whisper", **line, "encoder_layers": n_enc,
            "audio_frames": cfg.n_audio_frames, "layers_vs_fp32": layers, "gpu": card}


def serve_bert_phase(card: str, dev) -> dict:
    """``serve_bert``: the paper's bert-10b at full depth (127 layers, d
    2560, 40 heads, dh 64; 40.6 GB of fp32 rows), ``init_params(seed=0)``,
    bf16 gather, the fixed batch (``BERT_FIXED``: prompts from
    ``default_rng(0)``) through ``build_serve_steps``: attention 127 on
    ``mma`` at the prefill and 127 on ``split`` a decode step; then bert-50b
    cut to ``BERT50_LAYERS`` layers (d 8192, 40 heads of dh 204) at the same
    shapes, every attention call through the padded route (dh 204 padded
    to 256: ``attention_launches_padded`` equals its launches), and the
    paged engine at its head dim (:func:`_padded_engine_check`).  Each: the
    hand-off, profiles of a decode step and a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.mics import init_params
    from repro_torch.launch.serve import stub_batch
    from repro_torch.models.build import build_model

    fx = BERT_FIXED
    out = {}
    for arch, layers in ((BERT_ARCH, None), (BERT50_ARCH, BERT50_LAYERS)):
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        model = build_model(cfg, tp=1)
        params = init_params(model, seed=0, device=dev)
        batch = stub_batch(cfg, fx["batch"], fx["prompt"], 0, dev)
        line, caches = _serve_run(f"serve_bert {arch}", model, params, batch, fx, dev,
                                  {"mma": cfg.n_layers, "split": cfg.n_layers * fx["steps"]})
        padded = cfg.resolved_head_dim not in (16, 32, 64, 128, 256)
        want_padded = cfg.n_layers * (1 + fx["steps"]) if padded else 0
        if line["attention_launches_padded"] != want_padded:
            raise AssertionError(f"serve_bert {arch}: {line['attention_launches_padded']} "
                                 f"padded calls, want {want_padded}")
        out[arch] = {**line, "layers_full": full.n_layers}
        if padded:
            out[arch]["engine"] = _padded_engine_check(model, params, caches, batch, fx, dev)
        del params, caches
        torch.cuda.empty_cache()
    return {"phase": "serve_bert", "runs": out, "gpu": card}


BERT50_ENGINE = {"lengths": (512, 300, 100, 200), "block": 16, "steps": 4}


def _padded_engine_check(model, params, caches, batch: dict, fx: dict, dev) -> dict:
    """The paged engine at bert-50b's head dim: its pools stored at the
    padded width (204 at 256), the serve run's contiguous caches copied in
    (``pages_from_contiguous``) at ragged prompt lengths
    (``BERT50_ENGINE``), then ``steps`` greedy steps of the paged step over
    bf16 pools against the contiguous step (the same padded ``paged``
    route over a pool of one block a request), logits and tokens bit for
    bit; int8 pools fed the same tokens, their logits within
    ``PAGED_INT8_REL_TOL`` of the bf16 pools'.  Each paged step's
    attention is counted on the ``paged`` route's ``mma`` body (dh 256)
    and as padded calls.  Consumes ``caches``."""
    import numpy as np

    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import layers as L
    from repro_torch.runtime import paged as PG

    ex, topo = BERT50_ENGINE, MiCSTopology()
    lengths, bs, steps = list(ex["lengths"]), ex["block"], ex["steps"]
    b, cap = len(lengths), fx["prompt"] + fx["steps"]
    mb = -(-cap // bs)
    tables = np.arange(1, b * mb + 1, dtype=np.int32).reshape(b, mb)
    seeds, temps = np.arange(b, dtype=np.int64), np.zeros(b, np.float32)
    first = batch["tokens"].cpu()[torch.arange(b), torch.as_tensor(lengths) - 1].numpy()
    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, kv_block_size=bs)
    logits, fed, runs = {}, [first], {}
    for kv in ("bf16", "int8"):
        pool = PG.init_paged_caches(model, topo, b * mb + 1, bs, kv, device=dev)
        width = pool["layers"]["k"].shape[-1]
        PG.pages_from_contiguous(model, topo, caches, pool, tables, lengths, block_size=bs,
                                 kv_dtype=kv)
        step = PG.build_paged_step(model, topo, dataclasses.replace(mcfg, kv_dtype=kv),
                                   max_blocks=mb, block_size=bs, device=dev)
        padded0, mma0 = L.launches_padded, FA.launches_paged_by_form["paged:mma"]
        logits[kv] = []
        for s in range(steps):
            tok, lg, pool = step(params, pool, fed[s][:, None], np.asarray(lengths) + s,
                                 np.ones(b), tables, seeds, temps)
            logits[kv].append(lg)
            if kv == "bf16":
                fed.append(tok.cpu().numpy())
        runs[kv] = {"pool_width": width, "padded_calls": L.launches_padded - padded0,
                    "paged_mma_launches": FA.launches_paged_by_form["paged:mma"] - mma0}
        want = model.cfg.n_layers * steps
        if width != FA.padded_head_dim(model.cfg.resolved_head_dim) \
                or runs[kv]["padded_calls"] != want \
                or runs[kv]["paged_mma_launches"] != want:
            raise AssertionError(f"serve_bert engine {kv}: {runs[kv]}, want {want} of each")
        del pool
    contig = PG.build_contiguous_step(model, topo, mcfg, cap, device=dev)
    for s in range(steps):
        tok, lg, caches = contig(params, caches, fed[s][:, None], np.asarray(lengths) + s, seeds,
                                 temps)
        if not (torch.equal(lg, logits["bf16"][s]) and np.array_equal(tok.cpu().numpy(),
                                                                      fed[s + 1])):
            raise AssertionError(f"serve_bert engine: paged != contiguous at step {s}")
    rel = max(float((a.float() - c.float()).abs().max() / c.float().abs().max())
              for a, c in zip(logits["int8"], logits["bf16"]))
    if not rel <= PAGED_INT8_REL_TOL:
        raise AssertionError(f"serve_bert engine: int8 pools {rel} from bf16's > "
                             f"{PAGED_INT8_REL_TOL}")
    return {**ex, "runs": runs, "paged_equals_contiguous": True, "int8_vs_bf16_rel": rel,
            "int8_rel_tol": PAGED_INT8_REL_TOL}


def encdec_train_flops(model, path: TrainPath) -> tuple[float, int, int]:
    """Model flops of one whisper step: 6 N_enc a frame and 6 N_dec a
    token (N the encoder's layers; the decoder's layers and the head; the
    embeddings do no product), plus 12 dh a (query, key) pair and head in
    each attention sub-layer: the encoder's every frame pair, the decoder's
    causal pairs and its (token, frame) pairs.  Recomputation is not
    counted.  Returns (flops, N_enc, N_dec)."""
    cfg = model.cfg
    size = lambda pool: sum(s.size for s in pool.layout.segments) * pool.stack  # noqa: E731
    n_enc = size(model.pool("enc"))
    n_dec = size(model.pool("dec")) + size(model.head)
    seqs = path.global_batch
    frames, tokens = seqs * cfg.n_audio_frames, seqs * path.seq
    per_pair = 12 * cfg.resolved_head_dim * cfg.n_heads
    pairs = seqs * (cfg.n_encoder_layers * cfg.n_audio_frames ** 2
                    + cfg.n_layers * (path.seq * (path.seq + 1) // 2
                                      + path.seq * cfg.n_audio_frames))
    return 6 * n_enc * frames + 6 * n_dec * tokens + per_pair * pairs, n_enc, n_dec


def _train_run(label: str, model, path: TrainPath, batch_of, dev) -> dict:
    """``build_train_step`` (bf16 gather, prefetch, bucketed boundary, exact
    clip) from ``init_state(seed=0)`` for ``path.steps`` steps of
    ``batch_of(step)``, the counters set to 0 just before and read just
    after (``check_train_launches``), then a step profiled."""
    from repro_torch.core.mics import MiCSConfig, build_train_step, init_state
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.optim.adamw import OptConfig

    step = build_train_step(model, MiCSTopology(), MiCSConfig(micro_steps=path.micro_steps),
                            OptConfig(warmup_steps=0, total_steps=path.steps), device=dev)
    state, init = measure_init(init_state, model, 0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, gnorms, step_ms = [], [], []
    for i in range(path.steps):
        t0 = time.perf_counter()
        state, m = step(state, batch_of(i))
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(m["grad_norm"].item())
    tables = check_train_launches(label, path, path.steps * path.micro_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memplan = plan_against_peak(label, model, step.mcfg, path, torch.cuda.max_memory_allocated(),
                                init)
    batch = batch_of(path.steps)    # two more steps: a warm one, the profiled
    prof = profile_line(model.cfg.name, f"{label} step",
                        lambda: step(state, batch)[1]["loss"].item(), activities=CARD_ONLY)
    del state, step
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{label}: losses {losses}, grad norms {gnorms}")
    ms = statistics.median(step_ms[1:])
    return {"phase": label, "arch": model.cfg.name, "layers": model.cfg.n_layers,
            "d_model": model.cfg.d_model, "global_batch": path.global_batch, "seq": path.seq,
            "micro_steps": path.micro_steps, "gather_dtype": "bf16", "schedule": "prefetch",
            "boundary": "bucketed", "clip": "exact", "loss": losses, "grad_norm": gnorms,
            "step_ms_all": step_ms, "step_ms": ms, "peak_gb": peak_gb,
            "model_params": model_params(model), "profile_step": _profile_fields(prof),
            "launches": tables[0], "attention_launches_by_route": tables[1],
            "attention_bwd_launches_by_route": tables[2],
            "rmsnorm_bwd_launches_by_route": tables[3], "rglru_launches_by_form": tables[4],
            "memplan": memplan}


def _mfu(flops: float, ms: float) -> dict:
    tflops = flops / (ms / 1e3) / 1e12
    return {"model_tflops": tflops, "mfu": tflops / (PEAK_OPS_PER_S[torch.bfloat16] / 1e12)}


def whisper_batches(cfg, path: TrainPath, dev):
    """``batch_of(step)``: the synthetic stream's tokens, targets and mask
    [2, 2, 448] and normal audio frames [2, 2, 1500, 1280] in bf16, drawn
    on the card from a generator seeded with the step."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                    global_batch=path.global_batch, micro_steps=path.micro_steps))
    rows = path.global_batch // path.micro_steps

    def batch_of(step: int) -> dict:
        gen = torch.Generator(device=dev).manual_seed(1000 + step)
        audio = torch.randn(path.micro_steps, rows, cfg.n_audio_frames, cfg.d_model,
                            generator=gen, device=dev).to(torch.bfloat16)
        return {**source.global_step_batch(step), "audio": audio}

    return batch_of


def train_whisper_phase(card: str, dev) -> dict:
    """``train_whisper``: whisper-large-v3 at full width and depth through
    ``build_train_step`` (``WHISPER_TRAIN``: 2 micro-steps of 2 x (1,500
    frames + 448 tokens), 3 steps; :func:`_train_run`), its line with MFU
    from :func:`encdec_train_flops`; first step 1's gradients by
    :func:`whisper_grad_probe` (its own line)."""
    from repro_torch.configs import get_config
    from repro_torch.models.build import build_model

    path = WHISPER_TRAIN
    cfg = get_config(path.arch)
    model = build_model(cfg, tp=1)
    batch_of = whisper_batches(cfg, path, dev)
    probe = whisper_grad_probe(model, batch_of(0), dev)
    line = _train_run("train_whisper", model, path, batch_of, dev)
    flops, n_enc, n_dec = encdec_train_flops(model, path)
    frames, tokens = path.global_batch * cfg.n_audio_frames, path.global_batch * path.seq
    line.update({"encoder_layers": cfg.n_encoder_layers, "audio_frames": cfg.n_audio_frames,
                 "frames_per_step": frames, "tokens_per_step": tokens,
                 "tokens_per_s": tokens / (line["step_ms"] / 1e3),
                 "frames_and_tokens_per_s": (frames + tokens) / (line["step_ms"] / 1e3),
                 "flops_per_step": flops, "flops_params": {"encoder": n_enc, "decoder": n_dec},
                 "flops_note": "6 N_enc a frame + 6 N_dec a token (N_dec with the head) + 12 dh "
                               "a (query, key) pair and head: encoder frame pairs, decoder "
                               "causal pairs, (token, frame) pairs",
                 **_mfu(flops, line["step_ms"]),
                 "rel_err_step1_vs_fp32": {k: probe["sound"][k] for k in ("loss", "grad_norm")},
                 "gpu": card})
    emit(line)
    return line


def whisper_grad_probe(model, batch: dict, dev) -> dict:
    """Step 1's gradients (``accumulate_grads`` on ``init_params(seed=0)``
    and ``batch``, both micro-steps) with bf16 compute against fp32 compute
    on the card (the ``fma`` routes), read as ``moe_grad_probe`` reads
    them: the loss, the global gradient norm and each segment's gradient
    norm over its pool's rows, the encoder's included, relative to fp32's;
    each within ``WHISPER_FP32_REL_TOL``.  A fault is read the same way and
    must exceed one limit: the encoder's gradients zeroed (its segments
    zeroed in the sound bf16 gradients: what a dropped encoder output
    gradient gives).  The key biases are left out of the segments (their
    gradient is rounding).  Its line is emitted before the limits are
    checked."""
    from repro_torch.core.comm import CommEngine
    from repro_torch.core.mics import MiCSConfig, accumulate_grads, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models import layers as L

    micro = batch["tokens"].shape[0]
    params = init_params(model, 0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def read(dtype):
        comm = CommEngine.from_config(MiCSTopology(), MiCSConfig(micro_steps=micro,
                                                                 gather_dtype=dtype))
        grads, loss, _ = accumulate_grads(model, comm, L.Ctx(mode="train", compute_dtype=dtype,
                                                             comm=comm), params, batch)
        sq = {f"{name}/{seg.name}": g[:, 0, seg.offset:seg.end].double().pow(2).sum().item()
              for name, g in grads.items() for seg in model.pool(name).layout.segments
              if not seg.name.endswith("attn.bk")}
        del grads
        torch.cuda.empty_cache()
        return sq, loss.item() / micro

    sq32, loss32 = read(torch.float32)
    sq16, loss16 = read(torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    norm32 = math.sqrt(sum(sq32.values()))

    def gaps(sq, loss):
        leaf = {k: abs(math.sqrt(sq[k]) - math.sqrt(v)) / math.sqrt(v)
                for k, v in sq32.items() if v > 0}
        worst = sorted(leaf, key=leaf.get, reverse=True)[:XLSTM_PROBE_SHOWN]
        return {"loss": abs(loss - loss32) / abs(loss32),
                "grad_norm": abs(math.sqrt(sum(sq.values())) - norm32) / norm32,
                "leaf_norm": leaf[worst[0]], "worst_leaves": {
                    k: [leaf[k], math.sqrt(sq32[k]) / norm32] for k in worst}}

    encoder = {k for k in sq16 if k.startswith("enc/")}
    sound = gaps(sq16, loss16)
    faults = {"encoder_grads_zero": gaps({k: 0.0 if k in encoder else v
                                          for k, v in sq16.items()}, loss16)}
    out = {"phase": "train_whisper_probe", "arch": model.cfg.name, "micro_steps_read": micro,
           "fp32": {"loss": loss32, "grad_norm": norm32 / micro}, "sound": sound,
           "faults": faults, "segments": len(sq32), "limits": WHISPER_FP32_REL_TOL,
           "encoder_share_of_sq_norm": sum(sq16[k] for k in encoder) / sum(sq16.values())}
    emit(out)
    if not all(sound[k] <= WHISPER_FP32_REL_TOL[k] for k in WHISPER_FP32_REL_TOL):
        raise AssertionError(f"train_whisper: step 1's gradient against fp32 compute {out}")
    for name, f in faults.items():
        if all(f[k] <= WHISPER_FP32_REL_TOL[k] for k in WHISPER_FP32_REL_TOL):
            raise AssertionError(f"train_whisper: the fault {name} is within every limit {out}")
    return out


def train_bert_phase(card: str, dev) -> dict:
    """``train_bert``: the paper's bert-10b at full width cut to
    ``BERT_TRAIN_LAYERS`` layers (its whole training state at 127 layers is
    ≈ 162 GB) through ``build_train_step`` (``BERT_TRAIN``: 2 micro-steps
    of 4 x 512 from the synthetic stream, 3 steps; :func:`_train_run`)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.build import build_model

    path = BERT_TRAIN
    full = get_config(path.arch)
    cfg = dataclasses.replace(full, n_layers=BERT_TRAIN_LAYERS)
    model = build_model(cfg, tp=1)
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq=path.seq,
                                    global_batch=path.global_batch, micro_steps=path.micro_steps))
    line = _train_run("train_bert", model, path, source.global_step_batch, dev)
    flops, n_params = train_flops(model, path)
    tokens = path.global_batch * path.seq
    line.update({"layers_full": full.n_layers, "tokens_per_step": tokens,
                 "tokens_per_s": tokens / (line["step_ms"] / 1e3),
                 "flops_params_counted": n_params, **_mfu(flops, line["step_ms"]),
                 "gpu": card})
    emit(line)
    return line


# The host link's fit: pinned copies of these sizes each way, each the
# median of HOST_LINK_REPS CUDA-event times.
HOST_LINK_BYTES = (64 * 2**20, 2**30)
HOST_LINK_REPS = 5
# The card profile's host tier against the fit, relative (core/linkmodel.H100_P5).
HOST_LINK_RTOL = 0.10


def host_link_phase(card: str, dev) -> dict:
    """``host_link``: the device <-> host link the autotuner prices the host
    carry and host moments on (``core/linkmodel``'s ``host`` tier).  Pinned
    host memory to the card and back at ``HOST_LINK_BYTES``, each the median
    of ``HOST_LINK_REPS`` CUDA-event times after a warm copy; the two sizes
    fit ``t = alpha + n / bandwidth`` each way, printed beside the card
    profile's tier (the middle of this card's fits on four hosts, 51.7
    GB/s, 5 µs), whose bandwidth must be within ``HOST_LINK_RTOL`` of each
    way's fit."""
    from repro_torch.core.linkmodel import H100_P5

    fits = {}
    for way in ("d2h", "h2d"):
        ms = []
        for n in HOST_LINK_BYTES:
            card_buf = torch.empty(n, dtype=torch.uint8, device=dev)
            host_buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            src, dst = (card_buf, host_buf) if way == "d2h" else (host_buf, card_buf)
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            reps = []
            for _ in range(HOST_LINK_REPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                dst.copy_(src, non_blocking=True)
                end.record()
                end.synchronize()
                reps.append(start.elapsed_time(end))
            ms.append(statistics.median(reps))
            del card_buf, host_buf, src, dst
        (n1, n2), (t1, t2) = HOST_LINK_BYTES, (m / 1e3 for m in ms)
        bw = (n2 - n1) / (t2 - t1)
        fits[way] = {"ms": dict(zip((f"{n // 2**20} MiB" for n in HOST_LINK_BYTES), ms)),
                     "bandwidth_gb_s": bw / 1e9, "alpha_us": (t1 - n1 / bw) * 1e6}
        if not (math.isfinite(bw) and bw > 0):
            raise AssertionError(f"host_link {way}: the fit {fits[way]}")
    torch.cuda.empty_cache()
    host = H100_P5.host
    off = {way: host.bandwidth / 1e9 / f["bandwidth_gb_s"] - 1 for way, f in fits.items()}
    if not all(abs(x) <= HOST_LINK_RTOL for x in off.values()):
        raise AssertionError(f"host_link: the profile's {host.bandwidth / 1e9} GB/s is off the "
                             f"card's fit by {off} (limit {HOST_LINK_RTOL})")
    return {"phase": "host_link", "fit": fits, "profile_off_fit": off,
            "profile": {"name": H100_P5.name, "bandwidth_gb_s": host.bandwidth / 1e9,
                        "alpha_us": host.alpha * 1e6}, "gpu": card}


# The dryrun phase (launch/dryrun.py): rank 0 of the production world, 16 x
# 16 at tp 16, under the fake process group, at full width: llama3.2-1b's
# train_4k (4 micro-steps of 4 rows x 4,096 tokens) and decode_32k (8 rows,
# one step at the last of 32,768 positions).  The fake group moves no data,
# so no loss or logits are held.
DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_CELLS = ("train_4k", "decode_32k")
# A step's counted matrix products against the config's
# (roofline/analysis.dense_rank_dot_flops: the rank's matrices, a KV head
# that two ranks of the model group share at tp 16 over 8 KV heads computed
# on each, the layers' recompute, attention at 18 dh a visible (query, key)
# pair and local head, decode 2 a weight and 4 dh a pair), and the flash
# kernels' reported products against that attention.  Both are exact
# counts: dropping the layers' recompute or every flash report moves them by
# 10% or more.
DRYRUN_FLOPS_RTOL = 0.01


def dryrun_expected_flops(rec: dict, cfg) -> dict:
    """The rank's expected products a step of the cell ``rec``
    (:data:`DRYRUN_FLOPS_RTOL`): ``{"matmul", "attention", "total"}``."""
    from repro_torch.roofline.analysis import dense_rank_dot_flops

    return dense_rank_dot_flops(cfg, tp=rec["tp"], kind=rec["kind"],
                                rows=max(rec["memplan"]["local_batch"], 1), seq=rec["seq"],
                                micro_steps=rec["micro_steps"])


def dryrun_phase(card: str, dev) -> dict:
    """``dryrun``: ``launch/dryrun.run_cell`` on the card for each of
    :data:`DRYRUN_CELLS` (the counters set to 0 just before, read just
    after), each held: the rank's peak over what was live before it against
    the plan within ``CARD_PLAN_RTOL`` and its reserve within the plan's
    ``reserved_bytes``; the census's calls equal ``predict_traffic``'s at
    every stage; the boundary's hop-2 collectives the bucket plan's; the
    counted dot flops within :data:`DRYRUN_FLOPS_RTOL` of
    :func:`dryrun_expected_flops`' total, the kernels' reported products
    within it of its attention."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import memplan as MP
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rglru import kernel as RG
    from repro_torch.kernels.rmsnorm import kernel as RN
    from repro_torch.launch import dryrun as DR

    out = ROOT / "build" / "dryrun"
    cells = {}
    reset_counts()
    for shape in DRYRUN_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        rec = DR.run_cell(DRYRUN_ARCH, shape, False,
                          MiCSConfig(micro_steps=DR.TRAIN_MICRO_STEPS), out_dir=out, device=dev)
        label = f"dryrun {shape}"
        mem, meas = rec["memplan"], rec["measured"]
        peak = meas["max_memory_allocated"] - meas["allocated_before"]
        reserved = meas["max_memory_reserved"] - meas["reserved_before"]
        ratio = mem["total_bytes"] / peak
        if not abs(ratio - 1) <= min(MP.MEM_RTOL, CARD_PLAN_RTOL):
            raise AssertionError(f"{label}: the plan {mem['total_bytes'] / 1e9:.3f} GB is not "
                                 f"within {CARD_PLAN_RTOL} of the rank's peak {peak / 1e9:.3f} GB")
        if not reserved <= mem["reserved_gib"] * 2**30:
            raise AssertionError(f"{label}: the allocator reserved {reserved / 1e9:.3f} GB, over "
                                 f"the plan's {mem['reserved_gib'] * 2**30 / 1e9:.3f} GB with "
                                 "its reserve")
        bad = {k: v for k, v in rec["autotune_cross_check"].items()
               if v["predicted_count"] != v["measured_count"]}
        if bad:
            raise AssertionError(f"{label}: census calls differ from predict_traffic's: {bad}")
        if "boundary" in rec and not rec["boundary"]["bucket_count_match"]:
            raise AssertionError(f"{label}: {rec['boundary']['measured']} hop-2 collectives, the "
                                 f"plan's {rec['boundary']['n_hop2_collectives']}")
        want = dryrun_expected_flops(rec, get_config(DRYRUN_ARCH))
        flops_ratio = rec["stats"]["dot_flops"] / want["total"]
        kernel_ratio = rec["stats"]["kernel_dot_flops"] / want["attention"]
        if not abs(flops_ratio - 1) <= DRYRUN_FLOPS_RTOL:
            raise AssertionError(f"{label}: counted dot flops {rec['stats']['dot_flops']:.4e} "
                                 f"over the config's {want['total']:.4e} = {flops_ratio:.6f}")
        if not abs(kernel_ratio - 1) <= DRYRUN_FLOPS_RTOL:
            raise AssertionError(f"{label}: the kernels' reported products "
                                 f"{rec['stats']['kernel_dot_flops']:.4e} over the config's "
                                 f"attention {want['attention']:.4e} = {kernel_ratio:.6f}")
        stats = {k: rec["stats"][k] for k in ("dot_flops", "hbm_bytes", "ici_wire_bytes",
                                               "dci_wire_bytes", "n_collectives",
                                               "kernel_launches", "kernel_dot_flops")}
        cells[shape] = {
            "mesh": rec["mesh"], "tp": rec["tp"], "partition_size": rec["partition_size"],
            "replication_degree": rec["replication_degree"], "ran": rec["ran"],
            "local_batch": rec["memplan"].get("local_batch"), "run_s": rec["run_s"],
            "plan_gb": mem["total_bytes"] / 1e9, "moment": mem["moment"],
            "peak_gb": peak / 1e9, "plan_over_peak": ratio, "reserved_gb": reserved / 1e9,
            "reserved_over_plan": reserved / mem["total_bytes"],
            "census": {k: {"calls": v["measured_count"], "ratio": v["ratio"]}
                       for k, v in rec["autotune_cross_check"].items()},
            "boundary": {k: rec["boundary"][k] for k in ("n_hop2_collectives",
                                                           "bucket_count_match")}
            if "boundary" in rec else None,
            "stats": stats, "expected_flops": want, "dot_flops_over_expected": flops_ratio,
            "kernel_flops_over_attention": kernel_ratio}
    launches = read_counts()
    by_route = dict(FA.launches_by_route)
    return {"phase": "dryrun", "arch": DRYRUN_ARCH, "cells": cells, "launches": launches,
            "attention_launches_by_route": by_route,
            "attention_bwd_launches_by_route": dict(FA.launches_bwd_by_route),
            "rmsnorm_bwd_launches_by_route": dict(RN.launches_bwd_by_route),
            "rglru_launches_by_form": {"forward": dict(RG.launches_by_form),
                                       "backward": dict(RG.launches_bwd_by_form)},
            "flops_rtol": DRYRUN_FLOPS_RTOL, "card_rtol": CARD_PLAN_RTOL, "gpu": card}


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
# The autotuner's variant (``policy="auto"``) runs under a budget of the
# card's whole memory in GiB (``torch.cuda.get_device_properties``): at p 1
# every candidate moves nothing and the tie goes to the smallest footprint.
KNOB_AUTO = "auto"
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
    the GB it copied down and up, its seconds, the memory plan beside the
    peak (:func:`plan_against_peak`); for ``KNOB_PROFILED``, a profile of
    two more steps' second.  ``KNOB_AUTO``: ``policy="auto"`` under the
    card's whole memory in GiB, gated at the path's batch, its chosen
    config printed, bitwise the train phase, its peak and reserve under
    the budget; first two budgets must raise ``MemoryBudgetError`` from
    ``build_train_step`` with nothing allocated on the card
    (:func:`knobs_auto_refusal`)."""
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
    budget_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    auto_kw = {"policy": "auto", "hbm_budget_gb": budget_gib}
    variants, totals = {}, {}
    for name, kw, held_to in (*KNOB_VARIANTS, (KNOB_AUTO, auto_kw, "bitwise")):
        t0 = time.perf_counter()
        mcfg = MiCSConfig(micro_steps=path.micro_steps, **kw)
        auto, shapes = {}, {"local_batch": path.global_batch // path.micro_steps, "seq": path.seq}
        if name == KNOB_AUTO:
            auto = knobs_auto_refusal(model, mcfg, oc, dev, shapes,
                                      variants["remat"]["memplan"]["reserved_gb"] * 1e9)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step = build_train_step(model, MiCSTopology(), mcfg, oc, device=dev, **shapes)
        state, init = measure_init(init_state, model, 0, device=dev, offload_opt=mcfg.offload_opt)
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
        peak = torch.cuda.max_memory_allocated()
        line = {"peak_gb": peak / 1e9,
                "memplan": plan_against_peak(f"train_knobs {name}", model, step.mcfg, path,
                                             peak, init),
                "pinned_gb": hostoffload.pinned_bytes() / 1e9,
                "carry_slot_gb": stash.slot_bytes() / 1e9,
                "step_ms": step_ms[-1], "step_ms_all": step_ms,
                "copied_gb_step": moved[-1], "loss": [g[0] for g in got],
                "grad_norm": [g[1] for g in got], "launches": tables[0]}
        if name == KNOB_AUTO:
            reserved = torch.cuda.max_memory_reserved()
            if not (peak <= budget_gib * 2**30 and reserved <= budget_gib * 2**30):
                raise AssertionError(f"train_knobs auto: peak {peak} / reserved {reserved} "
                                     f"bytes over the {budget_gib} GiB budget")
            chosen = step.mcfg
            line.update(auto, budget_gib=budget_gib, chosen={
                "hierarchical": chosen.hierarchical, "gather_order": chosen.gather_order,
                "gather_dtype": str(chosen.gather_dtype).removeprefix("torch."),
                "quant_gather": chosen.quant_gather, "hop1_wire_dtype": chosen.hop1_wire_dtype,
                "compress_hop2": chosen.compress_hop2, "prefetch_carry": chosen.prefetch_carry,
                "carry_offload": chosen.carry_offload,
                "boundary_schedule": chosen.boundary_schedule,
                "hop2_bucket_mb": chosen.hop2_bucket_mb, "clip_mode": chosen.clip_mode})
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


def knobs_auto_refusal(model, mcfg, oc, dev, shapes: dict, remat_reserved: float) -> dict:
    """Under ``mcfg`` (``policy="auto"`` and a budget) the autotuner's plan
    at the path's batch ``shapes`` (the gate ``build_train_step`` applies)
    and with the model states alone; then two budgets that
    ``build_train_step`` must refuse with ``MemoryBudgetError`` before
    anything is allocated on the card (``init_state`` never runs): 0.99 of
    the smallest numerics-eligible candidate's reserve, and the midpoint
    between the states-only plan and ``remat_reserved``, the bytes the
    remat variant's run reserved (a budget a gate without the batch and
    the reserve admits, and that run overran).  Returns the chosen
    candidate's footprint, the smallest, and the refusals."""
    from repro_torch.core import memplan as MP
    from repro_torch.core.autotune import resolve_config
    from repro_torch.core.mics import build_train_step
    from repro_torch.core.topology import MiCSTopology

    _, plan = resolve_config(mcfg, model, MiCSTopology(), mode="train", **shapes)
    _, bare = resolve_config(mcfg, model, MiCSTopology(), mode="train")
    eligible = [c for c in plan.candidates if not (c.lossy_wire or c.lossy_hop2 or c.lossy_hop1)
                and c.clip_mode == "exact"]
    smallest = min(c.mem_bytes * MP.RESERVE_FACTOR + c.reserve_excess for c in eligible)
    between = (bare.chosen.mem_bytes + remat_reserved) / 2 / 2**30
    if not bare.chosen.mem_bytes / 2**30 < between < remat_reserved / 2**30:
        raise AssertionError(f"train_knobs auto: no budget between the states-only plan "
                             f"{bare.chosen.mem_bytes} and the remat run's reserve "
                             f"{remat_reserved} bytes")
    refusals = {}
    for key, budget in (("below_smallest", 0.99 * smallest / 2**30),
                        ("states_only_to_reserve", between)):
        low = dataclasses.replace(mcfg, hbm_budget_gb=budget)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        try:
            build_train_step(model, MiCSTopology(), low, oc, device=dev, **shapes)
        except MP.MemoryBudgetError as e:
            refusals[key] = {"budget_gib": budget, "error": str(e)}
        else:
            raise AssertionError(f"train_knobs auto: a budget of {budget} GiB was not refused")
        if torch.cuda.memory_allocated() != before:
            raise AssertionError("train_knobs auto: the refused budget allocated on the card")
    return {"plan_gib": plan.chosen.mem_bytes / 2**30,
            "plan_reserved_gib": (plan.chosen.mem_bytes * MP.RESERVE_FACTOR
                                  + plan.chosen.reserve_excess) / 2**30,
            "states_only_gib": bare.chosen.mem_bytes / 2**30,
            "remat_reserved_gib": remat_reserved / 2**30,
            "smallest_candidate_reserved_gib": smallest / 2**30, "refusals": refusals,
            "ranking": plan.table(top=6)}


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |b|), in fp32 on the CPU."""
    a, b = a.float().cpu(), b.float().cpu()
    return (a - b).abs().max().item(), b.abs().max().item()


def train_consistency_phase(path: TrainPath, dev):
    """``train_consistency``: ``path``'s weights at its cut depth (full
    width), one micro-step of 1 x ``cut_tokens`` tokens.  Bitwise on the
    card: serial == prefetch (loss and gradients), serial == bucketed
    boundary (params, m, v, grad_norm), and a step run twice.  Card
    against CPU, one step of ``build_train_step`` on each: loss, grad_norm,
    every pool's gradient (each step's ``accumulate_grads`` read as it
    returns, before the boundary) and the params after the AdamW step."""
    from repro_torch.configs import get_config
    from repro_torch.core import mics as M
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

    def grads(prefetch: bool):
        comm = CommEngine.from_config(topo, MiCSConfig(prefetch=prefetch))
        return accumulate_grads(model2, comm, ctx, dict(params), batch)

    g_pre, loss_pre, _ = grads(True)
    g_ser, loss_ser, _ = grads(False)
    if not (torch.equal(loss_pre, loss_ser) and all(torch.equal(g_pre[k], g_ser[k]) for k in g_pre)):
        raise AssertionError("train_consistency: serial != prefetch on the card")
    del g_pre, g_ser

    oc = OptConfig(warmup_steps=0)
    card_grads, grad_err = {}, {}

    def read_grads(*args, **kw):
        """``accumulate_grads`` inside a step: the card's gradients to the
        host, the CPU's held against them (before the boundary's update)."""
        g, loss_sum, aux_sum = accumulate_grads(*args, **kw)
        for k, v in g.items():
            if v.is_cuda:
                card_grads[k] = v.cpu()
                continue
            err, scale = _rel_err(card_grads[k], v)
            grad_err[k] = {"max_abs_err": err, "max_abs_grad": scale}
            if not err <= REL_TOL_GRAD_CARD_VS_CPU * scale:
                raise AssertionError(f"train_consistency: pool {k} gradient card vs CPU {err} > "
                                     f"{REL_TOL_GRAD_CARD_VS_CPU} x {scale}")
        return g, loss_sum, aux_sum

    def one_step(boundary: str, on, read: bool = False):
        mc = MiCSConfig(micro_steps=1, boundary_schedule=boundary)
        p = {k: v.to(on, copy=True) for k, v in params.items()}
        state = {"params": p, "m": {k: torch.zeros_like(v) for k, v in p.items()},
                 "v": {k: torch.zeros_like(v) for k, v in p.items()}, "step": 0}
        step = build_train_step(model2, topo, mc, oc, device=on)
        if read:
            M.accumulate_grads = read_grads
        try:
            return step(state, batch)
        finally:
            M.accumulate_grads = accumulate_grads

    def same(a, b):
        return torch.equal(a[1]["grad_norm"], b[1]["grad_norm"]) and all(
            torch.equal(a[0][part][k], b[0][part][k]) for part in ("params", "m", "v")
            for k in a[0][part])

    bucketed = one_step("bucketed", dev, read=True)
    if not same(bucketed, one_step("serial", dev)):
        raise AssertionError("train_consistency: serial != bucketed boundary on the card")
    if not same(bucketed, one_step("bucketed", dev)):
        raise AssertionError("train_consistency: a step run twice differs on the card")
    t_cpu = time.perf_counter()
    cpu = one_step("bucketed", "cpu", read=True)
    cpu_s = time.perf_counter() - t_cpu
    if sorted(grad_err) != sorted(params):
        raise AssertionError(f"train_consistency: gradients read for {sorted(grad_err)}")
    loss_card, loss_cpu = bucketed[1]["loss"].item(), cpu[1]["loss"].item()
    if not abs(loss_card - loss_cpu) <= REL_TOL_GRAD_CARD_VS_CPU * abs(loss_cpu):
        raise AssertionError(f"train_consistency: loss {loss_card} vs {loss_cpu}")
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
          "card_vs_cpu": {"loss": [loss_card, loss_cpu],
                          "grad_norm": [gn_card, gn_cpu], "grads": grad_err,
                          "rel_tol": REL_TOL_GRAD_CARD_VS_CPU,
                          "params_after_step_max_abs_err": param_err,
                          "params_tol": ADAMW_STEP_TOL_LR * oc.lr_max,
                          "cpu_step_s": cpu_s}})


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
# what the script's limit leaves once the phases after it (the xLSTM, VLM,
# whisper and bert phases ≈ 100 s, digest and kernels ≈ 60 s) have their
# share: its gloo steps follow the host's speed, and a deadline of its own
# would fail a slow host that still ends in time.
SCRIPT_LIMIT_S = 1200
AFTER_DIST_S = 180


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
    steps: int = 2
    micro_steps: int | None = None   # None: the train path's; else its rows a micro-step


# Layout A: one partition group of 4, the paper's three-stage gather
# (outer_first, inner 2); layout B: 2 partition groups of 2 (the staged
# gather degenerates to one flat gather at p = 2) x 2 replicas, so hop 2
# and the bucketed boundary run across replicas.  Layout C: llama over p 2
# x tp 2 (the flat gather at p 2 under tensor parallelism: GQA at kv_gather
# 1, the vocab-parallel loss over 128,256 columns).  A, B and C cut llama to
# 4 layers at full width.  Layout D: recurrentgemma-2b cut to one (rec,
# rec, attn) super-layer over tp 4 (10 Q heads padded to 12, its one KV
# head gathered over the 4 model ranks, LRU width 640 and d_ff 1920 a rank,
# the norm scales gathered).  C, D and E start from their model's
# ``init_params(seed=0)`` at tp 1 cut by ``convert.tp_params_from_full``,
# written as the loop's step-0 checkpoint.  Every layout runs 2 steps, and
# A, B and C one micro-step of llama's rows (1 x 2048 a data rank): the 4
# ranks' gloo collectives go through the host's memory, every micro-step
# gathers llama's two 262.7 M-element vocabulary rows again, and on a host
# shared with other machines llama's full depth, a third step and a second
# micro-step took the workers past the script's time limit (PERF.md).  D
# runs 2 of the griffin path's micro-steps (2 x 2048 rows
# each), E the MoE path's 2.
DIST_LAYOUTS = (DistLayout("A", "llama3.2-1b", 1, 4, 1, "outer_first", 2, 4, micro_steps=1),
                DistLayout("B", "llama3.2-1b", 2, 2, 1, "inner_first", None, 4, micro_steps=1),
                DistLayout("C", "llama3.2-1b", 1, 2, 2, "inner_first", None, 4, micro_steps=1),
                DistLayout("D", "recurrentgemma-2b", 1, 1, 4, "inner_first", None, 3,
                           micro_steps=2),
                DistLayout("E", MOE_ARCH, 1, 1, 4, "inner_first", None, 1))
# Layout E: deepseek-moe-16b at full width cut to 1 layer over tp 4, p 1: 16
# experts a rank, each rank routing 1/4 of a micro-step's 4096 tokens (the
# token-sharded dispatch, 1024 tokens: one chunk, 120 slots an expert) and
# the expert exchange over the model group; it starts, as C and D, from the
# tp 1 model's weights cut by ``tp_params_from_full`` into the loop's step-0
# checkpoint.
# Layout E against a one-card run of its cut model, as the reference's own
# ``moe_tp_equiv`` (tests/dist_harness.py): token sharding changes each
# rank's n and with it the capacity, so other tokens are dropped.
DIST_MOE_TOL = {"rtol": 0.03, "atol": 0.05}
# Layouts A-D against a one-card run of their cut model on the same
# weights, data and global batch (``dist_reference``): step 1's loss and
# grad_norm (both sides round to bf16, hop 1 and the model-axis psums sum
# in bf16 over the ranks), then step 2 at the reference's
# ``mics_fidelity`` rtol.
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
    """The one-card train path of ``layout``'s model (its data and routes),
    at the layout's micro-steps where it sets them (the same rows a
    micro-step, so a global batch of that many micro-steps)."""
    path = next(tp for tp in (*TRAIN, MOE_TRAIN) if tp.arch == layout.arch)
    if layout.micro_steps is None:
        return path
    rows = path.global_batch // path.micro_steps
    return dataclasses.replace(path, micro_steps=layout.micro_steps,
                               global_batch=rows * layout.micro_steps)


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
    the backward's one; and a step's norm psum over the model group.  An
    MoE layer (with shared experts, whose psum is the row's last) adds, a
    micro-step, the expert exchange 6 times a dispatch chunk (2 in the
    forward, 2 in the recompute, 2 in the backward) and, on the
    token-sharded path, the gather of y twice and its reduce-scatter once
    and aux's mean over the model group 3 times (a psum)."""
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
            psums = sum(seg.name.endswith(("attn.wo", "rec.wo", "mlp.wd", "shared.wd"))
                        for seg in pool.layout.segments)
            add("all_reduce:model", (3 * psums - 1) * pool.stack * micro)
        if model.cfg.family == "moe":
            from repro_torch.models.blocks import moe_chunk

            if not model.cfg.n_shared_experts:
                raise NotImplementedError("the MoE count rules assume shared experts (the "
                                          "row's last psum)")
            path = dist_train_path(layout)
            n = path.global_batch // path.micro_steps // topo.data_parallel_size * path.seq
            sharded = n % tp == 0 and n >= tp
            n = n // tp if sharded else n
            layers = model.cfg.n_layers * micro
            add("all_to_all:model", 6 * (n // moe_chunk(n)) * layers)
            if sharded:
                add("all_gather:model", 2 * layers)
                add("reduce_scatter:model", layers)
                add("all_reduce:model", 3 * layers)
        add("all_gather:model", 2 * micro)       # the embedding, the final norm scale
        add("reduce_scatter:model", 2 * micro)
        add("all_reduce_max:model", micro)
        add("all_reduce:model", 3 * micro + steps)
    return dict(sorted(calls.items()))


def dist_census(layout: DistLayout, model, path: TrainPath, per: list) -> dict:
    """The autotuner's analytical census (``core/autotune.predict_traffic``,
    the bucketed boundary) of ``layout``'s step beside each rank's
    ``CommCounter`` in the same units (``census_from_counter``), stage by
    stage (``compare_census``): the calls of every stage the ``CommEngine``
    owns must be equal; the wire bytes are printed with their ratio."""
    from repro_torch.core.autotune import census_from_counter, compare_census, predict_traffic
    from repro_torch.core.comm import policies_from_config
    from repro_torch.core.mics import MiCSConfig

    topo = dist_topology(layout)
    gp, sp = policies_from_config(MiCSConfig(micro_steps=path.micro_steps,
                                             gather_order=layout.gather_order,
                                             hierarchy_inner=layout.inner))
    pred = predict_traffic(model, topo, gp, sp, micro_steps=path.micro_steps,
                           boundary="bucketed", hop2_bucket_mb=32.0)["by_stage"]
    out = {}
    for r, p in enumerate(per):
        cmp = compare_census(pred, census_from_counter(p["comm"], topo, gp, steps=layout.steps))
        bad = {k: v for k, v in cmp.items() if v["predicted_count"] != v["measured_count"]}
        if bad:
            raise AssertionError(f"dist_train {layout.name} rank {r}: census counts {bad}")
        out = out or {k: {"calls_step": v["measured_count"],
                          "predicted_wire_bytes_step": v["predicted_wire_bytes"],
                          "measured_wire_bytes_step": v["measured_wire_bytes"],
                          "ratio": v["ratio"]} for k, v in cmp.items()}
    return out


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
        topo_n, _, _ = TL.resize_for_world(model, mcfg, entry["world"], tp=1,
                                           partition_size=p_prev, available=DIST_WORLD)
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


# -- serving over the same 4 ranks (dist_serve) ----------------------------------

# (a) the engine: llama3.2-1b at full width cut to DIST_SERVE_LAYERS layers,
# layout C's topology (p 2 x tp 2, dp 2), bf16 gather and pools, 4 slots a
# data rank, every tick at the chunk width 64, blocks of 16 (17 a table:
# the longest prompt and its new tokens), 8 requests from seed 0 (prompts
# 64-256, 8 new tokens, odd ones at temperature 0.7 with top-k 8), one
# every 2 ticks.  (b) the fixed batch: recurrentgemma-2b cut to layout D's 3
# layers over tp 4: batch 4, prompt 512, 8 greedy decode steps.
DIST_SERVE_LAYERS = 4
DIST_SERVE = PagedServe(slots=4, chunk=64, block=16, max_blocks=17, requests=8,
                        prompt_lo=64, prompt_hi=256, new_tokens=8, arrival_every=2,
                        temperature=0.7, top_k=8, decode_lens=(150, 256))
DIST_SERVE_PREEMPT = "preempt@6x2"       # ranks 2-3 lost abruptly at tick 6
DIST_SERVE_FIXED = {"batch": 4, "prompt": 512, "steps": 8}
# The rank-0 logits of (a)'s first tick and of every (b) step, gathered over
# the model group, against a one-card tp 1 run of the same cut model on the
# same inputs, as a fraction of the one-card run's largest |logit|: bf16
# activations summed over the model ranks in another order (each rank's
# row-parallel output rounded to bf16 before the sum).  Measured on the
# card (NVIDIA H100 80GB HBM3, 700.00 W): 0.0133 at (a)'s first tick,
# 0.0127-0.0164 over (b)'s 9 steps; the bound keeps 1.8x of that.
DIST_SERVE_REL_TOL = 0.03


def dist_serve_model(arch: str, layers: int, tp: int):
    from repro_torch.configs import get_config
    from repro_torch.models.build import build_model

    return build_model(dataclasses.replace(get_config(arch), n_layers=layers), tp=tp)


def dist_serve_weights(model, model_1, dev):
    """``model_1``'s ``init_params(seed=0)`` on the card and its cut into
    ``model``'s tp shards (``convert.tp_params_from_full``) in host memory,
    one pool at a time."""
    from repro_torch.convert import tp_params_from_full
    from repro_torch.core.mics import init_params

    full = init_params(model_1, 0, device=dev)
    cut = {name: tp_params_from_full(model, model_1, {name: t.cpu()})[name]
           for name, t in full.items()}
    return full, cut


def _model_gather(x, groups):
    from repro_torch.core import collectives as C

    return C.all_gather(x.contiguous(), groups.model, axis=-1)


def _against_one_card(got, want, vocab: int) -> dict:
    """Rank 0's gathered logits ``got`` [rows, V] against the one-card run's
    ``want``: the largest error relative to the largest |logit| (real vocab
    columns), and greedy agreement on every row whose one-card top-1 margin
    exceeds twice the bound."""
    got, want = got[:, :vocab].float(), want[:, :vocab].float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])
    sure = margin > 2 * DIST_SERVE_REL_TOL * scale
    agree = torch.argmax(got, -1) == torch.argmax(want, -1)
    return {"max_abs_err": err, "max_abs_logit": scale, "rel_err": err / scale,
            "rows": got.shape[0], "rows_past_margin": int(sure.sum()),
            "greedy_agree_past_margin": bool(agree[sure].all()),
            "greedy_agree_all": int(agree.sum())}


def dist_serve_run(rank: int, dev, backend: str, timeout) -> dict:
    """One rank of ``dist_serve``.  (a) The engine through
    ``runtime/resilient.ResilientServeLoop`` from ``elastic_host_topology(n,
    n / 2, tp 2)``: fault-free on 4 ranks, fault-free on 2 (ranks 2-3
    parked), and with ``DIST_SERVE_PREEMPT``; each run's launches set to 0
    just before it and read just after, its engine steps counted on this
    rank; the first tick's logit rows of this rank gathered over the model
    group; then rank 0 runs the first tick's rows of data rank 0 on one card
    at tp 1.  (b) The fixed batch through ``build_serve_steps`` on layout
    D's groups: prefill, then greedy decode steps, each step's logits of
    rank 0's rows gathered over the model group; then rank 0 runs the same
    cut model at tp 1 on one card, fed the same tokens."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.convert import shard_params
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology, elastic_host_topology
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.launch.mesh import MiCSGroups
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.runtime import batching as RB
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig
    from repro_torch.runtime.serving import build_serve_steps

    pg, out = DIST_SERVE, {"engine": {}, "fixed": {}}
    model = dist_serve_model("llama3.2-1b", DIST_SERVE_LAYERS, 2)
    model_1 = dist_serve_model("llama3.2-1b", DIST_SERVE_LAYERS, 1)
    full, cut = dist_serve_weights(model, model_1, dev)
    if rank:
        full = None
    torch.cuda.empty_cache()
    mcfg = MiCSConfig(kv_block_size=pg.block)     # bf16 gather and pools, prefetch
    sc = ServeLoopConfig(slots_local=pg.slots, nb_local=pg.slots * pg.max_blocks + 1,
                         block_size=pg.block, max_blocks=pg.max_blocks, chunk=pg.chunk,
                         top_k=pg.top_k, reserve="full", seed=0)
    arrivals = [pg.arrival_every * i for i in range(pg.requests)]
    first = {}

    def run(name: str, world: int, spec: str):
        topo = elastic_host_topology(world, world // 2, 2, available=DIST_WORLD)
        groups = MiCSGroups(topo, rank, backend=backend, timeout=timeout)
        loop = ResilientServeLoop(
            model, topo, mcfg, sc, params_for=lambda m, t: shard_params(m, t, rank, cut,
                                                                       device=dev),
            fault_injector=FaultPlan.parse(spec) if spec else None, device=dev, groups=groups)
        step_ms = []

        def engine_step(plan):
            t0 = time.perf_counter()
            tok, lg, loop.caches = loop.step(loop.params, loop.caches, plan.tokens, plan.pos,
                                             plan.n_new, plan.tables, plan.seeds, plan.temps)
            tok = tok.cpu().numpy()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if name == "free4" and not first:
                first.update(plan=plan, logits=lg.clone())
            return tok

        loop._engine_step = engine_step
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rep = loop.run(paged_requests(RB, model.cfg.vocab, pg), arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        line = {"world": world, "plan": spec, "wall_s": wall, "ticks": rep["ticks"],
                "engine_steps": len(step_ms), "step_ms": step_ms, "launches": read_counts(),
                **route_tables(), "attention_launches_by_form": dict(FA.launches_paged_by_form),
                "completions": rep["completions"], "ledger": rep["ledger"],
                "world_changes": rep["world_changes"], "final_world": rep["world"],
                "comm": None if loop.step is None else loop.step.comm.counter.snapshot()}
        if name == "free4":   # the first tick's rows, their columns over the model group
            first["gathered"] = _model_gather(first["logits"], loop.groups)
        dist.barrier()
        loop.groups.release()
        del loop
        torch.cuda.empty_cache()
        return line

    t0 = time.perf_counter()
    for name, world, spec in (("free4", 4, ""), ("free2", 2, ""),
                              ("preempt", 4, DIST_SERVE_PREEMPT)):
        out["engine"][name] = run(name, world, spec)
    out["engine_s"] = time.perf_counter() - t0
    if rank == 0:   # data rank 0's rows of the first tick on one card at tp 1
        plan, b = first["plan"], pg.slots
        step = PG.build_paged_step(model_1, MiCSTopology(), mcfg, max_blocks=pg.max_blocks,
                                   block_size=pg.block, chunk=pg.chunk, top_k=pg.top_k,
                                   device=dev)
        pool = PG.init_paged_caches(model_1, MiCSTopology(), sc.nb_local, pg.block, "bf16",
                                    device=dev)
        _, want, _ = step(full, pool, plan.tokens[:b], plan.pos[:b], plan.n_new[:b],
                          plan.tables[:b], plan.seeds[:b], plan.temps[:b])
        out["engine"]["first_tick"] = {"n_new": plan.n_new[:b].tolist(),
                                       **_against_one_card(first["gathered"], want,
                                                           model.cfg.vocab)}
        del step, pool, want
    del full, cut, first
    torch.cuda.empty_cache()

    # (b) the fixed batch over tp 4
    t0 = time.perf_counter()
    fb = DIST_SERVE_FIXED
    lay = next(lay for lay in DIST_LAYOUTS if lay.name == "D")
    model, model_1 = dist_model(lay), dist_model(lay, tp=1)
    full, cut = dist_serve_weights(model, model_1, dev)
    if rank:
        full = None
    topo = dist_topology(lay)
    groups = MiCSGroups(topo, rank, backend=backend, timeout=timeout)
    params = shard_params(model, topo, rank, cut, device=dev)
    del cut
    torch.cuda.empty_cache()
    cache_len = fb["prompt"] + fb["steps"]
    prefill_fn, decode_fn = build_serve_steps(model, topo, MiCSConfig(), cache_len, device=dev,
                                              groups=groups)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (fb["batch"], fb["prompt"])))
    ctx = L.Ctx(tp=topo.model_size, comm=decode_fn.comm)
    torch.cuda.synchronize()
    reset_counts()
    logits, caches = prefill_fn(params, {"tokens": prompt})
    tok = lm.greedy_sample(logits[:, -1], ctx, model.cfg.vocab)[:, None]
    seen, fed = [_model_gather(logits[:, -1], groups)], [tok.cpu()]
    step_ms = []
    for i in range(fb["steps"]):
        t1 = time.perf_counter()
        logits, tok, caches = decode_fn(params, caches, tok, fb["prompt"] + i)
        seen.append(_model_gather(logits[:, -1], groups))
        fed.append(tok.cpu())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    out["fixed"] = {"launches": read_counts(), **route_tables(), "decode_step_ms": step_ms,
                    "comm": decode_fn.comm.counter.snapshot(),
                    "tokens": torch.cat(fed, 1).tolist()}
    del params, caches, logits
    dist.barrier()
    groups.release()
    torch.cuda.empty_cache()
    if rank == 0:   # the same cut model at tp 1 on one card, fed the same tokens
        prefill_1, decode_1 = build_serve_steps(model_1, MiCSTopology(), MiCSConfig(),
                                                cache_len, device=dev)
        lg, caches = prefill_1(full, {"tokens": prompt})
        checks = [_against_one_card(seen[0], lg[:, -1], model.cfg.vocab)]
        for i in range(fb["steps"]):
            lg, _, caches = decode_1(full, caches, fed[i].to(dev), fb["prompt"] + i)
            checks.append(_against_one_card(seen[i + 1], lg[:, -1], model.cfg.vocab))
        out["fixed"]["against_one_card"] = checks
        del caches, lg
    del full
    torch.cuda.empty_cache()
    out["fixed_s"] = time.perf_counter() - t0
    return out


def dist_serve_checks(ranks: list) -> tuple[dict, dict]:
    """``dist_serve``'s checks on every rank's results: (a) each run's
    ledger (every request completed, accounted), its completions the same
    on every rank and bitwise the fault-free 4-rank run's (the 2-rank run
    and the preemption's), the preemption's ledger (4 -> 2 at tick 6, every
    in-flight request replayed), each rank's launches an engine step it ran
    RMSNorm 2 x layers + 1 and attention one a layer, every call on
    ``paged:wgmma``, and its collective counts a step; the first tick's
    logits within ``DIST_SERVE_REL_TOL`` of the one-card run's, greedy
    agreeing past twice that margin.  (b) every step's logits likewise,
    launches 9 forwards x (RMSNorm 7, attention 1: ``mma`` at the prefill,
    ``split`` at each decode step; RG-LRU 2, gated).  Returns ``(line,
    launches summed over ranks)``."""
    pg, total = DIST_SERVE, {}
    cfg_layers = DIST_SERVE_LAYERS
    runs = {}
    base = ranks[0]["serve"]["engine"]["free4"]["completions"]
    for name in ("free4", "free2", "preempt"):
        per = [rk["serve"]["engine"][name] for rk in ranks]
        for r, p in enumerate(per):
            led = p["ledger"]
            if not (led["accounted"] and led["completed"] == pg.requests and led["shed"] == 0):
                raise AssertionError(f"dist_serve {name} rank {r}: ledger {led}")
            if p["completions"] != base:
                raise AssertionError(f"dist_serve {name} rank {r}: completions differ from "
                                     "the fault-free 4-rank run's")
            steps = p["engine_steps"]
            want = dict.fromkeys(p["launches"], 0) | {"rmsnorm": (2 * cfg_layers + 1) * steps,
                                                      "flash_attention": cfg_layers * steps}
            if (p["launches"] != want or p["attention_launches_by_route"]["paged"]
                    != cfg_layers * steps
                    or p["attention_launches_by_form"]["paged:wgmma"] != cfg_layers * steps):
                raise AssertionError(f"dist_serve {name} rank {r}: launches {p['launches']} "
                                     f"{p['attention_launches_by_form']} != {want} "
                                     f"({steps} engine steps)")
            if r < p["world"] and not steps:
                raise AssertionError(f"dist_serve {name} rank {r}: no engine step")
            add_counts(total, p["launches"])
        changes = [(c["kind"], c["at_tick"], c["world"], c["partition_size"])
                   for c in per[0]["world_changes"]]
        if name == "preempt" and (changes != [("preempt", 6, 2, 1)]
                                  or not per[0]["world_changes"][0]["replayed"]):
            raise AssertionError(f"dist_serve preempt: world changes {changes}")
        if name != "preempt" and changes:
            raise AssertionError(f"dist_serve {name}: world changes {changes}")
        if name == "free4":
            calls = per[0]["comm"]["calls"]
            n = per[0]["engine_steps"]
            want = {"all_gather:partition": 6 * n, "all_gather:model": (2 * cfg_layers + 3) * n,
                    "all_reduce:model": 2 * cfg_layers * n, "all_reduce_max:model": n,
                    "all_reduce_min:model": n, "all_gather:data": n}
            if calls != dict(sorted(want.items())):
                raise AssertionError(f"dist_serve free4: collectives {calls} != {want}")
        runs[name] = {
            "world": per[0]["world"], "plan": per[0]["plan"], "ticks": per[0]["ticks"],
            "engine_steps": [p["engine_steps"] for p in per],
            "wall_s": [p["wall_s"] for p in per],
            "tokens": sum(len(t) for t in base.values()),
            "tokens_per_s": sum(len(t) for t in base.values()) / per[0]["wall_s"],
            "engine_step_ms_p50": [_pct(p["step_ms"], 50) for p in per],
            "ledger": per[0]["ledger"], "world_changes": per[0]["world_changes"],
            "comm": per[0]["comm"], "completions_bitwise_free4": True,
            "launches": [p["launches"] for p in per]}
    first = ranks[0]["serve"]["engine"]["first_tick"]
    fixed = ranks[0]["serve"]["fixed"]["against_one_card"]
    for what, c in [("engine first tick", first)] + [(f"fixed step {i}", c)
                                                      for i, c in enumerate(fixed)]:
        if not (c["rel_err"] <= DIST_SERVE_REL_TOL and c["greedy_agree_past_margin"]):
            raise AssertionError(f"dist_serve {what}: against one card {c}")
    steps = DIST_SERVE_FIXED["steps"]
    fwd, rg_layers = 1 + steps, dist_model(next(
        lay for lay in DIST_LAYOUTS if lay.name == "D")).cfg.n_layers
    for r, rk in enumerate(ranks):
        p = rk["serve"]["fixed"]
        want = dict.fromkeys(p["launches"], 0) | {
            "rmsnorm": (2 * rg_layers + 1) * fwd, "flash_attention": fwd, "rglru": 2 * fwd}
        if (p["launches"] != want or p["attention_launches_by_route"]["mma"] != 1
                or p["attention_launches_by_route"]["split"] != steps
                or p["rglru_launches_by_form"]["forward"]["gated"] != 2 * fwd):
            raise AssertionError(f"dist_serve fixed rank {r}: launches {p['launches']} != "
                                 f"{want}")
        if p["tokens"] != ranks[0]["serve"]["fixed"]["tokens"]:
            raise AssertionError(f"dist_serve fixed rank {r}: tokens differ from rank 0's")
        add_counts(total, p["launches"])
    line = {"engine": {"arch": "llama3.2-1b", "layers": cfg_layers, "layout": "C",
                       "engine": dataclasses.asdict(pg), "gather_dtype": "bf16",
                       "kv_dtype": "bf16", "runs": runs, "first_tick": first,
                       "rel_tol": DIST_SERVE_REL_TOL},
            "fixed": {"arch": "recurrentgemma-2b", "layers": rg_layers, "layout": "D",
                      **DIST_SERVE_FIXED, "against_one_card": fixed,
                      "rel_tol": DIST_SERVE_REL_TOL,
                      "decode_step_ms": [rk["serve"]["fixed"]["decode_step_ms"] for rk in ranks],
                      "comm": ranks[0]["serve"]["fixed"]["comm"],
                      "launches": ranks[0]["serve"]["fixed"]["launches"]},
            "engine_s": max(rk["serve"]["engine_s"] for rk in ranks),
            "fixed_s": max(rk["serve"]["fixed_s"] for rk in ranks)}
    return line, total


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
    ``dist_elastic``'s run (:func:`dist_elastic_run`); then ``dist_serve``'s
    (:func:`dist_serve_run`).  Writes ``rank<r>.json`` into
    ``--dist-out``."""
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
    t0 = time.perf_counter()
    result["serve"] = dist_serve_run(rank, dev, args.dist_backend, timeout)
    result["serve_s"] = time.perf_counter() - t0
    (out_dir / f"rank{rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_tp_start(layout: DistLayout, model, topo, groups, rank: int, ckdir, dev) -> None:
    """Write the step-0 checkpoint a tp > 1 layout's loop resumes from:
    :func:`dist_tp_state`."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    state = dist_tp_state(layout, model, topo, rank, dev)
    Checkpointer(ckdir).save(state, 0, topo=topo, groups=groups)
    del state
    torch.cuda.empty_cache()


def dist_tp_state(layout: DistLayout, model, topo, rank: int, dev) -> dict:
    """A tp > 1 layout's step-0 state on this rank: its model's
    ``init_params(seed=0)`` at tp 1 on this card (the weights of the
    one-card runs it is held to), cut into tp shards by
    ``convert.tp_params_from_full`` one pool at a time and into this rank's
    model coordinate and partition chunk, with zero moments."""
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
    torch.cuda.empty_cache()
    return {"params": params, "step": 0,
            **{part: {k: torch.zeros_like(v) for k, v in params.items()} for part in ("m", "v")}}


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


def dist_train_phase(card: str, dev) -> dict:
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
    out_dir = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    def save_moment(i, state):  # the wire runs' reference first moment
        if i == WIRE_STEPS:
            torch.save({k: t.cpu() for k, t in state["m"].items()}, out_dir / WIRE_REF_M)

    refs = {layout.name: dist_reference(
        layout, dev, save_moment if layout.name == WIRE_REFERENCE else None)
        for layout in DIST_LAYOUTS}
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
            if layout.arch == MOE_ARCH:
                ok = all(abs(a - b) <= DIST_MOE_TOL["atol"] + DIST_MOE_TOL["rtol"] * abs(b)
                         for a, b in ((loss, rl), (gn, rg)))
            else:
                ok = el <= lim_l and eg <= lim_g
            if not ok:
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
        census = dist_census(layout, model, path, per)
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
            "checkpoint_gb": per[0].get("checkpoint_gb"),
            "tolerance": DIST_MOE_TOL if model.cfg.family == "moe" else DIST_REL_TOL,
            "comm_calls": want_calls, "comm_bytes": per[0]["comm"]["bytes"],
            "census": census, "launches_per_rank": want_launches, "gather_check": gc}
    launches = {k: sum(rk["layouts"][lay.name]["launches"][k] for rk in ranks
                       for lay in DIST_LAYOUTS) for k in want_launches}
    wires_s = max(rk["wires_s"] for rk in ranks)
    elastic_s = max(rk["elastic_s"] for rk in ranks)
    serve_s = max(rk["serve_s"] for rk in ranks)
    wire_lines, wire_launches = dist_wire_checks(ranks, refs[WIRE_REFERENCE], backend, cards)
    elastic_line, elastic_launches = dist_elastic_checks(ranks)
    serve_line, serve_launches = dist_serve_checks(ranks)
    line = {"phase": "dist_train", "arch": sorted({lay.arch for lay in DIST_LAYOUTS}),
            "device_count": cards,
            "backend": backend, "ranks": DIST_WORLD,
            "ranks_per_card": DIST_WORLD // min(cards, DIST_WORLD),
            "layouts": lines, "workers_s": workers_s - wires_s - elastic_s - serve_s,
            "seconds": time.perf_counter() - t_phase - wires_s - elastic_s - serve_s,
            "gpu": card}
    emit(line)
    emit({"phase": "dist_wires", "arch": "llama3.2-1b", "layers": WIRE_LAYERS,
          "device_count": cards, "backend": backend, "ranks": DIST_WORLD,
          "runs": wire_lines, "seconds": wires_s, "gpu": card})
    emit({"phase": "dist_elastic", **elastic_line, "device_count": cards, "backend": backend,
          "step_ms_label": ("nccl, one card a rank" if backend == "nccl" else
                            f"gloo over host, {DIST_WORLD} ranks on {cards} card(s)"),
          "seconds": elastic_s, "gpu": card})
    emit({"phase": "dist_serve", **serve_line, "device_count": cards, "backend": backend,
          "ranks": DIST_WORLD,
          "step_ms_label": ("nccl, one card a rank" if backend == "nccl" else
                            f"gloo over host, {DIST_WORLD} ranks on {cards} card(s): a "
                            "rehearsal of serving over ranks, not a MiCS serving speed"),
          "seconds": serve_s, "gpu": card})
    shutil.rmtree(out_dir)
    # for the kernel table: the launches summed over ranks and layouts
    by_route = {key: {} for key in ("attention_launches_by_route",
                                    "attention_bwd_launches_by_route",
                                    "rmsnorm_bwd_launches_by_route")}
    by_form = {"forward": {}, "backward": {}}
    for rk in ranks:
        for got in [rk["layouts"][lay.name] for lay in DIST_LAYOUTS] + [
                rk["wires"][wr.name] for wr in DIST_WIRES] + [rk["elastic"]] + [
                rk["serve"]["engine"][run] for run in ("free4", "free2", "preempt")] + [
                rk["serve"]["fixed"]]:
            for key, table in by_route.items():
                for route, n in got[key].items():
                    table[route] = table.get(route, 0) + n
            for way, table in by_form.items():
                for form, n in got["rglru_launches_by_form"][way].items():
                    table[form] = table.get(form, 0) + n
    paged_forms = {}
    for rk in ranks:
        for run in ("free4", "free2", "preempt"):
            for form, n in rk["serve"]["engine"][run]["attention_launches_by_form"].items():
                paged_forms[form] = paged_forms.get(form, 0) + n
    # the route tables cover the wire, elastic and serve runs too; their
    # launches stand apart
    return {"arch": "dist_train", "launches": launches, **by_route,
            "rglru_launches_by_form": by_form, "wires_launches": wire_launches,
            "elastic_launches": elastic_launches, "serve_launches": serve_launches,
            "serve_paged_forms": paged_forms}


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
    from repro_torch.models import layers as L

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
                       ("llama tp 2 train", 2 * 2048, 2048),
                       # xlstm-125m: d 768 (ln1, ln2, s.hnorm, the final
                       # norm) and 1536 (m.hnorm) at train_xlstm's and
                       # serve_xlstm's rows; the VLM's d 8192 at serve_vlm's
                       # rows and at a train micro-step's
                       ("xlstm train d 768", train_rows(XLSTM_TRAIN), 768),
                       ("xlstm train d 1536", train_rows(XLSTM_TRAIN), 1536),
                       ("xlstm prefill d 1536", 4 * 512, 1536),
                       ("xlstm decode d 768", 4, 768),
                       ("xlstm decode d 1536", 4, 1536),
                       ("vlm prefill d 8192", 4 * 512, 8192),
                       ("vlm decode d 8192", 4, 8192),
                       ("vlm train d 8192", 2 * 2048, 8192)):
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
        # a rank's decode steps serving over ranks: llama's KV heads over tp
        # 2 and 4 (a fixed-batch step at the llama serve path's cache), and
        # dist_serve's fixed batch, recurrentgemma over tp 4 (its prefill,
        # then a decode step at its cache of 520)
        ("llama tp 2 decode", 4, 1, 544, 4, 4, 64, False, 0, 519, 520, bf),
        ("llama tp 4 decode", 4, 1, 544, 2, 4, 64, False, 0, 519, 520, bf),
        ("recurrentgemma tp 4 prefill", 4, 512, 512, 1, 3, 256, True, 2048, 0, None, bf),
        ("recurrentgemma tp 4 decode", 4, 1, 520, 1, 3, 256, False, 0, 519, 520, bf),
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
        # deepseek-moe-16b (MHA: 16 KV heads, g 1, dh 128): serve_moe's
        # prefill and decode steps, train_moe's micro-step
        ("deepseek-moe prefill", 4, 512, 512, 16, 1, 128, True, 0, 0, None, bf),
        ("deepseek-moe decode", 4, 1, 528, 16, 1, 128, False, 0, 519, 520, bf),
        ("deepseek-moe train", 2, 2048, 2048, 16, 1, 128, True, 0, 0, None, bf),
        # a rank's micro-step in dist_train's layout E (deepseek-moe, tp 4:
        # 4 of the 16 KV heads)
        ("deepseek-moe tp 4 train", 2, 2048, 2048, 4, 1, 128, True, 0, 0, None, bf),
        # llama-3.2-vision-90b's gated cross layer: non-causal over the
        # 1,024 vision keys of its own length (hkv 8, g 8, dh 128):
        # serve_vlm's prefill (mma) and decode step over the cached vision
        # K/V (split), a train micro-step's forward (mma; its log-sum-exp in
        # backward_checks), and a ragged non-causal edge
        ("vlm cross prefill", 4, 512, 1024, 8, 8, 128, False, 0, 0, None, bf),
        ("vlm cross decode", 4, 1, 1024, 8, 8, 128, False, 0, 0, None, bf),
        ("vlm cross train", 2, 2048, 1024, 8, 8, 128, False, 0, 0, None, bf),
        ("ragged non-causal, tq 300, tk 1000", 2, 300, 1000, 2, 4, 64, False, 0, 0, None, bf),
        # whisper-large-v3 (MHA: 20 KV heads, g 1, dh 64): the encoder's
        # non-causal self-attention over the 1,500 frames (serve_whisper's
        # prefill: a ragged last tile on both axes), the decoder's cross
        # prefill (64 tokens over the 1,500 encoder keys) and a decode step
        # over them (split: one packed row), train_whisper's cross forward;
        # the decoder's causal self-attention at the prompt of 64 and its
        # last decode step over the cache of 96
        ("whisper encoder prefill", 4, 1500, 1500, 20, 1, 64, False, 0, 0, None, bf),
        ("whisper cross prefill", 4, 64, 1500, 20, 1, 64, False, 0, 0, None, bf),
        ("whisper cross decode", 4, 1, 1500, 20, 1, 64, False, 0, 0, None, bf),
        ("whisper cross train", 2, 448, 1500, 20, 1, 64, False, 0, 0, None, bf),
        ("whisper self prefill", 4, 64, 64, 20, 1, 64, True, 0, 0, None, bf),
        ("whisper self decode", 4, 1, 96, 20, 1, 64, False, 0, 0, 96, bf),
        # the paper's models (40 MHA heads): bert-10b (dh 64) and bert-20b
        # (dh 128) causal at serve_bert's prompt; bert-50b's dh 204 through
        # the pad (layers.attention: mma at 256, the scale of 204).
        # serve_bert's decode steps over its cache of 528 (b hkv = 160 KV
        # streams, more than the card's SMs): bert-10b's first and last,
        # bert-50b's last through the pad (split at 256)
        ("bert-10b prefill", 4, 512, 512, 40, 1, 64, True, 0, 0, None, bf),
        ("bert-20b prefill", 4, 512, 512, 40, 1, 128, True, 0, 0, None, bf),
        ("bert-50b prefill, dh 204 padded to 256", 4, 512, 512, 40, 1, 204, True, 0, 0, None,
         bf),
        ("bert-10b decode, first step", 4, 1, 528, 40, 1, 64, False, 0, 0, 513, bf),
        ("bert-10b decode, last step", 4, 1, 528, 40, 1, 64, False, 0, 0, 528, bf),
        ("bert-50b decode, dh 204 padded to 256", 4, 1, 528, 40, 1, 204, False, 0, 0, 528,
         bf),
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
        # a head dim outside the kernels' through the model's call site, which pads
        attend = FA.flash_attention if dh in FA.HEAD_DIMS else L.attention
        padded = L.launches_padded
        out = attend(q, k, v, **kw)
        err = check(f"flash_attention {kind}", out, FA.attention_plain(q, k, v, **kw), tol)
        if not torch.equal(out, attend(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {kind}: route {route} is not bitwise "
                                 "repeatable")
        kv_len = tk if kvl is None else min(tk, kvl)
        extra = {}
        if attend is not FA.flash_attention:
            if L.launches_padded != padded + 2:
                raise AssertionError(f"flash_attention {kind}: not through the padded route")
            extra["padded_to"] = FA.padded_head_dim(dh)
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
        ms = time_ms(lambda: attend(q, k, v, **kw), flush)
        if route != "split":
            extra["tflops"] = ops / ms / 1e9
        attn_checks.append({
            "case": kind, "shape": {"b": b, "tq": tq, "tk": tk, "hkv": hkv, "g": g, "dh": dh},
            "causal": causal, "window": window, "q_offset": q_offset, "kv_valid_len": kvl,
            "dtype": "bf16" if dt == bf else "fp32", "route": route, "bitwise_repeat": True,
            "max_abs_err": err, "tol": tol, "ms": ms,
            "host_us": host_us(lambda: attend(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, **kw), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, is_causal=lib_causal, enable_gqa=True), flush),
            **extra})
        del q, k, v, qs, ks, vs
    # the other new models' heads at dh 128 (NEW_ATTN_SHAPES), correctness
    # only: a prefill on mma, a decode step on split
    for name, hkv, g in NEW_ATTN_SHAPES[1:]:
        for kind, b, tq, tk, causal, q_offset, kvl in (("prefill", 2, 256, 256, True, 0, None),
                                                       ("decode", 4, 1, 544, False, 519, 520)):
            q = torch.randn(b, tq, hkv, g, 128, generator=gen, device=dev).to(bf)
            k = torch.randn(b, tk, hkv, 128, generator=gen, device=dev).to(bf)
            v = torch.randn(b, tk, hkv, 128, generator=gen, device=dev).to(bf)
            kw = dict(causal=causal, window=0, q_offset=q_offset, kv_valid_len=kvl)
            out = FA.flash_attention(q, k, v, **kw)
            err = check(f"flash_attention {name} {kind}", out, FA.attention_plain(q, k, v, **kw),
                        TOL[bf])
            if not torch.equal(out, FA.flash_attention(q, k, v, **kw)):
                raise AssertionError(f"flash_attention {name} {kind}: not bitwise repeatable")
            attn_checks.append({
                "case": f"{name} {kind}", "timed": False,
                "shape": {"b": b, "tq": tq, "tk": tk, "hkv": hkv, "g": g, "dh": 128},
                "causal": causal, "q_offset": q_offset, "kv_valid_len": kvl, "dtype": "bf16",
                "route": FA.route(bf, tq * g), "bitwise_repeat": True, "max_abs_err": err,
                "tol": TOL[bf]})
            del q, k, v, out

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
            ("ragged d [37, 1000], fp32 scale", (37, 1000), bf, f32),
            # train_xlstm's micro-step (d 768 and 1536) and the VLM's at d 8192
            ("xlstm train [4096, 768]", (train_rows(XLSTM_TRAIN), 768), bf, bf),
            ("xlstm train [4096, 1536]", (train_rows(XLSTM_TRAIN), 1536), bf, bf),
            ("vlm train [4096, 8192]", (2 * 2048, 8192), bf, bf)):
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
        # case, b, T, hkv, g, dh, causal, window, dtype[, key length when not T]
        ("llama train", TRAIN[0].global_batch // TRAIN[0].micro_steps, TRAIN[0].seq, 8, 4, 64,
         True, 0, bf),
        ("recurrentgemma train", TRAIN[1].global_batch // TRAIN[1].micro_steps, TRAIN[1].seq, 1,
         10, 256, True, 2048, bf),
        # dist_train's layouts C and D, a rank's micro-step (as kernel_checks)
        ("llama tp 2 train", 2, 2048, 4, 4, 64, True, 0, bf),
        ("recurrentgemma tp 4 train", 2, 2048, 1, 3, 256, True, 2048, bf),
        # train_moe's micro-step (deepseek-moe-16b: 16 KV heads, g 1, dh 128)
        # and a rank's in dist_train's layout E (tp 4: 4 KV heads)
        ("deepseek-moe train", 2, 2048, 16, 1, 128, True, 0, bf),
        ("deepseek-moe tp 4 train", 2, 2048, 4, 1, 128, True, 0, bf),
        # the VLM's cross layer in a train micro-step: 2048 queries over the
        # 1,024 vision keys, non-causal (g 8 divides 64: wgmma); the ragged
        # non-causal edge on wgmma (g 4) and on mma (g 3)
        ("vlm cross train", 2, 2048, 8, 8, 128, False, 0, bf, 1024),
        ("ragged non-causal, tq 300, tk 1000", 2, 300, 2, 4, 64, False, 0, bf, 1000),
        ("ragged non-causal, tq 300, tk 1000, g 3: mma", 2, 300, 2, 3, 64, False, 0, bf, 1000),
        # train_whisper's micro-step (20 KV heads, g 1, dh 64): the encoder's
        # non-causal 1,500 x 1,500 and the cross layers' 448 x 1,500, on
        # wgmma; train_bert's (bert-10b, dh 64) and bert-20b's (dh 128)
        # causal 512, on wgmma
        ("whisper encoder train", 2, 1500, 20, 1, 64, False, 0, bf),
        ("whisper cross train", 2, 448, 20, 1, 64, False, 0, bf, 1500),
        ("bert-10b train", 4, 512, 40, 1, 64, True, 0, bf),
        ("bert-20b train", 4, 512, 40, 1, 128, True, 0, bf),
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
    for case, b, t, hkv, g, dh, causal, window, dt, *tk_ in cfgs:
        tk = tk_[0] if tk_ else t
        kw = dict(causal=causal, window=window)
        q = torch.randn(b, t, hkv, g, dh, generator=gen, device=dev).to(dt)
        k = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
        v = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
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
        allowed = FA.mask_bias(t, tk, causal=causal, window=window, q_offset=0,
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
        mask = None if lib_causal or not (causal or window) else allowed
        y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, is_causal=lib_causal,
                                           enable_gqa=True)
        attn.append({
            "case": case, "shape": {"b": b, "T": t, "tk": tk, "hkv": hkv, "g": g, "dh": dh},
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
    attn.append(padded_bwd_check(gen, dev, flush))
    # the other new models' heads (NEW_ATTN_SHAPES), correctness only: dbrx's
    # g 6 on mma (whole positions do not fill wgmma's 64-row tiles), the
    # others on wgmma
    for name, hkv, g in NEW_ATTN_SHAPES[1:]:
        kw = dict(causal=True, window=0)
        q, do = (torch.randn(2, 256, hkv, g, 128, generator=gen, device=dev).to(bf)
                 for _ in range(2))
        k, v = (torch.randn(2, 256, hkv, 128, generator=gen, device=dev).to(bf)
                for _ in range(2))
        o, lse = FA.flash_attention_fwd(q, k, v, **kw)
        route = FA.bwd_route(bf, 128, g, hkv)
        ref = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        err, _ = run_bwd_route(f"{name} train", route, (q, k, v, o, lse, do), kw, ref,
                               BWD_REL_TOL[bf])
        attn.append({"case": f"{name} train", "timed": False,
                     "shape": {"b": 2, "T": 256, "hkv": hkv, "g": g, "dh": 128},
                     "causal": True, "dtype": "bfloat16", "route": route,
                     "bitwise_repeat": True, "max_abs_err": err, "rel_tol": BWD_REL_TOL[bf]})
        del q, k, v, do, o, lse, ref
    # dbrx's RMSNorm width (d 6144), correctness only
    x = torch.randn(64, 6144, generator=gen, device=dev).to(bf)
    dy = torch.randn(64, 6144, generator=gen, device=dev).to(bf)
    sc = (0.2 * torch.randn(6144, generator=gen, device=dev)).to(bf)
    route = RN.bwd_route(bf, 6144, True)
    out = RN.rmsnorm_bwd(x, sc, dy)
    rms.append({"case": "dbrx-132b d 6144 [64, 6144]", "timed": False, "shape": [64, 6144],
                "dtype": "bfloat16", "scale_dtype": "bfloat16", "route": route,
                "max_abs_err": rel_check("rmsnorm_bwd dbrx d 6144", out,
                                         RN.rms_norm_bwd_plain(x, sc, dy), BWD_REL_TOL[bf]),
                "rel_tol": BWD_REL_TOL[bf],
                "forward_max_abs_err": rel_check("rmsnorm dbrx d 6144", [RN.rmsnorm(x, sc)],
                                                 [RN.rms_norm_plain(x, sc)], TOL[bf])})
    return rms, attn, rglru_backward_checks(gen, dev, flush)


def padded_bwd_check(gen, dev, flush, b: int = 4, t: int = 512, hkv: int = 40,
                     dh: int = 204) -> dict:
    """bert-50b's attention at dh 204 with its gradient, as a train step
    runs it: ``layers.attention`` on q, k and v that require a gradient
    (zero-padded to 256, ``FlashAttentionFn``: the ``mma`` forward with its
    log-sum-exp and the ``wgmma256`` backward at the scale of 204, the
    output cut back), then ``torch.autograd.grad`` at dO (autograd's cut
    and pad give dq, dk and dv at 204).  Held against the plain forward and
    backward at 204 on the same inputs, its counts read (one padded call,
    one ``mma`` forward, one ``wgmma256`` backward), bitwise repeatable,
    the backward timed through autograd beside the bound at 204, the plain
    version and SDPA's backward at 204."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import layers as L

    bf = torch.bfloat16
    kw = dict(causal=True, window=0)
    q, do = (torch.randn(b, t, hkv, 1, dh, generator=gen, device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn(b, t, hkv, dh, generator=gen, device=dev).to(bf) for _ in range(2))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    to = FA.padded_head_dim(dh)
    route = FA.bwd_route(bf, to, 1, hkv)
    before = (L.launches_padded, FA.launches_by_route["mma"], FA.launches_bwd_by_route[route])
    o = L.attention(qg, kg, vg, **kw)
    out = torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)
    after = (L.launches_padded, FA.launches_by_route["mma"], FA.launches_bwd_by_route[route])
    if route != "wgmma256" or [a - c for a, c in zip(after, before)] != [1, 1, 1]:
        raise AssertionError(f"attention bert-50b dh 204: route {route}, padded / mma / "
                             f"backward launches {before} -> {after}")
    if o.shape[-1] != dh or any(g.shape != x.shape for g, x in zip(out, (q, k, v))):
        raise AssertionError("attention bert-50b dh 204: not cut back to 204")
    o_ref, lse_ref = FA.attention_plain_lse(q, k, v, **kw)
    o_err = rel_check("flash forward bert-50b dh 204", [o.detach()], [o_ref], TOL[bf])

    def bwd():
        return torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)

    if not all(torch.equal(a, r) for a, r in zip(out, bwd())):
        raise AssertionError("flash_attention_bwd bert-50b dh 204: not bitwise repeatable")
    err = rel_check("flash_attention_bwd bert-50b dh 204", out,
                    FA.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, **kw),
                    BWD_REL_TOL[bf])
    pairs = b * hkv * t * (t + 1) // 2
    ops = 10 * dh * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse_ref.numel() * 4
    b_ms, b_by = bound(nbytes, ops, bf)
    ms = time_ms(bwd, flush)
    qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv, t, dh).contiguous().requires_grad_()
    ks = k.permute(0, 2, 1, 3).contiguous().requires_grad_()
    vs = v.permute(0, 2, 1, 3).contiguous().requires_grad_()
    dos = do.permute(0, 2, 3, 1, 4).reshape(b, hkv, t, dh).contiguous()
    y = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    line = {"case": "bert-50b train, dh 204 padded to 256", "padded_to": to,
            "shape": {"b": b, "T": t, "tk": t, "hkv": hkv, "g": 1, "dh": dh}, "causal": True,
            "window": 0, "dtype": "bfloat16", "route": route, "bitwise_repeat": True,
            "through": "layers.attention (FlashAttentionFn) + torch.autograd.grad",
            "max_abs_err": err, "rel_tol": BWD_REL_TOL[bf], "o_max_abs_err": o_err,
            "o_tol": TOL[bf], "ms": ms, "tflops": ops / ms / 1e9,
            "allowed_pairs": pairs,
            "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                                                     **kw), flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.autograd.grad(y, (qs, ks, vs), dos,
                                                              retain_graph=True), flush)}
    del q, k, v, do, qg, kg, vg, o, out, qs, ks, vs, y
    torch.cuda.empty_cache()
    return line


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
    paged_launches, paged_forms = {}, dict.fromkeys(FA.launches_paged_by_form, 0)
    for p in PATHS:
        by_path[p.arch], by_route, by_form, int8, paged = serve_path(p, card, dev)
        by_path[f"{p.arch} serve_int8"] = int8[0]
        for r, n in (*by_route.items(), *int8[1].items()):
            launches_by_route[r] += n
        if paged is not None:  # the engine's runs: fault-free, crash, int8 pools, fp32 pools
            checks = paged["checks"]
            fp32 = checks["fp32_engine"]
            runs = {"serve_paged": paged, "serve_paged crash": checks["crash_replay"],
                    "serve_paged int8": checks["int8_engine"], "serve_paged fp32": fp32,
                    "serve_paged fp32 crash": fp32["crash_replay"],
                    "serve_paged auto": checks["auto_engine"]}
            for run, line in runs.items():
                n = line["launches"]
                by_path[f"{p.arch} {run}"] = n
                paged_launches[f"{p.arch} {run}"] = n["flash_attention"]
                launches_by_route["paged"] += n["flash_attention"]
                for f, k in line["attention_launches_by_form"].items():
                    paged_forms[f] += k
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

    # -- 3a. the MoE family on one card ---------------------------------------------
    moe = serve_moe_phase(card, dev)
    emit(moe)
    engine = moe["engine"]
    by_path[f"{MOE_ARCH} serve_moe"] = moe["fixed_batch"]["launches"]
    for r, n in moe["fixed_batch"]["attention_launches_by_route"].items():
        launches_by_route[r] += n
    for run, line in (("serve_moe engine", engine), ("serve_moe engine crash",
                                                    engine["crash_replay"])):
        by_path[f"{MOE_ARCH} {run}"] = line["launches"]
        paged_launches[f"{MOE_ARCH} {run}"] = line["launches"]["flash_attention"]
        launches_by_route["paged"] += line["launches"]["flash_attention"]
        for f, n in line["attention_launches_by_form"].items():
            paged_forms[f] += n
    torch.cuda.empty_cache()
    moe_train = train_moe_phase(card, dev)
    train_lines.append(moe_train)
    by_path[f"{MOE_ARCH} train_moe"] = moe_train["launches"]
    launches_by_route["mma"] += moe_train["attention_launches_by_route"]["mma"]
    torch.cuda.empty_cache()

    # -- 3b. one rank of the production world (the dry run) ------------------------
    dry = dryrun_phase(card, dev)
    emit(dry)
    by_path[f"{DRYRUN_ARCH} dryrun"] = dry["launches"]
    for r, n in dry["attention_launches_by_route"].items():
        launches_by_route[r] += n
    torch.cuda.empty_cache()

    # -- 3c. the MiCS step over 4 ranks -------------------------------------------
    dist_line = dist_train_phase(card, dev)
    by_path[dist_line["arch"]] = dist_line["launches"]
    by_path["dist_wires"] = dist_line["wires_launches"]
    by_path["dist_elastic"] = dist_line["elastic_launches"]
    by_path["dist_serve"] = dist_line["serve_launches"]
    for r in ("mma", "split", "paged"):   # dist_serve's split and paged launches
        launches_by_route[r] += dist_line["attention_launches_by_route"][r]
    launches_by_form["gated"] += dist_line["rglru_launches_by_form"]["forward"]["gated"]
    paged_launches["dist_serve"] = dist_line["attention_launches_by_route"]["paged"]
    for f, n in dist_line["serve_paged_forms"].items():
        paged_forms[f] += n
    torch.cuda.empty_cache()

    # -- 3f. xlstm-125m and the VLM backbone on one card ------------------------------
    xlstm = serve_xlstm_phase(card, dev)
    emit(xlstm)
    by_path[f"{XLSTM_ARCH} serve_xlstm"] = xlstm["launches"]
    torch.cuda.empty_cache()
    xlstm_train = train_xlstm_phase(card, dev)
    train_lines.append(xlstm_train)
    by_path[f"{XLSTM_ARCH} train_xlstm"] = xlstm_train["launches"]
    torch.cuda.empty_cache()
    vlm = serve_vlm_phase(card, dev)
    emit(vlm)
    by_path[f"{VLM_ARCH} serve_vlm"] = vlm["launches"]
    for r, n in vlm["attention_launches_by_route"].items():
        launches_by_route[r] += n
    torch.cuda.empty_cache()

    # -- 3g. whisper-large-v3 and the paper's LayerNorm + GeLU models on one card -----
    launches_padded = 0
    whisper = serve_whisper_phase(card, dev)
    emit(whisper)
    bert = serve_bert_phase(card, dev)
    emit(bert)
    for label, line in ((f"{WHISPER_ARCH} serve_whisper", whisper),
                        *((f"{a} serve_bert", ln) for a, ln in bert["runs"].items())):
        by_path[label] = line["launches"]
        launches_padded += line["attention_launches_padded"]
        for r, n in line["attention_launches_by_route"].items():
            launches_by_route[r] += n
    for train_ln in (train_whisper_phase(card, dev), train_bert_phase(card, dev)):
        train_lines.append(train_ln)
        by_path[f"{train_ln['arch']} {train_ln['phase']}"] = train_ln["launches"]
        launches_by_route["mma"] += train_ln["attention_launches_by_route"]["mma"]

    emit(host_link_phase(card, dev))

    def train_sum(*keys: str) -> dict:
        """A train line's launches by route (or form) under ``keys``, summed
        over the train paths, the dryrun and the dist_train phase."""
        out = {}
        for line in (*train_lines, dry, dist_line):
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
    for hkv, tp in ((4, 2), (2, 4)):   # a rank's pools in dist_serve's engine (tp 2) and at tp 4
        paged_checks += paged_kernel_checks(gen, dev, flush, pg=DIST_SERVE, hkv=hkv,
                                            label=f"llama tp {tp} rank, dist_serve engine: ",
                                            dtypes=("bf16",))
    # fp32 pools (the fma body) at serve_paged's pool; the MoE engine's heads
    # (timed), then the other new models' heads (correctness only)
    paged_checks += paged_kernel_checks(gen, dev, flush, dtypes=("fp32",), label="fp32 pools: ")
    # and at the fp32 engine run's own pool (FP32_PAGED: 17 blocks a slot,
    # another split plan), correctness only
    paged_checks += paged_kernel_checks(gen, dev, flush, timed=False, pg=FP32_PAGED,
                                        dtypes=("fp32",), label="fp32 engine pool: ")
    for i, (name, hkv, g) in enumerate(NEW_ATTN_SHAPES):
        paged_checks += paged_kernel_checks(gen, dev, flush, timed=i == 0, pg=MOE_PAGED,
                                            hkv=hkv, g=g, dh=128, dtypes=("bf16",),
                                            label=f"{name} (g {g}, dh 128): ")
    # bert-50b's pools in the engine: dh 204 stored at 256 (the mma body), correctness only
    paged_checks += paged_kernel_checks(gen, dev, flush, timed=False, pg=MOE_PAGED, hkv=40,
                                        g=1, dh=256, label="bert-50b pool (dh 204 at 256): ")
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
              launches_by_route=launches_by_route,
              # calls at a head dim outside HEAD_DIMS (bert-50b's 204), run
              # zero-padded to 256 on the routes above
              launches_padded=launches_padded),
        # the paged route alone (the continuous-batching engine): its checks,
        # the engine's decode-only tick first; its launches the serve_paged runs'
        entry("flash_attention_paged", "src/repro_torch/kernels/csrc/flash_attention_paged.cu",
              "src/repro/kernels/flash_attention/kernel.py:86", paged_checks,
              by_path_n=paged_launches, launches_by_form=paged_forms,
              merge="src/repro_torch/kernels/csrc/flash_attention_paged.cu "
                    "flash_paged_merge_kernel",
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
