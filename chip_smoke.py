"""Drive the PyTorch port's serve path on one NVIDIA card and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed as one JSON line (any failed check raises and the
script exits non-zero; no phase swallows an error):

1. ``build``: nvcc builds every kernel of the path from
   ``src/repro_torch/kernels/csrc`` (seconds, card name and power limit).
2. ``serve``: full-width llama3.2-1b (16 layers, d_model 2048, vocab
   128,256), random weights from ``init_params(seed=0)``, bf16 gather,
   batch 4, prompt 512, 32 greedy decode steps, prefetch schedule, through
   ``build_serve_steps``.  Every kernel's launch counter is set to 0 just
   before and read just after; RMSNorm must have run 33 x 33 times and
   attention 16 x 33 times.
3. ``consistency``: (a) a prefill over the prompt plus the first 8
   generated tokens agrees with decode step 8; (b) the same weights at depth
   2 give the same prefill logits on the card (kernels) as on the CPU (plain
   versions).
4. ``kernels``: each kernel at the path's shapes against its plain version
   on the same inputs, with its time, the plain version's, one PyTorch
   library call's, and the card's bound for the same work.

The last line is ``{"ok": true, "device": {...}}``.  Without a card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
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
# Card-vs-card and card-vs-CPU agreement of the whole bf16 model, as a
# fraction of the largest |logit|: both sides round every activation to
# bf16, in different orders (the kernels' fp32 sums versus cuBLAS's or the
# CPU's), over 16 or 2 layers.
REL_TOL_DECODE_VS_PREFILL = 5e-2
REL_TOL_CARD_VS_CPU = 5e-2

BATCH, PROMPT, STEPS = 4, 512, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median CUDA-event time of one call, with L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: int, ops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.kernels import build as KB
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rmsnorm import kernel as RN
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    dev = torch.device("cuda")
    card = smi()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = KB.build_library()
    KB.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib.name,
          "gpu": card})

    # -- 2. the serve path -------------------------------------------------------
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, tp=1)
    topo = MiCSTopology()
    params = init_params(model, seed=0, device=dev)
    mcfg = MiCSConfig(gather_dtype=torch.bfloat16, prefetch=True)
    prefill_fn, decode_fn = build_serve_steps(model, topo, mcfg, PROMPT + STEPS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen, device=dev)

    # warm-up (cuBLAS handles, allocator), not counted
    logits, caches = prefill_fn(params, {"tokens": prompt})
    decode_fn(params, caches, torch.argmax(logits[:, -1:].float(), dim=-1), PROMPT)
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    RN.launches = 0
    FA.launches = 0
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    generated, step_logits = [tok], []
    t0 = time.perf_counter()
    for i in range(STEPS):
        logits, tok, caches = decode_fn(params, caches, tok, PROMPT + i)
        step_logits.append(logits)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {"rmsnorm": RN.launches, "flash_attention": FA.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ids = torch.cat(generated, dim=1)  # [b, 1 + STEPS]: prefill's token, then each step's
    want = {"rmsnorm": 33 * (1 + STEPS), "flash_attention": 16 * (1 + STEPS)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for lg in step_logits:
        if lg.shape != (BATCH, 1, model.vocab_padded) or not torch.isfinite(lg).all():
            raise AssertionError("decode logits not finite or of the wrong shape")
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.vocab:
        raise AssertionError("sampled ids out of the vocabulary")
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "batch": BATCH, "prompt": PROMPT, "decode_steps": STEPS,
          "gather_dtype": "bf16", "schedule": "prefetch", "prefill_ms": prefill_ms,
          "decode_ms_per_step": decode_s * 1e3 / STEPS,
          "tokens_per_s": BATCH * STEPS / decode_s, "peak_gb": peak_gb,
          "launches": launches, "ids_row0": ids[0].tolist(), "gpu": card})

    # -- 3. consistency ------------------------------------------------------------
    # (a) decode step 8 (which fed the 8th generated token) against a prefill
    # over the prompt plus those 8 tokens
    ext = torch.cat([prompt, ids[:, :8]], dim=1)
    lg_pre, _ = prefill_fn(params, {"tokens": ext})
    ref = step_logits[7].float()
    err_a = (lg_pre.float() - ref).abs().max().item()
    scale_a = ref.abs().max().item()
    argmax_a = (lg_pre.float().argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not err_a <= REL_TOL_DECODE_VS_PREFILL * scale_a:
        raise AssertionError(f"decode vs prefill recompute: {err_a} > "
                             f"{REL_TOL_DECODE_VS_PREFILL} x {scale_a}")
    # (b) depth 2, same width: card (kernels) against CPU (plain versions)
    import dataclasses

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model2 = build_model(cfg2, tp=1)
    params2 = {"embed": params["embed"], "layers": params["layers"][:2].contiguous(),
               "head": params["head"]}
    p_card, _ = build_serve_steps(model2, topo, mcfg, 128, device=dev)
    p_cpu, _ = build_serve_steps(model2, topo, mcfg, 128, device="cpu")
    tokens2 = prompt[:1, :128]
    lg_card, _ = p_card(params2, {"tokens": tokens2})
    lg_cpu, _ = p_cpu({k: v.cpu() for k, v in params2.items()}, {"tokens": tokens2.cpu()})
    ref_b = lg_cpu.float()
    err_b = (lg_card.float().cpu() - ref_b).abs().max().item()
    scale_b = ref_b.abs().max().item()
    if not err_b <= REL_TOL_CARD_VS_CPU * scale_b:
        raise AssertionError(f"card vs CPU at depth 2: {err_b} > "
                             f"{REL_TOL_CARD_VS_CPU} x {scale_b}")
    emit({"phase": "consistency",
          "decode_vs_prefill": {"max_abs_err": err_a, "max_abs_logit": scale_a,
                                "rel_tol": REL_TOL_DECODE_VS_PREFILL,
                                "argmax_agree": argmax_a},
          "card_vs_cpu_depth2": {"max_abs_err": err_b, "max_abs_logit": scale_b,
                                 "rel_tol": REL_TOL_CARD_VS_CPU}})
    del params2, lg_pre, lg_card

    # -- profile: where one prefill and one decode step spend the card's time --
    for kind in ("prefill", "decode"):
        if kind == "prefill":
            run = lambda: prefill_fn(params, {"tokens": prompt})  # noqa: E731
        else:
            _, pcache = prefill_fn(params, {"tokens": prompt})
            run = lambda: decode_fn(params, pcache, ids[:, :1], PROMPT)  # noqa: E731
        run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side kernel and memcpy events only (the CPU-side aten ops
        # carry the same time again as their children's)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.key != "Activity Buffer Request"]
        rows.sort(key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
        emit({"phase": "profile", "step": kind, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
              "top": [{"name": e.key[:80], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3} for e in rows[:12]]})
    del pcache

    # -- 4. kernels against their plain versions, timed ---------------------------
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB > L2
    import torch.nn.functional as F

    def check(name, out, ref, dtype):
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(max |err| {err}, tol {tol})")
        return err, tol

    rms_checks = []
    for n, d in ((BATCH * PROMPT, cfg.d_model), (BATCH, cfg.d_model)):
        x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
        s = (0.2 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
        w = 1.0 + s.float()
        err, tol = check("rmsnorm", RN.rmsnorm(x, s), RN.rms_norm_plain(x, s), x.dtype)
        b_ms, b_by = bound(2 * x.numel() * x.element_size() + s.numel() * s.element_size(),
                           4 * x.numel(), torch.float32)
        rms_checks.append({
            "shape": [n, d], "dtype": "bf16", "scale_dtype": "bf16", "max_abs_err": err,
            "tol": tol, "ms": time_ms(lambda: RN.rmsnorm(x, s), flush),
            "plain_ms": time_ms(lambda: RN.rms_norm_plain(x, s), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.rms_norm(x, (d,), weight=w.to(x.dtype),
                                                     eps=1e-6), flush)})

    attn_cases = [
        ("prefill", 4, 512, 512, 8, 4, 64, True, 0, 0, None, torch.bfloat16),
        ("decode", 4, 1, 544, 8, 4, 64, False, 0, 519, 520, torch.bfloat16),
        ("ragged", 4, 200, 200, 8, 4, 64, True, 0, 0, None, torch.bfloat16),
        ("ragged", 4, 200, 200, 8, 4, 64, True, 0, 0, None, torch.float32),
        ("window", 4, 512, 512, 8, 4, 64, True, 64, 0, None, torch.bfloat16),
        ("window", 4, 512, 512, 8, 4, 64, True, 64, 0, None, torch.float32),
    ]
    attn_checks = []
    for (kind, b, tq, tk, hkv, g, dh, causal, window, q_offset, kvl, dt) in attn_cases:
        q = torch.randn(b, tq, hkv, g, dh, generator=gen, device=dev).to(dt)
        k = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
        v = torch.randn(b, tk, hkv, dh, generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, q_offset=q_offset, kv_valid_len=kvl)
        err, tol = check(f"flash_attention {kind}", FA.flash_attention(q, k, v, **kw),
                         FA.attention_plain(q, k, v, **kw), dt)
        kv_len = tk if kvl is None else min(tk, kvl)
        allowed = FA.mask_bias(tq, kv_len, causal=causal, window=window, q_offset=q_offset,
                               kv_valid_len=kvl, device=dev) == 0
        pairs = int(allowed.sum().item()) * b * hkv * g
        nbytes = (2 * q.numel() + 2 * b * kv_len * hkv * dh) * q.element_size()
        b_ms, b_by = bound(nbytes, 4 * dh * pairs, dt)
        # the same function as one PyTorch call: [b, heads, t, dh] layout
        qs = q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, tq, dh).contiguous()
        ks = k[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        vs = v[:, :kv_len].permute(0, 2, 1, 3).contiguous()
        mask = allowed if window else None     # the window needs an explicit mask
        lib_causal = causal and not window     # these cases have q_offset 0, tq == tk
        attn_checks.append({
            "case": kind, "shape": {"b": b, "tq": tq, "tk": tk, "hkv": hkv, "g": g, "dh": dh},
            "causal": causal, "window": window, "q_offset": q_offset, "kv_valid_len": kvl,
            "dtype": "bf16" if dt == torch.bfloat16 else "fp32", "max_abs_err": err,
            "tol": tol, "ms": time_ms(lambda: FA.flash_attention(q, k, v, **kw), flush),
            "plain_ms": time_ms(lambda: FA.attention_plain(q, k, v, **kw), flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, is_causal=lib_causal, enable_gqa=True), flush)})

    def entry(name, source, replaces, n_launch, checks):
        main = checks[0]  # the path's main shape
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "checks": checks}

    emit({"kernels": [
        entry("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
              "src/repro/kernels/rmsnorm/kernel.py:28", launches["rmsnorm"], rms_checks),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:86", launches["flash_attention"],
              attn_checks),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
