"""Serving runtime: fixed-batch prefill + greedy KV-cache decode (the port
of ``repro/runtime/serving.py``'s ``build_serve_steps`` and
``pad_ragged_batch``).

Inference uses the same flat-pool parameter gathering as training: every
step re-gathers every layer through the ``CommEngine`` (at p = 1 on one
card, the cast of each fp32 row to the wire dtype).  With
``quant_gather`` the weights are stored int8 (``quant.quantize_state``:
``{'q': int8, 's': fp32 block scales}`` a pool) and each layer's row is
dequantized on the card every step, where the bf16 path reads fp32 rows
and casts them.  Serving over more than one rank is refused (ROADMAP
Queue 1 item 6).
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import CommEngine
from repro_torch.core.mics import SCORES_BF16_UNNEEDED, MiCSConfig
from repro_torch.core.quant import n_blocks
from repro_torch.core.topology import MiCSTopology
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import ModelDef


def pad_ragged_batch(topo: MiCSTopology, batch: dict):
    """Pad every batch leaf to the next multiple of dp with dummy rows.

    Returns ``(padded_batch, row_mask)``; ``row_mask`` is a bool [B] marking
    real rows (the decode step emits token -1 for the others).
    """
    dp = topo.data_parallel_size
    b = batch["tokens"].shape[0]
    pad = (-b) % dp
    device = batch["tokens"].device
    mask = torch.arange(b + pad, device=device) < b
    if pad:
        batch = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))], dim=0)
                 for k, v in batch.items()}
    return batch, mask


def _check_params(model: ModelDef, params: dict, device: torch.device,
                  quantized: bool = False) -> None:
    """Each pool fp32 ``[stack, 1, S]``, or with ``quantized`` a stored
    ``{'q': int8 [stack, 1, S], 's': fp32 [stack, 1, ceil(S / 128)]}``, on
    ``device``'s type."""
    for name, (stack, tp, flat) in model.global_flat_shapes().items():
        pool = params[name]
        if quantized:
            if not isinstance(pool, dict) or set(pool) != {"q", "s"}:
                raise ValueError(f"pool {name!r}: quant_gather serves stored int8 pools "
                                 "{'q', 's'} (quant.quantize_state)")
            want = {"q": (torch.int8, (stack, tp, flat)),
                    "s": (torch.float32, (stack, tp, n_blocks(flat)))}
        else:
            if isinstance(pool, dict):
                raise ValueError(f"pool {name!r} is stored int8: serve it with quant_gather")
            pool, want = {"": pool}, {"": (torch.float32, (stack, tp, flat))}
        for k, (dtype, shape) in want.items():
            t = pool[k]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"pool {name!r}{'.' + k if k else ''}: want {dtype} {shape}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            if t.device.type != device.type:
                raise ValueError(f"pool {name!r} is on {t.device}, the serve steps on {device}")


def build_serve_steps(model: ModelDef, topo: MiCSTopology, mcfg: MiCSConfig,
                      cache_len: int, *, device: str | torch.device = "cuda"):
    """Returns ``(prefill_fn, decode_fn)`` running on ``device``.

    ``prefill_fn(params, batch) -> (logits [b, 1, V], caches)``; with
    ``mcfg.quant_gather`` the params are stored int8 pools
    (``quant.quantize_state``).
    ``decode_fn(params, caches, tokens, pos, seeds=None, temps=None,
    row_mask=None) -> (logits [b, 1, V], next_tokens [b, 1], caches)`` is
    greedy: the argmax over the real vocab; rows where ``row_mask`` is False
    emit -1.  The caches are updated in place.  A temperature above 0 raises:
    the seeded sampler cannot match JAX's threefry noise and comes with the
    continuous-batching slice.
    """
    dev = resolve_device(device)
    if topo.world_size > 1:
        raise NotImplementedError(
            f"serving over {topo.world_size} ranks (p = {topo.partition_size}, "
            f"{topo.replication_degree} replicas) waits for ROADMAP Queue 1 item 6, the "
            "serving engine; the port serves on one card")
    if mcfg.scores_bf16:
        raise NotImplementedError(SCORES_BF16_UNNEEDED)
    comm = CommEngine.from_config(topo, mcfg)
    ctx = L.Ctx(mode="decode", tp=topo.model_size, cache_len=cache_len,
                compute_dtype=mcfg.gather_dtype)

    @torch.inference_mode()
    def prefill_fn(params, batch):
        _check_params(model, params, dev, mcfg.quant_gather)
        tokens = batch["tokens"].to(dev)
        return lm.prefill(model, params, comm, ctx, {"tokens": tokens})

    @torch.inference_mode()
    def decode_fn(params, caches, tokens, pos, seeds=None, temps=None, row_mask=None):
        del seeds  # only the seeded sampler reads them
        _check_params(model, params, dev, mcfg.quant_gather)
        if temps is not None and bool((torch.as_tensor(temps) > 0).any()):
            raise NotImplementedError(
                "temperature > 0: the seeded sampler comes with the "
                "continuous-batching slice")
        tokens = tokens.to(dev)
        logits, new_caches = lm.decode_step(model, params, comm, ctx, tokens,
                                            int(pos), caches)
        nxt = lm.greedy_sample(logits[:, -1], ctx, model.cfg.vocab)
        if row_mask is not None:
            nxt = torch.where(row_mask.to(dev), nxt, torch.full_like(nxt, -1))
        return logits, nxt[:, None], new_caches

    return prefill_fn, decode_fn
