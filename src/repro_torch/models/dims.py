"""Tensor-parallel dimension bookkeeping: head padding, KV gather groups
(the port's copy of ``repro/models/dims.py``: pure arithmetic).

The model axis has a fixed size (16 in production, 1 in smoke tests).  Head
counts in the assigned architectures are not always divisible by it
(recurrentgemma: 10 Q heads; whisper: 20), and GQA KV head counts are often
smaller than it.  Policy (see DESIGN.md §3):

* Q heads are padded up to a multiple of ``tp``.  Padded heads are masked
  after attention (before the output projection), so their weights receive
  zero gradient and the model is mathematically identical to the unpadded
  architecture — only FLOPs are wasted, which the roofline accounts for.
* KV projections are stored sharded over the flattened (kv_heads × head_dim)
  dimension.  If ``kv_heads_pad < tp``, each rank holds a slice of one KV
  head's dims, and the full head is re-assembled with an all-gather over the
  contiguous model-axis sub-group of ``tp // kv_heads_pad`` ranks that share
  that head (``Segment.model_gather``).  No parameter is stored replicated,
  so gradients need no fix-ups.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class AttnDims:
    tp: int
    d_model: int
    head_dim: int
    hq: int              # true Q head count
    hq_pad: int          # padded to multiple of tp
    hq_local: int        # per model rank
    hkv: int             # true KV head count
    hkv_pad: int         # padded (to divisor or multiple of tp)
    kv_gather: int       # model-axis sub-group size reassembling one KV head
    hkv_local: int       # KV heads materialized per rank after gathering
    q_per_kv_local: int  # local Q heads per local KV head

    @property
    def q_cols_local(self) -> int:
        return self.hq_pad * self.head_dim // self.tp

    @property
    def kv_cols_stored(self) -> int:
        """Stored (pre-gather) KV projection columns per rank."""
        return self.hkv_pad * self.head_dim // self.tp


def attn_dims(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, tp: int) -> AttnDims:
    hq_pad = _round_up(n_heads, tp)
    if n_kv_heads >= tp:
        hkv_pad = _round_up(n_kv_heads, tp)
        kv_gather = 1
        hkv_local = hkv_pad // tp
    else:
        # pad kv heads to a power-of-two divisor of tp
        hkv_pad = 1
        while hkv_pad < n_kv_heads:
            hkv_pad *= 2
        while tp % hkv_pad != 0:
            hkv_pad *= 2
        kv_gather = tp // hkv_pad
        hkv_local = 1
    hq_local = hq_pad // tp
    # every local KV head serves an equal number of local Q heads
    if hq_local % hkv_local != 0:
        raise ValueError(
            f"local Q heads {hq_local} not divisible by local KV heads {hkv_local}"
        )
    return AttnDims(
        tp=tp,
        d_model=d_model,
        head_dim=head_dim,
        hq=n_heads,
        hq_pad=hq_pad,
        hq_local=hq_local,
        hkv=n_kv_heads,
        hkv_pad=hkv_pad,
        kv_gather=kv_gather,
        hkv_local=hkv_local,
        q_per_kv_local=hq_local // hkv_local,
    )


def shard_dim(total: int, tp: int, name: str = "") -> int:
    if total % tp != 0:
        raise ValueError(f"dim {name}={total} not divisible by tp={tp}")
    return total // tp


def pad_to_tp(total: int, tp: int) -> int:
    return _round_up(total, tp)
