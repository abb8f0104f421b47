"""Architecture configuration schema (the port's copy of
``repro/configs/base.py``).

One ``ArchConfig`` per architecture plus a ``smoke_variant`` reduction of
the same family for CPU tests.  Field names, defaults and the smoke
reduction are kept identical to the JAX package so both build the same
flat layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "vlm", "encdec", "griffin", "xlstm", "moe"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"          # swiglu | geglu | gelu
    norm: str = "rms"            # rms | ln
    rope_theta: float = 500_000.0
    use_rope: bool = True
    tie_embeddings: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- griffin / local attention ------------------------------------------
    window: int = 0              # local-attention window (0 = full)
    pattern: tuple[str, ...] = ()
    lru_width: int = 0
    conv_width: int = 4

    # --- vlm ------------------------------------------------------------------
    cross_interval: int = 0
    n_vision_tokens: int = 1024

    # --- encdec -----------------------------------------------------------------
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # --- xlstm -------------------------------------------------------------------
    slstm_every: int = 0
    expand: float = 2.0

    # --- serving / shapes ----------------------------------------------------
    max_seq: int = 32768
    sub_quadratic: bool = False

    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Exact parameter count, summed over the port's own layouts."""
        from repro_torch.models.build import exact_param_count

        return exact_param_count(self)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        max_seq=128,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=2, n_shared_experts=cfg.n_shared_experts, d_ff=32)
    if cfg.family == "griffin":
        kw.update(window=32, lru_width=64, n_layers=min(cfg.n_layers, 6))
    if cfg.family == "xlstm":
        kw.update(n_layers=4, n_heads=2, n_kv_heads=2)
    if cfg.family == "vlm":
        kw.update(n_layers=5, n_vision_tokens=16)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2, n_layers=2, n_audio_frames=16)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
