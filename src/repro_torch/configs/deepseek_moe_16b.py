"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6.

[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base]
28L d_model=2048 16H (MHA kv=16) per-expert d_ff=1408 vocab=102400.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    head_dim=128,
    mlp="swiglu",
    rope_theta=10_000.0,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    max_seq=32768,
    notes="experts sharded over the model axis (EP=16, 4 experts/rank); "
          "full attention -> long_500k skipped",
)
