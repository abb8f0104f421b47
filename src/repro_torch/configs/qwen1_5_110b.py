"""qwen1.5-110b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-110B; family-verified via Qwen/Qwen1.5-0.5B]
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1_000_000.0,
    max_seq=32768,
    notes="full attention -> long_500k skipped",
)
