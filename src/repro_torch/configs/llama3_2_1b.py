"""llama3.2-1b — small llama3 dense decoder.

[hf:meta-llama/Llama-3.2-1B]
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128_256,
    head_dim=64,
    mlp="swiglu",
    rope_theta=500_000.0,
    max_seq=32768,
    notes="full attention -> long_500k skipped",
)
