"""llama-3.2-vision-90b — VLM backbone with gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-90B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Backbone only: the vision frontend is a stub (input_specs provides patch
embeddings); 1 gated cross-attn layer after every 4 self-attn layers.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128_256,
    head_dim=128,
    mlp="swiglu",
    rope_theta=500_000.0,
    cross_interval=4,
    n_vision_tokens=1024,
    max_seq=32768,
    notes="full attention -> long_500k skipped",
)
