"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

[arXiv:2402.19427 (Griffin); hf:google/recurrentgemma-2b]
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="griffin",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256_000,
    head_dim=256,
    mlp="geglu",
    norm="rms",
    rope_theta=10_000.0,
    window=2048,
    pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv_width=4,
    max_seq=32768,
    sub_quadratic=True,
    notes="26 = 8x(rec,rec,attn) + 2 rec tail; diagonal RG-LRU gates "
          "(DESIGN.md §2); 10 Q heads padded to 16 on the 16-wide model axis.",
)
