"""granite-8b — llama-architecture code model.

[arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base]
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    head_dim=128,
    mlp="swiglu",
    rope_theta=10_000_000.0,
    max_seq=32768,
    notes="full attention -> long_500k skipped",
)
