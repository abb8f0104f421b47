"""dbrx-132b — 16-expert top-4 fine-grained MoE.

[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752 vocab=100352.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100_352,
    head_dim=128,
    mlp="swiglu",
    rope_theta=500_000.0,
    n_experts=16,
    n_shared_experts=0,
    top_k=4,
    max_seq=32768,
    notes="EP=16 -> one expert per model rank; "
          "full attention -> long_500k skipped",
)
