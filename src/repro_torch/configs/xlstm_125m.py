"""xlstm-125m — sLSTM + mLSTM blocks (xLSTM[7:1]-style interleave).

[arXiv:2405.04517; unverified]
12L d_model=768 4H vocab=50304 (d_ff=0: the blocks carry their own
up-projections).  Pattern: one sLSTM per 4 blocks -> (m,m,m,s) x 3.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=192,
    use_rope=False,
    slstm_every=4,
    expand=2.0,
    conv_width=4,
    max_seq=32768,
    sub_quadratic=True,
    notes="constant-size recurrent state -> runs long_500k; weights stored "
          "model-sharded but cell computed replicated per rank (DESIGN.md §2).",
)
