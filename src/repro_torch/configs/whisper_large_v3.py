"""whisper-large-v3 — encoder-decoder speech model (conv frontend stubbed).

[arXiv:2212.04356; hf:openai/whisper-large-v3]
32 encoder + 32 decoder layers, d_model=1280 20H (MHA) d_ff=5120 vocab=51866.
input_specs provides precomputed mel-frame embeddings (1500 frames).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,            # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    mlp="gelu",
    norm="ln",
    use_rope=False,
    n_audio_frames=1500,
    max_seq=32768,
    notes="decode shapes lower the decoder with cross-attention to the "
          "encoded audio; 20 heads padded to 32 on the 16-wide model axis; "
          "full attention -> long_500k skipped.",
)
