"""The paper's own workloads (Table 1): BERT-style dense LMs at 10B-50B.

Used by the scaling benchmarks to reproduce Figures 7-9 analytically.  We
model them as causal dense decoders of the same width/depth (the paper's
throughput analysis is agnostic to the attention masking direction).
"""

from repro_torch.configs.base import ArchConfig


def _bert(name, hidden, inter, layers, heads, vocab=32008):
    return ArchConfig(
        name=name,
        family="dense",
        n_layers=layers,
        d_model=hidden,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=inter,
        vocab=vocab,
        head_dim=hidden // heads,
        mlp="gelu",
        norm="ln",
        use_rope=False,
        max_seq=512,
        notes="paper Table 1 workload",
    )


BERT_10B = _bert("bert-10b", 2560, 10240, 127, 40)
BERT_15B = _bert("bert-15b", 2560, 10240, 190, 40)
BERT_20B = _bert("bert-20b", 5120, 20480, 64, 40)
BERT_50B = _bert("bert-50b", 8192, 32768, 62, 40)
ROBERTA_20B = _bert("roberta-20b", 5120, 20480, 62, 40, vocab=50265)
GPT2_20B = _bert("gpt2-20b", 5120, 20480, 62, 40, vocab=50265)

PAPER_CONFIGS = {
    c.name: c
    for c in (BERT_10B, BERT_15B, BERT_20B, BERT_50B, ROBERTA_20B, GPT2_20B)
}
