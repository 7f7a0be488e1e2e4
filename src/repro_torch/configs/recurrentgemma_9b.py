"""recurrentgemma-9b [hybrid]: 38 layers, d=4096, 16 heads on one KV head
(MQA), head dim 256, d_ff 12288, vocab 256,000.

RG-LRU recurrent blocks beside local attention in the pattern (rec, rec,
attn), so ``attn_period`` 3: 12 periods and a tail of two recurrent
layers. The attention layers see a 2048-token window through a ring
buffer; half of each head is rotated (``rope_pct`` 0.5); GELU MLPs;
untied embedding and unembedding. The reference configuration
(``src/repro/configs/recurrentgemma_9b.py``) also carries a logit
softcap of 30.0, which only its training loss reads.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    attn_period=3, lru_width=4096, sliding_window=2048,
    act="gelu", rope_pct=0.5,
    source="arXiv:2402.19427",
)
