"""gpt2-small — the paper's own evaluation model (GPT-2 Small, head dim 64).

12 layers, d=768, 12 heads (MHA), vocab 50,257 padded to 50,432, tied
embeddings, LayerNorm + GELU with biases. Positions are RoPE over the full
head dim, as in the reference configuration.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gpt2-small", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=50257, head_dim=64,
    act="gelu", norm="layernorm", use_bias=True, tie_embeddings=True,
    source="paper (GPT-2 small)",
)
