"""phi3-medium-14b [dense]: 40 layers, d=5120, 40 heads on 10 KV heads
(GQA, 4 query heads a KV head), head dim 128, d_ff 17920, vocab 100,352.

RoPE over the whole head, RMSNorm, SwiGLU MLPs (the gate's SiLU takes
the policy's exponential), no biases, untied embedding and unembedding.
The reference configuration is ``src/repro/configs/phi3_medium_14b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, head_dim=128,
    act="swiglu", rope_theta=10000.0,
    source="arXiv:2404.14219",
)
