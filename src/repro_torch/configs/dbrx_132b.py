"""dbrx-132b [moe]: 40 layers, d=6144, 48 heads on 8 KV heads (GQA, 6
query heads a KV head), head dim 128, 16 experts a layer with 4 taken a
token, expert d_ff 10752, vocab 100,352.

RoPE over the whole head, RMSNorm, SwiGLU experts (the gate's SiLU takes
the policy's exponential), a softmax router on the policy's exponential,
no biases, untied embedding and unembedding. The reference configuration
is ``src/repro/configs/dbrx_132b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    n_experts=16, top_k=4, act="swiglu",
    source="hf:databricks/dbrx-base",
)
