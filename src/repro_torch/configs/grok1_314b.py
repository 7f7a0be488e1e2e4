"""grok-1-314b [moe]: 64 layers, d=6144, 48 heads on 8 KV heads, head dim
128, 8 experts a layer with 2 taken a token, expert d_ff 32768, vocab
131,072.

GELU experts (the MoE family's other expert branch), untied embeddings.
Its logit softcap (30.0) is read only by the reference's loss, so it is
not carried here. The reference configuration is
``src/repro/configs/grok1_314b.py``; the port runs it ``.reduced()``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, head_dim=128,
    n_experts=8, top_k=2, act="gelu",
    source="hf:xai-org/grok-1",
)
