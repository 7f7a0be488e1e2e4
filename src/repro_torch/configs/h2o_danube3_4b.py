"""h2o-danube3-4b [dense]: 24 layers, d=3840, 32 heads on 8 KV heads
(GQA, 4 query heads a KV head), head dim 120, d_ff 10240, vocab 32,000,
sliding-window attention over the last 4,096 positions.

RoPE over the whole head, RMSNorm, SwiGLU MLPs (the gate's SiLU takes
the policy's exponential), no biases, untied embedding and unembedding.
The window makes the cache a ring of 4,096 slots: decode is O(window).
The reference configuration is ``src/repro/configs/h2o_danube3_4b.py``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    sliding_window=4096, act="swiglu", rope_theta=10000.0,
    source="arXiv:2401.16818",
)
