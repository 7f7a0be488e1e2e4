"""mamba2-1.3b [ssm]: 48 layers, d=2048, attention-free, state 128 (SSD).

State-space duality; expand 2 gives d_inner 4096, head dim 64 gives 64
heads. Vocab 50,280 padded to 50,432, untied embedding and unembedding.
No attention softmax, but the SSD's decays, softplus and SiLU gates all
take the policy's exponential (the reference configuration,
``src/repro/configs/mamba2_1_3b.py``).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    source="arXiv:2405.21060",
)
