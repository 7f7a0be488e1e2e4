"""Model configuration schema (the port's own copy).

Mirrors ``repro/configs/base.py``'s ``ModelConfig`` for the fields the
ported families read: the dense decoder, the MoE decoder, the ssm
(Mamba-2) family and the hybrid (RG-LRU + local attention) family. The
port keeps its own copy rather than importing the reference package, so
it stays importable where JAX is absent. Fields of families not ported
yet (modality stubs) are left out. Training carries ``loss_chunk``, the
chunked cross-entropy's sequence chunk (``models.layers.cross_entropy``);
the reference's ``logit_softcap`` and ``router_aux_coef`` (the hybrid's
and the MoE's losses) wait for their slice. The parameters are f32
masters (the reference's ``param_dtype``) only in a model built for
training (``models.api.init_params(..., trainable=True)``); a serving
model holds its layers in the compute dtype.

Execution fields resolve into a ``runtime.ExecPolicy``: ``REPRO_*``
environment variables and per-call overrides take precedence over them.
The dense family takes GELU or SwiGLU MLPs (``act``), tied or untied
embeddings (``tie_embeddings``), any ``rope_theta`` and the head dims
the attention kernels take (32, 64, 120, 128 and 256; 120 runs the 128
kernels on zero-filled columns). The port supports f32 attention and
logits matmul inputs only (the reference's ``attn_mm_dtype`` /
``logits_mm_dtype`` defaults), and no parallel blocks, so those knobs are
not carried. ``sliding_window`` is the local attention window of the
hybrid family and of the dense family (h2o-danube3-4b): its cache is a
ring of ``min(max_seq, window)`` slots, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid (ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    causal: bool = True
    rope_theta: float = 10000.0
    rope_pct: float = 1.0           # fraction of head_dim rotated
    sliding_window: Optional[int] = None   # dense, hybrid: local window
    use_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE (grok-1 / dbrx style): experts, experts a token, bucket slack
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (recurrentgemma / griffin)
    attn_period: int = 0            # 1 attention layer per `attn_period`
    lru_width: int = 0
    conv_width: int = 4             # ssm / hybrid: causal depthwise conv
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256            # SSD block: the chunked scan's unit
    ssm_ngroups: int = 1
    # numerics / execution (see runtime.policy.resolve_policy)
    exp_impl: str = "vexp"          # the paper's knob: vexp | exact | vexp_hw
    kernel_backend: str = ""        # cuda | reference | eager; "" -> cuda
    attn_block_k: int = 512         # FlashAttention KV block (online-update unit)
    kv_cache_layout: str = "bshd"   # bshd | bhsd
    compute_dtype: str = "bfloat16"
    loss_chunk: int = 512           # chunked cross-entropy seq chunk
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256; logits in the padded
        range are masked at the serving boundary."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's
        ``reduced()`` restricted to the fields kept here)."""
        return replace(
            self,
            n_layers=2 if self.attn_period == 0
            else self.attn_period + 1,       # +1: the tail is covered
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads
            else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            lru_width=128 if self.lru_width else 0,
            sliding_window=16 if self.sliding_window else None,
            ssm_headdim=32 if self.ssm_state else 64,
            ssm_state=min(self.ssm_state, 32),
            ssm_chunk=16,
            loss_chunk=64,
        )
