"""Model configuration dataclass shared by every architecture.

Each assigned architecture gets one module in this package defining
``CONFIG`` (the exact assignment) plus ``reduced()`` (a tiny same-family
variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # FFN is MoE on layers where idx % moe_every == moe_every-1
    capacity_factor: float = 1.25
    moe_combine: str = "gather"   # "gather" | "scatter" (§Perf lever)
    # --- SSM (Mamba2/SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    # --- layer pattern: one char per layer in a repeating period.
    # 'A' = attention mixer, 'M' = mamba mixer. "" means all-'A' (or all-'M'
    # for family == "ssm").
    layer_pattern: str = ""
    # --- attention variant ---
    sliding_window: int = 0     # 0 = full causal attention
    rope_theta: float = 1e4
    attn_chunk: int = 1024      # query-chunk size of the flash-style scan
    attn_impl: str = "jnp"      # "jnp": the model's own differentiable attention
                                # and SSD scan (training and inference) |
                                # "pallas": the hand kernels of both mixers
                                # (kernels/, inference only: no backward)
    # --- modality frontend stub (audio/vlm): number of precomputed
    # frame/patch embeddings prepended to the token sequence.
    frontend: str = "none"      # none | audio | vision
    frontend_tokens: int = 0
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def pattern(self) -> str:
        if self.layer_pattern:
            return self.layer_pattern
        return "M" if self.family == "ssm" else "A"

    @property
    def num_periods(self) -> int:
        p = self.pattern
        assert self.num_layers % len(p) == 0, (self.name, self.num_layers, p)
        return self.num_layers // len(p)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (used for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D  # lm head
        per = self.pattern
        for ch in list(per) * self.num_periods:
            n += 2 * D  # norms
            if ch == "A":
                n += D * (self.num_heads * hd)          # q
                n += 2 * D * (self.num_kv_heads * hd)   # k, v
                n += (self.num_heads * hd) * D          # o
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            else:  # mamba mixer
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_nheads
                n += D * (2 * di + 2 * self.ssm_ngroups * ds + nh)  # in_proj
                n += di * self.ssm_conv + di                        # conv + norm-ish
                n += 2 * nh                                         # A_log, dt_bias
                n += di * D                                         # out_proj
        # FFNs (attention/mamba mixers both may carry an FFN when d_ff > 0)
        if F > 0:
            layers_with_ffn = self.num_layers
            moe_layers = 0
            if self.num_experts > 0:
                moe_layers = sum(
                    1 for i in range(self.num_layers)
                    if i % self.moe_every == self.moe_every - 1)
            dense_layers = layers_with_ffn - moe_layers
            n += dense_layers * 3 * D * F
            if self.num_experts > 0:
                e = self.experts_per_token if active_only else self.num_experts
                n += moe_layers * (e * 3 * D * F + D * self.num_experts)
        return n
