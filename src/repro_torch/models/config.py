"""Model configuration dataclass shared by the whole zoo — a copy of
`repro.models.config` (the port imports nothing of the JAX package): the
same fields, `reduced`, `param_count` and `active_param_count`, with
``tdtype`` (the ``torch.dtype`` of ``dtype``) in place of ``jdtype``."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_local: float | None = None  # gemma3 dual-theta
    # sliding-window pattern: window size for "local" layers; pattern gives
    # the local:global grouping (e.g. gemma3 pattern=6 -> 5 local + 1 global)
    sliding_window: int | None = None
    pattern: int = 0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # routed/shared expert hidden dim
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- MLA ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- MTP (deepseek-v3) ---
    mtp: bool = False
    mtp_weight: float = 0.3
    # --- SSM / hybrid ---
    ssm_state: int = 0
    mamba_headdim: int = 64
    mamba_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0  # zamba2: shared attention every k mamba blocks
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    max_target_len: int = 448
    # --- vlm ---
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    # numerics
    dtype: str = "float32"
    # attention chunking
    kv_chunk: int = 1024
    q_chunk: int = 512
    remat: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        base = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.head_dim else None,
            kv_chunk=64,
            q_chunk=32,
        )
        if self.num_experts:
            base.update(num_experts=4, top_k=2, moe_d_ff=64,
                        num_shared_experts=min(self.num_shared_experts, 1),
                        first_dense_layers=min(self.first_dense_layers, 1))
        if self.use_mla:
            base.update(kv_lora_rank=32, q_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=16, v_head_dim=16, head_dim=None)
        if self.ssm_state:
            base.update(ssm_state=16, mamba_headdim=16)
        if self.encoder_layers:
            base.update(encoder_layers=2)
        if self.mrope:
            # rescale sections to the reduced head_dim (sum == hd // 2)
            half = 16  # head_dim 32 below
            base.update(mrope_sections=(half // 4, 3 * half // 8, 3 * half // 8))
        if self.sliding_window:
            base.update(sliding_window=64)
        if self.pattern:
            base.update(pattern=2, num_layers=4)
        if self.attn_every:
            base.update(attn_every=2, num_layers=4)
        base.update(overrides)
        return dataclasses.replace(self, **base)

    def param_count(self) -> int:
        """Analytic total parameter count (for roofline MODEL_FLOPS)."""
        d, l, v = self.d_model, self.num_layers, self.vocab_size
        hd = self.hd
        emb = v * d
        if self.family == "rwkv":
            per = 4 * d * d + 2 * d * self.d_ff + d * (self.d_model // self.mamba_headdim) * 0
            # rough: time-mix (r,k,v,g,o ~ 5 d^2) + channel-mix (2 d dff)
            per = 5 * d * d + 2 * d * self.d_ff
            return emb * 2 + l * per
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.num_heads * self.v_head_dim * d
            )
        ff_mult = 3 if self.act == "swiglu" else 2
        dense_ff = ff_mult * d * self.d_ff
        if self.num_experts:
            moe_ff = ff_mult * d * self.moe_d_ff * (self.num_experts + self.num_shared_experts)
            n_moe = l - self.first_dense_layers
            total_ff = self.first_dense_layers * dense_ff + n_moe * (moe_ff + d * self.num_experts)
        else:
            total_ff = l * dense_ff
        total = emb * 2 + l * attn + total_ff
        if self.encoder_layers:
            total += self.encoder_layers * (attn + dense_ff) + l * attn  # cross-attn
        if self.family == "hybrid":
            din = self.mamba_expand * d
            nh = din // self.mamba_headdim
            mamba = d * (2 * din + 2 * nh * self.ssm_state // (self.ssm_state or 1) * self.ssm_state + nh) + din * d
            mamba = d * 2 * din + din * (2 * self.ssm_state) + din * d + din * self.conv_kernel
            total = emb * 2 + l * mamba + (attn + dense_ff)  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k routed)."""
        if not self.num_experts:
            return self.param_count()
        d, l = self.d_model, self.num_layers
        ff_mult = 3 if self.act == "swiglu" else 2
        full = self.param_count()
        moe_ff_all = ff_mult * d * self.moe_d_ff * self.num_experts
        moe_ff_act = ff_mult * d * self.moe_d_ff * self.top_k
        n_moe = l - self.first_dense_layers
        return int(full - n_moe * (moe_ff_all - moe_ff_act))
