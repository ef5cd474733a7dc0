"""starcoder2-3b [dense] — GQA (kv=2), RoPE, GELU MLP, layernorm, attn bias.
[arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    act="gelu",
    norm="layernorm",
    attn_bias=True,
    rope_theta=1e5,
)
