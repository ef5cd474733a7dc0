"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent per-channel decay,
head size 64 (40 heads).  [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    num_layers=32,
    d_model=2560,
    num_heads=40,        # informational; rwkv heads = d_model // mamba_headdim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    mamba_headdim=64,    # rwkv head size
)
