"""qwen3-4b [dense] — GQA (kv=8), qk_norm, SwiGLU, head_dim=128.
[hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
)
