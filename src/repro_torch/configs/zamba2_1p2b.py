"""zamba2-1.2b [hybrid] — Mamba2 blocks + ONE shared attention block invoked
every 6 blocks (weights reused; per-invocation LoRA omitted, see DESIGN.md).
ssm_state=64.  [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,          # mamba2 blocks; 6 shared-attn invocations
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,              # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    mamba_headdim=64,
    mamba_expand=2,
    conv_kernel=4,
    attn_every=6,
    sliding_window=4096,    # decode-time window for long_500k (DESIGN.md)
)
