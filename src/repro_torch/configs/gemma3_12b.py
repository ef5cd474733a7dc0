"""gemma3-12b [dense] — 5:1 local(1024-window):global attention pattern,
dual rope theta, 128k, head_dim=256, 262k vocab.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    pattern=6,             # 5 local + 1 global per group
    sliding_window=1024,
    rope_theta=1e6,        # global layers
    rope_theta_local=1e4,  # local layers
    qk_norm=True,
)
