"""whisper-medium [audio] — enc-dec transformer backbone; conv/mel frontend
is a stub (input_specs provides frame embeddings).  [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    attn_bias=True,
    max_target_len=448,
)
