"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed experts
top-6, first layer dense.  [arXiv:2405.04434]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,            # dense-layer FFN
    moe_d_ff=1536,         # routed/shared expert hidden
    vocab_size=102400,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)
