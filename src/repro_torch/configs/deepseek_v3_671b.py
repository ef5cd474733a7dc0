"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP,
first 3 layers dense.  [arXiv:2412.19437]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,            # dense-layer FFN
    moe_d_ff=2048,         # routed/shared expert hidden
    vocab_size=129280,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    first_dense_layers=3,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp=True,
)
