"""DeepSeek-V2 236B: MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE
[arXiv:2405.04434; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA: per-head K/V reconstructed from the latent
    d_ff=1536,
    moe_d_ff=1536,
    dense_d_ff=12288,
    first_k_dense=1,
    vocab_size=102400,
    head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)
