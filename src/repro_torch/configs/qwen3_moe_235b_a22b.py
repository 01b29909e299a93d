"""Qwen3-MoE 235B-A22B-class: 128 experts, top-8, GQA kv=4
[hf:Qwen/Qwen3-30B-A3B family; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,            # unused for MoE layers; kept per assignment sheet
    moe_d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
)
