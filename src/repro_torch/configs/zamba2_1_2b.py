"""Zamba2-1.2B: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,        # shared block uses full MHA
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,         # shared attention+MLP block after every 6th mamba block
    tie_embeddings=True,
)
