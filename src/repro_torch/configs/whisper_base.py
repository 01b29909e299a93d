"""Whisper-base backbone: 6L enc + 6L dec, d=512; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356;
unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    cross_attention=True,
    frontend="audio",
    tie_embeddings=True,
)
