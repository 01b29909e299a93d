"""InternVL2-26B backbone: InternLM2-20B LM; InternViT frontend is a STUB
(the batch carries precomputed patch embeddings, ``patch_embeds``) [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    frontend="vision",
    rope_theta=1_000_000.0,
)
