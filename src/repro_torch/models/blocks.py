"""Per-family transformer blocks (pre-norm residual structure)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.base import Specs
from repro_torch.models.layers import ffn, ffn_specs, rmsnorm, rmsnorm_specs


# ---- dense / GQA -----------------------------------------------------------------

def dense_block_specs(cfg: ModelConfig) -> Specs:
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn.gqa_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "ffn": ffn_specs(cfg.d_model, cfg.d_ff),
    }


def dense_block(params, cfg: ModelConfig, x, positions, impl="kernel",
                causal=True):
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    h = attn.gqa_attention(params["attn"], cfg, h, positions, causal=causal,
                           impl=impl)
    x = x + h
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn(params["ffn"], h)
