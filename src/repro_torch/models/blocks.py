"""Per-family transformer blocks (pre-norm residual structure)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import Specs
from repro_torch.models.layers import ffn, ffn_specs, rmsnorm, rmsnorm_specs
from repro_torch.sharding.partition import sp_boundary, sp_gather


# ---- dense ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> Specs:
    """The attention's parameters: MLA's where ``cfg.use_mla``, else GQA's."""
    return attn.mla_specs(cfg) if cfg.use_mla else attn.gqa_specs(cfg)


def attention(params, cfg: ModelConfig, x, positions, causal=True, impl="kernel"):
    """Full-sequence attention: MLA where ``cfg.use_mla``, else GQA."""
    fn = attn.mla_attention if cfg.use_mla else attn.gqa_attention
    return fn(params, cfg, x, positions, causal=causal, impl=impl)


def dense_block_specs(cfg: ModelConfig) -> Specs:
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "ffn": ffn_specs(cfg.d_model, cfg.d_ff),
    }


def dense_block(params, cfg: ModelConfig, x, positions, impl="kernel",
                causal=True, fused=False):
    """Under a mesh the residual stream is sequence-parallel: the norms run
    on it, the attention and FFN on the whole sequence (``sp_gather``), and
    their outputs are reduce-scattered back to it (``sp_boundary``) before
    the residual adds, so that no gradient reaches a product with its
    sequence sharded, and the block returns the stream sequence-parallel.
    Without a mesh both do nothing."""
    h = sp_gather(rmsnorm(params["ln1"], x, cfg.norm_eps))
    x = x + sp_boundary(attention(params["attn"], cfg, h, positions, causal=causal, impl=impl))
    h = sp_gather(rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x + sp_boundary(ffn(params["ffn"], h, fused=fused))


# ---- MoE ---------------------------------------------------------------------------

def moe_block_specs(cfg: ModelConfig, dense_ffn: bool) -> Specs:
    s: Specs = {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
    }
    if dense_ffn:
        s["ffn"] = ffn_specs(cfg.d_model, cfg.dense_d_ff or cfg.d_ff)
    else:
        s["moe"] = moe_mod.moe_specs(cfg)
    return s


def moe_block(params, cfg: ModelConfig, x, positions, impl="kernel", fused=False):
    """Returns (x, aux_loss): a dense-FFN layer's aux is 0. Under a mesh the
    stream is sequence-parallel around the attention and the FFN (dense or
    routed), as in ``dense_block``."""
    h = sp_gather(rmsnorm(params["ln1"], x, cfg.norm_eps))
    x = x + sp_boundary(attention(params["attn"], cfg, h, positions, impl=impl))
    h = sp_gather(rmsnorm(params["ln2"], x, cfg.norm_eps))
    if "ffn" in params:
        return (x + sp_boundary(ffn(params["ffn"], h, fused=fused)),
                torch.zeros((), dtype=torch.float32, device=x.device))
    y, aux = moe_mod.moe_ffn(params["moe"], cfg, h, fused=fused)
    return x + sp_boundary(y), aux


# ---- SSM (Mamba-2) -----------------------------------------------------------------

def mamba_block_specs(cfg: ModelConfig) -> Specs:
    return {"ln": rmsnorm_specs(cfg.d_model), "mixer": ssm_mod.ssm_specs(cfg)}


def mamba_block(params, cfg: ModelConfig, x, scan="kernel"):
    """Under a mesh the stream is sequence-parallel around the mixer, as in
    ``dense_block``: the mixer takes the whole sequence (its conv and scan
    run along it) and its output goes back to the stream's layout."""
    h = sp_gather(rmsnorm(params["ln"], x, cfg.norm_eps))
    y, _ = ssm_mod.mamba2_forward(params["mixer"], cfg, h, scan=scan)
    return x + sp_boundary(y)


def mamba_block_decode(params, cfg: ModelConfig, x, conv_state, ssm_state):
    """One token; ``conv_state`` and ``ssm_state`` are updated in place."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    y, cs, ss = ssm_mod.mamba2_decode(params["mixer"], cfg, h, conv_state, ssm_state)
    return x + y, cs, ss


# ---- Zamba-style shared attention block ----------------------------------------------

def shared_attn_block_specs(cfg: ModelConfig) -> Specs:
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn.gqa_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "ffn": ffn_specs(cfg.d_model, cfg.d_ff),
    }


def shared_attn_block(params, cfg: ModelConfig, x, positions, impl="kernel", fused=False):
    """Sequence-parallel under a mesh around the attention and the FFN, as
    ``dense_block``."""
    h = sp_gather(rmsnorm(params["ln1"], x, cfg.norm_eps))
    x = x + sp_boundary(attn.gqa_attention(params["attn"], cfg, h, positions, impl=impl))
    h = sp_gather(rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x + sp_boundary(ffn(params["ffn"], h, fused=fused))


# ---- encoder/decoder (Whisper backbone) ------------------------------------------------

def encoder_block_specs(cfg: ModelConfig) -> Specs:
    return dense_block_specs(cfg)


def encoder_block(params, cfg: ModelConfig, x, positions, impl="kernel", fused=False):
    return dense_block(params, cfg, x, positions, impl=impl, causal=False, fused=fused)


def decoder_block_specs(cfg: ModelConfig) -> Specs:
    s = dense_block_specs(cfg)
    s["ln_cross"] = rmsnorm_specs(cfg.d_model)
    s["cross"] = attn.gqa_specs(cfg)
    return s


def decoder_block(params, cfg: ModelConfig, x, enc_out, positions, impl="kernel",
                  fused=False):
    """Causal self-attention, then cross-attention (queries from the
    decoder, keys and values from ``enc_out``, no rotary embedding, no
    mask), then the SwiGLU FFN. Under a mesh the stream is sequence-parallel
    around all three, as in ``dense_block``; ``enc_out`` is read with its
    whole sequence for the cross keys and values, and a projection whose
    heads do not divide "model" is read whole (``attention.whole_heads``)."""
    h = sp_gather(rmsnorm(params["ln1"], x, cfg.norm_eps))
    x = x + sp_boundary(attn.gqa_attention(params["attn"], cfg, h, positions, causal=True,
                                           impl=impl))
    h = sp_gather(rmsnorm(params["ln_cross"], x, cfg.norm_eps))
    enc = sp_gather(enc_out)
    b, s, _ = h.shape
    s_enc = enc.shape[1]
    cross, hd = params["cross"], cfg.head_dim
    q = attn.whole_heads(h @ cross["wq"], cfg.n_heads).reshape(b, s, cfg.n_heads, hd)
    k = attn.whole_heads(enc @ cross["wk"], cfg.n_kv_heads).reshape(b, s_enc, cfg.n_kv_heads, hd)
    v = attn.whole_heads(enc @ cross["wv"], cfg.n_kv_heads).reshape(b, s_enc, cfg.n_kv_heads, hd)
    o = attn.sdpa(q, k, v, causal=False, impl=impl)
    x = x + sp_boundary(attn.merge_heads(o) @ cross["wo"])
    h = sp_gather(rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x + sp_boundary(ffn(params["ffn"], h, fused=fused))
