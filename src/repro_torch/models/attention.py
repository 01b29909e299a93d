"""Grouped-query attention, with two SDPA implementations.

* ``naive``  — materializes the scores; small shapes and oracles.
* ``kernel`` — the hand-written kernels in ``repro_torch.kernels``:
  ``flash_attention`` for a full sequence, ``flash_decode`` for one token
  against the cache.

The decode path takes a KV cache and the host-side position of the new token,
and writes the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30
IMPLS = ("naive", "kernel")


# --------------------------------------------------------------------------------
# SDPA implementations (q: B,Sq,H,D; k/v: B,Skv,KVH,D)
# --------------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None,
                    scale: float | None = None):
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    idx_q = torch.arange(sq, device=q.device) + q_offset
    idx_k = torch.arange(skv, device=q.device)
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx_k[None, :] <= idx_q[:, None]
    if kv_len is not None:
        mask &= idx_k[None, :] < kv_len
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def decode_attention(q, k_cache, v_cache, kv_len: int, scale: float | None = None):
    """Single-token attention against a cache, scores materialized.

    q: (B,1,H,D); caches: (B,S,KVH,D); kv_len: number of valid entries.
    """
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * scale
    mask = torch.arange(s, device=q.device) < kv_len
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


def sdpa(q, k, v, *, causal: bool, impl: str = "kernel", scale=None):
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    if impl == "naive" or q.shape[1] <= 256:
        return naive_attention(q, k, v, causal=causal, scale=scale)
    return kops.flash_attention_op(q, k, v, causal=causal, scale=scale)


# --------------------------------------------------------------------------------
# GQA attention module
# --------------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Specs:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": P((d, h * hd), ("embed", "heads")),
        "wk": P((d, kvh * hd), ("embed", "kv_heads")),
        "wv": P((d, kvh * hd), ("embed", "kv_heads")),
        "wo": P((h * hd, d), ("heads", "embed")),
    }


def gqa_project_qkv(params, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(params, cfg: ModelConfig, x, positions, *, causal=True,
                  impl="kernel"):
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    out = sdpa(q, k, v, causal=causal, impl=impl)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ params["wo"]


def gqa_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos: int,
               impl="kernel"):
    """One-token decode. cache_[kv]: (B, S, KVH, D), updated IN PLACE at
    ``pos``, the host-side index of the new token. Returns
    (out, cache_k, cache_v), the caches being the tensors passed in."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    q = q.to(cache_k.dtype)
    if impl == "kernel":
        out = kops.flash_decode_op(q[:, 0], cache_k, cache_v, pos + 1)
    else:
        out = decode_attention(q, cache_k, cache_v, kv_len=pos + 1)
    out = out.reshape(b, 1, -1).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v
