"""Grouped-query attention and MLA (DeepSeek-V2's latent attention), with two
SDPA implementations.

* ``naive``  — materializes the scores; small shapes and oracles.
* ``kernel`` — the hand-written kernels in ``repro_torch.kernels``:
  ``flash_attention`` for a full sequence, differentiable (K1 forward, K2a/K2b
  backward, one autograd Function), ``flash_decode`` for one token against
  the cache. It is the counterpart of the reference's ``impl="chunked"``
  training path; runtime-position masking (sequence packing) is not ported.

The decode paths take a cache (GQA: per-head K/V; MLA: the latent ``ckv`` and
the shared rope key) and the host-side position of the new token, and write
the cache in place. MLA's prefill reaches K1 at q/k head dim
``head_dim + rope_head_dim`` and v head dim ``v_head_dim``; its decode is the
absorbed form over the latent cache, plain products as in the reference.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import apply_rope
from repro_torch.sharding.partition import constrain, mesh_sizes

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
    """Under a device mesh (``DTensor`` inputs) either implementation runs on
    each rank's local shard, batch over "data" and heads over "model"."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    if impl == "naive" or q.shape[1] <= 256:
        def attend(q_, k_, v_):
            return naive_attention(q_, k_, v_, causal=causal, scale=scale)

        if isinstance(q, DTensor):
            return kops.attention_on_local_shards(attend, q, k, v)
        return attend(q, k, v)
    return kops.flash_attention_op(q, k, v, causal=causal, scale=scale)


# --------------------------------------------------------------------------------
# GQA attention module
# --------------------------------------------------------------------------------

def whole_heads(t, n_heads: int):
    """A (B, S, n_heads * D) projection ready to unflatten into its heads.
    Under a mesh, n_heads * D may shard over "model" where n_heads does not
    (``resolve_spec`` reads only the flattened width): no rank could then
    unflatten its columns into whole heads, so ``t`` comes back
    "model"-replicated, as ``kernels.ops.attention_on_local_shards`` reads
    such heads. Any other tensor comes back as it is."""
    if isinstance(t, DTensor) and n_heads % mesh_sizes(t.device_mesh).get("model", 1):
        return constrain(t, ("pod", "data"), None, None)
    return t


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
    # JAX promotes a bf16 input against fp32 weights, where torch's @ raises:
    # whisper's first encoder block takes the frames in bf16 whatever the
    # parameters' dtype (lm.py:_forward_audio, as the reference casts them)
    x = x.to(torch.promote_types(x.dtype, params["wq"].dtype))
    q = whole_heads(x @ params["wq"], h).reshape(b, s, h, hd)
    k = whole_heads(x @ params["wk"], kvh).reshape(b, s, kvh, hd)
    v = whole_heads(x @ params["wv"], kvh).reshape(b, s, kvh, hd)
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


def cross_decode(params, cfg: ModelConfig, x, cross_k, cross_v, impl="kernel"):
    """One token's cross-attention (the encoder-decoder's): queries from
    ``x`` (B,1,d), keys and values the cached (B,S_enc,KVH,D), every row
    valid, no rotary embedding. ``impl="kernel"`` runs K3 at kv_len = S_enc,
    ``"naive"`` the plain ``decode_attention`` the reference takes. An empty
    cache (S_enc = 0) adds nothing, as the reference's sum over no keys."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    b, enc_len = x.shape[0], cross_k.shape[1]
    if enc_len == 0:
        return torch.zeros_like(x)
    q = (x @ params["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim).to(cross_k.dtype)
    if impl == "kernel":
        out = kops.flash_decode_op(q[:, 0], cross_k, cross_v, enc_len)
    else:
        out = decode_attention(q, cross_k, cross_v, kv_len=enc_len)
    return out.reshape(b, 1, -1).to(x.dtype) @ params["wo"]


# --------------------------------------------------------------------------------
# MLA attention (DeepSeek-V2): latent-compressed KV cache
# --------------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Specs:
    d, h = cfg.d_model, cfg.n_heads
    hd, r, vd = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": P((d, ql), ("embed", "lora")),
        "wq_b": P((ql, h * (hd + r)), ("lora", "heads")),
        "wkv_a": P((d, kvl + r), ("embed", "lora")),
        "wk_b": P((kvl, h * hd), ("lora", "heads")),
        "wv_b": P((kvl, h * vd), ("lora", "heads")),
        "wo": P((h * vd, d), ("heads", "embed")),
    }


def _mla_q(params, cfg: ModelConfig, x, positions):
    """Per-head queries (B,S,H,hd+r) through the q low-rank pair, the last
    ``rope_head_dim`` lanes rotated; returned as (q_nope, q_rope)."""
    b, s, _ = x.shape
    hd, r = cfg.head_dim, cfg.rope_head_dim
    q = whole_heads((x @ params["wq_a"]) @ params["wq_b"], cfg.n_heads)
    q = q.reshape(b, s, cfg.n_heads, hd + r)
    return q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)


def _mla_latent(params, cfg: ModelConfig, x, positions):
    """The latent ``c_kv`` (B,S,kv_lora) and the rotated rope key shared by
    all heads (B,S,r), from one product with ``wkv_a``."""
    kvl = cfg.kv_lora_rank
    ckv_full = x @ params["wkv_a"]
    k_rope = apply_rope(ckv_full[:, :, None, kvl:], positions, cfg.rope_theta)[:, :, 0]
    return ckv_full[..., :kvl], k_rope


def _mla_qkv(params, cfg: ModelConfig, x, positions, c_kv, k_rope):
    """Expand the latent into per-head K/V and build the rope-augmented Q/K:
    q, k (B,S,H,hd+r) and v (B,S,H,vd), each contiguous (``torch.cat`` and
    fresh products), as K1 takes them."""
    b, s_kv = c_kv.shape[:2]
    h, hd, r, vd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    k_nope = whole_heads(c_kv @ params["wk_b"], h).reshape(b, s_kv, h, hd)
    v = whole_heads(c_kv @ params["wv_b"], h).reshape(b, s_kv, h, vd)
    # the shared rope key broadcast across heads
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s_kv, h, r)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def mla_attention(params, cfg: ModelConfig, x, positions, *, causal=True, impl="kernel"):
    """Full-sequence MLA. Past ``sdpa``'s S <= 256 shortcut, ``impl="kernel"``
    runs K1 at q/k head dim hd + r and v head dim vd (192 and 128 for
    deepseek-v2-236b), scale (hd + r)^-0.5."""
    b, s, _ = x.shape
    c_kv, k_rope = _mla_latent(params, cfg, x, positions)
    q, k, v = _mla_qkv(params, cfg, x, positions, c_kv, k_rope)
    scale = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    out = sdpa(q, k, v, causal=causal, impl=impl, scale=scale)
    return out.reshape(b, s, -1) @ params["wo"]


def mla_decode(params, cfg: ModelConfig, x, cache_ckv, cache_krope, pos: int, impl="kernel"):
    """One-token MLA decode in the ABSORBED form: the scores are taken against
    the latent cache directly (``wk_b`` folded into q, ``wv_b`` applied after
    the weighted latent sum), so per-head K/V are never expanded over the
    cache. cache_ckv (B,S,kv_lora) and cache_krope (B,S,r) are updated IN
    PLACE at ``pos``, the host-side index of the new token. The products are
    plain PyTorch for either ``impl``, as the reference's are for any of its
    own: no kernel of the reference computes this. Returns (out, cache_ckv,
    cache_krope), the caches being the tensors passed in."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    kvl, r, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    c_new, krope_new = _mla_latent(params, cfg, x, positions)
    cache_ckv[:, pos] = c_new[:, 0].to(cache_ckv.dtype)
    cache_krope[:, pos] = krope_new[:, 0].to(cache_krope.dtype)

    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, params["wk_b"].reshape(kvl, h, hd))
    s_nope = torch.einsum("bqhl,bkl->bhqk", q_abs.float(), cache_ckv.float())
    s_rope = torch.einsum("bqhr,bkr->bhqk", q_rope.float(), cache_krope.float())
    scores = (s_nope + s_rope) * ((hd + r) ** -0.5)
    mask = torch.arange(cache_ckv.shape[1], device=x.device) < pos + 1
    p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqk,bkl->bqhl", p.to(cache_ckv.dtype), cache_ckv)
    wv_b = params["wv_b"].reshape(kvl, h, vd)
    out = torch.einsum("bqhl,lhv->bqhv", ctx.to(wv_b.dtype), wv_b)
    return out.reshape(b, 1, -1) @ params["wo"], cache_ckv, cache_krope
