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
An int8 cache (``core.msm.compose(..., kv_cache_dtype="int8")``) is written
through ``to_cache_dtype`` (JAX's saturating cast) and read with the
reference's arithmetic: the scores in q's dtype, the weighted sum in bf16
(``decode_attention``, K3's plain versions), MLA's softmax weights in the
cache's dtype. K3 itself reads bf16 or fp32 only and raises on it.

Under a device mesh the caches are ``DTensor``s in ``cache_shardings``'
placements. The new token's row is written into the local shard of the rank
that holds its position (``write_cache_row``), and the decode reads each
rank's shard where it lies: GQA through ``kernels.ops.flash_decode_op``, MLA
by each rank's partial softmax over its rows and ``combine_partials`` where
the latent cache's sequence is sharded. Neither gathers the cache.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_decode import flash_decode_partial_plain, shard_kv_len
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import apply_rope
from repro_torch.sharding.partition import fit, mesh_sizes, placements, replicate_like

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
    An int8 cache is read as the reference reads it: the scores in q's
    dtype (JAX promotes int8 against it), the weighted sum in bf16.
    """
    b, _, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d)
    k_cache = k_cache.to(torch.promote_types(q.dtype, k_cache.dtype))
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * scale
    mask = torch.arange(s, device=q.device) < kv_len
    scores = scores.masked_fill(~mask, NEG_INF)
    acc = torch.bfloat16 if v_cache.dtype == torch.int8 else v_cache.dtype
    p = torch.softmax(scores, dim=-1).to(acc)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(acc))
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
    if not (isinstance(t, DTensor) and n_heads % mesh_sizes(t.device_mesh).get("model", 1)):
        return t
    # not ``constrain``, which leaves a tensor as it is where every entry
    # degrades (a batch of one): the columns must come back whole all the same
    mesh = t.device_mesh
    target = placements(fit(t.shape, (("pod", "data"), None, None), mesh), mesh)
    return t if tuple(t.placements) == target else t.redistribute(mesh, target)


def merge_heads(out):
    """An attention output (B, S, H, Dv) as (B, S, H * Dv). A ``DTensor`` is
    flattened on each rank's shard (``local_map``) in the placements it
    has, so that the gradient coming back is brought to those placements
    first: where the heads do not divide "model" the output is
    "model"-replicated, while the output projection's backward hands its
    gradient back with the flattened width over "model", which no rank
    could unflatten into whole heads."""
    b, s = out.shape[:2]
    if not isinstance(out, DTensor):
        return out.reshape(b, s, -1)
    layout = list(out.placements)
    return local_map(lambda t: t.reshape(t.shape[0], t.shape[1], -1), out_placements=layout,
                     in_placements=(layout,), device_mesh=out.device_mesh)(out)


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
    return merge_heads(out) @ params["wo"]


def to_cache_dtype(x, dtype):
    """``x`` in a cache's ``dtype``. Into int8 a float is truncated toward
    zero and saturated to [-128, 127], NaN to 0, as JAX's ``astype(int8)``
    casts it (the reference's cache writes); torch's ``.to`` would wrap."""
    if dtype == torch.int8 and x.is_floating_point():
        x = torch.nan_to_num(x.float().trunc(), nan=0.0).clamp(-128, 127)
    return x.to(dtype)


def write_cache_row(cache, pos: int, row) -> None:
    """``cache[:, pos] = row`` IN PLACE: ``cache`` (B, S, ...), ``row`` (B,
    ...). A ``DTensor`` cache is written in its local shard (indexing a
    ``DTensor`` on a sharded dim could write a redistributed temporary and
    leave the cache as it was): ``row`` is brought to the cache's layout
    less the sequence dim, and only the rank whose sequence shard holds
    ``pos`` writes, at ``pos`` less its shard's first row. The row takes the
    cache's dtype through ``to_cache_dtype``."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = to_cache_dtype(row, cache.dtype)
        return
    _, seq_dim = kops.cache_layout(cache)
    row_layout = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                  else (Replicate() if isinstance(p, Shard) and p.dim == 1 else p)
                  for p in cache.placements]
    # every rank redistributes (a collective), one writes
    row = replicate_like(row, cache).redistribute(cache.device_mesh, row_layout).to_local()
    local = cache.to_local()
    offset = kops.seq_offset(cache, seq_dim)
    if offset <= pos < offset + local.shape[1]:
        local[:, pos - offset] = to_cache_dtype(row, local.dtype)
    elif seq_dim is None:
        raise IndexError(f"position {pos} outside the cache's {cache.shape[1]} rows")


def gqa_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos: int,
               impl="kernel"):
    """One-token decode. cache_[kv]: (B, S, KVH, D), updated IN PLACE at
    ``pos``, the host-side index of the new token (``write_cache_row``).
    Returns (out, cache_k, cache_v), the caches being the tensors passed
    in."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    write_cache_row(cache_k, pos, k[:, 0])
    write_cache_row(cache_v, pos, v[:, 0])
    q = _query_for(q, cache_k)
    if impl == "kernel":
        out = kops.flash_decode_op(q[:, 0], cache_k, cache_v, pos + 1)
    elif isinstance(cache_k, DTensor):
        # the oracle on each rank's shards, laid out as the kernel path reads them
        out = kops.decode_on_local_shards(q[:, 0], cache_k, cache_v, pos + 1,
                                          whole=_decode_attention_3d,
                                          partial=flash_decode_partial_plain)
    else:
        out = decode_attention(q, cache_k, cache_v, kv_len=pos + 1)
    out = out.reshape(b, 1, -1).to(x.dtype) @ params["wo"]
    return out, cache_k, cache_v


def _query_for(q, cache):
    """q in the dtype of a float cache, as K3 takes them; against an int8
    cache q keeps its own, as the reference's einsum promotes the cache."""
    return q.to(cache.dtype) if cache.dtype.is_floating_point else q


def _decode_attention_3d(q, k_cache, v_cache, kv_len, scale=None):
    """``decode_attention`` on q (B,H,D), as K3 takes it: (B,H,Dv)."""
    return decode_attention(q[:, None], k_cache, v_cache, kv_len, scale)[:, 0]


def cross_decode(params, cfg: ModelConfig, x, cross_k, cross_v, impl="kernel"):
    """One token's cross-attention (the encoder-decoder's): queries from
    ``x`` (B,1,d), keys and values the cached (B,S_enc,KVH,D), every row
    valid, no rotary embedding. ``impl="kernel"`` runs K3 at kv_len = S_enc,
    ``"naive"`` the plain ``decode_attention`` the reference takes. An empty
    cache (S_enc = 0) adds nothing, as the reference's sum over no keys.
    A ``DTensor`` cache is read where it lies, as ``gqa_decode`` reads its
    own: at batch 1 its sequence lies over "data" (``cache_shardings``), and
    each rank runs K3's partial entry at its share of kv_len = S_enc."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not one of {IMPLS}")
    b, enc_len = x.shape[0], cross_k.shape[1]
    if enc_len == 0:
        return torch.zeros_like(x)
    q = whole_heads(x @ params["wq"], cfg.n_heads).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    q = _query_for(q, cross_k)
    if impl == "kernel":
        out = kops.flash_decode_op(q[:, 0], cross_k, cross_v, enc_len)
    elif isinstance(cross_k, DTensor):
        out = kops.decode_on_local_shards(q[:, 0], cross_k, cross_v, enc_len,
                                          whole=_decode_attention_3d,
                                          partial=flash_decode_partial_plain)
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
    c_kv, k_rope = _mla_latent(params, cfg, x, positions)
    q, k, v = _mla_qkv(params, cfg, x, positions, c_kv, k_rope)
    scale = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    out = sdpa(q, k, v, causal=causal, impl=impl, scale=scale)
    return merge_heads(out) @ params["wo"]


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
    write_cache_row(cache_ckv, pos, c_new[:, 0])
    write_cache_row(cache_krope, pos, krope_new[:, 0])

    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, params["wk_b"].reshape(kvl, h, hd))
    scale = (hd + r) ** -0.5
    if isinstance(cache_ckv, DTensor):
        ctx = _mla_context_on_local_shards(q_abs, q_rope, cache_ckv, cache_krope, pos + 1, scale)
    else:
        ctx = _mla_context(q_abs, q_rope, cache_ckv, cache_krope, pos + 1, scale)
    wv_b = params["wv_b"].reshape(kvl, h, vd)
    out = torch.einsum("bqhl,lhv->bqhv", ctx.to(wv_b.dtype), wv_b)
    return out.reshape(b, 1, -1) @ params["wo"], cache_ckv, cache_krope


def _mla_scores(q_abs, q_rope, ckv, krope, kv_len, scale):
    """The absorbed decode's scaled scores (B,H,1,S) fp32 against the latent
    cache, rows at or past ``kv_len`` NEG_INF, and the rows' validity (S,)."""
    s_nope = torch.einsum("bqhl,bkl->bhqk", q_abs.float(), ckv.float())
    s_rope = torch.einsum("bqhr,bkr->bhqk", q_rope.float(), krope.float())
    valid = torch.arange(ckv.shape[1], device=ckv.device) < kv_len
    return ((s_nope + s_rope) * scale).masked_fill(~valid, NEG_INF), valid


def _mla_context(q_abs, q_rope, ckv, krope, kv_len, scale):
    """The softmax-weighted latent rows (B,1,H,kv_lora) over the first
    ``kv_len`` rows of the cache, in its dtype."""
    scores, _ = _mla_scores(q_abs, q_rope, ckv, krope, kv_len, scale)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkl->bqhl", p.to(ckv.dtype), ckv)


def _mla_context_on_local_shards(q_abs, q_rope, ckv, krope, kv_len, scale):
    """``_mla_context`` on a ``DTensor`` latent cache in ``cache_shardings``'
    placements, read where it lies: the queries (every head) go to the
    cache's batch layout, and where the cache's sequence is sharded each
    rank takes the partial softmax over its rows (normalised by their own
    log-sum-exp; a rank with no valid row weighs nothing) and
    ``combine_partials`` merges the ranks' contexts over that mesh dim, the
    psums XLA inserts for the reference. ``wv_b`` is linear, so it applies
    after the merge."""
    mesh = ckv.device_mesh
    q_layout, seq_dim = kops.cache_layout(ckv)
    offset = kops.seq_offset(ckv, seq_dim)
    # the queries' batch where the cache's batch is, every head on every rank
    q_layout = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in q_layout]

    def local(qa, qr, c_, kr):
        if seq_dim is None:
            return _mla_context(qa, qr, c_, kr, kv_len, scale)
        scores, valid = _mla_scores(qa, qr, c_, kr, shard_kv_len(kv_len, offset, c_.shape[1]),
                                    scale)
        if not c_.dtype.is_floating_point:
            return _int_context_over_shards(scores, c_, mesh, seq_dim)
        lse = torch.logsumexp(scores, dim=-1)                       # (B,H,1)
        p = torch.exp(scores - lse[..., None]) * valid
        ctx = torch.einsum("bhqk,bkl->bqhl", p.to(c_.dtype), c_)
        lse = torch.where(valid.any(), lse, torch.full_like(lse, NEG_INF)).transpose(1, 2)
        return kops.combine_partials(ctx, lse, mesh, seq_dim)[0].to(c_.dtype)

    return local_map(local, out_placements=q_layout,
                     in_placements=(q_layout, q_layout, ckv.placements, krope.placements),
                     device_mesh=mesh, redistribute_inputs=True)(q_abs, q_rope, ckv, krope)


def _int_context_over_shards(scores, ckv, mesh, seq_dim):
    """The weighted latent rows of an integer (int8) cache whose sequence is
    sharded over mesh dim ``seq_dim``. The reference casts the softmax
    weights to the cache's dtype, which keeps only a weight of exactly 1, so
    no rank may normalise over its own rows: each takes the softmax over the
    whole sequence (its max and sum all-reduced, as ``jax.nn.softmax``
    computes it) and the ranks' integer sums are added, wrapping as the
    cache's dtype does."""
    group = mesh.get_group(seq_dim)
    m = kops.all_reduce(scores.amax(-1, keepdim=True), dist.ReduceOp.MAX, group)
    e = torch.exp(scores - m)
    p = e / kops.all_reduce(e.sum(-1, keepdim=True), dist.ReduceOp.SUM, group)
    ctx = torch.einsum("bhqk,bkl->bqhl", p.to(ckv.dtype).long(), ckv.long())
    return kops.all_reduce(ctx, dist.ReduceOp.SUM, group).to(ckv.dtype)
