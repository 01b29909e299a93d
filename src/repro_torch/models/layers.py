"""Shared layer primitives: RMSNorm, RoPE, SwiGLU FFN, embeddings, chunked
cross-entropy.
Pure functions over param dicts (see ``models.base``). Weights are stored
``(d_in, d_out)`` and applied as ``x @ W``.

Under a device mesh the weights and activations are ``DTensor``s, and
DTensor's sharding rules carry the norms, RoPE and the products. Two ops
take their weight replicated (``Replicate()`` on every mesh dim) and run on
each rank's rows instead (``on_rows``): the embedding gather, whose vocab
shards over "model", and the chunked cross-entropy (the vocab projection,
its gold-logit gather and the per-chunk recompute), so that each rank runs
the very ops of the single-device path on its rows. ``models.ssm`` runs
the Mamba-2 mixer so too, with all of its weights replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.base import P, Specs
from repro_torch.sharding.partition import mesh_sizes, replicate_like, role_placements


# --------------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------------

def rmsnorm_specs(d: int) -> Specs:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Half-split
    layout: the first D/2 lanes rotate against the last D/2; angles in fp32."""
    half = x.shape[-1] // 2
    positions = replicate_like(positions, x)
    freqs = replicate_like(rope_frequencies(x.shape[-1], theta, x.device), x)   # (half,)
    angles = positions[..., :, None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------------
# SwiGLU FFN
# --------------------------------------------------------------------------------

def ffn_specs(d: int, d_ff: int) -> Specs:
    return {
        "w_gate": P((d, d_ff), ("embed", "ff")),
        "w_up": P((d, d_ff), ("embed", "ff")),
        "w_down": P((d_ff, d), ("ff", "embed")),
    }


def ffn(params, x, fused: bool = False):
    """SwiGLU. ``fused=True`` flattens (..., D) to (T, D) and runs K4
    (``kernels.ops.fused_ffn_op``: forward only, silu(g)*u kept in fp32),
    the port's consumer of the reference's ``MemoryPolicy.fused_ffn``."""
    if fused:
        y = kops.fused_ffn_op(x.reshape(-1, x.shape[-1]), params["w_gate"], params["w_up"],
                              params["w_down"])
        return y.reshape(x.shape)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    # silu in fp32, cast back to the input dtype BEFORE the product with u
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


# --------------------------------------------------------------------------------
# Embedding + LM head
# --------------------------------------------------------------------------------

def embedding_specs(vocab: int, d: int, tied: bool) -> Specs:
    s: Specs = {"embedding": P((vocab, d), ("vocab", "embed"), init="small")}
    if not tied:
        s["lm_head"] = P((d, vocab), ("embed", "vocab"))
    return s


def _leaves(tree) -> list:
    """The leaves of one tensor or a nested dict of them, in key order."""
    return [t for v in tree.values() for t in _leaves(v)] if hasattr(tree, "keys") else [tree]


def _rebuild(like, leaves):
    """``leaves`` in the shape of ``like`` (one tensor or a nested dict)."""
    it = iter(leaves)

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if hasattr(node, "keys") else next(it)

    return walk(like)


def on_rows(fn, weights, *rows, out_rows=True, n_out=1):
    """``fn(weights, *rows)`` on each rank's rows of ``DTensor`` inputs:
    ``weights`` (one tensor, or a nested dict of them) replicated, each
    (B, ...) ``rows`` tensor split over "data" by its batch where that
    divides (replicated otherwise) and replicated over "model". Each
    weight's gradient is a partial sum over "data" where the rows are
    split. ``fn`` returns ``n_out`` tensors (one, or a tuple): rows too
    where ``out_rows``, else sums over the rows (partial over "data")."""
    flat = _leaves(weights)
    n = len(flat)
    mesh = flat[0].device_mesh
    sizes = mesh_sizes(mesh)
    split = "data" in sizes and rows[0].shape[0] % sizes["data"] == 0

    def layout(kind):
        return role_placements(mesh, kind if split else None)

    def local(*args):
        return fn(_rebuild(weights, args[:n]), *args[n:])

    rows = tuple(replicate_like(r, flat[0]) for r in rows)
    out = layout(Shard(0) if out_rows else Partial())
    return local_map(local, out_placements=out if n_out == 1 else (out,) * n_out,
                     in_placements=(role_placements(mesh),) * n + (layout(Shard(0)),) * len(rows),
                     in_grad_placements=(layout(Partial()),) * n
                     + (layout(Shard(0)),) * len(rows),
                     device_mesh=mesh, redistribute_inputs=True)(*flat, *rows)


def copy_into(dst, src) -> None:
    """``dst.copy_(src)``, in place, for ``DTensor``s too: ``src`` is brought
    to ``dst``'s placements and copied into ``dst``'s local shard, which is
    the storage a layer's slice of a cache shares with the stacked cache."""
    if isinstance(dst, DTensor):
        src = replicate_like(src, dst).redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def _gather_rows(w, tokens):
    return w[tokens]


def embed(params, tokens):
    w = params["embedding"]
    if isinstance(w, DTensor):
        return on_rows(_gather_rows, w, tokens)
    return _gather_rows(w, tokens)


def unembed_weight(params):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embedding"].T


def _chunk_loss(hx, w, lx, mx):
    logits = (hx @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None])[..., 0]
    return ((lse - gold) * mx).sum()


def _loss_sums(w, h, labels, mask, chunk: int = 512):
    """(masked loss sum, mask sum) of ``chunked_cross_entropy``."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_loss, h[:, sl], w, labels[:, sl].long(), mask[:, sl],
                                   use_reentrant=False, preserve_rng_state=False)
    return total, mask.sum()


def chunked_cross_entropy(params, h, labels, chunk: int = 512, mask=None):
    """Vocab projection + softmax cross-entropy without materializing the
    full logits. h: (B,S,D); labels: (B,S); mask: optional (B,S) weights.

    S is padded to a multiple of ``chunk``; each chunk's (B, chunk, V) logits
    are taken in the hidden states' dtype and cast to fp32, as the reference
    does, and recomputed in the backward (``torch.utils.checkpoint`` per
    chunk). Returns the masked sum over ``max(mask.sum(), 1)``. Under a mesh
    each rank sums its rows against the replicated vocab projection."""
    w = unembed_weight(params)
    b, s, _ = h.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
    mask = mask.float()
    if isinstance(w, DTensor):
        total, count = on_rows(lambda w_, *r: _loss_sums(w_, *r, chunk=chunk), w, h, labels,
                               mask, out_rows=False, n_out=2)
        # sums over "data": the loss is one number on every rank (``float``
        # of a partial sum would read this rank's share)
        whole = role_placements(w.device_mesh)
        count = count.redistribute(placements=whole)
        return (total / torch.clamp(count, min=1.0)).redistribute(placements=whole)
    total, count = _loss_sums(w, h, labels, mask, chunk)
    return total / torch.clamp(count, min=1.0)


def logits_for_tokens(params, h):
    """Full logits (decode path: S is 1)."""
    return h @ unembed_weight(params)
