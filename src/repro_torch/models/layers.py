"""Shared layer primitives: RMSNorm, RoPE, SwiGLU FFN, embeddings, chunked
cross-entropy.
Pure functions over param dicts (see ``models.base``). Weights are stored
``(d_in, d_out)`` and applied as ``x @ W``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.base import P, Specs


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
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (half,)
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


def embed(params, tokens):
    return params["embedding"][tokens]


def unembed_weight(params):
    if "lm_head" in params:
        return params["lm_head"]
    return params["embedding"].T


def _chunk_loss(hx, w, lx, mx):
    logits = (hx @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None])[..., 0]
    return ((lse - gold) * mx).sum()


def chunked_cross_entropy(params, h, labels, chunk: int = 512, mask=None):
    """Vocab projection + softmax cross-entropy without materializing the
    full logits. h: (B,S,D); labels: (B,S); mask: optional (B,S) weights.

    S is padded to a multiple of ``chunk``; each chunk's (B, chunk, V) logits
    are taken in the hidden states' dtype and cast to fp32, as the reference
    does, and recomputed in the backward (``torch.utils.checkpoint`` per
    chunk). Returns the masked sum over ``max(mask.sum(), 1)``."""
    w = unembed_weight(params)
    b, s, _ = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    mask = torch.ones((b, s), dtype=torch.float32, device=h.device) if mask is None else mask.float()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_chunk_loss, h[:, sl], w, labels[:, sl].long(), mask[:, sl],
                                   use_reentrant=False, preserve_rng_state=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def logits_for_tokens(params, h):
    """Full logits (decode path: S is 1)."""
    return h @ unembed_weight(params)
