"""Dispatch for the kernels: a CUDA tensor goes to the hand-written kernel, a
CPU tensor to the kernel's plain version, and there is no third way. The
model layer calls these under ``impl="kernel"``."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (check_inputs as _check_attention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)
from repro_torch.kernels.flash_decode import (check_inputs as _check_decode,
                                              flash_decode, flash_decode_plain)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: K1 forward, K2a/K2b backward on the
    card; the plain forward and backward for CPU tensors. The forward saves
    ``(q, k, v, out, lse)``, so the backward recomputes P from ``lse`` and
    never reruns the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        if q.is_cuda:
            out, lse = flash_attention(q, k, v, causal=causal, scale=scale)
        else:
            _check_attention(q, k, v, causal)
            out, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        bwd = flash_attention_bwd if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_op(q, k, v, *, causal: bool = True, scale=None):
    """q (B,Sq,H,D), k/v (B,Skv,KVH,D) -> (B,Sq,H,D), differentiable."""
    return FlashAttentionFn.apply(q, k, v, causal, scale)


def flash_decode_op(q, k, v, kv_len: int, *, scale=None):
    """q (B,H,D), k/v (B,S,KVH,D), kv_len host int -> (B,H,D). Forward only:
    the decode path runs under ``no_grad``."""
    if q.is_cuda:
        return flash_decode(q, k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len)
    return flash_decode_plain(q, k, v, kv_len, scale=scale)
