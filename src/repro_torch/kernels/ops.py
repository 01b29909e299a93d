"""Dispatch for the kernels: a CUDA tensor goes to the hand-written kernel, a
CPU tensor to the kernel's plain version, and there is no third way. The
model layer calls these under ``impl="kernel"``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (check_inputs as _check_attention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)
from repro_torch.kernels.flash_decode import (check_inputs as _check_decode,
                                              flash_decode, flash_decode_plain)
from repro_torch.kernels.fused_ffn import (check_inputs as _check_ffn, fused_ffn,
                                           fused_ffn_plain)
from repro_torch.kernels.ssd_scan import (check_inputs as _check_ssd, ssd_scan,
                                          ssd_scan_plain)


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
        dout = dout.contiguous()                     # (B,Sq,H,Dv), as out
        bwd = flash_attention_bwd if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_op(q, k, v, *, causal: bool = True, scale=None):
    """q (B,Sq,H,D), k (B,Skv,KVH,D), v (B,Skv,KVH,Dv) -> (B,Sq,H,Dv),
    differentiable. On the card (D, Dv) is one of the kernels' ``HEAD_DIMS``
    (MLA's (192, 128) among them), else the launch raises; the plain versions
    take any pair."""
    return FlashAttentionFn.apply(q, k, v, causal, scale)


def flash_decode_op(q, k, v, kv_len, *, scale=None):
    """q (B,H,D), k/v (B,S,KVH,D), kv_len (a host int, or a one-element
    integer tensor on q's device; int32 on the card) -> (B,H,D). Forward
    only: the decode path runs under ``no_grad``."""
    if q.is_cuda:
        return flash_decode(q, k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len)
    return flash_decode_plain(q, k, v, kv_len, scale=scale)


def ssd_scan_op(x, dt, A, b_, c_):
    """x (B,S,H,P), dt (B,S,H), A (H,), b_/c_ (B,S,N) -> (y (B,S,H,P),
    final state (B,H,P,N) fp32), from a zero state. Forward only, on either
    device: the reference has no backward for this kernel, so inputs that
    require grad are refused; ``models.ssm.ssd_chunked`` is the
    differentiable path."""
    if x.is_cuda:
        return ssd_scan(*(a.contiguous() for a in (x, dt, A, b_, c_)))
    _check_ssd(x, dt, A, b_, c_)
    build.refuse_grad("ssd_scan", x, dt, A, b_, c_)
    return ssd_scan_plain(x, dt, A, b_, c_)


def fused_ffn_op(x, w_gate, w_up, w_down):
    """x (T,D), w_gate/w_up (D,F), w_down (F,D) -> (T,D). Forward only, as
    in the reference: the wrapper refuses inputs that require grad."""
    if x.is_cuda:
        return fused_ffn(x.contiguous(), w_gate, w_up, w_down)
    _check_ffn(x, w_gate, w_up, w_down)
    build.refuse_grad("fused_ffn", x, w_gate, w_up, w_down)
    return fused_ffn_plain(x, w_gate, w_up, w_down)
