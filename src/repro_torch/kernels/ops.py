"""Dispatch for the kernels: a CUDA tensor goes to the hand-written kernel, a
CPU tensor to the kernel's plain version, and there is no third way. The
model layer calls these under ``impl="kernel"``."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import (check_inputs as _check_attention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (check_inputs as _check_decode,
                                              flash_decode, flash_decode_plain)


def flash_attention_op(q, k, v, *, causal: bool = True, scale=None):
    """q (B,Sq,H,D), k/v (B,Skv,KVH,D) -> (B,Sq,H,D)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, scale=scale)[0]
    _check_attention(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)[0]


def flash_decode_op(q, k, v, kv_len: int, *, scale=None):
    """q (B,H,D), k/v (B,S,KVH,D), kv_len host int -> (B,H,D)."""
    if q.is_cuda:
        return flash_decode(q, k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len)
    return flash_decode_plain(q, k, v, kv_len, scale=scale)
