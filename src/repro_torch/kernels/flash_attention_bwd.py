"""flash_attention backward: the wrappers of the two CUDA kernels in
``csrc/flash_attention_bwd.cu`` (K2a ``dq``; K2b ``dk`` + ``dv``), and the
plain PyTorch versions of the same functions beside them.

    q, dout (B,Sq,H,D), k/v (B,Skv,KVH,D), out (B,Sq,H,D), lse (B,Sq,H) fp32
    -> dq (B,Sq,H,D), dk, dv (B,Skv,KVH,D)

``lse`` is the forward's (``flash_attention`` returns it); ``P`` is recomputed
from it as ``exp(scale * q k^T - lse)``, never stored. ``delta =
rowsum(out * dout)`` in fp32 is computed once here and handed to both
kernels. ``flash_attention_bwd`` takes CUDA tensors only and launches K2a
then K2b on the current stream, or raises; each kernel's wrapper counts its
own launches. The plain versions materialize P in fp32; the CPU tests and the
on-card comparison use them, and ``kernels.ops`` takes them for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF, check_inputs


def attention_delta(out, dout):
    """``rowsum(out * dout)`` in fp32, (B,Sq,H): the ``delta`` of the
    backward, computed once for both kernels."""
    return (out.float() * dout.float()).sum(-1)


def _plain_p_ds(q, k, v, out, lse, dout, causal: bool, scale: float):
    """fp32 P and dS, (B,KVH,G,Sq,Skv), as ``_p_block`` and the Pallas
    kernels compute them; also the fp32 grouped q and dout."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).float()
    dog = dout.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse_t = lse.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)         # (B,KVH,G,Sq)
    p = torch.exp(s - lse_t[..., None])
    delta = attention_delta(out, dout)
    delta_t = delta.reshape(b, sq, kvh, g).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta_t[..., None]) * scale
    return p, ds, qg, dog


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                                 scale: float | None = None):
    """Plain version of K2a, fp32 inside: dq in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, _, _ = _plain_p_ds(q, k, v, out, lse, dout, causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                                  scale: float | None = None):
    """Plain version of K2b, fp32 inside: (dk, dv) in k's and v's dtypes,
    each summed over the G query heads of a KV head."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds, qg, dog = _plain_p_ds(q, k, v, out, lse, dout, causal, scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              scale: float | None = None):
    """Plain version of the whole backward: ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    dq = flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, causal=causal, scale=scale)
    return dq, dk, dv


def check_bwd_inputs(q, k, v, out, lse, dout, causal: bool) -> None:
    """What both versions require of their arguments."""
    check_inputs(q, k, v, causal)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must have "
                         f"q's shape {tuple(q.shape)}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 of shape {tuple(q.shape[:3])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")


def _launch_args(q, k, causal, scale):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {HEAD_DIMS}")
    scale = scale if scale is not None else d ** -0.5
    return (b, sq, skv, h, kvh, d, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)


def _check_cuda(q, k, v, dout, lse, delta):
    build.check_cuda_tensors(q=q, k=k, v=v, dout=dout)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {q.device}")
    if delta.shape != lse.shape:
        raise ValueError(f"delta {tuple(delta.shape)} must have lse's shape {tuple(lse.shape)}")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           scale: float | None = None):
    """Launches K2a on the current stream: dq. CUDA tensors, bf16 or fp32,
    contiguous; ``lse`` and ``delta`` (B,Sq,H) fp32."""
    _check_cuda(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *_launch_args(q, k, causal, scale))
    build.check(lib, code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            scale: float | None = None):
    """Launches K2b on the current stream: (dk, dv). Arguments as K2a's."""
    _check_cuda(q, k, v, dout, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_launch_args(q, k, causal, scale))
    build.check(lib, code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0     # K2a launches made by this wrapper
flash_attention_bwd_dkv.launches = 0    # K2b launches made by this wrapper


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None):
    """The backward on the card: K2a then K2b. CUDA tensors only; returns
    ``(dq, dk, dv)``."""
    check_bwd_inputs(q, k, v, out, lse, dout, causal)
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv
