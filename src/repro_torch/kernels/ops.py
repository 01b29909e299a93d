"""Dispatch for the kernels: a CUDA tensor goes to the hand-written kernel, a
CPU tensor to the kernel's plain version, and there is no third way. The
model layer calls these under ``impl="kernel"``.

Under a device mesh the kernels take local shards: ``flash_attention_op``
given ``DTensor``s runs its forward and backward (K1, K2a/K2b) on each
rank's shard through ``local_map``, batch over "data" and heads over
"model" (``attention_on_local_shards``). The serving and SSM kernels (K3,
K4, K5) refuse a ``DTensor``: serving through a mesh is item 14b's, and a
Mamba-2 layer trains through a mesh on the naive scan (``models.ssm``).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

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
from repro_torch.sharding.partition import mesh_sizes, role_placements


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: K1 forward, K2a/K2b backward on the
    card; the plain forward and backward for CPU tensors. The forward saves
    ``(q, k, v, out, lse)``, so the backward recomputes P from ``lse`` and
    never reruns the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        if q.is_cuda:
            # a local shard or a KV-head slice may be a strided view: the
            # kernels read contiguous rows
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
    take any pair. ``DTensor`` inputs run on their local shards."""
    def attend(q_, k_, v_):
        return FlashAttentionFn.apply(q_, k_, v_, causal, scale)

    if isinstance(q, DTensor):
        return attention_on_local_shards(attend, q, k, v)
    return attend(q, k, v)


def _local_kv_heads(h: int, kvh: int, local_h: int, rank: int) -> slice | torch.Tensor:
    """The KV heads that query heads ``[rank*local_h, (rank+1)*local_h)`` of
    ``h`` read, ``kvh`` KV heads in all: a slice where those query heads fall
    into whole groups of one size, else an index of one KV head per query
    head (the KV heads expanded)."""
    g = h // kvh
    idx = [(rank * local_h + j) // g for j in range(local_h)]
    lo, hi = idx[0], idx[-1] + 1
    if all(idx.count(i) * (hi - lo) == local_h for i in range(lo, hi)):
        return slice(lo, hi)
    return torch.tensor(idx)


def attention_on_local_shards(fn, q, k, v):
    """``fn(q, k, v)`` (an attention on plain (B,S,H,D) tensors) on ``DTensor``
    inputs in the reference's attention layout: batch over "data", heads
    over "model", the full sequence, each input redistributed to it. Where
    the KV heads do not divide "model" they stay replicated while the query
    heads are sharded, and each rank reads the KV heads of its own query
    heads: their gradients are partial sums over "model". Returns a
    ``DTensor`` in the same layout."""
    mesh = q.device_mesh
    sizes = mesh_sizes(mesh)
    b, h, kvh = q.shape[0], q.shape[2], k.shape[2]
    batch = Shard(0) if "data" in sizes and b % sizes["data"] == 0 else None
    heads = "model" in sizes and h % sizes["model"] == 0
    kv_heads = heads and kvh % sizes["model"] == 0
    q_layout = role_placements(mesh, batch, Shard(2) if heads else None)
    kv_layout = role_placements(mesh, batch, Shard(2) if kv_heads else None)
    kv_grad = kv_layout if kv_heads or not heads else role_placements(mesh, batch, Partial())
    rank = mesh.get_local_rank("model") if heads and not kv_heads else 0

    def local(q_, k_, v_):
        if heads and not kv_heads:
            sel = _local_kv_heads(h, kvh, q_.shape[2], rank)
            k_, v_ = k_[:, :, sel], v_[:, :, sel]
        return fn(q_, k_, v_)

    return local_map(local, out_placements=q_layout, in_placements=(q_layout, kv_layout, kv_layout),
                     in_grad_placements=(q_layout, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def refuse_dtensor(what: str, waits_for: str, *tensors) -> None:
    """Raise on a ``DTensor`` argument: the kernel takes a whole tensor on one
    device, and the path that would shard its inputs is not ported."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise NotImplementedError(f"{what}: no sharded path under a device mesh yet "
                                  f"({waits_for}); call it with plain tensors")


def flash_decode_op(q, k, v, kv_len, *, scale=None):
    """q (B,H,D), k/v (B,S,KVH,D), kv_len (a host int, or a one-element
    integer tensor on q's device; int32 on the card) -> (B,H,D). Forward
    only: the decode path runs under ``no_grad``."""
    refuse_dtensor("flash_decode", "serving through a mesh and the sequence-sharded "
                   "cache's partial-softmax combine are item 14b's", q, k, v)
    if q.is_cuda:
        return flash_decode(q, k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len)
    return flash_decode_plain(q, k, v, kv_len, scale=scale)


# what K5 on a mesh waits for: training takes the naive scan (K5 is forward only)
SSD_SCAN_WAITS_FOR = "SSM serving through a mesh is item 14b's"


def ssd_scan_op(x, dt, A, b_, c_):
    """x (B,S,H,P), dt (B,S,H), A (H,), b_/c_ (B,S,N) -> (y (B,S,H,P),
    final state (B,H,P,N) fp32), from a zero state. Forward only, on either
    device: the reference has no backward for this kernel, so inputs that
    require grad are refused; ``models.ssm.ssd_chunked`` is the
    differentiable path."""
    refuse_dtensor("ssd_scan", SSD_SCAN_WAITS_FOR, x, dt, A, b_, c_)
    if x.is_cuda:
        return ssd_scan(*(a.contiguous() for a in (x, dt, A, b_, c_)))
    _check_ssd(x, dt, A, b_, c_)
    build.refuse_grad("ssd_scan", x, dt, A, b_, c_)
    return ssd_scan_plain(x, dt, A, b_, c_)


def fused_ffn_op(x, w_gate, w_up, w_down):
    """x (T,D), w_gate/w_up (D,F), w_down (F,D) -> (T,D). Forward only, as
    in the reference: the wrapper refuses inputs that require grad."""
    refuse_dtensor("fused_ffn", "serving through a mesh is item 14b's",
                   x, w_gate, w_up, w_down)
    if x.is_cuda:
        return fused_ffn(x.contiguous(), w_gate, w_up, w_down)
    _check_ffn(x, w_gate, w_up, w_down)
    build.refuse_grad("fused_ffn", x, w_gate, w_up, w_down)
    return fused_ffn_plain(x, w_gate, w_up, w_down)
