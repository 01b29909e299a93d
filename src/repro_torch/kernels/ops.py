"""Dispatch for the kernels: a CUDA tensor goes to the hand-written kernel, a
CPU tensor to the kernel's plain version, and there is no third way. The
model layer calls these under ``impl="kernel"``.

Under a device mesh the kernels take local shards (``local_map``):

* ``flash_attention_op`` runs its forward and backward (K1, K2a/K2b) on
  each rank's shard, batch over "data" and heads over "model"
  (``attention_on_local_shards``);
* ``flash_decode_op`` (K3) reads a cache in ``cache_shardings``'
  placements where it lies (``decode_on_local_shards``): batch over "data",
  KV heads over "model" (each rank's query heads with them), or the
  sequence over a mesh dim, where each rank takes K3's partial entry over
  its rows and ``combine_partials`` merges the ranks' results, as XLA's
  psums do for the reference;
* ``fused_ffn_op`` (K4) runs on each rank's rows and its slice of "ff",
  the weights' "embed" gathered (FSDP), and all-reduces the partial sums
  over "model" (``ffn_on_local_shards``: Megatron's row-parallel output).

K5 refuses a ``DTensor``: its mesh path is item 14c's, and a Mamba-2 layer
trains through a mesh on the naive scan (``models.ssm``). On a CUDA shard
each op launches its kernel or raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (check_inputs as _check_attention,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)
from repro_torch.kernels.flash_decode import (cdiv, check_inputs as _check_decode,
                                              flash_decode, flash_decode_partial,
                                              flash_decode_partial_plain, flash_decode_plain,
                                              shard_kv_len)
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
    only: the decode path runs under ``no_grad``. ``DTensor`` inputs run on
    their local shards (``decode_on_local_shards``)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return decode_on_local_shards(q, k, v, kv_len, scale)
    if q.is_cuda:
        return flash_decode(q, k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len)
    return flash_decode_plain(q, k, v, kv_len, scale=scale)


def flash_decode_partial_op(q, k, v, kv_len, *, scale=None):
    """K3's partial entry, ``(out fp32, lse fp32)`` over the cache's first
    ``kv_len`` rows (0 allowed): the kernel for CUDA tensors, its plain
    version for CPU tensors."""
    if q.is_cuda:
        return flash_decode_partial(q.contiguous(), k, v, kv_len, scale=scale)
    _check_decode(q, k, v, kv_len, min_len=0)
    return flash_decode_partial_plain(q, k, v, kv_len, scale=scale)


def _all_reduce(t, op, group):
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def combine_partials(out, lse, mesh=None, axis=None):
    """Merges partial softmax results by their log-sum-exps: ``out`` (...,
    Dv), each part normalised over its own keys, and ``lse`` (...) fp32, the
    natural-log log-sum-exp of those keys' scores (NEG_INF for a part with
    none). The parts are the ranks of ``mesh``'s dim ``axis`` (a name or an
    index), merged by all-reduces over its process group, or, where
    ``mesh`` is None, the leading dim of ``out`` and ``lse``:

        m = max lse;  w = exp(lse - m);  out = sum(w out) / sum(w);
        lse = m + log(sum w).

    Returns (out, lse) in fp32. Plain PyTorch: a small collective, not a
    kernel; K3's partial entry and MLA's absorbed decode both use it."""
    out, lse = out.float(), lse.float()
    if mesh is None:
        m = lse.amax(0)
        w = torch.exp(lse - m)
        num, den = (w[..., None] * out).sum(0), w.sum(0)
    else:
        group = mesh.get_group(axis)
        m = _all_reduce(lse, dist.ReduceOp.MAX, group)
        w = torch.exp(lse - m)
        num = _all_reduce(w[..., None] * out, dist.ReduceOp.SUM, group)
        den = _all_reduce(w, dist.ReduceOp.SUM, group)
    return num / den[..., None], m + torch.log(den)


def cache_layout(cache):
    """How a ``DTensor`` cache (B, S, ...) lies on its mesh, as
    ``cache_shardings`` places it: (the placements of its queries (B, H,
    ...): batch where the cache's batch is, heads where its KV heads are,
    replicated elsewhere; the mesh dim its sequence is sharded over, or
    None). Any other layout raises."""
    q_layout, seq_dim = [], None
    for i, p in enumerate(cache.placements):
        if isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in (0, 2)):
            q_layout.append(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p)
        elif isinstance(p, Shard) and p.dim == 1 and seq_dim is None:
            seq_dim = i
            q_layout.append(Replicate())
        else:
            raise NotImplementedError(
                f"a cache on a mesh lies in cache_shardings' placements (batch, KV heads or "
                f"one sequence split), not {tuple(cache.placements)}")
    return q_layout, seq_dim


def seq_offset(cache, seq_dim) -> int:
    """The first sequence row of this rank's shard of ``cache``, sharded
    over mesh dim ``seq_dim`` (None: 0), as DTensor splits a dim."""
    if seq_dim is None:
        return 0
    mesh = cache.device_mesh
    return cdiv(cache.shape[1], mesh.size(seq_dim)) * mesh.get_local_rank(seq_dim)


def decode_on_local_shards(q, k, v, kv_len, scale=None, whole=None, partial=None):
    """``flash_decode_op`` on ``DTensor`` q (B,H,D) and a cache k/v (B,S,KVH,D)
    in ``cache_shardings``' placements, read where it lies (no gather):
    q is redistributed to the cache's layout (``cache_layout``), and each
    rank runs K3 on its batch rows and KV heads. Where the sequence is
    sharded, each rank runs K3's partial entry over its rows' share of
    ``kv_len`` (``shard_kv_len``, 0 for a shard past it) and the ranks'
    results are merged over that mesh dim (``combine_partials``). Returns
    a ``DTensor`` in q's layout, in q's dtype. ``whole`` and ``partial``
    replace K3's two entries (the model's naive decode passes its own)."""
    whole = whole or flash_decode_op
    partial = partial or flash_decode_partial_op
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)
            and tuple(v.placements) == tuple(k.placements)):
        raise NotImplementedError("flash_decode on a mesh takes the cache's k and v as "
                                  "DTensors in one of cache_shardings' placements")
    mesh = k.device_mesh
    q_layout, seq_dim = cache_layout(k)
    offset = seq_offset(k, seq_dim)

    def local(q_, k_, v_):
        if seq_dim is None:
            return whole(q_.contiguous(), k_, v_, kv_len, scale=scale)
        n = shard_kv_len(kv_len, offset, k_.shape[1])
        out, lse = partial(q_, k_, v_, n, scale=scale)
        return combine_partials(out, lse, mesh, seq_dim)[0].to(q_.dtype)

    return local_map(local, out_placements=q_layout,
                     in_placements=(q_layout, k.placements, k.placements), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


# what K5 on a mesh waits for: training takes the naive scan (K5 is forward only)
SSD_SCAN_WAITS_FOR = "K5 and the hybrid prefill through a mesh are item 14c's"


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
    in the reference: the wrapper refuses inputs that require grad.
    ``DTensor`` inputs run on local shards (``ffn_on_local_shards``)."""
    if any(isinstance(t, DTensor) for t in (x, w_gate, w_up, w_down)):
        return ffn_on_local_shards(x, w_gate, w_up, w_down)
    if x.is_cuda:
        return fused_ffn(x.contiguous(), w_gate, w_up, w_down)
    _check_ffn(x, w_gate, w_up, w_down)
    build.refuse_grad("fused_ffn", x, w_gate, w_up, w_down)
    return fused_ffn_plain(x, w_gate, w_up, w_down)


def ffn_on_local_shards(x, w_gate, w_up, w_down):
    """``fused_ffn_op`` on ``DTensor``s, Megatron's MLP: x's rows over "data"
    (where they divide it), w_gate/w_up with "ff" over "model" and their
    "embed" dim gathered over "data" (FSDP), w_down the same with the dims
    swapped. Each rank runs K4 on its rows and its F-slice: SwiGLU is a sum
    over F, so its result is a partial sum over "model", all-reduced into
    the rows' layout (the row-parallel output; the decode step's one-token
    rows leave no sequence for a reduce-scatter to split). Where F does not
    divide "model" each rank runs all of F and nothing is reduced."""
    if not all(isinstance(t, DTensor) for t in (x, w_gate, w_up, w_down)):
        raise NotImplementedError("fused_ffn on a mesh takes x and its three weights as "
                                  "DTensors on one mesh")
    mesh = x.device_mesh
    sizes = mesh_sizes(mesh)
    rows = Shard(0) if "data" in sizes and x.shape[0] % sizes["data"] == 0 else None
    split = "model" in sizes and w_gate.shape[1] % sizes["model"] == 0
    x_layout = role_placements(mesh, rows)
    up = role_placements(mesh, None, Shard(1) if split else None)
    down = role_placements(mesh, None, Shard(0) if split else None)

    def local(x_, g_, u_, d_):
        return fused_ffn_op(x_, g_.contiguous(), u_.contiguous(), d_.contiguous())

    y = local_map(local, out_placements=role_placements(mesh, rows, Partial() if split else None),
                  in_placements=(x_layout, up, up, down), device_mesh=mesh,
                  redistribute_inputs=True)(x, w_gate, w_up, w_down)
    return y.redistribute(mesh, x_layout)
