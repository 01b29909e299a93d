"""flash_attention backward: the wrappers of the two CUDA kernels in
``csrc/flash_attention_bwd.cu`` (K2a ``dq``; K2b ``dk`` + ``dv``), and the
plain PyTorch versions of the same functions beside them.

    q (B,Sq,H,D), k (B,Skv,KVH,D), v (B,Skv,KVH,Dv), out and dout (B,Sq,H,Dv),
    lse (B,Sq,H) fp32 -> dq (B,Sq,H,D), dk (B,Skv,KVH,D), dv (B,Skv,KVH,Dv)

``lse`` is the forward's (``flash_attention`` returns it); ``P`` is recomputed
from it as ``exp(scale * q k^T - lse)``, never stored. ``delta =
rowsum(out * dout)`` in fp32 is computed once here and handed to both
kernels. ``flash_attention_bwd`` takes CUDA tensors only and launches K2a
then K2b on the current stream, or raises; each kernel's wrapper counts its
own launches. The plain versions materialize P in fp32 and take any (D, Dv);
the CPU tests and the on-card comparison use them, and ``kernels.ops`` takes
them for CPU tensors. The CUDA source instantiates K1's pairs, ``HEAD_DIMS``:
Dv differs from D in MLA attention (q/k at 192, v at 128).

``bwd_plan`` is the host-side plan the kernels are launched with: both grids,
K2a's key tile and K2b's q-tile (which pick the kernel instances), cluster
size and heads per block go to the C entry points, which launch them as
given (and refuse a grid that does not cover the tensors with their tiles). ``dq_walk``, ``dkv_walk``
and ``cluster_rows`` restate in Python the walk the CUDA source makes: which
tiles each block visits, which of them it masks, and which rows of a key tile
each block of a cluster sums. The CPU tests hold that statement of the walk;
only ``chip_smoke.py`` holds the kernels themselves, against the plain
versions on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import HEAD_DIMS, NEG_INF
from repro_torch.kernels.flash_attention import check_inputs


def attention_delta(out, dout):
    """``rowsum(out * dout)`` in fp32, (B,Sq,H): the ``delta`` of the
    backward, computed once for both kernels."""
    return (out.float() * dout.float()).sum(-1)


def _plain_p_ds(q, k, v, out, lse, dout, causal: bool, scale: float):
    """fp32 P and dS, (B,KVH,G,Sq,Skv), as ``_p_block`` and the Pallas
    kernels compute them (dP = dO V^T over Dv); also the fp32 grouped q and
    dout."""
    b, sq, h, d = q.shape
    _, skv, kvh, dv = v.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).float()
    dog = dout.reshape(b, sq, kvh, g, dv).float()
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
    check_inputs(q, k, v, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, _, _ = _plain_p_ds(q, k, v, out, lse, dout, causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                                  scale: float | None = None):
    """Plain version of K2b, fp32 inside: (dk, dv) in k's and v's dtypes,
    each summed over the G query heads of a KV head."""
    check_inputs(q, k, v, causal)
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
    want = (*q.shape[:3], v.shape[-1])
    if out.shape != want or dout.shape != want:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"(B,Sq,H,Dv) {want}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 of shape {tuple(q.shape[:3])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")


DQ_ROWS = 64            # query rows of a K2a block, bf16
DKV_KEYS = 64           # keys of a K2b block, bf16
MAX_CLUSTER = 8         # the portable thread-block cluster size
FMA_TILE = 32           # rows and keys of a tile of the fp32 kernels


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def cluster_size(g: int) -> int:
    """K2b's cluster size for G query heads a KV head: the largest divisor
    of G that is at most MAX_CLUSTER (8 for G = 8 or 16, 6 for G = 6 or 12,
    1 for MHA)."""
    return max(c for c in range(1, min(g, MAX_CLUSTER) + 1) if g % c == 0)


@dataclass(frozen=True)
class BwdPlan:
    """How K2a and K2b are launched for one shape and dtype.

    ``dq_tiles``/``dkv_tiles``: (query rows, keys) of a K2a block and of a K2b
    step; ``cluster``: K2b blocks that sum one key tile's dk/dv over their
    heads; ``heads_per_block``: query heads one K2b block walks (G/cluster);
    ``dq_grid``/``dkv_grid``: the CUDA grids; ``dq_descending``: K2a's grid
    row 0 is the last q-tile (the most key tiles under ``causal``), so the
    longest blocks start first. K2b's key tile 0 walks the most q-tiles and is
    its grid row 0 already. The fp32 kernels keep 32 x 32 tiles, one block per
    (tile, KV head, batch) and no cluster."""
    sq: int
    skv: int
    causal: bool
    fma: bool
    dq_tiles: tuple[int, int]
    dkv_tiles: tuple[int, int]
    cluster: int
    heads_per_block: int
    dq_grid: tuple[int, int, int]
    dkv_grid: tuple[int, int, int]

    @property
    def dq_descending(self) -> bool:
        return self.causal and not self.fma

    def summary(self) -> dict:
        return {"dq_tiles": list(self.dq_tiles), "dkv_tiles": list(self.dkv_tiles),
                "cluster": self.cluster, "heads_per_block": self.heads_per_block,
                "dq_grid": list(self.dq_grid), "dkv_grid": list(self.dkv_grid)}


# the bf16 tiles of each (D, Dv) instance: K2a's keys a step, 64, and 32 at
# (192, 128) (S and dP in 16 registers each beside dq's 96, and two blocks an
# SM); K2b's query rows a step, 64 at D <= 64, 32 at D = 128 (S^T and dP^T in
# 16 registers each beside the 128 of dk and dv), 16 at (192, 128) (8 each
# beside 160)
DQ_KEYS = {(32, 32): 64, (64, 64): 64, (128, 128): 64, (192, 128): 32}
DKV_Q_TILES = {(32, 32): 64, (64, 64): 64, (128, 128): 32, (192, 128): 16}


def bwd_plan(b: int, sq: int, skv: int, h: int, kvh: int, d: int, dtype,
             causal: bool, dv: int | None = None) -> BwdPlan:
    """The plan for q (b, sq, h, d), k (b, skv, kvh, d), v (b, skv, kvh, dv)
    of ``dtype`` (``dv`` defaults to ``d``); bf16 needs (d, dv) one of
    ``HEAD_DIMS``, whose instances set the tiles."""
    g = h // kvh
    if dtype == torch.float32:
        t = FMA_TILE
        return BwdPlan(sq, skv, causal, True, (t, t), (t, t), 1, g,
                       (cdiv(sq, t), h, b), (cdiv(skv, t), kvh, b))
    pair = (d, d if dv is None else dv)
    if pair not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {pair[0]}, v {pair[1]}) not supported: (D, Dv) one "
                         f"of {HEAD_DIMS}")
    c = cluster_size(g)
    return BwdPlan(sq, skv, causal, False, (DQ_ROWS, DQ_KEYS[pair]), (DKV_Q_TILES[pair], DKV_KEYS),
                   c, g // c, (b * h, cdiv(sq, DQ_ROWS), 1), (b * kvh * c, cdiv(skv, DKV_KEYS), 1))


def dq_walk(plan: BwdPlan, i: int) -> tuple[int, list[tuple[int, bool]]]:
    """The K2a block at position ``i`` of its tile axis (grid y in bf16, x in
    fp32): its q-tile's first row, and the key tiles it walks, in order, each
    as (first key, masked). A masked tile drops keys at or beyond Skv and,
    under ``causal``, keys above the query; query rows at or beyond Sq
    contribute nothing in any tile (bf16: lse = +inf there, so P = 0)."""
    bm, bn = plan.dq_tiles
    nq = cdiv(plan.sq, bm)
    m0 = (nq - 1 - i if plan.dq_descending else i) * bm
    n_end = min(plan.skv, m0 + bm) if plan.causal else plan.skv
    return m0, [(n0, plan.fma or (plan.causal and n0 + bn - 1 > m0) or n0 + bn > plan.skv)
                for n0 in range(0, n_end, bn)]


def dkv_walk(plan: BwdPlan, i: int) -> tuple[int, list[tuple[int, bool]]]:
    """The K2b block at position ``i`` of its key-tile axis: its first key,
    and the q-tiles it walks for each of its heads, in order, each as (first
    query, masked). A masked step drops queries at or beyond Sq and, under
    ``causal``, queries before the key; key rows at or beyond Skv are
    computed but never written."""
    bm, bn = plan.dkv_tiles
    n0 = i * bn
    first = n0 // bm if plan.causal else 0
    return n0, [(m * bm, plan.fma or (plan.causal and n0 + bn - 1 > m * bm)
                 or m * bm + bm > plan.sq)
                for m in range(first, cdiv(plan.sq, bm))]


def dkv_heads(plan: BwdPlan, kvh: int, g: int, rank: int) -> list[int]:
    """The query heads K2b's block of cluster rank ``rank`` walks, for KV head
    ``kvh`` with ``g`` query heads each."""
    return [kvh * g + rank * plan.heads_per_block + j for j in range(plan.heads_per_block)]


def cluster_rows(c: int, rows: int = DKV_KEYS) -> list[tuple[int, int]]:
    """The rows [r0, r1) of a key tile that block r of a K2b cluster sums over
    the cluster and writes (c need not divide the rows)."""
    return [(r * rows // c, (r + 1) * rows // c) for r in range(c)]


def _plan_for(q, k, v, causal) -> BwdPlan:
    b, sq, h, d = q.shape
    return bwd_plan(b, sq, k.shape[1], h, k.shape[2], d, q.dtype, causal, dv=v.shape[3])


def _launch_args(q, k, v, causal, scale):
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not supported: (D, Dv) one of {HEAD_DIMS}")
    scale = scale if scale is not None else d ** -0.5
    return (b, sq, skv, h, kvh, d, dv, float(scale), int(causal),
            int(q.dtype == torch.bfloat16))


def _check_cuda(q, k, v, dout, lse, delta, causal):
    check_inputs(q, k, v, causal)
    if dout.shape != (*q.shape[:3], v.shape[-1]):
        raise ValueError(f"dout {tuple(dout.shape)} must be (B,Sq,H,Dv) "
                         f"{(*q.shape[:3], v.shape[-1])}")
    build.check_cuda_tensors(q=q, k=k, v=v, dout=dout)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 tensor on {q.device}")
    if delta.shape != lse.shape:
        raise ValueError(f"delta {tuple(delta.shape)} must have lse's shape {tuple(lse.shape)}")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                           scale: float | None = None):
    """Launches K2a on the current stream: dq. CUDA tensors, bf16 or fp32,
    contiguous, (q/k head dim, v head dim) one of ``HEAD_DIMS``; ``lse`` and
    ``delta`` (B,Sq,H) fp32."""
    _check_cuda(q, k, v, dout, lse, delta, causal)
    plan = _plan_for(q, k, v, causal)
    dq = torch.empty_like(q)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *_launch_args(q, k, v, causal, scale),
            plan.dq_tiles[1], *plan.dq_grid, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                            scale: float | None = None):
    """Launches K2b on the current stream: (dk, dv). Arguments as K2a's."""
    _check_cuda(q, k, v, dout, lse, delta, causal)
    plan = _plan_for(q, k, v, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_launch_args(q, k, v, causal, scale),
            plan.dkv_tiles[0], *plan.dkv_grid, plan.cluster, plan.heads_per_block,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0     # K2a launches made by this wrapper
flash_attention_bwd_dkv.launches = 0    # K2b launches made by this wrapper


def dkv_max_active_clusters(b: int, sq: int, skv: int, h: int, kvh: int, d: int,
                            causal: bool = True, dv: int | None = None) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the bf16 K2b launch at this
    shape (v's head dim ``dv``, default ``d``): how many of its clusters the
    card holds at once."""
    import ctypes

    dv = d if dv is None else dv
    plan = bwd_plan(b, sq, skv, h, kvh, d, torch.bfloat16, causal, dv=dv)
    out = ctypes.c_int(0)
    lib = build.load_library()
    code = lib.flash_attention_bwd_dkv_max_clusters(b, sq, skv, h, kvh, d, dv, plan.dkv_tiles[0],
                                                    *plan.dkv_grid, plan.cluster,
                                                    plan.heads_per_block, ctypes.byref(out))
    build.check(lib, code, "flash_attention_bwd_dkv_max_clusters")
    return out.value


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None):
    """The backward on the card: K2a then K2b. CUDA tensors only; returns
    ``(dq, dk, dv)``."""
    check_bwd_inputs(q, k, v, out, lse, dout, causal)
    delta = attention_delta(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv
