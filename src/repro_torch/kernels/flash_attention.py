"""flash_attention forward: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu``, and the plain PyTorch version of the same
function beside it.

    q (B,Sq,H,D), k (B,Skv,KVH,D), v (B,Skv,KVH,Dv) -> out (B,Sq,H,Dv),
    lse (B,Sq,H) fp32

``flash_attention`` takes CUDA tensors only and launches the kernel or
raises. ``flash_attention_plain`` materializes the scores in fp32; the CPU
tests and the on-card comparison use it, and ``kernels.ops`` takes it for
CPU tensors. The causal mask is top-left aligned (key index <= query index),
as on the model path. Dv differs from D in MLA attention (q/k at 192, v at
128); the CUDA source instantiates the pairs in ``HEAD_DIMS``.

``attn_fwd_plan`` is the host-side plan the kernel is launched with: its
tiles, grid, threads and dynamic shared memory. The wrapper passes the grid
to the C entry point, which refuses one it was not built for. ``fwd_walk``
restates in Python the key tiles each block visits and which of them it
masks; ``check.facts`` reads both.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# (D, Dv) pairs the CUDA source instantiates
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """Plain version, fp32 inside. Returns ``(out, lse)``."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                        # (B,KVH,G,Sq)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


MMA_BM = 64         # bf16: query rows of a block, 16 a warp
MMA_THREADS = 128   # bf16: 4 warps
FMA_BM = 64         # fp32: query rows of a block
FMA_THREADS = 256   # fp32: a 16 x 16 grid of threads
KV_TILE = 64        # keys of a KV tile, both dtypes


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_stages(d: int) -> int:
    """Stages of the bf16 kernel's K/V ring (``fwd_stages<D>``)."""
    return 3 if d <= 64 else 2


def fwd_smem(d: int, dv: int, fma: bool) -> int:
    """Dynamic shared memory of a block, in bytes: bf16, Q's rows and each
    stage's K rows at D + 8 and V rows at Dv + 8 (``fwd_smem<D, DV>``);
    fp32, Q, K (rows of D + 1), V, the scores (rows of BN + 1) and three
    per-row vectors."""
    if fma:
        return (FMA_BM * d + KV_TILE * (d + 1) + KV_TILE * dv + FMA_BM * (KV_TILE + 1)
                + 3 * FMA_BM) * 4
    st = fwd_stages(d)
    return ((MMA_BM + st * KV_TILE) * (d + 8) + st * KV_TILE * (dv + 8)) * 2


@dataclass(frozen=True)
class FwdPlan:
    """How K1 is launched for one shape and dtype: ``tiles`` (query rows of
    a block, keys of a tile), ``grid`` (bf16: (B*H, q-tiles), the last
    q-tile first under ``causal``; fp32: (q-tiles, H, B)), ``threads``
    and ``smem`` (dynamic shared memory, bytes)."""
    sq: int
    skv: int
    causal: bool
    fma: bool
    tiles: tuple[int, int]
    grid: tuple[int, int, int]
    threads: int
    smem: int

    @property
    def descending(self) -> bool:
        """bf16 under ``causal``: grid row 0 is the last q-tile, which walks
        the most key tiles, so the longest blocks start first."""
        return self.causal and not self.fma

    def summary(self) -> dict:
        return {"tiles": list(self.tiles), "grid": list(self.grid), "threads": self.threads,
                "smem": self.smem}


def attn_fwd_plan(b: int, sq: int, skv: int, h: int, kvh: int, d: int, dv: int, dtype,
                  causal: bool) -> FwdPlan:
    """The plan for q (b, sq, h, d), k (b, skv, kvh, d), v (b, skv, kvh, dv)
    of ``dtype``; (d, dv) one of ``HEAD_DIMS``."""
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not supported: (D, Dv) one of {HEAD_DIMS}")
    if dtype == torch.float32:
        return FwdPlan(sq, skv, causal, True, (FMA_BM, KV_TILE), (cdiv(sq, FMA_BM), h, b),
                       FMA_THREADS, fwd_smem(d, dv, True))
    return FwdPlan(sq, skv, causal, False, (MMA_BM, KV_TILE), (b * h, cdiv(sq, MMA_BM), 1),
                   MMA_THREADS, fwd_smem(d, dv, False))


def fwd_walk(plan: FwdPlan, i: int) -> tuple[int, list[tuple[int, bool]]]:
    """The block at position ``i`` of its q-tile axis (grid y in bf16, x in
    fp32): its q-tile's first row, and the key tiles it walks, in order,
    each as (first key, masked). Under ``causal`` no tile above the
    diagonal is visited. bf16 masks the tile that crosses the diagonal and
    the ragged last one; fp32 masks every tile. Query rows at or beyond Sq
    are computed on zeros and never written."""
    bm, bn = plan.tiles
    nq = cdiv(plan.sq, bm)
    m0 = (nq - 1 - i if plan.descending else i) * bm
    n_end = min(plan.skv, m0 + bm) if plan.causal else plan.skv
    return m0, [(n0, plan.fma or (plan.causal and n0 + bn - 1 > m0) or n0 + bn > plan.skv)
                for n0 in range(0, n_end, bn)]


def check_inputs(q, k, v, causal: bool) -> None:
    """What both versions require of their arguments."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B,S,H,D) tensors")
    b, sq, h, d = q.shape
    if k.shape[:3] != v.shape[:3]:
        # v's head dim may differ from k's (MLA); nothing else may
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} disagree in batch, "
                         "length or heads")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in batch or head dim")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are no multiple of {k.shape[2]} KV heads")
    if causal and sq != k.shape[1]:
        # top-left and bottom-right masks differ when Sq != Skv; the path only
        # uses Sq == Skv, so the other case is refused until a caller needs it
        raise ValueError(f"causal attention needs Sq == Skv, got {sq} and {k.shape[1]}")


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Launches the CUDA kernel on the current stream, with
    ``attn_fwd_plan``'s grid. CUDA tensors, bf16 or fp32, contiguous, (q/k
    head dim, v head dim) one of ``HEAD_DIMS``. Returns ``(out, lse)``."""
    check_inputs(q, k, v, causal)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    plan = attn_fwd_plan(b, sq, skv, h, kvh, d, dv, q.dtype, causal)
    build.refuse_grad("flash_attention", q, k, v)
    build.check_cuda_tensors(q=q, k=k, v=v)
    scale = scale if scale is not None else d ** -0.5
    out = q.new_empty((b, sq, h, dv))
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, sq, skv, h, kvh, d, dv, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), *plan.grid, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0    # kernel launches made by this wrapper
