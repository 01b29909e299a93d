"""KernelFacts: what the port's Hopper kernels do at one shape, read from the
host-side plans their wrappers launch.

The reference's analyser traced each Pallas kernel to a jaxpr and evaluated
its BlockSpecs' index maps over the grid. A CUDA kernel has no such IR: its
grid, tiles and walk are set by the host's plan (``kernels/*``:
``attn_fwd_plan``/``fwd_walk``, ``bwd_plan``/``dq_walk``/``dkv_walk``/
``dkv_heads``/``cluster_rows``, ``decode_plan``/``decode_walk``,
``ffn_plan``/``split_plan``/``tiled_chunk_rows``/``chunk_spans``,
``ssd_plan``/``mma_smem_bytes``) and by a few constants that live only in
the CUDA source, which this module states (``K4_TILED``, ``K4_ROWTILE``,
``K5_CHUNK``, K3's shared memory) and ``tests/test_torch_check.py`` ties to
the ``.cu`` text. One ``KernelFacts`` per (kernel instance, case) records:

- the C entry, the instance as ``ptxas`` names it, its route and dtypes;
- grid, cluster size, threads and dynamic shared memory;
- the ``.cu`` file and line of the kernel;
- one ``Walk`` per tensor: every tile a block reads or writes, in each
  block's order, as NumPy arrays (the visiting block, the tile's box, and
  whether the kernel masks that visit);
- the block's products (tile extents against the tensors' dims), the MMA
  instruction (parsed from the source) and the accumulator dtype.

Everything is built with NumPy over the blocks, no Python loop over them.
``check.rules`` lints the facts and ``check.streams`` compiles them to
``core.trace.Trace``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import flash_attention_bwd as k2
from repro_torch.kernels import flash_decode as k3
from repro_torch.kernels import fused_ffn as k4
from repro_torch.kernels import ssd_scan as k5

CSRC = Path(k1.__file__).resolve().parent.parent / "csrc"
ROOT = CSRC.parents[2]

# Tiles that live only in the CUDA source (tied to it by the tests).
# fused_ffn.cu, the tiled route: TM rows of a block tile, TK the depth of a
# ring stage, STAGES the ring, GU_N columns of g and u a block (pass A),
# DN_N columns of y a block (pass B).
K4_TILED = {"TM": 128, "TK": 32, "STAGES": 3, "GU_N": 64, "DN_N": 128, "THREADS": 256}
# fused_ffn.cu, the row-tile route: BM rows of x a block, BF hidden columns
# a step, BK rows of W_g/W_u a shared-memory step, WD_ROWS rows of W_d.
K4_ROWTILE = {"BM": 16, "BF": 64, "BK": 128, "WD_ROWS": 32, "THREADS": 256}
# ssd_scan.cu: L tokens a chunk; the fma route's 256 threads; grid B*H.
K5_CHUNK = 64
K5_FMA_THREADS = 256
# flash_decode.cu: each warp's cp.async ring (bf16), its merge state.
K3_STAGES = 3


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


_ITEMSIZE = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True, eq=False)
class Walk:
    """One tensor's visits: row i is one tile that block ``block[i]`` reads
    (``role`` "in") or writes ("out"), the box [start, stop) in the tensor's
    index space ``shape`` (a box may pass the tensor's end: a ragged tile),
    ``masked[i]`` where the kernel masks that visit. ``needed``: where the
    geometry asks for a mask besides raggedness (the causal diagonal, a
    fragment past its KV head's query heads, keys past kv_len). ``exact``:
    the kernel masks a tile only where needed (the bf16 kernels' per-tile
    masks); otherwise it guards every element and only a missing mask is a
    fault. ``group`` and ``region``: a split walk (K2b's cluster over its
    heads, K3's ranks and warps over the live tiles) whose groups' visits
    cover their regions exactly once, region g's box [region[0][g],
    region[1][g])."""
    tensor: str
    role: str
    shape: tuple[int, ...]
    dtype: str
    block: np.ndarray
    start: np.ndarray
    stop: np.ndarray
    masked: np.ndarray
    needed: np.ndarray | None = None
    exact: bool = False
    group: np.ndarray | None = None
    region: tuple[np.ndarray, np.ndarray] | None = None

    @property
    def itemsize(self) -> int:
        return _ITEMSIZE[self.dtype]

    def ragged(self) -> np.ndarray:
        return (self.stop > np.asarray(self.shape)).any(axis=1)

    def clipped_bytes(self) -> np.ndarray:
        """Each visit's bytes inside the tensor."""
        ext = np.minimum(self.stop, np.asarray(self.shape)) - self.start
        return np.clip(ext, 0, None).prod(axis=1) * self.itemsize


@dataclass(frozen=True)
class Product:
    """One product of a block's tile: (m, n, k) extents against the
    tensors' (M, N, K)."""
    name: str
    m: int
    n: int
    k: int
    dims: tuple[int, int, int]


@dataclass(frozen=True, eq=False)
class KernelFacts:
    kernel: str             # K1 ... K5
    entry: str              # the C entry point
    instance: str           # the template instance, as ``check.ptxas`` names it
    route: str
    case: str
    src_file: str           # the .cu, relative to the repo's root
    src_line: int           # the kernel's name line
    dtype: str              # the operands'
    acc_dtype: str          # the products' accumulator
    mma: str | None         # the tensor-core instruction's shape; None: IEEE fp32 FMAs
    grid: tuple[int, int, int]
    cluster: int
    threads: int
    smem: int
    walks: tuple[Walk, ...]
    products: tuple[Product, ...]
    flops_walk: str         # the walk each of whose visits does ``flops_per_visit``
    flops_per_visit: float
    launches: int = 1       # launches of one call (K4's tiled route: one a row chunk)

    @property
    def n_blocks(self) -> int:
        """Blocks of one call, over all its launches."""
        return 1 + max(int(w.block.max()) for w in self.walks if len(w.block))

    def walk(self, tensor: str) -> Walk:
        return next(w for w in self.walks if w.tensor == tensor)


# --- the CUDA source -----------------------------------------------------------------

def _source(name: str) -> str:
    return (CSRC / name).read_text()


@lru_cache(maxsize=None)
def kernel_line(cu: str, name: str) -> int:
    """The line of kernel ``name``'s name in its ``__global__`` definition."""
    text = _source(cu)
    m = re.search(rf"__global__[^;{{]*?\b{name}\s*\(", text)
    if m is None:
        raise ValueError(f"no __global__ kernel {name} in {cu}")
    return text.count("\n", 0, m.end()) + 1


_MMA_RE = re.compile(r"mma\.sync\.aligned\.(m\d+n\d+k\d+)\.row\.col\.(\w+)\.(\w+)\.(\w+)\.(\w+)")
_PTX_TYPES = {"f32": "float32", "bf16": "bfloat16", "f16": "float16", "tf32": "tf32"}


@lru_cache(maxsize=None)
def mma_of(cu: str) -> tuple[str, str, str]:
    """(shape, operand dtype, accumulator dtype) of the ``mma.sync`` a
    source issues (itself, or through the headers it includes)."""
    text = _source(cu)
    for inc in re.findall(r'#include "(\w+\.cuh)"', text):
        text += _source(inc)
    found = {(m[0], m[2], m[1]) for m in _MMA_RE.findall(text)}
    if len(found) != 1:
        raise ValueError(f"{cu}: expected one mma.sync form, found {sorted(found)}")
    shape, a, d = found.pop()
    return shape, _PTX_TYPES[a], _PTX_TYPES[d]


def _facts(kernel, entry, instance, route, case, cu, name, dtype, grid, cluster, threads, smem,
           walks, products, flops_walk, flops_per_visit, launches=1) -> KernelFacts:
    """A ``KernelFacts``; bf16 kernels issue the source's ``mma.sync``, fp32
    kernels IEEE FMAs (no instruction, fp32 accumulators)."""
    if dtype == "bfloat16" and route not in ("fma", "combine"):
        mma, _, acc = mma_of(cu)
    else:
        mma, acc = None, "float32"
    return KernelFacts(kernel, entry, instance, route, case, f"src/repro_torch/csrc/{cu}",
                       kernel_line(cu, name), dtype, acc, mma, tuple(grid), cluster, threads,
                       smem, tuple(walks), tuple(products), flops_walk, float(flops_per_visit),
                       launches)


def _walk(tensor, role, shape, dtype, block, start, extent, masked=None, **kw) -> Walk:
    """A ``Walk`` from visit columns: ``start`` and ``extent`` are sequences
    of per-dim arrays (or ints), broadcast to the visits; ``masked`` defaults
    to the ragged visits."""
    block = np.asarray(block, dtype=np.int64)
    n = len(block)
    start = np.stack([np.broadcast_to(np.asarray(c, dtype=np.int64), (n,)) for c in start], 1)
    stop = start + np.stack([np.broadcast_to(np.asarray(c, dtype=np.int64), (n,))
                             for c in extent], 1)
    if masked is None:
        masked = (stop > np.asarray(shape)).any(axis=1)
    return Walk(tensor, role, tuple(shape), dtype, block, start, stop,
                np.broadcast_to(np.asarray(masked, dtype=bool), (n,)).copy(), **kw)


def _per_row(rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row index, first, masked) of a list of per-row tile lists
    ``[(first, masked), ...]``, flattened."""
    counts = [len(r) for r in rows]
    idx = np.repeat(np.arange(len(rows)), counts)
    flat = [t for r in rows for t in r]
    first = np.array([t[0] for t in flat], dtype=np.int64)
    masked = np.array([t[1] for t in flat], dtype=bool)
    return idx, first, masked


# --- K1: flash attention forward -------------------------------------------------

def _q_tile_walks(walks, b, h, g, bn, causal, fma) -> tuple[dict, dict]:
    """The visits of a kernel with one block a (q-tile position i,
    batch-head bh) that walks key tiles (K1, K2a): bf16 grid (B*H, q-tiles),
    fp32 (q-tiles, H, B), ids i and bh in C order either way. ``walks``: the
    plan's walk of each position, [(m0, [(n0, masked), ...]), ...]. Returns
    the once-a-block visits (block, batch, head, m0) and the key-tile visits
    (block, batch, KV head, n0, masked, on the diagonal)."""
    nq = len(walks)
    m0s = np.array([m for m, _ in walks], dtype=np.int64)
    ti, n0, tmask = _per_row([t for _, t in walks])
    bh = np.arange(b * h)
    i_one, bh_one = np.repeat(np.arange(nq), b * h), np.tile(bh, nq)
    blk_one = bh_one + b * h * i_one if not fma else i_one + nq * bh_one
    bh_t, i_t = np.repeat(bh, len(ti)), np.tile(ti, b * h)
    n0_t = np.tile(n0, b * h)
    one = dict(block=blk_one, b=bh_one // h, h=bh_one % h, m0=m0s[i_one])
    keys = dict(block=bh_t + b * h * i_t if not fma else i_t + nq * bh_t, b=bh_t // h,
                kvh=(bh_t % h) // g, n0=n0_t, masked=np.tile(tmask, b * h),
                diag=causal & (n0_t + bn - 1 > m0s[i_t]))
    return one, keys


def k1_facts(case, b, sq, skv, h, kvh, d, dv, dtype, causal) -> list[KernelFacts]:
    plan = k1.attn_fwd_plan(b, sq, skv, h, kvh, d, dv, dtype, causal)
    bm, bn = plan.tiles
    g, nq = h // kvh, cdiv(sq, bm)
    dt = dtype_name(dtype)
    one, kt = _q_tile_walks([k1.fwd_walk(plan, i) for i in range(nq)], b, h, g, bn, causal,
                            plan.fma)
    rows = (one["b"], one["m0"], one["h"])
    keys = dict(needed=kt["diag"], exact=not plan.fma)
    kstart = (kt["b"], kt["n0"], kt["kvh"], 0)
    ws = [_walk("q", "in", (b, sq, h, d), dt, one["block"], rows + (0,), (1, bm, 1, d)),
          _walk("k", "in", (b, skv, kvh, d), dt, kt["block"], kstart, (1, bn, 1, d),
                kt["masked"], **keys),
          _walk("v", "in", (b, skv, kvh, dv), dt, kt["block"], kstart, (1, bn, 1, dv),
                kt["masked"], **keys),
          _walk("out", "out", (b, sq, h, dv), dt, one["block"], rows + (0,), (1, bm, 1, dv)),
          _walk("lse", "out", (b, sq, h), "float32", one["block"], rows, (1, bm, 1))]
    prods = [Product("S = Q K^T", bm, bn, d, (sq, skv, d)),
             Product("O += P V", bm, dv, bn, (sq, dv, skv))]
    name = "attn_fwd_fma" if plan.fma else "attn_fwd_mma"
    return [_facts("K1", "flash_attention_fwd", f"{name}<{d},{dv}>", "fma" if plan.fma else "mma",
                   case, "flash_attention.cu", name, dt, plan.grid, 1, plan.threads, plan.smem, ws,
                   prods, "k", 2 * bm * bn * (d + dv))]


# --- K2: flash attention backward ------------------------------------------------

def _dq_smem(d, dv, bn, fma):
    if fma:
        t = k2.FMA_TILE
        return (2 * t * (d + 1) + 2 * t * (dv + 1) + t * (t + 1) + 2 * t) * 4
    stages = 2 if d == 128 else 3
    return (k2.DQ_ROWS + stages * bn) * (d + 8 + dv + 8) * 2


def _dkv_smem(d, dv, bm, fma):
    if fma:
        t = k2.FMA_TILE
        return (2 * t * (d + 1) + 2 * t * (dv + 1) + 2 * t * (t + 1) + 2 * t) * 4
    stages, bn = 3, k2.DKV_KEYS
    tiles = (bn + stages * bm) * (d + 8 + dv + 8) * 2 + stages * 2 * bm * 4
    return max(tiles, bn * (d + 8 + dv + 8) * 4)


def k2_facts(case, b, sq, skv, h, kvh, d, dv, dtype, causal) -> list[KernelFacts]:
    plan = k2.bwd_plan(b, sq, skv, h, kvh, d, dtype, causal, dv=dv)
    dt, g, fma = dtype_name(dtype), h // kvh, plan.fma
    route = "fma" if fma else "mma"
    threads = 256 if fma else 128
    out = []

    # K2a: one block a (q-tile position i, batch-head bh), as K1's
    bm, bn = plan.dq_tiles
    nq = cdiv(sq, bm)
    one, kt = _q_tile_walks([k2.dq_walk(plan, i) for i in range(nq)], b, h, g, bn, causal, fma)
    rows = (one["b"], one["m0"], one["h"])
    keys = dict(needed=kt["diag"], exact=not fma)
    kstart = (kt["b"], kt["n0"], kt["kvh"], 0)
    ws = [_walk("q", "in", (b, sq, h, d), dt, one["block"], rows + (0,), (1, bm, 1, d)),
          _walk("dout", "in", (b, sq, h, dv), dt, one["block"], rows + (0,), (1, bm, 1, dv)),
          _walk("lse", "in", (b, sq, h), "float32", one["block"], rows, (1, bm, 1)),
          _walk("delta", "in", (b, sq, h), "float32", one["block"], rows, (1, bm, 1)),
          _walk("k", "in", (b, skv, kvh, d), dt, kt["block"], kstart, (1, bn, 1, d),
                kt["masked"], **keys),
          _walk("v", "in", (b, skv, kvh, dv), dt, kt["block"], kstart, (1, bn, 1, dv),
                kt["masked"], **keys),
          _walk("dq", "out", (b, sq, h, d), dt, one["block"], rows + (0,), (1, bm, 1, d))]
    prods = [Product("S = Q K^T", bm, bn, d, (sq, skv, d)),
             Product("dP = dO V^T", bm, bn, dv, (sq, skv, dv)),
             Product("dQ += dS K", bm, d, bn, (sq, d, skv))]
    name = "attn_bwd_dq_fma" if fma else "attn_bwd_dq_mma"
    inst = f"{name}<{d},{dv}>" if fma else f"{name}<{d},{dv},{bn}>"
    out.append(_facts("K2a", "flash_attention_bwd_dq", inst, route, case,
                      "flash_attention_bwd.cu", name, dt, plan.dq_grid, 1, threads,
                      _dq_smem(d, dv, bn, fma), ws, prods, "k", 2 * bm * bn * (2 * d + dv)))

    # K2b: one block a (batch, KV head, cluster rank, key tile j); each walks
    # its heads' q-tiles; the cluster sums each key tile's dk/dv over its
    # ranks and rank r writes rows cluster_rows(c)[r] of it
    bm, bn = plan.dkv_tiles
    c, hpb, nk, nq = plan.cluster, plan.heads_per_block, cdiv(skv, bn), cdiv(sq, bm)
    walks = [k2.dkv_walk(plan, j) for j in range(nk)]
    n0s = np.array([n for n, _ in walks], dtype=np.int64)
    tj, m0, tmask = _per_row([t for _, t in walks])
    grp = np.arange(b * kvh * c)                       # (b, kvh, rank) in C order
    # block ids: bf16 grid (B*KVH*c, nk): x + B*KVH*c*j; fp32 (nk, KVH, B): j + nk*(b*KVH + kvh)
    def blk_of(x, j):
        return x + b * kvh * c * j if not fma else j + nk * x
    bx, bj = np.repeat(grp, nk), np.tile(np.arange(nk), len(grp))
    blk_one = blk_of(bx, bj)
    b_one, kv_one, r_one = bx // (kvh * c), (bx // c) % kvh, bx % c
    n0_one = n0s[bj]
    # q-tile visits: (block, head j of hpb, tile)
    per_block = len(tj)        # tiles a head, summed over j: expand by blocks and heads
    vx = np.repeat(grp, per_block * hpb)
    vhead = np.tile(np.repeat(np.arange(hpb), per_block), len(grp))
    vt = np.tile(np.arange(per_block), len(grp) * hpb)
    vj, vm0, vmask = tj[vt], m0[vt], tmask[vt]
    vb, vkv, vr = vx // (kvh * c), (vx // c) % kvh, vx % c
    heads = np.array([[k2.dkv_heads(plan, kv_, g, r) for r in range(c)] for kv_ in range(kvh)],
                     dtype=np.int64).reshape(kvh, c, hpb)
    vh = heads[vkv, vr, vhead]
    vblk = blk_of(vx, vj)
    diag = causal & (n0s[vj] + bn - 1 > vm0)
    group = (vb * kvh + vkv) * nk + vj                 # the cluster of (b, kvh, key tile)
    gb, gkv, gj = (np.arange(b * kvh * nk) // nk) // kvh, (np.arange(b * kvh * nk) // nk) % kvh, \
        np.arange(b * kvh * nk) % nk
    first = (n0s[gj] // bm if causal else 0) * bm
    region = (np.stack([gb, first, gkv * g, np.zeros_like(gb)], 1),
              np.stack([gb + 1, np.full_like(gb, nq * bm), (gkv + 1) * g, np.full_like(gb, d)], 1))
    qkw = dict(needed=diag, exact=not fma)
    if fma:
        share = np.zeros((len(blk_one), 2), dtype=np.int64)
        share[:, 1] = bn
    else:
        share = np.array(k2.cluster_rows(c, bn), dtype=np.int64)[r_one]
    ws = [_walk("q", "in", (b, sq, h, d), dt, vblk, (vb, vm0, vh, 0), (1, bm, 1, d), vmask,
                group=group, region=region, **qkw),
          _walk("dout", "in", (b, sq, h, dv), dt, vblk, (vb, vm0, vh, 0), (1, bm, 1, dv), vmask,
                **qkw),
          _walk("lse", "in", (b, sq, h), "float32", vblk, (vb, vm0, vh), (1, bm, 1), vmask, **qkw),
          _walk("delta", "in", (b, sq, h), "float32", vblk, (vb, vm0, vh), (1, bm, 1), vmask,
                **qkw),
          _walk("k", "in", (b, skv, kvh, d), dt, blk_one, (b_one, n0_one, kv_one, 0),
                (1, bn, 1, d)),
          _walk("v", "in", (b, skv, kvh, dv), dt, blk_one, (b_one, n0_one, kv_one, 0),
                (1, bn, 1, dv)),
          _walk("dk", "out", (b, skv, kvh, d), dt, blk_one, (b_one, n0_one + share[:, 0], kv_one, 0),
                (1, share[:, 1] - share[:, 0], 1, d)),
          _walk("dv", "out", (b, skv, kvh, dv), dt, blk_one,
                (b_one, n0_one + share[:, 0], kv_one, 0), (1, share[:, 1] - share[:, 0], 1, dv))]
    prods = [Product("S^T = K Q^T", bn, bm, d, (skv, sq, d)),
             Product("dP^T = V dO^T", bn, bm, dv, (skv, sq, dv)),
             Product("dV += P^T dO", bn, dv, bm, (skv, dv, sq)),
             Product("dK += dS^T Q", bn, d, bm, (skv, d, sq))]
    name = "attn_bwd_dkv_fma" if fma else "attn_bwd_dkv_mma"
    inst = f"{name}<{d},{dv}>" if fma else f"{name}<{d},{dv},{bm}>"
    out.append(_facts("K2b", "flash_attention_bwd_dkv", inst, route, case,
                      "flash_attention_bwd.cu", name, dt, plan.dkv_grid, c, threads,
                      _dkv_smem(d, dv, bm, fma), ws, prods, "q", 4 * bn * bm * (d + dv)))
    return out


# --- K3: flash decode ------------------------------------------------------------

def k3_smem(d: int, fma: bool) -> int:
    """``mma_smem<D>`` / ``fma_smem<D>`` of flash_decode.cu: each warp's ring
    of K and V tiles (bf16) and the block's merge state, m, l and acc for
    16 rows; fp32, q's 16 rows and a merge state per warp and the block's."""
    part = 2 * k3.ROWS + k3.ROWS * d
    if fma:
        return (k3.ROWS * d + (k3.WARPS + 1) * part) * 4
    return k3.WARPS * K3_STAGES * 2 * k3.TILE_KEYS * (d + 8) * 2 + part * 4


def k3_facts(case, b, h, kvh, d, s, kv_len, dtype, partial=False,
             cluster=None) -> list[KernelFacts]:
    """``cluster``: the cluster size the card's ``launch_plan`` picked (the
    occupancy query shrinks ``decode_plan``'s); None keeps the plan's."""
    g = h // kvh
    plan = k3.decode_plan(b, kvh, g, s, d, dtype, *(() if cluster is None else (cluster,)))
    c, frags, t = plan.cluster, plan.frags, plan.tile
    fma = dtype == torch.float32
    dt = dtype_name(dtype)
    clusters = b * kvh * frags
    cid = np.arange(clusters)
    cf, ckv, cb = cid % frags, (cid // frags) % kvh, cid // (frags * kvh)
    # tiles of each (rank, warp), the same in every cluster
    rw = [(r, w) for r in range(c) for w in range(plan.warps)]
    ti, n0, tmask = _per_row([k3.decode_walk(plan, r, w, kv_len) for r, w in rw])
    rank_t = np.array([r for r, _ in rw], dtype=np.int64)[ti]
    vc = np.repeat(cid, len(ti))
    vblk = vc * c + np.tile(rank_t, clusters)
    vn0, vmask = np.tile(n0, clusters), np.tile(tmask, clusters)
    vb, vkv = cb[vc], ckv[vc]
    live = cdiv(kv_len, t) * t
    region = (np.stack([cb, np.zeros_like(cb), ckv, np.zeros_like(cb)], 1),
              np.stack([cb + 1, np.full_like(cb, live), ckv + 1, np.full_like(cb, d)], 1))
    needed = vn0 + t > kv_len
    kw = dict(needed=needed, exact=not fma)
    # every rank loads the fragment's live query heads (at most 16; the
    # mma's rows past its KV head's G heads are masked, zeros)
    blk = np.arange(clusters * c)
    bc = blk // c
    head0 = ckv[bc] * g + cf[bc] * k3.ROWS
    frag_rows = np.minimum(k3.ROWS, g - cf[bc] * k3.ROWS)
    q_masked = frag_rows < k3.ROWS
    # rank r merges and writes units [r U / c, (r + 1) U / c) of the
    # fragment's rows x D outputs (U = rows D / 4), flat; lse where col 0
    units = frag_rows * d // 4
    rank = blk % c
    lo, hi = rank * units // c, (rank + 1) * units // c
    base = cb[bc] * h + head0
    ws = [_walk("q", "in", (b, h, d), dt, blk, (cb[bc], head0, 0), (1, frag_rows, d), q_masked,
                needed=q_masked),
          _walk("k", "in", (b, s, kvh, d), dt, vblk, (vb, vn0, vkv, 0), (1, t, 1, d), vmask,
                group=vc, region=region, **kw),
          _walk("v", "in", (b, s, kvh, d), dt, vblk, (vb, vn0, vkv, 0), (1, t, 1, d), vmask, **kw),
          _walk("out", "out", (b * h * d,), "float32" if partial else dt, blk,
                (base * d + 4 * lo,), (4 * (hi - lo),))]
    if partial:
        q4 = d // 4
        lse_lo, lse_hi = -(-lo // q4), -(-hi // q4)
        ws.append(_walk("lse", "out", (b * h,), "float32", blk, (base + lse_lo,),
                        (lse_hi - lse_lo,)))
    prods = [Product("S = Q K^T", k3.ROWS, t, d, (g, kv_len, d)),
             Product("O += P V", k3.ROWS, d, t, (g, d, kv_len))]
    name = "flash_decode_fma" if fma else "flash_decode_mma"
    entry = "flash_decode_partial_fwd" if partial else "flash_decode_fwd"
    return [_facts("K3", entry, f"{name}<{d},{int(partial)}>", "fma" if fma else "mma", case,
                   "flash_decode.cu", name, dt, plan.grid, c, k3.WARPS * 32, k3_smem(d, fma), ws,
                   prods, "k", 2 * k3.ROWS * t * 2 * d)]


# --- K4: fused FFN ---------------------------------------------------------------

def k4_tiled_smem() -> tuple[int, int]:
    """(SMEM_GU, SMEM_DN) of fused_ffn.cu: the 3-stage rings of pass A (x,
    W_g, W_u) and pass B (h, W_d), rows padded by 8 bf16."""
    p = K4_TILED
    lda, ldg, ldd = p["TK"] + 8, p["GU_N"] + 8, p["DN_N"] + 8
    return (p["STAGES"] * (p["TM"] * lda + 2 * p["TK"] * ldg) * 2,
            p["STAGES"] * (p["TM"] * lda + p["TK"] * ldd) * 2)


def k4_rowtile_smem(d: int, fma: bool) -> int:
    """``smem_mma(D)`` / ``smem_fma(D)`` of fused_ffn.cu."""
    p = K4_ROWTILE
    if fma:
        return (p["BM"] * d + p["BM"] * p["BF"]) * 4
    xs, hs = p["BM"] * (d + 8), p["BM"] * (p["BF"] + 8)
    return (xs + hs + max(2 * p["BK"] * (p["BF"] + 8), p["WD_ROWS"] * (d + 8))) * 2


def k4_facts(case, t, d, f, dtype, route=None) -> list[KernelFacts]:
    plan_route, chunk_rows = k4.ffn_plan(t, f, dtype)
    route = route or plan_route
    dt = dtype_name(dtype)
    if route == "tiled":
        return _k4_tiled(case, t, d, f, dt, chunk_rows or k4.tiled_chunk_rows(t, f))
    return _k4_rowtile(case, t, d, f, dtype)


def _k4_tiled(case, t, d, f, dt, chunk_rows) -> list[KernelFacts]:
    p = K4_TILED
    tm, gu, dn = p["TM"], p["GU_N"], p["DN_N"]
    ldh = k4.round_up(f, gu)
    spans = k4.chunk_spans(t, chunk_rows)
    hrows = k4.round_up(t, tm)        # h's chunks in launch order, each a whole number of tiles
    tiles = np.array([cdiv(n, tm) for _, n in spans], dtype=np.int64)
    r0s = np.array([r for r, _ in spans], dtype=np.int64)
    smem_gu, smem_dn = k4_tiled_smem()

    def blocks(cols):
        """(block id, first row) of every block of every chunk's launch, a
        launch's ids after the previous launch's (grid (row tiles, cols))."""
        per = tiles * cols
        off = np.concatenate([[0], np.cumsum(per)[:-1]])
        chunk = np.repeat(np.arange(len(spans)), per)
        local = np.arange(per.sum()) - off[chunk]
        rt, ct = local % tiles[chunk], local // tiles[chunk]
        return local + off[chunk], r0s[chunk] + rt * tm, ct

    blk, row, ct = blocks(ldh // gu)
    c0 = ct * gu
    ws = [_walk("x", "in", (t, d), dt, blk, (row, 0), (tm, d)),
          _walk("w_gate", "in", (d, f), dt, blk, (0, c0), (d, gu)),
          _walk("w_up", "in", (d, f), dt, blk, (0, c0), (d, gu)),
          _walk("h", "out", (hrows, ldh), dt, blk, (row, c0), (tm, gu))]
    prods = [Product("g = x W_g", tm, gu, d, (t, f, d)), Product("u = x W_u", tm, gu, d, (t, f, d))]
    gate_up = _facts("K4", "fused_ffn_tiled_fwd", "ffn_gate_up_mma", "tiled", case, "fused_ffn.cu",
                     "ffn_gate_up_mma", dt, (int(tiles[0]), ldh // gu, 1), 1, p["THREADS"],
                     smem_gu, ws, prods, "x", 2 * 2 * tm * gu * d, launches=len(spans))
    blk, row, ct = blocks(d // dn)
    c0 = ct * dn
    ws = [_walk("h", "in", (hrows, ldh), dt, blk, (row, 0), (tm, ldh)),
          _walk("w_down", "in", (f, d), dt, blk, (0, c0), (ldh, dn)),
          _walk("y", "out", (t, d), dt, blk, (row, c0), (tm, dn))]
    prods = [Product("y = h W_d", tm, dn, ldh, (t, d, f))]
    down = _facts("K4", "fused_ffn_tiled_fwd", "ffn_down_mma", "tiled", case, "fused_ffn.cu",
                  "ffn_down_mma", dt, (int(tiles[0]), d // dn, 1), 1, p["THREADS"], smem_dn, ws,
                  prods, "h", 2 * tm * dn * ldh, launches=len(spans))
    return [gate_up, down]


def _k4_rowtile(case, t, d, f, dtype) -> list[KernelFacts]:
    p = K4_ROWTILE
    bm, bf = p["BM"], p["BF"]
    fma = dtype == torch.float32
    dt = dtype_name(dtype)
    n_splits, per = k4.split_plan(t, f)
    nt, nf = cdiv(t, bm), cdiv(f, bf)
    # block (row tile x, split y): id x + nt y; it walks F tiles [y per, (y + 1) per)
    splits = np.arange(n_splits)
    counts = np.minimum(nf, (splits + 1) * per) - splits * per
    sp = np.repeat(splits, counts)
    ft = np.arange(len(sp)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[sp] + sp * per
    vx = np.repeat(np.arange(nt), len(sp))
    vs, vf = np.tile(sp, nt), np.tile(ft, nt) * bf
    vblk = vx + nt * vs
    blk = np.arange(nt * n_splits)
    bx, by = blk % nt, blk // nt
    out = ("part", (n_splits, t, d), "float32") if n_splits > 1 else ("y", (t, d), dt)
    ws = [_walk("x", "in", (t, d), dt, blk, (bx * bm, 0), (bm, d)),
          _walk("w_gate", "in", (d, f), dt, vblk, (0, vf), (d, bf)),
          _walk("w_up", "in", (d, f), dt, vblk, (0, vf), (d, bf)),
          _walk("w_down", "in", (f, d), dt, vblk, (vf, 0), (bf, d)),
          _walk(out[0], "out", out[1], out[2], blk,
                ((by,) if n_splits > 1 else ()) + (bx * bm, 0),
                ((1,) if n_splits > 1 else ()) + (bm, d))]
    prods = [Product("g = x W_g", bm, bf, d, (t, f, d)), Product("u = x W_u", bm, bf, d, (t, f, d)),
             Product("y += h W_d", bm, d, bf, (t, d, f))]
    name = "ffn_fma" if fma else "ffn_mma"
    facts = [_facts("K4", "fused_ffn_fwd", name, "fma" if fma else "rowtile", case, "fused_ffn.cu",
                    name, dt, (nt, n_splits, 1), 1, p["THREADS"], k4_rowtile_smem(d, fma), ws,
                    prods, "w_gate", 3 * 2 * bm * bf * d)]
    if n_splits > 1:
        # ffn_combine: a grid-stride loop of 256 elements a step over the T x D
        # outputs, each the sum of the splits' partials in split order
        n, th = t * d, p["THREADS"]
        grid = min(cdiv(n, th), 1024)
        lo = np.arange(0, n, th)
        cblk = (lo // th) % grid
        ws = [_walk("part", "in", (n_splits, n), "float32", cblk, (0, lo), (n_splits, th)),
              _walk("y", "out", (n,), dt, cblk, (lo,), (th,))]
        facts.append(_facts("K4", "fused_ffn_fwd", f"ffn_combine<{_C_TYPE[dt]}>", "combine",
                            case, "fused_ffn.cu", "ffn_combine", dt, (grid, 1, 1), 1, th, 0, ws,
                            (), "y", 0.0))
    return facts


_C_TYPE = {"bfloat16": "__nv_bfloat16", "float32": "float"}


# --- K5: the SSD chunk scan ------------------------------------------------------

def k5_fma_smem(p: int, n: int) -> int:
    """``smem_floats(P, N)`` of ssd_scan.cu, in bytes."""
    lc = K5_CHUNK
    return (lc * p + 2 * lc * (n + 1) + lc * (lc + 1) + n * p + 3 * lc) * 4


def k5_facts(case, b, s, h, p, n, dtype, route=None) -> list[KernelFacts]:
    route = route or k5.ssd_plan(dtype, p, n)
    dt, lc = dtype_name(dtype), K5_CHUNK
    nch = cdiv(s, lc)
    blk = np.arange(b * h)                      # one block a (b, h), grid B*H
    vblk = np.repeat(blk, nch)
    vb, vh, c0 = vblk // h, vblk % h, np.tile(np.arange(nch), b * h) * lc
    ws = [_walk("x", "in", (b, s, h, p), dt, vblk, (vb, c0, vh, 0), (1, lc, 1, p)),
          _walk("dt", "in", (b, s, h), "float32", vblk, (vb, c0, vh), (1, lc, 1)),
          _walk("A", "in", (h,), "float32", blk, (blk % h,), (1,)),
          _walk("b", "in", (b, s, n), dt, vblk, (vb, c0, 0), (1, lc, n)),
          _walk("c", "in", (b, s, n), dt, vblk, (vb, c0, 0), (1, lc, n)),
          _walk("y", "out", (b, s, h, p), dt, vblk, (vb, c0, vh, 0), (1, lc, 1, p)),
          _walk("state", "out", (b, h, p, n), "float32", blk, (blk // h, blk % h, 0, 0),
                (1, 1, p, n))]
    prods = [Product("C B^T", lc, lc, n, (s, s, n)), Product("y = (C B^T . decay) x", lc, p, lc,
                                                            (s, p, s)),
             Product("y += C state", lc, p, n, (s, p, n)),
             Product("state += W^T x", n, p, lc, (n, p, s))]
    flops = 2 * lc * (lc * n + lc * p + 2 * n * p)
    if route == "mma":
        prods.append(Product("state += W_lo^T x", n, p, lc, (n, p, s)))
        return [_facts("K5", "ssd_scan_fwd", f"ssd_chunk_scan_mma<{p},{n}>", "mma", case,
                       "ssd_scan.cu", "ssd_chunk_scan_mma", dt, (b * h, 1, 1), 1,
                       k5.MMA_WARPS * 32, k5.mma_smem_bytes(p, n), ws, prods, "x",
                       flops + 2 * lc * n * p)]
    return [_facts("K5", "ssd_scan_fwd", f"ssd_chunk_scan<{_C_TYPE[dt]},{p}>", "fma", case,
                   "ssd_scan.cu", "ssd_chunk_scan", dt, (b * h, 1, 1), 1, K5_FMA_THREADS,
                   k5_fma_smem(p, n), ws, prods, "x", flops)]
