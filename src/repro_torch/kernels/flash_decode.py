"""flash_decode: the wrappers of the one-launch CUDA kernel in
``csrc/flash_decode.cu``, and the plain PyTorch versions beside them.

    q (B,H,D), k/v (B,S,KVH,D), kv_len -> out (B,H,D)
    flash_decode_partial: ... -> (out (B,H,D) fp32, lse (B,H) fp32)

One query token per sequence against a cache whose first ``kv_len``
positions are valid. ``kv_len`` is a host int, or a one-element integer
tensor, as the reference's ``flash_decode_pallas`` takes a scalar int32
array. ``flash_decode`` takes CUDA tensors only and launches the kernel, one
launch a call, or raises; there its ``kv_len`` tensor is int32 on q's device
and is read by the kernel, never by the host (a read would wait for the
device), so one captured CUDA graph serves every position. The kernel rounds
the softmax weights to bf16 for the product with V when the cache is bf16;
the plain version keeps them fp32, so the two agree to bf16 rounding.

``flash_decode_partial`` is the kernel's second entry, for one rank's shard
of a cache whose sequence is sharded: the output normalised over this
shard's first ``kv_len`` rows, in fp32, and the natural-log log-sum-exp of
those rows' scaled scores. ``kv_len`` may be 0 there (a shard that holds no
valid key: out 0, lse NEG_INF). ``kernels.ops.combine_partials`` merges the
shards' results by their lse, and ``shard_kv_len`` gives each shard its
length.

``decode_plan`` is the host-side plan the kernel is launched with: the grid
(one thread-block cluster per (b, KV head, 16-row fragment of the group's
query heads)), the cluster size and the key tile, sized over the cache length
S and never over ``kv_len``. ``decode_walk`` restates in Python the tiles
each (rank, warp) of a cluster visits and which of them it masks; the CPU
tests hold that statement, and only ``chip_smoke.py`` holds the kernel
itself, against the plain version on the card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the kernel's instances
WARPS = 4                   # warps a block, each walking its own tiles
ROWS = 16                   # query heads a fragment (the mma's 16 rows)
TILE_KEYS = 32              # keys a tile, both dtypes (fp32: one a lane)
MAX_CLUSTER = 16            # 8 is portable; the card's occupancy query has the last word
TARGET_BLOCKS = 264         # two blocks on each of an H100's 132 SMs


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shard_kv_len(kv_len, first: int, rows: int):
    """The valid rows of a shard that holds rows [first, first + rows) of a
    cache whose first ``kv_len`` rows are valid: ``min(max(kv_len - first,
    0), rows)``, a host int, or a tensor where ``kv_len`` is one."""
    if isinstance(kv_len, torch.Tensor):
        return (kv_len - first).clamp(0, rows).to(kv_len.dtype)
    return min(max(kv_len - first, 0), rows)


def _scores(q, k, scale):
    """The scaled scores (B,KVH,G,S) fp32 of q (B,H,D) against k
    (B,S,KVH,D). An int8 cache is read as the reference's
    ``decode_attention`` reads it: the product in q's dtype (JAX promotes
    int8 against it), then fp32; a float cache's product is fp32."""
    b, h, d = q.shape
    kvh = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, h // kvh, d)
    if k.dtype == torch.int8:
        return torch.einsum("bhgd,bkhd->bhgk", qg, k.to(q.dtype)).float() * scale
    return torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) * scale


def _weighted_sum(p, v):
    """Σ_k p v_k (B,KVH,G,Dv) of fp32 weights p (B,KVH,G,S): fp32 against a
    float cache; against an int8 cache in bf16, weights and values, as the
    reference's ``decode_attention`` sums them."""
    if v.dtype == torch.int8:
        return torch.einsum("bhgk,bkhd->bhgd", p.to(torch.bfloat16), v.to(torch.bfloat16))
    return torch.einsum("bhgk,bkhd->bhgd", p, v.float())


def flash_decode_partial_plain(q, k, v, kv_len, scale: float | None = None):
    """Plain version of the partial entry, fp32 inside: (out (B,H,Dv) fp32,
    normalised over the first ``kv_len`` rows, lse (B,H) fp32, the
    natural-log log-sum-exp of their scaled scores). ``kv_len`` 0 gives
    out 0 and lse NEG_INF. An int8 cache as in ``flash_decode_plain``."""
    b, h = q.shape[:2]
    s = k.shape[1]
    sc = _scores(q, k, scale)
    valid = torch.arange(s, device=q.device) < kv_len
    sc = sc.masked_fill(~valid, NEG_INF)
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None]) * valid          # masked rows weigh exactly 0
    out = _weighted_sum(p, v).float()
    lse = torch.where(valid.any(), lse, torch.full_like(lse, NEG_INF))
    return out.reshape(b, h, v.shape[-1]), lse.reshape(b, h)


def flash_decode_plain(q, k, v, kv_len, scale: float | None = None):
    """Plain version, fp32 inside, masks the whole cache beyond ``kv_len``
    (a host int or a one-element tensor on q's device). An int8 cache takes
    the reference's arithmetic (``_scores``, ``_weighted_sum``)."""
    b, h = q.shape[:2]
    s = k.shape[1]
    sc = _scores(q, k, scale)
    mask = torch.arange(s, device=q.device) < kv_len
    sc = sc.masked_fill(~mask, NEG_INF)
    out = _weighted_sum(torch.softmax(sc, dim=-1), v)
    return out.reshape(b, h, v.shape[-1]).to(q.dtype)


@dataclass(frozen=True)
class DecodePlan:
    """How K3 is launched for one shape and dtype.

    ``tile``: keys a tile; ``cluster``: blocks that share one (b, KV head,
    fragment), each with ``warps`` warps; ``frags``: 16-row fragments of the
    G query heads; ``tiles``: tiles in the cache of ``s`` positions;
    ``grid``: the CUDA grid, one cluster per (b, KV head, fragment). Tile t
    belongs to rank t mod c and, within it, to warp (t // c) mod warps
    (``decode_walk``)."""
    s: int
    tile: int
    warps: int
    cluster: int
    frags: int
    grid: tuple[int, int, int]

    @property
    def tiles(self) -> int:
        return cdiv(self.s, self.tile)

    def summary(self) -> dict:
        return {"tile": self.tile, "warps": self.warps, "cluster": self.cluster,
                "frags": self.frags, "grid": list(self.grid)}


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, kvh: int, g: int, s: int, d: int, dtype,
                max_cluster: int = MAX_CLUSTER) -> DecodePlan:
    """The plan for q (b, kvh * g, d), k/v (b, s, kvh, d) of ``dtype``:
    clusters of c blocks with c as large as fills about TARGET_BLOCKS blocks,
    at most ``max_cluster`` and at most one block for every WARPS tiles of the
    cache. It depends on s, never on kv_len; d and dtype pick the kernel
    instance, not the plan."""
    tile = TILE_KEYS
    frags = cdiv(g, ROWS)
    clusters = b * kvh * frags
    tiles = cdiv(s, tile)
    c = max(1, min(TARGET_BLOCKS // clusters, max_cluster, cdiv(tiles, WARPS)))
    return DecodePlan(s, tile, WARPS, c, frags, (clusters * c, 1, 1))


def decode_walk(plan: DecodePlan, rank: int, warp: int, kv_len: int) -> list[tuple[int, bool]]:
    """The tiles warp ``warp`` of cluster rank ``rank`` visits, in order, each
    as (first key, masked): tiles rank + c (warp + WARPS j) that hold a key
    below ``kv_len``. Only the tile that holds kv_len (when kv_len is not a
    multiple of the tile) is masked; keys at or beyond kv_len load as zeros.
    At kv_len 0 (the partial entry's empty shard) no warp visits a tile."""
    t = plan.tile
    return [(n0, n0 + t > kv_len) for n0 in range((rank + plan.cluster * warp) * t, kv_len,
                                                  plan.cluster * plan.warps * t)]


def check_inputs(q, k, v, kv_len, min_len: int = 1) -> None:
    """What both versions require of their arguments. A tensor ``kv_len`` is
    one integer; on the CPU its value is checked too (reading it costs no
    wait), on the card it is the caller's contract (min_len <= kv_len <= S;
    ``min_len`` is 1, or 0 for the partial entry)."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B,H,D) and k, v (B,S,KVH,D)")
    b, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must have the same shape")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in batch or head dim")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are no multiple of {k.shape[2]} KV heads")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype.is_floating_point or kv_len.dtype.is_complex or kv_len.dtype == torch.bool:
            raise TypeError(f"kv_len is an integer tensor, not {kv_len.dtype}")
        if kv_len.numel() != 1 or kv_len.dim() > 1:
            raise ValueError(f"kv_len is one integer, not a tensor of shape {tuple(kv_len.shape)}")
        if kv_len.device != q.device:
            raise ValueError(f"kv_len is on {kv_len.device}, q on {q.device}")
        if kv_len.is_cuda:
            return
        kv_len = int(kv_len)
    elif not isinstance(kv_len, int):
        raise TypeError("kv_len is a host integer or a one-element integer tensor")
    if not min_len <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [{min_len}, {k.shape[1]}]")


def max_active_clusters(plan: DecodePlan, b: int, h: int, kvh: int, d: int, dtype,
                        device: int, partial: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the launch of ``plan`` (of the
    partial entry's instance where ``partial``): how many of its clusters
    the card holds at once."""
    out = ctypes.c_int(0)
    lib = build.load_library()
    code = lib.flash_decode_max_clusters(b, plan.s, h, kvh, d, int(dtype == torch.bfloat16),
                                         plan.tile, plan.cluster, plan.grid[0], int(partial),
                                         device, ctypes.byref(out))
    build.check(lib, code, "flash_decode_max_clusters")
    return out.value


@functools.lru_cache(maxsize=None)
def launch_plan(device: int, b: int, h: int, kvh: int, s: int, d: int, dtype,
                partial: bool = False) -> DecodePlan:
    """``decode_plan`` with its cluster shrunk, a block at a time, until the
    card holds all of the launch's clusters at once (one wave): a launch of
    32 clusters of 8 where 30 fit would take two. Queried once a shape and
    entry."""
    plan = decode_plan(b, kvh, h // kvh, s, d, dtype)
    while plan.cluster > 1 and (max_active_clusters(plan, b, h, kvh, d, dtype, device, partial)
                                < plan.grid[0] // plan.cluster):
        plan = decode_plan(b, kvh, h // kvh, s, d, dtype, plan.cluster - 1)
    return plan


def _launch_args(what: str, q, k, v, kv_len, scale, min_len: int):
    """What both entries check and pass: (kv_len's pointer or None, the host
    kv_len, the scale, the device, the plan)."""
    check_inputs(q, k, v, kv_len, min_len)
    if k.dtype not in (torch.bfloat16, torch.float32) or v.dtype != k.dtype:
        raise TypeError(f"{what}: K3 reads a bf16 or fp32 cache, not {k.dtype}/{v.dtype} "
                        "(an int8 cache is read by the plain decode only, impl='naive')")
    build.refuse_grad(what, q, k, v)
    build.check_cuda_tensors(q=q, k=k, v=v)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported {HEAD_DIMS}")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dtype != torch.int32:
            raise TypeError(f"the kernel reads kv_len as int32, not {kv_len.dtype}")
        len_ptr, len_host = kv_len.data_ptr(), 0
    else:
        len_ptr, len_host = None, kv_len
    scale = scale if scale is not None else d ** -0.5
    device = q.device.index
    plan = launch_plan(device, b, h, kvh, s, d, q.dtype, min_len == 0)
    return len_ptr, len_host, float(scale), device, plan


def flash_decode(q, k, v, kv_len, scale: float | None = None):
    """Launches the CUDA kernel on the current stream. CUDA tensors, bf16 or
    fp32, contiguous, head dim 32, 64 or 128. ``kv_len``: a host int in
    [1, S], or a one-element int32 tensor on q's device holding a value in
    [1, S] (the kernel reads it; a value outside is clamped into [1, S])."""
    len_ptr, len_host, scale, device, plan = _launch_args("flash_decode", q, k, v, kv_len,
                                                          scale, 1)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.load_library()
    code = lib.flash_decode_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), len_ptr, len_host,
        b, s, h, kvh, d, scale, int(q.dtype == torch.bfloat16), plan.tile,
        plan.cluster, plan.grid[0], device, torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0       # calls that launched the kernel


def flash_decode_partial(q, k, v, kv_len, scale: float | None = None):
    """Launches the kernel's partial entry on the current stream: (out
    (B,H,D) fp32, lse (B,H) fp32) over this cache's first ``kv_len`` rows,
    as ``flash_decode_partial_plain``. Tensors as ``flash_decode``'s;
    ``kv_len`` a host int in [0, S] or a one-element int32 tensor on q's
    device (clamped into [0, S]), one launch a call."""
    len_ptr, len_host, scale, device, plan = _launch_args("flash_decode_partial", q, k, v,
                                                          kv_len, scale, 0)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    lib = build.load_library()
    code = lib.flash_decode_partial_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), len_ptr,
        len_host, b, s, h, kvh, d, scale, int(q.dtype == torch.bfloat16), plan.tile,
        plan.cluster, plan.grid[0], device, torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, code, "flash_decode_partial")
    flash_decode_partial.launches += 1
    return out, lse


flash_decode_partial.launches = 0   # calls that launched the partial entry
