"""flash_decode: the wrapper of the split-KV CUDA kernels in
``csrc/flash_decode.cu``, and the plain PyTorch version beside it.

    q (B,H,D), k/v (B,S,KVH,D), kv_len (host int) -> out (B,H,D)

One query token per sequence against a cache whose first ``kv_len``
positions are valid. ``flash_decode`` takes CUDA tensors only and launches
the kernels (partial, then combine) or raises. The kernel keeps the softmax
weights in fp32 for the product with V; the model path's
``decode_attention`` rounds them to the cache dtype first, so the two agree
to bf16 rounding with a bf16 cache, not exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
TILE_KV = 64            # keys per tile in the CUDA source; a split is a whole number of tiles
TARGET_BLOCKS = 264     # two blocks for each of an H100's 132 SMs
MAX_SPLITS = 64


def flash_decode_plain(q, k, v, kv_len: int, scale: float | None = None):
    """Plain version, fp32 inside, masks the whole cache beyond ``kv_len``."""
    b, h, d = q.shape
    _, s, kvh, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    mask = torch.arange(s, device=q.device) < kv_len
    sc = sc.masked_fill(~mask, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(b, h, v.shape[-1]).to(q.dtype)


def split_plan(kv_len: int, n_groups: int) -> tuple[int, int]:
    """``(n_splits, split_len)`` for ``n_groups = B*KVH`` independent
    (sequence, KV head) pairs: enough splits to fill the card, each a whole
    number of tiles and none empty."""
    tiles = -(-kv_len // TILE_KV)
    want = max(1, min(MAX_SPLITS, tiles, -(-TARGET_BLOCKS // n_groups)))
    tiles_per_split = -(-tiles // want)
    n_splits = -(-tiles // tiles_per_split)
    return n_splits, tiles_per_split * TILE_KV


def check_inputs(q, k, v, kv_len: int) -> None:
    """What both versions require of their arguments."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B,H,D) and k, v (B,S,KVH,D)")
    b, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must have the same shape")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in batch or head dim")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads are no multiple of {k.shape[2]} KV heads")
    if not isinstance(kv_len, int):
        raise TypeError("kv_len is a host integer (the caller knows the position; "
                        "reading it from a tensor would wait for the device)")
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")


def flash_decode(q, k, v, kv_len: int, scale: float | None = None):
    """Launches the CUDA kernels on the current stream. CUDA tensors, bf16 or
    fp32, contiguous, head dim a multiple of 8."""
    check_inputs(q, k, v, kv_len)
    build.refuse_grad("flash_decode", q, k, v)
    build.check_cuda_tensors(q=q, k=k, v=v)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if d % 8:
        raise ValueError(f"head dim {d} must be a multiple of 8")
    scale = scale if scale is not None else d ** -0.5
    n_splits, split_len = split_plan(kv_len, b * kvh)
    out = torch.empty_like(q)
    partial = torch.empty((b * kvh, n_splits, h // kvh, d + 2),
                          dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), partial.data_ptr(),
            b, s, h, kvh, d, kv_len, n_splits, split_len, float(scale),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0       # calls that launched the kernels
