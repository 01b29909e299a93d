"""fused_ffn: the wrapper of the fused SwiGLU CUDA kernels in
``csrc/fused_ffn.cu``, and the plain PyTorch version beside it.

    x (T,D), w_gate/w_up (D,F), w_down (F,D) -> y (T,D) = (silu(x W_g) * x W_u) W_d

``ffn_plan`` picks one of two routes on the host. ``"tiled"`` (bf16,
T >= TILED_MIN_T) makes h in row chunks of at most 16 MiB, each through two
tensor-core passes (gate/up, then down): g and u never leave registers and
no (T x F) tensor is allocated once it would exceed 16 MiB. ``"rowtile"``
(fp32, and bf16 below TILED_MIN_T, which serves decode) keeps a 16-row tile
of h on chip in each block; ``split_plan`` cuts F into splits so that
T-tiles x splits fill the card, and with more than one split the blocks
write fp32 partial sums (splits, T, D) that a second kernel adds in a fixed
order. ``fused_ffn`` takes CUDA tensors only and launches the kernels or
raises; ``fused_ffn_plain`` is the reference's ``fused_ffn_ref``: fp32
throughout, cast to x's dtype at the end.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

TILE_T = 16             # rows of x per block of the row-tile route
TILE_F = 64             # hidden columns per step; a split is a whole number of them
TARGET_BLOCKS = 128     # about one block per SM: a block takes ~200 KB of shared memory
MAX_D = 2048            # the 16 x D fp32 accumulator of a block must fit its registers
ROUTES = ("tiled", "rowtile")
TILED_MIN_T = 256       # bf16 rows from which the tiled route runs
TILED_ROWS = 128        # rows of a block tile of the tiled route; chunks are whole tiles
H_CHUNK_BYTES = 16 << 20  # most bytes of one row chunk of h: it stays in the 50 MB L2


def fused_ffn_plain(x, w_gate, w_up, w_down):
    """Plain version, fp32 inside."""
    xf = x.float()
    h = F.silu(xf @ w_gate.float()) * (xf @ w_up.float())
    return (h @ w_down.float()).to(x.dtype)


def split_plan(t: int, f: int) -> tuple[int, int]:
    """``(n_splits, f_tiles_per_split)``: enough F-splits that the
    ``ceil(t / TILE_T)`` row tiles times the splits reach TARGET_BLOCKS, each
    split a whole number of F tiles and none empty."""
    tiles_t = -(-t // TILE_T)
    tiles_f = -(-f // TILE_F)
    want = max(1, min(tiles_f, -(-TARGET_BLOCKS // tiles_t)))
    per = -(-tiles_f // want)
    return -(-tiles_f // per), per


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tiled_chunk_rows(t: int, f: int) -> int:
    """Rows of one chunk of h in the tiled route: the most whole 128-row
    tiles whose (rows, round_up(f, 64)) bf16 chunk fits H_CHUNK_BYTES, and no
    more than ``t`` needs; 0 where not even one tile fits (F > 65536)."""
    rows = H_CHUNK_BYTES // (round_up(f, TILE_F) * 2) // TILED_ROWS * TILED_ROWS
    return min(rows, round_up(t, TILED_ROWS))


def ffn_plan(t: int, f: int, dtype) -> tuple[str, int | None]:
    """``(route, chunk_rows)``: ``("tiled", rows)`` for bf16 with
    ``t >= TILED_MIN_T``, else ``("rowtile", None)`` (the kernels of
    ``split_plan``)."""
    rows = tiled_chunk_rows(t, f)
    if dtype == torch.bfloat16 and t >= TILED_MIN_T and rows:
        return "tiled", rows
    return "rowtile", None


def chunk_spans(t: int, chunk_rows: int) -> list[tuple[int, int]]:
    """``(first row, rows)`` of each chunk, in the order the CUDA entry point
    walks them."""
    return [(r0, min(chunk_rows, t - r0)) for r0 in range(0, t, chunk_rows)]


def check_inputs(x, w_gate, w_up, w_down) -> None:
    """What both versions require of their arguments."""
    if x.dim() != 2 or w_gate.dim() != 2 or w_up.dim() != 2 or w_down.dim() != 2:
        raise ValueError("x must be (T,D), w_gate and w_up (D,F), w_down (F,D)")
    d, f = w_gate.shape
    if x.shape[1] != d or w_up.shape != w_gate.shape or tuple(w_down.shape) != (f, d):
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} disagree")


def fused_ffn(x, w_gate, w_up, w_down, *, route=None):
    """Launches the CUDA kernels of ``ffn_plan``'s route on the current
    stream. CUDA tensors, bf16 or fp32, contiguous; D at most 2048 (bf16: a
    multiple of 128), F a multiple of 8. ``route`` overrides the plan, to time
    both routes at one shape; the model path never passes it."""
    check_inputs(x, w_gate, w_up, w_down)
    build.refuse_grad("fused_ffn", x, w_gate, w_up, w_down)
    t, d = x.shape
    f = w_gate.shape[1]
    route = route or ffn_plan(t, f, x.dtype)[0]
    chunk_rows = tiled_chunk_rows(t, f)
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    if route == "tiled" and (x.dtype != torch.bfloat16 or not chunk_rows):
        raise ValueError("the tiled route takes bf16 with F <= 65536")
    build.check_cuda_tensors(x=x, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if d > MAX_D or f % 8 or (x.dtype == torch.bfloat16 and d % 128):
        raise ValueError(f"D={d}, F={f} not supported: D <= {MAX_D} (bf16: a multiple of "
                         "128) and F a multiple of 8")
    y = torch.empty_like(x)
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "tiled":
        h = torch.empty((chunk_rows, round_up(f, TILE_F)), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            code = lib.fused_ffn_tiled_fwd(
                x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                y.data_ptr(), h.data_ptr(), t, d, f, chunk_rows, stream)
    else:
        n_splits, per = split_plan(t, f)
        part = (torch.empty((n_splits, t, d), dtype=torch.float32, device=x.device)
                if n_splits > 1 else None)
        with torch.cuda.device(x.device):
            code = lib.fused_ffn_fwd(
                x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                y.data_ptr(), None if part is None else part.data_ptr(), t, d, f, n_splits,
                per, int(x.dtype == torch.bfloat16), stream)
    build.check(lib, code, "fused_ffn")
    fused_ffn.launches += 1
    fused_ffn.launches_by_route[route] += 1
    return y


fused_ffn.launches = 0          # calls that launched the kernels
fused_ffn.launches_by_route = dict.fromkeys(ROUTES, 0)
