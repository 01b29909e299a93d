"""fused_ffn: the wrapper of the fused SwiGLU CUDA kernel in
``csrc/fused_ffn.cu``, and the plain PyTorch version beside it.

    x (T,D), w_gate/w_up (D,F), w_down (F,D) -> y (T,D) = (silu(x W_g) * x W_u) W_d

The (T x F) hidden state never reaches device memory: each block keeps a
16-row tile of it on chip. ``split_plan`` cuts F into splits on the host so
that T-tiles x splits fill the card; with more than one split the blocks
write fp32 partial sums (splits, T, D) that a second kernel adds in a fixed
order. ``fused_ffn`` takes CUDA tensors only and launches the kernels or
raises; ``fused_ffn_plain`` is the reference's ``fused_ffn_ref``: fp32
throughout, cast to x's dtype at the end.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

TILE_T = 16             # rows of x per block in the CUDA source
TILE_F = 64             # hidden columns per step; a split is a whole number of them
TARGET_BLOCKS = 128     # about one block per SM: a block takes ~200 KB of shared memory
MAX_D = 2048            # the 16 x D fp32 accumulator of a block must fit its registers


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


def check_inputs(x, w_gate, w_up, w_down) -> None:
    """What both versions require of their arguments."""
    if x.dim() != 2 or w_gate.dim() != 2 or w_up.dim() != 2 or w_down.dim() != 2:
        raise ValueError("x must be (T,D), w_gate and w_up (D,F), w_down (F,D)")
    d, f = w_gate.shape
    if x.shape[1] != d or w_up.shape != w_gate.shape or tuple(w_down.shape) != (f, d):
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)} disagree")


def fused_ffn(x, w_gate, w_up, w_down):
    """Launches the CUDA kernels on the current stream. CUDA tensors, bf16 or
    fp32, contiguous; D at most 2048 (bf16: a multiple of 128), F a multiple
    of 8."""
    check_inputs(x, w_gate, w_up, w_down)
    build.refuse_grad("fused_ffn", x, w_gate, w_up, w_down)
    build.check_cuda_tensors(x=x, w_gate=w_gate, w_up=w_up, w_down=w_down)
    t, d = x.shape
    f = w_gate.shape[1]
    if d > MAX_D or f % 8 or (x.dtype == torch.bfloat16 and d % 128):
        raise ValueError(f"D={d}, F={f} not supported: D <= {MAX_D} (bf16: a multiple of "
                         "128) and F a multiple of 8")
    y = torch.empty_like(x)
    n_splits, per = split_plan(t, f)
    part = (torch.empty((n_splits, t, d), dtype=torch.float32, device=x.device)
            if n_splits > 1 else None)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.fused_ffn_fwd(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), t, d, f, n_splits, per,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "fused_ffn")
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0          # calls that launched the kernels
