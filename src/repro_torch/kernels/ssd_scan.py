"""ssd_scan: the wrapper of the Mamba-2 SSD chunk-scan CUDA kernel in
``csrc/ssd_scan.cu``, and the plain PyTorch version beside it.

    x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, b_/c_ (B,S,N)
        -> y (B,S,H,P) in x's dtype, final state (B,H,P,N) fp32

Per (sequence, head) and chunk of ``CHUNK`` tokens: ``seg = cumsum(dt*A)``;
``y = ((C B^T) * exp(seg_i - seg_j) * [j <= i]) (x*dt) + (C * exp(seg)) state``;
``state <- (B * exp(seg_L - seg))^T (x*dt) + exp(seg_L) * state``, from a zero
state. ``ssd_plan`` picks one of two kernels on the host, before any
launch: ``"mma"`` (bf16, N of 64 or 128, P of 16 to 64) runs the four
products on the tensor cores with the fp32 state in registers; ``"fma"``
(fp32, and the bf16 shapes the mma route does not take) does them as fp32
FMAs from shared memory. ``ssd_scan`` takes CUDA tensors only and launches
the kernel or raises; ``ssd_scan_plain`` is the same chunked arithmetic in
fp32 torch, differentiable, and the model's ``impl="naive"`` scan
(``models.ssm.ssd_chunked``). A ragged tail (``S`` no multiple of the
chunk) is zero-padded in the plain version and masked in the kernel: a zero
``dt`` leaves the state untouched.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

CHUNK = 64              # tokens per chunk in the CUDA source
HEAD_DIMS = (16, 32, 64, 128)   # head dims P the CUDA source instantiates
ROUTES = ("mma", "fma")
MMA_STATES = (64, 128)  # state sizes N the mma route instantiates
MMA_WARPS = 4           # a block of the mma route: 16 rows of a chunk's y a warp
MMA_STAGES = 2          # chunks in the mma route's cp.async ring
MMA_ACC_REGS = 96       # most fp32 accumulator values (state and y) a thread of the mma route carries
SMEM_MAX = 227 * 1024   # shared memory a block can have


def mma_smem_bytes(p: int, n: int) -> int:
    """The mma route's shared memory (``mma_smem_bytes`` in the CUDA source):
    a ring of chunks (x, B, C in bf16 with rows padded by 16 bytes, and dt),
    two bf16 (N x P) state tiles, each warp's 16 staged rows of y, and each
    warp's seg and dout."""
    stage = 2 * CHUNK * ((p + 8) + 2 * (n + 8)) + 4 * CHUNK
    return (MMA_STAGES * stage + 2 * 2 * n * (p + 8) + 2 * MMA_WARPS * 16 * (p + 8)
            + 4 * MMA_WARPS * 2 * CHUNK)


def mma_acc_regs(p: int, n: int) -> int:
    """fp32 accumulator values a thread of the mma route carries: its share
    of the (N x P) state and of its warp's 16 rows of y."""
    return n * p // (32 * MMA_WARPS) + p // 2


def ssd_plan(dtype, p: int, n: int) -> str:
    """``"mma"`` for bf16 with P in HEAD_DIMS, N in MMA_STATES, a thread's
    accumulators within MMA_ACC_REGS (P = 128 spills) and the shared memory
    within SMEM_MAX; ``"fma"`` otherwise (fp32 above all: its checks hold it
    at 2e-4 / 2e-3, which TF32 tensor cores would miss)."""
    if (dtype == torch.bfloat16 and p in HEAD_DIMS and n in MMA_STATES
            and mma_acc_regs(p, n) <= MMA_ACC_REGS and mma_smem_bytes(p, n) <= SMEM_MAX):
        return "mma"
    return "fma"


def ssd_scan_plain(x, dt, A, b_, c_, chunk: int = CHUNK, initial_state=None):
    """Plain version, fp32 inside. Returns ``(y, final_state)``; the state
    starts at zero or at ``initial_state`` (B,H,P,N)."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    pad = (-s) % chunk
    xf, dtf, bf, cf = x.float(), dt.float(), b_.float(), c_.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    a = A.float()
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xz, dtz, bz, cz = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        seg = torch.cumsum(dtz * a, dim=1)                           # (B,L,H)
        total = seg[:, -1]                                           # (B,H)
        cb = torch.einsum("bin,bjn->bij", cz, bz)                    # (B,L,L)
        diff = (seg[:, :, None, :] - seg[:, None, :, :]).masked_fill(
            ~tril[None, :, :, None], float("-inf"))
        xdt = xz * dtz[..., None]                                    # (B,L,H,P)
        y = torch.einsum("bij,bijh,bjhp->bihp", cb, torch.exp(diff), xdt)
        y = y + torch.einsum("bin,bih,bhpn->bihp", cz, torch.exp(seg), state)
        decay_out = torch.exp(total[:, None, :] - seg)               # (B,L,H)
        state = (torch.einsum("bjn,bjh,bjhp->bhpn", bz, decay_out, xdt)
                 + torch.exp(total)[:, :, None, None] * state)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def check_inputs(x, dt, A, b_, c_) -> None:
    """What both versions require of their arguments."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or b_.dim() != 3 or c_.dim() != 3:
        raise ValueError("x must be (B,S,H,P), dt (B,S,H), A (H,), b_ and c_ (B,S,N)")
    bsz, s, h, _ = x.shape
    if tuple(dt.shape) != (bsz, s, h) or tuple(A.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x {tuple(x.shape)}")
    if b_.shape != c_.shape or tuple(b_.shape[:2]) != (bsz, s):
        raise ValueError(f"b_ {tuple(b_.shape)} and c_ {tuple(c_.shape)} must be (B,S,N) "
                         f"with x's B and S")


def ssd_scan(x, dt, A, b_, c_, *, route=None):
    """Launches the CUDA kernel of ``ssd_plan``'s route on the current
    stream. x, b_, c_ CUDA tensors of one dtype (bf16 or fp32); dt and A fp32
    whatever x is (the model makes dt with an fp32 softplus); all contiguous.
    ``route`` overrides the plan, to time both routes at one shape; the model
    path never passes it. Returns ``(y, final_state)``."""
    check_inputs(x, dt, A, b_, c_)
    build.refuse_grad("ssd_scan", x, dt, A, b_, c_)
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    plan = ssd_plan(x.dtype, p, n)
    route = route or plan
    if route not in ROUTES:
        raise ValueError(f"route {route!r}: one of {ROUTES}")
    if route == "mma" and plan != "mma":
        raise ValueError(f"the mma route takes bf16 with N in {MMA_STATES} and at most "
                         f"{MMA_ACC_REGS} accumulator values a thread (P <= 64); got "
                         f"{x.dtype}, P={p}, N={n}")
    build.check_cuda_tensors(x=x, b_=b_, c_=c_)
    build.check_cuda_tensors(dt=dt, A=A)
    if dt.dtype != torch.float32 or dt.device != x.device:
        raise ValueError(f"dt and A must be float32 on {x.device}, got {dt.dtype} on {dt.device}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not supported {HEAD_DIMS}")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, s, h, p, n,
            int(x.dtype == torch.bfloat16), int(route == "mma"),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[route] += 1
    return y, state


ssd_scan.launches = 0           # kernel launches made by this wrapper
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
