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
"""
from __future__ import annotations

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
    """Launches the CUDA kernel on the current stream. CUDA tensors, bf16 or
    fp32, contiguous, (q/k head dim, v head dim) one of ``HEAD_DIMS``.
    Returns ``(out, lse)``."""
    check_inputs(q, k, v, causal)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not supported: (D, Dv) one of {HEAD_DIMS}")
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
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0    # kernel launches made by this wrapper
