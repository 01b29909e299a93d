"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

Chunked SSD algorithm: within a chunk the token mixing is the quadratic
"attention-like" form; across chunks a linear recurrence carries the
(heads, head_dim, state) SSM state. Two implementations of the scan, picked
by ``scan`` (``LanguageModel``'s own choice, apart from attention's
``impl``):

* ``naive``  — ``ssd_chunked``, plain torch, differentiable: the training
  path, as the reference trains through its jnp chunked scan;
* ``kernel`` — ``kernels.ops.ssd_scan_op``: the hand-written K5 on the card,
  its plain version for CPU tensors. Forward only: asked for a gradient, it
  raises.

Decode keeps O(1)-in-sequence state: (conv window, SSM state), updated in
place in the caller's cache. Under a mesh the states are ``DTensor``s, batch
over "data" (``cache_shardings``), and the step runs on each rank's rows as
the training mixer does, its new states copied into the cache's local
shards (``layers.copy_into``).

Under a device mesh (a ``DTensor`` input) the mixer runs on each rank's
batch rows with every one of its weights replicated (``layers.on_rows``):
the conv and the scan read the whole sequence, and ``in_proj``'s
``[z | x | B | C | dt]`` column slices cut across its shards over "model".
Either scan runs there on the rank's rows: the naive one in training, K5
in the prefill. The weights stay stored in their placements ("ff" over
"model", "embed" over "data"), and their gradients are partial sums over
"data".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import copy_into, on_rows

SCANS = ("naive", "kernel")


def ssm_specs(cfg: ModelConfig) -> Specs:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return {
        "in_proj": P((d, 2 * di + 2 * n + h), ("embed", "ff")),
        "conv_w": P((cfg.ssm_conv, conv_ch), (None, "ff"), init="small"),
        "conv_b": P((conv_ch,), ("ff",), init="zeros"),
        "A_log": P((h,), ("heads",), init="zeros"),
        "D": P((h,), ("heads",), init="ones"),
        "dt_bias": P((h,), ("heads",), init="zeros"),
        "norm": P((di,), ("ff",), init="ones"),
        "out_proj": P((di, d), ("ff", "embed")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b_ = zxbcdt[..., 2 * di:2 * di + n]
    c_ = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, x, b_, c_, dt


def _causal_conv(params, xbc, conv_state=None):
    """Depthwise causal conv over (B,S,C). Returns (out, new_state). The taps
    are summed in the input dtype, silu is taken in fp32, as the reference
    rounds them."""
    kw = params["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], kw - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(kw):
        out = out + xp[:, i:i + xbc.shape[1]] * params["conv_w"][i]
    out = F.silu((out + params["conv_b"]).float()).to(xbc.dtype)
    new_state = xp[:, xp.shape[1] - (kw - 1):]
    return out, new_state


def ssd_chunked(x, dt, A, b_, c_, chunk: int, initial_state=None):
    """SSD scan. x: (B,S,H,P); dt: (B,S,H); A: (H,) (negative);
    b_/c_: (B,S,N). Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,P,N) fp32). A ragged ``S`` is zero-padded to a chunk multiple; the
    state starts at zero or at ``initial_state``. The arithmetic is K5's
    plain version, at the caller's chunk length."""
    return ssd_scan_plain(x, dt, A, b_, c_, chunk, initial_state)


def _gated_out(params, cfg: ModelConfig, y, z, out_dtype):
    """Gated RMSNorm then the out-projection (Mamba-2 block structure)."""
    yz = y * F.silu(z.float()).to(y.dtype)
    yf = yz.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    yz = (yf * torch.rsqrt(var + cfg.norm_eps) * params["norm"].float()).to(out_dtype)
    return yz @ params["out_proj"]


def mamba2_forward(params, cfg: ModelConfig, x, chunk: int | None = None, scan: str = "naive"):
    """Full Mamba-2 mixer over (B,S,d). Returns (y, (conv_state, ssm_state)).
    ``scan="naive"`` scans with ``ssd_chunked`` (chunk ``cfg.ssm_chunk``),
    ``scan="kernel"`` with K5 (its own chunk length). A ``DTensor`` ``x``
    runs on each rank's rows (see the module's note) with either scan: K5
    takes the rank's rows as plain tensors, forward only."""
    if scan not in SCANS:
        raise ValueError(f"scan {scan!r} not one of {SCANS}")
    if isinstance(x, DTensor):
        def local(params_, x_):
            y, (conv_state, ssm_state) = _mamba2(params_, cfg, x_, chunk, scan)
            return y, conv_state, ssm_state

        y, conv_state, ssm_state = on_rows(local, params, x, n_out=3)
        return y, (conv_state, ssm_state)
    return _mamba2(params, cfg, x, chunk, scan)


def _mamba2(params, cfg: ModelConfig, x, chunk, scan):
    """``mamba2_forward`` on plain tensors."""
    di, h, p, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = x @ params["in_proj"]
    z, xin, b_, c_, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xin, b_, c_], dim=-1)
    xbc, conv_state = _causal_conv(params, xbc)
    xin, b_, c_ = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(*xin.shape[:2], h, p)
    if scan == "kernel":
        y, ssm_state = kops.ssd_scan_op(xh, dt, A, b_, c_)
    else:
        y, ssm_state = ssd_chunked(xh, dt, A, b_, c_, chunk or cfg.ssm_chunk)
    y = y + xh * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(*x.shape[:2], di)
    return _gated_out(params, cfg, y, z, x.dtype), (conv_state, ssm_state)


def mamba2_decode(params, cfg: ModelConfig, x, conv_state, ssm_state):
    """Single-token step. x: (B,1,d); conv_state: (B,kw-1,C); ssm_state:
    (B,H,P,N) fp32. Both states are this layer's slices of the cache and are
    updated IN PLACE. Returns (y, conv_state, ssm_state), the states being the
    tensors passed in. A ``DTensor`` ``x`` runs on each rank's rows with the
    mixer's weights replicated (``layers.on_rows``)."""
    if isinstance(x, DTensor):
        y, conv_new, ssm_new = on_rows(
            lambda params_, x_, c_, s_: _mamba2_decode(params_, cfg, x_, c_, s_),
            params, x, conv_state, ssm_state, n_out=3)
        copy_into(conv_state, conv_new)
        copy_into(ssm_state, ssm_new)
        return y, conv_state, ssm_state
    return _mamba2_decode(params, cfg, x, conv_state, ssm_state)


def _mamba2_decode(params, cfg: ModelConfig, x, conv_state, ssm_state):
    """``mamba2_decode`` on plain tensors."""
    di, h, p, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = x @ params["in_proj"]
    z, xin, b_, c_, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xin, b_, c_], dim=-1)
    xbc, new_conv = _causal_conv(params, xbc, conv_state)
    conv_state.copy_(new_conv)
    xin, b_, c_ = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(x.shape[0], h, p)
    dt1 = dt[:, 0]                                                   # (B,H)
    dA = torch.exp(dt1 * A[None, :])                                 # (B,H)
    dbx = torch.einsum("bn,bh,bhp->bhpn", b_[:, 0].float(), dt1, xh.float())
    ssm_state.mul_(dA[:, :, None, None]).add_(dbx)
    y = torch.einsum("bn,bhpn->bhp", c_[:, 0].float(), ssm_state)
    y = y.to(x.dtype) + xh * params["D"][None, :, None].to(x.dtype)
    y = y.reshape(x.shape[0], 1, di)
    return _gated_out(params, cfg, y, z, x.dtype), conv_state, ssm_state
