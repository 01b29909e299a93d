"""Mixture-of-Experts: top-k routing with sort-based grouped dispatch.

* Router: softmax top-k over the expert logits, renormalised, with the
  Switch-style load-balance aux loss; optional shared experts (always
  active) through ``layers.ffn``.
* Dispatch: the (token, j) assignments are sorted by expert id (stable) and
  packed into a fixed ``(E, capacity)`` grid; an assignment past its
  expert's capacity is dropped, and an empty grid slot reads a zero row.
* Expert FFN: three batched products over the expert axis (SwiGLU), weights
  ``(E, d, ff)``. The reference computes them outside any Pallas kernel, so
  they are library products (``torch.bmm``) here.
* Combine: each (token, j) reads its expert's output row at its grid slot
  (the zero row where it was dropped), weighted, and the k rows of a token
  are summed in j order. The reference scatter-adds the grid back into the
  tokens: the same sum in another order. A fixed order keeps two runs on the
  card equal to the bit, where ``index_add_`` with repeated indices adds by
  float atomics.

No step reads a value back to the host: every shape follows from the
input's shape alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import ffn, ffn_specs


def moe_specs(cfg: ModelConfig) -> Specs:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s: Specs = {
        "router": P((d, e), ("embed", "experts"), init="small"),
        "w_gate": P((e, d, f), ("experts", "embed", "ff")),
        "w_up": P((e, d, f), ("experts", "embed", "ff")),
        "w_down": P((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = ffn_specs(d, cfg.moe_d_ff * cfg.n_shared_experts)
    return s


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n_tokens * top_k * capacity_factor / n_experts``,
    rounded up to a multiple of 8, at least 8."""
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def route(params, cfg: ModelConfig, x2d):
    """x2d: (T, d) -> (weights (T,k) in x's dtype, experts (T,k) int64,
    aux_loss fp32 scalar)."""
    logits = (x2d @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss: each routed slot counts 1/(T*k)
    e = cfg.n_experts
    me = probs.mean(dim=0)
    slots = experts.reshape(-1)
    ce = torch.zeros(e, dtype=torch.float32, device=x2d.device).index_add_(
        0, slots, torch.full(slots.shape, 1.0 / slots.numel(), dtype=torch.float32,
                             device=x2d.device))
    aux = e * torch.sum(me * ce)
    return weights.to(x2d.dtype), experts, aux


def moe_ffn(params, cfg: ModelConfig, x, fused: bool = False):
    """x: (B, S, d) -> (B, S, d), aux_loss. ``fused`` applies to the shared
    experts' SwiGLU (``layers.ffn``)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    weights, experts, aux = route(params, cfg, x2d)
    k, e = cfg.top_k, cfg.n_experts
    cap = _capacity(t, cfg)
    dev = x.device

    # ---- sort-based packing into (E, cap) ----
    flat_expert = experts.reshape(-1)                       # (T*k,), token-major
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=dev))
    slot = torch.arange(t * k, device=dev) - group_start[se]  # 0-based within its expert
    # each sorted assignment's cell of the flat grid; overflow goes to cell
    # E*cap, which is cut off the grid and reads the zero row in the combine
    cell = torch.where(slot < cap, se * cap + slot, e * cap)
    grid_tok = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    grid_tok[cell] = order // k
    x_pad = torch.cat([x2d, x2d.new_zeros(1, d)])
    xg = x_pad[grid_tok[:e * cap].view(e, cap)]            # (E, cap, d); empty slots zero

    # ---- expert SwiGLU over the expert axis ----
    g = torch.bmm(xg, params["w_gate"])
    u = torch.bmm(xg, params["w_up"])
    h = F.silu(g.float()).to(xg.dtype) * u
    yg = torch.bmm(h, params["w_down"])                     # (E, cap, d)

    # ---- combine: each (token, j) gathers its row, weighted, summed over j ----
    cell_of = torch.empty_like(cell)
    cell_of[order] = cell                                   # token-major again
    y_rows = torch.cat([yg.reshape(e * cap, d), yg.new_zeros(1, d)])
    yk = y_rows[cell_of].view(t, k, d) * weights[..., None].to(yg.dtype)
    y2d = yk[:, 0]
    for j in range(1, k):
        y2d = y2d + yk[:, j]

    if cfg.n_shared_experts:
        y2d = y2d + ffn(params["shared"], x2d, fused=fused)
    return y2d.reshape(b, s, d), aux
