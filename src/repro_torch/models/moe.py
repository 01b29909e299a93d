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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import P, Specs
from repro_torch.models.layers import ffn, ffn_specs
from repro_torch.sharding.partition import (fit, mesh_sizes, placements, replicate_like,
                                            role_placements)


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


def _route_rows(router, cfg: ModelConfig, x2d, n_tokens: int):
    """``route`` on rows ``x2d`` (T', d) of a batch of ``n_tokens`` tokens:
    (weights (T',k), experts (T',k), me (E,), ce (E,)), where ``me`` and
    ``ce`` are these rows' shares of the aux loss's two means over the
    batch (the means themselves where T' is the batch)."""
    logits = (x2d @ router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss: each routed slot counts 1/(T*k)
    me = probs.mean(dim=0)
    if x2d.shape[0] != n_tokens:
        me = me * (x2d.shape[0] / n_tokens)
    slots = experts.reshape(-1)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x2d.device).index_add_(
        0, slots, torch.full(slots.shape, 1.0 / (n_tokens * cfg.top_k), dtype=torch.float32,
                             device=x2d.device))
    return weights.to(x2d.dtype), experts, me, ce


def route(params, cfg: ModelConfig, x2d):
    """x2d: (T, d) -> (weights (T,k) in x's dtype, experts (T,k) int64,
    aux_loss fp32 scalar)."""
    weights, experts, me, ce = _route_rows(params["router"], cfg, x2d, x2d.shape[0])
    return weights, experts, cfg.n_experts * torch.sum(me * ce)


def _pack(experts, cap: int, cfg: ModelConfig):
    """The sort-based packing of all T tokens' assignments ``experts`` (T,k)
    into the (E, cap) grid: (grid_tok (E, cap), the token in each slot, T
    where it is empty; cell_of (T, k), each assignment's flat grid cell,
    E*cap where it was dropped). Integer work only, no gradient."""
    t, k = experts.shape
    e, dev = cfg.n_experts, experts.device
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
    cell_of = torch.empty_like(cell)
    cell_of[order] = cell                                   # token-major again
    return grid_tok[:e * cap].view(e, cap), cell_of.view(t, k)


def _dispatch(x2d, grid_tok):
    """The grid's rows of tokens ``x2d`` (T, d): (E', cap', d) for a block
    ``grid_tok`` (E', cap') of the grid, empty slots (token T) zero."""
    x_pad = torch.cat([x2d, x2d.new_zeros(1, x2d.shape[1])])
    return x_pad[grid_tok]


def _experts(xg, w_gate, w_up, w_down):
    """The expert SwiGLU over the expert axis: (E', cap', d) -> (E', cap', d)."""
    g = torch.bmm(xg, w_gate)
    u = torch.bmm(xg, w_up)
    h = F.silu(g.float()).to(xg.dtype) * u
    return torch.bmm(h, w_down)


def _combine(yg, cell_of, weights):
    """Each (token, j) of rows ``cell_of``/``weights`` (T', k) reads its
    expert's output row of the whole grid ``yg`` (E, cap, d) at its cell
    (the zero row where it was dropped), weighted; the k rows of a token are
    summed in j order. Returns (T', d)."""
    e, cap, d = yg.shape
    t, k = cell_of.shape
    y_rows = torch.cat([yg.reshape(e * cap, d), yg.new_zeros(1, d)])
    yk = y_rows[cell_of.reshape(-1)].view(t, k, d) * weights[..., None].to(yg.dtype)
    y2d = yk[:, 0]
    for j in range(1, k):
        y2d = y2d + yk[:, j]
    return y2d


def moe_ffn(params, cfg: ModelConfig, x, fused: bool = False):
    """x: (B, S, d) -> (B, S, d), aux_loss. ``fused`` applies to the shared
    experts' SwiGLU (``layers.ffn``). A ``DTensor`` ``x`` runs on the mesh
    (``_moe_on_mesh``), with the same result."""
    b, s, d = x.shape
    t = b * s
    cap = _capacity(t, cfg)
    if isinstance(x, DTensor):
        y, aux = _moe_on_mesh(params, cfg, x, cap)
    else:
        # route and dispatch each read x as the mesh path's do (one view
        # each), so that x's gradient sums its parts in the same order there
        weights, experts, aux = route(params, cfg, x.reshape(t, d))
        grid_tok, cell_of = _pack(experts, cap, cfg)
        yg = _experts(_dispatch(x.reshape(t, d), grid_tok), params["w_gate"], params["w_up"],
                      params["w_down"])
        y = _combine(yg, cell_of, weights).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + ffn(params["shared"], x, fused=fused)
    return y, aux


def _moe_on_mesh(params, cfg: ModelConfig, x, cap: int):
    """``moe_ffn``'s routed experts on a ``DTensor`` ``x`` (B, S, d), in the
    reference's placements: the (E, cap, d) grid, the expert hidden and
    output with experts over "model" and capacity over "data", the combined
    rows batch over "data" (each placement fitted to the mesh, as the
    reference's ``constrain``). The result is the unsharded function's:
    every rank routes its own rows, the decisions (T x k expert ids) are
    gathered, and every rank packs all T tokens against the one capacity,
    as one device does, then takes its block of the grid. The ops run on
    local shards (``local_map``): a rank's grid rows come from the gathered
    tokens, each token's k rows from the gathered grid, and a gradient
    whose rank holds only part of the sum is declared partial there."""
    mesh = x.device_mesh
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    sizes = mesh_sizes(mesh)
    split = "data" in sizes and b % sizes["data"] == 0
    rows = role_placements(mesh, Shard(0) if split else None)
    rows_sum = role_placements(mesh, Partial() if split else None)
    whole = role_placements(mesh)
    grid = list(placements(fit((cfg.n_experts, cap, d), ("model", "data", None), mesh), mesh))
    # a rank's share of a sum over the grid's blocks: partial where the grid
    # is split, whole where every rank of that mesh dim holds the same block
    grid_sum = [Partial() if p.is_shard() else Replicate() for p in grid]
    grid_at, grid_sum_at = (dict(zip(mesh.mesh_dim_names, p)) for p in (grid, grid_sum))
    # the expert weights: experts as the grid's, gathered over "data"; their
    # gradients summed over the grid's capacity blocks
    experts_on = role_placements(mesh, None, grid_at.get("model"))
    experts_grad = role_placements(mesh, grid_sum_at.get("data"), grid_at.get("model"))

    def route_rows(router, x_):
        n = x_.shape[0] * x_.shape[1]
        w, ex, me, ce = _route_rows(router, cfg, x_.reshape(n, d), t)
        return w.view(-1, s, k), ex.view(-1, s, k), me, ce

    weights, experts, me, ce = local_map(
        route_rows, out_placements=(rows, rows, rows_sum, rows_sum),
        in_placements=(whole, rows), in_grad_placements=(rows_sum, rows),
        device_mesh=mesh, redistribute_inputs=True)(params["router"], x)
    aux = cfg.n_experts * torch.sum(me.redistribute(placements=whole)
                                    * ce.redistribute(placements=whole))

    # every rank packs all tokens' decisions: the same grid on every rank
    grid_tok, cell_of = _pack(experts.full_tensor().reshape(t, k), cap, cfg)
    xg = local_map(lambda x_, g_: _dispatch(x_.reshape(t, d), g_),
                   out_placements=grid, in_placements=(whole, grid),
                   in_grad_placements=(grid_sum, grid), device_mesh=mesh,
                   redistribute_inputs=True)(x, replicate_like(grid_tok, x))
    yg = local_map(_experts, out_placements=grid,
                   in_placements=(grid, experts_on, experts_on, experts_on),
                   in_grad_placements=(grid, experts_grad, experts_grad, experts_grad),
                   device_mesh=mesh, redistribute_inputs=True)(
        xg, params["w_gate"], params["w_up"], params["w_down"])
    y = local_map(lambda y_, c_, w_: _combine(y_, c_.reshape(-1, k), w_.reshape(-1, k))
                  .view(-1, s, d),
                  out_placements=rows, in_placements=(whole, rows, rows),
                  in_grad_placements=(rows_sum, rows, rows), device_mesh=mesh,
                  redistribute_inputs=True)(yg, replicate_like(cell_of.view(b, s, k), x),
                                            weights)
    return y, aux
