"""Training step: loss and gradients -> (optional) gradient compression ->
AdamW.

Gradient compression options, as in the reference:

* ``None``      gradients in the parameters' dtype.
* ``"bf16"``    explicit cast before the optimizer (no-op with bf16 params).
* ``"int8_ef"`` per-tensor int8 quantization with persistent error feedback
                carried in the optimizer state (1-bit-Adam-style EF,
                arXiv:2102.02888): the quantization error is re-injected on
                the next step.

Under a device mesh the parameters, gradients and state are ``DTensor``s;
``grad_shardings`` and ``batch_shardings`` pin gradients and microbatches
to their placements, as the reference's ``with_sharding_constraint``s do.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.partition import device_put
from repro_torch.train import optim as optim_mod
from repro_torch.train.optim import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x32):
    amax = torch.max(torch.abs(x32)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compress_grads(grads, method: str | None, ef_state):
    """Returns (effective_grads, new_ef_state)."""
    if method is None:
        return grads, ef_state
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), ef_state
    if method == "int8_ef":
        def one(g, e):
            g32 = g.float() + e
            q, s = quantize_int8(g32)
            deq = dequantize_int8(q, s)
            return deq.to(g.dtype), g32 - deq

        outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef_state))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))
    raise ValueError(method)


def init_ef_state(params, method: str | None):
    if method != "int8_ef":
        return None
    return tree_map(_zeros_f32, params)


def _zeros_f32(p):
    """fp32 zeros of ``p``'s shape (a ``DTensor``'s at its placements)."""
    return torch.zeros_like(p, dtype=torch.float32)


def _place(tree, shardings):
    """``tree`` placed on ``shardings`` (``sharding.device_put``); with
    ``shardings=None`` as it is."""
    return tree if shardings is None else device_put(tree, shardings)


def make_train_step(model, opt_cfg: optim_mod.OptimConfig,
                    grad_compression: str | None = None, microbatches: int = 1,
                    grad_shardings=None, batch_shardings=None):
    """Returns ``train_step(params, opt_state, batch, rng=None) -> (params,
    opt_state, metrics)``. ``params`` is ``model.params``: the step updates
    it and ``opt_state`` in place and returns them. ``opt_state`` carries the
    EF buffers when compressing. ``batch`` holds tensors on the model's
    device; ``rng`` is a ``torch.Generator`` there (stochastic rounding).

    ``microbatches > 1`` accumulates gradients: the batch is split along dim
    0, each part's gradients are summed in fp32, and loss and gradients are
    divided by ``microbatches``.

    Under a mesh: ``grad_shardings`` (the parameters' ``NamedSharding``s)
    pins each microbatch's gradients and the fp32 accumulator to the
    parameters' placements, so the accumulator stays as sharded as the
    parameters; ``batch_shardings`` (one per batch key) pins the split
    batch (microbatches, rows, ...), the microbatch dim first, as the
    reference's dry-run builds them (``mb_shard``: the batch's spec behind
    a replicated leading dim), so that each microbatch keeps the batch's
    placements."""

    def grad_fn(params, batch):
        loss = model.loss(batch)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(params, opt_state, batch, rng=None):
        if params is not model.params:
            raise ValueError("train_step updates model.params in place: pass model.params")
        if microbatches <= 1:
            loss, grads = grad_fn(params, batch)
            grads = _place(grads, grad_shardings)
        else:
            def split(x):
                if isinstance(x, DTensor):
                    # the split's leading dim holds dim 0's shards only where
                    # their count divides it; else dim 0 is gathered first
                    shards = math.prod(x.device_mesh.size(d) for d, p in enumerate(x.placements)
                                       if p.is_shard(0))
                    if microbatches % shards:
                        x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(0) else p
                                                           for p in x.placements])
                return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])

            parts = _place({k: split(v) for k, v in batch.items()}, batch_shardings)
            gsum = _place(tree_map(_zeros_f32, params), grad_shardings)
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                mb = {k: v[i] for k, v in parts.items()}
                l, g = grad_fn(params, mb)
                g = _place(g, grad_shardings)
                for acc, gi in zip(tree_leaves(gsum), tree_leaves(g)):
                    acc.add_(gi.float())
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        ef = opt_state.get("ef")
        grads, new_ef = compress_grads(grads, grad_compression, ef)
        core = {k: v for k, v in opt_state.items() if k != "ef"}
        params, new_core, metrics = optim_mod.apply_updates(params, grads, core, opt_cfg, rng=rng)
        if new_ef is not None:
            new_core["ef"] = new_ef
        metrics = dict(metrics, loss=loss)
        return params, new_core, metrics

    return train_step


def init_opt_state(params, opt_cfg: optim_mod.OptimConfig,
                   grad_compression: str | None = None):
    state = optim_mod.init_state(params, opt_cfg)
    ef = init_ef_state(params, grad_compression)
    if ef is not None:
        state["ef"] = ef
    return state
