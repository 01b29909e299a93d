"""AdamW with dtype-configurable state, from scratch (no ``torch.optim``).

Mixed-precision recipes, as in the reference:

* ``float32`` moments + fp32 master weights: the classic recipe
  (14 bytes/param with bf16 params).
* ``bfloat16`` moments (+ optional master): the capacity recipe; stochastic
  rounding on the bf16 param update when no master is kept (6 bytes/param).

Parameter, gradient and state trees are nested dicts (or ``ParameterDict``s)
of tensors; their leaves are taken in sorted-key order, as ``jax.tree``
flattens a dict. Unlike the reference, which returns new arrays,
``apply_updates`` updates the parameters and the state IN PLACE (``copy_``
under ``no_grad``), PyTorch's idiom, so no second copy of either is held.

Under a device mesh the leaves are ``DTensor``s: the state shards exactly
like its parameters (``state_shardings``), the update runs on each rank's
shards, and the global norm reduces across ranks. Stochastic rounding
draws its bits per leaf; on a mesh of more than one rank each shard would
draw other bits than the unsharded leaf does, so it raises there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.partition import NamedSharding


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # float32 | bfloat16
    master_weights: bool = True
    stochastic_rounding: bool = False  # SR on bf16 param updates (no master)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in sorted-key order (``jax.tree.leaves`` order for dicts)."""
    out = []
    for k in sorted(tree.keys()):
        v = tree[k]
        out.extend(tree_leaves(v) if hasattr(v, "keys") else [v])
    return out


def tree_map(fn, tree) -> dict:
    """A nested dict of ``fn(leaf)`` with ``tree``'s keys."""
    return {k: (tree_map(fn, v) if hasattr(v, "keys") else fn(v)) for k, v in tree.items()}


def tree_unflatten(like, leaves) -> dict:
    """A nested dict with ``like``'s keys holding ``leaves`` (sorted-key order)."""
    it = iter(leaves)

    def walk(node):
        return {k: (walk(node[k]) if hasattr(node[k], "keys") else next(it))
                for k in sorted(node.keys())}

    return walk(like)


def lr_at(cfg: OptimConfig, step):
    """Warmup then cosine decay, in fp32 as the reference computes it.
    ``step``: an int or an int tensor; returns an fp32 tensor on its device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _moment_dtype(cfg: OptimConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def init_state(params, cfg: OptimConfig) -> dict:
    mdt = _moment_dtype(cfg)
    device = tree_leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt, requires_grad=False), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt, requires_grad=False), params),
    }
    if cfg.master_weights:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


def _dither_round_bf16(x32: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 by adding 16 bits of ``noise`` (int32 in [0, 65536)) below
    the bf16 mantissa and truncating. On an int32 view: the wraparound sum has
    the bits of the reference's uint32 sum, and -65536 is 0xFFFF0000."""
    bits = x32.contiguous().view(torch.int32)
    return ((bits + noise) & -65536).view(torch.float32).to(torch.bfloat16)


def _stochastic_round_bf16(generator: torch.Generator, x32: torch.Tensor) -> torch.Tensor:
    """Unbiased fp32 -> bf16 rounding via uniform dither of the truncated bits.
    A ``DTensor`` (on a one-rank mesh: its shard is the whole leaf) draws
    and rounds its local tensor."""
    if isinstance(x32, DTensor):
        local = _stochastic_round_bf16(generator, x32.to_local())
        return DTensor.from_local(local, x32.device_mesh, x32.placements, run_check=False)
    noise = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32, device=x32.device,
                          generator=generator)
    return _dither_round_bf16(x32, noise)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptimConfig, rng: torch.Generator | None = None):
    """One AdamW step, IN PLACE on ``params`` and ``state``. Returns
    ``(params, state, metrics)``, the first two being the objects passed in.
    ``rng`` (a generator on the parameters' device) drives stochastic
    rounding when it is on and no master is kept."""
    if (cfg.stochastic_rounding and not cfg.master_weights and rng is not None
            and any(isinstance(p, DTensor) and p.device_mesh.size() > 1
                    for p in tree_leaves(params))):
        raise NotImplementedError(
            "stochastic rounding under a mesh of more than one rank: each shard would draw "
            "other random bits than the unsharded leaf; train with fp32 master weights "
            "(master_weights=True, as TRAIN_MSM) or on one rank")
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    flat_params = tree_leaves(params)
    flat_grads = tree_leaves(grads)
    flat_mu = tree_leaves(state["mu"])
    flat_nu = tree_leaves(state["nu"])
    flat_master = (tree_leaves(state["master"]) if cfg.master_weights
                   else [None] * len(flat_params))
    use_sr = cfg.stochastic_rounding and not cfg.master_weights and rng is not None

    # each fp32 temporary is dropped as soon as it is used: a leaf of 1.26 B
    # elements (a MoE layer's expert stack) takes 5 GB a temporary
    for p, g, mu, nu, mw in zip(flat_params, flat_grads, flat_mu, flat_nu, flat_master):
        g32 = g.float() * scale
        mu32 = mu.float() * b1 + g32 * (1 - b1)
        nu32 = nu.float() * b2 + torch.square(g32) * (1 - b2)
        del g32
        upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        mu.copy_(mu32)
        nu.copy_(nu32)
        del mu32, nu32
        base = mw if mw is not None else p.float()
        p32 = base - lr * (upd + cfg.weight_decay * base)
        del upd, base
        if mw is not None:
            mw.copy_(p32)
            p.copy_(p32)
        elif use_sr and p.dtype == torch.bfloat16:
            p.copy_(_stochastic_round_bf16(rng, p32))
        else:
            p.copy_(p32)
        del p32

    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def state_shardings(param_shardings_tree, cfg: OptimConfig, mesh):
    """Optimizer state shards exactly like its parameters; the step counter
    is replicated."""
    out = {
        "step": NamedSharding(mesh, ()),
        "mu": param_shardings_tree,
        "nu": param_shardings_tree,
    }
    if cfg.master_weights:
        out["master"] = param_shardings_tree
    return out
