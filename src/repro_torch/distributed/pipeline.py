"""GPipe-style pipeline parallelism over a mesh axis, over
``torch.distributed``: the counterpart of the reference's
``distributed/pipeline.py`` (``shard_map`` + ``ppermute``).

Layers are split into ``n_stages`` contiguous groups whose parameters are
stacked on a leading "stage" dim sharded over the stage axis
(``stage_params_sharding``), so each rank holds only its stage's layers.
``pipeline_apply`` runs the classic GPipe schedule: with M microbatches
and S stages, M + S - 1 ticks; on each tick every stage that holds a
microbatch applies its block to it, and the activations move one stage on.
Bubble fraction = (S - 1) / (M + S - 1), as ``bubble_fraction`` reports.

Where the reference lets ``jax.grad`` transpose its ``ppermute``s, the
schedule here is one ``torch.autograd.Function``: a send or receive whose
output nobody reads would never have its backward called, and its peer
would wait for it. The backward walks the ticks in reverse on every rank,
receiving each tick's output gradient from the next stage and sending its
input gradient to the one before, and recomputes each active tick's block
to differentiate it (GPipe's re-materialisation). Each tick's exchange is
one ``dist.batch_isend_irecv``, with the peers' global ranks looked up
through the axis's group, so the axis may be one dim of a larger mesh.
The last stage's outputs reach every stage by an all-reduce (sum) over the
axis, the others contributing zeros, as the reference's masked ``psum``;
its backward hands each rank's cotangent on unchanged, as the reference's
does under ``shard_map(check_rep=False)``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.partition import NamedSharding
from repro_torch.train.optim import tree_leaves, tree_unflatten


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def stage_params_sharding(mesh, axis: str = "pipe") -> NamedSharding:
    """Stacked per-stage params: leading dim = stage, sharded over the axis
    (``Shard(0)`` there, ``Replicate()`` on any other mesh dim), for
    ``sharding.partition.device_put``."""
    return NamedSharding(mesh, (axis,))


class _Schedule:
    """What the autograd Function needs besides tensors: the block, the
    stage tree's structure, this rank's stage and its peers."""

    def __init__(self, block_fn, like, mesh, axis: str, m: int):
        self.block_fn, self.like, self.m = block_fn, like, m
        self.group = mesh.get_group(axis)
        self.n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
        self.stage = mesh.get_local_rank(axis)
        self.prev = self._peer(self.stage - 1)
        self.next = self._peer(self.stage + 1)

    def _peer(self, stage: int) -> int | None:
        if 0 <= stage < self.n_stages:
            return dist.get_global_rank(self.group, stage)
        return None

    @property
    def n_ticks(self) -> int:
        return self.m + self.n_stages - 1

    def active(self, stage: int, t: int) -> bool:
        """Whether ``stage`` holds a real microbatch (``t - stage``) at tick t."""
        return 0 <= t - stage < self.m

    def params(self, mine):
        """The stage's parameter tree from its leaves without the stage dim."""
        return tree_unflatten(self.like, mine) if hasattr(self.like, "keys") else mine[0]

    def exchange(self, t: int, send, recv_like, *, backward: bool):
        """One tick's point-to-point exchange. Forward: this stage's output
        of tick t to the next stage, and the previous stage's into the
        returned buffer. Backward: the gradient of tick t's input to the
        previous stage, and the next stage's gradient of this stage's output
        of tick t - 1 into the returned buffer. Only transfers a stage reads
        are posted (the wrap-around edge, and inactive ticks, carry nothing
        the reference keeps), so with one stage there are none."""
        s = self.stage
        if backward:
            to, frm = self.prev, self.next
            sends, recvs = self.active(s, t), self.active(s + 1, t)
        else:
            to, frm = self.next, self.prev
            sends, recvs = self.active(s, t), self.active(s - 1, t)
        ops, buf = [], None
        if to is not None and sends:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), to, self.group))
        if frm is not None and recvs:
            buf = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return buf


class _GPipe(torch.autograd.Function):
    """The schedule over this rank's stage: ``x`` (M, mb, ...) replicated,
    ``leaves`` the stage's local (1, ...) parameter leaves. Returns the
    last stage's outputs on every rank of the axis."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        params = sched.params([leaf[0] for leaf in leaves])
        s, last = sched.stage, sched.n_stages - 1
        outputs = torch.zeros_like(x)
        inputs, buf = {}, None
        for t in range(sched.n_ticks):
            y = None
            if sched.active(s, t):
                cur = x[t] if s == 0 else buf
                inputs[t] = cur
                y = sched.block_fn(params, cur)
                if s == last:
                    outputs[t - s] = y
            buf = sched.exchange(t, y, x[0], backward=False)
        dist.all_reduce(outputs, group=sched.group)
        ctx.sched, ctx.inputs = sched, inputs
        ctx.save_for_backward(*leaves)
        return outputs

    @staticmethod
    def backward(ctx, dout):
        sched, inputs = ctx.sched, ctx.inputs
        leaves = ctx.saved_tensors
        s, last = sched.stage, sched.n_stages - 1
        want_x, want = ctx.needs_input_grad[1], ctx.needs_input_grad[2:]
        dx = torch.zeros_like(dout) if want_x else None
        grads, g_buf = None, None
        for t in reversed(range(sched.n_ticks)):
            d_in = None
            if sched.active(s, t):
                mb = t - s
                g_y = dout[mb] if s == last else g_buf
                with torch.enable_grad():
                    mine = [leaf[0].detach().requires_grad_(w) for leaf, w in zip(leaves, want)]
                    cur = inputs[t].detach().requires_grad_()
                    y = sched.block_fn(sched.params(mine), cur)
                    wrt = [cur] + [p for p in mine if p.requires_grad]
                    got = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
                got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, wrt)]
                d_in = got[0]
                # summed over the ticks in reverse, as autograd sums a leaf's
                # gradients over the microbatches of an unpipelined loop
                grads = got[1:] if grads is None else [a + b for a, b in zip(grads, got[1:])]
                if s == 0 and want_x:
                    dx[mb] = d_in
            g_buf = sched.exchange(t, d_in, dout[0], backward=True)
        if want_x:
            dist.all_reduce(dx, group=sched.group)
        it = iter(grads or [])
        return (None, dx, *(next(it).unsqueeze(0) if w else None for w in want))


def pipeline_apply(block_fn, stage_params, x, *, mesh, axis: str = "pipe",
                   n_microbatches: int | None = None):
    """Run a pipelined stack of stages.

    block_fn(params_stage, x_mb) -> y_mb: one stage's computation (itself
    typically a loop over that stage's layers), y_mb of x_mb's shape.
    stage_params: a tensor or nested dict of ``DTensor``s on ``mesh`` with
    leading dim = n_stages, sharded over ``axis`` (``stage_params_sharding``;
    leaves in other placements are redistributed to it).
    x: (M, mb, ...) microbatched input, replicated over ``axis``: a plain
    tensor, the same on every rank.

    Returns y with the same (M, mb, ...) layout, replicated over ``axis``.
    Differentiable in ``stage_params`` and ``x``."""
    m = x.shape[0]
    n_microbatches = n_microbatches or m
    if m != n_microbatches:
        raise ValueError(f"x has {m} microbatches on its leading dim, "
                         f"n_microbatches is {n_microbatches}")
    target = stage_params_sharding(mesh, axis).placements
    leaves = tree_leaves(stage_params) if hasattr(stage_params, "keys") else [stage_params]
    local = []
    for leaf in leaves:
        if not isinstance(leaf, DTensor):
            raise TypeError("stage_params: leaves must be DTensors on the mesh, placed by "
                            "stage_params_sharding")
        if tuple(leaf.placements) != target:
            leaf = leaf.redistribute(mesh, target)
        local.append(leaf.to_local())
    return _GPipe.apply(_Schedule(block_fn, stage_params, mesh, axis, m), x, *local)
