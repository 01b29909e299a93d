"""Logical-axis -> mesh-axis resolution (DP/FSDP/TP/SP) over a
``torch.distributed`` device mesh, in the reference's global-view semantics.

Parameters carry logical axis names (see ``models.base.P``); this module
maps them onto a mesh with dims ``("data", "model")``, as the reference's
``sharding/partition.py`` does:

    experts  -> "model"   (expert parallelism for MoE)
    heads / kv_heads / ff / vocab -> "model"  (megatron-style TP)
    embed    -> "data"    (FSDP weight sharding over the data axis)
    layers / lora / None  -> replicated

Divisibility-aware: a logical axis whose dimension does not divide the mesh
axis degrades to replication for that axis, and when several logical axes
of one tensor want the same mesh axis the first in the priority order
below wins. A spec is what the reference's ``PartitionSpec`` holds: one
entry per tensor dim, a mesh-axis name, a tuple of names or ``None``.
``placements`` turns it into ``DTensor`` placements, one per mesh dim;
``role_placements`` builds them from the roles a tensor takes on "data"
and "model", for the ops that run on local shards.

The rules read only the mesh's dim names and sizes (``mesh_dim_names``,
``shape``), so they are pure functions of shapes and mesh sizes.
``device_put`` places a tree on its shardings. ``constrain``,
``sp_boundary`` and ``sp_gather`` redistribute a ``DTensor`` and hand any
other tensor back unchanged, which keeps every single-device path as it is.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

# Priority-ordered: earlier entries claim their mesh axis first within a tensor.
LOGICAL_RULES: list[tuple[str, tuple[str, ...]]] = [
    ("experts", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("ff", ("model",)),
    ("vocab", ("model",)),
    ("embed", ("data",)),       # FSDP: weights gathered just-in-time
    ("expert_cap", ("data",)),
    ("layers", ()),
    ("lora", ()),
]
_RULES = dict(LOGICAL_RULES)
_PRIORITY = {name: i for i, (name, _) in enumerate(LOGICAL_RULES)}

Spec = tuple    # per tensor dim: a mesh-axis name, a tuple of names, or None


def mesh_sizes(mesh) -> dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_spec(shape: tuple[int, ...], axes: tuple[str | None, ...], mesh,
                 fsdp: bool = True) -> Spec:
    """The spec of one tensor, enforcing divisibility and
    one-mesh-axis-per-tensor-dim / one-dim-per-mesh-axis."""
    sizes = mesh_sizes(mesh)
    taken: set[str] = set()
    entries: list[str | None] = [None] * len(axes)
    # Resolve in priority order so e.g. "experts" claims "model" before "ff".
    order = sorted(range(len(axes)), key=lambda i: _PRIORITY.get(axes[i] or "", 99))
    for i in order:
        name = axes[i]
        if name is None or name not in _RULES:
            continue
        if not fsdp and name == "embed":
            continue
        for mesh_axis in _RULES[name]:
            if mesh_axis not in sizes or mesh_axis in taken:
                continue
            if shape[i] % sizes[mesh_axis] != 0:
                continue  # degrade to replication (e.g. 4 kv-heads over 16)
            entries[i] = mesh_axis
            taken.add(mesh_axis)
            break
    return tuple(entries)


def role_placements(mesh, data=None, model=None) -> list:
    """One placement per dim of ``mesh`` from the roles a tensor takes
    there: ``data`` on the "data" dim (``Shard(0)`` for a batch split over
    it, ``Partial()`` for a gradient summed over it), ``model`` on the
    "model" dim, ``Replicate()`` where a role is None and on any other dim.
    A list, as ``local_map`` reads a tuple as one placement list per
    output."""
    roles = {"data": data, "model": model}
    return [Replicate() if roles.get(name) is None else roles[name]
            for name in mesh.mesh_dim_names]


def placements(spec: Spec, mesh) -> tuple:
    """``DTensor`` placements of ``spec``, one per mesh dim: ``Shard(d)``
    where tensor dim ``d`` names that mesh dim, else ``Replicate()``."""
    dims = {}
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            dims[axis] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(axes_tree, shapes_tree, mesh, fsdp: bool = True):
    """Tree of ``NamedSharding``s parallel to the params tree. The leaves of
    ``shapes_tree`` need only a ``shape`` (tensors, or ``model.specs()``)."""

    def walk(ax, shp):
        if isinstance(ax, dict):
            return {k: walk(ax[k], shp[k]) for k in ax}
        return NamedSharding(mesh, resolve_spec(tuple(shp.shape), ax, mesh, fsdp=fsdp))

    return walk(axes_tree, shapes_tree)


def batch_spec(mesh, seq_sharded: bool = False) -> Spec:
    """Token batches: batch over (pod, data); optionally sequence over data
    (context/sequence parallelism for the gb=1 long-context cells)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if seq_sharded:
        return (None, ("data",))
    return (batch_axes if len(batch_axes) > 1 else batch_axes[0],)


def cache_shardings(cache_tree, mesh, shard_seq: bool = False):
    """KV-cache shardings. Layout per family (leading dim = layers):

    attention k/v (L, B, S, KVH, D): batch over (pod,data); kv-heads over
    model when divisible, otherwise the SEQUENCE dim shards over model.
    MLA latent caches (no head dim) always sequence-shard. ``shard_seq``
    (gb=1 long-context) shards S over data instead. SSM conv/ssm states:
    batch over (pod,data). ``launch/serve.ServingEngine(mesh=)`` places its
    cache with it (``shard_seq`` at batch 1), and the decode step reads each
    rank's shard where it lies (``models.attention``, ``kernels.ops``: a
    sequence-sharded cache by partial softmax results combined over its
    mesh dim, where XLA turns the reference's reductions into psums);
    ``launch/specs`` places the dry-run's decode caches with it."""
    dims = mesh_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in dims)
    bspec = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    nbatch = max(_flat(dims, batch_axes), 1)

    def spec_for(name: str, arr) -> Spec:
        shape = arr.shape
        if name in ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v", "ckv", "krope"):
            seq_ok_model = shape[2] % dims.get("model", 1) == 0
            if shard_seq and shape[2] % dims.get("data", 1) == 0:
                return (None, None, "data")
            if shape[1] % nbatch == 0 and shape[1] > 1:
                entries = [None, bspec, None]
                has_kvh = name not in ("ckv", "krope") and len(shape) >= 4
                if has_kvh and shape[3] % dims.get("model", 1) == 0:
                    entries += ["model"]
                elif seq_ok_model:
                    entries[2] = "model"   # context-parallel over TP axis
                return tuple(entries)
            if seq_ok_model:
                return (None, None, "model")
            return ()
        # ssm conv/ssm states: (L, B, ...)
        if shape[1] % nbatch == 0 and shape[1] > 1:
            return (None, bspec)
        return ()

    return {k: NamedSharding(mesh, spec_for(k, v)) for k, v in cache_tree.items()}


def _flat(dims: dict, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= dims.get(a, 1)
    return n


def device_put(tree, shardings):
    """Place every leaf of ``tree`` (a nested dict, or an ``nn.ParameterDict``)
    on its ``NamedSharding`` in ``shardings`` (the same keys): a leaf already
    so placed is kept, a plain tensor is split from its full value, which
    every rank holds. Returns a nested dict of ``DTensor``s."""
    if hasattr(tree, "keys"):
        return {k: device_put(tree[k], shardings[k]) for k in tree.keys()}
    leaf = tree.detach()
    target = shardings.placements
    if isinstance(leaf, DTensor):
        return leaf if tuple(leaf.placements) == target else leaf.redistribute(
            shardings.mesh, target)
    return distribute_tensor(leaf, shardings.mesh, target)


def fit(shape, entries, mesh) -> Spec:
    """``entries`` (a mesh-axis name, a tuple of names or None per dim of
    ``shape``) as a spec on ``mesh``: axes not in the mesh, or whose sizes
    do not divide the dim, degrade to None, as the reference's
    ``constrain`` degrades them."""
    sizes = mesh_sizes(mesh)
    resolved = []
    for dim, e in zip(shape, entries):
        axes = () if e is None else tuple(
            a for a in ((e,) if isinstance(e, str) else tuple(e)) if a in sizes)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        resolved.append(axes if axes and dim % prod == 0 else None)
    return tuple(resolved)


def constrain(x, *entries):
    """The reference's best-effort ``with_sharding_constraint`` inside model
    code. ``entries`` are mesh-axis names, tuples of names, or None per dim,
    fitted to the tensor's mesh (``fit``). A ``DTensor`` is redistributed to
    the result (unless every entry degraded); any other tensor comes back
    unchanged."""
    if not isinstance(x, DTensor):
        return x
    resolved = fit(x.shape, entries, x.device_mesh)
    if all(e is None for e in resolved):
        return x
    target = placements(resolved, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def sp_boundary(x):
    """Sequence-parallel residual boundary: (B, S, D) activations sharded
    batch->(pod,data), seq->model (Megatron-SP, arXiv:2205.05198); DTensor
    gathers the sequence at the QKV/FFN entry and reduce-scatters after the
    output projections."""
    return constrain(x, ("pod", "data"), "model", None)


def sp_gather(x):
    """The other side of ``sp_boundary``: (B, S, D) activations with the
    whole sequence (batch over (pod, data), replicated over model), as a
    block's QKV and FFN products take them (Megatron-SP's all-gather, which
    XLA inserts by itself and DTensor, whose matmul cannot flatten a
    sharded sequence into its rows, is told)."""
    return constrain(x, ("pod", "data"), None, None)


def replicate_like(t, ref):
    """``t`` as a ``DTensor`` replicated on ``ref``'s mesh when ``ref`` is a
    ``DTensor`` and ``t`` a plain tensor (DTensor refuses to mix the two
    beyond 0-dim tensors); ``t`` itself otherwise."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
