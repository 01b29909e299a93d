"""Dry-run of every (arch x shape x mesh) cell through the port's mesh path,
as rank 0 of a ``torch.distributed`` fake process group, and its three-term
roofline on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out PATH]

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for the single-pod 16x16 ``("data", "model")`` and the
2x16x16 ``("pod", "data", "model")`` TPU meshes and reads each partition's
counts from XLA. Here ``fake_mesh`` starts torch's ``"fake"`` backend in
this process as rank 0 of the mesh's size (256 or 512 ranks; no other
process, no card, no traffic: a collective returns at once) and builds a
``DeviceMesh`` with the reference's dim names. Each cell's arguments are
``DTensor``s on that mesh (``launch.specs.input_specs`` and ``on_mesh``):
rank 0's local shard of every parameter, optimizer-state leaf, batch and
cache leaf is a ``meta`` tensor, in ``param_shardings``', ``state_shardings``',
``cache_shardings``' and the batch's placements. The cell's step (the
port's ``make_train_step`` with the parameters' ``grad_shardings`` and the
reference's microbatch ``batch_shardings``, the prefill step or the decode
step) then runs once on them through the same mesh path a real mesh runs:
``DTensor`` sharding propagation, the model's ``local_map``s and its
explicit collectives. Nothing is allocated. One fake group lives at a
time; ``fake_mesh`` refuses to start where a process group exists, so a
process that runs a dry-run has no other group. Results are cached per
cell in the output JSON, keyed ``arch|shape|mesh`` (incremental;
``--force`` runs cached cells again; by default
``build/dryrun_results.json``). A cell is skipped exactly where
``configs.cell_is_runnable`` says.

What is counted, and where (``StepCounter``, a ``TorchDispatchMode``): an
op on ``DTensor``s is handed on to ``DTensor``, which runs rank 0's local
op on its local shards, and that local op comes back to the counter and is
counted. The global op ``DTensor`` runs on fake tensors to propagate shapes
is not counted. So every count is rank 0's own: the largest shard where a
dim divides unevenly (``DTensor`` gives the first ranks the larger part),
and the work of a replicated compute (the loss, heads that do not divide
"model") on every rank. Each ok cell's fields:

* ``flops_per_device``: rank 0's local ops' FLOPs, by
  ``torch.utils.flop_counter``'s formulas. The remat recompute is in it,
  and so is the full score square of the attention, by choice: on ``meta``
  K1 and K2 are the custom ops of ``kernels.ops`` (``attention_fwd_meta``,
  ``attention_bwd_meta``), counted here at the FLOPs of the plain versions'
  products (``attention_fwd_flops``, ``attention_bwd_flops``), every
  (query, key) pair, causal or not; and the plain SSD scan's products.
* ``bytes_per_device``: the bytes of rank 0's local ops' tensor inputs and
  outputs (view ops excluded, the collectives' buffers included): eager and
  unfused, the counterpart of XLA's "bytes accessed".
* ``argument_bytes_per_device``: rank 0's local-shard bytes of the step's
  arguments: parameters, optimizer state, batch and cache.
* ``temp_bytes_per_device``: the peak of the live storage bytes rank 0's
  local ops make (every output's storage registered once and released by
  ``weakref.finalize`` when Python drops it; a ``meta`` tensor's
  ``untyped_storage()`` is one object shared by its views). K1 and K2 count
  as the kernels run: their inputs, their outputs and lse (K2 also dout and
  delta), no (S x S) tensor;
  ``peak_memory_per_device`` is the argument bytes plus it, and ``fits``
  holds it against one H100's 80 GB.
* ``collective_bytes_per_device`` and ``collectives["by_kind"]``: the
  collectives the step issues, each as the counter sees it on rank 0 (its
  kind, its process group's size n and its tensors), in bytes a device
  moves over the link: an all-gather (n-1) times its local input, a
  reduce-scatter and an all-to-all (n-1)/n of their input, an all-reduce
  2(n-1)/n of it. ``collectives["calls"]`` counts them by kind. "pod" is
  where the port's placements put it (the batch over ("pod", "data"),
  weights replicated over it).
* ``model_flops`` (6ND / 2ND, ``core.roofline.model_flops_lm``),
  ``useful_flops`` (``useful_flops_cell``) and ``roofline``: a
  ``core.roofline.RooflineReport`` row on ``core.hw.H100_SXM``.

Each mesh runs its own step: its counts depend on its placements. The
reference's ``lower_s``/``compile_s`` are ``build_s`` here (this cell's
group, specs, step and counted run; ``counted_s`` is the counted run's own
time); its HLO-derived ``*_adjusted`` fields and XLA's memory analysis have
no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry, register_flop_formula

import repro_torch.configs as configs
from repro_torch.configs.base import cell_is_runnable
from repro_torch.core import msm
from repro_torch.core.hw import H100_SXM
from repro_torch.core.roofline import RooflineReport, model_flops_lm, useful_flops_cell
from repro_torch.kernels import ops  # noqa: F401  (defines the K1/K2 custom ops counted below)
from repro_torch.launch.specs import (StandInMesh, input_specs, on_mesh, optim_config_for,
                                      shape_of)
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding.partition import NamedSharding, mesh_sizes
from repro_torch.train import make_train_step

COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def production_mesh(multi_pod: bool = False) -> StandInMesh:
    """The reference's production meshes (256 and 512 chips), by shape and
    dim names; ``fake_mesh`` builds them."""
    if multi_pod:
        return StandInMesh((2, 16, 16), ("pod", "data", "model"))
    return StandInMesh((16, 16), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` with dim ``names`` over torch's "fake"
    backend, this process its rank 0 of ``prod(shape)``: collectives
    return at once and move nothing. The group is this process's default
    one, so it refuses to start where a process group exists, and it is
    destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts a fake process group of its own, and this process "
                           "already has a process group")
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _batch_group(sizes: dict) -> int:
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _clamp_microbatches(policy_mb: int, gb: int, mesh) -> int:
    """Largest mb <= policy that leaves an integer per-shard batch."""
    per_shard = max(gb // _batch_group(mesh_sizes(mesh)), 1)
    mb = min(policy_mb, per_shard)
    while per_shard % mb:
        mb -= 1
    return max(mb, 1)


def microbatch_shardings(batch_shardings: dict) -> dict:
    """The reference's ``mb_shard``: each batch key's sharding with a leading
    replicated dim, the microbatch dim of the split batch."""
    return {k: NamedSharding(sh.mesh, (None, *sh.spec)) for k, sh in batch_shardings.items()}


def build_step(kind: str, model, policy, shape, microbatches: int = 1, shardings=None):
    """The cell's step as a function of its ``input_specs`` arguments. A
    training step updates its parameters and state in place (the
    reference's donation), its gradients pinned to the parameters'
    placements and its microbatches to ``microbatch_shardings`` of the
    batch's (``shardings``: the cell's, as ``input_specs`` gives them); a
    decode step runs one token at position ``seq_len - 1``, against the
    whole cache."""
    if kind == "train":
        param_sh, _, batch_sh = shardings if shardings is not None else (None, None, None)
        return make_train_step(model, optim_config_for(policy), policy.grad_compression,
                               microbatches=microbatches, grad_shardings=param_sh,
                               batch_shardings=(microbatch_shardings(batch_sh)
                                                if batch_sh is not None else None))
    if kind == "prefill":
        prefill = make_prefill_step(model)
        return lambda params, batch: prefill(batch)
    decode = make_decode_step(model)
    return lambda params, cache, tokens: decode(cache, tokens, shape_of(shape).seq_len - 1)


def _tensors(tree) -> list:
    """The tensors of nested tuples, lists and dicts (``ParameterDict``s
    too, which ``torch.utils._pytree`` takes for leaves)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "keys"):
        return [t for k in tree.keys() for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def attention_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """K1's FLOPs as the plain forward's products count them: Q K^T over D
    and P V over Dv for every (query, key) pair, 2 B H Sq Skv (D + Dv)."""
    b, sq, h, d = q_shape
    return 2 * b * h * sq * k_shape[1] * (d + v_shape[3])


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def attention_bwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """K2's FLOPs as the plain backward's products count them: dq's
    recompute of S and dP and its dS K, dk/dv's recompute of S and dP and
    their dS^T Q and P^T dO, 2 B H Sq Skv (4 D + 3 Dv)."""
    b, sq, h, d = q_shape
    return 2 * b * h * sq * k_shape[1] * (4 * d + 3 * v_shape[3])


_PLAIN = (torch.Tensor, torch.nn.Parameter)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")
# ops of the collective namespaces that move no data between ranks
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier", "monitored_barrier")


def _collective_kind(func) -> str | None:
    """The kind of a collective op (``COLLECTIVE_KINDS``), or None."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if any(name.startswith(n) for n in _NOT_COLLECTIVES):
        return None
    for kind, keys in (("reduce-scatter", ("reduce_scatter",)),
                       ("all-gather", ("all_gather", "allgather")),
                       ("all-reduce", ("all_reduce", "allreduce")),
                       ("all-to-all", ("all_to_all", "alltoall"))):
        if any(k in name for k in keys):
            return kind
    raise NotImplementedError(f"the dry-run counts no collective {func}")


def _group_size(named: dict) -> int:
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return dist.distributed_c10d._resolve_process_group(named["group_name"]).size()
    return dist.ProcessGroup.unbox(named["process_group"]).size()


def collective_bytes(func, args, kwargs) -> tuple[str, float] | None:
    """(kind, bytes a device moves over the link) of one collective call, or
    None for any other op: an all-gather (n-1) x its input, a reduce-scatter
    or an all-to-all (n-1)/n of it, an all-reduce 2(n-1)/n of it."""
    kind = _collective_kind(func)
    if kind is None:
        return None
    schema = [a.name for a in func._schema.arguments]
    named = dict(zip(schema, args)) | kwargs
    n = _group_size(named)
    src = named.get("input", named.get("input_tensors", named.get("tensors")))
    x = sum(t.numel() * t.element_size() for t in tree_leaves(src)
            if isinstance(t, torch.Tensor))
    factor = {"all-gather": n - 1, "reduce-scatter": (n - 1) / n, "all-to-all": (n - 1) / n,
              "all-reduce": 2 * (n - 1) / n}[kind]
    return kind, factor * x


class StepCounter(TorchDispatchMode):
    """Rank 0's local ops: their FLOPs (``torch.utils.flop_counter``'s
    formulas), the bytes of their tensor inputs and outputs (view ops
    excluded), the peak of the live bytes of the storages they make, and
    the collectives they issue (``collective_bytes``). An op on ``DTensor``s
    is handed on (``NotImplemented``): ``DTensor`` runs its local op, which
    comes back here. An op on any other tensor subclass (the fake tensors on
    which ``DTensor`` propagates global shapes) runs uncounted. The
    arguments' storages (``args``) are not the step's: an in-place update
    writes them, and they are counted apart."""

    def __init__(self, args):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.calls = {k: 0 for k in COLLECTIVE_KINDS}
        # held, so that no argument's storage id is reused during the run
        self._args = {id(s): s for s in (_local(t).untyped_storage() for t in _tensors(args))}
        self._live: set[int] = set()

    def _release(self, key: int, n: int) -> None:
        self.live -= n
        self._live.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        # as FlopCounterMode: an op with a decomposition is counted by its parts
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(type(t) not in _PLAIN for t in ins + outs):
            return out
        moved = collective_bytes(func, args, kwargs)
        if moved is not None:
            self.collectives[moved[0]] += moved[1]
            self.calls[moved[0]] += 1
        elif func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            storage = t.untyped_storage()
            key = id(storage)
            if key in self._args or key in self._live:
                continue
            n = storage.nbytes()
            self._live.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key, n)
        return out


@dataclass(frozen=True)
class StepCounts:
    flops: float        # rank 0's
    bytes: float
    temp_peak: float    # peak live bytes of the step's own storages
    collectives: dict   # bytes a device moves, by kind
    calls: dict         # collective calls, by kind
    seconds: float      # the counted run


def count_step(step_fn, args) -> StepCounts:
    """Rank 0's FLOPs, bytes, peak temporaries and collectives of one run of
    ``step_fn(*args)``."""
    t0 = time.perf_counter()
    counter = StepCounter(args)
    with counter:
        step_fn(*args)
    return StepCounts(float(counter.flops), float(counter.bytes), float(counter.peak),
                      dict(counter.collectives), dict(counter.calls),
                      time.perf_counter() - t0)


# --------------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------------

def run_cell(arch: str, shape_name, multi_pod: bool = False, *, mesh=None,
             policy=None) -> dict:
    """One cell's record, its step run as rank 0 of a fake process group of
    the mesh's size (``fake_mesh``; none may exist before). ``shape_name``:
    a name of ``configs.SHAPES`` or a ``ShapeConfig``; ``mesh``: the shape
    and dim names (a ``StandInMesh``) of the mesh to build in place of the
    production one ``multi_pod`` picks; ``policy``: in place of
    ``msm.recommend``'s."""
    cfg = configs.get(arch)
    shape = shape_of(shape_name)
    mesh = mesh or production_mesh(multi_pod)
    base = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mesh)}
    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        return dict(base, status="skipped", reason=reason)

    t0 = time.perf_counter()
    policy = policy or msm.recommend(shape.name, cfg.n_params())
    with fake_mesh(mesh.shape, mesh.mesh_dim_names) as device_mesh:
        kind, model, args, shardings = input_specs(cfg, shape, device_mesh, policy)
        args = on_mesh(args, shardings)
        model.load_params(args[0])
        args = (model.params, *args[1:])
        mb = (_clamp_microbatches(policy.microbatches, shape.global_batch, device_mesh)
              if kind == "train" else 1)
        arg_bytes = sum(_local(t).numel() * _local(t).element_size() for t in _tensors(args))
        counts = count_step(build_step(kind, model, policy, shape, mb, shardings), args)
    chips = math.prod(mesh.shape)
    coll = sum(counts.collectives.values())
    peak = arg_bytes + counts.temp_peak
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    useful = useful_flops_cell(cfg, shape)
    report = RooflineReport(arch=arch, shape=shape.name, mesh=base["mesh"], chips=chips,
                            hlo_flops=counts.flops, hlo_bytes=counts.bytes,
                            collective_bytes=coll, model_flops=useful,
                            peak_memory_bytes=peak, collective_breakdown=counts.collectives)
    return dict(
        base,
        status="ok",
        step=kind,
        policy=policy.name,
        kv_cache_dtype=policy.kv_cache_dtype if kind == "decode" else None,
        chips=chips,
        microbatches=mb,
        build_s=round(time.perf_counter() - t0, 1),
        counted_s=round(counts.seconds, 1),
        flops_per_device=counts.flops,
        bytes_per_device=counts.bytes,
        argument_bytes_per_device=arg_bytes,
        temp_bytes_per_device=counts.temp_peak,
        peak_memory_per_device=peak,
        fits=peak <= H100_SXM.hbm_capacity,
        collective_bytes_per_device=coll,
        collectives={"by_kind": counts.collectives, "calls": counts.calls},
        model_flops=model_flops_lm(cfg.n_active_params(), tokens, training=(kind == "train")),
        useful_flops=useful,
        roofline=report.row(),
    )


def grid(archs, shapes, meshes):
    """``(key, arch, shape, multi_pod, int8)`` of each cell: every (arch,
    shape, mesh), and each decode shape again with an int8 cache, keyed
    ``arch|shape+kv_int8|mesh``."""
    for arch in archs:
        for shape in shapes:
            for int8 in (False, True) if configs.SHAPES[shape].step == "decode" else (False,):
                for mp in meshes:
                    name = shape + ("+kv_int8" if int8 else "")
                    yield (f"{arch}|{name}|{mesh_name(production_mesh(mp))}", arch, shape, mp,
                           int8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "dryrun_results.json"))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    archs = list(configs.ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for key, arch, shape, mp, int8 in grid(archs, shapes, meshes):
        if key in results and results[key].get("status") in ("ok", "skipped") \
                and not args.force:
            print(f"[cached] {key}: {results[key]['status']}")
            continue
        print(f"[run] {key} ...", flush=True)
        policy = None
        if int8:
            base = msm.recommend(shape, configs.get(arch).n_params())
            policy = msm.compose(base.name, kv_cache_dtype="int8")
        try:
            res = run_cell(arch, shape, mp, policy=policy)
        except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
            res = {"arch": arch, "shape": shape, "mesh": mesh_name(production_mesh(mp)),
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if res["status"] == "ok":
            r = res["roofline"]
            print(f"  ok: build={res['build_s']}s "
                  f"flops/dev={res['flops_per_device']:.3e} "
                  f"bytes/dev={res['bytes_per_device']:.3e} "
                  f"coll/dev={res['collective_bytes_per_device']:.3e} "
                  f"args/dev={res['argument_bytes_per_device'] / 1e9:.2f}GB "
                  f"peakmem/dev={res['peak_memory_per_device'] / 1e9:.2f}GB "
                  f"fits={res['fits']} dominant={r['dominant']}", flush=True)
        else:
            print(f"  {res['status']}: {res.get('reason') or res.get('error')}", flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\nSummary: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
