"""Dry-run of every (arch x shape x mesh) cell on ``meta`` tensors, and its
three-term roofline on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out PATH]

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell for a TPU pod. Here each cell's step (the port's
``make_train_step``, prefill or decode step) runs once on ``meta`` tensors
at the cell's global shape, on the host, with no card: the parameters
(``models.base.abstract_params``), optimizer state, batch and cache come
from ``launch.specs.input_specs`` beside their placements on a stand-in of
the reference's meshes, 16x16 ``("data", "model")`` or 2x16x16 ``("pod",
"data", "model")``. Nothing is allocated and no process group is started.
Results are cached per cell in the output JSON, keyed ``arch|shape|mesh``
(incremental; ``--force`` runs cached cells again; by default
``build/dryrun_results.json``). A cell is skipped
exactly where ``configs.cell_is_runnable`` says.

Each ok cell's fields:

* ``flops_per_device``: the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
  counts over the step, divided by the chip count. The remat recompute is in
  it, and so is the full score square of the attention: on ``meta`` the ops
  take the kernels' plain versions (``kernels.ops``), which compute every
  (query, key) pair, causal or not, and the plain SSD scan's products.
* ``bytes_per_device``: the bytes of every aten op's tensor inputs and
  outputs over the same run (view ops excluded), counted by one
  ``TorchDispatchMode``, over the chip count: eager and unfused, the
  counterpart of XLA's "bytes accessed".
* ``argument_bytes_per_device``: exact. The Σ of each leaf's local-shard
  bytes under its ``NamedSharding`` (a dim named by mesh axes divided by
  their sizes): parameters, optimizer state, batch and cache.
* ``peak_memory_per_device``: the argument bytes plus the peak of the live
  storage bytes the step makes (``temp_bytes_per_device``: every output's
  storage registered once and released by ``weakref.finalize`` when Python
  drops it; a ``meta`` tensor's ``untyped_storage()`` is one object shared
  by its views), divided by the chip count; ``fits`` against one H100's
  80 GB.
* ``collective_bytes_per_device`` and ``collectives`` (by kind and by
  term): analytic, from the placements, as the port's mesh path issues its
  collectives. With sizes nd ("data"), nm ("model"), np ("pod"), the batch
  group nb = np·nd, a leaf's local-shard bytes L, a sequence-parallel
  activation of X = (rows a rank) x S x d x 2 bytes, one use of a weight
  per layer (the hybrid's shared block: one per call) and ``mb``
  microbatches, per device and step:

  - FSDP: a weight sharded over "data" is all-gathered, (nd-1)·L, at each
    use in the forward and again in the remat recompute. A weight the port
    reads replicated on every dim (the embedding, the LM head, the Mamba-2
    mixer's, the MoE router; ``layers.on_rows``) is gathered over every
    axis it is sharded on, (n-1)·L for its n shards.
  - Gradients (training): a "data"-sharded weight's gradient is
    reduce-scattered over "data", (nd-1)·L (a replicated-read weight's from
    its full size over "model": (nd-1)·L·nm where it is sharded over
    "model"); one replicated over "data" is all-reduced, 2(nd-1)/nd·L; over
    "pod" every gradient is all-reduced, 2(np-1)/np of its post-"data" size.
  - Sequence parallel: around every attention, FFN and mixer
    (``sp_gather``, ``sp_boundary``) an all-gather and a reduce-scatter over
    "model", (nm-1)/nm·X each; where the sequence does not divide "model"
    (a decode step's one token) one all-reduce, 2(nm-1)/nm·X, in their
    place; in the forward, the recompute and the backward. A training step
    also gathers the final hidden state for the loss and reduce-scatters its
    gradient.
  - MoE (``models/moe.py:_moe_on_mesh``), each MoE layer and pass over T
    tokens: the T x k routing decisions (int64) and the T token rows
    all-gathered over the batch group, (nb-1)/nb of each; the (E, cap, d)
    grid gathered from its g shards, (1-1/g); the aux loss's two E-vectors
    all-reduced; in the backward the token rows' gradient reduce-scattered
    over the batch group and all-reduced over "model", and the grid's
    reduce-scattered over the batch group.

  Every term is 0 on a mesh of one device. "pod" is taken as the
  reference places it (batch over ("pod", "data"), weights replicated):
  the port's mesh path has not run a three-dimensional mesh.
* ``model_flops`` (6ND / 2ND, ``core.roofline.model_flops_lm``),
  ``useful_flops`` (``useful_flops_cell``) and ``roofline``: a
  ``core.roofline.RooflineReport`` row on ``core.hw.H100_SXM``.

One step is built and run per (arch, shape): both meshes reuse its counts
(``counts_reused``), since only the placements differ. The reference's
``lower_s``/``compile_s`` are ``build_s`` here (this cell's specs, step
and counted run; ``counted_s`` is the counted run's own time); its HLO-derived ``*_adjusted`` fields and XLA's memory analysis have
no counterpart. The counts divide the global step evenly over the chips,
where the reference reads each partition's SPMD counts from XLA.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as configs
from repro_torch.configs.base import cell_is_runnable
from repro_torch.core import msm
from repro_torch.core.hw import H100_SXM
from repro_torch.core.roofline import RooflineReport, model_flops_lm, useful_flops_cell
from repro_torch.launch.specs import (StandInMesh, argument_bytes, input_specs,
                                      local_nbytes, optim_config_for, shape_of)
from repro_torch.models import moe as moe_mod
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.sharding.partition import mesh_sizes
from repro_torch.train import make_train_step

ACT_BYTES = 2                    # bf16 activations
# blocks whose forward runs again in the backward under remat
REMAT_GROUPS = ("layers", "dense_layers", "enc_layers", "shared_attn")


def production_mesh(multi_pod: bool = False) -> StandInMesh:
    """Stand-ins of the reference's production meshes (256 and 512 chips)."""
    if multi_pod:
        return StandInMesh((2, 16, 16), ("pod", "data", "model"))
    return StandInMesh((16, 16), ("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _batch_group(sizes: dict) -> int:
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _clamp_microbatches(policy_mb: int, gb: int, mesh) -> int:
    """Largest mb <= policy that leaves an integer per-shard batch."""
    per_shard = max(gb // _batch_group(mesh_sizes(mesh)), 1)
    mb = min(policy_mb, per_shard)
    while per_shard % mb:
        mb -= 1
    return max(mb, 1)


def build_step(kind: str, model, policy, shape, microbatches: int = 1):
    """The cell's step as a function of its ``input_specs`` arguments. A
    training step updates its parameters and state in place (the
    reference's donation); a decode step runs one token at position
    ``seq_len - 1``, against the whole cache."""
    if kind == "train":
        return make_train_step(model, optim_config_for(policy), policy.grad_compression,
                               microbatches=microbatches)
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


class StepCounter(TorchDispatchMode):
    """Counts the bytes of every non-view aten op's tensor inputs and
    outputs, and the peak of the live bytes of the storages the ops make.
    The arguments' storages (``args``) are not the step's: an in-place
    update writes them, and they are counted apart."""

    def __init__(self, args):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        # held, so that no argument's storage id is reused during the run
        self._args = {id(s): s for s in (t.untyped_storage() for t in _tensors(args))}
        self._live: set[int] = set()

    def _release(self, key: int, n: int) -> None:
        self.live -= n
        self._live.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs)) + outs
                              if isinstance(t, torch.Tensor))
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
    flops: float        # the whole step's
    bytes: float
    temp_peak: float    # peak live bytes of the step's own storages
    seconds: float      # the counted run


_COUNTED: dict = {}


def count_step(step_fn, args) -> StepCounts:
    """FLOPs, bytes and peak temporaries of one run of ``step_fn(*args)``."""
    t0 = time.perf_counter()
    counter = StepCounter(args)
    with FlopCounterMode(display=False) as flops, counter:
        step_fn(*args)
    return StepCounts(float(flops.get_total_flops()), float(counter.bytes),
                      float(counter.peak), time.perf_counter() - t0)


# --------------------------------------------------------------------------------
# collectives, analytic from the placements
# --------------------------------------------------------------------------------

def _leaves(tree, path=()):
    for k in sorted(tree.keys()):
        v = tree[k]
        yield from _leaves(v, path + (k,)) if hasattr(v, "keys") else [(path + (k,), v)]


def _spec_axes(spec) -> set:
    axes = set()
    for e in spec:
        axes.update(() if e is None else ((e,) if isinstance(e, str) else e))
    return axes


def _weight_uses(cfg, path) -> tuple[bool, int, bool]:
    """(read replicated on every dim, uses in one forward, inside a
    rematerialized block) of the parameter at ``path``."""
    replicated = path[0] == "emb" or "mixer" in path or path[-1] == "router"
    uses = 1
    if path[0] == "shared_attn":
        uses = cfg.n_layers // cfg.attn_every
    if path == ("emb", "embedding") and cfg.tie_embeddings:
        uses = 2                    # the embedding gather and the LM head
    return replicated, uses, path[0] in REMAT_GROUPS


def _sp_sites(cfg, kind: str, seq: int) -> list[tuple[int, int]]:
    """(sites, sequence length) of the sequence-parallel sites (attention,
    FFN, mixer) in one forward."""
    dec = 1 if kind == "decode" else seq
    if cfg.family == "audio":
        enc = [] if kind == "decode" else [(2 * cfg.n_encoder_layers, seq)]
        return enc + [(3 * cfg.n_layers, 1 if kind == "decode" else seq // 4)]
    if cfg.family == "ssm":
        return [(cfg.n_layers, dec)]
    if cfg.family == "hybrid":
        return [(cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every), dec)]
    return [(2 * cfg.n_layers, dec)]


def collective_terms(cfg, kind: str, shape, policy, microbatches: int, args,
                     shardings, mesh) -> dict:
    """Per-device bytes of each collective term of one step (see the module
    docstring), keyed ``<term>_<kind>``."""
    sizes = mesh_sizes(mesh)
    nd, nm, np_ = sizes.get("data", 1), sizes.get("model", 1), sizes.get("pod", 1)
    nb = np_ * nd
    train = kind == "train"
    mb = microbatches if train else 1
    remat = train and policy.remat != "none"
    terms = {k: 0.0 for k in ("fsdp_all_gather", "grad_reduce_scatter", "grad_all_reduce",
                              "sp_all_gather", "sp_reduce_scatter", "sp_all_reduce",
                              "moe_all_gather", "moe_reduce_scatter", "moe_all_reduce")}

    # weights: gathers at each use, gradients at each use
    params, param_sh = args[0], shardings[0]
    flat_sh = dict(_leaves(param_sh))
    for path, p in _leaves(params):
        sh = flat_sh[path]
        local = local_nbytes(p, sh)
        axes = _spec_axes(sh.spec)
        replicated, uses, in_block = _weight_uses(cfg, path)
        on_data = "data" in axes
        if replicated:
            shards = math.prod(sizes[a] for a in axes)
            gather = (shards - 1) * local
            full_over_data = local * (sizes["model"] if "model" in axes else 1)
        else:
            gather = (nd - 1) * local if on_data else 0
            full_over_data = local
        passes = 1 + (remat and in_block)
        terms["fsdp_all_gather"] += mb * uses * passes * gather
        if not train:
            continue
        # the gradient a device holds is full_over_data x nd before the
        # "data" reduction where the weight is sharded over it, and
        # full_over_data after it either way
        if on_data:
            terms["grad_reduce_scatter"] += mb * uses * (nd - 1) * full_over_data
        else:
            terms["grad_all_reduce"] += mb * uses * 2 * (nd - 1) / nd * full_over_data
        terms["grad_all_reduce"] += mb * uses * 2 * (np_ - 1) / np_ * full_over_data

    # sequence parallel around each attention, FFN and mixer
    rows = shape.global_batch // mb
    rows = rows // nb if rows % nb == 0 else rows
    passes = (2 + remat) if train else 1
    for sites, s in _sp_sites(cfg, kind, shape.seq_len):
        x = rows * s * cfg.d_model * ACT_BYTES
        moved = mb * passes * sites * (nm - 1) / nm * x
        if s % nm == 0:
            terms["sp_all_gather"] += moved
            terms["sp_reduce_scatter"] += moved
        else:
            terms["sp_all_reduce"] += 2 * moved
    if train:
        s = shape.seq_len // 4 if cfg.family == "audio" else shape.seq_len
        if s % nm == 0:
            x = rows * s * cfg.d_model * ACT_BYTES
            terms["sp_all_gather"] += mb * (nm - 1) / nm * x
            terms["sp_reduce_scatter"] += mb * (nm - 1) / nm * x

    # the MoE's routing decisions, token rows and expert grid
    if cfg.family == "moe":
        n_moe = cfg.n_layers - cfg.first_k_dense
        t = shape.global_batch // mb * (1 if kind == "decode" else shape.seq_len)
        e, d = cfg.n_experts, cfg.d_model
        cap = moe_mod._capacity(t, cfg)
        grid = e * cap * d * ACT_BYTES
        g = (nm if e % nm == 0 else 1) * (nd if cap % nd == 0 else 1)
        tokens = t * d * ACT_BYTES
        fwd_passes = 1 + remat
        per_pass_gather = ((nb - 1) / nb * (t * cfg.top_k * 8 + tokens)
                           + (1 - 1 / g) * grid)
        terms["moe_all_gather"] += mb * n_moe * fwd_passes * per_pass_gather
        terms["moe_all_reduce"] += mb * n_moe * fwd_passes * 2 * 2 * (nb - 1) / nb * e * 4
        if train:
            terms["moe_reduce_scatter"] += mb * n_moe * (nb - 1) / nb * (tokens + grid)
            if e % nm == 0:
                terms["moe_all_reduce"] += mb * n_moe * 2 * (nm - 1) / nm * tokens / nb
    return terms


def by_kind(terms: dict) -> dict:
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    for name, v in terms.items():
        kind = name.split("_", 1)[1].replace("_", "-")
        out[kind] += v
    return out


# --------------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------------

def run_cell(arch: str, shape_name, multi_pod: bool = False, *, mesh=None,
             policy=None) -> dict:
    """One cell's record. ``shape_name``: a name of ``configs.SHAPES`` or a
    ``ShapeConfig``; ``mesh``: a stand-in mesh in place of the production
    one ``multi_pod`` picks; ``policy``: in place of ``msm.recommend``'s."""
    cfg = configs.get(arch)
    shape = shape_of(shape_name)
    mesh = mesh or production_mesh(multi_pod)
    base = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mesh)}
    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        return dict(base, status="skipped", reason=reason)

    t0 = time.perf_counter()
    policy = policy or msm.recommend(shape.name, cfg.n_params())
    kind, model, args, shardings = input_specs(cfg, shape, mesh, policy)
    mb = (_clamp_microbatches(policy.microbatches, shape.global_batch, mesh)
          if kind == "train" else 1)
    key = (cfg.name, shape, policy, mb)
    reused = key in _COUNTED
    if not reused:
        _COUNTED[key] = count_step(build_step(kind, model, policy, shape, mb), args)
    counts = _COUNTED[key]

    chips = mesh.size()
    arg_bytes = argument_bytes(args, shardings)
    terms = collective_terms(cfg, kind, shape, policy, mb, args, shardings, mesh)
    coll = sum(terms.values())
    peak = arg_bytes + counts.temp_peak / chips
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    useful = useful_flops_cell(cfg, shape)
    report = RooflineReport(arch=arch, shape=shape.name, mesh=base["mesh"], chips=chips,
                            hlo_flops=counts.flops / chips, hlo_bytes=counts.bytes / chips,
                            collective_bytes=coll, model_flops=useful,
                            peak_memory_bytes=peak, collective_breakdown=by_kind(terms))
    return dict(
        base,
        status="ok",
        step=kind,
        policy=policy.name,
        chips=chips,
        microbatches=mb,
        build_s=round(time.perf_counter() - t0, 1),
        counted_s=round(counts.seconds, 1),
        counts_reused=reused,
        flops_per_device=counts.flops / chips,
        bytes_per_device=counts.bytes / chips,
        argument_bytes_per_device=arg_bytes,
        temp_bytes_per_device=counts.temp_peak / chips,
        peak_memory_per_device=peak,
        fits=peak <= H100_SXM.hbm_capacity,
        collective_bytes_per_device=coll,
        collectives={"by_kind": by_kind(terms), "by_term": terms},
        model_flops=model_flops_lm(cfg.n_active_params(), tokens, training=(kind == "train")),
        useful_flops=useful,
        roofline=report.row(),
    )


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
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{mesh_name(production_mesh(mp))}"
                if key in results and results[key].get("status") in ("ok", "skipped") \
                        and not args.force:
                    print(f"[cached] {key}: {results[key]['status']}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mp)
                except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
                    res = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(production_mesh(mp)),
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
                    print(f"  {res['status']}: {res.get('reason') or res.get('error')}",
                          flush=True)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\nSummary: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
