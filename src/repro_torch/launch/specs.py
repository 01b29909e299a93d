"""Abstract inputs for the dry-run: ``meta`` tensors beside their placements.

The counterpart of the reference's ``launch/specs.py``, where an abstract
value is a ``jax.ShapeDtypeStruct`` carrying its ``NamedSharding``. Here it
is a ``meta`` tensor (shape and dtype, no storage) beside the
``sharding.partition.NamedSharding`` that would place it: ``input_specs``
returns the step's arguments as trees of ``meta`` tensors at their global
shapes and, parallel to them, trees of shardings. The placement rules read
only a mesh's dim names and sizes, so ``input_specs`` takes a
``DeviceMesh`` or a ``StandInMesh`` (those two things, no devices, no
process group); ``on_mesh`` turns the trees into ``DTensor``s on a
``DeviceMesh`` (``launch.dryrun`` runs its steps on them).

The step's arguments, as the port's steps take them:

* train: ``(params, opt_state, batch)``; the optimizer state comes from the
  port's own ``init_opt_state`` on the ``meta`` parameters, each leaf
  placed as its parameter, the step counter replicated. The reference's
  ``rng`` argument has no counterpart (a ``torch.Generator`` drives
  stochastic rounding, and ``optim_config_for`` turns it off).
* prefill: ``(params, batch)``.
* decode: ``(params, cache, tokens)``; the position is a host int
  (``seq_len - 1``: one token against a full cache), where the reference
  passes an int32 scalar and an ``rng``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

import repro_torch.configs as configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import msm
from repro_torch.models import LanguageModel
from repro_torch.models.base import abstract_params
from repro_torch.sharding.partition import (NamedSharding, batch_spec, cache_shardings,
                                            mesh_sizes, param_shardings)
from repro_torch.train import OptimConfig, init_opt_state
from repro_torch.train.optim import state_shardings

VLM_PATCHES = 256
WHISPER_ENC_LEN = 1500
# the policies' attention_impl (the reference's names) -> the port's IMPLS:
# the reference's chunked and Pallas paths are the port's kernel path; on
# meta tensors K1 and K2 are counted as the kernels run (``kernels.ops``'s
# custom ops: O(S) memory, as the reference's chunked attention), their
# FLOPs those of the plain versions' every (query, key) pair (``launch/dryrun``)
IMPL_OF = {"naive": "naive", "chunked": "kernel", "pallas": "kernel"}


@dataclass(frozen=True)
class StandInMesh:
    """What the placement rules read of a ``DeviceMesh``: its dim names and
    sizes (``partition.mesh_sizes``). No devices, no process group: the
    placements on the reference's production meshes, computed where no
    group of their size can start, and the shape of the mesh
    ``launch.dryrun.fake_mesh`` builds."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...] = ("data", "model")

    def size(self) -> int:
        return math.prod(self.shape)


def shape_of(shape) -> ShapeConfig:
    """A ``ShapeConfig``, or the name of one of ``configs.SHAPES``."""
    return configs.SHAPES[shape] if isinstance(shape, str) else shape


def model_for(cfg: ModelConfig, shape: ShapeConfig, policy=None) -> LanguageModel:
    """The model the policy asks for. A training step scans Mamba-2 layers
    with the naive chunked scan (K5 has no backward), as ``launch/train``."""
    policy = policy or msm.recommend(shape.name, cfg.n_params())
    impl = IMPL_OF[policy.attention_impl]
    return LanguageModel(cfg, impl=impl, remat=policy.remat,
                         scan="naive" if shape.step == "train" else impl)


def abstract_model_params(model: LanguageModel, mesh, fsdp: bool = True):
    """``(params, shardings)``: the model's parameters as ``meta`` bf16
    tensors and their ``NamedSharding``s."""
    aparams = abstract_params(model.specs())
    return aparams, param_shardings(model.axes(), aparams, mesh, fsdp=fsdp)


def optim_config_for(policy) -> OptimConfig:
    return OptimConfig(
        moment_dtype="bfloat16" if policy.optimizer_dtype == "bfloat16" else "float32",
        master_weights=policy.master_weights,
        # RTN updates in the capacity-specialized recipe, as the reference:
        # the SR path costs a params-sized random temporary per step
        stochastic_rounding=False,
    )


def abstract_opt_state(params, opt_cfg: OptimConfig, param_sh, mesh, grad_compression=None):
    """``(state, shardings)``: the port's ``init_opt_state`` run on the
    ``meta`` parameters, and shardings that mirror the parameters' (the
    error-feedback buffers too), the step counter replicated."""
    state = init_opt_state(params, opt_cfg, grad_compression)
    shardings = state_shardings(param_sh, opt_cfg, mesh)
    if "ef" in state:
        shardings["ef"] = param_sh
    return state, shardings


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch, shape, mesh, policy=None):
    """Returns ``(kind, model, args, shardings)`` for the cell: ``args`` the
    step's arguments as trees of ``meta`` tensors (the parameters loaded
    into ``model``), ``shardings`` the parallel trees of ``NamedSharding``s.
    ``arch``: a config or its name; ``shape``: a ``ShapeConfig`` or the name
    of one of ``configs.SHAPES``."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    shape = shape_of(shape)
    policy = policy or msm.recommend(shape.name, cfg.n_params())
    model = model_for(cfg, shape, policy)
    gb, seq = shape.global_batch, shape.seq_len
    bsh = NamedSharding(mesh, batch_spec(mesh))
    tok = torch.int32

    fsdp = policy.serve_fsdp if shape.step != "train" else True
    aparams, param_sh = abstract_model_params(model, mesh, fsdp=fsdp)
    model.load_params(aparams)
    params = model.params

    if shape.step in ("train", "prefill"):
        keys = ("tokens", "labels", "positions") if shape.step == "train" else ("tokens",
                                                                                 "positions")
        batch = {k: _meta((gb, seq), tok) for k in keys}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = _meta((gb, VLM_PATCHES, cfg.d_model), torch.bfloat16)
        if cfg.family == "audio":
            # the decoder reads a quarter of the frames' length (its positions
            # stay the frames', as in the reference; the forward makes its own)
            batch["frames"] = _meta((gb, seq, cfg.d_model), torch.bfloat16)
            for k in ("tokens", "labels"):
                if k in batch:
                    batch[k] = _meta((gb, seq // 4), tok)
        batch_sh = {k: bsh for k in batch}
        if shape.step == "prefill":
            return "prefill", model, (params, batch), (param_sh, batch_sh)
        opt_state, opt_sh = abstract_opt_state(params, optim_config_for(policy), param_sh, mesh,
                                               policy.grad_compression)
        return "train", model, (params, opt_state, batch), (param_sh, opt_sh, batch_sh)

    # decode: one new token against a seq_len cache, int8 where the policy
    # asks for it (the SSM state stays fp32, as init_cache makes it)
    shard_seq = policy.kv_shard_axis == "data" or gb == 1
    kv_dtype = torch.int8 if policy.kv_cache_dtype == "int8" else torch.bfloat16
    cache = model.init_cache(gb, seq, dtype=kv_dtype, device="meta", enc_len=WHISPER_ENC_LEN)
    cache_sh = cache_shardings(cache, mesh, shard_seq=shard_seq)
    tokens = _meta((gb, 1), tok)
    tokens_sh = bsh if gb > 1 else NamedSharding(mesh, ())
    return "decode", model, (params, cache, tokens), (param_sh, cache_sh, tokens_sh)


def local_shape(shape, sharding: NamedSharding) -> tuple[int, ...]:
    """The largest local shard of a tensor of ``shape`` under ``sharding``:
    a dim named by mesh axes is divided by the product of their sizes
    (rounded up, as ``DTensor`` gives the first rank the larger part); a
    spec shorter than the tensor replicates the trailing dims."""
    sizes = mesh_sizes(sharding.mesh)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        out.append(-(-dim // math.prod(sizes[a] for a in axes)))
    return tuple(out)


def local_nbytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    return math.prod(local_shape(tuple(t.shape), sharding)) * t.element_size()


def on_mesh(args, shardings):
    """The parallel trees ``args`` (``meta`` tensors at their global shapes)
    and ``shardings`` (``NamedSharding``s on a ``DeviceMesh``) as trees of
    ``DTensor``s: each leaf this rank's local shard, a ``meta`` tensor of
    ``local_shape`` (the first rank's, which is the dry-run's rank 0), in
    its sharding's placements. ``from_local`` is given the global shape and
    stride and checks nothing, so building them issues no collective."""
    if isinstance(args, (tuple, list)):
        return type(args)(on_mesh(a, s) for a, s in zip(args, shardings))
    if hasattr(args, "keys"):
        return {k: on_mesh(args[k], shardings[k]) for k in args.keys()}
    local = torch.empty(local_shape(tuple(args.shape), shardings), dtype=args.dtype,
                        device="meta")
    return DTensor.from_local(local, shardings.mesh, shardings.placements, run_check=False,
                              shape=args.shape, stride=args.stride())
