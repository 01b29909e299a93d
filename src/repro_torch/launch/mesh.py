"""Mesh construction: the counterpart of the reference's
``launch/mesh.py:make_compat_mesh`` and ``make_host_mesh``, over
``torch.distributed``.

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device.

Where no default process group exists, ``make_compat_mesh`` (and so
``make_host_mesh``) starts one:

* under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment), from its
  environment;
* otherwise a group of this one process, from a ``FileStore`` in a fresh
  temporary directory, so one process needs no launcher and no free port.

NCCL on the card, gloo for ``device="cpu"``. A launcher of several ranks
that rendezvous another way (the multi-rank CPU tests use a ``FileStore``
of their own) starts the group itself before calling it.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import resolve_device

DIM_NAMES = ("data", "model")


def _shutdown(store_dir: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)


def _start_group(device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        return
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    atexit.register(_shutdown, store_dir)


def mesh_device(mesh) -> torch.device:
    """The torch device a mesh's local shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_compat_mesh(shape, axes, device=None):
    """A device mesh of ``shape`` with the dim names ``axes`` (a one-axis
    ``("pipe",)`` mesh, say) over every rank of the default process group,
    started here where there is none. ``device``: the card by default (an
    error without one), ``"cpu"`` for a gloo mesh."""
    device = resolve_device(device)
    if not dist.is_initialized():
        _start_group(device)
    shape, world = tuple(shape), dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=tuple(axes))


def make_host_mesh(data: int | None = None, model: int = 1, device=None):
    """A ``("data", "model")`` device mesh over every rank of the default
    process group, started here where there is none; ``data`` defaults to
    the world size over ``model``. ``device``: as ``make_compat_mesh``'s."""
    device = resolve_device(device)
    if not dist.is_initialized():
        _start_group(device)
    return make_compat_mesh((data or dist.get_world_size() // model, model), DIM_NAMES, device)
