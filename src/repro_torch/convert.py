"""Parameter trees from the JAX reference package into the port.

The two packages keep the same keys and the same stacked shapes, so the
conversion is a change of container only. numpy has no bfloat16: a caller
holding bf16 parameters casts them to float32 first, and this side casts to
the dtype it is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree: dict, dtype=torch.float32, device=None) -> dict:
    """Nested dicts of float32 numpy arrays -> nested dicts of tensors of
    ``dtype`` on ``device`` (default: the card), for
    ``LanguageModel.load_params``."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"expected float32 arrays, got {arr.dtype}")
        return torch.tensor(arr).to(device=device, dtype=dtype)   # torch.tensor copies

    return walk(tree)


def opt_state_from_numpy(state: dict, moment_dtype=torch.float32, device=None) -> dict:
    """A reference optimizer state ``{"step", "mu", "nu"[, "master"][, "ef"]}``
    as numpy (float32 trees, an integer step) -> the port's, for
    ``train.apply_updates``: ``mu``/``nu`` in ``moment_dtype``, ``master``
    and ``ef`` in fp32, ``step`` an int32 scalar, all on ``device``
    (default: the card)."""
    device = resolve_device(device)
    out = {"step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                device=device),
           "mu": params_from_numpy(state["mu"], moment_dtype, device),
           "nu": params_from_numpy(state["nu"], moment_dtype, device)}
    for key in ("master", "ef"):
        if key in state:
            out[key] = params_from_numpy(state[key], torch.float32, device)
    return out
