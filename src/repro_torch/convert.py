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
