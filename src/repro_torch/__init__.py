"""PyTorch/CUDA port of the LM runtime, for one NVIDIA Hopper card.

The package mirrors the layout of the JAX reference package module by module
and function by function, so a reader finds each counterpart by name. It
imports ``torch`` only. Entry points take an explicit ``device`` and default
to the card: nothing here moves to the CPU on its own.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The card. Raises where there is none: the port never picks the CPU
    by itself, a caller has to ask for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; anything else is taken as given, and a CUDA
    device that is not there raises instead of falling back."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
