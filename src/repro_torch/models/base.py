"""Functional parameter machinery: specs -> init -> nested dicts of tensors.

Every module describes its parameters as a dict of :class:`P` specs carrying
shape, *logical axis names* and an initializer. ``init_params`` materializes
a nested dict of tensors; ``axes_tree`` yields the parallel tree of
logical-axis tuples. Layer stacks get a leading ``layers`` axis, as in the
JAX reference package: the forward pass loops over it in Python and indexes
``[i]``, so the parameter tree converts 1:1 between the two packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | small (0.006)
    scale: float | None = None  # override stddev

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


Specs = dict  # nested dict[str, P | Specs]


def stack_specs(specs: Specs, n: int, axis_name: str = "layers") -> Specs:
    """Add a leading stacked-layer dimension to every spec."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, P):
            out[k] = replace(v, shape=(n,) + v.shape, axes=(axis_name,) + v.axes)
        else:
            out[k] = stack_specs(v, n, axis_name)
    return out


def _init_one(generator: torch.Generator, p: P, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    std = p.scale if p.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if p.init == "small":
        std = 0.006
    # drawn in fp32 on the generator's own device, scaled in place (no second
    # fp32 tensor of the leaf's size), then moved and cast
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(std).to(device=device, dtype=dtype)


def init_params(specs: Specs, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Materialize ``specs`` in sorted-path order from one ``generator``
    (which may live on another device than the parameters) on ``device``
    (default: the card)."""
    device = resolve_device(device)

    def walk(s):
        return {k: (_init_one(generator, v, dtype, device) if isinstance(v, P)
                    else walk(v))
                for k, v in sorted(s.items())}

    return walk(specs)


def axes_tree(specs: Specs):
    def walk(s):
        return {k: (v.axes if isinstance(v, P) else walk(v)) for k, v in s.items()}

    return walk(specs)


def count_params(specs: Specs) -> int:
    total = 0
    for v in specs.values():
        total += math.prod(v.shape) if isinstance(v, P) else count_params(v)
    return total
