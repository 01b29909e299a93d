"""Compile ``KernelFacts`` into analytic touch streams (``core.trace.Trace``).

As the reference's stream compiler, with a CUDA block where it had a grid
step:

- one Op per block (over every launch of the call), in block order;
- its reads: each input tile it walks, once a visit; its writes: each output
  tile it writes; a tile's bytes are those inside its tensor (a ragged tile
  is clipped), and tiles are named per tensor box
  (``<instance>.<tensor>#<box id>``), so the cache model sees tile-level
  reuse exactly and the stream's unique bytes are the tensors' bytes where
  the tiles cover them;
- its FLOPs: the visits of the facts' ``flops_walk`` times
  ``flops_per_visit`` (the tile-granular products).
"""
from __future__ import annotations

import numpy as np

from repro_torch.check.facts import KernelFacts
from repro_torch.core.trace import Trace

_PRECISION = {"bfloat16": "bf16", "float32": "fp32"}


def _tiles(prefix: str, walk) -> tuple[np.ndarray, list[str], np.ndarray, np.ndarray]:
    """(the visits' order by block, the tile names by visit in that order,
    their bytes, the sorted blocks)."""
    order = np.argsort(walk.block, kind="stable")
    boxes = np.concatenate([walk.start, walk.stop], axis=1)[order]
    uniq, inv = np.unique(boxes, axis=0, return_inverse=True)
    names = [f"{prefix}{walk.tensor}#{i}" for i in range(len(uniq))]
    inv = inv.reshape(-1)
    return order, [names[i] for i in inv], walk.clipped_bytes()[order], walk.block[order]


def append_kernel_ops(trace: Trace, facts: KernelFacts) -> None:
    """Append one Op per block of ``facts`` to ``trace``."""
    n = facts.n_blocks
    prefix = f"{facts.instance}."
    per_walk = []
    for w in facts.walks:
        _, names, nbytes, blocks = _tiles(prefix, w)
        bounds = np.searchsorted(blocks, np.arange(n + 1))
        per_walk.append((w.role, names, nbytes.tolist(), bounds))
    flops = np.bincount(facts.walk(facts.flops_walk).block, minlength=n) * facts.flops_per_visit
    precision = _PRECISION[facts.dtype]
    for blk in range(n):
        reads, writes = [], []
        for role, names, nbytes, bounds in per_walk:
            lo, hi = bounds[blk], bounds[blk + 1]
            (reads if role == "in" else writes).extend(zip(names[lo:hi], nbytes[lo:hi]))
        trace.emit(f"{prefix}b{blk}", float(flops[blk]), reads=reads, writes=writes,
                   precision=precision, parallelism=facts.threads)


def compile_trace(facts_list, name: str, kind: str = "inference") -> Trace:
    """One Trace for a kernel call (one ``KernelFacts``, or the several of
    a call: K2a and K2b, K4's two passes or its row-tile pass and combine)."""
    if isinstance(facts_list, KernelFacts):
        facts_list = [facts_list]
    trace = Trace(name=name, kind=kind)
    for facts in facts_list:
        append_kernel_ops(trace, facts)
    return trace
