"""The port's analytic core: the paper's analytical machinery, the hardware
tables, the dry-run's three-term roofline and the software memory-system
policies.

    hw         — the paper's GPU and link tables, and the H100 spec
    copa       — Table V design space + energy model
    trace      — the tensor-granular access-trace IR
    stackdist  — LRU stack distances (Mattson), its batch pass also on the card
    cachesim   — L2 -> L3 -> DRAM hierarchy traffic model, its suite scan also
                 on the card
    sweep      — batched design-space sweep engine (TraceAnalysis/SweepEngine)
    perfmodel  — bottleneck time model + Fig-2 attribution (facade over sweep)
    roofline   — 3-term roofline over the dry-run's counts (``launch/dryrun``)
    msm        — software memory-system-module policies (``compose``,
                 ``recommend``) and the cache model's Fig-4 sweep (``analyze``)
"""
from repro_torch.core import (
    cachesim,
    copa,
    hw,
    msm,
    perfmodel,
    roofline,
    stackdist,
    sweep,
    trace,
)

__all__ = ["cachesim", "copa", "hw", "msm", "perfmodel", "roofline", "stackdist", "sweep",
           "trace"]
