"""The port's analytic core: the hardware tables, the dry-run's three-term
roofline and the software memory-system policies.

    hw        — the paper's GPU and link tables, and the H100 spec
    roofline  — 3-term roofline over the dry-run's counts (``launch/dryrun``)
    msm       — software memory-system-module policies (``compose``, ``recommend``)
    trace     — the tensor-granular access-trace IR (``check.streams`` builds it)
"""
from repro_torch.core import hw, msm, roofline, trace

__all__ = ["hw", "msm", "roofline", "trace"]
