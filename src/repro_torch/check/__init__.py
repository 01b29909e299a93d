"""repro_torch.check — static analysis of the port's Hopper kernels.

``check.facts`` builds ``KernelFacts`` (grid, cluster, threads, shared
memory, every block's tile walk with its masks, the products and their
accumulator) from the host-side plans the kernel wrappers launch;
``check.rules`` lints them (R1-R5 for ``sm_90a``); ``check.streams``
compiles them to ``core.trace.Trace`` touch streams; ``check.catalog`` is
the kernel x shape matrix; ``check.ptxas`` reads the build's register and
spill report. CLI: ``python -m repro_torch.check``.
"""
from repro_torch.check.facts import KernelFacts, Walk
from repro_torch.check.rules import RULES, Finding, run_rules
from repro_torch.check.streams import compile_trace

__all__ = ["RULES", "Finding", "KernelFacts", "Walk", "compile_trace", "run_rules"]
