"""Workload traces: MLPerf-proxy (paper Table III), HPC population (Fig 3),
and LM-architecture traces derived from ``repro_torch.configs`` (our 10 assigned
architectures run through the same COPA analysis). ``registry`` maps
scenario names -> trace factories across all three families for the sweep
engine, with the ``kernel.*`` streams of the port's Hopper kernels
(``kernels``) beside them. The JAX reference package's modules, on the
port's ``core.trace``, ``configs`` and ``check``."""
from repro_torch.workloads import common, hpc, kernels, lm, mlperf, registry

__all__ = ["common", "hpc", "kernels", "lm", "mlperf", "registry"]
