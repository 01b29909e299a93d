"""Bottleneck execution-time model + the paper's Fig-2-style attribution.

Per kernel (trace Op):

    t_op = max(t_math, t_L2, t_UHB, t_DRAM) + t_launch

with an SM-occupancy factor applied to the GPM-internal rates (math, L2) —
a kernel that cannot fill the machine neither computes nor streams at full
rate, which is the paper's "SM underutilization" term. Off-die rates (UHB,
DRAM) saturate at much lower occupancy and are left unscaled.

Attribution follows the paper exactly: the cost of a component is the time
recovered by idealizing it, peeled in the paper's order:

    DRAM BW       = T(actual) - T(DRAM -> inf)
    Memory others = T(DRAM -> inf) - T(DRAM, L2, UHB -> inf)
    SM util       = T(all mem -> inf) - T(all mem -> inf, occupancy -> 1)
    Math          = the remainder (pure math at full occupancy)

The computation itself lives in :class:`repro_torch.core.sweep.TraceAnalysis` —
one shared, capacity-batched implementation for this class, ``msm.analyze``
and the :class:`~repro_torch.core.sweep.SweepEngine`. :class:`PerfModel` is the
single-trace facade kept for its established API.

The JAX reference package's module; :meth:`PerfModel.batch` takes the
suite's ``device`` (``None``: the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import copa as copa_mod
from repro_torch.core.cachesim import HierarchyTraffic, TouchStream
from repro_torch.core.hw import GpuSpec
from repro_torch.core.sweep import (  # noqa: F401
    LAUNCH_OVERHEAD_S,
    TraceAnalysis,
    bottleneck_of,
    geomean,
)
from repro_torch.core.trace import Trace


@dataclass
class PerfResult:
    trace_name: str
    spec_name: str
    time_s: float
    per_op_s: np.ndarray
    segments: dict[str, float] = field(default_factory=dict)
    dram_bytes: float = 0.0
    l3_bytes: float = 0.0
    uhb_bytes: float = 0.0

    @property
    def bottleneck(self) -> str:
        return bottleneck_of(self.segments)


class PerfModel:
    """Single-trace facade over :class:`~repro_torch.core.sweep.TraceAnalysis`.

    Capacity-batched traffic is cached inside the analysis, so sweeping many
    specs over one trace shares a single trace pass per new capacity set.
    """

    def __init__(self, trace: Trace, cyclic: bool = True,
                 analysis: TraceAnalysis | None = None):
        self.trace = trace
        self.cyclic = cyclic
        self.analysis = analysis if analysis is not None else TraceAnalysis(
            trace, cyclic=cyclic
        )
        self.stream: TouchStream = self.analysis.stream

    @classmethod
    def batch(cls, traces: list[Trace], cyclic: bool = True,
              device=None) -> list["PerfModel"]:
        """Suite-batched construction: one padded
        :class:`~repro_torch.core.sweep.SuiteAnalysis` builds every trace's
        stream in a single batched Mattson pass and shares the suite
        traffic cache, so the returned models run from warm state. Each
        model is bit-identical to ``PerfModel(trace)`` built alone."""
        from repro_torch.core.sweep import suite_analysis_for

        suite = suite_analysis_for(list(traces), cyclic=cyclic, device=device)
        return [cls(t, cyclic=cyclic, analysis=ta)
                for t, ta in zip(suite.traces, suite.analyses)]

    @property
    def flops(self) -> np.ndarray:
        return self.analysis.flops

    @property
    def parallelism(self) -> np.ndarray:
        return self.analysis.parallelism

    @property
    def is_tc(self) -> np.ndarray:
        return self.analysis.is_tc

    def traffic(self, spec: GpuSpec) -> HierarchyTraffic:
        return self.analysis.hierarchy(spec)

    # -- core time estimate ----------------------------------------------------
    def time(
        self,
        spec: GpuSpec,
        ideal_dram: bool = False,
        ideal_mem_other: bool = False,
        ideal_occupancy: bool = False,
        per_op: bool = False,
    ):
        return self.analysis.time(
            spec,
            ideal_dram=ideal_dram,
            ideal_mem_other=ideal_mem_other,
            ideal_occupancy=ideal_occupancy,
            per_op=per_op,
        )

    # -- paper-style outputs ---------------------------------------------------
    def run(self, spec: GpuSpec) -> PerfResult:
        t_act, segments = self.analysis.attribution(spec)
        tr = self.analysis.hierarchy(spec)
        return PerfResult(
            trace_name=self.trace.name,
            spec_name=spec.name,
            time_s=t_act,
            per_op_s=self.analysis.time(spec, per_op=True),
            segments=segments,
            dram_bytes=tr.dram.total,
            l3_bytes=tr.l3_bytes,
            uhb_bytes=tr.post_l2.total if tr.has_l3 else 0.0,
        )

    def energy(self, spec: GpuSpec) -> copa_mod.EnergyReport:
        return self.analysis.energy(spec)


def speedup(model: PerfModel, spec: GpuSpec, baseline: GpuSpec) -> float:
    return model.time(baseline) / model.time(spec)
