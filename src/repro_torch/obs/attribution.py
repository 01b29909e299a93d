"""Bottleneck attribution: WHY each sweep cell costs what it costs.

:func:`explain` runs the same deduplicated (workload x config x GPU-count)
grid as :meth:`~repro_torch.core.sweep.SweepEngine.run`, but keeps the per-op
resource components (:meth:`~repro_torch.core.sweep.SuiteAnalysis
.component_batch`) instead of collapsing them: every op is *bound* by the
resource whose component time wins the max, so each cell decomposes into
time bound by math / LLC / UHB / DRAM (plus the ICI collective for
scale-out training). The report ranks resources per cell, quotes the
binding margin (top resource over runner-up — how close the cell is to
tipping), and exports a plot-ready roofline JSON (arithmetic intensity vs
achieved throughput against each config's compute/DRAM ceilings).

The report's ``schema`` names are the reference's, so the two packages'
JSON documents compare equal key for key.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.sweep import (
    LAUNCH_OVERHEAD_S,
    TIME_COMPONENTS,
    SweepEngine,
    _as_spec,
    _config_name,
    _dram_cap,
    ring_allreduce_time,
)

RESOURCES = TIME_COMPONENTS + ("ici",)


def _json_margin(margin: float) -> float | None:
    """inf margins (single-resource cells) are not valid JSON numbers."""
    return None if not np.isfinite(margin) else float(margin)


@dataclass(frozen=True)
class CellExplain:
    """One (workload, config, n_gpus) cell of the attribution grid."""

    workload: str
    config: str
    n_gpus: int
    kind: str
    time_s: float                  # total: per-op bottleneck sum + ici
    bound_s: dict[str, float]      # resource -> seconds of ops it binds
    bound_ops: dict[str, int]      # resource -> number of ops it binds
    flops: float                   # total FLOPs of the per-GPU trace
    dram_bytes: float              # DRAM traffic of the per-GPU trace

    @property
    def bottleneck(self) -> str:
        return max(self.bound_s, key=self.bound_s.get)

    @property
    def margin(self) -> float:
        """Top resource's bound time over the runner-up's — 1.0 means a
        dead heat, inf means every second is bound by one resource."""
        ts = sorted(self.bound_s.values(), reverse=True)
        return ts[0] / ts[1] if ts[1] > 0 else float("inf")

    @property
    def shares(self) -> dict[str, float]:
        tot = sum(self.bound_s.values())
        return {r: (v / tot if tot > 0 else 0.0)
                for r, v in self.bound_s.items()}

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.dram_bytes if self.dram_bytes > 0 \
            else float("inf")

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.time_s / 1e12 if self.time_s > 0 else 0.0

    def to_json(self) -> dict:
        return {
            "workload": self.workload,
            "config": self.config,
            "n_gpus": self.n_gpus,
            "kind": self.kind,
            "time_s": self.time_s,
            "bottleneck": self.bottleneck,
            "margin": _json_margin(self.margin),
            "bound_s": dict(self.bound_s),
            "bound_ops": dict(self.bound_ops),
            "shares": self.shares,
            "arithmetic_intensity": _json_margin(self.arithmetic_intensity),
            "achieved_tflops": self.achieved_tflops,
        }


@dataclass
class ExplainReport:
    """The full attribution grid plus the spec peaks a roofline needs."""

    cells: list[CellExplain]
    peaks: dict[str, dict[str, float]] = field(default_factory=dict)

    def cell(self, workload: str, config: str,
             n_gpus: int = 1) -> CellExplain:
        for c in self.cells:
            if (c.workload == workload and c.config == config
                    and c.n_gpus == n_gpus):
                return c
        raise KeyError(f"no cell ({workload!r}, {config!r}, n={n_gpus})")

    @property
    def workloads(self) -> list[str]:
        seen: dict[str, None] = {}
        for c in self.cells:
            seen.setdefault(c.workload)
        return list(seen)

    @property
    def configs(self) -> list[str]:
        seen: dict[str, None] = {}
        for c in self.cells:
            seen.setdefault(c.config)
        return list(seen)

    def table(self) -> str:
        """Text table: one row per cell, the resource ranking inline."""
        rows = []
        hdr = (f"{'workload':<28s} {'config':<18s} {'n':>3s} "
               f"{'time':>10s} {'bound by':<8s} {'margin':>7s}  shares")
        rows.append(hdr)
        rows.append("-" * len(hdr))
        for c in self.cells:
            shares = c.shares
            ranked = sorted((r for r in RESOURCES if shares.get(r, 0) > 0),
                            key=lambda r: -shares[r])
            share_txt = "  ".join(f"{r}:{shares[r]:.0%}" for r in ranked)
            mg = c.margin
            mg_txt = f"{mg:7.2f}" if np.isfinite(mg) else "    inf"
            rows.append(
                f"{c.workload:<28.28s} {c.config:<18.18s} {c.n_gpus:>3d} "
                f"{c.time_s:9.4g}s {c.bottleneck:<8s} {mg_txt}  {share_txt}")
        return "\n".join(rows)

    def roofline(self) -> dict:
        """Plot-ready roofline: per-config compute/DRAM ceilings plus one
        (AI, achieved TFLOP/s) point per cell."""
        return {
            "schema": "repro.obs.roofline/v1",
            "ceilings": {
                name: {
                    "fp16_tflops": pk["fp16_tflops"],
                    "fp32_tflops": pk["fp32_tflops"],
                    "dram_gbps": pk["dram_bandwidth"] / 1e9,
                    # the memory roof: achievable TFLOP/s at intensity AI is
                    # min(peak, AI * dram_bw) — the knee sits at
                    # peak_flops / dram_bw flop-per-byte.
                    "knee_flop_per_byte":
                        pk["fp16_tflops"] * 1e12 / pk["dram_bandwidth"],
                }
                for name, pk in self.peaks.items()
            },
            "points": [
                {
                    "workload": c.workload,
                    "config": c.config,
                    "n_gpus": c.n_gpus,
                    "ai_flop_per_byte": _json_margin(c.arithmetic_intensity),
                    "achieved_tflops": c.achieved_tflops,
                    "bottleneck": c.bottleneck,
                }
                for c in self.cells
            ],
        }

    def to_json(self) -> dict:
        return {
            "schema": "repro.obs.explain/v1",
            "resources": list(RESOURCES),
            "cells": [c.to_json() for c in self.cells],
            "roofline": self.roofline(),
        }


def explain_engine(engine: SweepEngine) -> ExplainReport:
    """Attribution over an existing engine's grid. Mirrors
    :meth:`SweepEngine.run`'s dedup loop (same workload expansion, same
    trace-identity sharing), but reduces the per-op component stack with
    argmax instead of max: each op's whole bottleneck time (launch overhead
    included) is charged to the resource that binds it, so per-cell
    ``sum(bound_s.values()) == time_s`` exactly."""
    specs = [(_config_name(c), _as_spec(c)) for c in engine.configs]
    spec_objs = [spec for _, spec in specs]

    jobs = []
    index: dict[int, int] = {}
    suite_traces = []
    for w in engine.workloads:
        trace1 = w.trace_for(1)
        per_n = [(n, trace1 if n == 1 else w.trace_for(n))
                 for n in engine.gpu_counts]
        jobs.append((w, per_n))
        for _, t in per_n:
            if id(t) not in index:
                index[id(t)] = len(suite_traces)
                suite_traces.append(t)
    suite = engine.suite_analysis(suite_traces)

    comp = suite.component_batch(spec_objs)     # (4, n_specs, n_ops)
    binding = comp.argmax(axis=0)               # ties -> first (math first)
    t_op = comp.max(axis=0) + LAUNCH_OVERHEAD_S
    dram_bytes = {_dram_cap(spec): suite.totals_below(_dram_cap(spec))
                  for _, spec in specs}

    cells: list[CellExplain] = []
    for w, per_n in jobs:
        for n, trace_n in per_n:
            i = index[id(trace_n)]
            ta = suite.analyses[i]
            sl = suite.op_slice(i)
            flops = float(suite.flops[sl].sum())
            coll = ring_allreduce_time(
                ta.grad_bytes, n, engine.ici_bandwidth, engine.ici_latency_s
            ) if trace_n.kind == "training" else 0.0
            for j, (name, spec) in enumerate(specs):
                b = binding[j, sl]
                t = t_op[j, sl]
                bound_s = {r: float(t[b == k].sum())
                           for k, r in enumerate(TIME_COMPONENTS)}
                bound_ops = {r: int((b == k).sum())
                             for k, r in enumerate(TIME_COMPONENTS)}
                bound_s["ici"] = coll
                bound_ops["ici"] = 1 if coll > 0 else 0
                cells.append(CellExplain(
                    workload=w.name, config=name, n_gpus=n,
                    kind=trace_n.kind, time_s=float(t.sum()) + coll,
                    bound_s=bound_s, bound_ops=bound_ops, flops=flops,
                    dram_bytes=float(dram_bytes[_dram_cap(spec)][i]),
                ))

    peaks = {name: {"fp16_tflops": spec.fp16_tflops,
                    "fp32_tflops": spec.fp32_tflops,
                    "dram_bandwidth": spec.dram_bandwidth}
             for name, spec in specs}
    return ExplainReport(cells=cells, peaks=peaks)


def explain(workloads, configs=None, **engine_kw) -> ExplainReport:
    """Build a :class:`SweepEngine` over ``workloads`` x ``configs`` (same
    defaults: Table V configs, GPU-N baseline, scenario-name globs expand
    through the registry) and attribute every cell. ``engine_kw`` passes
    through — ``gpu_counts``, ``ici_bandwidth``, ``ici_latency_s``,
    ``device``, ... Without ``device`` the suite's scans run on the card,
    and raise where there is none; ``device="cpu"`` runs the NumPy scans."""
    return explain_engine(SweepEngine(workloads, configs, **engine_kw))
