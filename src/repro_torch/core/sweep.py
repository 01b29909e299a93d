"""Batched design-space sweep engine: trace -> cache hierarchy -> perf/energy.

The paper's entire evaluation (Figs 2, 4, 8-12) is one shape of computation:
every workload trace replayed against every memory configuration. This module
is the single substrate for that shape:

* :class:`TraceAnalysis` — everything capacity-independent about one trace
  (the :class:`~repro_torch.core.cachesim.TouchStream`, per-op static vectors, the
  per-op L2 touch bytes) plus a capacity-keyed cache of
  :class:`~repro_torch.core.cachesim.LevelTraffic`. Missing capacities are computed
  in ONE vectorized :func:`~repro_torch.core.cachesim.traffic_below` call; since
  capacity columns are independent there, batching is bit-identical to
  evaluating capacities one at a time. The bottleneck time model evaluates a
  whole config list as one (config x op) matrix (:meth:`TraceAnalysis
  .time_batch`); the per-spec scalar loop survives as the
  :meth:`TraceAnalysis._reference_time` parity oracle. The paper's Fig-2
  attribution lives here too; ``repro_torch.core.perfmodel.PerfModel`` is a thin
  facade over this class.

* :class:`SuiteAnalysis` — the suite level: every member trace's stream
  padded into one :class:`~repro_torch.core.cachesim.StreamBatch`, traffic for a
  whole (trace x capacity) plane computed in one batched scan, and the
  bottleneck time model evaluated as a single (config x total-ops) matrix
  with per-trace slice sums — bit-identical, per trace, to the member
  :class:`TraceAnalysis` objects (whose caches it fills). Shared
  process-wide through :func:`suite_analysis_for`.

* :class:`SweepEngine` — evaluates a grid of (trace x config x extra LLC
  capacity x GPU count) in ONE suite pass (``run()``; the original
  per-trace loop survives as ``run(batched=False)``, the bit-for-bit
  parity oracle): the union of every capacity any config touches is
  prefetched in a single batched traffic call, then every config is costed
  from the shared cache with one suite-wide matrix evaluation per
  attribution term. Configs may be
  :class:`~repro_torch.core.copa.CopaConfig` (``build()`` is called for you) or
  raw :class:`~repro_torch.core.hw.GpuSpec` (for bandwidth/capacity sensitivity
  sweeps like Figs 8-10). Workloads may be :class:`~repro_torch.core.trace.Trace`
  objects, scenario names resolved through ``repro_torch.workloads.registry``, or
  :class:`ScaleOutWorkload` families whose per-GPU trace depends on the
  instance count (the paper's Fig-12 fixed-global-batch scale-out).

* :class:`SweepResult` / :class:`SweepGrid` — structured rows (time,
  per-segment attribution, DRAM/L3/UHB bytes, energy, speedup vs baseline,
  scale-out terms: per-GPU vs collective time, throughput, scaling
  efficiency) with geomean and instances-to-target-throughput helpers over
  arbitrary trace subsets.

Scale-out model (paper Fig 12 / §V): ``n`` data-parallel GPU instances each
replay the per-GPU trace; training instances synchronize gradients with a
ring all-reduce over the inter-GPU fabric (``ici_bandwidth`` per direction,
:func:`ring_allreduce_time`). The default fabric is ideal (infinite
bandwidth), matching the paper's methodology of charging scale-out only for
the lost per-GPU batch efficiency; a finite bandwidth adds the collective
term to every training step.

The JAX reference package's module, with a ``device`` for the suite level.
:class:`SuiteAnalysis`, :func:`suite_analysis_for`, :func:`suite_append`,
:func:`suite_invalidate`, :func:`analysis_for`, :class:`SweepEngine`,
:func:`serve_cost_grids`, :func:`prefill_cost_per_token` and
:func:`kv_sweep_times` take ``device=None``, resolved by
``repro_torch.resolve_device``: missing, it is the card, and raises
without one; only ``device="cpu"`` runs the NumPy scans. On the card the
streams' Mattson passes and the suite's traffic scans run there
(``cachesim.build_streams``, ``cachesim.StreamBatch``). Every memo
(``_ANALYSES``, ``_SUITES``, the KV session) is keyed by where the scans
ran, so a card result and a host result are never mixed, not even through
the member analyses' caches a suite fills. The time model
(:func:`_bottleneck_time_matrix`), the per-trace :class:`TraceAnalysis`
path, ``_reference_time`` and ``run(batched=False)`` stay NumPy on the
host: they are the oracles.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Iterable, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import copa as copa_mod
from repro_torch.core.cachesim import (
    HierarchyTraffic,
    LevelTraffic,
    StreamBatch,
    TouchStream,
    _backend_key,
    build_stream,
    build_streams,
    scan_device,
    traffic_below,
)
from repro_torch.core.copa import CopaConfig, EnergyReport
from repro_torch.core.hw import GpuSpec
from repro_torch.core.trace import Trace

LAUNCH_OVERHEAD_S = 2.0e-6  # per-kernel launch/dependency latency

# Resource axis order of the component stack returned by
# ``components=True`` / :meth:`SuiteAnalysis.component_batch`
# (``repro_torch.obs.explain`` ranks per-cell bottlenecks from it).
TIME_COMPONENTS = ("math", "llc", "uhb", "dram")

# Math throughput class per trace precision.
_TENSOR_CORE = {"fp16", "bf16", "int8", "fp8"}

ConfigLike = Union[CopaConfig, GpuSpec]
TraceLike = Union[Trace, str]


def geomean(xs) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    return float(np.exp(np.log(xs).mean())) if len(xs) else float("nan")


def bottleneck_of(segments: dict[str, float]) -> str:
    """Dominant non-Math attribution segment ('Math' when nothing else)."""
    segs = {k: v for k, v in segments.items() if k != "Math"}
    return max(segs, key=segs.get) if segs else "Math"


def ring_allreduce_time(nbytes: float, n_gpus: int, bandwidth: float,
                        latency_s: float = 0.0) -> float:
    """Ring all-reduce step time: each GPU moves ``2(n-1)/n`` of the payload
    through its ``bandwidth`` (bytes/s per direction) link in ``2(n-1)``
    latency-bound steps. Zero for one GPU, nothing to reduce, or an ideal
    (infinite-bandwidth) fabric. A non-positive bandwidth is an error, not
    a free fabric — 0 cannot mean both 'no link' and 'ideal link'."""
    if bandwidth <= 0:
        raise ValueError(f"ici bandwidth must be > 0, got {bandwidth!r}")
    if n_gpus <= 1 or nbytes <= 0 or not np.isfinite(bandwidth):
        return 0.0
    return (2.0 * (n_gpus - 1) / n_gpus * nbytes / bandwidth
            + 2.0 * (n_gpus - 1) * latency_s)


def _as_spec(config: ConfigLike) -> GpuSpec:
    return config.build() if isinstance(config, CopaConfig) else config


def _config_name(config: ConfigLike) -> str:
    return config.name


def _resolve_trace(t: TraceLike) -> Trace:
    if isinstance(t, str):
        from repro_torch.workloads import registry  # lazy: workloads sit above core

        return registry.scenario(t)
    return t


def _dram_cap(spec: GpuSpec) -> float:
    """The LRU pool capacity DRAM sees for one spec (L2, or L2+L3)."""
    return float(spec.l2_capacity + spec.l3_capacity) if spec.l3_capacity \
        else float(spec.l2_capacity)


def _bottleneck_time_matrix(
    specs: Sequence[GpuSpec],
    flops: np.ndarray,
    is_tc: np.ndarray,
    occupancy_for,
    l2_touch: np.ndarray,
    uhb_rows,
    dram_rows,
    ideal_dram: bool,
    ideal_mem_other: bool,
    ideal_occupancy: bool,
    components: bool = False,
) -> np.ndarray:
    """THE bottleneck time model as one (config x op) matrix — the single
    implementation behind :meth:`TraceAnalysis.time_batch` (ops of one
    trace) and :meth:`SuiteAnalysis.time_batch` (a whole suite's global op
    axis); only the per-spec row sources differ, so the two can never
    drift apart. ``occupancy_for(spec)`` returns the per-op occupancy,
    ``uhb_rows(spec)`` the post-L2 (fill, writeback) rows and
    ``dram_rows(spec)`` the total DRAM-traffic row for the relevant
    capacities. Every step is elementwise per op column.
    ``TraceAnalysis._reference_time`` stays a deliberate per-spec copy —
    it is the parity oracle this matrix is tested against.

    With ``components=True`` the four per-resource pressure matrices are
    returned stacked as ``(4, n_specs, n_ops)`` in :data:`TIME_COMPONENTS`
    order, WITHOUT the launch overhead — ``stack.max(axis=0) + overhead``
    reproduces the default return exactly (asserted in tests)."""
    n_ops = len(flops)
    if ideal_occupancy:
        occ = np.ones((len(specs), n_ops))
    else:
        occ = np.stack([occupancy_for(sp) for sp in specs]) \
            if n_ops else np.ones((len(specs), 0))
    f_tc = np.array([sp.fp16_tflops for sp in specs])[:, None] * 1e12
    f_fp32 = np.array([sp.fp32_tflops for sp in specs])[:, None] * 1e12
    fmath = np.where(is_tc[None, :], f_tc, f_fp32) * occ
    flops_b = np.broadcast_to(flops[None, :], fmath.shape)
    t_math = np.divide(flops_b, fmath, out=np.zeros_like(fmath),
                       where=fmath > 0)

    if ideal_mem_other:
        t_l2 = np.zeros_like(fmath)
        t_uhb = np.zeros_like(fmath)
    else:
        l2_bw = np.array([sp.l2_bandwidth for sp in specs])[:, None]
        t_l2 = l2_touch[None, :] / (l2_bw * occ)
        has_uhb = np.array([bool(sp.l3_capacity) and sp.l3_bandwidth > 0
                            for sp in specs])
        if has_uhb.any():
            # UHB is per-direction (paper: 2xRD + 2xWR).
            l3_bw = np.array([sp.l3_bandwidth if u else 1.0
                              for sp, u in zip(specs, has_uhb)])[:, None]
            rows = [uhb_rows(sp) for sp in specs]
            fill = np.stack([r[0] for r in rows])
            wb = np.stack([r[1] for r in rows])
            t_uhb = np.where(has_uhb[:, None],
                             np.maximum(fill / l3_bw, wb / l3_bw), 0.0)
        else:
            t_uhb = np.zeros_like(fmath)

    if ideal_dram:
        t_dram = np.zeros_like(fmath)
    else:
        dram_bw = np.array([sp.dram_bandwidth for sp in specs])[:, None]
        dram_tot = np.stack([dram_rows(sp) for sp in specs])
        t_dram = dram_tot / dram_bw

    if components:
        return np.stack([t_math, t_l2, t_uhb, t_dram])
    overhead = 0.0 if ideal_occupancy else LAUNCH_OVERHEAD_S
    return np.maximum.reduce([t_math, t_l2, t_uhb, t_dram]) + overhead


@dataclass(frozen=True)
class ScaleOutWorkload:
    """A workload family whose per-GPU trace depends on the instance count.

    ``trace_for(n)`` returns the trace ONE GPU replays when the workload is
    spread across ``n`` data-parallel instances. Fixed-global-batch training
    (paper Fig 12) shrinks the per-GPU batch as ``n`` grows (strong
    scaling); returning the same trace at every ``n`` models weak scaling
    (per-instance serving at fixed per-GPU load). ``trace_for(1)`` anchors
    the baseline time and throughput."""

    name: str
    trace_for: Callable[[int], Trace]


WorkloadLike = Union[Trace, str, ScaleOutWorkload]


def _as_workload(t: WorkloadLike) -> ScaleOutWorkload:
    if isinstance(t, ScaleOutWorkload):
        return t
    if isinstance(t, str):
        from repro_torch.workloads import registry  # lazy: workloads sit above core

        resolved = registry.resolve(t)
        if isinstance(resolved, ScaleOutWorkload):
            return resolved
        t = resolved
    if not isinstance(t, Trace):
        raise TypeError(
            f"not a sweepable workload: {t!r} (expected Trace, scenario "
            f"name, or ScaleOutWorkload — arrival specs drive "
            f"repro_torch.serve.sim, not the sweep engine)")
    trace = t
    return ScaleOutWorkload(name=trace.name, trace_for=lambda n: trace)


def _expand_workloads(traces: Iterable[WorkloadLike]) -> list[ScaleOutWorkload]:
    """Resolve every workload; glob-pattern strings expand through the
    registry to every matching scenario/scale-out name."""
    out: list[ScaleOutWorkload] = []
    for t in traces:
        if isinstance(t, str) and any(ch in t for ch in "*?["):
            from repro_torch.workloads import registry  # lazy

            out.extend(_as_workload(r) for r in registry.resolve(t))
        else:
            out.append(_as_workload(t))
    return out


class TraceAnalysis:
    """Capacity-independent analysis of one trace + shared traffic cache."""

    def __init__(self, trace: Trace, cyclic: bool = True,
                 stream: TouchStream | None = None):
        self.trace = trace
        self.cyclic = cyclic
        self.stream = stream if stream is not None else build_stream(trace, cyclic=cyclic)
        self.flops = np.array([op.flops for op in trace.ops])
        self.parallelism = np.array([op.parallelism for op in trace.ops])
        self.is_tc = np.array([op.precision in _TENSOR_CORE for op in trace.ops])
        self._levels: dict[float, LevelTraffic] = {}
        self._l2_touch: np.ndarray | None = None
        self._occ: dict[int, np.ndarray] = {}  # spec concurrency -> occupancy
        self._grad_bytes: float | None = None

    # -- traffic ---------------------------------------------------------------
    @property
    def l2_touch(self) -> np.ndarray:
        """Bytes served by the L2 per op (all touches, steady-state copy)."""
        if self._l2_touch is None:
            l2 = np.zeros(self.stream.n_ops)
            half = self.stream.second_half
            np.add.at(l2, self.stream.op_idx[half:], self.stream.sizes[half:])
            self._l2_touch = l2
        return self._l2_touch

    @property
    def grad_bytes(self) -> float:
        """Bytes all-reduced per iteration under data parallelism: the
        unique gradient tensors (``g.*``) this trace writes. Zero for
        inference traces (no gradients, instances are independent)."""
        if self._grad_bytes is None:
            seen: dict[str, int] = {}
            for op in self.trace.ops:
                for t, b in op.writes:
                    if t.startswith("g."):
                        seen[t] = max(seen.get(t, 0), b)
            self._grad_bytes = float(sum(seen.values()))
        return self._grad_bytes

    def prefetch(self, capacities: Iterable[float]) -> None:
        """Compute all not-yet-cached capacities in one batched trace pass."""
        missing = sorted({float(c) for c in capacities} - self._levels.keys())
        if missing:
            for cap, lt in zip(missing, traffic_below(self.stream, missing)):
                self._levels[cap] = lt

    def level_traffic(self, capacity: float) -> LevelTraffic:
        self.prefetch([capacity])
        return self._levels[float(capacity)]

    def dram_traffic(self, capacities: Sequence[float]) -> dict[float, float]:
        """Total DRAM traffic vs LLC capacity (paper Fig 4)."""
        self.prefetch(capacities)
        return {c: self._levels[float(c)].total for c in capacities}

    @staticmethod
    def capacities_for(spec: GpuSpec) -> list[float]:
        """LRU pool capacities the §III-C hierarchy needs for one spec."""
        if spec.l3_capacity:
            return [float(spec.l2_capacity),
                    float(spec.l2_capacity + spec.l3_capacity)]
        return [float(spec.l2_capacity)]

    def hierarchy(self, spec: GpuSpec) -> HierarchyTraffic:
        if spec.l3_capacity:
            post_l2 = self.level_traffic(spec.l2_capacity)
            dram = self.level_traffic(spec.l2_capacity + spec.l3_capacity)
            return HierarchyTraffic(self.l2_touch, post_l2, dram, has_l3=True)
        post_l2 = self.level_traffic(spec.l2_capacity)
        return HierarchyTraffic(self.l2_touch, post_l2, post_l2, has_l3=False)

    # -- bottleneck time model (paper Fig-2 machinery) -------------------------
    def _occupancy(self, spec: GpuSpec) -> np.ndarray:
        # Occupancy is sublinear in exposed parallelism: a kernel filling 10%
        # of the machine still extracts >10% of peak thanks to ILP, split-K
        # decompositions and cache effects (exponent calibrated against the
        # paper's Fig-2 small-batch attribution).
        occ = self._occ.get(spec.concurrency)
        if occ is None:
            occ = np.minimum(1.0, self.parallelism / spec.concurrency) ** 0.55
            self._occ[spec.concurrency] = occ
        return occ

    def time_batch(
        self,
        specs: Sequence[GpuSpec],
        ideal_dram: bool = False,
        ideal_mem_other: bool = False,
        ideal_occupancy: bool = False,
        per_op: bool = False,
    ) -> np.ndarray:
        """One (config x op) matrix evaluation of the bottleneck time model.

        Returns per-spec total seconds of shape ``(len(specs),)`` — or the
        full ``(len(specs), n_ops)`` matrix with ``per_op=True``. Each row is
        bit-identical to :meth:`_reference_time` on that spec alone: every
        step of :func:`_bottleneck_time_matrix` is elementwise, so batching
        configs cannot change a row.
        """
        specs = list(specs)
        n_ops = len(self.flops)
        if not specs:
            return np.zeros((0, n_ops)) if per_op else np.zeros(0)
        self.prefetch({c for sp in specs for c in self.capacities_for(sp)})
        t_op = _bottleneck_time_matrix(
            specs, self.flops, self.is_tc, self._occupancy, self.l2_touch,
            uhb_rows=lambda sp: (
                self._levels[float(sp.l2_capacity)].fill,
                self._levels[float(sp.l2_capacity)].writeback,
            ),
            dram_rows=lambda sp: (
                self._levels[_dram_cap(sp)].fill
                + self._levels[_dram_cap(sp)].writeback
            ),
            ideal_dram=ideal_dram,
            ideal_mem_other=ideal_mem_other,
            ideal_occupancy=ideal_occupancy,
        )
        if per_op:
            return t_op
        return t_op.sum(axis=-1)

    def time(
        self,
        spec: GpuSpec,
        ideal_dram: bool = False,
        ideal_mem_other: bool = False,
        ideal_occupancy: bool = False,
        per_op: bool = False,
    ):
        """Single-spec facade over :meth:`time_batch` (one-row matrix)."""
        out = self.time_batch(
            [spec],
            ideal_dram=ideal_dram,
            ideal_mem_other=ideal_mem_other,
            ideal_occupancy=ideal_occupancy,
            per_op=per_op,
        )
        return out[0] if per_op else float(out[0])

    def _reference_time(
        self,
        spec: GpuSpec,
        ideal_dram: bool = False,
        ideal_mem_other: bool = False,
        ideal_occupancy: bool = False,
        per_op: bool = False,
    ):
        """Per-spec scalar-loop oracle the batched path is tested against."""
        tr = self.hierarchy(spec)
        if ideal_occupancy:
            occ = np.ones_like(self.parallelism)
        else:
            occ = self._occupancy(spec)
        f_tc = spec.fp16_tflops * 1e12
        f_fp32 = spec.fp32_tflops * 1e12
        fmath = np.where(self.is_tc, f_tc, f_fp32) * occ
        t_math = np.divide(self.flops, fmath, out=np.zeros_like(self.flops),
                           where=fmath > 0)

        if ideal_mem_other:
            t_l2 = np.zeros(len(self.flops))
            t_uhb = np.zeros(len(self.flops))
        else:
            t_l2 = tr.l2_touch / (spec.l2_bandwidth * occ)
            if tr.has_l3 and spec.l3_bandwidth > 0:
                # UHB is per-direction (paper: 2xRD + 2xWR).
                t_uhb = np.maximum(
                    tr.post_l2.fill / spec.l3_bandwidth,
                    tr.post_l2.writeback / spec.l3_bandwidth,
                )
            else:
                t_uhb = np.zeros(len(self.flops))

        if ideal_dram:
            t_dram = np.zeros(len(self.flops))
        else:
            t_dram = (tr.dram.fill + tr.dram.writeback) / spec.dram_bandwidth

        overhead = 0.0 if ideal_occupancy else LAUNCH_OVERHEAD_S
        t_op = np.maximum.reduce([t_math, t_l2, t_uhb, t_dram]) + overhead
        if per_op:
            return t_op
        return float(t_op.sum())

    def attribution_batch(
        self, specs: Sequence[GpuSpec]
    ) -> list[tuple[float, dict[str, float]]]:
        """Actual time + the paper's peel-order attribution for every spec.

        Four matrix evaluations total — instead of four per config — which
        is where the engine's remaining per-config cost used to go.
        """
        specs = list(specs)
        t_act = self.time_batch(specs)
        t_no_dram = self.time_batch(specs, ideal_dram=True)
        t_no_mem = self.time_batch(specs, ideal_dram=True,
                                   ideal_mem_other=True)
        t_math = self.time_batch(specs, ideal_dram=True, ideal_mem_other=True,
                                 ideal_occupancy=True)
        out = []
        for act, nd, nm, m in zip(t_act, t_no_dram, t_no_mem, t_math):
            out.append((float(act), {
                "Math": float(m),
                "SM util": max(float(nm) - float(m), 0.0),
                "Memory others": max(float(nd) - float(nm), 0.0),
                "DRAM BW": max(float(act) - float(nd), 0.0),
            }))
        return out

    def attribution(self, spec: GpuSpec) -> tuple[float, dict[str, float]]:
        """Actual time + the paper's peel-order cost attribution."""
        return self.attribution_batch([spec])[0]

    def energy(self, spec: GpuSpec) -> EnergyReport:
        tr = self.hierarchy(spec)
        return copa_mod.memory_energy(spec, tr.dram.total, tr.l3_bytes)


# Shared per-process analyses so benchmarks/examples/tests reuse streams.
# Bounded LRU: callers like dram_traffic_sweep may analyze an unbounded
# stream of ephemeral traces (property tests generate thousands), and each
# analysis pins O(touches x capacities) arrays — evict the oldest instead of
# leaking. The workload-registry traces are lru-cached module-side, so the
# hot set stays comfortably within the bound.
_ANALYSES: OrderedDict[tuple[int, int, bool, str], tuple[Trace, TraceAnalysis]] = OrderedDict()
_ANALYSES_MAX = 512


def analysis_for(trace: Trace, cyclic: bool = True, device=None) -> TraceAnalysis:
    """Process-wide TraceAnalysis cache (keyed by trace identity).

    The op count is part of the key so a trace that grows after being
    analyzed (emit() between sweeps) gets a fresh analysis instead of the
    stale stream; in-place edits of existing ops are still on the caller.

    ``device`` (``None``: the card) is part of the key too: on the card the
    analysis's stream comes from the device batch pass, and a suite on the
    card fills its traffic cache from the card's scans.
    """
    device = resolve_device(device)
    scan = scan_device(device)
    key = (id(trace), len(trace.ops), cyclic, _backend_key(scan))
    hit = _ANALYSES.get(key)
    if hit is None or hit[0] is not trace:
        stream = None if scan is None \
            else build_streams([trace], cyclic=cyclic, device=device)[0]
        _ANALYSES[key] = (trace, TraceAnalysis(trace, cyclic=cyclic, stream=stream))
        if len(_ANALYSES) > _ANALYSES_MAX:
            _ANALYSES.popitem(last=False)
    else:
        _ANALYSES.move_to_end(key)
    return _ANALYSES[key][1]


class SuiteAnalysis:
    """Suite-level analysis: a whole set of traces behind ONE batched pass.

    Pads every member trace's touch stream into a
    :class:`~repro_torch.core.cachesim.StreamBatch` (one batched Mattson pass for
    construction, one batched segmented scan per new capacity set) and
    concatenates the per-op static vectors onto a single global op axis, so
    the bottleneck time model evaluates the *entire suite* as one
    (config x total-ops) matrix. Every number is bit-identical to running
    the member :class:`TraceAnalysis` objects one at a time (asserted in
    tests): padded rows are scanned with exactly the per-trace operation
    sequence, and the time model is elementwise with per-trace slice sums.

    Member analyses share the suite's traffic cache (levels are installed
    into each member's ``_levels``), so single-trace APIs — ``PerfModel``,
    ``msm.analyze``, ``dram_traffic_sweep`` — stay warm after a suite pass.

    ``device`` (``None``: the card) is where the streams' Mattson passes and
    the batch's traffic scans run; on the CPU they are the NumPy scans.
    """

    def __init__(self, traces: Sequence[Trace], cyclic: bool = True,
                 analyses: Sequence[TraceAnalysis] | None = None, device=None):
        self.traces = list(traces)
        self.cyclic = cyclic
        self.device = resolve_device(device)
        self._scan = scan_device(self.device)
        if analyses is None:
            streams = build_streams(self.traces, cyclic=cyclic, device=self.device)
            analyses = [TraceAnalysis(t, cyclic=cyclic, stream=s)
                        for t, s in zip(self.traces, streams)]
        self.analyses = list(analyses)
        self.batch = StreamBatch.pad([ta.stream for ta in self.analyses], device=self._scan)
        self.flops = np.concatenate(
            [ta.flops for ta in self.analyses]) if self.analyses \
            else np.zeros(0)
        self.parallelism = np.concatenate(
            [ta.parallelism for ta in self.analyses]) if self.analyses \
            else np.zeros(0)
        self.is_tc = np.concatenate(
            [ta.is_tc for ta in self.analyses]) if self.analyses \
            else np.zeros(0, dtype=bool)
        self._occ: dict[int, np.ndarray] = {}
        self._l2_touch: np.ndarray | None = None
        # capacity -> (per-op fill row, per-op writeback row) on the global
        # op axis; rows come from the batched scan (or are concatenated from
        # member caches when a member was analyzed before this suite).
        self._levels_cat: dict[float, tuple[np.ndarray, np.ndarray]] = {}
        self._totals: dict[float, np.ndarray] = {}

    @property
    def n_traces(self) -> int:
        return len(self.analyses)

    def op_slice(self, i: int) -> slice:
        return self.batch.op_slice(i)

    @property
    def l2_touch(self) -> np.ndarray:
        """Per-op L2 touch bytes on the global op axis (and installed into
        every member's cache as its slice view)."""
        if self._l2_touch is None:
            l2 = np.zeros(self.batch.n_ops_total)
            for i, ta in enumerate(self.analyses):
                s = ta.stream
                half = s.second_half
                sl = self.op_slice(i)
                if ta._l2_touch is not None:
                    l2[sl] = ta._l2_touch
                    continue
                seg = l2[sl]
                np.add.at(seg, s.op_idx[half:], s.sizes[half:])
                ta._l2_touch = seg
            self._l2_touch = l2
        return self._l2_touch

    # -- traffic ---------------------------------------------------------------
    def prefetch(self, capacities: Iterable[float]) -> None:
        """Make every requested capacity known suite-wide, scanning as
        little as possible: rows whose member :class:`TraceAnalysis` already
        carries a capacity (from an earlier suite in this session, or a
        per-trace call) are *gathered* from that cache; only blocks holding
        at least one uncovered row go through a batched
        :meth:`~repro_torch.core.cachesim.StreamBatch.traffic_matrices` scan — one
        call for the union of all missing capacities. A cached member row is
        bit-identical to a rescan of it (the per-row independence the batch
        is built on), so assembled and scanned planes cannot differ."""
        want = sorted({float(c) for c in capacities})
        missing = [c for c in want if c not in self._levels_cat]
        if not missing:
            return
        scan_caps = [c for c in missing
                     if any(c not in ta._levels for ta in self.analyses)]
        if scan_caps:
            need = {i for i, ta in enumerate(self.analyses)
                    if any(c not in ta._levels for c in scan_caps)}
            blocks = [b for b in self.batch._blocks
                      if any(m in need for m in b.members)]
            if len(blocks) == len(self.batch._blocks):
                blocks = None  # full scan; skip the membership indirection
            fills, wbs = self.batch.traffic_matrices(scan_caps, blocks=blocks)
        for c in missing:
            if c in scan_caps:
                k = scan_caps.index(c)
                fill, wb = fills[k], wbs[k]
                for i, ta in enumerate(self.analyses):
                    lt = ta._levels.get(c)
                    sl = self.op_slice(i)
                    if lt is not None:
                        # covered row: its block may not have been scanned;
                        # the cached values are bit-identical to a scan
                        fill[sl] = lt.fill
                        wb[sl] = lt.writeback
                    else:
                        ta._levels[c] = LevelTraffic(fill[sl], wb[sl])
            else:
                # every member already has this capacity: pure gather
                fill = np.concatenate(
                    [ta._levels[c].fill for ta in self.analyses]) \
                    if self.analyses else np.zeros(0)
                wb = np.concatenate(
                    [ta._levels[c].writeback for ta in self.analyses]) \
                    if self.analyses else np.zeros(0)
            self._levels_cat[c] = (fill, wb)

    def append(self, traces: Sequence[Trace],
               analyses: Sequence[TraceAnalysis] | None = None) -> None:
        """Grow the suite in place: new traces join the batch as fresh
        blocks (O(new trace) — no re-pad of existing rows) and every cached
        plane is extended for them — the static vectors, the occupancy
        cache, the L2 touch row, and each capacity in ``_levels_cat`` via
        ONE partial scan over just the new blocks (the session-level
        capacity union: whatever capacities this suite has ever seen, a new
        scenario gets them all on arrival). The grown suite is
        bit-identical, field for field, to a cold build over the full list
        (asserted in tests).

        NOTE: callers holding this object see it grow. Use
        :func:`suite_append` to also keep the :func:`suite_analysis_for`
        memo layer consistent."""
        traces = list(traces)
        if not traces:
            return
        if analyses is None:
            streams = build_streams(traces, cyclic=self.cyclic, device=self.device)
            analyses = [TraceAnalysis(t, cyclic=self.cyclic, stream=s)
                        for t, s in zip(traces, streams)]
        analyses = list(analyses)
        old_total = self.batch.n_ops_total
        old_n = self.n_traces
        new_blocks = self.batch.append([ta.stream for ta in analyses])
        self.traces.extend(traces)
        self.analyses.extend(analyses)
        self.flops = np.concatenate(
            [self.flops] + [ta.flops for ta in analyses])
        self.parallelism = np.concatenate(
            [self.parallelism] + [ta.parallelism for ta in analyses])
        self.is_tc = np.concatenate(
            [self.is_tc] + [ta.is_tc for ta in analyses])
        for conc, occ in list(self._occ.items()):
            self._occ[conc] = np.concatenate([
                occ,
                np.minimum(1.0, self.parallelism[old_total:] / conc) ** 0.55,
            ])
        if self._l2_touch is not None:
            l2 = np.zeros(self.batch.n_ops_total)
            l2[:old_total] = self._l2_touch
            self._l2_touch = l2
            for i, ta in enumerate(analyses, start=old_n):
                s = ta.stream
                sl = self.op_slice(i)
                if ta._l2_touch is not None:
                    l2[sl] = ta._l2_touch
                    continue
                seg = l2[sl]
                np.add.at(seg, s.op_idx[s.second_half:],
                          s.sizes[s.second_half:])
                ta._l2_touch = seg
        caps_known = sorted(self._levels_cat)
        if caps_known:
            fills, wbs = self.batch.traffic_matrices(caps_known,
                                                     blocks=new_blocks)
            for k, cap in enumerate(caps_known):
                of, ow = self._levels_cat[cap]
                fills[k, :old_total] = of
                wbs[k, :old_total] = ow
                self._levels_cat[cap] = (fills[k], wbs[k])
                for i, ta in enumerate(analyses, start=old_n):
                    sl = self.op_slice(i)
                    lt = ta._levels.get(cap)
                    if lt is not None:
                        fills[k, sl] = lt.fill
                        wbs[k, sl] = lt.writeback
                    else:
                        ta._levels[cap] = LevelTraffic(fills[k, sl],
                                                       wbs[k, sl])
        for cap in list(self._totals):
            self._totals[cap] = np.concatenate([
                self._totals[cap],
                [ta._levels[cap].total for ta in analyses],
            ])

    def invalidate(self, traces: Trace | Sequence[Trace]) -> None:
        """Drop member traces in place (a scenario whose trace object was
        rebuilt or grew stale). Surviving rows are re-grouped into a fresh
        batch (cheap: per-stream layouts are cached) and every cached plane
        is *gathered* down to the surviving columns — no rescan. Unknown
        traces are ignored."""
        if isinstance(traces, Trace):
            traces = [traces]
        drop = {id(t) for t in traces}
        keep = [i for i, t in enumerate(self.traces) if id(t) not in drop]
        if len(keep) == len(self.traces):
            return
        cols = np.concatenate(
            [np.arange(self.op_slice(i).start, self.op_slice(i).stop)
             for i in keep]) if keep else np.zeros(0, dtype=np.int64)
        self.traces = [self.traces[i] for i in keep]
        self.analyses = [self.analyses[i] for i in keep]
        self.batch = StreamBatch.pad([ta.stream for ta in self.analyses], device=self._scan)
        self.flops = self.flops[cols]
        self.parallelism = self.parallelism[cols]
        self.is_tc = self.is_tc[cols]
        self._occ = {c: occ[cols] for c, occ in self._occ.items()}
        if self._l2_touch is not None:
            self._l2_touch = self._l2_touch[cols]
        self._levels_cat = {c: (f[cols], w[cols])
                            for c, (f, w) in self._levels_cat.items()}
        self._totals = {c: tot[keep] for c, tot in self._totals.items()}

    def totals_below(self, capacity: float) -> np.ndarray:
        """Per-trace total traffic below one capacity, shape (n_traces,)."""
        cap = float(capacity)
        if cap not in self._totals:
            self.prefetch([cap])
            self._totals[cap] = np.array(
                [ta._levels[cap].total for ta in self.analyses])
        return self._totals[cap]

    def dram_traffic(self, capacities: Sequence[float]) -> np.ndarray:
        """(n_traces, n_capacities) DRAM-traffic tensor in one call — the
        suite-level paper Fig 4."""
        caps = [float(c) for c in capacities]
        self.prefetch(caps)
        if not caps or not self.traces:
            return np.zeros((len(self.traces), len(caps)))
        return np.column_stack([self.totals_below(c) for c in caps])

    # -- suite time model --------------------------------------------------------
    def _occupancy(self, spec: GpuSpec) -> np.ndarray:
        occ = self._occ.get(spec.concurrency)
        if occ is None:
            occ = np.minimum(1.0, self.parallelism / spec.concurrency) ** 0.55
            self._occ[spec.concurrency] = occ
        return occ

    def _level_rows(self, cap: float) -> tuple[np.ndarray, np.ndarray]:
        self.prefetch([cap])
        return self._levels_cat[float(cap)]

    def time_batch(
        self,
        specs: Sequence[GpuSpec],
        ideal_dram: bool = False,
        ideal_mem_other: bool = False,
        ideal_occupancy: bool = False,
        per_op: bool = False,
    ) -> np.ndarray:
        """The (config x op) bottleneck matrix over the WHOLE suite's global
        op axis. Returns per-(spec, trace) totals of shape
        ``(len(specs), n_traces)`` — or the ``(len(specs), n_ops_total)``
        matrix with ``per_op=True``. Every step is elementwise and the
        per-trace sums run over each trace's own slice, so each
        (spec, trace) cell is bit-identical to
        ``TraceAnalysis.time_batch`` on that trace alone."""
        specs = list(specs)
        n_ops = len(self.flops)
        if not specs:
            return np.zeros((0, n_ops)) if per_op \
                else np.zeros((0, self.n_traces))
        self.prefetch({c for sp in specs
                       for c in TraceAnalysis.capacities_for(sp)})
        t_op = _bottleneck_time_matrix(
            specs, self.flops, self.is_tc, self._occupancy, self.l2_touch,
            uhb_rows=lambda sp: self._level_rows(sp.l2_capacity),
            dram_rows=lambda sp: np.add(*self._level_rows(_dram_cap(sp))),
            ideal_dram=ideal_dram,
            ideal_mem_other=ideal_mem_other,
            ideal_occupancy=ideal_occupancy,
        )
        if per_op:
            return t_op
        return np.stack(
            [t_op[:, self.op_slice(i)].sum(axis=1)
             for i in range(self.n_traces)], axis=1,
        ) if self.n_traces else np.zeros((len(specs), 0))

    def component_batch(self, specs: Sequence[GpuSpec]) -> np.ndarray:
        """Per-resource component times of the bottleneck model, shape
        ``(4, len(specs), n_ops_total)`` in :data:`TIME_COMPONENTS` order
        (math, llc, uhb, dram). ``stack.max(axis=0) + LAUNCH_OVERHEAD_S``
        reproduces ``time_batch(per_op=True)`` exactly (asserted in
        tests) — this is the raw material ``repro_torch.obs.explain`` ranks
        per-cell bottlenecks from."""
        specs = list(specs)
        if not specs:
            return np.zeros((4, 0, len(self.flops)))
        self.prefetch({c for sp in specs
                       for c in TraceAnalysis.capacities_for(sp)})
        return _bottleneck_time_matrix(
            specs, self.flops, self.is_tc, self._occupancy, self.l2_touch,
            uhb_rows=lambda sp: self._level_rows(sp.l2_capacity),
            dram_rows=lambda sp: np.add(*self._level_rows(_dram_cap(sp))),
            ideal_dram=False, ideal_mem_other=False, ideal_occupancy=False,
            components=True,
        )

    def attribution_grid(
        self, specs: Sequence[GpuSpec]
    ) -> list[list[tuple[float, dict[str, float]]]]:
        """Actual time + the paper's peel-order attribution for every
        (trace, spec) cell: four suite-wide matrix evaluations total.
        ``out[i][j]`` matches ``analyses[i].attribution_batch(specs)[j]``
        bit for bit."""
        specs = list(specs)
        t_act = self.time_batch(specs)
        t_nd = self.time_batch(specs, ideal_dram=True)
        t_nm = self.time_batch(specs, ideal_dram=True, ideal_mem_other=True)
        t_m = self.time_batch(specs, ideal_dram=True, ideal_mem_other=True,
                              ideal_occupancy=True)
        out = []
        for i in range(self.n_traces):
            row = []
            for j in range(len(specs)):
                act, nd, nm, m = (float(t_act[j, i]), float(t_nd[j, i]),
                                  float(t_nm[j, i]), float(t_m[j, i]))
                row.append((act, {
                    "Math": m,
                    "SM util": max(nm - m, 0.0),
                    "Memory others": max(nd - nm, 0.0),
                    "DRAM BW": max(act - nd, 0.0),
                }))
            out.append(row)
        return out


# Process-wide SuiteAnalysis cache, keyed by the member-trace identities:
# repeated suite sweeps (benchmarks re-running figures, serve grids priced
# after an engine run) reuse the padded batch and every computed capacity.
_SUITES: OrderedDict[tuple, SuiteAnalysis] = OrderedDict()
_SUITES_MAX = 32


def _suite_key(traces: Sequence[Trace], cyclic: bool, device: torch.device) -> tuple:
    return (cyclic, _backend_key(scan_device(device))) \
        + tuple((id(t), len(t.ops)) for t in traces)


def suite_analysis_for(traces: Sequence[Trace], cyclic: bool = True,
                       device=None) -> SuiteAnalysis:
    """Process-wide :class:`SuiteAnalysis` cache (keyed by trace identities).

    Member analyses are shared with :func:`analysis_for`'s per-trace cache,
    so suite passes and single-trace APIs warm each other — and since
    :meth:`SuiteAnalysis.prefetch` gathers member-cached capacities instead
    of rescanning them, a *miss* here over already-analyzed traces is a
    warm rebuild (padded-row assembly from cached stream layouts, no
    Mattson pass, no traffic scan), not a cold one. To grow or shrink a
    cached suite in place, use :func:`suite_append` /
    :func:`suite_invalidate`. ``device`` (``None``: the card) keys the
    cache, and the member analyses with it."""
    traces = list(traces)
    device = resolve_device(device)
    key = _suite_key(traces, cyclic, device)
    hit = _SUITES.get(key)
    if hit is not None and hit.n_traces == len(traces) \
            and all(a is b for a, b in zip(hit.traces, traces)):
        _SUITES.move_to_end(key)
        return hit
    # Build member streams in one batched pass BEFORE analysis_for would
    # build them one at a time, then share the per-trace analysis cache.
    build_streams(traces, cyclic=cyclic, device=device)
    suite = SuiteAnalysis(
        traces, cyclic=cyclic,
        analyses=[analysis_for(t, cyclic=cyclic, device=device) for t in traces],
        device=device,
    )
    _SUITES[key] = suite
    if len(_SUITES) > _SUITES_MAX:
        _SUITES.popitem(last=False)
    return suite


def _rekey_suite(suite: SuiteAnalysis) -> None:
    """Re-index ``suite`` in the process cache under its current members."""
    for k, s in list(_SUITES.items()):
        if s is suite:
            del _SUITES[k]
    _SUITES[_suite_key(suite.traces, suite.cyclic, suite.device)] = suite
    if len(_SUITES) > _SUITES_MAX:
        _SUITES.popitem(last=False)


def suite_append(suite: SuiteAnalysis, traces: Sequence[Trace]) -> SuiteAnalysis:
    """Append scenarios to a live suite in O(new trace) — the incremental
    half of :func:`suite_analysis_for`'s append/invalidate API. New traces
    join the padded batch as fresh blocks, inherit every capacity the
    suite has ever computed via one partial scan, and the suite is re-keyed
    in the process cache so a later ``suite_analysis_for`` call with the
    grown membership hits it. Traces already in the suite are skipped.
    Returns ``suite`` (grown in place)."""
    have = {id(t) for t in suite.traces}
    new = [t for t in traces if id(t) not in have]
    if new:
        build_streams(new, cyclic=suite.cyclic, device=suite.device)
        suite.append(new, analyses=[analysis_for(t, cyclic=suite.cyclic, device=suite.device)
                                    for t in new])
        _rekey_suite(suite)
    return suite


def suite_invalidate(suite: SuiteAnalysis,
                     traces: Trace | Sequence[Trace]) -> SuiteAnalysis:
    """Drop scenarios from a live suite (stale/rebuilt trace objects) and
    re-key it in the process cache — the invalidate half of the API. Cached
    planes are gathered down to the surviving columns; nothing is
    rescanned. Returns ``suite`` (shrunk in place)."""
    n = suite.n_traces
    suite.invalidate(traces)
    if suite.n_traces != n:
        _rekey_suite(suite)
    return suite


@dataclass(frozen=True)
class SweepResult:
    """One (trace, config, GPU count) cell of the design-space grid."""

    trace: str
    kind: str                     # "training" | "inference" | "hpc" | ...
    config: str
    spec_name: str
    time_s: float                 # full step: per-GPU compute + collective
    baseline_time_s: float        # baseline config, ONE GPU, full batch
    speedup: float                # throughput ratio vs that 1-GPU baseline
    segments: dict[str, float]    # paper Fig-2 attribution (per-GPU compute)
    dram_bytes: float
    l3_bytes: float
    uhb_bytes: float
    l2_bytes: float
    dram_joules: float
    l3_joules: float
    # -- scale-out terms (all trivial at the default n_gpus=1) -----------------
    n_gpus: int = 1
    per_gpu_time_s: float = 0.0   # compute-only time of one instance
    collective_time_s: float = 0.0  # gradient all-reduce over the ICI fabric
    throughput: float = 0.0       # samples/s across all instances
    scaling_efficiency: float = 1.0  # speedup / (n_gpus * speedup@1GPU)

    @property
    def total_joules(self) -> float:
        return self.dram_joules + self.l3_joules

    @property
    def per_instance_throughput(self) -> float:
        return self.throughput / max(self.n_gpus, 1)

    @property
    def bottleneck(self) -> str:
        return bottleneck_of(self.segments)


@dataclass
class SweepGrid:
    """Structured result of a SweepEngine run."""

    baseline: str
    rows: list[SweepResult] = field(default_factory=list)
    # trace name -> LLC capacity -> total traffic below that capacity
    llc_traffic: dict[str, dict[float, float]] = field(default_factory=dict)
    _index: dict[tuple[str, str, int], SweepResult] = field(default_factory=dict)

    def add(self, row: SweepResult) -> None:
        self.rows.append(row)
        self._index[(row.trace, row.config, row.n_gpus)] = row

    def result(self, trace: str, config: str, n_gpus: int = 1) -> SweepResult:
        try:
            return self._index[(trace, config, n_gpus)]
        except KeyError:
            raise KeyError(
                f"no grid row (trace={trace!r}, config={config!r}, "
                f"n_gpus={n_gpus}); this grid swept gpu_counts="
                f"{self.gpu_counts} over configs {self.configs}"
            ) from None

    @property
    def configs(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.rows:
            seen.setdefault(r.config)
        return list(seen)

    @property
    def traces(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.rows:
            seen.setdefault(r.trace)
        return list(seen)

    @property
    def gpu_counts(self) -> list[int]:
        return sorted({r.n_gpus for r in self.rows})

    def speedups(self, config: str, traces: Sequence[str] | None = None,
                 n_gpus: int = 1) -> list[float]:
        names = list(traces) if traces is not None else self.traces
        return [self._index[(t, config, n_gpus)].speedup for t in names]

    def geomean_speedup(self, config: str,
                        traces: Sequence[str] | None = None,
                        n_gpus: int = 1) -> float:
        return geomean(self.speedups(config, traces, n_gpus=n_gpus))

    def instances_to_target(self, trace: str, config: str,
                            target_speedup: float) -> int | None:
        """Smallest swept instance count at which ``config`` reaches the
        target throughput speedup on ``trace`` (None when no swept count
        does) — the paper's GPU-instances-to-match-COPA question."""
        rows = sorted((r for r in self.rows
                       if r.trace == trace and r.config == config),
                      key=lambda r: r.n_gpus)
        for r in rows:
            if r.speedup >= target_speedup:
                return r.n_gpus
        return None

    def instances_to_match(self, config: str, target_config: str,
                           traces: Sequence[str] | None = None
                           ) -> dict[str, int | None]:
        """Per trace: swept instances of ``config`` needed to match one
        ``target_config`` GPU's throughput (None where even the largest
        swept count falls short — report it, don't invent a number)."""
        names = list(traces) if traces is not None else self.traces
        return {t: self.instances_to_target(
                    t, config, self.result(t, target_config).speedup)
                for t in names}


# -- step-cost export for the request-level serving simulator -----------------

#: Resident-KV bucket edges (tokens) for serving cost grids.
DEFAULT_SEQ_EDGES = (4096, 16384, 65536, 262144, 1048576)


@dataclass(frozen=True)
class CostGrid:
    """Precomputed (batch, resident-KV-bucket) step times for ONE config.

    The serving simulator (``repro_torch.serve.sim``) charges every engine
    iteration one cell of this grid: ``step_time(batch, resident_tokens)``
    rounds the batch UP to the next priced bucket and the resident-token
    count UP to the next ``seq_edges`` bucket (conservative within a
    bucket; counts past the last edge use the last bucket). Lookups are
    vectorized — arrays in, arrays out.

    Under the paged residency model (``repro_torch.serve.paged``) the resident
    count an engine passes in is ``pages_mapped * page_size`` — mapped
    pages, not reserved peaks — so a grid built with page-aligned edges
    (``serve_cost_grids(page_size=...)``) prices resident-PAGE buckets:
    eviction/recompute shows up as extra prefill charges and smaller
    resident sweeps, and a compressed-KV policy's bandwidth tax is baked
    into the bucket sweep times. ``page_size`` here is metadata recording
    that alignment (None: plain token buckets).
    """

    config: str
    batches: tuple[int, ...]          # ascending priced batch sizes
    seq_edges: tuple[float, ...]      # ascending resident-token bucket edges
    step_time_s: np.ndarray           # (len(batches), len(seq_edges)) seconds
    prefill_s_per_token: float = 0.0
    page_size: int | None = None      # edges are multiples of this (paged KV)

    def __post_init__(self):
        if list(self.batches) != sorted(set(self.batches)) or not self.batches:
            raise ValueError("batches must be non-empty, ascending, unique")
        if list(self.seq_edges) != sorted(set(self.seq_edges)):
            raise ValueError("seq_edges must be ascending and unique")
        if self.step_time_s.shape != (len(self.batches), len(self.seq_edges)):
            raise ValueError("step_time_s shape mismatch")
        # cache the lookup arrays once — step_time() is the hottest call in
        # the serving simulators and np.searchsorted over a tuple would
        # otherwise rebuild an ndarray on every step
        object.__setattr__(self, "_batches_arr",
                           np.asarray(self.batches, dtype=np.int64))
        object.__setattr__(self, "_edges_arr",
                           np.asarray(self.seq_edges, dtype=float))

    @property
    def max_batch(self) -> int:
        return self.batches[-1]

    def step_time(self, batch, resident_tokens=0):
        b = np.asarray(batch)
        if np.any(b < 1) or np.any(b > self.max_batch):
            raise ValueError(
                f"batch outside priced range [1, {self.max_batch}]: {batch!r}")
        i = np.searchsorted(self._batches_arr, b, side="left")
        j = np.minimum(np.searchsorted(self._edges_arr,
                                       np.asarray(resident_tokens),
                                       side="left"),
                       len(self.seq_edges) - 1)
        out = self.step_time_s[i, j]
        return float(out) if np.ndim(batch) == 0 and np.ndim(resident_tokens) == 0 \
            else out

    def prefill_time(self, prompt_tokens):
        return np.asarray(prompt_tokens) * self.prefill_s_per_token \
            if np.ndim(prompt_tokens) else prompt_tokens * self.prefill_s_per_token

    def saturated_rps(self, output_tokens: int = 1) -> float:
        """Steady-state requests/s at a permanently full batch with empty-KV
        step costs — the closed-loop ceiling the saturation tests pin against
        the ``SweepEngine`` serve rows."""
        return self.max_batch / (self.step_time_s[-1, 0] * output_tokens)


@lru_cache(maxsize=4096)
def _kv_sweep_trace(kv_bytes: int) -> Trace:
    """One decode iteration's KV sweep as a trace: the whole resident cache
    is read once per step. Priced cyclically, the cache model keeps the
    LLC-resident fraction on package and streams only the remainder from
    DRAM — the closed form this replaced charged the whole sweep to a
    single level and over-priced partially-resident caches. Bounded: a
    long repricing session sweeps an open-ended set of byte counts."""
    tr = Trace(name=f"serve.kvsweep.{int(kv_bytes)}", kind="inference")
    tr.emit("kv.sweep", 0.0, reads=[("kvcache", int(kv_bytes))],
            precision="bf16")
    return tr


# KV-sweep pricing session: ONE growing SuiteAnalysis serves every
# kv_sweep_times call in the process. A new byte count (grid repriced with a
# different compression tax, page size, or bytes/token) APPENDS a row in
# O(new trace) and inherits the session's whole capacity union, instead of
# keying a fresh suite per size set and rescanning the overlap. One session
# for each place the scans run (``cachesim._backend_key``).
_KV_SESSION_MAX = 1024
# scan key -> (kv byte count -> session row index, the session's suite)
_KV_SESSIONS: dict[str, tuple[dict[int, int], SuiteAnalysis]] = {}


def _kv_session_suite(sizes: Sequence[int], device=None) -> tuple[dict[int, int], SuiteAnalysis]:
    device = resolve_device(device)
    key = _backend_key(scan_device(device))
    rows, suite = _KV_SESSIONS.get(key, ({}, None))
    new = [s for s in sizes if s not in rows]
    if suite is None or len(rows) + len(new) > _KV_SESSION_MAX:
        rows = {s: i for i, s in enumerate(sizes)}
        suite = suite_analysis_for([_kv_sweep_trace(s) for s in sizes], device=device)
    elif new:
        suite_append(suite, [_kv_sweep_trace(s) for s in new])
        for s in new:
            rows[s] = len(rows)
    _KV_SESSIONS[key] = (rows, suite)
    return rows, suite


def kv_sweep_times(specs: Sequence[GpuSpec],
                   kv_bytes_seq: Sequence[float], device=None) -> np.ndarray:
    """Per-step KV read times of shape ``(len(kv_bytes_seq), len(specs))``,
    priced through the cache model (steady-state cyclic residency; ideal
    occupancy and no launch overhead — the sweep rides along the decode
    math it accompanies). All sizes share one suite-level ``time_batch``
    over the process-wide KV session suite, so repricing with new sizes
    pays only for the new rows."""
    device = resolve_device(device)
    sizes = [float(b) for b in kv_bytes_seq]
    finite = sorted({int(s) for s in sizes if s > 0 and np.isfinite(s)})
    out = np.zeros((len(sizes), len(specs)))
    if finite:
        rows, suite = _kv_session_suite(finite, device)
        times = suite.time_batch(list(specs), ideal_occupancy=True)
        lookup = {s: times[:, rows[s]] for s in finite}
    for r, s in enumerate(sizes):
        if s > 0:
            out[r] = lookup[int(s)] if np.isfinite(s) else np.inf
    return out


def prefill_cost_per_token(scenario: str, configs: Sequence[ConfigLike],
                           device=None) -> np.ndarray:
    """Per-config prefill seconds/token priced from a REAL prefill trace.

    ``scenario`` names a registry prefill cell (``lm.<arch>.prefill_*``);
    its trace models one prefill chunk of ``batch x seq_len`` prompt
    tokens, so ONE ``time_batch`` call over all configs divided by the
    chunk's token count yields the per-token prefill cost each config's
    :class:`CostGrid` charges (trace-sourced pricing in place of the flat
    s/token knob)."""
    from repro_torch.configs import SHAPES  # lazy: configs sit above core
    from repro_torch.workloads import registry  # lazy: workloads sit above core

    shape = scenario.rsplit(".", 1)[1]
    if shape not in SHAPES or SHAPES[shape].step != "prefill":
        raise KeyError(
            f"{scenario!r} is not a prefill scenario (expected an "
            f"lm.<arch>.prefill_* registry cell)")
    trace = registry.scenario(scenario)
    tokens = max(trace.batch_size, 1) * SHAPES[shape].seq_len
    specs = [_as_spec(c) for c in configs]
    return analysis_for(trace, device=device).time_batch(specs) / tokens


def serve_cost_grids(
    bench: str,
    configs: Sequence[ConfigLike],
    *,
    kv_bytes_per_token: float = 0.0,
    seq_edges: Sequence[float] = DEFAULT_SEQ_EDGES,
    prefill_s_per_token: float = 0.0,
    prefill_scenario: str | None = None,
    tokens_per_pass: int = 1,
    scenario_prefix: str = "serve.mlperf",
    page_size: int | None = None,
    kv_policy=None,
    device=None,
) -> dict[str, CostGrid]:
    """Export (batch x KV-bucket) step-time grids for every config, priced
    from the registry's ``serve.<bench>.b<batch>`` scenarios.

    ONE suite-level ``time_batch`` call covers every (batch bucket, config)
    cell: the batch scenarios share a :class:`SuiteAnalysis`, so pricing a
    serve grid after an engine run re-uses the same padded batch and
    traffic instead of re-running the per-scenario pipeline.
    ``tokens_per_pass`` divides the trace time for scenarios whose one pass
    decodes several tokens (e.g. gnmt's 50-step decoder), yielding a
    per-output-token step cost. With ``kv_bytes_per_token`` zero (the
    one-shot MLPerf semantics) the grid has a single KV bucket and step
    times equal the engine's serve-row times bit-for-bit.

    Prefill pricing: ``prefill_scenario`` names an ``lm.<arch>.prefill_*``
    cell whose trace prices prefill per config (one extra ``time_batch``
    over the prefill chunk — see :func:`prefill_cost_per_token`); it
    overrides the flat ``prefill_s_per_token`` knob.

    Paged residency: ``page_size`` snaps every KV bucket edge UP to the
    next page multiple (deduplicated, order preserved) so the grid's
    buckets land on resident-page boundaries — the counts the paged
    engines actually report. ``kv_policy`` (a
    :class:`repro_torch.core.msm.MemoryPolicy`) applies its
    ``kv_compression_bw_tax`` to the per-bucket KV sweep bytes: compressed
    KV moves ``(1 + tax)`` bytes per resident byte read, pricing the
    Buddy-Compression bandwidth cost into the same grid whose *capacity*
    side grows via ``msm.kv_token_capacity``.

    ``device`` (``None``: the card) is where the suites' scans run."""
    from repro_torch.workloads import registry  # lazy: workloads sit above core

    device = resolve_device(device)
    names = registry.scenarios(f"{scenario_prefix}.{bench}.b")
    if not names:
        raise KeyError(f"no {scenario_prefix}.{bench}.b* scenarios registered")
    by_batch = sorted((int(n.rsplit(".b", 1)[1]), n) for n in names)
    batches = tuple(b for b, _ in by_batch)
    specs = [(_config_name(c), _as_spec(c)) for c in configs]
    spec_objs = [s for _, s in specs]
    suite = suite_analysis_for([registry.scenario(scen) for _, scen in by_batch],
                               device=device)
    base = suite.time_batch(spec_objs).T / max(int(tokens_per_pass), 1)

    if prefill_scenario is not None:
        prefill = prefill_cost_per_token(prefill_scenario, configs, device=device)
    else:
        prefill = np.full(len(specs), float(prefill_s_per_token))
    if kv_bytes_per_token > 0:
        edges = [float(e) for e in seq_edges]
        if page_size is not None:
            if page_size < 1:
                raise ValueError("page_size must be >= 1")
            snapped = [float(-(-int(e) // page_size) * page_size)
                       for e in edges if np.isfinite(e)]
            snapped += [e for e in edges if not np.isfinite(e)]
            edges = sorted(set(snapped))
        edges = tuple(edges)
    else:
        edges = (float("inf"),)
    bw_tax = 0.0 if kv_policy is None else float(kv_policy.kv_compression_bw_tax)
    kv = kv_sweep_times(spec_objs,
                        [e * kv_bytes_per_token * (1.0 + bw_tax)
                         for e in edges], device=device) \
        if kv_bytes_per_token > 0 else np.zeros((1, len(specs)))
    out = {}
    for ci, (name, spec) in enumerate(specs):
        out[name] = CostGrid(
            config=name,
            batches=batches,
            seq_edges=edges,
            step_time_s=base[:, ci][:, None] + kv[:, ci][None, :],
            prefill_s_per_token=float(prefill[ci]),
            page_size=page_size,
        )
    return out


class SweepEngine:
    """One batched pipeline over (traces x configs x LLC capacities x GPUs).

    Per workload the engine builds (or reuses) a :class:`TraceAnalysis`,
    prefetches the union of every capacity any config touches in a single
    vectorized pass, then costs ALL configs from the shared cache with one
    (config x op) matrix evaluation per attribution term — the whole
    Table-V design space costs one trace walk instead of one per config.

    ``gpu_counts`` adds the scale-out dimension: every workload is also
    projected onto n data-parallel instances (per-GPU trace from
    :class:`ScaleOutWorkload.trace_for`, or the same trace for weak
    scaling), with training steps charged a gradient ring all-reduce over
    the ``ici_bandwidth`` fabric. Rows carry throughput and scaling
    efficiency against the 1-GPU baseline config.

    ``device`` (``None``: the card, and it raises without one) is where the
    suite's scans run; ``"cpu"`` runs the NumPy scans.
    """

    def __init__(
        self,
        traces: Iterable[WorkloadLike],
        configs: Sequence[ConfigLike] | None = None,
        baseline: ConfigLike | None = None,
        extra_llc_capacities: Sequence[float] = (),
        cyclic: bool = True,
        share_analyses: bool = True,
        gpu_counts: Sequence[int] = (1,),
        ici_bandwidth: float = float("inf"),
        ici_latency_s: float = 0.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.workloads = _expand_workloads(traces)
        self.configs = list(configs if configs is not None else copa_mod.TABLE_V)
        self.baseline = baseline if baseline is not None else copa_mod.GPU_N_BASE
        self.extra_llc_capacities = [float(c) for c in extra_llc_capacities]
        self.cyclic = cyclic
        self.gpu_counts = sorted({int(n) for n in gpu_counts})
        if any(n < 1 for n in self.gpu_counts):
            raise ValueError("gpu_counts must be >= 1")
        if float(ici_bandwidth) <= 0:
            raise ValueError("ici_bandwidth must be > 0 bytes/s "
                             "(use the default inf for an ideal fabric)")
        self.ici_bandwidth = float(ici_bandwidth)
        self.ici_latency_s = float(ici_latency_s)
        # share_analyses=False keeps this engine's analyses private — used by
        # cold-cache benchmarking; everything else should share the process
        # cache so figures/tests reuse streams and traffic.
        self._share = share_analyses
        self._private: dict[int, TraceAnalysis] = {}

    @property
    def traces(self) -> list[Trace]:
        """The 1-GPU trace of every workload (back-compat accessor)."""
        return [w.trace_for(1) for w in self.workloads]

    def analysis(self, trace: Trace) -> TraceAnalysis:
        if self._share:
            return analysis_for(trace, cyclic=self.cyclic, device=self.device)
        key = id(trace)
        if key not in self._private:
            self._private[key] = TraceAnalysis(
                trace, cyclic=self.cyclic,
                stream=build_streams([trace], cyclic=self.cyclic, device=self.device)[0])
        return self._private[key]

    def suite_analysis(self, traces: Sequence[Trace]) -> SuiteAnalysis:
        if self._share:
            return suite_analysis_for(traces, cyclic=self.cyclic, device=self.device)
        streams = build_streams(traces, cyclic=self.cyclic, device=self.device)
        for t, s in zip(traces, streams):
            if id(t) not in self._private:
                self._private[id(t)] = TraceAnalysis(t, cyclic=self.cyclic,
                                                     stream=s)
        return SuiteAnalysis(traces, cyclic=self.cyclic,
                             analyses=[self._private[id(t)] for t in traces],
                             device=self.device)

    def run(self, batched: bool = True) -> SweepGrid:
        """Evaluate the grid. The default path pads every workload's touch
        stream into one :class:`~repro_torch.core.cachesim.StreamBatch` and costs
        the whole (trace x config x capacity x GPU count) space through a
        single :class:`SuiteAnalysis` pass; ``batched=False`` runs the
        original per-trace loop, kept as the bit-for-bit parity oracle
        (asserted in tests) and the before/after benchmark baseline."""
        if not batched:
            return self._run_per_trace()
        base_spec = _as_spec(self.baseline)
        specs = [(_config_name(c), _as_spec(c)) for c in self.configs]
        spec_objs = [spec for _, spec in specs]
        grid = SweepGrid(baseline=_config_name(self.baseline))
        caps: set[float] = set(self.extra_llc_capacities)
        for _, spec in specs:
            caps.update(TraceAnalysis.capacities_for(spec))
        caps.update(TraceAnalysis.capacities_for(base_spec))

        # Materialize every (workload, n) trace, dedup by identity: scale-out
        # families often return the same object at several instance counts.
        jobs: list[tuple[ScaleOutWorkload, Trace, list[tuple[int, Trace]]]] = []
        index: dict[int, int] = {}
        suite_traces: list[Trace] = []
        for w in self.workloads:
            trace1 = w.trace_for(1)
            per_n = [(n, trace1 if n == 1 else w.trace_for(n))
                     for n in self.gpu_counts]
            jobs.append((w, trace1, per_n))
            for _, t in [(1, trace1)] + per_n:
                if id(t) not in index:
                    index[id(t)] = len(suite_traces)
                    suite_traces.append(t)
        suite = self.suite_analysis(suite_traces)
        suite.prefetch(caps)

        # One suite pass: base-config times, the four-term attribution, and
        # per-(spec, trace) traffic/energy vectors.
        t_base_all = suite.time_batch([base_spec])[0] \
            if suite_traces else np.zeros(0)
        att_all = suite.attribution_grid(spec_objs)
        post_tot = {spec.l2_capacity: suite.totals_below(spec.l2_capacity)
                    for _, spec in specs}
        dram_tot = {_dram_cap(spec):
                    suite.totals_below(_dram_cap(spec))
                    for _, spec in specs}
        l2_sum = np.array([float(ta.l2_touch.sum())
                           for ta in suite.analyses])

        for w, trace1, per_n in jobs:
            i1 = index[id(trace1)]
            t_base = float(t_base_all[i1])
            base_batch = trace1.batch_size
            # 1-GPU speedup per config anchors the scaling-efficiency ratio.
            sp1 = {name: (t_base / att[0] if att[0] > 0 else float("inf"))
                   for (name, _), att in zip(specs, att_all[i1])}

            for n, trace_n in per_n:
                i = index[id(trace_n)]
                ta = suite.analyses[i]
                coll = ring_allreduce_time(
                    ta.grad_bytes, n, self.ici_bandwidth, self.ici_latency_s
                ) if trace_n.kind == "training" else 0.0
                batch_n = trace_n.batch_size

                for (name, spec), (t_act, segments) in zip(specs, att_all[i]):
                    time_s = t_act + coll
                    if n == 1 and coll == 0.0:
                        sp = t_base / time_s
                    elif batch_n and base_batch:
                        # throughput ratio at whatever the global batch is
                        sp = (batch_n * n / time_s) / (base_batch / t_base)
                    else:
                        sp = n * t_base / time_s  # batchless: weak scaling
                    eff = sp / (n * sp1[name]) if sp1[name] > 0 else 1.0
                    post = float(post_tot[spec.l2_capacity][i])
                    dram = float(dram_tot[_dram_cap(spec)][i])
                    has_l3 = bool(spec.l3_capacity)
                    l3_bytes = max(post - dram, 0.0) if has_l3 else 0.0
                    dram_j = dram * 8.0 * spec.dram_energy_pj_per_bit * 1e-12
                    l3_j = l3_bytes * 8.0 \
                        * (spec.dram_energy_pj_per_bit / 4.0) * 1e-12
                    grid.add(SweepResult(
                        trace=w.name,
                        kind=trace_n.kind,
                        config=name,
                        spec_name=spec.name,
                        time_s=time_s,
                        baseline_time_s=t_base,
                        speedup=sp,
                        segments=segments,
                        dram_bytes=dram,
                        l3_bytes=l3_bytes,
                        uhb_bytes=post if has_l3 else 0.0,
                        l2_bytes=float(l2_sum[i]),
                        dram_joules=dram_j,
                        l3_joules=l3_j,
                        n_gpus=n,
                        per_gpu_time_s=t_act,
                        collective_time_s=coll,
                        throughput=(batch_n or 1) * n / time_s,
                        scaling_efficiency=eff,
                    ))
            if self.extra_llc_capacities:
                grid.llc_traffic[w.name] = suite.analyses[i1].dram_traffic(
                    self.extra_llc_capacities
                )
        return grid

    def _run_per_trace(self) -> SweepGrid:
        """The pre-batch per-trace loop: one TraceAnalysis, one traffic
        prefetch and one attribution per trace. Parity oracle for
        :meth:`run` and the benchmark baseline in ``bench_core``."""
        base_spec = _as_spec(self.baseline)
        specs = [(_config_name(c), _as_spec(c)) for c in self.configs]
        spec_objs = [spec for _, spec in specs]
        grid = SweepGrid(baseline=_config_name(self.baseline))
        caps: set[float] = set(self.extra_llc_capacities)
        for _, spec in specs:
            caps.update(TraceAnalysis.capacities_for(spec))
        caps.update(TraceAnalysis.capacities_for(base_spec))

        for w in self.workloads:
            trace1 = w.trace_for(1)
            ta1 = self.analysis(trace1)
            ta1.prefetch(caps)
            t_base = ta1.time(base_spec)
            att1 = ta1.attribution_batch(spec_objs)
            base_batch = trace1.batch_size
            # 1-GPU speedup per config anchors the scaling-efficiency ratio.
            sp1 = {name: (t_base / att[0] if att[0] > 0 else float("inf"))
                   for (name, _), att in zip(specs, att1)}

            for n in self.gpu_counts:
                trace_n = trace1 if n == 1 else w.trace_for(n)
                if trace_n is trace1:
                    ta, att = ta1, att1
                else:
                    ta = self.analysis(trace_n)
                    ta.prefetch(caps)
                    att = ta.attribution_batch(spec_objs)
                coll = ring_allreduce_time(
                    ta.grad_bytes, n, self.ici_bandwidth, self.ici_latency_s
                ) if trace_n.kind == "training" else 0.0
                batch_n = trace_n.batch_size

                for (name, spec), (t_act, segments) in zip(specs, att):
                    time_s = t_act + coll
                    if n == 1 and coll == 0.0:
                        sp = t_base / time_s
                    elif batch_n and base_batch:
                        # throughput ratio at whatever the global batch is
                        sp = (batch_n * n / time_s) / (base_batch / t_base)
                    else:
                        sp = n * t_base / time_s  # batchless: weak scaling
                    eff = sp / (n * sp1[name]) if sp1[name] > 0 else 1.0
                    tr = ta.hierarchy(spec)
                    en = ta.energy(spec)
                    grid.add(SweepResult(
                        trace=w.name,
                        kind=trace_n.kind,
                        config=name,
                        spec_name=spec.name,
                        time_s=time_s,
                        baseline_time_s=t_base,
                        speedup=sp,
                        segments=segments,
                        dram_bytes=tr.dram.total,
                        l3_bytes=tr.l3_bytes,
                        uhb_bytes=tr.post_l2.total if tr.has_l3 else 0.0,
                        l2_bytes=float(ta.l2_touch.sum()),
                        dram_joules=en.dram_joules,
                        l3_joules=en.l3_joules,
                        n_gpus=n,
                        per_gpu_time_s=t_act,
                        collective_time_s=coll,
                        throughput=(batch_n or 1) * n / time_s,
                        scaling_efficiency=eff,
                    ))
            if self.extra_llc_capacities:
                grid.llc_traffic[w.name] = ta1.dram_traffic(
                    self.extra_llc_capacities
                )
        return grid
