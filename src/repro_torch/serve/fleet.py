"""Fleet-level serving: N simulated instances behind a router.

Answers the paper's scale-out question at the request level: how many
instances of a COPA config does a latency-bounded service need?
:class:`FleetSim` runs one global discrete-event loop over N instances —
arrivals are dispatched by a router (``round_robin`` or ``least_loaded``),
each instance schedules its own continuous-batching iterations, and an
optional autoscaler (queue-depth policy from ``repro_torch.ft.elastic``) resizes
the fleet at a fixed cadence.

Two engines share these semantics: the default is the vectorized
struct-of-arrays core in ``repro_torch.serve.fleetbatch`` (requests as
:class:`~repro_torch.serve.sim.RequestBatch` columns, instances as rows of one
event state — planet-scale fleets price in seconds); ``run(batched=False)``
keeps the original per-instance :class:`~repro_torch.serve.sim.Instance`/heap
loop as the parity oracle, asserted bit-identical in tests.

:func:`instances_to_meet_slo` is the SLO-percentile analogue of
``SweepGrid.instances_to_target``: the smallest fleet whose simulated
latency percentiles meet the :class:`~repro_torch.serve.sim.Slo`.
:func:`scan_fleet` finds it by doubling + bisection — each probe is one
batched run over the SAME generated request stream, so a 200+-instance
answer costs ~log2(N) simulations instead of N.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.serve.sim import (
    ArrivalSpec,
    Instance,
    ObsConfig,
    Request,
    RequestBatch,
    SimMetrics,
    Slo,
    StepLog,
    fresh_requests,
)

ROUTERS = ("round_robin", "least_loaded")


@dataclass
class ScaleEvent:
    t: float
    n_active: int
    queued: int
    running: int


@dataclass
class FleetResult:
    batch: RequestBatch               # per-request timings, SoA, arrival-sorted
    metrics: SimMetrics
    step_logs: list[StepLog]          # one per instance ever active
    n_instances_final: int            # active (non-draining) at completion
    scale_events: list[ScaleEvent] = field(default_factory=list)
    n_instances_initial: int | None = None   # fleet size before any autoscale

    @property
    def requests(self) -> list[Request]:
        """Per-request objects, materialized from the SoA batch on demand
        (the batched core never builds them)."""
        if getattr(self, "_requests", None) is None:
            self._requests = self.batch.to_requests()
        return self._requests

    @property
    def n_instances_peak(self) -> int:
        return max((e.n_active for e in self.scale_events),
                   default=self.n_instances_final)

    def timeseries(self, window_s: float, *, slo: Slo | None = None):
        """Windowed :class:`repro_torch.obs.series.MetricSeries` rollup — the
        per-window goodput/percentile/occupancy view of this run."""
        from repro_torch.obs.series import timeseries
        return timeseries(self, window_s, slo=slo)


_ARRIVAL, _STEP_DONE, _TICK = 0, 1, 2


class FleetSim:
    """N serving instances of one config behind a router.

    All instances share one cost model (``CostGrid``-like) and per-instance
    ``max_batch`` / ``kv_capacity_tokens`` limits. With an ``autoscaler``
    (see :class:`repro_torch.ft.elastic.QueueDepthAutoscaler`) the fleet is
    resized every ``autoscale_interval_s``: scale-up adds a fresh instance;
    scale-down drains the least-loaded one (it stops receiving arrivals,
    finishes its queue, then leaves the fleet)."""

    def __init__(self, cost, n_instances: int = 1, *,
                 router: str = "least_loaded",
                 max_batch: int | None = None,
                 kv_capacity_tokens: float = float("inf"),
                 paged=None, sched=None,
                 autoscaler=None, autoscale_interval_s: float = 0.0,
                 obs: ObsConfig | None = None):
        if router not in ROUTERS:
            raise ValueError(f"unknown router {router!r}; one of {ROUTERS}")
        if n_instances < 1:
            raise ValueError("n_instances must be >= 1")
        if autoscaler is not None and autoscale_interval_s <= 0:
            raise ValueError("autoscaler needs autoscale_interval_s > 0")
        self.cost = cost
        self.router = router
        self.max_batch = max_batch
        self.kv_capacity_tokens = kv_capacity_tokens
        self.paged = paged
        self.sched = sched
        self.autoscaler = autoscaler
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.obs = obs
        self._n_initial = int(n_instances)
        self._active: list[Instance] = []
        self._draining: list[Instance] = []
        self._retired: list[Instance] = []
        for _ in range(n_instances):
            self._spawn()
        self._rr = 0

    # -- fleet membership ------------------------------------------------------
    def _spawn(self) -> Instance:
        inst = Instance(self.cost, max_batch=self.max_batch,
                        kv_capacity_tokens=self.kv_capacity_tokens,
                        paged=self.paged, sched=self.sched, obs=self.obs)
        self._active.append(inst)
        return inst

    def _drain_one(self) -> None:
        if len(self._active) <= 1:
            return
        inst = min(self._active, key=lambda i: i.load)
        self._active.remove(inst)
        (self._retired if inst.idle else self._draining).append(inst)

    def _route(self, req: Request) -> Instance:
        if self.router == "round_robin":
            inst = self._active[self._rr % len(self._active)]
            self._rr += 1
            return inst
        return min(self._active, key=lambda i: i.load)

    # -- the global event loop -------------------------------------------------
    def run(self, requests: Sequence[Request] | ArrivalSpec | RequestBatch,
            seed: int = 0, *, batched: bool = True) -> FleetResult:
        if batched:
            from repro_torch.serve import fleetbatch  # lazy: avoids import cycle

            if isinstance(requests, ArrivalSpec):
                rb = requests.generate_batch(seed)
            elif isinstance(requests, RequestBatch):
                rb = requests
            else:
                rb = RequestBatch.from_requests(requests)
            return fleetbatch.run_fleet(
                self.cost, rb, n_instances=len(self._active),
                router=self.router, max_batch=self.max_batch,
                kv_capacity_tokens=self.kv_capacity_tokens,
                paged=self.paged, sched=self.sched,
                autoscaler=self.autoscaler,
                autoscale_interval_s=self.autoscale_interval_s,
                obs=self.obs)
        if isinstance(requests, ArrivalSpec):
            requests = requests.generate(seed)
        elif isinstance(requests, RequestBatch):
            requests = requests.to_requests()
        # copy: a shared request list (replayed trace) must not carry one
        # run's timing state into the next (scan_fleet reuses the list)
        reqs = fresh_requests(requests)
        events: list[tuple[float, int, int, object]] = []
        seq = 0
        for r in reqs:
            heapq.heappush(events, (r.t_arrival, seq, _ARRIVAL, r))
            seq += 1
        scale_events: list[ScaleEvent] = []
        if self.autoscaler is not None and reqs:
            heapq.heappush(events, (reqs[0].t_arrival
                                    + self.autoscale_interval_s, seq, _TICK,
                                    None))
            seq += 1
        done = 0
        clock = 0.0
        while events and done < len(reqs):
            t, _, kind, payload = heapq.heappop(events)
            assert t >= clock, "fleet clock went backwards"
            clock = t
            # Drain every event at this timestamp before starting iterations
            # (simultaneous arrivals share a batch — see repro_torch.serve.sim).
            kick: dict[int, Instance] = {}
            while True:
                if kind == _ARRIVAL:
                    inst = self._route(payload)
                    inst.submit(payload)
                    kick[id(inst)] = inst
                elif kind == _STEP_DONE:
                    inst = payload
                    done += len(inst.finish_step(t))
                    if inst in self._draining and inst.idle:
                        self._draining.remove(inst)
                        self._retired.append(inst)
                    else:
                        kick[id(inst)] = inst
                else:  # autoscale tick
                    queued = sum(len(i.waiting) for i in self._active)
                    running = sum(len(i.running) for i in self._active)
                    target = self.autoscaler.decide(
                        len(self._active), queued, running,
                        self.max_batch or self.cost.max_batch)
                    while len(self._active) < target:
                        self._spawn()
                    while len(self._active) > max(target, 1):
                        self._drain_one()
                    scale_events.append(ScaleEvent(t, len(self._active),
                                                   queued, running))
                    if done < len(reqs):
                        heapq.heappush(events, (t + self.autoscale_interval_s,
                                                seq, _TICK, None))
                        seq += 1
                if not (events and events[0][0] == t):
                    break
                _, _, kind, payload = heapq.heappop(events)
            for inst in kick.values():
                if not inst.busy:
                    t_end = inst.start_step(t)
                    if t_end is not None:
                        heapq.heappush(events, (t_end, seq, _STEP_DONE, inst))
                        seq += 1
        leftovers = sum(i.load for i in
                        self._active + self._draining + self._retired)
        assert done == len(reqs) and leftovers == 0, "requests left in system"
        logs = [i.step_log() for i in
                self._active + self._draining + self._retired]
        out = FleetResult(
            batch=RequestBatch.from_completed(reqs),
            metrics=SimMetrics.from_requests(reqs),
            step_logs=logs,
            n_instances_final=len(self._active),
            scale_events=scale_events,
            n_instances_initial=self._n_initial,
        )
        out._requests = reqs
        return out


def scan_fleet(cost, arrivals: ArrivalSpec | Sequence[Request] | RequestBatch,
               slo: Slo, *,
               router: str = "least_loaded", max_batch: int | None = None,
               kv_capacity_tokens: float = float("inf"),
               paged=None, sched=None, obs: ObsConfig | None = None,
               max_instances: int = 64, seed: int = 0,
               batched: bool = True, strategy: str = "bisect"
               ) -> dict[int, SimMetrics]:
    """Probe fleet sizes until the smallest SLO-meeting size is bracketed;
    returns metrics for every size probed.

    The request stream is generated ONCE and re-run fresh per probe, so
    every probed size sees the identical arrival trace. ``strategy`` picks
    the probe schedule: ``"bisect"`` (default) doubles 1, 2, 4, ... to the
    first SLO-meeting size then bisects the bracket — O(log N) batched runs,
    which is what makes 200+-instance sizing cheap; ``"linear"`` is the
    original 1..N scan (kept for parity tests — both schedules land on the
    same :func:`instances_to_meet_slo` answer whenever SLO attainment is
    monotone in fleet size, asserted in tests)."""
    if strategy not in ("bisect", "linear"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if isinstance(arrivals, ArrivalSpec):
        base = arrivals.generate_batch(seed) if batched \
            else arrivals.generate(seed)
    else:
        base = arrivals   # FleetSim.run re-materializes fresh copies

    def probe(k: int) -> SimMetrics:
        sim = FleetSim(cost, k, router=router, max_batch=max_batch,
                       kv_capacity_tokens=kv_capacity_tokens,
                       paged=paged, sched=sched, obs=obs)
        return sim.run(base, seed=seed, batched=batched).metrics

    out: dict[int, SimMetrics] = {}
    if strategy == "linear":
        for k in range(1, max_instances + 1):
            out[k] = probe(k)
            if slo.met(out[k]):
                break
        return out
    k, lo = 1, 0
    while True:                       # doubling: find the first met size
        out[k] = probe(k)
        if slo.met(out[k]):
            break
        if k >= max_instances:
            return out                # even the cap falls short
        lo, k = k, min(2 * k, max_instances)
    hi = k
    while hi - lo > 1:                # bisect the (fail, met] bracket
        mid = (lo + hi) // 2
        out[mid] = probe(mid)
        if slo.met(out[mid]):
            hi = mid
        else:
            lo = mid
    return out


def instances_to_meet_slo(cost,
                          arrivals: ArrivalSpec | Sequence[Request]
                          | RequestBatch,
                          slo: Slo, **kw) -> int | None:
    """Smallest fleet size whose simulated percentiles meet ``slo`` (None
    when even ``max_instances`` falls short) — the SLO analogue of
    ``SweepGrid.instances_to_target``."""
    scanned = scan_fleet(cost, arrivals, slo, **kw)
    met = [k for k, m in scanned.items() if slo.met(m)]
    return min(met) if met else None


def latency_goodput_rows(grids: dict[str, "object"], arrivals: ArrivalSpec,
                         rates: Sequence[float], slo: Slo, *,
                         n_instances: int = 1, router: str = "least_loaded",
                         kv_capacity_tokens: float = float("inf"),
                         paged=None, sched=None,
                         seed: int = 0) -> list[dict]:
    """Comparison-table rows (config x arrival rate): latency percentiles +
    SLO goodput, shared by the examples / launch drivers / benchmarks."""
    rows = []
    for rate in rates:
        spec = arrivals.with_rate(rate)
        for name, grid in grids.items():
            m = FleetSim(grid, n_instances, router=router,
                         kv_capacity_tokens=kv_capacity_tokens,
                         paged=paged, sched=sched).run(
                             spec, seed=seed).metrics
            rows.append({
                "config": name,
                "rate_rps": rate,
                "ttft_p50_ms": 1e3 * m.percentile("ttft", 50),
                "ttft_p99_ms": 1e3 * m.percentile("ttft", 99),
                "tpot_p99_ms": 1e3 * m.percentile("tpot", 99),
                "e2e_p99_ms": 1e3 * m.percentile("e2e", 99),
                "goodput_rps": m.goodput_rps(slo),
                "slo_met": slo.met(m),
            })
    return rows
