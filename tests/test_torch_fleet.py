"""The port's fleet simulator (``repro_torch.serve.fleet`` and
``serve.fleetbatch``) against the JAX package's, on the same ``CostGrid``,
``ArrivalSpec`` and seed: every request-timing column, every instance's step
log, the instance counts and the autoscaler's scale events equal to the bit,
for the batched core and for the per-instance oracle (``batched=False``),
and the two cores equal to each other. The grids come from each side's
``serve_cost_grids`` (the port with ``device="cpu"``: its NumPy scans),
held to the bit first, or are built alike on both sides from the same
numbers."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

from repro.core import copa as rcopa
from repro.core import sweep as rsweep
from repro.ft import elastic as relastic
from repro.serve import fleet as rfleet
from repro.serve import paged as rpaged
from repro.serve import sim as rsim
from repro_torch.core import copa, sweep
from repro_torch.ft import elastic
from repro_torch.serve import fleet, paged, sim

PORT = SimpleNamespace(name="port", copa=copa, sweep=sweep, elastic=elastic, fleet=fleet,
                       paged=paged, sim=sim)
REF = SimpleNamespace(name="ref", copa=rcopa, sweep=rsweep, elastic=relastic, fleet=rfleet,
                      paged=rpaged, sim=rsim)
SIDES = (PORT, REF)

KV_PER_TOKEN = 64 * 1024
GNMT_KW = {"tokens_per_pass": 50, "kv_bytes_per_token": KV_PER_TOKEN,
           "seq_edges": (64, 4096, 1 << 20),
           "prefill_scenario": "lm.tinyllama-1.1b.prefill_32k"}

_GRIDS = {}


def gnmt_grids(s):
    """Each side's gnmt grids for GPU-N and HBM+L3 (memoized per side)."""
    if s.name not in _GRIDS:
        extra = {"device": "cpu"} if s is PORT else {}
        _GRIDS[s.name] = s.sweep.serve_cost_grids(
            "gnmt", [s.copa.GPU_N_BASE, s.copa.HBM_L3], **GNMT_KW, **extra)
    return _GRIDS[s.name]


def flat_grid(s, step=1e-3, batches=(1, 2, 4, 8), prefill=0.0):
    tab = np.tile(np.asarray([step] * 3), (len(batches), 1))
    return s.sweep.CostGrid("flat", tuple(batches), (8.0, 64.0, float("inf")), tab,
                            prefill_s_per_token=prefill)


def ramp_grid(s):
    batches, edges = (1, 2, 4), (8.0, 64.0, 512.0)
    tab = np.asarray([[1e-3 + 1e-5 * b + 1e-6 * j for j in range(3)] for b in batches])
    return s.sweep.CostGrid("ramp", batches, edges, tab, prefill_s_per_token=0.01)


BATCH_COLS = ("rid", "t_arrival", "prompt_tokens", "output_tokens", "t_admitted",
              "t_first_token", "t_done", "tokens_emitted", "evictions")
LOG_COLS = ("t_start", "t_end", "batch", "kv_reserved", "queued", "admitted", "pages",
            "prefill_tokens")


def same_array(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")


def assert_same_result(a, b):
    """Two ``FleetResult``s equal to the bit: request columns, step logs,
    instance counts, scale events and every metrics field."""
    for col in BATCH_COLS:
        assert same_array(getattr(a.batch, col), getattr(b.batch, col)), f"batch {col}"
    assert len(a.step_logs) == len(b.step_logs)
    for k, (la, lb) in enumerate(zip(a.step_logs, b.step_logs)):
        for col in LOG_COLS:
            assert same_array(getattr(la, col), getattr(lb, col)), f"step log {k} {col}"
    assert (a.n_instances_final, a.n_instances_initial, a.n_instances_peak) == \
        (b.n_instances_final, b.n_instances_initial, b.n_instances_peak)
    assert [dataclasses.astuple(e) for e in a.scale_events] == \
        [dataclasses.astuple(e) for e in b.scale_events]
    for f in dataclasses.fields(a.metrics):
        assert same_array(getattr(a.metrics, f.name), getattr(b.metrics, f.name)), f.name


def test_gnmt_grids_equal_reference():
    got, want = gnmt_grids(PORT), gnmt_grids(REF)
    assert list(got) == list(want)
    for name in got:
        assert np.array_equal(got[name].step_time_s, want[name].step_time_s)
        assert got[name].prefill_s_per_token == want[name].prefill_s_per_token
        assert (got[name].batches, got[name].seq_edges) == (want[name].batches,
                                                            want[name].seq_edges)


def run_sides(make_grid, work, seed, batched=True, autoscale=None, **kw):
    """The port's and the reference's run of one case: ``make_grid(s)``,
    ``work(s)`` and each callable keyword give a side's grid, arrivals and
    options; ``autoscale`` the keywords of each side's autoscaler."""
    out = []
    for s in SIDES:
        kws = {k: (v(s) if callable(v) else v) for k, v in kw.items()}
        if autoscale is not None:
            kws["autoscaler"] = s.elastic.QueueDepthAutoscaler(**autoscale)
        out.append(s.fleet.FleetSim(make_grid(s), **kws).run(work(s), seed=seed,
                                                             batched=batched))
    return out


def poisson(rate, n, prompt=16, high=8):
    return lambda s: s.sim.ArrivalSpec("poisson", rate, n, prompt=s.sim.LengthDist("fixed", prompt),
                                       output=s.sim.LengthDist("uniform", low=1, high=high))


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
@pytest.mark.parametrize("router", ["least_loaded", "round_robin"])
@pytest.mark.parametrize("n_instances", [1, 2, 3, 5])
def test_routers_equal_reference(router, n_instances, batched):
    """The gnmt grids at 90 % of the fleet's saturated rate."""
    def work(s):
        g = gnmt_grids(s)["GPU-N"]
        return s.sim.ArrivalSpec("poisson", 0.9 * n_instances * g.saturated_rps(8), 300,
                                 prompt=s.sim.LengthDist("fixed", 16),
                                 output=s.sim.LengthDist("uniform", low=1, high=16))

    got, want = run_sides(lambda s: gnmt_grids(s)["GPU-N"], work, 7, batched,
                          n_instances=n_instances, router=router, kv_capacity_tokens=4096.0)
    assert_same_result(got, want)
    if batched:
        oracle = run_sides(lambda s: gnmt_grids(s)["GPU-N"], work, 7, False,
                           n_instances=n_instances, router=router, kv_capacity_tokens=4096.0)[0]
        assert_same_result(got, oracle)


def bursty(s):
    return s.sim.ArrivalSpec("bursty", 300.0, 400, burst_factor=4.0, burst_fraction=0.3,
                             period_s=0.25, prompt=s.sim.LengthDist("uniform", low=4, high=32),
                             output=s.sim.LengthDist("uniform", low=1, high=16))


def kv_tight(s):
    return s.sim.ArrivalSpec("kv", 500.0, 250, prompt=s.sim.LengthDist("uniform", low=16, high=64),
                             output=s.sim.LengthDist("uniform", low=1, high=32))


def simultaneous(s):
    """20 requests at exactly t=0: arrivals before steps, FIFO in the wave."""
    return [s.sim.Request(rid=i, t_arrival=0.0 if i < 20 else 0.001 * (i - 19),
                          prompt_tokens=3 + (i % 5), output_tokens=1 + (i % 7))
            for i in range(120)]


def gnmt_hbm(s):
    return gnmt_grids(s)["HBM+L3"]


def gnmt_bursty(s):
    g = gnmt_hbm(s)
    rate = 3 * g.saturated_rps(24)
    return s.sim.ArrivalSpec("bursty", rate, 600, burst_factor=3.0, burst_fraction=0.25,
                             period_s=600 / rate / 5, prompt=s.sim.LengthDist("fixed", 12),
                             output=s.sim.LengthDist("lognormal", mean=24, sigma=0.4, floor=4))


# name -> (grid, arrivals, seed, FleetSim keywords)
CASES = {
    "bursty_prefill": (ramp_grid, bursty, 11,
                       {"n_instances": 4, "max_batch": 4, "kv_capacity_tokens": 2048.0}),
    "kv_tight": (ramp_grid, kv_tight, 3,
                 {"n_instances": 2, "max_batch": 4, "kv_capacity_tokens": 160.0}),
    "simultaneous": (flat_grid, simultaneous, 0,
                     {"n_instances": 3, "max_batch": 4, "kv_capacity_tokens": 1e9}),
    "gnmt_bursty_prefill": (gnmt_hbm, gnmt_bursty, 5, {"n_instances": 3}),
    "paged": (gnmt_hbm, gnmt_bursty, 5,
              {"n_instances": 3, "kv_capacity_tokens": 1500.0,
               "paged": lambda s: s.paged.PagedKvSpec(page_size=16)}),
    "paged_obs": (ramp_grid, kv_tight, 3,
                  {"n_instances": 2, "max_batch": 4, "kv_capacity_tokens": 320.0,
                   "paged": lambda s: s.paged.PagedKvSpec(page_size=8),
                   "obs": lambda s: s.sim.ObsConfig(level=1)}),
    "rich_eviction": (gnmt_hbm, gnmt_bursty, 5,
                      {"n_instances": 3, "kv_capacity_tokens": 800.0,
                       "paged": lambda s: s.paged.PagedKvSpec(
                           page_size=16, oversubscription=1.5, eviction="lru")}),
    "rich_chunked_priority": (ramp_grid, kv_tight, 3,
                              {"n_instances": 2, "max_batch": 4, "kv_capacity_tokens": 400.0,
                               "sched": lambda s: s.paged.SchedPolicy(prefill_chunk=8,
                                                                      decode_priority=True),
                               "obs": lambda s: s.sim.ObsConfig(level=1)}),
    "rich_all": (gnmt_hbm, gnmt_bursty, 5,
                 {"n_instances": 2, "kv_capacity_tokens": 600.0,
                  "paged": lambda s: s.paged.PagedKvSpec(page_size=16, oversubscription=2.0,
                                                         eviction="lru"),
                  "sched": lambda s: s.paged.SchedPolicy(prefill_chunk=32,
                                                         decode_priority=True),
                  "obs": lambda s: s.sim.ObsConfig(level=1)}),
}


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equals_reference(case, batched):
    grid, work, seed, kw = CASES[case]
    got, want = run_sides(grid, work, seed, batched, **kw)
    assert_same_result(got, want)
    assert len(got.batch) == len(want.batch) > 0
    if case.startswith("rich") and batched:
        # the rich core ran: eviction or chunking shows in the columns
        assert int(got.batch.evictions.sum()) > 0 or "chunked" in case
    if batched:
        assert_same_result(got, run_sides(grid, work, seed, False, **kw)[0])


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "oracle"])
@pytest.mark.parametrize("name,rate,n0", [("up", 900.0, 1), ("down", 80.0, 6)])
def test_autoscale_equals_reference(name, rate, n0, batched):
    """The port's ``QueueDepthAutoscaler`` driving the port's fleet against
    the reference's driving the reference's."""
    got, want = run_sides(flat_grid, poisson(rate, 500), 5, batched,
                          autoscale={"min_instances": 1, "max_instances": 8},
                          n_instances=n0, max_batch=4, kv_capacity_tokens=4096.0,
                          autoscale_interval_s=0.05)
    assert_same_result(got, want)
    assert len(got.scale_events) > 0
    assert (got.n_instances_final > n0) if name == "up" else (got.n_instances_final < n0)


def test_autoscaler_decisions_equal_reference():
    a, b = elastic.QueueDepthAutoscaler(max_instances=12), \
        relastic.QueueDepthAutoscaler(max_instances=12)
    rng = np.random.default_rng(0)
    n = m = 3
    for _ in range(400):
        q, r = int(rng.integers(0, 200)), int(rng.integers(0, 64))
        n, m = a.decide(n, q, r, 16), b.decide(m, q, r, 16)
        assert n == m


SCAN_SCENARIOS = {
    "poisson_tight": (lambda s: s.sim.ArrivalSpec(
        "scan", 900.0, 400, prompt=s.sim.LengthDist("fixed", 16),
        output=s.sim.LengthDist("uniform", low=1, high=8)),
        lambda s: s.sim.Slo(ttft_s=0.05, tpot_s=0.01, e2e_s=2.0, percentile=90.0)),
    "bursty": (lambda s: s.sim.ArrivalSpec(
        "scan", 700.0, 400, burst_factor=3.0, burst_fraction=0.25, period_s=0.2,
        prompt=s.sim.LengthDist("uniform", low=4, high=32),
        output=s.sim.LengthDist("uniform", low=1, high=12)),
        lambda s: s.sim.Slo(ttft_s=0.08, tpot_s=0.02, percentile=90.0)),
    "unmeetable": (lambda s: s.sim.ArrivalSpec(
        "scan", 5000.0, 300, prompt=s.sim.LengthDist("fixed", 16),
        output=s.sim.LengthDist("fixed", 8)),
        lambda s: s.sim.Slo(ttft_s=1e-4, percentile=50.0)),
}


def assert_same_ladder(got, want):
    assert list(got) == list(want)
    for k in got:
        for f in dataclasses.fields(got[k]):
            assert same_array(getattr(got[k], f.name), getattr(want[k], f.name)), (k, f.name)


@pytest.mark.parametrize("strategy", ["linear", "bisect"])
@pytest.mark.parametrize("scenario", sorted(SCAN_SCENARIOS))
def test_scan_fleet_equals_reference(scenario, strategy):
    """The probed ladder (sizes in probe order, every metrics field) and
    ``instances_to_meet_slo``; linear and bisect agree on the answer."""
    work, slo = SCAN_SCENARIOS[scenario]
    kw = {"max_batch": 4, "max_instances": 8, "seed": 2, "strategy": strategy,
          "batched": strategy == "bisect"}
    got = fleet.scan_fleet(flat_grid(PORT), work(PORT), slo(PORT), **kw)
    want = rfleet.scan_fleet(flat_grid(REF), work(REF), slo(REF), **kw)
    assert_same_ladder(got, want)
    n = fleet.instances_to_meet_slo(flat_grid(PORT), work(PORT), slo(PORT), **kw)
    assert n == rfleet.instances_to_meet_slo(flat_grid(REF), work(REF), slo(REF), **kw)
    other = {**kw, "strategy": "linear" if strategy == "bisect" else "bisect"}
    assert n == fleet.instances_to_meet_slo(flat_grid(PORT), work(PORT), slo(PORT), **other)
    assert (n is None) == (scenario == "unmeetable")


def test_scan_fleet_gnmt_bisect_equals_reference():
    """``fleet_at_scale``'s schedule on the gnmt grids at a cut size: 2,000
    bursty requests, up to 40 instances, each config's ladder."""
    ladders = []
    for s in SIDES:
        grids = gnmt_grids(s)
        base = grids["GPU-N"]
        rate = 40 * 0.8 * base.saturated_rps(48)
        spec = s.sim.ArrivalSpec("example.mixed", rate, 2000, burst_factor=3.0,
                                 burst_fraction=0.25, period_s=2000 / rate / 5.0,
                                 prompt=s.sim.LengthDist("fixed", mean=12, floor=1),
                                 output=s.sim.LengthDist("lognormal", mean=48, sigma=0.4,
                                                         floor=4))
        slo = s.sim.Slo(ttft_s=10 * base.step_time(1), tpot_s=5 * base.step_time(1),
                        percentile=95)
        ladders.append({name: s.fleet.scan_fleet(g, spec, slo, max_instances=40,
                                                  strategy="bisect")
                        for name, g in grids.items()})
    got, want = ladders
    assert list(got) == list(want)
    for name in got:
        assert_same_ladder(got[name], want[name])
        assert len(got[name]) > 3


def test_latency_goodput_rows_equal_reference():
    rows = []
    for s in SIDES:
        grids = gnmt_grids(s)
        base = grids["GPU-N"]
        sat = base.saturated_rps(16)
        arrivals = s.sim.ArrivalSpec("rows", sat, 300, prompt=s.sim.LengthDist("fixed", 12),
                                     output=s.sim.LengthDist("uniform", low=4, high=28))
        slo = s.sim.Slo(ttft_s=5e-4, tpot_s=1.5e-4, percentile=95)
        rows.append(s.fleet.latency_goodput_rows(grids, arrivals, [0.5 * sat, 1.1 * sat], slo,
                                                 n_instances=2, seed=3))
    assert rows[0] == rows[1]
    assert len(rows[0]) == 4 and {r["slo_met"] for r in rows[0]} == {True, False}


@pytest.mark.parametrize("batched", [True, False])
def test_oversized_request_raises_like_reference(batched):
    for s in SIDES:
        reqs = [s.sim.Request(rid=0, t_arrival=0.0, prompt_tokens=500, output_tokens=4)]
        with pytest.raises(ValueError, match="can never be"):
            s.fleet.FleetSim(flat_grid(s), 2, max_batch=4, kv_capacity_tokens=100.0).run(
                reqs, batched=batched)


def test_fleet_refusals():
    g = flat_grid(PORT)
    with pytest.raises(ValueError, match="unknown router"):
        fleet.FleetSim(g, 2, router="random")
    with pytest.raises(ValueError, match="n_instances"):
        fleet.FleetSim(g, 0)
    with pytest.raises(ValueError, match="autoscale_interval_s"):
        fleet.FleetSim(g, 2, autoscaler=elastic.QueueDepthAutoscaler())
    with pytest.raises(ValueError, match="unknown strategy"):
        fleet.scan_fleet(g, poisson(100.0, 10)(PORT), sim.Slo(ttft_s=1.0), strategy="random")


def test_replayed_trace_runs_fresh_each_time():
    """``scan_fleet`` reuses one request list: a run leaves it untouched."""
    reqs = simultaneous(PORT)
    first = fleet.FleetSim(flat_grid(PORT), 2, max_batch=4).run(reqs, batched=False)
    assert all(np.isnan(r.t_done) for r in reqs)
    again = fleet.FleetSim(flat_grid(PORT), 2, max_batch=4).run(reqs, batched=False)
    assert_same_result(first, again)
    assert [r.rid for r in first.requests] == list(first.batch.rid)
