"""The reference's fleet and obs properties, held on the port: over drawn
cost grids, arrival processes, routers, fleet sizes and KV capacities the
port's batched core equals its per-instance oracle and the JAX package's
batched core, bit for bit; the windowed rollup re-partitions the run's
totals at any window width; the Chrome trace stays schema-valid. The draws
are derandomized, so every run tries the same examples."""
import numpy as np
import pytest
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.obs.timeline import chrome_trace, validate_chrome_trace
from test_torch_fleet import PORT, REF, assert_same_result, ramp_grid


@st.composite
def fleet_case(draw):
    n_batches = draw(st.integers(min_value=1, max_value=3))
    batches = tuple(2 ** k for k in range(n_batches))
    base = draw(st.floats(min_value=1e-4, max_value=5e-3))
    tab = np.asarray([[base * (1 + 0.1 * bi + 0.05 * j) for j in range(3)]
                      for bi in range(n_batches)])
    prefill = draw(st.sampled_from([0.0, 1e-4]))
    kind = draw(st.sampled_from(["poisson", "bursty"]))
    spec_kw = {}
    if kind == "bursty":
        spec_kw = dict(burst_factor=draw(st.floats(min_value=1.5, max_value=6.0)),
                       burst_fraction=0.3, period_s=0.2)
    spec = dict(name=kind, rate=draw(st.floats(min_value=50.0, max_value=1500.0)),
                n_requests=draw(st.integers(min_value=1, max_value=200)),
                high=draw(st.integers(min_value=1, max_value=12)), **spec_kw)
    kw = dict(n_instances=draw(st.integers(min_value=1, max_value=5)),
              router=draw(st.sampled_from(["least_loaded", "round_robin"])),
              max_batch=batches[-1],
              kv_capacity_tokens=draw(st.sampled_from([64.0, 400.0, float("inf")])))
    return (batches, tab, prefill), kw, spec, draw(st.integers(min_value=0, max_value=2**31 - 1))


def build(s, grid, spec):
    batches, tab, prefill = grid
    g = s.sweep.CostGrid("prop", batches, (16.0, 128.0, float("inf")), tab,
                         prefill_s_per_token=prefill)
    spec = dict(spec)
    high = spec.pop("high")
    arrivals = s.sim.ArrivalSpec(
        spec.pop("name"), prompt=s.sim.LengthDist("uniform", low=1, high=40),
        output=s.sim.LengthDist("uniform", low=1, high=high), **spec)
    return g, arrivals


@settings(max_examples=30, deadline=None, derandomize=True)
@given(case=fleet_case())
def test_batched_matches_oracle_and_reference(case):
    grid, kw, spec, seed = case
    g, arrivals = build(PORT, grid, spec)
    got = PORT.fleet.FleetSim(g, **kw).run(arrivals, seed=seed)
    assert_same_result(got, PORT.fleet.FleetSim(g, **kw).run(arrivals, seed=seed,
                                                             batched=False))
    rg, rarrivals = build(REF, grid, spec)
    assert_same_result(got, REF.fleet.FleetSim(rg, **kw).run(rarrivals, seed=seed))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(rate=st.floats(min_value=100.0, max_value=2000.0),
       n0=st.integers(min_value=1, max_value=6),
       interval=st.sampled_from([0.02, 0.05, 0.2]),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_batched_matches_oracle_autoscaled(rate, n0, interval, seed):
    def run(s, batched=True):
        spec = s.sim.ArrivalSpec("as", rate, 300, prompt=s.sim.LengthDist("fixed", 8),
                                 output=s.sim.LengthDist("uniform", low=1, high=6))
        grid = s.sweep.CostGrid("as", (1, 4), (16.0, 128.0, float("inf")), np.full((2, 3), 1e-3))
        return s.fleet.FleetSim(grid, n0, max_batch=4, kv_capacity_tokens=4096.0,
                                autoscaler=s.elastic.QueueDepthAutoscaler(min_instances=1,
                                                                          max_instances=8),
                                autoscale_interval_s=interval).run(spec, seed=seed,
                                                                   batched=batched)

    got = run(PORT)
    assert_same_result(got, run(PORT, batched=False))
    assert_same_result(got, run(REF))


def obs_run(n_instances, n_requests, rate, seed):
    spec = PORT.sim.ArrivalSpec("obs-prop", rate, n_requests,
                                prompt=PORT.sim.LengthDist("uniform", low=1, high=40),
                                output=PORT.sim.LengthDist("uniform", low=1, high=12))
    return PORT.fleet.FleetSim(ramp_grid(PORT), n_instances, max_batch=4,
                               kv_capacity_tokens=2048.0,
                               obs=PORT.sim.ObsConfig(level=1)).run(spec, seed=seed)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(n_instances=st.integers(min_value=1, max_value=4),
       n_requests=st.integers(min_value=1, max_value=150),
       rate=st.floats(min_value=50.0, max_value=1200.0),
       seed=st.integers(min_value=0, max_value=2**31 - 1),
       window_s=st.floats(min_value=1e-4, max_value=60.0))
def test_timeseries_repartitions_aggregates(n_instances, n_requests, rate, seed, window_s):
    res = obs_run(n_instances, n_requests, rate, seed)
    slo = PORT.sim.Slo(ttft_s=0.02, percentile=95)
    s = res.timeseries(window_s, slo=slo)
    m = res.metrics
    assert int(s.arrived.sum()) == n_requests
    assert int(s.completed.sum()) == n_requests
    assert int(s.tokens.sum()) == int(res.batch.output_tokens.sum())
    assert int(s.ok.sum()) == int(slo.ok_mask(m).sum())
    total_busy = sum(float((sl.t_end - sl.t_start).sum()) for sl in res.step_logs)
    assert np.isclose(s.busy_s.sum(), total_busy, rtol=1e-9, atol=1e-12)
    assert np.all(s.busy_s <= s.capacity_s * (1 + 1e-9) + 1e-12)
    assert np.all((s.batch_mean >= 0) & (s.queue_mean >= 0))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(n_instances=st.integers(min_value=1, max_value=4),
       n_requests=st.integers(min_value=1, max_value=120),
       rate=st.floats(min_value=50.0, max_value=1200.0),
       seed=st.integers(min_value=0, max_value=2**31 - 1),
       max_requests=st.one_of(st.none(), st.integers(min_value=1, max_value=50)))
def test_chrome_trace_always_schema_valid(n_instances, n_requests, rate, seed, max_requests):
    res = obs_run(n_instances, n_requests, rate, seed)
    doc = chrome_trace(res, max_requests=max_requests)
    assert validate_chrome_trace(doc) == []
    kept = doc["otherData"]["n_requests"]
    assert kept == min(n_requests, max_requests or n_requests)
    assert doc["otherData"]["dropped_requests"] == n_requests - kept
