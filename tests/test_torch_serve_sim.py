"""The port's request-level serving simulator (``repro_torch.serve.sim`` and
``serve.paged``) against the JAX package's, on the same ``CostGrid``,
``ArrivalSpec`` and seed: every ``SimMetrics`` field and the step log equal
to the bit. The grids come from each side's ``serve_cost_grids`` (the port
with ``device="cpu"``: its NumPy scans), and are held to the bit first."""
import dataclasses

import numpy as np
import pytest
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

from repro.core import copa as rcopa
from repro.core import msm as rmsm
from repro.core import sweep as rsweep
from repro.serve import paged as rpaged
from repro.serve import sim as rsim
from repro.workloads import registry as rregistry
from repro_torch.core import copa, msm, sweep
from repro_torch.serve import paged, sim
from repro_torch.workloads import registry

KV_PER_TOKEN = 64 * 1024
EDGES = (64, 4096, 1 << 20)


def grids(side, bench, **kw):
    c, s = (copa, sweep) if side == "port" else (rcopa, rsweep)
    extra = {"device": "cpu"} if side == "port" else {}
    return s.serve_cost_grids(bench, [c.GPU_N_BASE, c.HBM_L3], **kw, **extra)


GRID_KW = {
    "resnet": {},
    "gnmt": {"kv_bytes_per_token": KV_PER_TOKEN, "seq_edges": EDGES, "tokens_per_pass": 50,
             "prefill_scenario": "lm.tinyllama-1.1b.prefill_32k", "page_size": 16},
}


@pytest.mark.parametrize("bench", sorted(GRID_KW))
def test_serve_cost_grids_equal_reference(bench):
    got, want = grids("port", bench, **GRID_KW[bench]), grids("ref", bench, **GRID_KW[bench])
    assert list(got) == list(want)
    for name in got:
        g, w = got[name], want[name]
        assert (g.config, g.batches, g.seq_edges, g.page_size) == \
            (w.config, w.batches, w.seq_edges, w.page_size)
        assert np.array_equal(g.step_time_s, w.step_time_s)
        assert g.prefill_s_per_token == w.prefill_s_per_token


def test_kv_sweep_times_equal_reference():
    mb = 1024 * 1024
    sizes = [0, mb, 4 * mb, 64 * mb, 256 * mb, 1024 * mb, 64 * 1024 * mb, float("inf")]
    got = sweep.kv_sweep_times([copa.GPU_N_BASE.build(), copa.HBM_L3.build()], sizes,
                               device="cpu")
    want = rsweep.kv_sweep_times([rcopa.GPU_N_BASE.build(), rcopa.HBM_L3.build()], sizes)
    assert np.array_equal(got, want)


def capacity(side, config):
    m, c = (msm, copa) if side == "port" else (rmsm, rcopa)
    return m.kv_token_capacity(getattr(c, config).build(), m.DECODE_MSM, 4 << 20)


# (arrival process, bench, simulate's keyword arguments by side)
CASES = {
    "poisson": ("arrivals.poisson.r64", "resnet", lambda side: {}),
    "burst": ("arrivals.burst.r256.x4", "resnet", lambda side: {"max_batch": 16}),
    "diurnal_kv": ("arrivals.diurnal.chat", "gnmt",
                   lambda side: {"kv_capacity_tokens": capacity(side, "GPU_N_BASE")}),
    "paged_lru_chunked": ("arrivals.diurnal.api", "gnmt", lambda side: {
        "kv_capacity_tokens": 6000,
        "paged": (paged if side == "port" else rpaged).PagedKvSpec(
            page_size=16, oversubscription=1.5, eviction="lru"),
        "sched": (paged if side == "port" else rpaged).SchedPolicy(
            prefill_chunk=64, decode_priority=True),
        "obs": (sim if side == "port" else rsim).ObsConfig(level=1)}),
}


def run(side, case, config):
    arrivals, bench, kw = CASES[case]
    reg, s = (registry, sim) if side == "port" else (rregistry, rsim)
    spec = reg.arrivals(arrivals)
    if "diurnal" in arrivals:   # a quarter of the stream: requests of up to 512 tokens
        spec = dataclasses.replace(spec, n_requests=128)
    grid = grids(side, bench, **GRID_KW[bench])[config]
    return spec, s.simulate(spec.generate(seed=11), grid, **kw(side))


@pytest.mark.parametrize("config", ["GPU-N", "HBM+L3"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_equals_reference_to_the_bit(case, config):
    spec, got = run("port", case, config)
    rspec, want = run("ref", case, config)
    assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
    for f in dataclasses.fields(got.metrics):
        a, b = getattr(got.metrics, f.name), getattr(want.metrics, f.name)
        assert np.array_equal(a, b), f.name
    for f in dataclasses.fields(got.step_log):
        a, b = getattr(got.step_log, f.name), getattr(want.step_log, f.name)
        assert (a is None and b is None) or np.array_equal(a, b), f.name
    assert [dataclasses.astuple(r) for r in got.requests] == \
        [dataclasses.astuple(r) for r in want.requests]
    assert len(got.requests) == spec.n_requests


def test_replay_and_reference_sim_equal_reference():
    times = np.linspace(0.0, 0.02, 40).tolist()
    got_g = grids("port", "gnmt", **GRID_KW["gnmt"])["HBM+L3"]
    want_g = grids("ref", "gnmt", **GRID_KW["gnmt"])["HBM+L3"]
    got = sim.simulate(sim.replay(times, prompts=100, outputs=7), got_g, max_batch=8)
    want = rsim.simulate(rsim.replay(times, prompts=100, outputs=7), want_g, max_batch=8)
    for f in ("ttft", "tpot", "e2e", "output_tokens", "evictions"):
        assert np.array_equal(getattr(got.metrics, f), getattr(want.metrics, f)), f
    req = sim.Request(rid=0, t_arrival=0.25, prompt_tokens=12, output_tokens=7)
    rreq = rsim.Request(rid=0, t_arrival=0.25, prompt_tokens=12, output_tokens=7)
    assert sim._reference_sim(req, got_g) == rsim._reference_sim(rreq, want_g)
    slo, rslo = sim.Slo(ttft_s=0.05, tpot_s=0.01, e2e_s=0.2), \
        rsim.Slo(ttft_s=0.05, tpot_s=0.01, e2e_s=0.2)
    assert got.metrics.goodput_rps(slo) == want.metrics.goodput_rps(rslo)


def test_paged_allocator_equals_reference():
    """The block-table allocator alone: the same admissions, growth and
    evictions leave the same ledgers."""
    for mod in (paged, rpaged):
        assert mod.pages_for(0, 16) == 0 and mod.pages_for(17, 16) == 2
    spec, rspec = paged.PagedKvSpec(page_size=8, oversubscription=2.0, eviction="lru"), \
        rpaged.PagedKvSpec(page_size=8, oversubscription=2.0, eviction="lru")
    got = paged.make_allocator(200.0, spec)
    want = rpaged.make_allocator(200.0, rspec)
    for a in (got, want):
        for rid, (prompt, out) in enumerate([(40, 20), (64, 8), (10, 90)]):
            assert a.can_admit(prompt + out)
            a.admit(rid, prompt + out)
            a.ensure(rid, a.pages_for(prompt))
        a.ensure(1, a.pages_for(70))
        a.release(0)
        a.ensure(2, a.pages_for(60))
    assert vars(got).keys() == vars(want).keys()
    for k in vars(got):
        assert repr(getattr(got, k)) == repr(getattr(want, k)), k
