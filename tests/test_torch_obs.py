"""The port's observability package (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on fleets run alike on both sides: ``MetricSeries``
arrays, Chrome-trace documents (as sorted JSON), the validator's findings,
``store`` files crossing between the packages, ``explain(device="cpu")``
reports, and the ``python -m ... obs`` CLI's output, all equal to the bit;
and the lazy package surface, which names only the port's modules."""
import ast
import dataclasses
import inspect
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

import repro.obs as robs
import repro_torch.obs as obs
from repro.core import copa as rcopa
from repro.obs import attribution as rattribution
from repro.obs import cli as rcli
from repro.obs import series as rseries
from repro.obs import store as rstore
from repro.obs import timeline as rtimeline
from repro_torch.core import copa
from repro_torch.obs import attribution, cli, series, store, timeline
from test_torch_fleet import PORT, REF, SIDES, assert_same_result, flat_grid, ramp_grid

ROOT = pathlib.Path(__file__).resolve().parent.parent


def paged_grid(s):
    """Large batches and KV-dependent steps: oversubscription evicts."""
    batches = (1, 2, 4, 8, 64)
    edges = (64.0, 512.0, 4096.0, float("inf"))
    tab = np.asarray([[1e-3 + 5e-5 * b + 2e-6 * j for j in range(4)] for b in batches])
    return s.sweep.CostGrid("obs-paged", batches, edges, tab, prefill_s_per_token=1e-5)


def fleet_run(s, level=1):
    spec = s.sim.ArrivalSpec("obs", 400.0, 300, prompt=s.sim.LengthDist("uniform", low=4, high=32),
                             output=s.sim.LengthDist("uniform", low=1, high=16))
    return s.fleet.FleetSim(ramp_grid(s), 3, max_batch=4, kv_capacity_tokens=2048.0,
                            obs=s.sim.ObsConfig(level=level)).run(spec, seed=5)


def evicting_run(s):
    spec = s.sim.ArrivalSpec("paged", 900.0, 400,
                             prompt=s.sim.LengthDist("lognormal", mean=400, floor=8),
                             output=s.sim.LengthDist("uniform", low=100, high=300))
    return s.fleet.FleetSim(paged_grid(s), n_instances=2, kv_capacity_tokens=12_000.0,
                            paged=s.paged.PagedKvSpec(page_size=16, oversubscription=1.5,
                                                      eviction="lru"),
                            obs=s.sim.ObsConfig(level=1)).run(spec, seed=0)


def autoscaled_run(s):
    spec = s.sim.ArrivalSpec("up", 900.0, 500, prompt=s.sim.LengthDist("fixed", 16),
                             output=s.sim.LengthDist("uniform", low=1, high=8))
    return s.fleet.FleetSim(flat_grid(s), 1, max_batch=4, kv_capacity_tokens=4096.0,
                            autoscaler=s.elastic.QueueDepthAutoscaler(max_instances=6),
                            autoscale_interval_s=0.05).run(spec, seed=1)


def single_run(s):
    reqs = [s.sim.Request(rid=i, t_arrival=0.002 * i, prompt_tokens=8, output_tokens=4)
            for i in range(50)]
    return s.sim.simulate(reqs, flat_grid(s), max_batch=4, obs=s.sim.ObsConfig(level=1))


RUNS = {"fleet": fleet_run, "fleet_level0": lambda s: fleet_run(s, level=0),
        "evicting": evicting_run, "autoscaled": autoscaled_run, "single": single_run}


def both(run):
    return RUNS[run](PORT), RUNS[run](REF)


def sorted_json(doc) -> str:
    return json.dumps(doc, sort_keys=True)


def same_series(a, b):
    assert type(a).__name__ == type(b).__name__ == "MetricSeries"
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), f.name
        else:
            assert x == y or (x != x and y != y), f.name
    for prop in ("t_start", "throughput_rps", "goodput_rps", "tokens_per_s",
                 "eviction_rate_rps", "utilization"):
        assert np.array_equal(getattr(a, prop), getattr(b, prop), equal_nan=True), prop
    assert a.rows() == b.rows() or sorted_json(a.rows()) == sorted_json(b.rows())
    assert sorted_json(a.to_json()) == sorted_json(b.to_json())
    assert a.table() == b.table()


@pytest.mark.parametrize("window_s", [0.013, 0.05, 0.2, 10.0])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_timeseries_equals_reference(run, window_s):
    got, want = both(run)
    if run != "single":
        assert_same_result(got, want)
    slo = (PORT.sim.Slo(ttft_s=0.02, percentile=95), REF.sim.Slo(ttft_s=0.02, percentile=95))
    window = window_s * (got.metrics.makespan_s if run == "evicting" else 1.0)
    same_series(got.timeseries(window, slo=slo[0]), want.timeseries(window, slo=slo[1]))
    same_series(series.timeseries(got, window), rseries.timeseries(want, window))


@pytest.mark.parametrize("window_s", [0.013, 0.05, 0.2, 10.0])
def test_timeseries_sums_exactly(window_s):
    """The windowed sums are the run's totals (the reference's contract)."""
    res = fleet_run(PORT)
    slo = PORT.sim.Slo(ttft_s=0.02, percentile=95)
    s = res.timeseries(window_s, slo=slo)
    m = res.metrics
    assert int(s.arrived.sum()) == int(s.completed.sum()) == len(res.batch)
    assert int(s.tokens.sum()) == int(res.batch.output_tokens.sum())
    assert int(s.evictions.sum()) == m.total_evictions
    assert int(s.ok.sum()) == int(slo.ok_mask(m).sum())
    busy = sum(float((sl.t_end - sl.t_start).sum()) for sl in res.step_logs)
    assert np.isclose(s.busy_s.sum(), busy, rtol=1e-9)
    assert np.isclose(s.capacity_s.sum(), s.n_instances * (s.t1 - s.t0), rtol=1e-9)


def test_timeseries_rejects_bad_window():
    res = fleet_run(PORT)
    for w in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError):
            series.timeseries(res, w)


@pytest.mark.parametrize("max_requests", [None, 10])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_chrome_trace_equals_reference(run, max_requests):
    got, want = both(run)
    doc = timeline.chrome_trace(got, max_requests=max_requests)
    assert sorted_json(doc) == sorted_json(rtimeline.chrome_trace(want,
                                                                  max_requests=max_requests))
    assert timeline.validate_chrome_trace(doc) == []
    assert timeline.trace_events(got, max_requests=max_requests) == \
        rtimeline.trace_events(want, max_requests=max_requests)
    tl, rtl = timeline.Timeline.derive(got), rtimeline.Timeline.derive(want)
    assert (tl.n_requests_total, tl.n_steps_total, tl.t0, tl.t1) == \
        (rtl.n_requests_total, rtl.n_steps_total, rtl.t0, rtl.t1)
    if run == "evicting" and max_requests is None:
        marks = [e for e in doc["traceEvents"] if e["ph"] == "i" and e["name"] == "evicted"]
        assert len(marks) == int((got.batch.evictions > 0).sum()) > 0


def malformed(doc):
    """Documents the validator must reject: an unbalanced async span, a
    counter that goes back in time, a negative duration, an unknown phase,
    a missing field."""
    out = []
    bad = json.loads(json.dumps(doc))
    bad["traceEvents"].append({"ph": "b", "cat": "request", "id": 999_999, "name": "queue",
                               "pid": 4, "tid": 0, "ts": 0.0})
    out.append(bad)
    bad = json.loads(json.dumps(doc))
    last = max((e for e in bad["traceEvents"] if e["ph"] == "C"), key=lambda e: e["ts"])
    bad["traceEvents"].append(dict(last, ts=last["ts"] - 1.0))
    out.append(bad)
    bad = json.loads(json.dumps(doc))
    next(e for e in bad["traceEvents"] if e["ph"] == "X")["dur"] = -1.0
    out.append(bad)
    bad = json.loads(json.dumps(doc))
    bad["traceEvents"][0]["ph"] = "Q"
    out.append(bad)
    bad = json.loads(json.dumps(doc))
    del next(e for e in bad["traceEvents"] if e["ph"] == "X")["ts"]
    out.append(bad)
    out.append({"traceEvents": "nope"})
    out.append([])
    return out


def test_validator_equals_reference():
    doc = timeline.chrome_trace(fleet_run(PORT), max_requests=5)
    for i, bad in enumerate(malformed(doc)):
        errs = timeline.validate_chrome_trace(bad)
        assert errs, i
        assert errs == rtimeline.validate_chrome_trace(bad), i
    assert any("monotone" in m for m in timeline.validate_chrome_trace(malformed(doc)[1]))


def test_write_chrome_trace_roundtrips(tmp_path):
    got, want = both("fleet")
    doc = timeline.write_chrome_trace(tmp_path / "port.json", got)
    rtimeline.write_chrome_trace(tmp_path / "ref.json", want)
    loaded = json.loads((tmp_path / "port.json").read_text())
    assert sorted_json(loaded) == sorted_json(json.loads((tmp_path / "ref.json").read_text()))
    assert loaded["traceEvents"] == json.loads(json.dumps(doc))["traceEvents"]
    assert timeline.validate_chrome_trace(loaded) == []


@pytest.mark.parametrize("run", ["fleet", "fleet_level0", "evicting", "autoscaled"])
def test_store_crosses_between_the_packages(run, tmp_path):
    got, want = both(run)
    rstore.save_result(tmp_path / "ref.npz", want)
    store.save_result(tmp_path / "port.npz", got)
    # a file the reference saved loads in the port equal to the port's run
    assert_same_result(store.load_result(tmp_path / "ref.npz"), got)
    # the port's own files round-trip, and load in the reference too
    back = store.load_result(tmp_path / "port.npz")
    assert_same_result(back, got)
    assert_same_result(rstore.load_result(tmp_path / "port.npz"), want)
    for la, lb in zip(got.step_logs, back.step_logs):
        assert (la.prefill_tokens is None and lb.prefill_tokens is None) or \
            np.array_equal(la.prefill_tokens, lb.prefill_tokens)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert sorted_json(timeline.chrome_trace(back)) == sorted_json(timeline.chrome_trace(got))


def test_store_rejects_another_schema(tmp_path):
    np.savez(tmp_path / "x.npz", schema=np.array("something.else/v1"))
    with pytest.raises(ValueError, match="schema"):
        store.load_result(tmp_path / "x.npz")


def explain_pair(workloads, configs=None, **kw):
    port_cfgs = None if configs is None else [copa.TABLE_V_BY_NAME[c] for c in configs]
    ref_cfgs = None if configs is None else [rcopa.TABLE_V_BY_NAME[c] for c in configs]
    return (attribution.explain(workloads, port_cfgs, device="cpu", **kw),
            rattribution.explain(workloads, ref_cfgs, **kw))


EXPLAIN_CASES = {
    "mlperf": (["mlperf.*"], None, {}),
    "mlperf_train_large": (["mlperf.train.*.large"], ["GPU-N", "HBM+L3"], {}),
    "scaleout": (["scaleout.mlperf.train.resnet"], ["GPU-N", "HBML+L3"],
                 {"gpu_counts": (1, 2, 4), "ici_bandwidth": 600e9, "ici_latency_s": 1e-6}),
}


@pytest.mark.parametrize("case", sorted(EXPLAIN_CASES))
def test_explain_equals_reference(case):
    workloads, configs, kw = EXPLAIN_CASES[case]
    got, want = explain_pair(workloads, configs, **kw)
    assert got.to_json() == want.to_json()
    assert got.table() == want.table()
    assert got.roofline() == want.roofline()
    assert [c.bottleneck for c in got.cells] == [c.bottleneck for c in want.cells]
    assert got.workloads == want.workloads and got.configs == want.configs
    for c in got.cells:
        assert c.margin >= 1.0 and sum(c.bound_s.values()) == pytest.approx(c.time_s,
                                                                             rel=1e-12)
        assert dataclasses.astuple(c) == \
            dataclasses.astuple(want.cell(c.workload, c.config, c.n_gpus))
    if case == "scaleout":
        assert {c.n_gpus for c in got.cells} == {1, 2, 4}
        assert all((c.bound_s["ici"] > 0) == (c.n_gpus > 1) for c in got.cells)


def test_explain_engine_on_the_port_engine():
    from repro_torch.core.sweep import SweepEngine

    eng = SweepEngine(["mlperf.train.resnet.large"], configs=[copa.GPU_N_BASE, copa.HBM_L3],
                      device="cpu")
    grid = eng.run()
    rep = attribution.explain_engine(eng)
    for row in grid.rows:
        assert np.isclose(rep.cell(row.trace, row.config, row.n_gpus).time_s, row.time_s,
                          rtol=1e-12, atol=0.0)
    with pytest.raises(KeyError, match="no cell"):
        rep.cell("nothing", "GPU-N")


# -- the CLI: the port's against the reference's, wall-clock fields left out

def cli_out(main, argv, capsys, tmp, tag):
    """``main(argv)``'s exit code and stdout, each path under ``tmp`` the
    same for both packages (``{d}`` in ``argv`` is ``tmp / tag``)."""
    d = tmp / tag
    d.mkdir(exist_ok=True)
    capsys.readouterr()
    code = main([a.format(d=d) for a in argv])
    return code, capsys.readouterr().out.replace(str(d), "<d>")


CLI_CASES = {
    "run": [["run", "--demo", "3x150", "-o", "{d}/r.npz"]],
    "run_paged": [["run", "--demo", "2x120", "--paged", "--seed", "3", "-o", "{d}/r.npz"]],
    "trace": [["run", "--demo", "3x150", "-o", "{d}/r.npz"],
              ["trace", "{d}/r.npz", "--check", "-o", "{d}/t.json"],
              ["trace", "--demo", "2x60", "--max-requests", "20", "--check"]],
    "timeseries": [["run", "--demo", "3x150", "-o", "{d}/r.npz"],
                   ["timeseries", "{d}/r.npz", "--window", "0.05", "--slo-ttft", "0.01",
                    "--json", "{d}/s.json"],
                   ["timeseries", "--demo", "2x80", "--obs-level", "0"]],
    "explain": [["explain", "mlperf.infer.gnmt.large", "mlperf.train.*.large",
                 "--configs", "GPU-N", "HBM+L3", "--roofline", "{d}/roof.json",
                 "--json", "{d}/e.json"],
                ["explain", "scaleout.mlperf.train.resnet", "--gpu-counts", "1", "4",
                 "--ici-bandwidth", "5e10"]],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_reference(case, capsys, tmp_path):
    for argv in CLI_CASES[case]:
        extra = ["--device", "cpu"] if argv[0] == "explain" else []
        got = cli_out(cli.main, argv + extra, capsys, tmp_path, "port")
        want = cli_out(rcli.main, argv, capsys, tmp_path, "ref")
        assert got == want, argv
        assert got[0] == 0
    for name in ("t.json", "s.json", "roof.json", "e.json"):
        a, b = tmp_path / "port" / name, tmp_path / "ref" / name
        if b.exists():
            assert sorted_json(json.loads(a.read_text())) == \
                sorted_json(json.loads(b.read_text())), name
    if (tmp_path / "ref" / "r.npz").exists():
        assert_same_result(store.load_result(tmp_path / "port" / "r.npz"),
                           rstore.load_result(tmp_path / "ref" / "r.npz"))


def test_cli_trace_check_fails_on_a_bad_document(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(timeline, "validate_chrome_trace", lambda doc: ["planted"])
    assert cli.main(["trace", "--demo", "2x20", "--check", "-o", str(tmp_path / "t.json")]) == 1
    assert "planted" in capsys.readouterr().err


def test_cli_demo_equals_reference():
    got, want = cli._demo_result("4x200"), rcli._demo_result("4x200")
    assert_same_result(got, want)
    assert len(got.batch) == 200 and len(got.step_logs) == 4
    assert all(sl.prefill_tokens is not None for sl in got.step_logs)


def test_cli_module_entry_runs(tmp_path):
    """``python -m repro_torch.obs`` without the JAX package on the path."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "run", "--demo", "2x40", "-o",
                          str(tmp_path / "r.npz")], capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "40 requests" in out.stdout


# -- the package surface

def test_homes_name_only_the_port():
    homes = obs._HOMES
    assert set(homes) == set(robs._HOMES) == set(obs.__all__)
    for name, home in homes.items():
        assert home.startswith("repro_torch."), (name, home)
        assert home == robs._HOMES[name].replace("repro.", "repro_torch.", 1)
        value = getattr(obs, name)
        assert not inspect.ismodule(value), name
        assert value is getattr(__import__(home, fromlist=[name]), name)
    assert callable(obs.explain) and obs.ObsConfig is PORT.sim.ObsConfig
    # no string in the package names a module of the JAX package
    for path in (ROOT / "src" / "repro_torch" / "obs").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not re.fullmatch(r"repro(\.\w+)+", node.value) or \
                    node.value == "repro.obs", (path.name, node.value)


def test_serve_imports_without_obs():
    """The serve -> obs -> serve cycle never forms at import time."""
    code = ("import sys\n"
            "import repro_torch.serve.sim, repro_torch.serve.fleet, repro_torch.serve.fleetbatch\n"
            "assert not [m for m in sys.modules if m.startswith('repro_torch.obs')]\n"
            "import repro_torch.obs\n"
            "assert 'repro_torch.obs.attribution' not in sys.modules\n"
            "from repro_torch.obs import timeseries\n"
            "assert 'repro_torch.obs.series' in sys.modules\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('repro', 'jax')]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
