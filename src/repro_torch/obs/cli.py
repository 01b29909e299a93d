"""``python -m repro_torch.obs`` — trace / timeseries / explain over saved runs.

Workflow: ``run`` executes a fleet simulation once (a named arrival spec,
or the self-contained ``--demo NxM`` fleet that replicates the serving
bench's synthetic grid) and saves the raw artifacts as ``.npz``; ``trace``
and ``timeseries`` then derive views from the saved file — or straight
from ``--demo`` for one-shot use. ``explain`` needs no saved run: it
attributes sweep-engine cells from workload/config names, with the sweep's
scans on the card unless ``--device cpu`` asks for the NumPy scans.

    PYTHONPATH=src python -m repro_torch.obs run --demo 8x2000 -o build/r.npz
    PYTHONPATH=src python -m repro_torch.obs trace build/r.npz --check -o build/t.json
    PYTHONPATH=src python -m repro_torch.obs timeseries build/r.npz
    PYTHONPATH=src python -m repro_torch.obs explain 'mlperf.train.*.large' --device cpu

The ``--demo`` fleet is deliberately a replica of ``benchmarks/
bench_serving.py``'s fixed-seed 64x20k row (same synthetic cost grid,
same 0.8x-saturation Poisson arrivals), NOT an import of it: CI's obs
smoke step must be able to generate and schema-check the flagship
timeline without depending on the benchmark package.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _demo_result(shape: str, *, obs_level: int = 1, paged: bool = False,
                 seed: int = 0):
    """Run the self-contained demo fleet: ``shape`` is ``NxM`` instances x
    requests, e.g. ``64x20000`` (the bench flagship) or ``4x200``."""
    from repro_torch.core.sweep import CostGrid
    from repro_torch.serve.fleet import FleetSim
    from repro_torch.serve.paged import PagedKvSpec
    from repro_torch.serve.sim import ArrivalSpec, LengthDist, ObsConfig

    try:
        n_inst, n_req = (int(x) for x in shape.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--demo wants NxM (e.g. 64x20000), got {shape!r}")
    mb = 16
    batches = tuple(2 ** k for k in range(mb.bit_length()))
    edges = (2048.0, 8192.0, float("inf"))
    tab = np.asarray([[1e-3 * (1.0 + 0.02 * b + 0.05 * j)
                       for j in range(len(edges))] for b in batches])
    grid = CostGrid("obs-demo", batches, edges, tab,
                    prefill_s_per_token=1e-6)
    step = float(grid.step_time(mb, 4096.0))
    rate = n_inst * 0.8 * mb / (step * 64.0)
    spec = ArrivalSpec("obs.demo", rate, n_req,
                       prompt=LengthDist("fixed", 128),
                       output=LengthDist("uniform", low=32, high=96))
    kw = dict(max_batch=mb, kv_capacity_tokens=float("inf"),
              obs=ObsConfig(level=obs_level))
    if paged:
        kw["paged"] = PagedKvSpec(page_size=16)
    return FleetSim(grid, n_inst, **kw).run(spec, seed=seed)


def _load_or_demo(ns):
    from repro_torch.obs.store import load_result

    if ns.demo:
        return _demo_result(ns.demo, obs_level=ns.obs_level,
                            paged=ns.paged, seed=ns.seed)
    if not ns.result:
        raise SystemExit("need a RESULT.npz (or --demo NxM)")
    return load_result(ns.result)


def _add_source_args(p):
    p.add_argument("result", nargs="?", default=None,
                   help="saved .npz from the run subcommand")
    p.add_argument("--demo", metavar="NxM", default=None,
                   help="run the demo fleet instead (instances x requests)")
    p.add_argument("--obs-level", type=int, default=1, choices=(0, 1),
                   help="ObsConfig level for --demo (default 1)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV residency for --demo")
    p.add_argument("--seed", type=int, default=0)


def cmd_run(ns) -> int:
    from repro_torch.obs.store import save_result

    res = _demo_result(ns.demo or "8x2000", obs_level=ns.obs_level,
                       paged=ns.paged, seed=ns.seed)
    save_result(ns.out, res)
    m = res.metrics
    print(f"{ns.out}: {len(res.batch)} requests, "
          f"{sum(len(sl.t_start) for sl in res.step_logs)} steps, "
          f"{res.n_instances_final} instances, "
          f"makespan {m.makespan_s:.2f}s, "
          f"throughput {m.throughput_rps:.1f} r/s")
    return 0


def cmd_trace(ns) -> int:
    from repro_torch.obs.timeline import chrome_trace, validate_chrome_trace

    res = _load_or_demo(ns)
    doc = chrome_trace(res, max_requests=ns.max_requests)
    if ns.check:
        errs = validate_chrome_trace(doc)
        if errs:
            for e in errs[:20]:
                print(f"SCHEMA: {e}", file=sys.stderr)
            print(f"{len(errs)} schema error(s)", file=sys.stderr)
            return 1
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(doc, f)
        od = doc["otherData"]
        print(f"{ns.out}: {len(doc['traceEvents'])} events "
              f"({od['n_instances']} instances, {od['n_requests']} requests"
              + (f", {od['dropped_requests']} dropped)"
                 if od["dropped_requests"] else ")")
              + (" [schema ok]" if ns.check else ""))
    else:
        json.dump(doc, sys.stdout)
        print()
    return 0


def cmd_timeseries(ns) -> int:
    from repro_torch.obs.series import timeseries
    from repro_torch.serve.sim import Slo

    res = _load_or_demo(ns)
    slo = Slo(ttft_s=ns.slo_ttft, percentile=95) \
        if ns.slo_ttft is not None else None
    window = ns.window
    if window is None:
        window = max(res.metrics.makespan_s / 40.0, 1e-9)
    series = timeseries(res, window, slo=slo)
    print(series.table())
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump(series.to_json(), f, indent=1)
        print(f"\nwrote {ns.json} ({len(series)} windows)")
    return 0


def cmd_explain(ns) -> int:
    from repro_torch.core import copa
    from repro_torch.obs.attribution import explain

    configs = None
    if ns.configs:
        try:
            configs = [copa.TABLE_V_BY_NAME[c] for c in ns.configs]
        except KeyError as e:
            raise SystemExit(
                f"unknown config {e.args[0]!r}; choose from "
                f"{sorted(copa.TABLE_V_BY_NAME)}")
    kw = {}
    if ns.gpu_counts:
        kw["gpu_counts"] = ns.gpu_counts
    if ns.ici_bandwidth is not None:
        kw["ici_bandwidth"] = ns.ici_bandwidth
    kw["device"] = ns.device
    report = explain(ns.workloads, configs, **kw)
    print(report.table())
    if ns.roofline:
        with open(ns.roofline, "w") as f:
            json.dump(report.roofline(), f, indent=1)
        print(f"\nwrote {ns.roofline} "
              f"({len(report.cells)} points, "
              f"{len(report.peaks)} config ceilings)")
    if ns.json:
        with open(ns.json, "w") as f:
            json.dump(report.to_json(), f, indent=1)
        print(f"wrote {ns.json}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="post-hoc observability: timelines, windowed metrics, "
                    "bottleneck attribution")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run the demo fleet, save raw artifacts")
    p.add_argument("--demo", metavar="NxM", default="8x2000",
                   help="instances x requests (default 8x2000)")
    p.add_argument("-o", "--out", default="fleet_result.npz")
    p.add_argument("--obs-level", type=int, default=1, choices=(0, 1))
    p.add_argument("--paged", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("trace",
                       help="Chrome trace_event JSON (chrome://tracing, "
                            "Perfetto)")
    _add_source_args(p)
    p.add_argument("-o", "--out", default=None,
                   help="output .json (default: stdout)")
    p.add_argument("--max-requests", type=int, default=None,
                   help="cap request-lifecycle spans (instance lanes and "
                        "counters always cover the full run)")
    p.add_argument("--check", action="store_true",
                   help="schema-validate the emitted document")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("timeseries", help="windowed metric table")
    _add_source_args(p)
    p.add_argument("--window", type=float, default=None,
                   help="window width in seconds (default: makespan/40)")
    p.add_argument("--slo-ttft", type=float, default=None,
                   help="TTFT SLO seconds: adds ok/goodput columns (p95)")
    p.add_argument("--json", default=None, help="also write JSON rollup")
    p.set_defaults(fn=cmd_timeseries)

    p = sub.add_parser("explain",
                       help="bottleneck attribution over the sweep engine")
    p.add_argument("workloads", nargs="+",
                   help="scenario names or globs, e.g. 'mlperf.train.*.large'")
    p.add_argument("--configs", nargs="+", default=None,
                   help="Table-V config names (default: all)")
    p.add_argument("--gpu-counts", nargs="+", type=int, default=None)
    p.add_argument("--ici-bandwidth", type=float, default=None,
                   help="bytes/s per direction (default: ideal fabric)")
    p.add_argument("--roofline", default=None,
                   help="write plot-ready roofline JSON here")
    p.add_argument("--json", default=None, help="write the full report JSON")
    p.add_argument("--device", default=None,
                   help="where the sweep's scans run (default: the CUDA device, "
                        "an error without one; 'cpu' runs the NumPy scans)")
    p.set_defaults(fn=cmd_explain)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    raise SystemExit(main())
