"""Fleet sizing at datacenter scale: the vectorized fleet core end to end,
through the PyTorch port (``fleet_at_scale.py`` with ``repro_torch`` in
place of ``repro``).

Sizes a 200+-instance serving fleet for a bursty, mixed-rate request
stream against a latency SLO, using real COPA cost grids (converged GPU-N
vs DL-COPA MSMs from the sweep engine's cost-grid export). The workflow:

1. price the per-step costs once per config (``serve_cost_grids``);
2. replay ONE 20k-request bursty arrival trace through fleets of
   increasing size via :func:`scan_fleet` — the bisection schedule probes
   O(log N) sizes, and each probe runs the batched engine
   (``repro_torch.serve.fleetbatch``), which prices a 200-instance x 20k-request
   fleet in well under a second;
3. print the probed ladder per config plus the smallest SLO-meeting size;
4. re-run the winning GPU-N fleet with the obs column on and drop its
   Chrome-trace timeline (``build/fleet_at_scale_timeline.json`` — open in
   chrome://tracing or https://ui.perfetto.dev) plus a windowed metric
   table showing the burst cycles beating against the SLO.

The batched engine is bit-identical to the per-instance reference loop
(``FleetSim.run(..., batched=False)`` — asserted in
tests/test_torch_fleet.py), so the answer is exactly what the slow loop
would give, ~10x sooner.

    PYTHONPATH=src python examples/fleet_at_scale_torch.py [--requests 20000]   # on the card
    PYTHONPATH=src python examples/fleet_at_scale_torch.py --device cpu         # NumPy scans

``--device`` is where ``serve_cost_grids`` runs its scans; without it the
card, and the example fails where there is none. The fleet is NumPy on the
host either way.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, "src")

from repro_torch.core import copa
from repro_torch.core.sweep import serve_cost_grids
from repro_torch.obs.timeline import write_chrome_trace
from repro_torch.serve.fleet import FleetSim, scan_fleet
from repro_torch.serve.sim import ArrivalSpec, LengthDist, ObsConfig, Slo

KV_BYTES_PER_TOKEN = 8 * 1024 * 2 * 4      # gnmt decoder KV proxy

CONFIGS = [copa.GPU_N_BASE, copa.HBM_L3]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=20_000)
    ap.add_argument("--max-instances", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default="build/fleet_at_scale_timeline.json",
                    help="Chrome-trace timeline of the sized GPU-N fleet "
                         "('' to skip)")
    ap.add_argument("--device", default=None,
                    help="where the cost grids' scans run (default: the CUDA device)")
    args = ap.parse_args(argv)

    grids = serve_cost_grids(
        "gnmt", CONFIGS, tokens_per_pass=50,
        kv_bytes_per_token=KV_BYTES_PER_TOKEN, device=args.device,
    )
    base = grids["GPU-N"]
    out_mean = 48
    # offered load sized so the GPU-N answer lands above 200 instances,
    # with diurnal-style bursts: 25% of each period at 3x the trough rate
    rate = 320 * 0.8 * base.saturated_rps(out_mean)
    # burst period scaled to the trace so several on/off cycles land
    # inside it regardless of --requests
    period = args.requests / rate / 5.0
    arrivals = ArrivalSpec(
        name="example.mixed", rate=rate, n_requests=args.requests,
        burst_factor=3.0, burst_fraction=0.25, period_s=period,
        prompt=LengthDist("fixed", mean=12, floor=1),
        output=LengthDist("lognormal", mean=out_mean, sigma=0.4, floor=4),
    )
    slo = Slo(ttft_s=10 * base.step_time(1), tpot_s=5 * base.step_time(1),
              percentile=95)
    print(f"offered: {rate:.0f} r/s bursty (peak {2 * rate:.0f}), "
          f"{args.requests} requests; SLO: p{slo.percentile:.0f} "
          f"TTFT<={slo.ttft_s * 1e3:.0f}ms TPOT<={slo.tpot_s * 1e3:.1f}ms")

    sized = {}
    for name, grid in grids.items():
        t0 = time.perf_counter()
        scanned = scan_fleet(grid, arrivals, slo,
                             max_instances=args.max_instances,
                             seed=args.seed, strategy="bisect")
        dt = time.perf_counter() - t0
        met = [n for n, m in scanned.items() if slo.met(m)]
        ladder = " ".join(
            f"{n}{'*' if slo.met(m) else ''}"
            for n, m in sorted(scanned.items()))
        answer = f"{min(met)} instances" if met \
            else f">{args.max_instances} (cap)"
        print(f"{name:<12} probed [{ladder}] -> {answer} "
              f"({len(scanned)} probes, {dt:.1f}s)")
        if met:
            sized[name] = min(met)

    if args.trace_out and "GPU-N" in sized:
        # one more batched run of the answer-sized fleet, obs column on,
        # and the whole run becomes a browsable timeline + metric table
        n = sized["GPU-N"]
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        res = FleetSim(grids["GPU-N"], n,
                       obs=ObsConfig(level=1)).run(arrivals, seed=args.seed)
        doc = write_chrome_trace(args.trace_out, res, max_requests=2_000)
        series = res.timeseries(res.metrics.makespan_s / 12, slo=slo)
        print(f"\ntimeline of the {n}-instance GPU-N fleet -> "
              f"{args.trace_out} ({len(doc['traceEvents'])} events; "
              f"chrome://tracing)")
        print(series.table())
    return sized


if __name__ == "__main__":
    main()
