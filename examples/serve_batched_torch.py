"""Serving under load: the request-level simulator on COPA configs, through
the PyTorch port (``serve_batched.py`` with ``repro_torch`` in place of
``repro``).

Replays Poisson arrivals at a few offered rates through one simulated
serving instance per config (converged GPU-N vs DL-COPA MSMs) and prints
the latency-percentile + SLO-goodput table — the fleet-level view of the
paper's serving claim. The per-token step costs come straight from the
sweep engine's cost-grid export over the ``serve.mlperf.gnmt.b*`` scenarios
(gnmt's 50-step decoder priced per output token, KV residency bucketed so a
cache that fits the COPA L3 is swept at UHB bandwidth).

    PYTHONPATH=src python examples/serve_batched_torch.py [--requests 400]   # on the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu       # NumPy scans

``--device`` is where ``serve_cost_grids`` runs its stack-distance and
traffic scans; without it the card, and the example fails where there is
none. The request-level simulator itself is NumPy on the host. The model
driver (real prefill/decode) is ``python -m repro_torch.launch.serve``;
``--sim`` there runs this same analytic path.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core import copa
from repro_torch.core.sweep import serve_cost_grids
from repro_torch.serve.fleet import latency_goodput_rows
from repro_torch.serve.sim import ArrivalSpec, LengthDist, Slo

# gnmt decoder KV proxy: 8 layers x 1024 hidden x K+V x fp32.
KV_BYTES_PER_TOKEN = 8 * 1024 * 2 * 4

CONFIGS = [copa.GPU_N_BASE, copa.HBM_L3, copa.HBML_L3L]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the cost grids' scans run (default: the CUDA device)")
    args = ap.parse_args(argv)

    # Prefill priced per config from a real prefill-chunk trace (the
    # lm.*.prefill_* cells) instead of a flat s/token knob.
    grids = serve_cost_grids(
        "gnmt", CONFIGS, tokens_per_pass=50,
        kv_bytes_per_token=KV_BYTES_PER_TOKEN,
        prefill_scenario="lm.tinyllama-1.1b.prefill_32k", device=args.device,
    )
    base = grids["GPU-N"]
    out_mean = 48
    sat = base.saturated_rps(out_mean)   # GPU-N full-batch ceiling
    rates = [round(f * sat, 1) for f in (0.5, 0.8, 1.1)]
    arrivals = ArrivalSpec(
        name="example.poisson", rate=sat, n_requests=args.requests,
        prompt=LengthDist("fixed", mean=12, floor=1),
        output=LengthDist("lognormal", mean=out_mean, sigma=0.4, floor=4),
    )
    slo = Slo(ttft_s=4 * base.step_time(1), tpot_s=2 * base.step_time(1),
              percentile=95)

    rows = latency_goodput_rows(grids, arrivals, rates, slo, seed=args.seed)
    hdr = (f"{'config':<12} {'rate r/s':>9} {'TTFT p50':>9} {'TTFT p99':>9} "
           f"{'TPOT p99':>9} {'goodput':>8} {'SLO':>4}")
    print(f"one instance per config; SLO: p{slo.percentile:.0f} "
          f"TTFT<={slo.ttft_s*1e3:.1f}ms TPOT<={slo.tpot_s*1e3:.1f}ms")
    print(hdr)
    for r in rows:
        print(f"{r['config']:<12} {r['rate_rps']:>9.1f} "
              f"{r['ttft_p50_ms']:>7.2f}ms {r['ttft_p99_ms']:>7.2f}ms "
              f"{r['tpot_p99_ms']:>7.2f}ms {r['goodput_rps']:>8.1f} "
              f"{'ok' if r['slo_met'] else 'MISS':>4}")
    return rows


if __name__ == "__main__":
    main()
