"""COPA vs KV compression: two routes to serving capacity, one cost grid,
through the PyTorch port (``paged_kv_study.py`` with ``repro_torch`` in
place of ``repro``).

The COPA paper buys HBM capacity with hardware — a memory-system module
(MSM) like HBML+L3 adds 1.67x DRAM + bandwidth on package. Buddy
Compression (arXiv 1903.02596) buys capacity in software instead: KV pages
compress ~2x, at a bandwidth tax on every compressed access. This study
prices both routes through the SAME paged serving stack and asks where
each one wins:

1. derive the per-instance KV token budget per (config, policy) from the
   model's real weight footprint (``msm.kv_reserve_frac`` — a 29B MHA
   model eats 55 GiB of GPU-N's 100 GiB, so only ~40% is left for KV);
2. price per-step costs with the compression bandwidth tax folded into
   the KV sweep buckets (``serve_cost_grids(..., kv_policy=...)``);
3. replay one diurnal chat trace (``arrivals.diurnal.chat`` — evening-peak
   hourly profile) through paged fleets (block-table residency,
   ``PagedKvSpec``) across config x compression x oversubscription, and
   size each fleet against a TTFT SLO via :func:`instances_to_meet_slo`.

The punchline the assertions pin down: on capacity-starved GPU-N the 2x
ratio converts straight into batch occupancy and SHRINKS the SLO fleet,
while on HBML+L3 — whose MSM already bought enough DRAM that the batch
bound binds first — the same knob is pure bandwidth tax and GROWS the
fleet. Which route wins is a property of the config, not of compression.

The run also drops a Chrome-trace timeline of the most eviction-pressured
cell (open ``build/paged_kv_timeline.json`` in chrome://tracing or
https://ui.perfetto.dev) and prints its windowed metric rollup — the
``repro_torch.obs`` view of where inside the diurnal profile the evictions and
the TTFT tail actually live.

    PYTHONPATH=src python examples/paged_kv_study_torch.py [--fleet 12]   # on the card
    PYTHONPATH=src python examples/paged_kv_study_torch.py --device cpu   # NumPy scans

``--device`` is where ``serve_cost_grids`` runs its scans; without it the
card, and the example fails where there is none. The fleets are NumPy on
the host either way.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, "src")

from repro_torch.configs.base import ModelConfig
from repro_torch.core import copa, msm
from repro_torch.core.sweep import serve_cost_grids
from repro_torch.obs.timeline import write_chrome_trace
from repro_torch.serve.fleet import FleetSim, instances_to_meet_slo
from repro_torch.serve.paged import PagedKvSpec
from repro_torch.serve.sim import ObsConfig, Slo
from repro_torch.workloads import registry

# A dense 29B MHA model: full-width K+V per layer per token, so KV is
# expensive (1.5 MiB/token bf16) and the weight footprint (55 GiB) eats
# most of a 100 GiB part — the regime where KV residency decides batch.
MODEL = ModelConfig(name="study-29b-mha", family="dense", n_layers=60,
                    d_model=6656, n_heads=52, n_kv_heads=52, d_ff=17920,
                    vocab_size=128256)
ELEMS_PER_TOKEN = 2 * MODEL.n_layers * MODEL.d_model
KV_BYTES_PER_TOKEN = ELEMS_PER_TOKEN * 2.0          # bf16

CONFIGS = [copa.GPU_N_BASE, copa.HBML_L3]           # base die vs big-DRAM MSM
POLICIES = {
    "off": msm.DECODE_MSM,
    "2x":  msm.compose("msm_decode", kv_compression_ratio=2.0,
                       kv_compression_bw_tax=0.25),
}
PAGE = 16
SEQ_EDGES = (96_000.0,)      # one resident bucket: both policies price the
                             # same sweep footprint, tax excepted
MAX_BATCH = 64
SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=12,
                    help="fixed fleet size for the goodput column")
    ap.add_argument("--max-instances", type=int, default=48)
    ap.add_argument("--trace-out", default="build/paged_kv_timeline.json",
                    help="Chrome-trace timeline of the most evicting cell "
                         "('' to skip)")
    ap.add_argument("--device", default=None,
                    help="where the cost grids' scans run (default: the CUDA device)")
    args = ap.parse_args(argv)

    trace = registry.arrivals("arrivals.diurnal.chat")
    slo = Slo(ttft_s=2.0, percentile=95)
    grid_kw = dict(tokens_per_pass=50, kv_bytes_per_token=KV_BYTES_PER_TOKEN,
                   seq_edges=SEQ_EDGES, page_size=PAGE,
                   prefill_s_per_token=2e-5, device=args.device)
    grids = {pol: serve_cost_grids("gnmt", CONFIGS, kv_policy=POLICIES[pol],
                                   **grid_kw)
             for pol in POLICIES}

    print(f"model {MODEL.name}: {MODEL.n_params() / 1e9:.1f}B params, "
          f"{KV_BYTES_PER_TOKEN / 2**20:.2f} MiB KV/token")
    print(f"trace {trace.name}: {trace.rate:.0f} r/s mean, "
          f"{trace.n_requests} requests, {len(trace.profile)}-slot profile")
    print(f"SLO: TTFT p{slo.percentile:.0f} <= {slo.ttft_s:.1f}s   "
          f"goodput at a fixed fleet of {args.fleet}\n")

    hdr = (f"{'config':10s} {'comp':4s} {'oversub':7s} {'kv cap':>9s} "
           f"{'fleet':>5s} {'goodput':>9s} {'ttft p95':>9s} {'evict':>5s}")
    print(hdr)
    print("-" * len(hdr))
    fleet_for = {}
    hot = None          # (evictions, cell label, grid, kw) — worst cell
    t0 = time.time()
    for cfg in CONFIGS:
        spec = cfg.build()
        for pol in POLICIES:
            cap = float(msm.kv_token_capacity(spec, POLICIES[pol],
                                              ELEMS_PER_TOKEN,
                                              model_config=MODEL))
            grid = grids[pol][cfg.name]
            for oversub, evict in ((1.0, "none"), (1.5, "lru")):
                paged = PagedKvSpec(page_size=PAGE, oversubscription=oversub,
                                    eviction=evict)
                kw = dict(max_batch=MAX_BATCH, kv_capacity_tokens=cap,
                          paged=paged)
                n = instances_to_meet_slo(
                    grid, trace, slo, seed=SEED,
                    max_instances=args.max_instances, **kw)
                res = FleetSim(grid, args.fleet, **kw).run(trace, seed=SEED)
                m = res.metrics
                evs = int(res.batch.evictions.sum())
                print(f"{cfg.name:10s} {pol:4s} {oversub:7.1f} {cap:9.0f} "
                      f"{str(n):>5s} {m.goodput_rps(slo):7.1f}r/s "
                      f"{m.percentile('ttft', 95):8.3f}s "
                      f"{evs:5d}")
                if hot is None or evs > hot[0]:
                    hot = (evs, f"{cfg.name}/{pol}/x{oversub}", grid, kw)
                if oversub == 1.0:
                    fleet_for[cfg.name, pol] = n
    print(f"\n[{time.time() - t0:.1f}s total]")

    if args.trace_out:
        # re-run the worst cell with the obs column on: the timeline gets
        # prefill/decode phase naming on its step spans (timing is
        # bit-identical with the knob on — asserted in tests/test_obs.py)
        _, label, grid, kw = hot
        os.makedirs(os.path.dirname(args.trace_out) or ".", exist_ok=True)
        res = FleetSim(grid, args.fleet, obs=ObsConfig(level=1),
                       **kw).run(trace, seed=SEED)
        doc = write_chrome_trace(args.trace_out, res, max_requests=2_000)
        series = res.timeseries(res.metrics.makespan_s / 12, slo=slo)
        print(f"\ntimeline of {label} -> {args.trace_out} "
              f"({len(doc['traceEvents'])} events; chrome://tracing)")
        print(series.table())

    n_base_off = fleet_for["GPU-N", "off"]
    n_base_2x = fleet_for["GPU-N", "2x"]
    n_msm_off = fleet_for["HBML+L3", "off"]
    n_msm_2x = fleet_for["HBML+L3", "2x"]
    # The study's claims, pinned: compression must change the fleet size in
    # opposite directions on the two configs.
    assert n_base_2x < n_base_off, \
        "compression should shrink the capacity-bound GPU-N fleet"
    assert n_msm_2x > n_msm_off, \
        "compression should cost the batch-bound HBML+L3 fleet instances"
    print(f"GPU-N:   compression shrinks the SLO fleet "
          f"{n_base_off} -> {n_base_2x} (capacity-bound: 2x ratio becomes "
          f"batch occupancy)")
    print(f"HBML+L3: compression grows the SLO fleet "
          f"{n_msm_off} -> {n_msm_2x} (batch-bound already: the knob is "
          f"pure bandwidth tax)")
    print(f"at a {n_base_2x}-instance budget the winning config flips: "
          f"without compression only HBML+L3 meets the SLO "
          f"(GPU-N needs {n_base_off}); with it, GPU-N does too — the "
          f"software knob substitutes for the MSM upgrade on this trace.")
    return fleet_for


if __name__ == "__main__":
    main()
