"""Online cost-grid repricing: the autoscaler consults fresh grids per tick,
through the PyTorch port (``online_repricing.py`` with ``repro_torch`` in
place of ``repro``).

The incremental suite machinery makes `serve_cost_grids` cheap enough
to call INSIDE a fleet control loop. This demo runs a diurnal 24-tick
scenario where the per-token KV footprint drifts tick to tick (longer
contexts through the evening peak — exactly the situation where yesterday's
cost grid misprices today's step times):

1. every tick reprices the (batch x KV-bucket) grids for both configs with
   that tick's ``kv_bytes_per_token`` — the changed KV byte counts APPEND
   rows to the process-wide KV-sweep session suite (O(new trace), capacity
   union inherited) instead of keying a cold suite per tick;
2. the queue-depth autoscaler (``repro_torch.ft.elastic.QueueDepthAutoscaler``)
   then resizes the fleet from the repriced grid: offered load over the
   repriced saturation ceiling gives the backlog observation it reacts to;
3. the per-tick wall cost of repricing is printed — the first tick pays the
   one-time session build, every later tick reprices in milliseconds.

    PYTHONPATH=src python examples/online_repricing_torch.py [--ticks 24]   # on the card
    PYTHONPATH=src python examples/online_repricing_torch.py --device cpu   # NumPy scans

``--device`` is where ``serve_cost_grids`` runs its scans; without it the
card, and the example fails where there is none. The session suite is kept
for each place the scans run (``sweep._KV_SESSIONS``, keyed by
``cachesim._backend_key``).
"""
import argparse
import math
import sys
import time

sys.path.insert(0, "src")

from repro_torch.core import cachesim, copa
from repro_torch.core.cachesim import stream_cache_stats
from repro_torch.core.sweep import serve_cost_grids
import repro_torch.core.sweep as sweep_mod
from repro_torch.ft.elastic import QueueDepthAutoscaler

BASE_KV_PER_TOKEN = 8 * 1024 * 2 * 4       # gnmt decoder KV proxy (bytes)
CONFIGS = [copa.GPU_N_BASE, copa.HBM_L3]
OUT_TOKENS = 48                            # mean decode length per request


def offered_rps(tick: int, ticks: int) -> float:
    """Diurnal offered load: trough 60k req/s, peak 220k req/s (a
    datacenter-scale gnmt fleet — one instance saturates at ~7-10k)."""
    phase = 2.0 * math.pi * tick / ticks
    return 140e3 + 80e3 * math.sin(phase - math.pi / 2)


def kv_bytes_per_token(tick: int, ticks: int) -> float:
    """Context-length drift: up to +60% KV per token through the peak."""
    phase = 2.0 * math.pi * tick / ticks
    return BASE_KV_PER_TOKEN * (1.0 + 0.6 * max(0.0, math.sin(phase)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="where the cost grids' scans run (default: the CUDA device)")
    args = ap.parse_args(argv)
    session_key = cachesim._backend_key(cachesim.scan_device(args.device))

    scaler = QueueDepthAutoscaler(max_instances=256)
    n, peak_n = 1, 1
    print(f"{'tick':>4s} {'rps':>6s} {'kv/tok':>8s} {'reprice':>9s} "
          f"{'rps/inst':>8s} {'fleet':>5s}  session")
    for tick in range(args.ticks):
        rps = offered_rps(tick, args.ticks)
        kvpt = kv_bytes_per_token(tick, args.ticks)

        t0 = time.perf_counter()
        grids = serve_cost_grids("gnmt", CONFIGS, tokens_per_pass=50,
                                 kv_bytes_per_token=kvpt, device=args.device)
        reprice_ms = (time.perf_counter() - t0) * 1e3

        grid = grids["GPU-N"]
        # Repriced saturation ceiling -> the backlog observation the
        # autoscaler reacts to: requests the current fleet cannot absorb
        # appear as queued batches; a draining fleet reports its running
        # occupancy. One tick spans several autoscale intervals, each
        # consulting the SAME repriced grid.
        per_inst = grid.saturated_rps(OUT_TOKENS)
        for _ in range(8):
            backlog = max(rps - n * per_inst, 0.0) * 8.0
            running = min(rps / per_inst, float(n)) * grid.max_batch
            n = scaler.decide(n, int(backlog), int(running), grid.max_batch)
        peak_n = max(peak_n, n)

        _, suite = sweep_mod._KV_SESSIONS.get(session_key, ({}, None))
        session = suite.n_traces if suite else 0
        print(f"{tick:>4d} {rps:>6.1f} {kvpt/1024:>7.1f}K {reprice_ms:>7.2f}ms "
              f"{per_inst:>8.2f} {n:>5d}  {session} kv rows")

    stats = stream_cache_stats()
    print(f"\nstream cache after {args.ticks} ticks: "
          f"{stats['hits']} hits / {stats['misses']} misses / "
          f"{stats['evictions']} evictions, "
          f"{stats['entries']} entries ({stats['bytes'] / 1e6:.1f} MB)")
    ideal = math.ceil(max(offered_rps(t, args.ticks)
                          for t in range(args.ticks)) / per_inst)
    print(f"peak-load ideal fleet ~{ideal} instances; "
          f"autoscaler peaked at {peak_n}, ended at {n}")
    return {"peak": peak_n, "final": n, "ideal": ideal, "stats": stats}


if __name__ == "__main__":
    main()
