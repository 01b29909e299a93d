"""The paper's design-space exploration through the PyTorch port's public
API: the sections of ``copa_design_sweep.py`` with ``repro_torch`` in place
of ``repro``. One SweepEngine grid over the COPA configurations (Table V) x
the MLPerf-proxy suites, the Fig-12-style scale-out projection (instances x
ICI fabric), the serving latency grid per MSM, the software-MSM
recommendation per LM cell, and the FULL-REGISTRY sweep: every scenario,
the ``kernel.*`` streams of the port's Hopper kernels included, x Table V
through one suite-batched pass.

    PYTHONPATH=src python examples/copa_design_sweep_torch.py                # on the card
    PYTHONPATH=src python examples/copa_design_sweep_torch.py --device cpu   # NumPy scans

``--device`` is where the stack-distance and traffic scans run; without it
the card, and the example fails where there is none.
"""
import argparse
import math
import sys
import time

sys.path.insert(0, "src")

import repro_torch.configs as configs
from repro_torch.core import copa, msm
from repro_torch.core.hw import MB
from repro_torch.core.sweep import SweepEngine, geomean
from repro_torch.workloads import registry

SUITES = ("mlperf.train.large", "mlperf.train.small",
          "mlperf.infer.large", "mlperf.infer.small")


def paper_suite_table(device):
    print("=== COPA design space (Table V / Fig 11) — MLPerf proxies ===")
    names = [n for s in SUITES for n in registry.suite(s)]
    grid = SweepEngine(names, configs=copa.TABLE_V, device=device).run()
    header = f"{'config':12s} {'train-lb':>9s} {'train-sb':>9s} {'infer-lb':>9s} {'infer-sb':>9s}"
    print(header)
    for cfg in copa.TABLE_V:
        cells = []
        for s in SUITES:
            traces = [registry.scenario(n).name for n in registry.suite(s)]
            cells.append(f"{grid.geomean_speedup(cfg.name, traces):9.3f}")
        print(f"{cfg.name:12s} " + " ".join(cells))


def scale_out_table(device):
    """Fig-12-style projection: fixed-global-batch DP training across 1/2/4
    GPU instances, ideal fabric vs a 600 GB/s ring all-reduce."""
    print("\n=== Scale-out projection (Fig 12): instances x ICI fabric ===")
    works = registry.scaleout_names("scaleout.mlperf.train.")
    names = [registry.scaleout(w).name for w in works]
    for label, ici in (("ideal fabric", float("inf")),
                       ("600GB/s ring", 600e9)):
        grid = SweepEngine(works, configs=[copa.GPU_N_BASE, copa.HBML_L3],
                           gpu_counts=(1, 2, 4), ici_bandwidth=ici, device=device).run()
        copa1 = grid.geomean_speedup("HBML+L3", names)
        n2 = geomean(grid.speedups("GPU-N", names, n_gpus=2))
        n4 = geomean(grid.speedups("GPU-N", names, n_gpus=4))
        eff2 = geomean(grid.result(t, "GPU-N", 2).scaling_efficiency
                       for t in names)
        reached = [n for n in
                   grid.instances_to_match("GPU-N", "HBML+L3", names).values()
                   if n is not None]
        inst = sum(reached) / len(reached) if reached else float("nan")
        print(f"{label:14s} HBML+L3@1={copa1:5.3f}  GPU-Nx2={n2:5.3f} "
              f"(eff {eff2:4.2f})  GPU-Nx4={n4:5.3f}  "
              f"GPU-N instances/COPA={inst:.2f} "
              f"({len(reached)}/{len(names)} matchable)")


def serve_grid_table(device):
    """Serving latency/throughput grid: batched decode per MSM config."""
    print("\n=== Serving grid: batch x MSM (per-request latency, ms) ===")
    configs_ = [copa.GPU_N_BASE, copa.HBM_L3, copa.HBML_L3]
    header = f"{'batch':>6s}" + "".join(f" {c.name:>10s}" for c in configs_)
    print(header)
    for b in registry.SERVE_BATCHES:
        names = registry.suite(f"serve.b{b}")
        grid = SweepEngine(names, configs=configs_, device=device).run()
        cells = []
        for c in configs_:
            lat = geomean(grid.result(registry.scenario(n).name, c.name).time_s
                          for n in names) * 1e3
            cells.append(f" {lat:10.3f}")
        print(f"{b:6d}" + "".join(cells))


def arch_msm_table(device):
    print("\n=== Assigned architectures: COPA analysis + software-MSM ===")
    cells = [(arch, shape) for arch in configs.ARCHS
             for shape in ("train_4k", "decode_32k")]
    # One suite-batched Fig-4 pass over all 20 cells (msm.analyze_suite),
    # instead of one trace walk per cell.
    traces = [registry.scenario(f"lm.{a}.{s}") for a, s in cells]
    for (arch, shape), an in zip(cells, msm.analyze_suite(traces, device=device)):
        red = min(an.baseline_traffic / max(an.sweep[960 * MB], 1e-9), 999)
        policy = msm.recommend(shape, configs.get(arch).n_params())
        print(f"{arch:24s} {shape:10s} 960MB-filter={red:6.1f}x  "
              f"msm={policy.name:16s} ({policy.describe()})")


def full_registry_sweep(device):
    """Every registered scenario x Table V in ONE suite-batched pass — the
    ``kernel.*`` streams of the port's Hopper kernels included."""
    print("\n=== Full-registry sweep: one StreamBatch pass ===")
    names = registry.scenarios()
    t0 = time.time()
    grid = SweepEngine(names, configs=copa.TABLE_V, device=device).run()
    dt = time.time() - t0
    print(f"{len(names)} scenarios x {len(copa.TABLE_V)} configs -> "
          f"{len(grid.rows)} rows in {dt * 1e3:.0f}ms")
    by_ns = {"mlperf.train": "mlperf.train.", "mlperf.infer": "mlperf.infer.",
             "serve": "serve.", "lm": "lm.", "hpc": "hpc.", "kernel": "kernel."}
    for label, prefix in by_ns.items():
        traces = [registry.scenario(n).name for n in names
                  if n.startswith(prefix)]
        sp = [s for s in grid.speedups("HBML+L3", traces)
              if math.isfinite(s) and s > 0]
        geo = geomean(sp)
        note = "" if len(sp) == len(traces) else \
            f" ({len(traces) - len(sp)} degenerate cells skipped)"
        print(f"  {label:14s} {len(traces):4d} scenarios  "
              f"HBML+L3 geomean speedup {geo:.3f}{note}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="where the scans run: 'cpu' (NumPy) or 'cuda' (default: the card)")
    args = p.parse_args(argv)
    paper_suite_table(args.device)
    scale_out_table(args.device)
    serve_grid_table(args.device)
    arch_msm_table(args.device)
    full_registry_sweep(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
