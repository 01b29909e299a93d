"""Observability: post-hoc, vectorized views over engine artifacts.

The serving engines (``repro_torch.serve.sim`` / ``repro_torch.serve.fleetbatch``) and
the sweep engine (``repro_torch.core.sweep``) already record everything a
timeline needs — :class:`~repro_torch.serve.sim.StepLog` columns, the
:class:`~repro_torch.serve.sim.RequestBatch` timing columns, autoscale
:class:`~repro_torch.serve.fleet.ScaleEvent` lists and the
:class:`~repro_torch.core.sweep.SuiteAnalysis` attribution matrices. This package
derives observability FROM those artifacts after the run, never by hooking
per-event callbacks into the hot paths, so the batched fleet core keeps its
CI speed floor and its bit-identical parity oracles untouched.

Three layers:

* ``repro_torch.obs.timeline`` — Chrome ``trace_event`` / Perfetto JSON export
  from any ``SimResult``/``FleetResult``: one lane per instance
  (prefill/decode step spans), request-lifecycle spans (queue -> first
  token -> done with eviction marks), counter tracks for queue depth, KV
  occupancy and fleet size.
* ``repro_torch.obs.series`` — windowed :class:`MetricSeries` rollups
  (``FleetResult.timeseries(window_s)``): per-window goodput, TTFT/TPOT
  percentiles, batch occupancy, eviction rate, utilization.
* ``repro_torch.obs.attribution`` — bottleneck attribution over the sweep engine:
  which resource (math / LLC / UHB / DRAM / ICI) bounds each
  workload x config cell and by what margin, as text tables and a
  plot-ready JSON roofline export.

``python -m repro_torch.obs`` exposes trace/timeseries/explain over saved
results (``repro_torch.obs.store``). The one engine knob is
:class:`~repro_torch.serve.sim.ObsConfig` (re-exported here): level 1 adds a
``prefill_tokens`` step-log column for richer phase spans, with timing
results bit-identical either way.

Submodules import lazily so ``repro_torch.serve`` never pays for this package
(and the serve -> obs -> serve cycle never materializes at import time).
"""

_HOMES = {
    "ObsConfig": "repro_torch.serve.sim",
    "Timeline": "repro_torch.obs.timeline",
    "trace_events": "repro_torch.obs.timeline",
    "chrome_trace": "repro_torch.obs.timeline",
    "write_chrome_trace": "repro_torch.obs.timeline",
    "validate_chrome_trace": "repro_torch.obs.timeline",
    "MetricSeries": "repro_torch.obs.series",
    "timeseries": "repro_torch.obs.series",
    "explain": "repro_torch.obs.attribution",
    "ExplainReport": "repro_torch.obs.attribution",
    "CellExplain": "repro_torch.obs.attribution",
    "save_result": "repro_torch.obs.store",
    "load_result": "repro_torch.obs.store",
}

__all__ = sorted(_HOMES)


def __getattr__(name):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(home), name)
    # Pin the resolved object: importing a submodule binds the MODULE over
    # its name on this package (so ``from repro_torch.obs import explain`` would
    # otherwise resolve to repro_torch.obs.explain the module, not the function —
    # from-import looks the name up twice and only the first consults us).
    globals()[name] = value
    return value
