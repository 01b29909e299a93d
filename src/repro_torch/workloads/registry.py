"""Scenario registry: every known workload trace behind one namespace.

Maps scenario names -> trace factories across the three workload families so
the sweep engine (``repro_torch.core.sweep.SweepEngine``) can enumerate the whole
evaluation space by name:

* ``mlperf.train.<bench>.<setting>`` / ``mlperf.infer.<bench>.<setting>`` —
  the paper's Table-III MLPerf proxies at ``large``/``small`` batch;
* ``serve.mlperf.<bench>.b<batch>`` — batched-decode serving grid points:
  the inference benchmarks at explicit batch sizes, so latency/throughput
  grids sweep batch x MSM policy (Table-V config), not just per hardware
  config;
* ``lm.<arch>.<shape>`` — the assigned LM architectures x shapes
  (``repro_torch.configs``), e.g. ``lm.deepseek_v2_236b.decode_32k``;
* ``hpc.<family>.<k>`` — the 130-app Fig-3 HPC proxy population;
* ``kernel.<kernel>.<case>`` — measured-structure touch streams of the
  port's Hopper kernels, from the launch plans ``repro_torch.check`` reads
  (one Op a CUDA block; the analyser's catalog: the reference's eight
  cases by name and the port's own path shapes).

Scale-out *families* (``repro_torch.core.sweep.ScaleOutWorkload``) live behind the
same namespace with a ``scaleout.`` prefix: each maps an instance count to
the per-GPU trace one instance replays.

* ``scaleout.mlperf.train.<bench>`` — fixed-global-batch data-parallel
  training (paper Fig 12): per-GPU batch = global / n;
* ``scaleout.serve.<bench>`` — a fixed offered request batch split across
  serving instances (strong-scaling latency grids).

Arrival processes for the request-level serving simulator
(``repro_torch.serve.sim``) live under ``arrivals.*`` — named open-loop request
streams (steady Poisson, burst-modulated) that :func:`resolve` returns as
``ArrivalSpec`` objects.

``SweepEngine`` resolves any scenario OR scale-out name through
:func:`resolve`; glob patterns (``serve.mlperf.*``, ``arrivals.poisson.*``)
resolve to every matching name. Suites group scenarios the way the paper's
figures do (``mlperf.train.large``, ``serve.mlperf``, ``hpc``, ...).
Factories are lazy, and built traces are memoized registry-side by scenario
name (:func:`scenario`), so enumerating names costs nothing and repeated
sweeps never re-run a factory. :func:`suite_analysis` resolves a suite (or
scenario glob) straight to the shared suite-level
:class:`~repro_torch.core.sweep.SuiteAnalysis` — one batched pass over all its
traces.
"""
from __future__ import annotations

from fnmatch import fnmatchcase
from functools import lru_cache
from typing import Callable

from repro_torch.core.sweep import ScaleOutWorkload
from repro_torch.core.trace import Trace
from repro_torch.workloads import hpc as hpc_mod
from repro_torch.workloads import kernels as kernels_mod
from repro_torch.workloads import lm as lm_mod
from repro_torch.workloads import mlperf as mlperf_mod

_FACTORIES: dict[str, Callable[[], Trace]] = {}
_SCALEOUT: dict[str, ScaleOutWorkload] = {}
_ARRIVALS: dict[str, Callable[[], object]] = {}  # -> repro_torch.serve.sim.ArrivalSpec
_SUITES: dict[str, list[str]] = {}
_GLOB_CHARS = "*?["


def register(name: str, factory: Callable[[], Trace],
             suites: tuple[str, ...] = ()) -> None:
    """Register one scenario; ``suites`` are group names it belongs to."""
    if name in _FACTORIES:
        raise ValueError(f"scenario {name!r} already registered")
    _FACTORIES[name] = factory
    for s in suites:
        _SUITES.setdefault(s, []).append(name)


def register_scaleout(name: str, workload: ScaleOutWorkload,
                      suites: tuple[str, ...] = ()) -> None:
    """Register one scale-out family under the ``scaleout.`` namespace."""
    if name in _SCALEOUT:
        raise ValueError(f"scale-out workload {name!r} already registered")
    _SCALEOUT[name] = workload
    for s in suites:
        _SUITES.setdefault(s, []).append(name)


@lru_cache(maxsize=None)
def _build_scenario(name: str) -> Trace:
    """Registry-level trace memo, keyed on scenario name: repeated
    ``resolve()``/``suite_traces()``/sweep calls must not re-enter the
    factory (several factories are themselves lru-cached, but with bounded
    sizes that a full-registry sweep can evict). Unbounded is safe — the
    key space is the fixed registry. ``register()`` only adds new names,
    so entries never go stale."""
    return _FACTORIES[name]()


def scenario(name: str) -> Trace:
    """Build (or fetch the memoized) trace for one scenario name."""
    if name not in _FACTORIES:
        raise KeyError(
            f"unknown scenario {name!r}; see repro_torch.workloads.registry.scenarios()"
        )
    return _build_scenario(name)


def scaleout(name: str) -> ScaleOutWorkload:
    """The scale-out family for one ``scaleout.*`` name."""
    try:
        return _SCALEOUT[name]
    except KeyError:
        raise KeyError(
            f"unknown scale-out workload {name!r}; see "
            f"repro_torch.workloads.registry.scaleout_names()"
        ) from None


def register_arrivals(name: str, factory: Callable[[], object],
                      suites: tuple[str, ...] = ()) -> None:
    """Register one named arrival process (``arrivals.*`` namespace) for the
    request-level serving simulator; factories return
    :class:`repro_torch.serve.sim.ArrivalSpec` objects lazily."""
    if name in _ARRIVALS:
        raise ValueError(f"arrival process {name!r} already registered")
    _ARRIVALS[name] = factory
    for s in suites:
        _SUITES.setdefault(s, []).append(name)


def arrivals(name: str):
    """The :class:`~repro_torch.serve.sim.ArrivalSpec` for one ``arrivals.*`` name."""
    try:
        return _ARRIVALS[name]()
    except KeyError:
        raise KeyError(
            f"unknown arrival process {name!r}; see "
            f"repro_torch.workloads.registry.arrival_names()"
        ) from None


def resolve(name: str):
    """Resolve a name to its registered object — a scenario ``Trace``, a
    ``ScaleOutWorkload`` family, or an ``ArrivalSpec``.

    Glob patterns (fnmatch: ``*?[``) resolve to the LIST of every matching
    name across all three namespaces, in registration order — e.g.
    ``resolve("serve.mlperf.resnet.*")`` or ``resolve("arrivals.poisson.*")``
    — raising ``KeyError`` when nothing matches."""
    if any(ch in name for ch in _GLOB_CHARS):
        hits = match(name)
        if not hits:
            raise KeyError(f"no registered name matches pattern {name!r}")
        return [resolve(n) for n in hits]
    if name in _SCALEOUT:
        return _SCALEOUT[name]
    if name in _ARRIVALS:
        return _ARRIVALS[name]()
    return scenario(name)


def names() -> list[str]:
    """Every registered name across all namespaces, registration order."""
    return [*_FACTORIES, *_SCALEOUT, *_ARRIVALS]


def match(pattern: str) -> list[str]:
    """Registered names matching an fnmatch pattern (registration order)."""
    return [n for n in names() if fnmatchcase(n, pattern)]


def scenarios(prefix: str = "") -> list[str]:
    return [n for n in _FACTORIES if n.startswith(prefix)]


def scaleout_names(prefix: str = "") -> list[str]:
    return [n for n in _SCALEOUT if n.startswith(prefix)]


def arrival_names(prefix: str = "") -> list[str]:
    return [n for n in _ARRIVALS if n.startswith(prefix)]


def suites() -> list[str]:
    return list(_SUITES)


def suite(name: str) -> list[str]:
    """Scenario names in a suite (KeyError on unknown suite)."""
    return list(_SUITES[name])


def suite_traces(name: str) -> list[Trace]:
    """Traces of a suite's members. Suites may also group scale-out
    families and arrival processes — those have no single trace, so asking
    for their traces is an error, not a silent skip."""
    out = []
    for n in suite(name):
        obj = resolve(n)
        if not isinstance(obj, Trace):
            raise TypeError(
                f"suite {name!r} member {n!r} is a {type(obj).__name__}, "
                f"not a scenario trace; resolve() it directly")
        out.append(obj)
    return out


def suite_analysis(name: str, device=None):
    """One-call suite-level analysis: resolve a suite name (or a glob over
    scenario names) and return the shared
    :class:`~repro_torch.core.sweep.SuiteAnalysis` over its traces — every
    member's touch stream built in one batched Mattson pass, traffic and
    time evaluated suite-wide per capacity/config set, on ``device``
    (``None``: the card)."""
    from repro_torch.core.sweep import suite_analysis_for  # lazy: avoid cycle

    if name in _SUITES:
        traces = suite_traces(name)
    else:
        hits = [n for n in match(name) if n in _FACTORIES] \
            if any(ch in name for ch in _GLOB_CHARS) else []
        if not hits:
            raise KeyError(
                f"{name!r} is neither a suite nor a glob matching scenarios; "
                f"see suites() and scenarios()")
        traces = [scenario(n) for n in hits]
    return suite_analysis_for(traces, device=device)


# --- built-in population ------------------------------------------------------

def _register_mlperf() -> None:
    for setting in ("large", "small"):
        for bench in mlperf_mod.TRAIN_BATCHES:
            register(
                f"mlperf.train.{bench}.{setting}",
                lambda b=bench, s=setting: mlperf_mod.training_trace(b, s),
                suites=(f"mlperf.train.{setting}", "mlperf"),
            )
        for bench in mlperf_mod.INFER_BATCHES:
            register(
                f"mlperf.infer.{bench}.{setting}",
                lambda b=bench, s=setting: mlperf_mod.inference_trace(b, s),
                suites=(f"mlperf.infer.{setting}", "mlperf"),
            )


# Batched-decode serving grid: requests served per instance at once. Grid
# points above a benchmark's Table-III large batch (its calibrated maximum —
# e.g. ssd-large tops out at 6) are NOT registered: those cells would
# extrapolate outside the paper's measured range.
SERVE_BATCHES = (1, 4, 16, 64)


def _register_serve() -> None:
    for bench, (_, large) in mlperf_mod.INFER_BATCHES.items():
        for b in SERVE_BATCHES:
            if b > large:
                continue
            register(
                f"serve.mlperf.{bench}.b{b}",
                lambda bench=bench, b=b: mlperf_mod.inference_trace(
                    bench, "large", batch_override=b),
                suites=(f"serve.mlperf.{bench}", f"serve.b{b}", "serve.mlperf"),
            )


def _register_lm() -> None:
    from repro_torch.configs import ARCHS, SHAPES

    for arch in ARCHS:
        for shape in SHAPES:
            register(
                f"lm.{arch}.{shape}",
                lambda a=arch, s=shape: lm_mod.arch_trace(a, s),
                suites=(f"lm.{shape}", "lm"),
            )


def _register_hpc() -> None:
    # One scenario per proxy app; the suite builds all 130 in one cached call.
    idx = 0
    for family, count in hpc_mod.APP_FAMILIES:
        for k in range(count):
            register(
                f"hpc.{family}.{k}",
                lambda i=idx: hpc_mod.hpc_suite()[i],
                suites=("hpc",),
            )
            idx += 1


def _register_kernels() -> None:
    # Measured-structure kernel streams from the static analyser
    # (repro_torch.check): one scenario per catalog (kernel, shape) case. The
    # factory compiles the case's launch plans on first build; names
    # enumerate import-light like every other namespace.
    for case in kernels_mod.case_names():
        kernel = case.split(".", 1)[0]
        register(
            f"kernel.{case}",
            lambda c=case: kernels_mod.kernel_trace(c),
            suites=(f"kernel.{kernel}", "kernel"),
        )


def _register_scaleout() -> None:
    # Fig-12 fixed-global-batch data-parallel training: n instances split the
    # Table-III large batch, so the per-GPU trace shrinks (strong scaling).
    # trace_for(1) is the plain large-batch scenario object (same lru-cached
    # trace), so 1-GPU rows are bit-identical to the non-scale-out grid.
    for bench in mlperf_mod.TRAIN_BATCHES:
        lb = mlperf_mod.TRAIN_BATCHES[bench][1]
        register_scaleout(
            f"scaleout.mlperf.train.{bench}",
            ScaleOutWorkload(
                name=f"{bench}.train.large",
                trace_for=lambda n, bench=bench, lb=lb:
                    mlperf_mod.training_trace(bench, "large")
                    if n == 1 else mlperf_mod.training_trace(
                        bench, "large", batch_override=max(lb // n, 1)),
            ),
            suites=("scaleout.mlperf.train",),
        )
    # Serving scale-out: a fixed offered batch of requests split across
    # instances — the latency knob of the serve grid.
    for bench in mlperf_mod.INFER_BATCHES:
        lb = mlperf_mod.INFER_BATCHES[bench][1]
        register_scaleout(
            f"scaleout.serve.{bench}",
            ScaleOutWorkload(
                name=f"{bench}.infer.large",
                trace_for=lambda n, bench=bench, lb=lb:
                    mlperf_mod.inference_trace(bench, "large")
                    if n == 1 else mlperf_mod.inference_trace(
                        bench, "large", batch_override=max(lb // n, 1)),
            ),
            suites=("scaleout.serve",),
        )


# Open-loop arrival processes for the request-level serving simulator
# (repro_torch.serve.sim): steady Poisson and 4x-burst-modulated Poisson at a
# log-spaced rate ladder, one-shot request semantics (prompt 0 / output 1 —
# the MLPerf serving scenarios). Factories import the sim module lazily so
# enumerating names stays import-light.
ARRIVAL_RATES = (4, 16, 64, 256, 1024)


def _register_arrivals() -> None:
    def poisson(rate: int):
        from repro_torch.serve.sim import ArrivalSpec

        return ArrivalSpec(name=f"arrivals.poisson.r{rate}", rate=float(rate),
                           n_requests=512)

    def burst(rate: int):
        from repro_torch.serve.sim import ArrivalSpec

        return ArrivalSpec(name=f"arrivals.burst.r{rate}.x4", rate=float(rate),
                           n_requests=512, burst_factor=4.0,
                           burst_fraction=0.25, period_s=64.0 / rate)

    for rate in ARRIVAL_RATES:
        register_arrivals(f"arrivals.poisson.r{rate}",
                          lambda rate=rate: poisson(rate),
                          suites=("arrivals.poisson", "arrivals"))
        register_arrivals(f"arrivals.burst.r{rate}.x4",
                          lambda rate=rate: burst(rate),
                          suites=("arrivals.burst", "arrivals"))


# Production-shaped diurnal load curves: hourly rate multipliers over one
# 24-"hour" day (time-compressed to DIURNAL_PERIOD_S so a 512-request trace
# spans a couple of days), normalized by ArrivalSpec so the long-run mean
# stays at the nominal rate. Shapes follow the usual published fleet
# telemetry: chat peaks evenings with a midday shoulder, api tracks
# business hours, batch inverts (overnight queue drain).
DIURNAL_PROFILES = {
    "chat": (0.2, 0.15, 0.1, 0.1, 0.1, 0.15, 0.3, 0.5, 0.8, 1.2, 1.5, 1.6,
             1.5, 1.4, 1.5, 1.6, 1.7, 1.8, 1.9, 1.8, 1.5, 1.1, 0.7, 0.4),
    "api": (0.3, 0.25, 0.2, 0.2, 0.2, 0.3, 0.5, 0.9, 1.4, 1.8, 1.9, 2.0,
            1.9, 1.9, 2.0, 1.9, 1.8, 1.5, 1.0, 0.7, 0.5, 0.4, 0.35, 0.3),
    "batch": (2.2, 2.4, 2.5, 2.3, 1.8, 1.2, 0.8, 0.6, 0.5, 0.5, 0.5, 0.6,
              0.6, 0.6, 0.6, 0.6, 0.7, 0.7, 0.8, 0.9, 1.1, 1.4, 1.8, 2.1),
}
DIURNAL_PERIOD_S = 4.0
_DIURNAL_LENGTHS = {         # (prompt dist, output dist) per workload shape
    "chat": (("lognormal", 512.0, 16), (32, 256)),
    "api": (("lognormal", 256.0, 8), (16, 128)),
    "batch": (("lognormal", 1024.0, 64), (64, 512)),
}


def _register_diurnal() -> None:
    def diurnal(kind: str):
        from repro_torch.serve.sim import ArrivalSpec, LengthDist

        (pk, pmean, pfloor), (olo, ohi) = _DIURNAL_LENGTHS[kind]
        return ArrivalSpec(
            name=f"arrivals.diurnal.{kind}", rate=64.0, n_requests=512,
            prompt=LengthDist(pk, mean=pmean, floor=pfloor),
            output=LengthDist("uniform", low=olo, high=ohi),
            period_s=DIURNAL_PERIOD_S, profile=DIURNAL_PROFILES[kind])

    for kind in DIURNAL_PROFILES:
        register_arrivals(f"arrivals.diurnal.{kind}",
                          lambda kind=kind: diurnal(kind),
                          suites=("arrivals.diurnal", "arrivals"))


_register_mlperf()
_register_serve()
_register_lm()
_register_hpc()
_register_kernels()
_register_scaleout()
_register_arrivals()
_register_diurnal()
