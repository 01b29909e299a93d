"""The port's analytic stack (``repro_torch.core.{stackdist, cachesim, copa,
sweep, perfmodel, msm}`` and ``repro_torch.workloads``) against the JAX
package's, on the CPU.

- The registry: every name of the reference's outside ``kernel.*``, letter
  for letter and in order, and every such trace op for op.
- ``SweepEngine(..., device="cpu")`` over those 212 scenarios x Table V:
  every field of every row equal to the reference's grid to the bit.
- The two device scans run as torch operations on CPU tensors against
  their NumPy plain versions, over every registry stream and the awkward
  rows (one touch, pads only, a length that is not a power of two, a
  seeded stream with heavy reuse, the longest stream alone): distances and
  fill bytes equal to the bit (touch sizes are whole numbers of bytes, so
  every sum is exact), writebacks at rtol 1e-12 (they go through log/exp).
- ``StreamBatch.append`` and ``suite_append`` through the torch scan
  against a cold pad of the whole list.
- ``msm.analyze``, ``analyze_suite`` and the KV capacity rules.
- The ``kernel.*`` scenarios priced with finite DRAM traffic that falls as
  capacity grows.
- ``examples/copa_design_sweep_torch.py --device cpu``.
"""
import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

import repro.configs as rconfigs
from repro.core import copa as rcopa
from repro.core import msm as rmsm
from repro.core import perfmodel as rperfmodel
from repro.core import sweep as rsweep
from repro.workloads import registry as rregistry
import repro_torch.configs as configs
from repro_torch.check import catalog
from repro_torch.core import cachesim, copa, msm, perfmodel, stackdist, sweep
from repro_torch.core.hw import MB
from repro_torch.core.trace import Trace
from repro_torch.workloads import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NAMESPACES = ("mlperf.train.", "mlperf.infer.", "serve.", "lm.", "hpc.")
WB_RTOL = 1e-12


def non_kernel(names):
    return [n for n in names if not n.startswith("kernel.")]


def table_v_caps(cfgs):
    caps = {float(c) for cfg in cfgs + [copa.GPU_N_BASE]
            for c in sweep.TraceAnalysis.capacities_for(cfg.build())}
    return sorted(caps)


CAPS = table_v_caps(copa.TABLE_V) + [float(c * MB) for c in (7, 33, 120)]


@pytest.fixture(scope="module")
def registry_traces():
    """Every scenario of the port's registry, ``kernel.*`` included."""
    return {n: registry.scenario(n) for n in registry.scenarios()}


@pytest.fixture(scope="module")
def host_streams(registry_traces):
    """The NumPy streams of every registry trace (``device="cpu"``)."""
    names = list(registry_traces)
    return dict(zip(names, cachesim.build_streams([registry_traces[n] for n in names],
                                                  device="cpu")))


# -- the registry ---------------------------------------------------------------

def test_registry_names_equal_reference():
    assert non_kernel(registry.scenarios()) == non_kernel(rregistry.scenarios())
    assert len(non_kernel(registry.scenarios())) == 212
    assert registry.scenarios("kernel.") == [f"kernel.{c}" for c in catalog.case_names()]
    assert set(catalog.REFERENCE_CASES) <= set(catalog.case_names())
    assert registry.scaleout_names() == rregistry.scaleout_names()
    assert registry.arrival_names() == rregistry.arrival_names()
    assert [s for s in registry.suites() if not s.startswith("kernel")] == \
        [s for s in rregistry.suites() if not s.startswith("kernel")]
    for s in registry.suites():
        if not s.startswith("kernel"):
            assert registry.suite(s) == rregistry.suite(s), s
    assert registry.match("serve.mlperf.resnet.*") == rregistry.match("serve.mlperf.resnet.*")
    got = registry.suite_analysis("mlperf.infer.large", device="cpu").dram_traffic([60 * MB])
    want = rregistry.suite_analysis("mlperf.infer.large").dram_traffic([60 * MB])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("prefix", NAMESPACES)
def test_traces_equal_reference_op_for_op(prefix):
    names = registry.scenarios(prefix)
    assert names
    for n in names:
        got, want = registry.scenario(n), rregistry.scenario(n)
        assert (got.name, got.kind, got.batch_size) == (want.name, want.kind, want.batch_size)
        assert len(got.ops) == len(want.ops), n
        for a, b in zip(got.ops, want.ops):
            assert dataclasses.astuple(a) == dataclasses.astuple(b), (n, a.name)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_scaleout_traces_equal_reference(n):
    for name in registry.scaleout_names():
        got = registry.scaleout(name).trace_for(n)
        want = rregistry.scaleout(name).trace_for(n)
        assert [dataclasses.astuple(o) for o in got.ops] == \
            [dataclasses.astuple(o) for o in want.ops], (name, n)


# -- the sweep engine -------------------------------------------------------------

def same_value(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k]) for k in a)
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def assert_same_grid(got, want):
    assert got.baseline == want.baseline
    assert len(got.rows) == len(want.rows)
    for a, b in zip(got.rows, want.rows):
        for f in dataclasses.fields(a):
            assert same_value(getattr(a, f.name), getattr(b, f.name)), \
                (a.trace, a.config, a.n_gpus, f.name)
    assert same_value(got.llc_traffic, want.llc_traffic)


SWEEPS = {
    "registry": lambda c: dict(traces=non_kernel(c.scenarios()), extra_llc_capacities=(
        7 * MB, 120 * MB)),
    "scaleout_ring": lambda c: dict(traces=c.scaleout_names(), gpu_counts=(1, 2, 4),
                                    ici_bandwidth=600e9),
}


@pytest.mark.parametrize("sweep_name", sorted(SWEEPS))
def test_sweep_engine_grid_equals_reference_to_the_bit(sweep_name):
    kw = SWEEPS[sweep_name](registry)
    traces = kw.pop("traces")
    got = sweep.SweepEngine(traces, configs=copa.TABLE_V, device="cpu", **kw).run()
    rkw = SWEEPS[sweep_name](rregistry)
    want = rsweep.SweepEngine(rkw.pop("traces"), configs=rcopa.TABLE_V, **rkw).run()
    assert_same_grid(got, want)
    # the per-trace loop, the batched path's oracle, agrees with it here too
    per_trace = sweep.SweepEngine(traces, configs=copa.TABLE_V, device="cpu", **kw).run(
        batched=False)
    assert_same_grid(per_trace, got)


def test_prefill_cost_and_perfmodel_equal_reference():
    cfgs, rcfgs = copa.TABLE_V, rcopa.TABLE_V
    for scen in ("lm.tinyllama-1.1b.prefill_32k", "lm.deepseek-v2-236b.prefill_32k"):
        assert np.array_equal(sweep.prefill_cost_per_token(scen, cfgs, device="cpu"),
                              rsweep.prefill_cost_per_token(scen, rcfgs))
    names = registry.suite("mlperf.infer.large")
    got = perfmodel.PerfModel.batch([registry.scenario(n) for n in names], device="cpu")
    want = rperfmodel.PerfModel.batch([rregistry.scenario(n) for n in names])
    for g, w in zip(got, want):
        for cfg, rcfg in zip(cfgs, rcfgs):
            a, b = g.run(cfg.build()), w.run(rcfg.build())
            assert (a.time_s, a.segments, a.dram_bytes, a.l3_bytes, a.uhb_bytes) == \
                (b.time_s, b.segments, b.dram_bytes, b.l3_bytes, b.uhb_bytes)
            assert np.array_equal(a.per_op_s, b.per_op_s)
            assert g.energy(cfg.build()).total_joules == w.energy(rcfg.build()).total_joules


# -- msm's analysis half -------------------------------------------------------------

def test_msm_analyze_and_analyze_suite_equal_reference():
    cells = [f"lm.{a}.{s}" for a in configs.ARCHS for s in ("train_4k", "decode_32k")]
    got = msm.analyze_suite([registry.scenario(c) for c in cells], device="cpu")
    want = rmsm.analyze_suite([rregistry.scenario(c) for c in cells])
    assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(b) for b in want]
    one = msm.analyze(registry.scenario("mlperf.train.resnet.large"), device="cpu")
    rone = rmsm.analyze(rregistry.scenario("mlperf.train.resnet.large"))
    assert dataclasses.asdict(one) == dataclasses.asdict(rone)
    assert one.reduction_at(960 * MB) == rone.reduction_at(960 * MB)
    assert msm.DEFAULT_CAPACITIES_MB == rmsm.DEFAULT_CAPACITIES_MB
    assert msm.KV_BYTES_PER_ELEM == rmsm.KV_BYTES_PER_ELEM


def outcome(fn, *args, **kw):
    """A call's value, or the error it raises (a model too large for the
    DRAM raises on both sides)."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("arch", [None, "tinyllama-1.1b", "mistral-nemo-12b", "deepseek-v2-236b"])
def test_kv_capacity_rules_equal_reference(arch):
    mcfg, rmcfg = (None, None) if arch is None else (configs.get(arch), rconfigs.get(arch))
    for cfg, rcfg in zip(copa.TABLE_V[:-1], rcopa.TABLE_V[:-1]):
        spec, rspec = cfg.build(), rcfg.build()
        assert outcome(msm.kv_reserve_frac, spec, mcfg) == \
            outcome(rmsm.kv_reserve_frac, rspec, rmcfg)
        for dtype in ("bfloat16", "int8"):
            pol = msm.compose("msm_decode", kv_cache_dtype=dtype, kv_compression_ratio=1.5)
            rpol = rmsm.compose("msm_decode", kv_cache_dtype=dtype, kv_compression_ratio=1.5)
            assert outcome(msm.kv_token_capacity, spec, pol, 65536, model_config=mcfg) == \
                outcome(rmsm.kv_token_capacity, rspec, rpol, 65536, model_config=rmcfg)
            assert outcome(msm.kv_page_capacity, spec, pol, 65536, 16, model_config=mcfg) == \
                outcome(rmsm.kv_page_capacity, rspec, rpol, 65536, 16, model_config=rmcfg)
    with pytest.raises(ValueError):
        msm.kv_token_capacity(copa.GPU_N_BASE.build(), msm.DECODE_MSM, 0)


# -- the torch scans on CPU tensors against NumPy ------------------------------------

def torch_distances(rows):
    return cachesim._device_distances(rows, CPU)


def test_torch_mattson_pass_equals_numpy_over_every_registry_stream(registry_traces,
                                                                  host_streams):
    names = list(registry_traces)
    rows = {i: (host_streams[n].tensor_idx, host_streams[n].sizes) for i, n in enumerate(names)}
    got = torch_distances(rows)
    assert max(len(r[0]) for r in rows.values()) > cachesim._BATCH_MATTSON_MAX_LEN
    for i, n in enumerate(names):
        assert np.array_equal(got[i], host_streams[n].dist), n
    # the blocks the card runs: short streams by pow2 width, each long one alone
    blocks = cachesim._mattson_blocks({i: r[0] for i, r in rows.items()})
    assert sorted(i for b in blocks for i in b) == sorted(rows)
    for b in blocks:
        lens = [len(rows[i][0]) for i in b]
        assert len(b) == 1 or max(lens) <= cachesim._BATCH_MATTSON_MAX_LEN


def assert_traffic_matches(streams, caps):
    want_f, want_w = cachesim.StreamBatch.pad(streams).traffic_matrices(caps)
    batch = cachesim.StreamBatch.pad(streams, device=CPU)
    got_f, got_w = batch.traffic_matrices(caps)
    assert np.array_equal(got_f, want_f)
    np.testing.assert_allclose(got_w, want_w, rtol=WB_RTOL, atol=0)
    return got_f, got_w


def test_torch_traffic_scan_equals_numpy_over_every_registry_stream(host_streams):
    streams = list(host_streams.values())
    fills, wbs = assert_traffic_matches(streams, table_v_caps(copa.TABLE_V))
    # the scan's NumPy twin is the per-trace kernel, row for row
    batch = cachesim.StreamBatch.pad(streams)
    for i in (0, len(streams) // 2, len(streams) - 1):
        for k, lt in enumerate(cachesim.traffic_below(streams[i], table_v_caps(copa.TABLE_V))):
            assert np.array_equal(fills[k, batch.op_slice(i)], lt.fill)
    assert np.isfinite(fills).all() and (fills >= 0).all() and (wbs >= 0).all()


def random_trace(rng, n_ops, n_tensors, name, max_bytes=1 << 22) -> Trace:
    """Many touches of few tensors, whole-number sizes of any value."""
    tr = Trace(name)
    sizes = rng.integers(1, max_bytes, n_tensors)
    for i in range(n_ops):
        reads = [(f"t{t}", int(sizes[t])) for t in rng.integers(0, n_tensors,
                                                                 int(rng.integers(1, 4)))]
        writes = [(f"t{t}", int(sizes[t])) for t in rng.integers(0, n_tensors,
                                                                  int(rng.integers(0, 2)))]
        tr.emit(f"op{i}", 1e6, reads=reads, writes=writes)
    return tr


def awkward_streams(case, host_streams):
    rng = np.random.default_rng(37)
    if case == "one_touch":
        out = []
        for i in range(3):
            tr = Trace(f"one{i}")
            tr.emit("op", 1.0, reads=[(f"w{i}", 1000 * (i + 1))])
            out.append(cachesim.build_stream(tr, cyclic=False))
        return out
    if case == "not_pow2":
        return [cachesim.build_stream(random_trace(rng, n, 5, f"np{n}")) for n in (333, 37, 1000)]
    if case == "heavy_reuse":
        return [cachesim.build_stream(random_trace(rng, 2500, 6, "heavy", max_bytes=40 << 20))]
    if case == "longest":   # the longest MLPerf stream, as a one-row batch
        return [max((s for n, s in host_streams.items() if n.startswith("mlperf.")),
                    key=lambda s: len(s.op_idx))]
    raise KeyError(case)


AWKWARD = ("one_touch", "not_pow2", "heavy_reuse", "longest")


@pytest.mark.parametrize("case", AWKWARD)
def test_torch_scans_equal_numpy_on_awkward_rows(case, host_streams):
    streams = awkward_streams(case, host_streams)
    dists = torch_distances({i: (s.tensor_idx, s.sizes) for i, s in enumerate(streams)})
    for i, s in enumerate(streams):
        assert np.array_equal(dists[i], stackdist._mattson_pass(s.tensor_idx, s.sizes))
    caps = sorted({float(c) for c in CAPS} | {float(np.median(
        [d for s in streams for d in s.dist if np.isfinite(d)] or [MB]))})
    assert_traffic_matches(streams, caps)


def test_torch_mattson_pass_on_padded_and_pad_only_rows():
    """Rows of a batch that are shorter than its width, and rows that are
    pads only, in the batch pass itself (the NumPy pass is the oracle)."""
    rng = np.random.default_rng(5)
    ids = np.full((4, 64), stackdist.PAD_ID, dtype=np.int64)
    sizes = np.zeros((4, 64))
    for r, n in ((0, 64), (1, 33), (2, 1)):
        ids[r, :n] = rng.integers(0, 7, n)
        sizes[r, :n] = rng.integers(1, 1 << 30, n)
    want = stackdist._mattson_pass_batch(ids, sizes)
    got = stackdist._mattson_pass_batch_torch(torch.from_numpy(ids), torch.from_numpy(sizes))
    assert np.array_equal(got.numpy(), want)
    for r, n in ((0, 64), (1, 33), (2, 1)):
        assert np.array_equal(want[r, :n], stackdist._mattson_pass(ids[r, :n], sizes[r, :n]))
    assert stackdist._mattson_pass_batch_torch(
        torch.zeros((0, 5), dtype=torch.int64), torch.zeros((0, 5), dtype=torch.float64)
    ).shape == (0, 5)
    with pytest.raises(TypeError):
        stackdist._mattson_pass_batch_torch(torch.from_numpy(ids).int(), torch.from_numpy(sizes))


def test_torch_traffic_scan_on_a_pad_only_row(host_streams):
    """A block row that is pads only (size 0, +inf distance, nothing
    recorded) adds exact zeros on both scans."""
    streams = awkward_streams("not_pow2", host_streams)
    want = cachesim.StreamBatch.pad(streams).traffic_matrices(CAPS)
    batch = cachesim.StreamBatch.pad(streams, device=CPU)
    block = batch._blocks[0]
    width = block.sizes.shape[1]
    block.sizes = np.vstack([block.sizes, np.zeros(width)])
    block.dist = np.vstack([block.dist, np.full(width, np.inf)])
    block.is_write = np.vstack([block.is_write, np.zeros(width, dtype=bool)])
    block.is_inf = np.vstack([block.is_inf, np.ones(width, dtype=bool)])
    block.on_device = {k: torch.from_numpy(getattr(block, k)) for k in cachesim._DEVICE_FIELDS}
    got = batch.traffic_matrices(CAPS)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=WB_RTOL, atol=0)


# -- appends through the torch scan -----------------------------------------------

def test_stream_batch_append_equals_cold_pad_through_the_torch_scan(host_streams):
    streams = [s for n, s in host_streams.items() if not n.startswith("kernel.")]
    half = len(streams) // 2
    grown = cachesim.StreamBatch.pad(streams[:half], device=CPU)
    grown.traffic_matrices(CAPS)
    added = grown.append(streams[half:])
    cold = cachesim.StreamBatch.pad(streams, device=CPU)
    assert np.array_equal(grown.op_offsets, cold.op_offsets)
    for got, want in zip(grown.traffic_matrices(CAPS), cold.traffic_matrices(CAPS)):
        assert np.array_equal(got, want)
    # a partial scan over the appended blocks fills only their columns
    fills, _ = grown.traffic_matrices(CAPS, blocks=added)
    assert not fills[:, : grown.op_offsets[half]].any()
    assert np.array_equal(fills[:, grown.op_offsets[half]:],
                          cold.traffic_matrices(CAPS)[0][:, grown.op_offsets[half]:])


def snapshot(suite, specs):
    suite.prefetch(CAPS)
    return {"time": suite.time_batch(specs), "components": suite.component_batch(specs),
            "levels": {c: tuple(a.copy() for a in suite._levels_cat[c]) for c in CAPS},
            "totals": {c: suite.totals_below(c).copy() for c in CAPS},
            "l2": suite.l2_touch.copy()}


def test_suite_append_equals_cold_suite_through_the_torch_scan(monkeypatch):
    """``suite_append`` on a suite whose scans are the torch ones on the CPU
    (``scan_device`` sends "cpu" to torch here, as it sends the card there)
    equals a cold suite over the whole list to the bit, and the NumPy suite
    as the scans agree: fills to the bit, writebacks at rtol 1e-12."""
    names = registry.suite("mlperf.train.large") + registry.suite("serve.b4")
    traces = [registry.scenario(n) for n in names]
    specs = [c.build() for c in copa.TABLE_V]
    want_host = snapshot(sweep.SuiteAnalysis(traces, device="cpu"), specs)

    def torch_on_cpu(device=None):
        return torch.device(device)

    monkeypatch.setattr(cachesim, "scan_device", torch_on_cpu)
    monkeypatch.setattr(sweep, "scan_device", torch_on_cpu)
    suite = sweep.suite_analysis_for(traces[:3], device="cpu")
    assert suite.batch.device == CPU
    suite.prefetch(CAPS)
    suite.time_batch(specs)
    for t in traces[3:]:
        assert sweep.suite_append(suite, [t]) is suite
    assert sweep.suite_analysis_for(traces, device="cpu") is suite
    got = snapshot(suite, specs)
    cold = snapshot(sweep.SuiteAnalysis(traces, device="cpu"), specs)
    for k in ("time", "components", "l2"):
        assert np.array_equal(got[k], cold[k]), k
    for c in CAPS:
        for a, b in zip(got["levels"][c], cold["levels"][c]):
            assert np.array_equal(a, b)
        assert np.array_equal(got["totals"][c], cold["totals"][c])
        assert np.array_equal(got["levels"][c][0], want_host["levels"][c][0])
        np.testing.assert_allclose(got["levels"][c][1], want_host["levels"][c][1],
                                   rtol=WB_RTOL, atol=0)
    np.testing.assert_allclose(got["time"], want_host["time"], rtol=WB_RTOL, atol=0)
    # the torch suite and the NumPy suite stay apart in every memo
    monkeypatch.undo()
    host_suite = sweep.suite_analysis_for(traces, device="cpu")
    assert host_suite is not suite and host_suite.batch.device is None
    assert all(a is not b for a, b in zip(host_suite.analyses, suite.analyses))


def test_memos_are_keyed_by_where_the_scans_ran():
    tr = registry.scenario("mlperf.infer.resnet.large")
    a = sweep.analysis_for(tr, device="cpu")
    assert sweep.analysis_for(tr, device="cpu") is a
    keys = [k for k in sweep._ANALYSES if k[0] == id(tr)]
    assert all(k[-1] == "numpy" for k in keys)
    assert cachesim._backend_key(None) == "numpy"
    assert cachesim._backend_key(torch.device("cuda", 0)) == "cuda:0"
    assert cachesim.scan_device("cpu") is None


# -- the kernel.* scenarios ------------------------------------------------------------

@pytest.fixture(scope="module")
def kernel_traffic(registry_traces, host_streams):
    names = registry.scenarios("kernel.")
    suite = sweep.suite_analysis_for([registry_traces[n] for n in names], device="cpu")
    caps = [c * MB for c in msm.DEFAULT_CAPACITIES_MB]
    return dict(zip(names, suite.dram_traffic(caps)))


@pytest.mark.parametrize("case", catalog.case_names())
def test_kernel_scenario_priced_with_finite_capacity_monotone_traffic(case, kernel_traffic):
    """A ``kernel.*`` scenario is the port's own launch plans: the
    reference's ``kernel.*`` traces come from ``repro.check``, which fails
    on the installed jax (``check/facts.py:320``), so there is nothing of
    the reference's to hold these against. They are held to what the cache
    model must give any trace: finite DRAM traffic that never grows with
    the capacity, none at a capacity that holds every tile the kernel
    touches, and some where the smallest capacity does not hold them."""
    traffic = kernel_traffic[f"kernel.{case}"]
    assert np.isfinite(traffic).all() and (traffic >= 0).all()
    assert (np.diff(traffic) <= 0).all(), traffic
    trace = registry.scenario(f"kernel.{case}")
    assert trace.ops and all(op.flops >= 0 for op in trace.ops)
    footprint = {}
    for op in trace.ops:
        for name, nbytes in op.reads + op.writes:
            footprint[name] = max(footprint.get(name, 0), nbytes)
    for cap, t in zip(msm.DEFAULT_CAPACITIES_MB, traffic):
        if sum(footprint.values()) <= cap * MB:
            assert t == 0.0, (cap, t)
    if sum(footprint.values()) > 2 * msm.DEFAULT_CAPACITIES_MB[0] * MB:
        assert traffic[0] > 0


def test_full_registry_sweep_prices_every_scenario(registry_traces):
    grid = sweep.SweepEngine(registry.scenarios(), configs=copa.TABLE_V, device="cpu").run()
    assert len(grid.rows) == len(registry.scenarios()) * len(copa.TABLE_V)
    for name in registry.scenarios("kernel."):
        rows = [r for r in grid.rows if r.trace == name]
        assert len(rows) == len(copa.TABLE_V)
        assert all(math.isfinite(r.time_s) and r.time_s > 0 and r.dram_bytes >= 0 for r in rows)
    # the kernels at the port's path shapes spill the baseline's L2
    assert grid.result("kernel.flash_attention_bwd.mla", "GPU-N").dram_bytes > 0


# -- the example ---------------------------------------------------------------------

def test_design_sweep_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "copa_design_sweep_torch", ROOT / "examples" / "copa_design_sweep_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    # Fig 11's HBML+L3 row, as the reference's example prints it
    assert "HBML+L3          1.311     1.230     1.491     1.049" in out
    n = len(registry.scenarios())
    assert f"{n} scenarios x {len(copa.TABLE_V)} configs -> {n * len(copa.TABLE_V)} rows" in out
    assert f"kernel           {len(catalog.case_names())} scenarios" in out
