"""The port's dry-run yardstick against the JAX package: ``SHAPES`` and
``cell_is_runnable`` (the port of ``tests/test_system.py:83``), the
memory-system policies and ``recommend`` (the port of
``tests/test_system.py:57``, with the two cells where one H100's 80 GB
changes the reference's choice), the FLOP formulas of ``core.roofline`` over
every cell of the full configs, the paper's hardware tables, and
``RooflineReport``'s terms by hand on ``H100_SXM``."""
import dataclasses

import pytest

import repro.configs as jconfigs
from repro.configs.base import cell_is_runnable as jcell_is_runnable
from repro.core import hw as jhw
from repro.core import msm as jmsm
from repro.core import roofline as jroofline
import repro_torch.configs as tconfigs
from repro_torch.configs.base import cell_is_runnable
from repro_torch.core import hw, msm, roofline
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

CELLS = [(a, s) for a in sorted(tconfigs.ARCHS) for s in tconfigs.SHAPES]
# 0.70 x 80e9 x 256 = 1.43e13 bytes on 256 H100s: no configuration needs the
# capacity recipe, where the reference's 16 GiB v5e rule picks it for these
FLIPPED = {("qwen3-moe-235b-a22b", "train_4k"), ("deepseek-v2-236b", "train_4k")}
FLOP_RTOL = 1e-12


@pytest.fixture(autouse=True)
def no_reference_overrides(monkeypatch):
    """The reference's ``recommend`` reads ``REPRO_OPTS``; the port has no such
    overrides."""
    monkeypatch.delenv("REPRO_OPTS", raising=False)


def test_shapes_equal_the_references():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in tconfigs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_equals_the_references(arch, shape):
    """Per cell of the 40: runnable and its reason, the policy ``recommend``
    picks, and (for a runnable cell) 6ND and the useful FLOPs."""
    cfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    tshape, jshape = tconfigs.SHAPES[shape], jconfigs.SHAPES[shape]
    ok, reason = cell_is_runnable(cfg, tshape)
    assert (ok, reason) == jcell_is_runnable(jcfg, jshape)
    got = msm.recommend(shape, cfg.n_params())
    want = jmsm.recommend(shape, jcfg.n_params())
    if (arch, shape) in FLIPPED:
        assert (got.name, want.name) == ("msm_train", "msm_train_large")
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not ok:
        return
    tokens = tshape.global_batch * (1 if tshape.step == "decode" else tshape.seq_len)
    for training in (False, True):
        assert roofline.model_flops_lm(cfg.n_active_params(), tokens, training) == \
            pytest.approx(jroofline.model_flops_lm(jcfg.n_active_params(), tokens, training),
                          rel=FLOP_RTOL)
    assert roofline.useful_flops_cell(cfg, tshape) == pytest.approx(
        jroofline.useful_flops_cell(jcfg, jshape), rel=FLOP_RTOL)


def test_the_grid_skips_only_the_documented_long_context_cells():
    """The port of ``tests/test_system.py:83``."""
    skipped = [(a, s.name) for a, cfg in tconfigs.ARCHS.items() for s in tconfigs.SHAPES.values()
               if not cell_is_runnable(cfg, s)[0]]
    assert all(s == "long_500k" for _, s in skipped)
    assert {a for a, _ in skipped} == set(tconfigs.ARCHS) - {"mamba2-1.3b", "zamba2-1.2b"}


@pytest.mark.parametrize("name", sorted(jmsm._BY_NAME))
def test_policies_equal_the_references(name):
    assert dataclasses.asdict(msm.compose(name)) == dataclasses.asdict(jmsm.compose(name))
    for kw in ({"serve_fsdp": False}, {"kv_cache_dtype": "int8"}, {"microbatches": 1}):
        assert dataclasses.asdict(msm.compose(name, **kw)) == dataclasses.asdict(
            jmsm.compose(name, **kw))
    assert msm.compose(name).describe() == jmsm.compose(name).describe()


def test_policy_selection():
    """The port of ``tests/test_system.py:57`` on 256 H100s: 236 B parameters
    at 14 bytes each (3.3e12) fit in 70 % of their HBM (1.43e13)."""
    small = msm.recommend("train_4k", 1e9)
    big = msm.recommend("train_4k", 236e9)
    assert small.name == "msm_train" and big.name == "msm_train"
    assert msm.recommend("train_4k", 1.1e12).name == "msm_train_large"
    large = msm.TRAIN_LARGE_MSM
    assert large.optimizer_dtype == "bfloat16" and not large.master_weights
    assert msm.recommend("long_500k", 1e9).kv_shard_axis == "data"
    assert msm.recommend("decode_32k", 1e9).remat == "none"
    with pytest.raises(ValueError):
        msm.MemoryPolicy("bad", kv_compression_ratio=0.5)


def test_paper_tables_equal_the_references():
    for name in ("V100", "A100", "GPU_N", "P100", "UHB_2_5D", "UHB_3D"):
        assert dataclasses.asdict(getattr(hw, name)) == dataclasses.asdict(getattr(jhw, name))
    assert hw.GPU_N.l2_bandwidth == jhw.GPU_N.l2_bandwidth
    assert hw.UHB_3D.energy_joules(1e9) == jhw.UHB_3D.energy_joules(1e9)


def test_h100_spec():
    """NVIDIA's H100 SXM5 80GB datasheet, dense rates; one NDR port a GPU."""
    s = hw.H100_SXM
    assert (s.bf16_tflops, s.fp32_tflops, s.num_sms) == (989.0, 67.0, 132)
    assert (s.hbm_bandwidth, s.hbm_capacity, s.link_bandwidth) == (3.35e12, 80e9, 50e9)
    assert s.l2_capacity == 50 * 2**20
    assert s.flops_per_byte_hbm == pytest.approx(989e12 / 3.35e12, rel=1e-15)


def test_roofline_terms_by_hand():
    r = roofline.RooflineReport(arch="a", shape="s", mesh="16x16", chips=256,
                                hlo_flops=2.0e15, hlo_bytes=4.0e12, collective_bytes=1.0e11,
                                model_flops=256 * 1.5e15, peak_memory_bytes=7.0)
    assert r.spec is hw.H100_SXM
    assert r.compute_s == pytest.approx(2.0e15 / 989e12, rel=1e-15)
    assert r.memory_s == pytest.approx(4.0e12 / 3.35e12, rel=1e-15)
    assert r.collective_s == pytest.approx(1.0e11 / 50e9, rel=1e-15)
    assert r.bound_s == r.compute_s and r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(1.5e15 / (2.0e15 / 989e12) / 989e12, rel=1e-15)
    assert r.model_flops_ratio == pytest.approx(0.75, rel=1e-15)
    row = r.row()
    assert row["dominant"] == "compute" and row["peak_memory_bytes"] == 7.0
    # the collective term dominates once its bytes exceed 50 GB/s x 2.02 s
    r2 = dataclasses.replace(r, collective_bytes=2.0e11)
    assert r2.dominant == "collective" and r2.bound_s == pytest.approx(4.0, rel=1e-15)
    assert "16x16" in roofline.format_table([r, r2])
