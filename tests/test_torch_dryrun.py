"""The port's dry-run (``launch/specs``, ``launch/dryrun``,
``models.base.abstract_params``) against the JAX package and against closed
forms.

The placements are pure functions of shapes and mesh sizes, so both sides
compute them on stand-in meshes: the port's ``StandInMesh``, and for the
reference its ``NamedSharding`` built on a ``jax.sharding.AbstractMesh`` of
the same sizes (its rules read a mesh's axis names and device-array shape
only). ``run_cell`` runs each cell's step through the port's mesh path as
rank 0 of a fake process group of the mesh's size; a process group is
process-wide, and none may start in a pytest worker, so every ``run_cell``
of this module runs in one subprocess (``fake_runs``, killed at
``FAKE_RUNS_TIMEOUT``) and the tests read its records. The smoke configs
run at a small shape a step (``SMALL``, the grid's names and kinds): on
``meta`` every op costs a Python-level shape computation (and on a mesh
``DTensor``'s sharding propagation), so at the grid's 4096 and 32768
positions one smoke cell takes minutes; tinyllama's smoke config also runs
at the grid's own shapes on 16 x 16."""
import ast
import dataclasses
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro.core import msm as jmsm
from repro.models import LanguageModel as JaxLM
from repro.models.base import abstract_params as jabstract_params
from repro.sharding import partition as jpartition
import repro_torch.configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import msm
from repro_torch.core.hw import H100_SXM
from repro_torch.data.pipeline import DataConfig, _batch_at
from repro_torch.launch import dryrun
from repro_torch.launch.specs import StandInMesh, input_specs, local_nbytes
from repro_torch.models import LanguageModel
from repro_torch.models.base import abstract_params
from repro_torch.train import OptimConfig, init_opt_state
from repro_torch.train.optim import tree_leaves
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE = "tinyllama-1.1b-smoke"
SPEC_MESHES = [(1, 1), (2, 2), (4, 2), (16, 16)]
SMALL = {
    "train_4k": ShapeConfig("train_4k", 320, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 320, 4, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 320, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 640, 1, "decode"),
}
FLOP_RTOL = 1e-9


def norm(spec) -> tuple:
    """A spec with one-name tuples as the name, and no trailing None: jax's
    ``PartitionSpec`` stores ``("data",)`` as ``"data"``."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture
def reference_on(monkeypatch):
    """``reference_on(shape)``: the reference's ``NamedSharding`` on an
    ``AbstractMesh`` of ``shape``'s sizes, and its stand-in mesh; no
    ``REPRO_OPTS`` overrides."""
    monkeypatch.delenv("REPRO_OPTS", raising=False)

    def on(shape):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        abstract = AbstractMesh(tuple(shape), names)

        def named(mesh, spec):
            return JaxNamedSharding(abstract, spec)

        monkeypatch.setattr(jspecs, "NamedSharding", named)
        monkeypatch.setattr(jpartition, "NamedSharding", named)
        return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))

    return on


def flat(tree, prefix=""):
    """``{path: leaf}`` of a nested dict (or ``ParameterDict``)."""
    out = {}
    for k in sorted(tree.keys()):
        v = tree[k]
        out.update(flat(v, f"{prefix}{k}/") if hasattr(v, "keys") else {prefix + k: v})
    return out


def reference_args(arch, shape_name, ref_mesh):
    """The reference's ``input_specs`` leaves that have a port counterpart,
    by role: ``{role: {path: ShapeDtypeStruct}}`` (its ``rng`` and decode
    ``pos`` have none), under the policy the port recommends (the two MoE
    training cells take ``msm_train`` on H100s)."""
    policy = msm.recommend(shape_name, tconfigs.get(arch).n_params())
    kind, _, args, _ = jspecs.input_specs(arch, shape_name, ref_mesh,
                                          jmsm.compose(policy.name))
    roles = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens")}[kind]
    out = {}
    for role, tree in zip(roles, args):
        out[role] = flat(tree) if isinstance(tree, dict) else {"": tree}
    return kind, out


def port_args(arch, shape, mesh):
    kind, _, args, shardings = input_specs(arch, shape, mesh)
    roles = {"train": ("params", "opt", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "tokens")}[kind]
    out = {}
    for role, tree, sh in zip(roles, args, shardings):
        out[role] = ({k: (v, flat(sh)[k]) for k, v in flat(tree).items()}
                     if hasattr(tree, "keys") else {"": (tree, sh)})
    return kind, out


def closed_form_argument_bytes(ref, sizes) -> int:
    """Σ over the reference's leaves of their local-shard bytes: each dim
    over the product of the mesh sizes its spec names."""
    total = 0
    for leaves in ref.values():
        for a in leaves.values():
            spec = tuple(a.sharding.spec) + (None,) * (len(a.shape) - len(a.sharding.spec))
            local = 1
            for dim, e in zip(a.shape, spec):
                axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
                local *= -(-dim // math.prod(sizes[x] for x in axes))
            total += local * np.dtype(a.dtype).itemsize
    return total


# --- abstract parameters -------------------------------------------------------------

def test_abstract_params_are_meta_and_load():
    model = LanguageModel(tconfigs.get("deepseek-v2-236b"))
    tree = abstract_params(model.specs())
    jtree = jabstract_params(JaxLM(jconfigs.get("deepseek-v2-236b")).specs())
    got, want = flat(tree), flat(jtree)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == want[k].shape
    model.load_params(tree)
    assert model.device.type == "meta"
    assert sum(t.numel() for t in got.values()) == sum(math.prod(a.shape)
                                                       for a in want.values())


# --- the specs against the reference's ---------------------------------------------

@pytest.mark.parametrize("mesh_shape", SPEC_MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_input_specs_equal_the_references(arch, mesh_shape, reference_on):
    """Every shape of the grid: the leaves, shapes, dtypes and specs
    ``input_specs`` gives parameters, optimizer state, batch and cache (or
    decode tokens) equal the reference's ``input_specs``'s."""
    ref_mesh = reference_on(mesh_shape)
    mesh = StandInMesh(mesh_shape)
    for shape_name in tconfigs.SHAPES:
        kind, want = reference_args(arch, shape_name, ref_mesh)
        got_kind, got = port_args(arch, shape_name, mesh)
        assert got_kind == kind
        assert list(got) == list(want)
        for role in want:
            assert sorted(got[role]) == sorted(want[role]), (shape_name, role)
            for path, a in want[role].items():
                t, sh = got[role][path]
                where = (shape_name, role, path)
                assert tuple(t.shape) == a.shape, where
                assert t.element_size() == np.dtype(a.dtype).itemsize, where
                assert str(t.dtype).split(".")[1] == np.dtype(a.dtype).name, where
                assert norm(sh.spec) == norm(a.sharding.spec), where


def reference_function(module: str, name: str):
    """A top-level function of a reference module, compiled from its source
    alone: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
    devices, which would change every later JAX test in the process."""
    tree = ast.parse((ROOT / "src" / module).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    namespace = {}
    exec(compile(ast.Module([fn], type_ignores=[]), module, "exec"), namespace)
    return namespace[name]


def test_clamp_microbatches_equals_the_references():
    reference = reference_function("repro/launch/dryrun.py", "_clamp_microbatches")
    for shape in [(1, 1), (2, 2), (4, 2), (16, 16), (2, 16, 16)]:
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        ref = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
        for mb in (1, 4, 16):
            for gb in (1, 8, 32, 128, 256):
                assert dryrun._clamp_microbatches(mb, gb, StandInMesh(shape, names)) == \
                    reference(mb, gb, ref)


# --- run_cell, in one subprocess -------------------------------------------------

FAKE_RUNS_TIMEOUT = 900
MESHES = [(1, 1), (2, 2), (1, 4)]
POD = ("pod", "data", "model")
# one architecture a family (dense, vlm, moe, MLA, hybrid, ssm, audio), run
# data-parallel on (4, 1) at the shapes whose batch "data" divides
DP_ARCHS = ["tinyllama-1.1b", "internvl2-26b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "zamba2-1.2b", "mamba2-1.3b", "whisper-base"]
DP_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]

# the subprocess: every run_cell this module reads, as JSON records by key
FAKE_RUNS = """
import contextlib, io, json, sys
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
import repro_torch.configs as configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import msm
from repro_torch.launch import dryrun
from repro_torch.launch.specs import StandInMesh, input_specs

out_path, cli_out = sys.argv[1], sys.argv[2]
small = {{name: ShapeConfig(*v) for name, v in {small}.items()}}
res = {{}}

def cell(arch, shape, mesh, names=("data", "model"), policy=None):
    return dryrun.run_cell(arch, shape, mesh=StandInMesh(mesh, names), policy=policy)

def unsharded_flops(arch, shape):
    # the step without a mesh, on plain meta tensors, FlopCounterMode's count
    cfg, one = configs.get(arch), StandInMesh((1, 1))
    policy = msm.recommend(shape.name, cfg.n_params())
    kind, model, args, _ = input_specs(cfg, shape, one, policy)
    mb = (dryrun._clamp_microbatches(policy.microbatches, shape.global_batch, one)
          if kind == "train" else 1)
    with FlopCounterMode(display=False) as flops:
        dryrun.build_step(kind, model, policy, shape, mb)(*args)
    return flops.get_total_flops()

for arch in sorted(configs.ARCHS):
    smoke = arch + "-smoke"
    for name, shape in small.items():
        for mesh in {meshes}:
            res[f"{{smoke}}|{{name}}|{{mesh}}"] = cell(smoke, shape, mesh)
        if res[f"{{smoke}}|{{name}}|(1, 1)"]["status"] == "ok":
            res[f"{{smoke}}|{{name}}|unsharded_flops"] = unsharded_flops(smoke, shape)
        if arch in {dp_archs} and name in {dp_shapes}:
            res[f"{{smoke}}|{{name}}|(4, 1)"] = cell(smoke, shape, (4, 1))
    res[f"{{smoke}}|decode_32k+kv_int8|(2, 2)"] = cell(
        smoke, small["decode_32k"], (2, 2), policy=msm.compose("msm_decode", kv_cache_dtype="int8"))
for name in configs.SHAPES:
    res[f"{smoke_arch}|{{name}}|16x16"] = dryrun.run_cell("{smoke_arch}", name)
res["yardstick"] = cell("{smoke_arch}", ShapeConfig("train", 288, 2, "train"), (1, 1),
                        policy=msm.compose("msm_train", microbatches=1))
res["train|(2, 1, 1)"] = cell("{smoke_arch}", small["train_4k"], (2, 1, 1), {pod})
# a process that has a group of its own cannot start the fake one
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    with dryrun.fake_mesh((1, 1), ("data", "model")):
        res["refused"] = None
except RuntimeError as e:
    res["refused"] = str(e)
dist.destroy_process_group()
# the CLI: a skipped cell on both meshes, an SSM cell on both, the cache
runs = []
for argv in (["--arch", "{smoke_arch}", "--shape", "long_500k", "--both-meshes"],
             ["--arch", "zamba2-1.2b-smoke", "--shape", "long_500k", "--both-meshes"],
             ["--arch", "{smoke_arch}", "--shape", "long_500k", "--both-meshes"]):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        code = dryrun.main(argv + ["--out", cli_out])
    runs.append({{"code": code, "printed": printed.getvalue(),
                 "records": json.load(open(cli_out))}})
res["cli"] = runs
with open(out_path, "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The records of ``FAKE_RUNS``, run in one subprocess of its own session,
    killed (its whole process group) at ``FAKE_RUNS_TIMEOUT``."""
    tmp = tmp_path_factory.mktemp("fake_runs")
    out = tmp / "runs.json"
    script = FAKE_RUNS.format(small={k: dataclasses.astuple(v) for k, v in SMALL.items()},
                              meshes=MESHES, smoke_arch=SMOKE, pod=POD, dp_archs=DP_ARCHS,
                              dp_shapes=DP_SHAPES)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with open(tmp / "stdout", "w") as so, open(tmp / "stderr", "w") as se:
        proc = subprocess.Popen([sys.executable, "-c", script, str(out), str(tmp / "cli.json")],
                                stdin=subprocess.DEVNULL, stdout=so, stderr=se, cwd=ROOT,
                                env=env, start_new_session=True)
        try:
            proc.wait(timeout=FAKE_RUNS_TIMEOUT)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    assert proc.returncode == 0, (proc.returncode, (tmp / "stderr").read_text()[-4000:])
    return json.loads(out.read_text())


def smoke_cells(fake_runs, arch, mesh):
    """``{shape name: record}`` of ``arch``'s smoke config at ``SMALL`` on
    ``mesh``."""
    return {name: fake_runs[f"{arch}-smoke|{name}|{mesh}"] for name in SMALL}


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_run_cell_on_each_smoke_config(arch, reference_on, monkeypatch, fake_runs):
    """Each shape on a (2, 2) mesh: ok, or skipped with the reference's
    reason; argument bytes equal to the closed form over the reference's
    specs at the same shape; every field present and finite."""
    smoke = arch + "-smoke"
    ref_mesh = reference_on((2, 2))
    for name, res in smoke_cells(fake_runs, arch, (2, 2)).items():
        monkeypatch.setitem(jconfigs.SHAPES, name, jconfigs.ShapeConfig(**dataclasses.asdict(
            SMALL[name])))
        runnable, reason = jconfigs.base.cell_is_runnable(jconfigs.get(smoke),
                                                          jconfigs.SHAPES[name])
        if not runnable:
            assert (res["status"], res["reason"]) == ("skipped", reason)
            continue
        assert res["status"] == "ok", res
        assert res["mesh"] == "2x2" and res["chips"] == 4
        _, ref = reference_args(smoke, name, ref_mesh)
        assert res["argument_bytes_per_device"] == closed_form_argument_bytes(
            ref, {"data": 2, "model": 2})
        for key in ("flops_per_device", "bytes_per_device", "temp_bytes_per_device",
                    "collective_bytes_per_device", "model_flops", "useful_flops"):
            assert math.isfinite(res[key]) and res[key] > 0, (name, key)
        assert res["peak_memory_per_device"] == res["argument_bytes_per_device"] + \
            res["temp_bytes_per_device"]
        assert res["fits"] == (res["peak_memory_per_device"] <= H100_SXM.hbm_capacity)
        assert res["roofline"]["dominant"] in ("compute", "memory", "collective")
        assert res["collective_bytes_per_device"] == sum(
            res["collectives"]["by_kind"].values())


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_one_device_counts_equal_the_unsharded_step(arch, fake_runs):
    """On a (1, 1) mesh every smoke cell's FLOPs equal, exactly,
    ``FlopCounterMode``'s count of the same step run without a mesh on
    plain ``meta`` tensors, and no collective moves a byte."""
    for name, res in smoke_cells(fake_runs, arch, (1, 1)).items():
        if res["status"] != "ok":
            continue
        assert res["flops_per_device"] == fake_runs[f"{arch}-smoke|{name}|unsharded_flops"], name
        assert res["collective_bytes_per_device"] == 0, name
        assert res["chips"] == 1


# the cells in which rank 0 runs the whole step: mamba2's mixers run on each
# rank's rows with every weight replicated (``layers.on_rows``), and its loss
# reads the whole vocabulary on each rank's rows, so over "model" alone
# (rows over a "data" of 1) no op of its training step divides
WHOLE_STEP_ON_EACH_RANK = {("mamba2-1.3b", "train_4k", (1, 4))}


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_per_rank_counts_on_a_mesh(arch, mesh, reference_on, monkeypatch, fake_runs):
    """Each family's smoke ``train``, ``prefill`` and ``decode`` cells on
    (2, 2) and (1, 4): the argument bytes equal the closed form over the
    reference's specs, and rank 0's FLOPs times the chips are at least the
    unsharded step's (no work is lost) while rank 0's own FLOPs are fewer
    than the step's (a count of the global op would equal it), but in the
    cells of ``WHOLE_STEP_ON_EACH_RANK``, where they equal it."""
    smoke = arch + "-smoke"
    ref_mesh = reference_on(mesh)
    chips = math.prod(mesh)
    for name, res in smoke_cells(fake_runs, arch, mesh).items():
        if res["status"] != "ok":
            continue
        monkeypatch.setitem(jconfigs.SHAPES, name, jconfigs.ShapeConfig(**dataclasses.asdict(
            SMALL[name])))
        _, ref = reference_args(smoke, name, ref_mesh)
        assert res["argument_bytes_per_device"] == closed_form_argument_bytes(
            ref, dict(zip(("data", "model"), mesh))), name
        whole = fake_runs[f"{smoke}|{name}|unsharded_flops"]
        assert whole <= res["flops_per_device"] * chips, name
        if (arch, name, mesh) in WHOLE_STEP_ON_EACH_RANK:
            assert res["flops_per_device"] == whole, name
        else:
            assert res["flops_per_device"] < whole, name


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_data_parallel_splits_the_step_evenly(arch, fake_runs):
    """Each family's smoke ``train``, ``prefill`` and ``decode`` cells on
    (4, 1), whose batch rows "data" divides: every op of the step runs on
    each rank's rows (FSDP's weights gathered whole), so rank 0's FLOPs are
    the unsharded step's over 4, exactly; its bytes and its peak of
    temporaries are below the (1, 1) cell's, which a count of the global
    ops would equal."""
    smoke = arch + "-smoke"
    for name in DP_SHAPES:
        res, one = fake_runs[f"{smoke}|{name}|(4, 1)"], fake_runs[f"{smoke}|{name}|(1, 1)"]
        assert res["status"] == "ok" and res["chips"] == 4, (name, res)
        assert res["flops_per_device"] * 4 == fake_runs[f"{smoke}|{name}|unsharded_flops"], name
        assert res["bytes_per_device"] < one["bytes_per_device"], name
        assert res["temp_bytes_per_device"] < one["temp_bytes_per_device"], name


@pytest.mark.parametrize("mesh", [(4, 1), (2, 2), (1, 4)], ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", DP_SHAPES)
def test_dense_per_rank_flops_by_closed_form(name, mesh, fake_runs):
    """tinyllama smoke's cells (L = 2 layers, d = 64, F = 128, V = 256): rank
    0's FLOPs are the unsharded step's split over every rank, but for the
    work a rank repeats, which splits over "data" only:

    * train: the loss's vocab product, 2TdV four times a microbatch
      (``test_dense_flops_by_closed_form``): the chunked cross-entropy runs
      on each rank's rows against the whole vocabulary (``layers.on_rows``);
    * prefill: none (its logits are the last position's, over the vocab
      shards);
    * decode: the first block's FFN gate and up products, 2 x 2BdF: its
      residual is the embedding's rows plus the output projection's partial
      sums over "model" (``Partial``), so ``DTensor`` gathers w_gate and
      w_up whole and runs both on the partial sums on every rank (later
      blocks take their F-slice; ROADMAP queue 2, C3)."""
    cfg = tconfigs.get(SMOKE)
    shape = SMALL[name]
    res = fake_runs[f"{SMOKE}|{name}|{mesh}"]
    whole = fake_runs[f"{SMOKE}|{name}|unsharded_flops"]
    data, model = mesh
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    rows = shape.global_batch
    repeated = {"train_4k": 4 * 2 * rows * shape.seq_len * d * v,   # Σ over the microbatches
                "prefill_32k": 0,
                "decode_32k": 2 * 2 * rows * d * f}[name]
    want = (whole - repeated) / (data * model) + repeated / data
    assert res["flops_per_device"] == pytest.approx(want, rel=FLOP_RTOL), name


def test_an_int8_cache_halves_the_cache_bytes(fake_runs):
    """Each smoke config's ``decode_32k`` on (2, 2) with an int8 cache
    (``compose("msm_decode", kv_cache_dtype="int8")``): the argument bytes
    are the bf16 cell's less half its cache bytes, the SSM state (fp32 in
    both) aside."""
    for arch in sorted(tconfigs.ARCHS):
        smoke = arch + "-smoke"
        bf16 = fake_runs[f"{smoke}|decode_32k|(2, 2)"]
        int8 = fake_runs[f"{smoke}|decode_32k+kv_int8|(2, 2)"]
        assert int8["status"] == bf16["status"] == "ok" and int8["kv_cache_dtype"] == "int8"
        _, _, args, shardings = input_specs(smoke, SMALL["decode_32k"], StandInMesh((2, 2)))
        cache = sum(local_nbytes(t, shardings[1][k]) for k, t in args[1].items() if k != "ssm")
        assert int8["argument_bytes_per_device"] == bf16["argument_bytes_per_device"] - cache / 2


def test_tinyllama_smoke_at_the_grids_shapes(reference_on, fake_runs):
    """The grid's own shapes on the production mesh (16 x 16, 256 ranks of a
    fake group): 3 cells ok, long_500k skipped as the reference skips it,
    argument bytes equal to the closed form. Its 4 query heads and 2 KV heads
    divide no "model" of 16: the training cell's backward takes the heads
    back whole (``attention.merge_heads``)."""
    ref_mesh = reference_on((16, 16))
    statuses = []
    for name in tconfigs.SHAPES:
        res = fake_runs[f"{SMOKE}|{name}|16x16"]
        statuses.append(res["status"])
        if res["status"] != "ok":
            assert res["reason"] == jconfigs.base.cell_is_runnable(
                jconfigs.get(SMOKE), jconfigs.SHAPES[name])[1]
            continue
        assert res["mesh"] == "16x16" and res["chips"] == 256
        _, ref = reference_args(SMOKE, name, ref_mesh)
        assert res["argument_bytes_per_device"] == closed_form_argument_bytes(
            ref, {"data": 16, "model": 16})
        assert res["collective_bytes_per_device"] > 0
    assert statuses == ["ok", "ok", "ok", "skipped"]


def test_argument_bytes_equal_an_allocated_state(fake_runs):
    """The yardstick the card holds at full size, on the CPU at smoke size:
    on a (1, 1) mesh the dry-run's argument bytes are the Σ nbytes of the
    parameters and optimizer state a training run holds, plus its batch."""
    res = fake_runs["yardstick"]
    model = LanguageModel(tconfigs.get(SMOKE)).init(torch.Generator().manual_seed(0),
                                                    device="cpu")
    state = init_opt_state(model.params, OptimConfig())
    batch = _batch_at(DataConfig(model.cfg.vocab_size, 288, 2), 0, slice(0, 2))
    held = (sum(t.nbytes for t in tree_leaves(model.params))
            + sum(t.nbytes for t in tree_leaves(state)) + sum(v.nbytes for v in batch.values()))
    assert res["argument_bytes_per_device"] == held


def test_collective_bytes_by_hand(fake_runs):
    """tinyllama smoke's training cell (8 x 320; L = 2 layers, d = 64, 4
    heads and 2 KV heads of 16, F = 128, V = 256), the collectives its mesh
    path issues, in the module docstring's bytes (an all-gather (n-1) x its
    input, a reduce-scatter (n-1)/n of its input, an all-reduce 2(n-1)/n):

    * (1, 1): none.
    * (4, 1), FSDP over "data" (n = 4; every weight has a 64-wide "embed"
      dim, split 4 ways), mb = 2 microbatches (2 rows a rank): each
      projection of a block gathered at its use in the forward, again in the
      remat recompute and again in the backward (``DTensor`` re-gathers the
      weight for the input's gradient), the FFN's down projection twice (the
      recompute stops before the block's last product), the norms' scales
      likewise three times but in fp32 (the norm casts them first); the
      embedding and the LM head once a microbatch (read whole through
      ``layers.on_rows``), the final norm's scale twice (forward and
      backward, fp32); each gradient reduce-scattered once a microbatch; the
      loss's two fp32 sums a microbatch and the gradient norm's two a step
      all-reduced; and the batch's three int32 keys gathered once (mb = 2
      does not divide the 4 ranks the rows lie on, so the microbatch split
      gathers them first).
    * (1, 4), sequence parallel over "model" (n = 4), mb = 4 (b = 2 rows,
      X = b S d bf16 bytes of the stream): the stream gathered before each
      attention and FFN in the forward and the recompute, and in the
      backward of each of their outputs' reduce-scatters, plus the loss's
      gather and one more in its backward (14 a microbatch); reduce-scattered
      after each in the forward, after the attention in the recompute, and
      in the backward of each gather (10); the 2 KV heads, which do not
      divide "model", gathered whole for k and v in the forward and the
      recompute (``attention.whole_heads``) and their gradients
      reduce-scattered; the embedding and the LM head (vocab over "model")
      gathered once a microbatch; the norms' gradients (partial over the
      sequence shards) all-reduced once a microbatch; the gradient norm's
      two sums.
    * the decode cell on (1, 4): the 2 KV heads do not divide "model", so
      the cache's sequence lies over it and each layer merges the ranks'
      K3 partial results with three fp32 all-reduces (``combine_partials``:
      max lse, Σw out, Σw)."""
    cfg = tconfigs.get(SMOKE)
    L, d, h, kvh, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shape = SMALL["train_4k"]
    full = {k: t.numel() * 2 for k, t in flat(abstract_params(
        LanguageModel(cfg).specs())).items()}
    in_blocks = sum(v_ for k, v_ in full.items() if k.startswith("layers/"))
    others = sum(v_ for k, v_ in full.items() if not k.startswith("layers/"))
    norms = sum(v_ for k, v_ in full.items() if k.startswith("layers/ln"))
    down = full["layers/ffn/w_down"]
    emb, head, ln_f = full["emb/embedding"], full["emb/lm_head"], full["ln_f/scale"]

    one = fake_runs[f"{SMOKE}|train_4k|(1, 1)"]
    assert one["collective_bytes_per_device"] == 0
    assert all(n == 0 for n in one["collectives"]["calls"].values())

    fsdp = fake_runs[f"{SMOKE}|train_4k|(4, 1)"]
    mb, g = 2, 3 / 4                          # 8 rows over 4: 2 a rank, policy 4
    assert fsdp["microbatches"] == mb
    kinds = fsdp["collectives"]["by_kind"]
    gathered = (3 * (in_blocks - norms) - down + 3 * 2 * norms + emb + head + 2 * 2 * ln_f)
    batch_keys = 3 * shape.global_batch * shape.seq_len * 4
    assert kinds["all-gather"] == pytest.approx(mb * g * gathered + g * batch_keys, rel=1e-12)
    assert kinds["reduce-scatter"] == pytest.approx(mb * g * (in_blocks + others), rel=1e-12)
    assert kinds["all-reduce"] == pytest.approx((2 * mb + 2) * 2 * g * 4, rel=1e-12)
    assert kinds["all-to-all"] == 0

    sp = fake_runs[f"{SMOKE}|train_4k|(1, 4)"]
    mb = 4
    assert sp["microbatches"] == mb
    kinds = sp["collectives"]["by_kind"]
    b = shape.global_batch // mb
    x = b * shape.seq_len * d * 2
    kv = b * shape.seq_len * kvh * hd * 2         # k or v, whole
    assert kinds["all-gather"] == pytest.approx(
        mb * g * (14 * x + 2 * L * 2 * kv + emb + head), rel=1e-12)
    assert kinds["reduce-scatter"] == pytest.approx(mb * g * (10 * x + 2 * L * kv), rel=1e-12)
    assert kinds["all-reduce"] == pytest.approx(mb * 2 * g * (norms + ln_f) + 2 * 2 * g * 4,
                                                rel=1e-12)

    dec = fake_runs[f"{SMOKE}|decode_32k|(1, 4)"]
    rows = SMALL["decode_32k"].global_batch
    assert dec["collectives"]["calls"]["all-reduce"] == 3 * L
    assert dec["collectives"]["by_kind"]["all-reduce"] == pytest.approx(
        L * 2 * g * 4 * (2 * rows * h + rows * h * hd), rel=1e-12)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_the_attention_peak_grows_with_s_not_s_squared(kind):
    """tinyllama smoke's step on plain ``meta`` tensors (``count_step``, no
    process group), at S and 2S: K1 and K2 count as the kernels run (their
    inputs, outputs and lse; no (S x S) scores), so the peak of temporaries
    at 2S is at most twice the peak at S and below one layer's fp32 score
    square at 2S. Prefill's FLOPs equal, exactly, ``FlopCounterMode``'s count
    of the same step on CPU tensors, which takes the plain versions: the
    FLOPs keep counting every (query, key) pair."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.serve.step import make_prefill_step

    cfg = tconfigs.get(SMOKE)
    one, b, peaks = StandInMesh((1, 1)), 4, []
    policy = msm.recommend(f"{kind}_32k" if kind == "prefill" else "train_4k", cfg.n_params())
    for s in (512, 1024):
        shape = ShapeConfig(f"{kind}_{s}", s, b, kind)
        _, model, args, _ = input_specs(cfg, shape, one, policy)
        mb = dryrun._clamp_microbatches(policy.microbatches, b, one) if kind == "train" else 1
        counts = dryrun.count_step(dryrun.build_step(kind, model, policy, shape, mb), args)
        peaks.append(counts.temp_peak)
        if kind == "prefill":
            cpu = LanguageModel(cfg, impl="kernel").init(torch.Generator().manual_seed(0),
                                                         device="cpu")
            batch = {k: torch.zeros_like(v, device="cpu") for k, v in args[1].items()}
            with FlopCounterMode(display=False) as plain, torch.no_grad():
                make_prefill_step(cpu)(batch)
            assert counts.flops == plain.get_total_flops(), s
    square = b * cfg.n_heads * 1024 ** 2 * 4
    assert peaks[1] <= 2 * peaks[0] * (1 + 1e-3) and peaks[1] < square, (peaks, square)


def test_dense_flops_by_closed_form(fake_runs):
    """tinyllama smoke's training step on one device: per microbatch of b
    rows and T = b S tokens, each layer's products P = 2T(dHh + 2dKh + Hhd +
    3dF) and attention units A = 2bHS^2h (the plain versions' full square)
    counted in the forward (P + 2A), the remat recompute (P + 2A less the
    block's last product, 2TFd: ``torch.utils.checkpoint`` stops
    recomputing once every saved activation is back, and no backward reads
    that product's output) and the backward (2P + 7A: the plain dq
    recomputes S and dP and takes dS K, the plain dk/dv S, dP, dS^T Q and
    P^T dO); the chunked loss's vocab product 2TdV four times (forward, the
    chunk's recompute, two gradients)."""
    cfg = tconfigs.get(SMOKE)
    shape = SMALL["train_4k"]
    res = fake_runs[f"{SMOKE}|train_4k|(1, 1)"]
    mb = res["microbatches"]
    b, s = shape.global_batch // mb, shape.seq_len
    d, h, kvh, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                           cfg.vocab_size)
    t = b * s
    p = 2 * t * (d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f)
    a = 2 * b * h * s * s * hd
    want = mb * (cfg.n_layers * (4 * p - 2 * t * f * d + 11 * a) + 4 * 2 * t * d * v)
    assert res["flops_per_device"] == pytest.approx(want, rel=FLOP_RTOL)


def test_a_pod_mesh_runs_each_cell(fake_runs):
    """The reference's multi-pod layout, ("pod", "data", "model") of (2, 1,
    1): the training cell runs; the weights and their state replicate over
    "pod" and the batch splits over it, so its argument bytes are the (1, 1)
    cell's less half the batch's.

    Every op that runs on local shards takes the batch's rows over "pod"
    and "data" (the rows role of ``partition.role_placements``), so each pod
    computes its own half of the batch: rank 0's FLOPs are the (1, 1) cell's
    over 2, and its collectives are those of data parallelism alone. With n =
    2 and mb = 4 microbatches of one row a rank, over "pod":

    * all-reduced, once a microbatch (2(n-1)/n = 1 x the input): every
      gradient, mb x the parameters' bytes, and the loss's two fp32 sums;
    * all-gathered ((n-1) x the input): the split batch's three int32 keys,
      once (the microbatch split gathers dim 0 first: mb = 4 does not divide
      the batch's 2 shards of 4 rows each into whole microbatches);
    * nothing reduce-scattered or sent all-to-all."""
    pod, one = fake_runs["train|(2, 1, 1)"], fake_runs[f"{SMOKE}|train_4k|(1, 1)"]
    assert pod["status"] == "ok" and pod["chips"] == 2 and pod["mesh"] == "2x1x1"
    shape = SMALL["train_4k"]
    batch = 3 * shape.global_batch * shape.seq_len * 4
    assert pod["argument_bytes_per_device"] == one["argument_bytes_per_device"] - batch / 2

    cfg = tconfigs.get(SMOKE)
    full = {k: t.numel() * 2 for k, t in flat(abstract_params(
        LanguageModel(cfg).specs())).items()}
    mb = 4
    assert pod["microbatches"] == one["microbatches"] == mb
    right = mb * sum(full.values())
    kinds, calls = pod["collectives"]["by_kind"], pod["collectives"]["calls"]
    assert kinds["all-reduce"] == pytest.approx(right + mb * 2 * 4, rel=1e-12)
    assert calls["all-reduce"] == mb * (len(full) + 2)
    assert kinds["all-gather"] == pytest.approx(batch / 2, rel=1e-12)
    assert calls["all-gather"] == 3
    assert kinds["reduce-scatter"] == kinds["all-to-all"] == 0
    assert pod["flops_per_device"] * 2 == one["flops_per_device"]


def test_fake_mesh_refuses_an_existing_group(fake_runs):
    """``fake_mesh`` starts the process's default group: where one exists
    (here a one-rank gloo group) it raises and starts nothing."""
    assert "already has a process group" in fake_runs["refused"]


def test_train_step_takes_the_references_microbatch_placements(reference_on):
    """The dry-run's training step is built with the parameters' placements
    for its gradients and, for its split batch, the batch's placements
    behind a replicated microbatch dim: the reference's ``mb_shard``
    (``src/repro/launch/dryrun.py:66-69``) over its batch specs, on every
    mesh of ``SPEC_MESHES``."""
    for mesh_shape in SPEC_MESHES:
        ref_mesh = reference_on(mesh_shape)
        _, ref = reference_args(SMOKE, "train_4k", ref_mesh)
        kind, _, _, (param_sh, _, batch_sh) = input_specs(SMOKE, "train_4k",
                                                          StandInMesh(mesh_shape))
        assert kind == "train"
        got = dryrun.microbatch_shardings(batch_sh)
        assert sorted(got) == sorted(ref["batch"])
        for k, a in ref["batch"].items():
            assert norm(got[k].spec) == norm((None, *a.sharding.spec)), k
        captured = {}

        def fake_make(model, opt_cfg, compression, microbatches, grad_shardings,
                      batch_shardings):
            captured.update(grad=grad_shardings, batch=batch_shardings)

        import unittest.mock
        with unittest.mock.patch.object(dryrun, "make_train_step", fake_make):
            dryrun.build_step("train", None, msm.TRAIN_MSM, SMALL["train_4k"], 4,
                              (param_sh, None, batch_sh))
        assert captured["grad"] is param_sh
        assert {k: norm(s.spec) for k, s in captured["batch"].items()} == \
            {k: norm(s.spec) for k, s in got.items()}


def test_step_counter_tracks_live_storage():
    x = torch.empty(1000, device="meta")

    def step(x):
        y = x * 2
        z = y.view(10, 100) + 1          # a view shares its base's storage
        del y
        return z * 3

    counter = dryrun.StepCounter((x,))
    with counter:
        out = step(x)
    assert counter.peak == 8000 and counter.live == 4000
    assert counter.bytes == 3 * 8000     # three ops of 4000 bytes in and out; views free
    del out
    assert counter.live == 0
    params = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.empty(8, device="meta"))})
    inplace = dryrun.StepCounter(({"x": x}, params))
    with inplace, torch.no_grad():
        x.mul_(2)                        # the arguments' storage is not the step's,
        params["w"].add_(1)              # a ParameterDict's leaves' neither
    assert inplace.peak == 0


def test_cli_sweeps_caches_and_reports(fake_runs):
    """``main``: a cell the reference skips, on both meshes; an SSM cell on
    both (256 and 512 ranks, each its own step: the 2x16x16 cell's batch of
    one splits over no "pod"); each decode shape again with an int8 cache;
    the first sweep again, from the cache."""
    first, ssm, again = fake_runs["cli"]
    assert first["code"] == ssm["code"] == again["code"] == 0
    keys = [f"{SMOKE}|long_500k{v}|{m}" for v in ("", "+kv_int8") for m in ("16x16", "2x16x16")]
    assert sorted(first["records"]) == sorted(keys)
    assert all(first["records"][k]["status"] == "skipped" for k in keys)
    for variant, dtype in (("", "bfloat16"), ("+kv_int8", "int8")):
        single, pod = (ssm["records"][f"zamba2-1.2b-smoke|long_500k{variant}|{m}"]
                       for m in ("16x16", "2x16x16"))
        assert single["status"] == pod["status"] == "ok"
        assert single["kv_cache_dtype"] == pod["kv_cache_dtype"] == dtype
        assert (single["chips"], pod["chips"]) == (256, 512)
        assert single["flops_per_device"] > 0 and pod["flops_per_device"] > 0
    assert f"[cached] {SMOKE}|long_500k|16x16: skipped" in again["printed"]
    assert "Summary: 4 ok, 4 skipped, 0 errors" in again["printed"]
