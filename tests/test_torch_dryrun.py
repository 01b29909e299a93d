"""The port's dry-run (``launch/specs``, ``launch/dryrun``,
``models.base.abstract_params``) against the JAX package and against closed
forms.

The placements are pure functions of shapes and mesh sizes, so both sides
run on stand-in meshes: the port's ``StandInMesh``, and for the reference
its ``NamedSharding`` built on a ``jax.sharding.AbstractMesh`` of the same
sizes (its rules read a mesh's axis names and device-array shape only).
``run_cell`` runs each cell's step on ``meta`` tensors. The smoke configs
run at a small shape a step (``SMALL``, the grid's names and kinds): on
``meta`` every op costs a Python-level shape computation, and the Mamba-2
layers' naive scan takes a Python loop a chunk of 32 positions, so at the
grid's 4096 and 32768 positions one smoke cell takes minutes; tinyllama's
smoke config also runs at the grid's own shapes."""
import ast
import dataclasses
import json
import math
import pathlib
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
from repro_torch.launch.specs import StandInMesh, input_specs
from repro_torch.models import LanguageModel
from repro_torch.models.base import abstract_params
from repro_torch.train import OptimConfig, init_opt_state
from repro_torch.train.optim import tree_leaves

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


# --- run_cell ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_run_cell_on_each_smoke_config(arch, reference_on, monkeypatch):
    """Each shape on a (2, 2) stand-in: ok, or skipped with the reference's
    reason; argument bytes equal to the closed form over the reference's
    specs at the same shape; every field present and finite."""
    smoke = arch + "-smoke"
    ref_mesh = reference_on((2, 2))
    for name, shape in SMALL.items():
        monkeypatch.setitem(jconfigs.SHAPES, name, jconfigs.ShapeConfig(**dataclasses.asdict(
            shape)))
        res = dryrun.run_cell(smoke, shape, mesh=StandInMesh((2, 2)))
        runnable, reason = jconfigs.base.cell_is_runnable(jconfigs.get(smoke),
                                                          jconfigs.SHAPES[name])
        if not runnable:
            assert (res["status"], res["reason"]) == ("skipped", reason)
            continue
        assert res["status"] == "ok", res
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


def test_tinyllama_smoke_at_the_grids_shapes(reference_on):
    """The grid's own shapes on the production stand-in (16 x 16): 3 cells
    ok, long_500k skipped as the reference skips it, argument bytes equal
    to the closed form."""
    ref_mesh = reference_on((16, 16))
    statuses = []
    for name in tconfigs.SHAPES:
        res = dryrun.run_cell(SMOKE, name)
        statuses.append(res["status"])
        if res["status"] != "ok":
            assert res["reason"] == jconfigs.base.cell_is_runnable(
                jconfigs.get(SMOKE), jconfigs.SHAPES[name])[1]
            continue
        assert res["mesh"] == "16x16" and res["chips"] == 256
        _, ref = reference_args(SMOKE, name, ref_mesh)
        assert res["argument_bytes_per_device"] == closed_form_argument_bytes(
            ref, {"data": 16, "model": 16})
    assert statuses == ["ok", "ok", "ok", "skipped"]


def test_argument_bytes_equal_an_allocated_state():
    """The yardstick the card holds at full size, on the CPU at smoke size:
    on a (1, 1) stand-in the dry-run's argument bytes are the Σ nbytes of
    the parameters and optimizer state a training run holds, plus its
    batch."""
    shape = ShapeConfig("train", 288, 2, "train")
    policy = msm.compose("msm_train", microbatches=1)
    res = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((1, 1)), policy=policy)
    model = LanguageModel(tconfigs.get(SMOKE)).init(torch.Generator().manual_seed(0),
                                                    device="cpu")
    state = init_opt_state(model.params, OptimConfig())
    batch = _batch_at(DataConfig(model.cfg.vocab_size, 288, 2), 0, slice(0, 2))
    held = (sum(t.nbytes for t in tree_leaves(model.params))
            + sum(t.nbytes for t in tree_leaves(state)) + sum(v.nbytes for v in batch.values()))
    assert res["argument_bytes_per_device"] == held


def test_collective_bytes_by_hand():
    """tinyllama smoke's training cell: none on one device; on (4, 1) only
    FSDP (every leaf has a 64-wide "embed" dim, so each is split 4 ways):
    each weight gathered at its use and, inside the blocks, again in the
    recompute, and each gradient reduce-scattered, (4 - 1)/4 of its bytes a
    time; on (1, 4) the embedding and LM head gathered over "model" (vocab
    over "model"), and the sequence-parallel gather and reduce-scatter
    around the 2 x 2 attention and FFN sites in the forward, recompute and
    backward, plus the loss's gather and its gradient's reduce-scatter; on
    (2, 1, 1) ("pod", "data", "model") each gradient all-reduced over
    "pod"."""
    cfg = tconfigs.get(SMOKE)
    shape = SMALL["train_4k"]
    full = {k: t.numel() * 2 for k, t in flat(abstract_params(
        LanguageModel(cfg).specs())).items()}
    in_blocks = sum(v for k, v in full.items() if k.startswith("layers/"))
    others = sum(v for k, v in full.items() if not k.startswith("layers/"))
    head = full["emb/embedding"] + full["emb/lm_head"]

    one = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((1, 1)))
    assert one["collective_bytes_per_device"] == 0
    assert all(v == 0 for v in one["collectives"]["by_term"].values())

    fsdp = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((4, 1)))
    mb = 2                                    # 8 rows over 4: 2 a rank, policy 4
    assert fsdp["microbatches"] == mb
    want = mb * 3 / 4 * (3 * in_blocks + 2 * others)
    assert fsdp["collective_bytes_per_device"] == pytest.approx(want, rel=1e-12)
    assert fsdp["collectives"]["by_kind"]["all-reduce"] == 0

    sp = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((1, 4)))
    mb = 4
    assert sp["microbatches"] == mb
    x = (8 // mb) * shape.seq_len * cfg.d_model * 2
    sites, passes = 2 * cfg.n_layers, 3
    want = mb * (3 / 4 * head + 3 / 4 * x * (sites * passes * 2 + 2))
    assert sp["collective_bytes_per_device"] == pytest.approx(want, rel=1e-12)
    assert sp["collectives"]["by_kind"]["all-reduce"] == 0
    # over "pod" alone (weights never shard over it) each gradient is
    # all-reduced, 2 (2 - 1)/2 of its bytes, at each of 4 microbatches
    pod = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((2, 1, 1), ("pod", "data", "model")))
    assert pod["microbatches"] == 4
    assert pod["collective_bytes_per_device"] == pytest.approx(4 * (in_blocks + others),
                                                               rel=1e-12)
    assert pod["collectives"]["by_term"]["grad_all_reduce"] == pod["collective_bytes_per_device"]
    # a decode step's one token cannot shard over "model": all-reduces there
    dec = dryrun.run_cell(SMOKE, SMALL["decode_32k"], mesh=StandInMesh((1, 4)))
    assert dec["collectives"]["by_term"]["sp_all_reduce"] == pytest.approx(
        2 * cfg.n_layers * 2 * 3 / 4 * 8 * cfg.d_model * 2, rel=1e-12)


def test_dense_flops_by_closed_form():
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
    res = dryrun.run_cell(SMOKE, shape, mesh=StandInMesh((1, 1)))
    mb = res["microbatches"]
    b, s = shape.global_batch // mb, shape.seq_len
    d, h, kvh, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                           cfg.vocab_size)
    t = b * s
    p = 2 * t * (d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f)
    a = 2 * b * h * s * s * hd
    want = mb * (cfg.n_layers * (4 * p - 2 * t * f * d + 11 * a) + 4 * 2 * t * d * v)
    assert res["flops_per_device"] == pytest.approx(want, rel=FLOP_RTOL)


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


def test_cli_sweeps_caches_and_reports(tmp_path, capsys):
    out = tmp_path / "res.json"
    argv = ["--arch", SMOKE, "--shape", "long_500k", "--both-meshes", "--out", str(out)]
    assert dryrun.main(argv) == 0
    res = json.loads(out.read_text())
    assert sorted(res) == [f"{SMOKE}|long_500k|16x16", f"{SMOKE}|long_500k|2x16x16"]
    assert all(r["status"] == "skipped" for r in res.values())
    assert dryrun.main(["--arch", "zamba2-1.2b-smoke", "--shape", "long_500k",
                        "--both-meshes", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    pod, single = (res[f"zamba2-1.2b-smoke|long_500k|{m}"] for m in ("2x16x16", "16x16"))
    assert single["status"] == pod["status"] == "ok"
    assert (single["chips"], pod["chips"]) == (256, 512)
    assert pod["flops_per_device"] == single["flops_per_device"] / 2
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    printed = capsys.readouterr().out
    assert f"[cached] {SMOKE}|long_500k|16x16: skipped" in printed
    assert "Summary: 2 ok, 2 skipped, 0 errors" in printed
