"""The port's sharding (``repro_torch.sharding``, ``launch.mesh``, the
sharded train step and the resharding restore) against the reference's
rules and against the port's own unsharded step.

The rules are pure functions of shapes and mesh sizes, so both sides are
held on stand-in meshes of the sizes alone. Multi-rank runs are CPU
``gloo`` processes started by ``run_ranks``, each rank in a session of its
own with its output in files of its own, meeting through a ``FileStore``
under the test's ``tmp_path``: no process group is started in the test
process and no port is opened."""
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.base import abstract_params
from repro.sharding import partition as jpartition
import repro_torch.configs as tconfigs
from repro_torch.checkpoint.ckpt import _unflatten, restore
from repro_torch.data.pipeline import DataConfig, _batch_at, host_batch_slice
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.sharding import partition
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves
from torch.distributed.tensor import Replicate, Shard

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [(1, 1), (2, 2), (4, 2)]


def ref_mesh(shape):
    """What the reference's rules read of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape))


def port_mesh(shape):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape, ndim=len(shape))


def norm(spec) -> tuple:
    """A spec with one-name tuples as the name: jax's ``PartitionSpec``
    stores ``("data",)`` as ``"data"``."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``NamedSharding`` reduced to its spec, so that its
    rules run on a stand-in mesh."""
    monkeypatch.setattr(jpartition, "NamedSharding", lambda mesh, spec: spec)


# --- ports of tests/test_sharding.py:17-31 ----------------------------------------

def test_resolve_spec_divisibility_degrades():
    mesh = port_mesh((1, 1))
    # model=1 divides anything; heads shard onto model
    assert partition.resolve_spec((2048, 4096), ("embed", "heads"), mesh) == ("data", "model")


def test_resolve_spec_no_double_claim():
    mesh = port_mesh((1, 1))
    # two ff axes: only one may claim "model"
    assert list(partition.resolve_spec((512, 512), ("ff", "ff"), mesh)).count("model") == 1


def test_resolve_spec_priority_experts_first():
    mesh = port_mesh((1, 1))
    spec = partition.resolve_spec((8, 64, 128), ("experts", "embed", "ff"), mesh)
    assert spec[0] == "model" and spec[1] == "data" and spec[2] is None


# --- every leaf of every architecture against the reference -------------------------

def leaves(tree, prefix=""):
    """``(path, leaf)`` of a nested dict (or ``ParameterDict``) in sorted-key order."""
    for k in sorted(tree.keys()):
        v = tree[k]
        yield from leaves(v, f"{prefix}{k}/") if hasattr(v, "keys") else [(prefix + k, v)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_param_specs_equal_the_references(arch, shape, ref_specs):
    """``param_shardings`` (and so ``resolve_spec``), with and without FSDP,
    gives every parameter of the smoke config the reference's spec."""
    jm = JaxLM(jconfigs.get(arch + "-smoke"))
    tm = LanguageModel(tconfigs.get(arch + "-smoke"))
    for fsdp in (True, False):
        want = dict(leaves(jpartition.param_shardings(jm.axes(), abstract_params(jm.specs()),
                                                      ref_mesh(shape), fsdp=fsdp)))
        got = dict(leaves(partition.param_shardings(tm.axes(), tm.specs(), port_mesh(shape),
                                                    fsdp=fsdp)))
        assert list(got) == list(want)
        for name, sh in got.items():
            assert norm(sh.spec) == norm(want[name]), (name, fsdp)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_cache_specs_equal_the_references(arch, shape, ref_specs):
    """``cache_shardings`` over the cache each family allocates, at batch 1
    (never split) and 4, with and without ``shard_seq``."""
    cfg = tconfigs.get(arch + "-smoke")
    if cfg.family == "moe" and cfg.first_k_dense and not cfg.use_mla:
        pytest.fail("no smoke config should lack a decode cache")
    for batch in (1, 4):
        cache = LanguageModel(cfg).init_cache(batch, 64, dtype=torch.float32, device="meta",
                                              enc_len=48)
        for shard_seq in (False, True):
            want = jpartition.cache_shardings(cache, ref_mesh(shape), shard_seq=shard_seq)
            got = partition.cache_shardings(cache, port_mesh(shape), shard_seq=shard_seq)
            assert sorted(got) == sorted(want)
            for name, sh in got.items():
                assert norm(sh.spec) == norm(want[name]), (name, batch, shard_seq)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_spec_equals_the_references(shape):
    for seq in (False, True):
        assert norm(partition.batch_spec(port_mesh(shape), seq)) == norm(
            jpartition.batch_spec(ref_mesh(shape), seq))


def test_placements_of_a_spec():
    mesh = port_mesh((2, 2))
    assert partition.placements(("data", None, "model", None), mesh) == (Shard(0), Shard(2))
    assert partition.placements((None, ("data",)), mesh) == (Shard(1), Replicate())
    assert partition.placements(("model",), mesh) == (Replicate(), Shard(0))
    assert partition.placements((), mesh) == (Replicate(), Replicate())
    assert partition.NamedSharding(mesh, ("data", "model")).placements == (Shard(0), Shard(1))


def test_constrain_leaves_a_plain_tensor_as_it_is():
    x = torch.randn(2, 8, 4)
    assert partition.constrain(x, "data", "model", None) is x
    assert partition.sp_boundary(x) is x


# --- multi-rank runs ---------------------------------------------------------------

RANKS_TIMEOUT = 240
# a collective that waits longer raises on its rank (gloo's default is 30 min)
COLLECTIVE_TIMEOUT = RANKS_TIMEOUT - 60

# every rank's first lines: one thread, the group from the FileStore of its run
RANK = textwrap.dedent(f"""
    import datetime, json, sys
    import torch
    import torch.distributed as dist
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    args = sys.argv[4:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds={COLLECTIVE_TIMEOUT}))
""")


def run_ranks(tmp_path, world: int, body: str, *args) -> list[str]:
    """Runs ``world`` ranks of ``RANK + body`` and returns each rank's
    standard output, in rank order. Each rank writes its output to files of
    its own (no two ranks share a pipe, so no line of one rank lands inside
    another's) and runs in a process group of its own; a rank that fails, or
    the deadline, kills every rank's group, so no rank outlives the call."""
    run = tmp_path / f"ranks_{world}_{len(list(tmp_path.iterdir()))}"
    run.mkdir()
    script = RANK + textwrap.dedent(body)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ranks, files = [], []
    deadline = time.monotonic() + RANKS_TIMEOUT
    try:
        for r in range(world):
            out, err = open(run / f"rank{r}.out", "w"), open(run / f"rank{r}.err", "w")
            files += [out, err]
            ranks.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), str(world), str(run / "store"),
                 *map(str, args)], stdin=subprocess.DEVNULL, stdout=out, stderr=err, cwd=ROOT,
                env=env, start_new_session=True))
        while (any(p.poll() is None for p in ranks) and time.monotonic() < deadline
               and not any(p.poll() not in (None, 0) for p in ranks)):
            time.sleep(0.05)
    finally:
        for p in ranks:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        for f in files:
            f.close()
    outs = [(run / f"rank{r}.out").read_text() for r in range(world)]
    failed = [(r, p.returncode) for r, p in enumerate(ranks) if p.returncode]
    assert not failed, (f"ranks (rank, exit code) {failed}, deadline {RANKS_TIMEOUT} s\n"
                        + "".join(f"--- rank {r}\n{outs[r][-2000:]}"
                                  f"{(run / f'rank{r}.err').read_text()[-4000:]}"
                                  for r, _ in failed))
    return outs


# --- a 4-rank (2, 2) mesh: the train step against the unsharded port's -------------

SMOKE = "granite-3-2b-smoke"
STEPS, BATCH, SEQ = 3, 4, 288        # S > 256: attention through K1's autograd Function
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)

# the trainer through a mesh of every rank (model 1), to ``elastic_steps``,
# twice: its parameters initialised in fp32 (under ``elastic_dir``/fp32) and
# in the trainer's bf16 (/bf16), each run printing its result as a line of
# JSON (see test_elastic_resume_across_rank_counts)
ELASTIC = """
import functools
from repro_torch.launch.train import main
from repro_torch.models import LanguageModel

def elastic(tag, fp32):
    init = LanguageModel.init
    if fp32:
        LanguageModel.init = functools.partialmethod(init, dtype=torch.float32)
    try:
        st = main(["--arch", "granite-3-2b-smoke", "--steps", str(elastic_steps),
                   "--global-batch", "4", "--seq-len", "32", "--ckpt-dir", f"{elastic_dir}/{tag}",
                   "--save-every", "5", "--log-every", "100", "--mesh-model", "1",
                   "--device", "cpu"])
    finally:
        LanguageModel.init = init
    if rank == 0:
        print(json.dumps({"run": tag, "step": st.step, "restarts": st.restarts,
                          "losses": st.final_losses}), flush=True)

for tag, fp32 in (("fp32", True), ("bf16", False)):
    elastic(tag, fp32)
"""

# the trainer on every rank to step 4 with a checkpoint every 2, a failure
# injected on every rank right after the save of step 2 while rank 0's write
# of it is still in flight (delayed by a second); each rank prints its result
RESTART = """
import time
from repro_torch.checkpoint import ckpt
from repro_torch.launch.train import make_runner, parse_args

restart = parse_args(["--arch", "granite-3-2b-smoke", "--steps", "4", "--global-batch", "4",
                      "--seq-len", "32", "--ckpt-dir", restart_dir, "--save-every", "2",
                      "--log-every", "100", "--mesh-model", "1", "--device", "cpu"])
if rank == 0:
    write = ckpt._write

    def late_write(*a, **kw):
        time.sleep(1.0)
        return write(*a, **kw)

    ckpt._write = late_write
runner = make_runner(restart, torch.device("cpu"))
save, failed = runner.maybe_save, []

def fail_after_the_save_of_step_2(st, force=False):
    save(st, force)
    if st.step == 2 and not failed:
        failed.append(st.step)
        raise RuntimeError("injected failure after the save of step 2")

runner.maybe_save = fail_after_the_save_of_step_2
st = runner.run(restart.steps)
print(json.dumps({"run": "restart", "rank": rank, "step": st.step, "restarts": st.restarts,
                  "losses": st.final_losses}), flush=True)
"""

DONE = "dist.destroy_process_group()\n"


def runs(stdout: str) -> list[dict]:
    """The JSON lines ``ELASTIC`` and ``RESTART`` print."""
    return [json.loads(line) for line in stdout.splitlines() if line.startswith('{"run"')]


TRAIN_2X2 = """
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    import repro_torch.configs as configs
    from repro_torch.data.pipeline import DataConfig, _batch_at, host_batch_slice
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel
    from repro_torch.sharding.partition import (NamedSharding, batch_spec, device_put,
                                                param_shardings)
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import apply_updates, state_shardings, tree_leaves

    steps, batch, seq = int(args[0]), int(args[1]), int(args[2])
    opt_kw, out_path = json.loads(args[3]), args[4]
    mesh = make_host_mesh(model=2, device="cpu")
    cpu = torch.device("cpu")
    cfg = configs.get("granite-3-2b-smoke")
    result = {}

    def sharded_model(**kw):
        model = LanguageModel(cfg, impl="kernel", **kw)
        model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
        sh = param_shardings(model.axes(), model.specs(), mesh)
        return model.load_params(device_put(model.params, sh)), sh

    def rows(step):
        data = DataConfig(cfg.vocab_size, seq, batch, seed=0)
        mine = host_batch_slice(data, mesh.get_local_rank("data"), mesh.size(0))
        return to_device({k: v[mine] for k, v in _batch_at(data, step, slice(0, batch)).items()},
                         cpu, mesh)

    def full(tree):
        return [t.full_tensor().detach().numpy() for t in tree_leaves(tree)]

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    # 1. steps with 2 microbatches, gradients and accumulator pinned
    model, sh = sharded_model()
    opt_cfg = OptimConfig(**opt_kw)
    opt = device_put(init_opt_state(model.params, opt_cfg), state_shardings(sh, opt_cfg, mesh))
    bsh = NamedSharding(mesh, batch_spec(mesh))
    step = make_train_step(model, opt_cfg, microbatches=2, grad_shardings=sh,
                           batch_shardings={k: bsh for k in ("tokens", "labels", "positions")})
    losses = []
    for i in range(steps):
        _, opt, metrics = step(model.params, opt, rows(i))
        losses.append(float(metrics["loss"]))
    result["losses"] = losses
    result["placements"] = {
        "wq": named(model.params["layers"]["attn"]["wq"].placements),
        "mu_wq": named(opt["mu"]["layers"]["attn"]["wq"].placements),
        "step": named(opt["step"].placements)}
    arrays = {f"param__{i}": a for i, a in enumerate(full(model.params))}

    # 2. one int8_ef step
    ef_model, ef_sh = sharded_model(remat="none")
    ef_opt = device_put(init_opt_state(ef_model.params, opt_cfg, "int8_ef"),
                        {**state_shardings(ef_sh, opt_cfg, mesh), "ef": ef_sh})
    ef_step = make_train_step(ef_model, opt_cfg, grad_compression="int8_ef",
                              grad_shardings=ef_sh)
    _, ef_opt, _ = ef_step(ef_model.params, ef_opt, rows(0))
    arrays.update({f"ef_param__{i}": a for i, a in enumerate(full(ef_model.params))})
    arrays.update({f"ef__{i}": a for i, a in enumerate(full(ef_opt["ef"]))})

    # 3. attention with KV heads that do not divide "model", on a (1, 4) mesh
    wide = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    attn_placements = {}
    for h, kvh in ((4, 2), (12, 3)):
        gen = torch.Generator().manual_seed(h)
        q, k, v, dout = (torch.randn(2, 300, n, 16, generator=gen)
                         for n in (h, kvh, kvh, h))
        dq = distribute_tensor(q, wide, [Replicate(), Shard(2)]).requires_grad_()
        dk, dv = (distribute_tensor(t, wide, [Replicate(), Replicate()]).requires_grad_()
                  for t in (k, v))
        out = ops.flash_attention_op(dq, dk, dv, causal=True)
        out.backward(distribute_tensor(dout, wide, [Replicate(), Shard(2)]))
        attn_placements[f"{h}/{kvh}"] = named(out.placements)
        for name, t in (("out", out), ("dq", dq.grad), ("dk", dk.grad), ("dv", dv.grad)):
            arrays[f"attn{h}_{kvh}__{name}"] = t.full_tensor().detach().numpy()
    result["attention_placements"] = attn_placements

    # 4. what a mesh refuses
    refused = {}
    x = distribute_tensor(torch.randn(2, 64, 4, 16), mesh, [Shard(0), Replicate()])
    small = distribute_tensor(torch.randn(16, 32), mesh, [Replicate(), Replicate()])
    # a cache whose head dim is split: no placement of cache_shardings'
    by_dim = distribute_tensor(torch.randn(2, 64, 4, 16), mesh, [Shard(0), Shard(3)])
    for name, call in (
            ("flash_decode", lambda: ops.flash_decode_op(by_dim[:, 0], by_dim, by_dim, 5)),
            ("ssd_scan", lambda: ops.ssd_scan_op(x, x[..., 0], x[0, 0, :, 0], x[:, :, 0],
                                                 x[:, :, 0])),
            ("fused_ffn", lambda: ops.fused_ffn_op(x[:, 0, 0], small.to_local(),
                                                   small.to_local(), small.to_local().T)),
            ("stochastic_rounding", lambda: apply_updates(
                {"w": x.to(torch.bfloat16)}, {"w": x}, {"step": torch.zeros((), dtype=torch.int32),
                                                        "mu": {"w": x}, "nu": {"w": x}},
                OptimConfig(moment_dtype="bfloat16", master_weights=False,
                            stochastic_rounding=True), rng=torch.Generator()))):
        try:
            call()
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    result["refused"] = refused
    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)

    # 5. then the first segments of the elastic runs, on a (4, 1) mesh
    elastic_steps, elastic_dir = 10, args[5]
"""


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """One 4-rank run on a (2, 2) mesh: its results (a dict) and arrays (by
    name: ``param__i``, ``ef_param__i``, ``ef__i`` in ``tree_leaves`` order,
    ``attn{H}_{KVH}__{out,dq,dk,dv}``), read by the tests below."""
    tmp = tmp_path_factory.mktemp("mesh_2x2")
    out = str(tmp / "out.npz")
    stdout = run_ranks(tmp, 4, textwrap.dedent(TRAIN_2X2) + ELASTIC + DONE, STEPS, BATCH, SEQ,
                       json.dumps(OPT), out, tmp / "elastic")[0]
    with open(out + ".json") as f:
        result = json.load(f)
    result["elastic"] = {"ckpt_dir": tmp / "elastic", "runs": {r["run"]: r for r in runs(stdout)}}
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


def numbered(arrays: dict, prefix: str) -> list:
    return [arrays[f"{prefix}__{i}"] for i in range(len([k for k in arrays
                                                         if k.startswith(prefix + "__")]))]


def global_batch(cfg, step):
    return {k: torch.tensor(v) for k, v in
            _batch_at(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0), step,
                      slice(0, BATCH)).items()}


def unsharded(**kw):
    model = LanguageModel(tconfigs.get(SMOKE), impl="kernel", **kw)
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


def test_sharded_steps_equal_the_unsharded_port_and_the_reference(mesh_2x2):
    """granite-3-2b-smoke in fp32 on a (2, 2) mesh, 2 microbatches, 3 steps:
    losses and parameters within 1e-5 of the port's unsharded step on the
    same global batches; the first loss within 2e-5 of the reference's."""
    result, arrays = mesh_2x2
    params = numbered(arrays, "param")
    model = unsharded()
    jparams = _unflatten({k: jnp.asarray(v.detach().numpy().copy())
                          for k, v in leaves(model.params)})
    opt_cfg = OptimConfig(**OPT)
    opt = init_opt_state(model.params, opt_cfg)
    step = make_train_step(model, opt_cfg, microbatches=2)
    losses = []
    for i in range(STEPS):
        _, opt, metrics = step(model.params, opt, global_batch(model.cfg, i))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(result["losses"], losses, atol=1e-5, rtol=0)
    want = [p.detach().numpy() for p in tree_leaves(model.params)]
    assert len(params) == len(want)
    for got, w in zip(params, want):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=0)
    # the reference's loss at the start: the mean of its two microbatches'
    jm = JaxLM(jconfigs.get(SMOKE), impl="naive")
    batch = {k: v.numpy() for k, v in global_batch(model.cfg, 0).items()}
    ref = np.mean([float(jm.loss(jparams, {k: jnp.asarray(v[i:i + 2]) for k, v in batch.items()}))
                   for i in (0, 2)])
    assert abs(result["losses"][0] - ref) <= 2e-5


def test_parameters_and_state_take_the_references_placements(mesh_2x2):
    """wq (embed, heads) shards embed over "data" and heads over "model";
    its moment the same; the step counter is replicated."""
    placements = mesh_2x2[0]["placements"]
    assert placements["wq"] == placements["mu_wq"] == ["Shard(1)", "Shard(2)"]
    assert placements["step"] == ["Replicate", "Replicate"]


def test_int8_ef_step_on_the_mesh_equals_the_unsharded_one(mesh_2x2):
    """One int8_ef step: the error feedback within 1e-5 but at elements that
    round to a neighbouring int8 level (fewer than 1 in 1000, one level
    apart there); the parameters within 1e-5, or 2 lr where Adam's first
    step divides by a gradient near its eps."""
    ef_params, ef_ef = numbered(mesh_2x2[1], "ef_param"), numbered(mesh_2x2[1], "ef")
    model = unsharded(remat="none")
    opt_cfg = OptimConfig(**OPT)
    step = make_train_step(model, opt_cfg, grad_compression="int8_ef")
    _, opt, metrics = step(model.params, init_opt_state(model.params, opt_cfg, "int8_ef"),
                           global_batch(model.cfg, 0))
    lr, flips, n = float(metrics["lr"]), 0, 0
    for got_p, got_e, p, e, mu in zip(ef_params, ef_ef, tree_leaves(model.params),
                                      tree_leaves(opt["ef"]), tree_leaves(opt["mu"])):
        e, deq = e.numpy(), mu.numpy() / (1 - opt_cfg.b1)
        diff = np.abs(got_e - e)
        flip = diff > 1e-5
        np.testing.assert_allclose(diff[flip], np.abs(deq).max() / 127.0, rtol=2e-2)
        flips, n = flips + int(flip.sum()), n + e.size
        err = np.abs(got_p - p.detach().numpy())
        near_eps = (np.abs(deq) < 100 * opt_cfg.eps) | flip
        assert (err[~near_eps] <= 1e-5).all() and (err[near_eps] <= 2 * lr).all()
    assert flips < 1e-3 * n


@pytest.mark.parametrize("heads", ["4/2", "12/3"])
def test_attention_with_kv_heads_replicated_over_model(mesh_2x2, heads):
    """On a (1, 4) mesh the query heads shard over "model" and the KV heads,
    which do not divide it, stay replicated: each rank reads the KV heads of
    its own query heads (a slice at 4/2; at 12/3 one rank's heads straddle
    two groups, and it reads them expanded). Output and gradients within
    1e-5 of the unsharded op."""
    h, kvh = map(int, heads.split("/"))
    gen = torch.Generator().manual_seed(h)
    q, k, v, dout = (torch.randn(2, 300, n, 16, generator=gen) for n in (h, kvh, kvh, h))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = kops.flash_attention_op(q, k, v, causal=True)
    (out * dout).sum().backward()
    assert mesh_2x2[0]["attention_placements"][heads] == ["Shard(0)", "Shard(2)"]
    for name, want in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
        np.testing.assert_allclose(mesh_2x2[1][f"attn{h}_{kvh}__{name}"], want.detach().numpy(),
                                   atol=1e-5, rtol=0)


# what each refusal names: the ROADMAP item that brings the path, the layout
# the op takes, or the recipe
REFUSAL_REASONS = {"flash_decode": ["cache_shardings"], "ssd_scan": ["item 14c"],
                   "fused_ffn": ["DTensors on one mesh"],
                   "stochastic_rounding": ["master_weights=True"]}


@pytest.mark.parametrize("name", list(REFUSAL_REASONS))
def test_what_a_mesh_refuses_raises_with_its_reason(mesh_2x2, name):
    reason = mesh_2x2[0]["refused"][name]
    assert reason is not None
    assert all(why in reason for why in REFUSAL_REASONS[name]), reason


# --- the trainer through a mesh: a one-rank CLI run, and a reshard on restore -------

def cli_args(arch: str) -> list[str]:
    return ["--arch", arch, "--steps", "1", "--global-batch", "2", "--seq-len", "288",
            "--log-every", "100"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-smoke", "qwen3-moe-235b-a22b-smoke",
                                  "zamba2-1.2b-smoke", "mamba2-1.3b-smoke"])
def test_one_rank_mesh_trains_to_the_bits_of_no_mesh(tmp_path, arch):
    """``launch.train --mesh-model 1`` in a process of its own starts its own
    one-rank group (``make_host_mesh``), trains through the (1, 1) mesh and
    saves from it; the checkpoint equals, leaf for leaf and to the bit, the
    state of the same run without a mesh: the dense family, the MoE family
    with its experts on the mesh, and the hybrid and SSM families with
    their Mamba-2 mixers on each rank's rows."""
    d = tmp_path / "ck"
    args = cli_args(arch)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                          "--mesh-model", "1", "--device", "cpu", "--ckpt-dir", str(d),
                          "--save-every", "100"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done at step 1" in out.stdout
    st = ttrain.main([*args, "--device", "cpu"])
    _, tree, extra = restore(str(d), device="cpu")
    assert extra == {"step": 1}
    want = {"params": st.params, "opt": st.opt_state}
    got_leaves, want_leaves = dict(leaves(tree)), dict(leaves(want))
    assert list(got_leaves) == list(want_leaves)
    for name, g in got_leaves.items():
        w = want_leaves[name].detach()
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.fixture(scope="module")
def two_ranks(mesh_2x2, tmp_path_factory):
    """One 2-rank run: both elastic runs of ``mesh_2x2`` resumed from step 10
    to 15 (the restore reshards onto the smaller mesh), then ``RESTART``.
    Returns each rank's stdout and the restart's checkpoint directory."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    body = ("elastic_steps, elastic_dir = 15, args[0]\n" + ELASTIC
            + "restart_dir = args[1]\n" + RESTART + DONE)
    outs = run_ranks(tmp, 2, body, mesh_2x2[0]["elastic"]["ckpt_dir"], tmp / "restart")
    return outs, tmp / "restart"


def elastic_against_unsharded(mesh_2x2, two_ranks, monkeypatch, tag: str):
    """The elastic run ``tag`` (4 ranks to step 10, then 2 to 15) beside an
    unsharded run of 15 steps on the same global batches (each step's rows
    as the 4, then the 2, ranks' loaders made them), its parameters
    initialised as the run's: ``(losses, checkpoint, unsharded losses,
    unsharded {"params", "opt"})``."""
    first = mesh_2x2[0]["elastic"]["runs"][tag]
    assert (first["step"], first["restarts"]) == (10, 0)
    stdout = two_ranks[0][0]            # rank 0's: it prints the runs' results
    d = mesh_2x2[0]["elastic"]["ckpt_dir"] / tag
    assert f"restored step 10 from {d}" in stdout
    second = [r for r in runs(stdout) if r["run"] == tag]
    assert len(second) == 1 and (second[0]["step"], second[0]["restarts"]) == (15, 0)
    _, tree, extra = restore(str(d), device="cpu")
    assert extra == {"step": 15}

    if tag == "fp32":
        monkeypatch.setattr(LanguageModel, "init",
                            functools.partialmethod(LanguageModel.init, dtype=torch.float32))
    args = ttrain.parse_args(["--arch", SMOKE, "--steps", "15", "--global-batch", "4",
                              "--seq-len", "32", "--device", "cpu"])
    model, cfg, opt, step, _ = ttrain.build(args, torch.device("cpu"))
    data = DataConfig(cfg.vocab_size, 32, 4, seed=0)
    losses = []
    for s in range(15):
        ranks = 4 if s < 10 else 2
        parts = [_batch_at(data, s, host_batch_slice(data, r, ranks)) for r in range(ranks)]
        batch = {k: torch.tensor(np.concatenate([p[k] for p in parts])) for k in parts[0]}
        _, opt, metrics = step(model.params, opt, batch, torch.Generator().manual_seed(s))
        losses.append(float(metrics["loss"]))
    assert int(tree["opt"]["step"]) == int(opt["step"]) == 15
    return (first["losses"] + second[0]["losses"], tree, losses,
            {"params": model.params, "opt": opt})


def test_elastic_resume_across_rank_counts(mesh_2x2, two_ranks, monkeypatch):
    """The counterpart of ``tests/test_sharding.py:109``: train on 4 ranks
    to step 10 with a checkpoint every 5 (the 4-rank run's last part),
    resume the same run on 2 ranks to step 15 (the restore reshards onto
    the smaller mesh). The result is held against an unsharded run of 15
    steps on the same global batches: every parameter and state leaf within
    1e-5. The trainer's parameters are initialised in fp32 on both sides
    here; its own bf16 recipe is held in the test below, at its own bound."""
    got_losses, tree, losses, want = elastic_against_unsharded(mesh_2x2, two_ranks,
                                                               monkeypatch, "fp32")
    np.testing.assert_allclose(got_losses, losses, atol=1e-5, rtol=0)
    for got, w in zip(tree_leaves(tree), tree_leaves(want)):
        assert got.dtype == w.dtype
        np.testing.assert_allclose(got.numpy(), w.detach().numpy(), atol=1e-5, rtol=0)


# the bf16 recipe's bounds (see the test below), each set between the readings
# of sound runs and of a planted fault
BF16_MASTER_ATOL = 4e-4
BF16_LOSS_ATOL = 3e-4


def test_elastic_resume_across_rank_counts_in_bf16(mesh_2x2, two_ranks, monkeypatch):
    """The same 4 -> 2 rank resume with the trainer's own recipe: bf16
    parameters, fp32 master weights and moments. The ranks' bf16 partial
    gradients sum in another order than the whole batch's, so the two runs
    part by more than in fp32: the losses within BF16_LOSS_ATOL, the fp32
    master weights within BF16_MASTER_ATOL, and the bf16 parameters equal
    to the master weights rounded to bf16."""
    got_losses, tree, losses, want = elastic_against_unsharded(mesh_2x2, two_ranks,
                                                               monkeypatch, "bf16")
    master = dict(leaves(tree["opt"]["master"]))
    wmaster = dict(leaves(want["opt"]["master"]))
    loss_err = float(np.max(np.abs(np.array(got_losses) - np.array(losses))))
    master_err = max(float((master[k] - wmaster[k].detach()).abs().max()) for k in master)
    print(f"bf16 4->2 resume: loss {loss_err:.3g} master {master_err:.3g}")
    for name, p in leaves(tree["params"]):
        assert p.dtype == torch.bfloat16 and torch.equal(p, master[name].to(torch.bfloat16)), name
    assert loss_err <= BF16_LOSS_ATOL
    assert master_err <= BF16_MASTER_ATOL


def test_restart_on_two_ranks_restores_one_step_on_every_rank(two_ranks):
    """A failure on every rank right after a save, while rank 0 (the only
    rank that writes) is still writing it: each rank waits for that write
    and restores the step rank 0 reads, step 2, and both finish at step 4
    after one restart with the same losses."""
    outs, d = two_ranks
    restored = [line for out in outs for line in out.splitlines()
                if "restored step" in line and str(d) in line]
    assert restored == [f"[train] restored step 2 from {d}"] * 2, [o[-3000:] for o in outs]
    results = [r for out in outs for r in runs(out) if r["run"] == "restart"]
    assert sorted(r["rank"] for r in results) == [0, 1]
    for r in results:
        assert (r["step"], r["restarts"], len(r["losses"])) == (4, 1, 2)
    assert results[0]["losses"] == results[1]["losses"]
    assert restore(str(d), device="cpu")[2] == {"step": 4}
