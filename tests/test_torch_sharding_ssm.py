"""The Mamba-2 (``ssm``) and Zamba-2 (``hybrid``) families through a device
mesh, and GQA and MLA on a mesh whose "model" size their heads do not
divide, held against the port's unsharded step, the unsharded op and the
reference.

Under a mesh the Mamba-2 mixer runs on each rank's batch rows with all of
its weights replicated (``models.ssm``), which keep the reference's
placements in storage; the blocks are sequence-parallel around the mixer
and the shared block. One 4-rank ``gloo`` launch
(``test_torch_sharding.run_ranks``) builds a (2, 2) and then a (1, 4) mesh
over the same ranks and computes everything the tests below read; each
test process holds its own side against it."""
import dataclasses
import inspect
import json
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.base import abstract_params
from repro.sharding import partition as jpartition
import repro_torch.configs as tconfigs
from repro_torch.checkpoint.ckpt import _unflatten
from repro_torch.data.pipeline import DataConfig, _batch_at
from repro_torch.models import LanguageModel
from repro_torch.models.attention import gqa_attention, gqa_specs
from repro_torch.models.base import init_params
from repro_torch.sharding import partition
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves
from test_torch_sharding import leaves, norm, port_mesh, ref_mesh, run_ranks

ARCHS = ["zamba2-1.2b-smoke", "mamba2-1.3b-smoke"]
MESHES = [(2, 2), (1, 4)]
# S > 256: the shared block's attention through K1's autograd Function;
# the smoke configs scan in chunks of 32
SEQ = 288
STEPS, BATCH = 3, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
# the fault's case: granite-3-2b-smoke's 2 KV heads on 4 "model" ranks
GQA_ARCH, GQA_BATCH = "granite-3-2b-smoke", 2
# the query heads' case: 6 heads on 4 "model" ranks, whose 6 x 16 (GQA) and
# 6 x (16 + 8) (MLA's q) columns shard over "model" where the heads cannot
QUERY_HEADS = {"gqa": ("granite-3-2b-smoke", {"n_heads": 6}),
               "mla": ("deepseek-v2-236b-smoke", {"n_heads": 6, "n_kv_heads": 6})}
# held in float64: in fp32 the unsharded op's own rounding (2.7e-5 on MLA's
# dwkv_a against float64) is larger than the 1e-5 the mesh is held to
QUERY_HEADS_DTYPE = torch.float64
# what the ranks' script takes from this module (besides the helpers below)
SHARED = ("ARCHS", "MESHES", "SEQ", "STEPS", "BATCH", "OPT", "GQA_ARCH", "GQA_BATCH",
          "QUERY_HEADS", "QUERY_HEADS_DTYPE")


def global_batch(cfg, step: int) -> dict:
    """The data pipeline's global batch of ``step`` (NumPy)."""
    return _batch_at(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0), step, slice(0, BATCH))


def gqa_inputs(cfg):
    """The fault case's inputs: seeded fp32 attention weights, x (B,S,d),
    positions and the output's cotangent."""
    return attention_inputs(cfg, gqa_specs(cfg))


def attention_inputs(cfg, specs, dtype=torch.float32):
    """Seeded weights of ``specs``, x (B,S,d), positions and the output's
    cotangent, in ``dtype``."""
    params = init_params(specs, torch.Generator().manual_seed(3), dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(GQA_BATCH, SEQ, cfg.d_model, generator=gen, dtype=dtype)
    dout = torch.randn(GQA_BATCH, SEQ, cfg.d_model, generator=gen, dtype=dtype)
    positions = torch.arange(SEQ, dtype=torch.int32).expand(GQA_BATCH, SEQ)
    return params, x, positions, dout


def query_heads_case(kind):
    """A ``QUERY_HEADS`` case: its config, attention op and specs."""
    import repro_torch.configs as configs
    from repro_torch.models import attention

    arch, changes = QUERY_HEADS[kind]
    cfg = dataclasses.replace(configs.get(arch), **changes)
    if kind == "mla":
        return cfg, attention.mla_attention, attention.mla_specs(cfg)
    return cfg, attention.gqa_attention, attention.gqa_specs(cfg)


# every rank: the default group's 4 ranks as a (2, 2), then a (1, 4) mesh;
# on each, both configs in fp32 for STEPS steps; then on (1, 4) the
# granite attention whose 2 KV heads do not divide "model", and the GQA and
# MLA attentions whose 6 query heads do not
SSM_MESHES = """
    import dataclasses
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    import repro_torch.configs as configs
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel
    from repro_torch.models.attention import gqa_attention, gqa_specs
    from repro_torch.models.base import axes_tree, init_params
    from repro_torch.sharding.partition import device_put, param_shardings
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import state_shardings, tree_leaves

    out_path = args[0]
    cpu = torch.device("cpu")
    result, arrays = {}, {}

    def full(tree):
        return [t.full_tensor().detach().numpy() for t in tree_leaves(tree)]

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    for shape in MESHES:
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("data", "model"))
        data_rank, data_size = mesh.get_local_rank("data"), mesh.size(0)

        def mine(batch):
            # this rank's rows of a global batch, as DTensors
            n = len(batch["tokens"]) // data_size
            return to_device({k: v[data_rank * n:(data_rank + 1) * n]
                              for k, v in batch.items()}, cpu, mesh)

        for arch in ARCHS:
            cfg, tag = configs.get(arch), f"{shape[0]}x{shape[1]}/{arch}"
            model = LanguageModel(cfg, impl="kernel", remat="full", scan="naive")
            model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
            sh = param_shardings(model.axes(), model.specs(), mesh)
            model.load_params(device_put(model.params, sh))
            opt_cfg = OptimConfig(**OPT)
            opt = device_put(init_opt_state(model.params, opt_cfg),
                             state_shardings(sh, opt_cfg, mesh))
            step = make_train_step(model, opt_cfg, grad_shardings=sh)
            losses = []
            for i in range(STEPS):
                _, opt, metrics = step(model.params, opt, mine(global_batch(cfg, i)))
                losses.append(float(metrics["loss"]))
            mixer = model.params["layers"]["mixer"]
            result[tag] = {
                "losses": losses,
                "placements": {name: named(mixer[name].placements) for name in mixer},
                "mu_placements": {name: named(leaf.placements) for name, leaf in
                                  opt["mu"]["layers"]["mixer"].items()}}
            arrays.update({f"{tag}/param__{i}": a for i, a in enumerate(full(model.params))})

    def sharded_attention(tag, cfg, op, specs, dtype=torch.float32, dout_layout=None):
        # forward and backward of op on the mesh in the reference's
        # placements, its output and gradients under "{tag}/"; the output's
        # cotangent in the output's placements, or in dout_layout
        params, x, positions, dout = attention_inputs(cfg, specs, dtype)
        params = {k: v.requires_grad_() for k, v in
                  device_put(params, param_shardings(axes_tree(specs), specs, mesh)).items()}
        dx = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()
        out = op(params, cfg, dx, positions, impl="kernel")
        out.backward(distribute_tensor(dout, mesh, dout_layout or out.placements))
        arrays[f"{tag}/out"] = out.full_tensor().detach().numpy()
        arrays[f"{tag}/dx"] = dx.grad.full_tensor().numpy()
        arrays.update({f"{tag}/d{name}": p.grad.full_tensor().numpy()
                       for name, p in params.items()})
        return {name: named(p.placements) for name, p in params.items()}

    # the fault's case on the last mesh, (1, 4): KVH * D shards over "model"
    # where KVH does not
    cfg = configs.get(GQA_ARCH)
    result["gqa_wk"] = sharded_attention("gqa", cfg, gqa_attention, gqa_specs(cfg))["wk"]
    # and the query heads' cases: H * D over "model" where H is not
    for kind in QUERY_HEADS:
        result[f"heads6_{kind}"] = sharded_attention(f"heads6_{kind}", *query_heads_case(kind),
                                                     QUERY_HEADS_DTYPE)
        # the cotangent "model"-replicated, as a loss hands it back
        sharded_attention(f"heads6r_{kind}", *query_heads_case(kind), QUERY_HEADS_DTYPE,
                          dout_layout=[Shard(0), Replicate()])
    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's unsharded side on one thread, as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ssm_meshes(tmp_path_factory):
    """The 4-rank run's results (a dict by ``{D}x{M}/{arch}``, ``gqa_wk``
    and ``heads6_{gqa,mla}``: each weight's placements) and arrays
    (``{D}x{M}/{arch}/param__i`` in ``tree_leaves`` order,
    ``gqa/{out,dx,dwq,dwk,dwv,dwo}``, ``heads6_{gqa,mla}/{out,dx,d<weight>}``)."""
    tmp = tmp_path_factory.mktemp("ssm_meshes")
    out = str(tmp / "out.npz")
    shared = "".join(f"{name} = {globals()[name]!r}\n" for name in SHARED)
    helpers = "".join(inspect.getsource(fn) for fn in (global_batch, gqa_inputs,
                                                       attention_inputs, query_heads_case))
    run_ranks(tmp, 4, shared + helpers + textwrap.dedent(SSM_MESHES), out)
    with open(out + ".json") as f:
        result = json.load(f)
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


def tag(shape, arch) -> str:
    return f"{shape[0]}x{shape[1]}/{arch}"


def unsharded(arch):
    model = LanguageModel(tconfigs.get(arch), impl="kernel", remat="full", scan="naive")
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def unsharded_runs():
    """Each config's STEPS unsharded steps on the same global batches:
    ``{arch: (losses, parameters after the last step, near_eps, moves)}``.
    ``near_eps`` marks, leaf by leaf, the elements whose clipped gradient
    g' fell below 100 Adam eps at some step (read off the first moment:
    g'_t = (mu_t - b1 mu_{t-1}) / (1 - b1)); ``moves`` is 2 lr summed over
    the steps."""
    runs = {}
    for arch in ARCHS:
        model = unsharded(arch)
        opt_cfg = OptimConfig(**OPT)
        opt = init_opt_state(model.params, opt_cfg)
        step = make_train_step(model, opt_cfg)
        losses, lrs = [], []
        mu = [torch.zeros_like(m) for m in tree_leaves(opt["mu"])]
        near_eps = [np.zeros(m.shape, bool) for m in mu]
        for i in range(STEPS):
            batch = {k: torch.tensor(v) for k, v in global_batch(model.cfg, i).items()}
            _, opt, metrics = step(model.params, opt, batch)
            losses.append(float(metrics["loss"]))
            lrs.append(float(metrics["lr"]))
            now = [m.clone() for m in tree_leaves(opt["mu"])]
            for ne, m0, m1 in zip(near_eps, mu, now):
                ne |= (np.abs((m1 - opt_cfg.b1 * m0).numpy() / (1 - opt_cfg.b1))
                       < 100 * opt_cfg.eps)
            mu = now
        runs[arch] = (losses, [p.detach().numpy() for p in tree_leaves(model.params)],
                      near_eps, 2 * sum(lrs))
    return runs


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_steps_on_the_mesh_equal_the_unsharded_port(ssm_meshes, unsharded_runs, arch,
                                                        shape):
    """STEPS steps on the mesh in fp32: losses and every parameter within
    1e-5 of the port's unsharded step on the same global batches. On (1, 4)
    ``in_proj``'s 296 columns shard 74 a rank, across its [z | x | B | C |
    dt] slices. A step moves an element by lr * m / (sqrt(v) + eps): where
    the clipped gradient is near eps (1e-8), the summation-order difference
    of the mesh's reductions (a few 1e-9 there) changes that ratio, so those
    elements (``near_eps``) are held to the sum of 2 lr over the steps
    instead, as ``tests/test_torch_mla_train.py`` holds them; fewer than 1
    in 1000 parameters may differ by more than 1e-5."""
    result, arrays = ssm_meshes
    losses, params, near_eps, moves = unsharded_runs[arch]
    np.testing.assert_allclose(result[tag(shape, arch)]["losses"], losses, atol=1e-5, rtol=0)
    got = [arrays[f"{tag(shape, arch)}/param__{i}"] for i in range(len(params))]
    assert f"{tag(shape, arch)}/param__{len(params)}" not in arrays
    beyond = 0
    for g, w, ne in zip(got, params, near_eps):
        err = np.abs(g - w)
        assert (err[~ne] <= 1e-5).all(), float(err[~ne].max())
        assert (err[ne] <= moves).all()
        beyond += int((err > 1e-5).sum())
    n = sum(w.size for w in params)
    print(f"{tag(shape, arch)}: {beyond} of {n} parameters beyond 1e-5")
    assert beyond < 1e-3 * n


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_first_loss_on_the_mesh_equals_the_references(ssm_meshes, arch, shape):
    """The first loss on the mesh within 2e-5 of the reference's
    ``LanguageModel(impl="naive").loss`` on the same parameters and batch."""
    model = unsharded(arch)
    jparams = _unflatten({k: jnp.asarray(v.detach().numpy().copy())
                          for k, v in leaves(model.params)})
    jm = JaxLM(jconfigs.get(arch), impl="naive")
    ref = float(jm.loss(jparams, {k: jnp.asarray(v)
                                  for k, v in global_batch(model.cfg, 0).items()}))
    assert abs(ssm_meshes[0][tag(shape, arch)]["losses"][0] - ref) <= 2e-5


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_leaves_keep_the_references_placements(ssm_meshes, monkeypatch, arch, shape):
    """After the steps every Mamba-2 mixer leaf and its first moment are
    stored in the placements of the reference's spec for it ("ff" over
    "model", "embed" over "data", heads over "model"): the mixer gathers
    them for its compute only. On (1, 4) at least ``in_proj`` is split over
    "model"."""
    monkeypatch.setattr(jpartition, "NamedSharding", lambda mesh, spec: spec)
    jm = JaxLM(jconfigs.get(arch))
    specs = jpartition.param_shardings(jm.axes(), abstract_params(jm.specs()), ref_mesh(shape))
    want = {name: [f"Shard({p.dim})" if p.is_shard() else type(p).__name__
                   for p in partition.placements(norm(spec), port_mesh(shape))]
            for name, spec in specs["layers"]["mixer"].items()}
    one = ssm_meshes[0][tag(shape, arch)]
    assert one["placements"] == one["mu_placements"] == want
    if shape == (1, 4):
        assert want["in_proj"][1] == "Shard(2)"      # (layers, embed, ff): ff over "model"


def test_gqa_with_kv_heads_that_do_not_divide_model(ssm_meshes):
    """granite-3-2b-smoke's attention (4 heads, 2 KV heads of 16) on a
    (1, 4) mesh in the reference's placements: wk's 32 columns shard over
    "model" where its 2 KV heads cannot, and the forward and backward run,
    output and every gradient within 1e-5 of the unsharded op."""
    result, arrays = ssm_meshes
    assert result["gqa_wk"] == ["Shard(0)", "Shard(1)"]
    cfg = tconfigs.get(GQA_ARCH)
    params, x, positions, dout = gqa_inputs(cfg)
    for p in (*params.values(), x):
        p.requires_grad_()
    out = gqa_attention(params, cfg, x, positions, impl="kernel")
    out.backward(dout)
    want = {"out": out, "dx": x.grad, **{f"d{k}": p.grad for k, p in params.items()}}
    for name, w in want.items():
        np.testing.assert_allclose(arrays[f"gqa/{name}"], w.detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", sorted(QUERY_HEADS))
def test_query_heads_that_do_not_divide_model(ssm_meshes, kind):
    """GQA (granite-3-2b-smoke at 6 heads, 2 KV heads) and MLA
    (deepseek-v2-236b-smoke at 6 heads) on a (1, 4) mesh in the reference's
    placements: the query projection's 6 x 16 (GQA) or 6 x 24 (MLA's
    ``wq_b``) columns and MLA's ``wk_b``/``wv_b`` shard over "model" where
    the 6 heads cannot, and the forward and backward run, output and every
    gradient within 1e-5 of the unsharded op (``QUERY_HEADS_DTYPE``)."""
    result, arrays = ssm_meshes
    cfg, op, specs = query_heads_case(kind)
    split = {"gqa": ("wq",), "mla": ("wq_b", "wk_b", "wv_b")}[kind]
    for name in split:        # over "model", the mesh's second dim
        assert result[f"heads6_{kind}"][name][1] == "Shard(1)", name
    params, x, positions, dout = attention_inputs(cfg, specs, QUERY_HEADS_DTYPE)
    for p in (*params.values(), x):
        p.requires_grad_()
    out = op(params, cfg, x, positions, impl="kernel")
    out.backward(dout)
    want = {"out": out, "dx": x.grad, **{f"d{k}": p.grad for k, p in params.items()}}
    assert sorted(f"heads6_{kind}/{name}" for name in want) == sorted(
        k for k in arrays if k.startswith(f"heads6_{kind}/"))
    for name, w in want.items():
        np.testing.assert_allclose(arrays[f"heads6_{kind}/{name}"], w.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", sorted(QUERY_HEADS))
def test_query_heads_with_a_replicated_cotangent(ssm_meshes, kind):
    """The cases of ``test_query_heads_that_do_not_divide_model`` with the
    output's cotangent "model"-replicated, as a loss hands it back (and as
    the dry-run's 16 x 16 training cells do): the output projection's
    backward then gives the flattened heads' gradient over "model", which
    the attention output's flatten must take back whole
    (``attention.merge_heads``; it raised ``Cannot unflatten unevenly
    sharded tensor`` before). Every gradient within 1e-5 of the unsharded
    op."""
    _, arrays = ssm_meshes
    cfg, op, specs = query_heads_case(kind)
    params, x, positions, dout = attention_inputs(cfg, specs, QUERY_HEADS_DTYPE)
    for p in (*params.values(), x):
        p.requires_grad_()
    out = op(params, cfg, x, positions, impl="kernel")
    out.backward(dout)
    want = {"out": out, "dx": x.grad, **{f"d{k}": p.grad for k, p in params.items()}}
    assert sorted(f"heads6r_{kind}/{name}" for name in want) == sorted(
        k for k in arrays if k.startswith(f"heads6r_{kind}/"))
    for name, w in want.items():
        np.testing.assert_allclose(arrays[f"heads6r_{kind}/{name}"], w.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
