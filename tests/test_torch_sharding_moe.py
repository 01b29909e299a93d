"""The MoE family through a device mesh: ``models.moe``'s routed experts in
the reference's placements (experts over "model", capacity over "data"),
the MoE blocks sequence-parallel, MLA's attention on local shards, and
``launch.train --mesh-model`` on the family, held against the port's
unsharded step and the reference.

One 4-rank (2, 2) ``gloo`` launch (``test_torch_sharding.run_ranks``)
computes everything the tests below read; each test process holds its own
side (the unsharded port, the reference) against it."""
import dataclasses
import functools
import inspect
import json
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import LanguageModel as JaxLM
import repro_torch.configs as tconfigs
from repro_torch.checkpoint.ckpt import _unflatten
from repro_torch.data.pipeline import DataConfig, _batch_at, host_batch_slice
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves
from test_torch_sharding import leaves, run_ranks

ARCHS = ["qwen3-moe-235b-a22b-smoke", "deepseek-v2-236b-smoke"]
# S > 256: attention through K1's autograd Function (MLA's at head dims 24/16)
SEQ = {"qwen3-moe-235b-a22b-smoke": 288, "deepseek-v2-236b-smoke": 320}
STEPS, BATCH, MICRO = 3, 4, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
# the batches take 32 of the 256 token ids, so that the router sends more
# tokens to some experts than their capacity holds (at the configs' own
# capacity_factor 1.25): the full vocabulary drops none of qwen3-moe's
SKEW_IDS = 32
TRAINER_STEPS, TRAINER_SEQ = 2, 320
# what the ranks' script takes from this module (besides ``skewed_batch``)
SHARED = ("ARCHS", "SEQ", "STEPS", "BATCH", "MICRO", "OPT", "SKEW_IDS", "TRAINER_STEPS",
          "TRAINER_SEQ")


def skewed_batch(cfg, step: int, seq: int) -> dict:
    """The global batch of ``step``: (BATCH, seq) tokens of ids below
    SKEW_IDS and their next tokens as labels, from a seeded generator."""
    rng = np.random.default_rng([cfg.vocab_size, seq, step])
    ids = rng.integers(0, SKEW_IDS, (BATCH, seq + 1)).astype(np.int32)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


# every rank: both configs trained on the (2, 2) mesh in fp32 (3 steps, 2
# microbatches, the assignments dropped counted), the first loss of each
# without drops, the reference's sharded-MoE test (qwen3-moe, 4 steps), and
# the trainer (deepseek-v2) through --mesh-model 2
MOE_2X2 = """
    import dataclasses, functools
    import numpy as np
    import repro_torch.configs as configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import main, to_device
    from repro_torch.models import LanguageModel, moe
    from repro_torch.sharding.partition import (NamedSharding, batch_spec, device_put,
                                                param_shardings)
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import state_shardings, tree_leaves

    out_path = args[0]
    mesh = make_host_mesh(model=2, device="cpu")
    cpu = torch.device("cpu")
    bsh = {k: NamedSharding(mesh, (None, *batch_spec(mesh))) for k in ("tokens", "labels")}
    data_rank, data_size = mesh.get_local_rank("data"), mesh.size(0)
    result, arrays = {}, {}

    def sharded_model(cfg, dtype=torch.float32):
        model = LanguageModel(cfg, impl="kernel", remat="full")
        model.init(torch.Generator().manual_seed(0), dtype=dtype, device="cpu")
        sh = param_shardings(model.axes(), model.specs(), mesh)
        return model.load_params(device_put(model.params, sh)), sh

    def mine(batch):
        # this rank's rows of a global batch, as DTensors
        n = len(batch["tokens"]) // data_size
        return to_device({k: v[data_rank * n:(data_rank + 1) * n] for k, v in batch.items()},
                         cpu, mesh)

    def full(tree):
        return [t.full_tensor().detach().numpy() for t in tree_leaves(tree)]

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    # the assignments every pack drops (each rank packs all tokens)
    packed = []
    pack = moe._pack

    def counted_pack(experts, cap, cfg):
        grid_tok, cell_of = pack(experts, cap, cfg)
        packed.append((int((cell_of == cfg.n_experts * cap).sum()), cell_of.numel()))
        return grid_tok, cell_of

    moe._pack = counted_pack
    for arch in ARCHS:
        cfg, seq = configs.get(arch), SEQ[arch]
        one = {}
        # 1. the first loss without drops (capacity_factor = n_experts / top_k):
        # the mean of the two microbatches' losses, as the first step takes it
        model, sh = sharded_model(dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k))
        parts = {k: v.reshape(MICRO, -1, seq) for k, v in skewed_batch(cfg, 0, seq).items()}
        with torch.no_grad():
            one["nodrop_first_loss"] = float(np.mean([
                float(model.loss(mine({k: v[i] for k, v in parts.items()})).full_tensor())
                for i in range(MICRO)]))
        # 2. STEPS steps at the config's own capacity, 2 microbatches
        packed.clear()
        model, sh = sharded_model(cfg)
        opt_cfg = OptimConfig(**OPT)
        opt = device_put(init_opt_state(model.params, opt_cfg),
                         state_shardings(sh, opt_cfg, mesh))
        step = make_train_step(model, opt_cfg, microbatches=MICRO, grad_shardings=sh,
                               batch_shardings=bsh)
        losses = []
        for i in range(STEPS):
            _, opt, metrics = step(model.params, opt, mine(skewed_batch(cfg, i, seq)))
            losses.append(float(metrics["loss"]))
        one["losses"] = losses
        one["dropped"] = [sum(d for d, _ in packed), sum(n for _, n in packed)]
        experts = model.params["layers"]["moe"]
        one["placements"] = {name: named(experts[name].placements)
                             for name in ("w_gate", "w_up", "w_down", "router")}
        one["placements"]["mu_w_gate"] = named(opt["mu"]["layers"]["moe"]["w_gate"].placements)
        arrays.update({f"{arch}/param__{i}": a for i, a in enumerate(full(model.params))})
        arrays.update({f"{arch}/opt__{i}": a for i, a in enumerate(full(opt))})
        result[arch] = one
    moe._pack = pack

    # 3. the reference's tests/test_sharding.py:81 on (2, 2): qwen3-moe smoke
    # in its own init dtype, lr 1e-3, 2 microbatches, 4 steps on one batch of
    # 8 x 32 random tokens that are their own labels
    cfg = configs.get("qwen3-moe-235b-a22b-smoke")
    model = LanguageModel(cfg)
    model.init(torch.Generator().manual_seed(0), device="cpu")
    sh = param_shardings(model.axes(), model.specs(), mesh)
    model.load_params(device_put(model.params, sh))
    opt_cfg = OptimConfig(lr=1e-3)
    opt = device_put(init_opt_state(model.params, opt_cfg), state_shardings(sh, opt_cfg, mesh))
    step = make_train_step(model, opt_cfg, microbatches=2, grad_shardings=sh)
    tokens = torch.randint(0, cfg.vocab_size, (8, 32), generator=torch.Generator().manual_seed(1))
    batch = mine({"tokens": tokens.numpy(), "labels": tokens.numpy()})
    reference_losses = []
    for i in range(4):
        _, opt, metrics = step(model.params, opt, batch, torch.Generator().manual_seed(i))
        reference_losses.append(float(metrics["loss"]))
    result["reference_test"] = {"losses": reference_losses,
                                "w_gate": named(model.params["layers"]["moe"]["w_gate"].placements)}

    # 4. the trainer through --mesh-model 2, its parameters initialised in fp32
    init = LanguageModel.init
    LanguageModel.init = functools.partialmethod(init, dtype=torch.float32)
    try:
        st = main(["--arch", "deepseek-v2-236b-smoke", "--steps", str(TRAINER_STEPS),
                   "--global-batch", str(BATCH), "--seq-len", str(TRAINER_SEQ),
                   "--log-every", "100", "--mesh-model", "2", "--device", "cpu"])
    finally:
        LanguageModel.init = init
    result["trainer"] = {"step": st.step, "losses": st.final_losses}
    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's unsharded side on one thread, as each rank runs: under
    the suite's load, a smoke model's small ops on many threads spend their
    time waiting for one another at each op's barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def moe_2x2(tmp_path_factory):
    """The 4-rank (2, 2) run's results (a dict by arch, ``reference_test``,
    ``trainer``) and arrays (``{arch}/param__i``, ``{arch}/opt__i`` in
    ``tree_leaves`` order)."""
    tmp = tmp_path_factory.mktemp("moe_2x2")
    out = str(tmp / "out.npz")
    shared = "".join(f"{name} = {globals()[name]!r}\n" for name in SHARED)
    run_ranks(tmp, 4, shared + inspect.getsource(skewed_batch) + textwrap.dedent(MOE_2X2), out)
    with open(out + ".json") as f:
        result = json.load(f)
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


def numbered(arrays: dict, prefix: str) -> list:
    return [arrays[f"{prefix}__{i}"]
            for i in range(len([k for k in arrays if k.startswith(prefix + "__")]))]


def unsharded(cfg, **kw):
    model = LanguageModel(cfg, impl="kernel", remat="full", **kw)
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


def tensors(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_steps_on_the_mesh_equal_the_unsharded_port(moe_2x2, arch):
    """3 steps on the (2, 2) mesh in fp32 with 2 microbatches, at the
    config's own capacity_factor and with assignments dropped: losses,
    parameters and optimizer state within 1e-5 of the port's unsharded step
    on the same global batches. Every rank packs all tokens of a microbatch
    against its one capacity, so the same assignments drop as on one
    device; a rank that packed only its own rows would drop others."""
    result, arrays = moe_2x2
    one = result[arch]
    dropped, total = one["dropped"]
    assert 0 < dropped < total
    cfg = tconfigs.get(arch)
    model = unsharded(cfg)
    opt_cfg = OptimConfig(**OPT)
    opt = init_opt_state(model.params, opt_cfg)
    step = make_train_step(model, opt_cfg, microbatches=MICRO)
    losses = []
    for i in range(STEPS):
        _, opt, metrics = step(model.params, opt, tensors(skewed_batch(cfg, i, SEQ[arch])))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(one["losses"], losses, atol=1e-5, rtol=0)
    for prefix, tree in (("param", model.params), ("opt", opt)):
        got, want = numbered(arrays, f"{arch}/{prefix}"), tree_leaves(tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w.detach().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_loss_on_the_mesh_equals_the_references(moe_2x2, arch):
    """The first loss on the (2, 2) mesh, the mean of its two microbatches',
    within 1e-5 of the reference's on the same parameters. Here both sides
    take capacity_factor = n_experts / top_k, which drops nothing: the two
    route in different libraries, and a near tie could send a token to
    another expert on each and so drop different tokens."""
    cfg = tconfigs.get(arch)
    model = unsharded(cfg)
    jparams = _unflatten({k: jnp.asarray(v.detach().numpy().copy())
                          for k, v in leaves(model.params)})
    jm = JaxLM(dataclasses.replace(jconfigs.get(arch), capacity_factor=cfg.n_experts / cfg.top_k),
               impl="naive")
    batch = skewed_batch(cfg, 0, SEQ[arch])
    ref = np.mean([float(jm.loss(jparams, {k: jnp.asarray(v.reshape(MICRO, -1, SEQ[arch])[i])
                                           for k, v in batch.items()}))
                   for i in range(MICRO)])
    assert abs(moe_2x2[0][arch]["nodrop_first_loss"] - ref) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_shard_over_model(moe_2x2, arch):
    """The expert weights (experts, embed, ff) and (experts, ff, embed) and
    their moments shard experts over "model" and embed over "data"; the
    router (embed, experts) too, as the reference's rules place them."""
    placed = moe_2x2[0][arch]["placements"]
    for name in ("w_gate", "w_up", "mu_w_gate"):
        assert placed[name] == ["Shard(2)", "Shard(1)"], (name, placed[name])
    assert placed["w_down"] == ["Shard(3)", "Shard(1)"]
    assert placed["router"] == ["Shard(1)", "Shard(2)"]


def test_reference_moe_training_on_the_mesh(moe_2x2):
    """The port of ``tests/test_sharding.py:81``: qwen3-moe smoke on a (2, 2)
    mesh (the reference takes 8 devices, data 4 x model 2; the CPU runs
    here take at most 4 ranks), 2 microbatches, 4 steps: the losses are
    finite and sane, the last below the first plus 0.5, and the expert
    weights sharded over "model"."""
    ref = moe_2x2[0]["reference_test"]
    losses = ref["losses"]
    assert len(losses) == 4 and all(np.isfinite(x) and x < 30 for x in losses)
    assert losses[-1] < losses[0] + 0.5
    assert ref["w_gate"][1] == "Shard(1)"      # (layers, experts, embed, ff): experts


def test_trainer_trains_mla_moe_through_the_mesh(moe_2x2, monkeypatch):
    """``launch.train --mesh-model 2`` on 4 ranks trains deepseek-v2 smoke
    (its dense layer and three MLA-MoE layers) to its last step; its losses
    within 1e-5 of an unsharded run of ``train.build``'s step on the same
    global batches (each data coordinate's pipeline rows), both initialised
    in fp32."""
    trainer = moe_2x2[0]["trainer"]
    assert trainer["step"] == TRAINER_STEPS
    monkeypatch.setattr(LanguageModel, "init",
                        functools.partialmethod(LanguageModel.init, dtype=torch.float32))
    args = ttrain.parse_args(["--arch", "deepseek-v2-236b-smoke", "--steps", str(TRAINER_STEPS),
                              "--global-batch", str(BATCH), "--seq-len", str(TRAINER_SEQ),
                              "--device", "cpu"])
    model, cfg, opt, step, _ = ttrain.build(args, torch.device("cpu"))
    data = DataConfig(cfg.vocab_size, TRAINER_SEQ, BATCH, seed=0)
    losses = []
    for s in range(TRAINER_STEPS):
        parts = [_batch_at(data, s, host_batch_slice(data, r, 2)) for r in range(2)]
        batch = {k: torch.tensor(np.concatenate([p[k] for p in parts])) for k in parts[0]}
        _, opt, metrics = step(model.params, opt, batch, torch.Generator().manual_seed(s))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(trainer["losses"], losses, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,why", [("whisper-base-smoke", "no 'frames'")])
def test_mesh_model_refuses_the_other_families(arch, why):
    """``--mesh-model`` refuses the encoder-decoder, whose batch the data
    pipeline cannot make, with that reason, before any process group is
    started; it takes every other family (the ssm and hybrid families in
    ``tests/test_torch_sharding_ssm.py``)."""
    args = ttrain.parse_args(["--arch", arch, "--steps", "1", "--mesh-model", "1",
                              "--device", "cpu"])
    with pytest.raises(SystemExit, match=why):
        ttrain.make_runner(args, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
