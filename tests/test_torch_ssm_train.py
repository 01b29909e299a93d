"""Mamba-2 / hybrid training: ``LanguageModel``'s ``scan`` picks the SSD scan
apart from attention's ``impl``, so the port trains the ``ssm``
(mamba2-1.3b) and ``hybrid`` (zamba2-1.2b) families with K1/K2 attention
beside the naive chunked scan, as the reference trains through its jnp scan
(K5 has no backward): one ``make_train_step`` past the S <= 256 shortcut
against the reference's jitted step, the shared block's calls through the
autograd Function, the refusal of a gradient through K5, and the training
entry point on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import LanguageModel as JaxLM
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves

SMOKES = ["mamba2-1.3b-smoke", "zamba2-1.2b-smoke"]


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def reference_and_port(name, seed=0, **port_kw):
    """The reference model with fp32 parameters from its own init (A_log, D
    and dt_bias moved off their constant init so that they matter, as
    ``tests/test_torch_hybrid.py`` does), and the port holding the same
    parameters through the converter."""
    jm = JaxLM(jconfigs.get(name), impl="chunked")
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    mixer = jparams["layers"]["mixer"]
    for k in ("A_log", "D", "dt_bias"):
        mixer[k] = mixer[k] + jnp.asarray(rng.standard_normal(mixer[k].shape, np.float32) * 0.3)
    tm = LanguageModel(tconfigs.get(name), **port_kw)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def batch(seed, b, s):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def rel_norm(got, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class CountingFn:
    """Records the q shape of every ``FlashAttentionFn`` call while open."""

    def __enter__(self):
        self.calls, self.apply = [], ops.FlashAttentionFn.apply

        def counting(*args):
            self.calls.append(tuple(args[0].shape))
            return self.apply(*args)

        ops.FlashAttentionFn.apply = counting
        return self

    def __exit__(self, *exc):
        ops.FlashAttentionFn.apply = self.apply


def shared_calls(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0


@pytest.mark.parametrize("name", SMOKES)
def test_one_train_step_equals_reference(name):
    """One step of make_train_step at S=512 (past ``sdpa``'s shortcut), fp32,
    the port with impl="kernel", scan="naive" against the reference's jitted
    step on the same batch: the loss, the gradient norm and every gradient
    leaf within 1e-5, and every parameter after the update within 1e-5
    wherever Adam's first step is well-conditioned (elements whose clipped
    gradient is under 100 eps are held to 2 lr, as ``tests/
    test_torch_mla_train.py`` holds MLA's). A_log's and dt_bias's gradients
    are ~2e-7 in norm, below any absolute tolerance, so every leaf, and
    in_proj's dt columns apart, is also held by relative norm,
    ||g - w|| / ||w|| <= 1e-5 (4.9e-6 at most, on A_log): that is what
    holds the scan's backward through dt and A. The hybrid's shared block
    reaches the autograd Function once a call."""
    cfg = tconfigs.get(name)
    dt_cols = slice(2 * cfg.d_inner + 2 * cfg.ssm_state, None)
    jm, jparams, tm = reference_and_port(name, impl="kernel", scan="naive")
    bt = batch(8, 2, 512)
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    jbatch = jax.tree.map(jnp.asarray, bt)
    want_g = jax.tree.leaves(jax.grad(jm.loss)(jparams, jbatch))
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    want_p, _, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg), jbatch,
                              jax.random.PRNGKey(0))
    tbatch = {k: torch.tensor(v) for k, v in bt.items()}
    with CountingFn() as fn:
        got_g = torch.autograd.grad(tm.loss(tbatch), tree_leaves(tm.params))
        _, _, got_m = make_train_step(tm, opt_cfg)(tm.params, init_opt_state(tm.params, opt_cfg),
                                                   tbatch)
    assert fn.calls == [(2, 512, cfg.n_heads, cfg.head_dim)] * shared_calls(cfg) * 2
    close(got_m["loss"], want_m["loss"], 1e-5, "loss")
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-5, "grad_norm")
    for g, w in zip(got_g, want_g):
        close(g, w, 1e-5)
        assert rel_norm(g, w) <= 1e-5
    leaves = tree_leaves(tm.params)
    i = next(i for i, p in enumerate(leaves) if p is tm.params["layers"]["mixer"]["in_proj"])
    assert rel_norm(got_g[i][..., dt_cols], np.asarray(want_g[i])[..., dt_cols]) <= 1e-5
    clip = min(1.0, opt_cfg.grad_clip / float(want_m["grad_norm"]))
    lr = float(want_m["lr"])
    ill = 0
    for p, w, g in zip(tree_leaves(tm.params), jax.tree.leaves(want_p), want_g):
        err = np.abs(p.detach().numpy() - np.asarray(w))
        near_eps = np.abs(np.asarray(g)) * clip < 100 * opt_cfg.eps
        ill += int(near_eps.sum())
        assert (err[~near_eps] <= 1e-5 + 1e-5 * np.abs(np.asarray(w))[~near_eps]).all()
        assert (err[near_eps] <= 2 * lr + 1e-5).all()
    # 7.8 % (mamba2) and 7.1 % (zamba2) of the elements here: all of A_log
    # and dt_bias, whose gradients are ~1e-7, and in_proj's dt columns; the
    # 1e-5 check covers the rest
    assert ill < 0.1 * sum(p.numel() for p in tree_leaves(tm.params))


@pytest.mark.parametrize("name", SMOKES)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_attention_fn_once_per_shared_block_call(name, remat):
    """A loss and its backward past the shortcut with impl="kernel",
    scan="naive": the autograd Function once per call of the hybrid's shared
    block (twice under remat "full": the forward and its recompute), never
    for the attention-free model; remat changes no gradient (fp32, 1e-6)."""
    cfg = tconfigs.get(name)
    _, _, tm = reference_and_port(name, impl="kernel", scan="naive", remat=remat)
    _, _, plain = reference_and_port(name, impl="kernel", scan="naive")
    tb = {k: torch.tensor(v) for k, v in batch(9, 1, 320).items()}
    with CountingFn() as fn:
        grads = torch.autograd.grad(tm.loss(tb), tree_leaves(tm.params))
    per_call = 2 if remat == "full" else 1
    assert fn.calls == [(1, 320, cfg.n_heads, cfg.head_dim)] * shared_calls(cfg) * per_call
    for g, w in zip(grads, torch.autograd.grad(plain.loss(tb), tree_leaves(plain.params))):
        close(g, w.numpy(), 1e-6)


@pytest.mark.parametrize("name", SMOKES)
def test_scan_is_its_own_choice(name):
    """``scan`` defaults to ``impl`` (so serving is as it was); K5 asked for a
    gradient raises, whatever attention's ``impl``; an unknown scan is
    refused; under no_grad the kernel scan and the naive one agree."""
    cfg = tconfigs.get(name)
    assert LanguageModel(cfg, impl="kernel").scan == "kernel"
    assert LanguageModel(cfg, impl="naive").scan == "naive"
    with pytest.raises(ValueError, match="scan"):
        LanguageModel(cfg, scan="pallas")
    model = LanguageModel(cfg, impl="naive", scan="kernel").init(
        torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    tb = {k: torch.tensor(v) for k, v in batch(10, 1, 40).items()}
    with pytest.raises(RuntimeError, match="requires grad"):
        model.loss(tb)
    naive = LanguageModel(cfg, impl="kernel", scan="naive")
    naive.params = model.params
    with torch.no_grad():
        close(model.forward(tb)[0], naive.forward(tb)[0].numpy(), 1e-4)
    naive.loss(tb).backward()
    mixer = model.params["layers"]["mixer"]
    assert all(float(mixer[k].grad.abs().sum()) > 0 for k in ("in_proj", "A_log", "dt_bias"))


@pytest.mark.parametrize("name", SMOKES)
def test_train_main_runs_on_the_cpu(name, capsys):
    """The entry point builds the model with scan="naive": past the
    shortcut at --seq-len 320, K1/K2's plain versions in the hybrid's shared
    block, losses finite."""
    st = ttrain.main(["--arch", name, "--steps", "2", "--global-batch", "2",
                      "--seq-len", "320", "--log-every", "1", "--device", "cpu"])
    losses = st.final_losses
    assert st.step == 2 and st.restarts == 0
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert sum(line.startswith("step ") for line in out.splitlines()) == 2
    assert "on cpu" in out
