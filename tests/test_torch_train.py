"""The port's training path end to end on the CPU: the data stream against
the reference's, a port of ``tests/test_system.py``'s loss-drop test, and the
single-GPU trainer's entry point with ``--device cpu``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import LanguageModel as JaxLM
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, DataLoader, _batch_at, host_batch_slice
from repro_torch.launch import train as train_launch
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves
import repro_torch.configs as tconfigs

SMOKE = "tinyllama-1.1b-smoke"


@pytest.mark.parametrize("kind", ["synthetic_lm", "zipf_lm"])
@pytest.mark.parametrize("step,rows", [(0, slice(0, 4)), (7, slice(2, 4))])
def test_batches_bit_equal_reference(kind, step, rows):
    cfg = DataConfig(vocab_size=1000, seq_len=33, global_batch=4, seed=5, kind=kind)
    jcfg = jpipeline.DataConfig(**cfg.__dict__)
    got, want = _batch_at(cfg, step, rows), jpipeline._batch_at(jcfg, step, rows)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_loader_yields_the_stream_in_order_from_any_step():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=4, seed=1)
    assert host_batch_slice(cfg, 1, 2) == slice(2, 4)
    loader = DataLoader(cfg, start_step=3, process_index=1, process_count=2)
    try:
        for want_step in (3, 4, 5):
            step, batch = next(loader)
            assert step == want_step and loader.step == step + 1
            np.testing.assert_array_equal(batch["tokens"],
                                          _batch_at(cfg, step, slice(2, 4))["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_training_reduces_loss_learnable_data():
    """A port of tests/test_system.py:32-54: memorising a fixed batch, 40
    steps must reduce the loss by more than 1.0 (granite-3-2b-smoke, bf16)."""
    cfg = tconfigs.get("granite-3-2b").smoke()
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptimConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    opt = init_opt_state(model.params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    tokens = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for i in range(40):
        _, opt, metrics = step(model.params, opt, batch, torch.Generator().manual_seed(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert int(opt["step"]) == 40


def test_train_step_takes_model_params_only():
    model = LanguageModel(tconfigs.get("tinyllama-1.1b-smoke")).init(
        torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptimConfig()
    step = make_train_step(model, opt_cfg)
    with pytest.raises(ValueError, match="model.params"):
        step(dict(model.params), init_opt_state(model.params, opt_cfg), {})


@pytest.mark.parametrize("extra", [[], ["--remat", "dots", "--microbatches", "2"]])
def test_train_main_runs_on_the_cpu(extra, capsys):
    """The entry point past the attention shortcut (S=288 > 256), so the
    kernel path's autograd Function carries the gradient (plain versions on
    the CPU)."""
    st = train_launch.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "3",
                            "--global-batch", "2", "--seq-len", "288", "--log-every", "1",
                            "--device", "cpu", *extra])
    losses = st.final_losses
    assert st.step == 3 and st.restarts == 0
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    logged = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(logged) == 3 and all("gnorm" in line for line in logged)
    assert "on cpu" in out


# ---- the trainer's two other modes against the reference ------------------------

def reference_and_port_fp32(seed=0):
    """tinyllama-1.1b-smoke with fp32 parameters from the reference's init,
    impl="naive" on both sides, the port holding them through the converter."""
    jm = JaxLM(jconfigs.get(SMOKE), impl="naive")
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(tconfigs.get(SMOKE), impl="naive")
    tm.load_params(params_from_numpy(jax.tree.map(np.asarray, jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def flipped(got_ef, want_ef, deq) -> np.ndarray:
    """Elements where the two runtimes rounded the compressed gradient to
    neighbouring int8 levels: there the error feedback differs by one level
    of the leaf, max|deq| / 127 (within 1e-2 of it), and elsewhere by no more
    than the gradients do, 1e-5."""
    diff = np.abs(got_ef - want_ef)
    level = np.abs(deq).max() / 127.0
    flip = diff > 1e-5
    np.testing.assert_allclose(diff[flip], level, rtol=1e-2)
    return flip


@pytest.mark.parametrize("mode", [{"microbatches": 2}, {"grad_compression": "int8_ef"}],
                         ids=["microbatches2", "int8_ef"])
def test_one_train_step_of_each_mode_equals_reference(mode):
    """One make_train_step with gradient accumulation over 2 microbatches,
    and one with int8 error-feedback compression, fp32, against the
    reference's jitted step on the same batch (4 x 64): loss and gradient
    norm within 1e-5; every parameter, moment and master weight within
    1e-5 + 1e-5 |w|, but where Adam's first step divides by a gradient near
    its eps (held to 2 lr). int8_ef: the error feedback within 1e-5 but at
    elements that round to a neighbouring int8 level on the two sides
    (fewer than 1 in 1000; there it differs by one level, and mu by that
    level's share); one step only, as rounding flips that Adam magnifies
    part the runs after three."""
    jm, jparams, tm = reference_and_port_fp32()
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (4, 64)).astype(np.int32)
    bt = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    compression = mode.get("grad_compression")
    jstep = jax.jit(jax_make_train_step(jm, jcfg, **mode))
    want_p, want_s, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg, compression),
                                   jax.tree.map(jnp.asarray, bt), jax.random.PRNGKey(0))
    step = make_train_step(tm, opt_cfg, **mode)
    _, got_s, got_m = step(tm.params, init_opt_state(tm.params, opt_cfg, compression),
                           {k: torch.tensor(v) for k, v in bt.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]), rtol=1e-5, atol=1e-5)
    assert int(got_s["step"]) == int(want_s["step"]) == 1
    assert sorted(got_s) == sorted(want_s)
    clip = min(1.0, opt_cfg.grad_clip / float(want_m["grad_norm"]))
    lr, n_flips, n = float(want_m["lr"]), 0, 0
    none = [None] * len(tree_leaves(tm.params))
    leaves = zip(tree_leaves(tm.params), jax.tree.leaves(want_p), tree_leaves(got_s["mu"]),
                 jax.tree.leaves(want_s["mu"]), tree_leaves(got_s["nu"]),
                 jax.tree.leaves(want_s["nu"]), tree_leaves(got_s["master"]),
                 jax.tree.leaves(want_s["master"]),
                 tree_leaves(got_s["ef"]) if compression else none,
                 jax.tree.leaves(want_s["ef"]) if compression else none)
    for p, wp, mu, wmu, nu, wnu, ms, wms, ef, wef in leaves:
        wp, wmu, wnu, wms = (np.asarray(a) for a in (wp, wmu, wnu, wms))
        deq = wmu / ((1 - opt_cfg.b1) * clip)          # the step's gradient, after compression
        near_eps = np.abs(deq) * clip < 100 * opt_cfg.eps
        flip = np.zeros(wp.shape, bool)
        if ef is not None:
            flip = flipped(ef.numpy(), np.asarray(wef), deq)
            n_flips += int(flip.sum())
        n += wp.size
        keep = ~flip
        for got, want in ((mu.numpy(), wmu), (nu.numpy(), wnu)):
            assert (np.abs(got - want)[keep] <= 1e-5 * (1 + np.abs(want[keep]))).all()
        for got in (p.detach().numpy(), ms.numpy()):
            err = np.abs(got - wp)
            assert (err[~near_eps] <= 1e-5 + 1e-5 * np.abs(wp[~near_eps])).all()
            assert (err[near_eps] <= 2 * lr + 1e-5).all()
        np.testing.assert_array_equal(ms.numpy(), p.detach().numpy())
    assert n_flips < 1e-3 * n


def test_int8_ef_state_survives_a_checkpoint_and_the_resumed_step_is_the_same(tmp_path):
    """bf16 parameters with int8_ef: a checkpoint after step 1 holds the
    error feedback with its bits, and step 2 from the restored state equals
    step 2 of the uninterrupted run, to the bit."""
    cfg = tconfigs.get(SMOKE)
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [{"tokens": torch.tensor(t), "labels": torch.tensor(np.roll(t, -1, 1))}
               for t in np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 2, 64))]
    whole = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(whole, opt_cfg, grad_compression="int8_ef")
    _, opt, _ = step(whole.params, init_opt_state(whole.params, opt_cfg, "int8_ef"), batches[0])
    save(str(tmp_path), 1, {"params": whole.params, "opt": opt}, extra={"step": 1})
    ef_after_1 = [e.clone() for e in tree_leaves(opt["ef"])]
    _, opt, m_whole = step(whole.params, opt, batches[1])

    _, tree, extra = restore(str(tmp_path), device="cpu")
    assert extra == {"step": 1} and sorted(tree["opt"]) == ["ef", "master", "mu", "nu", "step"]
    for got, want in zip(tree_leaves(tree["opt"]["ef"]), ef_after_1):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    resumed = LanguageModel(cfg).load_params(tree["params"])
    _, opt_r, m_resumed = make_train_step(resumed, opt_cfg, grad_compression="int8_ef")(
        resumed.params, tree["opt"], batches[1])
    assert float(m_resumed["loss"]) == float(m_whole["loss"])
    for got, want in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        assert got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)
    for got, want in zip(tree_leaves(opt_r), tree_leaves(opt)):
        assert got.dtype == want.dtype and torch.equal(got, want)
