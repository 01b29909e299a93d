"""The port's AdamW and train step: ports of ``tests/test_optim.py``, one
``apply_updates`` step against the reference's from identical parameters,
gradients and state, and the stochastic rounding's bits against a numpy
reimplementation of the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train as jtrain
import repro_torch.configs as tconfigs
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import LanguageModel
from repro_torch.train import (OptimConfig, apply_updates, init_opt_state, init_state, lr_at,
                               make_train_step)
from repro_torch.train.optim import _dither_round_bf16, _stochastic_round_bf16, tree_leaves
from repro_torch.train.step import (compress_grads, dequantize_int8, init_ef_state,
                                    quantize_int8)
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)


# ---- ports of tests/test_optim.py -------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = OptimConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200,
                      min_lr_ratio=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_state(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(150):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = apply_updates(params, grads, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_lr_schedule_shape():
    cfg = OptimConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(lr_at(cfg, 0)) == 0.0
    assert abs(float(lr_at(cfg, 10)) - 1.0) < 1e-6
    assert float(lr_at(cfg, 100)) == pytest.approx(0.1, abs=1e-6)
    assert float(lr_at(cfg, 55)) < float(lr_at(cfg, 11))


def test_grad_clip_applies():
    cfg = OptimConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = init_state(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = apply_updates(params, huge, state, cfg)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def test_bf16_moment_state_dtype():
    cfg = OptimConfig(moment_dtype="bfloat16", master_weights=False)
    params = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    state = init_state(params, cfg)
    assert state["mu"]["w"].dtype == torch.bfloat16
    assert "master" not in state


def test_int8_quantization_roundtrip():
    x = torch.tensor([0.5, -1.0, 0.25, 127.0])
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=float(s) + 1e-6)


def test_int8_ef_error_accumulates_to_zero_bias():
    """Error feedback: repeated compression of a constant gradient passes the
    full magnitude through on average (EF re-injects residuals)."""
    g = {"w": torch.full((64,), 0.003)}
    ef = init_ef_state(g, "int8_ef")
    total = torch.zeros(64)
    for _ in range(50):
        eff, ef = compress_grads(g, "int8_ef", ef)
        total = total + eff["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), rtol=0.02)


def smoke_model(arch="granite-3-2b", seed=0):
    cfg = tconfigs.get(arch).smoke()
    return LanguageModel(cfg).init(torch.Generator().manual_seed(seed), device="cpu")


def test_microbatch_equivalence():
    """microbatches=4 gives (numerically close) the update of one full batch."""
    m1, m4 = smoke_model(), smoke_model()
    opt_cfg = OptimConfig(lr=1e-3)
    tokens = torch.tensor(np.random.default_rng(1).integers(0, m1.cfg.vocab_size, (4, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    _, _, r1 = make_train_step(m1, opt_cfg, microbatches=1)(
        m1.params, init_opt_state(m1.params, opt_cfg), batch)
    _, _, r4 = make_train_step(m4, opt_cfg, microbatches=4)(
        m4.params, init_opt_state(m4.params, opt_cfg), batch)
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 0.02
    l1 = tree_leaves(m1.params)[0].detach().float()
    l4 = tree_leaves(m4.params)[0].detach().float()
    np.testing.assert_allclose(l1.numpy(), l4.numpy(), atol=0.02)


# ---- one step against the reference ------------------------------------------------

def state_pair(rng, params, step, moment_dtype, master):
    """A reference state (jnp) and its numpy form, at ``step``; moments
    rounded once to ``moment_dtype`` by JAX."""
    mdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32

    def tree(fn):
        return {k: fn(v) for k, v in params.items()}

    mu = tree(lambda v: jnp.asarray(rng.standard_normal(v.shape, np.float32) * 0.01).astype(mdt))
    nu = tree(lambda v: jnp.asarray(rng.random(v.shape, np.float32) * 1e-3).astype(mdt))
    jstate = {"step": jnp.int32(step), "mu": mu, "nu": nu}
    if master:
        jstate["master"] = tree(lambda v: jnp.asarray(v))
    as_np = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), jstate)
    as_np["step"] = step
    return jstate, as_np


@pytest.mark.parametrize("step", [0, 7])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_apply_updates_equals_reference(step, moment_dtype, master):
    """fp32 parameters, identical parameters, gradients and state: one step is
    within 1e-6 of the reference's (parameters, moments, master, lr, norm)."""
    rng = np.random.default_rng(step)
    params = {"a": rng.standard_normal((16, 8), np.float32),
              "b": {"c": rng.standard_normal((5,), np.float32)}}
    flat = {"a": params["a"], "c": params["b"]["c"]}
    grads = jax.tree.map(lambda v: rng.standard_normal(v.shape, np.float32) * 0.3, params)
    cfg = OptimConfig(lr=1e-2, moment_dtype=moment_dtype, master_weights=master,
                      warmup_steps=3, total_steps=20)
    jcfg = jtrain.OptimConfig(**cfg.__dict__)
    jstate, np_state = state_pair(rng, flat, step, moment_dtype, master)
    # the reference's trees keyed as the parameters
    nest = lambda t: {"a": t["a"], "b": {"c": t["c"]}}
    jstate = {k: (nest(v) if isinstance(v, dict) else v) for k, v in jstate.items()}
    np_state = {k: (nest(v) if isinstance(v, dict) else v) for k, v in np_state.items()}

    want_p, want_s, want_m = jtrain.apply_updates(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads), jstate, jcfg)
    tdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    tparams = params_from_numpy(params, torch.float32, "cpu")
    tstate = opt_state_from_numpy(np_state, tdt, "cpu")
    got_p, got_s, got_m = apply_updates(tparams, params_from_numpy(grads, torch.float32, "cpu"),
                                        tstate, cfg)
    assert got_p is tparams and got_s is tstate                 # in place
    assert int(got_s["step"]) == step + 1 == int(want_s["step"])
    close = lambda g, w: np.testing.assert_allclose(
        g.float().numpy(), np.asarray(jnp.asarray(w).astype(jnp.float32)), atol=1e-6, rtol=1e-6)
    close(got_m["lr"], want_m["lr"])
    close(got_m["grad_norm"], want_m["grad_norm"])
    for key in ("mu", "nu") + (("master",) if master else ()):
        for g, w in zip(tree_leaves(got_s[key]), jax.tree.leaves(want_s[key])):
            assert g.dtype == (torch.float32 if key == "master" else tdt)
            close(g, w)
    for g, w in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        close(g, w)


# ---- stochastic rounding ---------------------------------------------------------------

def numpy_stochastic_round(x32: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """optim.py:65-70 in numpy: uint32 bits plus 16 bits of noise, the low
    half cleared (the result is a bf16 value, held here in fp32)."""
    bits = x32.view(np.uint32)
    out = (bits + noise.astype(np.uint32)) & np.uint32(0xFFFF0000)
    return out.view(np.float32)


def test_stochastic_rounding_bits_equal_numpy():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10,
                        np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-40, np.inf,
                                  -np.inf, np.float32(1.0039062)], np.float32)])
    noise = rng.integers(0, 1 << 16, x.shape).astype(np.int32)
    noise[-10:] = 0xFFFF                          # the carry into the kept bits
    got = _dither_round_bf16(torch.tensor(x), torch.tensor(noise))
    assert got.dtype == torch.bfloat16
    want = numpy_stochastic_round(x, noise)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


def test_stochastic_rounding_is_unbiased():
    """Between two neighbouring bf16 values, the mean of many draws is the
    fp32 value, where round-to-nearest would always give the nearer one."""
    x = torch.full((200_000,), 1.0 + 2 ** -9, dtype=torch.float32)   # 1/4 of a bf16 ulp up
    gen = torch.Generator().manual_seed(0)
    got = _stochastic_round_bf16(gen, x).float()
    assert set(np.unique(got.numpy())) == {1.0, 1.0 + 2 ** -7}
    assert float(got.mean()) == pytest.approx(1.0 + 2 ** -9, abs=2e-5)
    assert float(x.to(torch.bfloat16).float().mean()) == 1.0


def test_stochastic_rounding_applies_only_without_master():
    cfg = OptimConfig(lr=1e-3, moment_dtype="bfloat16", master_weights=False,
                      stochastic_rounding=True, warmup_steps=0)
    params = {"w": torch.ones(4096, dtype=torch.bfloat16)}
    state = init_state(params, cfg)
    grads = {"w": torch.full((4096,), 1e-4, dtype=torch.bfloat16)}
    apply_updates(params, grads, state, cfg, rng=torch.Generator().manual_seed(0))
    # 1 - 1e-3 * (1 + 0.1) lies between bf16 neighbours: rounding to nearest
    # would give one value everywhere, the dither gives both
    assert len(torch.unique(params["w"])) == 2
