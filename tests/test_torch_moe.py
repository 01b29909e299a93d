"""The MoE slice: the port's ``models/moe.py`` (routing, capacity packing,
the expert SwiGLU and the combine) and the ``moe`` LanguageModel
(qwen3-moe-235b-a22b, GQA attention) against the JAX package's, on converted
fp32 parameters and the same NumPy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch.serve import ServingEngine as JaxEngine
from repro.models import LanguageModel as JaxLM
from repro.models import moe as jmoe
from repro.models.base import count_params as jax_count_params
from repro.models.base import init_params
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.models import moe as tmoe
from repro_torch.models.base import count_params
from repro_torch.models.layers import logits_for_tokens
from repro_torch.serve.step import make_prefill_step
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves

ARCH = "qwen3-moe-235b-a22b"
SMOKE = ARCH + "-smoke"


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def cfg_pair(name=SMOKE, **changes):
    """The reference's config and the port's, with the same changes."""
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    return dataclasses.replace(cj, **changes), dataclasses.replace(ct, **changes)


def reference_and_port(cj, ct, impl_j="naive", impl_t="naive", seed=0):
    jm = JaxLM(cj, impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(ct, impl=impl_t)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def moe_params(cj, seed=0):
    """One MoE layer's parameters from the reference's init, as writable numpy."""
    tree = init_params(jmoe.moe_specs(cj), jax.random.PRNGKey(seed), jnp.float32)
    return jax.tree.map(np.array, tree)


def tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


# ---- configuration -------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count_equal_reference(smoke):
    """The config equals the reference's field for field; the specs count the
    same parameters on the same axes, within 2 % of the analytic n_params()."""
    name = ARCH + ("-smoke" if smoke else "")
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
    built = count_params(LanguageModel(ct).specs())
    assert built == jax_count_params(JaxLM(cj).specs())
    assert LanguageModel(ct).axes() == JaxLM(cj).axes()
    assert abs(built - ct.n_params()) / ct.n_params() < 0.02


def test_moe_specs_and_capacity_equal_reference():
    cj, ct = cfg_pair(n_shared_experts=1)
    assert jax.tree.map(lambda p: (p.shape, p.axes, p.init), jmoe.moe_specs(cj)) == \
        jax.tree.map(lambda p: (p.shape, p.axes, p.init), tmoe.moe_specs(ct))
    full_j, full_t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    for n in (1, 4, 24, 100, 2048, 4096):
        assert tmoe._capacity(n, full_t) == jmoe._capacity(n, full_j)
        assert tmoe._capacity(n, ct) == jmoe._capacity(n, cj)
    assert tmoe._capacity(2048, full_t) == 160 and tmoe._capacity(4, full_t) == 8


# ---- route and moe_ffn ------------------------------------------------------------------

@pytest.mark.parametrize("experts,top_k", [(None, None), (128, 8)])
def test_route_equals_reference(experts, top_k):
    """Weights, experts and the aux loss within 1e-6, at the smoke config's
    4 experts / top-2 and at the full model's 128 / top-8."""
    changes = {} if experts is None else {"n_experts": experts, "top_k": top_k}
    cj, ct = cfg_pair(**changes)
    params = moe_params(cj)
    x = np.random.default_rng(1).standard_normal((40, cj.d_model), np.float32)
    w_j, e_j, aux_j = jmoe.route(jax.tree.map(jnp.asarray, params), cj, jnp.asarray(x))
    w_t, e_t, aux_t = tmoe.route(params_from_numpy(params, torch.float32, "cpu"), ct,
                                 torch.tensor(x))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    close(w_t, w_j, 1e-6)
    close(aux_t, aux_j, 1e-6)


def overflow_case(cj):
    """Inputs whose first lane is large and positive, and a router that reads
    that lane into expert 0 alone: every token's first choice is expert 0, so
    it takes T assignments against its capacity. The rest is continuous
    noise, so no two logits tie."""
    params = moe_params(cj, seed=3)
    params["router"][0, 0] = 2.0
    x = np.random.default_rng(4).standard_normal((2, 12, cj.d_model), np.float32)
    x[..., 0] = 3.0 + 0.1 * x[..., 0]
    return params, x


@pytest.mark.parametrize("case", ["smoke", "shared_expert", "overflow"])
def test_moe_ffn_equals_reference(case):
    """y and the aux loss within 1e-5 (fp32): the smoke config, the same with
    one shared expert, and a router built so that expert 0 overflows its
    capacity (its overflow dropped on both sides)."""
    cj, ct = cfg_pair(n_shared_experts=1) if case == "shared_expert" else cfg_pair()
    if case == "overflow":
        params, x = overflow_case(cj)
        _, experts, _ = tmoe.route(params_from_numpy(params, torch.float32, "cpu"), ct,
                                   torch.tensor(x.reshape(-1, cj.d_model)))
        t = x.shape[0] * x.shape[1]
        assert bool((experts[:, 0] == 0).all())
        assert t > tmoe._capacity(t, ct)                  # 24 tokens against 16 slots
    else:
        params = moe_params(cj)
        x = np.random.default_rng(5).standard_normal((2, 12, cj.d_model), np.float32)
    if case == "shared_expert":
        assert "shared" in params
    y_j, aux_j = jmoe.moe_ffn(jax.tree.map(jnp.asarray, params), cj, jnp.asarray(x))
    y_t, aux_t = tmoe.moe_ffn(params_from_numpy(params, torch.float32, "cpu"), ct,
                              torch.tensor(x))
    assert y_t.shape == x.shape
    close(y_t, y_j, 1e-5)
    close(aux_t, aux_j, 1e-5)


def test_overflow_is_dropped_not_spilled():
    """Expert 0's assignments past its capacity contribute nothing: with the
    router of the overflow case, the tokens that lost their expert-0 slot get
    only their second expert's row, weighted as routed."""
    cj, ct = cfg_pair()
    params, x = overflow_case(cj)
    tp = params_from_numpy(params, torch.float32, "cpu")
    x2d = torch.tensor(x.reshape(-1, cj.d_model))
    t = x2d.shape[0]
    cap = tmoe._capacity(t, ct)
    weights, experts, _ = tmoe.route(tp, ct, x2d)
    assert bool((experts[:, 0] == 0).all())
    assert int(torch.bincount(experts[:, 1], minlength=ct.n_experts).max()) <= cap
    y, _ = tmoe.moe_ffn(tp, ct, torch.tensor(x))
    y = y.reshape(t, -1)

    def expert_row(e, rows):
        g, u = rows @ tp["w_gate"][e], rows @ tp["w_up"][e]
        return (torch.nn.functional.silu(g) * u) @ tp["w_down"][e]

    # the stable sort keeps token order: the first ``cap`` tokens hold expert 0's slots
    second = torch.cat([expert_row(int(e), r[None]) for e, r in zip(experts[:, 1], x2d)])
    want = weights[:, 1:2] * second
    want[:cap] += weights[:cap, 0:1] * expert_row(0, x2d[:cap])
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


def test_moe_ffn_twice_is_bit_identical():
    cj, ct = cfg_pair(n_shared_experts=1)
    tp = params_from_numpy(moe_params(cj), torch.float32, "cpu")
    x = torch.tensor(np.random.default_rng(6).standard_normal((3, 7, cj.d_model), np.float32))
    a, b = tmoe.moe_ffn(tp, ct, x), tmoe.moe_ffn(tp, ct, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---- the model -------------------------------------------------------------------------

@pytest.mark.parametrize("s,impl_j,impl_t,first_k_dense", [
    (12, "chunked", "naive", 0),
    (12, "chunked", "naive", 1),
    (512, "pallas", "kernel", 0),
])
def test_forward_aux_and_loss_equal_reference(s, impl_j, impl_t, first_k_dense):
    """Hidden states and aux within 1e-4, and the loss, in fp32: the port's
    naive path against the reference's chunked one; at S=512 the
    reference runs its Pallas kernel in interpret mode, the port its dispatch
    (K1's plain version on the CPU). ``first_k_dense=1`` adds a dense-FFN
    layer before the MoE layers (``dense_layers``)."""
    changes = {"first_k_dense": 1, "n_layers": 3} if first_k_dense else {}
    jm, jparams, tm = reference_and_port(*cfg_pair(**changes), impl_j, impl_t)
    if first_k_dense:
        assert "dense_layers" in tm.params
    toks = tokens(1, 2, s)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1))}
    batch_t = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    want, aux_j = jm.forward(jparams, batch_j)
    with torch.no_grad():
        got, aux_t = tm.forward(batch_t)
        loss_t = tm.loss(batch_t)
    assert got.shape == (2, s, tm.cfg.d_model) and float(aux_t) > 0
    close(got, want, 1e-4)
    close(aux_t, aux_j, 1e-4)
    close(loss_t, jm.loss(jparams, batch_j), 1e-4)


@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_decode_logits_equal_reference(impl_t):
    """12 teacher-forced steps in fp32 with fp32 caches on both sides."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), "naive", impl_t)
    b, s = 2, 12
    toks = tokens(2, b, s)
    jcache = jm.init_cache(b, 16, dtype=jnp.float32)
    tcache = tm.init_cache(b, 16)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    for t in range(s):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            got, same = tm.decode_step(tcache, torch.tensor(toks[:, t:t + 1]), t)
        assert same is tcache
        close(got, want, 1e-4, f"step {t}")
    for k in jcache:
        close(tcache[k], jcache[k], 1e-4, k)


def test_one_train_step_equals_reference():
    """One step of make_train_step against the reference's jitted step, fp32,
    on the same batch: loss, gradient norm and every parameter after the
    update (AdamW with fp32 master weights)."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), "chunked", "kernel")
    toks = tokens(7, 2, 16)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    want_p, _, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg),
                              jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    step = make_train_step(tm, opt_cfg)
    _, _, got_m = step(tm.params, init_opt_state(tm.params, opt_cfg),
                       {k: torch.tensor(v) for k, v in batch.items()})
    close(got_m["loss"], want_m["loss"], 1e-5)
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-5)
    for g, w in zip(tree_leaves(tm.params), jax.tree.leaves(want_p)):
        close(g, w, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_prefill_matches_decode(impl):
    """The port's own teacher-forced decode reproduces its forward logits, in
    bf16 at the reference dense test's tolerance (atol 0.25 / rtol 0.05),
    where capacity drops nothing: the forward packs all S tokens against one
    capacity, a decode step one token, so with drops the two differ by
    design. ``capacity_factor = n_experts / top_k`` gives every expert room
    for every token."""
    cfg = tconfigs.get(SMOKE)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = LanguageModel(cfg, impl=impl).init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 1, 12
    toks = torch.tensor(tokens(3, b, s))
    with torch.no_grad():
        h, _ = model.forward({"tokens": toks})
        full = logits_for_tokens(model.params["emb"], h)
        cache = model.init_cache(b, s)
        dec = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0] for t in range(s)],
                        dim=1)
    assert torch.allclose(full.float(), dec.float(), atol=0.25, rtol=0.05)


BATCH, PROMPT, STEPS, MAX_LEN = 2, 8, 12, 32


def test_generate_greedy_tokens_identical_to_reference():
    """fp32, batch 2, prompt 8, 12 greedy steps: the same token ids; and the
    prefill step's last logits equal the engine's (1e-4), as the prefill's
    16 tokens fit the capacity of 16 (nothing is dropped)."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), "naive", "kernel")
    prompts = tokens(4, BATCH, PROMPT)
    assert tmoe._capacity(BATCH * PROMPT, tm.cfg) >= BATCH * PROMPT
    jeng = JaxEngine(jm, jparams, BATCH, MAX_LEN)
    jeng.cache = jm.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
    want = jeng.generate(prompts, STEPS)
    teng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    got = teng.generate(prompts, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    full = make_prefill_step(tm)({"tokens": torch.tensor(prompts)})
    eng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    eng.prefill(prompts)
    close(full[:, 0], eng.prefill_logits.numpy(), 1e-4)


def test_first_k_dense_decode_is_refused_on_both_sides():
    """A moe config with GQA attention and first_k_dense > 0 runs forward,
    but the reference's decode step cannot run it (it scans the MoE layers
    against the full-depth cache), and the port refuses it with the reason."""
    cj, ct = cfg_pair(first_k_dense=1, n_layers=3)
    jm, jparams, tm = reference_and_port(cj, ct)
    with pytest.raises(ValueError):
        jm.decode_step(jparams, jm.init_cache(1, 4, dtype=jnp.float32),
                       jnp.zeros((1, 1), jnp.int32), jnp.int32(0))
    with pytest.raises(NotImplementedError, match="first_k_dense=1.*skips the dense layers"):
        tm.init_cache(1, 4)


def test_serve_and_train_main_run_on_the_cpu(capsys):
    toks = tserve.main(["--device", "cpu", "--arch", SMOKE, "--batch", "2", "--prompt-len", "6",
                        "--gen", "4", "--max-len", "16"])
    assert tuple(toks.shape) == (2, 4)
    st = ttrain.main(["--arch", SMOKE, "--steps", "2", "--global-batch", "2",
                      "--seq-len", "32", "--log-every", "1", "--device", "cpu"])
    losses = st.final_losses
    assert st.step == 2 and st.restarts == 0
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "tok/s" in out and "on cpu" in out
