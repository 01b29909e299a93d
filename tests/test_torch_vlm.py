"""The vision-language slice: the port's ``vlm`` LanguageModel (internvl2-26b,
the dense GQA family whose batch may carry ``patch_embeds`` for its first
positions) against the JAX package's, on converted fp32 parameters, the
same tokens and the same patch embeddings, with the reference's batch
convention of 8 patch positions (``tests/test_models.py:16-18``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.base import count_params as jax_count_params
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.models.base import count_params
from repro_torch.models.layers import logits_for_tokens
from repro_torch.serve.step import make_prefill_step
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves

ARCH = "internvl2-26b"
SMOKE = ARCH + "-smoke"
PATCHES = 8


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def reference_and_port(impl_j="naive", impl_t="naive", seed=0):
    jm = JaxLM(jconfigs.get(SMOKE), impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(tconfigs.get(SMOKE), impl=impl_t)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def batch(seed, b, s, d, patches=PATCHES):
    """Tokens, next-token labels and ``patches`` patch embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if patches:
        out["patch_embeds"] = rng.standard_normal((b, patches, d), np.float32)
    return out


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count_equal_reference(smoke):
    """The config equals the reference's field for field (a ``vision`` front
    end, head dim 128 at full size); the specs count the same parameters on
    the same axes, within 2 % of the analytic n_params()."""
    name = ARCH + ("-smoke" if smoke else "")
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
    assert ct.frontend == "vision" and ct.family == "vlm"
    built = count_params(LanguageModel(ct).specs())
    assert built == jax_count_params(JaxLM(cj).specs())
    assert LanguageModel(ct).axes() == JaxLM(cj).axes()
    assert abs(built - ct.n_params()) / ct.n_params() < 0.02


@pytest.mark.parametrize("s,impl_j,impl_t,patches", [
    (16, "chunked", "naive", PATCHES),
    (16, "chunked", "naive", 0),
    (512, "pallas", "kernel", PATCHES),
])
def test_forward_and_loss_equal_reference(s, impl_j, impl_t, patches):
    """Hidden states within 1e-4 and the loss, fp32, with and without patch
    embeddings: the port's naive path against the reference's chunked one;
    at S=512 the reference runs its Pallas kernel in interpret mode, the
    port its dispatch (K1's plain version on the CPU)."""
    jm, jparams, tm = reference_and_port(impl_j, impl_t)
    b_np = batch(1, 2, s, tm.cfg.d_model, patches)
    b_j = {k: jnp.asarray(v) for k, v in b_np.items()}
    b_t = {k: torch.tensor(v) for k, v in b_np.items()}
    want, _ = jm.forward(jparams, b_j)
    with torch.no_grad():
        got, aux = tm.forward(b_t)
        loss = tm.loss(b_t)
    assert got.shape == (2, s, tm.cfg.d_model) and float(aux) == 0.0
    close(got, want, 1e-4)
    close(loss, jm.loss(jparams, b_j), 1e-4)


def test_patch_embeds_take_the_first_positions():
    """The first P positions are the patch embeddings, cast to the
    embeddings' dtype; the rest are the token embeddings. Changing a patch
    changes the hidden states from its position on, and none before it."""
    tm = LanguageModel(tconfigs.get(SMOKE)).init(torch.Generator().manual_seed(0), device="cpu")
    b_np = batch(2, 2, 12, tm.cfg.d_model)
    b_t = {k: torch.tensor(v) for k, v in b_np.items()}
    x = tm._embed_inputs(b_t)
    assert x.dtype == torch.bfloat16
    assert torch.equal(x[:, :PATCHES], b_t["patch_embeds"].to(torch.bfloat16))
    assert torch.equal(x[:, PATCHES:], tm.params["emb"]["embedding"][b_t["tokens"][:, PATCHES:]])
    other = dict(b_t, patch_embeds=b_t["patch_embeds"].clone())
    other["patch_embeds"][:, 5] += 1.0
    with torch.no_grad():
        h, _ = tm.forward(b_t)
        h2, _ = tm.forward(other)
    assert torch.equal(h[:, :5], h2[:, :5]) and not torch.equal(h[:, 5:], h2[:, 5:])


@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_decode_logits_equal_reference(impl_t):
    """12 teacher-forced steps in fp32 with fp32 caches on both sides."""
    jm, jparams, tm = reference_and_port("naive", impl_t)
    b, s = 2, 12
    toks = batch(3, b, s, tm.cfg.d_model, 0)["tokens"]
    jcache = jm.init_cache(b, 16, dtype=jnp.float32)
    tcache = tm.init_cache(b, 16)
    assert tcache["k"].shape == jcache["k"].shape
    for t in range(s):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            got, _ = tm.decode_step(tcache, torch.tensor(toks[:, t:t + 1]), t)
        close(got, want, 1e-4, f"step {t}")


def test_one_train_step_equals_reference():
    """One step with patch embeddings in the batch, against the reference's
    jitted step, fp32: loss, gradient norm and every parameter after it."""
    jm, jparams, tm = reference_and_port("chunked", "kernel")
    b_np = batch(4, 2, 16, tm.cfg.d_model)
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    want_p, _, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg),
                              jax.tree.map(jnp.asarray, b_np), jax.random.PRNGKey(0))
    step = make_train_step(tm, opt_cfg)
    _, _, got_m = step(tm.params, init_opt_state(tm.params, opt_cfg),
                       {k: torch.tensor(v) for k, v in b_np.items()})
    close(got_m["loss"], want_m["loss"], 1e-5)
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-5)
    for g, w in zip(tree_leaves(tm.params), jax.tree.leaves(want_p)):
        close(g, w, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_prefill_matches_decode(impl):
    """Without patch embeddings (the decode step embeds tokens only), the
    port's teacher-forced decode reproduces its forward logits, bf16, at the
    reference test's tolerance (atol 0.25 / rtol 0.05)."""
    cfg = tconfigs.get(SMOKE)
    model = LanguageModel(cfg, impl=impl).init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 1, 12
    toks = torch.tensor(batch(5, b, s, cfg.d_model, 0)["tokens"])
    with torch.no_grad():
        h, _ = model.forward({"tokens": toks})
        full = logits_for_tokens(model.params["emb"], h)
        cache = model.init_cache(b, s)
        dec = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0] for t in range(s)],
                        dim=1)
    assert torch.allclose(full.float(), dec.float(), atol=0.25, rtol=0.05)


def test_prefill_step_passes_patch_embeds_and_the_engine_embeds_tokens_only():
    """The prefill step hands the batch to ``forward``, so its last logits
    are the reference forward's with the patches (1e-4); the engine, like the
    reference's, prefills token by token and equals the prefill step without
    them (1e-4)."""
    jm, jparams, tm = reference_and_port("naive", "kernel")
    b_np = batch(6, 2, 12, tm.cfg.d_model)
    del b_np["labels"]
    prefill = make_prefill_step(tm)
    got = prefill({k: torch.tensor(v) for k, v in b_np.items()})
    h, _ = jm.forward(jparams, {k: jnp.asarray(v) for k, v in b_np.items()})
    from repro.models.layers import logits_for_tokens as jax_logits
    close(got, jax_logits(jparams["emb"], h[:, -1:]), 1e-4)
    eng = tserve.ServingEngine(tm, 2, 16)
    eng.prefill(b_np["tokens"])
    close(prefill({"tokens": torch.tensor(b_np["tokens"])})[:, 0], eng.prefill_logits.numpy(),
          1e-4)
    assert not torch.allclose(got[:, 0], eng.prefill_logits, atol=1e-2)


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
