"""The hybrid slice as a whole: the port's ``ssm`` (mamba2-1.3b) and
``hybrid`` (zamba2-1.2b) LanguageModel and ServingEngine against the JAX
package's, on converted parameters and the same tokens, in fp32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch.serve import ServingEngine as JaxEngine
from repro.models import LanguageModel as JaxLM
from repro.models.base import count_params as jax_count_params
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import LanguageModel
from repro_torch.models.base import count_params
from repro_torch.models.layers import logits_for_tokens
from repro_torch.serve.step import make_prefill_step

ARCHS = ["mamba2-1.3b", "zamba2-1.2b"]
SMOKES = [a + "-smoke" for a in ARCHS]


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def reference_and_port(name, impl_j="naive", impl_t="naive", fused=False, seed=0):
    """The reference model with fp32 parameters from its own init (A_log, D
    and dt_bias moved off their constant init so that they matter), and the
    port holding the same parameters through the converter."""
    jm = JaxLM(jconfigs.get(name), impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    mixer = jparams["layers"]["mixer"]
    for k in ("A_log", "D", "dt_bias"):
        mixer[k] = mixer[k] + jnp.asarray(rng.standard_normal(mixer[k].shape, np.float32) * 0.3)
    tm = LanguageModel(tconfigs.get(name), impl=impl_t, fused_ffn=fused)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count_equal_reference(arch, smoke):
    """The port's configs equal the reference's field for field; the specs
    count the same parameters, within 2 % of the analytic n_params()
    (tests/test_models.py:122)."""
    name = arch + ("-smoke" if smoke else "")
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
    built = count_params(LanguageModel(ct).specs())
    assert built == jax_count_params(JaxLM(cj).specs())
    assert LanguageModel(ct).axes() == JaxLM(cj).axes()
    if not smoke:
        assert abs(built - ct.n_params()) / ct.n_params() < 0.02


@pytest.mark.parametrize("name", SMOKES)
def test_converter_carries_the_ssm_leaves_and_the_tied_embedding(name):
    jm, jparams, tm = reference_and_port(name)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {"".join(f"['{s}']" for s in k.split(".")): v.numpy()
              for k, v in tm.params.state_dict().items()}
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    for leaf in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "norm", "in_proj", "out_proj"):
        assert f"['layers']['mixer']['{leaf}']" in flat_t
    assert "['emb']['lm_head']" not in flat_t           # tied: the embedding serves both


@pytest.mark.parametrize("name,s,impl_j,impl_t,fused", [
    ("mamba2-1.3b-smoke", 12, "naive", "naive", False),
    ("mamba2-1.3b-smoke", 300, "naive", "kernel", False),
    ("zamba2-1.2b-smoke", 12, "naive", "naive", False),
    ("zamba2-1.2b-smoke", 12, "naive", "kernel", True),
    ("zamba2-1.2b-smoke", 512, "pallas", "kernel", True),
])
def test_forward_hidden_states_equal_reference(name, s, impl_j, impl_t, fused):
    """fp32, 1e-4. At S=512 the shared block is past the Sq <= 256 shortcut:
    the reference in its Pallas kernel (interpret mode), the port in its
    dispatch (plain versions of K1, K4 and K5 on the CPU)."""
    jm, jparams, tm = reference_and_port(name, impl_j, impl_t, fused)
    toks = tokens(1, 2, s)
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = tm.forward({"tokens": torch.tensor(toks)})
    assert got.shape == (2, s, tm.cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", SMOKES)
@pytest.mark.parametrize("impl_t,fused", [("naive", False), ("kernel", True)])
def test_decode_logits_and_caches_equal_reference(name, impl_t, fused):
    """12 teacher-forced steps in fp32 with fp32 caches on both sides: logits
    and every cache (conv, SSM state, shared K/V) within 1e-4."""
    jm, jparams, tm = reference_and_port(name, "naive", impl_t, fused)
    b, s = 2, 12
    toks = tokens(2, b, s)
    jcache = jm.init_cache(b, 16, dtype=jnp.float32)
    tcache = tm.init_cache(b, 16)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tcache["ssm"].dtype == torch.float32
    for t in range(s):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            got, same = tm.decode_step(tcache, torch.tensor(toks[:, t:t + 1]), t)
        assert same is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    for k in jcache:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_cache_dtypes_follow_the_parameters_except_the_ssm_state():
    cfg = tconfigs.get("zamba2-1.2b-smoke")
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(3, 20)
    assert cache["ssm"].dtype == torch.float32
    assert {cache[k].dtype for k in ("conv", "shared_k", "shared_v")} == {torch.bfloat16}
    assert cache["shared_k"].shape == (cfg.n_layers // cfg.attn_every, 3, 20, cfg.n_kv_heads,
                                       cfg.head_dim)


@pytest.mark.parametrize("name", SMOKES)
@pytest.mark.parametrize("impl,fused", [("naive", False), ("kernel", True)])
def test_prefill_matches_decode(name, impl, fused):
    """The port of tests/test_models.py:100 (ssm), and the hybrid case: the
    port's own teacher-forced decode reproduces its forward logits, bf16, at
    the reference test's tolerance (atol 0.3 / rtol 0.05)."""
    cfg = tconfigs.get(name)
    model = LanguageModel(cfg, impl=impl, fused_ffn=fused).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert model.dtype == torch.bfloat16
    b, s = 1, 16
    toks = torch.tensor(tokens(3, b, s))
    with torch.no_grad():
        h, _ = model.forward({"tokens": toks})
        full = logits_for_tokens(model.params["emb"], h)
        cache = model.init_cache(b, s)
        dec = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0] for t in range(s)], dim=1)
    assert torch.allclose(full.float(), dec.float(), atol=0.3, rtol=0.05)


BATCH, PROMPT, STEPS, MAX_LEN = 2, 8, 16, 32


@pytest.mark.parametrize("name", SMOKES)
@pytest.mark.parametrize("impl,fused", [("naive", False), ("kernel", True)])
def test_generate_greedy_tokens_identical_to_reference(name, impl, fused):
    """fp32, batch 2, prompt 8, 16 greedy steps: the same token ids. The
    reference engine is given an fp32 cache (its default is bf16)."""
    jm, jparams, tm = reference_and_port(name, "naive", impl, fused)
    prompts = tokens(4, BATCH, PROMPT)
    jeng = JaxEngine(jm, jparams, BATCH, MAX_LEN)
    jeng.cache = jm.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
    want = jeng.generate(prompts, STEPS)
    teng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    got = teng.generate(prompts, STEPS)
    assert got.shape == (BATCH, STEPS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_step_agrees_with_engine_prefill_hybrid():
    """The full-sequence forward (K5, K1's dispatch, K4) and the
    token-at-a-time engine give the same last-position logits (fp32, 1e-4)."""
    _, _, tm = reference_and_port("zamba2-1.2b-smoke", "naive", "kernel", True)
    p = tokens(5, BATCH, PROMPT)
    full = make_prefill_step(tm)({"tokens": torch.tensor(p)})
    eng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    eng.prefill(p)
    np.testing.assert_allclose(full[:, 0].numpy(), eng.prefill_logits.numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("args", [["--arch", "zamba2-1.2b-smoke", "--fused-ffn"],
                                  ["--arch", "mamba2-1.3b-smoke", "--impl", "naive"]])
def test_main_runs_on_the_cpu(args, capsys):
    toks = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "4",
                        "--max-len", "16", *args])
    assert tuple(toks.shape) == (2, 4)
    assert "tok/s" in capsys.readouterr().out
