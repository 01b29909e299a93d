"""The MLA slice: K1's plain version at v head dim != q/k head dim against the
reference's Pallas kernel (interpret mode) and its jnp oracle; the checks
that admit MLA's shapes to K1; the port's
``mla_attention`` / ``mla_decode`` and the ``moe`` LanguageModel with MLA
(deepseek-v2-236b) against the JAX package's, on converted fp32 parameters and
the same NumPy inputs. The CUDA instances at (192, 128) are held against the
same plain version on the card by ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.serve import ServingEngine as JaxEngine
from repro.models import LanguageModel as JaxLM
from repro.models import attention as jattn
from repro.models.base import count_params as jax_count_params
from repro.models.base import init_params
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, check_inputs, flash_attention,
                                                 flash_attention_plain)
from repro_torch.launch import serve as tserve
from repro_torch.models import LanguageModel
from repro_torch.models import attention as tattn
from repro_torch.models.base import count_params
from repro_torch.models.layers import logits_for_tokens
from repro_torch.serve.step import make_prefill_step
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

ARCH = "deepseek-v2-236b"
SMOKE = ARCH + "-smoke"
# the tolerances of tests/test_kernels.py:14; bf16 carries ~3 decimal digits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32 model outputs: summation order, and RoPE's fp32 angles at positions
# >= 256 (as the other model tests hold them)
MODEL_TOL = 1e-4


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


def mla_params(cj, seed=0):
    """One MLA attention's parameters from the reference's init: (jax, port)."""
    tree = init_params(jattn.mla_specs(cj), jax.random.PRNGKey(seed), jnp.float32)
    return tree, params_from_numpy(to_numpy_tree(tree), torch.float32, "cpu")


def tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def both(arr, dtype):
    """The same values (rounded to ``dtype`` once, by JAX) on both sides."""
    j = jnp.asarray(arr).astype(JDT[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def qkv(seed, b, s, h, kvh, d, dv, dtype="float32"):
    rng = np.random.default_rng(seed)
    return (both(rng.standard_normal((b, s, h, d), np.float32), dtype),
            both(rng.standard_normal((b, s, kvh, d), np.float32), dtype),
            both(rng.standard_normal((b, s, kvh, dv), np.float32), dtype))


# ---- K1 at Dv != D ---------------------------------------------------------------------

@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_at_dv_vs_pallas_and_ref(kvh, causal, dtype):
    """B=1, S=512, H=4, q/k head dim 24 and v head dim 16 (the smoke model's
    MLA widths), scale 24^-0.5, against the Pallas kernel in interpret mode
    and the jnp oracle; the dispatch takes the same plain version."""
    b, s, h, d, dv = 1, 512, 4, 24, 16
    (qj, qt), (kj, kt), (vj, vt) = qkv(0, b, s, h, kvh, d, dv, dtype)
    scale = d ** -0.5
    got, lse = flash_attention_plain(qt, kt, vt, causal=causal, scale=scale)
    assert got.shape == (b, s, h, dv) and got.dtype == TDT[dtype] and lse.shape == (b, s, h)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, scale=scale, interpret=True)
    want = ref.flash_attention_ref(qj, kj, vj, causal=causal, scale=scale)
    tol = TOL[dtype]
    close(got, pallas.astype(jnp.float32), tol)
    close(got, want.astype(jnp.float32), tol)
    assert torch.equal(ops.flash_attention_op(qt, kt, vt, causal=causal, scale=scale), got)


def test_check_inputs_admits_v_head_dim_and_refuses_other_mismatches():
    q, k = torch.zeros(2, 8, 4, 24), torch.zeros(2, 8, 2, 24)
    check_inputs(q, k, torch.zeros(2, 8, 2, 16), causal=True)
    for bad in ((1, 8, 2, 16), (2, 7, 2, 16), (2, 8, 1, 16)):
        with pytest.raises(ValueError, match="disagree in batch, length or heads"):
            check_inputs(q, k, torch.zeros(bad), causal=True)
    with pytest.raises(ValueError, match="batch or head dim"):
        check_inputs(q, torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 16), causal=True)


def test_k1_wrapper_names_its_head_dim_pairs_and_refuses_cpu_tensors():
    """(192, 128) is an instance; (24, 16) is not, and the refusal names the
    pairs. A CPU tensor at an instance's shape raises instead of launching."""
    assert (192, 128) in HEAD_DIMS
    before = flash_attention.launches
    (_, q), (_, k), (_, v) = qkv(1, 1, 8, 2, 2, 24, 16)
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        flash_attention(q, k, v, causal=True)
    (_, q), (_, k), (_, v) = qkv(1, 1, 8, 2, 2, 192, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before


# ---- MLA attention and decode --------------------------------------------------------

def test_config_and_specs_equal_reference():
    """The config equals the reference's field for field (full and smoke); the
    MLA specs and the model's count the same parameters on the same axes."""
    for name in (ARCH, SMOKE):
        cj, ct = jconfigs.get(name), tconfigs.get(name)
        assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
        assert count_params(LanguageModel(ct).specs()) == jax_count_params(JaxLM(cj).specs())
        assert LanguageModel(ct).axes() == JaxLM(cj).axes()
    cj, ct = cfg_pair()
    assert jax.tree.map(lambda p: (p.shape, p.axes, p.init), jattn.mla_specs(cj)) == \
        jax.tree.map(lambda p: (p.shape, p.axes, p.init), tattn.mla_specs(ct))


@pytest.mark.parametrize("s,impl_j,impl_t", [(32, "naive", "naive"), (512, "pallas", "kernel")])
def test_mla_attention_equals_reference(s, impl_j, impl_t):
    """At S=512 the reference runs its Pallas kernel (interpret mode) at q/k
    head dim 24 and v head dim 16, the port its dispatch (K1's plain version
    on the CPU)."""
    cj, ct = cfg_pair()
    jp, tp = mla_params(cj)
    x = np.random.default_rng(3).standard_normal((2, s, cj.d_model), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jattn.mla_attention(jp, cj, jnp.asarray(x), jnp.asarray(pos), impl=impl_j)
    with torch.no_grad():
        got = tattn.mla_attention(tp, ct, torch.tensor(x), torch.tensor(pos), impl=impl_t)
    assert got.shape == (2, s, ct.d_model)
    close(got, want, MODEL_TOL)


def test_mla_decode_equals_reference_over_12_steps():
    """The absorbed decode, 12 steps in fp32: outputs, and both latent caches
    (written in place at each step's position)."""
    cj, ct = cfg_pair()
    jp, tp = mla_params(cj)
    b, steps, max_len = 2, 12, 16
    x = np.random.default_rng(4).standard_normal((steps, b, 1, cj.d_model), np.float32)
    jckv = jnp.zeros((b, max_len, cj.kv_lora_rank), jnp.float32)
    jkr = jnp.zeros((b, max_len, cj.rope_head_dim), jnp.float32)
    tckv, tkr = torch.zeros(jckv.shape), torch.zeros(jkr.shape)
    for t in range(steps):
        want, jckv, jkr = jattn.mla_decode(jp, cj, jnp.asarray(x[t]), jckv, jkr, t)
        with torch.no_grad():
            got, ckv, kr = tattn.mla_decode(tp, ct, torch.tensor(x[t]), tckv, tkr, t)
        assert ckv is tckv and kr is tkr
        close(got, want, MODEL_TOL, f"step {t}")
    close(tckv, jckv, MODEL_TOL, "ckv")
    close(tkr, jkr, MODEL_TOL, "krope")


# ---- the model -----------------------------------------------------------------------

@pytest.mark.parametrize("s,impl_j,impl_t", [(12, "naive", "naive"), (512, "pallas", "kernel")])
def test_forward_aux_and_loss_equal_reference(s, impl_j, impl_t):
    """deepseek-v2-236b-smoke (one dense-FFN layer, then MoE layers with one
    shared expert): hidden states, aux and loss within 1e-4 in fp32."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), impl_j, impl_t)
    assert "dense_layers" in tm.params and "shared" in tm.params["layers"]["moe"]
    toks = tokens(1, 2, s)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1))}
    batch_t = {k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()}
    want, aux_j = jax.jit(jm.forward)(jparams, batch_j)
    with torch.no_grad():
        got, aux_t = tm.forward(batch_t)
        loss_t = tm.loss(batch_t)
    assert got.shape == (2, s, tm.cfg.d_model) and float(aux_t) > 0
    close(got, want, MODEL_TOL)
    close(aux_t, aux_j, MODEL_TOL)
    close(loss_t, jax.jit(jm.loss)(jparams, batch_j), MODEL_TOL)


def test_decode_logits_equal_reference():
    """12 teacher-forced steps in fp32 with fp32 latent caches on both sides:
    the dense layer against cache layer 0, the MoE layers against the rest."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), "naive", "kernel")
    b, s = 2, 12
    toks = tokens(2, b, s)
    jcache = jm.init_cache(b, 16, dtype=jnp.float32)
    tcache = tm.init_cache(b, 16)
    assert set(tcache) == {"ckv", "krope"}
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    jstep = jax.jit(jm.decode_step)
    for t in range(s):
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        with torch.no_grad():
            got, same = tm.decode_step(tcache, torch.tensor(toks[:, t:t + 1]), t)
        assert same is tcache
        close(got, want, MODEL_TOL, f"step {t}")
    for k in jcache:
        close(tcache[k], jcache[k], MODEL_TOL, k)


def test_prefill_matches_decode():
    """The port's own absorbed decode reproduces its forward's logits, in
    bf16 at the model tests' tolerance (atol 0.25 / rtol 0.05), with a
    capacity that drops nothing (``n_experts / top_k``)."""
    cfg = tconfigs.get(SMOKE)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
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
    prefill step's last logits equal the engine's (1e-4)."""
    jm, jparams, tm = reference_and_port(*cfg_pair(), "naive", "kernel")
    prompts = tokens(4, BATCH, PROMPT)
    jeng = JaxEngine(jm, jparams, BATCH, MAX_LEN)
    jeng.cache = jm.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
    want = jeng.generate(prompts, STEPS)
    teng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    got = teng.generate(prompts, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    full = make_prefill_step(tm)({"tokens": torch.tensor(prompts)})
    close(full[:, 0], teng.prefill_logits.numpy(), MODEL_TOL)


def test_serve_main_runs_on_the_cpu(capsys):
    toks = tserve.main(["--device", "cpu", "--arch", SMOKE, "--batch", "2", "--prompt-len", "6",
                        "--gen", "4", "--max-len", "16"])
    assert tuple(toks.shape) == (2, 4)
    assert "on cpu" in capsys.readouterr().out
