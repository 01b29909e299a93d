"""The slice as a whole: the port's ServingEngine against the JAX package's,
on converted parameters and the same prompts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch.serve import ServingEngine as JaxEngine
from repro.models import LanguageModel as JaxLM
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import LanguageModel
from repro_torch.serve.step import make_decode_step, make_prefill_step
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

SMOKE = "tinyllama-1.1b-smoke"
BATCH, PROMPT, STEPS, MAX_LEN = 2, 8, 16, 32


def port_model(impl, seed=0):
    jm = JaxLM(jconfigs.get(SMOKE), impl="naive")
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tree = jax.tree.map(lambda a: np.asarray(a), jparams)
    tm = LanguageModel(tconfigs.get(SMOKE), impl=impl)
    tm.load_params(params_from_numpy(tree, torch.float32, "cpu"))
    return jm, jparams, tm


def prompts(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (BATCH, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_generate_greedy_tokens_identical_to_reference(impl):
    """fp32, batch 2, prompt 8, 16 greedy steps: the same token ids. The
    reference engine allocates a bf16 cache whatever the parameters' dtype;
    it is given an fp32 one here so that both sides run in fp32 throughout."""
    jm, jparams, tm = port_model(impl)
    jeng = JaxEngine(jm, jparams, BATCH, MAX_LEN)
    jeng.cache = jm.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
    want = jeng.generate(prompts(), STEPS)

    teng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    assert teng.cache["k"].dtype == torch.float32
    got = teng.generate(prompts(), STEPS)
    assert got.shape == (BATCH, STEPS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert teng.lengths.tolist() == [PROMPT + STEPS] * BATCH
    assert teng.prefill_logits.shape == (BATCH, tm.cfg.vocab_size)


def test_prefill_step_agrees_with_engine_prefill():
    """The full-sequence forward and the token-at-a-time engine give the same
    logits at the last prompt position (fp32, 1e-4)."""
    _, _, tm = port_model("kernel")
    p = prompts(1)
    full = make_prefill_step(tm)({"tokens": torch.tensor(p)})
    eng = tserve.ServingEngine(tm, BATCH, MAX_LEN)
    eng.prefill(p)
    assert full.shape == (BATCH, 1, tm.cfg.vocab_size)
    np.testing.assert_allclose(full[:, 0].numpy(), eng.prefill_logits.numpy(),
                               atol=1e-4, rtol=1e-4)


def test_top_k_sampling_stays_in_the_top_k_and_is_reproducible():
    _, _, tm = port_model("naive")
    top_k = 5
    step = make_decode_step(tm, sample="top_k", temperature=0.8, top_k=top_k)
    tok = torch.tensor(prompts(2)[:, :1])

    def run(seed, n=40):
        gen = torch.Generator().manual_seed(seed)
        cache = tm.init_cache(BATCH, MAX_LEN)
        out = []
        for _ in range(n):    # position 0 again and again: same logits, fresh draws
            nxt, logits = step(cache, tok, 0, gen)
            allowed = torch.topk(logits, top_k, dim=-1).indices
            assert bool((nxt.long() == allowed).any(dim=-1).all())
            out.append(nxt)
        return torch.cat(out, dim=1)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert len(set(a[0].tolist())) > 1      # it does sample, not argmax


def test_engine_refuses_what_does_not_fit():
    _, _, tm = port_model("naive")
    eng = tserve.ServingEngine(tm, BATCH, 12)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts(), 8)
    with pytest.raises(ValueError, match="prompts must be"):
        eng.prefill(prompts()[:1])


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_main_runs_on_the_cpu(impl, capsys):
    toks = tserve.main(["--device", "cpu", "--arch", SMOKE, "--batch", "2",
                        "--prompt-len", "6", "--gen", "4", "--max-len", "16",
                        "--impl", impl])
    assert tuple(toks.shape) == (2, 4)
    assert "tok/s" in capsys.readouterr().out
