"""The dense LanguageModel of the port against the JAX package: parameter
counts, forward hidden states and decode logits on converted parameters, and
the port's own prefill-vs-decode agreement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.base import count_params as jax_count_params
from repro_torch.convert import params_from_numpy
from repro_torch.models import LanguageModel
from repro_torch.models.base import P, count_params
from repro_torch.models.layers import logits_for_tokens

DENSE = ["tinyllama-1.1b", "yi-6b", "mistral-nemo-12b", "granite-3-2b"]
SMOKE = "tinyllama-1.1b-smoke"


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def reference_and_port(impl_j, impl_t, seed=0):
    """The reference model with fp32 parameters from its own init, and the
    port holding the same parameters through the converter."""
    jm = JaxLM(jconfigs.get(SMOKE), impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(tconfigs.get(SMOKE), impl=impl_t)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_count_params_equals_reference(arch, smoke):
    name = arch + ("-smoke" if smoke else "")
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
    assert count_params(LanguageModel(ct).specs()) == jax_count_params(JaxLM(cj).specs())
    assert LanguageModel(ct).axes() == JaxLM(cj).axes()


def test_converter_keeps_keys_and_shapes():
    jm, jparams, tm = reference_and_port("naive", "naive")
    flat_j = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {"".join(f"['{s}']" for s in k.split(".")): tuple(v.shape)
              for k, v in tm.params.state_dict().items()}
    assert flat_t == flat_j
    with pytest.raises(TypeError, match="float32"):
        params_from_numpy({"a": np.zeros(3, np.float64)}, torch.float32, "cpu")


@pytest.mark.parametrize("s,impl_j,impl_t", [(12, "naive", "naive"),
                                             (512, "pallas", "kernel")])
def test_forward_hidden_states_equal_reference(s, impl_j, impl_t):
    """fp32, 1e-4: at S=512 both sides are past the Sq <= 256 shortcut, the
    reference in its Pallas kernel (interpret mode), the port in its dispatch
    (plain version on the CPU)."""
    jm, jparams, tm = reference_and_port(impl_j, impl_t)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, s)).astype(np.int32)
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux = tm.forward({"tokens": torch.tensor(tokens)})
    assert got.shape == (2, s, tm.cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_decode_logits_equal_reference(impl_t):
    """12 teacher-forced steps in fp32 with fp32 caches on both sides."""
    jm, jparams, tm = reference_and_port("naive", impl_t)
    b, s = 2, 12
    tokens = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (b, s)).astype(np.int32)
    jcache = jm.init_cache(b, 16, dtype=jnp.float32)
    tcache = tm.init_cache(b, 16)
    assert tcache["k"].shape == jcache["k"].shape and tcache["k"].dtype == torch.float32
    for t in range(s):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                      jnp.int32(t))
        with torch.no_grad():
            got, same = tm.decode_step(tcache, torch.tensor(tokens[:, t:t + 1]), t)
        assert same is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_prefill_matches_decode_dense(impl):
    """The port's own teacher-forced decode reproduces its forward logits, in
    bf16 at the reference test's tolerance (atol 0.25 / rtol 0.05)."""
    cfg = tconfigs.get(SMOKE)
    model = LanguageModel(cfg, impl=impl).init(torch.Generator().manual_seed(0), device="cpu")
    assert model.dtype == torch.bfloat16
    b, s = 1, 12
    tokens = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        h, _ = model.forward({"tokens": tokens})
        full = logits_for_tokens(model.params["emb"], h)
        cache = model.init_cache(b, s)
        dec = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0]
                         for t in range(s)], dim=1)
    assert torch.allclose(full.float(), dec.float(), atol=0.25, rtol=0.05)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_own_init_shapes_dtypes_and_std(dtype):
    cfg = tconfigs.get(SMOKE)
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(1), dtype=dtype, device="cpu")

    def walk(specs, params, path=""):
        for k, v in specs.items():
            if not isinstance(v, P):
                walk(v, params[k], f"{path}.{k}")
                continue
            x = params[k]
            assert tuple(x.shape) == v.shape and x.dtype == dtype, f"{path}.{k}"
            x = x.detach().float()
            if v.init == "ones":
                assert bool((x == 1).all())
            elif v.init == "small":
                assert abs(float(x.std()) - 0.006) < 0.0006, f"{path}.{k}"
            else:
                want = v.shape[-2] ** -0.5
                assert abs(float(x.std()) - want) < 0.1 * want, f"{path}.{k}"

    walk(model.specs(), model.params)
    # same seed, same parameters; another seed, others
    again = LanguageModel(cfg).init(torch.Generator().manual_seed(1), dtype=dtype, device="cpu")
    other = LanguageModel(cfg).init(torch.Generator().manual_seed(2), dtype=dtype, device="cpu")
    w = lambda m: m.params["layers"]["attn"]["wq"]
    assert torch.equal(w(model), w(again)) and not torch.equal(w(model), w(other))


@pytest.mark.parametrize("arch,item", [("whisper-base", "item 11")])
def test_other_families_name_their_roadmap_item(arch, item):
    """What is not ported raises, and says where it is queued: the
    encoder-decoder family. The port has no config for it yet, so the
    reference's schema is copied."""
    cj = jconfigs.get(arch).smoke()
    fields = tconfigs.ModelConfig.__dataclass_fields__
    ct = tconfigs.ModelConfig(**{f: getattr(cj, f) for f in fields})
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        LanguageModel(ct)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_init_scales_in_place_to_the_same_bits(dtype):
    """``init_params`` scales each fp32 draw in place: for one leaf of each
    init kind, the same tensors bit for bit as drawing in sorted-path order
    and taking ``(x * std).to(dtype)``."""
    import math

    from repro_torch.models.base import init_params

    specs = {"a_normal": P((6, 5), ("embed", "ff")),
             "b_small": P((7, 4), ("vocab", "embed"), init="small"),
             "c_scaled": P((3, 8, 2), ("layers", "embed", "ff"), scale=0.37),
             "d_zeros": P((4,), ("embed",), init="zeros"),
             "e_ones": P((4,), ("embed",), init="ones"),
             "f_vector": P((9,), ("embed",))}
    got = init_params(specs, torch.Generator().manual_seed(11), dtype, "cpu")
    gen = torch.Generator().manual_seed(11)
    for name in sorted(specs):
        p = specs[name]
        if p.init in ("zeros", "ones"):
            want = (torch.zeros if p.init == "zeros" else torch.ones)(p.shape, dtype=dtype)
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            std = 0.006 if p.init == "small" else (p.scale or 1.0 / math.sqrt(fan_in))
            x = torch.randn(p.shape, generator=gen, dtype=torch.float32)
            want = (x * std).to(dtype)
        assert got[name].dtype == dtype and torch.equal(got[name], want), name
