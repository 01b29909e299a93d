"""The port's LanguageModel against the JAX package: for the dense family
parameter counts, forward hidden states and decode logits on converted
parameters, and the port's own prefill-vs-decode agreement; for every
architecture of ``configs.ARCHS`` the port of the reference's three
all-arch tests (forward and loss, a train step, two decode steps)."""
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
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

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


def test_every_family_is_assembled_and_an_unknown_one_refused():
    """Every family of the reference's configs builds; one that no config
    has raises ValueError, as the reference's ``specs`` does."""
    import dataclasses

    assert {c.family for c in tconfigs.ARCHS.values()} == \
        {"dense", "vlm", "moe", "ssm", "hybrid", "audio"}
    assert len(tconfigs.ARCHS) == len(jconfigs.ARCHS) == 10
    for cfg in tconfigs.ARCHS.values():
        LanguageModel(cfg.smoke())
    with pytest.raises(ValueError, match="family 'conv'"):
        LanguageModel(dataclasses.replace(tconfigs.get(SMOKE), family="conv"))


# ---- every architecture: the port of tests/test_models.py:27-74 -------------------------

ARCHS = list(tconfigs.ARCHS)


def arch_batch(cfg, seed=1, b=2, s=64):
    """The batch of tests/test_models.py:13-24 from a numpy seed: tokens as
    labels; a vision front end's 8 patch embeddings; for the audio family 64
    frames and the first 16 tokens. Embeddings are bf16-valued, as the
    reference draws them in bf16."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tokens, "labels": tokens}

    def bf16_valued(shape):
        x = jnp.asarray(rng.standard_normal(shape, np.float32)).astype(jnp.bfloat16)
        return np.asarray(x.astype(jnp.float32))

    if cfg.frontend == "vision":
        out["patch_embeds"] = bf16_valued((b, 8, cfg.d_model))
    if cfg.family == "audio":
        out = {"frames": bf16_valued((b, s, cfg.d_model)), "tokens": tokens[:, :16],
               "labels": tokens[:, :16]}
    return out


def arch_reference_and_port(arch, seed=0):
    """The reference smoke model in fp32 from its own init and the port on
    the same parameters (impl="kernel": the kernels' plain versions on the
    CPU, K5's too). The audio family's reference is its forward with the
    layer scans unrolled (``tests/test_torch_audio.py``): the reference's
    own raises in fp32."""
    from test_torch_audio import UnrolledReference

    cj = jconfigs.get(arch + "-smoke")
    jm = (UnrolledReference if cj.family == "audio" else JaxLM)(cj)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(tconfigs.get(arch + "-smoke"))
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_equal_reference_every_arch(arch):
    """fp32, 1e-4: hidden states (B, S, d), aux and loss, finite."""
    jm, jparams, tm = arch_reference_and_port(arch)
    bt = arch_batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    want_h, want_aux = jm.forward(jparams, jb)
    want_loss = jm.loss(jparams, jb)
    tb = {k: torch.tensor(v) for k, v in bt.items()}
    with torch.no_grad():
        got_h, aux = tm.forward(tb)
        loss = tm.loss(tb)
    assert got_h.shape == (2, bt["tokens"].shape[1], tm.cfg.d_model)
    assert bool(torch.isfinite(got_h).all()) and bool(torch.isfinite(loss))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_changes_the_parameters_every_arch(arch):
    """One make_train_step on the port's own bf16 init (lr 1e-3), K1/K2's
    dispatch beside the naive scan (``scan="naive"``, as ``launch.train``
    builds it): finite loss and gradient norm, the parameters moved."""
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import tree_leaves

    cfg = tconfigs.get(arch + "-smoke")
    model = LanguageModel(cfg, scan="naive").init(torch.Generator().manual_seed(0),
                                                  device="cpu")
    before = [p.detach().clone() for p in tree_leaves(model.params)]
    opt_cfg = OptimConfig(lr=1e-3)
    tb = {k: torch.tensor(v) for k, v in arch_batch(cfg).items()}
    _, _, metrics = make_train_step(model, opt_cfg)(model.params,
                                                    init_opt_state(model.params, opt_cfg), tb)
    assert bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(metrics["grad_norm"]))
    after = tree_leaves(model.params)
    assert not torch.allclose(before[0].float(), after[0].float())


@pytest.mark.parametrize("arch", ARCHS)
def test_two_decode_steps_equal_reference_every_arch(arch):
    """init_cache(2, 32, enc_len=16) in fp32 on both sides, then two decode
    steps of token 1 at positions 0 and 1: logits (2, 1, V) within 1e-4."""
    jm, jparams, tm = arch_reference_and_port(arch)
    jcache = jm.init_cache(2, 32, dtype=jnp.float32, enc_len=16)
    tcache = tm.init_cache(2, 32, enc_len=16)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    tok = np.ones((2, 1), np.int32)
    for pos in (0, 1):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        with torch.no_grad():
            got, _ = tm.decode_step(tcache, torch.tensor(tok), pos)
        assert got.shape == (2, 1, tm.cfg.vocab_size) and bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


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
