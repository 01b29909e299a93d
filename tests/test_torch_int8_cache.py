"""The int8 KV cache (``core.msm.compose(..., kv_cache_dtype="int8")``)
against the JAX package: the cast a cache write takes, and one decode step
of every family on an int8 cache filled with the same values on both
sides, at smoke size.

The reference writes its int8 cache with ``astype(jnp.int8)``, which
truncates toward zero and saturates; torch's ``.to(torch.int8)`` wraps, so
the port casts through ``models.attention.to_cache_dtype``. The reference
reads the cache with the scores in q's dtype and the weighted sum in bf16
(``src/repro/models/attention.py:339-343``), MLA's absorbed decode with its
softmax weights cast to the cache's dtype (``:505``), and its SSM conv
state comes back from a decode step in the activations' dtype (JAX promotes
it in ``_causal_conv``'s concatenation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.specs as jspecs
from repro.core import msm as jmsm
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import msm
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_partial,
                                              flash_decode_partial_plain, flash_decode_plain)
from repro_torch.launch.specs import StandInMesh, input_specs
from repro_torch.models.attention import decode_attention, to_cache_dtype

from test_torch_models import arch_reference_and_port
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

# one architecture a family: dense, vlm, moe (GQA), MLA, hybrid, ssm, audio
FAMILIES = ["tinyllama-1.1b", "internvl2-26b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "zamba2-1.2b", "mamba2-1.3b", "whisper-base"]
LOGIT_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# a bf16 step fills its int8 cache from [-BF16_SPAN, BF16_SPAN): over all
# of int8's range whisper-base's cross-attention drives its bf16 logits 0.73
# (relative norm) from its own fp32 logits, and no bound would hold the
# arithmetic there
BF16_SPAN = 8
B, S, ENC, POS = 2, 16, 8, 5

CAST_VALUES = [1.7, -1.7, 0.4, -0.9, 126.9, 127.6, -128.7, -129.5, 300.7, -300.2, 1000.0,
               -1e6, float("nan"), float("inf"), float("-inf"), 0.0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_cast_saturates_as_jax(dtype):
    """Fractional, out-of-range, infinite and NaN values cast into an int8
    cache equal JAX's ``astype(jnp.int8)`` of the same values, through the
    cast alone and through a cache-row write."""
    x = jnp.asarray(np.array(CAST_VALUES, np.float32)).astype(dtype)
    want = np.asarray(x.astype(jnp.int8))
    t = torch.tensor(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = to_cache_dtype(t, torch.int8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # torch's own cast wraps where JAX's saturates: the reason for the helper
    assert not np.array_equal(t.float().to(torch.int8).numpy(), want)
    from repro_torch.models.attention import write_cache_row
    cache = torch.zeros(1, 3, len(CAST_VALUES), dtype=torch.int8)
    write_cache_row(cache, 1, t[None])
    np.testing.assert_array_equal(cache[0, 1].numpy(), want)
    assert not cache[0, 0].any() and not cache[0, 2].any()


def rel_norm(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_close(got, want, dtype, what=""):
    """fp32: elementwise within 2e-5. bf16: by relative norm within 2e-2: an
    int8 cache drives the activations far past 1, where an elementwise bound
    would hold bf16's spacing, not the arithmetic."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL[dtype], rtol=0, err_msg=what)
    else:
        rel = rel_norm(got, want)
        assert rel <= LOGIT_ATOL[dtype], (what, rel)


def _fill(rng, shape, dtype, span=128):
    """Seeded values for a cache leaf: int8 in [-span, span), or normal fp32."""
    if dtype == "int8":
        return rng.integers(-span, span, shape).astype(np.int8)
    return (0.5 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_decode_step_on_an_int8_cache_equals_the_reference(arch, dtype):
    """``init_cache(dtype=int8)`` leaf by leaf as the reference's (the SSM
    state fp32), every leaf filled with the same seeded values, one decode
    step at position 5: every int8 leaf comes out equal to the bit (in bf16
    the new row within 1: it truncates bf16 products), the
    float leaves (the SSM state, and the conv state, promoted to the
    parameters' dtype on both sides) and the logits within 2e-5 (fp32
    parameters) or, in bf16 (the int8 leaves from ``BF16_SPAN``), by
    relative norm within 2e-2 (``assert_close``)."""
    jm, jparams, tm = arch_reference_and_port(arch)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tm.load_params(params_from_numpy(
            jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams), tdt, "cpu"))
    jcache = jm.init_cache(B, S, dtype=jnp.int8, enc_len=ENC)
    tcache = tm.init_cache(B, S, dtype=torch.int8, enc_len=ENC)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tcache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
    rng = np.random.default_rng(7)
    span = BF16_SPAN if dtype == "bfloat16" else 128
    values = {k: _fill(rng, v.shape, str(v.dtype), span) for k, v in sorted(jcache.items())}
    jcache = {k: jnp.asarray(v) for k, v in values.items()}
    tcache = {k: torch.tensor(v) for k, v in values.items()}
    tok = rng.integers(0, tm.cfg.vocab_size, (B, 1)).astype(np.int32)

    want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok), jnp.int32(POS))
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got, tcache = tm.decode_step(tcache, torch.tensor(tok), POS)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    assert_close(got.float().numpy(), want, dtype, "logits")
    assert sorted(tcache) == sorted(jcache)
    for k, v in jcache.items():
        assert str(tcache[k].dtype).split(".")[-1] == str(v.dtype), k
        got_k, want_k = tcache[k].float().numpy(), np.array(v.astype(jnp.float32))
        if v.dtype == jnp.int8 and dtype == "bfloat16":
            # the new row truncates bf16 products that may lie one rounding
            # step apart, across an integer: within 1 there, equal elsewhere
            row = [slice(None)] * got_k.ndim
            row[2] = POS                                # (L, B, S, ...)
            np.testing.assert_allclose(got_k[tuple(row)], want_k[tuple(row)], atol=1, rtol=0)
            got_k[tuple(row)] = want_k[tuple(row)] = 0
            np.testing.assert_array_equal(got_k, want_k, err_msg=k)
        elif v.dtype == jnp.int8:
            np.testing.assert_array_equal(got_k, want_k, err_msg=k)
        else:
            # the SSM state and the promoted conv state hold products' values
            assert k == "ssm" or (k == "conv" and v.dtype == jdt), k
            assert_close(got_k, want_k, dtype, k)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_both_impls_read_an_int8_cache_as_the_reference(impl):
    """The dense family's decode step under either ``impl``: the naive
    ``decode_attention`` and K3's plain version take the same arithmetic."""
    jm, jparams, tm = arch_reference_and_port("granite-3-2b")
    tm.impl = impl
    rng = np.random.default_rng(3)
    jcache = jm.init_cache(B, S, dtype=jnp.int8)
    values = {k: _fill(rng, v.shape, "int8") for k, v in sorted(jcache.items())}
    tok = rng.integers(0, tm.cfg.vocab_size, (B, 1)).astype(np.int32)
    want, _ = jm.decode_step(jparams, {k: jnp.asarray(v) for k, v in values.items()},
                             jnp.asarray(tok), jnp.int32(POS))
    with torch.no_grad():
        got, _ = tm.decode_step({k: torch.tensor(v) for k, v in values.items()},
                                torch.tensor(tok), POS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_plain_decode_versions_take_an_int8_cache():
    """K3's plain versions against the reference's ``decode_attention`` on an
    int8 cache (q bf16 and fp32), and the partial entry combined over two
    halves of the cache; K3's CUDA entries refuse an int8 cache before they
    look for a card."""
    from repro.models.attention import decode_attention as jdecode
    from repro_torch.kernels.ops import combine_partials

    rng = np.random.default_rng(11)
    b, s, h, kvh, d, kv_len = 2, 24, 8, 2, 16, 19
    k = rng.integers(-128, 128, (b, s, kvh, d)).astype(np.int8)
    v = rng.integers(-128, 128, (b, s, kvh, d)).astype(np.int8)
    for dtype in ("float32", "bfloat16"):
        q = jnp.asarray(0.05 * rng.standard_normal((b, 1, h, d), np.float32)).astype(dtype)
        want = np.asarray(jdecode(q, jnp.asarray(k), jnp.asarray(v), kv_len).astype(jnp.float32))
        tq = torch.tensor(np.asarray(q.astype(jnp.float32))).to(getattr(torch, dtype))
        tk, tv = torch.tensor(k), torch.tensor(v)
        naive = decode_attention(tq, tk, tv, kv_len)
        assert naive.dtype == torch.bfloat16            # the reference's int8 branch
        assert_close(naive.float().numpy(), want, dtype, "naive")
        whole = flash_decode_plain(tq[:, 0], tk, tv, kv_len)
        assert_close(whole.float().numpy(), want[:, 0], dtype, "whole")
        parts = [flash_decode_partial_plain(tq[:, 0], tk[:, i:i + 12], tv[:, i:i + 12],
                                            min(max(kv_len - i, 0), 12)) for i in (0, 12)]
        out, _ = combine_partials(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]))
        # each half's sum rounded to bf16 before the combine
        assert_close(out.numpy(), want[:, 0], "bfloat16", "combined halves")
        for entry in (flash_decode, flash_decode_partial):
            with pytest.raises(TypeError, match="bf16 or fp32"):
                entry(tq[:, 0], tk, tv, kv_len)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-base"])
def test_input_specs_build_an_int8_cache_as_the_reference(arch, monkeypatch):
    """A decode cell under ``compose("msm_decode", kv_cache_dtype="int8")``:
    every cache leaf's shape and dtype equal the reference's ``input_specs``
    under the same policy (int8, the SSM state fp32), on a (2, 2) stand-in."""
    from jax.sharding import AbstractMesh, NamedSharding
    import types

    from repro.sharding import partition as jpartition

    abstract = AbstractMesh((2, 2), ("data", "model"))
    for mod in (jspecs, jpartition):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: NamedSharding(abstract, spec))
    ref_mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 2)))
    shape = tconfigs.SHAPES["decode_32k"]
    smoke = arch + "-smoke"
    _, _, jargs, _ = jspecs.input_specs(smoke, "decode_32k", ref_mesh,
                                        jmsm.compose("msm_decode", kv_cache_dtype="int8"))
    kind, _, args, _ = input_specs(smoke, shape, StandInMesh((2, 2)),
                                   msm.compose("msm_decode", kv_cache_dtype="int8"))
    assert kind == "decode"
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in args[1].items()}
    assert got == {k: (v.shape, str(v.dtype)) for k, v in jargs[1].items()}
    assert any(dt == "int8" for _, dt in got.values())
    assert jconfigs.get(smoke).family == tconfigs.get(smoke).family
