"""Layer and attention functions of the port against the JAX package on
identical numpy inputs. fp32 at 3e-5: the two frameworks sum in different
orders, nothing else differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers

TOL = 3e-5


def rng(seed=0):
    return np.random.default_rng(seed)


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x)).to(dtype)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_rmsnorm():
    r = rng(1)
    x = r.standard_normal((2, 7, 64), np.float32) * 3
    scale = r.standard_normal(64).astype(np.float32)
    close(tlayers.rmsnorm({"scale": t(scale)}, t(x), 1e-5),
          jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))
    # bf16 in -> bf16 out, fp32 inside: one bf16 rounding of the result
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tlayers.rmsnorm({"scale": t(scale)}, t(xb.astype(jnp.float32), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got, jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xb), 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_apply_rope(theta):
    r = rng(2)
    x = r.standard_normal((2, 9, 4, 16), np.float32)
    pos = r.integers(0, 64, (2, 9)).astype(np.int32)
    close(tlayers.rope_frequencies(16, theta), jlayers.rope_frequencies(16, theta), 1e-6)
    close(tlayers.apply_rope(t(x), t(pos, torch.int32), theta),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def ffn_params(r, d, f):
    return {k: (r.standard_normal(s, np.float32) / np.sqrt(s[0])).astype(np.float32)
            for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}


def test_ffn_fp32():
    r = rng(3)
    p = ffn_params(r, 64, 128)
    x = r.standard_normal((2, 5, 64), np.float32)
    close(tlayers.ffn({k: t(v) for k, v in p.items()}, t(x)),
          jlayers.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_ffn_bf16_pins_the_cast_order():
    """silu(g) is rounded to bf16 BEFORE the product with u. Against the
    reference the port agrees to bf16 rounding of the matmuls; against a
    variant that multiplies in fp32 first it must differ, or the test would
    not see the order."""
    r = rng(4)
    p = ffn_params(r, 64, 128)
    x = r.standard_normal((4, 16, 64), np.float32) * 2
    pj = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pt = {k: t(v.astype(jnp.float32), torch.bfloat16) for k, v in pj.items()}
    xt = t(xj.astype(jnp.float32), torch.bfloat16)
    got = tlayers.ffn(pt, xt)
    assert got.dtype == torch.bfloat16
    close(got, jlayers.ffn(pj, xj), 2e-2)
    # the hidden state itself, where the order shows, bit for bit
    g, u = xt @ pt["w_gate"], xt @ pt["w_up"]
    gj = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    uj = jnp.asarray(u.float().numpy()).astype(jnp.bfloat16)
    want_h = jax.nn.silu(gj.astype(jnp.float32)).astype(jnp.bfloat16) * uj
    got_h = torch.nn.functional.silu(g.float()).to(torch.bfloat16) * u
    late = (torch.nn.functional.silu(g.float()) * u.float()).to(torch.bfloat16)
    # silu's last fp32 bit may differ between the frameworks and flip a bf16
    # rounding: allow a handful of 1-ulp differences, no more
    ulp_off = (got_h.float().numpy() != np.asarray(want_h.astype(jnp.float32))).mean()
    assert ulp_off < 0.01
    assert (late != got_h).float().mean() > 0.05


@pytest.mark.parametrize("tied", [False, True])
def test_embed_and_logits(tied):
    r = rng(5)
    p = {"embedding": r.standard_normal((50, 16), np.float32)}
    if not tied:
        p["lm_head"] = r.standard_normal((16, 50), np.float32)
    tok = r.integers(0, 50, (2, 6)).astype(np.int32)
    h = r.standard_normal((2, 6, 16), np.float32)
    pt, pj = {k: t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}
    close(tlayers.embed(pt, t(tok, torch.int64)), jlayers.embed(pj, jnp.asarray(tok)), 0)
    close(tlayers.logits_for_tokens(pt, t(h)), jlayers.logits_for_tokens(pj, jnp.asarray(h)))
    assert tlayers.unembed_weight(pt).shape == (16, 50)


def attn_inputs(r, b, sq, skv, h, kvh, d):
    return (r.standard_normal((b, sq, h, d), np.float32),
            r.standard_normal((b, skv, kvh, d), np.float32),
            r.standard_normal((b, skv, kvh, d), np.float32))


@pytest.mark.parametrize("causal,q_offset,kv_len", [
    (True, 0, None), (False, 0, None), (True, 5, None), (True, 0, 9),
    (False, 0, 3), (True, 7, 12),
])
def test_naive_attention(causal, q_offset, kv_len):
    q, k, v = attn_inputs(rng(6), 2, 8, 16, 4, 2, 16)
    close(tattn.naive_attention(t(q), t(k), t(v), causal=causal, q_offset=q_offset,
                                kv_len=kv_len),
          jattn.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, q_offset=q_offset, kv_len=kv_len))


@pytest.mark.parametrize("kv_len", [1, 11, 32])
def test_decode_attention(kv_len):
    q, k, v = attn_inputs(rng(7), 2, 1, 32, 8, 2, 16)
    close(tattn.decode_attention(t(q), t(k), t(v), kv_len),
          jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))


def gqa_params(r, cfg):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d)}
    return {k: (r.standard_normal(s, np.float32) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("b,s,timpl,jimpl", [(2, 12, "naive", "naive"),
                                             (2, 12, "kernel", "pallas"),
                                             (1, 512, "kernel", "pallas")])
def test_gqa_attention(b, s, timpl, jimpl):
    """At S=512 both sides are past the Sq <= 256 shortcut: the reference runs
    its Pallas kernel (interpret mode on the CPU), the port its dispatch. Rope
    angles reach 511 rad there, where 1 ulp of a frequency is 3e-5 rad: 1e-4."""
    r = rng(8)
    cfg_j, cfg_t = jconfigs.get("tinyllama-1.1b-smoke"), tconfigs.get("tinyllama-1.1b-smoke")
    p = gqa_params(r, cfg_t)
    x = r.standard_normal((b, s, cfg_t.d_model), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    got = tattn.gqa_attention({k: t(v) for k, v in p.items()}, cfg_t, t(x),
                              t(pos, torch.int32), impl=timpl)
    want = jattn.gqa_attention({k: jnp.asarray(v) for k, v in p.items()}, cfg_j,
                               jnp.asarray(x), jnp.asarray(pos), impl=jimpl)
    close(got, want, 1e-4 if s > 256 else TOL)


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_gqa_decode(impl):
    """Three steps into a cache; the port writes the cache in place, the
    reference returns a new one. The reference's gqa_decode ignores ``impl``
    and always takes decode_attention, the oracle for both port paths."""
    r = rng(9)
    cfg_j, cfg_t = jconfigs.get("tinyllama-1.1b-smoke"), tconfigs.get("tinyllama-1.1b-smoke")
    p = gqa_params(r, cfg_t)
    pt, pj = {k: t(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()}
    shape = (2, 16, cfg_t.n_kv_heads, cfg_t.head_dim)
    k0 = r.standard_normal(shape, np.float32)
    v0 = r.standard_normal(shape, np.float32)
    ck_t, cv_t = t(k0), t(v0)
    ck_j, cv_j = jnp.asarray(k0), jnp.asarray(v0)
    for pos in (3, 4, 5):
        x = r.standard_normal((2, 1, cfg_t.d_model), np.float32)
        got, rk, rv = tattn.gqa_decode(pt, cfg_t, t(x), ck_t, cv_t, pos, impl=impl)
        want, ck_j, cv_j = jattn.gqa_decode(pj, cfg_j, jnp.asarray(x), ck_j, cv_j, pos)
        assert rk is ck_t and rv is cv_t
        close(got, want)
        close(ck_t, ck_j)
        close(cv_t, cv_j)


def test_unknown_impl_is_refused():
    q, k, v = (t(a) for a in attn_inputs(rng(10), 1, 4, 4, 2, 2, 8))
    with pytest.raises(ValueError, match="impl"):
        tattn.sdpa(q, k, v, causal=True, impl="pallas")
