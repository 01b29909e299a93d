"""The Mamba-2 layer and the two kernels of the hybrid slice against the JAX
package on identical numpy inputs: ``ssd_scan_plain`` and ``fused_ffn_plain``
against the Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs
them) and the jnp oracles; ``models/ssm.py`` function by function. The CUDA
kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref
from repro.kernels.fused_ffn import fused_ffn_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models.base import init_params as jax_init_params
from repro_torch.kernels import ops
from repro_torch.kernels.fused_ffn import TILE_F, fused_ffn_plain, split_plan
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import LanguageModel, ssm
from repro_torch.models.layers import ffn

# the tolerances of tests/test_kernels.py:14; fused_ffn is held at 5x them
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(arr, dtype="float32"):
    """The same values (rounded to ``dtype`` once, by JAX) on both sides."""
    j = jnp.asarray(arr).astype(JDT[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---- K4: fused_ffn ------------------------------------------------------------------

@pytest.mark.parametrize("t,d,f,bt,bf", [
    (256, 128, 512, 128, 256),
    (512, 256, 1024, 256, 512),
    (128, 64, 256, 128, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_vs_pallas_and_ref(t, d, f, bt, bf, dtype):
    """The shapes and scales of tests/test_kernels.py:56, at 5x the base
    tolerance (fp32 1e-4, bf16 0.1), as the reference holds its kernel."""
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((t, d), np.float32) * 0.5, dtype)
    gj, gt = both(rng.standard_normal((d, f), np.float32) * 0.05, dtype)
    uj, ut = both(rng.standard_normal((d, f), np.float32) * 0.05, dtype)
    dj, dt = both(rng.standard_normal((f, d), np.float32) * 0.05, dtype)
    got = fused_ffn_plain(xt, gt, ut, dt)
    assert got.dtype == TDT[dtype] and got.shape == (t, d)
    tol = 5 * TOL[dtype]
    pallas = fused_ffn_pallas(xj, gj, uj, dj, block_t=bt, block_f=bf, interpret=True)
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(got), f32(ref.fused_ffn_ref(xj, gj, uj, dj)), atol=tol, rtol=tol)
    # the dispatch takes the same plain version for CPU tensors
    np.testing.assert_array_equal(f32(ops.fused_ffn_op(xt, gt, ut, dt)), f32(got))


@pytest.mark.parametrize("t", [1, 4, 16, 333, 2048])
@pytest.mark.parametrize("f", [64, 5632, 8192])
def test_fused_ffn_split_plan_covers_f_with_no_empty_split(t, f):
    """The host-side plan the CUDA kernel relies on: whole F tiles, every
    split non-empty, all of F covered, no split at the prefill shape."""
    n_splits, per = split_plan(t, f)
    tiles = -(-f // TILE_F)
    assert n_splits >= 1 and per >= 1
    assert (n_splits - 1) * per < tiles <= n_splits * per
    if t >= 2048:
        assert n_splits == 1


def test_ffn_fused_equals_plain_kernel_version_and_refuses_grad():
    """``ffn(fused=True)`` flattens to (T, D) and runs K4's dispatch: on the
    CPU exactly its plain version. K4 is forward only, as in the reference:
    with grad on it raises rather than drop the gradient."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 5, 32), np.float32))
    p = {k: torch.tensor(rng.standard_normal(s, np.float32) * 0.1)
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    got = ffn(p, x, fused=True)
    want = fused_ffn_plain(x.reshape(10, 32), p["w_gate"], p["w_up"], p["w_down"]).reshape(2, 5, 32)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ffn(p, x).numpy(), atol=1e-5, rtol=1e-5)
    p["w_up"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ffn(p, x, fused=True)


def test_model_with_fused_ffn_refuses_grad():
    cfg = tconfigs.get("zamba2-1.2b-smoke")
    model = LanguageModel(cfg, impl="naive", fused_ffn=True).init(
        torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="requires grad"):
        model.loss({"tokens": tokens, "labels": tokens})
    with torch.no_grad():                 # serving: no gradient to drop
        h, _ = model.forward({"tokens": tokens})
    assert h.shape == (1, 8, cfg.d_model)


# ---- K5: ssd_scan -------------------------------------------------------------------

def ssd_inputs(seed, b, s, h, p, n, dtype="float32"):
    """The scales of tests/test_kernels.py:83."""
    rng = np.random.default_rng(seed)
    x = both(rng.standard_normal((b, s, h, p), np.float32) * 0.5, dtype)
    dt = both(np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32))))
    a = both(-np.exp(rng.standard_normal((h,), np.float32) * 0.3))
    bm = both(rng.standard_normal((b, s, n), np.float32) * 0.3, dtype)
    cm = both(rng.standard_normal((b, s, n), np.float32) * 0.3, dtype)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 32, 16, 64),
    (1, 128, 2, 64, 32, 32),
    (1, 512, 8, 16, 8, 128),
])
def test_ssd_scan_vs_pallas_and_ref(b, s, h, p, n, chunk):
    """tests/test_kernels.py:76 at its tolerance (atol 2e-4, rtol 2e-3), and
    the final state, which the Pallas kernel drops, against the sequential
    oracle's."""
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct) = ssd_inputs(3, b, s, h, p, n)
    y, st = ssd_scan_plain(xt, dt, at, bt, ct)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n) and st.dtype == torch.float32
    pallas = ssd_scan_pallas(xj, dj, aj, bj, cj, chunk=chunk, interpret=True)
    want, st_want = ref.ssd_chunk_ref(xj, dj, aj, bj, cj)
    np.testing.assert_allclose(f32(y), f32(pallas), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(f32(y), f32(want), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(f32(st), f32(st_want), atol=2e-4, rtol=2e-3)
    got_y, got_st = ops.ssd_scan_op(xt, dt, at, bt, ct)
    assert torch.equal(got_y, y) and torch.equal(got_st, st)


@pytest.mark.parametrize("s", [1, 63, 333])
def test_ssd_scan_ragged_length(s):
    """S no multiple of the kernel's 64-token chunk: the Pallas kernel asserts
    on it, so the oracle is the sequential reference."""
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct) = ssd_inputs(4, 2, s, 4, 32, 16)
    y, st = ops.ssd_scan_op(xt, dt, at, bt, ct)
    want, st_want = ref.ssd_chunk_ref(xj, dj, aj, bj, cj)
    np.testing.assert_allclose(f32(y), f32(want), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(f32(st), f32(st_want), atol=2e-4, rtol=2e-3)


def test_ssd_scan_bf16_inputs_match_the_fp32_oracle_to_bf16():
    """bf16 x, B, C (dt and A fp32, as the model makes them): against the
    sequential oracle on the same bf16 values, y rounded once to bf16."""
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct) = ssd_inputs(5, 2, 200, 4, 32, 16, "bfloat16")
    y, st = ssd_scan_plain(xt, dt, at, bt, ct)
    assert y.dtype == torch.bfloat16
    want, st_want = ref.ssd_chunk_ref(xj.astype(jnp.float32), dj, aj, bj.astype(jnp.float32),
                                      cj.astype(jnp.float32))
    np.testing.assert_allclose(f32(y), f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(f32(st), f32(st_want), atol=2e-4, rtol=2e-3)


def test_ssd_scan_is_forward_only_and_the_naive_scan_trains():
    """K5 has no backward (nor has the reference's kernel): its dispatch
    refuses inputs that require grad on either device, so a Mamba-2 loss
    under impl="kernel" raises; impl="naive" (ssd_chunked) carries the
    gradient to every mixer parameter."""
    (_, xt), (_, dt), (_, at), (_, bt), (_, ct) = ssd_inputs(10, 1, 16, 2, 16, 8)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.ssd_scan_op(xt.requires_grad_(), dt, at, bt, ct)
    cfg = tconfigs.get("mamba2-1.3b-smoke")
    toks = torch.tensor(np.random.default_rng(11).integers(0, 256, (1, 40)))
    batch = {"tokens": toks, "labels": toks}
    model = LanguageModel(cfg, impl="kernel").init(torch.Generator().manual_seed(0),
                                                   dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="requires grad"):
        model.loss(batch)
    naive = LanguageModel(cfg, impl="naive")
    naive.params = model.params
    naive.loss(batch).backward()
    mixer = model.params["layers"]["mixer"]
    for k in ("in_proj", "out_proj", "conv_w", "A_log", "D", "dt_bias", "norm"):
        assert mixer[k].grad is not None and float(mixer[k].grad.abs().sum()) > 0, k


def test_ssd_scan_refuses_mismatched_shapes():
    (_, xt), (_, dt), (_, at), (_, bt), (_, ct) = ssd_inputs(6, 1, 16, 2, 16, 8)
    with pytest.raises(ValueError, match="dt"):
        ops.ssd_scan_op(xt, dt[:, :8], at, bt, ct)
    with pytest.raises(ValueError, match="b_"):
        ops.ssd_scan_op(xt, dt, at, bt, ct[..., :4])


# ---- models/ssm.py ------------------------------------------------------------------

def test_ssd_chunked_matches_reference_and_sequential_oracle():
    """The port of tests/test_kernels.py:93: chunks 16, 32 and 96 (96 = S, 32
    and 16 ragged against nothing, 96 not a power of two), y and final state
    at atol 1e-4 / rtol 1e-3, against the reference's ssd_chunked and the
    token-by-token oracle, from a zero state and from a given one."""
    b, s, h, p, n = 2, 96, 4, 16, 8
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct) = ssd_inputs(7, b, s, h, p, n)
    init = both(np.random.default_rng(8).standard_normal((b, h, p, n), np.float32))
    want, st_want = ref.ssd_chunk_ref(xj, dj, aj, bj, cj)
    want_i, st_want_i = ref.ssd_chunk_ref(xj, dj, aj, bj, cj, initial_state=init[0])
    for chunk in (16, 32, 96):
        got, st = ssm.ssd_chunked(xt, dt, at, bt, ct, chunk)
        rj, rst = jssm.ssd_chunked(xj, dj, aj, bj, cj, chunk=chunk)
        for g, w in ((got, want), (st, st_want), (got, rj), (st, rst)):
            np.testing.assert_allclose(f32(g), f32(w), atol=1e-4, rtol=1e-3)
        got, st = ssm.ssd_chunked(xt, dt, at, bt, ct, chunk, initial_state=init[1])
        np.testing.assert_allclose(f32(got), f32(want_i), atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(f32(st), f32(st_want_i), atol=1e-4, rtol=1e-3)


def test_ssd_chunked_pads_a_ragged_sequence():
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct) = ssd_inputs(9, 1, 50, 2, 16, 8)
    got, st = ssm.ssd_chunked(xt, dt, at, bt, ct, 32)
    rj, rst = jssm.ssd_chunked(xj, dj, aj, bj, cj, chunk=32)
    assert got.shape == (1, 50, 2, 16)
    np.testing.assert_allclose(f32(got), f32(rj), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(f32(st), f32(rst), atol=1e-4, rtol=1e-3)


LAYER_ARCH = "zamba2-1.2b-smoke"


def one_layer(seed=0):
    """One smoke Mamba-2 mixer, fp32, the reference's init converted."""
    cfg_j, cfg_t = jconfigs.get(LAYER_ARCH), tconfigs.get(LAYER_ARCH)
    pj = jax_init_params(jssm.ssm_specs(cfg_j), jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    # A_log, D and dt_bias start at 0/1/0: move them off their init so every
    # term of the layer is exercised
    for k in ("A_log", "D", "dt_bias"):
        pj[k] = pj[k] + jnp.asarray(rng.standard_normal(pj[k].shape, np.float32) * 0.3)
    pj["conv_w"] = pj["conv_w"] * 50.0
    pt = {k: torch.tensor(np.asarray(v)) for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_equals_reference(with_state):
    cfg_j, _, pj, pt = one_layer(1)
    c = cfg_j.d_inner + 2 * cfg_j.ssm_state
    rng = np.random.default_rng(2)
    xj, xt = both(rng.standard_normal((2, 7, c), np.float32))
    sj, st = both(rng.standard_normal((2, cfg_j.ssm_conv - 1, c), np.float32))
    want, want_state = jssm._causal_conv(pj, xj, sj if with_state else None)
    got, got_state = ssm._causal_conv(pt, xt, st if with_state else None)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(f32(got_state), f32(want_state))


def test_split_proj_and_specs_equal_reference():
    cfg_j, cfg_t, pj, pt = one_layer()
    specs_j, specs_t = jssm.ssm_specs(cfg_j), ssm.ssm_specs(cfg_t)
    assert {k: (v.shape, v.axes, v.init) for k, v in specs_t.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in specs_j.items()}
    z = np.arange(2 * (2 * cfg_j.d_inner + 2 * cfg_j.ssm_state + cfg_j.ssm_heads), dtype=np.float32)
    z = z.reshape(2, -1)
    for a, b in zip(ssm._split_proj(cfg_t, torch.tensor(z)), jssm._split_proj(cfg_j, jnp.asarray(z))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scan", ["naive", "kernel"])
def test_mamba2_forward_equals_reference(scan):
    """fp32, one smoke layer, S=80 (no multiple of either chunk length):
    output and both states within 1e-4."""
    cfg_j, cfg_t, pj, pt = one_layer(3)
    xj, xt = both(np.random.default_rng(4).standard_normal((2, 80, cfg_j.d_model), np.float32))
    want, (cs_w, ss_w) = jssm.mamba2_forward(pj, cfg_j, xj)
    got, (cs, ss) = ssm.mamba2_forward(pt, cfg_t, xt, scan=scan)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(cs), f32(cs_w), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(f32(ss), f32(ss_w), atol=1e-4, rtol=1e-4)


def test_mamba2_decode_equals_reference_and_updates_in_place():
    """12 steps in fp32 from random states: output and states within 1e-4;
    the port writes the caller's state tensors in place."""
    cfg_j, cfg_t, pj, pt = one_layer(5)
    rng = np.random.default_rng(6)
    c = cfg_j.d_inner + 2 * cfg_j.ssm_state
    cs_j, cs_t = both(rng.standard_normal((2, cfg_j.ssm_conv - 1, c), np.float32))
    ss_j, ss_t = both(rng.standard_normal((2, cfg_j.ssm_heads, cfg_j.ssm_head_dim,
                                           cfg_j.ssm_state), np.float32))
    conv, state = cs_t.clone(), ss_t.clone()
    for _ in range(12):
        xj, xt = both(rng.standard_normal((2, 1, cfg_j.d_model), np.float32))
        want, (cs_j, ss_j) = jssm.mamba2_decode(pj, cfg_j, xj, cs_j, ss_j)
        got, cs_o, ss_o = ssm.mamba2_decode(pt, cfg_t, xt, conv, state)
        assert cs_o is conv and ss_o is state
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(f32(conv), f32(cs_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(f32(state), f32(ss_j), atol=1e-4, rtol=1e-4)


def test_mamba2_forward_state_continues_in_decode():
    """The states a forward over a prompt returns carry on exactly as if the
    prompt had gone through the decode step token by token (fp32, 1e-4)."""
    _, cfg, _, p = one_layer(7)
    x = torch.tensor(np.random.default_rng(8).standard_normal((1, 40, cfg.d_model), np.float32))
    y_full, (cs, ss) = ssm.mamba2_forward(p, cfg, x, scan="kernel")
    conv = torch.zeros_like(cs)
    state = torch.zeros_like(ss)
    ys = [ssm.mamba2_decode(p, cfg, x[:, t:t + 1], conv, state)[0] for t in range(40)]
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), ss.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(conv.numpy(), cs.numpy(), atol=1e-6, rtol=1e-6)
