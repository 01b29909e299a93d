"""The port's flash-attention backward against the JAX package: the plain
versions of K2a/K2b against the Pallas backward kernels (interpret mode, as
``tests/test_kernels.py`` runs them) and against ``jax.grad`` of the
reference's ``naive_attention``, and the autograd Function that carries K1
forward and K2a/K2b backward, on identical numpy inputs. On the card the CUDA
kernels are held against the same plain versions by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention_bwd import flash_attention_bwd_pallas
from repro.models.attention import naive_attention as jax_naive_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import (attention_delta, check_bwd_inputs,
                                                     flash_attention_bwd_dkv_plain,
                                                     flash_attention_bwd_dq_plain,
                                                     flash_attention_bwd_plain)
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

TOL = 2e-4      # the reference's own tolerance for its backward kernels (fp32)


def inputs(seed, b, sq, skv, h, kvh, d, causal):
    """q, k, v, dout and the forward's out and lse (from the reference), as
    numpy fp32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, skv, kvh, d), np.float32)
    v = rng.standard_normal((b, skv, kvh, d), np.float32)
    dout = rng.standard_normal((b, sq, h, d), np.float32)
    g = h // kvh
    sc = jnp.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, sq, kvh, g, d), k) * d ** -0.5
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((sq, skv), bool))[None, None, None], sc, -1e30)
    lse = jax.nn.logsumexp(sc, axis=-1).transpose(0, 3, 1, 2).reshape(b, sq, h)
    out = jax_naive_attention(q, k, v, causal=causal)
    return q, k, v, dout, np.asarray(out), np.asarray(lse)


def torch_args(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


# tests/test_kernels.py:112-115, then a ragged length, KVH=1 and a non-causal
# cross length; (block_q, block_kv) for the Pallas kernel, which asserts that
# they divide the lengths
SHAPES = [
    (1, 256, 256, 4, 2, 32, True, 64, 64),
    (2, 128, 128, 2, 2, 64, False, 64, 64),
    (1, 333, 333, 4, 2, 32, True, 333, 333),
    (1, 256, 256, 4, 1, 32, True, 128, 128),
    (2, 200, 333, 4, 2, 32, False, 200, 333),
]


@pytest.mark.parametrize("b,sq,skv,h,kvh,d,causal,bq,bk", SHAPES)
def test_plain_backward_vs_pallas_and_autodiff(b, sq, skv, h, kvh, d, causal, bq, bk):
    q, k, v, dout, out, lse = inputs(9, b, sq, skv, h, kvh, d, causal)
    got = flash_attention_bwd_plain(*torch_args(q, k, v, out, lse, dout), causal=causal)
    pallas = flash_attention_bwd_pallas(q, k, v, out, lse, dout, causal=causal,
                                        block_q=bq, block_kv=bk, interpret=True)
    autodiff = jax.grad(lambda q_, k_, v_: (jax_naive_attention(q_, k_, v_, causal=causal)
                                            * dout).sum(), (0, 1, 2))(q, k, v)
    for name, x, p, a in zip(("dq", "dk", "dv"), got, pallas, autodiff):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(p), atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(a), atol=TOL, rtol=TOL, err_msg=name)


def test_per_kernel_plain_versions_split_the_backward():
    q, k, v, dout, out, lse = inputs(1, 2, 96, 96, 8, 2, 32, True)
    args = torch_args(q, k, v, out, lse, dout)
    dq, dk, dv = flash_attention_bwd_plain(*args, causal=True)
    assert torch.equal(flash_attention_bwd_dq_plain(*args, causal=True), dq)
    dk2, dv2 = flash_attention_bwd_dkv_plain(*args, causal=True)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    # delta is rowsum(out * dout), fp32, (B,Sq,H)
    delta = attention_delta(args[3], args[5])
    np.testing.assert_allclose(delta.numpy(), (out * dout).sum(-1), atol=1e-5, rtol=1e-5)


def test_backward_input_checks():
    q, k, v, dout, out, lse = torch_args(*inputs(2, 1, 64, 64, 4, 2, 32, True))
    check_bwd_inputs(q, k, v, out, lse, dout, True)
    with pytest.raises(ValueError, match="lse"):
        check_bwd_inputs(q, k, v, out, lse.double(), dout, True)
    with pytest.raises(ValueError, match="dout"):
        check_bwd_inputs(q, k, v, out, lse, dout[:, :32], True)
    with pytest.raises(ValueError, match="Sq == Skv"):
        check_bwd_inputs(q, k[:, :32], v[:, :32], out, lse, dout, True)


@pytest.mark.parametrize("b,s,skv,h,kvh,d,causal", [
    (2, 320, 320, 4, 2, 16, True),
    (1, 333, 333, 8, 1, 32, True),
    (2, 200, 333, 4, 4, 32, False),
])
def test_autograd_function_equals_autograd_through_plain(b, s, skv, h, kvh, d, causal):
    """On the CPU the Function runs the plain forward and the plain backward;
    its gradients equal autograd through the plain forward (fp32, summation
    order only)."""
    q, k, v, dout, _, _ = inputs(3, b, s, skv, h, kvh, d, causal)
    q1, k1, v1, q2, k2, v2 = (t.requires_grad_() for t in torch_args(q, k, v, q, k, v))
    g_fn = torch.autograd.grad(ops.flash_attention_op(q1, k1, v1, causal=causal),
                               (q1, k1, v1), torch.tensor(dout))
    out2, _ = flash_attention_plain(q2, k2, v2, causal=causal)
    g_ref = torch.autograd.grad(out2, (q2, k2, v2), torch.tensor(dout))
    for x, y in zip(g_fn, g_ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5, rtol=2e-5)


def test_autograd_function_saves_lse_and_does_not_rerun_the_forward(monkeypatch):
    q, k, v, dout, _, _ = inputs(4, 1, 300, 300, 4, 2, 16, True)
    calls = []
    plain = ops.flash_attention_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention_plain", counting)
    qt, kt, vt = (t.requires_grad_() for t in torch_args(q, k, v))
    out = ops.flash_attention_op(qt, kt, vt, causal=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (1, 300, 4) and saved[4].dtype == torch.float32
    np.testing.assert_array_equal(saved[3].detach().numpy(), out.detach().numpy())
    _, want_lse = plain(qt.detach(), kt.detach(), vt.detach(), causal=True)
    np.testing.assert_array_equal(saved[4].numpy(), want_lse.numpy())
    out.backward(torch.tensor(dout))
    assert len(calls) == 1          # the backward read lse; it did not recompute it
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (qt, kt, vt))
