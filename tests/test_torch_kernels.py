"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them) and its jnp oracles,
on identical numpy inputs. On the CPU the port's dispatch takes the plain
versions; the CUDA kernels themselves are held against the same plain versions
on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models.attention import naive_attention as jax_naive_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode_plain
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

# the tolerances of tests/test_kernels.py:14; bf16 carries ~3 decimal digits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(arr, dtype):
    """The same values (rounded to ``dtype`` once, by JAX) on both sides."""
    j = jnp.asarray(arr).astype(JDT[dtype])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def qkv(seed, b, sq, skv, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((b, sq, h, d), np.float32), dtype)
    k = both(rng.standard_normal((b, skv, kvh, d), np.float32), dtype)
    v = both(rng.standard_normal((b, skv, kvh, d), np.float32), dtype)
    return q, k, v


ATTN_SHAPES = [
    (2, 256, 4, 2, 64, True, 128, 128),
    (1, 512, 8, 8, 64, True, 256, 128),
    (2, 256, 4, 1, 32, False, 128, 256),
    (1, 384, 4, 4, 128, True, 128, 128),
    (1, 256, 8, 2, 64, False, 64, 64),
    (2, 256, 12, 2, 64, True, 128, 128),    # G=6, as the card checks K1 at S=333
    (1, 256, 16, 1, 64, True, 128, 128),    # KVH=1: one KV head for every query head
]


@pytest.mark.parametrize("b,s,h,kvh,d,causal,bq,bk", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_pallas_and_ref(b, s, h, kvh, d, causal, bq, bk, dtype):
    (qj, qt), (kj, kt), (vj, vt) = qkv(0, b, s, s, h, kvh, d, dtype)
    got, _ = flash_attention_plain(qt, kt, vt, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, d)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, block_q=bq,
                                    block_kv=bk, interpret=True)
    want = ref.flash_attention_ref(qj, kj, vj, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    # the dispatch takes the same plain version for CPU tensors
    np.testing.assert_array_equal(
        f32(ops.flash_attention_op(qt, kt, vt, causal=causal)), f32(got))


@pytest.mark.parametrize("b,s,h,kvh,d,causal", [
    (2, 256, 4, 2, 64, True),
    (1, 128, 8, 2, 32, False),
    (1, 384, 4, 4, 128, True),
])
def test_flash_attention_lse_is_logsumexp_of_scores(b, s, h, kvh, d, causal):
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, b, s, s, h, kvh, d, "float32")
    _, lse = flash_attention_plain(qt, kt, vt, causal=causal)
    assert lse.shape == (b, s, h) and lse.dtype == torch.float32
    g = h // kvh
    scores = np.einsum("bqhgd,bkhd->bqhgk",
                       np.asarray(qj, np.float64).reshape(b, s, kvh, g, d),
                       np.asarray(kj, np.float64)) * d ** -0.5
    if causal:
        mask = np.tril(np.ones((s, s), bool))
        scores = np.where(mask[None, :, None, None, :], scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    want = (mx[..., 0] + np.log(np.exp(scores - mx).sum(-1))).reshape(b, s, h)
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_length(dtype, causal):
    """S=384 is no multiple of a 256 tile: the Pallas kernel asserts on it, so
    the oracles are the model path's naive attention and the jnp reference."""
    b, s, h, kvh, d = 1, 384, 4, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, b, s, s, h, kvh, d, dtype)
    got = ops.flash_attention_op(qt, kt, vt, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        f32(got), f32(ref.flash_attention_ref(qj, kj, vj, causal=causal)), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        f32(got), f32(jax_naive_attention(qj, kj, vj, causal=causal)), atol=tol, rtol=tol)


def test_flash_attention_refuses_causal_with_unequal_lengths():
    (_, qt), (_, kt), (_, vt) = qkv(3, 1, 64, 128, 4, 2, 32, "float32")
    with pytest.raises(ValueError, match="Sq == Skv"):
        ops.flash_attention_op(qt, kt, vt, causal=True)
    # top-left convention is moot without a mask: non-causal cross lengths run
    (qj, _), (kj, _), (vj, _) = qkv(3, 1, 64, 128, 4, 2, 32, "float32")
    got = ops.flash_attention_op(qt, kt, vt, causal=False)
    np.testing.assert_allclose(
        f32(got), f32(ref.flash_attention_ref(qj, kj, vj, causal=False)), atol=2e-5, rtol=2e-5)


DECODE_SHAPES = [
    (2, 8, 2, 64, 1024, 700, 256),
    (1, 4, 4, 128, 512, 512, 128),
    (4, 16, 2, 64, 2048, 1, 512),
]


def decode_inputs(seed, b, h, kvh, d, s, dtype):
    rng = np.random.default_rng(seed)
    q = both(rng.standard_normal((b, h, d), np.float32), dtype)
    k = both(rng.standard_normal((b, s, kvh, d), np.float32), dtype)
    v = both(rng.standard_normal((b, s, kvh, d), np.float32), dtype)
    return q, k, v


@pytest.mark.parametrize("b,h,kvh,d,s,kv_len,bk", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_vs_pallas_and_ref(b, h, kvh, d, s, kv_len, bk, dtype):
    (qj, qt), (kj, kt), (vj, vt) = decode_inputs(4, b, h, kvh, d, s, dtype)
    got = flash_decode_plain(qt, kt, vt, kv_len)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, d)
    pallas = flash_decode_pallas(qj, kj, vj, kv_len, block_kv=bk, interpret=True)
    want = ref.flash_decode_ref(qj, kj, vj, kv_len)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(f32(ops.flash_decode_op(qt, kt, vt, kv_len)), f32(got))


@pytest.mark.parametrize("b,h,kvh,d,s,kv_len,bk", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_tensor_kv_len_vs_pallas(b, h, kvh, d, s, kv_len, bk, dtype):
    """kv_len as a tensor, the form the reference's kernel reads from SMEM:
    through the dispatch it equals the host-int form bit for bit and the
    Pallas kernel given ``jnp.int32(kv_len)``."""
    (qj, qt), (kj, kt), (vj, vt) = decode_inputs(4, b, h, kvh, d, s, dtype)
    got = ops.flash_decode_op(qt, kt, vt, torch.tensor([kv_len], dtype=torch.int32))
    np.testing.assert_array_equal(f32(got), f32(ops.flash_decode_op(qt, kt, vt, kv_len)))
    pallas = flash_decode_pallas(qj, kj, vj, jnp.int32(kv_len), block_kv=bk, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("kv_len", [1, 63, 700, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_ragged_cache(kv_len, dtype):
    """A cache of 1000 positions is no multiple of any block: the Pallas
    kernel asserts on it, so the oracle is the jnp reference."""
    b, h, kvh, d, s = 2, 8, 2, 64, 1000
    (qj, qt), (kj, kt), (vj, vt) = decode_inputs(5, b, h, kvh, d, s, dtype)
    got = ops.flash_decode_op(qt, kt, vt, kv_len)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        f32(got), f32(ref.flash_decode_ref(qj, kj, vj, kv_len)), atol=tol, rtol=tol)


def test_flash_decode_refuses_bad_kv_len():
    """Out of [1, S] as a host int or a CPU tensor, a float, a float tensor or
    a tensor of more than one element is refused; a one-element int tensor
    is taken, as the reference takes an array."""
    (_, qt), (_, kt), (_, vt) = decode_inputs(6, 1, 4, 2, 32, 64, "float32")
    for bad in (0, 65, torch.tensor(0), torch.tensor([65], dtype=torch.int32)):
        with pytest.raises(ValueError, match="kv_len"):
            ops.flash_decode_op(qt, kt, vt, bad)
    for bad in (3.0, torch.tensor(3.0)):
        with pytest.raises(TypeError, match="integer"):
            ops.flash_decode_op(qt, kt, vt, bad)
    with pytest.raises(ValueError, match="one integer"):
        ops.flash_decode_op(qt, kt, vt, torch.tensor([3, 4]))
    assert torch.equal(ops.flash_decode_op(qt, kt, vt, torch.tensor(3)),
                       ops.flash_decode_op(qt, kt, vt, 3))
