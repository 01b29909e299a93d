"""K3's partial entry and the combine that serves a sequence-sharded cache:
``flash_decode_partial_plain`` over each shard of a cache split 1, 2, 4 and
8 ways, merged by ``kernels.ops.combine_partials``, against the whole-cache
plain version and the reference's ``decode_attention`` (JAX on the CPU), at
the tolerances of ``tests/test_kernels.py:14``; the shards' lengths
(``shard_kv_len``); and K3's walk at kv_len 0. The CUDA entry itself is
held against the same plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (NEG_INF, decode_plan, decode_walk,
                                              flash_decode_partial, flash_decode_partial_plain,
                                              flash_decode_plain, shard_kv_len)
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

TOL = 2e-5          # fp32, tests/test_kernels.py:14
B, H, KVH, D, S = 2, 8, 2, 32, 64


def inputs(seed: int, b=B, h=H, kvh=KVH, d=D, s=S):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32)
                 for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))


def split_and_combine(q, k, v, kv_len, n: int):
    """The plain partial entry on each of ``n`` sequence shards of the
    cache, each at its own length, merged by ``combine_partials``."""
    s_local = k.shape[1] // n
    parts = [flash_decode_partial_plain(q, k[:, r * s_local:(r + 1) * s_local],
                                        v[:, r * s_local:(r + 1) * s_local],
                                        shard_kv_len(kv_len, r * s_local, s_local))
             for r in range(n)]
    return ops.combine_partials(torch.stack([o for o, _ in parts]),
                                torch.stack([lse for _, lse in parts]))


# kv_len inside shard 0 of every split, in a middle shard, exactly on a shard
# boundary of every split, the cache's last row; all but shard 0 empty at 1
KV_LENS = {"first_row": 1, "inside_shard_0": 5, "middle_shard": 27, "boundary": 32,
           "boundary_of_8": 40, "whole": S}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(KV_LENS))
def test_combined_shards_equal_the_whole_cache_and_the_reference(case, n):
    kv_len = KV_LENS[case]
    qn, kn, vn = inputs(n * 100 + kv_len)
    q, k, v = map(torch.tensor, (qn, kn, vn))
    out, lse = split_and_combine(q, k, v, kv_len, n)
    whole = flash_decode_plain(q, k, v, kv_len)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=TOL, rtol=TOL)
    ref = jax_decode_attention(jnp.asarray(qn)[:, None], jnp.asarray(kn), jnp.asarray(vn), kv_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, 0], atol=TOL, rtol=TOL)
    # the merged lse is the whole cache's: log-sum-exp of the valid scaled scores
    scores = torch.einsum("bhgd,bkhd->bhgk", q.view(B, KVH, H // KVH, D), k) * D ** -0.5
    want_lse = torch.logsumexp(scores[..., :kv_len], dim=-1).reshape(B, H)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kv_len", [0, 1, 17, S])
def test_partial_plain_is_normalised_with_its_lse(kv_len):
    """The partial plain version: out normalised over the first kv_len rows
    (the whole-cache plain version's out where kv_len > 0), lse their
    log-sum-exp; at kv_len 0 out is 0 and lse NEG_INF, which weighs exactly
    0 in a combine."""
    q, k, v = map(torch.tensor, inputs(kv_len))
    out, lse = flash_decode_partial_plain(q, k, v, kv_len)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (B, H, D) and lse.shape == (B, H)
    if kv_len == 0:
        assert not out.any() and bool((lse == NEG_INF).all())
        return
    np.testing.assert_allclose(out.numpy(), flash_decode_plain(q, k, v, kv_len).numpy(),
                               atol=TOL, rtol=TOL)
    assert bool(torch.isfinite(lse).all()) and bool((lse > NEG_INF / 2).all())


def test_an_empty_shard_weighs_nothing():
    """A shard at kv_len 0 beside a full one: the combine gives the full
    one's out and lse to the bit."""
    q, k, v = map(torch.tensor, inputs(3))
    full = flash_decode_partial_plain(q, k, v, S)
    empty = flash_decode_partial_plain(q, k, v, 0)
    out, lse = ops.combine_partials(torch.stack([full[0], empty[0]]),
                                    torch.stack([full[1], empty[1]]))
    assert torch.equal(out, full[0]) and torch.equal(lse, full[1])


def test_partial_op_takes_a_tensor_kv_len_and_refuses_one_past_the_cache():
    q, k, v = map(torch.tensor, inputs(4))
    for kv_len in (0, 9):
        want = ops.flash_decode_partial_op(q, k, v, kv_len)
        got = ops.flash_decode_partial_op(q, k, v, torch.tensor([kv_len], dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match=r"outside \[0, 64\]"):
        ops.flash_decode_partial_op(q, k, v, S + 1)
    with pytest.raises(ValueError, match=r"outside \[1, 64\]"):
        ops.flash_decode_op(q, k, v, 0)


@pytest.mark.parametrize("kv_len,s_local,want", [
    (1, 16, [1, 0, 0, 0]),        # every shard but the first empty
    (16, 16, [16, 0, 0, 0]),      # on the boundary: shard 1 still empty
    (17, 16, [16, 1, 0, 0]),      # one row past it
    (40, 16, [16, 16, 8, 0]),
    (64, 16, [16, 16, 16, 16]),
    (0, 16, [0, 0, 0, 0]),
])
def test_shard_lengths_at_the_boundaries(kv_len, s_local, want):
    got = [shard_kv_len(kv_len, r * s_local, s_local) for r in range(4)]
    assert got == want and sum(got) == kv_len
    as_tensor = [int(shard_kv_len(torch.tensor([kv_len], dtype=torch.int32), r * s_local,
                                  s_local)) for r in range(4)]
    assert as_tensor == want


def test_decode_walk_at_kv_len_zero_visits_no_tile():
    """The partial entry's empty shard: no (rank, warp) of a cluster visits a
    tile, whatever the plan, so every block keeps the empty state."""
    for s in (32, 1024, 32768):
        plan = decode_plan(4, 4, 8, s, 64, torch.bfloat16)
        assert all(decode_walk(plan, r, w, 0) == [] for r in range(plan.cluster)
                   for w in range(plan.warps))
        assert decode_walk(plan, 0, 0, 1) == [(0, True)]


def test_cuda_partial_entry_refuses_cpu_tensors():
    """The partial entry's CUDA wrapper never falls back to the plain
    version."""
    q, k, v = map(torch.tensor, inputs(5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode_partial(q, k, v, 0)
