"""K2a/K2b's host-side plan: tiles, K2b's cluster size and heads per block,
the grids, and which tiles each block visits and masks. The CUDA kernels are
launched with the plan's grids, K2b's q-tile, cluster size and heads per
block. The walk tests hold ``dq_walk``/``dkv_walk``/``cluster_rows``, the
Python statement of the walk the CUDA source makes, not the kernels: only
``chip_smoke.py`` holds the kernels, against the plain versions on the card.
``test_plan_tiles_match_the_cuda_source`` ties the plan's tiles to the constants
and kernel instances of the CUDA source. On the CPU the dispatch still takes
the plain versions."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.flash_attention_bwd import (DKV_KEYS, DQ_ROWS, FMA_TILE, MAX_CLUSTER,
                                                     bwd_plan, cdiv, cluster_rows, cluster_size,
                                                     dkv_heads, dkv_walk, dq_walk,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_bwd_plain)

CU = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
      / "flash_attention_bwd.cu").read_text()

GS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16]
DTYPES = [torch.bfloat16, torch.float32]
# (Sq, Skv, causal): causal needs Sq == Skv
LENGTHS = [(1, 1, True), (63, 63, True), (64, 64, True), (333, 333, True),
           (1024, 1024, True), (200, 333, False)]
DV = dict(HEAD_DIMS)    # v's head dim of each q/k head dim's instance: 192 -> 128 (MLA)


@pytest.mark.parametrize("g", GS)
def test_cluster_divides_g_and_is_portable(g):
    """c divides G, is at most 8, and is the largest such divisor."""
    c = cluster_size(g)
    assert g % c == 0 and 1 <= c <= MAX_CLUSTER
    assert not any(g % x == 0 for x in range(c + 1, MAX_CLUSTER + 1))
    plan = bwd_plan(2, 128, 128, 4 * g, 4, 64, torch.bfloat16, True)
    assert plan.cluster == c and plan.heads_per_block * c == g


@pytest.mark.parametrize("h,kvh,c", [(32, 4, 8), (48, 8, 6), (32, 8, 4), (32, 32, 1), (16, 1, 8)])
def test_cluster_of_the_zoo(h, kvh, c):
    """tinyllama / yi-6b 8, internvl2-26b 6, mistral-nemo-12b 4, MHA 1, and
    G = 16 walks two heads a block."""
    plan = bwd_plan(1, 256, 256, h, kvh, 64, torch.bfloat16, True)
    assert plan.cluster == c and plan.heads_per_block == h // kvh // c


@pytest.mark.parametrize("c", range(1, MAX_CLUSTER + 1))
def test_cluster_rows_cover_the_tile_once(c):
    """The ranks' row shares cover the 64 keys of a tile exactly once, in
    order, also where c does not divide 64."""
    rows = cluster_rows(c)
    assert len(rows) == c
    assert rows[0][0] == 0 and rows[-1][1] == DKV_KEYS
    assert all(r1 == s0 for (_, r1), (s0, _) in zip(rows, rows[1:]))
    assert all(r1 - r0 in (DKV_KEYS // c, DKV_KEYS // c + 1) for r0, r1 in rows)
    covered = np.zeros(DKV_KEYS, int)
    for r0, r1 in rows:
        covered[r0:r1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("g", GS)
def test_cluster_heads_cover_the_group_once(g):
    """The blocks of a cluster walk the G query heads of their KV head
    exactly once between them."""
    kvh, n_kv = 1, 3
    plan = bwd_plan(1, 128, 128, n_kv * g, n_kv, 64, torch.bfloat16, True)
    heads = [h for r in range(plan.cluster) for h in dkv_heads(plan, kvh, g, r)]
    assert sorted(heads) == list(range(kvh * g, (kvh + 1) * g))


def coverage(plan, kernel):
    """How many times each (query, key) pair is taken, over every block of
    one (batch, head) of ``kernel``, with the masks the plan states; padded
    by a tile on each side so that an unmasked overhang shows."""
    pad = 128
    count = np.zeros((plan.sq + pad, plan.skv + pad), int)
    if kernel == "dq":
        bm, bn = plan.dq_tiles
        for i in range(cdiv(plan.sq, bm)):
            m0, tiles = dq_walk(plan, i)
            q1 = min(m0 + bm, plan.sq)        # rows past Sq: nothing in any tile
            for n0, masked in tiles:
                k1 = min(n0 + bn, plan.skv) if masked else n0 + bn
                block = np.ones((q1 - m0, k1 - n0), bool)
                if masked and plan.causal:
                    block &= np.arange(n0, k1)[None, :] <= np.arange(m0, q1)[:, None]
                count[m0:q1, n0:k1] += block
    else:
        bm, bn = plan.dkv_tiles
        for i in range(cdiv(plan.skv, bn)):
            n0, tiles = dkv_walk(plan, i)
            k1 = min(n0 + bn, plan.skv)       # key rows past Skv: never written
            for m0, masked in tiles:
                q1 = min(m0 + bm, plan.sq) if masked else m0 + bm
                block = np.ones((q1 - m0, k1 - n0), bool)
                if masked and plan.causal:
                    block &= np.arange(n0, k1)[None, :] <= np.arange(m0, q1)[:, None]
                count[m0:q1, n0:k1] += block
    return count


@pytest.mark.parametrize("sq,skv,causal", LENGTHS)
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_walks_cover_each_pair_once(sq, skv, causal, d, dtype, kernel):
    """K2a's key-tile walks and K2b's q-tile walks, with the tiles the plan
    masks, take every (query, key) pair at or below the diagonal exactly
    once, and none above it or outside the lengths (at D = 192, v's head dim
    128: K2a's 32-key tiles and K2b's 16-row steps)."""
    plan = bwd_plan(2, sq, skv, 8, 2, d, dtype, causal, dv=DV[d])
    count = coverage(plan, kernel)
    want = np.zeros_like(count)
    want[:sq, :skv] = 1
    if causal:
        want[:sq, :skv] = np.tril(np.ones((sq, skv), int))
    np.testing.assert_array_equal(count, want)


@pytest.mark.parametrize("sq,skv,causal", LENGTHS)
def test_masks_only_where_needed(sq, skv, causal):
    """bf16: a tile is masked only if it crosses the diagonal (causal) or
    overhangs a length; every fp32 tile is masked (the FMA kernels test each
    element)."""
    plan = bwd_plan(1, sq, skv, 8, 2, 64, torch.bfloat16, causal)
    bm, bn = plan.dq_tiles
    for i in range(cdiv(sq, bm)):
        m0, tiles = dq_walk(plan, i)
        for n0, masked in tiles:
            assert masked == ((causal and n0 + bn - 1 > m0) or n0 + bn > skv)
    fma = bwd_plan(1, sq, skv, 8, 2, 64, torch.float32, causal)
    assert all(m for i in range(cdiv(sq, 32)) for _, m in dq_walk(fma, i)[1])
    assert all(m for i in range(cdiv(skv, 32)) for _, m in dkv_walk(fma, i)[1])


@pytest.mark.parametrize("s", [64, 333, 1024, 4096])
@pytest.mark.parametrize("d", [32, 64, 128, 192])
def test_work_order_is_descending_when_causal(s, d):
    """With causal, both grids hand out the longest blocks first: K2a's grid
    row 0 is the last q-tile, K2b's is key tile 0."""
    plan = bwd_plan(4, s, s, 32, 4, d, torch.bfloat16, True, dv=DV[d])
    dq_work = [len(dq_walk(plan, i)[1]) for i in range(plan.dq_grid[1])]
    dkv_work = [len(dkv_walk(plan, i)[1]) for i in range(plan.dkv_grid[1])]
    assert dq_work == sorted(dq_work, reverse=True)
    assert dkv_work == sorted(dkv_work, reverse=True)
    if s > 64:
        assert dq_work[0] > dq_work[-1] and dkv_work[0] > dkv_work[-1]
    assert dq_walk(plan, 0)[0] == (cdiv(s, 64) - 1) * 64


def test_grids_at_the_training_shape():
    """B=4, S=1024, H=32, KVH=4, D=64: 2048 blocks in each pass; K2b's
    block walks at most 16 q-tiles of its own head (not 8 x 16)."""
    plan = bwd_plan(4, 1024, 1024, 32, 4, 64, torch.bfloat16, True)
    assert plan.dq_grid == (128, 16, 1) and plan.dkv_grid == (128, 16, 1)
    assert (plan.cluster, plan.heads_per_block) == (8, 1)
    assert max(len(dkv_walk(plan, i)[1]) for i in range(16)) * plan.heads_per_block == 16
    assert plan.dkv_grid[0] % plan.cluster == 0


@pytest.mark.parametrize("d,q_tile", [(32, 64), (64, 64), (128, 32), (192, 16)])
def test_dkv_q_tile_by_head_dim(d, q_tile):
    """K2b takes 32-row q-tiles at D=128 (S^T and dP^T in 16 registers each
    beside 128 of accumulators), 16 at (192, 128) (8 each beside 160), 64
    below; K2a 64 x 64 at every D but 192, 64 x 32 there; fp32 32."""
    plan = bwd_plan(2, 1024, 1024, 32, 4, d, torch.bfloat16, True, dv=DV[d])
    assert plan.dkv_tiles == (q_tile, 64)
    assert plan.dq_tiles == (64, 32 if d == 192 else 64)
    fma = bwd_plan(2, 1024, 1024, 32, 4, d, torch.float32, True, dv=DV[d])
    assert fma.dq_tiles == fma.dkv_tiles == (32, 32) and fma.cluster == 1


def cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def cu_instances(pattern: str) -> set[tuple[int, ...]]:
    return {tuple(map(int, m)) for m in re.findall(pattern, CU)}


@pytest.mark.parametrize("d", [32, 64, 128, 192])
def test_plan_tiles_match_the_cuda_source(d):
    """The plan's tiles are the CUDA source's: K2a's DQ_BM rows with a key
    tile, K2b's BN keys with a q-tile, each one that the source has a bf16
    instance for at this (D, Dv) (the instance the entry point picks by the
    plan's tile; K2b's occupancy query has the same ones), MAX_CLUSTER, and
    the fp32 kernels' FT, instantiated at every pair of ``HEAD_DIMS``."""
    dq = cu_instances(r"launch_dq_mma<(\d+), (\d+), (\d+)>\(a, p\)")
    dkv = cu_instances(r"launch_dkv_mma<(\d+), (\d+), (\d+)>\(a, p\)")
    assert dq == {(32, 32, 64), (64, 64, 64), (128, 128, 64), (192, 128, 32)}
    assert dkv == {(32, 32, 64), (64, 64, 64), (128, 128, 32), (192, 128, 16)}
    assert cu_instances(r"dkv_max_clusters<(\d+), (\d+), (\d+)>\(a, p, max_clusters\)") == dkv
    assert cu_instances(r"FN<(\d+), (\d+)>\(a, p\)") == set(HEAD_DIMS)
    plan = bwd_plan(2, 1024, 1024, 32, 4, d, torch.bfloat16, True, dv=DV[d])
    assert plan.dq_tiles[0] == cu_constant("DQ_BM") == DQ_ROWS
    assert (d, DV[d], plan.dq_tiles[1]) in dq
    assert plan.dkv_tiles[1] == cu_constant("BN") == DKV_KEYS
    assert (d, DV[d], plan.dkv_tiles[0]) in dkv
    assert MAX_CLUSTER == cu_constant("MAX_CLUSTER") and FMA_TILE == cu_constant("FT")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,skv,h,kvh,causal", [(1, 333, 333, 12, 2, True),
                                                  (2, 200, 333, 4, 4, False)])
def test_cpu_dispatch_is_plain_version(dtype, b, s, skv, h, kvh, causal):
    """On the CPU the autograd Function's backward is the plain backward,
    bit for bit."""
    rng = np.random.default_rng(s + h)
    d = 32
    q, k, v, dout = (torch.tensor(rng.standard_normal(shape, np.float32)).to(dtype)
                     for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d),
                                   (b, s, h, d)))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention_op(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), dout)
    _, lse = ops.flash_attention_plain(q, k, v, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, out.detach(), lse, dout, causal=causal)
    for x, y in zip(got, want):
        assert x.dtype == dtype and torch.equal(x, y)


@pytest.mark.parametrize("wrapper", [flash_attention_bwd_dq, flash_attention_bwd_dkv])
def test_kernel_wrappers_take_cuda_tensors_only(wrapper):
    """The CUDA wrappers never fall back to the plain version: CPU tensors
    raise."""
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 64, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(q, k, k, q, lse, lse)
