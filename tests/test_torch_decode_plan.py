"""K3's host-side plan: the key tile, the cluster size, the grid, and which
tiles each (rank, warp) of a cluster visits and masks. The CUDA kernel is
launched with the plan's tile, cluster size and grid. The walk tests hold
``decode_walk``, the Python statement of the walk the CUDA source makes, not
the kernel: only ``chip_smoke.py`` holds the kernel, against the plain
version on the card. ``test_plan_constants_match_the_cuda_source`` ties the
plan's constants to the CUDA source. On the CPU the dispatch takes the plain
version, with ``kv_len`` as a host int or as a tensor."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (HEAD_DIMS, MAX_CLUSTER, ROWS, TARGET_BLOCKS,
                                              TILE_KEYS, WARPS, cdiv, decode_plan, decode_walk,
                                              flash_decode, flash_decode_plain)
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

CU = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
      / "flash_decode.cu").read_text()

LENGTHS = [1, 63, 64, 65, 543, 1024, 2048, 32768]
GROUPS = [1, 4, 16, 32, 128, 512]       # B * KVH
PORTABLE_CLUSTER = 8                    # the cluster size every Hopper card launches


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("s", LENGTHS)
def test_walk_covers_the_cache_once_at_every_kv_len(s, groups):
    """For every kv_len in 1..S the (rank, warp) walks of one cluster visit
    each tile that holds a key below kv_len exactly once and no other, each
    walk in ascending order and in its own residue class; only the tile that
    holds kv_len is masked. The grid is the plan's, whatever kv_len."""
    plan = decode_plan(groups, 1, 8, s, 64, torch.bfloat16)
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.warps == WARPS
    assert plan.grid == (groups * plan.cluster, 1, 1)
    t, c = plan.tile, plan.cluster
    pairs = [(r, w) for r in range(c) for w in range(WARPS)]
    for r, w in pairs:
        full = [n0 // t for n0, _ in decode_walk(plan, r, w, s)]
        assert full == sorted(full) and all(i % (c * WARPS) == r + c * w for i in full)
    for kv_len in range(1, s + 1):
        walks = [decode_walk(plan, r, w, kv_len) for r, w in pairs]
        live = cdiv(kv_len, t)
        assert sorted(n0 for walk in walks for n0, _ in walk) == list(range(0, live * t, t))
        masked = [n0 for walk in walks for n0, m in walk if m]
        assert masked == ([(live - 1) * t] if kv_len % t else [])


@pytest.mark.parametrize("max_cluster", [PORTABLE_CLUSTER, MAX_CLUSTER])
@pytest.mark.parametrize("groups", GROUPS)
def test_cluster_fills_the_card_within_bounds(groups, max_cluster):
    """c is the largest size within ``max_cluster`` and one block for every
    WARPS tiles whose grid stays within TARGET_BLOCKS, or 1."""
    for s in LENGTHS:
        plan = decode_plan(groups, 1, 8, s, 64, torch.bfloat16, max_cluster)
        c = plan.cluster
        cap = min(max_cluster, cdiv(plan.tiles, WARPS))
        assert 1 <= c <= cap
        assert c == 1 or groups * c <= TARGET_BLOCKS
        assert c == cap or groups * (c + 1) > TARGET_BLOCKS
        assert plan.grid[0] % c == 0 and plan.grid[0] <= 2 ** 31 - 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_one_plan_for_every_head_dim_and_dtype(d, dtype):
    """32 keys a tile at every head dim in both dtypes (fp32: one a lane):
    the head dim and the dtype pick the kernel instance, not the plan."""
    plan = decode_plan(2, 4, 8, 1000, d, dtype)
    assert plan == decode_plan(2, 4, 8, 1000, 64, torch.bfloat16)
    assert plan.tile == TILE_KEYS == 32 and plan.tiles == cdiv(1000, 32)


def cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def test_plan_constants_match_the_cuda_source():
    """The plan's warps, rows, tile, cluster bound and head dims are the CUDA
    source's."""
    assert WARPS == cu_constant("WARPS") and ROWS == cu_constant("ROWS")
    assert TILE_KEYS == cu_constant("KEYS") and MAX_CLUSTER == cu_constant("MAX_CLUSTER")
    instances = {int(x) for x in re.findall(r"case (\d+): return \(int\)launch<T, \1>\(a\);", CU)}
    assert instances == set(HEAD_DIMS)


@pytest.mark.parametrize("name,shape,cluster,grid", [
    ("serve", (4, 4, 8, 1024, 64), 8, 128),            # tinyllama: B=4, KVH=4, G=8
    ("hybrid", (4, 32, 1, 1024, 64), 2, 256),          # zamba2's shared block: G=1
    ("b8_s2048", (8, 4, 8, 2048, 64), 8, 256),
    ("long", (1, 8, 4, 32768, 128), 16, 128),          # mistral-nemo-12b's heads
])
def test_plans_at_the_timed_shapes(name, shape, cluster, grid):
    """The plans of ``chip_smoke.py``'s timed shapes: about 128-256 blocks,
    the long context's 8 (b, KV head) pairs in clusters of 16. On the card
    ``launch_plan`` shrinks a cluster until all of them fit at once."""
    b, kvh, g, s, d = shape
    plan = decode_plan(b, kvh, g, s, d, torch.bfloat16)
    assert (plan.cluster, plan.grid[0], plan.frags) == (cluster, grid, 1)
    portable = decode_plan(b, kvh, g, s, d, torch.bfloat16, PORTABLE_CLUSTER)
    assert portable.cluster == min(cluster, PORTABLE_CLUSTER)


@pytest.mark.parametrize("g,frags", [(1, 1), (8, 1), (16, 1), (17, 2), (32, 2), (48, 3)])
def test_groups_over_16_heads_take_a_cluster_per_fragment(g, frags):
    """G > 16 query heads a KV head: one cluster per 16-row fragment."""
    plan = decode_plan(2, 2, g, 512, 64, torch.bfloat16)
    assert plan.frags == frags == cdiv(g, ROWS)
    assert plan.grid[0] == 2 * 2 * frags * plan.cluster


def decode_inputs(seed, b, h, kvh, d, s, dtype):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal(shape, np.float32)).to(dtype)
            for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("len_dtype,len_shape", [(torch.int32, ()), (torch.int32, (1,)),
                                                 (torch.int64, ())])
def test_tensor_kv_len_equals_the_host_int_on_the_cpu(len_dtype, len_shape, dtype):
    """On the CPU the dispatch takes ``kv_len`` as a one-element integer
    tensor and gives the host int's result bit for bit."""
    q, k, v = decode_inputs(7, 2, 8, 2, 64, 300, dtype)
    for kv_len in (1, 63, 64, 65, 299, 300):
        t = torch.full(len_shape, kv_len, dtype=len_dtype)
        want = ops.flash_decode_op(q, k, v, kv_len)
        assert torch.equal(ops.flash_decode_op(q, k, v, t), want)
        assert torch.equal(flash_decode_plain(q, k, v, t), want)


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_kv_len():
    """The CUDA wrapper never falls back to the plain version: CPU tensors
    raise, as do a float, a two-element or an out-of-range kv_len."""
    q, k, v = decode_inputs(8, 1, 4, 2, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode(q, k, v, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode(q, k, v, torch.tensor([3], dtype=torch.int32))
    with pytest.raises(TypeError, match="integer"):
        flash_decode(q, k, v, torch.tensor([3.0]))
    with pytest.raises(ValueError, match="one integer"):
        flash_decode(q, k, v, torch.tensor([3, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_len"):
        flash_decode(q, k, v, 65)
