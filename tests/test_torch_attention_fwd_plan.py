"""K1's host-side plan (``attn_fwd_plan``) and the Python statement of its
walk (``fwd_walk``): tiles, grid, threads and shared memory tied to the
constants and launch code of ``csrc/flash_attention.cu``, each (query, key)
pair walked once, masks only where the tile needs one, and the wrapper
handing the plan's grid to the C entry point (which refuses any other).
Only ``chip_smoke.py`` holds the kernel itself, on the card."""
import contextlib
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import HEAD_DIMS, attn_fwd_plan, fwd_walk
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

CU = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
      / "flash_attention.cu").read_text()
DTYPES = [torch.bfloat16, torch.float32]
# (Sq, Skv, causal): causal needs Sq == Skv
LENGTHS = [(1, 1, True), (63, 63, True), (64, 64, True), (333, 333, True), (1024, 1024, True),
           (200, 333, False), (448, 1500, False)]


def constant(name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1)


def test_plan_constants_match_the_cuda_source():
    warps = int(constant("MMA_WARPS"))
    assert constant("MMA_BM") == "16 * MMA_WARPS" and 16 * warps == fa.MMA_BM
    assert constant("MMA_THREADS") == "32 * MMA_WARPS" and 32 * warps == fa.MMA_THREADS
    assert int(constant("BM")) == fa.FMA_BM and int(constant("BN")) == fa.KV_TILE
    assert "fwd_stages() { return D <= 64 ? 3 : 2; }" in CU
    assert [fa.fwd_stages(d) for d in (32, 64, 128, 192)] == [3, 3, 2, 2]
    assert ("return ((size_t)(MMA_BM + fwd_stages<D>() * BN) * (D + 8) +\n"
            "          (size_t)fwd_stages<D>() * BN * (DV + 8)) * sizeof(__nv_bfloat16);") in CU
    assert ("(size_t)(BM * D + BN * (D + 1) + BN * DV + BM * (BN + 1) + 3 * BM) * sizeof(float);"
            in CU)
    assert "attn_fwd_fma<D, DV><<<grid, 256, smem, stream>>>" in CU
    assert "attn_fwd_mma<D, DV><<<grid, MMA_THREADS, smem, stream>>>" in CU
    # the grid the C entry accepts is the plan's, and no other
    assert ("return is_bf16 ? dim3(B * H, (Sq + MMA_BM - 1) / MMA_BM, 1) : "
            "dim3((Sq + BM - 1) / BM, H, B);") in CU
    assert "if (grid.x != want.x || grid.y != want.y || grid.z != want.z) return -1;" in CU
    # the kernel reads its q-tile in the plan's order
    assert ("const int m0 = (causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * MMA_BM;"
            in CU)
    assert "const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;" in CU


def test_shared_memory_at_the_sources_figures():
    """flash_attention.cu's comment: (192, 128) takes 111,616 B in bf16
    (two blocks an SM) and 148,736 B in fp32."""
    assert attn_fwd_plan(4, 512, 512, 128, 128, 192, 128, torch.bfloat16, True).smem == 111_616
    assert attn_fwd_plan(1, 333, 333, 4, 1, 192, 128, torch.float32, True).smem == 148_736
    for d, dv in HEAD_DIMS:
        for dt in DTYPES:
            assert attn_fwd_plan(1, 64, 64, 1, 1, d, dv, dt, True).smem <= 227 * 1024


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_grids(dtype):
    plan = attn_fwd_plan(4, 1024, 1024, 32, 4, 64, 64, dtype, True)
    if dtype == torch.bfloat16:
        assert (plan.grid, plan.threads, plan.tiles) == ((128, 16, 1), 128, (64, 64))
        assert plan.descending and fwd_walk(plan, 0)[0] == 1024 - 64
    else:
        assert (plan.grid, plan.threads, plan.tiles) == ((16, 32, 4), 256, (64, 64))
        assert not plan.descending and fwd_walk(plan, 0)[0] == 0
    with pytest.raises(ValueError, match="not supported"):
        attn_fwd_plan(1, 8, 8, 1, 1, 96, 96, dtype, True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq,skv,causal", LENGTHS)
def test_walk_covers_each_pair_once_and_masks_where_needed(sq, skv, causal, dtype):
    """Over the q-tiles, each (query, key) pair with the key at or below the
    query (causal) or any (not causal) lies in exactly one walked tile; a
    bf16 tile is masked exactly where it crosses the diagonal or passes Skv,
    an fp32 one always."""
    plan = attn_fwd_plan(1, sq, skv, 1, 1, 64, 64, dtype, causal)
    bm, bn = plan.tiles
    seen = np.zeros((sq, skv), int)
    rows = set()
    for i in range(plan.grid[1] if not plan.fma else plan.grid[0]):
        m0, tiles = fwd_walk(plan, i)
        rows.add(m0)
        for n0, masked in tiles:
            seen[m0:m0 + bm, n0:n0 + bn] += 1
            needed = (causal and n0 + bn - 1 > m0) or n0 + bn > skv
            assert masked == (needed or plan.fma), (i, n0)
    assert rows == set(range(0, sq, bm))
    want = np.tril(np.ones((sq, skv), int)) if causal else np.ones((sq, skv), int)
    assert (seen[want == 1] == 1).all()
    if causal:       # no tile wholly above the diagonal is walked
        assert seen.sum() < sq * skv or sq <= bm


def test_the_wrapper_launches_the_plans_grid(monkeypatch):
    """``flash_attention`` hands ``attn_fwd_plan``'s grid to the C entry (its
    CUDA checks stood in for, on the CPU)."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(build, "load_library", lambda: types.SimpleNamespace(
        flash_attention_fwd=entry))
    monkeypatch.setattr(build, "check_cuda_tensors", lambda **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa.flash_attention, "launches", fa.flash_attention.launches)
    for dtype in DTYPES:
        q = torch.zeros(2, 333, 6, 64, dtype=dtype)
        k = torch.zeros(2, 333, 2, 64, dtype=dtype)
        fa.flash_attention(q, k, k, causal=True)
        plan = attn_fwd_plan(2, 333, 333, 6, 2, 64, 64, dtype, True)
        assert calls[-1][15:18] == plan.grid


def test_the_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q, causal=True)
