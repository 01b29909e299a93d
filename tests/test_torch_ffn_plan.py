"""K4's host-side plan: which route ``fused_ffn`` takes, and the row chunks
of h the tiled route walks. The CUDA kernels rely on it (whole 128-row tiles,
every row of x in one chunk, the chunk's scratch within 16 MiB); on the CPU
the dispatch still takes the plain version. The kernels themselves are held
against ``fused_ffn_plain`` on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_ffn import (H_CHUNK_BYTES, TILE_F, TILED_MIN_T, TILED_ROWS,
                                           chunk_spans, ffn_plan, fused_ffn, fused_ffn_plain,
                                           round_up, tiled_chunk_rows)

TS = [1, 4, 255, 256, 333, 1025, 2048, 8192]
FS = [1000, 5632, 8192]


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("f", FS)
def test_ffn_plan_route(t, f):
    """Tiled for bf16 from TILED_MIN_T rows; row tiles below it and for fp32."""
    route, rows = ffn_plan(t, f, torch.bfloat16)
    assert route == ("tiled" if t >= TILED_MIN_T else "rowtile")
    assert (rows is None) == (route == "rowtile")
    assert ffn_plan(t, f, torch.float32) == ("rowtile", None)


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("f", FS)
def test_ffn_plan_chunks_cover_t_in_whole_tiles(t, f):
    """The chunks cover [0, T) in order, none empty, each of chunk_rows but
    the last; chunk_rows is a multiple of 128 and no larger than T needs."""
    _, rows = ffn_plan(t, f, torch.bfloat16)
    if t < TILED_MIN_T:                    # the rows a tiled route forced by route= takes
        rows = tiled_chunk_rows(t, f)
    assert rows > 0 and rows % TILED_ROWS == 0
    assert rows <= round_up(t, TILED_ROWS)
    spans = chunk_spans(t, rows)
    assert spans[0][0] == 0
    assert all(n > 0 for _, n in spans)
    assert all(a + n == b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] == t
    assert all(n == rows for _, n in spans[:-1])


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("f", FS)
def test_ffn_plan_scratch_within_16_mib(t, f):
    """The (chunk_rows, round_up(F, 64)) bf16 scratch is at most 16 MiB
    whatever T, and smaller than one (T x F) bf16 tensor wherever that
    tensor would exceed 16 MiB."""
    route, rows = ffn_plan(t, f, torch.bfloat16)
    if route == "rowtile":
        return
    scratch = rows * round_up(f, TILE_F) * 2
    assert scratch <= H_CHUNK_BYTES
    if t * f * 2 > H_CHUNK_BYTES:
        assert scratch < t * f * 2
    if (t, f) in ((2048, 8192), (8192, 8192)):   # zamba2-1.2b's prefill and 4x it
        assert rows == 1024 and len(chunk_spans(t, rows)) == t // 1024


@pytest.mark.parametrize("t", TS)
def test_fused_ffn_cpu_dispatch_is_plain_version(t):
    """On the CPU the dispatch returns fused_ffn_plain bit for bit, on either
    side of the route threshold."""
    rng = np.random.default_rng(t)
    d, f = 8, 1000
    x = torch.tensor(rng.standard_normal((t, d), np.float32)).to(torch.bfloat16)
    wg, wu = (torch.tensor(rng.standard_normal((d, f), np.float32) * 0.3).to(torch.bfloat16)
              for _ in range(2))
    wd = torch.tensor(rng.standard_normal((f, d), np.float32) * 0.03).to(torch.bfloat16)
    got = ops.fused_ffn_op(x, wg, wu, wd)
    assert got.dtype == torch.bfloat16 and got.shape == (t, d)
    assert torch.equal(got, fused_ffn_plain(x, wg, wu, wd))


@pytest.mark.parametrize("route", [None, "tiled", "rowtile"])
def test_fused_ffn_wrapper_takes_cuda_tensors_only(route):
    """The CUDA wrapper never falls back to the plain version: CPU tensors
    raise, on either route."""
    x, wg, wu, wd = (torch.zeros(s, dtype=torch.bfloat16)
                     for s in ((256, 128), (128, 512), (128, 512), (512, 128)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ffn(x, wg, wu, wd, route=route)


@pytest.mark.parametrize("dtype,route,match", [
    (torch.bfloat16, "bogus", "one of"),
    (torch.float32, "tiled", "bf16"),
])
def test_fused_ffn_wrapper_refuses_a_route_it_has_not(dtype, route, match):
    x, wg, wu, wd = (torch.zeros(s, dtype=dtype)
                     for s in ((256, 128), (128, 512), (128, 512), (512, 128)))
    with pytest.raises(ValueError, match=match):
        fused_ffn(x, wg, wu, wd, route=route)
