"""K5's host-side plan: which route ``ssd_scan`` takes, and what the mma
route's arithmetic does to the numbers. ``ssd_plan`` sends bf16 at N of 64 or
128 and P of at most 64 to the tensor-core kernel and everything else to the
fp32-FMA kernel; ``test_plan_constants_match_the_cuda_source`` ties the
plan's constants to the CUDA source. ``mma_route_emulation`` states the mma
route's rounding points in fp32 torch (att * dt, the state read by y_inter,
and the state update's W as bf16 hi + lo) and holds them against the JAX
package's sequential oracle at the tolerances ``chip_smoke.py`` holds the
kernel to. The kernels themselves are held against ``ssd_scan_plain`` on the
card by ``chip_smoke.py``; on the CPU the dispatch takes the plain version."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (CHUNK, HEAD_DIMS, MMA_ACC_REGS, MMA_STAGES,
                                          MMA_STATES, MMA_WARPS, ROUTES, SMEM_MAX,
                                          mma_acc_regs, mma_smem_bytes, ssd_plan, ssd_scan,
                                          ssd_scan_plain)

CU = (pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
      / "ssd_scan.cu").read_text()

PS = [16, 32, 64, 128]
NS = [8, 16, 64, 128]
SM_SHARED = 228 * 1024        # shared memory of one H100 SM; each block reserves 1 KB more
# chip_smoke.py's tolerances for K5 on bf16 inputs: y elementwise and by
# relative norm, the fp32 final state at the reference test's own 2e-4 / 2e-3
Y_TOL, Y_REL_NORM, STATE_TOL = (2e-2, 2e-2), 1e-2, (2e-4, 2e-3)


def cu_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_ssd_plan_route(dtype, p, n):
    """mma for bf16 at N of 64 or 128 and P up to 64 (at P = 128 the state
    and y accumulators spill); fma for fp32 and every other shape."""
    want = "mma" if dtype == torch.bfloat16 and n in (64, 128) and p <= 64 else "fma"
    assert ssd_plan(dtype, p, n) == want
    assert (want == "mma") == (dtype == torch.bfloat16 and n in MMA_STATES
                               and mma_acc_regs(p, n) <= MMA_ACC_REGS)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_mma_route_shared_memory_fits_where_it_is_picked(p, n):
    """Wherever the plan picks the mma route its block's shared memory is
    within 227 KB; a head dim it does not instantiate never gets it."""
    if ssd_plan(torch.bfloat16, p, n) == "mma":
        assert mma_smem_bytes(p, n) <= SMEM_MAX
    assert ssd_plan(torch.bfloat16, 48, 64) == "fma"


def test_mma_route_at_the_paths_shape_runs_two_blocks_an_sm():
    """zamba2-1.2b's P = N = 64: 85,504 bytes, so two blocks (each with the
    1 KB the card reserves) share an SM and the 256 blocks of B=4 H=64 run in
    one wave on 132 SMs; mamba2-1.3b's N = 128 takes one block an SM."""
    assert mma_smem_bytes(64, 64) == 85504
    assert 2 * (mma_smem_bytes(64, 64) + 1024) <= SM_SHARED
    assert 2 * (mma_smem_bytes(64, 128) + 1024) > SM_SHARED


def test_plan_constants_match_the_cuda_source():
    """The chunk, the mma route's warps, stages, accumulator cap and
    instances, and the shared-memory limit are the CUDA source's."""
    assert CHUNK == cu_constant("L") and MMA_WARPS == cu_constant("MMA_WARPS")
    assert MMA_STAGES == cu_constant("MMA_STAGES")
    assert MMA_ACC_REGS == cu_constant("MMA_ACC_REGS")
    assert SMEM_MAX == 227 * 1024 and "constexpr int SMEM_MAX = 227 * 1024;" in CU
    states = {int(x) for x in re.findall(r"case (\d+): return run_mma<P, \1>\(", CU)}
    assert states == set(MMA_STATES)
    for route in ("mma", "fma"):
        call = "dispatch_mma_n<" if route == "mma" else "(int)launch<T, "
        heads = {int(x) for x in re.findall(rf"case (\d+): return {re.escape(call)}\1>\(", CU)}
        assert heads == set(HEAD_DIMS), route
    assert "(N == 64 || N == 128) && N * P / MMA_THREADS + P / 2 <= MMA_ACC_REGS" in CU
    assert "ssd_chunk_scan_mma" in CU        # chip_smoke.py's KERNEL_CLASSES: "ssd_chunk_scan"


def tiny_inputs(dtype, s=16, h=2, p=16, n=64):
    x = torch.zeros((1, s, h, p), dtype=dtype)
    dt = torch.zeros((1, s, h))
    a = -torch.ones(h)
    bm = torch.zeros((1, s, n), dtype=dtype)
    return x, dt, a, bm, bm.clone()


@pytest.mark.parametrize("route", [None, "mma", "fma"])
def test_ssd_scan_wrapper_takes_cuda_tensors_only(route):
    """The CUDA wrapper never falls back to the plain version: CPU tensors
    raise, on either route, and count no launch on any route."""
    before = dict(ssd_scan.launches_by_route)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(*tiny_inputs(torch.bfloat16), route=route)
    assert ssd_scan.launches_by_route == before and set(before) == set(ROUTES)


@pytest.mark.parametrize("dtype,p,n,route,match", [
    (torch.bfloat16, 16, 64, "bogus", "one of"),
    (torch.float32, 16, 64, "mma", "bf16"),
    (torch.bfloat16, 16, 16, "mma", "bf16"),
    (torch.bfloat16, 128, 128, "mma", "bf16"),
    (torch.bfloat16, 128, 64, "mma", "bf16"),
])
def test_ssd_scan_wrapper_refuses_a_route_the_shape_cannot_take(dtype, p, n, route, match):
    with pytest.raises(ValueError, match=match):
        ssd_scan(*tiny_inputs(dtype, p=p, n=n), route=route)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [1, 64, 333])
def test_ssd_scan_cpu_dispatch_is_plain_version(dtype, s):
    """On the CPU the dispatch returns ssd_scan_plain bit for bit, at shapes
    the mma route would take on the card (bf16, N=64)."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 16, 64
    x = torch.tensor(rng.standard_normal((b, s, h, p), np.float32) * 0.5).to(dtype)
    dt = torch.tensor(np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32))))
    a = torch.tensor(-np.exp(rng.standard_normal((h,), np.float32) * 0.3))
    bm, cm = (torch.tensor(rng.standard_normal((b, s, n), np.float32) * 0.3).to(dtype)
              for _ in range(2))
    y, st = ops.ssd_scan_op(x, dt, a, bm, cm)
    want_y, want_st = ssd_scan_plain(x, dt, a, bm, cm)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.equal(y, want_y) and torch.equal(st, want_st)


def mma_route_emulation(x, dt, A, b_, c_, lo_term=True):
    """The mma route's arithmetic in fp32 torch, chunk by chunk, with its
    rounding points: Sc = C B^T exact on bf16 inputs; att = Sc exp(seg_i -
    seg_j) dt_j [j <= i] rounded to bf16; y = att x + exp(seg_i) (C
    bf16(state)), rounded to bf16 once; W = B exp(seg_L - seg_j) dt_j as
    bf16 hi + lo (hi alone without ``lo_term``); state <- exp(seg_L) state +
    hi^T x + lo^T x in fp32. Returns ``(y, final state (B,H,P,N))``."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    pad = (-s) % CHUNK
    xf, dtf, bf_, cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in (x, dt, b_, c_))
    tril = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    state = torch.zeros((bsz, h, n, p))
    ys = []
    for c0 in range(0, s + pad, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        xz, dtz, bz, cz = xf[:, sl], dtf[:, sl], bf_[:, sl], cf[:, sl]
        seg = torch.cumsum(dtz * A.float(), dim=1)                       # (B,L,H)
        total = seg[:, -1]                                               # (B,H)
        sc = torch.einsum("bin,bjn->bij", cz, bz)
        decay = torch.exp((seg[:, :, None] - seg[:, None]).masked_fill(
            ~tril[None, :, :, None], float("-inf")))                    # (B,i,j,H)
        att = bf(sc[..., None] * decay * dtz[:, None])
        y = torch.einsum("bijh,bjhp->bihp", att, xz)
        y = y + torch.exp(seg)[..., None] * torch.einsum("bin,bhnp->bihp", cz, bf(state))
        w = bz[:, :, None, :] * (torch.exp(total[:, None] - seg) * dtz)[..., None]  # (B,L,H,N)
        hi = bf(w)
        upd = torch.einsum("bjhn,bjhp->bhnp", hi, xz)
        if lo_term:
            upd = upd + torch.einsum("bjhn,bjhp->bhnp", bf(w - hi), xz)
        state = torch.exp(total)[..., None, None] * state + upd
        ys.append(bf(y))
    return torch.cat(ys, dim=1)[:, :s], state.transpose(-1, -2)


def probe_inputs(seed, dt_kind, n, b=2, s=512, h=8, p=64):
    """The model path's scales (tests/test_torch_ssm.py), x, B and C rounded
    to bf16; dt a softplus of N(0, 1), or Mamba-2's log-uniform [1e-3, 1e-1]
    initialisation, at which the state carries across chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32) * 0.5
    if dt_kind == "softplus":
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32)))
    else:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(np.float32)
    a = -np.exp(rng.standard_normal((h,), np.float32) * 0.3)
    bm = rng.standard_normal((b, s, n), np.float32) * 0.3
    cm = rng.standard_normal((b, s, n), np.float32) * 0.3
    r16 = [np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
           for v in (x, bm, cm)]
    return r16[0], dt, a, r16[1], r16[2]


@pytest.mark.parametrize("dt_kind", ["softplus", "mamba2_init"])
@pytest.mark.parametrize("n", [64, 128])
def test_mma_route_rounding_holds_to_the_oracle(dt_kind, n):
    """The emulated mma route against ``ref.ssd_chunk_ref`` (the token-by-
    token recurrence in fp32) on the same bf16 values: y within 2e-2 +
    2e-2|y| and a relative norm error within 1e-2, the final state within
    2e-4 + 2e-3|s|: the tolerances the kernel is held to on the card, which
    this precision plan leaves unchanged."""
    x, dt, a, bm, cm = probe_inputs(20 + n, dt_kind, n)
    want_y, want_st = ref.ssd_chunk_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    want_y, want_st = np.asarray(want_y), np.asarray(want_st)
    tx, tdt, ta, tb, tc = (torch.tensor(v) for v in (x, dt, a, bm, cm))
    y, st = mma_route_emulation(tx.to(torch.bfloat16), tdt, ta, tb.to(torch.bfloat16),
                                tc.to(torch.bfloat16))
    y, st = y.numpy(), st.numpy()
    np.testing.assert_allclose(y, want_y, atol=Y_TOL[0], rtol=Y_TOL[1])
    assert np.linalg.norm(y - want_y) / np.linalg.norm(want_y) <= Y_REL_NORM
    np.testing.assert_allclose(st, want_st, atol=STATE_TOL[0], rtol=STATE_TOL[1])


@pytest.mark.parametrize("dt_kind", ["softplus", "mamba2_init"])
def test_mma_route_state_needs_the_lo_term(dt_kind):
    """The state update's lo term carries what bf16 drops of W: with it the
    final state is at least 10x closer to the oracle than with hi alone."""
    x, dt, a, bm, cm = probe_inputs(30, dt_kind, 64, s=256, h=4)
    _, want_st = ref.ssd_chunk_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    want_st = np.asarray(want_st)
    args = [torch.tensor(v) for v in (x, dt, a, bm, cm)]
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    err = {lo: np.abs(mma_route_emulation(*args, lo_term=lo)[1].numpy() - want_st).max()
           for lo in (True, False)}
    assert err[True] * 10 <= err[False]
