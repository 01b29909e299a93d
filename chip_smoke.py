#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py            # one NVIDIA Hopper card, nvcc, no network

Phases, one JSON object a line:
  env      the card (name, power limit), torch / CUDA / nvcc versions
  build    builds the CUDA kernels from src/repro_torch/csrc and loads them,
           with each kernel's registers and spill bytes as ptxas reports them
           (template instances named by their arguments, e.g.
           attn_bwd_dkv_mma<128,32>)
  occupancy  cudaOccupancyMaxActiveClusters of K2b's cluster launch at the
           training shape, with its plan
  checks   every kernel against its plain PyTorch version on the card, over
           the serving path's shapes and the awkward ones (ragged lengths,
           D=128, KVH=H, non-causal, fp32), with device times (CUDA-graph
           replay), eager call times and roofline bounds
           and, for the training path, K1 and the backward kernels K2a (dq)
           and K2b (dk, dv) at the training shape and the awkward ones (also
           G=6 and G=16, K2b's clusters of 6 and of 8 blocks walking 2 heads),
           each K2 launch repeated and required to agree bit for bit, each
           row with its plan (tiles, cluster size); K2 also timed at S=4096
           (B=1) and at D=128 (yi-6b's heads, B=2, S=1024)
  serve    tinyllama-1.1b at full width and depth, bf16, seeded random
           weights: one 512-token prefill through `forward` (flash_attention)
           and `ServingEngine.generate` for 32 greedy steps (flash_decode at
           every layer of every step), with the launch counts the path must
           show, and the same two steps through impl="naive" as the reference
  checks   (hybrid path) K4 fused_ffn at zamba2-1.2b's prefill (T=2048) and
           decode (T=4) shapes, the tiled route's threshold T=256, T=1025
           (two row chunks of h, the second ragged), T=8192 (eight chunks),
           F=1000, tinyllama's F=5632, T=333 and fp32, every bf16 shape on
           both routes (tiled and rowtile; the route ffn_plan picks is the
           row's own, both timed at T=2048 and T=256), with the route and
           h's chunk rows; K5 ssd_scan at the prefill shape (N=64; again with
           Mamba-2's small dt, bf16 and fp32, so the state carries across
           chunks), mamba2-1.3b's N=128, S=333, S=1 and fp32 shapes, y and
           final state; bf16 outputs held elementwise and by relative norm;
           each launched twice and required bit-identical; K4's allocation
           at T=2048 and T=8192 held below one (T x F) bf16 tensor and to
           16 MiB + 1 MiB
  serve_hybrid  zamba2-1.2b at full width and depth (38 Mamba-2 blocks, 6
           calls of the shared attention + MLP block), bf16, seeded random
           weights, impl="kernel" with fused_ffn: the prefill step on 4 x 512
           prompts (K5 38, K1 6, K4 6 launches, all on the tiled route) and
           `generate` for 16 greedy steps (K3 and K4 6 x 527 each, K4 on the
           row-tile route), against impl="naive" without
           fused_ffn on the same weights; layer 0's SSM state after 512
           tokens through the kernel scan against 512 decode steps; times
           (host clock, CUDA-graph replay) and a torch.profiler breakdown of
           one prefill step and one decode step
  train    tinyllama-1.1b at full width and depth, bf16 with fp32 master
           weights and moments, remat "full": loss and every gradient of
           impl="kernel" against impl="naive", then 8 steps of
           make_train_step on one fixed 4 x 1024 batch (K1 twice, K2a and
           K2b once per layer and step), with the losses, step times (host
           clock, and one step replayed as a CUDA graph), tokens/s, MFU and
           peak memory
  kernels  the summary line: per kernel its launches on each path, error,
           time, plain time, bound and the library call's time; K4 also its
           launches by route and both routes' times at T=2048 and T=256
then the card's name and power limit, then {"ok": true, "device": ...}.
Any failed phase raises: the script exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tolerances of the CPU tests: fp32 differs by summation order only, bf16
# carries about three decimal digits
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# backward: fp32 at the reference's own 2e-4; bf16 |got - want| <= 2e-2 max|want|
# + 2e-2 |want|, because P and dS are rounded to bf16 before the tensor-core
# products
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# prefill-vs-decode tolerance on bf16 logits, as the model tests use it
LOGIT_ATOL, LOGIT_RTOL = 0.25, 0.05

ARCH, BATCH, PROMPT_LEN, GEN_STEPS, MAX_LEN = "tinyllama-1.1b", 4, 512, 32, 1024
WIDE_ARCH = "yi-6b"        # K2 timed at its heads: H=32, KVH=4, D=128
HYBRID_ARCH, HYBRID_GEN_STEPS = "zamba2-1.2b", 16
# (atol, rtol): |got - want| <= atol + rtol |want| in every element.
# K5 computes in fp32 from the inputs' values, as its plain version does: on
# bf16 inputs the two differ by summation order and by a flip of y's one
# rounding to bf16 (at most 2^-8 |y|), so y is held at 2e-2 + 2e-2 |y| and
# the fp32 state at the reference test's own 2e-4 / 2e-3, as all of fp32 is.
SSD_TOL = {torch.float32: (2e-4, 2e-3), torch.bfloat16: (2e-2, 2e-2)}
# K4 fp32 at 5x the base tolerance, as the reference's test holds its Pallas
# kernel. bf16: the kernel rounds h = silu(g) u to bf16 as the down product's
# operand and rounds y once, the plain version rounds only y; the first run
# measured one bf16 ulp of a |y| in [2, 4), 0.0156, so 3e-2 + 2e-2 |y|.
FFN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
# bf16 K4 and K5 outputs: ||got - want|| / ||want|| at most 1e-2, several
# times what one rounding of each side (2^-9 |y| at most) can give
BF16_REL_NORM = 1e-2
# Mamba-2's dt initialisation: log-uniform in [1e-3, 1e-1]. At these dt the
# state carries across K5's 64-token chunks (exp(sum dt A) ~ 0.2 a chunk);
# at dt = softplus(N(0, 1)) it has decayed within a few tokens.
SSD_SMALL_DT = (1e-3, 1e-1)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 1e-3
# kernel path against naive path on the card, bf16: each gradient leaf's
# relative norm error, and the first step's loss. Both bf16 paths are 1-3 %
# off an fp32 oracle in every leaf (ffn weights as much as attention's: the
# rounding of the whole 22-layer model, not of the kernels), so the leaves
# are held at 4e-2 against each other, and the kernel path must be no
# further from the fp32 oracle than the naive path is (within 10 %)
TRAIN_GRAD_RTOL, TRAIN_LOSS_ATOL, TRAIN_VS_ORACLE = 4e-2, 1e-2, 1.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``launches`` calls are captured into a CUDA
    graph and the graph is replayed between two events, so the host's cost of
    making a call (which exceeds these kernels' run time) is not in it.
    Inputs stay in L2 between calls where they fit, as they do for the model,
    which has just written them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time of one eager call as a caller sees it, by CUDA events around
    ``iters`` calls: the larger of the host's cost of a call and the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate against
    operations over the peak rate for the type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs error {err} exceeds tolerance {tol}")
    return err


def scaled_compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
                   scaled: bool) -> float:
    """|got - want| <= atol' + rtol |want|, where atol' is ``atol`` or, when
    ``scaled``, ``atol * max|want|`` (bf16 rounding grows with the values)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: bad shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    bound_abs = atol * float(want.abs().max()) if scaled else atol
    if not bool((err <= bound_abs + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max())} exceeds "
                             f"{bound_abs} + {rtol}|want|")
    return float(err.max())


def held(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
         rel_norm: float | None = None) -> dict:
    """|got - want| <= atol + rtol |want| in every element and, where
    ``rel_norm`` is given, ||got - want|| / ||want|| <= rel_norm. Returns the
    errors with the largest and the RMS |want| beside them."""
    err = scaled_compare(name, got, want, atol, rtol, scaled=False)
    rel = rel_err(got, want)
    if rel_norm is not None and not rel <= rel_norm:
        raise AssertionError(f"{name}: relative norm error {rel} exceeds {rel_norm}")
    w = want.float()
    return {"max_abs_err": err, "rel_norm_err": rel, "want_max_abs": float(w.abs().max()),
            "want_rms": float(w.square().mean().sqrt())}


def kernel_name(mangled: str) -> str:
    """The unqualified name in an Itanium-mangled function name:
    ``_ZN<len><namespace><len><name>...`` or ``_Z<len><name>...``, with a
    template's integer arguments (``I Li64E ... E``) as ``name<64,...>``."""
    m = re.match(r"_Z(N?)", mangled)
    if not m:
        return mangled
    pos, names = m.end(), []
    while n := re.match(r"\d+", mangled[pos:]):
        pos += n.end()
        names.append(mangled[pos:pos + int(n.group())])
        pos += int(n.group())
        if not m.group(1):
            break
    if not names:
        return mangled
    args = re.match(r"I((?:L[a-z]+-?\d+E)+)E", mangled[pos:])
    if not args:
        return names[-1]
    return names[-1] + "<" + ",".join(re.findall(r"L[a-z]+(-?\d+)E", args.group(1))) + ">"


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel from ``nvcc -Xptxas -v``'s
    output, by ``kernel_name`` (a template instance by its integer arguments,
    ``attn_bwd_dkv_mma<128,32>``; where two entries share a name, the n-th
    gets "#n")."""
    report, entry, name = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m.group(1)
            name = base = kernel_name(entry)
            n = 1
            while name in report:
                n += 1
                name = f"{base}#{n}"
            report[name] = {}
        elif m := re.search(r"Function properties for (\w+)", line):
            if m.group(1) != entry:
                name = None          # a callee's properties, not the entry's
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
    return report


def build_with_report() -> dict:
    """Builds the kernels with ``-Xptxas -v`` and returns ``ptxas_report``."""
    from repro_torch.kernels import build

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        build.build(verbose=True)
    return ptxas_report(out.getvalue())


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# --------------------------------------------------------------------------------
# kernel checks
# --------------------------------------------------------------------------------

def check_flash_attention(gen, *, b, sq, skv, h, kvh, d, dtype, causal, timed=False) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q = randn(gen, (b, sq, h, d), dtype)
    k = randn(gen, (b, skv, kvh, d), dtype)
    v = randn(gen, (b, skv, kvh, d), dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_plain(q, k, v, causal=causal)
    tol = TOL[dtype]
    row = {"kernel": "flash_attention",
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "KVH": kvh, "D": d,
                     "dtype": str(dtype).split(".")[-1], "causal": causal},
           "tol": tol,
           "max_abs_err": compare("flash_attention out", out, want, tol),
           "lse_max_abs_err": compare("flash_attention lse", lse, want_lse, tol)}
    if timed:
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
        flops = 4 * b * h * d * pairs
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row.update(
            kernel_ms=device_ms(lambda: flash_attention(q, k, v, causal=causal)),
            call_ms=call_ms(lambda: flash_attention(q, k, v, causal=causal)),
            plain_ms=device_ms(lambda: flash_attention_plain(q, k, v, causal=causal)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def check_flash_decode(gen, *, b, h, kvh, d, s, kv_len, dtype, timed=False) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, split_plan

    q = randn(gen, (b, h, d), dtype)
    k = randn(gen, (b, s, kvh, d), dtype)
    v = randn(gen, (b, s, kvh, d), dtype)
    out = flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    row = {"kernel": "flash_decode",
           "shape": {"B": b, "H": h, "KVH": kvh, "D": d, "S": s, "kv_len": kv_len,
                     "dtype": str(dtype).split(".")[-1]},
           "splits": split_plan(kv_len, b * kvh)[0], "tol": tol,
           "max_abs_err": compare("flash_decode out", out,
                                  flash_decode_plain(q, k, v, kv_len), tol)}
    if timed:
        # this run's data: only the first kv_len positions of the cache are needed
        nbytes = q.element_size() * (2 * q.numel() + 2 * b * kv_len * kvh * d)
        flops = 4 * b * h * d * kv_len
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        q4 = q[:, :, None, :]
        kt, vt = (x[:, :kv_len].transpose(1, 2) for x in (k, v))
        row.update(
            kernel_ms=device_ms(lambda: flash_decode(q, k, v, kv_len)),
            call_ms=call_ms(lambda: flash_decode(q, k, v, kv_len)),
            plain_ms=device_ms(lambda: flash_decode_plain(q, k, v, kv_len)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q4, kt, vt, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def check_flash_attention_bwd(gen, *, b, sq, skv, h, kvh, d, dtype, causal, timed=False) -> dict:
    """K2a and K2b against their plain versions, and twice on the same inputs
    (the two launches must agree bit for bit), with the plan they ran."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (attention_delta, bwd_plan,
                                                         flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dkv_plain,
                                                         flash_attention_bwd_dq,
                                                         flash_attention_bwd_dq_plain)

    q = randn(gen, (b, sq, h, d), dtype)
    k = randn(gen, (b, skv, kvh, d), dtype)
    v = randn(gen, (b, skv, kvh, d), dtype)
    dout = randn(gen, (b, sq, h, d), dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    delta = attention_delta(out, dout)
    dq = lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=causal)
    dkv = lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=causal)
    got = (dq(), *dkv())
    again = (dq(), *dkv())
    torch.cuda.synchronize()
    want = (flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, causal=causal),
            *flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, causal=causal))
    row = {"kernel": "flash_attention_bwd",
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "KVH": kvh, "D": d,
                     "dtype": str(dtype).split(".")[-1], "causal": causal},
           "plan": bwd_plan(b, sq, skv, h, kvh, d, dtype, causal).summary(),
           "tol": BWD_TOL[dtype],
           "max_abs_err": {n: scaled_compare(f"flash_attention_bwd {n}", x, y, BWD_TOL[dtype],
                                             BWD_TOL[dtype], dtype != torch.float32)
                           for n, x, y in zip(("dq", "dk", "dv"), got, want)},
           "max_abs_want": {n: float(y.float().abs().max()) for n, y in zip(("dq", "dk", "dv"), want)},
           "bit_identical": all(torch.equal(x, y) for x, y in zip(got, again))}
    if not row["bit_identical"]:
        raise AssertionError("flash_attention_bwd: two launches on the same inputs differ")
    if timed:
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        es = q.element_size()
        io = {"dq": es * (3 * q.numel() + k.numel() + v.numel()) + 4 * (lse.numel() + delta.numel()),
              "dkv": es * (2 * q.numel() + 2 * k.numel() + 2 * v.numel())
                     + 4 * (lse.numel() + delta.numel())}
        flops = {"dq": 6 * b * h * d * pairs, "dkv": 8 * b * h * d * pairs}
        plain = {"dq": lambda: flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, causal=causal),
                 "dkv": lambda: flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, causal=causal)}
        for name, fn in (("dq", dq), ("dkv", dkv)):
            bound_ms, bound_by = bound(io[name], flops[name], dtype)
            row[name] = {"kernel_ms": device_ms(fn), "call_ms": call_ms(fn),
                         "plain_ms": device_ms(plain[name], launches=3),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": io[name], "flops": flops[name]}
        # the library's backward: fused forward+backward less the forward
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = dout.transpose(1, 2)
        fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        fwd_bwd = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)
        lib_fwd, lib_all = device_ms(fwd), device_ms(fwd_bwd)
        row.update(library_fwd_ms=lib_fwd, library_fwd_bwd_ms=lib_all,
                   library_ms=lib_all - lib_fwd)
    return row


def phase_occupancy(cfg) -> dict:
    """cudaOccupancyMaxActiveClusters of K2b's launch at the training shape,
    beside its plan: how many of its clusters the card holds at once."""
    from repro_torch.kernels.flash_attention_bwd import bwd_plan, dkv_max_active_clusters

    shape = dict(b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=cfg.n_heads, kvh=cfg.n_kv_heads,
                 d=cfg.head_dim)
    plan = bwd_plan(**shape, dtype=torch.bfloat16, causal=True)
    clusters = dkv_max_active_clusters(**shape)
    if clusters < 1:
        raise AssertionError(f"K2b: not one cluster of {plan.cluster} blocks fits the card")
    return {"phase": "occupancy", "kernel": "flash_attention_bwd_dkv", "shape": shape,
            "plan": plan.summary(), "max_active_clusters": clusters,
            "max_active_blocks": clusters * plan.cluster,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}


def phase_train_checks(cfg, wide_cfg) -> tuple[dict, dict, dict]:
    """K2a/K2b over the training path's shape and the awkward ones, and K1 at
    the training path's shape; returns the two timed rows at the training
    shape and K2's timed rows at S=4096 (tinyllama's heads, B=1) and at
    D=128 (``wide_cfg``'s heads, B=2, S=1024)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fa = check_flash_attention(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh, d=d,
                               dtype=bf16, causal=True, timed=True)
    bwd = check_flash_attention_bwd(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh,
                                    d=d, dtype=bf16, causal=True, timed=True)
    more = {
        "S=4096": check_flash_attention_bwd(gen, b=1, sq=4096, skv=4096, h=h, kvh=kvh, d=d,
                                            dtype=bf16, causal=True, timed=True),
        "D=128": check_flash_attention_bwd(gen, b=2, sq=TRAIN_SEQ, skv=TRAIN_SEQ,
                                           h=wide_cfg.n_heads, kvh=wide_cfg.n_kv_heads,
                                           d=wide_cfg.head_dim, dtype=bf16, causal=True,
                                           timed=True),
    }
    rows = [fa, bwd, *more.values()]
    for kw in (
        dict(b=2, sq=333, skv=333, h=h, kvh=kvh, d=d, dtype=bf16, causal=True),   # no tile multiple
        dict(b=2, sq=512, skv=512, h=8, kvh=2, d=32, dtype=bf16, causal=True),
        dict(b=2, sq=384, skv=384, h=8, kvh=2, d=128, dtype=bf16, causal=True),
        dict(b=2, sq=512, skv=512, h=8, kvh=8, d=d, dtype=bf16, causal=True),     # KVH == H
        dict(b=2, sq=512, skv=512, h=8, kvh=1, d=d, dtype=bf16, causal=True),     # KVH == 1
        dict(b=2, sq=200, skv=333, h=8, kvh=2, d=d, dtype=bf16, causal=False),    # Sq != Skv
        dict(b=2, sq=333, skv=333, h=8, kvh=2, d=d, dtype=fp32, causal=True),
        dict(b=1, sq=130, skv=250, h=4, kvh=1, d=128, dtype=fp32, causal=False),
        dict(b=1, sq=100, skv=100, h=4, kvh=4, d=32, dtype=fp32, causal=True),
        dict(b=2, sq=333, skv=333, h=12, kvh=2, d=d, dtype=bf16, causal=True),    # G=6: c=6
        dict(b=1, sq=256, skv=256, h=16, kvh=1, d=d, dtype=bf16, causal=True),    # G=16: c=8, 2 heads a block
    ):
        rows.append(check_flash_attention_bwd(gen, **kw))
    for row in rows:
        emit({"phase": "checks", "path": "train", **row})
    return fa, bwd, more


def phase_checks(cfg) -> tuple[dict, dict]:
    """All shapes; returns the two rows taken at the serve path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = [check_flash_attention(gen, b=BATCH, sq=PROMPT_LEN, skv=PROMPT_LEN, h=h, kvh=kvh,
                                  d=d, dtype=bf16, causal=True, timed=True)]
    fa_path = rows[0]
    for kw in (
        dict(b=2, sq=384, skv=384, h=h, kvh=kvh, d=d, dtype=bf16, causal=True),
        dict(b=2, sq=333, skv=333, h=h, kvh=kvh, d=d, dtype=bf16, causal=True),   # no tile multiple
        dict(b=2, sq=512, skv=512, h=8, kvh=2, d=128, dtype=bf16, causal=True),
        dict(b=2, sq=512, skv=512, h=8, kvh=8, d=d, dtype=bf16, causal=True),     # KVH == H
        dict(b=2, sq=512, skv=512, h=8, kvh=2, d=d, dtype=bf16, causal=False),
        dict(b=2, sq=200, skv=333, h=8, kvh=2, d=32, dtype=bf16, causal=False),   # Sq != Skv
        dict(b=2, sq=333, skv=333, h=8, kvh=2, d=d, dtype=fp32, causal=True),
        dict(b=1, sq=256, skv=256, h=4, kvh=4, d=128, dtype=fp32, causal=False),
        dict(b=1, sq=130, skv=130, h=4, kvh=1, d=32, dtype=fp32, causal=True),
    ):
        rows.append(check_flash_attention(gen, **kw))
    # the serve path's own call: the cache of MAX_LEN at the last step's length
    fd_path = check_flash_decode(gen, b=BATCH, h=h, kvh=kvh, d=d, s=MAX_LEN,
                                 kv_len=PROMPT_LEN + GEN_STEPS - 1, dtype=bf16, timed=True)
    rows.append(fd_path)
    for kw in (
        dict(b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=1, dtype=bf16),
        dict(b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=700, dtype=bf16),
        dict(b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=2048, dtype=bf16, timed=True),
        dict(b=3, h=h, kvh=kvh, d=d, s=1000, kv_len=999, dtype=bf16),             # ragged cache
        dict(b=2, h=8, kvh=8, d=128, s=1000, kv_len=65, dtype=bf16),              # KVH == H
        dict(b=2, h=8, kvh=2, d=128, s=1000, kv_len=700, dtype=fp32),
        dict(b=1, h=4, kvh=4, d=32, s=64, kv_len=64, dtype=fp32),
    ):
        rows.append(check_flash_decode(gen, **kw))
    for row in rows:
        emit({"phase": "checks", **row})
    return fa_path, fd_path


def check_fused_ffn(gen, *, t, d, f, dtype, timed=False, alloc=False, both_routes=False) -> dict:
    """K4 against its plain version, twice on the same inputs (bit-identical),
    with model-like scales (x of unit RMS, weights of std 1/sqrt(fan-in)), on
    the route ``ffn_plan`` picks and, with ``both_routes``, on the other one
    (``other_route``), timed too where ``timed``."""
    from repro_torch.kernels.fused_ffn import (H_CHUNK_BYTES, ROUTES, chunk_spans, ffn_plan,
                                               fused_ffn, fused_ffn_plain, split_plan)
    from repro_torch.models.layers import ffn

    x = randn(gen, (t, d), dtype)
    wg = (randn(gen, (d, f), torch.float32) * d ** -0.5).to(dtype)
    wu = (randn(gen, (d, f), torch.float32) * d ** -0.5).to(dtype)
    wd = (randn(gen, (f, d), torch.float32) * f ** -0.5).to(dtype)
    want = fused_ffn_plain(x, wg, wu, wd)
    atol, rtol = FFN_TOL[dtype]
    rel_norm = BF16_REL_NORM if dtype == torch.bfloat16 else None
    route, chunk_rows = ffn_plan(t, f, dtype)

    def on(r) -> dict:
        got = fused_ffn(x, wg, wu, wd, route=r)
        again = fused_ffn(x, wg, wu, wd, route=r)
        torch.cuda.synchronize()
        res = {**held(f"fused_ffn ({r})", got, want, atol, rtol, rel_norm),
               "bit_identical": bool(torch.equal(got, again))}
        if not res["bit_identical"]:
            raise AssertionError(f"fused_ffn ({r}): two launches on the same inputs differ")
        if timed:
            res.update(kernel_ms=device_ms(lambda: fused_ffn(x, wg, wu, wd, route=r)),
                       call_ms=call_ms(lambda: fused_ffn(x, wg, wu, wd, route=r)))
        return res

    row = {"kernel": "fused_ffn",
           "shape": {"T": t, "D": d, "F": f, "dtype": str(dtype).split(".")[-1]},
           "route": route, "chunk_rows": chunk_rows,
           "chunks": len(chunk_spans(t, chunk_rows)) if chunk_rows else None,
           "splits": split_plan(t, f)[0] if route == "rowtile" else None,
           "tol": {"atol": atol, "rtol": rtol, "rel_norm": rel_norm}, **on(route)}
    if both_routes:
        other = next(r for r in ROUTES if r != route)
        row["other_route"] = {"route": other, **on(other)}
    if alloc:
        # what one call allocates besides its output: no (T x F) tensor, and
        # no more than one chunk of h (16 MiB) and 1 MiB of slack
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fused_ffn(x, wg, wu, wd)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
        limit, chunk_limit = t * f * 2, H_CHUNK_BYTES + (1 << 20)
        row.update(alloc_extra_bytes=extra, alloc_limit_bytes=limit,
                   alloc_chunk_limit_bytes=chunk_limit)
        if extra >= limit or extra > chunk_limit:
            raise AssertionError(f"fused_ffn allocated {extra} bytes besides its output: not "
                                 f"fewer than one (T x F) bf16 tensor ({limit}), or more "
                                 f"than {chunk_limit}")
        del out
    if timed:
        nbytes = x.element_size() * (2 * x.numel() + wg.numel() + wu.numel() + wd.numel())
        flops = 6 * t * d * f
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        params = {"w_gate": wg, "w_up": wu, "w_down": wd}
        row.update(
            plain_ms=device_ms(lambda: fused_ffn_plain(x, wg, wu, wd), launches=3),
            library_ms=device_ms(lambda: ffn(params, x)),
            library_covers="three cuBLAS products + silu*mul (eager layers.ffn), several calls",
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def routes_ms(row) -> dict:
    """Device ms of both K4 routes from a row checked with ``both_routes``."""
    return {row["route"]: row["kernel_ms"], row["other_route"]["route"]: row["other_route"]["kernel_ms"]}


def ssd_flops(b, s, h, p, n) -> int:
    """What K5 does: per (b, h) and 64-token chunk, C B^T, the masked-score
    product, the inter-chunk product and the state update, all in full."""
    from repro_torch.kernels.ssd_scan import CHUNK as L
    chunks = -(-s // L)
    return b * h * chunks * 2 * L * (L * n + L * p + 2 * n * p)


def check_ssd_scan(gen, *, b, s, h, p, n, dtype, timed=False, dt_range=None) -> dict:
    """K5 against its plain version (y and the final state), twice on the
    same inputs (bit-identical). Inputs at the model's scales: A = -exp(.) per
    head, dt a softplus of N(0, 1) or, with ``dt_range``, log-uniform in it."""
    from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan, ssd_scan_plain

    x = (randn(gen, (b, s, h, p), torch.float32) * 0.5).to(dtype)
    if dt_range is None:
        dt = torch.nn.functional.softplus(randn(gen, (b, s, h), torch.float32))
    else:
        lo, hi = math.log(dt_range[0]), math.log(dt_range[1])
        dt = torch.exp(lo + (hi - lo) * torch.rand((b, s, h), generator=gen, device="cuda"))
    a = -torch.exp(randn(gen, (h,), torch.float32) * 0.3)
    bm = (randn(gen, (b, s, n), torch.float32) * 0.3).to(dtype)
    cm = (randn(gen, (b, s, n), torch.float32) * 0.3).to(dtype)
    y, st = ssd_scan(x, dt, a, bm, cm)
    y2, st2 = ssd_scan(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    want_y, want_st = ssd_scan_plain(x, dt, a, bm, cm)
    atol, rtol = SSD_TOL[dtype]
    st_atol, st_rtol = SSD_TOL[torch.float32]
    rel_norm = BF16_REL_NORM if dtype == torch.bfloat16 else None
    y_err = held("ssd_scan y", y, want_y, atol, rtol, rel_norm)
    st_err = held("ssd_scan state", st, want_st, st_atol, st_rtol)
    row = {"kernel": "ssd_scan",
           "shape": {"B": b, "S": s, "H": h, "P": p, "N": n, "dtype": str(dtype).split(".")[-1]},
           "dt": "softplus(N(0,1))" if dt_range is None else f"log-uniform {list(dt_range)}",
           # share of the state one 64-token chunk carries into the next
           "chunk_carry_mean": float(torch.exp(dt[:, :CHUNK].sum(1) * a).mean()),
           "tol": {"y": {"atol": atol, "rtol": rtol, "rel_norm": rel_norm},
                   "state": {"atol": st_atol, "rtol": st_rtol}},
           **y_err,
           "state_max_abs_err": st_err["max_abs_err"],
           "state_rel_norm_err": st_err["rel_norm_err"],
           "bit_identical": bool(torch.equal(y, y2) and torch.equal(st, st2))}
    if not row["bit_identical"]:
        raise AssertionError("ssd_scan: two launches on the same inputs differ")
    if timed:
        # each input read once, y and the final state written once
        nbytes = (x.element_size() * (2 * x.numel() + bm.numel() + cm.numel())
                  + 4 * (dt.numel() + a.numel() + st.numel()))
        flops = ssd_flops(b, s, h, p, n)
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        row.update(
            kernel_ms=device_ms(lambda: ssd_scan(x, dt, a, bm, cm)),
            call_ms=call_ms(lambda: ssd_scan(x, dt, a, bm, cm)),
            plain_ms=device_ms(lambda: ssd_scan_plain(x, dt, a, bm, cm), launches=3),
            library_ms=None,
            library_none_because="no single PyTorch call computes the SSD scan",
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def phase_hybrid_checks(cfg, ssm_cfg) -> dict:
    """K4 and K5 over the hybrid path's shapes and the awkward ones; returns
    the timed rows at the path's shapes (and K4's at its route threshold)."""
    from repro_torch.kernels.fused_ffn import TILED_MIN_T

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, fp32 = torch.bfloat16, torch.float32
    d, f, tokens = cfg.d_model, cfg.d_ff, BATCH * PROMPT_LEN
    rows = {
        "ffn_prefill": check_fused_ffn(gen, t=tokens, d=d, f=f, dtype=bf16, timed=True, alloc=True,
                                       both_routes=True),
        "ffn_decode": check_fused_ffn(gen, t=BATCH, d=d, f=f, dtype=bf16, timed=True,
                                      both_routes=True),
        "ffn_threshold": check_fused_ffn(gen, t=TILED_MIN_T, d=d, f=f, dtype=bf16, timed=True,
                                         both_routes=True),
        "ssd_prefill": check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=cfg.ssm_heads,
                                      p=cfg.ssm_head_dim, n=cfg.ssm_state, dtype=bf16, timed=True),
    }
    others = [
        check_fused_ffn(gen, t=1025, d=d, f=f, dtype=bf16, both_routes=True),   # 2 chunks, ragged
        check_fused_ffn(gen, t=8192, d=d, f=f, dtype=bf16, alloc=True, both_routes=True),  # 8
        check_fused_ffn(gen, t=tokens, d=d, f=1000, dtype=bf16, both_routes=True),   # ragged F
        check_fused_ffn(gen, t=tokens, d=2048, f=5632, dtype=bf16, both_routes=True),  # tinyllama
        check_fused_ffn(gen, t=333, d=d, f=f, dtype=bf16, both_routes=True),    # no tile multiple
        check_fused_ffn(gen, t=256, d=128, f=512, dtype=bf16, both_routes=True),
        check_fused_ffn(gen, t=256, d=128, f=512, dtype=fp32),          # tests/test_kernels.py:57
        check_fused_ffn(gen, t=512, d=256, f=1024, dtype=fp32),
        check_fused_ffn(gen, t=128, d=64, f=256, dtype=fp32),
        # the prefill shape with the state carried across chunks, bf16 and fp32
        check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=cfg.ssm_heads, p=cfg.ssm_head_dim,
                       n=cfg.ssm_state, dtype=bf16, dt_range=SSD_SMALL_DT),
        check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=cfg.ssm_heads, p=cfg.ssm_head_dim,
                       n=cfg.ssm_state, dtype=fp32, dt_range=SSD_SMALL_DT),
        check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=ssm_cfg.ssm_heads, p=ssm_cfg.ssm_head_dim,
                       n=ssm_cfg.ssm_state, dtype=bf16),                # mamba2-1.3b's N=128
        check_ssd_scan(gen, b=2, s=333, h=8, p=64, n=64, dtype=bf16),   # no chunk multiple
        check_ssd_scan(gen, b=2, s=1, h=8, p=64, n=64, dtype=bf16),
        check_ssd_scan(gen, b=2, s=256, h=4, p=32, n=16, dtype=fp32),   # tests/test_kernels.py:77
        check_ssd_scan(gen, b=1, s=128, h=2, p=64, n=32, dtype=fp32),
        check_ssd_scan(gen, b=1, s=512, h=8, p=16, n=8, dtype=fp32),
        check_ssd_scan(gen, b=2, s=333, h=4, p=128, n=128, dtype=fp32),
    ]
    for row in [*rows.values(), *others]:
        emit({"phase": "checks", "path": "serve_hybrid", **row})
    return rows


# --------------------------------------------------------------------------------
# the serving path
# --------------------------------------------------------------------------------

def logits_agree(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: bad shape {tuple(got.shape)} or non-finite logits")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise AssertionError(f"{name}: logits differ by up to {err} "
                             f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    return err


def drive(model, prompts) -> dict:
    """The two steps of the serving path through one model: the prefill step
    and the engine's generate, timed on the host clock around a synchronize."""
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.serve.step import make_prefill_step

    prefill = make_prefill_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_logits = prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine = ServingEngine(model, BATCH, MAX_LEN)
    tokens = engine.generate(prompts, GEN_STEPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"prefill_logits": last_logits[:, 0].float(), "engine_logits": engine.prefill_logits,
            "tokens": tokens, "prefill_s": t1 - t0, "generate_s": t2 - t1,
            "prefill": prefill, "engine": engine}


def phase_serve(cfg) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import LanguageModel

    model = LanguageModel(cfg, impl="kernel")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive")
    naive.params = model.params                      # the same weights, not a copy
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))

    drive_steps = PROMPT_LEN + GEN_STEPS - 1         # decode-step calls in one generate
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    ker = drive(model, prompts)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * drive_steps}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    ref = drive(naive, prompts)
    if (flash_attention.launches, flash_decode.launches) != tuple(expected.values()):
        raise AssertionError("the naive path launched a kernel")
    # a second kernel-path drive for the times: the first one paid for cuBLAS's
    # start-up and the allocator's first growth
    timed = drive(model, prompts)

    # what the card alone needs for each step (graph replay, no host in the
    # way): the gap to the eager times above is the share the device idles
    engine, last = timed["engine"], PROMPT_LEN + GEN_STEPS - 1
    prefill_device_ms = device_ms(lambda: timed["prefill"]({"tokens": prompts}),
                                  launches=1, replays=3)
    decode_device_ms = device_ms(lambda: engine.decode(engine.cache, prompts[:, :1], last),
                                 launches=1, replays=10)

    toks = ker["tokens"]
    if toks.shape != (BATCH, GEN_STEPS) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}")
    if not torch.equal(toks, timed["tokens"]):
        raise AssertionError("two greedy runs of the kernel path gave different tokens")
    errs = {
        "engine_vs_prefill": logits_agree("engine vs prefill step (kernel path)",
                                          ker["engine_logits"], ker["prefill_logits"]),
        "prefill_kernel_vs_naive": logits_agree("prefill step, kernel vs naive",
                                                ker["prefill_logits"], ref["prefill_logits"]),
        "engine_kernel_vs_naive": logits_agree("engine, kernel vs naive",
                                               ker["engine_logits"], ref["engine_logits"]),
    }
    row = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
           "batch": BATCH, "prompt_len": PROMPT_LEN, "gen_steps": GEN_STEPS, "max_len": MAX_LEN,
           "launches": launches, "logit_max_abs_diff": errs,
           "tokens_equal_naive": bool(torch.equal(toks, ref["tokens"])),
           "prefill_ms": timed["prefill_s"] * 1e3,
           "decode_ms_per_step": timed["generate_s"] * 1e3 / drive_steps,
           "generate_s": timed["generate_s"],
           "generated_tokens_per_s": BATCH * GEN_STEPS / timed["generate_s"],
           "decode_tokens_per_s": BATCH * drive_steps / timed["generate_s"],
           "prefill_device_ms": prefill_device_ms,
           "decode_device_ms_per_step": decode_device_ms,
           "decode_device_idle_share":
               1 - decode_device_ms / (timed["generate_s"] * 1e3 / drive_steps),
           "naive_prefill_ms": ref["prefill_s"] * 1e3,
           "naive_decode_ms_per_step": ref["generate_s"] * 1e3 / drive_steps,
           "first_run_prefill_ms": ker["prefill_s"] * 1e3,
           "max_memory_allocated_bytes": peak_bytes}
    emit(row)
    return launches


def phase_serve_hybrid(cfg) -> dict:
    """zamba2-1.2b at full width and depth through the prefill step and the
    engine, kernel path (K5, K1/K3, K4) against the naive path."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import LanguageModel
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.lm import _unbind_layers
    from repro_torch.models.ssm import mamba2_decode, mamba2_forward
    from repro_torch.serve.step import make_prefill_step

    counters = (ssd_scan, flash_attention, fused_ffn, flash_decode)

    def reset():
        for c in counters:
            c.launches = 0
        fused_ffn.launches_by_route = dict.fromkeys(fused_ffn.launches_by_route, 0)

    def counts():
        return {c.__name__: c.launches for c in counters}

    model = LanguageModel(cfg, impl="kernel", fused_ffn=True)
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive", fused_ffn=False)
    naive.params = model.params                      # the same weights, not a copy
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    n_shared = cfg.n_layers // cfg.attn_every
    drive_steps = PROMPT_LEN + HYBRID_GEN_STEPS - 1  # decode-step calls in one generate
    want_prefill = {"ssd_scan": cfg.n_layers, "flash_attention": n_shared,
                    "fused_ffn": n_shared, "flash_decode": 0}
    want_generate = {"ssd_scan": 0, "flash_attention": 0, "fused_ffn": n_shared * drive_steps,
                     "flash_decode": n_shared * drive_steps}
    # K4's route: the prefill step's T = 2048 takes the tiled route, decode's T = 4 the row tiles
    want_by_route = {"prefill": {"tiled": n_shared, "rowtile": 0},
                     "generate": {"tiled": 0, "rowtile": n_shared * drive_steps}}

    def drive_hybrid(m):
        prefill = make_prefill_step(m)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits = prefill({"tokens": prompts})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c_prefill, r_prefill = counts(), dict(fused_ffn.launches_by_route)
        reset()
        engine = ServingEngine(m, BATCH, MAX_LEN)
        toks = engine.generate(prompts, HYBRID_GEN_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"prefill_logits": logits[:, 0].float(), "engine_logits": engine.prefill_logits,
                "tokens": toks, "prefill_s": t1 - t0, "generate_s": t2 - t1,
                "launches": {"prefill": c_prefill, "generate": counts()},
                "by_route": {"prefill": r_prefill, "generate": dict(fused_ffn.launches_by_route)},
                "prefill": prefill, "engine": engine}

    torch.cuda.reset_peak_memory_stats()
    ker = drive_hybrid(model)
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = ker["launches"]
    if launches != {"prefill": want_prefill, "generate": want_generate}:
        raise AssertionError(f"launch counts {launches}, expected prefill {want_prefill}, "
                             f"generate {want_generate}")
    if ker["by_route"] != want_by_route:
        raise AssertionError(f"fused_ffn launches by route {ker['by_route']}, expected "
                             f"{want_by_route}")
    ref = drive_hybrid(naive)
    if any(v for step in ref["launches"].values() for v in step.values()):
        raise AssertionError(f"the naive path launched a kernel: {ref['launches']}")
    timed = drive_hybrid(model)                      # the first run paid for start-up

    engine, last = timed["engine"], drive_steps
    prefill_device_ms = device_ms(lambda: timed["prefill"]({"tokens": prompts}),
                                  launches=1, replays=3)
    decode_device_ms = device_ms(lambda: engine.decode(engine.cache, prompts[:, :1], last),
                                 launches=1, replays=10)
    profile = {"prefill": profile_step(lambda: timed["prefill"]({"tokens": prompts})),
               "decode_step": profile_step(
                   lambda: engine.decode(engine.cache, prompts[:, :1], last))}

    toks = ker["tokens"]
    if (toks.shape != (BATCH, HYBRID_GEN_STEPS) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}")
    if not torch.equal(toks, timed["tokens"]):
        raise AssertionError("two greedy runs of the kernel path gave different tokens")
    errs = {
        "engine_vs_prefill": logits_agree("hybrid: engine vs prefill step (kernel path)",
                                          ker["engine_logits"], ker["prefill_logits"]),
        "prefill_kernel_vs_naive": logits_agree("hybrid: prefill step, kernel vs naive",
                                                ker["prefill_logits"], ref["prefill_logits"]),
        "engine_kernel_vs_naive": logits_agree("hybrid: engine, kernel vs naive",
                                               ker["engine_logits"], ref["engine_logits"]),
    }

    # layer 0 at full width: the SSM state after the prompt through the kernel
    # scan against the state after as many decode steps. Each side's inputs
    # carry its own bf16 rounding (in_proj over 512 tokens or over one), so
    # the two are held as the bf16 K5 checks are: 2e-2 max|want| + 2e-2 |want|
    p0 = _unbind_layers(model.params["layers"], cfg.n_layers)[0]
    with torch.no_grad():
        h0 = rmsnorm(p0["ln"], embed(model.params["emb"], prompts), cfg.norm_eps)
        _, (conv_fwd, st_fwd) = mamba2_forward(p0["mixer"], cfg, h0, impl="kernel")
        cache = model.init_cache(BATCH, 1)
        conv, st = cache["conv"][0], cache["ssm"][0]
        for t in range(PROMPT_LEN):
            mamba2_decode(p0["mixer"], cfg, h0[:, t:t + 1], conv, st)
    state_err = scaled_compare("layer 0 SSM state, prefill kernel vs decode", st_fwd, st,
                               2e-2, 2e-2, True)
    conv_equal = bool(torch.equal(conv_fwd, conv))

    prefill_ms = timed["prefill_s"] * 1e3
    decode_ms = timed["generate_s"] * 1e3 / drive_steps
    row = {"phase": "serve_hybrid", "arch": cfg.name, "n_layers": cfg.n_layers,
           "shared_block_calls": n_shared, "dtype": "bfloat16", "impl": "kernel",
           "fused_ffn": True, "batch": BATCH, "prompt_len": PROMPT_LEN,
           "gen_steps": HYBRID_GEN_STEPS, "max_len": MAX_LEN, "launches": launches,
           "fused_ffn_launches_by_route": ker["by_route"],
           "logit_max_abs_diff": errs,
           "tokens_equal_naive": bool(torch.equal(toks, ref["tokens"])),
           "layer0_state_max_abs_err": state_err,
           "layer0_state_max_abs": float(st.abs().max()),
           "layer0_state_rel_err": rel_err(st_fwd, st),
           "layer0_conv_state_equal": conv_equal,
           "prefill_ms": prefill_ms, "prefill_device_ms": prefill_device_ms,
           "prefill_device_idle_share": 1 - prefill_device_ms / prefill_ms,
           "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": decode_device_ms,
           "decode_device_idle_share": 1 - decode_device_ms / decode_ms,
           "generate_s": timed["generate_s"],
           "generated_tokens_per_s": BATCH * HYBRID_GEN_STEPS / timed["generate_s"],
           "decode_tokens_per_s": BATCH * drive_steps / timed["generate_s"],
           "naive_prefill_ms": ref["prefill_s"] * 1e3,
           "naive_decode_ms_per_step": ref["generate_s"] * 1e3 / drive_steps,
           "first_run_prefill_ms": ker["prefill_s"] * 1e3,
           "max_memory_allocated_bytes": peak_bytes, "profile": profile}
    emit(row)
    by_route = {r: sum(step[r] for step in ker["by_route"].values()) for r in want_by_route["prefill"]}
    return {k: launches["prefill"][k] + launches["generate"][k] for k in want_prefill}, by_route


# --------------------------------------------------------------------------------
# the training path
# --------------------------------------------------------------------------------

KERNEL_CLASSES = (("K1 flash_attention", ("attn_fwd",)),
                  ("K2a flash_attention_bwd_dq", ("attn_bwd_dq",)),
                  ("K2b flash_attention_bwd_dkv", ("attn_bwd_dkv",)),
                  ("K3 flash_decode", ("decode_partial", "decode_combine")),
                  ("K4 fused_ffn", ("ffn_mma", "ffn_fma", "ffn_combine", "ffn_gate_up_mma",
                                    "ffn_down_mma")),
                  ("K5 ssd_scan", ("ssd_chunk_scan",)),
                  ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "nvjet")))


def profile_step(fn, top: int = 15) -> dict:
    """One call of ``fn`` under torch.profiler: the device time summed by
    kernel name, the top ``top`` of them, and the sums by class."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies, memsets), not the host-side
    # operators that launched them, which carry the same time again
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["everything else"] = 0.0
    for key, ms, _ in rows:
        low = key.lower()
        name = next((n for n, marks in KERNEL_CLASSES if any(m in low for m in marks)),
                    "everything else")
        by_class[name] += ms
    return {"device_ms": sum(r[1] for r in rows), "by_class_ms": by_class,
            "top": [{"kernel": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:top]]}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative norm error ||got - want|| / ||want|| in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def phase_train(cfg) -> dict:
    """tinyllama-1.1b at full width and depth, bf16 parameters, fp32 master
    weights and moments, remat "full": first the loss and every gradient of
    impl="kernel" against impl="naive" on the same weights and batch, then
    TRAIN_STEPS steps of make_train_step on one fixed batch (memorising it
    makes the loss fall), with the launch counts of the design."""
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import apply_updates, tree_leaves, tree_map, tree_unflatten

    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return {c.__name__: c.launches for c in counters}

    model = LanguageModel(cfg, impl="kernel", remat="full")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive", remat="full")
    naive.params = model.params                      # the same weights, not a copy
    data = DataLoader(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    try:
        _, batch = next(data)
    finally:
        data.close()
    batch = to_device(batch, torch.device("cuda"))
    layers = cfg.n_layers
    per_step = {"flash_attention": 2 * layers,       # forward, and its recompute under remat
                "flash_attention_bwd_dq": layers, "flash_attention_bwd_dkv": layers}

    # 1. the first step's loss and gradients, kernel path against naive path
    def paths(tree, prefix=""):                      # tree_leaves' order
        for k in sorted(tree.keys()):
            v = tree[k]
            yield from paths(v, f"{prefix}{k}.") if hasattr(v, "keys") else [prefix + k]

    keys = list(paths(model.params))

    def loss_and_grads(m):
        loss = m.loss(batch)
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(m.params))

    reset()
    k_loss, k_grads = loss_and_grads(model)
    one_step = counts()
    if one_step != per_step:
        raise AssertionError(f"launches in one loss+backward {one_step}, expected {per_step}")
    n_loss, n_grads = loss_and_grads(naive)
    # an fp32 oracle on the same (bf16-valued) weights: says which of the two
    # bf16 paths is off where they disagree
    exact = LanguageModel(cfg, impl="naive", remat="full")
    exact.load_params(tree_map(lambda p: p.detach().float(), model.params))
    e_loss, e_grads = loss_and_grads(exact)
    del exact
    if counts() != per_step:
        raise AssertionError("the naive path launched a kernel")
    grad_rel = {"kernel_vs_naive": {}, "kernel_vs_fp32": {}, "naive_vs_fp32": {}}
    for key, kg, ng, eg in zip(keys, k_grads, n_grads, e_grads):
        if not bool(torch.isfinite(kg).all()) or float(kg.float().norm()) == 0.0:
            raise AssertionError(f"kernel path: gradient of {key} is zero or non-finite")
        grad_rel["kernel_vs_naive"][key] = rel_err(kg, ng)
        grad_rel["kernel_vs_fp32"][key] = rel_err(kg, eg)
        grad_rel["naive_vs_fp32"][key] = rel_err(ng, eg)
    worst = {k: max(v.values()) for k, v in grad_rel.items()}
    for key, err in grad_rel["kernel_vs_naive"].items():
        if err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"gradient of {key}: kernel vs naive relative error "
                                 f"{err} > {TRAIN_GRAD_RTOL}")
        if grad_rel["kernel_vs_fp32"][key] > TRAIN_VS_ORACLE * grad_rel["naive_vs_fp32"][key]:
            raise AssertionError(f"gradient of {key}: the kernel path is further from the fp32 "
                                 f"oracle than the naive path: {grad_rel['kernel_vs_fp32'][key]} "
                                 f"vs {grad_rel['naive_vs_fp32'][key]}")
    loss_diff = abs(k_loss - n_loss)
    if loss_diff > TRAIN_LOSS_ATOL:
        raise AssertionError(f"first-step loss kernel {k_loss} vs naive {n_loss}")
    del k_grads, n_grads, e_grads

    # 2. the trainer's steps
    opt_cfg = OptimConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS)
    opt_state = init_opt_state(model.params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, opt_state, metrics = step(model.params, opt_state, batch)
        losses.append(float(metrics["loss"]))        # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"launch counts {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not all finite, or the last is not below the first")

    # 3. the device's own time for a step: one step captured in a CUDA graph,
    # replayed (the replays train on; the step counter stays where it was)
    device_step_ms = device_ms(lambda: step(model.params, opt_state, batch), launches=1, replays=3)

    profile = profile_step(lambda: step(model.params, opt_state, batch))
    # the optimizer's share of the device time: one apply_updates alone
    grads = tree_unflatten(model.params, loss_and_grads(model)[1])
    optimizer_device_ms = device_ms(lambda: apply_updates(model.params, grads, opt_state, opt_cfg),
                                    launches=1, replays=3)
    del grads

    host_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3     # median, first step excluded
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = count_params(model.specs()) - cfg.vocab_size * cfg.d_model   # less the lookup table
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn_flops = 12 * TRAIN_BATCH * cfg.n_heads * cfg.head_dim * pairs * layers
    model_flops = 6 * n_matmul * tokens + attn_flops
    row = {"phase": "train", "arch": cfg.name, "n_layers": layers, "dtype": "bfloat16",
           "master_weights": True, "moment_dtype": "float32", "remat": "full",
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "losses": losses, "first_step_loss": {"kernel": k_loss, "naive": n_loss, "fp32": e_loss,
                                                 "abs_diff": loss_diff},
           "grad_rel_err_max": worst, "grad_rel_err": grad_rel, "launches_per_step": per_step, "launches": launches,
           "step_ms_host": [x * 1e3 for x in step_s], "step_ms_host_median": host_ms,
           "step_ms_device": device_step_ms, "device_idle_share": 1 - device_step_ms / host_ms,
           "tokens_per_s": tokens / (host_ms / 1e3),
           "model_flops_per_step": model_flops, "mfu_host": model_flops / (host_ms / 1e3) / 989e12,
           "mfu_device": model_flops / (device_step_ms / 1e3) / 989e12,
           "max_memory_allocated_bytes": peak_bytes,
           "optimizer_device_ms": optimizer_device_ms, "profile": profile}
    emit(row)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    import repro_torch.configs as configs
    from repro_torch.kernels import build

    # fp32 references in IEEE fp32: no TF32 in the plain versions' products
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    nvcc = re.search(r"release ([\d.]+)", run_text([build.find_nvcc(), "--version"]))
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.group(1) if nvcc else None,
          "triton": importlib.util.find_spec("triton") is not None,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    ptxas = build_with_report()
    lib = build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": Path(lib._name).name,
          "sources": [str(s.relative_to(ROOT)) for s in build.sources()], "ptxas": ptxas})

    cfg, hybrid = configs.get(ARCH), configs.get(HYBRID_ARCH)
    emit(phase_occupancy(cfg))
    fa, fd = phase_checks(cfg)
    fa_train, bwd, bwd_more = phase_train_checks(cfg, configs.get(WIDE_ARCH))
    hyb = phase_hybrid_checks(hybrid, configs.get("mamba2-1.3b"))
    launches = phase_serve(cfg)
    hybrid_launches, ffn_by_route = phase_serve_hybrid(hybrid)
    train_launches = phase_train(cfg)

    def timing(row):
        return {"ms": row["kernel_ms"], "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}

    def bwd_shapes(part):
        return {key: {"shape": row["shape"], "plan": row["plan"], **timing(row[part]),
                      "library_ms": row["library_ms"]} for key, row in bwd_more.items()}

    def summary(name, source, replaces, launches_by_path, row, err, times, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(launches_by_path.values()),
                "launches_by_path": launches_by_path, "shape": row["shape"],
                "max_abs_err": err, **times, "library_ms": library_ms, **extra}

    bwd_err = bwd["max_abs_err"]
    bwd_library = {"library_covers": "dq, dk and dv: the backward of "
                                     "F.scaled_dot_product_attention (fwd+bwd less fwd)"}
    def by_path(name):
        return {"serve": launches.get(name, 0), "serve_hybrid": hybrid_launches.get(name, 0),
                "train": train_launches.get(name, 0)}

    ffn_p, ffn_d, ffn_256 = hyb["ffn_prefill"], hyb["ffn_decode"], hyb["ffn_threshold"]
    ssd = hyb["ssd_prefill"]
    emit({"kernels": [
        summary("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:96",
                by_path("flash_attention"),
                fa, fa["max_abs_err"], timing(fa), fa["library_ms"],
                train_shape={"shape": fa_train["shape"], **timing(fa_train),
                             "library_ms": fa_train["library_ms"]}),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:132",
                by_path("flash_attention_bwd_dq"), bwd, bwd_err["dq"],
                timing(bwd["dq"]), bwd["library_ms"], **bwd_library, plan=bwd["plan"],
                more_shapes=bwd_shapes("dq")),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:153",
                by_path("flash_attention_bwd_dkv"), bwd,
                max(bwd_err["dk"], bwd_err["dv"]), timing(bwd["dkv"]), bwd["library_ms"],
                **bwd_library, plan=bwd["plan"], more_shapes=bwd_shapes("dkv")),
        summary("flash_decode", "flash_decode.cu", "src/repro/kernels/flash_decode.py:75",
                by_path("flash_decode"), fd, fd["max_abs_err"], timing(fd),
                fd["library_ms"]),
        summary("fused_ffn", "fused_ffn.cu", "src/repro/kernels/fused_ffn.py:55",
                by_path("fused_ffn"), ffn_p, ffn_p["max_abs_err"], timing(ffn_p),
                ffn_p["library_ms"], library_covers=ffn_p["library_covers"],
                kernel_route=ffn_p["route"], chunk_rows=ffn_p["chunk_rows"],
                launches_by_route=ffn_by_route,
                routes_ms={"T=2048": routes_ms(ffn_p), "T=256": routes_ms(ffn_256)},
                alloc_extra_bytes=ffn_p["alloc_extra_bytes"],
                decode_shape={"shape": ffn_d["shape"], "route": ffn_d["route"],
                              "splits": ffn_d["splits"], **timing(ffn_d),
                              "library_ms": ffn_d["library_ms"]}),
        summary("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:89",
                by_path("ssd_scan"), ssd, max(ssd["max_abs_err"], ssd["state_max_abs_err"]),
                timing(ssd), None, library_none_because=ssd["library_none_because"])]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
