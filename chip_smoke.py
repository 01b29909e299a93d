#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py            # one NVIDIA Hopper card, nvcc, no network

Phases, one JSON object a line:
  env      the card (name, power limit), torch / CUDA / nvcc versions
  build    builds the CUDA kernels from src/repro_torch/csrc and loads them
  checks   every kernel against its plain PyTorch version on the card, over
           the serving path's shapes and the awkward ones (ragged lengths,
           D=128, KVH=H, non-causal, fp32), with device times (CUDA-graph
           replay), eager call times and roofline bounds
           and, for the training path, K1 and the backward kernels K2a (dq)
           and K2b (dk, dv) at the training shape and the awkward ones, each
           K2 launch repeated and required to agree bit for bit
  serve    tinyllama-1.1b at full width and depth, bf16, seeded random
           weights: one 512-token prefill through `forward` (flash_attention)
           and `ServingEngine.generate` for 32 greedy steps (flash_decode at
           every layer of every step), with the launch counts the path must
           show, and the same two steps through impl="naive" as the reference
  train    tinyllama-1.1b at full width and depth, bf16 with fp32 master
           weights and moments, remat "full": loss and every gradient of
           impl="kernel" against impl="naive", then 8 steps of
           make_train_step on one fixed 4 x 1024 batch (K1 twice, K2a and
           K2b once per layer and step), with the losses, step times (host
           clock, and one step replayed as a CUDA graph), tokens/s, MFU and
           peak memory
  kernels  the summary line: per kernel its launches on each path, error,
           time, plain time, bound and the library call's time
then the card's name and power limit, then {"ok": true, "device": ...}.
Any failed phase raises: the script exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import importlib.util
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


def bwd_compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    tol = BWD_TOL[dtype]
    atol = tol if dtype == torch.float32 else tol * float(want.abs().max())
    if not bool((err <= atol + tol * want.abs()).all()):
        raise AssertionError(f"{name}: max abs error {float(err.max())} exceeds "
                             f"{atol} + {tol}|want|")
    return float(err.max())


def check_flash_attention_bwd(gen, *, b, sq, skv, h, kvh, d, dtype, causal, timed=False) -> dict:
    """K2a and K2b against their plain versions, and twice on the same inputs
    (the two launches must agree bit for bit)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (attention_delta,
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
           "tol": BWD_TOL[dtype],
           "max_abs_err": {n: bwd_compare(f"flash_attention_bwd {n}", x, y, dtype)
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


def phase_train_checks(cfg) -> tuple[dict, dict]:
    """K2a/K2b over the training path's shape and the awkward ones, and K1 at
    the training path's shape; returns the two timed rows."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fa = check_flash_attention(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh, d=d,
                               dtype=bf16, causal=True, timed=True)
    bwd = check_flash_attention_bwd(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh,
                                    d=d, dtype=bf16, causal=True, timed=True)
    rows = [fa, bwd]
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
    ):
        rows.append(check_flash_attention_bwd(gen, **kw))
    for row in rows:
        emit({"phase": "checks", "path": "train", **row})
    return fa, bwd


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


# --------------------------------------------------------------------------------
# the training path
# --------------------------------------------------------------------------------

KERNEL_CLASSES = (("K1 flash_attention", ("attn_fwd",)),
                  ("K2a flash_attention_bwd_dq", ("attn_bwd_dq",)),
                  ("K2b flash_attention_bwd_dkv", ("attn_bwd_dkv",)),
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
    lib = build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": Path(lib._name).name,
          "sources": [str(s.relative_to(ROOT)) for s in build.sources()]})

    cfg = configs.get(ARCH)
    fa, fd = phase_checks(cfg)
    fa_train, bwd = phase_train_checks(cfg)
    launches = phase_serve(cfg)
    train_launches = phase_train(cfg)

    def timing(row):
        return {"ms": row["kernel_ms"], "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}

    def summary(name, source, replaces, launches_by_path, row, err, times, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(launches_by_path.values()),
                "launches_by_path": launches_by_path, "shape": row["shape"],
                "max_abs_err": err, **times, "library_ms": library_ms, **extra}

    bwd_err = bwd["max_abs_err"]
    bwd_library = {"library_covers": "dq, dk and dv: the backward of "
                                     "F.scaled_dot_product_attention (fwd+bwd less fwd)"}
    emit({"kernels": [
        summary("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:96",
                {"serve": launches["flash_attention"], "train": train_launches["flash_attention"]},
                fa, fa["max_abs_err"], timing(fa), fa["library_ms"],
                train_shape={"shape": fa_train["shape"], **timing(fa_train),
                             "library_ms": fa_train["library_ms"]}),
        summary("flash_attention_bwd_dq", "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:132",
                {"train": train_launches["flash_attention_bwd_dq"]}, bwd, bwd_err["dq"],
                timing(bwd["dq"]), bwd["library_ms"], **bwd_library),
        summary("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
                "src/repro/kernels/flash_attention_bwd.py:153",
                {"train": train_launches["flash_attention_bwd_dkv"]}, bwd,
                max(bwd_err["dk"], bwd_err["dv"]), timing(bwd["dkv"]), bwd["library_ms"],
                **bwd_library),
        summary("flash_decode", "flash_decode.cu", "src/repro/kernels/flash_decode.py:75",
                {"serve": launches["flash_decode"]}, fd, fd["max_abs_err"], timing(fd),
                fd["library_ms"])]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
