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
  serve    tinyllama-1.1b at full width and depth, bf16, seeded random
           weights: one 512-token prefill through `forward` (flash_attention)
           and `ServingEngine.generate` for 32 greedy steps (flash_decode at
           every layer of every step), with the launch counts the path must
           show, and the same two steps through impl="naive" as the reference
  kernels  the summary line: per kernel its launches on the serve path, error,
           time, plain time, bound and the library call's time
then the card's name and power limit, then {"ok": true, "device": ...}.
Any failed phase raises: the script exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import importlib.util
import json
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
# prefill-vs-decode tolerance on bf16 logits, as the model tests use it
LOGIT_ATOL, LOGIT_RTOL = 0.25, 0.05

ARCH, BATCH, PROMPT_LEN, GEN_STEPS, MAX_LEN = "tinyllama-1.1b", 4, 512, 32, 1024


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
    launches = phase_serve(cfg)

    def summary(row, name, replaces):
        return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name], "shape": row["shape"],
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "call_ms": row["call_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    emit({"kernels": [
        summary(fa, "flash_attention", "src/repro/kernels/flash_attention.py:96"),
        summary(fd, "flash_decode", "src/repro/kernels/flash_decode.py:75")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
