#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the card.

    python3 chip_smoke.py            # one NVIDIA Hopper card, nvcc, no network

Phases, one JSON object a line (each with `at_s`, the script's seconds
when the line was printed):
  env      the card (name, power limit), torch / CUDA / nvcc versions
  build    builds the CUDA kernels from src/repro_torch/csrc and loads them,
           with each kernel's registers and spill bytes as ptxas reports them
           (template instances named by their arguments, e.g.
           attn_bwd_dkv_mma<128,128,32>); K3's bf16 instances, K5's mma
           instances and the bf16 instances at MLA's head dims of K1
           (attn_fwd_mma<192,128>), K2a (attn_bwd_dq_mma<192,128,32>) and
           K2b (attn_bwd_dkv_mma<192,128,16>) must not spill
  check    the static analyser (`repro_torch.check`) over its catalog, from
           the kernels' launch plans, K3's cluster sizes as `launch_plan`
           picks them on this card, R5 reading the build's ptxas report:
           cases, launch plans, findings (any unwaived one fails) and seconds
  sweep    the analytic stack (core.stackdist, core.cachesim, core.sweep)
           over every scenario of the port's registry, kernel.* included,
           at full size: SweepEngine(registry.scenarios(), copa.TABLE_V) with
           device="cuda" against device="cpu" (the NumPy scans), every row's
           DRAM/L3/UHB bytes, time, speedup and segments; each side's host
           seconds cold and warm; every stream's reuse distances from the
           card's batch pass equal to the host's to the bit (the longest
           MLPerf stream among them); StreamBatch.traffic_matrices over the
           whole registry at every capacity Table V and the baseline need,
           fills to the bit and writebacks at rtol 1e-12; serve_cost_grids
           for resnet (and gnmt with a KV axis) on both sides; the two scans
           on awkward rows (one touch, pads only, a length that is not a
           power of two, a seeded stream with heavy reuse, the longest
           stream alone); each scan's device ms (CUDA events) beside its
           NumPy ms on the host, the peak device memory, and the model's
           per-config geomean speedups over mlperf.infer.large and
           mlperf.train.large (the paper's GPU-N configurations: model
           output, not a card measurement); the phase's seconds
  occupancy  cudaOccupancyMaxActiveClusters of K2b's cluster launch at the
           training shape and at MLA's (deepseek-v2-236b's heads, head dims
           (192, 128)), with its plan
  checks   every kernel against its plain PyTorch version on the card, over
           the serving path's shapes and the awkward ones (ragged lengths,
           D=128, KVH=H, G=6, KVH=1, non-causal, fp32), with device times
           (CUDA-graph replay), eager call times and roofline bounds;
           K3 (one cluster launch a call) also at zamba2-1.2b's shared block
           (G=1), B=8 S=2048 and a 32k-token cache at mistral-nemo-12b's
           heads (all timed, with `sdpa` beside them), G=17 and G=32 (16-row
           fragments), each row with its plan, launched twice (bit-identical),
           with kv_len as a host int and as an int32 tensor on the card
           (bit-identical), allocating no more than its output; and E2: one
           tensor-kv_len call captured in a CUDA graph and replayed at six
           positions, each replay equal to the host-int launch bit for bit;
           and, for the training path, K1 and the backward kernels K2a (dq)
           and K2b (dk, dv) at the training shape and the awkward ones (also
           G=6 and G=16, K2b's clusters of 6 and of 8 blocks walking 2 heads),
           each K1 and K2 launch repeated and required to agree bit for bit,
           each K2 row with its plan (tiles, cluster size); K1 and K2 also
           timed at S=4096 (B=1), at D=128 (yi-6b's heads, B=2, S=1024), at
           MLA's training shape (deepseek-v2-236b: B=4 S=1024
           H=KVH=128, q/k 192, v 128; K2 beside `sdpa`'s backward, with the
           kernels it ran named) and at the GQA-MoE's (qwen3-moe-235b-a22b:
           B=4 S=1024 H=64 KVH=4 D=128, G=16), and checked at MLA's head dims at S=333,
           Sq=200 Skv=333 non-causal, G=4 and fp32 (K1 and K2 each);
           K1 and K3 also timed at the two D=128 models' serving shapes
           (internvl2-26b G=6, qwen3-moe-235b-a22b G=16: prefill B=4 S=512,
           decode kv_len 527); K1 at MLA's head dims (q/k 192, v 128):
           timed at deepseek-v2-236b's prefill (B=4 S=512 H=KVH=128), with
           the kernels `sdpa` ran named, and at S=333, Sq=200 Skv=333
           non-causal, G=4 and fp32 (all timed)
  serve    tinyllama-1.1b at full width and depth, bf16, seeded random
           weights: one 512-token prefill through `forward` (flash_attention)
           and `ServingEngine.generate` for 32 greedy steps (flash_decode at
           every layer of every step), with the launch counts the path must
           show, and the same two steps through impl="naive" as the reference;
           two kernel-path drives equal to the bit; times (host clock,
           CUDA-graph replay) and a torch.profiler breakdown of one prefill
           step and one decode step
  checks   (hybrid path) K4 fused_ffn at zamba2-1.2b's prefill (T=2048) and
           decode (T=4) shapes, the tiled route's threshold T=256, T=1025
           (two row chunks of h, the second ragged), T=8192 (eight chunks),
           F=1000, tinyllama's F=5632, T=333 and fp32, every bf16 shape on
           both routes (tiled and rowtile; the route ffn_plan picks is the
           row's own, both timed at T=2048 and T=256), with the route and
           h's chunk rows; K5 ssd_scan at the prefill shape (N=64; again with
           Mamba-2's small dt, bf16 and fp32, so the state carries across
           chunks), mamba2-1.3b's N=128, a long prompt (B=1 S=8192), S=333,
           S=1 and fp32 shapes, y and final state, every bf16 shape on both
           routes (mma and fma; the route ssd_plan picks is the row's own;
           both timed at the prefill shape, N=128 and S=8192); bf16 outputs
           held elementwise and by relative norm;
           each launched twice and required bit-identical; K4's allocation
           at T=2048 and T=8192 held below one (T x F) bf16 tensor and to
           16 MiB + 1 MiB
  checks   (K3's partial entry, for a sequence-sharded cache) at the serve
           row's shape and at zamba2-1.2b's shared block (G=1), a cache of
           1024 rows, bf16, kv_len 543, 512 and 1: fp32 out and lse against
           the plain version, launched twice (bit-identical), kv_len as a
           tensor (bit-identical); the cache split 2, 4 and 8 ways, each
           shard's partial at its own length (0 past kv_len) merged by
           kernels.ops.combine_partials, against whole-cache K3 and the plain
           version; device ms (graph replay) of the entry, its plain version,
           `sdpa` on the same rows and each split, beside their bounds; and
           both entries (and the dispatch) on an int8 cache: a TypeError
           naming the dtypes K3 reads, no launch
  serve_hybrid  zamba2-1.2b at full width and depth (38 Mamba-2 blocks, 6
           calls of the shared attention + MLP block), bf16, seeded random
           weights, impl="kernel" with fused_ffn: the prefill step on 4 x 512
           prompts and on their first 64 tokens (each K5 38 launches, all on
           the mma route, and K4 6, all on the tiled route; K1 6 at 512, none
           at 64: the reference's naive attention up to 256) and `generate`
           for 16 greedy steps after the 64-token prompt (K3 and K4 6 x 79
           each, K4 on the row-tile route), the engine held against the
           4 x 64 prefill step, against impl="naive" without
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
  dryrun   launch.dryrun on the host (no kernel launched), in a child
           process of its own, started and awaited here (nothing else runs
           beside it): each cell's step through the port's mesh path
           as rank 0 of a fake process group of the mesh's size, on meta
           tensors; tinyllama-1.1b's four grid shapes on the 16 x 16 mesh
           (three ok, long_500k skipped: the three roofline terms, the
           dominant one, argument and peak bytes a device, fits, rank 0's
           collectives by kind), decode_32k again with an int8 cache (its
           argument bytes the bf16 cell's less half the cache's), then the
           train phase's own cell on a (1, 1) mesh held against that phase:
           its argument bytes equal to the parameters, optimizer state and
           batch the phase held, exactly, no collective byte; the dry-run's
           peak beside the step's max_memory_allocated, the roofline bound
           (core.hw.H100_SXM, the denominator of every bound and MFU here)
           beside the step's device time, and useful_flops_cell beside the
           row's model FLOPs
  serve_vlm  internvl2-26b at full width and depth (48 layers, d 6144, GQA at
           H=48 KVH=8 D=128), bf16, seeded random weights: the prefill step on
           4 x 512 prompts with 256 seeded patch embeddings (K1 48), without
           them (K1 48), and on their first 64 tokens (no K1), and `generate` for 16 greedy
           steps after the 64-token prompt (K3 48 x 79), against
           impl="naive" on the same weights; the engine (token ids only, as
           the reference's) against the 4 x 64 prefill step
  serve_moe  qwen3-moe-235b-a22b at full width (d 4096, 128 experts, top-8,
           GQA at H=64 KVH=4 D=128) and 6 of its 94 layers, bf16: the prefill
           step on 4 x 512 (K1 6) and on their first 64 tokens (no K1) and
           `generate` for 16 steps after the 64-token prompt (K3 6 x 79), against
           impl="naive" sending each token to the experts the kernel path
           chose (the naive path's own picks recorded: the share of routing
           decisions that agree), the (token, expert) assignments capacity
           drops in the 4 x 512 prefill; the bf16 logits held kernel against
           naive, and the engine against a 4 x 64 prefill step that drops
           nothing and routes as the engine's prompt steps did; then 2 layers in fp32,
           each path routing for itself, kernel against naive logits held
           at 1e-4, routing identical.
  serve_mla  deepseek-v2-236b at full width (d 5120, MLA: 128 heads,
           kv_lora 512, q_lora 1536, rope 64, v 128; 160 experts top-6, 2
           shared) and 4 of its 60 layers (the dense-FFN layer + 3 MoE
           layers), bf16, run by serve_moe's code: the prefill steps (K1
           4 at 512, at head dims (192, 128)) and `generate` for 16 steps (the
           absorbed decode on the latent cache: no kernel, K3 0); then the
           dense layer + 1 MoE layer in fp32.
           All three rows: device ms (graph replay) and eager ms of the prefill
           and decode steps, idle shares, a torch.profiler breakdown of each
           step, peak memory (after init and while driving), phase seconds
  train_mla  deepseek-v2-236b at full width, cut to 2 of its 60 layers (the
           dense-FFN layer + 1 MoE layer, 5.36 B parameters), bf16, remat
           "full", one fixed 4 x 1024 batch: the loss and every gradient
           leaf of impl="kernel" against impl="naive" and an fp32 oracle on
           the same weights, both sending each token to the experts the
           kernel path chose (the bf16 gradient sets wait in host memory
           while the oracle runs), and two kernel-path passes equal to the
           bit; then 8 steps of make_train_step with the reference's
           large-model recipe (TRAIN_LARGE_MSM: bf16 moments, no master
           weights, stochastic rounding, bf16 gradient compression;
           microbatches 1), K1 4, K2a 2, K2b 2 launches a step, losses
           falling; step times (host clock, and the profiler's kernel-time
           sum), tokens/s, MFU over the active parameters (6 routed + 2
           shared experts a token), peak memory, the optimizer's device
           time and a torch.profiler breakdown of one step
  checks   (family paths) K1 and K2 at whisper-base's encoder (B=8, 1500
           frames, non-causal, ragged), decoder (448 tokens, causal) and
           cross-attention (448 queries against 1500 frames), at H = KVH = 8
           D = 64, and at zamba2-1.2b's training shape (B=4 S=1024 H = KVH =
           32: K2b's clusters of 1); K3 at the whisper engine's cross cache (B=4,
           S = kv_len = 1500) and self cache (S=448 at kv_len 79); all timed,
           with `sdpa` beside them
  serve_audio  whisper-base at full size (6 encoder + 6 decoder layers, d
           512, H = KVH = 8, D = 64, vocab 51865), bf16, seeded random weights:
           the prefill step on 4 x (1500 seeded frames, 448 tokens) (K1 18:
           encoder, self- and cross-attention) and `generate` for 16 steps
           after a 64-token prompt (K3 2 x 6 x 79), the engine's cross caches
           of 1500 rows holding seeded values this harness writes (the
           reference's engine leaves them zeros), against impl="naive" on the
           same weights and cross caches; times and profiles as serve's
  train_audio  whisper-base at full size, one fixed batch of 8 x (1500
           frames, 448 tokens), bf16 with fp32 master weights and moments
           (TRAIN_MSM), remat "full": the loss and every gradient leaf of
           impl="kernel" against impl="naive" and an fp32 oracle, two kernel
           passes equal to the bit, then 8 steps at lr 1e-3 (K1 36, K2a 18,
           K2b 18 a step), losses falling; step times (host clock, and the
           profiler's kernel-time sum), tokens/s, MFU, peak memory
  train_hybrid  zamba2-1.2b at full size, 4 x 1024, TRAIN_MSM, remat
           "full", impl="kernel" with scan="naive" (K5 has no backward): the
           same checks and numbers as train_audio (K1 12, K2a 6, K2b 6 a
           step), and the naive scan's share of the step: its device time on
           one layer's shape, forward and forward + backward, times 38 layers
  train_ckpt  tinyllama-1.1b at full width, cut to 4 of its 22 layers, through
           launch.train's runner
           (make_runner, as its main builds it: TRAIN_MSM, remat "full",
           impl="kernel", 4 x 1024 batches from the data pipeline). Run A: 4
           steps, no checkpoint. Run B: 4 steps with --ckpt-dir (a directory
           under build/, removed at the end; at least 3 checkpoints of free
           disk required) and --save-every 2, its segment failing once after
           step 3, before that step's save: one restart, resumed from step 2
           (K1 2 x 4, K2a 4, K2b 4 a step: A 4 steps, B 5). B's resumed
           losses, final parameters and optimizer state equal A's to the bit;
           `restore` of step 4 equals B's in-memory state; the restored
           parameters served (prefill step on 4 x 512, K1 4; `generate` 16
           steps, K3 4 x 527), the prefill logits equal to the bit to those
           of A's parameters (K1 4) and close to the naive path's. Reports
           the checkpoint's bytes, each save's hold on the loop
           (wait + snapshot), background write seconds and GB/s, restore
           seconds and GB/s, the doubled last save's cost, free disk before
           the phase, peak device memory across the restart
  train_mesh  tinyllama-1.1b at full size through launch.train's runner,
           4 steps without a mesh (A) and 4 with --mesh-model 1 (B): a (1, 1)
           NCCL mesh from make_host_mesh() on the one card, parameters,
           optimizer state and batches DTensors in the reference's
           placements. B's losses, final parameters and optimizer state equal
           A's to the bit; K1 2 x 22, K2a 22, K2b 22 a step in each run; B's
           final parameters take the first batch's loss through the mesh at
           impl="kernel" and impl="naive"; each run's host step times and one
           more profiled step, and the differences B - A
  train_mesh_moe  the moe family at full width and cut depth:
           qwen3-moe-235b-a22b at 1 of its 94 layers (3 steps) and
           deepseek-v2-236b at its dense layer + 1 MoE layer (2 steps), with
           the large-model recipe (bf16 moments, no master weights,
           stochastic rounding, bf16 gradient compression), remat "full",
           the pipeline's 4 x 1024 batches; each without a mesh (A) and
           through make_host_mesh()'s (1, 1) NCCL mesh in launch.train.build's
           placements (B), the routed experts' grid over "model" and "data".
           B's losses, final parameters and optimizer state equal A's to the
           bit; K1 2 x layers, K2a and K2b layers a step in each run; per
           model and run: host step times, one more profiled step, B - A,
           the share of (token, expert) assignments the capacity dropped,
           peak memory
  train_mesh_ssm  the hybrid and ssm families at full size through
           launch.train's runner (TRAIN_MSM, remat "full", impl="kernel",
           the naive scan, 4 x 1024 pipeline batches, 3 steps):
           zamba2-1.2b (38 Mamba-2 blocks, 6 shared-block calls) and
           mamba2-1.3b (48 blocks, state 128), each without a mesh (A) and
           with --mesh-model 1 (B), every Mamba-2 mixer on the rank's rows
           with its weights gathered. B's losses, final parameters and
           optimizer state equal A's to the bit, every leaf of B a DTensor;
           K1 2 x 6, K2a 6, K2b 6 a step (zamba2-1.2b) and none
           (mamba2-1.3b), K4 and K5 none, in each run; per model and run:
           host step times, one more profiled step, B - A, the first step
           beyond the median (B's over A's: sharding propagation), peak
           memory
  pipeline  GPipe (distributed.pipeline.pipeline_apply) through a one-stage
           NCCL "pipe" mesh from make_compat_mesh((1,), ("pipe",)) (one card:
           S = 1, bubble 0, no point-to-point op; S > 1 runs on gloo only):
           the reference test's case (M = 8 microbatches of 2 x 16, one
           tanh(x @ w_s) layer, fp32) within 1e-5 (forward) and 1e-4
           (gradients) of the sequential loop; then tinyllama-1.1b's 22
           dense blocks at full width as the one stage, 4 microbatches of 1
           x 1024 bf16 hidden states, forward and backward against the same
           blocks applied microbatch by microbatch: output and x's gradient
           equal to the bit, each layer gradient equal to the bit or within
           2^-7 by relative norm; K1 2 x 88, K2a 88, K2b 88 pipelined (88
           each in the loop); host and profiled device ms of a step of each,
           peak memory
  serve_mesh  ServingEngine without a mesh and through make_host_mesh()'s
           (1, 1) NCCL mesh (parameters in param_shardings' placements, the
           cache in cache_shardings'), kernel path, bf16, seeded weights:
           tinyllama-1.1b at full width and depth, 4 x 64-token prompts and
           16 greedy steps; zamba2-1.2b at full size with fused_ffn, 4 x 64
           and 8 steps; tinyllama-1.1b at batch 1, an 8-token prompt and 4
           steps, where the cache's sequence goes over "data" and every
           layer's decode takes K3's partial entry and the combine;
           whisper-base at full size, 4 x 16 + 8 steps and at batch 1, 8 +
           4 (its self and cross caches' sequences over "data": K3's
           partial entry at kv_len 1500 for the cross-attention), the cross
           caches holding 1500 seeded rows, the same in both runs. Tokens
           equal, logits within LOGIT_ATOL (the largest difference and
           whether it is 0), K3 (self and cross) and K4 launches equal to
           the run without the mesh, every cache leaf a DTensor in
           cache_shardings' placements; host ms a decode step (median,
           first), device ms of one more step (profiler), peak memory. The
           prefill step without the mesh and through it (its batch placed
           as launch/specs places a prefill cell's): tinyllama-1.1b and
           zamba2-1.2b (fused_ffn) on 4 x 512 tokens, whisper-base on each
           run's batch x (1500 frames, 448 tokens); last-position logits
           within LOGIT_ATOL, launches equal to the run without the mesh
           and as designed (K1 22; K5 38 on the mma route, K1 6, K4 6 on
           the tiled route; K1 18), host ms of the first and second call,
           device ms of a third (profiler), peak memory; the phase's
           seconds
  kernels  the summary line: per kernel its launches on each path (serve,
           serve_hybrid, serve_vlm, serve_moe, serve_mla, train, train_mla,
           serve_audio, train_audio, train_hybrid, train_ckpt, train_mesh,
           train_mesh_moe, train_mesh_ssm, pipeline, serve_mesh), error, time,
           plain time, bound and the library call's time; K3's partial entry
           (flash_decode_partial) as its own entry, with its rows by kv_len
           and split; K1 and K2 also at S=4096, D=128, MLA's and the
           GQA-MoE's training shapes and the family paths' four shapes, K1 also at the two D=128 models' and the MLA
           model's prefill, K3 with its plan and at its seven other timed shapes
           (`more_shapes`); K4 also its launches by
           route and both routes' times at T=2048 and T=256; K5 its launches
           by route and both routes' times at its three timed shapes
then the card's name and power limit, then {"ok": true, "device": ...}.
Any failed phase raises: the script exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.check.ptxas import ptxas_report  # noqa: E402
from repro_torch.core.hw import H100_SXM  # noqa: E402  (the port's one source of peaks)

# published peaks of one H100 SXM (NVIDIA data sheet, dense rates), the
# denominators of every bound and MFU here
HBM_BYTES_PER_S = H100_SXM.hbm_bandwidth
PEAK_FLOPS = {torch.bfloat16: H100_SXM.bf16_tflops * 1e12,
              torch.float32: H100_SXM.fp32_tflops * 1e12}
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
LONG_ARCH = "mistral-nemo-12b"   # K3 timed at its heads over a 32k cache: H=32, KVH=8, D=128
HYBRID_ARCH, HYBRID_GEN_STEPS = "zamba2-1.2b", 16
VLM_ARCH, MOE_ARCH, FAMILY_GEN_STEPS = "internvl2-26b", "qwen3-moe-235b-a22b", 16
VLM_PATCHES = 256          # the reference's patch positions for a vlm (launch/specs.py)
# the engine's prompt in serve_hybrid, serve_vlm, serve_moe and serve_mla:
# the engine takes a prompt one decode step a token, so a 512-token prompt
# made these phases host-bound for minutes. The prefill step still runs on
# BATCH x PROMPT_LEN; the engine is held against a prefill step on its own
# BATCH x ENGINE_PROMPT prompt (the first ENGINE_PROMPT tokens of the same
# prompts), which launches no K1: a prefill of 256 positions or fewer takes
# the naive attention, the reference's shortcut (models.attention.sdpa).
# serve and train_ckpt keep the engine at PROMPT_LEN.
ENGINE_PROMPT = 64
# qwen3-moe-235b-a22b at full width, cut in depth to fit one 80 GB card: 6 of
# its 94 layers in bf16 (16.2 B parameters), 2 in fp32 (6.2 B)
MOE_LAYERS, MOE_FP32_LAYERS = 6, 2
# deepseek-v2-236b (MLA) at full width, cut in depth: its first_k_dense layer
# and 3 MoE layers in bf16 (13.30 B parameters), the dense layer and 1 MoE
# layer in fp32 (5.36 B)
MLA_ARCH, MLA_LAYERS, MLA_FP32_LAYERS = "deepseek-v2-236b", 4, 2
# its training (train_mla): the first_k_dense layer and 1 MoE layer (5.36 B
# parameters) at TRAIN_BATCH x TRAIN_SEQ
MLA_TRAIN_LAYERS = 2
# fp32 logits, kernel path against naive path: the CPU model tests' tolerance
LOGIT_TOL_FP32 = 1e-4
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
SSD_LONG_S = 8192          # K5 timed on one long prompt (B=1) at zamba2-1.2b's heads
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 8, 1e-3
# whisper-base (the encoder-decoder) at full size: 1500 encoder frames (30 s
# of audio) and a 448-token decoder context, its published sizes. Served at
# batch 4 with a 64-token prompt and 16 steps, the cross caches holding
# AUDIO_FRAMES seeded rows; trained at batch 8 over 1500 frames + 448 tokens
AUDIO_ARCH, AUDIO_FRAMES, AUDIO_MAX_LEN = "whisper-base", 1500, 448
AUDIO_PROMPT, AUDIO_GEN_STEPS, AUDIO_TRAIN_BATCH = 64, 16, 8
# serve_audio's logits, kernel path against naive path, by relative norm:
# whisper's logits on its seeded init spread only ~0.14, under LOGIT_ATOL.
# A cross-attention that contributes nothing must read at least
# AUDIO_BLIND_MARGIN times this bound, or the check could not see it
AUDIO_LOGIT_REL_NORM, AUDIO_BLIND_MARGIN = 5e-2, 4
# kernel path against naive path on the card, bf16: each gradient leaf's
# relative norm error, and the first step's loss. Both bf16 paths are 1-3 %
# off an fp32 oracle in every leaf (ffn weights as much as attention's: the
# rounding of the whole 22-layer model, not of the kernels), so the leaves
# are held at 4e-2 against each other, and the kernel path must be no
# further from the fp32 oracle than the naive path is (within 10 %)
TRAIN_GRAD_RTOL, TRAIN_LOSS_ATOL, TRAIN_VS_ORACLE = 4e-2, 1e-2, 1.1
# train_ckpt: launch.train's runner on tinyllama-1.1b at full width, cut to
# CKPT_LAYERS of its 22 layers, 4 steps, a checkpoint every 2 into a directory
# inside the checkout (ignored by git, removed at the end); run B's segment
# fails once right after its third step, before that step's save, so it
# resumes from step 2. Each checkpoint holds the bf16 parameters and fp32
# master weights, mu and nu (4.30 GB at 4 layers; 15.40 GB at all 22, whose
# three writes and two reads held the phase at the disk's rate for minutes);
# at the doubled last save, steps 2 and 4 and step 4's second copy, not yet
# renamed into place, are on the disk at once, so 3 checkpoints and
# CKPT_DISK_MARGIN must be free
CKPT_DIR = ROOT / "build" / "train_ckpt"
CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_FAIL_AFTER, CKPT_LAYERS = 4, 2, 3, 4
CKPT_DISK_MARGIN = 2 << 30
# train_mesh: launch.train's runner on tinyllama-1.1b at full size, without a
# mesh and through a (1, 1) mesh on the card, MESH_STEPS steps each
MESH_STEPS = 4
# train_mesh_moe: (arch, layers, steps) of the moe family at full width, cut
# in depth, without a mesh and through a (1, 1) mesh: qwen3-moe-235b-a22b at
# 1 of its 94 layers (3.73 B parameters, ~30 GB of parameters, gradients and
# bf16 moments), deepseek-v2-236b at its dense layer and one MoE layer (5.36 B)
MESH_MOE_RUNS = ((MOE_ARCH, 1, 3), (MLA_ARCH, MLA_TRAIN_LAYERS, 2))
# train_mesh_ssm: (arch, steps) of the hybrid and ssm families at full size,
# without a mesh and through a (1, 1) mesh: zamba2-1.2b (38 Mamba-2 blocks, 6
# shared-block calls) and mamba2-1.3b (48 Mamba-2 blocks, state 128)
MESH_SSM_RUNS = ((HYBRID_ARCH, 3), ("mamba2-1.3b", 3))
# pipeline: GPipe through a one-stage NCCL "pipe" mesh (one card, one rank).
# (a) the reference test's case (tests/test_pipeline.py): M = 8 microbatches
# of 2 x 16, one tanh(x @ w_s) layer a stage, fp32, held to the sequential
# loop at its limits (forward, gradients). (b) tinyllama-1.1b's 22 dense
# blocks as the one stage, M = PIPE_MICROBATCHES microbatches of 1 x
# PIPE_SEQ positions of bf16 hidden states, against the same block applied
# microbatch by microbatch; a gradient whose sum over the microbatches runs
# in another order than the loop's is held by relative norm at
# PIPE_GRAD_RTOL, two bf16 roundings (2^-8) of the sum of 4 microbatches;
# each step timed PIPE_REPEATS times on the host clock
PIPE_CASE = (8, 2, 16)
PIPE_FWD_TOL, PIPE_GRAD_TOL = 1e-5, 1e-4
PIPE_MICROBATCHES, PIPE_SEQ, PIPE_REPEATS = 4, 1024, 4
PIPE_GRAD_RTOL = 2 ** -7
# K3's partial entry: the cache of MAX_LEN rows split PARTIAL_SPLITS ways on
# the one card, at kv_len 543 (inside a middle shard of 4 and 8), 512 (on a
# shard boundary of every split) and 1 (every shard but the first empty)
PARTIAL_SPLITS, PARTIAL_KV_LENS = (2, 4, 8), (543, 512, 1)
# serve_mesh: (arch, fused_ffn, batch, prompt, steps, prefill) through
# ServingEngine without a mesh and through make_host_mesh()'s (1, 1) NCCL
# mesh, at full width and depth; short prompts cut the length, not the
# model. At batch 1 the cache's sequence goes over "data" (shard_seq), which
# sends every layer's decode through K3's partial entry and the combine
# (whisper-base's cross-attention too, at kv_len AUDIO_FRAMES). Where
# `prefill` is set, the run also takes the prefill step without the mesh and
# through it: BATCH x PROMPT_LEN tokens, whisper-base the run's batch x
# (AUDIO_FRAMES frames, AUDIO_MAX_LEN tokens); whisper-base's engine holds
# AUDIO_MAX_LEN positions and AUDIO_FRAMES seeded cross-cache rows
SERVE_MESH_RUNS = ((ARCH, False, BATCH, 64, 16, True), (ARCH, False, 1, 8, 4, False),
                   (HYBRID_ARCH, True, BATCH, 64, 8, True),
                   (AUDIO_ARCH, False, BATCH, 16, 8, True), (AUDIO_ARCH, False, 1, 8, 4, True))


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
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


def build_with_report() -> dict:
    """Builds the kernels with ``-Xptxas -v`` and returns ``ptxas_report``."""
    from repro_torch.kernels import build

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        build.build(verbose=True)
    return ptxas_report(out.getvalue())


def phase_check(ptxas: dict) -> None:
    """``repro_torch.check`` over its catalog on this card: K3's cluster of
    each decode case from ``launch_plan`` (the occupancy query), R5 against
    the build's ``ptxas`` report. Raises on any unwaived finding."""
    from repro_torch.check import catalog
    from repro_torch.check.rules import run_rules
    from repro_torch.kernels.flash_decode import launch_plan

    t0 = time.perf_counter()
    clusters = {}

    def decode_cluster(b, h, kvh, s, d, dtype, partial):
        c = launch_plan(0, b, h, kvh, s, d, dtype, partial).cluster
        clusters[f"B={b} H={h} KVH={kvh} S={s} D={d}{' partial' if partial else ''}"] = c
        return c

    facts = catalog.trace_all(decode_cluster=decode_cluster)
    findings = run_rules(facts, ptxas=ptxas)
    unwaived = [f.format() for f in findings if not f.waived]
    emit({"phase": "check", "cases": len(catalog.case_names()), "launch_plans": len(facts),
          "findings": len(unwaived), "waived": len(findings) - len(unwaived),
          "decode_clusters": clusters, "seconds": time.perf_counter() - t0})
    if unwaived:
        raise AssertionError("check: unwaived findings:\n" + "\n".join(unwaived))


# --------------------------------------------------------------------------------
# the analytic stack: its two batched scans on the card against NumPy

SWEEP_WB_RTOL = 1e-12   # writebacks go through log/exp; every other sum is of whole numbers


def sweep_close(a: float, b: float, scale: float = 0.0) -> bool:
    """``a`` and ``b`` equal (NaN and inf included), or within
    ``SWEEP_WB_RTOL`` of the larger of them and ``scale``."""
    if a == b or (math.isnan(a) and math.isnan(b)):
        return True
    if not (math.isfinite(a) and math.isfinite(b)):
        return False
    return abs(a - b) <= SWEEP_WB_RTOL * max(abs(a), abs(b),
                                             scale if math.isfinite(scale) else 0.0)


def same_bits_value(a, b) -> bool:
    """Equal, NaN to NaN, through a row's segment dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits_value(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def same_row(a, b) -> bool:
    return all(same_bits_value(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def sweep_grids_agree(got, want) -> dict:
    """Every row of the card's grid against the host's: bytes, times and
    speedups at rtol 1e-12, each segment (a difference of two times) at
    1e-12 of its row's time. Raises on the first disagreement."""
    assert len(got.rows) == len(want.rows)
    worst = 0.0
    for a, b in zip(got.rows, want.rows):
        assert (a.trace, a.config, a.n_gpus) == (b.trace, b.config, b.n_gpus)
        for f in ("dram_bytes", "l3_bytes", "uhb_bytes", "l2_bytes", "time_s",
                  "per_gpu_time_s", "baseline_time_s", "speedup", "throughput",
                  "dram_joules", "l3_joules"):
            x, y = getattr(a, f), getattr(b, f)
            if not sweep_close(x, y):
                raise AssertionError(f"sweep: {a.trace} {a.config} {f}: card {x!r}, host {y!r}")
            if x != y and math.isfinite(y) and y:
                worst = max(worst, abs(x - y) / abs(y))
        assert a.segments.keys() == b.segments.keys()
        for k in a.segments:
            if not sweep_close(a.segments[k], b.segments[k], abs(b.time_s)):
                raise AssertionError(f"sweep: {a.trace} {a.config} segment {k}: card "
                                     f"{a.segments[k]!r}, host {b.segments[k]!r}")
    return {"rows": len(got.rows), "max_rel_diff": worst,
            "rows_equal_to_the_bit": sum(same_row(a, b) for a, b in zip(got.rows, want.rows))}


def traffic_agree(name: str, got: tuple, want: tuple) -> float:
    """Fills to the bit, writebacks at ``SWEEP_WB_RTOL``; the writebacks'
    largest relative difference."""
    if not np.array_equal(got[0], want[0]):
        raise AssertionError(f"sweep: {name}: fills differ from the host's")
    wb, wb_want = got[1], want[1]
    bad = np.abs(wb - wb_want) > SWEEP_WB_RTOL * np.maximum(np.abs(wb), np.abs(wb_want))
    if bad.any():
        raise AssertionError(f"sweep: {name}: {int(bad.sum())} writebacks beyond rtol "
                             f"{SWEEP_WB_RTOL}")
    nz = wb_want != 0
    return float((np.abs(wb - wb_want)[nz] / np.abs(wb_want[nz])).max()) if nz.any() else 0.0


def event_ms(fn) -> tuple[object, float, float]:
    """``fn()``'s result, its device ms between two CUDA events and its host
    ms (the call ends with a copy to the host)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def sweep_random_trace(rng, n_ops: int, n_tensors: int, name: str, max_bytes: int):
    """Many touches of few tensors, whole-number sizes of any value."""
    from repro_torch.core.trace import Trace

    tr = Trace(name)
    sizes = rng.integers(1, max_bytes, n_tensors)
    for i in range(n_ops):
        reads = [(f"t{t}", int(sizes[t])) for t in rng.integers(0, n_tensors,
                                                                 int(rng.integers(1, 4)))]
        writes = [(f"t{t}", int(sizes[t])) for t in rng.integers(0, n_tensors,
                                                                  int(rng.integers(0, 2)))]
        tr.emit(f"op{i}", 1e6, reads=reads, writes=writes)
    return tr


def sweep_awkward(caps: list) -> dict:
    """The two scans on the card against NumPy on rows that are easy to get
    wrong: one touch each, a pad-only row, lengths that are not powers of
    two, a seeded stream with heavy reuse (the registry's longest streams
    alone are held in ``phase_sweep``)."""
    from repro_torch.core import cachesim, stackdist
    from repro_torch.core.trace import Trace

    cuda = torch.device("cuda")
    rng = np.random.default_rng(37)
    one = []
    for i in range(3):
        tr = Trace(f"one{i}")
        tr.emit("op", 1.0, reads=[(f"w{i}", 1000 * (i + 1))])
        one.append(cachesim.build_stream(tr, cyclic=False))
    cases = {
        "one_touch": one,
        "not_pow2": [cachesim.build_stream(sweep_random_trace(rng, n, 5, f"np{n}", 1 << 22))
                     for n in (333, 37, 1000)],
        "heavy_reuse": [cachesim.build_stream(sweep_random_trace(rng, 2500, 6, "heavy",
                                                                 40 << 20))],
    }
    out = {}
    for name, rows in cases.items():
        dist = cachesim._device_distances({i: (s.tensor_idx, s.sizes)
                                           for i, s in enumerate(rows)}, cuda)
        for i, s in enumerate(rows):     # build_stream's distances are the NumPy pass's
            if not np.array_equal(dist[i], s.dist):
                raise AssertionError(f"sweep: {name}: distances differ from the host's")
        extra = [float(np.median([d for s in rows for d in s.dist if np.isfinite(d)] or [1.0]))]
        c = sorted(set(caps) | set(extra))
        wb = traffic_agree(name, cachesim.StreamBatch.pad(rows, device=cuda).traffic_matrices(c),
                           cachesim.StreamBatch.pad(rows).traffic_matrices(c))
        out[name] = {"rows": len(rows), "touches": [len(s.op_idx) for s in rows],
                     "wb_max_rel_diff": wb}
    # pads only: a row of PAD_ID and size 0 beside real rows, and the same
    # row appended to a traffic block (size 0, +inf distance, nothing recorded)
    ids = np.full((3, 64), stackdist.PAD_ID, dtype=np.int64)
    sizes = np.zeros((3, 64))
    ids[0] = rng.integers(0, 7, 64)
    sizes[0] = rng.integers(1, 1 << 30, 64)
    ids[1, :33], sizes[1, :33] = ids[0, :33], sizes[0, :33]
    got = stackdist._mattson_pass_batch_torch(torch.from_numpy(ids).to(cuda),
                                              torch.from_numpy(sizes).to(cuda)).cpu().numpy()
    if not np.array_equal(got, stackdist._mattson_pass_batch(ids, sizes)):
        raise AssertionError("sweep: pad_only: distances differ from the host's")
    rows = cases["not_pow2"]
    batch = cachesim.StreamBatch.pad(rows, device=cuda)
    block = batch._blocks[0]
    width = block.sizes.shape[1]
    block.on_device["sizes"] = torch.cat([block.on_device["sizes"],
                                          block.on_device["sizes"].new_zeros((1, width))])
    block.on_device["dist"] = torch.cat([block.on_device["dist"], torch.full(
        (1, width), math.inf, dtype=torch.float64, device=cuda)])
    block.on_device["is_write"] = torch.cat([block.on_device["is_write"], torch.zeros(
        (1, width), dtype=torch.bool, device=cuda)])
    block.on_device["is_inf"] = torch.cat([block.on_device["is_inf"], torch.ones(
        (1, width), dtype=torch.bool, device=cuda)])
    out["pad_only"] = {"wb_max_rel_diff": traffic_agree(
        "pad_only", batch.traffic_matrices(caps), cachesim.StreamBatch.pad(rows).traffic_matrices(caps))}
    return out


def phase_sweep(card: str) -> dict:
    """The analytic stack over the whole registry on the card against the
    host's NumPy scans (see the module docstring's ``sweep``)."""
    from repro_torch.core import cachesim, copa, sweep
    from repro_torch.workloads import registry

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    names = registry.scenarios()
    t0 = time.perf_counter()
    traces = [registry.scenario(n) for n in names]
    traces_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    # the engine, cold then warm, on each side; the two scans timed where
    # the engines call them (the card's by CUDA events, NumPy's by the host
    # clock) and their results kept
    scans: dict[str, list] = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            out, dev_ms, host_ms = event_ms(lambda: fn(*args, **kwargs))
            where = name(*args) if callable(name) else name
            scans.setdefault(where, []).append((dev_ms, host_ms, out))
            return out
        return call

    originals = (cachesim._host_distances, cachesim._device_distances,
                 cachesim.StreamBatch.traffic_matrices)
    cachesim._host_distances = timed("mattson_host", originals[0])
    cachesim._device_distances = timed("mattson_device", originals[1])
    cachesim.StreamBatch.traffic_matrices = timed(
        lambda batch, *_: "traffic_" + ("host" if batch.device is None else "device"), originals[2])
    engines = {}
    try:
        for side in ("cuda", "cpu"):
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                grid = sweep.SweepEngine(names, configs=copa.TABLE_V, device=side).run()
                torch.cuda.synchronize()
                runs.append((grid, time.perf_counter() - t0))
            engines[side] = runs
    finally:
        (cachesim._host_distances, cachesim._device_distances,
         cachesim.StreamBatch.traffic_matrices) = originals
    grids = sweep_grids_agree(engines["cuda"][0][0], engines["cpu"][0][0])
    for side, runs in engines.items():
        if not all(same_row(a, b) for a, b in zip(runs[0][0].rows, runs[1][0].rows)):
            raise AssertionError(f"sweep: the warm {side} grid differs from the cold one")
    grid = engines["cuda"][0][0]

    # every stream's distances: the engines' own (memoized by side)
    dev_streams = cachesim.build_streams(traces, device="cuda")
    host_streams = cachesim.build_streams(traces, device="cpu")
    for n, a, b in zip(names, dev_streams, host_streams):
        if not np.array_equal(a.dist, b.dist):
            raise AssertionError(f"sweep: {n}: the card's distances differ from the host's")
    streams = dict(zip(names, host_streams))
    longest_mlperf = max((n for n in names if n.startswith("mlperf.")),
                         key=lambda n: len(streams[n].op_idx))

    # the registry's traffic matrices, at every capacity Table V and the
    # baseline need: the engines' one full scan each
    caps = sorted({float(c) for cfg in copa.TABLE_V + [copa.GPU_N_BASE]
                   for c in sweep.TraceAnalysis.capacities_for(cfg.build())})
    if len(scans.get("traffic_device", ())) != 1 or len(scans.get("traffic_host", ())) != 1:
        raise AssertionError(f"sweep: one traffic scan a side expected: "
                             f"{ {k: len(v) for k, v in scans.items()} }")
    dev_traffic, host_traffic = scans["traffic_device"][0][2], scans["traffic_host"][0][2]
    if dev_traffic[0].shape[0] != len(caps):
        raise AssertionError(f"sweep: the engines scanned {dev_traffic[0].shape[0]} capacities")
    wb_diff = traffic_agree("registry", dev_traffic, host_traffic)
    dev_batch = sweep.suite_analysis_for(traces, device="cuda").batch
    host_batch = sweep.suite_analysis_for(traces, device="cpu").batch
    # the device scans again, warm
    rows = {i: (s.tensor_idx, s.sizes) for i, s in enumerate(host_streams)}
    _, mattson_warm_ms, _ = event_ms(lambda: cachesim._device_distances(rows, cuda))
    _, traffic_warm_ms, _ = event_ms(lambda: dev_batch.traffic_matrices(caps))

    def scan_ms(key):
        calls = scans.get(key, [])
        return {"calls": len(calls), "device_ms": sum(c[0] for c in calls),
                "host_ms": sum(c[1] for c in calls)}

    # the longest stream and the longest MLPerf stream, each a one-row batch
    alone = {}
    for i in {max(range(len(names)), key=lambda i: len(host_streams[i].op_idx)),
              names.index(longest_mlperf)}:
        dist = cachesim._device_distances({0: rows[i]}, cuda)[0]
        if not np.array_equal(dist, host_streams[i].dist):
            raise AssertionError(f"sweep: {names[i]} alone: distances differ from the host's")
        sl = host_batch.op_slice(i)
        one = cachesim.StreamBatch.pad([host_streams[i]], device=cuda).traffic_matrices(caps)
        alone[names[i]] = {"touches": len(host_streams[i].op_idx), "wb_max_rel_diff": traffic_agree(
            names[i], one, (host_traffic[0][:, sl], host_traffic[1][:, sl]))}

    # the serving simulator's cost grids
    serve = {}
    for bench, kw in (("resnet", {}),
                      ("gnmt", {"kv_bytes_per_token": 64 * 1024, "seq_edges": (64, 4096, 1 << 20),
                                "tokens_per_pass": 50,
                                "prefill_scenario": "lm.tinyllama-1.1b.prefill_32k"})):
        got = sweep.serve_cost_grids(bench, [copa.GPU_N_BASE, copa.HBM_L3], device="cuda", **kw)
        want = sweep.serve_cost_grids(bench, [copa.GPU_N_BASE, copa.HBM_L3], device="cpu", **kw)
        for cfg in got:
            a, b = got[cfg], want[cfg]
            if not (a.batches == b.batches and a.seq_edges == b.seq_edges
                    and all(sweep_close(x, y) for x, y in zip(a.step_time_s.ravel(),
                                                              b.step_time_s.ravel()))
                    and sweep_close(a.prefill_s_per_token, b.prefill_s_per_token)):
                raise AssertionError(f"sweep: serve_cost_grids({bench}) {cfg} differs")
        serve[bench] = {cfg: {"equal": bool(np.array_equal(got[cfg].step_time_s,
                                                            want[cfg].step_time_s)),
                              "step_ms": (got[cfg].step_time_s * 1e3).tolist()} for cfg in got}
    awkward = {**sweep_awkward(caps), "alone": alone}
    peak = torch.cuda.max_memory_allocated() - held

    def geomeans(suite):
        members = [registry.scenario(n).name for n in registry.suite(suite)]
        return {cfg.name: grid.geomean_speedup(cfg.name, members) for cfg in copa.TABLE_V}

    blocks = cachesim._mattson_blocks({i: r[0] for i, r in rows.items()})
    row = {"phase": "sweep", "card": card, "scenarios": len(names),
           "families": {f: sum(n.startswith(f + ".") for n in names)
                        for f in ("hpc", "lm", "mlperf", "serve", "kernel")},
           "touches": int(sum(len(s.op_idx) for s in host_streams)),
           "longest": {"scenario": names[max(range(len(names)),
                                            key=lambda i: len(host_streams[i].op_idx))],
                       "touches": max(len(s.op_idx) for s in host_streams)},
           "longest_mlperf": {"scenario": longest_mlperf,
                              "touches": len(streams[longest_mlperf].op_idx)},
           "mattson_blocks": len(blocks), "traffic_blocks": len(dev_batch._blocks),
           "capacities": caps, "grid": grids,
           "engine_s": {side: {"cold": runs[0][1], "warm": runs[1][1]}
                        for side, runs in engines.items()},
           "traces_s": traces_s,
           "mattson": {"card_in_engine": scan_ms("mattson_device"),
                       "card_warm_device_ms": mattson_warm_ms,
                       "host_numpy_in_engine": scan_ms("mattson_host")},
           "traffic": {"card_in_engine": scan_ms("traffic_device"),
                       "card_warm_device_ms": traffic_warm_ms,
                       "host_numpy_in_engine": scan_ms("traffic_host"),
                       "wb_max_rel_diff": wb_diff},
           "serve_cost_grids": serve, "awkward": awkward,
           "peak_device_bytes": peak,
           "geomean_speedup_model_output": {
               "note": "the analytic model's output for the paper's GPU-N configurations "
                       "(Table V), not a measurement of this card",
               "mlperf.infer.large": geomeans("mlperf.infer.large"),
               "mlperf.train.large": geomeans("mlperf.train.large")},
           "seconds": time.perf_counter() - t_phase}
    # the memos hold every registry trace and stream: let the model phases have the memory
    cachesim.stream_cache_clear()
    sweep._ANALYSES.clear()
    sweep._SUITES.clear()
    sweep._KV_SESSIONS.clear()
    del engines, grid, dev_streams, host_streams, streams, dev_batch, host_batch, traces
    free_memory()
    return row


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# --------------------------------------------------------------------------------
# kernel checks
# --------------------------------------------------------------------------------

def check_flash_attention(gen, *, b, sq, skv, h, kvh, d, dtype, causal, dv=None,
                          timed=False) -> dict:
    """K1 against its plain version (out and lse), and twice on the same
    inputs (the two launches must agree bit for bit). ``dv``: v's head dim
    where it differs from q's and k's (MLA). Timed rows also name the
    kernels the library call ran (the backend ``sdpa`` picked)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attn_fwd_plan, flash_attention,
                                                     flash_attention_plain)

    dv = d if dv is None else dv
    q = randn(gen, (b, sq, h, d), dtype)
    k = randn(gen, (b, skv, kvh, d), dtype)
    v = randn(gen, (b, skv, kvh, dv), dtype)
    out, lse = flash_attention(q, k, v, causal=causal)
    out2, lse2 = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_plain(q, k, v, causal=causal)
    tol = TOL[dtype]
    row = {"kernel": "flash_attention",
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "KVH": kvh, "D": d,
                     **({"Dv": dv} if dv != d else {}),
                     "dtype": str(dtype).split(".")[-1], "causal": causal},
           "plan": attn_fwd_plan(b, sq, skv, h, kvh, d, dv, dtype, causal).summary(),
           "tol": tol,
           "max_abs_err": compare("flash_attention out", out, want, tol),
           "lse_max_abs_err": compare("flash_attention lse", lse, want_lse, tol),
           "bit_identical": bool(torch.equal(out, out2) and torch.equal(lse, lse2))}
    if not row["bit_identical"]:
        raise AssertionError("flash_attention: two launches on the same inputs differ")
    if timed:
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        nbytes = (q.element_size() * (q.numel() + k.numel() + v.numel() + out.numel())
                  + 4 * lse.numel())
        flops = 2 * b * h * (d + dv) * pairs          # Q K^T over D, P V over Dv
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        row.update(
            kernel_ms=device_ms(lambda: flash_attention(q, k, v, causal=causal)),
            call_ms=call_ms(lambda: flash_attention(q, k, v, causal=causal)),
            plain_ms=device_ms(lambda: flash_attention_plain(q, k, v, causal=causal), launches=3),
            library_ms=device_ms(library),
            library_kernels=[r["kernel"] for r in profile_step(library, top=3)["top"]],
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def check_flash_decode(gen, *, b, h, kvh, d, s, kv_len, dtype, timed=False) -> dict:
    """K3 against its plain version; twice on the same inputs (bit-identical);
    with kv_len as a host int and as an int32 tensor on the card (the two
    bit-identical); one call allocating no more than its output; with the
    plan it ran."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (decode_plan, flash_decode, flash_decode_plain,
                                                  launch_plan, max_active_clusters)

    q = randn(gen, (b, h, d), dtype)
    k = randn(gen, (b, s, kvh, d), dtype)
    v = randn(gen, (b, s, kvh, d), dtype)
    len_t = torch.tensor([kv_len], dtype=torch.int32, device="cuda")
    out = flash_decode(q, k, v, kv_len)
    again = flash_decode(q, k, v, kv_len)
    by_tensor = flash_decode(q, k, v, len_t)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept = flash_decode(q, k, v, kv_len)
    torch.cuda.synchronize()
    alloc = torch.cuda.max_memory_allocated() - before
    out_bytes = -(-kept.numel() * kept.element_size() // 512) * 512   # the allocator's blocks
    del kept
    plan = launch_plan(q.device.index, b, h, kvh, s, d, dtype)
    active = max_active_clusters(plan, b, h, kvh, d, dtype, q.device.index)
    tol = TOL[dtype]
    row = {"kernel": "flash_decode",
           "shape": {"B": b, "H": h, "KVH": kvh, "D": d, "S": s, "kv_len": kv_len,
                     "dtype": str(dtype).split(".")[-1]},
           "plan": plan.summary(), "max_active_clusters": active,
           "cpu_plan_cluster": decode_plan(b, kvh, h // kvh, s, d, dtype).cluster, "tol": tol,
           "max_abs_err": compare("flash_decode out", out,
                                  flash_decode_plain(q, k, v, kv_len), tol),
           "bit_identical": bool(torch.equal(out, again)),
           "tensor_kv_len_bit_identical": bool(torch.equal(out, by_tensor)),
           "alloc_bytes": alloc, "out_bytes": out_bytes}
    if not row["bit_identical"]:
        raise AssertionError("flash_decode: two launches on the same inputs differ")
    if not row["tensor_kv_len_bit_identical"]:
        raise AssertionError("flash_decode: kv_len as a tensor and as a host int differ")
    if alloc > out_bytes:
        raise AssertionError(f"flash_decode: one call allocated {alloc} bytes, "
                             f"more than its {out_bytes}-byte output")
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
            tensor_call_ms=call_ms(lambda: flash_decode(q, k, v, len_t)),
            plain_ms=device_ms(lambda: flash_decode_plain(q, k, v, kv_len)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q4, kt, vt, enable_gqa=True)),
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return row


def check_decode_graph(gen, *, b, h, kvh, d, s, dtype) -> dict:
    """E2: one call with kv_len as an int32 tensor on the card, captured in a
    CUDA graph, replayed after copying each of six positions into the tensor;
    every replay must equal the host-int launch bit for bit and the plain
    version within TOL."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain

    q = randn(gen, (b, h, d), dtype)
    k = randn(gen, (b, s, kvh, d), dtype)
    v = randn(gen, (b, s, kvh, d), dtype)
    len_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    flash_decode(q, k, v, len_t)                     # plan and attributes outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, len_t)
    errs = {}
    for kv_len in (1, 63, 64, 65, 543, s):
        len_t.fill_(kv_len)
        graph.replay()
        got = out.clone()
        want = flash_decode(q, k, v, kv_len)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"flash_decode graph replay at kv_len {kv_len} differs from "
                                 "the host-int launch")
        errs[kv_len] = compare(f"flash_decode graph replay, kv_len {kv_len}", got,
                               flash_decode_plain(q, k, v, kv_len), TOL[dtype])
    return {"kernel": "flash_decode", "check": "cuda_graph_tensor_kv_len",
            "shape": {"B": b, "H": h, "KVH": kvh, "D": d, "S": s,
                      "dtype": str(dtype).split(".")[-1]},
            "replays_bit_identical_to_host_int": True, "max_abs_err_by_kv_len": errs}


def decode_bound(b, h, kvh, d, kv_len, esize, out_bytes, dtype) -> tuple[float, str]:
    """K3's bound over this run's data: q, the first kv_len cache rows, the
    outputs (``out_bytes``), and 4·B·H·D·kv_len operations."""
    return bound(esize * (b * h * d + 2 * b * kv_len * kvh * d) + out_bytes,
                 4 * b * h * d * kv_len, dtype)


def check_decode_partial(gen, *, b, h, kvh, d, s, dtype, label) -> dict:
    """K3's partial entry (``flash_decode_partial``): at each of
    PARTIAL_KV_LENS, on the whole cache against its plain version (out and
    lse), launched twice (bit-identical) and with kv_len as an int32 tensor
    on the card (bit-identical); then the cache split PARTIAL_SPLITS ways,
    each shard's partial at its own length (``shard_kv_len``: 0 past
    kv_len) merged by ``combine_partials``, against whole-cache K3 and the
    plain version (out) and the whole-cache partial's lse. Device ms (graph
    replay) of the partial entry and of each split's launches + combine,
    beside their bounds, at every kv_len; of its plain version and of
    ``sdpa`` on the same rows, and its and each split's eager ms (and the
    split's plain version), at the first."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_partial,
                                                  flash_decode_partial_plain, flash_decode_plain,
                                                  launch_plan, shard_kv_len)
    from repro_torch.kernels.ops import combine_partials

    q = randn(gen, (b, h, d), dtype)
    k = randn(gen, (b, s, kvh, d), dtype)
    v = randn(gen, (b, s, kvh, d), dtype)
    tol, esize = TOL[dtype], q.element_size()
    q4 = q[:, :, None, :]
    row = {"kernel": "flash_decode_partial", "label": label,
           "shape": {"B": b, "H": h, "KVH": kvh, "D": d, "S": s,
                     "dtype": str(dtype).split(".")[-1]},
           "plan": launch_plan(q.device.index, b, h, kvh, s, d, dtype, True).summary(),
           "tol": tol, "by_kv_len": {}}
    for kv_len in PARTIAL_KV_LENS:
        out, lse = flash_decode_partial(q, k, v, kv_len)
        again = flash_decode_partial(q, k, v, kv_len)
        by_tensor = flash_decode_partial(q, k, v, torch.tensor([kv_len], dtype=torch.int32,
                                                               device="cuda"))
        whole = flash_decode(q, k, v, kv_len)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip((out, lse), again)):
            raise AssertionError(f"flash_decode_partial: two launches differ at kv_len {kv_len}")
        if not all(torch.equal(a, c) for a, c in zip((out, lse), by_tensor)):
            raise AssertionError(f"flash_decode_partial: kv_len as a tensor and as a host int "
                                 f"differ at kv_len {kv_len}")
        want_out, want_lse = flash_decode_partial_plain(q, k, v, kv_len)
        plain_whole = flash_decode_plain(q, k, v, kv_len)
        one = {"max_abs_err": compare(f"partial out, kv_len {kv_len}", out, want_out, tol),
               "lse_max_abs_err": compare(f"partial lse, kv_len {kv_len}", lse, want_lse, tol),
               "bit_identical": True, "tensor_kv_len_bit_identical": True, "splits": {}}
        out_bytes = 4 * (b * h * d + b * h)
        one["bound_ms"], one["bound_by"] = decode_bound(b, h, kvh, d, kv_len, esize, out_bytes,
                                                        dtype)
        one["kernel_ms"] = device_ms(lambda: flash_decode_partial(q, k, v, kv_len))
        if kv_len == PARTIAL_KV_LENS[0]:
            kt, vt = (x[:, :kv_len].transpose(1, 2) for x in (k, v))
            one.update(call_ms=call_ms(lambda: flash_decode_partial(q, k, v, kv_len)),
                       plain_ms=device_ms(lambda: flash_decode_partial_plain(q, k, v, kv_len)),
                       library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                           q4, kt, vt, enable_gqa=True)))
        for n in PARTIAL_SPLITS:
            s_local = s // n
            shards = [(k[:, r * s_local:(r + 1) * s_local].contiguous(),
                       v[:, r * s_local:(r + 1) * s_local].contiguous(),
                       shard_kv_len(kv_len, r * s_local, s_local)) for r in range(n)]

            def split():
                parts = [flash_decode_partial(q, k_, v_, n_) for k_, v_, n_ in shards]
                return combine_partials(torch.stack([o for o, _ in parts]),
                                        torch.stack([x for _, x in parts]))

            c_out, c_lse = split()
            name = f"{n}-way split, kv_len {kv_len}"
            err = {"lengths": [n_ for _, _, n_ in shards],
                   "vs_whole_k3": compare(f"{name} vs whole-cache K3", c_out, whole, tol),
                   "vs_plain": compare(f"{name} vs plain", c_out, plain_whole, tol),
                   "lse_vs_whole_partial": compare(f"{name} lse", c_lse, lse, tol)}
            err["bound_ms"], err["bound_by"] = decode_bound(b, h, kvh, d, kv_len, esize,
                                                            esize * b * h * d, dtype)
            err["device_ms"] = device_ms(split, launches=5)
            if kv_len == PARTIAL_KV_LENS[0]:
                def split_plain():
                    parts = [flash_decode_partial_plain(q, k_, v_, n_) for k_, v_, n_ in shards]
                    return combine_partials(torch.stack([o for o, _ in parts]),
                                            torch.stack([x for _, x in parts]))

                # the library's call for the same function: sdpa over the
                # whole cache's first kv_len rows (timed above)
                err.update(call_ms=call_ms(split), plain_ms=device_ms(split_plain),
                           library_ms=one["library_ms"])
            one["splits"][n] = err
        row["by_kv_len"][kv_len] = one
    # the row's own numbers: the first kv_len's (543, inside a middle shard)
    first = row["by_kv_len"][PARTIAL_KV_LENS[0]]
    row.update({key: first[key] for key in ("max_abs_err", "lse_max_abs_err", "kernel_ms",
                                            "call_ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")})
    return row


def phase_partial_checks(cfg, hybrid) -> dict:
    """K3's partial entry at the serve row's shape and at the hybrid's
    shared block (G=1), both over a cache of MAX_LEN rows, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {"serve": check_decode_partial(gen, b=BATCH, h=cfg.n_heads, kvh=cfg.n_kv_heads,
                                          d=cfg.head_dim, s=MAX_LEN, dtype=torch.bfloat16,
                                          label="serve"),
            "hybrid G=1": check_decode_partial(gen, b=BATCH, h=hybrid.n_heads,
                                               kvh=hybrid.n_kv_heads, d=hybrid.head_dim,
                                               s=MAX_LEN, dtype=torch.bfloat16,
                                               label="hybrid G=1")}
    for row in rows.values():
        emit({"phase": "checks", **row})
    emit({"phase": "checks", **check_decode_refuses_int8(gen, cfg)})
    return rows


def check_decode_refuses_int8(gen, cfg) -> dict:
    """K3's two entries on an int8 cache on the card (the serve row's
    heads, a cache of MAX_LEN rows): each raises a TypeError that names the
    dtypes K3 reads, launches nothing, and no plain version runs in its
    place (the dispatch ``kernels.ops.flash_decode_op`` raises the same)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partial

    q = torch.randn(BATCH, cfg.n_heads, cfg.head_dim, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randint(-128, 128, (BATCH, MAX_LEN, cfg.n_kv_heads, cfg.head_dim),
                          generator=gen, device="cuda", dtype=torch.int8) for _ in range(2))
    refused = {}
    before = (flash_decode.launches, flash_decode_partial.launches)
    for name, entry in (("flash_decode", flash_decode), ("flash_decode_partial",
                                                         flash_decode_partial),
                        ("kernels.ops.flash_decode_op", ops.flash_decode_op)):
        try:
            entry(q, k, v, PROMPT_LEN + 31)
        except TypeError as e:
            refused[name] = str(e)
        else:
            raise AssertionError(f"{name} took an int8 cache on the card")
        if "bf16 or fp32" not in refused[name]:
            raise AssertionError(f"{name} refused the int8 cache without naming K3's dtypes: "
                                 f"{refused[name]}")
    if (flash_decode.launches, flash_decode_partial.launches) != before:
        raise AssertionError("K3 launched on an int8 cache")
    return {"check": "flash_decode refuses an int8 cache", "cache": [BATCH, MAX_LEN,
                                                                   cfg.n_kv_heads,
                                                                   cfg.head_dim],
            "refused": refused, "launches": 0}


def check_flash_attention_bwd(gen, *, b, sq, skv, h, kvh, d, dtype, causal, dv=None,
                              timed=False) -> dict:
    """K2a and K2b against their plain versions, and twice on the same inputs
    (the two launches must agree bit for bit), with the plan they ran.
    ``dv``: v's head dim where it differs from q's and k's (MLA). Timed rows
    also name the kernels the library's backward ran."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (attention_delta, bwd_plan,
                                                         flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dkv_plain,
                                                         flash_attention_bwd_dq,
                                                         flash_attention_bwd_dq_plain)

    dv = d if dv is None else dv
    q = randn(gen, (b, sq, h, d), dtype)
    k = randn(gen, (b, skv, kvh, d), dtype)
    v = randn(gen, (b, skv, kvh, dv), dtype)
    dout = randn(gen, (b, sq, h, dv), dtype)
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
                     **({"Dv": dv} if dv != d else {}),
                     "dtype": str(dtype).split(".")[-1], "causal": causal},
           "plan": bwd_plan(b, sq, skv, h, kvh, d, dtype, causal, dv=dv).summary(),
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
        stats = 4 * (lse.numel() + delta.numel())
        # each input read once, each output written once: K2a reads q, k, v,
        # dout and writes dq; K2b reads the same and writes dk and dv
        io = {"dq": es * (2 * q.numel() + k.numel() + v.numel() + dout.numel()) + stats,
              "dkv": es * (q.numel() + dout.numel() + 2 * k.numel() + 2 * v.numel()) + stats}
        # K2a: S = Q K^T and dq = dS K over D, dP = dO V^T over Dv; K2b: S^T
        # and dk over D, dP^T and dv over Dv
        flops = {"dq": 2 * b * h * pairs * (2 * d + dv), "dkv": 4 * b * h * pairs * (d + dv)}
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
        fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True,
                                                     scale=d ** -0.5)
        fwd_bwd = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)
        lib_fwd, lib_all = device_ms(fwd), device_ms(fwd_bwd)
        row.update(library_fwd_ms=lib_fwd, library_fwd_bwd_ms=lib_all,
                   library_ms=lib_all - lib_fwd,
                   library_kernels=[r["kernel"] for r in profile_step(fwd_bwd, top=4)["top"]])
    return row


def phase_occupancy(cfg, mla) -> list[dict]:
    """cudaOccupancyMaxActiveClusters of K2b's launch at the training shape
    of ``cfg`` and of the ``mla`` model (head dims (192, 128)), beside its
    plan: how many of its clusters the card holds at once."""
    from repro_torch.kernels.flash_attention_bwd import bwd_plan, dkv_max_active_clusters

    rows = []
    for m, dims in ((cfg, dict(h=cfg.n_heads, kvh=cfg.n_kv_heads, d=cfg.head_dim,
                               dv=cfg.head_dim)),
                    (mla, mla_dims(mla))):
        shape = dict(b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, **dims)
        plan = bwd_plan(**shape, dtype=torch.bfloat16, causal=True)
        clusters = dkv_max_active_clusters(**shape)
        if clusters < 1:
            raise AssertionError(f"K2b: not one cluster of {plan.cluster} blocks fits the card")
        rows.append({"phase": "occupancy", "kernel": "flash_attention_bwd_dkv", "arch": m.name,
                     "shape": shape, "plan": plan.summary(), "max_active_clusters": clusters,
                     "max_active_blocks": clusters * plan.cluster,
                     "sms": torch.cuda.get_device_properties(0).multi_processor_count})
    return rows


def phase_train_checks(cfg, wide_cfg, mla, moe) -> tuple[dict, dict, dict, dict]:
    """K2a/K2b over the training path's shape and the awkward ones, and K1 at
    the training path's shape; returns the two timed rows at the training
    shape and K1's and K2's timed rows at S=4096 (tinyllama's heads, B=1),
    at D=128 (``wide_cfg``'s heads, B=2, S=1024), at the ``mla`` model's
    training shape (head dims (192, 128), B=4, S=1024) and at the ``moe``
    model's (its heads, D=128, B=4, S=1024)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, fp32 = torch.bfloat16, torch.float32
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fa = check_flash_attention(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh, d=d,
                               dtype=bf16, causal=True, timed=True)
    bwd = check_flash_attention_bwd(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=h, kvh=kvh,
                                    d=d, dtype=bf16, causal=True, timed=True)
    more_shapes = {"S=4096": dict(b=1, sq=4096, skv=4096, h=h, kvh=kvh, d=d),
                   "D=128": dict(b=2, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=wide_cfg.n_heads,
                                 kvh=wide_cfg.n_kv_heads, d=wide_cfg.head_dim)}
    fa_more = {key: check_flash_attention(gen, **kw, dtype=bf16, causal=True, timed=True)
               for key, kw in more_shapes.items()}
    more = {key: check_flash_attention_bwd(gen, **kw, dtype=bf16, causal=True, timed=True)
            for key, kw in more_shapes.items()}
    rows = [fa, bwd, *fa_more.values(), *more.values()]
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
    # MLA's training shape (deepseek-v2-236b: q/k 192, v 128, G=1), K1 and K2
    # timed, then its awkward shapes at the same head dims, K1 and K2 each: a
    # ragged length, Sq != Skv, G=4, fp32; on a generator of their own, so
    # the rows above keep their inputs
    gen = torch.Generator(device="cuda").manual_seed(5)
    dims, key = mla_dims(mla), f"{mla.name} MLA train"
    fa_more[key] = check_flash_attention(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, **dims,
                                         dtype=bf16, causal=True, timed=True)
    more[key] = check_flash_attention_bwd(gen, b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, **dims,
                                          dtype=bf16, causal=True, timed=True)
    rows += [fa_more[key], more[key]]
    # the GQA-MoE's training shape (qwen3-moe-235b-a22b: H=64 KVH=4 D=128,
    # G=16), the one train_mesh_moe's steps take, on a generator of its own
    moe_gen = torch.Generator(device="cuda").manual_seed(7)
    moe_key = f"{moe.name} train"
    moe_shape = dict(b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, h=moe.n_heads,
                     kvh=moe.n_kv_heads, d=moe.head_dim, dtype=bf16, causal=True, timed=True)
    fa_more[moe_key] = check_flash_attention(moe_gen, **moe_shape)
    more[moe_key] = check_flash_attention_bwd(moe_gen, **moe_shape)
    rows += [fa_more[moe_key], more[moe_key]]
    d, dv = dims["d"], dims["dv"]
    for kw in (
        dict(b=2, sq=333, skv=333, h=8, kvh=8, dtype=bf16, causal=True),        # no tile multiple
        dict(b=2, sq=200, skv=333, h=8, kvh=8, dtype=bf16, causal=False),       # Sq != Skv
        dict(b=2, sq=384, skv=384, h=8, kvh=2, dtype=bf16, causal=True),        # G=4: c=4
        dict(b=1, sq=300, skv=300, h=4, kvh=4, dtype=fp32, causal=True),
    ):
        rows.append(check_flash_attention(gen, **kw, d=d, dv=dv))
        rows.append(check_flash_attention_bwd(gen, **kw, d=d, dv=dv))
    for row in rows:
        emit({"phase": "checks", "path": "train", **row})
    return fa, bwd, fa_more, more


def phase_family_checks(audio, hybrid) -> dict:
    """K1 and K2 at the shapes ``train_audio``, ``serve_audio`` and
    ``train_hybrid`` give them, K3 at ``serve_audio``'s two decode calls, all
    timed: whisper-base's encoder (1500 frames, non-causal, ragged), its
    decoder's causal self-attention (448 tokens) and its cross-attention (448
    queries against 1500 frames, non-causal), at its training batch, H = KVH
    = 8, D = 64; zamba2-1.2b's shared block in training (B=4 S=1024, H = KVH
    = 32: K2b's clusters of 1); K3 against the 1500-row cross cache and the
    448-row self cache at the engine's last length. Keyed by row name."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    heads = dict(h=audio.n_heads, kvh=audio.n_kv_heads, d=audio.head_dim)
    b = AUDIO_TRAIN_BATCH
    attn_shapes = {
        f"{audio.name} encoder": dict(b=b, sq=AUDIO_FRAMES, skv=AUDIO_FRAMES, causal=False,
                                      **heads),
        f"{audio.name} decoder": dict(b=b, sq=AUDIO_MAX_LEN, skv=AUDIO_MAX_LEN, causal=True,
                                      **heads),
        f"{audio.name} cross": dict(b=b, sq=AUDIO_MAX_LEN, skv=AUDIO_FRAMES, causal=False,
                                    **heads),
        f"{hybrid.name} train": dict(b=TRAIN_BATCH, sq=TRAIN_SEQ, skv=TRAIN_SEQ, causal=True,
                                     h=hybrid.n_heads, kvh=hybrid.n_kv_heads, d=hybrid.head_dim),
    }
    out = {"fa": {}, "bwd": {}, "fd": {}}
    for key, kw in attn_shapes.items():
        out["fa"][key] = check_flash_attention(gen, **kw, dtype=bf16, timed=True)
        out["bwd"][key] = check_flash_attention_bwd(gen, **kw, dtype=bf16, timed=True)
    last = AUDIO_PROMPT + AUDIO_GEN_STEPS - 1         # the engine's last decode length
    for key, s, kv_len in ((f"{audio.name} cross S=kv_len={AUDIO_FRAMES}", AUDIO_FRAMES,
                            AUDIO_FRAMES),
                           (f"{audio.name} self S={AUDIO_MAX_LEN} kv_len={last}", AUDIO_MAX_LEN,
                            last)):
        out["fd"][key] = check_flash_decode(gen, b=BATCH, s=s, kv_len=kv_len, dtype=bf16,
                                            timed=True, **heads)
    for part in out.values():
        for key, row in part.items():
            emit({"phase": "checks", "path": "families", "name": key, **row})
    return out


def mla_dims(cfg) -> dict:
    """K1's head dims and heads on an MLA model's prefill: q/k at
    head_dim + rope_head_dim, v at v_head_dim, one KV head a query head."""
    return dict(h=cfg.n_heads, kvh=cfg.n_heads, d=cfg.head_dim + cfg.rope_head_dim,
                dv=cfg.v_head_dim)


def phase_checks(cfg, hybrid, long_cfg, vlm, moe, mla) -> tuple[dict, dict, dict, dict]:
    """All shapes; returns the two rows taken at the serve path's shapes,
    K3's timed rows at ``hybrid``'s shared block (G=1), B=8 S=2048, a
    32k-token cache at ``long_cfg``'s heads and the ``vlm`` and ``moe``
    paths' decode calls, and K1's timed rows at the ``vlm``, ``moe`` and
    ``mla`` paths' prefill (the last at MLA's (192, 128) head dims)."""
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
        dict(b=2, sq=333, skv=333, h=12, kvh=2, d=d, dtype=bf16, causal=True),    # G=6
        dict(b=1, sq=256, skv=256, h=16, kvh=1, d=d, dtype=bf16, causal=True),    # KVH == 1
        dict(b=2, sq=333, skv=333, h=8, kvh=2, d=d, dtype=fp32, causal=True),
        dict(b=1, sq=256, skv=256, h=4, kvh=4, d=128, dtype=fp32, causal=False),
        dict(b=1, sq=130, skv=130, h=4, kvh=1, d=32, dtype=fp32, causal=True),
    ):
        rows.append(check_flash_attention(gen, **kw))
    # the serve path's own call: the cache of MAX_LEN at the last step's length
    fd_path = check_flash_decode(gen, b=BATCH, h=h, kvh=kvh, d=d, s=MAX_LEN,
                                 kv_len=PROMPT_LEN + GEN_STEPS - 1, dtype=bf16, timed=True)
    rows.append(fd_path)
    fd_more = {
        # zamba2-1.2b's shared block: MHA (G=1), its last step's length
        "hybrid G=1": check_flash_decode(gen, b=BATCH, h=hybrid.n_heads, kvh=hybrid.n_kv_heads,
                                         d=hybrid.head_dim, s=MAX_LEN,
                                         kv_len=PROMPT_LEN + HYBRID_GEN_STEPS - 1, dtype=bf16,
                                         timed=True),
        "B=8 S=2048": check_flash_decode(gen, b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=2048,
                                         dtype=bf16, timed=True),
        # long context at mistral-nemo-12b's heads: bytes, not latency, set the pace
        "S=32768 D=128": check_flash_decode(gen, b=1, h=long_cfg.n_heads,
                                            kvh=long_cfg.n_kv_heads, d=long_cfg.head_dim,
                                            s=32768, kv_len=32768, dtype=bf16, timed=True),
    }
    rows.extend(fd_more.values())
    for kw in (
        dict(b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=1, dtype=bf16),
        dict(b=8, h=h, kvh=kvh, d=d, s=2048, kv_len=700, dtype=bf16),
        dict(b=3, h=h, kvh=kvh, d=d, s=1000, kv_len=999, dtype=bf16),             # ragged cache
        dict(b=2, h=8, kvh=8, d=128, s=1000, kv_len=65, dtype=bf16),              # KVH == H
        dict(b=2, h=8, kvh=2, d=32, s=500, kv_len=333, dtype=bf16),
        dict(b=2, h=32, kvh=1, d=d, s=700, kv_len=699, dtype=bf16),               # G=32: 2 fragments
        dict(b=1, h=17, kvh=1, d=d, s=300, kv_len=250, dtype=bf16),               # G=17: 16 + 1 rows
        dict(b=2, h=8, kvh=2, d=128, s=1000, kv_len=700, dtype=fp32),
        dict(b=2, h=4, kvh=4, d=d, s=333, kv_len=200, dtype=fp32),                # G=1
        dict(b=1, h=4, kvh=4, d=32, s=64, kv_len=64, dtype=fp32),
    ):
        rows.append(check_flash_decode(gen, **kw))
    rows.append(check_decode_graph(gen, b=BATCH, h=h, kvh=kvh, d=d, s=MAX_LEN, dtype=bf16))
    rows.append(check_decode_graph(gen, b=BATCH, h=hybrid.n_heads, kvh=hybrid.n_kv_heads,
                                   d=hybrid.head_dim, s=MAX_LEN, dtype=bf16))
    # the D=128 models' own calls: each layer's prefill, and the last decode
    # step of a 16-step generate (kv_len 527) in a cache of MAX_LEN
    fa_models = {}
    for key, m in ((f"{VLM_ARCH} G=6", vlm), (f"{MOE_ARCH} G=16", moe)):
        fa_models[key] = check_flash_attention(gen, b=BATCH, sq=PROMPT_LEN, skv=PROMPT_LEN,
                                               h=m.n_heads, kvh=m.n_kv_heads, d=m.head_dim,
                                               dtype=bf16, causal=True, timed=True)
        fd_more[key] = check_flash_decode(gen, b=BATCH, h=m.n_heads, kvh=m.n_kv_heads,
                                          d=m.head_dim, s=MAX_LEN,
                                          kv_len=PROMPT_LEN + FAMILY_GEN_STEPS - 1, dtype=bf16,
                                          timed=True)
    rows.extend(fa_models.values())
    rows.extend(fd_more[key] for key in fa_models)
    # serve_moe's fp32 run: K1's and K3's fp32 instances at its heads
    rows.append(check_flash_attention(gen, b=BATCH, sq=PROMPT_LEN, skv=PROMPT_LEN,
                                      h=moe.n_heads, kvh=moe.n_kv_heads, d=moe.head_dim,
                                      dtype=fp32, causal=True))
    rows.append(check_flash_decode(gen, b=BATCH, h=moe.n_heads, kvh=moe.n_kv_heads,
                                   d=moe.head_dim, s=MAX_LEN,
                                   kv_len=PROMPT_LEN + FAMILY_GEN_STEPS - 1, dtype=fp32))
    # MLA's prefill (deepseek-v2-236b: q/k 192, v 128, G=1), then its awkward
    # shapes at the same head dims, all timed: a ragged length, Sq != Skv,
    # G=4, fp32; on a generator of their own, so the rows above keep their
    # inputs
    gen = torch.Generator(device="cuda").manual_seed(4)
    dims = mla_dims(mla)
    fa_models[f"{mla.name} MLA"] = check_flash_attention(
        gen, b=BATCH, sq=PROMPT_LEN, skv=PROMPT_LEN, **dims, dtype=bf16, causal=True, timed=True)
    rows.append(fa_models[f"{mla.name} MLA"])
    d, dv = dims["d"], dims["dv"]
    for kw in (
        dict(b=2, sq=333, skv=333, h=8, kvh=8, dtype=bf16, causal=True),        # no tile multiple
        dict(b=2, sq=200, skv=333, h=8, kvh=8, dtype=bf16, causal=False),       # Sq != Skv
        dict(b=2, sq=384, skv=384, h=8, kvh=2, dtype=bf16, causal=True),        # G=4
        dict(b=1, sq=300, skv=300, h=4, kvh=4, dtype=fp32, causal=True),
    ):
        rows.append(check_flash_attention(gen, **kw, d=d, dv=dv, timed=True))
    # serve_mla's fp32 run: K1's fp32 instance at its heads
    rows.append(check_flash_attention(gen, b=BATCH, sq=PROMPT_LEN, skv=PROMPT_LEN, **dims,
                                      dtype=fp32, causal=True))
    for row in rows:
        emit({"phase": "checks", **row})
    return fa_path, fd_path, fd_more, fa_models


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
    """Device ms of both routes (K4 or K5) from a row checked with ``both_routes``."""
    return {row["route"]: row["kernel_ms"], row["other_route"]["route"]: row["other_route"]["kernel_ms"]}


def ssd_flops(b, s, h, p, n) -> int:
    """What K5 does: per (b, h) and 64-token chunk, C B^T, the masked-score
    product, the inter-chunk product and the state update, all in full."""
    from repro_torch.kernels.ssd_scan import CHUNK as L
    chunks = -(-s // L)
    return b * h * chunks * 2 * L * (L * n + L * p + 2 * n * p)


def ssd_mma_flops(b, s, h, p, n) -> int:
    """What K5's mma route does: ``ssd_flops`` and the state update's lo term
    (W^T x once more)."""
    from repro_torch.kernels.ssd_scan import CHUNK as L
    return ssd_flops(b, s, h, p, n) + b * h * -(-s // L) * 2 * L * n * p


def check_ssd_scan(gen, *, b, s, h, p, n, dtype, timed=False, dt_range=None,
                   both_routes=False) -> dict:
    """K5 against its plain version (y and the final state), twice on the
    same inputs (bit-identical), on the route ``ssd_plan`` picks and, with
    ``both_routes``, on the other one (``other_route``), timed too where
    ``timed``. Inputs at the model's scales: A = -exp(.) per head, dt a
    softplus of N(0, 1) or, with ``dt_range``, log-uniform in it."""
    from repro_torch.kernels.ssd_scan import CHUNK, ROUTES, ssd_plan, ssd_scan, ssd_scan_plain

    x = (randn(gen, (b, s, h, p), torch.float32) * 0.5).to(dtype)
    if dt_range is None:
        dt = torch.nn.functional.softplus(randn(gen, (b, s, h), torch.float32))
    else:
        lo, hi = math.log(dt_range[0]), math.log(dt_range[1])
        dt = torch.exp(lo + (hi - lo) * torch.rand((b, s, h), generator=gen, device="cuda"))
    a = -torch.exp(randn(gen, (h,), torch.float32) * 0.3)
    bm = (randn(gen, (b, s, n), torch.float32) * 0.3).to(dtype)
    cm = (randn(gen, (b, s, n), torch.float32) * 0.3).to(dtype)
    want_y, want_st = ssd_scan_plain(x, dt, a, bm, cm)
    atol, rtol = SSD_TOL[dtype]
    st_atol, st_rtol = SSD_TOL[torch.float32]
    rel_norm = BF16_REL_NORM if dtype == torch.bfloat16 else None
    route = ssd_plan(dtype, p, n)

    def on(r) -> dict:
        y, st = ssd_scan(x, dt, a, bm, cm, route=r)
        y2, st2 = ssd_scan(x, dt, a, bm, cm, route=r)
        torch.cuda.synchronize()
        y_err = held(f"ssd_scan y ({r})", y, want_y, atol, rtol, rel_norm)
        st_err = held(f"ssd_scan state ({r})", st, want_st, st_atol, st_rtol)
        res = {**y_err, "state_max_abs_err": st_err["max_abs_err"],
               "state_rel_norm_err": st_err["rel_norm_err"],
               "bit_identical": bool(torch.equal(y, y2) and torch.equal(st, st2))}
        if not res["bit_identical"]:
            raise AssertionError(f"ssd_scan ({r}): two launches on the same inputs differ")
        if timed:
            res.update(kernel_ms=device_ms(lambda: ssd_scan(x, dt, a, bm, cm, route=r)),
                       call_ms=call_ms(lambda: ssd_scan(x, dt, a, bm, cm, route=r)))
        return res

    row = {"kernel": "ssd_scan",
           "shape": {"B": b, "S": s, "H": h, "P": p, "N": n, "dtype": str(dtype).split(".")[-1]},
           "dt": "softplus(N(0,1))" if dt_range is None else f"log-uniform {list(dt_range)}",
           # share of the state one 64-token chunk carries into the next
           "chunk_carry_mean": float(torch.exp(dt[:, :CHUNK].sum(1) * a).mean()),
           "tol": {"y": {"atol": atol, "rtol": rtol, "rel_norm": rel_norm},
                   "state": {"atol": st_atol, "rtol": st_rtol}},
           "route": route, **on(route)}
    if both_routes:
        other = next(r for r in ROUTES if r != route)
        row["other_route"] = {"route": other, **on(other)}
    if timed:
        # each input read once, y and the final state written once
        nbytes = (x.element_size() * (2 * x.numel() + bm.numel() + cm.numel())
                  + 4 * (dt.numel() + a.numel() + want_st.numel()))
        flops = ssd_flops(b, s, h, p, n)
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        row.update(
            plain_ms=device_ms(lambda: ssd_scan_plain(x, dt, a, bm, cm), launches=3),
            library_ms=None,
            library_none_because="no single PyTorch call computes the SSD scan",
            bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
            mma_flops=ssd_mma_flops(b, s, h, p, n))
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
                                      p=cfg.ssm_head_dim, n=cfg.ssm_state, dtype=bf16, timed=True,
                                      both_routes=True),
        # mamba2-1.3b's N=128
        "ssd_n128": check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=ssm_cfg.ssm_heads,
                                   p=ssm_cfg.ssm_head_dim, n=ssm_cfg.ssm_state, dtype=bf16,
                                   timed=True, both_routes=True),
        # a long prompt, what Mamba-2 is served for: B*H = 64 blocks, 128 chunks each
        "ssd_long": check_ssd_scan(gen, b=1, s=SSD_LONG_S, h=cfg.ssm_heads, p=cfg.ssm_head_dim,
                                   n=cfg.ssm_state, dtype=bf16, timed=True, both_routes=True),
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
                       n=cfg.ssm_state, dtype=bf16, dt_range=SSD_SMALL_DT, both_routes=True),
        check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=cfg.ssm_heads, p=cfg.ssm_head_dim,
                       n=cfg.ssm_state, dtype=fp32, dt_range=SSD_SMALL_DT),
        check_ssd_scan(gen, b=BATCH, s=PROMPT_LEN, h=ssm_cfg.ssm_heads, p=ssm_cfg.ssm_head_dim,
                       n=ssm_cfg.ssm_state, dtype=bf16, dt_range=SSD_SMALL_DT,
                       both_routes=True),                               # N=128, state carried
        check_ssd_scan(gen, b=2, s=333, h=8, p=64, n=64, dtype=bf16,    # no chunk multiple
                       both_routes=True),
        check_ssd_scan(gen, b=2, s=1, h=8, p=64, n=64, dtype=bf16, both_routes=True),
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

def logits_agree(name: str, got: torch.Tensor, want: torch.Tensor, atol: float = LOGIT_ATOL,
                 rtol: float = LOGIT_RTOL) -> float:
    """Max |got - want|; raises unless both are finite, of one shape and
    within atol + rtol |want|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: bad shape {tuple(got.shape)} or non-finite logits")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: logits differ by up to {err} (atol {atol}, rtol {rtol})")
    return err


@contextlib.contextmanager
def routes(replay=None):
    """The experts (T, k) that every ``moe.route`` call made while it is open
    picks, in call order. With ``replay`` (such experts, one a call), each
    call sends its tokens to the replayed experts instead, weighted by its own
    router probabilities renormalised over them as ``route`` does (its aux
    loss is its own pick's): two paths then route alike whatever their
    roundings."""
    from repro_torch.models import moe

    calls, route = [], moe.route

    def recording(params, cfg, x2d):
        weights, experts, aux = route(params, cfg, x2d)
        calls.append(experts)
        if replay is None:
            return weights, experts, aux
        experts = replay[len(calls) - 1]
        probs = torch.softmax((x2d @ params["router"]).float(), dim=-1).gather(-1, experts)
        weights = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
        return weights.to(x2d.dtype), experts, aux

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def drive(model, prompts, batches: dict, counters, gen_steps: int,
          record_routes: bool = False, replay: dict | None = None, max_len: int = MAX_LEN,
          enc_len: int = 0, prepare=None) -> dict:
    """The prefill step on each of ``batches`` (name -> batch), then the
    engine's ``generate``. Per part: the launch counts (and, for a counter
    with ``launches_by_route``, those by route), host-clock seconds around a
    synchronize, logits (the prefill step's last position; the engine's at
    the last prompt position) and, with ``record_routes`` or ``replay``, the
    experts each routing picked; ``replay`` (part -> experts a call) routes
    each part's calls as given. The engine holds ``max_len`` positions and
    ``enc_len`` cross-cache rows; ``prepare(engine)`` runs before
    ``generate``, outside its timed span."""
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.serve.step import make_prefill_step

    prefill = make_prefill_step(model)
    out = {"prefill": prefill, "launches": {}, "by_route": {}, "seconds": {}, "logits": {},
           "routes": {}}
    by_route = [c for c in counters if hasattr(c, "launches_by_route")]

    def part(name, fn):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        for c in by_route:
            c.launches_by_route = dict.fromkeys(c.launches_by_route, 0)
        recorder = (routes(replay[name] if replay else None) if record_routes or replay
                    else contextlib.nullcontext([]))
        with recorder as calls:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {c.__name__: c.launches for c in counters}
        out["by_route"][name] = {c.__name__: dict(c.launches_by_route) for c in by_route}
        out["routes"][name] = calls
        return result

    for name, batch in batches.items():
        out["logits"][name] = part(name, lambda: prefill(batch))[:, 0].float()
    engine = ServingEngine(model, BATCH, max_len, enc_len=enc_len)
    if prepare is not None:
        prepare(engine)
    out["tokens"] = part("generate", lambda: engine.generate(prompts, gen_steps))
    out["logits"]["engine"] = engine.prefill_logits
    out["engine"] = engine
    return out


def total_launches(ker: dict) -> dict:
    """A drive's launches by counter, summed over its parts."""
    parts = list(ker["launches"].values())
    return {k: sum(part[k] for part in parts) for k in parts[0]}


def serve_times(ker: dict, ref: dict, timed: dict, prompts, batch, gen_steps: int) -> dict:
    """The eager ms of the timed drive, device ms (graph replay) of the
    prefill step on ``batch`` and of one decode step at the last position,
    the idle shares, the naive path's and the first drive's eager ms, and a
    ``torch.profiler`` breakdown of each step. The engine is built outside
    the timed spans."""
    engine, drive_steps = timed["engine"], prompts.shape[1] + gen_steps - 1
    generate_s = timed["seconds"]["generate"]
    prefill_ms = timed["seconds"]["prefill"] * 1e3
    decode_ms = generate_s * 1e3 / drive_steps
    prefill_device_ms = device_ms(lambda: timed["prefill"](batch), launches=1, replays=3)
    decode_device_ms = device_ms(lambda: engine.decode(engine.cache, prompts[:, :1], drive_steps),
                                 launches=1, replays=10)
    return {"prefill_ms": prefill_ms, "prefill_device_ms": prefill_device_ms,
            "prefill_device_idle_share": 1 - prefill_device_ms / prefill_ms,
            "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": decode_device_ms,
            "decode_device_idle_share": 1 - decode_device_ms / decode_ms,
            "generate_s": generate_s,
            "generated_tokens_per_s": BATCH * gen_steps / generate_s,
            "decode_tokens_per_s": BATCH * drive_steps / generate_s,
            "naive_prefill_ms": ref["seconds"]["prefill"] * 1e3,
            "naive_decode_ms_per_step": ref["seconds"]["generate"] * 1e3 / drive_steps,
            "first_run_prefill_ms": ker["seconds"]["prefill"] * 1e3,
            "profile": {"prefill": profile_step(lambda: timed["prefill"](batch)),
                        "decode_step": profile_step(
                            lambda: engine.decode(engine.cache, prompts[:, :1], drive_steps))}}


def check_launches(name: str, ker: dict, ref: dict, want: dict) -> None:
    """The kernel path's launch counts as designed, none on the naive path."""
    if ker["launches"] != want:
        raise AssertionError(f"{name}: launch counts {ker['launches']}, expected {want}")
    if any(v for part in ref["launches"].values() for v in part.values()):
        raise AssertionError(f"{name}: the naive path launched a kernel: {ref['launches']}")


def check_drives(name: str, cfg, ker: dict, ref: dict, timed: dict, want: dict,
                 gen_steps: int) -> None:
    """``check_launches``, and two kernel-path drives equal to the bit
    (logits and tokens)."""
    check_launches(name, ker, ref, want)
    toks = ker["tokens"]
    if (toks.shape != (BATCH, gen_steps) or int(toks.min()) < 0
            or int(toks.max()) >= cfg.vocab_size):
        raise AssertionError(f"{name}: bad tokens: shape {tuple(toks.shape)}")
    if not torch.equal(toks, timed["tokens"]):
        raise AssertionError(f"{name}: two greedy runs of the kernel path gave different tokens")
    for part, logits in ker["logits"].items():
        if not torch.equal(logits, timed["logits"][part]):
            raise AssertionError(f"{name}: two kernel-path runs gave different {part} logits")


def phase_serve(cfg) -> dict:
    """tinyllama-1.1b at full width and depth through the prefill step and
    the engine, kernel path (K1, K3) against the naive path on the same
    weights."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import LanguageModel

    model = LanguageModel(cfg, impl="kernel")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive")
    naive.params = model.params                      # the same weights, not a copy
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    batches = {"prefill": {"tokens": prompts}}
    counters = (flash_attention, flash_decode)
    drive_steps = PROMPT_LEN + GEN_STEPS - 1         # decode-step calls in one generate
    want = {"prefill": {"flash_attention": cfg.n_layers, "flash_decode": 0},
            "generate": {"flash_attention": 0, "flash_decode": cfg.n_layers * drive_steps}}

    torch.cuda.reset_peak_memory_stats()
    ker = drive(model, prompts, batches, counters, GEN_STEPS)
    peak_bytes = torch.cuda.max_memory_allocated()
    ref = drive(naive, prompts, batches, counters, GEN_STEPS)
    # a second kernel-path drive for the times: the first one paid for cuBLAS's
    # start-up and the allocator's first growth
    timed = drive(model, prompts, batches, counters, GEN_STEPS)
    check_drives("serve", cfg, ker, ref, timed, want, GEN_STEPS)
    kl, rl = ker["logits"], ref["logits"]
    errs = {
        "engine_vs_prefill": logits_agree("engine vs prefill step (kernel path)",
                                          kl["engine"], kl["prefill"]),
        "prefill_kernel_vs_naive": logits_agree("prefill step, kernel vs naive",
                                                kl["prefill"], rl["prefill"]),
        "engine_kernel_vs_naive": logits_agree("engine, kernel vs naive",
                                               kl["engine"], rl["engine"]),
    }
    row = {"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
           "batch": BATCH, "prompt_len": PROMPT_LEN, "gen_steps": GEN_STEPS, "max_len": MAX_LEN,
           "launches": ker["launches"], "logit_max_abs_diff": errs,
           "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
           "kernel_runs_bit_identical": True,
           **serve_times(ker, ref, timed, prompts, batches["prefill"], GEN_STEPS),
           "max_memory_allocated_bytes": peak_bytes}
    emit(row)
    return total_launches(ker)


def phase_serve_hybrid(cfg) -> dict:
    """zamba2-1.2b at full width and depth through the prefill step and the
    engine, kernel path (K5, K1/K3, K4) against the naive path."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import LanguageModel
    from repro_torch.models.layers import embed, rmsnorm
    from repro_torch.models.lm import _unbind_layers
    from repro_torch.models.ssm import mamba2_decode, mamba2_forward

    counters = (ssd_scan, flash_attention, fused_ffn, flash_decode)
    model = LanguageModel(cfg, impl="kernel", fused_ffn=True)
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive", fused_ffn=False)
    naive.params = model.params                      # the same weights, not a copy
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    engine_prompts = prompts[:, :ENGINE_PROMPT]
    batches = {"prefill": {"tokens": prompts}, "prefill_short": {"tokens": engine_prompts}}
    n_shared = cfg.n_layers // cfg.attn_every
    drive_steps = ENGINE_PROMPT + HYBRID_GEN_STEPS - 1  # decode-step calls in one generate
    per_prefill = {"ssd_scan": cfg.n_layers, "flash_attention": n_shared, "fused_ffn": n_shared,
                   "flash_decode": 0}
    want = {"prefill": per_prefill, "prefill_short": {**per_prefill, "flash_attention": 0},
            "generate": {"ssd_scan": 0, "flash_attention": 0, "fused_ffn": n_shared * drive_steps,
                         "flash_decode": n_shared * drive_steps}}
    # K4's route: the prefill steps' T = 2048 and T = 256 (the tiled route's
    # threshold) take the tiled route, decode's T = 4 the row tiles; K5's: the
    # prefill steps' bf16 scan at N=64 the mma route
    per_route = {"ssd_scan": {"mma": cfg.n_layers, "fma": 0},
                 "fused_ffn": {"tiled": n_shared, "rowtile": 0}}
    want_by_route = {"prefill": per_route, "prefill_short": per_route,
                     "generate": {"ssd_scan": {"mma": 0, "fma": 0},
                                  "fused_ffn": {"tiled": 0, "rowtile": n_shared * drive_steps}}}

    torch.cuda.reset_peak_memory_stats()
    ker = drive(model, engine_prompts, batches, counters, HYBRID_GEN_STEPS)
    peak_bytes = torch.cuda.max_memory_allocated()
    if ker["by_route"] != want_by_route:
        raise AssertionError(f"launches by route {ker['by_route']}, expected {want_by_route}")
    ref = drive(naive, engine_prompts, batches, counters, HYBRID_GEN_STEPS)
    # the first drive paid for start-up
    timed = drive(model, engine_prompts, batches, counters, HYBRID_GEN_STEPS)
    check_drives("serve_hybrid", cfg, ker, ref, timed, want, HYBRID_GEN_STEPS)
    kl, rl = ker["logits"], ref["logits"]
    errs = {
        "engine_vs_prefill": logits_agree("hybrid: engine vs prefill step (kernel path)",
                                          kl["engine"], kl["prefill_short"]),
        "prefill_kernel_vs_naive": logits_agree("hybrid: prefill step, kernel vs naive",
                                                kl["prefill"], rl["prefill"]),
        "engine_kernel_vs_naive": logits_agree("hybrid: engine, kernel vs naive",
                                               kl["engine"], rl["engine"]),
    }

    # layer 0 at full width: the SSM state after the prompt through the kernel
    # scan against the state after as many decode steps. Each side's inputs
    # carry its own bf16 rounding (in_proj over 512 tokens or over one), so
    # the two are held as the bf16 K5 checks are: 2e-2 max|want| + 2e-2 |want|
    p0 = _unbind_layers(model.params["layers"], cfg.n_layers)[0]
    with torch.no_grad():
        h0 = rmsnorm(p0["ln"], embed(model.params["emb"], prompts), cfg.norm_eps)
        _, (conv_fwd, st_fwd) = mamba2_forward(p0["mixer"], cfg, h0, scan="kernel")
        cache = model.init_cache(BATCH, 1)
        conv, st = cache["conv"][0], cache["ssm"][0]
        for t in range(PROMPT_LEN):
            mamba2_decode(p0["mixer"], cfg, h0[:, t:t + 1], conv, st)
    state_err = scaled_compare("layer 0 SSM state, prefill kernel vs decode", st_fwd, st,
                               2e-2, 2e-2, True)
    conv_equal = bool(torch.equal(conv_fwd, conv))

    row = {"phase": "serve_hybrid", "arch": cfg.name, "n_layers": cfg.n_layers,
           "shared_block_calls": n_shared, "dtype": "bfloat16", "impl": "kernel",
           "fused_ffn": True, "batch": BATCH, "prompt_len": PROMPT_LEN,
           "engine_prompt_len": ENGINE_PROMPT,
           "gen_steps": HYBRID_GEN_STEPS, "max_len": MAX_LEN, "launches": ker["launches"],
           "launches_by_route": ker["by_route"],
           "logit_max_abs_diff": errs,
           "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
           "kernel_runs_bit_identical": True,
           "layer0_state_max_abs_err": state_err,
           "layer0_state_max_abs": float(st.abs().max()),
           "layer0_state_rel_err": rel_err(st_fwd, st),
           "layer0_conv_state_equal": conv_equal,
           **serve_times(ker, ref, timed, engine_prompts, batches["prefill"], HYBRID_GEN_STEPS),
           "max_memory_allocated_bytes": peak_bytes}
    emit(row)

    def routes_total(name):
        return {r: sum(part[name][r] for part in ker["by_route"].values())
                for r in want_by_route["prefill"][name]}

    return total_launches(ker), routes_total("fused_ffn"), routes_total("ssd_scan")


def phase_serve_audio(cfg) -> dict:
    """whisper-base at full size through the prefill step (AUDIO_FRAMES
    seeded frames and AUDIO_MAX_LEN tokens: K1 in the encoder, the decoder
    and the cross-attention) and the engine (K3 on the self cache and on the
    cross cache at every layer of every step), kernel path against the naive
    path on the same weights. The reference's engine never fills the cross
    caches (they stay zeros); so that K3's cross call does real work, this
    harness writes the same seeded values into them before each drive's
    ``generate``, on both paths."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params

    t_start = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, impl="kernel")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive")
    naive.params = model.params                      # the same weights, not a copy
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, AUDIO_PROMPT), device="cuda",
                            generator=gen)
    batches = {"prefill": {
        "frames": randn(gen, (BATCH, AUDIO_FRAMES, cfg.d_model), torch.bfloat16),
        "tokens": torch.randint(0, cfg.vocab_size, (BATCH, AUDIO_MAX_LEN), device="cuda",
                                generator=gen)}}
    cross_shape = (cfg.n_layers, BATCH, AUDIO_FRAMES, cfg.n_kv_heads, cfg.head_dim)
    cross = {k: randn(gen, cross_shape, torch.bfloat16) for k in ("cross_k", "cross_v")}

    def fill_cross(engine):
        for k, v in cross.items():
            engine.cache[k].copy_(v)

    counters = (flash_attention, flash_decode)
    drive_steps = AUDIO_PROMPT + AUDIO_GEN_STEPS - 1
    per_forward = cfg.n_encoder_layers + 2 * cfg.n_layers     # encoder, self, cross
    want = {"prefill": {"flash_attention": per_forward, "flash_decode": 0},
            "generate": {"flash_attention": 0, "flash_decode": 2 * cfg.n_layers * drive_steps}}
    kw = dict(max_len=AUDIO_MAX_LEN, enc_len=AUDIO_FRAMES, prepare=fill_cross)

    ker = drive(model, prompts, batches, counters, AUDIO_GEN_STEPS, **kw)
    peak = torch.cuda.max_memory_allocated()
    ref = drive(naive, prompts, batches, counters, AUDIO_GEN_STEPS, **kw)
    timed = drive(model, prompts, batches, counters, AUDIO_GEN_STEPS, **kw)
    check_drives("serve_audio", cfg, ker, ref, timed, want, AUDIO_GEN_STEPS)
    if not torch.equal(ker["engine"].cache["cross_k"], cross["cross_k"]):
        raise AssertionError("serve_audio: the decode step wrote the cross cache")
    kl, rl = ker["logits"], ref["logits"]
    errs = {"prefill_kernel_vs_naive": logits_agree("audio: prefill step, kernel vs naive",
                                                    kl["prefill"], rl["prefill"]),
            "engine_kernel_vs_naive": logits_agree("audio: engine, kernel vs naive",
                                                   kl["engine"], rl["engine"])}
    # the same comparison where the cross-attention contributes nothing: the
    # naive path on frames of zeros (the encoder's output, and so the cross
    # keys and values, are then zeros) and on the cross caches as the
    # reference's engine leaves them (zeros)
    zero_frames = {"prefill": {**batches["prefill"],
                               "frames": torch.zeros_like(batches["prefill"]["frames"])}}
    blind = drive(naive, prompts, zero_frames, counters, AUDIO_GEN_STEPS,
                  max_len=AUDIO_MAX_LEN, enc_len=AUDIO_FRAMES)["logits"]
    rel, blind_rel = {}, {}
    for part in ("prefill", "engine"):
        rel[part] = rel_err(kl[part], rl[part])
        blind_rel[part] = rel_err(blind[part], rl[part])
        if rel[part] > AUDIO_LOGIT_REL_NORM:
            raise AssertionError(f"serve_audio: {part} logits, kernel vs naive: relative norm "
                                 f"error {rel[part]} > {AUDIO_LOGIT_REL_NORM}")
        if blind_rel[part] < AUDIO_BLIND_MARGIN * AUDIO_LOGIT_REL_NORM:
            raise AssertionError(f"serve_audio: {part} logits move by only {blind_rel[part]} "
                                 "without the cross-attention: the bound could not see it fail")
    row = {"phase": "serve_audio", "arch": cfg.name, "dtype": "bfloat16",
           "n_layers": {"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers},
           "heads": {"H": cfg.n_heads, "KVH": cfg.n_kv_heads, "D": cfg.head_dim},
           "n_params": count_params(model.specs()), "batch": BATCH,
           "prefill_frames": AUDIO_FRAMES, "prefill_tokens": AUDIO_MAX_LEN,
           "prompt_len": AUDIO_PROMPT, "gen_steps": AUDIO_GEN_STEPS, "max_len": AUDIO_MAX_LEN,
           "enc_len": AUDIO_FRAMES,
           "cross_caches": "seeded values written by this harness before each generate (the "
                           "reference's engine leaves them zeros); the same on both paths",
           "launches": ker["launches"], "logit_max_abs_diff": errs,
           "logit_rel_err": {"kernel_vs_naive": rel, "bound": AUDIO_LOGIT_REL_NORM,
                             "naive_without_cross_attention": blind_rel},
           "logit_spread": {part: float(rl[part].float().std()) for part in ("prefill", "engine")},
           "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
           "kernel_runs_bit_identical": True,
           **serve_times(ker, ref, timed, prompts, batches["prefill"], AUDIO_GEN_STEPS),
           "max_memory_allocated_bytes": peak}
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    return total_launches(ker)


def free_memory() -> None:
    """Returns what earlier phases left to the allocator's cache, so that a
    full-size model finds the card's memory whole."""
    gc.collect()
    torch.cuda.empty_cache()


def routing_agreement(got: list, want: list, n_layers: int) -> dict:
    """How far two runs over the same calls (layer after layer) routed
    alike: the share of (token, expert) decisions both made (a token's k
    experts as a set), overall and by layer; the share of tokens sent to the
    same set; the share of top-k slots holding the same expert in the same
    rank."""
    both = [(g[:, :, None] == w[:, None, :]).any(-1) for g, w in zip(got, want)]
    by_layer = [torch.cat(both[i::n_layers]).float().mean() for i in range(n_layers)]
    both = torch.cat(both)
    slots = torch.cat([(g == w).reshape(-1) for g, w in zip(got, want)])
    return {"token_routings": both.shape[0], "decision_share": float(both.float().mean()),
            "decision_share_by_layer": [float(x) for x in by_layer],
            "token_share": float(both.all(-1).float().mean()),
            "slot_share": float(slots.float().mean())}


def dropped_assignments(routes: list, cfg) -> list[int]:
    """(token, expert) assignments past their expert's capacity, a call each."""
    from repro_torch.models.moe import _capacity

    out = []
    for experts in routes:
        counts = torch.bincount(experts.reshape(-1), minlength=cfg.n_experts)
        out.append(int((counts - _capacity(experts.shape[0], cfg)).clamp(min=0).sum()))
    return out


def phase_serve_vlm(cfg) -> dict:
    """internvl2-26b at full width and depth through the prefill step (with
    VLM_PATCHES seeded patch embeddings, and without) and the engine, kernel
    path (K1, K3 at D=128, G=6) against the naive path on the same weights."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params

    t_start = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, impl="kernel")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    init_peak = torch.cuda.max_memory_allocated()
    naive = LanguageModel(cfg, impl="naive")
    naive.params = model.params                      # the same weights, not a copy
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda", generator=gen)
    patches = randn(gen, (BATCH, VLM_PATCHES, cfg.d_model), torch.bfloat16)
    engine_prompts = prompts[:, :ENGINE_PROMPT]
    batches = {"prefill": {"tokens": prompts, "patch_embeds": patches},
               "prefill_no_patches": {"tokens": prompts},
               "prefill_short": {"tokens": engine_prompts}}
    counters = (flash_attention, flash_decode)
    drive_steps = ENGINE_PROMPT + FAMILY_GEN_STEPS - 1
    per_prefill = {"flash_attention": cfg.n_layers, "flash_decode": 0}
    want = {"prefill": per_prefill, "prefill_no_patches": per_prefill,
            "prefill_short": {"flash_attention": 0, "flash_decode": 0},
            "generate": {"flash_attention": 0, "flash_decode": cfg.n_layers * drive_steps}}

    torch.cuda.reset_peak_memory_stats()
    ker = drive(model, engine_prompts, batches, counters, FAMILY_GEN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    ref = drive(naive, engine_prompts, batches, counters, FAMILY_GEN_STEPS)
    timed = drive(model, engine_prompts, batches, counters, FAMILY_GEN_STEPS)
    check_drives("serve_vlm", cfg, ker, ref, timed, want, FAMILY_GEN_STEPS)
    kl, rl = ker["logits"], ref["logits"]
    errs = {
        "prefill_kernel_vs_naive": logits_agree("vlm: prefill step with patches, kernel vs naive",
                                                kl["prefill"], rl["prefill"]),
        "prefill_no_patches_kernel_vs_naive": logits_agree(
            "vlm: prefill step without patches, kernel vs naive",
            kl["prefill_no_patches"], rl["prefill_no_patches"]),
        # the engine embeds token ids only, as the reference's does
        "engine_vs_prefill_no_patches": logits_agree("vlm: engine vs prefill step (kernel path)",
                                                     kl["engine"], kl["prefill_short"]),
        "engine_kernel_vs_naive": logits_agree("vlm: engine, kernel vs naive",
                                               kl["engine"], rl["engine"]),
    }
    # the patches reach the model: they move the last position's logits
    patch_shift = float((kl["prefill"] - kl["prefill_no_patches"]).abs().max())
    if torch.allclose(kl["prefill"], kl["prefill_no_patches"], atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise AssertionError("vlm: the patch embeddings did not move the prefill step's logits")
    row = {"phase": "serve_vlm", "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "bfloat16",
           "heads": {"H": cfg.n_heads, "KVH": cfg.n_kv_heads, "D": cfg.head_dim},
           "n_params": count_params(model.specs()), "batch": BATCH, "prompt_len": PROMPT_LEN,
           "engine_prompt_len": ENGINE_PROMPT, "patches": VLM_PATCHES, "gen_steps": FAMILY_GEN_STEPS, "max_len": MAX_LEN,
           "launches": ker["launches"], "logit_max_abs_diff": errs,
           "logit_max_abs_shift_by_patches": patch_shift,
           "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
           "kernel_runs_bit_identical": True,
           **serve_times(ker, ref, timed, engine_prompts, batches["prefill"], FAMILY_GEN_STEPS),
           "prefill_no_patches_ms": timed["seconds"]["prefill_no_patches"] * 1e3,
           "init_max_memory_allocated_bytes": init_peak, "max_memory_allocated_bytes": peak}
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    return total_launches(ker)


def phase_serve_routed(phase: str, full_cfg, n_layers: int, fp32_layers: int) -> dict:
    """A routed-expert model at full width, cut to ``n_layers`` layers (bf16),
    then ``fp32_layers`` in fp32: the prefill step and the engine, kernel path
    against the naive path on the same weights, with both paths' routing
    decisions. ``serve_moe`` (qwen3-moe-235b-a22b, GQA: K1 prefill, K3
    decode) and ``serve_mla`` (deepseek-v2-236b, MLA: K1 prefill at head
    dims (192, 128), the absorbed decode with no kernel, a dense-FFN layer
    first)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params
    from repro_torch.models.moe import _capacity
    from repro_torch.serve.step import make_prefill_step

    t_start = time.perf_counter()
    counters = (flash_attention, flash_decode)
    drive_steps = ENGINE_PROMPT + FAMILY_GEN_STEPS - 1
    prompts = torch.randint(0, full_cfg.vocab_size, (BATCH, PROMPT_LEN), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(2))
    engine_prompts = prompts[:, :ENGINE_PROMPT]
    batches = {"prefill": {"tokens": prompts}, "prefill_short": {"tokens": engine_prompts}}

    def build(n, dtype):
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(full_cfg, n_layers=n)
        model = LanguageModel(cfg, impl="kernel")
        model.init(torch.Generator(device="cuda").manual_seed(0), dtype=dtype)
        naive = LanguageModel(cfg, impl="naive")
        naive.params = model.params                  # the same weights, not a copy
        return cfg, model, naive, torch.cuda.max_memory_allocated()

    def want(cfg):
        # MLA's absorbed decode runs on the latent cache with no kernel
        decode = 0 if cfg.use_mla else cfg.n_layers * drive_steps
        return {"prefill": {"flash_attention": cfg.n_layers, "flash_decode": 0},
                "prefill_short": {"flash_attention": 0, "flash_decode": 0},
                "generate": {"flash_attention": 0, "flash_decode": decode}}

    def routed(cfg):
        return cfg.n_layers - cfg.first_k_dense     # route calls a forward or decode step

    def routing(cfg, ker, ref):
        # the engine's prompt steps (teacher-forced, so both paths see the
        # same tokens); the steps after follow each path's own tokens
        prompt_calls = ENGINE_PROMPT * routed(cfg)
        return {"prefill": routing_agreement(ker["routes"]["prefill"], ref["routes"]["prefill"],
                                             routed(cfg)),
                "engine_prompt": routing_agreement(ker["routes"]["generate"][:prompt_calls],
                                                   ref["routes"]["generate"][:prompt_calls],
                                                   routed(cfg))}

    # ---- bf16, n_layers layers ----
    cfg, model, naive, init_peak = build(n_layers, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    ker = drive(model, engine_prompts, batches, counters, FAMILY_GEN_STEPS, record_routes=True)
    peak = torch.cuda.max_memory_allocated()
    # bf16 router logits over 128 experts nearly tie, and a flipped k-th expert
    # moves a token by far more than attention's own rounding: the naive path
    # sends each token to the experts the kernel path chose (its own picks are
    # recorded, given the same routing in the layers before), so the logits
    # compare attention's two paths
    ref = drive(naive, engine_prompts, batches, counters, FAMILY_GEN_STEPS, replay=ker["routes"])
    timed = drive(model, engine_prompts, batches, counters, FAMILY_GEN_STEPS)
    check_drives(phase, cfg, ker, ref, timed, want(cfg), FAMILY_GEN_STEPS)
    agree = routing(cfg, ker, ref)
    tokens = BATCH * PROMPT_LEN
    dropped = dropped_assignments(ker["routes"]["prefill"], cfg)
    if any(dropped_assignments(ker["routes"]["generate"], cfg)):
        raise AssertionError(f"{phase}: a decode step ({BATCH} tokens, capacity "
                             f"{_capacity(BATCH, cfg)}) dropped an assignment")
    # a prefill step packs all its tokens against one capacity, a decode step
    # 4: the engine is held against a prefill step on its prompt that drops
    # nothing (capacity_factor = E / k) and routes each token as the engine's
    # prompt steps did (a call a step and routed layer, B tokens each)
    L = routed(cfg)
    prompt_routes = ker["routes"]["generate"][:ENGINE_PROMPT * L]
    engine_routes = [torch.stack(prompt_routes[i::L], dim=1).reshape(BATCH * ENGINE_PROMPT,
                                                                      cfg.top_k)
                     for i in range(L)]
    no_drops = LanguageModel(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                             impl="kernel")
    no_drops.params = model.params
    with routes(engine_routes):
        no_drop_logits = make_prefill_step(no_drops)(batches["prefill_short"])[:, 0].float()
    kl, rl = ker["logits"], ref["logits"]
    errs = {
        "prefill_kernel_vs_naive": logits_agree(f"{phase}: prefill step, kernel vs naive",
                                                kl["prefill"], rl["prefill"]),
        "engine_kernel_vs_naive": logits_agree(f"{phase}: engine, kernel vs naive", kl["engine"],
                                               rl["engine"]),
        "engine_vs_prefill_no_drops": logits_agree(
            f"{phase}: engine vs prefill step without drops, its routes (kernel path)",
            kl["engine"], no_drop_logits),
    }
    heads = {"H": cfg.n_heads, "KVH": cfg.n_kv_heads, "D": cfg.head_dim}
    if cfg.use_mla:
        heads.update(kv_lora=cfg.kv_lora_rank, q_lora=cfg.q_lora_rank, rope=cfg.rope_head_dim,
                     v=cfg.v_head_dim, k1_head_dims=[cfg.head_dim + cfg.rope_head_dim,
                                                     cfg.v_head_dim])
    kd = cfg.first_k_dense
    row = {"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
           "reduced": f"depth {cfg.n_layers} of {full_cfg.n_layers} layers"
                      + (f" ({kd} dense-FFN, {L} MoE)" if kd else "") + "; full width",
           "dtype": "bfloat16", "heads": heads,
           "experts": {"E": cfg.n_experts, "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff,
                       "shared": cfg.n_shared_experts,
                       "capacity_prefill": _capacity(tokens, cfg),
                       "capacity_decode": _capacity(BATCH, cfg)},
           "n_params": count_params(model.specs()), "batch": BATCH, "prompt_len": PROMPT_LEN,
           "engine_prompt_len": ENGINE_PROMPT,
           "gen_steps": FAMILY_GEN_STEPS, "max_len": MAX_LEN, "launches": ker["launches"],
           "cache": {k: list(v.shape) for k, v in timed["engine"].cache.items()},
           "naive_routes": "the kernel path's, replayed",
           "routing_agreement": agree,
           "prefill_dropped_assignments": {"by_layer": dropped, "of": tokens * cfg.top_k,
                                           "share": sum(dropped) / (tokens * cfg.top_k * L)},
           "logit_max_abs_diff": errs,
           "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
           "kernel_runs_bit_identical": True,
           **serve_times(ker, ref, timed, engine_prompts, batches["prefill"], FAMILY_GEN_STEPS),
           "init_max_memory_allocated_bytes": init_peak, "max_memory_allocated_bytes": peak}
    launches = total_launches(ker)
    del model, naive, no_drops, ker, ref, timed

    # ---- fp32, fp32_layers layers: each path routes for itself ----
    cfg32, model, naive, init_peak32 = build(fp32_layers, torch.float32)
    ker = drive(model, engine_prompts, batches, counters, FAMILY_GEN_STEPS, record_routes=True)
    ref = drive(naive, engine_prompts, batches, counters, FAMILY_GEN_STEPS, record_routes=True)
    check_launches(f"{phase} fp32", ker, ref, want(cfg32))
    kl, rl = ker["logits"], ref["logits"]
    row["fp32"] = {
        "n_layers": cfg32.n_layers, "n_params": count_params(model.specs()), "tol": LOGIT_TOL_FP32,
        "launches": ker["launches"], "routing_agreement": routing(cfg32, ker, ref),
        "prefill_dropped_assignments": dropped_assignments(ker["routes"]["prefill"], cfg32),
        "logit_max_abs_diff": {
            "prefill_kernel_vs_naive": logits_agree(f"{phase} fp32: prefill step, kernel vs naive",
                                                    kl["prefill"], rl["prefill"],
                                                    LOGIT_TOL_FP32, LOGIT_TOL_FP32),
            "engine_kernel_vs_naive": logits_agree(f"{phase} fp32: engine, kernel vs naive",
                                                   kl["engine"], rl["engine"],
                                                   LOGIT_TOL_FP32, LOGIT_TOL_FP32)},
        "tokens_equal_naive": bool(torch.equal(ker["tokens"], ref["tokens"])),
        "prefill_ms": ker["seconds"]["prefill"] * 1e3,
        "decode_ms_per_step": ker["seconds"]["generate"] * 1e3 / drive_steps,
        "init_max_memory_allocated_bytes": init_peak32}
    # each path routes for itself: in fp32 every token must reach the same experts
    for part, agreement in row["fp32"]["routing_agreement"].items():
        if agreement["decision_share"] != 1.0:
            raise AssertionError(f"{phase} fp32: the two paths routed {part} differently: "
                                 f"{agreement}")
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    return launches


# --------------------------------------------------------------------------------
# the training path
# --------------------------------------------------------------------------------

SCAN_RANGE = "ssd_chunked"      # the naive scan's range in train_hybrid's profile
KERNEL_CLASSES = (("K1 flash_attention", ("attn_fwd",)),
                  ("K2a flash_attention_bwd_dq", ("attn_bwd_dq",)),
                  ("K2b flash_attention_bwd_dkv", ("attn_bwd_dkv",)),
                  ("K3 flash_decode", ("flash_decode",)),
                  ("K4 fused_ffn", ("ffn_mma", "ffn_fma", "ffn_combine", "ffn_gate_up_mma",
                                    "ffn_down_mma")),
                  ("K5 ssd_scan", ("ssd_chunk_scan",)),
                  ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas", "nvjet")))


def profile_step(fn, top: int = 15, ranges: tuple = ()) -> dict:
    """One call of ``fn`` under torch.profiler: the device time summed by
    kernel name, the top ``top`` of them, and the sums by class; with
    ``ranges`` (names of record_function ranges that ``fn`` opens), each
    range's device time as ``range_device_ms`` reads it."""
    from torch.profiler import ProfilerActivity, profile

    # the host's operators only where a range needs them: the device's own
    # events give the same kernel sums, and reading a training step's host
    # events as well takes about three times as long (8-16 s on an H100's host)
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if ranges
                  else [ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's own events (kernels, copies, memsets), not the host-side
    # operators that launched them, which carry the same time again, nor the
    # ranges' spans on the device's timeline, which cover kernels counted here
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in ranges]
    rows.sort(key=lambda r: -r[1])
    by_class = {name: 0.0 for name, _ in KERNEL_CLASSES}
    by_class["everything else"] = 0.0
    for key, ms, _ in rows:
        low = key.lower()
        name = next((n for n, marks in KERNEL_CLASSES if any(m in low for m in marks)),
                    "everything else")
        by_class[name] += ms
    out = {"device_ms": sum(r[1] for r in rows), "by_class_ms": by_class,
           "top": [{"kernel": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:top]]}
    if ranges:
        out["ranges"] = {name: range_device_ms(prof.events(), name) for name in ranges}
    return out


def range_device_ms(events, name: str) -> dict:
    """The device ms of a profile's record_function ranges ``name``: the
    kernels launched inside them (the forward, and remat's recompute), and
    those of the backward nodes that the operators inside them created. A
    backward node is matched to its forward by the autograd sequence number
    and the forward's thread; an operator that creates no node records the
    number the next node will take, so a number also recorded outside every
    range is not the range's. Each event is counted once."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [e for e in events if e.name == name and e.device_type == cpu]
    inside, stack = set(), list(spans)
    while stack:
        for child in stack.pop().cpu_children:
            inside.add(id(child))
            stack.append(child)
    made = {(e.sequence_nr, e.thread) for e in events if id(e) in inside and e.sequence_nr >= 0}
    made -= {(e.sequence_nr, e.thread) for e in events
             if id(e) not in inside and e.sequence_nr >= 0 and not e.fwd_thread}

    def hit(e):
        return bool(e.fwd_thread) and (e.sequence_nr, e.fwd_thread) in made

    def under_hit(e):
        parent = e.cpu_parent
        while parent is not None and not hit(parent):
            parent = parent.cpu_parent
        return parent is not None

    backward = [e for e in events if hit(e) and not under_hit(e)]
    forward_ms = sum(e.device_time_total for e in spans) / 1e3
    backward_ms = sum(e.device_time_total for e in backward) / 1e3
    return {"calls": len(spans), "backward_nodes": len(backward), "forward_ms": forward_ms,
            "backward_ms": backward_ms, "ms": forward_ms + backward_ms}


@contextlib.contextmanager
def scan_named():
    """While open, every naive SSD scan (``models.ssm.ssd_chunked``, which
    ``mamba2_forward`` looks up at each call, remat's recompute included)
    runs inside a record_function range named SCAN_RANGE."""
    from repro_torch.models import ssm

    inner = ssm.ssd_chunked

    def named(*args, **kw):
        with torch.profiler.record_function(SCAN_RANGE):
            return inner(*args, **kw)

    ssm.ssd_chunked = named
    try:
        yield
    finally:
        ssm.ssd_chunked = inner


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative norm error ||got - want|| / ||want|| in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def param_paths(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in ``tree_leaves``' order."""
    for k in sorted(tree.keys()):
        v = tree[k]
        yield from param_paths(v, f"{prefix}{k}.") if hasattr(v, "keys") else [prefix + k]


def phase_train(cfg) -> tuple[dict, dict]:
    """tinyllama-1.1b at full width and depth through ``train_family`` on one
    fixed TRAIN_BATCH x TRAIN_SEQ batch from the data pipeline (memorising it
    makes the loss fall): K1 twice a layer and step under remat "full", K2a
    and K2b once. The step's and the optimizer's device times are CUDA-graph
    replays, as this row has always taken them. Returns the launches and the
    row (``phase_dryrun`` reads its held bytes, peak, step time and FLOPs)."""
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params

    data = DataLoader(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    try:
        _, batch = next(data)
    finally:
        data.close()
    batch = to_device(batch, torch.device("cuda"))
    layers = cfg.n_layers
    per_step = {"flash_attention": 2 * layers,       # forward, and its recompute under remat
                "flash_attention_bwd_dq": layers, "flash_attention_bwd_dkv": layers}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = count_params(LanguageModel(cfg).specs()) - cfg.vocab_size * cfg.d_model
    attn_flops = layers * attention_train_flops(TRAIN_BATCH, cfg.n_heads, cfg.head_dim,
                                                TRAIN_SEQ, TRAIN_SEQ, True)
    row, launches = train_family("train", cfg, batch, per_step,
                                 6 * n_matmul * tokens + attn_flops, graphed=True)
    row.update(n_layers=layers, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    emit(row)
    return launches, row


# the dry-run's child process: launch.dryrun.run_cell as rank 0 of a fake
# process group (one a cell, each destroyed before the next), the records
# as one JSON line; the fake group is its process's default group, and this
# process starts NCCL groups later, so it runs apart
DRYRUN_CHILD = """
import json, sys, time
from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.core import msm
from repro_torch.launch import dryrun
from repro_torch.launch.specs import StandInMesh, input_specs, local_nbytes

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
out = {"cells": [], "cells_s": {}}
for name in SHAPES:
    t = time.perf_counter()
    out["cells"].append(dryrun.run_cell(arch, name))
    out["cells_s"][name] = time.perf_counter() - t
# decode_32k again with an int8 cache, and the bf16 cache's bytes a device
t = time.perf_counter()
policy = msm.compose("msm_decode", kv_cache_dtype="int8")
out["int8"] = dryrun.run_cell(arch, "decode_32k", policy=policy)
out["cells_s"]["decode_32k+kv_int8"] = time.perf_counter() - t
_, _, args, shardings = input_specs(arch, "decode_32k", StandInMesh((16, 16)))
out["bf16_cache_bytes"] = sum(local_nbytes(v, shardings[1][k]) for k, v in args[1].items())
t = time.perf_counter()
out["yardstick"] = dryrun.run_cell(arch, ShapeConfig("train", seq, batch, "train"),
                                   mesh=StandInMesh((1, 1)),
                                   policy=msm.compose("msm_train", microbatches=1))
out["cells_s"]["yardstick"] = time.perf_counter() - t
print(json.dumps(out))
"""
DRYRUN_TIMEOUT = 150
CHILDREN: list = []     # processes this script started, stopped at its exit


def phase_dryrun(cfg, train_row: dict) -> None:
    """The dry-run (``launch.dryrun``, on the host, no kernel launched), in a
    child process of its own (``DRYRUN_CHILD``, started and awaited here, so
    that no phase's host clock runs beside it; killed at DRYRUN_TIMEOUT):
    each cell's step runs through the port's mesh path as rank 0 of
    a fake process group of the mesh's size, its counts rank 0's own. (a)
    ``run_cell`` at tinyllama-1.1b's four shapes on the 16 x 16 mesh (256
    ranks): 3 cells ok, long_500k skipped, each with its three roofline
    terms, dominant term, argument and peak bytes a device, ``fits`` and
    its collectives by kind. (b) decode_32k again with an int8 cache
    (``compose(..., kv_cache_dtype="int8")``): its argument bytes are the
    bf16 cell's less half the cache's. (c) The ``train`` phase's own cell
    (TRAIN_BATCH x TRAIN_SEQ, the TRAIN_MSM recipe, remat "full", one
    microbatch) on a (1, 1) mesh, against that phase's state on the card:
    the argument bytes must equal the bytes of the parameters, optimizer
    state and batch it held, exactly, and no collective moves a byte; the
    dry-run's peak beside the step's ``max_memory_allocated``, the
    roofline's bound beside the step's device time, and
    ``useful_flops_cell`` beside the row's model FLOPs are printed."""
    t_start = time.perf_counter()
    stdout, stderr = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, cfg.name, str(TRAIN_SEQ),
                             str(TRAIN_BATCH)], stdin=subprocess.DEVNULL, stdout=stdout,
                            stderr=stderr, cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                 # meta ops: one thread ran the train cell faster
                                 "OMP_NUM_THREADS": "1"})
    CHILDREN.append(proc)
    try:
        code = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"dryrun: the child ran past {DRYRUN_TIMEOUT} s") from None
    child_s = time.perf_counter() - t_start
    stdout.seek(0)
    stderr.seek(0)
    if code:
        raise AssertionError(f"dryrun: the child exited {code}:\n{stderr.read()[-4000:]}")
    out = json.loads(stdout.read().strip().splitlines()[-1])
    cells = []
    for res in out["cells"]:
        if res["status"] == "ok":
            r = res["roofline"]
            cells.append({key: res[key] for key in (
                "shape", "mesh", "status", "step", "policy", "microbatches", "build_s",
                "flops_per_device", "argument_bytes_per_device", "peak_memory_per_device",
                "fits", "collective_bytes_per_device", "collectives")}
                | {key: r[key] for key in ("compute_s", "memory_s", "collective_s", "dominant",
                                           "bound_s", "roofline_fraction")})
        else:
            cells.append({key: res.get(key) for key in ("shape", "mesh", "status", "reason")})
    statuses = [c["status"] for c in cells]
    if statuses != ["ok", "ok", "ok", "skipped"] or cells[-1]["shape"] != "long_500k":
        raise AssertionError(f"dryrun: {cfg.name}'s four cells came back {statuses}, expected "
                             "three ok and long_500k skipped")
    bf16, int8 = out["cells"][2], out["int8"]
    if (int8["status"] != "ok" or int8["argument_bytes_per_device"]
            != bf16["argument_bytes_per_device"] - out["bf16_cache_bytes"] / 2):
        raise AssertionError(f"dryrun: the int8 cache's decode_32k argument bytes "
                             f"{int8.get('argument_bytes_per_device')} != the bf16 cell's "
                             f"{bf16['argument_bytes_per_device']} less half its cache's "
                             f"{out['bf16_cache_bytes']}")
    res = out["yardstick"]
    held = sum(train_row["held_bytes"].values())
    if res["argument_bytes_per_device"] != held:
        raise AssertionError(f"dryrun: argument bytes {res['argument_bytes_per_device']} != the "
                             f"train phase's held bytes {held} ({train_row['held_bytes']})")
    if res["collective_bytes_per_device"] != 0:
        raise AssertionError(f"dryrun: a (1, 1) mesh moved {res['collectives']}")
    r = res["roofline"]
    step_s = train_row["step_ms_device"] / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    diff = res["useful_flops"] - train_row["model_flops_per_step"]
    embedding = 6 * cfg.vocab_size * cfg.d_model * tokens
    diagonal = 6 * cfg.n_layers * TRAIN_BATCH * cfg.n_heads * cfg.head_dim * TRAIN_SEQ
    emit({"phase": "dryrun", "arch": cfg.name, "cells": cells, "cells_s": out["cells_s"],
          "child_s": child_s,
          "kv_int8": {"shape": "decode_32k", "argument_bytes": int8["argument_bytes_per_device"],
                      "bf16_argument_bytes": bf16["argument_bytes_per_device"],
                      "bf16_cache_bytes": out["bf16_cache_bytes"],
                      "flops_per_device": int8["flops_per_device"],
                      "collective_bytes_per_device": int8["collective_bytes_per_device"]},
          "yardstick": {
              "shape": {"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH, "step": "train"},
              "mesh": res["mesh"], "policy": res["policy"],
              "argument_bytes": res["argument_bytes_per_device"], "held_bytes": held,
              "held_bytes_by_part": train_row["held_bytes"], "argument_bytes_equal": True,
              "peak_memory_dryrun": res["peak_memory_per_device"],
              "max_memory_allocated": train_row["max_memory_allocated_bytes"],
              "peak_ratio_dryrun_over_card": (res["peak_memory_per_device"]
                                              / train_row["max_memory_allocated_bytes"]),
              "flops_counted": res["flops_per_device"], "bytes_counted": res["bytes_per_device"],
              "compute_s": r["compute_s"], "memory_s": r["memory_s"],
              "dominant": r["dominant"], "bound_s": r["bound_s"],
              "step_s_device": step_s, "step_ms_device_from": train_row["step_ms_device_from"],
              "roofline_fraction_reached": r["bound_s"] / step_s,
              "collective_bytes": res["collective_bytes_per_device"],
              "useful_flops_cell": res["useful_flops"],
              "train_model_flops": train_row["model_flops_per_step"],
              "useful_minus_train": diff,
              "useful_minus_train_parts": {
                  "embedding (useful counts the embedding table as a product; train does not)":
                      embedding,
                  "attention diagonal (train counts the S causal pairs on it; useful halves S^2)":
                      -diagonal,
                  "rest": diff - embedding + diagonal}},
          "phase_s": time.perf_counter() - t_start})


def phase_train_mla(full_cfg) -> dict:
    """deepseek-v2-236b (MLA) at full width, cut to MLA_TRAIN_LAYERS layers
    (its first_k_dense layer and one MoE layer), bf16, remat "full", on one
    fixed 4 x 1024 batch: first the loss and every gradient of
    impl="kernel" (K1 at head dims (192, 128), K2a/K2b behind it) against
    impl="naive" and an fp32 oracle on the same weights, the two reference
    paths sending each token to the experts the kernel path chose, and the
    kernel path twice, equal to the bit; then TRAIN_STEPS steps of
    make_train_step with the reference's large-model recipe, with the launch
    counts of the design. At most one set of bf16 gradients is on the card
    while the oracle runs: the others wait in host memory."""
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import apply_updates, tree_leaves, tree_map, tree_unflatten

    t_start = time.perf_counter()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(full_cfg, n_layers=MLA_TRAIN_LAYERS)
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)

    def reset():
        for c in counters:
            c.launches = 0

    def counts():
        return {c.__name__: c.launches for c in counters}

    model = LanguageModel(cfg, impl="kernel", remat="full")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    init_peak = torch.cuda.max_memory_allocated()
    naive = LanguageModel(cfg, impl="naive", remat="full")
    naive.params = model.params                      # the same weights, not a copy
    data = DataLoader(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    try:
        _, batch = next(data)
    finally:
        data.close()
    batch = to_device(batch, torch.device("cuda"))
    layers, routed_layers = cfg.n_layers, cfg.n_layers - cfg.first_k_dense
    per_step = {"flash_attention": 2 * layers,       # forward, and its recompute under remat
                "flash_attention_bwd_dq": layers, "flash_attention_bwd_dkv": layers}
    keys = list(param_paths(model.params))

    def loss_and_grads(m, replay=None):
        # under remat "full" each MoE layer routes twice a pass: its forward
        # and its recompute; ``replay`` sends both calls to the given experts
        with routes(replay) as calls:
            loss = m.loss(batch)
            grads = torch.autograd.grad(loss, tree_leaves(m.params))
        return float(loss.detach()), grads, calls

    def to_host(grads):
        return [g.to("cpu") for g in grads]

    # 1. loss and gradients three ways; the kernel path twice
    torch.cuda.reset_peak_memory_stats()
    reset()
    k_loss, k_grads, k_routes = loss_and_grads(model)
    if counts() != per_step:
        raise AssertionError(f"train_mla: launches in one loss+backward {counts()}, "
                             f"expected {per_step}")
    again_loss, again, again_routes = loss_and_grads(model)
    differ = [key for key, a, b in zip(keys, k_grads, again) if not torch.equal(a, b)]
    if (again_loss != k_loss or differ
            or not all(torch.equal(a, b) for a, b in zip(k_routes, again_routes))):
        raise AssertionError(f"train_mla: two kernel-path passes differ: loss {k_loss} vs "
                             f"{again_loss}, gradients of {differ}")
    del again
    for key, g in zip(keys, k_grads):
        if not bool(torch.isfinite(g).all()) or float(g.float().norm()) == 0.0:
            raise AssertionError(f"train_mla: gradient of {key} is zero or non-finite")
    reset()
    n_loss, n_grads, n_routes = loss_and_grads(naive, replay=k_routes)
    grad_rel = {"kernel_vs_naive": {key: rel_err(kg, ng)
                                    for key, kg, ng in zip(keys, k_grads, n_grads)},
                "kernel_vs_fp32": {}, "naive_vs_fp32": {}}
    k_host, n_host = to_host(k_grads), to_host(n_grads)
    del k_grads, n_grads
    grads_peak = torch.cuda.max_memory_allocated()
    # an fp32 oracle on the same (bf16-valued) weights, routed as the kernel path
    free_memory()
    exact = LanguageModel(cfg, impl="naive", remat="full")
    exact.load_params(tree_map(lambda p: p.detach().float(), model.params))
    e_loss, e_grads, _ = loss_and_grads(exact, replay=k_routes)
    del exact
    if any(counts().values()):
        raise AssertionError(f"train_mla: the naive paths launched a kernel: {counts()}")
    oracle_peak = torch.cuda.max_memory_allocated()
    for key, kg, ng, eg in zip(keys, k_host, n_host, e_grads):
        grad_rel["kernel_vs_fp32"][key] = rel_err(kg.to("cuda"), eg)
        grad_rel["naive_vs_fp32"][key] = rel_err(ng.to("cuda"), eg)
    del e_grads, k_host, n_host
    free_memory()
    worst = {k: max(v.values()) for k, v in grad_rel.items()}
    for key, err in grad_rel["kernel_vs_naive"].items():
        if err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"train_mla: gradient of {key}: kernel vs naive relative error "
                                 f"{err} > {TRAIN_GRAD_RTOL}")
        if grad_rel["kernel_vs_fp32"][key] > TRAIN_VS_ORACLE * grad_rel["naive_vs_fp32"][key]:
            raise AssertionError(f"train_mla: gradient of {key}: the kernel path is further from "
                                 f"the fp32 oracle than the naive path: "
                                 f"{grad_rel['kernel_vs_fp32'][key]} vs "
                                 f"{grad_rel['naive_vs_fp32'][key]}")
    loss_diff = abs(k_loss - n_loss)
    if loss_diff > TRAIN_LOSS_ATOL:
        raise AssertionError(f"train_mla: first-step loss kernel {k_loss} vs naive {n_loss}")

    # 2. the trainer's steps with the reference's large-model recipe
    # (TRAIN_LARGE_MSM): bf16 moments, no master weights, stochastic
    # rounding of the bf16 update, bf16 gradient compression
    opt_cfg = OptimConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS,
                          moment_dtype="bfloat16", master_weights=False,
                          stochastic_rounding=True)
    opt_state = init_opt_state(model.params, opt_cfg, grad_compression="bf16")
    step = make_train_step(model, opt_cfg, grad_compression="bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        rng = torch.Generator(device="cuda").manual_seed(i)   # as launch.train seeds a step
        t0 = time.perf_counter()
        _, opt_state, metrics = step(model.params, opt_state, batch, rng)
        losses.append(float(metrics["loss"]))        # waits for the step
        step_s.append(time.perf_counter() - t0)
    launches = counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    expected = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if launches != expected:
        raise AssertionError(f"train_mla: launch counts {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_mla: losses {losses}: not all finite, or the last is not "
                             "below the first")

    # 3. the device's own time for a step and for the optimizer: the sums of
    # a torch.profiler trace's kernel times, not a CUDA-graph replay. The
    # step draws its stochastic-rounding noise from a torch.Generator, and a
    # capture of it raises ("Attempt to increase offset for a CUDA generator
    # not in capture mode", torch 2.11 on the H100)
    rng = torch.Generator(device="cuda").manual_seed(TRAIN_STEPS)
    profile = profile_step(lambda: step(model.params, opt_state, batch, rng))
    device_step_ms = profile["device_ms"]
    grads = tree_unflatten(model.params, loss_and_grads(model)[1])
    optimizer_profile = profile_step(
        lambda: apply_updates(model.params, grads, opt_state, opt_cfg, rng=rng), top=5)
    del grads

    host_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3     # median, first step excluded
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = count_params(model.specs())
    # the parameters a token's products touch: all but the lookup table and
    # the routed experts it is not sent to (top_k of n_experts)
    routed = routed_layers * 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff
    n_active = (n_params - cfg.vocab_size * cfg.d_model
                - routed * (cfg.n_experts - cfg.top_k) // cfg.n_experts)
    d, dv = cfg.head_dim + cfg.rope_head_dim, cfg.v_head_dim
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn_flops = 6 * TRAIN_BATCH * cfg.n_heads * pairs * (d + dv) * layers
    model_flops = 6 * n_active * tokens + attn_flops
    row = {"phase": "train_mla", "arch": cfg.name, "n_layers": layers,
           "reduced": f"depth {layers} of {full_cfg.n_layers} layers ({cfg.first_k_dense} "
                      f"dense-FFN, {routed_layers} MoE); full width; microbatches 1 (the "
                      f"reference's 16 cannot split a batch of {TRAIN_BATCH})",
           "dtype": "bfloat16", "remat": "full",
           "recipe": {"source": "TRAIN_LARGE_MSM (src/repro/core/msm.py:82-90)",
                      "moment_dtype": opt_cfg.moment_dtype,
                      "master_weights": opt_cfg.master_weights,
                      "stochastic_rounding": opt_cfg.stochastic_rounding,
                      "grad_compression": "bf16", "microbatches": 1},
           "heads": {"H": cfg.n_heads, "KVH": cfg.n_kv_heads, "kv_lora": cfg.kv_lora_rank,
                     "q_lora": cfg.q_lora_rank, "k_head_dims": [d, dv]},
           "experts": {"E": cfg.n_experts, "top_k": cfg.top_k, "shared": cfg.n_shared_experts,
                       "moe_d_ff": cfg.moe_d_ff},
           "n_params": n_params, "n_active_params": n_active,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
           "losses": losses,
           "first_step_loss": {"kernel": k_loss, "naive": n_loss, "fp32": e_loss,
                               "abs_diff": loss_diff},
           "kernel_runs_bit_identical": True,
           "naive_routes": "the kernel path's, replayed (naive and fp32 oracle)",
           "routing_agreement_naive_own_picks": routing_agreement(n_routes, k_routes,
                                                                  routed_layers),
           "grad_rel_err_max": worst, "grad_rel_err": grad_rel,
           "launches_per_step": per_step, "launches": launches,
           "step_ms_host": [x * 1e3 for x in step_s], "step_ms_host_median": host_ms,
           "step_ms_device": device_step_ms,
           "step_ms_device_from": "torch.profiler kernel-time sum of one step",
           "device_idle_share": 1 - device_step_ms / host_ms,
           "tokens_per_s": tokens / (host_ms / 1e3),
           "model_flops_per_step": model_flops,
           "mfu_host": model_flops / (host_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "mfu_device": model_flops / (device_step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "init_max_memory_allocated_bytes": init_peak,
           "grads_max_memory_allocated_bytes": grads_peak,
           "oracle_max_memory_allocated_bytes": oracle_peak,
           "max_memory_allocated_bytes": peak_bytes,
           "optimizer_device_ms": optimizer_profile["device_ms"],
           "optimizer_profile": optimizer_profile, "profile": profile}
    del model, naive, opt_state, step
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    free_memory()
    return launches


def train_family(phase: str, cfg, batch: dict, per_step: dict, model_flops: float,
                 graphed: bool = False, **model_kw) -> tuple[dict, dict]:
    """``cfg`` at full size, bf16 parameters, fp32 master weights and moments
    (the reference's TRAIN_MSM), remat "full", on one fixed ``batch``: the
    loss and every gradient leaf of impl="kernel" against impl="naive" and an
    fp32 oracle on the same weights, the kernel path twice (equal to the
    bit), then TRAIN_STEPS steps of make_train_step at lr TRAIN_LR, each with
    the ``per_step`` launches of K1, K2a and K2b, the losses falling.
    ``model_kw`` goes to every model (the scan). The step's and the
    optimizer's device times are the profiler's kernel-time sums, or with
    ``graphed`` the replays of each captured in a CUDA graph (the replays
    train on; the step counter stays where it was); MFU counts
    ``model_flops`` a step. The profiled step runs any naive scan inside
    SCAN_RANGE, and the profile gives that range's device time.
    Returns the phase's row (not yet emitted) and the steps' launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
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

    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, impl="kernel", remat="full", **model_kw)
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    naive = LanguageModel(cfg, impl="naive", remat="full", **model_kw)
    naive.params = model.params                      # the same weights, not a copy
    keys = list(param_paths(model.params))

    def loss_and_grads(m):
        loss = m.loss(batch)
        return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(m.params))

    # 1. loss and gradients three ways; the kernel path twice
    reset()
    k_loss, k_grads = loss_and_grads(model)
    if counts() != per_step:
        raise AssertionError(f"{phase}: launches in one loss+backward {counts()}, "
                             f"expected {per_step}")
    again_loss, again = loss_and_grads(model)
    differ = [key for key, a, b in zip(keys, k_grads, again) if not torch.equal(a, b)]
    if again_loss != k_loss or differ:
        raise AssertionError(f"{phase}: two kernel-path passes differ: loss {k_loss} vs "
                             f"{again_loss}, gradients of {differ}")
    del again
    for key, g in zip(keys, k_grads):
        if not bool(torch.isfinite(g).all()) or float(g.float().norm()) == 0.0:
            raise AssertionError(f"{phase}: gradient of {key} is zero or non-finite")
    reset()
    n_loss, n_grads = loss_and_grads(naive)
    grad_rel = {"kernel_vs_naive": {key: rel_err(kg, ng)
                                    for key, kg, ng in zip(keys, k_grads, n_grads)},
                "kernel_vs_fp32": {}, "naive_vs_fp32": {}}
    # an fp32 oracle on the same (bf16-valued) weights: says which of the two
    # bf16 paths is off where they disagree
    exact = LanguageModel(cfg, impl="naive", remat="full", **model_kw)
    exact.load_params(tree_map(lambda p: p.detach().float(), model.params))
    e_loss, e_grads = loss_and_grads(exact)
    del exact
    if any(counts().values()):
        raise AssertionError(f"{phase}: the naive paths launched a kernel: {counts()}")
    oracle_peak = torch.cuda.max_memory_allocated()
    for key, kg, ng, eg in zip(keys, k_grads, n_grads, e_grads):
        grad_rel["kernel_vs_fp32"][key] = rel_err(kg, eg)
        grad_rel["naive_vs_fp32"][key] = rel_err(ng, eg)
    del k_grads, n_grads, e_grads
    free_memory()
    worst = {k: max(v.values()) for k, v in grad_rel.items()}
    for key, err in grad_rel["kernel_vs_naive"].items():
        if err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{phase}: gradient of {key}: kernel vs naive relative error "
                                 f"{err} > {TRAIN_GRAD_RTOL}")
        if grad_rel["kernel_vs_fp32"][key] > TRAIN_VS_ORACLE * grad_rel["naive_vs_fp32"][key]:
            raise AssertionError(f"{phase}: gradient of {key}: the kernel path is further from "
                                 f"the fp32 oracle than the naive path: "
                                 f"{grad_rel['kernel_vs_fp32'][key]} vs "
                                 f"{grad_rel['naive_vs_fp32'][key]}")
    loss_diff = abs(k_loss - n_loss)
    if loss_diff > TRAIN_LOSS_ATOL:
        raise AssertionError(f"{phase}: first-step loss kernel {k_loss} vs naive {n_loss}")

    # 2. the trainer's steps with the reference's recipe (TRAIN_MSM)
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
        raise AssertionError(f"{phase}: launch counts {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: losses {losses}: not all finite, or the last is not "
                             "below the first")

    # 3. the device's time for a step and for the optimizer
    def one_step():
        return step(model.params, opt_state, batch)

    with scan_named():
        profile = profile_step(one_step, ranges=(SCAN_RANGE,))
    grads = tree_unflatten(model.params, loss_and_grads(model)[1])

    def update():
        return apply_updates(model.params, grads, opt_state, opt_cfg)

    if graphed:
        device_step_ms = device_ms(one_step, launches=1, replays=3)
        optimizer_ms = device_ms(update, launches=1, replays=3)
        ms_from = "CUDA-graph replay of one step"
    else:
        device_step_ms = profile["device_ms"]
        optimizer_ms = profile_step(update, top=5)["device_ms"]
        ms_from = "torch.profiler kernel-time sum of one step"
    del grads
    held_bytes = {"params": sum(t.nbytes for t in tree_leaves(model.params)),
                  "opt_state": sum(t.nbytes for t in tree_leaves(opt_state)),
                  "batch": sum(t.nbytes for t in batch.values())}
    host_ms = sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3     # median, first step excluded
    tokens = int(batch["tokens"].numel())
    row = {"phase": phase, "arch": cfg.name, "dtype": "bfloat16", "impl": "kernel",
           **model_kw, "remat": "full",
           "recipe": {"source": "TRAIN_MSM (src/repro/core/msm.py)", "master_weights": True,
                      "moment_dtype": "float32"},
           "n_params": count_params(model.specs()), "lr": TRAIN_LR, "steps": TRAIN_STEPS,
           "losses": losses,
           "first_step_loss": {"kernel": k_loss, "naive": n_loss, "fp32": e_loss,
                               "abs_diff": loss_diff},
           "kernel_runs_bit_identical": True,
           "grad_rel_err_max": worst, "grad_rel_err": grad_rel,
           "launches_per_step": per_step, "launches": launches,
           "step_ms_host": [x * 1e3 for x in step_s], "step_ms_host_median": host_ms,
           "step_ms_device": device_step_ms,
           "step_ms_device_from": ms_from,
           "device_idle_share": 1 - device_step_ms / host_ms,
           "tokens_per_s": tokens / (host_ms / 1e3),          # the decoder's, for whisper
           "model_flops_per_step": model_flops,
           "mfu_host": model_flops / (host_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "mfu_device": model_flops / (device_step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "oracle_max_memory_allocated_bytes": oracle_peak,
           "max_memory_allocated_bytes": peak_bytes,
           "optimizer_device_ms": optimizer_ms, "held_bytes": held_bytes,
           "profile": profile}
    del model, naive, opt_state, step
    free_memory()
    return row, launches


def attention_train_flops(b, h, d, sq, skv, causal) -> int:
    """K1's forward and K2's backward on one layer: QK^T and PV, three times
    over (the forward, and twice that in the backward)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    return 12 * b * h * d * pairs


def phase_train_audio(cfg) -> dict:
    """whisper-base at full size trained on one fixed batch of
    AUDIO_TRAIN_BATCH x (AUDIO_FRAMES seeded frames, AUDIO_MAX_LEN tokens):
    ``train_family``, K1 in the encoder, the decoder's self-attention and the
    cross-attention (each twice a step under remat "full"), K2a and K2b once
    each a layer and step."""
    t_start = time.perf_counter()
    free_memory()
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, d = AUDIO_TRAIN_BATCH, cfg.d_model
    tokens = torch.randint(0, cfg.vocab_size, (b, AUDIO_MAX_LEN), device="cuda", generator=gen)
    batch = {"frames": randn(gen, (b, AUDIO_FRAMES, d), torch.bfloat16), "tokens": tokens,
             "labels": torch.roll(tokens, -1, 1)}
    calls = cfg.n_encoder_layers + 2 * cfg.n_layers
    per_step = {"flash_attention": 2 * calls, "flash_attention_bwd_dq": calls,
                "flash_attention_bwd_dkv": calls}
    # the products a frame and a decoder token go through (fwd + bwd: 6 a
    # parameter), the cross-attention's keys and values taken over the frames
    layer = 4 * d * d + 3 * d * cfg.d_ff
    enc_tok, dec_tok = b * AUDIO_FRAMES, b * AUDIO_MAX_LEN
    matmul = (enc_tok * (cfg.n_encoder_layers * layer + cfg.n_layers * 2 * d * d)
              + dec_tok * (cfg.n_layers * (layer + 2 * d * d) + cfg.vocab_size * d))
    hd = dict(b=b, h=cfg.n_heads, d=cfg.head_dim)
    attn = (cfg.n_encoder_layers * attention_train_flops(**hd, sq=AUDIO_FRAMES, skv=AUDIO_FRAMES,
                                                         causal=False)
            + cfg.n_layers * (attention_train_flops(**hd, sq=AUDIO_MAX_LEN, skv=AUDIO_MAX_LEN,
                                                    causal=True)
                              + attention_train_flops(**hd, sq=AUDIO_MAX_LEN, skv=AUDIO_FRAMES,
                                                      causal=False)))
    row, launches = train_family("train_audio", cfg, batch, per_step, 6 * matmul + attn)
    row.update(batch=b, frames=AUDIO_FRAMES, decoder_tokens=AUDIO_MAX_LEN,
               n_layers={"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers},
               frames_per_s=enc_tok / (row["step_ms_host_median"] / 1e3),
               phase_s=time.perf_counter() - t_start)
    emit(row)
    return launches


def naive_scan_ms(cfg, b: int, s: int) -> dict:
    """Device ms of the naive chunked scan (``models.ssm.ssd_chunked`` at
    the model's chunk) on one Mamba-2 layer's training shape, timed alone:
    the forward, and the forward with its backward, on seeded inputs of the
    mixer's dtypes (x, B, C bf16; dt, A fp32), not its values. Under remat
    "full" a layer runs the forward once and forward + backward once a step.
    A cross-check of the share read from the step's own profile."""
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device="cuda").manual_seed(8)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = randn(gen, (b, s, h, p), torch.bfloat16).requires_grad_()
    dt = (torch.rand((b, s, h), generator=gen, device="cuda") * 0.1).requires_grad_()
    a = -torch.rand((h,), generator=gen, device="cuda").requires_grad_()
    b_, c_ = (randn(gen, (b, s, n), torch.bfloat16).requires_grad_() for _ in range(2))
    dy = randn(gen, (b, s, h, p), torch.bfloat16)
    calls = 3

    def fwd():
        with torch.no_grad():
            return ssd_chunked(x, dt, a, b_, c_, cfg.ssm_chunk)

    def fwd_bwd():
        y, _ = ssd_chunked(x, dt, a, b_, c_, cfg.ssm_chunk)
        return torch.autograd.grad(y, (x, dt, a, b_, c_), dy)

    # the profiler's kernel-time sums over ``calls`` calls: a CUDA-graph
    # capture of the backward on these leaf inputs raises ("operation would
    # make the legacy stream depend on a capturing blocking stream")
    fwd_bwd()
    out = {"shape": {"B": b, "S": s, "H": h, "P": p, "N": n, "chunk": cfg.ssm_chunk},
           "ms_from": f"torch.profiler kernel-time sum over {calls} calls, divided by {calls}"}
    for key, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        prof = profile_step(lambda: [fn() for _ in range(calls)], top=6)
        out[f"{key}_ms"] = prof["device_ms"] / calls
        out[f"{key}_profile"] = prof
    return out


def phase_train_hybrid(cfg) -> dict:
    """zamba2-1.2b at full size trained on one fixed TRAIN_BATCH x TRAIN_SEQ
    batch with impl="kernel" and scan="naive" (K5 has no backward; the
    reference trains through its jnp scan): ``train_family``, K1 twice, K2a
    and K2b once per shared-block call and step. The naive scan's share of
    the step's device time is read from the step's own profile (its range,
    forward, recompute and backward); ``naive_scan_ms`` on one layer's shape,
    times the layers, cross-checks it."""
    from repro_torch.data.pipeline import DataConfig, DataLoader
    from repro_torch.launch.train import to_device

    t_start = time.perf_counter()
    free_memory()
    data = DataLoader(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    try:
        _, batch = next(data)
    finally:
        data.close()
    batch = to_device(batch, torch.device("cuda"))
    calls = cfg.n_layers // cfg.attn_every
    per_step = {"flash_attention": 2 * calls, "flash_attention_bwd_dq": calls,
                "flash_attention_bwd_dkv": calls}
    d, tokens = cfg.d_model, TRAIN_BATCH * TRAIN_SEQ
    shared = 4 * d * cfg.n_heads * cfg.head_dim + 3 * d * cfg.d_ff
    mixer = d * (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) + cfg.d_inner * d
    matmul = cfg.n_layers * mixer + calls * shared + cfg.vocab_size * d   # tied head
    length = cfg.ssm_chunk
    chunks = -(-TRAIN_SEQ // length)
    scan = (TRAIN_BATCH * cfg.ssm_heads * chunks * 2 * length
            * (length * cfg.ssm_state + length * cfg.ssm_head_dim
               + 2 * cfg.ssm_state * cfg.ssm_head_dim))
    flops = (6 * matmul * tokens + 3 * scan * cfg.n_layers
             + calls * attention_train_flops(TRAIN_BATCH, cfg.n_heads, cfg.head_dim, TRAIN_SEQ,
                                             TRAIN_SEQ, True))
    row, launches = train_family("train_hybrid", cfg, batch, per_step, flops, scan="naive")
    in_step = row["profile"]["ranges"][SCAN_RANGE]
    if in_step["calls"] != 2 * cfg.n_layers or not in_step["backward_nodes"]:
        raise AssertionError(f"train_hybrid: the profiled step's naive-scan ranges {in_step}: "
                             f"expected {2 * cfg.n_layers} calls (forward and recompute) "
                             "and their backward nodes")
    alone = naive_scan_ms(cfg, TRAIN_BATCH, TRAIN_SEQ)
    alone_step_ms = cfg.n_layers * (alone["fwd_ms"] + alone["fwd_bwd_ms"])
    row.update(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, n_layers=cfg.n_layers,
               shared_block_calls=calls,
               naive_scan={**in_step, "from": f"the step's profile, range {SCAN_RANGE!r}",
                           "share_of_step_device_ms": in_step["ms"] / row["profile"]["device_ms"],
                           "alone": {**alone, "layers": cfg.n_layers, "per_step_ms": alone_step_ms,
                                     "share_of_step_device_ms":
                                         alone_step_ms / row["profile"]["device_ms"]}},
               phase_s=time.perf_counter() - t_start)
    emit(row)
    return launches


def flat_leaves(tree) -> dict:
    """A tree's leaves by their checkpoint name (``a/b``), detached."""
    from repro_torch.checkpoint.ckpt import _flatten

    return {k: v.detach() for k, v in _flatten(tree).items()}


def same_bits(name: str, got: dict, want: dict) -> None:
    """Two flat trees with the same names, dtypes, shapes and values to the
    bit (``want`` may be on the host)."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: leaf names differ: {sorted(set(got) ^ set(want))}")
    for k, g in got.items():
        w = want[k].to(g.device)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: leaf {k} differs ({g.dtype} {tuple(g.shape)} vs "
                                 f"{w.dtype} {tuple(w.shape)})")


def phase_train_ckpt(full_cfg) -> dict:
    """tinyllama-1.1b at full width, cut to CKPT_LAYERS layers, through
    ``launch.train``'s runner (``make_runner``, as ``main`` builds it, on a
    name registered in ``configs.ARCHS`` for the phase: bf16 parameters,
    fp32 master weights and moments, remat "full", impl="kernel", 4 x 1024
    batches from the trainer's data pipeline). Run A: CKPT_STEPS steps, no checkpoint.
    Run B: the same with a checkpoint every CKPT_SAVE_EVERY steps, its
    segment failing once after step CKPT_FAIL_AFTER before that step's
    save; the runner restarts from step 2. B's resumed losses, final
    parameters and optimizer state must equal A's to the bit, and
    ``restore`` of step 4 B's in-memory state. Then the restored parameters
    are served (prefill step on 4 x 512, ``generate`` for 16 steps), the
    prefill logits equal to the bit to those of A's parameters and within
    LOGIT_ATOL/LOGIT_RTOL of the naive path's. The row reports the
    checkpoint's bytes, the seconds each save held the loop, the background
    writes' and the restore's seconds and GB/s, the doubled last save's
    cost, the disk's free bytes and peak device memory across the restart."""
    import shutil

    import repro_torch.configs as configs
    from repro_torch.checkpoint.ckpt import _unflatten, restore
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import train as ttrain
    from repro_torch.models import LanguageModel
    from repro_torch.models.base import count_params
    from repro_torch.serve.step import make_prefill_step

    t_start = time.perf_counter()
    free_memory()
    cuda = torch.device("cuda")
    cfg = dataclasses.replace(full_cfg, name=f"{full_cfg.name}-{CKPT_LAYERS}-layers",
                              n_layers=CKPT_LAYERS)
    train_counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    layers = cfg.n_layers
    per_step = {"flash_attention": 2 * layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    resumed_from = CKPT_FAIL_AFTER // CKPT_SAVE_EVERY * CKPT_SAVE_EVERY
    n_params = count_params(LanguageModel(cfg).specs())
    ckpt_bytes = n_params * (2 + 3 * 4) + 4          # bf16 params, fp32 master/mu/nu, step
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    free_before = shutil.disk_usage(CKPT_DIR).free
    need = 3 * ckpt_bytes + CKPT_DISK_MARGIN
    if free_before < need:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        raise AssertionError(f"train_ckpt: {free_before} bytes free at {CKPT_DIR}, {need} "
                             f"needed (3 checkpoints of {ckpt_bytes} bytes + "
                             f"{CKPT_DISK_MARGIN})")

    def run(ckpt_dir=None, fail_after=None):
        argv = ["--arch", cfg.name, "--steps", str(CKPT_STEPS), "--global-batch",
                str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--log-every", "1"]
        if ckpt_dir is not None:
            argv += ["--ckpt-dir", str(ckpt_dir), "--save-every", str(CKPT_SAVE_EVERY)]
        runner = ttrain.make_runner(ttrain.parse_args(argv), cuda)
        save, failed, held = runner.maybe_save, [], []

        def maybe_save(st, force=False):
            if st.step == fail_after and not force and not failed:
                failed.append(st.step)
                raise RuntimeError(f"injected failure after step {st.step}, before its save")
            t0 = time.perf_counter()
            save(st, force)
            if runner.ckpt is not None and len(runner.ckpt.saves) > len(held):
                held.append(time.perf_counter() - t0)     # the wait and the snapshot

        runner.maybe_save = maybe_save
        torch.cuda.synchronize()
        for c in train_counters:
            c.launches = 0
        t0 = time.perf_counter()
        st = runner.run(CKPT_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return st, runner, {c.__name__: c.launches for c in train_counters}, held, seconds

    configs.ARCHS[cfg.name] = cfg
    try:
        # run A: uninterrupted, its final state kept in host memory
        st_a, _, launches_a, _, seconds_a = run()
        losses_a = list(st_a.final_losses)
        params_a = {k: v.to("cpu", copy=True) for k, v in flat_leaves(st_a.params).items()}
        opt_a = {k: v.to("cpu", copy=True) for k, v in flat_leaves(st_a.opt_state).items()}
        del st_a
        free_memory()
        # run B: fails once, restarts from its checkpoint
        torch.cuda.reset_peak_memory_stats()
        st_b, runner_b, launches_b, held_b, seconds_b = run(CKPT_DIR, CKPT_FAIL_AFTER)
        peak_bytes = torch.cuda.max_memory_allocated()
        steps_b = CKPT_STEPS + CKPT_FAIL_AFTER - resumed_from
        for name, got, steps in (("run A", launches_a, CKPT_STEPS), ("run B", launches_b, steps_b)):
            want = {k: v * steps for k, v in per_step.items()}
            if got != want:
                raise AssertionError(f"train_ckpt: {name}'s launch counts {got}, expected {want}")
        if st_b.restarts != 1 or st_b.step != CKPT_STEPS:
            raise AssertionError(f"train_ckpt: run B ended at step {st_b.step} after "
                                 f"{st_b.restarts} restarts, expected {CKPT_STEPS} after 1")
        if st_b.final_losses != losses_a[resumed_from:]:
            raise AssertionError(f"train_ckpt: resumed losses {st_b.final_losses} differ from "
                                 f"the uninterrupted run's {losses_a[resumed_from:]}")
        if not all(math.isfinite(x) for x in losses_a):
            raise AssertionError(f"train_ckpt: losses {losses_a}")
        state_b = {"params": flat_leaves(st_b.params), "opt": flat_leaves(st_b.opt_state)}
        same_bits("train_ckpt: run B's parameters against run A's", state_b["params"], params_a)
        same_bits("train_ckpt: run B's optimizer state against run A's", state_b["opt"], opt_a)
        step_dir = CKPT_DIR / f"step_{CKPT_STEPS:09d}"
        disk_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
        kept = sorted(p.name for p in CKPT_DIR.iterdir() if p.name.startswith("step_"))
        # restore the last checkpoint onto the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, tree, extra = restore(str(CKPT_DIR), device=cuda)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != CKPT_STEPS or extra.get("step") != CKPT_STEPS:
            raise AssertionError(f"train_ckpt: restored step {step}, extra {extra}")
        same_bits("train_ckpt: the restored step-4 parameters against run B's",
                  flat_leaves(tree["params"]), state_b["params"])
        same_bits("train_ckpt: the restored step-4 optimizer state against run B's",
                  flat_leaves(tree["opt"]), state_b["opt"])
        del st_b, state_b, tree["opt"]
        free_memory()

        # serve once from the checkpoint. B's state equals A's and the restored
        # tree equals B's, to the bit, so the same drive from A's parameters
        # would repeat it; A's parameters in memory take the prefill step, and
        # the naive path on the restored weights holds the kernel path's logits
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), device=cuda,
                                generator=torch.Generator(device=cuda).manual_seed(2))
        batch = {"tokens": prompts}
        drive_steps = PROMPT_LEN + FAMILY_GEN_STEPS - 1
        want = {"prefill": {"flash_attention": layers, "flash_decode": 0},
                "generate": {"flash_attention": 0, "flash_decode": layers * drive_steps}}
        model = LanguageModel(cfg, impl="kernel").load_params(tree.pop("params"))
        served = drive(model, prompts, {"prefill": batch}, (flash_attention, flash_decode),
                       FAMILY_GEN_STEPS)
        if served["launches"] != want:
            raise AssertionError(f"train_ckpt: serving from the checkpoint: launch counts "
                                 f"{served['launches']}, expected {want}")
        logits = served["logits"]
        toks = served["tokens"]
        if (toks.shape != (BATCH, FAMILY_GEN_STEPS) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab_size):
            raise AssertionError(f"train_ckpt: bad tokens: shape {tuple(toks.shape)}")
        naive = LanguageModel(cfg, impl="naive")
        naive.params = model.params                  # the same weights, not a copy
        errs = {"engine_vs_prefill": logits_agree("train_ckpt: engine vs prefill step",
                                                  logits["engine"], logits["prefill"]),
                "prefill_kernel_vs_naive": logits_agree(
                    "train_ckpt: prefill step, kernel vs naive", logits["prefill"],
                    make_prefill_step(naive)(batch)[:, 0].float())}
        del served["engine"], model, naive
        free_memory()
        memory = LanguageModel(cfg, impl="kernel").load_params(
            _unflatten({k: v.to(cuda) for k, v in params_a.items()}))
        flash_attention.launches = 0
        memory_logits = make_prefill_step(memory)(batch)[:, 0].float()
        memory_launches = {"flash_attention": flash_attention.launches}
        if memory_launches["flash_attention"] != layers:
            raise AssertionError(f"train_ckpt: prefill from memory launched K1 "
                                 f"{memory_launches['flash_attention']} times, expected {layers}")
        if not torch.equal(memory_logits, logits["prefill"]):
            raise AssertionError("train_ckpt: prefill logits from the checkpoint differ from "
                                 "those from run A's parameters")
        del memory
        free_memory()
    finally:
        del configs.ARCHS[cfg.name]
        shutil.rmtree(CKPT_DIR, ignore_errors=True)

    saves = [dict(r, held_loop_s=held, write_gb_per_s=r["bytes"] / r["write_s"] / 1e9)
             for r, held in zip(runner_b.ckpt.saves, held_b)]
    want_saves = [resumed_from, CKPT_STEPS, CKPT_STEPS]     # the last one doubled
    if [r["step"] for r in saves] != want_saves or any(r["bytes"] != ckpt_bytes for r in saves):
        raise AssertionError(f"train_ckpt: saves {saves}: expected steps {want_saves} of "
                             f"{ckpt_bytes} bytes")
    launches = {k: launches_a[k] + launches_b[k] for k in per_step}
    launches["flash_decode"] = served["launches"]["generate"]["flash_decode"]
    launches["flash_attention"] += (served["launches"]["prefill"]["flash_attention"]
                                    + memory_launches["flash_attention"])
    row = {"phase": "train_ckpt", "arch": full_cfg.name, "n_layers": layers,
           "reduced": f"depth {layers} of {full_cfg.n_layers} layers; full width",
           "n_params": n_params,
           "dtype": "bfloat16", "impl": "kernel", "remat": "full",
           "recipe": {"source": "TRAIN_MSM (src/repro/core/msm.py)", "master_weights": True,
                      "moment_dtype": "float32"},
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": CKPT_STEPS,
           "save_every": CKPT_SAVE_EVERY, "fail_after_step": CKPT_FAIL_AFTER,
           "resumed_from_step": resumed_from, "losses": losses_a, "restarts": 1,
           "resumed_losses_equal": True, "state_bit_identical": True,
           "restored_bit_identical": True, "prefill_from_memory_bit_identical": True,
           "logit_max_abs_diff": errs,
           "launches_per_step": per_step,
           "launches": {"run_a": launches_a, "run_b": launches_b,
                        "serve_checkpoint": served["launches"],
                        "prefill_memory": memory_launches},
           "run_s": {"a": seconds_a, "b": seconds_b},
           "checkpoint_bytes": ckpt_bytes, "checkpoint_disk_bytes": disk_bytes,
           "kept": kept, "saves": saves,
           # what the second save of the last step adds: its snapshot and its write
           # (its hold on the loop also waits for the first one's write)
           "doubled_last_save_s": saves[2]["snapshot_s"] + saves[2]["write_s"],
           "restore_s": restore_s, "restore_gb_per_s": ckpt_bytes / restore_s / 1e9,
           "disk_free_bytes_before": free_before, "disk_needed_bytes": need,
           "max_memory_allocated_bytes_run_b": peak_bytes,
           "phase_s": time.perf_counter() - t_start}
    emit(row)
    return launches


def trainer_run(arch: str, steps: int, mesh_model, counters) -> tuple:
    """``launch.train``'s runner as its ``main`` builds it (TRAIN_MSM: bf16
    parameters, fp32 master weights and moments; remat "full",
    impl="kernel", TRAIN_BATCH x TRAIN_SEQ batches from the data pipeline),
    ``steps`` steps on the card, with ``--mesh-model mesh_model`` unless
    that is None; ``counters`` (kernel wrappers) set to 0 just before.
    Returns (the final RunState, the counters' launches, each step's host
    ms around a synchronize, make_host_mesh's seconds or None). The state's
    ``untimed_step_fn`` is the step function itself."""
    from repro_torch.launch import train as ttrain

    argv = ["--arch", arch, "--steps", str(steps), "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--log-every", "1"]
    argv += [] if mesh_model is None else ["--mesh-model", str(mesh_model)]
    runner = ttrain.make_runner(ttrain.parse_args(argv), torch.device("cuda"))
    build, make_mesh, step_ms, mesh_s = runner.build_state, runner.mesh_factory, [], []

    def mesh_factory():
        t0 = time.perf_counter()
        mesh = make_mesh()
        mesh_s.append(time.perf_counter() - t0)
        return mesh

    def build_state(mesh, restore_step):
        st = build(mesh, restore_step)
        step_fn = st.step_fn

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        st.step_fn, st.untimed_step_fn = timed, step_fn
        return st

    runner.mesh_factory, runner.build_state = mesh_factory, build_state
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    st = runner.run(steps)
    torch.cuda.synchronize()
    return (st, {c.__name__: c.launches for c in counters}, step_ms,
            mesh_s[0] if mesh_model else None)


def phase_train_mesh(cfg) -> dict:
    """tinyllama-1.1b at full size through ``launch.train``'s runner twice,
    as ``main`` builds it (TRAIN_MSM: bf16 parameters, fp32 master weights
    and moments; remat "full", impl="kernel", 4 x 1024 batches from the
    data pipeline), MESH_STEPS steps each: run A without a mesh, run B with
    ``--mesh-model 1``, through ``make_host_mesh()`` on the one card, a
    (1, 1) NCCL mesh with parameters, optimizer state and batches as
    DTensors in the reference's placements. B's losses, final parameters
    and optimizer state must equal A's to the bit, and B must launch K1,
    K2a and K2b 2 x 22, 22 and 22 times a step. Then B's final parameters
    take the loss of the first batch through the mesh at impl="kernel" and
    impl="naive" (within TRAIN_LOSS_ATOL). The row reports each run's host
    step times (around a synchronize), one more step of each under
    torch.profiler (its kernel-time sum), and the differences B - A."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.launch import train as ttrain

    t_start = time.perf_counter()
    free_memory()
    cuda = torch.device("cuda")
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    layers = cfg.n_layers
    per_step = {"flash_attention": 2 * layers, "flash_attention_bwd_dq": layers,
                "flash_attention_bwd_dkv": layers}
    first = _batch_at(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0), 0,
                      slice(0, TRAIN_BATCH))

    def counts():
        return {c.__name__: c.launches for c in counters}

    def run(mesh_model):
        st, launches, step_ms, mesh_s = trainer_run(cfg.name, MESH_STEPS, mesh_model, counters)
        batch = ttrain.to_device(first, cuda, st.mesh if mesh_model is not None else None)
        return st, launches, step_ms, batch, mesh_s

    def profile(st, batch):
        """One more step, of the run's final state, under torch.profiler."""
        return profile_step(lambda: st.untimed_step_fn(st.params, st.opt_state, batch, None))

    # run A: no mesh, its final state kept in host memory
    st_a, launches_a, ms_a, batch_a, _ = run(None)
    losses_a = list(st_a.final_losses)
    state_a = {k: v.to("cpu", copy=True)
               for k, v in flat_leaves({"params": st_a.params, "opt": st_a.opt_state}).items()}
    profile_a = profile(st_a, batch_a)
    del st_a, batch_a
    free_memory()
    # run B: the same steps through a (1, 1) mesh
    torch.cuda.reset_peak_memory_stats()
    st_b, launches_b, ms_b, batch_b, mesh_s = run(1)
    peak_bytes = torch.cuda.max_memory_allocated()
    mesh = st_b.mesh
    want = {k: v * MESH_STEPS for k, v in per_step.items()}
    if launches_b != want or launches_a != want:
        raise AssertionError(f"train_mesh: launch counts {launches_b} (mesh), {launches_a} "
                             f"(no mesh), expected {want} each")
    if st_b.final_losses != losses_a or not all(math.isfinite(x) for x in losses_a):
        raise AssertionError(f"train_mesh: losses through the mesh {st_b.final_losses}, "
                             f"without {losses_a}")
    leaves_b = flat_leaves({"params": st_b.params, "opt": st_b.opt_state})
    sharded = [k for k, v in leaves_b.items() if isinstance(v, DTensor)]
    if len(sharded) != len(leaves_b):
        raise AssertionError(f"train_mesh: leaves not placed on the mesh: "
                             f"{sorted(set(leaves_b) - set(sharded))}")
    same_bits("train_mesh: the mesh run's state against the run without a mesh",
              {k: v.full_tensor() for k, v in leaves_b.items()}, state_a)
    del state_a
    profile_b = profile(st_b, batch_b)
    # the loss of the first batch through the mesh, kernel path and naive path
    model = st_b.model
    losses = {}
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        for impl in ("kernel", "naive"):
            model.impl = impl
            losses[impl] = float(model.loss(batch_b))
            losses[f"{impl}_launches"] = counts()
            for c in counters:
                c.launches = 0
    model.impl = "kernel"
    if losses["naive_launches"] != {k: 0 for k in per_step} or (
            losses["kernel_launches"]["flash_attention"] != layers):
        raise AssertionError(f"train_mesh: loss launches {losses}")
    if abs(losses["kernel"] - losses["naive"]) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"train_mesh: loss through the mesh, kernel {losses['kernel']} "
                             f"vs naive {losses['naive']}")
    row = {"phase": "train_mesh", "arch": cfg.name, "n_layers": layers, "dtype": "bfloat16",
           "impl": "kernel", "remat": "full",
           "recipe": {"source": "TRAIN_MSM (src/repro/core/msm.py)", "master_weights": True,
                      "moment_dtype": "float32"},
           "mesh": {"shape": list(mesh.shape), "dim_names": list(mesh.mesh_dim_names),
                    "backend": dist.get_backend(), "make_host_mesh_s": mesh_s,
                    "dtensor_leaves": len(sharded),
                    "wq_placements": [str(p) for p in
                                      st_b.params["layers"]["attn"]["wq"].placements]},
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": MESH_STEPS,
           "losses": losses_a, "losses_bit_identical": True, "state_bit_identical": True,
           "loss_kernel_vs_naive": {"kernel": losses["kernel"], "naive": losses["naive"],
                                    "abs_diff": abs(losses["kernel"] - losses["naive"])},
           "launches_per_step": per_step, "launches": launches_b,
           "launches_no_mesh": launches_a,
           "no_mesh": {"step_ms_host": ms_a, "step_ms_host_median": statistics.median(ms_a[1:]),
                       "step_ms_device": profile_a["device_ms"], "profile": profile_a},
           "mesh_run": {"step_ms_host": ms_b, "step_ms_host_median": statistics.median(ms_b[1:]),
                        "step_ms_device": profile_b["device_ms"], "profile": profile_b},
           "step_ms_device_from": "torch.profiler kernel-time sum of one more step",
           "max_memory_allocated_bytes_mesh_run": peak_bytes}
    row["mesh_minus_no_mesh_ms"] = {
        "host_median": row["mesh_run"]["step_ms_host_median"]
        - row["no_mesh"]["step_ms_host_median"],
        "device": profile_b["device_ms"] - profile_a["device_ms"]}
    del st_b, model, batch_b, leaves_b
    dist.destroy_process_group()
    free_memory()
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    return launches_b


def phase_train_mesh_moe(configs) -> dict:
    """The moe family at full width, cut in depth (MESH_MOE_RUNS), with the
    reference's large-model recipe as train_mla takes it (TRAIN_LARGE_MSM:
    bf16 moments, no master weights, stochastic rounding, bf16 gradient
    compression), remat "full", impl="kernel", on the data pipeline's 4 x
    1024 batches: run A without a mesh, run B through ``make_host_mesh()``'s
    (1, 1) NCCL mesh in the placements ``launch.train.build`` gives
    (``param_shardings``, ``state_shardings``, ``make_train_step(
    grad_shardings=)``): the routed experts' grid over "model" and "data"
    (``models.moe``). B's losses, final parameters and optimizer state must
    equal A's to the bit, and each run must launch K1 2 x layers, K2a and
    K2b layers times a step. Each row reports both runs' host step times
    (around a synchronize) and one more step of each under torch.profiler
    (its kernel-time sum), their differences B - A, the share of (token,
    expert) assignments the capacity dropped, and peak memory. Returns the
    mesh runs' launches, summed over the models."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import LanguageModel, moe
    from repro_torch.models.base import count_params
    from repro_torch.sharding.partition import device_put, param_shardings
    from repro_torch.train import OptimConfig, init_opt_state, make_train_step
    from repro_torch.train.optim import state_shardings

    cuda = torch.device("cuda")
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    total = {c.__name__: 0 for c in counters}
    pack, packed = moe._pack, []

    def counted_pack(experts, cap, cfg):
        # the dropped count stays on the card until the run has ended
        grid_tok, cell_of = pack(experts, cap, cfg)
        packed.append(((cell_of == cfg.n_experts * cap).sum(), cell_of.numel()))
        return grid_tok, cell_of

    def counts():
        return {c.__name__: c.launches for c in counters}

    free_memory()
    mesh = make_host_mesh(model=1)
    moe._pack = counted_pack
    try:
        for arch, layers, steps in MESH_MOE_RUNS:
            t_start = time.perf_counter()
            full_cfg = configs.get(arch)
            cfg = dataclasses.replace(full_cfg, n_layers=layers)
            opt_cfg = OptimConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=steps,
                                  moment_dtype="bfloat16", master_weights=False,
                                  stochastic_rounding=True)
            per_step = {"flash_attention": 2 * layers, "flash_attention_bwd_dq": layers,
                        "flash_attention_bwd_dkv": layers}
            data = DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
            # the steps' batches, and one more for the profiled step
            batches = [_batch_at(data, i, slice(0, TRAIN_BATCH)) for i in range(steps + 1)]

            def run(on_mesh: bool, want=None) -> tuple[dict, dict | None]:
                free_memory()
                torch.cuda.reset_peak_memory_stats()
                model = LanguageModel(cfg, impl="kernel", remat="full")
                model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
                sh = param_shardings(model.axes(), model.specs(), mesh) if on_mesh else None
                opt_state = init_opt_state(model.params, opt_cfg, grad_compression="bf16")
                if on_mesh:
                    model.load_params(device_put(model.params, sh))
                    opt_state = device_put(opt_state, state_shardings(sh, opt_cfg, mesh))
                step = make_train_step(model, opt_cfg, grad_compression="bf16", grad_shardings=sh)
                at = mesh if on_mesh else None
                packed.clear()
                for c in counters:
                    c.launches = 0
                losses, step_ms = [], []
                for i in range(steps):
                    batch = to_device(batches[i], cuda, at)
                    rng = torch.Generator(device="cuda").manual_seed(i)  # as launch.train seeds it
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, opt_state, metrics = step(model.params, opt_state, batch, rng)
                    losses.append(float(metrics["loss"]))
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                launches = counts()
                dropped = int(sum(int(d) for d, _ in packed))
                assignments = sum(n for _, n in packed)
                peak = torch.cuda.max_memory_allocated()
                leaves = flat_leaves({"params": model.params, "opt": opt_state})
                if on_mesh:
                    plain = [k for k, v in leaves.items() if not isinstance(v, DTensor)]
                    if plain:
                        raise AssertionError(f"train_mesh_moe: {arch}: leaves not on the mesh: "
                                             f"{plain}")
                    # one leaf at a time, so that no second copy of the state
                    # is on the card
                    if list(leaves) != list(want):
                        raise AssertionError(f"train_mesh_moe: {arch}: leaf names differ")
                    for k, v in leaves.items():
                        same_bits(f"train_mesh_moe: {arch}: the mesh run's state against the "
                                  "run without a mesh", {k: v.full_tensor()}, {k: want[k]})
                    state = None
                else:
                    state = {k: v.to("cpu", copy=True) for k, v in leaves.items()}
                experts = model.params["layers"]["moe"]["w_gate"]
                placed = ([str(p) for p in experts.placements]
                          if isinstance(experts, DTensor) else None)
                del leaves
                batch = to_device(batches[steps], cuda, at)
                rng = torch.Generator(device="cuda").manual_seed(steps)
                profile = profile_step(lambda: step(model.params, opt_state, batch, rng))
                out = {"losses": losses, "launches": launches, "step_ms_host": step_ms,
                       "step_ms_host_median": statistics.median(step_ms[1:]),
                       "step_ms_device": profile["device_ms"], "profile": profile,
                       "dropped_assignments": [dropped, assignments],
                       "dropped_share": dropped / assignments,
                       "max_memory_allocated_bytes": peak, "w_gate_placements": placed,
                       "n_params": count_params(model.specs())}
                del model, opt_state, step, batch
                free_memory()
                return out, state

            a, state_a = run(False)
            b, _ = run(True, want=state_a)
            del state_a
            want = {k: v * steps for k, v in per_step.items()}
            if a["launches"] != want or b["launches"] != want:
                raise AssertionError(f"train_mesh_moe: {arch}: launch counts {b['launches']} "
                                     f"(mesh), {a['launches']} (no mesh), expected {want} each")
            if b["losses"] != a["losses"] or not all(math.isfinite(x) for x in a["losses"]):
                raise AssertionError(f"train_mesh_moe: {arch}: losses through the mesh "
                                     f"{b['losses']}, without {a['losses']}")
            if b["dropped_assignments"] != a["dropped_assignments"]:
                raise AssertionError(f"train_mesh_moe: {arch}: assignments dropped "
                                     f"{b['dropped_assignments']} (mesh), "
                                     f"{a['dropped_assignments']} (no mesh)")
            for k in total:
                total[k] += b["launches"][k]
            row = {"phase": "train_mesh_moe", "arch": cfg.name, "n_layers": layers,
                   "reduced": f"depth {layers} of {full_cfg.n_layers} layers"
                              + (f" ({cfg.first_k_dense} dense-FFN, "
                                 f"{layers - cfg.first_k_dense} MoE)" if cfg.first_k_dense
                                 else "") + "; full width",
                   "n_params": a["n_params"], "dtype": "bfloat16", "impl": "kernel",
                   "remat": "full",
                   "recipe": {"source": "TRAIN_LARGE_MSM (src/repro/core/msm.py:82-90)",
                              "moment_dtype": opt_cfg.moment_dtype,
                              "master_weights": opt_cfg.master_weights,
                              "stochastic_rounding": opt_cfg.stochastic_rounding,
                              "grad_compression": "bf16", "microbatches": 1},
                   "heads": {"H": cfg.n_heads, "KVH": cfg.n_kv_heads,
                             "D": (cfg.head_dim + cfg.rope_head_dim) if cfg.use_mla
                             else cfg.head_dim},
                   "experts": {"E": cfg.n_experts, "top_k": cfg.top_k,
                               "shared": cfg.n_shared_experts,
                               "capacity_factor": cfg.capacity_factor},
                   "mesh": {"shape": list(mesh.shape), "dim_names": list(mesh.mesh_dim_names),
                            "backend": dist.get_backend(),
                            "w_gate_placements": b["w_gate_placements"]},
                   "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": steps,
                   "losses": a["losses"], "losses_bit_identical": True,
                   "state_bit_identical": True,
                   "dropped_assignments": a["dropped_assignments"],
                   "dropped_share": a["dropped_share"],
                   "launches_per_step": per_step, "launches": b["launches"],
                   "launches_no_mesh": a["launches"],
                   "no_mesh": {k: a[k] for k in ("step_ms_host", "step_ms_host_median",
                                                 "step_ms_device", "profile",
                                                 "max_memory_allocated_bytes")},
                   "mesh_run": {k: b[k] for k in ("step_ms_host", "step_ms_host_median",
                                                  "step_ms_device", "profile",
                                                  "max_memory_allocated_bytes")},
                   "step_ms_device_from": "torch.profiler kernel-time sum of one more step",
                   "mesh_minus_no_mesh_ms": {
                       "host_median": b["step_ms_host_median"] - a["step_ms_host_median"],
                       "device": b["step_ms_device"] - a["step_ms_device"]},
                   "phase_s": time.perf_counter() - t_start}
            emit(row)
    finally:
        moe._pack = pack
    dist.destroy_process_group()
    free_memory()
    return total


def phase_train_mesh_ssm(configs) -> dict:
    """The ssm and hybrid families at full size through ``launch.train``'s
    runner (``trainer_run``: TRAIN_MSM, remat "full", impl="kernel" beside
    the naive scan, the pipeline's 4 x 1024 batches), MESH_SSM_RUNS: run A
    without a mesh, run B with ``--mesh-model 1``, a (1, 1) NCCL mesh from
    ``make_host_mesh()``, where every Mamba-2 mixer runs on the rank's rows
    with its weights gathered (``models.ssm``) and the shared block's
    attention on local shards. B's losses, final parameters and optimizer
    state must equal A's to the bit (A's held on the card meanwhile: its
    bytes are taken off B's peak), every leaf of B a DTensor, and each run
    must launch K1 2 x, K2a and K2b once per shared-block call a step
    (zamba2-1.2b: 6 calls; mamba2-1.3b: none) and K4 and K5 never.
    Each row reports both runs' host step times (around a synchronize), one
    more step of each under torch.profiler (its kernel-time sum), B - A,
    each run's first step beyond its median (B's extra over A's: DTensor's
    sharding propagation) and peak memory. Returns the mesh runs' launches,
    summed over the models."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.train import to_device
    from repro_torch.models.base import count_params
    from repro_torch.models.lm import LanguageModel

    cuda = torch.device("cuda")
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv, fused_ffn,
                ssd_scan)
    total = {c.__name__: 0 for c in counters}
    for arch, steps in MESH_SSM_RUNS:
        t_start = time.perf_counter()
        cfg = configs.get(arch)
        calls = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        per_step = {"flash_attention": 2 * calls, "flash_attention_bwd_dq": calls,
                    "flash_attention_bwd_dkv": calls, "fused_ffn": 0, "ssd_scan": 0}
        # the profiled step's batch: the one after the run's last
        extra = _batch_at(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0), steps,
                          slice(0, TRAIN_BATCH))

        def run(mesh_model, want=None) -> tuple[dict, dict | None]:
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            # A's final state, which B is held against, stays on the card
            held = sum(v.numel() * v.element_size() for v in (want or {}).values())
            st, launches, step_ms, mesh_s = trainer_run(arch, steps, mesh_model, counters)
            peak = torch.cuda.max_memory_allocated() - held
            leaves = flat_leaves({"params": st.params, "opt": st.opt_state})
            if mesh_model is None:
                state = {k: v.clone() for k, v in leaves.items()}
            else:
                plain = [k for k, v in leaves.items() if not isinstance(v, DTensor)]
                if plain:
                    raise AssertionError(f"train_mesh_ssm: {arch}: leaves not on the mesh: "
                                         f"{plain}")
                if list(leaves) != list(want):
                    raise AssertionError(f"train_mesh_ssm: {arch}: leaf names differ")
                for k, v in leaves.items():
                    same_bits(f"train_mesh_ssm: {arch}: the mesh run's state against the run "
                              "without a mesh", {k: v.full_tensor()}, {k: want[k]})
                state = None
            in_proj = st.params["layers"]["mixer"]["in_proj"]
            placed = ([str(p) for p in in_proj.placements]
                      if isinstance(in_proj, DTensor) else None)
            shape = list(st.mesh.shape) if mesh_model is not None else None
            del leaves
            batch = to_device(extra, cuda, st.mesh if mesh_model is not None else None)
            profile = profile_step(lambda: st.untimed_step_fn(st.params, st.opt_state, batch,
                                                              None))
            median = statistics.median(step_ms[1:])
            out = {"losses": list(st.final_losses), "launches": launches,
                   "step_ms_host": step_ms, "step_ms_host_median": median,
                   "first_step_extra_ms": step_ms[0] - median,
                   "step_ms_device": profile["device_ms"], "profile": profile,
                   "max_memory_allocated_bytes": peak, "held_state_bytes": held,
                   "make_host_mesh_s": mesh_s,
                   "mesh_shape": shape, "in_proj_placements": placed}
            del st, batch
            free_memory()
            return out, state

        a, state_a = run(None)
        b, _ = run(1, want=state_a)
        del state_a
        want = {k: v * steps for k, v in per_step.items()}
        if a["launches"] != want or b["launches"] != want:
            raise AssertionError(f"train_mesh_ssm: {arch}: launch counts {b['launches']} "
                                 f"(mesh), {a['launches']} (no mesh), expected {want} each")
        if b["losses"] != a["losses"] or not all(math.isfinite(x) for x in a["losses"]):
            raise AssertionError(f"train_mesh_ssm: {arch}: losses through the mesh "
                                 f"{b['losses']}, without {a['losses']}")
        for k in total:
            total[k] += b["launches"][k]
        keys = ("step_ms_host", "step_ms_host_median", "first_step_extra_ms", "step_ms_device",
                "profile", "max_memory_allocated_bytes", "held_state_bytes")
        row = {"phase": "train_mesh_ssm", "arch": arch, "family": cfg.family,
               "n_layers": cfg.n_layers, "reduced": "none: full width and depth",
               "shared_block_calls": calls,
               "n_params": count_params(LanguageModel(cfg).specs()), "dtype": "bfloat16",
               "impl": "kernel", "scan": "naive", "remat": "full",
               "recipe": {"source": "TRAIN_MSM (src/repro/core/msm.py)", "master_weights": True,
                          "moment_dtype": "float32"},
               "ssm": {"heads": cfg.ssm_heads, "head_dim": cfg.ssm_head_dim,
                       "state": cfg.ssm_state, "chunk": cfg.ssm_chunk},
               "mesh": {"shape": b["mesh_shape"], "dim_names": ["data", "model"],
                        "backend": dist.get_backend(), "make_host_mesh_s": b["make_host_mesh_s"],
                        "in_proj_placements": b["in_proj_placements"]},
               "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": steps,
               "losses": a["losses"], "losses_bit_identical": True, "state_bit_identical": True,
               "launches_per_step": per_step, "launches": b["launches"],
               "launches_no_mesh": a["launches"],
               "no_mesh": {k: a[k] for k in keys}, "mesh_run": {k: b[k] for k in keys},
               "step_ms_device_from": "torch.profiler kernel-time sum of one more step",
               "mesh_minus_no_mesh_ms": {
                   "host_median": b["step_ms_host_median"] - a["step_ms_host_median"],
                   "device": b["step_ms_device"] - a["step_ms_device"],
                   "first_step_extra": b["first_step_extra_ms"] - a["first_step_extra_ms"]},
               "phase_s": time.perf_counter() - t_start}
        emit(row)
    dist.destroy_process_group()
    free_memory()
    return total


def pipeline_case(mesh, device) -> dict:
    """The reference test's case through ``pipeline_apply`` on ``mesh`` (its
    "pipe" dim the stages) and through the sequential loop, fp32: the
    largest absolute differences of y and of the gradients of (y ** 2).sum()
    in w and x."""
    from repro_torch.distributed.pipeline import pipeline_apply, stage_params_sharding
    from repro_torch.sharding.partition import device_put

    m, mb, d = PIPE_CASE
    n = mesh.size(mesh.mesh_dim_names.index("pipe"))
    gen = torch.Generator(device=device).manual_seed(11)
    w = torch.randn(n, d, d, generator=gen, device=device) * 0.3
    x = torch.randn(m, mb, d, generator=gen, device=device)
    w_piped = device_put(w, stage_params_sharding(mesh)).requires_grad_()
    x_piped = x.clone().requires_grad_()
    y = pipeline_apply(lambda w_s, xb: torch.tanh(xb @ w_s), w_piped, x_piped, mesh=mesh)
    (y ** 2).sum().backward()
    y = y.detach()
    w_loop, x_loop = w.clone().requires_grad_(), x.clone().requires_grad_()
    y_loop = x_loop
    for s in range(n):
        y_loop = torch.tanh(y_loop @ w_loop[s])
    (y_loop ** 2).sum().backward()
    y_loop = y_loop.detach()
    return {"stages": n, "microbatches": m, "microbatch_shape": [mb, d], "dtype": "float32",
            "y_max_abs_err": float((y - y_loop).abs().max()),
            "w_grad_max_abs_err": float((w_piped.grad.full_tensor() - w_loop.grad).abs().max()),
            "x_grad_max_abs_err": float((x_piped.grad - x_loop.grad).abs().max())}


def pipeline_and_loop(cfg, mesh, layers, x, dout):
    """``cfg``'s dense blocks (the stacked ``layers``) as one stage of
    ``pipeline_apply`` on ``mesh``, and the same block applied microbatch by
    microbatch without the pipeline, on ``x`` (M, mb, S, d) with the output
    cotangent ``dout``. Returns two step functions; each runs the forward
    and the backward once and returns (y, x's gradient, the layers'
    gradients by ``flat_leaves`` name)."""
    from repro_torch.distributed.pipeline import pipeline_apply, stage_params_sharding
    from repro_torch.models import blocks
    from repro_torch.models.lm import _unbind_layers
    from repro_torch.sharding.partition import device_put
    from repro_torch.train.optim import tree_leaves, tree_map, tree_unflatten

    s = x.shape[2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(x.shape[1], s)

    def block_fn(stage, h):
        for p in _unbind_layers(stage, cfg.n_layers):
            h = blocks.dense_block(p, cfg, h, positions, impl="kernel")
        return h

    stacked = tree_map(lambda v: v.detach().unsqueeze(0), layers)
    piped = tree_map(lambda v: v.requires_grad_(),
                     device_put(stacked, tree_map(lambda _: stage_params_sharding(mesh),
                                                  stacked)))
    loop = tree_map(lambda v: v.detach().requires_grad_(), layers)

    def named(grads, like):
        return flat_leaves(tree_unflatten(like, grads))

    def piped_step():
        xp = x.detach().requires_grad_()
        y = pipeline_apply(block_fn, piped, xp, mesh=mesh)
        dx, *grads = torch.autograd.grad(y, [xp, *tree_leaves(piped)], dout)
        return y.detach(), dx, named([g.to_local()[0] for g in grads], piped)

    def loop_step():
        xl = x.detach().requires_grad_()
        y = torch.stack([block_fn(loop, xl[i]) for i in range(x.shape[0])])
        dx, *grads = torch.autograd.grad(y, [xl, *tree_leaves(loop)], dout)
        return y.detach(), dx, named(grads, loop)

    return piped_step, loop_step


def phase_pipeline(cfg) -> dict:
    """GPipe (``distributed.pipeline.pipeline_apply``) through a one-stage
    "pipe" mesh from ``make_compat_mesh((1,), ("pipe",))``: NCCL on the one
    card, S = 1, bubble 0. One card cannot run S > 1: NCCL's group has one
    rank and takes no send to one's own rank, so the schedule posts no
    point-to-point op here, and several stages have run only on gloo
    (tests/test_torch_pipeline.py). (a) The reference test's case, held to
    the sequential loop at its limits. (b) tinyllama-1.1b's 22 dense blocks
    at full width as the one stage (impl="kernel"), PIPE_MICROBATCHES
    microbatches of 1 x PIPE_SEQ seeded bf16 hidden states, forward and
    backward against a seeded cotangent, against the same block applied
    microbatch by microbatch: the output and x's gradient equal to the bit,
    each layer gradient equal to the bit where its sum over the microbatches
    runs in the loop's order, else within PIPE_GRAD_RTOL by relative norm;
    K1 2 x 22 (forward and the backward's recompute), K2a and K2b 22 a
    microbatch through the pipeline, K1, K2a and K2b 22 each in the loop;
    host ms (PIPE_REPEATS in turns) and the profiler's device ms of a step
    of each, and peak memory. Returns the pipelined run's launches."""
    import torch.distributed as dist

    from repro_torch.distributed.pipeline import bubble_fraction
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.models.lm import LanguageModel

    t_start = time.perf_counter()
    free_memory()
    cuda = torch.device("cuda")
    counters = (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv)
    t0 = time.perf_counter()
    mesh = make_compat_mesh((1,), ("pipe",))
    mesh_s = time.perf_counter() - t0
    case = pipeline_case(mesh, cuda)
    if not (case["y_max_abs_err"] <= PIPE_FWD_TOL and case["w_grad_max_abs_err"] <= PIPE_GRAD_TOL
            and case["x_grad_max_abs_err"] <= PIPE_GRAD_TOL):
        raise AssertionError(f"pipeline: the reference test's case against the loop: {case}")

    model = LanguageModel(cfg, impl="kernel")
    model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(12)
    shape = (PIPE_MICROBATCHES, 1, PIPE_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    dout = torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    piped_step, loop_step = pipeline_and_loop(cfg, mesh, model.params["layers"], x, dout)

    def counted(step):
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = step()
        torch.cuda.synchronize()
        return out, {c.__name__: c.launches for c in counters}, torch.cuda.max_memory_allocated()

    (y_p, dx_p, g_p), launches, peak_p = counted(piped_step)
    held = sum(t.numel() * t.element_size() for t in (y_p, dx_p, *g_p.values()))
    (y_l, dx_l, g_l), launches_loop, peak_l = counted(loop_step)
    layers, m = cfg.n_layers, PIPE_MICROBATCHES
    want = {"flash_attention": 2 * m * layers, "flash_attention_bwd_dq": m * layers,
            "flash_attention_bwd_dkv": m * layers}
    want_loop = {k: m * layers for k in want}
    if launches != want or launches_loop != want_loop:
        raise AssertionError(f"pipeline: launch counts {launches} (pipelined), "
                             f"{launches_loop} (loop), expected {want} and {want_loop}")
    if not (torch.isfinite(y_p).all() and torch.isfinite(dx_p).all()):
        raise AssertionError("pipeline: non-finite output or x gradient")
    same_bits("pipeline: output and x's gradient against the loop", {"y": y_p, "dx": dx_p},
              {"y": y_l, "dx": dx_l})
    if list(g_p) != list(g_l):
        raise AssertionError(f"pipeline: gradient names differ: {sorted(set(g_p) ^ set(g_l))}")
    grads = {}
    for k, g in g_p.items():
        equal = bool(torch.equal(g, g_l[k]))
        grads[k] = {"bit_identical": equal, "rel_err": 0.0 if equal else rel_err(g, g_l[k])}
        if not equal and not grads[k]["rel_err"] <= PIPE_GRAD_RTOL:
            raise AssertionError(f"pipeline: gradient {k} against the loop: {grads[k]}")
    del y_l, dx_l, g_l, y_p, dx_p, g_p

    host = {"pipelined": [], "loop": []}
    for _ in range(PIPE_REPEATS // 2):
        for name, step in (("pipelined", piped_step), ("loop", loop_step),
                           ("loop", loop_step), ("pipelined", piped_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
    profiles = {name: profile_step(step) for name, step in
                (("pipelined", piped_step), ("loop", loop_step))}
    row = {"phase": "pipeline", "mesh": {"shape": list(mesh.shape),
                                         "dim_names": list(mesh.mesh_dim_names),
                                         "backend": dist.get_backend(), "make_compat_mesh_s": mesh_s},
           "stages": 1, "bubble_fraction": bubble_fraction(1, m),
           "one_card": "S = 1: NCCL's one rank takes no send to itself; S > 1 runs on gloo only",
           "reference_case": {**case, "fwd_tol": PIPE_FWD_TOL, "grad_tol": PIPE_GRAD_TOL},
           "arch": cfg.name, "n_layers": layers, "dtype": "bfloat16", "impl": "kernel",
           "reduced": "none: full width and depth, the blocks only (no embedding, no head)",
           "microbatches": m, "microbatch_shape": [1, PIPE_SEQ, cfg.d_model],
           "output_bit_identical": True, "x_grad_bit_identical": True,
           "grads_bit_identical": sum(v["bit_identical"] for v in grads.values()),
           "grads": len(grads), "grad_rel_tol": PIPE_GRAD_RTOL,
           "grads_max_rel_err": max(v["rel_err"] for v in grads.values()),
           "grads_not_bit_identical": {k: v["rel_err"] for k, v in grads.items()
                                       if not v["bit_identical"]},
           "launches": launches, "launches_loop": launches_loop,
           "step_ms_host": host,
           "step_ms_host_median": {k: statistics.median(v) for k, v in host.items()},
           "step_ms_device": {k: p["device_ms"] for k, p in profiles.items()},
           "step_ms_device_from": "torch.profiler kernel-time sum of one more step",
           "profile": profiles,
           "max_memory_allocated_bytes": {"pipelined": peak_p, "loop": peak_l},
           "loop_peak_holds_pipelined_results_bytes": held}
    row["pipelined_minus_loop_ms"] = {
        "host_median": row["step_ms_host_median"]["pipelined"]
        - row["step_ms_host_median"]["loop"],
        "device": row["step_ms_device"]["pipelined"] - row["step_ms_device"]["loop"]}
    del model, piped_step, loop_step, x, dout
    dist.destroy_process_group()
    free_memory()
    row["phase_s"] = time.perf_counter() - t_start
    emit(row)
    return launches


def mesh_prefill(model, batch: dict, counters) -> dict:
    """The prefill step on ``batch``, called twice, each call on the host
    clock around a synchronize: the launches of the first (every counter's,
    and by route where a counter has them, reset just before it), its
    last-position logits, one more call under the profiler (the device's
    kernel-time sum), the peak memory of the three, the seconds of all."""
    from repro_torch.serve.step import make_prefill_step

    t_start = time.perf_counter()
    prefill = make_prefill_step(model)
    by_route = [c for c in counters if hasattr(c, "launches_by_route")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms = []
    for _ in range(2):
        for c in counters:
            c.launches = 0
        for c in by_route:
            c.launches_by_route = dict.fromkeys(c.launches_by_route, 0)
        t = time.perf_counter()
        logits = prefill(batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        if len(host_ms) == 1:
            first = logits[:, 0].float()
            launches = {c.__name__: c.launches for c in counters}
            routes_ = {c.__name__: dict(c.launches_by_route) for c in by_route}
    prof = profile_step(lambda: prefill(batch))
    return {"logits": first, "launches": launches, "by_route": routes_,
            "host_ms_first": host_ms[0], "host_ms_second": host_ms[1],
            "device_ms": prof["device_ms"], "profile_top": prof["top"][:6],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t_start}


def mesh_prefill_want(cfg) -> tuple[dict, dict]:
    """The prefill step's launches (and K4's and K5's by route) as the path
    designs them: K1 a layer (whisper-base's encoder, self- and
    cross-attention), K5 a Mamba-2 block on the mma route, K4 a shared-block
    call on the tiled route (T = BATCH x PROMPT_LEN)."""
    want = dict.fromkeys(("flash_attention", "ssd_scan", "fused_ffn", "flash_decode",
                          "flash_decode_partial"), 0)
    if cfg.family == "audio":
        want["flash_attention"] = cfg.n_encoder_layers + 2 * cfg.n_layers
    elif cfg.family == "hybrid":
        n_shared = cfg.n_layers // cfg.attn_every
        want.update(flash_attention=n_shared, ssd_scan=cfg.n_layers, fused_ffn=n_shared)
    else:
        want["flash_attention"] = cfg.n_layers
    by_route = {"fused_ffn": {"tiled": want["fused_ffn"], "rowtile": 0},
                "ssd_scan": {"mma": want["ssd_scan"], "fma": 0}}
    return want, by_route


def phase_serve_mesh(configs) -> dict:
    """SERVE_MESH_RUNS through ``launch.serve.ServingEngine``, kernel path,
    bf16, seeded weights: run A without a mesh, run B on the same weights
    through ``make_host_mesh()``'s (1, 1) NCCL mesh (parameters in
    ``param_shardings``' placements, the cache in ``cache_shardings``').
    B's tokens must equal A's; its logits (prefill and last step) within
    LOGIT_ATOL of A's, the largest difference reported (one rank runs the
    same kernels on the same rows: equal to the bit is expected); its K3
    launches (whole-cache and partial entries together, self and cross
    attention for whisper-base) and K4 launches equal to A's, all on the
    partial entry at batch 1 (the sequence over "data") and none there at
    batch 4; every cache leaf a DTensor in ``cache_shardings``' placements.
    whisper-base's cross caches hold the same seeded rows in both runs,
    written into each DTensor's local shard on the mesh
    (``layers.copy_into``). Where the run takes the prefill step
    (``mesh_prefill``), B's last-position logits must agree with A's within
    LOGIT_ATOL and its launches (K1, K5 and K4, by route too) equal A's and
    ``mesh_prefill_want``'s. Per run: host ms a decode step (each step
    timed around a synchronize; the median and the first), device ms of one
    more step (the profiler's kernel-time sum), peak memory; the prefill
    step's host ms (first and second call), device ms and peak."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partial
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import LanguageModel
    from repro_torch.models.layers import copy_into
    from repro_torch.sharding.partition import cache_shardings

    t_start = time.perf_counter()
    free_memory()
    counters = (flash_decode, flash_decode_partial, fused_ffn)
    prefill_counters = (flash_attention, ssd_scan, fused_ffn, flash_decode, flash_decode_partial)
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    mesh_s = time.perf_counter() - t0
    rows, totals = [], dict.fromkeys((c.__name__ for c in prefill_counters), 0)
    weights = {}      # one seeded init an arch, shared by its runs
    for arch, fused, batch, prompt_len, steps, with_prefill in SERVE_MESH_RUNS:
        t_run = time.perf_counter()
        cfg = configs.get(arch)
        audio = cfg.family == "audio"
        model = LanguageModel(cfg, impl="kernel", fused_ffn=fused)
        if arch not in weights:
            weights.clear()
            free_memory()
            model.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16)
            weights[arch] = model.params
        model.load_params(weights[arch])
        gen = torch.Generator(device="cuda").manual_seed(2)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), device="cuda",
                                generator=gen)
        max_len, enc_len = (AUDIO_MAX_LEN, AUDIO_FRAMES) if audio else (MAX_LEN, 0)
        cross = {k: randn(gen, (cfg.n_layers, batch, AUDIO_FRAMES, cfg.n_kv_heads,
                                cfg.head_dim), torch.bfloat16)
                 for k in ("cross_k", "cross_v")} if audio else {}
        pbatch = None
        if with_prefill:
            pb = batch if audio else BATCH
            pbatch = {"tokens": torch.randint(0, cfg.vocab_size,
                                              (pb, AUDIO_MAX_LEN if audio else PROMPT_LEN),
                                              device="cuda", generator=gen)}
            if audio:
                pbatch["frames"] = randn(gen, (pb, AUDIO_FRAMES, cfg.d_model), torch.bfloat16)
        drive_steps = prompt_len + steps - 1

        def run(on_mesh):
            m = model
            if on_mesh:       # the same weights in a model of its own, placed by the engine
                m = LanguageModel(cfg, impl="kernel", fused_ffn=fused).load_params(model.params)
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            engine = ServingEngine(m, batch, max_len, enc_len=enc_len,
                                   mesh=mesh if on_mesh else None)
            for k, v in cross.items():
                copy_into(engine.cache[k], v)
            decode, step_ms = engine.decode, []

            def timed(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = decode(*args)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                return out

            engine.decode = timed
            torch.cuda.synchronize()
            for c in counters:
                c.launches = 0
            toks = engine.generate(prompts, steps)
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
            engine.decode = decode
            prof = profile_step(lambda: engine.decode(engine.cache, prompts[:, :1], drive_steps))
            out = {"engine": engine, "tokens": toks, "launches": launches, "step_ms": step_ms,
                   "device_ms": prof["device_ms"], "profile": prof,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            if pbatch is not None:
                out["prefill"] = mesh_prefill(m, pbatch, prefill_counters)
            return out

        a = run(False)
        b = run(True)
        name = f"serve_mesh {arch} batch {batch}"
        if not torch.equal(a["tokens"], b["tokens"]):
            raise AssertionError(f"{name}: tokens through the mesh differ from those without")
        ea, eb = a["engine"], b["engine"]
        diffs = {part: logits_agree(f"{name}: {part} logits, mesh vs none",
                                    getattr(eb, part), getattr(ea, part))
                 for part in ("prefill_logits", "last_logits")}
        la, lb = a["launches"], b["launches"]
        calls = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                 else 2 * cfg.n_layers if audio else cfg.n_layers)
        k3_a = la["flash_decode"] + la["flash_decode_partial"]
        k3_b = lb["flash_decode"] + lb["flash_decode_partial"]
        on_partial = lb["flash_decode_partial"] if batch == 1 else lb["flash_decode"]
        if (k3_a != calls * drive_steps or k3_b != k3_a or on_partial != k3_b
                or la["fused_ffn"] != lb["fused_ffn"]
                or la["fused_ffn"] != (calls * drive_steps if fused else 0)):
            raise AssertionError(f"{name}: launches {lb} through the mesh, {la} without")
        want = cache_shardings(eb.cache, mesh, shard_seq=batch == 1)
        placed = {k: [str(p) for p in v.placements] for k, v in eb.cache.items()
                  if isinstance(v, DTensor) and tuple(v.placements) == want[k].placements}
        if len(placed) != len(eb.cache):
            raise AssertionError(f"{name}: cache leaves not in cache_shardings' placements")

        def times(r):
            return {"decode_ms_host_median": statistics.median(r["step_ms"][1:]),
                    "decode_ms_host_first": r["step_ms"][0],
                    "decode_ms_device": r["device_ms"], "peak_bytes": r["peak_bytes"],
                    "profile_top": r["profile"]["top"][:6]}

        row = {"arch": cfg.name, "n_layers": cfg.n_layers, "fused_ffn": fused,
               "batch": batch, "prompt_len": prompt_len, "gen_steps": steps,
               "max_len": max_len, "tokens_equal": True,
               "logit_max_abs_diff": diffs,
               "logits_bit_equal": all(torch.equal(getattr(ea, p), getattr(eb, p))
                                       for p in diffs),
               "launches": lb, "launches_no_mesh": la, "cache_placements": placed,
               "no_mesh": times(a), "mesh_run": times(b),
               "mesh_minus_no_mesh_ms": {
                   "host_median": times(b)["decode_ms_host_median"]
                   - times(a)["decode_ms_host_median"],
                   "device": b["device_ms"] - a["device_ms"]}}
        if audio:
            row.update(n_encoder_layers=cfg.n_encoder_layers, enc_len=enc_len,
                       cross_caches="the same seeded rows in both runs, written into each "
                                    "DTensor's local shard on the mesh")
        for c, n in lb.items():
            totals[c] += n
        if pbatch is not None:
            pa, pb_ = a["prefill"], b["prefill"]
            want_p, want_routes = mesh_prefill_want(cfg)
            if pa["launches"] != want_p or pb_["launches"] != want_p or (
                    pa["by_route"] != pb_["by_route"] or pa["by_route"] != want_routes):
                raise AssertionError(f"{name}: prefill step launches {pb_['launches']} "
                                     f"{pb_['by_route']} through the mesh, {pa['launches']} "
                                     f"{pa['by_route']} without, expected {want_p} {want_routes}")
            err = logits_agree(f"{name}: prefill step logits, mesh vs none", pb_["logits"],
                               pa["logits"])

            def ptimes(r):
                return {k: r[k] for k in ("host_ms_first", "host_ms_second", "device_ms",
                                          "peak_bytes", "seconds", "profile_top")}

            row["prefill_step"] = {
                "shape": {k: list(v.shape) for k, v in pbatch.items()},
                "launches": pb_["launches"], "launches_no_mesh": pa["launches"],
                "launches_by_route": pb_["by_route"], "logit_max_abs_diff": err,
                "logits_bit_equal": bool(torch.equal(pa["logits"], pb_["logits"])),
                "no_mesh": ptimes(pa), "mesh_run": ptimes(pb_),
                "mesh_minus_no_mesh_ms": {
                    "host_second": pb_["host_ms_second"] - pa["host_ms_second"],
                    "device": pb_["device_ms"] - pa["device_ms"]}}
            for c, n in pb_["launches"].items():
                totals[c] += n
        row["run_s"] = time.perf_counter() - t_run
        rows.append(row)
        del a, b, ea, eb, model
        free_memory()
    weights.clear()
    emit({"phase": "serve_mesh", "dtype": "bfloat16", "impl": "kernel",
          "mesh": {"shape": list(mesh.shape), "dim_names": list(mesh.mesh_dim_names),
                   "backend": dist.get_backend(), "make_host_mesh_s": mesh_s},
          "step_ms_device_from": "torch.profiler kernel-time sum of one more step",
          "runs": rows, "phase_s": time.perf_counter() - t_start})
    dist.destroy_process_group()
    free_memory()
    return totals


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
    props = torch.cuda.get_device_properties(0)
    emit({"phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.group(1) if nvcc else None,
          "triton": importlib.util.find_spec("triton") is not None,
          "python": sys.version.split()[0],
          "total_memory": props.total_memory, "sms": props.multi_processor_count,
          "spec": {"name": H100_SXM.name, "hbm_capacity": H100_SXM.hbm_capacity,
                   "sms": H100_SXM.num_sms, "bf16_tflops": H100_SXM.bf16_tflops,
                   "hbm_bandwidth": H100_SXM.hbm_bandwidth}})

    t0 = time.perf_counter()
    ptxas = build_with_report()
    lib = build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": Path(lib._name).name,
          "sources": [str(s.relative_to(ROOT)) for s in build.sources() + build.headers()],
          "ptxas": ptxas})
    # three head dims, each for the whole-cache entry (<D,0>) and the partial one (<D,1>)
    k3_bf16 = {n: r for n, r in ptxas.items() if n.startswith("flash_decode_mma")}
    if len(k3_bf16) != 6 or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                                for r in k3_bf16.values()):
        raise AssertionError(f"K3's bf16 instances must build without spills: {k3_bf16}")
    # K1 at MLA's head dims: both instances built, the bf16 one without
    # spills (Q's fragments read from shared memory each KV tile)
    k1_mla = {n: ptxas.get(n) for n in ("attn_fwd_mma<192,128>", "attn_fwd_fma<192,128>")}
    if None in k1_mla.values() or any(k1_mla["attn_fwd_mma<192,128>"].get(key, 1)
                                      for key in ("spill_stores", "spill_loads")):
        raise AssertionError(f"K1's (192, 128) instances must build, bf16 without spills: "
                             f"{k1_mla}")
    # K2a and K2b at MLA's head dims: all four instances built, the bf16 ones
    # without spills (the fp32 ones are off the training path: reported only)
    k2_mla = {n: ptxas.get(n) for n in ("attn_bwd_dq_mma<192,128,32>",
                                        "attn_bwd_dkv_mma<192,128,16>",
                                        "attn_bwd_dq_fma<192,128>", "attn_bwd_dkv_fma<192,128>")}
    if None in k2_mla.values() or any(k2_mla[n].get(key, 1) for n in list(k2_mla)[:2]
                                      for key in ("spill_stores", "spill_loads")):
        raise AssertionError(f"K2's (192, 128) instances must build, bf16 without spills: "
                             f"{k2_mla}")
    k5_mma = {n: r for n, r in ptxas.items() if n.startswith("ssd_chunk_scan_mma")}
    if len(k5_mma) != 6 or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                               for r in k5_mma.values()):
        raise AssertionError(f"K5's mma instances must build without spills: {k5_mma}")
    phase_check(ptxas)
    emit(phase_sweep(card))

    cfg, hybrid = configs.get(ARCH), configs.get(HYBRID_ARCH)
    vlm, moe, mla = configs.get(VLM_ARCH), configs.get(MOE_ARCH), configs.get(MLA_ARCH)
    for row in phase_occupancy(cfg, mla):
        emit(row)
    fa, fd, fd_more, fa_models = phase_checks(cfg, hybrid, configs.get(LONG_ARCH), vlm, moe, mla)
    fa_train, bwd, fa_more, bwd_more = phase_train_checks(cfg, configs.get(WIDE_ARCH), mla, moe)
    audio = configs.get(AUDIO_ARCH)
    fam = phase_family_checks(audio, hybrid)
    hyb = phase_hybrid_checks(hybrid, configs.get("mamba2-1.3b"))
    partial = phase_partial_checks(cfg, hybrid)
    launches = phase_serve(cfg)
    hybrid_launches, ffn_by_route, ssd_by_route = phase_serve_hybrid(hybrid)
    train_launches, train_row = phase_train(cfg)
    phase_dryrun(cfg, train_row)
    vlm_launches = phase_serve_vlm(vlm)
    moe_launches = phase_serve_routed("serve_moe", moe, MOE_LAYERS, MOE_FP32_LAYERS)
    mla_launches = phase_serve_routed("serve_mla", mla, MLA_LAYERS, MLA_FP32_LAYERS)
    train_mla_launches = phase_train_mla(mla)
    audio_launches = phase_serve_audio(audio)
    train_audio_launches = phase_train_audio(audio)
    train_hybrid_launches = phase_train_hybrid(hybrid)
    train_ckpt_launches = phase_train_ckpt(cfg)
    train_mesh_launches = phase_train_mesh(cfg)
    train_mesh_moe_launches = phase_train_mesh_moe(configs)
    train_mesh_ssm_launches = phase_train_mesh_ssm(configs)
    pipeline_launches = phase_pipeline(cfg)
    serve_mesh_launches = phase_serve_mesh(configs)

    def timing(row):
        return {"ms": row["kernel_ms"], "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}

    def bwd_shapes(part):
        return {key: {"shape": row["shape"], "plan": row["plan"], **timing(row[part]),
                      "library_ms": row["library_ms"], "library_kernels": row["library_kernels"]}
                for key, row in {**bwd_more, **fam["bwd"]}.items()}

    fa_shapes = {key: {"shape": row["shape"], "max_abs_err": row["max_abs_err"], **timing(row),
                       "library_ms": row["library_ms"]}
                 for key, row in {**fa_more, **fa_models, **fam["fa"]}.items()}

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
                "serve_vlm": vlm_launches.get(name, 0), "serve_moe": moe_launches.get(name, 0),
                "serve_mla": mla_launches.get(name, 0), "train": train_launches.get(name, 0),
                "train_mla": train_mla_launches.get(name, 0),
                "serve_audio": audio_launches.get(name, 0),
                "train_audio": train_audio_launches.get(name, 0),
                "train_hybrid": train_hybrid_launches.get(name, 0),
                "train_ckpt": train_ckpt_launches.get(name, 0),
                "train_mesh": train_mesh_launches.get(name, 0),
                "train_mesh_moe": train_mesh_moe_launches.get(name, 0),
                "train_mesh_ssm": train_mesh_ssm_launches.get(name, 0),
                "pipeline": pipeline_launches.get(name, 0),
                "serve_mesh": serve_mesh_launches.get(name, 0)}

    ffn_p, ffn_d, ffn_256 = hyb["ffn_prefill"], hyb["ffn_decode"], hyb["ffn_threshold"]
    ssd = hyb["ssd_prefill"]
    ssd_shapes = {key: {"shape": hyb[key]["shape"], "route": hyb[key]["route"],
                        "max_abs_err": max(hyb[key]["max_abs_err"],
                                           hyb[key]["state_max_abs_err"]),
                        **timing(hyb[key]), "library_ms": None,
                        "routes_ms": routes_ms(hyb[key])}
                  for key in ("ssd_n128", "ssd_long")}
    emit({"kernels": [
        summary("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:96",
                by_path("flash_attention"),
                fa, fa["max_abs_err"], timing(fa), fa["library_ms"],
                train_shape={"shape": fa_train["shape"], **timing(fa_train),
                             "library_ms": fa_train["library_ms"]},
                more_shapes=fa_shapes),
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
                fd["library_ms"], plan=fd["plan"], tensor_call_ms=fd["tensor_call_ms"],
                more_shapes={key: {"shape": row["shape"], "plan": row["plan"],
                                   "max_abs_err": row["max_abs_err"], **timing(row),
                                   "library_ms": row["library_ms"]}
                             for key, row in {**fd_more, **fam["fd"]}.items()}),
        summary("flash_decode_partial", "flash_decode.cu", "src/repro/kernels/flash_decode.py:75",
                by_path("flash_decode_partial"), partial["serve"],
                max(partial["serve"]["max_abs_err"], partial["serve"]["lse_max_abs_err"]),
                timing(partial["serve"]), partial["serve"]["library_ms"],
                entry="flash_decode_partial_fwd: K3's second entry (fp32 out + lse, kv_len 0 "
                      "allowed), for a sequence-sharded cache; the combine is "
                      "kernels.ops.combine_partials",
                plan=partial["serve"]["plan"],
                by_kv_len={key: {kv: {f: one[f] for f in ("max_abs_err", "lse_max_abs_err",
                                                          "kernel_ms", "call_ms", "plain_ms",
                                                          "library_ms", "bound_ms", "bound_by")
                                      if f in one} | {"splits": one["splits"]}
                                      for kv, one in row["by_kv_len"].items()}
                           for key, row in partial.items()}),
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
                timing(ssd), None, library_none_because=ssd["library_none_because"],
                kernel_route=ssd["route"], launches_by_route=ssd_by_route,
                routes_ms=routes_ms(ssd), more_shapes=ssd_shapes)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    sys.exit(code)
