"""Single-GPU training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20 --global-batch 4 --seq-len 1024

Config -> model -> train step (loss, gradients through the kernels, AdamW)
-> deterministic data pipeline. Runs on the card; ``--device cpu`` runs the
same path with the kernels' plain versions (for the smoke configs,
``--arch tinyllama-1.1b-smoke``). Without ``--remat`` the recipe is the
reference's training policy: per-block full remat, fp32 moments, fp32 master
weights.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.models import LanguageModel
from repro_torch.models.attention import IMPLS
from repro_torch.models.lm import REMATS
from repro_torch.train import OptimConfig, init_opt_state, make_train_step

DEFAULT_REMAT = "full"      # the reference's training policy (TRAIN_MSM)


def build(args, device):
    cfg = configs.get(args.arch)
    model = LanguageModel(cfg, impl=args.impl, remat=args.remat or DEFAULT_REMAT)
    model.init(torch.Generator(device=device).manual_seed(args.seed), device=device)
    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    opt_state = init_opt_state(model.params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    return model, cfg, opt_state, step_fn


def to_device(batch: dict, device: torch.device) -> dict:
    """NumPy batch -> tensors on ``device``; through pinned memory and an
    asynchronous copy when that is the card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None, choices=REMATS,
                    help=f"default: {DEFAULT_REMAT!r}")
    ap.add_argument("--impl", default="kernel", choices=IMPLS)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (an error without one); "
                         "'cpu' runs the kernels' plain versions")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model, cfg, opt_state, step_fn = build(args, device)
    data = DataLoader(DataConfig(cfg.vocab_size, args.seq_len, args.global_batch,
                                 seed=args.seed))
    losses = []
    try:
        for step, batch in data:
            if step >= args.steps:
                break
            t0 = time.perf_counter()
            batch = to_device(batch, device)
            rng = torch.Generator(device=device).manual_seed(step)
            _, opt_state, metrics = step_fn(model.params, opt_state, batch, rng)
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"dt {dt*1e3:7.1f}ms", flush=True)
    finally:
        data.close()
    print(f"done at step {len(losses)}; final loss {np.mean(losses[-10:]):.4f} on {device}")
    return losses


if __name__ == "__main__":
    main()
