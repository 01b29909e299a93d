"""Training entry point: the reference's elastic, checkpointing trainer.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20 --global-batch 4 --seq-len 1024 [--ckpt-dir DIR --save-every 50] \\
        [--mesh-model 1]

Config -> model -> train step (loss, gradients through the kernels, AdamW)
-> deterministic data pipeline -> step watchdog -> async checkpointing ->
elastic restart (``ft.ElasticRunner``), as the reference's
``launch/train.py`` wires them. Runs on the card; ``--device cpu`` runs the
same path with the kernels' plain versions (for the smoke configs,
``--arch tinyllama-1.1b-smoke``). Without ``--remat`` the recipe is the
reference's training policy: per-block full remat, fp32 moments, fp32 master
weights. Attention takes ``--impl``; a Mamba-2 layer's scan is always the
naive chunked scan (``scan="naive"``): K5 has no backward, and the reference
trains through its jnp scan. The data pipeline makes tokens only, so the
encoder-decoder (``whisper-base``), whose batch needs ``frames``, trains
through ``train.make_train_step`` on a batch its caller builds.

``--ckpt-dir`` has no default: without it nothing is written or read and a
failed step raises. With it, the trainer restores the latest checkpoint
there, saves every ``--save-every`` steps and at the end, and restarts a
failed segment from the last checkpoint. A resumed run equals an
uninterrupted one to the bit: the loader restarts at the restored step and
each step's generator is seeded by its step.

``--mesh-model M`` trains through a ``("data", "model")`` device mesh
(``launch.mesh.make_host_mesh``: data = the world size over M) in the
reference's placements: parameters and optimizer state as
``sharding.param_shardings`` and ``train.optim.state_shardings`` place
them, each rank reading the rows of its coordinate on "data". One process
starts its own one-rank group; several ranks are started by ``torchrun``
(or by a launcher that starts the group). A restore reshards onto the
mesh at hand, whatever mesh saved the checkpoint. Every family that trains
here takes it: the dense families (``dense``, ``vlm``), ``moe`` (GQA-MoE
and MLA-MoE, the routed experts over "model"), ``ssm`` and ``hybrid`` (the
Mamba-2 mixer on each rank's rows, its weights gathered for the compute);
the encoder-decoder (``audio``) has no batch here either way. Without
``--mesh-model`` nothing is distributed: one device, plain tensors.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.distributed.tensor import DTensor

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import restore
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.ft import ElasticRunner, RunState, StepWatchdog
from repro_torch.launch.mesh import make_host_mesh, mesh_device
from repro_torch.models import LanguageModel
from repro_torch.models.attention import IMPLS
from repro_torch.models.lm import REMATS
from repro_torch.sharding.partition import (NamedSharding, batch_spec, device_put,
                                            param_shardings)
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import state_shardings

DEFAULT_REMAT = "full"      # the reference's training policy (TRAIN_MSM)


def build(args, mesh, restore_step=None):
    """The model, its config, the optimizer state, the step function and
    the step to start from: a fresh init from ``args.seed``, or the
    parameters and optimizer state of ``restore_step`` under
    ``args.ckpt_dir``. ``mesh``: a device mesh, whose placements the
    parameters and state take, or the one ``torch.device`` to train on."""
    cfg = configs.get(args.arch)
    model = LanguageModel(cfg, impl=args.impl, remat=args.remat or DEFAULT_REMAT, scan="naive")
    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    sharded = not isinstance(mesh, torch.device)
    device = mesh_device(mesh) if sharded else mesh
    shardings = param_shardings(model.axes(), model.specs(), mesh) if sharded else None
    if restore_step is not None:
        placed = ({"params": shardings, "opt": state_shardings(shardings, opt_cfg, mesh)}
                  if sharded else None)
        _, tree, extra = restore(args.ckpt_dir, restore_step, device=device, shardings=placed)
        model.load_params(tree["params"])
        opt_state = tree["opt"]      # step, mu, nu[, master]: the keys init_opt_state makes
        start = int(extra.get("step", restore_step))
        print(f"[train] restored step {start} from {args.ckpt_dir}")
    else:
        model.init(torch.Generator(device=device).manual_seed(args.seed), device=device)
        if sharded:
            model.load_params(device_put(model.params, shardings))
        opt_state = init_opt_state(model.params, opt_cfg)
        if sharded:
            opt_state = device_put(opt_state, state_shardings(shardings, opt_cfg, mesh))
        start = 0
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              grad_shardings=shardings)
    return model, cfg, opt_state, step_fn, start


def to_device(batch: dict, device: torch.device, mesh=None) -> dict:
    """NumPy batch -> tensors on ``device``; through pinned memory and an
    asynchronous copy when that is the card. With a ``mesh`` the arrays are
    this rank's rows of the global batch, and come back as ``DTensor``s
    placed by ``sharding.batch_spec``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
        if mesh is not None:
            out[k] = DTensor.from_local(out[k], mesh,
                                        NamedSharding(mesh, batch_spec(mesh)).placements,
                                        run_check=False)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b-smoke",
                    help="a name of configs.ARCHS, with '-smoke' for its CPU-sized variant")
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: restore its latest step, save into it, and "
                         "restart a failed segment from it (default: none)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="train through a (data, model) device mesh with this many ranks on "
                         "'model' (default: no mesh, one device)")
    return ap.parse_args(argv)


def make_runner(args: argparse.Namespace, device: torch.device) -> ElasticRunner:
    """The elastic runner ``main`` runs: ``runner.run(args.steps)`` returns
    the final ``RunState``, with ``final_losses`` (the last segment's)."""
    if configs.get(args.arch).family == "audio":
        raise SystemExit(f"{args.arch}: the data pipeline makes no 'frames' for the encoder, "
                         "as the reference's makes none; train it through "
                         "train.make_train_step on a batch that holds them")

    sharded = args.mesh_model is not None

    def mesh_factory():
        return make_host_mesh(model=args.mesh_model, device=device) if sharded else device

    def build_state(mesh, restore_step):
        model, cfg, opt_state, step_fn, start = build(args, mesh, restore_step)
        st = RunState(params=model.params, opt_state=opt_state, step=start, mesh=mesh)
        st.model, st.cfg, st.step_fn = model, cfg, step_fn
        return st

    def train_segment(runner: ElasticRunner, st: RunState, max_steps: int):
        mesh = st.mesh if sharded else None
        # a rank reads the rows of its coordinate on "data"
        rows = ({"process_index": mesh.get_local_rank("data"),
                 "process_count": mesh.size(mesh.mesh_dim_names.index("data"))}
                if sharded else {})
        data = DataLoader(DataConfig(st.cfg.vocab_size, args.seq_len, args.global_batch,
                                     seed=args.seed), start_step=st.step, **rows)
        losses = []
        try:
            with StepWatchdog(deadline_s=300.0) as wd:
                for step, batch in data:
                    if step >= max_steps:
                        break
                    wd.check()
                    wd.step_started()
                    batch = to_device(batch, device, mesh)
                    rng = torch.Generator(device=device).manual_seed(step)
                    _, st.opt_state, metrics = st.step_fn(st.params, st.opt_state, batch, rng)
                    loss = float(metrics["loss"])           # waits for the step
                    dt = wd.step_finished()
                    st.step = step + 1
                    runner.maybe_save(st)
                    losses.append(loss)
                    if step % args.log_every == 0:
                        print(f"step {step:5d} loss {loss:8.4f} "
                              f"gnorm {float(metrics['grad_norm']):7.3f} "
                              f"dt {dt*1e3:7.1f}ms", flush=True)
        finally:
            data.close()
        runner.maybe_save(st, force=True)
        st.final_losses = losses
        return st

    return ElasticRunner(args.ckpt_dir, mesh_factory, build_state, train_segment,
                         save_every=args.save_every)


def main(argv=None) -> RunState:
    args = parse_args(argv)
    device = resolve_device(args.device)
    st = make_runner(args, device).run(args.steps)
    losses = st.final_losses          # none where a restored run was already at --steps
    tail = f"final loss {np.mean(losses[-10:]):.4f}" if losses else "no step left to run"
    print(f"done at step {st.step}; {tail} on {device}")
    return st


if __name__ == "__main__":
    main()
