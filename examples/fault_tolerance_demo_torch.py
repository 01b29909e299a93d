"""Fault-tolerance demo: train with injected failures and watch the elastic
runner recover from atomic checkpoints, through the PyTorch port
(``fault_tolerance_demo.py`` with ``repro_torch`` in place of ``repro``).

    PYTHONPATH=src python examples/fault_tolerance_demo_torch.py                # on the card
    PYTHONPATH=src python examples/fault_tolerance_demo_torch.py --device cpu

Injects a simulated node failure at step 12; the ElasticRunner restarts the
segment, restores the step-10 checkpoint, and completes to step 25. The
watchdog/straggler machinery is live throughout. Each segment's state is
built on the device of the mesh ``make_host_mesh`` gives (one rank: a
one-process group of its own, NCCL on the card, gloo on the CPU).
``--device``: without it the card, and the demo fails where there is none.
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import restore
from repro_torch.ft import ElasticRunner, RunState, StepWatchdog
from repro_torch.launch.mesh import make_host_mesh, mesh_device
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step

STEPS, FAIL_AT, SAVE_EVERY = 25, 12, 5
crashes = {"n": 0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA device)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ft_demo_")
    cfg = configs.get("tinyllama-1.1b").smoke()
    model = LanguageModel(cfg)
    opt_cfg = OptimConfig(lr=1e-3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(1))
    step_fn = make_train_step(model, opt_cfg)

    def build_state(mesh, restore_step):
        dev = mesh_device(mesh)
        if restore_step is not None:
            _, tree, extra = restore(ckpt_dir, device=dev)
            model.load_params(tree["params"])
            print(f"[demo] restored checkpoint at step {extra['step']}")
            return RunState(params=model.params, opt_state=tree["opt"],
                            step=int(extra["step"]))
        model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        return RunState(params=model.params,
                        opt_state=init_opt_state(model.params, opt_cfg), step=0)

    def segment(runner, st, max_steps):
        dev = mesh_device(st.mesh)
        batch = {"tokens": tokens.to(dev), "labels": tokens.to(dev)}
        with StepWatchdog(deadline_s=120) as wd:
            while st.step < max_steps:
                wd.step_started()
                _, st.opt_state, m = step_fn(
                    st.params, st.opt_state, batch,
                    torch.Generator(device=dev).manual_seed(st.step))
                loss = float(m["loss"])          # waits for the step
                wd.step_finished()
                st.step += 1
                runner.maybe_save(st)
                print(f"step {st.step:3d} loss {loss:7.4f}")
                if st.step == FAIL_AT and crashes["n"] == 0:
                    crashes["n"] += 1
                    runner.ckpt.wait()
                    raise RuntimeError("simulated node failure (ICI timeout)")
        runner.maybe_save(st, force=True)
        runner.ckpt.wait()
        return st

    runner = ElasticRunner(ckpt_dir, lambda: make_host_mesh(device=device),
                           build_state, segment, save_every=SAVE_EVERY)
    st = runner.run(STEPS)
    print(f"[demo] completed at step {st.step} after "
          f"{crashes['n']} injected failure(s)")
    assert st.step == STEPS
    return st


if __name__ == "__main__":
    main()
