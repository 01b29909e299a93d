"""Quickstart: train a ~100M-param model for a few hundred steps, through
the PyTorch port (``quickstart.py`` with ``repro_torch`` in place of
``repro``).

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 300]          # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --smoke --steps 5

Uses the full public API: config registry -> LanguageModel -> train step ->
deterministic data pipeline -> watchdog -> async checkpoints
(``repro_torch.launch.train.main``). The model is whisper-base's
decoder-family cousin at ~100M params, registered in
``repro_torch.configs.ARCHS`` on the fly. ``--device`` is where it trains:
without it the card, and the example fails where there is none.
``--smoke`` trains the config's CPU-sized variant
(``quickstart-100m-smoke``), for a quick run on the CPU.
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import repro_torch.configs as configs
from repro_torch.launch.train import main as train_main


def build_100m():
    """A ~100M dense config registered on the fly."""
    base = configs.get("tinyllama-1.1b")
    cfg = dataclasses.replace(
        base, name="quickstart-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=8192)
    configs.ARCHS[cfg.name] = cfg
    print(f"quickstart model: {cfg.n_params()/1e6:.1f}M params")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="build/quickstart_ckpt")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA device)")
    ap.add_argument("--smoke", action="store_true",
                    help="train the config's CPU-sized variant")
    args = ap.parse_args(argv)
    cfg = build_100m()
    argv = ["--arch", cfg.name + ("-smoke" if args.smoke else ""),
            "--steps", str(args.steps), "--global-batch", "8", "--seq-len", "256",
            "--ckpt-dir", args.ckpt_dir, "--save-every", "100", "--log-every", "10"]
    if args.device is not None:
        argv += ["--device", args.device]
    return train_main(argv)


if __name__ == "__main__":
    main()
