#!/usr/bin/env python3
"""Times the flash-attention backward kernels (K2a dq, K2b dk/dv) of a parent
checkout and of this one on one card, in turns: parent, this, this, parent.

    python3 tools/bwd_ab.py PARENT     # PARENT: root of the other checkout

Each run is its own process: it imports that checkout's ``src/repro_torch``,
builds its kernels into that checkout's ``build/``, holds dq, dk and dv
against the checkout's plain versions at ``chip_smoke.BWD_TOL`` (and fails
past it), and times each kernel by ``chip_smoke.device_ms`` (CUDA-graph
replay) at the training shape (B=4, S=1024, H=32, KVH=4, D=64), at S=4096
(B=1, the same heads) and at D=128 (yi-6b's heads, B=2, S=1024), all bf16
and causal. One JSON object a run, then the card's name and power limit.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"train": dict(b=4, s=1024, h=32, kvh=4, d=64),
          "S=4096": dict(b=1, s=4096, h=32, kvh=4, d=64),
          "D=128": dict(b=2, s=1024, h=32, kvh=4, d=128)}


def worker(tree: str) -> None:
    src = os.path.join(tree, "src")
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import flash_attention

    assert fab.__file__.startswith(src), fab.__file__
    sys.path.insert(1, HERE)
    import chip_smoke as cs      # its helpers only; the checkout's kernels are imported above

    gen = torch.Generator(device="cuda").manual_seed(7)
    row, tol = {"tree": tree}, cs.BWD_TOL[torch.bfloat16]
    for key, sh in SHAPES.items():
        b, s, h, kvh, d = sh["b"], sh["s"], sh["h"], sh["kvh"], sh["d"]
        q, dout = (cs.randn(gen, (b, s, h, d), torch.bfloat16) for _ in range(2))
        k, v = (cs.randn(gen, (b, s, kvh, d), torch.bfloat16) for _ in range(2))
        out, lse = flash_attention(q, k, v, causal=True)
        delta = fab.attention_delta(out, dout)
        dq = lambda: fab.flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=True)
        dkv = lambda: fab.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=True)
        got = (dq(), *dkv())
        want = (fab.flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, causal=True),
                *fab.flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, causal=True))
        row[key] = {"dq_ms": cs.device_ms(dq), "dkv_ms": cs.device_ms(dkv), "tol": tol,
                    "max_abs_err": {n: cs.scaled_compare(f"{tree} {key} {n}", x, y, tol, tol, True)
                                    for n, x, y in zip(("dq", "dk", "dv"), got, want)}}
        del got, want
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="root of the parent's checkout")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    parent = os.path.abspath(args.parent)
    for tree in (parent, HERE, HERE, parent):
        subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, "--worker", tree],
                       check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
