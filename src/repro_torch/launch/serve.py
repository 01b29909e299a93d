"""Batched serving entry point: prefill a batch of prompts, then decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 4 --prompt-len 512 --gen 32 --max-len 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --fused-ffn \
        --batch 4 --prompt-len 512 --gen 16 --max-len 1024

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b-smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b --mesh-model 1

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --mesh-model 1

Runs on the card; ``--device cpu`` runs the same path with the kernels' plain
versions (for the smoke configs, ``--arch tinyllama-1.1b-smoke`` or
``--arch zamba2-1.2b-smoke``). ``--fused-ffn`` sends every SwiGLU MLP through
the fused kernel (K4). The engine's cache is whatever the model's
``init_cache`` returns: KV for attention layers, conv and SSM state for
Mamba-2 layers, the latent ``ckv`` and rope key ``krope`` for MLA layers
(``deepseek-v2-236b``), and for the encoder-decoder (``whisper-base``) also
the cross caches of the engine's ``enc_len`` rows (64), left as zeros, as the
reference's engine leaves them.

``--mesh-model M`` serves through a ``("data", "model")`` device mesh
(``launch.mesh.make_host_mesh``: data = the world size over M), as the
reference's ``main`` serves through ``make_host_mesh()``: the parameters in
``param_shardings``' placements with FSDP (the reference's ``serve_fsdp``
default), the cache in ``cache_shardings``' (the sequence over "data" at
batch 1, as ``launch/specs`` shards a batch-1 cell's), every rank drawing
the same tokens. One process starts its own one-rank group (NCCL on the
card, gloo with ``--device cpu``); several ranks are started by
``torchrun``. Every family serves so, the encoder-decoder with its cross
caches placed as the self caches are (zeros, as the reference's engine
leaves them). Without ``--mesh-model`` nothing is distributed: one device,
plain tensors.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LanguageModel
from repro_torch.models.attention import IMPLS
from repro_torch.serve.step import make_decode_step
from repro_torch.sharding.partition import cache_shardings, device_put, param_shardings

class ServingEngine:
    """Minimal batched engine over the decode step. The cache (KV, MLA's
    latent, or conv and SSM state) lives on the model's device, in the model's dtype except the
    fp32 SSM state, and is updated in place. ``enc_len`` sizes the
    encoder-decoder's cross caches, as in the reference, which never fills
    them (other families ignore it).

    With a device ``mesh`` the engine places the model's parameters on it
    (``param_shardings``, FSDP) and its cache (``cache_shardings``; the
    sequence over "data" at batch 1; the encoder-decoder's cross caches
    too), both ``DTensor``s; the prompts are the same on every rank, and so
    are the tokens it returns."""

    def __init__(self, model: LanguageModel, batch: int, max_len: int,
                 sample: str = "greedy", temperature: float = 1.0, top_k: int = 0,
                 generator: torch.Generator | None = None, enc_len: int = 64, mesh=None):
        self.model = model
        self.batch = batch
        self.max_len = max_len
        self.mesh = mesh
        cache = model.init_cache(batch, max_len, enc_len=enc_len)
        if mesh is not None:
            model.load_params(device_put(model.params, param_shardings(
                model.axes(), model.specs(), mesh, fsdp=True)))
            cache = device_put(cache, cache_shardings(cache, mesh, shard_seq=batch == 1))
        self.cache = cache
        self.decode = make_decode_step(model, sample, temperature, top_k)
        self.generator = generator
        self.lengths = np.zeros(batch, np.int32)
        self.prefill_logits = None      # fp32 (B,V) logits at the last prompt position
        self.last_logits = None         # fp32 (B,V) logits of the last token drawn

    def _tokens(self, prompts) -> torch.Tensor:
        prompts = torch.as_tensor(prompts).to(self.model.device)
        if prompts.dim() != 2 or prompts.shape[0] != self.batch:
            raise ValueError(f"prompts must be ({self.batch}, prompt_len), "
                             f"got {tuple(prompts.shape)}")
        return prompts

    def prefill(self, prompts):
        """Teacher-forced prefill via the decode step (token at a time —
        simple and exact). Returns the first generated token, (B,1). The
        decode step embeds token ids only, so a ``vlm``'s ``patch_embeds``
        never reach the engine, as in the reference; they reach the model
        through ``serve.step.make_prefill_step``."""
        prompts = self._tokens(prompts)
        plen = prompts.shape[1]
        if not 1 <= plen <= self.max_len:
            raise ValueError(f"prompt length {plen} outside [1, {self.max_len}]")
        toks = None
        for t in range(plen):
            toks, self.prefill_logits = self.decode(
                self.cache, prompts[:, t:t + 1], t, self.generator)
        self.last_logits = self.prefill_logits
        self.lengths[:] = plen
        return toks

    def generate(self, prompts, steps: int) -> torch.Tensor:
        """Prefill, then ``steps`` tokens for every sequence: (B, steps) int32
        on the model's device."""
        prompts = self._tokens(prompts)
        pos = prompts.shape[1]
        if pos + steps - 1 > self.max_len:
            raise ValueError(f"prompt {pos} + {steps} steps exceed max_len {self.max_len}")
        next_tok = self.prefill(prompts)
        out = [next_tok]
        for i in range(steps - 1):
            next_tok, self.last_logits = self.decode(self.cache, next_tok, pos + i,
                                                     self.generator)
            out.append(next_tok)
        self.lengths += steps
        return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="a name of configs.ARCHS (e.g. deepseek-v2-236b, MLA), "
                         "with '-smoke' for its CPU-sized variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--impl", default="kernel", choices=IMPLS)
    ap.add_argument("--fused-ffn", action="store_true",
                    help="SwiGLU MLPs through the fused kernel (K4)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (an error without one); "
                         "'cpu' runs the kernels' plain versions")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="serve through a (data, model) device mesh with this many ranks on "
                         "'model' (default: no mesh, one device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    mesh = None
    if args.mesh_model is not None:
        mesh = make_host_mesh(model=args.mesh_model, device=device)
    model = LanguageModel(cfg, impl=args.impl, fused_ffn=args.fused_ffn)
    model.init(torch.Generator(device=device).manual_seed(0), device=device)
    engine = ServingEngine(model, args.batch, args.max_len, mesh=mesh)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    toks = engine.generate(prompts, args.gen).cpu()    # the copy waits for the device
    dt = time.time() - t0
    if mesh is None or dist.get_rank() == 0:
        where = device if mesh is None else f"{device}, mesh {tuple(mesh.shape)}"
        print(f"generated {tuple(toks.shape)} tokens in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s) on {where}")
        print("sample:", toks[0][:12].tolist())
    return toks


if __name__ == "__main__":
    main()
