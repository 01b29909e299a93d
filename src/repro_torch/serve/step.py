"""Serving steps: prefill (full-sequence forward) and decode (one token).

Sampling is greedy/temperature/top-k on fp32 logits. Both steps run without
autograd. Under a device mesh (the model's parameters ``DTensor``s) the
decode step places its tokens as ``launch/specs`` places a decode cell's
(``place_tokens``) and brings the logits back replicated before argmax or
sampling, so every rank draws the same tokens.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.layers import logits_for_tokens
from repro_torch.sharding.partition import NamedSharding, batch_spec


def model_mesh(model):
    """The device mesh of ``model``'s parameters, or None for plain tensors."""
    leaf = model.params["ln_f"]["scale"]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


def place_tokens(tokens: torch.Tensor, mesh) -> DTensor:
    """(B, 1) int32 tokens, the same on every rank, as a ``DTensor``: batch
    over "data" (``batch_spec``) where B > 1, replicated at B = 1, as
    ``launch/specs.input_specs`` places a decode cell's. Each rank keeps its
    own rows; nothing is sent."""
    spec = batch_spec(mesh) if tokens.shape[0] > 1 else ()
    return distribute_tensor(tokens.to(torch.int32), mesh, NamedSharding(mesh, spec).placements,
                             src_data_rank=None)


def make_prefill_step(model):
    @torch.no_grad()
    def prefill(batch):
        """Runs the full-sequence forward and returns the logits of the last
        position, (B,1,V)."""
        h, _ = model.forward(batch)
        return logits_for_tokens(model.params["emb"], h[:, -1:, :])

    return prefill


def make_decode_step(model, sample: str = "greedy", temperature: float = 1.0,
                     top_k: int = 0):
    @torch.no_grad()
    def decode_step(cache, tokens, pos: int, generator: torch.Generator | None = None):
        """One token for every sequence; ``cache`` is written in place.
        Returns (next tokens (B,1) int32, the fp32 logits (B,V) they were
        drawn from), plain tensors, the same on every rank under a mesh.
        ``generator`` (on the logits' device) drives sampling."""
        mesh = model_mesh(model)
        if mesh is not None and not isinstance(tokens, DTensor):
            tokens = place_tokens(tokens, mesh)
        logits, _ = model.decode_step(cache, tokens, pos)
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        logits = logits[:, -1, :].float()
        if sample == "greedy":
            nxt = torch.argmax(logits, dim=-1, keepdim=True)
        else:
            scaled = logits / max(temperature, 1e-6)
            if top_k:
                vals, _ = torch.topk(scaled, top_k, dim=-1)
                scaled = scaled.masked_fill(scaled < vals[:, -1:], -1e30)
            nxt = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=generator)
        return nxt.to(torch.int32), logits

    return decode_step
