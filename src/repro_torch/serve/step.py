"""Serving steps: prefill (full-sequence forward) and decode (one token).

Sampling is greedy/temperature/top-k on fp32 logits. Both steps run without
autograd.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import logits_for_tokens


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
        drawn from). ``generator`` (on the logits' device) drives sampling."""
        logits, _ = model.decode_step(cache, tokens, pos)
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
