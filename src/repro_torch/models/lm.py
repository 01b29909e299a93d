"""Model assembly: specs, init, forward (loop over the stacked layers) and the
prefill/decode paths with layer-stacked caches.

    model = LanguageModel(cfg, impl="kernel")
    model.init(generator, dtype, device)      # or model.load_params(tree)
    h, aux = model.forward(batch)             # prefill hidden states
    cache = model.init_cache(batch_size, max_len)
    logits, cache = model.decode_step(cache, tokens, pos)

The module holds its parameters as one nested ``ParameterDict`` with the
reference's keys and stacked shapes (layer parameters carry a leading
``layers`` axis), so a parameter tree converts 1:1. Only the ``dense``
family is assembled so far.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import IMPLS, gqa_decode
from repro_torch.models.base import Specs, axes_tree, init_params, stack_specs
from repro_torch.models.layers import (embed, embedding_specs, ffn,
                                       logits_for_tokens, rmsnorm, rmsnorm_specs)

# where each family that is not assembled yet stands in ROADMAP.md, queue 1
FAMILY_ROADMAP_ITEM = {
    "vlm": "item 8 (K4 + vlm front end)",
    "moe": "item 9 (MLA + MoE)",
    "ssm": "item 10 (SSM + hybrid + K5)",
    "hybrid": "item 10 (SSM + hybrid + K5)",
    "audio": "item 11 (encoder-decoder)",
}


def _to_module(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: (_to_module(v) if isinstance(v, dict)
            else nn.Parameter(v, requires_grad=v.is_floating_point()))
        for k, v in tree.items()})


def _layer(stacked, i: int) -> dict:
    """Views of layer ``i`` of a stacked parameter tree."""
    return {k: (_layer(v, i) if isinstance(v, (dict, nn.ParameterDict)) else v[i])
            for k, v in stacked.items()}


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, impl: str = "kernel"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not one of {IMPLS}")
        if cfg.family != "dense" or cfg.use_mla:
            item = FAMILY_ROADMAP_ITEM.get(cfg.family, "item 9 (MLA + MoE)")
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md queue 1, {item}")
        self.cfg = cfg
        self.impl = impl            # sdpa / decode implementation
        self.params = nn.ParameterDict()

    # ------------------------------------------------------------------ specs --
    def specs(self) -> Specs:
        cfg = self.cfg
        return {
            "emb": embedding_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
            "ln_f": rmsnorm_specs(cfg.d_model),
            "layers": stack_specs(blocks.dense_block_specs(cfg), cfg.n_layers),
        }

    def init(self, generator: torch.Generator, dtype=torch.bfloat16, device=None):
        """Random parameters from ``generator`` on ``device`` (default: the
        card). Returns ``self``."""
        return self.load_params(init_params(self.specs(), generator, dtype, device))

    def load_params(self, tree: dict):
        """Adopt a nested dict of tensors with the keys and shapes of
        ``specs()`` (as ``convert.params_from_numpy`` returns it)."""
        self.params = _to_module(tree)
        return self

    def axes(self):
        return axes_tree(self.specs())

    @property
    def device(self) -> torch.device:
        return self.params["ln_f"]["scale"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["ln_f"]["scale"].dtype

    # ---------------------------------------------------------------- forward --
    def forward(self, batch):
        """batch: {"tokens": (B,S) int, optional "positions": (B,S)}.
        Returns (hidden (B,S,d), aux_loss)."""
        cfg, params = self.cfg, self.params
        x = embed(params["emb"], batch["tokens"])
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x = blocks.dense_block(_layer(params["layers"], i), cfg, x, positions,
                                   impl=self.impl)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return h, aux

    # ------------------------------------------------------------------ cache --
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None):
        """Zeroed (L,B,S,KVH,D) caches; dtype and device default to the
        parameters'."""
        cfg = self.cfg
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    # ------------------------------------------------------------ decode step --
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B,1) int; pos: host int (current length). The cache is
        written IN PLACE. Returns (logits (B,1,V), cache)."""
        cfg, params = self.cfg, self.params
        x = embed(params["emb"], tokens)
        for i in range(cfg.n_layers):
            p = _layer(params["layers"], i)
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            o, _, _ = gqa_decode(p["attn"], cfg, h, cache["k"][i], cache["v"][i], pos,
                                 impl=self.impl)
            x = x + o
            h = rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + ffn(p["ffn"], h)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits_for_tokens(params["emb"], h), cache
