"""Model assembly: specs, init, forward (loop over the stacked layers), loss,
and the prefill/decode paths with layer-stacked caches.

    model = LanguageModel(cfg, impl="kernel", remat="none")
    model.init(generator, dtype, device)      # or model.load_params(tree)
    h, aux = model.forward(batch)             # train/prefill hidden states
    loss = model.loss(batch)                  # differentiable scalar
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
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import IMPLS, gqa_decode
from repro_torch.models.base import Specs, axes_tree, init_params, stack_specs
from repro_torch.models.layers import (chunked_cross_entropy, embed, embedding_specs,
                                       ffn, logits_for_tokens, rmsnorm, rmsnorm_specs)

REMATS = ("none", "dots", "full")
# what remat "dots" keeps: the outputs of the matrix products, as
# jax.checkpoint_policies.checkpoint_dots keeps those of dot_general
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str, *args):
    """``fn(*args)`` under the block's rematerialization policy: "none" keeps
    every activation, "full" keeps only the block's input and recomputes the
    rest in the backward, "dots" keeps the matrix products' outputs. The
    blocks draw no random numbers, so no RNG state is stashed."""
    if remat == "none":
        return fn(*args)
    context = {} if remat == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **context)


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


def _unbind_layers(stacked, n: int) -> list[dict]:
    """All ``n`` layers' views of a stacked tree, by one ``unbind`` a leaf, so
    the backward writes each stacked gradient once (indexing layer by layer
    would add a zero-filled full-size gradient per layer)."""
    out = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = (_unbind_layers(v, n) if isinstance(v, (dict, nn.ParameterDict))
                 else v.unbind(0))
        for i in range(n):
            out[i][k] = parts[i]
    return out


class LanguageModel(nn.Module):
    def __init__(self, cfg: ModelConfig, impl: str = "kernel", remat: str = "none"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not one of {IMPLS}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not one of {REMATS}")
        if cfg.family != "dense" or cfg.use_mla:
            item = FAMILY_ROADMAP_ITEM.get(cfg.family, "item 9 (MLA + MoE)")
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md queue 1, {item}")
        self.cfg = cfg
        self.impl = impl            # sdpa / decode implementation
        self.remat = remat          # per-block rematerialization policy
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

        def body(x_, p_):
            return blocks.dense_block(p_, cfg, x_, positions, impl=self.impl)

        for p in _unbind_layers(params["layers"], cfg.n_layers):
            x = _maybe_remat(body, self.remat, x, p)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return h, aux

    # ------------------------------------------------------------------- loss --
    def loss(self, batch, aux_weight: float = 0.01):
        """batch: {"tokens", "labels": (B,S) int, optional "positions",
        "loss_mask"}. Mean next-token cross-entropy, fp32 scalar."""
        h, aux = self.forward(batch)
        ce = chunked_cross_entropy(self.params["emb"], h, batch["labels"],
                                   mask=batch.get("loss_mask"))
        return ce + aux_weight * aux

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
        for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            o, _, _ = gqa_decode(p["attn"], cfg, h, cache["k"][i], cache["v"][i], pos,
                                 impl=self.impl)
            x = x + o
            h = rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + ffn(p["ffn"], h)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits_for_tokens(params["emb"], h), cache
