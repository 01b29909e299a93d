"""Model assembly: specs, init, forward (loop over the stacked layers), loss,
and the prefill/decode paths with layer-stacked caches.

    model = LanguageModel(cfg, impl="kernel", remat="none", fused_ffn=False,
                          scan=None)          # scan: default impl
    model.init(generator, dtype, device)      # or model.load_params(tree)
    h, aux = model.forward(batch)             # train/prefill hidden states
    loss = model.loss(batch)                  # differentiable scalar
    cache = model.init_cache(batch_size, max_len, enc_len=0)
    logits, cache = model.decode_step(cache, tokens, pos)

The module holds its parameters as one nested ``ParameterDict`` with the
reference's keys and stacked shapes (layer parameters carry a leading
``layers`` axis), so a parameter tree converts 1:1. Every family of the
reference is assembled: ``dense`` (GQA), ``vlm`` (the dense family, whose
batch may carry ``patch_embeds`` for its first positions), ``moe`` (routed
experts, after ``first_k_dense`` dense-FFN layers), ``ssm`` (Mamba-2),
``hybrid`` (Mamba-2 with one shared attention + MLP block after every
``attn_every``-th layer, Zamba-2) and ``audio`` (the encoder-decoder,
whisper: a non-causal encoder over the batch's ``frames``, a decoder with
causal self-attention and cross-attention to the encoder's output).
Attention is GQA, or MLA where ``cfg.use_mla`` (deepseek-v2-236b): its
cache holds the latent ``ckv`` and the shared rope key ``krope`` a layer,
and its decode step is the absorbed form.

``impl="kernel"`` runs attention through K1 (prefill, MLA's too; K2a/K2b
behind it in the backward) and K3 (GQA decode, the encoder-decoder's cross
decode too); ``scan`` picks the SSD scan apart from it: ``"kernel"`` (K5,
forward only: a gradient through it raises) or ``"naive"`` (the plain
chunked scan, differentiable), by default what ``impl`` says, so that a
model trains with K1/K2 attention beside the naive scan (``scan="naive"``,
as ``launch/train`` builds it). ``fused_ffn=True`` runs every SwiGLU MLP
but the routed experts through K4 (forward only).

Every family but ``audio`` also trains through a device mesh: parameters
and batch as ``DTensor``s (``sharding.partition``), the residual stream
sequence-parallel between blocks (``sp_boundary``), attention on each
rank's shards (``kernels.ops``), the routed experts over "model"
(``models.moe``), the Mamba-2 mixer on each rank's rows with its weights
replicated (``models.ssm``; the naive scan: K5 refuses a mesh). The same
families but ``audio`` decode through a mesh: ``decode_step`` takes
``DTensor`` caches in ``cache_shardings``' placements (``cache["k"][i]`` is
a view of the stacked cache's local shard, so a layer's writes reach it),
each attention reading its cache where it lies (``models.attention``), the
Mamba-2 states updated on each rank's rows, K4 on each rank's F-slice.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import IMPLS, cross_decode, gqa_decode, mla_decode
from repro_torch.models.base import P, Specs, axes_tree, init_params, stack_specs
from repro_torch.models.layers import (chunked_cross_entropy, embed, embedding_specs,
                                       ffn, logits_for_tokens, rmsnorm, rmsnorm_specs)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import SCANS
from repro_torch.sharding.partition import sp_boundary

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


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _layer_groups(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """The stacked layer groups in order, as (params key, first layer,
    count): a moe config's ``first_k_dense`` dense-FFN layers
    (``dense_layers``), then ``layers``."""
    kd = cfg.first_k_dense if cfg.family == "moe" else 0
    return ([("dense_layers", 0, kd)] if kd else []) + [("layers", kd, cfg.n_layers - kd)]


def _check_tree(tree, specs: Specs, prefix: str = "") -> None:
    """Raise ``ValueError`` naming the first leaf (in sorted-key order) that
    ``specs`` has and ``tree`` lacks, that ``tree`` has and ``specs`` lacks,
    or whose shape is not its spec's."""
    for k in sorted(set(specs) | set(tree.keys())):
        path = prefix + k
        if k not in tree:
            raise ValueError(f"parameter {path!r} is missing")
        if k not in specs:
            raise ValueError(f"parameter {path!r} is not one of this model's")
        spec, v = specs[k], tree[k]
        if isinstance(spec, P):
            if hasattr(v, "keys") or tuple(v.shape) != spec.shape:
                shape = "a subtree" if hasattr(v, "keys") else f"shape {tuple(v.shape)}"
                raise ValueError(f"parameter {path!r} has {shape}, expected shape {spec.shape}")
        elif not hasattr(v, "keys"):
            raise ValueError(f"parameter {path!r} is a leaf, expected a subtree")
        else:
            _check_tree(v, spec, path + ".")


def _to_module(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: (_to_module(v) if hasattr(v, "keys")
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
    def __init__(self, cfg: ModelConfig, impl: str = "kernel", remat: str = "none",
                 fused_ffn: bool = False, scan: str | None = None):
        super().__init__()
        scan = impl if scan is None else scan
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r} not one of {IMPLS}")
        if scan not in SCANS:
            raise ValueError(f"scan {scan!r} not one of {SCANS}")
        if remat not in REMATS:
            raise ValueError(f"remat {remat!r} not one of {REMATS}")
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} ({cfg.name}) not one of {FAMILIES}")
        self.cfg = cfg
        self.impl = impl            # sdpa / decode implementation
        self.scan = scan            # SSD scan implementation (Mamba-2 layers)
        self.remat = remat          # per-block rematerialization policy
        self.fused_ffn = fused_ffn  # SwiGLU through K4 (MemoryPolicy.fused_ffn)
        self.params = nn.ParameterDict()

    # ------------------------------------------------------------------ specs --
    def specs(self) -> Specs:
        cfg = self.cfg
        s: Specs = {
            "emb": embedding_specs(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings),
            "ln_f": rmsnorm_specs(cfg.d_model),
        }
        if cfg.family in ("dense", "vlm"):
            s["layers"] = stack_specs(blocks.dense_block_specs(cfg), cfg.n_layers)
        elif cfg.family == "moe":
            for key, _, n in _layer_groups(cfg):
                s[key] = stack_specs(blocks.moe_block_specs(cfg, key == "dense_layers"), n)
        elif cfg.family == "audio":
            s["enc_layers"] = stack_specs(blocks.encoder_block_specs(cfg), cfg.n_encoder_layers)
            s["layers"] = stack_specs(blocks.decoder_block_specs(cfg), cfg.n_layers)
            s["ln_enc"] = rmsnorm_specs(cfg.d_model)
        else:
            s["layers"] = stack_specs(blocks.mamba_block_specs(cfg), cfg.n_layers)
        if cfg.family == "hybrid":
            s["shared_attn"] = blocks.shared_attn_block_specs(cfg)
        return s

    def init(self, generator: torch.Generator, dtype=torch.bfloat16, device=None):
        """Random parameters from ``generator`` on ``device`` (default: the
        card). Returns ``self``."""
        return self.load_params(init_params(self.specs(), generator, dtype, device))

    def load_params(self, tree: dict):
        """Adopt a nested dict of tensors with the keys and shapes of
        ``specs()`` (as ``convert.params_from_numpy`` and
        ``checkpoint.ckpt.restore`` return it). Raises ``ValueError`` naming
        the first missing, extra or misshapen leaf, so that another
        architecture's parameters fail here and not at a product."""
        _check_tree(tree, self.specs())
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

    # ------------------------------------------------------------- embeddings --
    def _embed_inputs(self, batch):
        """Token embeddings; a ``vision`` front end's ``patch_embeds`` (B,P,d),
        where the batch has them, take the first P positions, cast to the
        embeddings' dtype."""
        x = embed(self.params["emb"], batch["tokens"])
        if self.cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    # ---------------------------------------------------------------- forward --
    def forward(self, batch):
        """batch: {"tokens": (B,S) int, optional "positions": (B,S), optional
        "patch_embeds": (B,P,d) for a vision front end; "frames" (B,S_enc,d)
        for the encoder-decoder}. Returns (hidden (B,S,d), aux_loss fp32)."""
        cfg, params = self.cfg, self.params
        if cfg.family == "audio":
            return self._forward_audio(batch)
        x = self._embed_inputs(batch)
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        if cfg.family == "moe":
            def moe_body(x_, p_):
                # the sequence-parallel residual boundary, as in the dense branch
                return blocks.moe_block(p_, cfg, sp_boundary(x_), positions, impl=self.impl,
                                        fused=self.fused_ffn)

            for key, _, n in _layer_groups(cfg):
                for p in _unbind_layers(params[key], n):
                    x, a = _maybe_remat(moe_body, self.remat, x, p)
                    aux = aux + a
            return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux

        if cfg.family in ("dense", "vlm"):
            def body(x_, p_):
                # the sequence-parallel residual boundary of the reference's
                # dense scan (the block keeps its output there): a no-op
                # without a device mesh
                return blocks.dense_block(p_, cfg, sp_boundary(x_), positions,
                                          impl=self.impl, fused=self.fused_ffn)
        else:
            # the reference's boundaries around each Mamba-2 block and each
            # call of the shared block (its lm.py:137-161)
            def body(x_, p_):
                return sp_boundary(blocks.mamba_block(p_, cfg, sp_boundary(x_), scan=self.scan))

            def shared(x_, p_):
                return sp_boundary(blocks.shared_attn_block(p_, cfg, x_, positions,
                                                            impl=self.impl,
                                                            fused=self.fused_ffn))

        for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
            x = _maybe_remat(body, self.remat, x, p)
            if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = _maybe_remat(shared, self.remat, x, params["shared_attn"])
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return h, aux

    def _forward_audio(self, batch):
        """The encoder over ``batch["frames"]`` (B,S_enc,d; a stubbed conv
        front end's output), then ``ln_enc``; the decoder over the embedded
        ``batch["tokens"]`` against it, then ``ln_f``. The frames are cast to
        bf16 whatever the parameters' dtype, as the reference casts them
        (``lm.py:_forward_audio``): with fp32 parameters the first encoder
        block's first norm stays bf16 and its residual turns the stream
        fp32, as JAX's promotion does (``attention.gqa_project_qkv``)."""
        cfg, params = self.cfg, self.params
        frames = batch["frames"]
        b, s_enc, _ = frames.shape
        enc_pos = torch.arange(s_enc, dtype=torch.int32, device=frames.device).expand(b, s_enc)
        x = frames.to(torch.bfloat16)

        def enc_body(x_, p_):
            return blocks.encoder_block(p_, cfg, x_, enc_pos, impl=self.impl,
                                        fused=self.fused_ffn)

        for p in _unbind_layers(params["enc_layers"], cfg.n_encoder_layers):
            x = _maybe_remat(enc_body, self.remat, x, p)
        enc_out = rmsnorm(params["ln_enc"], x, cfg.norm_eps)

        tokens = batch["tokens"]
        s_dec = tokens.shape[1]
        dec_pos = torch.arange(s_dec, dtype=torch.int32, device=tokens.device).expand(b, s_dec)
        y = embed(params["emb"], tokens)

        def dec_body(y_, p_, enc_):
            return blocks.decoder_block(p_, cfg, y_, enc_, dec_pos, impl=self.impl,
                                        fused=self.fused_ffn)

        for p in _unbind_layers(params["layers"], cfg.n_layers):
            y = _maybe_remat(dec_body, self.remat, y, p, enc_out)
        h = rmsnorm(params["ln_f"], y, cfg.norm_eps)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)

    # ------------------------------------------------------------------- loss --
    def loss(self, batch, aux_weight: float = 0.01):
        """batch: {"tokens", "labels": (B,S) int, optional "positions",
        "loss_mask"}. Mean next-token cross-entropy plus ``aux_weight`` times
        the MoE load-balance loss, fp32 scalar."""
        h, aux = self.forward(batch)
        ce = chunked_cross_entropy(self.params["emb"], h, batch["labels"],
                                   mask=batch.get("loss_mask"))
        return ce + aux_weight * aux

    # ------------------------------------------------------------------ cache --
    def init_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   enc_len: int = 0):
        """Zeroed caches; dtype and device default to the parameters'. Dense,
        vlm and moe: (L,B,S,KVH,D) ``k``/``v``; with MLA instead ``ckv``
        (L,B,S,kv_lora) and ``krope`` (L,B,S,rope_head_dim). SSM: ``conv``
        (L,B,kw-1,C) and ``ssm`` (L,B,H,P,N), the SSM state always fp32.
        Hybrid: those, and ``shared_k``/``shared_v`` (L // attn_every, B, S,
        KVH, D) for the shared block's calls. Audio: ``k``/``v``, and
        ``cross_k``/``cross_v`` (L,B,enc_len,KVH,D) for the cross-attention,
        which nothing fills: the decode step attends over them as they are,
        as in the reference (zeros unless the caller writes them). Other
        families ignore ``enc_len``.

        A ``moe`` config with GQA attention and first_k_dense > 0 is refused:
        the reference's decode step scans ``layers`` (n_layers - first_k_dense
        of them) against the n_layers-deep cache and never runs
        ``dense_layers`` (``models/lm.py:decode_step``), so it has no
        semantics to copy, and no decode step runs without this cache."""
        cfg = self.cfg
        if cfg.family == "moe" and cfg.first_k_dense and not cfg.use_mla:
            raise NotImplementedError(
                f"{cfg.name}: no decode step for a moe config with GQA attention and "
                f"first_k_dense={cfg.first_k_dense}: the reference's scans the "
                f"{cfg.n_layers - cfg.first_k_dense} MoE layers against an {cfg.n_layers}-layer "
                "cache and skips the dense layers")
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        if cfg.use_mla:
            shape = (cfg.n_layers, batch, max_len)
            return {"ckv": torch.zeros(*shape, cfg.kv_lora_rank, dtype=dtype, device=device),
                    "krope": torch.zeros(*shape, cfg.rope_head_dim, dtype=dtype, device=device)}
        if cfg.family in ("dense", "vlm", "moe", "audio"):
            shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
            if cfg.family == "audio":
                shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
                cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
                cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
            return cache
        cache = self._ssm_cache(batch, dtype, device)
        if cfg.family == "hybrid":
            shape = (cfg.n_layers // cfg.attn_every, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=device)
            cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=device)
        return cache

    def _ssm_cache(self, batch: int, dtype, device):
        cfg = self.cfg
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32, device=device),
        }

    # ------------------------------------------------------------ decode step --
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B,1) int; pos: host int (current length). The cache is
        written IN PLACE. Returns (logits (B,1,V), cache). A moe config's
        ``dense_layers`` run against cache layers [0, first_k_dense) and its
        ``layers`` against the rest, as in the reference's MLA branch."""
        cfg, params = self.cfg, self.params
        x = embed(params["emb"], tokens)
        if cfg.family in ("dense", "vlm", "moe"):
            ka, kb = ("ckv", "krope") if cfg.use_mla else ("k", "v")
            for key, off, n in _layer_groups(cfg):
                for i, p in enumerate(_unbind_layers(params[key], n), start=off):
                    x = self._attn_mlp_decode(p, x, cache[ka][i], cache[kb][i], pos)
        elif cfg.family == "audio":
            for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
                x = self._decoder_decode(p, x, cache["k"][i], cache["v"][i],
                                         cache["cross_k"][i], cache["cross_v"][i], pos)
        else:
            for i, p in enumerate(_unbind_layers(params["layers"], cfg.n_layers)):
                x, _, _ = blocks.mamba_block_decode(p, cfg, x, cache["conv"][i],
                                                    cache["ssm"][i])
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    inv = i // cfg.attn_every
                    x = self._attn_mlp_decode(params["shared_attn"], x, cache["shared_k"][inv],
                                              cache["shared_v"][inv], pos)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits_for_tokens(params["emb"], h), cache

    def _attn_mlp_decode(self, p, x, cache_a, cache_b, pos: int):
        """One token through an attention + MLP block (a dense or MoE layer,
        or the hybrid's shared block); the caches (``k``/``v``, or MLA's
        ``ckv``/``krope``) are written in place."""
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        attend = mla_decode if cfg.use_mla else gqa_decode
        o, _, _ = attend(p["attn"], cfg, h, cache_a, cache_b, pos, impl=self.impl)
        x = x + o
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "ffn" in p:
            return x + ffn(p["ffn"], h, fused=self.fused_ffn)
        return x + moe_ffn(p["moe"], cfg, h, fused=self.fused_ffn)[0]

    def _decoder_decode(self, p, x, cache_k, cache_v, cross_k, cross_v, pos: int):
        """One token through a decoder block: causal self-attention against
        ``k``/``v`` (written in place), cross-attention against the
        encoder's cached keys and values (read only), the MLP."""
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + gqa_decode(p["attn"], cfg, h, cache_k, cache_v, pos, impl=self.impl)[0]
        h = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + cross_decode(p["cross"], cfg, h, cross_k, cross_v, impl=self.impl)
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + ffn(p["ffn"], h, fused=self.fused_ffn)
