"""Traces for the assigned LM architectures, fed to the paper's COPA
analysis — this is the integration point: the same cache/perf model that
reproduces the paper's MLPerf study runs over our 10 architectures x 4
shapes, and its traffic sweeps drive the software-MSM policy choices.

Per-GPU scope: the trace models ONE device's shard of the workload
(global_batch / 256 chips, TP shard of weights), matching the paper's
per-GPU methodology (§IV-A: all-reduce omitted).
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.configs import SHAPES, get
from repro_torch.configs.base import ModelConfig
from repro_torch.core.trace import Trace, gemm_parallelism
from repro_torch.workloads.common import ModelBuilder

CHIPS = 256
TP = 16  # model-axis shard of weights


def _attn_layer(mb: ModelBuilder, cfg: ModelConfig, name: str, tokens: int,
                seq: int, decode: bool):
    e = mb.dtype_bytes()
    d = cfg.d_model
    h = max(cfg.n_heads // TP, 1) * TP  # pad tiny models to one head/shard
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    if cfg.use_mla:
        q = mb.gemm(f"{name}.q_a", None, tokens, d, cfg.q_lora_rank,
                    x_bytes=tokens * d * e)
        q = mb.gemm(f"{name}.q_b", q, tokens, cfg.q_lora_rank,
                    (h // TP) * (hd + cfg.rope_head_dim))
        kv = mb.gemm(f"{name}.kv_a", None, tokens, d,
                     cfg.kv_lora_rank + cfg.rope_head_dim,
                     x_bytes=tokens * d * e)
        if decode:
            # absorbed decode: score against latent cache
            cache_bytes = seq * (cfg.kv_lora_rank + cfg.rope_head_dim) * e \
                * mb._batch
            mb.emit(f"{name}.sdpa", 2.0 * mb._batch * (h // TP) * seq
                    * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2,
                    reads=[(f"{name}.kvcache", cache_bytes),
                           (q, tokens * (h // TP) * (hd + cfg.rope_head_dim) * e)],
                    writes=[(f"{name}.attnout", tokens * (h // TP) * hd * e)],
                    parallelism=float(mb._batch * (h // TP) * 128))
        else:
            kvx = mb.gemm(f"{name}.kv_b", kv, tokens, cfg.kv_lora_rank,
                          (h // TP) * (hd + cfg.v_head_dim))
            mb.attention(f"{name}.sdpa_core", q, mb._batch, seq, seq,
                         h // TP, hd, kv_heads=h // TP, chunked=True)
        mb.gemm(f"{name}.o", None, tokens, (h // TP) * cfg.v_head_dim, d,
                x_bytes=tokens * (h // TP) * cfg.v_head_dim * e)
        return
    kvh_t = max(kvh // TP, 1)
    q = mb.gemm(f"{name}.q", None, tokens, d, (h // TP) * hd,
                x_bytes=tokens * d * e)
    mb.gemm(f"{name}.k", None, tokens, d, kvh_t * hd, x_bytes=tokens * d * e)
    mb.gemm(f"{name}.v", None, tokens, d, kvh_t * hd, x_bytes=tokens * d * e)
    if decode:
        cache = seq * kvh_t * hd * 2 * e * mb._batch
        mb.emit(f"{name}.sdpa", 2.0 * mb._batch * (h // TP) * seq * hd * 2,
                reads=[(f"{name}.kvcache", cache),
                       (q, tokens * (h // TP) * hd * e)],
                writes=[(f"{name}.attnout", tokens * (h // TP) * hd * e)],
                parallelism=float(mb._batch * (h // TP) * 128))
    else:
        mb.attention(f"{name}.sdpa_core", q, mb._batch, seq, seq, h // TP,
                     hd, kv_heads=kvh_t, chunked=True)
    mb.gemm(f"{name}.o", None, tokens, (h // TP) * hd, d,
            x_bytes=tokens * (h // TP) * hd * e)


def _ffn_layer(mb: ModelBuilder, cfg: ModelConfig, name: str, tokens: int,
               d_ff: int):
    e = mb.dtype_bytes()
    d = cfg.d_model
    f = max(d_ff // TP, 1)
    h1 = mb.gemm(f"{name}.gate", None, tokens, d, f, x_bytes=tokens * d * e)
    mb.gemm(f"{name}.up", None, tokens, d, f, x_bytes=tokens * d * e)
    mb.gemm(f"{name}.down", h1, tokens, f, d)


def _moe_layer(mb: ModelBuilder, cfg: ModelConfig, name: str, tokens: int):
    e = mb.dtype_bytes()
    d = cfg.d_model
    e_local = max(cfg.n_experts // TP, 1)
    # activated fraction of the local expert weights
    frac = min(1.0, tokens * cfg.top_k / max(cfg.n_experts, 1) / 8.0 + 0.1) \
        if tokens < cfg.n_experts * 8 else 1.0
    w_bytes = int(3 * d * cfg.moe_d_ff * e_local * e * frac)
    act_tokens = tokens * cfg.top_k // TP
    mb.gemm(f"{name}.router", None, tokens, d, cfg.n_experts,
            x_bytes=tokens * d * e)
    mb.emit(f"{name}.experts",
            2.0 * act_tokens * 3 * d * cfg.moe_d_ff,
            reads=[(f"{name}.expert_w", w_bytes),
                   (f"{name}.dispatch_in", act_tokens * d * e)],
            writes=[(f"{name}.dispatch_out", act_tokens * d * e)],
            parallelism=gemm_parallelism(act_tokens, cfg.moe_d_ff))
    if cfg.n_shared_experts:
        _ffn_layer(mb, cfg, f"{name}.shared", tokens,
                   cfg.moe_d_ff * cfg.n_shared_experts)


def _ssm_layer(mb: ModelBuilder, cfg: ModelConfig, name: str, tokens: int,
               decode: bool):
    e = mb.dtype_bytes()
    d, di = cfg.d_model, cfg.d_inner
    proj = (2 * di + 2 * cfg.ssm_state + cfg.ssm_heads) // 1
    x = mb.gemm(f"{name}.in", None, tokens, d, max(proj // TP, 1),
                x_bytes=tokens * d * e)
    state_bytes = mb._batch * cfg.ssm_heads * cfg.ssm_head_dim \
        * cfg.ssm_state * 4 // TP
    flops = 2.0 * tokens * (cfg.ssm_heads // TP + 1) * cfg.ssm_head_dim \
        * cfg.ssm_state * (2 if not decode else 2)
    mb.emit(f"{name}.ssd", flops,
            reads=[(x, tokens * max(di // TP, 1) * e),
                   (f"{name}.state", state_bytes)],
            writes=[(f"{name}.y", tokens * max(di // TP, 1) * e),
                    (f"{name}.state", state_bytes)],
            parallelism=float(tokens * max(cfg.ssm_heads // TP, 1)))
    mb.gemm(f"{name}.out", None, tokens, max(di // TP, 1), d,
            x_bytes=tokens * max(di // TP, 1) * e)


@lru_cache(maxsize=128)
def arch_trace(arch: str, shape_name: str) -> Trace:
    cfg = get(arch)
    shape = SHAPES[shape_name]
    decode = shape.step == "decode"
    batch = max(shape.global_batch // (CHIPS // TP), 1)
    seq = shape.seq_len
    tokens = batch * (1 if decode else seq)
    mb = ModelBuilder(f"{arch}.{shape_name}")
    mb._batch = batch
    e = mb.dtype_bytes()

    mb.gather("embed", cfg.vocab_size * cfg.d_model * e // TP,
              tokens * cfg.d_model * e)
    enc = cfg.n_encoder_layers if cfg.family == "audio" and not decode else 0
    for i in range(enc):
        _attn_layer(mb, cfg, f"enc{i}", tokens, seq, False)
        _ffn_layer(mb, cfg, f"enc{i}.ffn", tokens, cfg.d_ff)
    for i in range(cfg.n_layers):
        nm = f"l{i}"
        if cfg.family in ("dense", "vlm", "audio"):
            _attn_layer(mb, cfg, nm, tokens, seq, decode)
            _ffn_layer(mb, cfg, f"{nm}.ffn", tokens, cfg.d_ff)
        elif cfg.family == "moe":
            _attn_layer(mb, cfg, nm, tokens, seq, decode)
            if i < cfg.first_k_dense:
                _ffn_layer(mb, cfg, f"{nm}.ffn", tokens,
                           cfg.dense_d_ff or cfg.d_ff)
            else:
                _moe_layer(mb, cfg, f"{nm}.moe", tokens)
        elif cfg.family == "ssm":
            _ssm_layer(mb, cfg, nm, tokens, decode)
        elif cfg.family == "hybrid":
            _ssm_layer(mb, cfg, nm, tokens, decode)
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                _attn_layer(mb, cfg, f"{nm}.shared", tokens, seq, decode)
                _ffn_layer(mb, cfg, f"{nm}.sffn", tokens, cfg.d_ff)
    mb.gemm("logits", None, tokens, cfg.d_model,
            max(cfg.vocab_size // TP, 1),
            x_bytes=tokens * cfg.d_model * e)
    tr = mb.trace(training=(shape.step == "train"), batch_size=batch,
                  optimizer="adam")
    tr.name = f"{arch}.{shape_name}"
    return tr
