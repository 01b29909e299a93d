"""Architecture configuration schema.

Every architecture is a :class:`ModelConfig`; ``smoke()`` returns the
reduced same-family variant used by the CPU tests. The schema is the same
as the JAX reference package's, field for field, so that a configuration
means the same model in both.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim
    first_k_dense: int = 0      # leading dense layers (DeepSeek)
    dense_d_ff: int = 0         # hidden dim of those dense layers
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0         # 0 -> head_dim

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0         # hybrid: shared attention block every N layers

    # --- encoder-decoder (Whisper) ---
    n_encoder_layers: int = 0
    cross_attention: bool = False

    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str | None = None  # "audio" | "vision" (stub: embeddings provided)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.use_mla and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # ---- derived sizes --------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: SSM and hybrid families only."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def attn_params_per_layer(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        if self.use_mla:
            r = self.rope_head_dim
            q = self.q_lora_rank * d + self.q_lora_rank * h * (hd + r) if self.q_lora_rank else d * h * (hd + r)
            kvp = d * (self.kv_lora_rank + r) + self.kv_lora_rank * h * (hd + self.v_head_dim)
            o = h * self.v_head_dim * d
            return q + kvp + o
        return d * h * hd + 2 * d * kv * hd + h * hd * d

    def ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def ssm_params_per_layer(self) -> int:
        d, di, s = self.d_model, self.d_inner, self.ssm_state
        in_proj = d * (2 * di + 2 * s + self.ssm_heads)  # z, x, B, C, dt
        conv = (di + 2 * s) * self.ssm_conv
        out = di * d
        return in_proj + conv + out + 2 * self.ssm_heads  # + A, D

    def n_params(self) -> float:
        """Total parameters (embeddings included once; +lm head if untied)."""
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        total = float(emb)
        enc = self.n_encoder_layers
        dec = self.n_layers
        if self.family == "ssm":
            total += dec * (self.ssm_params_per_layer() + 2 * self.d_model)
            return total
        if self.family == "hybrid":
            total += dec * (self.ssm_params_per_layer() + 2 * self.d_model)
            # one SHARED attention+MLP block (Zamba-style)
            total += self.attn_params_per_layer() + self.ffn_params(self.d_ff)
            return total
        per_layer_attn = self.attn_params_per_layer() + 2 * self.d_model
        if self.n_experts:
            moe_layers = dec - self.first_k_dense
            dense_layers = self.first_k_dense
            expert_p = (self.n_experts + self.n_shared_experts) * self.ffn_params(self.moe_d_ff)
            router_p = self.d_model * self.n_experts
            total += dec * per_layer_attn
            total += moe_layers * (expert_p + router_p)
            total += dense_layers * self.ffn_params(self.dense_d_ff or self.d_ff)
            return total
        total += (dec + enc) * (per_layer_attn + self.ffn_params(self.d_ff))
        if self.cross_attention:
            total += dec * self.attn_params_per_layer()
        return total

    def n_active_params(self) -> float:
        """Per-token activated parameters (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.n_params()
        dec = self.n_layers
        moe_layers = dec - self.first_k_dense
        emb = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        active = float(emb) + dec * (self.attn_params_per_layer() + 2 * self.d_model)
        active += moe_layers * (
            (self.top_k + self.n_shared_experts) * self.ffn_params(self.moe_d_ff)
            + self.d_model * self.n_experts
        )
        active += self.first_k_dense * self.ffn_params(self.dense_d_ff or self.d_ff)
        return active

    # ---- reduced variant for CPU smoke tests -----------------------------------
    def smoke(self) -> "ModelConfig":
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if (self.attn_every or self.first_k_dense) else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=2, moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1), dense_d_ff=128)
        if self.use_mla:
            kw.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8, v_head_dim=16)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=2, n_kv_heads=4)
        if self.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        return dataclasses.replace(self, **kw)
