"""Software Memory-System Modules — the COPA idea, as policies of the port.

The paper composes one reusable compute module (GPM) with domain-specialized
memory-system modules (MSM). Here the compute module is the model's math
graph; the composable memory system is *policy*: which attention
implementation, which remat policy, which optimizer-state dtype, how the KV
cache is laid out and sharded, which kernels filter HBM traffic.

``compose(domain, ...)`` returns the policy bundle for a workload domain the
same way a COPA SKU pairs a GPM with an MSM; ``recommend()`` derives the
domain from an (arch, shape) cell. The policies are the JAX reference
package's, field for field (``attention_impl`` keeps its names: the
dry-run maps ``chunked`` and ``pallas`` to the port's ``impl="kernel"``).
Two departures: the capacity rule reads one H100's 80 GB where the
reference reads a TPU v5e's 16 GiB, so on 256 devices no configuration
needs ``msm_train_large``; and ``recommend`` reads no ``REPRO_OPTS``
overrides (``serve_fsdp=False`` and ``kv_cache_dtype="int8"`` are asked
for through ``compose``). The reference's ``analyze`` (the cache model over
a cell's trace) is not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.hw import H100_SXM


@dataclass(frozen=True)
class MemoryPolicy:
    """One composed software-MSM: everything that shapes HBM traffic."""

    name: str
    attention_impl: str = "chunked"      # naive | chunked | pallas (the reference's names)
    attention_block_q: int = 512
    attention_block_kv: int = 1024
    remat: str = "none"                  # none | dots | full
    optimizer_dtype: str = "float32"     # float32 | bfloat16 moments
    master_weights: bool = True
    kv_cache_dtype: str = "bfloat16"
    kv_shard_axis: str | None = None     # e.g. "data" for context-parallel decode
    fused_ffn: bool = False              # fused SwiGLU (K4)
    donate_state: bool = True
    grad_compression: str | None = None  # None | bf16 | int8_ef
    microbatches: int = 1                # gradient-accumulation depth
    serve_fsdp: bool = True              # False: replicate weights over data
                                         # (kills per-step weight all-gathers)
    # Buddy-Compression-style KV residency knob (arXiv 1903.02596): the KV
    # cache is stored compressed in DRAM, multiplying effective capacity by
    # ``kv_compression_ratio`` at the cost of a fractional bandwidth tax on
    # every KV byte moved (compress/decompress traffic over the link).
    kv_compression_ratio: float = 1.0    # >= 1; 1.0 = off
    kv_compression_bw_tax: float = 0.0   # extra fraction of KV bytes moved

    def __post_init__(self):
        if self.kv_compression_ratio < 1.0:
            raise ValueError("kv_compression_ratio must be >= 1")
        if self.kv_compression_bw_tax < 0.0:
            raise ValueError("kv_compression_bw_tax must be >= 0")

    def describe(self) -> str:
        bits = [
            f"attn={self.attention_impl}(q{self.attention_block_q}/kv{self.attention_block_kv})",
            f"remat={self.remat}",
            f"opt={self.optimizer_dtype}" + ("+master" if self.master_weights else ""),
            f"kv={self.kv_cache_dtype}" + (f"@{self.kv_shard_axis}" if self.kv_shard_axis else ""),
        ]
        if self.fused_ffn:
            bits.append("fused_ffn")
        if self.grad_compression:
            bits.append(f"gradcomp={self.grad_compression}")
        if self.kv_compression_ratio != 1.0:
            bits.append(f"kvcomp={self.kv_compression_ratio:g}x"
                        f"(+{self.kv_compression_bw_tax:.0%}bw)")
        return " ".join(bits)


# The domain-specialized SKUs — same model "GPM", different memory systems.
TRAIN_MSM = MemoryPolicy(
    name="msm_train",
    attention_impl="chunked",
    remat="full",          # per-block full remat: only block boundaries saved
    optimizer_dtype="float32",
    grad_compression=None,
    microbatches=4,
)
TRAIN_LARGE_MSM = replace(
    TRAIN_MSM,
    name="msm_train_large",
    remat="full",
    optimizer_dtype="bfloat16",
    master_weights=False,   # stochastic-rounding updates: 6 bytes/param total
    grad_compression="bf16",
    microbatches=16,
)
PREFILL_MSM = MemoryPolicy(
    name="msm_prefill",
    attention_impl="chunked",
    attention_block_q=1024,
    attention_block_kv=1024,
    remat="none",
    master_weights=False,
)
DECODE_MSM = MemoryPolicy(
    name="msm_decode",
    attention_impl="chunked",
    attention_block_kv=2048,
    remat="none",
    master_weights=False,
)
LONG_CONTEXT_MSM = replace(
    DECODE_MSM,
    name="msm_long_context",
    kv_shard_axis="data",     # context-parallel flash-decode
)

_BY_NAME = {
    p.name: p
    for p in (TRAIN_MSM, TRAIN_LARGE_MSM, PREFILL_MSM, DECODE_MSM, LONG_CONTEXT_MSM)
}


def compose(name: str, **overrides) -> MemoryPolicy:
    base = _BY_NAME[name]
    return replace(base, **overrides) if overrides else base


def recommend(shape_name: str, n_params: float) -> MemoryPolicy:
    """Pick the software-MSM for a workload cell, like choosing a COPA SKU."""
    if shape_name.startswith("train"):
        # Models too large for fp32 optimizer residency get the large-model MSM
        # (bf16 moments + full remat), exactly the capacity-driven
        # specialization argument of the paper: 14 bytes a parameter against
        # 70 % of 256 cards' HBM.
        big = n_params * 14 > 0.70 * H100_SXM.hbm_capacity * 256
        return TRAIN_LARGE_MSM if big else TRAIN_MSM
    if shape_name.startswith("prefill"):
        return PREFILL_MSM
    if shape_name.startswith("long"):
        return LONG_CONTEXT_MSM
    return DECODE_MSM
