"""Software Memory-System Modules — the COPA idea, as policies of the port.

The paper composes one reusable compute module (GPM) with domain-specialized
memory-system modules (MSM). Here the compute module is the model's math
graph; the composable memory system is *policy*: which attention
implementation, which remat policy, which optimizer-state dtype, how the KV
cache is laid out and sharded, which kernels filter HBM traffic.

``compose(domain, ...)`` returns the policy bundle for a workload domain the
same way a COPA SKU pairs a GPM with an MSM; ``recommend()`` derives the
domain from an (arch, shape) cell, and ``analyze()`` runs the paper's cache
model over the cell's trace to quantify how much traffic each policy filters
(the software analogue of Fig 4). The policies are the JAX reference
package's, field for field (``attention_impl`` keeps its names: the
dry-run maps ``chunked`` and ``pallas`` to the port's ``impl="kernel"``).
Two departures: the capacity rule reads one H100's 80 GB where the
reference reads a TPU v5e's 16 GiB, so on 256 devices no configuration
needs ``msm_train_large``; and ``recommend`` reads no ``REPRO_OPTS``
overrides (``serve_fsdp=False`` and ``kv_cache_dtype="int8"`` are asked
for through ``compose``). ``analyze`` and ``analyze_suite`` take the
``device`` their scans run on (``None``: the card, as ``core.sweep``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.hw import H100_SXM, MB
from repro_torch.core.sweep import analysis_for, suite_analysis_for
from repro_torch.core.trace import Trace


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


KV_BYTES_PER_ELEM = {"float32": 4, "bfloat16": 2, "float16": 2,
                     "fp8": 1, "int8": 1}

# Fraction of DRAM held back for activations / workspace on top of the
# resident weights when the reserve is derived from a model config.
_ACTIVATION_MARGIN = 0.05


def kv_reserve_frac(spec, model_config=None) -> float:
    """The DRAM fraction set aside for weights + activations.

    With a :class:`~repro_torch.configs.base.ModelConfig` the reserve is the
    model's actual resident weight bytes (``n_params`` at the config's
    param dtype) plus a small activation margin; without one, the
    historical conservative 0.30 stands in. Raises when the weights alone
    leave no room for KV — that config can't serve on this MSM at all."""
    if model_config is None:
        return 0.30
    bytes_per_param = KV_BYTES_PER_ELEM.get(model_config.dtype, 2)
    frac = (model_config.n_params() * bytes_per_param / spec.dram_capacity
            + _ACTIVATION_MARGIN)
    if frac >= 1.0:
        raise ValueError(
            f"model {model_config.name} needs {frac:.0%} of DRAM for "
            f"weights + activations — no capacity left for KV")
    return frac


def kv_token_capacity(spec, policy: MemoryPolicy, elems_per_token: int,
                      reserve_frac: float | None = None, *,
                      model_config=None) -> int:
    """Resident KV tokens one serving instance can hold — the admission
    bound of the request-level simulator (``repro_torch.serve.sim``).

    Usable DRAM (capacity minus the reserve set aside for weights and
    activations — derived via :func:`kv_reserve_frac` when ``reserve_frac``
    is None) over the per-token KV bytes; the element width comes from the
    policy's ``kv_cache_dtype``, so an int8-KV MSM holds 2x the tokens of a
    bf16 one, and a COPA MSM with ``dram_capacity_scale`` > 1 holds
    proportionally more — capacity-driven specialization at the serving
    layer. The policy's ``kv_compression_ratio`` multiplies the effective
    capacity (Buddy-Compression residency; the bandwidth tax is priced by
    the serving cost grids, not here)."""
    if reserve_frac is None:
        reserve_frac = kv_reserve_frac(spec, model_config)
    if not 0.0 <= reserve_frac < 1.0:
        raise ValueError("reserve_frac must be in [0, 1)")
    if elems_per_token < 1:
        raise ValueError("elems_per_token must be >= 1")
    per_token = elems_per_token * KV_BYTES_PER_ELEM[policy.kv_cache_dtype]
    usable = (1.0 - reserve_frac) * spec.dram_capacity \
        * policy.kv_compression_ratio
    return int(usable // per_token)


def kv_page_capacity(spec, policy: MemoryPolicy, elems_per_token: int,
                     page_size: int, reserve_frac: float | None = None, *,
                     model_config=None) -> int:
    """:func:`kv_token_capacity` in block-table pages: the physical page
    pool one instance's ``PagedKv`` allocator manages (its oversubscribable
    commit budget is this times the spec's oversubscription factor)."""
    if page_size < 1:
        raise ValueError("page_size must be >= 1")
    return kv_token_capacity(spec, policy, elems_per_token, reserve_frac,
                             model_config=model_config) // page_size


@dataclass
class TrafficAnalysis:
    """Fig-4-style sweep for a cell: traffic filtered per on-chip capacity."""

    trace_name: str
    baseline_traffic: float
    sweep: dict[float, float]

    def reduction_at(self, capacity: float) -> float:
        return self.baseline_traffic / max(self.sweep[capacity], 1.0)


DEFAULT_CAPACITIES_MB = (60, 120, 240, 480, 960, 1920, 3840)


def analyze(trace: Trace, capacities_mb: tuple[int, ...] = DEFAULT_CAPACITIES_MB,
            device=None) -> TrafficAnalysis:
    caps = [c * MB for c in capacities_mb]
    sweep = analysis_for(trace, device=device).dram_traffic(caps)
    return TrafficAnalysis(
        trace_name=trace.name,
        baseline_traffic=sweep[caps[0]],
        sweep=sweep,
    )


def analyze_suite(
    traces: list[Trace],
    capacities_mb: tuple[int, ...] = DEFAULT_CAPACITIES_MB,
    device=None,
) -> list[TrafficAnalysis]:
    """Suite-level :func:`analyze`: one padded
    :class:`~repro_torch.core.sweep.SuiteAnalysis` pass prices the Fig-4 sweep
    for every cell at once (bit-identical per trace to :func:`analyze` —
    the per-trace caches are shared, so mixing the two stays consistent)."""
    caps = [c * MB for c in capacities_mb]
    mat = suite_analysis_for(list(traces), device=device).dram_traffic(caps)
    return [
        TrafficAnalysis(
            trace_name=t.name,
            baseline_traffic=float(row[0]),
            sweep={c: float(v) for c, v in zip(caps, row)},
        )
        for t, row in zip(traces, mat)
    ]
