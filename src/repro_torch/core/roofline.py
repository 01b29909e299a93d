"""Three-term roofline analysis from the dry-run's counts.

Per (architecture x shape x mesh):

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The peaks are one NVIDIA H100 SXM's (``core.hw.H100_SXM``): the compute
term on its dense bf16 rate, the memory term on its HBM rate, the
collective term on its one NDR InfiniBand port. ``launch/dryrun`` counts,
over one step run as rank 0 of a fake process group on ``meta`` tensors,
the FLOPs and the bytes of rank 0's local ops' inputs and outputs (eager,
unfused) and the bytes of the collectives they issue; all three are per
device. ``hlo_flops``/``hlo_bytes`` keep the reference's field names
(there, XLA's per-partition cost analysis). The dominant term is the
bottleneck a performance PR iterates on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.hw import H100_SXM, ChipSpec


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per-device FLOPs of one step
    hlo_bytes: float            # per-device HBM bytes accessed
    collective_bytes: float     # per-device bytes crossing the link
    model_flops: float          # 6*N*D useful-model FLOPs (global)
    peak_memory_bytes: float = 0.0
    collective_breakdown: dict = field(default_factory=dict)
    spec: ChipSpec = H100_SXM

    # -- the three terms, in seconds -------------------------------------------
    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.spec.bf16_tflops * 1e12)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.spec.hbm_bandwidth

    @property
    def collective_s(self) -> float:
        # Bytes leave a chip over its network link; a ring collective streams
        # over one link at a time, so the conservative bound uses one link.
        return self.collective_bytes / self.spec.link_bandwidth

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step achieves if it runs exactly at the max
        term (the overlap-perfect bound): useful-FLOPs utilization."""
        if self.bound_s <= 0:
            return 0.0
        per_dev_model_flops = self.model_flops / max(self.chips, 1)
        return per_dev_model_flops / (self.bound_s * self.spec.bf16_tflops * 1e12)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the counted compute is
        useful (catches remat/redundancy waste). >1 means the count misses
        work; <1 means recompute, padding or the full score square of the
        plain attention."""
        total_hlo = self.hlo_flops * max(self.chips, 1)
        return self.model_flops / total_hlo if total_hlo else float("nan")

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_fraction": self.roofline_fraction,
            "model_flops_ratio": self.model_flops_ratio,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def model_flops_lm(n_params_active: float, tokens: float, training: bool) -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for a pure forward/decode step."""
    return (6.0 if training else 2.0) * n_params_active * tokens


def useful_flops_cell(cfg, shape) -> float:
    """Useful model FLOPs for one step of an (arch x shape) cell: the
    parameter term (6ND / 2ND) PLUS the sequence-mixing term, which at 32k+
    dominates and which 6ND ignores (attention: 4*B*H*S^2*hd per layer with
    causal halving; SSD: linear in S). Recompute (remat/flash-bwd) is
    deliberately excluded — that is what model_flops_ratio exposes."""
    training = shape.step == "train"
    fwd_bwd = 3.0 if training else 1.0
    gb, s = shape.global_batch, shape.seq_len
    tokens = gb * (1 if shape.step == "decode" else s)
    total = (2.0 * fwd_bwd) * cfg.n_active_params() * tokens

    def attn_flops(n_layers, s_q, s_kv, causal):
        hd = cfg.head_dim + (cfg.rope_head_dim if cfg.use_mla else 0)
        per_layer = 2.0 * 2.0 * gb * cfg.n_heads * s_q * s_kv * hd
        if causal and s_q == s_kv:
            per_layer *= 0.5
        return n_layers * per_layer * fwd_bwd

    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        if shape.step == "decode":
            total += attn_flops(cfg.n_layers, 1, s, causal=False)
        else:
            total += attn_flops(cfg.n_layers, s, s, causal=True)
    elif fam == "ssm":
        di = cfg.d_inner
        total += (2.0 * 2.0 * gb * (1 if shape.step == "decode" else s)
                  * di * cfg.ssm_state * fwd_bwd * cfg.n_layers)
    elif fam == "hybrid":
        di = cfg.d_inner
        steps = 1 if shape.step == "decode" else s
        total += (2.0 * 2.0 * gb * steps * di * cfg.ssm_state * fwd_bwd
                  * cfg.n_layers)
        n_attn = cfg.n_layers // max(cfg.attn_every, 1)
        if shape.step == "decode":
            total += attn_flops(n_attn, 1, s, causal=False)
        else:
            total += attn_flops(n_attn, s, s, causal=True)
    elif fam == "audio":
        if shape.step == "decode":
            total += attn_flops(cfg.n_layers, 1, s, causal=False)
        else:
            total += attn_flops(cfg.n_encoder_layers, s, s, causal=False)
            total += attn_flops(cfg.n_layers, s // 4, s // 4, causal=True)
            total += attn_flops(cfg.n_layers, s // 4, s, causal=False)
    return total


def format_table(reports: list[RooflineReport]) -> str:
    hdr = (
        f"{'arch':24s} {'shape':12s} {'mesh':10s} {'compute_s':>11s} {'memory_s':>11s} "
        f"{'collect_s':>11s} {'dominant':>10s} {'roofline%':>10s} {'useful%':>8s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        ratio = r.model_flops_ratio
        ratio_s = f"{100*min(ratio, 9.99):7.1f}%" if ratio == ratio else "      —"
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.mesh:10s} {r.compute_s:11.4e} {r.memory_s:11.4e} "
            f"{r.collective_s:11.4e} {r.dominant:>10s} {100*r.roofline_fraction:9.1f}% "
            f"{ratio_s}"
        )
    return "\n".join(lines)
