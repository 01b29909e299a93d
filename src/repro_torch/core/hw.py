"""Hardware descriptions: the COPA-GPU study's and the port's H100 target.

The paper's tables (Tables I, II, IV: ``LinkSpec``, ``GpuSpec``, V100, A100,
GPU-N, P100 and the UHB links) are copied from the JAX reference package's
``core/hw.py`` as they are; the analytic COPA model reads them.

``ChipSpec`` describes one accelerator for the dry-run's three-term
roofline (``core/roofline``) and the capacity rule of ``core/msm``.
``H100_SXM`` holds the peaks of one NVIDIA H100 SXM5 80GB from NVIDIA's
public H100 Tensor Core GPU datasheet: dense BF16 tensor-core rate 989
TFLOP/s (the sheet's 1,979 is with 2:4 sparsity), FP32 67 TFLOP/s, 80 GB
of HBM3 at 3.35 TB/s, 132 SMs, 50 MB of L2. The collective term's link is
one 400 Gb/s NDR InfiniBand port per GPU (50 GB/s a direction), as a DGX
H100 node has one per GPU: the reference's 256- and 512-device meshes span
nodes of 8 GPUs, so a "model" axis of 16 crosses a node boundary, and
NVLink 4's 450 GB/s a direction holds only inside a node.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

KB = 1024
MB = 1024 * KB
GB = 1024 * MB
TB = 1024 * GB

# Throughputs use decimal units as in vendor datasheets.
GBPS = 1e9
TBPS = 1e12
TFLOPS = 1e12


@dataclass(frozen=True)
class LinkSpec:
    """An on-package UHB link (paper Table II) or an off-chip interconnect."""

    name: str
    bandwidth: float            # bytes/s, unidirectional unless noted
    energy_pj_per_bit: float    # pJ/b
    # Paper: 2.5D = 256 GB/s/mm edge density, 3D = 512 GB/s/mm^2 areal density.
    density: float = 0.0
    density_unit: str = ""

    def energy_joules(self, num_bytes: float) -> float:
        return num_bytes * 8.0 * self.energy_pj_per_bit * 1e-12


@dataclass(frozen=True)
class GpuSpec:
    """A converged-GPU (or GPM) compute+memory description (paper Table IV).

    ``l3_capacity``/``l3_bandwidth`` are zero for monolithic designs; COPA
    variants are built by ``repro.core.copa`` layering an MSM on top of a GPM.
    """

    name: str
    num_sms: int
    frequency_ghz: float
    fp32_tflops: float
    fp16_tflops: float
    l2_capacity: int            # bytes
    dram_bandwidth: float       # bytes/s
    dram_capacity: int          # bytes
    # L2 is the bandwidth filter in front of everything (GPM-internal).
    # Aggregate L2 bandwidth on modern GPUs is ~10x DRAM bandwidth.
    l2_bandwidth_ratio: float = 10.0
    # Memory-side L3 (MSM) — zero when absent.
    l3_capacity: int = 0
    l3_bandwidth: float = 0.0   # post-L2 UHB link bandwidth (per direction RD/WR)
    l3_energy_pj_per_bit: float = 0.0
    # DRAM access energy, used by the §III-D energy model. The paper states a
    # COPA L3 hit costs ~4x less than HBM access.
    dram_energy_pj_per_bit: float = 7.0
    max_threads_per_sm: int = 2048

    @property
    def l2_bandwidth(self) -> float:
        return self.dram_bandwidth * self.l2_bandwidth_ratio

    @property
    def llc_capacity(self) -> int:
        """Last-level cache the DRAM sees: L3 when present, else L2."""
        return self.l3_capacity if self.l3_capacity else self.l2_capacity

    @property
    def concurrency(self) -> int:
        return self.num_sms * self.max_threads_per_sm

    def with_(self, **kw) -> "GpuSpec":
        return dataclasses.replace(self, **kw)


# --- Paper Table IV configurations -----------------------------------------

V100 = GpuSpec(
    name="V100", num_sms=80, frequency_ghz=1.4, fp32_tflops=15.7,
    fp16_tflops=125.0, l2_capacity=6 * MB, dram_bandwidth=900 * GBPS,
    dram_capacity=16 * GB,
)

A100 = GpuSpec(
    name="A100", num_sms=108, frequency_ghz=1.4, fp32_tflops=19.5,
    fp16_tflops=312.0, l2_capacity=40 * MB, dram_bandwidth=1555 * GBPS,
    dram_capacity=40 * GB,
)

# The paper's forward projection ("GPU-N", Tables I/IV).
GPU_N = GpuSpec(
    name="GPU-N", num_sms=134, frequency_ghz=1.4, fp32_tflops=24.2,
    fp16_tflops=779.0, l2_capacity=60 * MB, dram_bandwidth=2687 * GBPS,
    dram_capacity=100 * GB,
)

P100 = GpuSpec(
    name="P100", num_sms=56, frequency_ghz=1.3, fp32_tflops=11.0,
    fp16_tflops=21.0, l2_capacity=4 * MB, dram_bandwidth=732 * GBPS,
    dram_capacity=16 * GB,
)

# --- Paper Table II link technologies ---------------------------------------

UHB_2_5D = LinkSpec(
    name="UHB-2.5D", bandwidth=14.7 * TBPS, energy_pj_per_bit=0.3,
    density=256 * GBPS, density_unit="GB/s/mm",
)
UHB_3D = LinkSpec(
    name="UHB-3D", bandwidth=14.7 * TBPS, energy_pj_per_bit=0.05,
    density=512 * GBPS, density_unit="GB/s/mm^2",
)


# --- the port's target: one NVIDIA H100 SXM -----------------------------------

@dataclass(frozen=True)
class ChipSpec:
    """Per-chip description used by the roofline analysis."""

    name: str
    bf16_tflops: float          # peak dense tensor-core throughput
    fp32_tflops: float          # peak non-tensor fp32 throughput
    hbm_bandwidth: float        # bytes/s
    hbm_capacity: int           # bytes
    link_bandwidth: float       # bytes/s a direction, the collective term's link
    num_sms: int
    l2_capacity: int            # bytes

    @property
    def flops_per_byte_hbm(self) -> float:
        return self.bf16_tflops * TFLOPS / self.hbm_bandwidth


# NVIDIA H100 Tensor Core GPU datasheet, SXM5 80GB column (dense rates).
H100_SXM = ChipSpec(
    name="H100-SXM5-80GB", bf16_tflops=989.0, fp32_tflops=67.0,
    hbm_bandwidth=3.35 * TBPS, hbm_capacity=80 * 10**9,
    link_bandwidth=50 * GBPS, num_sms=132, l2_capacity=50 * MB,
)
