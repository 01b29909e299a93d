"""The COPA-GPU design space (paper §III, Table V) and its energy model.

A COPA config = a GPM (compute module, identical across all variants — that
is the whole point of composability) + an MSM choice (memory-side L3 and/or
extra HBM sites). ``build()`` materializes a :class:`~repro_torch.core.hw.GpuSpec`
the perf model can consume.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core import hw
from repro_torch.core.hw import MB, GpuSpec, LinkSpec

# Paper §IV-D: UHB link set to 2x RD + 2x WR of *half* the baseline DRAM BW
# each direction: total 10.8 TB/s for GPU-N's 2.7 TB/s DRAM.
def uhb_bandwidth_for(dram_bandwidth: float, scale: float = 2.0) -> float:
    """Per-direction UHB bandwidth given the paper's NxRD+NxWR convention."""
    return scale * dram_bandwidth


@dataclass(frozen=True)
class MsmSpec:
    """A Memory System Module: what the 2.5D/3D package composes onto the GPM."""

    name: str
    l3_capacity: int                 # bytes; 0 = no L3 (HPC variant)
    dram_bandwidth_scale: float      # vs the GPM baseline DRAM BW
    dram_capacity_scale: float
    integration: str = "2.5D"        # "2.5D" | "3D" | "none"
    uhb_scale: float = 2.0           # per-direction UHB = scale x DRAM BW

    @property
    def link(self) -> LinkSpec:
        return hw.UHB_3D if self.integration == "3D" else hw.UHB_2_5D


# --- Paper Table V -----------------------------------------------------------
# name                  LLC        DRAM BW   DRAM cap
# GPU-N                 60MB(L2)   2.7TB/s   100GB
# HBM+L3                960MB      2.7TB/s   100GB
# HBML+L3               960MB      4.5TB/s   167GB
# HBM+L3L               1920MB     2.7TB/s   100GB
# HBML+L3L              1920MB     4.5TB/s   167GB
# HBMLL+L3L             1920MB     6.3TB/s   233GB
# Perfect L2            inf        inf       inf

MSM_NONE = MsmSpec("baseline", 0, 1.0, 1.0, integration="none")
MSM_L3 = MsmSpec("L3", 960 * MB, 1.0, 1.0, integration="3D")
MSM_HBML_L3 = MsmSpec("HBML+L3", 960 * MB, 4500.0 / 2687.0, 1.67)
MSM_L3L = MsmSpec("L3L", 1920 * MB, 1.0, 1.0)
MSM_HBML_L3L = MsmSpec("HBML+L3L", 1920 * MB, 4500.0 / 2687.0, 1.67)
MSM_HBMLL_L3L = MsmSpec("HBMLL+L3L", 1920 * MB, 6300.0 / 2687.0, 2.33)


@dataclass(frozen=True)
class CopaConfig:
    name: str
    gpm: GpuSpec = field(default_factory=lambda: hw.GPU_N)
    msm: MsmSpec = MSM_NONE
    perfect_llc: bool = False   # the paper's "Perfect L2" upper bound

    def build(self) -> GpuSpec:
        """Compose GPM + MSM into a flat GpuSpec for the perf model."""
        g = self.gpm
        if self.perfect_llc:
            # Infinite LLC and DRAM: modelled as enormous-but-finite values so
            # arithmetic stays well defined.
            return g.with_(
                name=f"{g.name}/PerfectL2",
                l2_capacity=1 << 50,
                dram_bandwidth=1e18,
            )
        if self.msm.integration == "none":
            return g
        dram_bw = g.dram_bandwidth * self.msm.dram_bandwidth_scale
        return g.with_(
            name=f"{g.name}/{self.name}",
            l3_capacity=self.msm.l3_capacity,
            # Paper §IV-D: UHB fixed at 2xRD+2xWR of the *baseline* DRAM BW.
            l3_bandwidth=uhb_bandwidth_for(g.dram_bandwidth, self.msm.uhb_scale),
            l3_energy_pj_per_bit=self.msm.link.energy_pj_per_bit,
            dram_bandwidth=dram_bw,
            dram_capacity=int(g.dram_capacity * self.msm.dram_capacity_scale),
        )


GPU_N_BASE = CopaConfig("GPU-N")
HBM_L3 = CopaConfig("HBM+L3", msm=MSM_L3)
HBML_L3 = CopaConfig("HBML+L3", msm=MSM_HBML_L3)
HBM_L3L = CopaConfig("HBM+L3L", msm=MSM_L3L)
HBML_L3L = CopaConfig("HBML+L3L", msm=MSM_HBML_L3L)
HBMLL_L3L = CopaConfig("HBMLL+L3L", msm=MSM_HBMLL_L3L)
PERFECT_L2 = CopaConfig("PerfectL2", perfect_llc=True)

TABLE_V = [GPU_N_BASE, HBM_L3, HBML_L3, HBM_L3L, HBML_L3L, HBMLL_L3L, PERFECT_L2]
TABLE_V_BY_NAME = {c.name: c for c in TABLE_V}


# --- Energy model (paper §III-D) ---------------------------------------------

@dataclass(frozen=True)
class EnergyReport:
    dram_bytes: float
    l3_bytes: float
    dram_joules: float
    l3_joules: float

    @property
    def total_joules(self) -> float:
        return self.dram_joules + self.l3_joules


def memory_energy(spec: GpuSpec, dram_bytes: float, l3_bytes: float) -> EnergyReport:
    """HBM-related energy. Paper: an L3 fetch costs ~4x less than HBM."""
    dram_j = dram_bytes * 8.0 * spec.dram_energy_pj_per_bit * 1e-12
    # L3 hit energy = link traversal + SRAM subarray; paper folds this into
    # "~4x less than HBM".
    l3_pj_per_bit = spec.dram_energy_pj_per_bit / 4.0
    l3_j = l3_bytes * 8.0 * l3_pj_per_bit * 1e-12
    return EnergyReport(dram_bytes, l3_bytes, dram_j, l3_j)
