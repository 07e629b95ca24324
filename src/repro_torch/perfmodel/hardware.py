"""FPGA profiles of the analytical performance model (copy of the FPGA
half of ``repro/perfmodel/hardware.py``): the paper's boards, §V / §VI-D."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPGAProfile:
    name: str
    luts: int
    ffs: int
    dsps: int
    freq_mhz: float
    hbm_gbps: float
    power_w: float
    usable_fraction: float = 0.8   # P&R headroom (routing, shell)


# paper §VI-D: AMD Alveo V80 (2.6M LUTs, 10,848 DSPs, 300 MHz, 810 GB/s HBM)
V80 = FPGAProfile("V80", luts=2_600_000, ffs=5_200_000, dsps=10_848,
                  freq_mhz=300.0, hbm_gbps=810.0, power_w=190.0)
# paper §V / §VI-C: Alveo U55c (32 HBM channels, 460 GB/s)
U55C = FPGAProfile("U55c", luts=1_304_000, ffs=2_607_000, dsps=9_024,
                   freq_mhz=300.0, hbm_gbps=460.0, power_w=85.0)
