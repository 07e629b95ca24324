"""XtraMAC core — the paper's contribution as a composable library (torch
twin of ``repro.core``).

Layers:
  formats         datatype registry + bit codecs (INT2-8, FP4/FP8/FP16/BF16)
  mac             unified mantissa-product MAC datapath (bit-exact, 4 stages)
  ref_mac         exact unbounded-integer oracle
  packing         DSP bit-space lane packing (Eqs. 9-12) + stride solver;
                  its Stage-2 multiply is the CUDA kernel K6 on the card
  pipeline        cycle-level 4-stage pipeline emulator (II=1, runtime switch)
  resource_model  LUT/FF/DSP + fmax model (Eqs. 7-8, paper tables)
  gemv_engine     tile-based GEMV engine model (Section VI)
"""
from .formats import REGISTRY, get_format, quantize_f64  # noqa: F401
from .mac import MacConfig, xtramac, xtramac_switching  # noqa: F401
from .packing import (  # noqa: F401
    PAPER_PARALLELISM, LanePlan, packed_multiply, solve_lane_plan, xtramac_packed,
)
from .pipeline import Op, XtraMACPipeline  # noqa: F401
from .ref_mac import mac_exact, mac_exact_vec  # noqa: F401
