"""The paper's analytic decode-latency model (copy of ``repro/perfmodel``;
host-side, no tensors): FPGA profiles and the two-phase streaming cost
model the serving policy (``serve/slo.py``) prices its decisions with.
Its seconds are the paper's V80 FPGA model, not a measurement of any
card."""
from .analytical import (decode_latency, gemv_engine_for,  # noqa: F401
                         mac_distribution, mac_unit_budget,
                         spec_round_latency)
from .hardware import U55C, V80, FPGAProfile  # noqa: F401
