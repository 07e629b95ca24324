"""Tile-based GEMV engine model (paper Section VI-A / VI-C, Figs. 11-13);
copy of ``repro/core/gemv_engine.py`` (host-side, no tensors).

Models the XtraMAC-based GEMV accelerator on the U55c:
  * M tiles, one per HBM channel; weights stream from HBM, activations are
    buffered on chip; each channel feeds a chain of cascaded XtraMAC
    instances:   N_MAC = channel_bits / (w_bits * P)          (Section VI-C)
  * latency = max(memory phase, compute phase) under the streaming model —
    the kernel is bandwidth-bound at scale (the paper measures ~74%
    effective HBM utilization).

`table_vii()` reproduces the paper's Table VII FPGA rows from first
principles (bytes / effective bandwidth); the H100 rows are the paper's
measurements (a GPU measurement cannot be derived from this model) and are
carried as constants for the speedup / energy-efficiency ratios.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .resource_model import Resources, system_fmax_mhz


@dataclasses.dataclass(frozen=True)
class GemvEngineConfig:
    n_channels: int = 30              # 30 active of 32 (1 act read, 1 writeback)
    channel_bits: int = 512
    hbm_bw_gbps: float = 460.0        # U55c peak
    hbm_utilization: float = 0.74     # paper-measured effective utilization
    weight_bits: int = 4              # INT4 / FP4 weights
    parallelism: int = 2              # P lanes per XtraMAC
    power_w: float = 85.0             # xbutil steady-state (paper)

    @property
    def n_mac_per_channel(self) -> int:
        return self.channel_bits // (self.weight_bits * self.parallelism)

    @property
    def n_instances(self) -> int:
        return self.n_channels * self.n_mac_per_channel

    @property
    def freq_hz(self) -> float:
        return system_fmax_mhz(self.n_instances) * 1e6

    @property
    def macs_per_cycle(self) -> int:
        return self.n_instances * self.parallelism


def gemv_latency_s(cfg: GemvEngineConfig, m: int, k: int, n: int) -> Dict[str, float]:
    """Latency of an m x k x n GEMV/GEMM-like workload (m = batch rows).

    Weight matrix is k x n in ``weight_bits`` precision, streamed once;
    activations (m x k, BF16) are on-chip.  Returns the phase breakdown.
    """
    weight_bytes = k * n * cfg.weight_bits / 8.0
    t_mem = weight_bytes / (cfg.hbm_bw_gbps * 1e9 * cfg.hbm_utilization)
    macs = m * k * n
    t_compute = macs / (cfg.macs_per_cycle * cfg.freq_hz)
    t = max(t_mem, t_compute)
    return {
        "time_s": t,
        "t_mem_s": t_mem,
        "t_compute_s": t_compute,
        "bound": "memory" if t_mem >= t_compute else "compute",
        "energy_j": t * cfg.power_w,
        "weight_bytes": weight_bytes,
    }


# Paper Table VII: H100 CUTLASS measurements (constants; not modelable here).
H100_MEASURED = {
    (1, 4096, 4096): {"time_s": 0.0294e-3, "power_w": 135.0},
    (1, 4096, 12288): {"time_s": 0.0879e-3, "power_w": 135.0},
}
PAPER_FPGA_MEASURED = {
    (1, 4096, 4096): 0.0246e-3,
    (1, 4096, 12288): 0.0743e-3,
}


def table_vii(cfg: GemvEngineConfig = GemvEngineConfig()) -> Dict:
    """Reproduce Table VII: model-predicted FPGA latency vs H100 baseline."""
    rows = {}
    for shape, h100 in H100_MEASURED.items():
        ours = gemv_latency_s(cfg, *shape)
        h100_e = h100["time_s"] * h100["power_w"]
        rows[shape] = {
            "xtramac_time_s": ours["time_s"],
            "xtramac_paper_time_s": PAPER_FPGA_MEASURED[shape],
            "model_vs_paper": ours["time_s"] / PAPER_FPGA_MEASURED[shape],
            "h100_time_s": h100["time_s"],
            "speedup": h100["time_s"] / ours["time_s"],
            "energy_eff": h100_e / ours["energy_j"],
            "bound": ours["bound"],
        }
    return rows


def resource_scaling(per_instance: Resources, n_instances: int) -> Resources:
    """Fig. 12: LUT/FF/DSP scale linearly with instantiated XtraMACs."""
    return per_instance.scale(n_instances)
