"""FPGA resource + frequency model for XtraMAC and the paper's baselines
(copy of ``repro/core/resource_model.py`` over the port's ``formats``,
``mac`` and ``packing``; host-side numpy, no tensors).

Two layers:
  1. **Measured tables** — the paper's post-synthesis numbers (Tables III,
     IV, V; Figs. 8, 10, 12) encoded verbatim.  These drive the
     paper-reproduction benchmarks and the reference's analytical
     end-to-end simulator (perfmodel/), so every downstream number is
     traceable to the paper.
  2. **Parametric model** — Eqs. (7)/(8): integer adders cost alpha*w
     (carry chain), FP align/normalize shifters cost beta*w*log2(w)
     (barrel shifter), plus mapping/post-compute terms.  Coefficients are
     calibrated against the measured tables by least squares at import
     time; the model extrapolates to datatype combinations the paper did
     not synthesize, with the calibration quality reported by benchmarks.

Units: LUTs / FFs / DSP slices on an AMD UltraScale+ device (U55c / V80).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .formats import FloatFormat, IntFormat, get_format
from .mac import MacConfig
from .packing import solve_lane_plan


@dataclasses.dataclass(frozen=True)
class Resources:
    lut: float
    ff: float
    dsp: float

    def __add__(self, o: "Resources") -> "Resources":
        return Resources(self.lut + o.lut, self.ff + o.ff, self.dsp + o.dsp)

    def scale(self, k: float) -> "Resources":
        return Resources(self.lut * k, self.ff * k, self.dsp * k)


# ---------------------------------------------------------------------------
# Measured tables (verbatim from the paper)
# ---------------------------------------------------------------------------
# Table III: runtime-switching XtraMAC instances (core datapath).
TABLE_III: Dict[str, Resources] = {
    "I:int4xbf16+bf16": Resources(436, 302, 1),    # Qwen3-8B-AWQ
    "II:int8xint8+int32|bf16": Resources(568, 513, 1),  # Llama-3.1-8B-W8A8
    "III:fp8xfp8+bf16|bf16": Resources(948, 622, 1),    # Qwen3/Llama FP8
    "IV:fp4xbf16+bf16|bf16": Resources(395, 274, 1),    # GPT-oss-20B
}

# Table IV: per-lane resource utilization, single-config instances with AXI
# wrapper.  key = (fmt_a, fmt_bcp);  value = (vendor IP, XtraMAC per lane).
TABLE_IV: Dict[Tuple[str, str], Tuple[Resources, Resources]] = {
    ("int8", "bf16"): (Resources(331, 222, 1), Resources(235, 124, 0.5)),
    ("int8", "fp16"): (Resources(387, 262, 1), Resources(270, 137, 0.5)),
    ("fp4_e2m1", "bf16"): (Resources(301, 226, 1), Resources(196, 115, 0.5)),
    ("fp4_e2m1", "fp16"): (Resources(357, 266, 1), Resources(251, 131, 0.5)),
    ("fp8_e4m3", "bf16"): (Resources(301, 226, 1), Resources(219, 123, 0.5)),
    ("fp8_e4m3", "fp16"): (Resources(357, 266, 1), Resources(253, 133, 0.5)),
}

# Table V: per-operation resources under INT8<->BF16 runtime switching.
TABLE_V: Dict[str, Dict[str, Resources]] = {
    "vendor": {"bf16": Resources(220.0, 310.5, 1), "int8": Resources(110.0, 155.3, 0.5)},
    "tataa": {"bf16": Resources(352.0, 467.0, 4), "int8": Resources(22.0, 29.2, 0.25)},
    "xtramac": {"bf16": Resources(142.0, 128.3, 0.25), "int8": Resources(142.0, 128.3, 0.25)},
}

# Paper-claimed average reductions vs vendor IP (Section V-E1).
PAPER_MEAN_REDUCTION = {"lut": 0.300, "ff": 0.479, "dsp": 0.500}

# Fig. 8: fmax (MHz) as datatype support is scaled up, single DSP instance.
FMAX_SCALING_MHZ: Dict[int, float] = {1: 483.0, 2: 476.0, 3: 469.0, 4: 462.0}
FMAX_VENDOR_RATIO = 0.78          # Fig. 10: XtraMAC ~22% slower on average
FMAX_FLOOR_MHZ = 400.0            # all configurations exceed 400 MHz

# Fig. 12: GEMV system frequency vs #XtraMAC instances (post-P&R).
def system_fmax_mhz(n_instances: int) -> float:
    if n_instances <= 1024:
        return 300.0
    # moderate degradation toward 1920 instances (routing congestion)
    frac = min(1.0, (n_instances - 1024) / (1920 - 1024))
    return 300.0 - frac * (300.0 - 260.0)


def fmax_mhz(n_datatypes: int) -> float:
    n = max(1, min(4, n_datatypes))
    return FMAX_SCALING_MHZ[n]


# ---------------------------------------------------------------------------
# Parametric model — Eqs. (7) and (8)
# ---------------------------------------------------------------------------
def int_adder_cost(w_int: int, alpha: float) -> float:
    """Eq. (7): C_int ~= alpha * w (ripple-carry chain)."""
    return alpha * w_int


def barrel_shifter_muxes(w_fp: int) -> float:
    """N_MUX = w * log2(w) (Pillmeier et al.)."""
    w = max(2, w_fp)
    return w * math.log2(w)


def fp_shifter_cost(w_fp: int, beta: float) -> float:
    """Eq. (8): C_shifter ~= beta * w * log2(w)."""
    return beta * barrel_shifter_muxes(w_fp)


@dataclasses.dataclass
class _InstanceStructure:
    """Structural decomposition of an XtraMAC instance for the model."""
    map_fp_bits: float      # format bits decoded by FP mapping submodules
    map_int_bits: float     # format bits decoded by INT mapping submodules
    post_fp_muxes: float    # LZC + normalize shifter muxes, all FP lanes
    adder_fp_muxes: float   # align+normalize shifter muxes, FP adder lanes
    adder_int_bits: float   # integer adder bits
    n_dtypes: int


def _mapping_shared(c1: MacConfig, c2: MacConfig, p1: int, p2: int) -> bool:
    """Config-IV rule: A-formats embeddable (zero-pad, no rounding) + same P."""
    f1, f2 = c1.fmt_a, c2.fmt_a
    if not (isinstance(f1, FloatFormat) and isinstance(f2, FloatFormat)):
        return False
    lo, hi = (f1, f2) if f1.bits <= f2.bits else (f2, f1)
    embeddable = (lo.man_bits <= hi.man_bits
                  and lo.max_unbiased_exp <= hi.max_unbiased_exp
                  and lo.min_unbiased_exp >= hi.min_unbiased_exp)
    return embeddable and p1 == p2 and c1.fmt_b.name == c2.fmt_b.name


def analyze_instance(configs: Sequence[MacConfig], max_parallelism: int = 4) -> _InstanceStructure:
    plans = [solve_lane_plan(c.fmt_a, c.fmt_b, max_parallelism=max_parallelism)
             for c in configs]
    # mapping: per config unless shared under the Config-IV rule
    map_fp_bits = map_int_bits = 0.0
    counted = [False] * len(configs)
    for i, (c, p) in enumerate(zip(configs, plans)):
        if counted[i]:
            continue
        for j in range(i + 1, len(configs)):
            if not counted[j] and _mapping_shared(c, configs[j], p.parallelism,
                                                  plans[j].parallelism):
                counted[j] = True  # folded into this mapping submodule
        bits = (c.fmt_a.bits * len(p.offsets_a) + c.fmt_b.bits * len(p.offsets_b))
        if isinstance(c.fmt_a, IntFormat) or isinstance(c.fmt_b, IntFormat):
            map_int_bits += bits
        else:
            map_fp_bits += bits
        counted[i] = True

    # post-compute: LZC + normalization shifter per FP lane (product width)
    post = 0.0
    for c, p in zip(configs, plans):
        if not c.is_int_accumulate:
            post += p.parallelism * barrel_shifter_muxes(p.w_lane)
    # decoupled accumulators, shared across configs with identical output fmt:
    # lane count = max over sharing configs (Config-III rule)
    fp_muxes = 0.0
    int_bits = 0.0
    fp_groups: Dict[str, int] = {}
    for c, p in zip(configs, plans):
        if c.is_int_accumulate:
            int_bits = max(int_bits, 0) + 0  # accumulate below
        else:
            key = c.fmt_p.name
            fp_groups[key] = max(fp_groups.get(key, 0), p.parallelism)
    for c, p in zip(configs, plans):
        if c.is_int_accumulate:
            int_bits += c.fmt_p.bits * p.parallelism
    for fmt_name, lanes in fp_groups.items():
        fmt = get_format(fmt_name)
        # align + normalize shifters over the extended mantissa width
        fp_muxes += lanes * 2 * barrel_shifter_muxes(fmt.man_bits + 4)
    return _InstanceStructure(map_fp_bits, map_int_bits, post, fp_muxes,
                              int_bits, len(configs))


def _nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Non-negative least squares via backward elimination (cost terms are
    physical resource counts — negative coefficients are meaningless and,
    with only 4 calibration rows, plain lstsq is underdetermined)."""
    active = list(range(A.shape[1]))
    coef = np.zeros(A.shape[1])
    while active:
        c, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if (c >= -1e-9).all():
            coef[:] = 0.0
            for idx, v in zip(active, c):
                coef[idx] = max(v, 0.0)
            return coef
        active.pop(int(np.argmin(c)))
    return coef


# least-squares calibration of [c_map_fp, c_map_int, c_post, beta, alpha, c0]
def _calibrate() -> Tuple[np.ndarray, np.ndarray, float]:
    rows: List[List[float]] = []
    lut_t: List[float] = []
    ff_t: List[float] = []
    cases: List[List[MacConfig]] = [
        [MacConfig.make("int4", "bf16", "bf16", "bf16"),
         MacConfig.make("bf16", "bf16", "bf16", "bf16")],
        [MacConfig.make("int8", "int8", "int32", "int32"),
         MacConfig.make("bf16", "bf16", "bf16", "bf16")],
        [MacConfig.make("fp8_e4m3", "fp8_e4m3", "bf16", "bf16"),
         MacConfig.make("bf16", "bf16", "bf16", "bf16")],
        [MacConfig.make("fp4_e2m1", "bf16", "bf16", "bf16"),
         MacConfig.make("bf16", "bf16", "bf16", "bf16")],
    ]
    targets = list(TABLE_III.values())
    for cfgs, res in zip(cases, targets):
        s = analyze_instance(cfgs)
        rows.append([s.map_fp_bits, s.map_int_bits, s.post_fp_muxes,
                     s.adder_fp_muxes, s.adder_int_bits, 1.0])
        lut_t.append(res.lut)
        ff_t.append(res.ff)
    A = np.asarray(rows)
    lut_coef = _nnls(A, np.asarray(lut_t))
    ff_coef = _nnls(A, np.asarray(ff_t))
    pred = A @ lut_coef
    denom = float(np.sum((np.asarray(lut_t) - np.mean(lut_t)) ** 2))
    r2 = 1.0 - float(np.sum((pred - lut_t) ** 2)) / denom if denom else 1.0
    return lut_coef, ff_coef, r2


_LUT_COEF, _FF_COEF, CALIBRATION_R2 = _calibrate()


def estimate_instance(configs: Sequence[MacConfig], max_parallelism: int = 4) -> Resources:
    """Parametric LUT/FF/DSP estimate for an arbitrary XtraMAC instance."""
    s = analyze_instance(configs, max_parallelism)
    x = np.asarray([s.map_fp_bits, s.map_int_bits, s.post_fp_muxes,
                    s.adder_fp_muxes, s.adder_int_bits, 1.0])
    return Resources(float(x @ _LUT_COEF), float(x @ _FF_COEF), 1.0)


def xtramac_per_lane(fmt_a: str, fmt_bcp: str) -> Resources:
    """Per-lane XtraMAC cost: measured (Table IV) if available, else model."""
    key = ("int8" if fmt_a.startswith("int") else fmt_a, fmt_bcp)
    if key in TABLE_IV:
        return TABLE_IV[key][1]
    cfg = MacConfig.make(fmt_a, fmt_bcp, fmt_bcp, fmt_bcp)
    plan = solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
    est = estimate_instance([cfg])
    return est.scale(1.0 / plan.parallelism)


def vendor_per_lane(fmt_a: str, fmt_bcp: str) -> Resources:
    key = ("int8" if fmt_a.startswith("int") else fmt_a, fmt_bcp)
    if key in TABLE_IV:
        return TABLE_IV[key][0]
    # vendor IP: fixed high-precision datapath, one lane per instance
    return Resources(331, 222, 1) if fmt_bcp == "bf16" else Resources(387, 262, 1)


def compute_density(fmt_a: str, fmt_bcp: str) -> Dict[str, float]:
    """Table IV 'Comp.Den.' column: vendor / XtraMAC per-op resources."""
    v, x = vendor_per_lane(fmt_a, fmt_bcp), xtramac_per_lane(fmt_a, fmt_bcp)
    return {"lut": v.lut / x.lut, "ff": v.ff / x.ff, "dsp": v.dsp / x.dsp}
