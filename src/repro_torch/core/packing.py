"""Lane packing in the DSP multiplier bit-space (paper Section III-C); torch
twin of ``repro/core/packing.py``.

Implements Eqs. (9)-(12):

  A_DSP = sum_i a_i << s_i         B_DSP = sum_j b_j << t_j          (9)
  P_DSP = sum_{i,j} (a_i b_j) << (s_i + t_j)                        (10)
  P_ij  = (P_DSP >> (s_i + t_j)) & (2^S - 1)                        (11)
  S >= W_lane + G;  per-port lane bound from L_A=27, L_B=18         (12)

``solve_lane_plan`` searches placements of mantissa lanes on the two DSP
ports such that every wanted product lands at an isolated bit position,
maximizing the number of parallel MAC lanes; the constants and the search
order are the reference's, verbatim.  The uncapped solver finds 8 lanes for
FP4xFP4 and 4 for INT2xBF16, more than ``SOLVER_BEYOND_PAPER`` records (6
and 3): that dict is a lower bound, kept as the reference has it.

``packed_multiply`` is Stage 2 of ``xtramac_packed``: on CUDA tensors it
launches the virtual-DSP kernel K6 (``kernels/xtramac_mac.py``, int64
lanes), on CPU tensors or with ``plain=True`` it runs the plain torch
version, bit for bit the same.  ``xtramac_packed`` must be bit-identical
to ``per_lane_reference`` (one unpacked ``mac.xtramac`` per lane) — the
lane-isolation claim of Eq. (10).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.xtramac_mac import (pack_port,  # noqa: F401
                                             virtual_dsp_multiply_wide,
                                             virtual_dsp_plain)

from . import mac as M
from .formats import Format, IntFormat, as_int64, device_of, get_format

DSP48E2_LA = 27
DSP48E2_LB = 18
DSP48E2_WMUL = DSP48E2_LA + DSP48E2_LB  # 45-bit utilization denominator


def magnitude_bits(fmt: Format) -> int:
    """Effective unsigned magnitude width entering the multiplier."""
    return fmt.magnitude_bits


def max_magnitude(fmt: Format) -> int:
    """Largest unsigned magnitude the mapping stage can emit for ``fmt``."""
    if isinstance(fmt, IntFormat):
        return 1 << (fmt.bits - 1)          # |-2^(b-1)|
    return (1 << fmt.magnitude_bits) - 1    # mantissa incl. implicit bit


@dataclasses.dataclass(frozen=True)
class LanePlan:
    fmt_a: Format
    fmt_b: Format
    w_a: int
    w_b: int
    stride: int                         # S = W_lane + guard
    offsets_a: Tuple[int, ...]          # s_i
    offsets_b: Tuple[int, ...]          # t_j
    guard: int = 1
    l_a: int = DSP48E2_LA
    l_b: int = DSP48E2_LB

    @property
    def w_lane(self) -> int:
        """Max product width: bitlen(max_a * max_b), NOT w_a + w_b — e.g.
        |INT8|max=128 so INT8xFP16 products are 18 bits, not 19."""
        return int(max_magnitude(self.fmt_a) * max_magnitude(self.fmt_b)).bit_length()

    @property
    def lane_positions(self) -> Tuple[Tuple[int, int, int], ...]:
        """(i, j, product bit position) for every lane product."""
        return tuple(
            (i, j, si + tj)
            for i, si in enumerate(self.offsets_a)
            for j, tj in enumerate(self.offsets_b)
        )

    @property
    def parallelism(self) -> int:
        return len(self.offsets_a) * len(self.offsets_b)

    @property
    def dsp_utilization(self) -> float:
        """Operand-bit utilization (Section II-A): per-lane (w_a + w_b),
        summed over lanes.  Reproduces the paper's reference points — e.g.
        2-lane INT8 gives (8+8)*2/45 = 71.1%, TATAA's own INT8 figure."""
        return self.parallelism * (self.w_a + self.w_b) / DSP48E2_WMUL

    def validate(self) -> None:
        assert max(self.offsets_a) + self.w_a <= self.l_a, "A-port overflow"
        assert max(self.offsets_b) + self.w_b <= self.l_b, "B-port overflow"
        pos = sorted(p for _, _, p in self.lane_positions)
        assert len(set(pos)) == len(pos), "colliding lane positions"
        for p, q in zip(pos, pos[1:]):
            assert q - p >= self.stride, f"lanes at {p},{q} closer than stride {self.stride}"
        assert pos[-1] + self.w_lane <= DSP48E2_WMUL, "product exceeds 45 bits"


def _try_plan(w_a: int, w_b: int, n_a: int, n_b: int, stride: int,
              spread_a: bool, l_a: int, l_b: int, guard: int,
              fmt_a: Format, fmt_b: Format) -> Optional[LanePlan]:
    """Regular-grid placement: one port's lanes step by S, the other by S*n."""
    if spread_a:
        offs_a = tuple(i * stride * n_b for i in range(n_a))
        offs_b = tuple(j * stride for j in range(n_b))
    else:
        offs_a = tuple(i * stride for i in range(n_a))
        offs_b = tuple(j * stride * n_a for j in range(n_b))
    plan = LanePlan(fmt_a, fmt_b, w_a, w_b, stride, offs_a, offs_b,
                    guard=guard, l_a=l_a, l_b=l_b)
    try:
        plan.validate()
    except AssertionError:
        return None
    return plan


def solve_lane_plan(
    fmt_a, fmt_b, *, l_a: int = DSP48E2_LA, l_b: int = DSP48E2_LB,
    guard: int = 1, max_parallelism: Optional[int] = None,
) -> LanePlan:
    """Find the max-parallelism packing of (fmt_a, fmt_b) lanes on the DSP."""
    fmt_a = get_format(fmt_a) if isinstance(fmt_a, str) else fmt_a
    fmt_b = get_format(fmt_b) if isinstance(fmt_b, str) else fmt_b
    w_a, w_b = magnitude_bits(fmt_a), magnitude_bits(fmt_b)
    w_lane = int(max_magnitude(fmt_a) * max_magnitude(fmt_b)).bit_length()
    stride = w_lane + guard
    best: Optional[LanePlan] = None
    max_na = max(1, l_a // w_a)
    max_nb = max(1, l_b // w_b)
    for n_a, n_b in itertools.product(range(1, max_na + 1), range(1, max_nb + 1)):
        if max_parallelism and n_a * n_b > max_parallelism:
            continue
        for spread_a in (True, False):
            plan = _try_plan(w_a, w_b, n_a, n_b, stride, spread_a, l_a, l_b,
                             guard, fmt_a, fmt_b)
            if plan and (best is None or plan.parallelism > best.parallelism):
                best = plan
    assert best is not None  # n_a = n_b = 1 always fits for supported formats
    return best


# Paper Fig. 6 / Table IV claimed parallelism (per single DSP).  These are
# the paper's *deployed* lane counts (capped at 4 by its 32-bit output bus);
# tests assert each is feasible, and separately that the uncapped solver
# meets or beats every one of them.
PAPER_PARALLELISM = {
    ("fp8_e4m3", "fp8_e4m3"): 4,
    ("fp8_e5m2", "fp8_e5m2"): 4,
    ("fp4_e2m1", "fp4_e2m1"): 4,
    ("bf16", "bf16"): 2,
    ("int8", "int8"): 2,
    ("int4", "bf16"): 2,
    ("fp4_e2m1", "bf16"): 2,
    ("fp8_e4m3", "bf16"): 2,
    ("int8", "bf16"): 2,
    ("int8", "fp16"): 2,
    ("int4", "fp16"): 2,
    ("fp4_e2m1", "fp16"): 2,
    ("fp8_e4m3", "fp16"): 2,
}

# Combos where the uncapped stride solver finds MORE isolated lanes than the
# paper deploys (beyond-paper result, reported in the benchmarks).
SOLVER_BEYOND_PAPER = {
    ("fp4_e2m1", "fp4_e2m1"): 6,   # paper: 4
    ("fp4_e2m1", "bf16"): 3,       # paper: 2
    ("int2", "bf16"): 3,           # paper: 2 (INT2-8 row)
}


# ---------------------------------------------------------------------------
# Packed multiply (the virtual DSP) and the packed MAC
# ---------------------------------------------------------------------------
def packed_multiply(plan: LanePlan, a_mags: torch.Tensor, b_mags: torch.Tensor,
                    *, plain: bool = False) -> torch.Tensor:
    """Eqs. (9)-(11): pack, ONE wide multiply, shift-and-mask extraction.

    a_mags: [..., n_a] magnitudes; b_mags: [..., n_b].
    Returns int64 lane products [..., P] ordered as plan.lane_positions:
    kernel K6 on CUDA tensors, the plain version on CPU tensors or with
    ``plain=True``.
    """
    if plain:
        return virtual_dsp_plain(a_mags, b_mags, plan)
    return virtual_dsp_multiply_wide(a_mags, b_mags, plan)


def xtramac_packed(
    cfg: M.MacConfig, plan: LanePlan, a_bits, b_bits, c_bits,
    *, plain: bool = False, device="cuda",
) -> torch.Tensor:
    """Full packed MAC: P lanes through ONE virtual-DSP multiply.

    a_bits: [..., n_a] raw patterns of fmt_a;  b_bits: [..., n_b];
    c_bits: [..., P] accumulator inputs (one per lane product).
    Bit-identical to running ``mac.xtramac`` once per lane.  ``plain``
    goes to Stage 2 (``packed_multiply``).
    """
    dev = device_of(a_bits, b_bits, c_bits, device=device)
    da = M.map_operand(cfg.fmt_a, as_int64(a_bits, dev))          # Stage 1
    db = M.map_operand(cfg.fmt_b, as_int64(b_bits, dev))
    dc = M.map_operand(cfg.fmt_c, as_int64(c_bits, dev))

    prods = packed_multiply(plan, da.mag, db.mag, plain=plain)  # Stage 2 (DSP)

    outs = []
    for lane, (i, j, _) in enumerate(plan.lane_positions):      # Stage 2 post + 3 + 4
        dai = M.Decoded(*(f[..., i] for f in da))
        dbj = M.Decoded(*(f[..., j] for f in db))
        sign, exp, nan, inf = M.product_flags(dai, dbj)
        prod = M.Product(sign, prods[..., lane], exp, nan, inf)
        dcl = M.Decoded(*(f[..., lane] for f in dc))
        outs.append(M.accumulate_select(cfg, prod, dcl))
    return torch.stack(outs, dim=-1)


def per_lane_reference(cfg: M.MacConfig, plan: LanePlan, a_bits, b_bits, c_bits):
    """Unpacked per-lane MACs — what the packed path must reproduce exactly."""
    outs = []
    for lane, (i, j, _) in enumerate(plan.lane_positions):
        outs.append(M.xtramac(cfg, a_bits[..., i], b_bits[..., j], c_bits[..., lane]))
    return torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# DSP-utilization comparison model (Fig. 3 / Fig. 4 / Fig. 9)
# ---------------------------------------------------------------------------
def utilization_xtramac(fmt_a, fmt_b) -> float:
    return solve_lane_plan(fmt_a, fmt_b, max_parallelism=4).dsp_utilization


def utilization_upcast(fmt_a, fmt_b, upcast_to: str = "bf16") -> float:
    """Vendor-IP style: operands promoted to one high-precision FP datapath
    (paper Fig. 2a/Fig. 3).  The datapath occupies the whole DSP multiplier;
    the useful payload is the SOURCE operands' effective magnitude bits:

        U = (w_a_src + w_b_src) / W_mul

    FP32 targets (24-bit mantissa) consume 2 DSPs (24x17 + 24x7 partials).
    """
    up = get_format(upcast_to)
    w_eff = magnitude_bits(get_format(fmt_a) if isinstance(fmt_a, str) else fmt_a) + \
        magnitude_bits(get_format(fmt_b) if isinstance(fmt_b, str) else fmt_b)
    n_dsp = 2 if up.magnitude_bits > DSP48E2_LB else 1
    return w_eff / (DSP48E2_WMUL * n_dsp)


def utilization_spatial(fmt_pairs) -> float:
    """Spatial replication: one active datapath, the rest idle (Fig. 2b)."""
    utils = [utilization_upcast(a, b, "fp32") for a, b in fmt_pairs]
    return float(np.mean(utils)) / len(fmt_pairs) * 1.0 if not utils else float(
        np.mean([u / len(fmt_pairs) for u in utils])
    )


def utilization_temporal_bf16_over_int8() -> float:
    """TATAA-style: BF16 decomposed into 4 INT8 micro-ops over 4 PEs/cycles."""
    int8_util = (8 + 8) / DSP48E2_WMUL  # one INT8xINT8 per DSP
    return int8_util / 4.0
