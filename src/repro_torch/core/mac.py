"""Tensor XtraMAC datapath — the paper's four-stage pipeline as int64
tensor ops (torch twin of ``repro/core/mac.py``).

This mirrors the microarchitecture of Fig. 5 stage by stage:

  Stage 1  ``map_operand``       operand interpretation -> (s, m, e) + flags
  Stage 2  ``multiply``          datatype-invariant integer mantissa product
                                  (the virtual DSP), sign XOR, exponent add
  Stage 3  ``accumulate_float`` / ``accumulate_int``
                                  decoupled FP / INT accumulation paths
  Stage 4  ``select_output``     flag-based combinational output selection

All arithmetic is exact int64 on whatever device the bit patterns lie on:
products are <= 45 bits, the FP adder aligns into a 50-bit window and its
sums stay below 2^51, so no unsigned arithmetic is needed.  Both branches
of every ``torch.where`` are computed, as in the reference's ``np.where``;
shifts are clipped to [0, 63] first, where int64 shifts behave alike on
the CPU and on CUDA.  Bit-exact against the reference and against the
unbounded-integer oracle in ``ref_mac.py`` (tests/test_torch_core.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .formats import FloatFormat, Format, IntFormat, as_int64, device_of, get_format

_ALIGN_BITS = 50  # FP adder alignment window (int64-safe; >=25 guard bits)


@dataclasses.dataclass(frozen=True)
class MacConfig:
    """One supported datatype combination ``A x B + C -> P`` (a Fig. 6 row)."""

    fmt_a: Format
    fmt_b: Format
    fmt_c: Format
    fmt_p: Format

    @staticmethod
    def make(a: str, b: str, c: str, p: str) -> "MacConfig":
        return MacConfig(get_format(a), get_format(b), get_format(c), get_format(p))

    @property
    def name(self) -> str:
        return f"{self.fmt_a.name}x{self.fmt_b.name}+{self.fmt_c.name}->{self.fmt_p.name}"

    @property
    def is_int_accumulate(self) -> bool:
        return isinstance(self.fmt_p, IntFormat)


class Decoded(NamedTuple):
    """Stage-1 output: sign/magnitude/exponent + special-value flags.

    value = (-1)^sign * mag * 2^exp   (mag==0 encodes zero; DAZ applied)
    """

    sign: torch.Tensor
    mag: torch.Tensor
    exp: torch.Tensor
    nan: torch.Tensor
    inf: torch.Tensor


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values (exact for x < 2^52)."""
    _, e = torch.frexp(x.to(torch.float64))
    return e.to(torch.int64)


def _i64(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int64)


# ---------------------------------------------------------------------------
# Stage 1: operand interpretation & bit-mapping
# ---------------------------------------------------------------------------
def map_operand(fmt: Format, bits, device="cuda") -> Decoded:
    bits = as_int64(bits, device) & ((1 << fmt.bits) - 1)
    if isinstance(fmt, IntFormat):
        sign_bit = 1 << (fmt.bits - 1)
        signed = torch.where(bits >= sign_bit, bits - (1 << fmt.bits), bits)
        sign = _i64(signed < 0)
        mag = signed.abs()
        z = torch.zeros_like(bits, dtype=torch.bool)
        return Decoded(sign, mag, torch.zeros_like(bits), z, z)

    assert isinstance(fmt, FloatFormat)
    sign = (bits >> (fmt.exp_bits + fmt.man_bits)) & 1
    e_field = (bits >> fmt.man_bits) & fmt.exp_max_field
    m_field = bits & ((1 << fmt.man_bits) - 1)
    if fmt.special_rule == "ieee":
        nan = (e_field == fmt.exp_max_field) & (m_field != 0)
        inf = (e_field == fmt.exp_max_field) & (m_field == 0)
    elif fmt.special_rule == "e4m3":
        nan = (e_field == fmt.exp_max_field) & (m_field == (1 << fmt.man_bits) - 1)
        inf = torch.zeros_like(nan)
    else:
        nan = torch.zeros_like(bits, dtype=torch.bool)
        inf = torch.zeros_like(nan)
    zero = e_field == 0  # DAZ
    special = zero | nan | inf
    mag = torch.where(special, 0, m_field | (1 << fmt.man_bits))
    exp = torch.where(special, 0, e_field - fmt.bias - fmt.man_bits)
    return Decoded(sign, mag, exp, nan, inf)


# ---------------------------------------------------------------------------
# Stage 2: datatype-invariant multiply (integer mantissa product) + metadata
# ---------------------------------------------------------------------------
class Product(NamedTuple):
    sign: torch.Tensor
    mag: torch.Tensor   # exact integer mantissa product
    exp: torch.Tensor
    nan: torch.Tensor   # NaN in, or inf * 0
    inf: torch.Tensor


def product_flags(da: Decoded, db: Decoded):
    """(sign, exp, nan, inf) of the product of two decoded operands: sign
    XOR, exponent add, NaN in or inf * 0, inf."""
    sign = da.sign ^ db.sign
    exp = da.exp + db.exp
    nan = da.nan | db.nan
    inf_times_zero = (da.inf & (db.mag == 0) & ~db.inf & ~db.nan) | (
        db.inf & (da.mag == 0) & ~da.inf & ~da.nan
    )
    nan = nan | inf_times_zero
    inf = (da.inf | db.inf) & ~nan
    return sign, exp, nan, inf


def multiply(da: Decoded, db: Decoded) -> Product:
    sign, exp, nan, inf = product_flags(da, db)
    mag = da.mag * db.mag                     # <- the shared DSP multiply
    return Product(sign, mag, exp, nan, inf)


# ---------------------------------------------------------------------------
# Stage 3a: floating-point accumulation (alignment + add + LZC normalize)
# ---------------------------------------------------------------------------
def _align(mag: torch.Tensor, exp: torch.Tensor, e_target: torch.Tensor) -> torch.Tensor:
    """Shift (mag, exp) to exponent ``e_target``; sticky folds into the LSB.

    Left shifts are exact by construction (result < 2^ALIGN_BITS).  Lossy
    right shifts only happen when the operand is >2^(ALIGN_BITS-24) below
    the top — cancellation is then impossible, so LSB-sticky + >=25 guard
    bits make RN-even exact.
    """
    sh = exp - e_target
    shl = sh.clamp(0, 63)
    shr = (-sh).clamp(0, 63)
    left = mag << shl
    kept = mag >> shr
    sticky = (kept << shr) != mag
    right = kept | _i64(sticky)
    return torch.where(sh >= 0, left, right)


class FpResult(NamedTuple):
    sign: torch.Tensor
    mag: torch.Tensor
    exp: torch.Tensor


def fp_add(s1, m1, e1, s2, m2, e2) -> FpResult:
    """Exact-enough FP add of two (sign, mag, exp) values (magnitudes > 0 ok)."""
    neg_inf = -(10**9)
    top1 = torch.where(m1 > 0, e1 + _bitlen(m1), neg_inf)
    top2 = torch.where(m2 > 0, e2 + _bitlen(m2), neg_inf)
    e_t = torch.maximum(top1, top2) - _ALIGN_BITS
    a = _align(m1, e1, e_t)
    b = _align(m2, e2, e_t)
    v = torch.where(s1 == 1, -a, a) + torch.where(s2 == 1, -b, b)
    sign = _i64(v < 0)
    return FpResult(sign, v.abs(), e_t)


def _round_encode_float(fmt: FloatFormat, sign, mag, exp):
    """RN-even round of value=(-1)^s*mag*2^exp into fmt; FTZ + saturation.

    Returns (bits, overflow_mask) — overflow resolved by stage 4.
    """
    n = _bitlen(mag)
    man1 = fmt.man_bits + 1
    shift = n - man1
    shr = shift.clamp(0, 63)
    shl = (-shift).clamp(0, 63)
    kept = torch.where(shift > 0, mag >> shr, mag << shl)
    mask = (1 << shr) - 1
    rem = torch.where(shift > 0, mag & mask, 0)
    half = torch.where(shift > 0, 1 << (shr - 1).clamp(min=0), 1)
    up = (rem > half) | ((rem == half) & (rem > 0) & ((kept & 1) == 1))
    kept = kept + _i64(up)
    carry = kept == (1 << man1)
    kept = torch.where(carry, kept >> 1, kept)
    e_val = exp + n - 1 + _i64(carry)

    zero = mag == 0
    underflow = (e_val < fmt.min_unbiased_exp) & ~zero
    overflow = (e_val > fmt.max_unbiased_exp) & ~zero
    if fmt.special_rule == "e4m3":
        overflow = overflow | (
            (e_val == fmt.max_unbiased_exp) & (kept == (1 << man1) - 1)
        )

    e_enc = e_val.clamp(fmt.min_unbiased_exp, fmt.max_unbiased_exp)
    bits = fmt.encode(sign, e_enc, kept)
    # +0 for exact-zero results; signed zero kept only via FTZ underflow
    bits = torch.where(zero, 0, bits)
    bits = torch.where(underflow, sign << (fmt.bits - 1), bits)
    return bits, overflow


# ---------------------------------------------------------------------------
# Stage 3b: integer accumulation (carry-chain path; saturating)
# ---------------------------------------------------------------------------
def accumulate_int(fmt_p: IntFormat, prod: Product, dc: Decoded) -> torch.Tensor:
    sp = torch.where(prod.sign == 1, -prod.mag, prod.mag)
    sc = torch.where(dc.sign == 1, -dc.mag, dc.mag)
    acc = sp + sc  # exact in int64 for all supported widths
    acc = acc.clamp(fmt_p.min_value, fmt_p.max_value)
    return acc & ((1 << fmt_p.bits) - 1)


# ---------------------------------------------------------------------------
# Stage 4: flag-driven output selection (purely combinational in hardware)
# ---------------------------------------------------------------------------
def select_output(fmt_p: FloatFormat, bits, overflow, nan, inf, inf_sign):
    if fmt_p.special_rule == "ieee" and fmt_p.has_inf:
        pos_inf, neg_inf_b = fmt_p.inf_bits(0), fmt_p.inf_bits(1)
        bits = torch.where(overflow | inf,
                           torch.where(inf_sign == 1, neg_inf_b, pos_inf), bits)
        # `overflow` uses the result sign, folded into inf_sign by the caller
        bits = torch.where(nan, fmt_p.qnan_bits, bits)
    elif fmt_p.special_rule == "e4m3":
        bits = torch.where(overflow | inf | nan, fmt_p.qnan_bits, bits)
    else:
        maxf = torch.where(inf_sign == 1, fmt_p.max_finite_bits(1),
                           fmt_p.max_finite_bits(0))
        bits = torch.where(overflow | inf, maxf, bits)
        bits = torch.where(nan, 0, bits)
    return bits


def accumulate_float(fmt_p: FloatFormat, prod: Product, dc: Decoded):
    """Stage 3a with the special-value flags Stage 4 consumes: returns
    (bits, overflow, nan, inf, inf_sign) for ``select_output``."""
    res = fp_add(prod.sign, prod.mag, prod.exp, dc.sign, dc.mag, dc.exp)
    bits, overflow = _round_encode_float(fmt_p, res.sign, res.mag, res.exp)
    nan = prod.nan | dc.nan | (prod.inf & dc.inf & (prod.sign != dc.sign))
    inf = (prod.inf | dc.inf) & ~nan
    inf_sign = torch.where(prod.inf, prod.sign, dc.sign)
    # saturation keeps the sign of the (finite) overflowed result
    inf_sign = torch.where(inf, inf_sign, res.sign)
    return bits, overflow, nan, inf, inf_sign


def accumulate_select(cfg: MacConfig, prod: Product, dc: Decoded) -> torch.Tensor:
    """Stages 3 and 4 of one lane: ``prod`` + C into ``cfg.fmt_p`` bits."""
    if cfg.is_int_accumulate:
        return accumulate_int(cfg.fmt_p, prod, dc)  # Stage 3b (+4 trivial)
    return select_output(cfg.fmt_p, *accumulate_float(cfg.fmt_p, prod, dc))


# ---------------------------------------------------------------------------
# Full MAC: P = A*B + C
# ---------------------------------------------------------------------------
def xtramac(cfg: MacConfig, a_bits, b_bits, c_bits, device="cuda") -> torch.Tensor:
    """Elementwise XtraMAC MAC over tensors of raw bit patterns."""
    dev = device_of(a_bits, b_bits, c_bits, device=device)
    a_bits, b_bits, c_bits = torch.broadcast_tensors(
        as_int64(a_bits, dev), as_int64(b_bits, dev), as_int64(c_bits, dev))
    da = map_operand(cfg.fmt_a, a_bits)           # Stage 1
    db = map_operand(cfg.fmt_b, b_bits)
    dc = map_operand(cfg.fmt_c, c_bits)
    prod = multiply(da, db)                        # Stage 2
    return accumulate_select(cfg, prod, dc)        # Stages 3 and 4


# ---------------------------------------------------------------------------
# Runtime datatype switching: N static submodules + per-element mux (Fig. 5)
# ---------------------------------------------------------------------------
def xtramac_switching(configs, dtype_sel, a_bits, b_bits, c_bits,
                      device="cuda") -> torch.Tensor:
    """All N mapping/datapath variants evaluated, output muxed by dtype_sel.

    This is exactly the paper's switching mechanism: every datatype submodule
    is instantiated statically; ``dtype_sel`` picks one per element/cycle.
    Output formats may differ per config; results are returned as raw bit
    patterns (int64) of each selected config's fmt_p.
    """
    dev = device_of(dtype_sel, a_bits, b_bits, c_bits, device=device)
    dtype_sel = as_int64(dtype_sel, dev)
    outs = [xtramac(cfg, a_bits, b_bits, c_bits, device=dev) for cfg in configs]
    out = outs[0]
    for i in range(1, len(configs)):
        out = torch.where(dtype_sel == i, outs[i], out)
    return out
