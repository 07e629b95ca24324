"""Exact scalar oracle for the XtraMAC MAC operation ``P = A*B + C`` (copy
of ``repro/core/ref_mac.py`` over the port's ``formats``).

This is the ground truth the tensor datapath (core/mac.py, core/packing.py
and the virtual-DSP kernel under it) is validated against: host code that
owes nothing to torch.  All arithmetic uses unbounded Python
integers, so alignment/rounding is *exact* — no double-rounding through
float64.

Semantics (paper Section III-D / V-A):
  * DAZ on ingest, FTZ on output.
  * any NaN in -> canonical qNaN out;  inf*0 and inf+(-inf) -> qNaN.
  * overflow saturates: +/-inf (ieee formats), NaN (e4m3), max-finite (fp4).
  * float rounding: round-to-nearest-even, applied ONCE after the fused
    product+accumulate (fused-MAC semantics, as in tensor-core FMAs).
  * integer accumulate: exact product, saturating add into the output width.
"""
from __future__ import annotations

import numpy as np

from .formats import Format, FloatFormat, IntFormat, get_format


def _decode(fmt: Format, bits: int):
    """bits -> (kind, sign, M, E) with value = (-1)^sign * M * 2^E, or special.

    kind in {"num", "nan", "inf"}; zero is ("num", s, 0, 0).
    """
    bits = int(bits) & ((1 << fmt.bits) - 1)
    if isinstance(fmt, IntFormat):
        sign_bit = 1 << (fmt.bits - 1)
        v = bits - (1 << fmt.bits) if bits >= sign_bit else bits
        return ("num", 1 if v < 0 else 0, abs(v), 0)
    assert isinstance(fmt, FloatFormat)
    sign = (bits >> (fmt.exp_bits + fmt.man_bits)) & 1
    e_field = (bits >> fmt.man_bits) & fmt.exp_max_field
    m_field = bits & ((1 << fmt.man_bits) - 1)
    if fmt.special_rule == "ieee":
        if e_field == fmt.exp_max_field:
            return ("nan", sign, 0, 0) if m_field != 0 else ("inf", sign, 0, 0)
    elif fmt.special_rule == "e4m3":
        if e_field == fmt.exp_max_field and m_field == (1 << fmt.man_bits) - 1:
            return ("nan", sign, 0, 0)
    if e_field == 0:  # DAZ: subnormals (and true zero) read as zero
        return ("num", sign, 0, 0)
    M = m_field | (1 << fmt.man_bits)
    E = e_field - fmt.bias - fmt.man_bits
    return ("num", sign, M, E)


def _round_to_float(fmt: FloatFormat, sign: int, M: int, E: int) -> int:
    """Exact RN-even rounding of (-1)^sign * M * 2^E into ``fmt`` bits."""
    if M == 0:
        return sign << (fmt.bits - 1)  # signed zero (FTZ output keeps sign)
    n = M.bit_length()
    shift = n - (fmt.man_bits + 1)
    if shift <= 0:
        m_out = M << (-shift)
    else:
        kept = M >> shift
        rem = M & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and (kept & 1)):
            kept += 1
        if kept == (1 << (fmt.man_bits + 1)):  # rounding carried
            kept >>= 1
            shift += 1
        m_out = kept
    e_val = E + shift + fmt.man_bits  # unbiased exponent of the result
    if e_val < fmt.min_unbiased_exp:  # FTZ
        return sign << (fmt.bits - 1)
    overflow = e_val > fmt.max_unbiased_exp
    if fmt.special_rule == "e4m3":
        if e_val == fmt.max_unbiased_exp and m_out == (1 << (fmt.man_bits + 1)) - 1:
            overflow = True  # would collide with the NaN code
        if overflow:
            return fmt.qnan_bits
    elif fmt.special_rule == "none":
        if overflow:
            return fmt.max_finite_bits(sign)
    elif overflow:
        return fmt.inf_bits(sign)
    return int(fmt.encode(sign, e_val, m_out))


def mac_exact(
    fmt_a: Format, fmt_b: Format, fmt_c: Format, fmt_p: Format,
    a_bits: int, b_bits: int, c_bits: int,
) -> int:
    """Exact ``P = A*B + C`` with XtraMAC semantics; returns P's bit pattern."""
    ka, sa, Ma, Ea = _decode(fmt_a, a_bits)
    kb, sb, Mb, Eb = _decode(fmt_b, b_bits)
    kc, sc, Mc, Ec = _decode(fmt_c, c_bits)

    if isinstance(fmt_p, IntFormat):
        # pure integer MAC: exact product + saturating accumulate
        assert ka == kb == kc == "num"
        prod = (-1) ** (sa ^ sb) * (Ma << Ea) * (Mb << Eb)
        acc = prod + (-1) ** sc * Mc
        lo, hi = fmt_p.min_value, fmt_p.max_value
        acc = min(max(acc, lo), hi)  # saturation on overflow (paper V-A)
        return acc & ((1 << fmt_p.bits) - 1)

    assert isinstance(fmt_p, FloatFormat)
    # ---- special-value resolution (paper III-D) ----
    if ka == "nan" or kb == "nan" or kc == "nan":
        return fmt_p.qnan_bits
    prod_is_inf = ka == "inf" or kb == "inf"
    if prod_is_inf:
        other_zero = (kb == "num" and Mb == 0) if ka == "inf" else (ka == "num" and Ma == 0)
        if other_zero:
            return fmt_p.qnan_bits  # inf * 0
        sp = sa ^ sb
        if kc == "inf" and sc != sp:
            return fmt_p.qnan_bits  # inf + (-inf)
        return fmt_p.inf_bits(sp) if fmt_p.has_inf and fmt_p.special_rule == "ieee" else fmt_p.qnan_bits
    if kc == "inf":
        return fmt_p.inf_bits(sc) if fmt_p.has_inf and fmt_p.special_rule == "ieee" else fmt_p.qnan_bits

    # ---- exact fused product + accumulate ----
    sp = sa ^ sb
    Mp, Ep = Ma * Mb, Ea + Eb
    if Mp == 0 and Mc == 0:
        return 0  # +0 (RN convention for exact-zero sums)
    E0 = min(Ep, Ec)
    v = (-1) ** sp * (Mp << (Ep - E0)) + (-1) ** sc * (Mc << (Ec - E0))
    if v == 0:
        return 0  # additive cancellation -> +0
    return _round_to_float(fmt_p, 1 if v < 0 else 0, abs(v), E0)


def mac_exact_vec(fmt_a, fmt_b, fmt_c, fmt_p, a_bits, b_bits, c_bits) -> np.ndarray:
    """Vectorized (slow, exact) oracle over arrays of bit patterns."""
    fmt_a, fmt_b = _as_fmt(fmt_a), _as_fmt(fmt_b)
    fmt_c, fmt_p = _as_fmt(fmt_c), _as_fmt(fmt_p)
    a, b, c = np.broadcast_arrays(
        np.asarray(a_bits, dtype=np.int64),
        np.asarray(b_bits, dtype=np.int64),
        np.asarray(c_bits, dtype=np.int64),
    )
    out = np.empty(a.shape, dtype=np.int64)
    flat_a, flat_b, flat_c = a.ravel(), b.ravel(), c.ravel()
    flat_o = out.ravel()
    for i in range(flat_a.size):
        flat_o[i] = mac_exact(fmt_a, fmt_b, fmt_c, fmt_p, flat_a[i], flat_b[i], flat_c[i])
    return out


def _as_fmt(f) -> Format:
    return get_format(f) if isinstance(f, str) else f


def decode_value(fmt, bits) -> float:
    """Scalar decode of a bit pattern to a float (NaN/inf aware)."""
    fmt = _as_fmt(fmt)
    kind, s, M, E = _decode(fmt, bits)
    if kind == "nan":
        return float("nan")
    if kind == "inf":
        return float("-inf") if s else float("inf")
    return (-1.0) ** s * M * 2.0 ** E
