"""Datatype registry and bit-level codecs for XtraMAC (torch twin of
``repro/core/formats.py``).

Every format the paper supports (Table II "Ours" row / Fig. 6) is an
``IntFormat`` (two's complement) or a ``FloatFormat`` (sign / exponent /
mantissa with implicit leading one).  The codecs convert between raw bit
patterns (int64 tensors) and exact float64 values, and give the (sign,
exponent, mantissa) fields of Eq. (1)/(4) that the datapath consumes.

Numerical conventions follow the paper (Section III-D):
  * FTZ/DAZ: subnormal inputs decode to zero; subnormal outputs flush to 0.
  * E4M3 (OCP) reserves only exponent=1111 & mantissa=111 as NaN; E2M1
    (FP4) has no NaN/inf at all.
  * NaNs are canonical quiet NaNs on output.

Tensors stay on their device.  A function given Python or numpy values
makes its tensors on ``device`` (default ``"cuda"``).  Powers of two are
built from their float64 bits (``exp2i``), exact on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch


def device_of(*xs, device="cuda") -> torch.device:
    """The device of the first tensor among ``xs``, else ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(device)


def as_int64(x, device="cuda") -> torch.Tensor:
    """``x`` as an int64 tensor: a tensor keeps its device; a Python or
    numpy value is made on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def as_float64(x, device="cuda") -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def exp2i(k: torch.Tensor) -> torch.Tensor:
    """2.0**k as float64 for integer k in [-1022, 1023], built from the
    exponent bits (exact on any device; ``k`` is clamped to that range)."""
    k = k.to(torch.int64).clamp(-1022, 1023)
    return ((k + 1023) << 52).view(torch.float64)


def ldexp_exact(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x * 2**k in two exact power-of-two steps (|k| up to 2044), so a
    result in the normal range is exact even where 2**k alone is not a
    normal double."""
    k = k.to(torch.int64)
    half = torch.div(k, 2, rounding_mode="floor")
    return x * exp2i(half) * exp2i(k - half)


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """Two's-complement signed integer format."""

    name: str
    bits: int

    @property
    def is_float(self) -> bool:
        return False

    @property
    def magnitude_bits(self) -> int:
        # |min| = 2^(bits-1) needs (bits) bits unsigned (e.g. |-8| = 0b1000).
        return self.bits

    @property
    def min_value(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def max_value(self) -> int:
        return (1 << (self.bits - 1)) - 1

    # -- codecs ------------------------------------------------------------
    def decode_to_f64(self, bits, device="cuda") -> torch.Tensor:
        """Bit pattern (uint) -> exact float64 value."""
        bits = as_int64(bits, device) & ((1 << self.bits) - 1)
        sign_bit = 1 << (self.bits - 1)
        signed = torch.where(bits >= sign_bit, bits - (1 << self.bits), bits)
        return signed.to(torch.float64)

    def encode_from_int(self, value, device="cuda") -> torch.Tensor:
        """Saturating encode of an integer value into this format."""
        v = as_int64(value, device).clamp(self.min_value, self.max_value)
        return v & ((1 << self.bits) - 1)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """IEEE-style float: 1 sign bit, ``exp_bits``, ``man_bits`` (explicit)."""

    name: str
    exp_bits: int
    man_bits: int
    has_inf: bool = True
    # E4M3 (OCP): only exp=max & man=all-ones is NaN; other exp=max codes are
    # normal numbers.  E2M1: no specials at all.
    special_rule: str = "ieee"  # "ieee" | "e4m3" | "none"

    @property
    def is_float(self) -> bool:
        return True

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def exp_max_field(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def magnitude_bits(self) -> int:
        # mantissa with implicit leading 1
        return self.man_bits + 1

    @property
    def max_unbiased_exp(self) -> int:
        """Largest unbiased exponent of a finite normal number."""
        if self.special_rule == "ieee":
            return self.exp_max_field - 1 - self.bias
        # e4m3 / none: exponent field all-ones still encodes finite values.
        return self.exp_max_field - self.bias

    @property
    def min_unbiased_exp(self) -> int:
        return 1 - self.bias

    @property
    def max_finite(self) -> float:
        if self.special_rule == "e4m3":
            # exp=max, man=all-ones-but-one is the largest finite (e.g. 448).
            m = (1 << self.magnitude_bits) - 2  # mantissa just below NaN code
            return m * 2.0 ** (self.max_unbiased_exp - self.man_bits)
        m = (1 << self.magnitude_bits) - 1
        return m * 2.0 ** (self.max_unbiased_exp - self.man_bits)

    # -- field decode --------------------------------------------------------
    def fields(self, bits, device="cuda"):
        bits = as_int64(bits, device) & ((1 << self.bits) - 1)
        sign = (bits >> (self.exp_bits + self.man_bits)) & 1
        e_field = (bits >> self.man_bits) & self.exp_max_field
        m_field = bits & ((1 << self.man_bits) - 1)
        return sign, e_field, m_field

    def is_nan(self, bits, device="cuda") -> torch.Tensor:
        sign, e, m = self.fields(bits, device)
        if self.special_rule == "ieee":
            return (e == self.exp_max_field) & (m != 0)
        if self.special_rule == "e4m3":
            return (e == self.exp_max_field) & (m == (1 << self.man_bits) - 1)
        return torch.zeros_like(e, dtype=torch.bool)

    def is_inf(self, bits, device="cuda") -> torch.Tensor:
        sign, e, m = self.fields(bits, device)
        if self.special_rule == "ieee" and self.has_inf:
            return (e == self.exp_max_field) & (m == 0)
        return torch.zeros_like(e, dtype=torch.bool)

    def is_zero_daz(self, bits, device="cuda") -> torch.Tensor:
        """Zero under DAZ: exponent field == 0 (subnormals -> zero)."""
        _, e, _ = self.fields(bits, device)
        return e == 0

    def decode_to_f64(self, bits, device="cuda") -> torch.Tensor:
        """Bit pattern -> float64 under DAZ (subnormals read as zero)."""
        bits = as_int64(bits, device)
        sign, e, m = self.fields(bits)
        mag = torch.where(
            e == 0,
            0.0,
            ldexp_exact((m + (1 << self.man_bits)).to(torch.float64),
                        e - self.bias - self.man_bits),
        )
        val = torch.where(sign == 1, -mag, mag)
        val = torch.where(self.is_nan(bits), float("nan"), val)
        inf = torch.where(sign == 1, float("-inf"), float("inf"))
        return torch.where(self.is_inf(bits), inf.to(val.dtype), val)

    # -- canonical special encodings ---------------------------------------
    @property
    def qnan_bits(self) -> int:
        if self.special_rule == "ieee":
            # quiet NaN: exp all ones, MSB of mantissa set
            return (self.exp_max_field << self.man_bits) | (1 << (self.man_bits - 1))
        if self.special_rule == "e4m3":
            return (self.exp_max_field << self.man_bits) | ((1 << self.man_bits) - 1)
        raise ValueError(f"{self.name} has no NaN encoding")

    def inf_bits(self, sign: int) -> int:
        if not (self.special_rule == "ieee" and self.has_inf):
            raise ValueError(f"{self.name} has no inf encoding")
        return (sign << (self.exp_bits + self.man_bits)) | (
            self.exp_max_field << self.man_bits
        )

    def max_finite_bits(self, sign: int) -> int:
        if self.special_rule == "e4m3":
            payload = (self.exp_max_field << self.man_bits) | ((1 << self.man_bits) - 2)
        elif self.special_rule == "none":
            payload = (self.exp_max_field << self.man_bits) | ((1 << self.man_bits) - 1)
        else:
            payload = ((self.exp_max_field - 1) << self.man_bits) | (
                (1 << self.man_bits) - 1
            )
        return (sign << (self.exp_bits + self.man_bits)) | payload

    def encode(self, sign, e_unbiased, mantissa):
        """Pack normalized fields. ``mantissa`` includes the implicit bit.
        Takes int64 tensors or Python ints (then returns an int)."""
        e_field = e_unbiased + self.bias
        m_field = mantissa & ((1 << self.man_bits) - 1)
        return (
            (sign << (self.exp_bits + self.man_bits))
            | (e_field << self.man_bits)
            | m_field
        )


Format = Union[IntFormat, FloatFormat]

# ---------------------------------------------------------------------------
# Registry (Table II "Ours": Integer + floating point, all positions A/B/C/P)
# ---------------------------------------------------------------------------
INT2 = IntFormat("int2", 2)
INT3 = IntFormat("int3", 3)
INT4 = IntFormat("int4", 4)
INT5 = IntFormat("int5", 5)
INT6 = IntFormat("int6", 6)
INT7 = IntFormat("int7", 7)
INT8 = IntFormat("int8", 8)
INT16 = IntFormat("int16", 16)
INT32 = IntFormat("int32", 32)

FP4 = FloatFormat("fp4_e2m1", exp_bits=2, man_bits=1, has_inf=False, special_rule="none")
FP8_E4M3 = FloatFormat("fp8_e4m3", exp_bits=4, man_bits=3, has_inf=False, special_rule="e4m3")
FP8_E5M2 = FloatFormat("fp8_e5m2", exp_bits=5, man_bits=2, has_inf=True, special_rule="ieee")
FP16 = FloatFormat("fp16", exp_bits=5, man_bits=10, has_inf=True, special_rule="ieee")
BF16 = FloatFormat("bf16", exp_bits=8, man_bits=7, has_inf=True, special_rule="ieee")
FP32 = FloatFormat("fp32", exp_bits=8, man_bits=23, has_inf=True, special_rule="ieee")

REGISTRY: Dict[str, Format] = {
    f.name: f
    for f in [
        INT2, INT3, INT4, INT5, INT6, INT7, INT8, INT16, INT32,
        FP4, FP8_E4M3, FP8_E5M2, FP16, BF16, FP32,
    ]
}
# convenience aliases used in configs
REGISTRY["fp8"] = FP8_E4M3
REGISTRY["fp4"] = FP4


def get_format(name: str) -> Format:
    try:
        return REGISTRY[name]
    except KeyError as exc:
        raise KeyError(f"unknown XtraMAC format {name!r}; have {sorted(REGISTRY)}") from exc


# ---------------------------------------------------------------------------
# float64 <-> format quantization (RN-even)
# ---------------------------------------------------------------------------
def _round_to_int64(v: torch.Tensor) -> torch.Tensor:
    """RN-even to int64; NaN and values outside int64 give INT64_MIN, as
    the reference's numpy cast gives on x86 (torch's own cast of those
    values differs between CPU and CUDA)."""
    r = torch.round(v)
    in_range = r.abs() < 2.0 ** 63          # False for NaN and +/-inf
    return torch.where(in_range, torch.where(in_range, r, 0.0).to(torch.int64),
                       -(1 << 63))


def quantize_f64(fmt: Format, value, device="cuda") -> torch.Tensor:
    """Round float64 values to ``fmt`` bit patterns with RN-even + FTZ.

    Overflow saturates to +/-inf (formats with inf), to NaN (e4m3), or to the
    max finite value (formats without any special encodings, e.g. FP4) —
    matching Section III-D's saturating flag-select behaviour.
    """
    v = as_float64(value, device)
    if isinstance(fmt, IntFormat):
        return fmt.encode_from_int(_round_to_int64(v))

    sign = torch.signbit(v).to(torch.int64)

    nan_mask = torch.isnan(v)
    inf_mask = torch.isinf(v)
    finite = ~(nan_mask | inf_mask)

    mag = torch.where(finite, v, 0.0).abs()
    # frexp: mag = frac * 2^e2, frac in [0.5, 1)
    _, e2 = torch.frexp(mag)
    e_unbiased = e2.to(torch.int64) - 1  # value = 1.xxx * 2^(e_unbiased)
    # integer mantissa with man_bits fractional bits; exact scaling then RN-even
    scaled = ldexp_exact(mag, fmt.man_bits - e_unbiased)
    m_int = _round_to_int64(scaled)
    # rounding may carry: mantissa == 2^(man_bits+1)
    carry = m_int >= (1 << (fmt.man_bits + 1))
    m_int = torch.where(carry, m_int >> 1, m_int)
    e_unbiased = e_unbiased + carry.to(torch.int64)

    # FTZ: anything below the min normal flushes to zero
    underflow = (e_unbiased < fmt.min_unbiased_exp) | (mag == 0.0)
    overflow = e_unbiased > fmt.max_unbiased_exp
    if fmt.special_rule == "e4m3":
        # exp=max & man=all-ones collides with NaN -> that code overflows too
        overflow = overflow | (
            (e_unbiased == fmt.max_unbiased_exp)
            & (m_int == (1 << (fmt.man_bits + 1)) - 1)
        )
    if fmt.special_rule == "none":
        overflow = torch.zeros_like(overflow)
        m_clip = m_int.clamp(max=(1 << (fmt.man_bits + 1)) - 1)
        e_clip = e_unbiased.clamp(max=fmt.max_unbiased_exp)
        sat = e_unbiased > fmt.max_unbiased_exp
        m_int = torch.where(sat, (1 << (fmt.man_bits + 1)) - 1, m_clip)
        e_unbiased = torch.where(sat, fmt.max_unbiased_exp, e_clip)

    normal = finite & ~underflow & ~overflow
    out = torch.where(normal, fmt.encode(sign, e_unbiased, m_int), 0)
    out = torch.where(underflow & finite, sign << (fmt.bits - 1), out)  # +/-0 (FTZ)

    if fmt.special_rule == "ieee" and fmt.has_inf:
        inf_code = torch.where(sign == 1, fmt.inf_bits(1), fmt.inf_bits(0))
        out = torch.where(inf_mask | (finite & overflow), inf_code, out)
        out = torch.where(nan_mask, fmt.qnan_bits, out)
    elif fmt.special_rule == "e4m3":
        out = torch.where(inf_mask | (finite & overflow) | nan_mask, fmt.qnan_bits, out)
    else:  # no specials: saturate everything to max finite
        maxf = torch.where(sign == 1, fmt.max_finite_bits(1), fmt.max_finite_bits(0))
        out = torch.where(inf_mask, maxf, out)
        out = torch.where(nan_mask, 0, out)  # no NaN encoding: canonical 0
    return out.to(torch.int64)


def all_bit_patterns(fmt: Format, device="cuda") -> torch.Tensor:
    """Every bit pattern of a (small) format — for exhaustive tests."""
    if fmt.bits > 16:
        raise ValueError("exhaustive enumeration only for <=16-bit formats")
    return torch.arange(1 << fmt.bits, dtype=torch.int64, device=device)
