"""Quantization schemes for weights and the KV cache (torch twin of
``repro/quant/schemes.py``).

Weights: ``QuantScheme`` / ``SCHEMES`` name the paper's MAC datatype
combinations; packed schemes store codes 8 (4-bit) or 4 (8-bit) per int32
word with f32 group scales ``[K/G, N]`` (``[1, N]`` per channel).  Decode is
arithmetic with DAZ (a zero exponent field reads as 0, no subnormals) and
the E4M3 NaN code read as 0 — the same values as the reference's
``decode_codes_arith``.  ``quantize_weights`` covers the int schemes in
torch, so full-width weights are quantized on the device.

KV cache: ``kv_quantize`` packs one absmax-scaled 8-bit code per channel, 4
codes per int32 word along ``d_head``, with one f32 scale per (position,
head).  The E4M3 encoder is arithmetic (frexp / ldexp / RN-even round, FTZ
below the min normal), bit-identical to the reference encoder; torch's
``float8_e4m3fn`` cast keeps subnormals and is not used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .pack import codes_per_word, pack_codes, to_int32_words, unpack_codes

# E4M3 (OCP) constants: 3 mantissa bits, bias 7, min normal exponent -6,
# largest finite 448
_E4M3_MAN_BITS = 3
_E4M3_BIAS = 7
_E4M3_MIN_EXP = -6
E4M3_MAX_FINITE = 448.0


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    name: str
    weight_format: str         # int4 | int8 | fp4_e2m1 | fp8_e4m3 | bf16
    act_format: str
    acc_format: str
    group_size: int            # scale granularity along K; -1 = per-channel
    weight_bits: int
    scale_pow2: bool = False
    pack_in_words: bool = True

    @property
    def packed(self) -> bool:
        return self.pack_in_words and self.weight_bits <= 8


SCHEMES: Dict[str, QuantScheme] = {
    "awq_int4": QuantScheme("awq_int4", "int4", "bf16", "bf16", 128, 4),
    "w8a8": QuantScheme("w8a8", "int8", "int8", "int32", -1, 8,
                        pack_in_words=False),
    "fp8": QuantScheme("fp8", "fp8_e4m3", "fp8_e4m3", "bf16", -1, 8),
    "mxfp4": QuantScheme("mxfp4", "fp4_e2m1", "bf16", "bf16", 32, 4,
                         scale_pow2=True),
    "bf16": QuantScheme("bf16", "bf16", "bf16", "bf16", -1, 16,
                        pack_in_words=False),
}

# packed schemes the kernels take, by their C-side format id
PACKED_FORMAT_IDS = {"int4": 0, "fp4_e2m1": 1, "fp8_e4m3": 2}


def get_scheme(name: str) -> QuantScheme:
    return SCHEMES[name]


def effective_group(group: int, k: int) -> int:
    """Group size along K (clamped: small layers use one group)."""
    return k if (group == -1 or group > k) else group


# ---------------------------------------------------------------------------
# Arithmetic decode (DAZ; NaN reads as 0)
# ---------------------------------------------------------------------------
def _decode_int(codes: torch.Tensor, bits: int) -> torch.Tensor:
    half = 1 << (bits - 1)
    return torch.where(codes >= half, codes - (1 << bits),
                       codes).to(torch.float32)


def _decode_fp4_e2m1(codes: torch.Tensor) -> torch.Tensor:
    s = (codes >> 3) & 1
    e = (codes >> 1) & 3
    m = codes & 1
    mag = torch.where(e == 0, torch.zeros((), device=codes.device),
                      (2 + m).to(torch.float32)
                      * torch.exp2((e - 2).to(torch.float32)))
    return torch.where(s == 1, -mag, mag)


def _decode_fp8_e4m3(codes: torch.Tensor) -> torch.Tensor:
    s = (codes >> 7) & 1
    e = (codes >> 3) & 0xF
    m = codes & 7
    zero = torch.zeros((), device=codes.device)
    mag = torch.where(e == 0, zero,
                      (8 + m).to(torch.float32)
                      * torch.exp2((e - 10).to(torch.float32)))
    mag = torch.where((e == 0xF) & (m == 7), zero, mag)
    return torch.where(s == 1, -mag, mag)


def decode_codes(scheme: QuantScheme, codes: torch.Tensor) -> torch.Tensor:
    """Unsigned codes -> f32 format values (pre-scale)."""
    if scheme.weight_format.startswith("int"):
        return _decode_int(codes, scheme.weight_bits)
    if scheme.weight_format == "fp4_e2m1":
        return _decode_fp4_e2m1(codes)
    if scheme.weight_format == "fp8_e4m3":
        return _decode_fp8_e4m3(codes)
    raise ValueError(scheme.weight_format)


def dequantize(scheme: QuantScheme, packed: torch.Tensor,
               scales: torch.Tensor, shape) -> torch.Tensor:
    """Packed words [K/per, N] + scales [K/G, N] -> f32 weights [K, N]
    (each decoded code times its group scale, rounded once to f32)."""
    k, n = shape
    codes = unpack_codes(packed, scheme.weight_bits)
    vals = decode_codes(scheme, codes)
    g = effective_group(scheme.group_size, k)
    return (vals.reshape(k // g, g, n) * scales[:, None, :]).reshape(k, n)


# ---------------------------------------------------------------------------
# Weight quantization (int schemes; runs on any device)
# ---------------------------------------------------------------------------
def quantize_weights(scheme: QuantScheme, w: torch.Tensor):
    """Float weights [K, N] -> (packed int32 [K/per, N], scales f32 [K/G, N]).

    Symmetric absmax per (group, column): scale = absmax / qmax, codes =
    clip(round_half_even(w / scale)) in two's complement — the same f32
    arithmetic as the reference's numpy quantizer."""
    if not (scheme.packed and scheme.weight_format.startswith("int")):
        raise NotImplementedError(
            f"torch quantize_weights covers the packed int schemes, "
            f"not {scheme.name!r}")
    w = w.to(torch.float32)
    k, n = w.shape
    g = effective_group(scheme.group_size, k)
    if k % g or k % codes_per_word(scheme.weight_bits):
        raise ValueError(f"K={k} does not tile scheme {scheme.name!r}")
    wg = w.reshape(k // g, g, n)
    absmax = torch.clamp(wg.abs().amax(dim=1), min=1e-12)     # [K/G, N]
    qmax = (1 << (scheme.weight_bits - 1)) - 1
    scales = absmax / qmax
    q = torch.round(wg / scales[:, None, :]).clamp(-qmax - 1, qmax)
    codes = (q.to(torch.int64) & ((1 << scheme.weight_bits) - 1)).reshape(k, n)
    return pack_codes(codes, scheme.weight_bits), scales


# ---------------------------------------------------------------------------
# KV-cache quantization
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class KVQuantScheme:
    name: str            # 'int8' | 'fp8'
    fmt_name: str
    bits: int = 8


KV_SCHEMES: Dict[str, KVQuantScheme] = {
    "int8": KVQuantScheme("int8", "int8"),
    "fp8": KVQuantScheme("fp8", "fp8_e4m3"),
}


def get_kv_scheme(kv_dtype) -> Optional[KVQuantScheme]:
    """None for bf16 storage, a ``KVQuantScheme`` for 'int8' / 'fp8'."""
    if kv_dtype is None or kv_dtype == "bf16":
        return None
    try:
        return KV_SCHEMES[kv_dtype]
    except KeyError as exc:
        raise KeyError(f"unknown kv_dtype {kv_dtype!r}; have 'bf16' + "
                       f"{sorted(KV_SCHEMES)}") from exc


def kv_pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """8-bit codes [..., D] -> int32 words [..., D/4] (little-endian)."""
    d = codes.shape[-1]
    if d % 4:
        raise ValueError(f"trailing dim {d} not divisible by 4 (KV packing)")
    c = (codes.to(torch.int64) & 0xFF).reshape(
        tuple(codes.shape[:-1]) + (d // 4, 4))
    word = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (c[..., 3] << 24)
    return to_int32_words(word)


def kv_unpack_codes(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., Dw] -> unsigned 8-bit codes int32 [..., Dw*4]."""
    parts = [(words >> (8 * i)) & 0xFF for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(tuple(words.shape[:-1]) + (-1,))


def _encode_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """RN-even E4M3 encode of f32 values already clipped to +-448 -> int32
    codes, flushing everything below the min normal 2^-6 to signed zero."""
    xf = x.to(torch.float32)
    sign = torch.signbit(xf).to(torch.int32)
    mag = xf.abs()
    _, e2 = torch.frexp(mag)                   # mag = frac * 2^e2, frac [.5,1)
    e_unb = e2.to(torch.int32) - 1
    # integer mantissa with 3 fractional bits; the 2^k scaling is exact in
    # f32, so round() is a true RN-even on the real quotient
    m = torch.round(torch.ldexp(mag, _E4M3_MAN_BITS - e_unb))
    m = torch.nan_to_num(m, posinf=0.0).to(torch.int32)  # underflow lanes
    carry = (m >= (1 << (_E4M3_MAN_BITS + 1))).to(torch.int32)
    m = torch.where(carry == 1, m >> 1, m)
    e_unb = e_unb + carry
    underflow = (e_unb < _E4M3_MIN_EXP) | (mag == 0)
    code = (sign << 7) | ((e_unb + _E4M3_BIAS) << _E4M3_MAN_BITS) \
        | (m & ((1 << _E4M3_MAN_BITS) - 1))
    return torch.where(underflow, sign << 7, code)


def kv_quantize(scheme: KVQuantScheme, x: torch.Tensor):
    """x [..., D] float -> (packed int32 [..., D/4], scales f32 [...]): one
    symmetric absmax scale per trailing-D group.  int8 rounds half to even
    in two's complement; fp8 is the arithmetic RN-even E4M3 encode."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(dim=-1), min=1e-12)
    if scheme.name == "int8":
        scales = absmax / 127.0
        codes = torch.clamp(torch.round(xf / scales[..., None]), -128,
                            127).to(torch.int32)
    else:
        scales = absmax / E4M3_MAX_FINITE
        scaled = torch.clamp(xf / scales[..., None], -E4M3_MAX_FINITE,
                             E4M3_MAX_FINITE)
        codes = _encode_fp8_e4m3(scaled)
    return kv_pack_codes(codes), scales


def kv_decode_codes(scheme: KVQuantScheme, codes: torch.Tensor) -> torch.Tensor:
    """Unsigned 8-bit codes -> f32 pre-scale values."""
    if scheme.name == "int8":
        return _decode_int(codes, 8)
    return _decode_fp8_e4m3(codes)


def kv_dequantize(scheme: KVQuantScheme, packed: torch.Tensor,
                  scales: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed words + group scales -> dense KV slab [..., D]."""
    codes = kv_unpack_codes(packed)
    return (kv_decode_codes(scheme, codes) * scales[..., None]).to(dtype)
