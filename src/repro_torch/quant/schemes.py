"""Quantization schemes for weights and the KV cache (torch twin of
``repro/quant/schemes.py``).

Weights: ``QuantScheme`` / ``SCHEMES`` name the paper's MAC datatype
combinations; packed schemes store codes 8 (4-bit) or 4 (8-bit) per int32
word with f32 group scales ``[K/G, N]`` (``[1, N]`` per channel).  Decode is
arithmetic with DAZ (a zero exponent field reads as 0, no subnormals) and
the E4M3 NaN code read as 0 — the same values as the reference's
``decode_codes_arith``.  w8a8 keeps raw int8 codes ``[K, N]`` (not packed
into words) with per-channel scales ``[1, N]``, and quantizes activations
per tensor (``quantize_activations_int8``).  ``quantize_weights`` covers
every quantized scheme (the float codes through ``core.formats``, as the
reference builds them), so full-width weights are quantized on the device.

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

from repro_torch.core import formats as F

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
# Weight and activation quantization (runs on any device)
# ---------------------------------------------------------------------------
# elements of one column block the weight quantizer works on at a time: the
# float formats pass through float64 (``core.formats.quantize_f64``), so
# each of its temporaries stays within 512 MB whatever the leaf's size
QUANT_BLOCK_ELEMS = 1 << 26


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an f32 division on x's device.  (A Python-number divisor
    would make CUDA multiply by its rounded reciprocal instead, which can
    differ from the reference's quotient in the last bit.)"""
    return x / x.new_full((), d)


def pow2_scale(q: torch.Tensor) -> torch.Tensor:
    """UE8M0 scales 2^ceil(log2(q)) of f32 ``q`` > 0, with the exponent as
    the reference's f32 ``log2`` gives it: log2 in f64 rounded once to f32,
    so that just above a power of two 2^k it rounds to k and the scale
    stays 2^k (an exact exponent would give 2^(k+1)); then the power of two
    from its bits, exact on every device."""
    e = torch.ceil(torch.log2(q.to(torch.float64)).to(torch.float32))
    return F.exp2i(e).to(torch.float32)


def _quantize_block(scheme: QuantScheme, w: torch.Tensor, g: int):
    """f32 weights [K, n] (a column block) -> (codes int64 [K, n], f32
    scales [K/G, n])."""
    k, n = w.shape
    wg = w.reshape(k // g, g, n)
    absmax = torch.clamp(wg.abs().amax(dim=1), min=1e-12)     # [K/G, n]
    if scheme.weight_format.startswith("int"):
        qmax = (1 << (scheme.weight_bits - 1)) - 1
        scales = _div(absmax, qmax)
        q = torch.round(wg / scales[:, None, :]).clamp(-qmax - 1, qmax)
        return q.reshape(k, n).to(torch.int64), scales
    fmt = F.get_format(scheme.weight_format)
    scales = _div(absmax, fmt.max_finite)
    if scheme.scale_pow2:
        scales = pow2_scale(scales)
    scaled = (wg / scales[:, None, :]).reshape(k, n).to(torch.float64)
    return F.quantize_f64(fmt, scaled), scales


def quantize_weights(scheme: QuantScheme, w: torch.Tensor):
    """Float weights [K, N] -> (codes, scales f32 [K/G, N]), bit for bit the
    reference's numpy quantizer, on w's device.

    Scales per (group, column) from absmax = max(|w| over the group,
    1e-12), in f32: int schemes absmax / qmax, codes = clip(round_half_even(
    w / scale)) in two's complement; fp8 absmax / 448 per channel; mxfp4
    2^ceil(log2(absmax / 6)) per 32-group (``pow2_scale``).  Float codes
    are ``core.formats.quantize_f64`` of the f32 quotient w / scale (RN-even,
    FTZ, saturating).  The packed schemes return int32 words [K/per, N];
    w8a8 returns raw int8 codes [K, N] with per-channel scales [1, N].
    Columns are quantized in blocks of at most ``QUANT_BLOCK_ELEMS``."""
    if scheme.name == "bf16":
        raise ValueError("bf16 weights are not quantized")
    w = w.to(torch.float32)
    k, n = w.shape
    g = effective_group(scheme.group_size, k)
    if k % g or (scheme.packed and k % codes_per_word(scheme.weight_bits)):
        raise ValueError(f"K={k} does not tile scheme {scheme.name!r}")
    rows = k // codes_per_word(scheme.weight_bits) if scheme.packed else k
    codes = torch.empty((rows, n), device=w.device,
                        dtype=torch.int32 if scheme.packed else torch.int8)
    scales = torch.empty((k // g, n), dtype=torch.float32, device=w.device)
    step = max(1, QUANT_BLOCK_ELEMS // k)
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        q, scales[:, c0:c1] = _quantize_block(scheme, w[:, c0:c1], g)
        codes[:, c0:c1] = (pack_codes(q & ((1 << scheme.weight_bits) - 1),
                                      scheme.weight_bits)
                           if scheme.packed else q)
    return codes, scales


def quantize_activations_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 activation quantization (SmoothQuant
    style) over every element of ``x``: absmax = max(max|x.f32|, 1e-12),
    scale = absmax / 127, codes = clip(round_half_even(x.f32 / scale),
    -128, 127).  Returns (int8 codes shaped like x, f32 0-d scale on x's
    device) — bit for bit the reference's ``quantize_activations_int8``."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(), min=1e-12)
    scale = _div(absmax, 127.0)
    codes = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return codes, scale


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
        scales = _div(absmax, 127.0)
        codes = torch.clamp(torch.round(xf / scales[..., None]), -128,
                            127).to(torch.int32)
    else:
        scales = _div(absmax, E4M3_MAX_FINITE)
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
