"""Packed-weight GEMV / matmul: CUDA kernels and their plain version.

Torch side of ``csrc/packed_matmul.cu`` (which replaces the Pallas kernel
``repro/kernels/packed_matmul.py:_packed_matmul_kernel``).  All functions
compute x [M, K] (bf16) @ W [K, N] -> f32 [M, N] with W given as packed
int32 words [K/per, N] and f32 group scales.

  * ``packed_gemv``   — decode shapes, 1 <= M <= 8 (split-K GEMV kernel,
    K1); takes N % 4 == 0 and 16-byte aligned words and scales
    (``gemv_takes``);
  * ``packed_matmul`` — any M >= 1, any N (tensor-core matmul kernel, K2):
    prefill chunks and the decode shapes K1 does not take;
  * ``packed_matmul_plain`` — the same math in plain torch: dequantize to
    f32, then one f32 matmul;
  * ``packed_matmul_grouped`` — plain torch in K2's association and order:
    per scale group, x @ codes (the codes as K2's bf16 operand) in f32,
    times the group's scale, summed in the order K2 sums the groups.

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel (or raises).  ``launches`` counts kernel launches
per wrapper; plain calls do not count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.quant.pack import codes_per_word, unpack_codes
from repro_torch.quant.schemes import (PACKED_FORMAT_IDS, QuantScheme,
                                       dequantize, effective_group)

from . import build

launches: Dict[str, int] = {"packed_gemv": 0, "packed_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "packed_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_matmul": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
}
GEMV_MAX_M = 8
_GEMV_COLS = 128          # columns per GEMV block (32 lanes x 4)
_GEMV_WARPS = 8
_GEMV_X_SMEM = 32 * 1024  # bytes of staged x per GEMV block
_MM_BK = 128              # matmul K per pipeline stage
_MM_MIN_STEPS = 4         # stages per split, at least
_TARGET_BLOCKS = 264      # two waves over the H100's 132 SMs


def packed_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor,
                        scheme: QuantScheme) -> torch.Tensor:
    """Plain torch: dequantize W to f32 (code x group scale), x.f32 @ W."""
    k = packed.shape[0] * codes_per_word(scheme.weight_bits)
    w = dequantize(scheme, packed, scales, (k, packed.shape[1]))
    return x.to(torch.float32) @ w


def kernel_decode_bf16(scheme: QuantScheme, codes: torch.Tensor) -> torch.Tensor:
    """The bf16 bit patterns (int32, in [0, 2^16)) that K2's
    ``decode_pairs`` makes of unsigned ``codes``, by the same integer
    operations: int4 as the mantissa of 128.0 in offset binary, minus 136;
    e2m1 / e4m3 by shifting (exponent, mantissa) into bf16's fields and
    adding the bias difference, with a zero exponent (and the e4m3 NaN
    code) read as +-0."""
    c = codes.to(torch.int32)
    if scheme.weight_format == "int4":
        v = bf16_from_bits((c ^ 8) | 0x4300) - torch.tensor(
            136.0, dtype=torch.bfloat16, device=c.device)
        return v.view(torch.int16).to(torch.int32) & 0xFFFF
    if scheme.weight_format == "fp4_e2m1":
        mag = torch.where((c & 6) != 0, ((c & 7) << 6) + 0x3F00,
                          torch.zeros_like(c))
        return mag | ((c & 8) << 12)
    if scheme.weight_format == "fp8_e4m3":
        keep = ((c & 0x78) != 0) & ((c & 0x7F) != 0x7F)
        mag = torch.where(keep, ((c & 0x7F) << 4) + 0x3C00, torch.zeros_like(c))
        return mag | ((c & 0x80) << 8)
    raise ValueError(scheme.weight_format)


def bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bf16 bit patterns -> bf16 values."""
    b = bits & 0xFFFF
    return torch.where(b >= 0x8000, b - 0x10000, b).to(
        torch.int16).view(torch.bfloat16)


def packed_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor,
                          scheme: QuantScheme) -> torch.Tensor:
    """Plain torch in K2's association and order: per scale group, x @
    codes in f32 (the codes as K2 decodes them to bf16, exact), times the
    group's scale, added to the split's sum in the order K2 adds them —
    each column tile (``matmul_plan``'s width) walks its split's stages of
    128 starting at stage tile % stages; a per-channel scale multiplies the
    split's whole sum once — then the splits summed in order.  Only the
    order inside one group's x @ codes (the tensor cores') is not
    replayed."""
    per = codes_per_word(scheme.weight_bits)
    k, n = packed.shape[0] * per, packed.shape[1]
    m = x.shape[0]
    vals = bf16_from_bits(kernel_decode_bf16(
        scheme, unpack_codes(packed, scheme.weight_bits))).to(torch.float32)
    group = effective_group(scheme.group_size, k)
    xf = x.to(torch.float32)
    _, nt, kps, splits = matmul_plan(m, k, n, scheme.weight_bits)
    tile = torch.arange(n, device=x.device) // (64 * nt)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for z in range(splits):
        k0, k1 = z * kps, min(k, (z + 1) * kps)
        if group == k:
            out += scales[0] * (xf[:, k0:k1] @ vals[k0:k1])
            continue
        parts = torch.stack([
            scales[g] * (xf[:, g * group:(g + 1) * group]
                         @ vals[g * group:(g + 1) * group])
            for g in range(k0 // group, k1 // group)])
        nk, gps = -(-(k1 - k0) // _MM_BK), _MM_BK // group
        rot = tile % nk
        acc = torch.zeros_like(out)
        for i in range(nk):
            for u in range(gps):
                gl = ((i + rot) % nk) * gps + u          # [n] group, or past
                take = parts.gather(0, gl.clamp(max=len(parts) - 1)
                                    .expand(1, m, n))[0]
                acc += torch.where(gl < len(parts), take,
                                   torch.zeros_like(take))
        out += acc
    return out


def gemv_split_plan(m: int, k: int, n: int, scheme: QuantScheme) -> Tuple[int, int]:
    """(words_per_split, splits) for the GEMV: split K until the grid holds
    about two waves of blocks, keeping each block's staged x slice within
    its shared-memory budget and at least one word row per warp."""
    per = codes_per_word(scheme.weight_bits)
    kw = k // per
    tiles = -(-n // _GEMV_COLS)
    want = max(1, -(-_TARGET_BLOCKS // tiles))
    wps = -(-kw // want)
    wps = -(-wps // _GEMV_WARPS) * _GEMV_WARPS
    cap = max(_GEMV_WARPS, _GEMV_X_SMEM // (4 * m * per))
    wps = max(_GEMV_WARPS, min(wps, cap, kw))
    return wps, -(-kw // wps)


def matmul_plan(m: int, k: int, n: int,
                bits: int) -> Tuple[int, int, int, int]:
    """(m_tiles, n_tiles, k_per_split, splits) for K2 on ``bits``-bit
    codes: blocks of 16 m_tiles rows (1 for M <= 16, else 4) by 64 n_tiles
    columns (2 for 4-bit codes in 64-row blocks, whose tile of packed words
    is half as many bytes, else 1); K split in whole stages of 128, at
    least 4 stages a split, while the grid holds fewer than two blocks per
    SM (264)."""
    mt = 1 if m <= 16 else 4
    nt = 2 if mt == 4 and bits == 4 else 1
    blocks = -(-n // (64 * nt)) * -(-m // (16 * mt))
    steps = -(-k // _MM_BK)
    splits = max(1, min(_TARGET_BLOCKS // blocks, steps // _MM_MIN_STEPS))
    kps = -(-steps // splits) * _MM_BK
    return mt, nt, kps, -(-k // kps)


def gemv_takes(m: int, n: int, packed_ptr: int, scales_ptr: int) -> bool:
    """Whether K1 takes a leaf: decode rows (M <= 8), N % 4 == 0 and
    16-byte aligned words and scales (its 16-byte loads); every other
    leaf goes to K2."""
    return (1 <= m <= GEMV_MAX_M and n % 4 == 0 and packed_ptr % 16 == 0
            and scales_ptr % 16 == 0)


def _check(x, packed, scales, scheme: QuantScheme, what: str):
    if not scheme.packed or scheme.weight_format not in PACKED_FORMAT_IDS:
        raise ValueError(f"{what}: {scheme.name!r} is not a packed scheme")
    for name, t, dtype in (("x", x, torch.bfloat16),
                           ("packed", packed, torch.int32),
                           ("scales", scales, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 2-D tensor")
    per = codes_per_word(scheme.weight_bits)
    m, k = x.shape
    n = packed.shape[1]
    if packed.shape[0] * per != k:
        raise ValueError(f"{what}: x has K={k}, packed holds "
                         f"{packed.shape[0] * per} rows")
    group = effective_group(scheme.group_size, k)
    if k % group or group % per or scales.shape != (k // group, n):
        raise ValueError(f"{what}: scales {tuple(scales.shape)} do not tile "
                         f"K={k} in groups of {group}")
    return m, k, n, group


def _dispatch(x, packed, scales, scheme, what):
    """None for CPU tensors (take the plain version); raises for a device
    the kernels do not run on."""
    if x.device.type == "cpu":
        if packed.device.type != "cpu" or scales.device.type != "cpu":
            raise ValueError(f"{what}: x on the CPU, weights on "
                             f"{packed.device}")
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return _check(x, packed, scales, scheme, what)


def packed_gemv(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                scheme: QuantScheme) -> torch.Tensor:
    """Decode-shape GEMV: x [M, K] bf16 with 1 <= M <= 8."""
    dims = _dispatch(x, packed, scales, scheme, "packed_gemv")
    if dims is None:
        return packed_matmul_plain(x, packed, scales, scheme)
    m, k, n, group = dims
    if not 1 <= m <= GEMV_MAX_M:
        raise ValueError(f"packed_gemv takes 1 <= M <= {GEMV_MAX_M}, got {m}")
    if not gemv_takes(m, n, packed.data_ptr(), scales.data_ptr()):
        raise ValueError("packed_gemv needs N % 4 == 0 and 16-byte aligned "
                         "packed / scales (packed_matmul takes any)")
    wps, splits = gemv_split_plan(m, k, n, scheme)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device)
    lib = build.load("packed_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.packed_gemv(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr(), out.data_ptr(), m, k, n,
            PACKED_FORMAT_IDS[scheme.weight_format], group, wps, splits,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "packed_gemv", err)
    launches["packed_gemv"] += 1
    return out


def matmul_x_operand(x: torch.Tensor) -> torch.Tensor:
    """x as K2 loads it: rows a multiple of 8 bf16 long and 16-byte
    aligned, so that every 16-byte copy is whole; a copy zero-padded along
    K where x is not (zeros add nothing)."""
    k = x.shape[1]
    if k % 8 == 0 and x.data_ptr() % 16 == 0:
        return x
    xp = torch.zeros((x.shape[0], -(-k // 8) * 8), dtype=x.dtype,
                     device=x.device)
    xp[:, :k] = x
    return xp


def packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, scheme: QuantScheme) -> torch.Tensor:
    """Tensor-core matmul: x [M, K] bf16, any M >= 1 and any N (used for
    M > 8, and for the decode leaves ``gemv_takes`` refuses)."""
    dims = _dispatch(x, packed, scales, scheme, "packed_matmul")
    if dims is None:
        return packed_matmul_plain(x, packed, scales, scheme)
    m, k, n, group = dims
    unit = 4 * codes_per_word(scheme.weight_bits)
    if group not in (k, _MM_BK) and not group == unit == 32:
        raise ValueError(f"packed_matmul: scale group {group} is neither K, "
                         f"{_MM_BK}, nor 32 for 4-bit codes")
    mt, nt, kps, splits = matmul_plan(m, k, n, scheme.weight_bits)
    xk = matmul_x_operand(x)
    vec = int(n % 4 == 0 and packed.data_ptr() % 16 == 0
              and scales.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, m, n) if splits > 1 else (0,),
                          dtype=torch.float32, device=x.device)
    lib = build.load("packed_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.packed_matmul(
            xk.data_ptr(), xk.shape[1], packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr(), out.data_ptr(), m, k, n,
            PACKED_FORMAT_IDS[scheme.weight_format], group, mt, nt, kps,
            splits, vec, torch.cuda.current_stream().cuda_stream)
    build.check(lib, "packed_matmul", err)
    launches["packed_matmul"] += 1
    return out
