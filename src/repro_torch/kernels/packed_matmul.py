"""Packed-weight GEMV / matmul: CUDA kernels and their plain version.

Torch side of ``csrc/packed_matmul.cu`` (which replaces the Pallas kernel
``repro/kernels/packed_matmul.py:_packed_matmul_kernel``).  All functions
compute x [M, K] (bf16) @ W [K, N] -> f32 [M, N] with W given as packed
int32 words [K/per, N] and f32 group scales.

  * ``packed_gemv``   — decode shapes, 1 <= M <= 8 (split-K GEMV kernel)
  * ``packed_matmul`` — prefill chunks, M > 8 (tiled matmul kernel)
  * ``packed_matmul_plain`` — the same math in plain torch: dequantize to
    f32, then one f32 matmul.

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel (or raises).  ``launches`` counts kernel launches
per wrapper; plain calls do not count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.quant.pack import codes_per_word
from repro_torch.quant.schemes import (PACKED_FORMAT_IDS, QuantScheme,
                                       dequantize, effective_group)

from . import build

launches: Dict[str, int] = {"packed_gemv": 0, "packed_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "packed_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
GEMV_MAX_M = 8
_GEMV_COLS = 128          # columns per GEMV block (32 lanes x 4)
_GEMV_WARPS = 8
_GEMV_X_SMEM = 32 * 1024  # bytes of staged x per GEMV block
_MM_TILE, _MM_BK = 64, 32  # matmul output tile and K step
_TARGET_BLOCKS = 264      # two waves over the H100's 132 SMs


def packed_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor,
                        scheme: QuantScheme) -> torch.Tensor:
    """Plain torch: dequantize W to f32 (code x group scale), x.f32 @ W."""
    k = packed.shape[0] * codes_per_word(scheme.weight_bits)
    w = dequantize(scheme, packed, scales, (k, packed.shape[1]))
    return x.to(torch.float32) @ w


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


def matmul_split_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(k_per_split, splits) for the matmul: split K, in steps of 32 rows,
    until the grid of 64 x 64 output tiles holds about two waves."""
    tiles = -(-n // _MM_TILE) * -(-m // _MM_TILE)
    want = max(1, -(-_TARGET_BLOCKS // tiles))
    kps = -(-k // want)
    kps = max(_MM_BK, -(-kps // _MM_BK) * _MM_BK)
    return kps, -(-k // kps)


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
    if n % 4 or packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("packed_gemv needs N % 4 == 0 and 16-byte aligned "
                         "packed / scales")
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


def packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, scheme: QuantScheme) -> torch.Tensor:
    """Prefill-shape matmul: x [M, K] bf16, any M >= 1 (used for M > 8)."""
    dims = _dispatch(x, packed, scales, scheme, "packed_matmul")
    if dims is None:
        return packed_matmul_plain(x, packed, scales, scheme)
    m, k, n, group = dims
    kps, splits = matmul_split_plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device)
    lib = build.load("packed_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.packed_matmul(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr(), out.data_ptr(), m, k, n,
            PACKED_FORMAT_IDS[scheme.weight_format], group, kps, splits,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "packed_matmul", err)
    launches["packed_matmul"] += 1
    return out
