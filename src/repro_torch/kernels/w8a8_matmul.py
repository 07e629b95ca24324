"""W8A8 matmul (int8 x int8 -> exact int32 -> f32): CUDA kernel and its
plain version.

Torch side of ``csrc/w8a8_matmul.cu`` (which replaces the Pallas kernel
``repro/kernels/packed_matmul.py:_w8a8_kernel``).  Both compute

    out = acc.f32 * (w_scales * x_scale),  acc = x_codes @ w_codes (int32)

with x_codes int8 [M, K] under one per-tensor f32 scale (a 0-d tensor),
the weight codes int8 given **transposed**, ``w_codes_t`` [N, K], and
per-channel f32 ``w_scales`` [1, N].  The int32 sum is exact, so kernel,
plain version and the reference's ``w8a8_matmul_ref`` agree bit for bit.

  * ``w8a8_matmul``       — launches the kernel on CUDA tensors (zero-padding
    both operands along K to a multiple of 16 where K or an address does
    not suit the kernel's 16-byte loads: zero codes add exactly 0 to the
    int32 sums), returns the plain version on CPU tensors, raises for any
    other device;
  * ``w8a8_matmul_plain`` — plain torch on any device.

``launches`` counts kernel launches; plain calls do not count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

launches: Dict[str, int] = {"w8a8_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"w8a8_matmul": [_P] * 6 + [_I] * 6 + [_P]}
_COLS = 128               # output columns per block (4 warps x 32)
_K_STEP = 64              # K per loop step of the kernel
_MIN_K_PER_SPLIT = 256
_TARGET_BLOCKS = 264      # two waves over the H100's 132 SMs


def w8a8_matmul_plain(x_codes: torch.Tensor, x_scale: torch.Tensor,
                      w_codes_t: torch.Tensor,
                      w_scales: torch.Tensor) -> torch.Tensor:
    """Plain torch.  The int32 product is taken as an f64 matmul: every
    partial sum is an integer of magnitude below 2^31 < 2^53, so f64 sums
    it exactly in any order, on any device (CUDA has no int32 matmul)."""
    acc = (x_codes.to(torch.float64) @ w_codes_t.to(torch.float64).t()
           ).to(torch.int32)
    return acc.to(torch.float32) * (w_scales * x_scale)


def m_tiles(m: int) -> int:
    """16-row m-tiles per warp: 1 for decode rows, 4 for prefill chunks."""
    return 1 if m <= 16 else 2 if m <= 32 else 4


def w8a8_takes(k: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether the kernel takes the code operands as they are: K % 16 == 0
    and both 16-byte aligned (its 16-byte loads).  Otherwise the wrapper
    runs it on copies zero-padded along K to a multiple of 16."""
    return k % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0


def _pad_k(codes: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros((codes.shape[0], k), dtype=codes.dtype,
                      device=codes.device)
    out[:, :codes.shape[1]] = codes
    return out


def split_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(k_per_split, splits): split K in steps of 64 (at least 256 per
    split) until the grid of 128-column, 16 x m_tiles-row blocks holds
    about two waves."""
    blocks = -(-n // _COLS) * -(-m // (16 * m_tiles(m)))
    want = max(1, -(-_TARGET_BLOCKS // blocks))
    kps = -(-(-(-k // want)) // _K_STEP) * _K_STEP
    kps = max(kps, _MIN_K_PER_SPLIT)
    return kps, -(-k // kps)


def _check(x_codes, x_scale, w_codes_t, w_scales):
    for name, t, dtype in (("x_codes", x_codes, torch.int8),
                           ("x_scale", x_scale, torch.float32),
                           ("w_codes_t", w_codes_t, torch.int8),
                           ("w_scales", w_scales, torch.float32)):
        if t.device != x_codes.device:
            raise ValueError(f"w8a8_matmul: {name} on {t.device}, x_codes "
                             f"on {x_codes.device}")
        if t.dtype != dtype:
            raise TypeError(f"w8a8_matmul: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"w8a8_matmul: {name} must be contiguous")
    if x_codes.dim() != 2 or w_codes_t.dim() != 2:
        raise ValueError("w8a8_matmul: x_codes and w_codes_t must be 2-D")
    m, k = x_codes.shape
    n = w_codes_t.shape[0]
    if w_codes_t.shape[1] != k:
        raise ValueError(f"w8a8_matmul: x has K={k}, the weights "
                         f"{w_codes_t.shape[1]}")
    if x_scale.numel() != 1 or w_scales.numel() != n:
        raise ValueError("w8a8_matmul: x_scale must hold 1 value and "
                         f"w_scales N={n}")
    return m, k, n


def w8a8_matmul(x_codes: torch.Tensor, x_scale: torch.Tensor,
                w_codes_t: torch.Tensor,
                w_scales: torch.Tensor) -> torch.Tensor:
    """x_codes int8 [M, K] (scale: f32 0-d), w_codes_t int8 [N, K],
    w_scales f32 [1, N] -> f32 [M, N]."""
    if x_codes.device.type == "cpu":
        if w_codes_t.device.type != "cpu":
            raise ValueError(f"w8a8_matmul: x on the CPU, weights on "
                             f"{w_codes_t.device}")
        return w8a8_matmul_plain(x_codes, x_scale, w_codes_t, w_scales)
    if x_codes.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: no kernel for device {x_codes.device}")
    m, k, n = _check(x_codes, x_scale, w_codes_t, w_scales)
    if not w8a8_takes(k, x_codes.data_ptr(), w_codes_t.data_ptr()):
        k = -(-k // 16) * 16
        x_codes, w_codes_t = _pad_k(x_codes, k), _pad_k(w_codes_t, k)
    kps, splits = split_plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=x_codes.device)
    partial = torch.empty((splits, m, n) if splits > 1 else (0,),
                          dtype=torch.int32, device=x_codes.device)
    lib = build.load("w8a8_matmul", _SIGNATURES)
    with torch.cuda.device(x_codes.device):
        err = lib.w8a8_matmul(
            x_codes.data_ptr(), w_codes_t.data_ptr(), w_scales.data_ptr(),
            x_scale.data_ptr(), partial.data_ptr(), out.data_ptr(), m, k, n,
            m_tiles(m), kps, splits, torch.cuda.current_stream().cuda_stream)
    build.check(lib, "w8a8_matmul", err)
    launches["w8a8_matmul"] += 1
    return out
