"""W8A8 matmul (int8 x int8 -> exact int32 -> f32): CUDA kernel and its
plain version.

Torch side of ``csrc/w8a8_matmul.cu`` (which replaces the Pallas kernel
``repro/kernels/packed_matmul.py:_w8a8_kernel``).  Both compute

    out = acc.f32 * (w_scales * x_scale),  acc = x_codes @ w_codes (int32)

with x_codes int8 [M, K] under one per-tensor f32 scale (a 0-d tensor),
the weight codes int8 given **transposed**, ``w_codes_t`` [N, K], and
per-channel f32 ``w_scales`` [1, N].  The int32 sum is exact, so kernel,
plain version and the reference's ``w8a8_matmul_ref`` agree bit for bit.

  * ``w8a8_matmul``       — launches the kernel on CUDA tensors (one launch;
    any K and any alignment of either operand, taken as they are),
    returns the plain version on CPU tensors, raises for any other device;
  * ``w8a8_matmul_plain`` — plain torch on any device.

``launches`` counts kernel launches; plain calls do not count.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import build, scratch

launches: Dict[str, int] = {"w8a8_matmul": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"w8a8_matmul": [_P] * 7 + [_I] * 8 + [_P],
               "w8a8_blocks_per_sm": [_I, ctypes.POINTER(ctypes.c_int)]}
COLS = 64                 # output columns a block (csrc: kCols)
BK = 512                  # K a ring stage (csrc: kBK)
MAX_K = 131071            # |int32 sum| <= K * 2^14 <= 2^31 - 2^14


def w8a8_matmul_plain(x_codes: torch.Tensor, x_scale: torch.Tensor,
                      w_codes_t: torch.Tensor,
                      w_scales: torch.Tensor) -> torch.Tensor:
    """Plain torch.  The int32 product is taken as an f64 matmul: every
    partial sum is an integer of magnitude below 2^31 < 2^53, so f64 sums
    it exactly in any order, on any device (CUDA has no int32 matmul)."""
    acc = (x_codes.to(torch.float64) @ w_codes_t.to(torch.float64).t()
           ).to(torch.int32)
    return acc.to(torch.float32) * (w_scales * x_scale)


def x_groups(m: int) -> int:
    """8-row groups of x a block takes: 1 for decode rows, up to 8 (64
    rows) for prefill chunks; larger M runs in blocks of 64 rows."""
    return 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8


def copy_width(k: int, addr: int) -> int:
    """Bytes per copy the kernel uses for an operand [*, K] at ``addr``: 16
    where K and the address allow it, else 4, else 1."""
    for width in (16, 4):
        if k % width == 0 and addr % width == 0:
            return width
    return 1


def split_plan(m: int, k: int, n: int, wave: int) -> Tuple[int, int]:
    """(k_per_split, splits): K cut into whole ring stages of BK, as many
    splits as keep the grid of COLS-column, 8 * x_groups(m)-row tiles
    within ``wave`` blocks (what the SMs hold at once), at most one a stage;
    prefill rows (over 16) take at least two stages a split, where one
    stage's copy no longer covers the epilogue's atomic adds."""
    groups = x_groups(m)
    tiles = -(-n // COLS) * -(-m // (8 * groups))
    steps = -(-k // BK)
    per = -(-steps // max(1, min(steps, wave // tiles)))
    per = min(steps, max(per, 2 if groups >= 4 else 1))
    return per * BK, -(-steps // per)


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
    if x_codes.shape[-1] > MAX_K:
        raise ValueError(f"w8a8_matmul: K={x_codes.shape[-1]} could overflow "
                         f"the int32 sums (K <= {MAX_K})")
    if x_codes.device.type == "cpu":
        if w_codes_t.device.type != "cpu":
            raise ValueError(f"w8a8_matmul: x on the CPU, weights on "
                             f"{w_codes_t.device}")
        return w8a8_matmul_plain(x_codes, x_scale, w_codes_t, w_scales)
    if x_codes.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: no kernel for device {x_codes.device}")
    m, k, n = _check(x_codes, x_scale, w_codes_t, w_scales)
    groups = x_groups(m)
    lib = build.load("w8a8_matmul", _SIGNATURES)
    dev = x_codes.device
    kps, splits = split_plan(m, k, n, _wave(lib, dev, groups))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        accum, counters = out, out
        if splits > 1:
            tiles = -(-n // COLS) * -(-m // (8 * groups))
            accum = scratch.zeroed("w8a8_matmul.accum", dev, stream, m * n)
            counters = scratch.zeroed("w8a8_matmul.counters", dev, stream,
                                      tiles)
        err = lib.w8a8_matmul(
            x_codes.data_ptr(), w_codes_t.data_ptr(), w_scales.data_ptr(),
            x_scale.data_ptr(), accum.data_ptr(), counters.data_ptr(),
            out.data_ptr(), m, k, n, groups, kps, splits,
            copy_width(k, w_codes_t.data_ptr()),
            copy_width(k, x_codes.data_ptr()), stream)
    build.check(lib, "w8a8_matmul", err)
    launches["w8a8_matmul"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _wave(lib: ctypes.CDLL, device: torch.device, groups: int) -> int:
    """Blocks of the ``groups`` body the card holds at once."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check(lib, "w8a8_blocks_per_sm",
                    lib.w8a8_blocks_per_sm(groups, ctypes.byref(per_sm)))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, per_sm.value) * sms
