"""Packed-weight GEMV / matmul: CUDA kernels and their plain version.

Torch side of ``csrc/packed_matmul.cu`` (which replaces the Pallas kernel
``repro/kernels/packed_matmul.py:_packed_matmul_kernel``).  All functions
compute x [M, K] (bf16) @ W [K, N] -> f32 [M, N] with W given as packed
int32 words [K/per, N] and f32 group scales.

  * ``packed_gemv``   — decode shapes, 1 <= M <= 8 (tensor-core GEMV
    kernel, K1, split-K summed in the same launch); takes N % 4 == 0 and
    16-byte aligned words and scales (``gemv_takes``);
  * ``packed_matmul`` — any M >= 1, any N (tensor-core matmul kernel, K2):
    prefill chunks and the decode shapes K1 does not take;
  * ``packed_matmul_plain`` — the same math in plain torch: dequantize to
    f32, then one f32 matmul;
  * ``packed_matmul_ordered`` / ``packed_gemv_ordered`` — plain torch in
    K2's / K1's association and order: per scale group, x @ codes (the
    codes as the kernels' bf16 operand) in f32, times the group's scale,
    summed in the order the kernel sums the groups and its K splits.

The expert-grouped forms run one launch over a stack of expert leaves
(words [E, K/per, N], scales [E, K/G, N]): group g of x [G, M, K] times
expert ``expert_idx[g]``'s leaf, of which only the first ``rows[g]`` rows
of x hold data (the rest come out zero) -> f32 [G, M, N].  Expert ids and
row counts stay on the device.  Both wrappers launch one persistent body
(``grouped_gemv_kernel``) that merges the groups naming one expert into
items of <= 8, 16 or 32 rows by M (``grouped_fragments``;
``grouped_work_list`` is its work list's twin) and sums in an order fixed
by the leaf alone (``grouped_gemv_plan``), so a row's output is bit for
bit the same whatever shares its launch and whatever M:
  * ``packed_gemv_grouped``   — grouped K1: M <= 8 (decode pairs and
    small capacity buffers);
  * ``packed_matmul_grouped`` — grouped K2: any M (the route past 8 rows:
    the capacity buffers of chunks of 104 tokens or more);
  * ``packed_grouped_plain``  — the same in plain torch: each group's
    expert dequantized to f32, then one batched f32 matmul;
  * ``packed_gemv_grouped_ordered`` — plain torch in the grouped body's
    order of sums, at any M.

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel (or raises).  ``launches`` counts kernel launches
per wrapper; plain calls do not count.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Dict, Tuple

import torch

from repro_torch.quant.pack import codes_per_word, unpack_codes
from repro_torch.quant.schemes import (PACKED_FORMAT_IDS, QuantScheme,
                                       decode_codes, dequantize,
                                       effective_group)

from . import build, scratch

launches: Dict[str, int] = {"packed_gemv": 0, "packed_matmul": 0,
                            "packed_gemv_grouped": 0,
                            "packed_matmul_grouped": 0}
# the same launches by (wrapper, weight format): which leaves a path ran on
format_launches: Counter = Counter()
# the grouped launches by (wrapper, rows M of a group): which of a MoE
# layer's shapes (decode pairs, prefill capacity buffers) a path ran
grouped_row_launches: Counter = Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "packed_gemv": [_P, _I, _P, _P, _P, _P, _P] + [_I] * 7 + [_P],
    "packed_matmul": [_P, _I, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "packed_gemv_grouped": [_P, _I] + [_P] * 5 + [_I] * 7 + [_P],
    "grouped_gemv_tensor_maps": [_P, _P] + [_I] * 6 + [_P],
}
GEMV_MAX_M = 8
_GV_COLS = 128            # columns per GEMV block (4 warps x 32)
_GV_STAGE_WORDS = 16      # word rows per GEMV ring stage (4 units of 4)
# the words' ring (3 stages of 16 rows of 544 bytes) and the scales' (4
# rows of 512 bytes a stage)
_GV_RING_BYTES = 3 * 16 * 544 + 3 * 4 * 512
_GV_X_ELEMS = 11776       # M x K of x a GEMV block stages (23 KB of bf16)
_GV_BLOCKS = 4 * 132      # four GEMV blocks share an SM: one resident wave
_GV_MAX_SPLITS = 32       # splits the plan aims at most for (the x-slice
                          # cap may force more; the last block's tail sums
                          # any number in order)
# K1's dynamic shared memory, at most (csrc: kGvMaxSmem)
_GV_MAX_SMEM = _GV_RING_BYTES + 2 * (_GV_X_ELEMS + GEMV_MAX_M * 32)
# the grouped body: 4 K warps split each ring stage's word rows (2 on
# leaves of N >= 1536); 4 consumer warps at M <= 8, 8 past it; items of
# 16 rows at 9 <= M <= 16, else 32 past 8; one launch takes at most 512
# experts and 6144 rows of x (csrc: gk_k_warps, kGwWarps, kGwMidFrags,
# gk_stage_rows, kGkMaxExperts, kGkMaxSources)
_GK_WARPS = 4
_GK_WIDE_WARPS = 8
_GK_MID_FRAGS = 2
_GK_MAX_EXPERTS = 512
_GK_MAX_ROWS = 6144
_PLAIN_ELEMS = 1 << 28    # f32 weights of one slice of the plain twin
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


def packed_matmul_ordered(x: torch.Tensor, packed: torch.Tensor,
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


@functools.lru_cache(maxsize=None)
def gemv_plan(m: int, k: int, n: int, scheme: QuantScheme) -> Tuple[int, int]:
    """(k_per_split, splits) for K1: K cut into splits of whole ring stages
    (128 K for 4-bit codes, 64 for fp8) and whole scale groups, as many as
    keep the grid of 128-column tiles within one resident wave of four
    blocks per SM (528) and at most 32 splits, with each block's staged
    slice of x (M x k_per_split bf16) within 23 KB so that four blocks fit
    an SM's shared memory.  Where that x-slice cap leaves more than 32
    splits, it wins: nemotron-4-340b's 73728 x 18432 leaf at M = 8 runs 53
    splits (more than one wave of blocks).  The last block of a column
    tile sums however many splits there are, in order 0, 1, ...
    (``packed_gemv_ordered``)."""
    per = codes_per_word(scheme.weight_bits)
    group = effective_group(scheme.group_size, k)
    q = _GV_STAGE_WORDS * per
    if group != k:
        q = q * group // math.gcd(q, group)
    steps = -(-k // q)
    want = max(1, _GV_BLOCKS // -(-n // _GV_COLS))
    per_split = max(1, min(max(-(-steps // want), -(-steps // _GV_MAX_SPLITS)),
                           _GV_X_ELEMS // (m * q)))
    kps = per_split * q
    return kps, -(-k // kps)


def gemv_smem_bytes(m: int, k_per_split: int, scheme: QuantScheme) -> int:
    """Dynamic shared memory of one K1 block: the rings and x's slice (rows
    padded by 64 or 32 bytes, as ``packed_gemv_kernel`` lays them out)."""
    xpad = 32 if codes_per_word(scheme.weight_bits) == 8 else 16
    return _GV_RING_BYTES + 2 * m * (k_per_split + xpad)


def packed_gemv_ordered(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor,
                        scheme: QuantScheme) -> torch.Tensor:
    """Plain torch in K1's association and order: each split of
    ``gemv_plan`` sums, group by group in K order, the group's scale times
    x @ codes in f32 (the codes as K1 decodes them to bf16, exact; a
    per-channel scale multiplies the split's whole sum once); the splits'
    sums are then added in split order to zero.  Only the order inside one
    group's x @ codes (the tensor cores') is not replayed."""
    per = codes_per_word(scheme.weight_bits)
    k, n = packed.shape[0] * per, packed.shape[1]
    vals = bf16_from_bits(kernel_decode_bf16(
        scheme, unpack_codes(packed, scheme.weight_bits))).to(torch.float32)
    group = effective_group(scheme.group_size, k)
    xf = x.to(torch.float32)
    kps, splits = gemv_plan(x.shape[0], k, n, scheme)
    out = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for z in range(splits):
        k0, k1 = z * kps, min(k, (z + 1) * kps)
        if group == k:
            out += scales[0] * (xf[:, k0:k1] @ vals[k0:k1])
            continue
        acc = torch.zeros_like(out)
        for g0 in range(k0, k1, group):
            acc += scales[g0 // group] * (xf[:, g0:g0 + group]
                                          @ vals[g0:g0 + group])
        out += acc
    return out


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
    kps, splits = _gemv_launch_plan(m, k, n, scheme)
    xk = matmul_x_operand(x)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = out if splits == 1 else torch.empty(
        (splits, m, n), dtype=torch.float32, device=x.device)
    lib = build.load("packed_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        counters = scratch.zeroed("packed_gemv.counters", x.device, stream,
                                  -(-n // _GV_COLS))
        err = lib.packed_gemv(
            xk.data_ptr(), xk.shape[1], packed.data_ptr(), scales.data_ptr(),
            partial.data_ptr(), out.data_ptr(), counters.data_ptr(), m, k, n,
            PACKED_FORMAT_IDS[scheme.weight_format], group, kps, splits,
            stream)
    build.check(lib, "packed_gemv", err)
    launches["packed_gemv"] += 1
    format_launches["packed_gemv", scheme.weight_format] += 1
    return out


@functools.lru_cache(maxsize=None)
def _gemv_launch_plan(m: int, k: int, n: int,
                      scheme: QuantScheme) -> Tuple[int, int]:
    """``gemv_plan``, after checking that K1 takes the leaf's scale groups
    and that the plan's x slice fits a block."""
    per = codes_per_word(scheme.weight_bits)
    group = effective_group(scheme.group_size, k)
    if group != k and group % (4 * per):
        raise ValueError(f"packed_gemv: scale group {group} is neither K nor "
                         f"a multiple of {4 * per}")
    kps, splits = gemv_plan(m, k, n, scheme)
    if gemv_smem_bytes(m, kps, scheme) > _GV_MAX_SMEM:
        raise ValueError(f"packed_gemv: scale group {group} needs a split of "
                         f"{kps} rows of K, more x than a block stages")
    return kps, splits


def matmul_x_operand(x: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """x as K2 loads it: rows a multiple of 8 bf16 long (the grouped body:
    of its unit's K, ``multiple``) and 16-byte aligned, so that every copy is
    whole; a copy zero-padded along K where x is not (zeros add nothing)."""
    k = x.shape[1]
    if k % multiple == 0 and x.data_ptr() % 16 == 0:
        return x
    xp = torch.zeros((x.shape[0], -(-k // multiple) * multiple),
                     dtype=x.dtype, device=x.device)
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
    _check_matmul_group(group, k, scheme, "packed_matmul")
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
    format_launches["packed_matmul", scheme.weight_format] += 1
    return out


def _check_matmul_group(group: int, k: int, scheme: QuantScheme, what: str):
    unit = 4 * codes_per_word(scheme.weight_bits)
    if group not in (k, _MM_BK) and not group == unit == 32:
        raise ValueError(f"{what}: scale group {group} is neither K, "
                         f"{_MM_BK}, nor 32 for 4-bit codes")


# ---------------------------------------------------------------------------
# Expert-grouped K1 / K2: one launch over a stack of expert leaves
# ---------------------------------------------------------------------------
def packed_grouped_plain(x: torch.Tensor, packed: torch.Tensor,
                         scales: torch.Tensor, scheme: QuantScheme,
                         expert_idx: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """Plain torch: group g's expert dequantized to f32 (code x group
    scale, as ``dequantize``), x[g].f32 @ W; rows past ``rows[g]`` zero.
    Groups go in slices whose f32 weights hold at most ``_PLAIN_ELEMS``
    values, so that the decode's temporaries stay a few GB at any G
    (deepseek-v2's 160 buffers of 5120 x 1536 experts: ~25 GB at once)."""
    g, m, k = x.shape
    n = packed.shape[-1]
    step = max(1, _PLAIN_ELEMS // (k * n))
    if g > step:
        return torch.cat([packed_grouped_plain(
            x[i:i + step], packed, scales, scheme, expert_idx[i:i + step],
            rows[i:i + step]) for i in range(0, g, step)])
    bits = scheme.weight_bits
    per = codes_per_word(bits)
    words = packed[expert_idx.long()]                       # [G, K/per, N]
    shifts = torch.arange(0, 32, bits, device=x.device, dtype=torch.int32)
    codes = (words[:, :, None, :] >> shifts[None, None, :, None]) \
        & ((1 << bits) - 1)                                 # [G, K/per, per, N]
    vals = decode_codes(scheme, codes.reshape(g, k // per * per, n))
    group = effective_group(scheme.group_size, k)
    w = (vals.reshape(g, k // group, group, n)
         * scales[expert_idx.long()][:, :, None, :]).reshape(g, k, n)
    out = torch.bmm(x.to(torch.float32), w)
    live = torch.arange(m, device=x.device)[None, :] < rows[:, None]
    return torch.where(live[..., None], out, torch.zeros_like(out))


def _check_grouped(x, packed, scales, scheme, expert_idx, rows, what):
    """(G, E, M, K, N, group) of a grouped call, after checking devices,
    types, shapes and contiguity."""
    if not scheme.packed or scheme.weight_format not in PACKED_FORMAT_IDS:
        raise ValueError(f"{what}: {scheme.name!r} is not a packed scheme")
    for name, t, dtype, dim in (("x", x, torch.bfloat16, 3),
                                ("packed", packed, torch.int32, 3),
                                ("scales", scales, torch.float32, 3),
                                ("expert_idx", expert_idx, torch.int32, 1),
                                ("rows", rows, torch.int32, 1)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dim}-D "
                             "tensor")
    g, m, k = x.shape
    e, n = packed.shape[0], packed.shape[2]
    per = codes_per_word(scheme.weight_bits)
    if packed.shape[1] * per != k:
        raise ValueError(f"{what}: x has K={k}, packed holds "
                         f"{packed.shape[1] * per} rows")
    group = effective_group(scheme.group_size, k)
    if k % group or group % per or scales.shape != (e, k // group, n):
        raise ValueError(f"{what}: scales {tuple(scales.shape)} do not tile "
                         f"{e} experts of K={k} in groups of {group}")
    if expert_idx.shape != (g,) or rows.shape != (g,):
        raise ValueError(f"{what}: expert_idx and rows must be [{g}]")
    if not 1 <= g <= 65535 or m < 1:
        raise ValueError(f"{what}: {g} groups of {m} rows")
    return g, e, m, k, n, group


def _grouped_dispatch(x, packed, scales, scheme, expert_idx, rows, what):
    """None for CPU tensors (take the plain version); raises for a device
    the kernels do not run on."""
    if x.device.type == "cpu":
        if any(t.device.type != "cpu"
               for t in (packed, scales, expert_idx, rows)):
            raise ValueError(f"{what}: x on the CPU, the rest elsewhere")
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    return _check_grouped(x, packed, scales, scheme, expert_idx, rows, what)


def grouped_gemv_plan(k: int, n: int,
                      scheme: QuantScheme) -> Tuple[int, int, int]:
    """(stage_k, chunk_k, fold_k): the grouped body's order of sums, a
    function of the leaf alone (never of G, M, the items' rows or the
    routing, so a row's output is the same whatever shares its launch).  A
    unit (an item's columns) walks K in stages of stage_k (64 word rows,
    or 32 where K / per is an odd multiple of 32, so that no stage runs
    past K); each of its columns' 4 (or, at N >= 1536, 2) K warps takes
    chunk w (chunk_k) of every stage and folds scale x partial every
    fold_k of K in K order (fold_k = min(group, chunk_k); K for a
    per-channel scale, which multiplies the warp's whole sum once); a
    column's output is its K warps' sums added in order, w0 + w1 + ...
    Raises for a scale group that is neither K, a multiple of stage_k, nor
    a divisor of stage_k (in whole 4-word units) that divides or is a
    multiple of chunk_k."""
    per = codes_per_word(scheme.weight_bits)
    group = effective_group(scheme.group_size, k)
    rows = k // per
    stage_rows = 32 if rows % 64 and rows % 32 == 0 else 64
    k_warps = _GK_WARPS // (2 if n >= 1536 else 1)
    unit, chunk = 4 * per, stage_rows // k_warps * per
    stage = stage_rows * per
    if not (group == k or group % stage == 0
            or (group % unit == 0 and stage % group == 0
                and (chunk % group == 0 or group % chunk == 0))):
        raise ValueError(f"grouped body: scale group {group} of a "
                         f"{k} x {n} leaf is neither K, a multiple of "
                         f"{stage}, nor a divisor of {stage} (in units of "
                         f"{unit}) that divides or is a multiple of {chunk}")
    return (stage_rows * per, chunk,
            k if group == k else min(group, chunk))


def grouped_fragments(m: int) -> int:
    """The n8 fragments of the mma's B operand an item of the grouped body
    fills at M rows a group (csrc: gk_fragments): 1 at M <= 8 (items of 8
    rows, grouped K1), 2 at M <= 16, else 4 (items of 16 / 32 rows)."""
    return 1 if m <= 8 else _GK_MID_FRAGS if m <= 16 else 4


def grouped_unit(m: int, n: int) -> Tuple[int, int]:
    """(rows R an item holds at most, columns U a unit spans) of the
    grouped body at M rows a group on a leaf of N columns (csrc:
    gk_fragments, gk_boxes): items of 8 rows in units of 32 (64 at N >=
    1536) at M <= 8; past it items of 16 / 32 rows in units as wide as the
    8 consumer warps' boxes, 32 columns each, over the leaf's K warps (64
    / 128 columns)."""
    k_warps = _GK_WARPS // (2 if n >= 1536 else 1)
    nf = grouped_fragments(m)
    warps = _GK_WARPS if nf == 1 else _GK_WIDE_WARPS
    return 8 * nf, 32 * warps // k_warps


def grouped_work_list(expert_idx: torch.Tensor, rows: torch.Tensor, m: int,
                      r: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the work list the grouped body builds on the card:
    (item_expert [I], item_rows [I, r]).  The sources — row g M + j of x
    and of the output for each group g and j < rows[g] (clamped to [0, M])
    — sorted by expert, ties in (group, row) order, cut into items of at
    most r sources of one expert (r = 8 ``grouped_fragments(m)``; -1 pads
    an item's row list).  An expert of n rows takes ceil(n / r) items, an
    expert with none takes none."""
    e = expert_idx.detach().to("cpu", torch.int64)
    rr = rows.detach().to("cpu", torch.int64).clamp(0, m)
    g = torch.arange(len(e)).repeat_interleave(rr)
    first = torch.cumsum(rr, 0) - rr
    src = g * m + torch.arange(len(g)) - first[g]       # g M + row in group
    se = e[g]
    order = torch.sort(se, stable=True).indices
    src, se = src[order], se[order]
    # rank within the expert's sources, then items of r
    start = torch.searchsorted(se, se, right=False)
    rank = torch.arange(len(se)) - start
    new_item = rank % r == 0
    item = torch.cumsum(new_item.to(torch.int64), 0) - 1
    n_items = int(new_item.sum())
    item_expert = se[new_item]
    item_rows = torch.full((n_items, r), -1, dtype=torch.int64)
    item_rows[item, rank % r] = src
    return item_expert, item_rows


def packed_gemv_grouped_ordered(x: torch.Tensor, packed: torch.Tensor,
                                scales: torch.Tensor, scheme: QuantScheme,
                                expert_idx: torch.Tensor,
                                rows: torch.Tensor) -> torch.Tensor:
    """Plain torch in the grouped body's order (``grouped_gemv_plan``), at
    any M, row by row (each row's ops the same whatever shares the call,
    so a row's output is bit for bit the same alone or in any batch): K
    warp w's sum adds, in K order, the group scale times x_row @ codes (the
    codes as K1 decodes them to bf16, exact) over each fold of its chunks
    (a per-channel scale times the sum of its chunks' products, once); the
    output is the warps' sums added in order.  Rows past ``rows[g]`` are
    zero.  Only the order inside one fold's x @ codes (the tensor cores')
    and the fused multiply-add of a fold are not replayed."""
    g, m, k = x.shape
    n = packed.shape[-1]
    group = effective_group(scheme.group_size, k)
    stage_k, chunk_k, fold_k = grouped_gemv_plan(k, n, scheme)
    warps = stage_k // chunk_k
    xf = x.reshape(g * m, k).to(torch.float32)
    out = torch.zeros((g * m, n), dtype=torch.float32, device=x.device)
    item_expert, item_rows = grouped_work_list(expert_idx, rows, m)
    vals = {}
    for e, srcs in zip(item_expert.tolist(), item_rows.tolist()):
        if e not in vals:
            vals[e] = bf16_from_bits(kernel_decode_bf16(
                scheme, unpack_codes(packed[e], scheme.weight_bits))).to(
                    torch.float32)
        v, sc = vals[e], scales[e]
        for row in (s_ for s_ in srcs if s_ >= 0):
            xr = xf[row:row + 1]
            total = None
            for w in range(warps):
                acc = torch.zeros((1, n), dtype=torch.float32,
                                  device=x.device)
                for c0 in range(w * chunk_k, k, stage_k):
                    c1 = min(c0 + chunk_k, k)
                    for f0 in range(c0, c1, fold_k):
                        f1 = min(f0 + fold_k, c1)
                        prod = xr[:, f0:f1] @ v[f0:f1]
                        acc += prod if group == k else sc[f0 // group] * prod
                if group == k:
                    acc = sc[0] * acc
                total = acc if total is None else total + acc
            out[row] = total[0]
    return out.reshape(g, m, n)


_TENSOR_MAPS: Dict[tuple, ctypes.Array] = {}


def _grouped_tensor_maps(lib, packed: torch.Tensor, scales: torch.Tensor,
                         e: int, k: int, n: int, m: int, fmt: int,
                         group: int) -> ctypes.Array:
    """The TMA tensor maps of a stack (``grouped_gemv_tensor_maps``),
    encoded once per leaf and unit width (items of 8 rows, or wider): a
    map holds no more than the addresses, shapes and boxes of its key, so
    a cached one is right for any tensor there."""
    wide = grouped_fragments(m) > 1
    key = (packed.data_ptr(), scales.data_ptr(), e, k, n, fmt, group, wide)
    maps = _TENSOR_MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(256)
        err = lib.grouped_gemv_tensor_maps(packed.data_ptr(),
                                           scales.data_ptr(), e, k, n, m,
                                           fmt, group, maps)
        if err != 0:
            raise RuntimeError("grouped body: cuTensorMapEncodeTiled "
                               f"failed (CUresult {err})")
        _TENSOR_MAPS[key] = maps
    return maps


def grouped_refusal(m: int, e: int, k: int, n: int, packed_ptr: int,
                    scales_ptr: int, scheme: QuantScheme):
    """Why the grouped body does not take a stack of ``e`` leaves of K x N
    at M rows a group (None where it does): N % 4 != 0, words or scales not
    16-byte aligned, more than 512 experts, or a scale group
    ``grouped_gemv_plan`` refuses.  Shape arithmetic only."""
    leaf = f"{e} experts of {k} x {n} ({scheme.name}) at M = {m}"
    if n % 4 or packed_ptr % 16 or scales_ptr % 16:
        return (f"the grouped body needs N % 4 == 0 and 16-byte aligned "
                f"words and scales: {leaf}")
    if e > _GK_MAX_EXPERTS:
        return (f"the grouped body takes at most {_GK_MAX_EXPERTS} "
                f"experts: {leaf}")
    try:
        grouped_gemv_plan(k, n, scheme)
    except ValueError as err:
        return f"{err}: {leaf}"
    return None


def _grouped_launch(name: str, x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, scheme: QuantScheme,
                    expert_idx: torch.Tensor, rows: torch.Tensor,
                    dims) -> torch.Tensor:
    """Launch the grouped body for wrapper ``name``: one launch, more only
    past 6144 rows of x (each launch taking whole groups)."""
    g, e, m, k, n, group = dims
    why = grouped_refusal(m, e, k, n, packed.data_ptr(), scales.data_ptr(),
                          scheme)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    fmt = PACKED_FORMAT_IDS[scheme.weight_format]
    xk = matmul_x_operand(x.reshape(g * m, k),
                          4 * codes_per_word(scheme.weight_bits))
    out = torch.empty((g, m, n), dtype=torch.float32, device=x.device)
    lib = build.load("packed_matmul", _SIGNATURES)
    step = max(1, _GK_MAX_ROWS // m)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        maps = _grouped_tensor_maps(lib, packed, scales, e, k, n, m, fmt,
                                    group)
        for g0 in range(0, g, step):
            gs = min(step, g - g0)
            err = lib.packed_gemv_grouped(
                xk[g0 * m:].data_ptr(), xk.shape[1], maps, scales.data_ptr(),
                out[g0:].data_ptr(), expert_idx[g0:].data_ptr(),
                rows[g0:].data_ptr(), gs, e, m, k, n, fmt, group, stream)
            build.check(lib, f"{name} ({gs} groups of M = {m}, {e} experts "
                             f"of {k} x {n})", err)
            launches[name] += 1
            format_launches[name, scheme.weight_format] += 1
            grouped_row_launches[name, m] += 1
    return out


def packed_gemv_grouped(x: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, scheme: QuantScheme,
                        expert_idx: torch.Tensor,
                        rows: torch.Tensor) -> torch.Tensor:
    """Grouped K1: x [G, M, K] bf16 with 1 <= M <= 8, through the grouped
    body in items of 8 rows."""
    dims = _grouped_dispatch(x, packed, scales, scheme, expert_idx, rows,
                             "packed_gemv_grouped")
    if dims is None:
        return packed_grouped_plain(x, packed, scales, scheme, expert_idx,
                                    rows)
    if not 1 <= dims[2] <= GEMV_MAX_M:
        raise ValueError(f"packed_gemv_grouped takes 1 <= M <= {GEMV_MAX_M}, "
                         f"got {dims[2]} (packed_matmul_grouped takes any)")
    return _grouped_launch("packed_gemv_grouped", x, packed, scales, scheme,
                           expert_idx, rows, dims)


def packed_matmul_grouped(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor, scheme: QuantScheme,
                          expert_idx: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """Grouped K2: x [G, M, K] bf16, any M >= 1 (the route past 8 rows),
    through the grouped body in items of ``8 grouped_fragments(M)``
    rows."""
    dims = _grouped_dispatch(x, packed, scales, scheme, expert_idx, rows,
                             "packed_matmul_grouped")
    if dims is None:
        return packed_grouped_plain(x, packed, scales, scheme, expert_idx,
                                    rows)
    return _grouped_launch("packed_matmul_grouped", x, packed, scales,
                           scheme, expert_idx, rows, dims)
