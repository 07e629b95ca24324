"""Flash-decode attention over the KV pool: CUDA kernel and plain version.

Torch side of ``csrc/decode_attention.cu`` (which replaces the Pallas
kernels ``repro/kernels/decode_attention.py:_decode_bf16_kernel`` and
``_decode_quant_kernel``).  Sq == 1 GQA attention: q [B, 1, H, Dh] bf16
over a slab [B, Sk, Hk, Dh] — bf16, or a ``QuantizedKV`` of int8 / fp8
codes packed four per int32 word plus per-(position, head) f32 scales —
attending positions < ``kv_valid_len[b]``.  Query head h reads KV head
h // (H / Hk).  Scores, softmax and the value sum are f32; the output is
bf16.  A row with ``kv_valid_len == 0`` gets equal weights over all Sk
positions of its slab (the mean of V), as in the reference, where every
score is then masked to the same -1e30.

``gqa_decode_attention`` launches the kernel on CUDA tensors and returns
``decode_attention_plain`` on CPU tensors.  The kernel takes H % Hk == 0,
H / Hk <= 16 and Dh % 4 == 0 up to 256 (every layout of the reference's
configs: Dh 16 to 192, H / Hk up to 12); its grid is a fixed split of Sk
(``split_plan``), so the host never reads ``kv_valid_len``.  ``launches``
counts kernel launches by slab kind ("decode_attention_bf16" /
"decode_attention_quant").
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.quant.kv_cache import QuantizedKV, cache_read

from . import build

launches: Dict[str, int] = {"decode_attention_bf16": 0,
                            "decode_attention_quant": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_attention": [_P] * 10 + [_I] * 7
               + [ctypes.c_float, _P]}
_KIND = {"bf16": 0, "int8": 1, "fp8": 2}
_NEG = -1e30
TILE = 32                 # positions per tile
SPAN = 64                 # positions per block: two tiles
WARPS = 4                 # warps per block; warp w takes positions
GROUP = 8                 # [GROUP w, GROUP (w + 1)) of each tile
MAX_DH = 256              # dims per lane up to 8
MAX_REP = 16              # query heads per KV head: 4 per warp


def query_scale(dh: int) -> float:
    """The f32 prescale 1/sqrt(Dh) applied to q before the dot products."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def decode_attention_plain(q: torch.Tensor, k_cache, v_cache,
                           kv_valid_len: torch.Tensor) -> torch.Tensor:
    """Plain torch: dequantize the slabs to f32, masked f32 softmax over
    all Sk positions (masked scores -1e30, so an empty row weighs every
    position equally), f32 value sum, / max(l, 1e-30)."""
    b, sq, h, dh = q.shape
    if sq != 1:
        raise ValueError("decode attention is the Sq == 1 path")
    k = cache_read(k_cache, torch.float32).to(torch.float32)
    v = cache_read(v_cache, torch.float32).to(torch.float32)
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    qg = (q[:, 0].to(torch.float32) * query_scale(dh)).reshape(b, hk, rep, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k)               # [B, Hk, rep, Sk]
    pos = torch.arange(sk, device=q.device)
    valid = pos[None, :] < kv_valid_len.to(q.device)[:, None]   # [B, Sk]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v) / torch.clamp(l, min=1e-30)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def split_plan(sk: int):
    """(span, splits): the kernel's fixed split of the sequence into spans
    of SPAN positions (two tiles of TILE), ceil(Sk / SPAN) of them.  It
    depends on the slab length only, never on ``kv_valid_len``: spans past
    a row's length exit at once on the card."""
    return SPAN, -(-sk // SPAN)


def copy_width(row_bytes: int, *ptrs: int) -> int:
    """The kernel's cp.async width for a slab: 16, 8 or 4 bytes, the
    largest that divides a (position, head) row's bytes and every slab
    address."""
    for w in (16, 8, 4):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    raise ValueError(f"KV rows of {row_bytes} bytes at {ptrs} are not "
                     "4-byte aligned")


def gqa_decode_attention(q: torch.Tensor, k_cache, v_cache,
                         kv_valid_len: torch.Tensor) -> torch.Tensor:
    """Fused decode attention: q [B, 1, H, Dh] bf16 over bf16 or
    ``QuantizedKV`` slabs; kv_valid_len [B] int (>= 0 per row).  Returns
    [B, 1, H, Dh] bf16."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: no kernel for device {q.device}")
    quant = isinstance(k_cache, QuantizedKV)
    if quant != isinstance(v_cache, QuantizedKV):
        raise TypeError("k_cache and v_cache must share one storage kind")
    b, sq, h, dh = q.shape
    kslab = k_cache.packed if quant else k_cache
    vslab = v_cache.packed if quant else v_cache
    sk, hk = kslab.shape[1], kslab.shape[2]
    kind = _KIND[k_cache.scheme_name if quant else "bf16"]
    if quant and v_cache.scheme_name != k_cache.scheme_name:
        raise TypeError("k_cache and v_cache must share one KV scheme")
    if sq != 1 or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("q must be a contiguous bf16 [B, 1, H, Dh] tensor")
    if h % hk or h // hk > MAX_REP or dh > MAX_DH or dh % 4:
        raise ValueError(f"unsupported head layout H={h} Hk={hk} Dh={dh} "
                         f"(needs H % Hk == 0, H / Hk <= {MAX_REP}, "
                         f"Dh <= {MAX_DH}, Dh % 4 == 0; no config of the "
                         "reference exceeds H / Hk = 12 or Dh = 192)")
    want = (b, sk, hk, dh // 4 if quant else dh)
    slab_dtype = torch.int32 if quant else torch.bfloat16
    tensors = [kslab, vslab]
    if quant:
        tensors += [k_cache.scales, v_cache.scales]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("KV slabs must be contiguous, on q's device")
    for t in (kslab, vslab):
        if tuple(t.shape) != want or t.dtype != slab_dtype:
            raise ValueError(f"KV slab {tuple(t.shape)} {t.dtype}, expected "
                             f"{want} {slab_dtype}")
    if quant:
        for t in (k_cache.scales, v_cache.scales):
            if tuple(t.shape) != (b, sk, hk) or t.dtype != torch.float32:
                raise ValueError("KV scales must be f32 [B, Sk, Hk]")
    lens = kv_valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    if tuple(lens.shape) != (b,):
        raise ValueError(f"kv_valid_len must be [B]={b}, got {tuple(lens.shape)}")

    _, splits = split_plan(sk)
    chunk = copy_width(2 * dh if not quant else dh, kslab.data_ptr(),
                       vslab.data_ptr())
    part_m = torch.empty((b, h, splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, splits, dh), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, 1, h, dh), dtype=torch.bfloat16, device=q.device)
    ks = k_cache.scales.data_ptr() if quant else 0
    vs = v_cache.scales.data_ptr() if quant else 0
    lib = build.load("decode_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), kslab.data_ptr(), vslab.data_ptr(), ks, vs,
            lens.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), b, sk, h, hk, dh, kind,
            chunk, query_scale(dh),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "decode_attention", err)
    launches["decode_attention_quant" if quant else "decode_attention_bf16"] += 1
    return out
