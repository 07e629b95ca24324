"""Quantized KV-cache storage (torch twin of ``repro/quant/kv_cache.py``).

A bf16 KV slab ``[..., S, H, D]`` becomes

  packed  [..., S, H, D/4]  int32  — 4 8-bit codes per word, little-endian
  scales  [..., S, H]       f32    — one absmax scale per (position, head)

``QuantizedKV`` carries the pair.  The write primitives quantize on write
and, unlike the reference's pure functions, **update the slab in place**
(the serving pool owns one preallocated cache; copying it per step would
double its memory traffic).  They also return the slab, so call sites read
like the reference.
"""
from __future__ import annotations

import torch

from .schemes import get_kv_scheme, kv_dequantize, kv_quantize


class QuantizedKV:
    """One quantized KV slab: packed codes + per-(position, head) scales."""

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor,
                 scheme_name: str):
        self.packed = packed
        self.scales = scales
        self.scheme_name = scheme_name

    def __getitem__(self, idx) -> "QuantizedKV":
        """Index the leading dims of codes and scales in lockstep (views)."""
        return QuantizedKV(self.packed[idx], self.scales[idx],
                           self.scheme_name)

    def __repr__(self):
        return f"QuantizedKV({self.scheme_name}, packed{tuple(self.packed.shape)})"


def kv_dtype_name(kv_dtype) -> str:
    """Canonical name of the pool dtype knob ('bf16' | 'int8' | 'fp8')."""
    scheme = get_kv_scheme(kv_dtype)
    return scheme.name if scheme is not None else "bf16"


def kv_slab(shape, kv_dtype, device) -> torch.Tensor | QuantizedKV:
    """A zeroed slab of logical ``shape`` [..., S, H, D] at ``kv_dtype``."""
    scheme = get_kv_scheme(kv_dtype)
    if scheme is None:
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    d = shape[-1]
    if d % 4:
        raise ValueError(f"d_head {d} not divisible by 4 (KV code packing)")
    return QuantizedKV(
        torch.zeros(tuple(shape[:-1]) + (d // 4,), dtype=torch.int32,
                    device=device),
        torch.zeros(tuple(shape[:-1]), dtype=torch.float32, device=device),
        scheme.name)


def cache_write_slice(slab, vals: torch.Tensor, offset: int):
    """Write ``vals`` [B, S, ...] into ``slab`` at sequence position
    ``offset`` (axis 1), in place — the prefill-chunk write."""
    s = vals.shape[1]
    if isinstance(slab, QuantizedKV):
        packed, scales = kv_quantize(get_kv_scheme(slab.scheme_name), vals)
        slab.packed[:, offset:offset + s] = packed
        slab.scales[:, offset:offset + s] = scales
        return slab
    slab[:, offset:offset + s] = vals.to(slab.dtype)
    return slab


def cache_write_rows(slab, vals: torch.Tensor, rows: torch.Tensor,
                     offsets: torch.Tensor):
    """Per-row scatter (decode), in place: row i of ``vals`` [B, 1, ...]
    lands at ``slab[rows[i], offsets[i]]``."""
    if isinstance(slab, QuantizedKV):
        packed, scales = kv_quantize(get_kv_scheme(slab.scheme_name), vals)
        slab.packed[rows, offsets] = packed[:, 0]
        slab.scales[rows, offsets] = scales[:, 0]
        return slab
    slab[rows, offsets] = vals[:, 0].to(slab.dtype)
    return slab


def cache_read(slab, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense view of a slab: dequantize ``QuantizedKV``, pass bf16 through."""
    if isinstance(slab, QuantizedKV):
        return kv_dequantize(get_kv_scheme(slab.scheme_name), slab.packed,
                             slab.scales, dtype)
    return slab
