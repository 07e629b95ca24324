"""Quantized KV-cache storage (torch twin of ``repro/quant/kv_cache.py``).

A bf16 KV slab ``[..., S, H, D]`` becomes

  packed  [..., S, H, D/4]  int32  — 4 8-bit codes per word, little-endian
  scales  [..., S, H]       f32    — one absmax scale per (position, head)

``QuantizedKV`` carries the pair.  The write primitives quantize on write
and, unlike the reference's pure functions, **update the slab in place**
(the serving pool owns one preallocated cache; copying it per step would
double its memory traffic).  They also return the slab, so call sites read
like the reference.

Paged pools (``serve/kv_pool.PagedKVPool``) keep each layer's cache as a
page arena [n_pages, page_size, ...] with a page table [n_slots,
pages_per_slot] over it.  ``cache_write_pages`` writes new rows through
the table straight into the arena, and ``gather_pages`` materializes the
virtual slab [n_slots, pages_per_slot * page_size, ...] — the layout the
slab pool stores — for the unchanged attention that reads it.  (The
reference gathers, writes into the gathered slab and scatters it all
back; the arena then holds the same bytes on every page but the garbage
page 0, which is never read at an attended position.)
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
    ``offset`` (axis 1), in place — the prefill-chunk write.  A bf16 slab
    may be head-less (MLA's latent and rope slabs, [B, Smax, D])."""
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
    lands at ``slab[rows[i], offsets[i]]`` (head-less bf16 slabs too)."""
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


def cache_write_pages(arena, vals: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor):
    """Write ``vals`` [B, S, ...] through the page table, in place: row b's
    position ``p = positions[b, s]`` lands at ``arena[table[b, p // ps],
    p % ps]``.  ``table`` [B, pages_per_slot] and ``positions`` [B, S] are
    int64 tensors on the arena's device (no host read).  Rows that map to
    one page at one offset (unmapped entries: the garbage page) leave an
    unspecified winner there."""
    base = arena.packed if isinstance(arena, QuantizedKV) else arena
    ps = base.shape[1]
    pages = torch.gather(table, 1, positions // ps).reshape(-1)
    offs = (positions % ps).reshape(-1)
    flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
    if isinstance(arena, QuantizedKV):
        packed, scales = kv_quantize(get_kv_scheme(arena.scheme_name), flat)
        arena.packed[pages, offs] = packed
        arena.scales[pages, offs] = scales
        return arena
    arena[pages, offs] = flat.to(arena.dtype)
    return arena


def gather_pages(arena, table: torch.Tensor):
    """The virtual slab of every table row: ``arena`` [n_pages, page_size,
    ...] (bf16 or ``QuantizedKV``: codes and scales gathered in
    lockstep), ``table`` [n_slots, pages_per_slot] int64 page ids ->
    [n_slots, pages_per_slot * page_size, ...], a fresh contiguous tensor
    in the slab pool's layout."""
    n_slots, pp = table.shape

    def g(a):
        return a[table].reshape((n_slots, pp * a.shape[1]) + a.shape[2:])

    if isinstance(arena, QuantizedKV):
        return QuantizedKV(g(arena.packed), g(arena.scales),
                           arena.scheme_name)
    return g(arena)
