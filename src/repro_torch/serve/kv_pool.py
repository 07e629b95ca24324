"""Slot-based KV-cache pool for continuous batching.

One cache ``(k, v)`` of stacked slabs [n_layers, n_slots, capacity, Hk, Dh]
(bf16, or int8 / fp8 ``QuantizedKV``) is allocated once on the device and
shared by every request: a request checks a slot (one batch row) out for
its lifetime and returns it on retirement.  Shapes never change, so every
step runs on the same tensors; admission, retirement and reuse are host
bookkeeping plus in-place writes.

Freed slots are not zeroed: every read is masked by the per-row valid
length, and the next tenant's prefill overwrites [0, P) before any read.
``lengths[slot]`` is the number of committed positions of a slot.

Capacity is a function of KV bytes per token: ``slots_for_budget`` turns
a cache-memory budget into a slot count at a tier, so the int8 / fp8
tiers (Dh code bytes plus one f32 scale per position and head) fit about
twice the bf16 slots of the same budget.
"""
from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.quant.kv_cache import QuantizedKV, kv_dtype_name


def _cache_bytes(cache) -> int:
    """Bytes of a (k, v) cache: bf16 slabs, or codes plus scales."""
    leaves = []
    for slab in cache:
        leaves += ([slab.packed, slab.scales] if isinstance(slab, QuantizedKV)
                   else [slab])
    return sum(t.numel() * t.element_size() for t in leaves)


def bytes_per_slot(cfg: ModelConfig, max_len: int, *, kv_dtype="bf16",
                   align: int = 1) -> int:
    """Cache bytes one slot costs (all layers, K and V, scales included),
    from the shapes ``T.init_cache`` allocates, on the ``meta`` device
    (nothing is allocated)."""
    capacity = -(-max_len // align) * align
    return _cache_bytes(T.init_cache(cfg, 1, capacity, kv_dtype=kv_dtype,
                                     device="meta"))


def slots_for_budget(cfg: ModelConfig, max_len: int, budget_bytes: int, *,
                     kv_dtype="bf16", align: int = 1) -> int:
    """How many ``max_len`` slots a cache budget holds at ``kv_dtype``."""
    per = bytes_per_slot(cfg, max_len, kv_dtype=kv_dtype, align=align)
    n = int(budget_bytes) // per
    if n < 1:
        raise ValueError(
            f"cache budget {budget_bytes} B < one {max_len}-position slot "
            f"({per} B at kv_dtype={kv_dtype_name(kv_dtype)!r})")
    return n


class KVCachePool:
    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_dtype="bf16", align: int = 1, device="cuda"):
        """``align``: allocation granularity of the sequence axis (the
        engine passes its prefill chunk, so every chunk's write window fits
        the slab); reads stay bounded by the per-row valid lengths."""
        if n_slots < 1 or max_len < 1 or align < 1:
            raise ValueError("n_slots, max_len and align must be >= 1")
        self.n_slots = n_slots
        self.max_len = max_len                            # logical capacity
        self.capacity = -(-max_len // align) * align      # allocated positions
        self.kv_dtype = kv_dtype_name(kv_dtype)
        self.cache = T.init_cache(cfg, n_slots, self.capacity,
                                  kv_dtype=self.kv_dtype, device=device)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._free: List[int] = list(range(n_slots))      # min-heap
        heapq.heapify(self._free)

    @property
    def cache_bytes(self) -> int:
        """Allocated bytes of the whole cache (codes and scales)."""
        return _cache_bytes(self.cache)

    @property
    def bytes_per_token(self) -> int:
        """Cache bytes one committed position costs across all layers."""
        return self.cache_bytes // (self.n_slots * self.capacity)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_used / self.n_slots

    def alloc(self) -> Optional[int]:
        """The lowest free slot id, or None when the pool is full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots or slot in self._free:
            raise ValueError(f"bad free of slot {slot}")
        self.lengths[slot] = 0
        heapq.heappush(self._free, slot)

    def room(self, slot: int) -> int:
        """Cache positions still writable in ``slot``."""
        return self.max_len - int(self.lengths[slot])
