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
twice the bf16 slots of the same budget.  An MLA model's pool holds the
latent cache (c_kv, k_rope), bf16 only: (kv_lora + d_head_rope) x 2 bytes
a token a layer (deepseek-v2: 1152).

Neither pool holds the static-batch families (``STATIC_BATCH_FAMILIES``:
xLSTM and Zamba2, whose recurrent state a slot pool cannot hold, and the
VLM, whose patch prefix the chunked prefill does not carry): the engine
serves them through its static-batch loop, and their pools raise
ValueError (the reference's pools refuse the recurrent families; its
pool path cannot run a VLM either, its chunk step passing no patches).

``PagedKVPool`` (the reference's paged pool) stores each layer's cache as
a page arena [L, n_pages, page_size, Hk, Dh] instead, with a page table
per slot over it: pages are allocated as a request's committed length
grows, refcounted, shared copy-on-write between requests whose prompts
match page by page, and evicted LRU when the arena runs dry
(``PageAllocator``, pure host bookkeeping).  A budget buys pages
(``pages_for_budget``), not worst-case slots.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import STATIC_BATCH_FAMILIES, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.quant.kv_cache import QuantizedKV, kv_dtype_name


def check_poolable(cfg: ModelConfig, pool: str) -> None:
    if cfg.family in STATIC_BATCH_FAMILIES:
        raise ValueError(
            f"{pool} does not hold the static-batch families "
            f"{STATIC_BATCH_FAMILIES}, so not {cfg.family!r} (recurrent "
            "state and patch prefixes are served by the engine's "
            "static-batch loop)")


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
    check_poolable(cfg, "a slot pool")
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
    paged = False       # one slab row per slot: no page table

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_dtype="bf16", align: int = 1, device="cuda"):
        """``align``: allocation granularity of the sequence axis (the
        engine passes its prefill chunk, so every chunk's write window fits
        the slab); reads stay bounded by the per-row valid lengths."""
        check_poolable(cfg, "KVCachePool")
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


# ===========================================================================
# Paged pool: one refcounted page arena per layer + per-slot page tables
# ===========================================================================
#
# Page 0 is a reserved garbage page: every unmapped table entry points at
# it, so the steps need no masking on the write or the gather; its bytes
# are only ever gathered into positions >= the row's valid length, which
# attention masks to exact zero.
#
# The invariant the steps rely on: **no shared page sits under any slot's
# write position.**  A decode step writes a KV row at ``lengths[slot]``
# for every slot, free and mid-prefill ones included.  ``ensure`` keeps
# that harmless: before a step may write positions [lengths, upto) of a
# slot, every page covering them is made private (entry 0 gets a fresh
# page, a shared entry a copy-on-write duplicate).  Any other write lands
# on a private page or on page 0.

_ROOT_KEY = ("kv-prefix-root",)


def bytes_per_page(cfg: ModelConfig, page_size: int, *,
                   kv_dtype="bf16") -> int:
    """Cache bytes one arena page costs (all layers, K and V, scales
    included), from the shapes ``T.init_cache`` allocates, on ``meta``."""
    return _cache_bytes(T.init_cache(cfg, 1, page_size, kv_dtype=kv_dtype,
                                     device="meta"))


def pages_for_budget(cfg: ModelConfig, max_len: int, budget_bytes: int, *,
                     kv_dtype="bf16", page_size: int, align: int = 1) -> int:
    """How many arena pages a cache budget buys at ``kv_dtype``: the
    budget over the bytes of a page, with no worst-case rounding per
    request.  Raises below the floor of the garbage page plus one
    ``max_len`` request (so admission can always make progress)."""
    if page_size < 1 or align < 1 or page_size % align:
        raise ValueError(f"page_size {page_size} must be a positive "
                         f"multiple of the prefill chunk {align}")
    per = bytes_per_page(cfg, page_size, kv_dtype=kv_dtype)
    n = int(budget_bytes) // per
    capacity = -(-max_len // page_size) * page_size
    floor = 1 + capacity // page_size           # garbage page + one slot
    if n < floor:
        raise ValueError(
            f"cache budget {budget_bytes} B < {floor} pages of {page_size} "
            f"positions ({per} B/page at kv_dtype={kv_dtype_name(kv_dtype)!r})"
            f" — too small for one {max_len}-position request")
    return n


class PageAllocator:
    """Host bookkeeping of the page arena: free list, refcounts, page
    tables, a content-keyed prefix cache and LRU eviction.  Pure Python
    over numpy, no device tensors; the only device effect it asks for is
    a page copy: mutating calls return ``(src, dst)`` copies for the owner
    to run on the arena.

    ``refcounts[p]`` is the number of table entries equal to ``p``, plus 1
    while the prefix cache holds ``p``.  A page at refcount 0 is free; a
    registered page at refcount 1 is held by the cache alone and waits in
    the LRU queue ``evictable``: eviction unregisters it and hands it out
    as a fresh page.

    Prefix keys are nested content tuples, ``key_i = (key_{i-1},
    tuple(tokens[i*ps:(i+1)*ps]))``: exact token-chain equality, so
    adopting a cached page is always sound.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int, *, align: int = 1):
        if n_pages < 1 + pages_per_slot:
            raise ValueError(
                f"an arena of {n_pages} pages cannot hold the garbage page "
                f"and one slot ({pages_per_slot} pages)")
        if page_size % align:
            raise ValueError(f"page_size {page_size} must be a multiple of "
                             f"the prefill chunk {align}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.align = align
        self.capacity = pages_per_slot * page_size
        # page 0 is the garbage page: never allocated
        self._free_pages: List[int] = list(range(1, n_pages))
        heapq.heapify(self._free_pages)
        self.refcounts = np.zeros((n_pages,), np.int32)
        self.table = np.zeros((n_slots, pages_per_slot), np.int32)
        self._free_slots: List[int] = list(range(n_slots))
        heapq.heapify(self._free_slots)
        self.prefix_map: Dict[tuple, int] = {}   # chain key -> page id
        self.page_key: Dict[int, tuple] = {}     # page id -> chain key
        self.evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU
        # pages promised to admitted requests' growth, so a later
        # admission cannot strand an in-flight request mid-decode
        self._slot_reserve = np.zeros((n_slots,), np.int32)
        self._reserved = 0
        self.n_evictions = 0
        self.n_cow_copies = 0

    # -- page lifecycle ----------------------------------------------------
    def _evict_lru(self) -> int:
        page, _ = self.evictable.popitem(last=False)     # least recent
        key = self.page_key.pop(page)
        del self.prefix_map[key]
        self.refcounts[page] -= 1                        # the cache ref
        if self.refcounts[page] != 0:
            raise RuntimeError(f"evicted page {page} is still referenced")
        self.n_evictions += 1
        return page

    def _alloc_page(self, slot: int) -> int:
        if self._free_pages:
            page = heapq.heappop(self._free_pages)
        elif self.evictable:
            page = self._evict_lru()
        else:
            raise RuntimeError(
                "page arena exhausted: admission reservations should make "
                "this unreachable")
        self.refcounts[page] = 1
        if self._slot_reserve[slot] > 0:
            self._slot_reserve[slot] -= 1
            self._reserved -= 1
        return page

    def _deref(self, page: int) -> None:
        self.refcounts[page] -= 1
        rc = int(self.refcounts[page])
        if rc < 0:
            raise RuntimeError(f"refcount underflow on page {page}")
        if page in self.page_key:
            if rc < 1:
                raise RuntimeError(f"registered page {page} lost its "
                                   "cache ref")
            if rc == 1:      # cache-only now: evictable, at the MRU end
                self.evictable[page] = None
                self.evictable.move_to_end(page)
        elif rc == 0:
            heapq.heappush(self._free_pages, page)

    def _ref(self, page: int) -> None:
        self.refcounts[page] += 1
        if page in self.evictable:       # in use again: not evictable
            del self.evictable[page]

    # -- prefix cache ------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """The cached pages covering the longest page-aligned cached
        prefix of ``tokens``."""
        key = _ROOT_KEY
        pages: List[int] = []
        ps = self.page_size
        for i in range(min(len(tokens) // ps, self.pages_per_slot)):
            key = (key, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            page = self.prefix_map.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def _admission_plan(self, tokens: Sequence[int], max_new: int):
        p = len(tokens)
        ps = self.page_size
        need_total = min(-(-(p + max_new) // ps), self.pages_per_slot)
        pages = self.match(tokens)
        hit_tokens = len(pages) * ps
        full_cover = hit_tokens >= p
        if full_cover:
            # re-prefill only the final chunk, for the first token's
            # logits; ``ensure`` copies its page on write
            prefill_pos = ((p - 1) // self.align) * self.align
        else:
            prefill_pos = hit_tokens
        need_new = need_total - len(pages) + (1 if full_cover else 0)
        return pages, hit_tokens, prefill_pos, need_new

    def can_admit(self, tokens: Sequence[int], max_new: int) -> bool:
        if not self._free_slots:
            return False
        pages, _, _, need_new = self._admission_plan(tokens, max_new)
        adopted_evictable = sum(1 for p in pages if p in self.evictable)
        avail = (len(self._free_pages) + len(self.evictable)
                 - adopted_evictable - self._reserved)
        return avail >= need_new

    def admit(self, tokens: Sequence[int], max_new: int
              ) -> Optional[Tuple[int, int, int, List[Tuple[int, int]]]]:
        """Adopt the request's cached prefix pages and reserve room for its
        worst-case growth: ``(slot, prefill_pos, hit_tokens, copies)``, or
        None when no slot or too few pages are free.  Prefill resumes at
        ``prefill_pos``; ``copies`` are ``(src, dst)`` page copies for the
        caller to run."""
        if not self.can_admit(tokens, max_new):
            return None
        pages, hit_tokens, prefill_pos, need_new = \
            self._admission_plan(tokens, max_new)
        slot = heapq.heappop(self._free_slots)
        for i, page in enumerate(pages):
            self.table[slot, i] = page
            self._ref(page)
        self._slot_reserve[slot] = need_new
        self._reserved += need_new
        # the page under prefill_pos (the next write) must be private now:
        # on a full-cover hit it is an adopted shared page, copied here
        copies = self.ensure(slot, prefill_pos, prefill_pos + 1)
        return slot, prefill_pos, hit_tokens, copies

    def ensure(self, slot: int, committed: int, upto: int
               ) -> List[Tuple[int, int]]:
        """Make every page covering positions [committed, upto) of
        ``slot`` private: entry 0 gets a fresh page, a shared entry
        (refcount > 1) a copy-on-write duplicate.  Returns the ``(src,
        dst)`` copies to run.  Idempotent; runs before any step may write
        those positions."""
        upto = min(upto, self.capacity)
        copies: List[Tuple[int, int]] = []
        for idx in range(committed // self.page_size,
                         -(-upto // self.page_size)):
            entry = int(self.table[slot, idx])
            if entry == 0:
                self.table[slot, idx] = self._alloc_page(slot)
            elif int(self.refcounts[entry]) > 1:
                fresh = self._alloc_page(slot)
                copies.append((entry, fresh))
                self.table[slot, idx] = fresh
                self._deref(entry)
                self.n_cow_copies += 1
        return copies

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Publish ``slot``'s prefilled whole prompt pages to the prefix
        cache (once, when prefill completes).  A chain already cached is
        not registered again (the slot keeps its private copy).  Returns
        the pages newly registered."""
        key = _ROOT_KEY
        registered = 0
        ps = self.page_size
        for i in range(min(len(tokens) // ps, self.pages_per_slot)):
            key = (key, tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            if key in self.prefix_map:
                continue
            page = int(self.table[slot, i])
            if page == 0:
                raise RuntimeError("registering an unmapped prompt page")
            self.prefix_map[key] = page
            self.page_key[page] = key
            self.refcounts[page] += 1        # the cache ref
            registered += 1
        return registered

    def free_slot(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots or slot in self._free_slots:
            raise ValueError(f"bad free of slot {slot}")
        for idx in range(self.pages_per_slot):
            entry = int(self.table[slot, idx])
            if entry != 0:
                self._deref(entry)
        self.table[slot, :] = 0
        self._reserved -= int(self._slot_reserve[slot])
        self._slot_reserve[slot] = 0
        heapq.heappush(self._free_slots, slot)

    # -- accounting --------------------------------------------------------
    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_cached(self) -> int:
        """Cache-only (refcount-1 registered) pages, evictable LRU."""
        return len(self.evictable)

    @property
    def pages_in_use(self) -> int:
        """Pages held by at least one slot table."""
        return self.n_pages - 1 - self.pages_free - self.pages_cached

    def check(self) -> None:
        """Raise ``AssertionError`` unless every allocator invariant holds
        (the tests' oracle)."""
        def need(cond, msg):
            if not cond:
                raise AssertionError(msg)

        table_refs = np.bincount(self.table.reshape(-1),
                                 minlength=self.n_pages)
        table_refs[0] = 0
        cache_refs = np.zeros((self.n_pages,), np.int64)
        for page in self.page_key:
            cache_refs[page] += 1
        expect = table_refs + cache_refs
        need((self.refcounts == expect).all(),
             f"refcount drift: {self.refcounts.tolist()} != "
             f"{expect.tolist()}")
        free = set(self._free_pages)
        need(len(free) == len(self._free_pages), "duplicate free pages")
        need(0 not in free and 0 not in self.page_key
             and 0 not in self.evictable, "garbage page 0 leaked into lists")
        need(all(self.refcounts[p] == 0 for p in free),
             "free page with live refs")
        need(free.isdisjoint(self.evictable), "page both free and evictable")
        need(all(p in self.page_key and self.refcounts[p] == 1
                 for p in self.evictable), "evictable page not cache-only")
        need(all(self.refcounts[p] >= 1 for p in self.page_key),
             "registered page with no refs")
        need(set(self.prefix_map.values()) == set(self.page_key),
             "prefix_map / page_key out of sync")
        need(self._reserved == int(self._slot_reserve.sum()),
             "reservations out of sync")
        for slot in self._free_slots:
            need((self.table[slot] == 0).all(), "freed slot keeps pages")
        # no leaks: every non-garbage page is free, cache-only or mapped
        accounted = len(free) + int((table_refs > 0).sum()) \
            + sum(1 for p in self.page_key if table_refs[p] == 0)
        need(accounted == self.n_pages - 1,
             f"page leak: {accounted} accounted of {self.n_pages - 1}")


class PagedKVPool:
    """The paged pool behind the scheduler's pool surface (lengths, free,
    n_free / n_used), plus page-aware admission (``admit`` instead of
    ``alloc``), write-window pinning (``ensure`` / ``ensure_decode``) and
    prefix publication (``register_prefix``).  The device state is the
    page arena ``cache`` = (k, v), each [L, n_pages, page_size, Hk, Dh]
    (bf16 or ``QuantizedKV``), written in place; ``page_table`` [n_slots,
    pages_per_slot] lives on the host and goes to the device once per
    dispatch.  All paging policy is the ``PageAllocator``'s.  An MLA
    model's latent cache has no paged pool yet: it raises."""

    paged = True

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_dtype="bf16", align: int = 1,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, device="cuda"):
        """``page_size`` defaults to ``align`` (the prefill chunk);
        ``n_pages`` to full provisioning (every slot's capacity plus the
        garbage page)."""
        check_poolable(cfg, "PagedKVPool")
        if cfg.use_mla:
            raise NotImplementedError(
                f"{cfg.name}: paged pools of the MLA latent cache are not "
                "ported; serve MLA models from a slab pool (paged=False)")
        if n_slots < 1 or max_len < 1 or align < 1:
            raise ValueError("n_slots, max_len and align must be >= 1")
        page_size = align if page_size is None else page_size
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.capacity = -(-max_len // page_size) * page_size
        self.pages_per_slot = self.capacity // page_size
        if n_pages is None:
            n_pages = 1 + n_slots * self.pages_per_slot
        self.n_pages = n_pages
        self.kv_dtype = kv_dtype_name(kv_dtype)
        self.allocator = PageAllocator(n_pages, page_size, n_slots,
                                       self.pages_per_slot, align=align)
        self.cache = T.init_cache(cfg, n_pages, page_size,
                                  kv_dtype=self.kv_dtype, device=device)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.n_prefix_hits = 0
        self.n_prefix_misses = 0
        self.prefix_hit_tokens_total = 0

    @property
    def page_table(self) -> np.ndarray:
        return self.allocator.table

    @property
    def cache_bytes(self) -> int:
        return _cache_bytes(self.cache)

    @property
    def bytes_per_token(self) -> int:
        """Arena bytes one cached position costs across all layers."""
        return self.cache_bytes // (self.n_pages * self.page_size)

    @property
    def n_free(self) -> int:
        return self.allocator.n_free_slots

    @property
    def n_used(self) -> int:
        return self.n_slots - self.n_free

    @property
    def pages_in_use(self) -> int:
        return self.allocator.pages_in_use

    @property
    def pages_cached(self) -> int:
        return self.allocator.pages_cached

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free

    @property
    def n_evictions(self) -> int:
        return self.allocator.n_evictions

    @property
    def n_cow_copies(self) -> int:
        return self.allocator.n_cow_copies

    def admit(self, tokens: Sequence[int], max_new: int
              ) -> Optional[Tuple[int, int, int]]:
        """``(slot, prefill_pos, hit_tokens)``, or None when no slot or too
        few pages are free.  ``prefill_pos > 0``: the prompt's first
        ``hit_tokens`` positions were adopted from the prefix cache, and
        prefill resumes there (on a full-cover hit it reruns only the
        final chunk, for its logits)."""
        out = self.allocator.admit(tokens, max_new)
        if out is None:
            return None
        slot, prefill_pos, hit_tokens, copies = out
        self.lengths[slot] = prefill_pos
        self._run_copies(copies)
        if hit_tokens > 0:
            self.n_prefix_hits += 1
            self.prefix_hit_tokens_total += hit_tokens
        else:
            self.n_prefix_misses += 1
        return slot, prefill_pos, hit_tokens

    def ensure(self, slot: int, upto: int) -> None:
        """Pin the write window [lengths[slot], upto): allocate or copy
        pages so a step may write there without touching shared pages."""
        self._run_copies(self.allocator.ensure(
            slot, int(self.lengths[slot]), upto))

    def ensure_decode(self, slots: Sequence[int], k: int = 1,
                      rems: Optional[Sequence[int]] = None) -> None:
        """Pin every decoding slot's write window for a ``k``-step
        dispatch, capped by ``rems`` (each slot's remaining new tokens):
        a row that stops mid-burst writes on at its frozen length, into
        an unmapped entry (the garbage page) or its own private page, so
        only the positions it commits need pages.  This keeps allocation
        within the admission reservation."""
        for i, slot in enumerate(slots):
            kk = k if rems is None else min(k, int(rems[i]))
            self.ensure(slot, int(self.lengths[slot]) + kk)

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Publish the prompt's whole pages once prefill completes."""
        return self.allocator.register_prefix(slot, tokens)

    def free(self, slot: int) -> None:
        """Retire a request: shared pages stay with their other holders,
        cache-only pages become evictable, private ones free."""
        self.allocator.free_slot(slot)
        self.lengths[slot] = 0

    def _run_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Copy-on-write in place: every layer's page ``dst`` takes page
        ``src``'s bytes, codes and scales alike."""
        for src, dst in copies:
            for slab in self.cache:
                leaves = [slab.packed, slab.scales] \
                    if isinstance(slab, QuantizedKV) else [slab]
                for a in leaves:
                    a[:, dst] = a[:, src]
