"""The port's paged KV pool against the JAX reference and against its own
slab pool, on the CPU at granite-smoke / minitron-smoke size.

* ``PageAllocator``: the port's and the reference's driven by the same
  seeded tapes of admit, ensure, register, free and preempt-resume have
  equal tables, refcounts, returned copies, LRU order and counters after
  every operation, and both pass ``check()``.
* Budget sizing: ``bytes_per_page`` / ``pages_for_budget`` equal the
  reference's on the four dense configs' FULL shapes (counted on ``meta``).
* ``gather_pages`` equals the reference's exactly; the paged decode
  attention twin equals ``paged_decode_attention_ref`` to one bf16 ulp.
* Serving: ``ServeConfig(paged=True)`` gives the slab pool's tokens bit for
  bit (greedy and temperature rows, mid-flight admission, partial and
  full-cover prefix hits, a small arena that queues and evicts, every KV
  tier and the three together, preempt-resume past cached pages, bursts),
  with the page invariant checked after every step of a contended run;
  its schedule and its greedy tokens are the reference's paged engine's.
* W8A8 (minitron): paged equals slab where the schedules are equal.
* On the card (``gpu``): K3 / K4 on a gathered slab equal the plain twin.
Every test draws from its own ``np.random.default_rng``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ref import paged_decode_attention_ref
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant import kv_cache as RKV
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.schemes import get_kv_scheme as ref_kv_scheme
from repro.quant.schemes import kv_quantize as ref_kv_quantize
from repro.serve import PageAllocator as RefAllocator
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro.serve import bytes_per_page as ref_bytes_per_page
from repro.serve import pages_for_budget as ref_pages_for_budget
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as DA
from repro_torch.quant import kv_cache as KV
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.quant.schemes import get_kv_scheme, kv_quantize
from repro_torch.serve import (PageAllocator, PagedKVPool, Request,
                               SamplingParams, Scheduler, ServeConfig,
                               ServingEngine, bytes_per_page,
                               pages_for_budget)

ATTN_TOL = dict(rtol=2.0 ** -7, atol=1e-5)        # one bf16 ulp
DENSE = ["granite-8b", "minitron-8b", "starcoder2-15b", "nemotron-4-340b"]
TIERS = ("bf16", "int8", "fp8")


# ---------------------------------------------------------------------------
# PageAllocator: the port's against the reference's, operation by operation
# ---------------------------------------------------------------------------
def _state(a):
    return {"table": a.table.tolist(), "refcounts": a.refcounts.tolist(),
            "free_pages": sorted(a._free_pages),
            "free_slots": sorted(a._free_slots),
            "evictable": list(a.evictable),
            "page_key": sorted((p, repr(k)) for p, k in a.page_key.items()),
            "reserve": a._slot_reserve.tolist(), "reserved": a._reserved,
            "evictions": a.n_evictions, "cow": a.n_cow_copies,
            "in_use": a.pages_in_use, "cached": a.pages_cached}


def _same(port, ref, out_port, out_ref, op):
    assert out_port == out_ref, op
    assert _state(port) == _state(ref), op
    port.check()
    ref.check()


@pytest.mark.parametrize("seed", range(20))
def test_allocator_equals_reference_on_seeded_tapes(seed):
    """Scheduler-shaped tapes over a 3-token alphabet (prefix hits, copies
    and evictions happen often): admit, prefill (ensure + register once the
    prompt is in), decode (ensure within the reservation), free, and
    preempt-resume (free mid-decode, re-admit prompt + generated[:-1] at
    the reduced budget)."""
    rng = np.random.default_rng(seed)
    ps, align = 4, 2
    n_slots = int(rng.integers(1, 5))
    pps = int(rng.integers(2, 6))
    n_pages = int(rng.integers(1 + pps, 2 + n_slots * pps + 2))
    port = PageAllocator(n_pages, ps, n_slots, pps, align=align)
    ref = RefAllocator(n_pages, ps, n_slots, pps, align=align)
    cap = ps * pps
    live, waiting = {}, []       # slot -> [tokens, max_new, committed]
    n_admitted = 0
    for _ in range(120):
        op = rng.choice(["admit", "admit", "prefill", "decode", "free",
                         "preempt"])
        if op == "admit":
            if waiting and rng.random() < 0.5:
                tokens, max_new = waiting.pop(0)
            else:
                p = int(rng.integers(1, cap))
                tokens = [int(t) for t in rng.integers(0, 3, p)]
                max_new = int(rng.integers(1, cap - p + 1))
            got, want = port.admit(tokens, max_new), ref.admit(tokens,
                                                               max_new)
            _same(port, ref, got, want, op)
            if got is not None:
                live[got[0]] = [tokens, max_new, got[1]]
                n_admitted += 1
        elif op == "prefill" and live:
            slot = int(rng.choice(sorted(live)))
            tokens, _, done = live[slot]
            if done < len(tokens):
                upto = done - done % align + align
                got = port.ensure(slot, done, upto)
                _same(port, ref, got, ref.ensure(slot, done, upto), op)
                live[slot][2] = done = min(upto, len(tokens))
                if done == len(tokens):
                    _same(port, ref, port.register_prefix(slot, tokens),
                          ref.register_prefix(slot, tokens), "register")
        elif op == "decode" and live:
            slot = int(rng.choice(sorted(live)))
            tokens, max_new, done = live[slot]
            limit = min(len(tokens) + max_new, cap)
            if len(tokens) <= done < limit:
                upto = int(rng.integers(done + 1, limit + 1))
                got = port.ensure(slot, done, upto)
                _same(port, ref, got, ref.ensure(slot, done, upto), op)
                live[slot][2] = upto
        elif op in ("free", "preempt") and live:
            slot = int(rng.choice(sorted(live)))
            tokens, max_new, done = live.pop(slot)
            port.free_slot(slot)
            ref.free_slot(slot)
            _same(port, ref, None, None, op)
            gen = done - len(tokens)
            if op == "preempt" and gen > 1:
                waiting.append((tokens + [int(t) for t in
                                          rng.integers(0, 3, gen - 1)],
                                max_new - gen + 1))
    for slot in sorted(live):
        port.free_slot(slot)
        ref.free_slot(slot)
    _same(port, ref, None, None, "drain")
    assert port.pages_in_use == 0
    assert port.pages_free + port.pages_cached == n_pages - 1
    assert n_admitted > 0


def test_allocator_copy_on_write_and_eviction_lifecycle():
    """Register a prompt's page, adopt it on a full-cover hit (one copy on
    write, prefill at ((P-1)//C)*C), then evict it for a request that needs
    the whole arena; both allocators agree at every step."""
    port = PageAllocator(4, 4, 2, 3, align=2)
    ref = RefAllocator(4, 4, 2, 3, align=2)
    prompt = [1, 2, 3, 4]

    def both(name, *args):
        got, want = getattr(port, name)(*args), getattr(ref, name)(*args)
        _same(port, ref, got, want, name)
        return got

    assert both("admit", prompt, 2) == (0, 0, 0, [])
    both("ensure", 0, 0, 4)
    assert both("register_prefix", 0, prompt) == 1
    both("free_slot", 0)
    assert port.pages_cached == 1
    assert both("admit", prompt, 2) == (0, 2, 4, [(1, 2)])
    assert port.n_cow_copies == 1
    both("free_slot", 0)
    assert both("admit", [0] * 9, 3) == (0, 0, 0, [])
    both("ensure", 0, 0, 12)
    assert port.n_evictions == 1 and port.pages_cached == 0
    assert port.match(prompt) == []
    both("free_slot", 0)


# ---------------------------------------------------------------------------
# Budget sizing on the four dense configs' FULL shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("arch", DENSE)
def test_budget_sizing_equals_reference(arch, tier):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    per = bytes_per_page(pcfg, 64, kv_dtype=tier)
    assert per == ref_bytes_per_page(rcfg, 64, kv_dtype=tier)
    for budget in (9 * per, 9 * per + 1, 16 * per - 1, 150_994_944,
                   75_497_472, 3 * 2**30):
        kw = dict(kv_dtype=tier, page_size=64, align=64)
        try:
            want = ref_pages_for_budget(rcfg, 512, budget, **kw)
        except ValueError:
            with pytest.raises(ValueError, match="too small"):
                pages_for_budget(pcfg, 512, budget, **kw)
            continue
        assert pages_for_budget(pcfg, 512, budget, **kw) == want
    with pytest.raises(ValueError, match="too small"):
        pages_for_budget(pcfg, 512, 9 * per - 1, kv_dtype=tier,
                         page_size=64, align=64)


def test_granite_paged_path_budgets():
    """The on-card path's arenas: 144 MiB of bf16 pages and 72 MiB of int8
    pages of 64 positions at granite-8b FULL."""
    cfg = get_config("granite-8b")
    assert bytes_per_page(cfg, 64) == 9_437_184
    assert bytes_per_page(cfg, 64, kv_dtype="int8") == 4_866_048
    assert pages_for_budget(cfg, 512, 150_994_944, page_size=64,
                            align=64) == 16
    assert pages_for_budget(cfg, 512, 75_497_472, kv_dtype="int8",
                            page_size=64, align=64) == 15


# ---------------------------------------------------------------------------
# Gather and paged attention
# ---------------------------------------------------------------------------
def _arena_and_table(tier, rng, n_pages=7, ps=4, hk=2, dh=16):
    """A seeded arena (bf16, or codes + scales quantized by the reference)
    and a ragged table with shared entries and unmapped (0) ones."""
    vals = rng.normal(size=(n_pages, ps, hk, dh)).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [1, 3, 4, 0], [5, 6, 6, 2]], np.int32)
    if tier == "bf16":
        ref = jnp.asarray(vals, jnp.bfloat16)
        port = torch.as_tensor(np.asarray(ref.astype(jnp.float32))).to(
            torch.bfloat16)
        return ref, port, table
    packed, scales = ref_kv_quantize(ref_kv_scheme(tier),
                                     jnp.asarray(vals, jnp.bfloat16))
    ref = RKV.QuantizedKV(packed, scales, tier)
    port = KV.QuantizedKV(torch.as_tensor(np.asarray(packed)),
                          torch.as_tensor(np.asarray(scales)), tier)
    return ref, port, table


def _np(x):
    if isinstance(x, KV.QuantizedKV):
        return [x.packed.numpy(), x.scales.numpy()]
    if isinstance(x, RKV.QuantizedKV):
        return [np.asarray(x.packed), np.asarray(x.scales)]
    if isinstance(x, torch.Tensor):
        return [x.to(torch.float32).numpy()]
    return [np.asarray(x.astype(jnp.float32))]


@pytest.mark.parametrize("tier", TIERS)
def test_gather_pages_equals_reference(tier):
    rng = np.random.default_rng(31)
    ref, port, table = _arena_and_table(tier, rng)
    want = RKV.gather_pages(ref, jnp.asarray(table))
    got = KV.gather_pages(port, torch.as_tensor(table, dtype=torch.int64))
    for w, g in zip(_np(want), _np(got)):
        np.testing.assert_array_equal(g, w)
    assert _np(got)[0].shape[:2] == (3, 16)


@pytest.mark.parametrize("tier", TIERS)
def test_paged_write_then_gather_equals_a_slab_write(tier):
    """``cache_write_pages`` through a table then ``gather_pages`` holds the
    bytes a slab write at the same [row, position] holds (decode rows and
    one chunk-aligned prefill row)."""
    rng = np.random.default_rng(32)
    _, arena, _ = _arena_and_table(tier, rng)
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 0]])
    vals = torch.as_tensor(rng.normal(size=(2, 1, 2, 16)),
                           dtype=torch.float32).to(torch.bfloat16)
    pos = torch.tensor([[5], [9]])
    slab = KV.gather_pages(arena, table)
    KV.cache_write_rows(slab, vals, torch.arange(2), pos[:, 0])
    KV.cache_write_pages(arena, vals, table, pos)
    for w, g in zip(_np(slab), _np(KV.gather_pages(arena, table))):
        np.testing.assert_array_equal(g, w)
    chunk = torch.as_tensor(rng.normal(size=(1, 4, 2, 16)),
                            dtype=torch.float32).to(torch.bfloat16)
    row = table[1:]
    slab = KV.gather_pages(arena, row)
    KV.cache_write_slice(slab, chunk, 8)
    KV.cache_write_pages(arena, chunk, row, torch.arange(8, 12)[None])
    for w, g in zip(_np(slab), _np(KV.gather_pages(arena, row))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tier", TIERS)
def test_paged_decode_attention_plain_equals_reference(tier):
    rng = np.random.default_rng(33)
    k_ref, k_port, table = _arena_and_table(tier, rng)
    v_ref, v_port, _ = _arena_and_table(tier, rng)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    lens = np.array([5, 13, 16], np.int32)
    want = paged_decode_attention_ref(jnp.asarray(q, jnp.bfloat16), k_ref,
                                      v_ref, table, jnp.asarray(lens))
    qt = torch.as_tensor(np.asarray(jnp.asarray(q, jnp.bfloat16)
                                    .astype(jnp.float32))).to(torch.bfloat16)
    got = DA.paged_decode_attention_plain(
        qt, k_port, v_port, torch.as_tensor(table, dtype=torch.int64),
        torch.as_tensor(lens))
    torch.testing.assert_close(got.float(),
                               torch.as_tensor(np.asarray(
                                   want.astype(jnp.float32))), **ATTN_TOL)


# ---------------------------------------------------------------------------
# Serving: paged against slab, bit for bit
# ---------------------------------------------------------------------------
def _smoke_weights(arch):
    cfg = ref_config(arch, smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = get_config(arch, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


@pytest.fixture(scope="module")
def weights():
    return _smoke_weights("granite-8b")


def _engine(weights, tier="bf16", **kw):
    _, _, pcfg, port = weights
    kw.setdefault("max_len", 48)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pcfg, port, ServeConfig(
        policy=PrecisionPolicy(kv=tier), device="cpu", **kw))


def _prompts(vocab, lens, rng):
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _family(vocab, rng, prefix_len, suffixes):
    """Prompts sharing one ``prefix_len`` prefix, each with a suffix of the
    given length (0: the prefix alone)."""
    pre = rng.integers(1, vocab, (prefix_len,)).astype(np.int32)
    return [np.concatenate([pre, rng.integers(1, vocab, (n,))
                            .astype(np.int32)]) for n in suffixes]


def _serve(engine, jobs, *, late=(), tiers=None, max_new=6, check=None,
           request_cls=Request, sampling_cls=SamplingParams,
           scheduler_cls=Scheduler):
    """Serve ``jobs`` [(id, prompt, temperature, tier)]; the ids in
    ``late`` are submitted once the earlier ones have all emitted a token.
    ``check(sched)`` runs after every step.  Returns (sched, {id: req})."""
    sched = scheduler_cls(engine, tiers=tiers)
    reqs = {}

    def submit(job):
        rid, prompt, temp, tier = job
        reqs[rid] = sched.submit(request_cls(
            prompt=prompt, id=rid, kv_policy=tier,
            sampling=sampling_cls(temperature=temp, max_new_tokens=max_new,
                                  seed=7)))

    for job in jobs:
        if job[0] not in late:
            submit(job)
    pending = [j for j in jobs if j[0] in late]
    for _ in range(2000):
        if not (sched.has_work or pending):
            break
        if pending and all(r.n_generated > 0 for r in reqs.values()):
            submit(pending.pop(0))
        sched.step()
        if check is not None:
            check(sched)
    assert not sched.has_work and not pending
    assert all(r.is_finished and r.n_generated == max_new
               for r in reqs.values())
    return sched, reqs


def _tokens(reqs):
    return {rid: list(r.output_tokens) for rid, r in reqs.items()}


def _jobs(prompts, temps=None, tier=None):
    temps = temps or [0.0] * len(prompts)
    return [(i, p, t, tier) for i, (p, t) in enumerate(zip(prompts, temps))]


def _page_invariant(sched):
    """After a step: every allocator invariant, and no page with refcount
    > 1 under any running row's write position."""
    for pool in sched.pools.values():
        alloc = pool.allocator
        alloc.check()
        for (tier, slot), _ in sched.running.items():
            if sched.pools[tier] is not pool:
                continue
            pos = int(pool.lengths[slot])
            if pos < pool.capacity:
                page = int(pool.page_table[slot, pos // pool.page_size])
                assert page == 0 or alloc.refcounts[page] == 1, \
                    (slot, pos, page)


def test_paged_greedy_and_temperature_equal_slab(weights):
    """Mixed lengths (page-aligned, ragged, under one page), greedy and
    seeded temperature rows, two admitted mid-flight."""
    rng = np.random.default_rng(40)
    prompts = _prompts(weights[2].vocab, (8, 6, 10, 17, 3), rng)
    jobs = _jobs(prompts, [0.0, 0.8, 0.0, 0.9, 0.0])
    _, slab = _serve(_engine(weights), jobs)
    sched, paged = _serve(_engine(weights, paged=True), jobs, late={3, 4},
                          check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)
    pool = sched.pool
    assert isinstance(pool, PagedKVPool) and pool.paged
    assert pool.n_pages == 1 + 4 * 6 and pool.page_size == 8
    assert pool.pages_in_use == 0


def test_prefix_hits_partial_and_full_cover_equal_slab(weights):
    """A 16-token prefix (two pages): later requests adopt it (prefill
    resumes at 16), and prompts that are exactly the prefix re-prefill only
    their final chunk after a copy-on-write of its page."""
    rng = np.random.default_rng(41)
    prompts = _family(weights[2].vocab, rng, 16, (5, 0, 9, 0, 12))
    jobs = _jobs(prompts, [0.0, 0.0, 0.8, 0.0, 0.0])
    _, slab = _serve(_engine(weights, n_slots=5), jobs)
    eng = _engine(weights, n_slots=5, paged=True)
    sched, paged = _serve(eng, jobs, late={1, 2, 3, 4},
                          check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)
    pool = sched.pool
    assert [paged[i].prefix_hit_tokens for i in range(5)] == \
        [0, 16, 16, 16, 16]
    assert pool.n_prefix_hits == 4 and pool.n_prefix_misses == 1
    assert pool.prefix_hit_tokens_total == 64
    assert pool.n_cow_copies == 2            # the two full-cover hits
    rep = sched.metrics.report()
    assert rep["prefix_hits"] == 4 and rep["prefix_hit_tokens"] == 64
    assert rep["ttft_hit_p50_s"] is not None
    assert rep["pages"]["bf16"]["cow_copies"] == 2


def test_full_cover_hit_prefills_only_the_final_chunk(weights):
    """A prompt of exactly two cached pages: admission starts prefill at
    ((P-1)//C)*C = 8 after copying that page, one prefill chunk runs, and
    the first token has its logits: the tokens of the first serve."""
    rng = np.random.default_rng(42)
    (prompt,) = _family(weights[2].vocab, rng, 16, (0,))
    eng = _engine(weights, paged=True)
    sched = Scheduler(eng)
    sp = SamplingParams(max_new_tokens=4)
    first = sched.submit(Request(prompt=prompt, sampling=sp))
    sched.run(max_steps=100)
    calls = []
    prefill = eng.prefill_chunk_into_slot

    def counted(*a, **kw):
        calls.append(a[3])
        return prefill(*a, **kw)

    eng.prefill_chunk_into_slot = counted
    again = sched.submit(Request(prompt=prompt, sampling=sp))
    sched.run(max_steps=100)
    assert (again.prefix_hit_tokens, calls) == (16, [8])
    assert sched.pool.n_cow_copies == 1
    assert again.output_tokens == first.output_tokens
    want = _engine(weights).generate({"tokens": prompt[None]},
                                      max_new_tokens=4)
    assert first.output_tokens == list(want["generated"][0])


def test_small_arena_queues_evicts_and_drains(weights):
    """An arena of 9 pages (8 usable; a request here needs up to 4): the
    queue waits for pages with slots free, cache-only pages are evicted,
    and every request gets its slab tokens."""
    rng = np.random.default_rng(43)
    prompts = (_family(weights[2].vocab, rng, 16, (4, 7, 0, 2))
               + _prompts(weights[2].vocab, (13, 7, 20), rng))
    jobs = _jobs(prompts, [0.0, 0.8, 0.0, 0.0, 0.0, 0.7, 0.0])
    _, slab = _serve(_engine(weights, max_len=32), jobs, max_new=8)
    per = bytes_per_page(weights[2], 8)
    eng = _engine(weights, max_len=32, paged=True,
                  cache_budget_bytes=9 * per)
    held = []

    def check(sched):
        _page_invariant(sched)
        held.append(bool(sched.waiting) and sched.pool.n_free > 0)

    sched, paged = _serve(eng, jobs, late={1, 2, 3}, max_new=8, check=check)
    assert _tokens(paged) == _tokens(slab)
    pool = sched.pool
    assert pool.n_pages == 9 and any(held)
    assert pool.n_evictions >= 1 and pool.n_prefix_hits >= 2
    assert pool.pages_in_use == 0
    assert pool.pages_free + pool.pages_cached == pool.n_pages - 1
    rep = sched.metrics.report()["pages"]["bf16"]
    assert rep["free_min"] == 0 and rep["evictions"] == pool.n_evictions


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_quantized_tier_paged_equals_slab(weights, tier):
    rng = np.random.default_rng(44)
    prompts = _family(weights[2].vocab, rng, 8, (3, 11, 0, 6))
    jobs = _jobs(prompts, [0.0, 0.8, 0.0, 0.0])
    _, slab = _serve(_engine(weights, tier), jobs)
    sched, paged = _serve(_engine(weights, tier, paged=True), jobs,
                          late={2, 3}, check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)
    assert sched.pool.kv_dtype == tier and sched.pool.n_prefix_hits >= 2


def test_three_tiers_in_one_paged_engine_equal_slab(weights):
    """One paged engine, a page arena per tier, bf16 / int8 / fp8 requests
    side by side: each request's slab tokens."""
    rng = np.random.default_rng(45)
    prompts = _family(weights[2].vocab, rng, 8, (2, 9, 5, 0, 7, 12))
    jobs = [(i, p, t, tier) for i, (p, t, tier) in enumerate(zip(
        prompts, (0.0, 0.7, 0.0, 0.0, 0.9, 0.0),
        ("bf16", "int8", "fp8", "bf16", "int8", "fp8")))]
    _, slab = _serve(_engine(weights, n_slots=2), jobs, tiers=list(TIERS))
    sched, paged = _serve(_engine(weights, n_slots=2, paged=True), jobs,
                          tiers=list(TIERS), late={3, 4, 5},
                          check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)
    assert all(p.paged for p in sched.pools.values())
    assert set(sched.metrics.report()["pages"]) == set(TIERS)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "temp"])
def test_preempt_resume_past_cached_pages_equals_slab(weights, temp):
    """Two slots, two low-class decoders, a high-class arrival preempts
    one.  On the paged pool the victim's resume adopts its registered
    prompt pages and re-prefills only the tail; its tokens are the slab
    pool's preempt-resume tokens (same schedule: full provisioning)."""
    rng = np.random.default_rng(46)
    prompts = _prompts(weights[2].vocab, (9, 16, 12), rng)
    runs = {}
    for paged in (False, True):
        eng = _engine(weights, n_slots=2, paged=paged)
        sp = SamplingParams(temperature=temp, max_new_tokens=24, seed=7)
        s = Scheduler(eng)
        s.submit(Request(prompts[1], sp, id=1, priority=5))
        s.submit(Request(prompts[2], sp, id=2, priority=5))
        for _ in range(5):
            s.step()
        s.submit(Request(prompts[0], sp, id=0, priority=0))
        starts = {}
        while s.has_work:
            s.step()
            for r in s.running.values():
                if r.n_preemptions and r.id not in starts:
                    starts[r.id] = r.prefix_hit_tokens
            if paged:
                _page_invariant(s)
        runs[paged] = ({r.id: list(r.output_tokens) for r in s.finished},
                       starts, s)
    assert runs[True][0] == runs[False][0]
    starts, s = runs[True][1], runs[True][2]
    assert len(starts) >= 1 and all(v >= 8 for v in starts.values())
    assert sum(r.n_preemptions for r in s.finished) >= 1


def test_paged_bursts_equal_single_steps(weights):
    rng = np.random.default_rng(47)
    prompts = _family(weights[2].vocab, rng, 8, (4, 0, 13))
    jobs = _jobs(prompts, [0.0, 0.0, 0.9])
    outs = {}
    for k in (1, 8):
        sched, reqs = _serve(_engine(weights, paged=True, max_burst=k),
                             jobs, max_new=12, check=_page_invariant)
        outs[k] = _tokens(reqs)
        hist = sched.metrics.burst_hist
        assert (max(hist) > 1) == (k > 1)
    assert outs[1] == outs[8]


def test_page_invariant_holds_after_every_step_of_a_contended_run(weights):
    """Nine requests, two prefix families, temperature rows, bursts and an
    arena of 12 pages: ``check()`` and no shared page under a running row's write
    position after every step; the engine's garbage rows (free and
    mid-prefill slots) write only unmapped entries or private pages."""
    rng = np.random.default_rng(48)
    vocab = weights[2].vocab
    prompts = (_family(vocab, rng, 16, (3, 0, 11, 6))
               + _family(vocab, rng, 8, (9, 0, 14, 2, 5)))
    per = bytes_per_page(weights[2], 8)
    eng = _engine(weights, max_len=40, paged=True,
                  cache_budget_bytes=12 * per)
    steps = []

    def check(sched):
        _page_invariant(sched)
        steps.append(sched.n_steps)

    jobs = _jobs(prompts, [0.0, 0.8, 0.0, 0.0, 0.7, 0.0, 0.0, 0.0, 0.9])
    sched, paged = _serve(eng, jobs, late={1, 2, 3, 6, 7, 8}, max_new=10,
                          check=check)
    _, slab = _serve(_engine(weights, max_len=40), jobs, max_new=10)
    assert _tokens(paged) == _tokens(slab)
    pool = sched.pool
    assert len(steps) > 10 and pool.n_prefix_hits >= 4
    assert pool.n_cow_copies >= 1


def test_paged_config_validation(weights):
    with pytest.raises(ValueError, match="page_size"):
        _engine(weights, paged=True, page_size=12)
    eng = _engine(weights, paged=True, page_size=16)
    pool = eng.new_pool()
    assert (pool.page_size, pool.pages_per_slot, pool.capacity) == (16, 3, 48)
    per = bytes_per_page(weights[2], 16)
    with pytest.raises(ValueError, match="too small"):
        _engine(weights, paged=True, page_size=16,
                cache_budget_bytes=3 * per).new_pool()


def test_page_size_two_chunks_equals_slab(weights):
    """Pages of two chunks (16 positions): a prefix hit covers whole pages
    only, and the tokens stay the slab pool's (the plain path has no
    split that the virtual slab's length could move)."""
    rng = np.random.default_rng(49)
    prompts = _family(weights[2].vocab, rng, 16, (5, 0, 21))
    jobs = _jobs(prompts)
    _, slab = _serve(_engine(weights), jobs)
    sched, paged = _serve(_engine(weights, paged=True, page_size=16), jobs,
                          late={1, 2}, check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)
    assert sched.pool.n_prefix_hits == 2


# ---------------------------------------------------------------------------
# Against the reference's paged engine
# ---------------------------------------------------------------------------
def _ref_jobs_run(weights, jobs, late, per):
    cfg, params, _, _ = weights
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=40, n_slots=4, prefill_chunk=8, paged=True,
        cache_budget_bytes=12 * per,
        policy=RefPolicy(kv="bf16", kernel="pallas")))
    return _serve(ref, jobs, late=late, max_new=8, request_cls=RefRequest,
                  sampling_cls=RefSamplingParams,
                  scheduler_cls=RefScheduler)


def test_schedule_and_greedy_tokens_equal_reference_paged_engine(weights):
    """The same requests on the reference's meshless paged engine
    (``PrecisionPolicy(kernel='pallas')``) and on the port's: equal prefix
    hits, copies, evictions and final allocator state (the schedule is
    host logic), and equal greedy tokens."""
    rng = np.random.default_rng(50)
    vocab = weights[2].vocab
    prompts = (_family(vocab, rng, 16, (3, 0, 11))
               + _family(vocab, rng, 8, (9, 0, 14)))
    jobs = _jobs(prompts)
    late = {1, 2, 4, 5}
    per = bytes_per_page(weights[2], 8)
    ref_sched, ref_reqs = _ref_jobs_run(weights, jobs, late, per)
    eng = _engine(weights, max_len=40, paged=True,
                  cache_budget_bytes=12 * per)
    sched, reqs = _serve(eng, jobs, late=late, max_new=8)
    rpool, pool = ref_sched.pool, sched.pool
    assert pool.n_pages == rpool.n_pages == 12
    assert (pool.n_prefix_hits, pool.n_prefix_misses,
            pool.prefix_hit_tokens_total) == (
        rpool.n_prefix_hits, rpool.n_prefix_misses,
        rpool.prefix_hit_tokens_total)
    assert (pool.n_cow_copies, pool.n_evictions) == (
        rpool.allocator.n_cow_copies, rpool.allocator.n_evictions)
    assert _state(pool.allocator) == _state(rpool.allocator)
    assert [reqs[i].prefix_hit_tokens for i in range(6)] == \
        [ref_reqs[i].prefix_hit_tokens for i in range(6)]
    assert _tokens(reqs) == _tokens(ref_reqs)


# ---------------------------------------------------------------------------
# W8A8: paged equals slab where the schedules are equal
# ---------------------------------------------------------------------------
def test_w8a8_paged_equals_slab_under_full_provisioning():
    """minitron-smoke: one activation scale spans every row of a call, so
    garbage rows could move live ones; with distinct one-chunk prompts, one
    slot per request and full provisioning, both pools run the same
    schedule with the same row contents, and the tokens are equal."""
    weights = _smoke_weights("minitron-8b")
    rng = np.random.default_rng(51)
    prompts = _prompts(weights[2].vocab, (8, 5, 7, 3), rng)
    jobs = _jobs(prompts, [0.0, 0.8, 0.0, 0.0])
    _, slab = _serve(_engine(weights), jobs, max_new=8)
    _, paged = _serve(_engine(weights, paged=True), jobs, max_new=8,
                      check=_page_invariant)
    assert _tokens(paged) == _tokens(slab)


# ---------------------------------------------------------------------------
# On the card: K3 / K4 on a gathered slab against the plain twin
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tier", TIERS)
def test_decode_kernel_on_gathered_slab_matches_plain_twin(cuda_device, tier):
    """granite's heads (32 / 8, Dh 128), 8 rows over a table of 8 pages of
    64 (shared and unmapped entries): K3 / K4 on ``gather_pages``' slab
    equal ``paged_decode_attention_plain`` to one bf16 ulp, launching
    once; the gathered codes meet the kernel's 16-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    n_pages, ps, hk, dh, h = 40, 64, 8, 128, 32
    vals = torch.randn((2, n_pages, ps, hk, dh), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    arenas = []
    for a in vals:
        if tier == "bf16":
            arenas.append(a)
        else:
            packed, scales = kv_quantize(get_kv_scheme(tier), a)
            arenas.append(KV.QuantizedKV(packed, scales, tier))
    rng = np.random.default_rng(52)
    table = torch.as_tensor(rng.integers(1, n_pages, (8, 8)),
                            device=cuda_device)
    table[:, 6:] = 0
    table[1] = table[0]
    lens = torch.as_tensor([384, 1, 37, 383, 200, 64, 129, 300],
                           device=cuda_device)
    q = torch.randn((8, 1, h, dh), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    k, v = (KV.gather_pages(a, table) for a in arenas)
    base = k.packed if tier != "bf16" else k
    assert base.is_contiguous() and base.data_ptr() % 16 == 0
    before = sum(DA.launches.values())
    got = DA.gqa_decode_attention(q, k, v, lens)
    assert sum(DA.launches.values()) == before + 1
    want = DA.paged_decode_attention_plain(q, *arenas, table, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
