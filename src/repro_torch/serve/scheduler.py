"""Continuous-batching scheduler over slot KV pools, one pool per KV tier
(torch twin of the slab path of ``repro/serve/scheduler.py``).

Each ``step()``:
  0. **Deadline shedding** — WAITING requests past their TTFT or e2e
     deadline retire with ``deadline_exceeded`` (from the clock sample the
     previous step took; no extra clock call).
  1. **Admission** — waiting requests are scanned in (priority, absolute
     TTFT deadline, arrival) order — EDF within a class, requests without
     a deadline after those with one; with no deadlines this is (priority,
     arrival) — skipping those held back after a fault; a request is
     admitted when its tier's pool has a free slot,
     at any time, including mid-flight between decode steps.  When its
     pool is full and a DECODE request of a strictly lower class holds a
     slot of that tier, the lowest-class one with the least output (then
     the youngest) is **preempted**: its slot is freed and it is requeued
     with a resume buffer, prompt + generated[:-1].  With one class this
     is plain FCFS.
  2. **One prefill chunk** — the oldest PREFILL request advances by one
     chunk (chunked prefill interleaved with decode; an SLO policy may
     budget more chunks a round from its cost model).  On a prompt's final
     chunk the first token is sampled (the request's TTFT event); a
     resume's final chunk computes no logits and emits nothing — its
     tokens were delivered before the preemption.
  3. **One decode round per tier** — the DECODE rows are cohorted by KV
     tier (a dispatch runs on one pool), so mixed traffic issues one
     dispatch per active tier per round.  Each cohort's round is a burst
     of K token-steps on the device (``engine.decode_burst``) or a single
     step for K = 1.  K is the least, over the cohort's rows, of the
     tokens a row can still emit before its length or capacity limit,
     capped by ``ServeConfig.max_burst``, rounded down to a power of two, and clamped
     to 1 while a request waits or a prefill is in flight (so admission
     latency and prefill interleaving match a burst-free scheduler).  EOS
     cannot be planned; rows that sample it stop on the device.  An SLO
     policy may cap K further from its cost model.  With speculation on
     and under the same conditions (nothing waiting, no prefill in
     flight), a cohort's round is instead a speculative round when the
     planner gives it a K >= 1: a K-step draft burst on the draft twin and
     one verify dispatch (``spec.py``, ``_decode_spec``).
  4. **E2e deadlines** — running requests past theirs retire with
     ``deadline_exceeded``, keeping the tokens they emitted.

SLO policy: ``Scheduler(engine, slo=SLOPolicy(...))`` (``slo.py``) judges
each ``submit``: it may downgrade the request's KV tier in place (the tier
is re-resolved and counted) or shed it with a typed ``Rejection`` — the
request comes back FINISHED with ``finish_reason='rejected'`` and is never
queued, so callers serving under a policy check ``is_finished``.

Fault fence: every prefill chunk, decode step and burst is fenced.  A
``StepFault`` (raised by the dispatch, e.g. by ``ServeConfig.
fault_injector``), or with an injector armed a decode output holding ids
outside the vocabulary, drops the dispatch's output whole; every request
of it is charged one fault and requeued through the preemption path
(reason 'fault') with a hold of 1, 2, 4, ... steps, or retired with
``finish_reason='fault'`` once past ``ServeConfig.max_fault_retries``.
The fence catches ``StepFault`` and nothing else: any other error (a CUDA
error, a kernel that fails to build or launch) ends the run.

Tiers: ``Scheduler(engine, tiers=["bf16", "int8", "fp8"])`` (or a
{tier: n_slots} mapping) builds one pool per tier from one engine, and a
request picks its tier by ``Request.kv_policy`` (None: the default tier,
the engine policy's when served, else the first listed).  With
``ServeConfig.cache_budget_bytes`` each pool is sized from the budget, so
the int8 / fp8 tiers hold about twice the bf16 slots.

Paged pools (``ServeConfig(paged=True)``): admission needs a slot *and*
the arena pages of the request's worst-case growth (``PagedKVPool.
admit``); a prefix-cache hit adopts the cached prompt pages and prefill
starts past them.  The scan goes on past a waiter refused for pages, so
under page pressure a smaller later request may pass a larger one.  Each
decode dispatch first pins its rows' write windows (``ensure_decode``),
a prompt's whole pages are published to the prefix cache when its
prefill completes, and a preempted request's registered pages stay
cached, so its resume re-prefills only what is not.

Speculation: ``Scheduler(engine, spec=SpecConfig(...))`` drafts on an
int8-KV twin over the same weights and emits, every round, the longest
prefix of the drafts the target agrees with plus the target's next
sample: each emitted token is the plain decode's, bit for bit, at any
acceptance rate.  A killed or poisoned verify goes to the fault path
with the lengths uncommitted; a freed slot's draft state is released.
``n_host_syncs`` counts host syncs where the reference counts them: two
for a prompt's first token, one per decode dispatch, a draft burst and a
verify one each, and one per key schedule of a round with temperature
rows (the reference's comes from the device; the port computes it on the
host, and counts it all the same so that the two tallies compare).

Observability: ``Scheduler(engine, obs=Observability(...))``
(``repro_torch.obs``) attaches a Chrome-trace tracer (each request's
WAITING / PREFILL / DECODE spans at retirement, one event per prefill
chunk, decode dispatch, draft and verify, queue and slot counter
tracks), a metrics registry (the scheduler's gauges and counters, and
``ServeMetrics``'s into the same one) and the model-vs-measured profiler,
each optional, with the reference's hooks and gates, so under one virtual
clock the trace, the exposition, the snapshots and the profiler's report
are the reference's byte for byte.  A dispatch is timed by a clock pair
only when a tracer or a profiler consumes it; the decode pair closes after
the scheduler's read of the sampled ids, the host sync it already makes.
``obs=None`` (the default) takes no extra clock sample and adds no host
sync, dispatch or launch; the bundle adds no host sync either.

Retirement (EOS / max-new-tokens / slot capacity) frees the slot at once.
A token is a pure function of (seed, id, step, logits): the keys of a
round's temperature rows come from the per-(request, step) schedule, so a
request's tokens do not depend on its slot, its batch-mates, its
admission time, a burst, the other tiers or a preemption — except under
W8A8 weights, whose per-tensor activation scale spans every row of a call
(the reference's ``kernels/ops.py:327``), so batch-mates move a row's
logits, and except that on the card a resume replays the KV through
another kernel than the one that first wrote it (``request.py``).  So a
request recovered from a fault emits its fault-free tokens, up to that
caveat.  The clock is injectable for tests.
"""
from __future__ import annotations

import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.obs.trace import PID_REQUESTS, PID_SCHEDULER
from repro_torch.runtime.fault_tolerance import RetryBudget, StepFault

from .kv_pool import KVCachePool
from .metrics import ServeMetrics
from .request import Request, RequestState
from .sampling import batched_step_keys, sample_one
from .spec import DraftEngine, SpecConfig, SpecPlanner, accept_longest_prefix


class Scheduler:
    def __init__(self, engine, *,
                 tiers: Union[None, Sequence[str],
                              Mapping[str, Optional[int]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 slo=None, spec: Optional[SpecConfig] = None, obs=None):
        """``tiers``: the KV tiers served, as names (each pool sized by the
        engine's config) or {tier: n_slots} (None: the config's sizing);
        default one pool at the engine policy's tier.  ``slo``: an
        ``SLOPolicy`` (admission control, tier downgrade, cost-model burst
        and chunk planning); None admits everything.  ``spec``: a
        ``SpecConfig`` (speculative decoding with a low-precision draft
        twin); None changes nothing.  ``obs``: a ``repro_torch.obs.
        Observability`` bundle (tracer, registry, profiler, snapshot
        writer, each optional); None costs nothing."""
        self.engine = engine
        if tiers is None:
            items = [(None, None)]
        else:
            items = list(tiers.items()) if isinstance(tiers, Mapping) \
                else [(t, None) for t in tiers]
            if not items:
                raise ValueError("tiers= must name at least one KV tier")
        self.pools: Dict[str, KVCachePool] = {}
        for tier, n in items:
            pool = engine.new_pool(n_slots=n, kv_dtype=tier)
            if pool.kv_dtype in self.pools:
                raise ValueError(f"duplicate KV tier {pool.kv_dtype!r}")
            self.pools[pool.kv_dtype] = pool
        default = engine.policy.kv
        self.default_tier = default if default in self.pools \
            else next(iter(self.pools))
        self.max_burst = engine.scfg.max_burst
        if self.max_burst < 1:
            raise ValueError("max_burst must be >= 1")
        self.waiting: Deque[Request] = deque()
        self.running: Dict[Tuple[str, int], Request] = {}   # (tier, slot)
        self.finished: List[Request] = []
        self.slo = slo
        # fault recovery: bounded retry with exponential backoff, and the
        # poisoned-output guard (ids in [0, vocab)), armed only with an
        # injector
        self._retry = RetryBudget(engine.scfg.max_fault_retries)
        self._ft_check = engine.scfg.fault_injector is not None
        self.obs = obs
        self.tracer = obs.tracer if obs is not None else None
        self.profiler = obs.profiler if obs is not None else None
        # a dispatch takes its clock pair only when something reads it
        self._timed = self.tracer is not None or self.profiler is not None
        # trace lanes of the scheduler process: tid 0 prefill, 1.. the
        # decode lane of each tier (sorted), then a draft and a verify lane
        # a tier, named only with speculation on
        self._tier_tid = {t: 1 + i for i, t in enumerate(sorted(self.pools))}
        base = 1 + len(self.pools)
        self._spec_tid = {t: (base + 2 * i, base + 2 * i + 1)
                          for i, t in enumerate(sorted(self.pools))}
        if self.tracer is not None:
            self.tracer.process_name(PID_REQUESTS, "requests")
            self.tracer.process_name(PID_SCHEDULER, "scheduler")
            self.tracer.thread_name(PID_SCHEDULER, 0, "prefill")
            for t, tid in sorted(self._tier_tid.items()):
                self.tracer.thread_name(PID_SCHEDULER, tid, f"decode:{t}")
            if spec is not None:
                for t, (dtid, vtid) in sorted(self._spec_tid.items()):
                    self.tracer.thread_name(PID_SCHEDULER, dtid, f"draft:{t}")
                    self.tracer.thread_name(PID_SCHEDULER, vtid,
                                            f"verify:{t}")
        registry = obs.registry if obs is not None else None
        self._r_steps = self._r_queue = self._r_used = None
        self._r_adm = self._r_chunks = self._r_syncs = None
        self._r_hits = self._r_hit_tokens = self._r_pages = None
        self._syncs_published = 0
        if registry is not None:
            self._r_steps = registry.counter(
                "serve_scheduler_steps_total", "scheduling rounds")
            self._r_queue = registry.gauge(
                "serve_queue_depth", "requests WAITING for a KV slot")
            self._r_used = registry.gauge(
                "serve_slots_used", "occupied KV slots, by tier")
            slots_total = registry.gauge(
                "serve_slots_total", "provisioned KV slots, by tier")
            for t, p in sorted(self.pools.items()):
                slots_total.set(p.n_slots, tier=t)
            self._r_adm = registry.counter(
                "serve_admissions_total",
                "WAITING -> PREFILL transitions, by tier")
            self._r_chunks = registry.counter(
                "serve_prefill_chunks_total",
                "prefill chunk dispatches, by tier")
            self._r_syncs = registry.counter(
                "serve_host_syncs_total",
                "blocking device->host transfers on the serving hot path")
            if any(p.paged for p in self.pools.values()):
                self._r_hits = registry.counter(
                    "serve_prefix_hits_total",
                    "admissions that adopted cached prefix pages, by tier")
                self._r_hit_tokens = registry.counter(
                    "serve_prefix_hit_tokens_total",
                    "prompt tokens served from the prefix cache, by tier")
                self._r_pages = registry.gauge(
                    "serve_pages",
                    "page-arena occupancy, by tier and state "
                    "(used / cached / free)")
        self.metrics = ServeMetrics(sum(p.n_slots
                                        for p in self.pools.values()),
                                    registry=registry)
        if len(self.pools) > 1:
            self.metrics.tiers = {t: p.n_slots for t, p in self.pools.items()}
        self._clock = clock
        self._last_now: Optional[float] = None
        self._next_id = 0
        self.n_steps = 0
        self._dispatch_seq = 0      # engine dispatches (prefill and decode)
        self.n_host_syncs = 0       # the reference's tally (module doc)
        self.draft = DraftEngine(engine, spec) if spec is not None else None
        self.spec_planner = SpecPlanner(spec) if spec is not None else None

    @property
    def pool(self) -> KVCachePool:
        """The default tier's pool."""
        return self.pools[self.default_tier]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def n_decode_steps(self) -> int:
        """Decode token-steps run (a burst adds its K)."""
        return self.metrics.decode_token_steps

    @property
    def n_decode_dispatches(self) -> int:
        """Decode dispatches (one per tier cohort per round)."""
        return self.metrics.decode_dispatches

    def _resolve_tier(self, req: Request) -> None:
        """Set ``req.tier``; raise for a tier not served or a request that
        overflows its slot."""
        tier = self.default_tier if req.kv_policy is None else req.kv_policy
        if tier not in self.pools:
            raise ValueError(
                f"request kv_policy={req.kv_policy!r}: no pool at that tier; "
                f"this scheduler serves {sorted(self.pools)} (build it with "
                "Scheduler(engine, tiers=[...]))")
        req.tier = tier
        need = req.prompt_len + req.sampling.max_new_tokens
        if need > self.pools[tier].max_len:
            raise ValueError(f"request needs {need} cache positions > slot "
                             f"capacity {self.pools[tier].max_len}")

    def submit(self, req: Request) -> Request:
        """Enqueue; ids are assigned in submit order and never reused (the
        sampling keys depend on them).  Under an SLO policy the request
        may come back downgraded (``downgraded_from``) or FINISHED with
        ``finish_reason='rejected'`` and ``rejection`` set, never queued."""
        self._resolve_tier(req)
        if req.id is None:
            req.id = self._next_id
        self._next_id = max(self._next_id, req.id) + 1
        req.state = RequestState.WAITING
        req.arrival_time = self._clock()
        req.last_enqueue_time = self._last_now = req.arrival_time
        self.metrics.on_arrival(req.arrival_time)
        if self.slo is not None:
            verdict = self.slo.admit(req, self)
            if req.downgraded_from is not None \
                    and req.tier != req.kv_policy:
                # downgraded in place: re-resolve (and re-check the fit)
                self._resolve_tier(req)
                self.metrics.on_downgrade(req)
            if verdict is not None:
                req.rejection = verdict
                self.metrics.on_reject(req)
                self._finish_unadmitted(req, "rejected", req.arrival_time,
                                        None)
                return req
        self.waiting.append(req)
        return req

    def run(self, max_steps: Optional[int] = None) -> None:
        """Step until every submitted request is FINISHED."""
        steps = 0
        while self.has_work:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(f"scheduler did not drain in {steps} steps")
            self.step()
            steps += 1

    def step(self) -> Dict[str, List]:
        """One scheduling round.  Returns the tokens emitted (``emitted``:
        (request, slot, token)) and the requests retired (``finished``)."""
        emitted: List = []
        finished_now: List[Request] = []
        self._shed_expired_waiting(finished_now)
        admitted = self._admit()
        n_chunks = 1 if self.slo is None \
            else self.slo.prefill_chunks_per_step(self)
        for _ in range(n_chunks):
            if not self._prefill_one_chunk(emitted, finished_now):
                break

        dec = sorted((r for r in self.running.values()
                      if r.state is RequestState.DECODE), key=lambda r: r.id)
        spec_ok = (self.spec_planner is not None and not self.waiting
                   and not any(r.state is RequestState.PREFILL
                               for r in self.running.values()))
        for tier in sorted({r.tier for r in dec}):
            cohort = [r for r in dec if r.tier == tier]
            pool = self.pools[tier]
            if spec_ok:
                ks = self.spec_planner.plan([(r, r.slot) for r in cohort],
                                            pool)
                if ks >= 1:
                    self._decode_spec(cohort, pool, ks, emitted,
                                      finished_now)
                    continue
            k = self._plan_burst(cohort, pool)
            if k <= 1:
                self._decode_single(cohort, pool, emitted, finished_now)
            else:
                self._decode_burst(cohort, pool, k, emitted, finished_now)

        self.n_steps += 1
        now = self._last_now = self._clock()
        for req in admitted:
            # a tracer stamped the admission itself; else the round's sample
            if req.admit_time is None:
                req.admit_time = now
            self.metrics.on_admit(req)
        for req in [r for r in self.running.values()
                    if r.e2e_deadline_s is not None
                    and now - r.arrival_time > r.e2e_deadline_s]:
            self._retire(req, "deadline_exceeded", now, finished_now)
        self.metrics.on_step(now, {t: p.n_used
                                   for t, p in self.pools.items()})
        for tier, pool in self.pools.items():
            if pool.paged:
                self.metrics.on_pages(tier, pool)
        if self.obs is not None:
            self._obs_step(now)
        return {"emitted": emitted, "finished": finished_now}

    # ------------------------------------------------------------------
    # Admission, preemption and deadline shedding
    # ------------------------------------------------------------------
    @staticmethod
    def _admit_order_key(r: Request) -> Tuple[int, float]:
        """Scan order: class, then the absolute TTFT deadline (none: after
        every deadline); the sort is stable, so arrival breaks ties."""
        if r.ttft_deadline_s is None:
            return (r.priority, float("inf"))
        return (r.priority, r.arrival_time + r.ttft_deadline_s)

    def _admit(self) -> List[Request]:
        """Scan the queue in ``_admit_order_key`` order and admit what fits,
        preempting where a strictly lower class holds the slot; skip a
        request still held back after a fault.  Stops at the first waiter
        that neither a free slot nor a victim could serve: the scan is
        priority-sorted, so the rest cannot either."""
        admitted: List[Request] = []
        if not self.waiting:
            return admitted
        free = sum(p.n_free for p in self.pools.values())
        top = self._lowest_decoding_class()
        for req in sorted(self.waiting, key=self._admit_order_key):
            if req.hold_until_step > self.n_steps:
                continue
            if free == 0 and (top is None or req.priority >= top):
                break
            if self._try_admit(req):
                admitted.append(req)
                free = sum(p.n_free for p in self.pools.values())
                top = self._lowest_decoding_class()
        if admitted:
            gone = {id(r) for r in admitted}
            self.waiting = deque(r for r in self.waiting if id(r) not in gone)
        return admitted

    def _lowest_decoding_class(self) -> Optional[int]:
        """The largest class number among DECODE requests (None: none)."""
        prios = [r.priority for r in self.running.values()
                 if r.state is RequestState.DECODE]
        return max(prios) if prios else None

    def _try_admit(self, req: Request) -> bool:
        pool = self.pools[req.tier]
        # the worst-case new tokens: a resume's replay already holds all
        # of its generated tokens but the last
        max_new = req.sampling.max_new_tokens - max(req.n_generated - 1, 0)
        while True:
            if pool.paged:
                adm = pool.admit(req.prefill_tokens, max_new)
                if adm is not None:
                    req.slot, req.prefill_pos, req.prefix_hit_tokens = adm
                    break
            elif pool.n_free:
                req.slot = pool.alloc()
                req.prefill_pos = 0
                break
            victim = self._pick_victim(req.tier, req.priority)
            if victim is None:
                return False
            self._preempt(victim)
        if self._r_hits is not None and req.prefix_hit_tokens > 0:
            self._r_hits.inc(tier=req.tier)
            self._r_hit_tokens.inc(int(req.prefix_hit_tokens), tier=req.tier)
        req.state = RequestState.PREFILL
        req.prompt_padded, _ = self.engine.pad_prompt(req.prefill_tokens)
        self.running[(req.tier, req.slot)] = req
        # the WAITING span's end: a clock sample only for a tracer
        if self.tracer is not None:
            req.admit_time = self._clock()
        if self._r_adm is not None:
            self._r_adm.inc(tier=req.tier)
        return True

    def _pick_victim(self, tier: str, priority: int) -> Optional[Request]:
        """The DECODE request of ``tier`` to evict for a waiter of class
        ``priority``: strictly lower classes only (two equals would trade
        one slot forever), the lowest first, then the least generated
        (cheapest to recompute), then the youngest."""
        cands = [r for r in self.running.values()
                 if r.tier == tier and r.state is RequestState.DECODE
                 and r.priority > priority]
        if not cands:
            return None
        return max(cands, key=lambda r: (r.priority, -r.n_generated, r.id))

    def _preempt(self, req: Request, reason: str = "priority") -> None:
        """Free ``req``'s slot and requeue it.  A request that has emitted
        tokens gets a resume buffer: the prompt and every generated token
        but the last (the next decode input, whose KV was never written).
        Output and ``n_generated`` stay, so with per-(request, step) keys
        the resumed tokens are those of an unpreempted run.  (A request
        faulted before its first token starts its prompt over.)  On a
        paged pool its registered prompt pages stay in the prefix cache
        for the resume."""
        del self.running[(req.tier, req.slot)]
        if self.draft is not None:
            self.draft.release(req.tier, req.slot)
        self.pools[req.tier].free(req.slot)
        req.slot = None
        req.state = RequestState.WAITING
        if req.output_tokens:
            req.resume_prompt = np.concatenate(
                [req.prompt, np.asarray(req.output_tokens[:-1], np.int32)]) \
                if req.n_generated > 1 else req.prompt
        req.prompt_padded = None
        req.prefill_pos = 0
        req.prefix_hit_tokens = 0
        req.n_preemptions += 1
        req.last_enqueue_time = self._last_now
        req.admit_time = None
        self.waiting.append(req)
        self.metrics.on_preempt(req, reason=reason)
        if self.tracer is not None and self._last_now is not None:
            self.tracer.instant(
                "preempted", self._last_now, pid=PID_REQUESTS,
                tid=req.id or 0,
                args={"reason": reason, "n_generated": req.n_generated,
                      "n_preemptions": req.n_preemptions})

    def _shed_expired_waiting(self, finished_now: List[Request]) -> None:
        """Retire WAITING requests whose TTFT (before a first token) or e2e
        deadline has passed, by the last clock sample taken."""
        now = self._last_now
        if now is None or not self.waiting:
            return
        expired = [
            r for r in self.waiting
            if (r.ttft_deadline_s is not None and r.first_token_time is None
                and now - r.arrival_time > r.ttft_deadline_s)
            or (r.e2e_deadline_s is not None
                and now - r.arrival_time > r.e2e_deadline_s)]
        if not expired:
            return
        gone = {id(r) for r in expired}
        self.waiting = deque(r for r in self.waiting if id(r) not in gone)
        for r in expired:
            self._finish_unadmitted(r, "deadline_exceeded", now,
                                    finished_now)

    def _finish_unadmitted(self, req: Request, reason: str, now: float,
                           finished_now: Optional[List[Request]]) -> None:
        """Retire a request that holds no slot (rejected at submit, or shed
        from the queue)."""
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = now
        self.finished.append(req)
        if finished_now is not None:
            finished_now.append(req)
        self.metrics.on_finish(req)
        if self.tracer is not None:
            self._trace_request(req)

    # ------------------------------------------------------------------
    # Fault recovery
    # ------------------------------------------------------------------
    def _on_fault(self, cohort: List[Request], fault: StepFault,
                  finished_now: List[Request]) -> None:
        """A dispatch died or returned poisoned output: its output is
        dropped whole; each of its requests is charged a fault and
        requeued through the preemption path, held back 1, 2, 4, ...
        steps, or retired with ``finish_reason='fault'`` once its budget
        is spent."""
        self.metrics.on_fault(fault, len(cohort))
        for r in list(cohort):
            backoff = self._retry.record_fault(r.id)
            r.n_faults += 1
            if backoff is None:
                now = self._last_now if self._last_now is not None \
                    else r.arrival_time
                self._retire(r, "fault", now, finished_now)
            else:
                r.hold_until_step = self.n_steps + backoff
                self._preempt(r, reason="fault")

    def _tokens_poisoned(self, toks: np.ndarray) -> bool:
        """The poisoned-output guard: sampled ids must be in the vocabulary."""
        return bool(np.any((toks < 0) | (toks >= self.engine.cfg.vocab)))

    # ------------------------------------------------------------------
    # Prefill and decode dispatches
    # ------------------------------------------------------------------
    def _plan_burst(self, dec: List[Request], pool: KVCachePool) -> int:
        if self.max_burst <= 1 or self.waiting or any(
                r.state is RequestState.PREFILL for r in self.running.values()):
            return 1
        k = self.max_burst
        if self.slo is not None:
            k = self.slo.burst_cap(self, dec, pool, k)
        for r in dec:
            budget = r.sampling.max_new_tokens - r.n_generated
            capacity = pool.max_len - int(pool.lengths[r.slot]) - 1
            k = min(k, max(1, min(budget, capacity)))
        return 1 << (k.bit_length() - 1)

    def _prefill_one_chunk(self, emitted: List,
                           finished_now: List[Request]) -> bool:
        """One chunk of the oldest PREFILL request; False when there was
        none, it faulted, or it finished its prompt (a round budgeting
        several chunks stops there)."""
        pre = [r for r in self.running.values()
               if r.state is RequestState.PREFILL]
        if not pre:
            return False
        req = min(pre, key=lambda r: r.id)
        pool = self.pools[req.tier]
        self._dispatch_seq += 1
        c = self.engine.scfg.prefill_chunk
        start, plen = req.prefill_pos, req.prefill_len
        t0 = self._clock() if self._timed else 0.0
        try:
            logits = self.engine.prefill_chunk_into_slot(
                pool, req.slot, req.prompt_padded, start, prompt_len=plen,
                need_logits=not req.is_resuming)
        except StepFault as f:
            self._on_fault([req], f, finished_now)
            return False
        req.prefill_pos = min(start + c, plen)
        final = req.prefill_pos >= plen
        resumed = req.is_resuming
        tok = None
        if final:
            req.state = RequestState.DECODE
            if pool.paged:
                pool.register_prefix(req.slot, req.prefill_tokens)
            if resumed:
                # the replay covers prompt + generated[:-1]; decode goes on
                # at n_generated with the last token as its input
                req.resume_prompt = None
            else:
                # two blocking transfers: the final chunk's logits, the
                # first token
                self.n_host_syncs += 2
                tok = sample_one(logits[(plen - 1) % c], req.step_key(),
                                 req.sampling.temperature)
        if self._timed:
            t1 = self._clock()
            n_tok = int(req.prefill_pos - start)
            if self.tracer is not None:
                self.tracer.complete(
                    "prefill_chunk", t0, t1, pid=PID_SCHEDULER, tid=0,
                    args={"req": req.id, "tier": req.tier, "pos": int(start),
                          "tokens": n_tok, "final": final,
                          "dispatch": self._dispatch_seq})
            if self.profiler is not None:
                self.profiler.record_prefill(tier=req.tier, n_tokens=n_tok,
                                             wall_s=t1 - t0)
        if self._r_chunks is not None:
            self._r_chunks.inc(tier=req.tier)
        if tok is not None:
            self._emit(req, tok, emitted, finished_now)
        return not final

    def _key_schedule(self, dec: List[Request], k: int, keys: np.ndarray,
                      temps: np.ndarray) -> None:
        """Fill ``keys`` [k, n_slots, 2] and ``temps`` [n_slots] for the
        temperature rows of ``dec`` (greedy rows keep key 0, never used)."""
        hot = [r for r in dec if r.sampling.temperature > 0]
        if not hot:
            return
        sched = batched_step_keys([r.sampling.seed for r in hot],
                                  [r.id or 0 for r in hot],
                                  [r.n_generated for r in hot], k)
        self.n_host_syncs += 1
        for r, row in zip(hot, sched):
            temps[r.slot] = r.sampling.temperature
            keys[:, r.slot] = row

    def _decode_single(self, dec: List[Request], pool: KVCachePool,
                       emitted: List, finished_now: List[Request]) -> None:
        n = pool.n_slots
        tokens = np.zeros((n,), np.int32)
        keys = np.zeros((1, n, 2), np.uint32)
        temps = np.zeros((n,), np.float32)
        for r in dec:
            tokens[r.slot] = r.last_token
        self._key_schedule(dec, 1, keys, temps)
        if pool.paged:
            pool.ensure_decode([r.slot for r in dec], 1)
        self._dispatch_seq += 1
        ctx = self._cohort_context(dec, pool)
        t0 = self._clock() if self._timed else 0.0
        try:
            toks = self.engine.decode_slots(pool, tokens, keys[0], temps)
        except StepFault as f:
            self._on_fault(dec, f, finished_now)
            return
        self.n_host_syncs += 1
        if self._ft_check \
                and self._tokens_poisoned(toks[[r.slot for r in dec]]):
            self._on_fault(dec, StepFault("nan", "decode ids out of vocab"),
                           finished_now)
            return
        if self._timed:
            self._obs_decode(dec, pool, 1, len(dec), ctx, t0, self._clock())
        self.metrics.on_decode_burst(1, len(dec), tier=pool.kv_dtype)
        for r in dec:
            pool.lengths[r.slot] += 1      # the input token's KV
            self._emit(r, int(toks[r.slot]), emitted, finished_now)

    def _decode_burst(self, dec: List[Request], pool: KVCachePool, k: int,
                      emitted: List, finished_now: List[Request]) -> None:
        n = pool.n_slots
        tokens = np.zeros((n,), np.int32)
        eos = np.full((n,), -1, np.int32)
        active = np.zeros((n,), bool)
        rem = np.zeros((n,), np.int32)
        keys = np.zeros((k, n, 2), np.uint32)
        temps = np.zeros((n,), np.float32)
        for r in dec:
            tokens[r.slot] = r.last_token
            eos[r.slot] = r.sampling.eos_id
            active[r.slot] = True
            rem[r.slot] = r.sampling.max_new_tokens - r.n_generated
        self._key_schedule(dec, k, keys, temps)
        if pool.paged:
            # each row's K-step window, capped at its remaining budget: a
            # row that stops mid-burst writes on at its frozen length, on
            # an unmapped entry (the garbage page) or a page of its own
            pool.ensure_decode([r.slot for r in dec], k,
                               [int(rem[r.slot]) for r in dec])
        self._dispatch_seq += 1
        ctx = self._cohort_context(dec, pool)
        t0 = self._clock() if self._timed else 0.0
        try:
            toks, valid = self.engine.decode_burst(pool, tokens, keys, temps,
                                                   active, rem, eos)
        except StepFault as f:
            self._on_fault(dec, f, finished_now)
            return
        self.n_host_syncs += 1
        if self._ft_check and self._tokens_poisoned(toks[valid]):
            # the burst committed the lengths; the requeue frees the slots
            # (and pages), so no poisoned write reaches a served token
            self._on_fault(dec, StepFault("nan", "burst ids out of vocab"),
                           finished_now)
            return
        n_emit = int(valid.sum())
        if self._timed:
            self._obs_decode(dec, pool, k, n_emit, ctx, t0, self._clock())
        self.metrics.on_decode_burst(k, n_emit, tier=pool.kv_dtype)
        # replay in step-major order; slots captured first because _emit
        # may retire a request mid-replay
        rows = [(r, r.slot) for r in dec]
        for t in range(k):
            for r, slot in rows:
                if valid[t, slot]:
                    self._emit(r, int(toks[t, slot]), emitted, finished_now)

    def _decode_spec(self, dec: List[Request], pool: KVCachePool, k: int,
                     emitted: List, finished_now: List[Request]) -> None:
        """One speculative round for one tier cohort: catch the draft up,
        draft K tokens a row, verify the [last, d_1..d_K] window in one
        target dispatch, and emit the longest agreeing prefix plus the
        target's next sample.  A fully rejected round emits the verify's
        position-0 sample, the plain step's token."""
        tier = pool.kv_dtype
        n = pool.n_slots
        s = k + 1
        rows = [(r, r.slot) for r in dec]
        n_catchup = self.draft.catch_up(tier, pool, rows)
        # one key schedule for the round: draft step t and verify position
        # t take keys[t], the key of token n_generated + t
        keys = np.zeros((s, n, 2), np.uint32)
        temps = np.zeros((n,), np.float32)
        self._key_schedule(dec, s, keys, temps)
        self._dispatch_seq += 1
        t0 = self._clock() if self._timed else 0.0
        drafts = self.draft.draft_burst(tier, pool, rows, k, keys[:k], temps)
        self.n_host_syncs += 1
        t1 = self._clock() if self._timed else 0.0
        if self.tracer is not None:
            self.tracer.complete(
                "spec_draft", t0, t1, pid=PID_SCHEDULER,
                tid=self._spec_tid[tier][0],
                args={"tier": tier, "k": k, "rows": len(dec),
                      "catchup_chunks": n_catchup,
                      "dispatch": self._dispatch_seq})
        window = np.zeros((n, s), np.int32)
        rems = np.zeros((n,), np.int32)
        for r, slot in rows:
            window[slot, 0] = r.last_token
            window[slot, 1:] = drafts[:, slot]
            rems[slot] = r.sampling.max_new_tokens - r.n_generated
        if pool.paged:
            # the S-wide window of each row (the planner kept K below each
            # row's budget, so every position the round may commit)
            pool.ensure_decode([slot for _, slot in rows], s,
                               [int(rems[slot]) for _, slot in rows])
        self._dispatch_seq += 1
        verify_dispatch = self._dispatch_seq
        t2 = self._clock() if self._timed else 0.0
        try:
            verified = self.engine.verify_slots(pool, window, keys, temps)
        except StepFault as f:
            self._on_fault(dec, f, finished_now)
            return
        self.n_host_syncs += 1
        if self._ft_check and self._tokens_poisoned(
                verified[:, [slot for _, slot in rows]]):
            # the lengths were never committed: the poisoned writes stay
            # masked, and the requeue recomputes them
            self._on_fault(dec, StepFault("nan", "verify ids out of vocab"),
                           finished_now)
            return
        plan: List[Tuple[Request, int, int]] = []
        drafted = accepted = emitted_total = 0
        for r, slot in rows:
            n_emit, n_acc = accept_longest_prefix(
                drafts[:, slot], verified[:, slot], r.sampling.eos_id,
                int(rems[slot]))
            plan.append((r, slot, n_emit))
            drafted += k
            accepted += n_acc
            emitted_total += n_emit
        # commit the target's lengths (the rollback), then the draft's
        for r, slot, n_emit in plan:
            pool.lengths[slot] += n_emit
        self.draft.sync_lengths(tier, pool, rows)
        self.spec_planner.observe(drafted, accepted)
        if self._timed:
            t3 = self._clock()
            if self.tracer is not None:
                self.tracer.complete(
                    "spec_verify", t2, t3, pid=PID_SCHEDULER,
                    tid=self._spec_tid[tier][1],
                    args={"tier": tier, "k": k, "rows": len(dec),
                          "accepted": accepted, "emitted": emitted_total,
                          "dispatch": verify_dispatch})
        self.metrics.on_spec_round(
            k=k, rows=len(dec), drafted=drafted, accepted=accepted,
            emitted=emitted_total, catchup_dispatches=n_catchup, tier=tier)
        # replay in step-major order, the order single steps emit in;
        # slots captured first because _emit may retire a request
        for t in range(s):
            for r, slot, n_emit in plan:
                if t < n_emit:
                    self._emit(r, int(verified[t, slot]), emitted,
                               finished_now)

    def _emit(self, req: Request, tok: int, emitted: List,
              finished_now: List[Request]) -> None:
        now = self._clock()
        req.output_tokens.append(tok)
        req.token_times.append(now)
        req.token_dispatches.append(self._dispatch_seq)
        if req.first_token_time is None:
            req.first_token_time = now
        emitted.append((req, req.slot, tok))
        sp = req.sampling
        if sp.eos_id >= 0 and tok == sp.eos_id:
            self._retire(req, "eos", now, finished_now)
        elif req.n_generated >= sp.max_new_tokens:
            self._retire(req, "length", now, finished_now)
        elif req.prompt_len + req.n_generated >= self.pools[req.tier].max_len:
            self._retire(req, "capacity", now, finished_now)

    def _retire(self, req: Request, reason: str, now: float,
                finished_now: List[Request]) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = now
        del self.running[(req.tier, req.slot)]
        if self.draft is not None:
            self.draft.release(req.tier, req.slot)
        self.pools[req.tier].free(req.slot)
        req.slot = None
        self._retry.clear(req.id)
        self.finished.append(req)
        finished_now.append(req)
        self.metrics.on_finish(req)
        if self.tracer is not None:
            self._trace_request(req)

    # ------------------------------------------------------------------
    # Observability (obs-enabled paths only)
    # ------------------------------------------------------------------
    def _obs_step(self, now: float) -> None:
        """After a round: the scheduler's gauges and counters, the queue
        and slot counter tracks, and the snapshot tick."""
        if self._r_steps is not None:
            self._r_steps.inc()
            self._r_queue.set(len(self.waiting))
            for t, p in sorted(self.pools.items()):
                self._r_used.set(p.n_used, tier=t)
            # by delta: the counter stays monotone, n_host_syncs raw
            self._r_syncs.inc(self.n_host_syncs - self._syncs_published)
            self._syncs_published = self.n_host_syncs
            if self._r_pages is not None:
                for t, p in sorted(self.pools.items()):
                    if p.paged:
                        self._r_pages.set(p.pages_in_use, tier=t,
                                          state="used")
                        self._r_pages.set(p.pages_cached, tier=t,
                                          state="cached")
                        self._r_pages.set(p.pages_free, tier=t,
                                          state="free")
        if self.tracer is not None:
            self.tracer.counter("queue_depth", now,
                                {"waiting": len(self.waiting)})
            self.tracer.counter(
                "slots_used", now,
                {t: self.pools[t].n_used for t in sorted(self.pools)})
        self.obs.on_step(now)

    def _cohort_context(self, dec: List[Request], pool: KVCachePool) -> int:
        """A cohort's mean committed context before its dispatch (what the
        profiler prices); 0 without a profiler."""
        if self.profiler is None:
            return 0
        return int(round(float(
            np.mean([pool.lengths[r.slot] for r in dec]))))

    def _obs_decode(self, dec: List[Request], pool: KVCachePool, k: int,
                    n_emit: int, ctx: int, t0: float, t1: float) -> None:
        """One decode dispatch's profiler record and trace event; [t0, t1]
        spans the dispatch up to the host's read of its sampled ids."""
        tier = pool.kv_dtype
        if self.profiler is not None:
            self.profiler.record_decode(
                tier=tier, k=k, rows=len(dec), context=ctx,
                kv_bytes_per_token=pool.bytes_per_token, wall_s=t1 - t0)
        if self.tracer is not None:
            self.tracer.complete(
                "decode_burst", t0, t1, pid=PID_SCHEDULER,
                tid=self._tier_tid[tier],
                args={"tier": tier, "k": k, "rows": len(dec),
                      "emitted": n_emit,
                      "slots": sorted(int(r.slot) for r in dec),
                      "dispatch": self._dispatch_seq})

    def _trace_request(self, req: Request) -> None:
        """A retired request's spans, rebuilt from the times the hot path
        stamped anyway: nothing is traced per token."""
        tr = self.tracer
        tid = req.id or 0
        tr.thread_name(PID_REQUESTS, tid, f"req {tid}")
        a, ad = req.arrival_time, req.admit_time
        ft, fin = req.first_token_time, req.finish_time
        if a is not None and ad is not None:
            tr.complete("WAITING", a, ad, pid=PID_REQUESTS, tid=tid,
                        args={"tier": req.tier})
        if ad is not None and ft is not None:
            tr.complete("PREFILL", ad, ft, pid=PID_REQUESTS, tid=tid,
                        args={"prompt_len": int(req.prompt_len)})
        if ft is not None and fin is not None:
            tr.complete("DECODE", ft, fin, pid=PID_REQUESTS, tid=tid,
                        args={"n_generated": req.n_generated})
        if ft is not None:
            tr.instant("first_token", ft, pid=PID_REQUESTS, tid=tid)
        if fin is not None:
            tr.instant("finished", fin, pid=PID_REQUESTS, tid=tid,
                       args={"reason": req.finish_reason,
                             "n_generated": req.n_generated})
