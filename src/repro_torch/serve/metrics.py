"""Serving metrics: TTFT, ITL, tokens/s, slot occupancy, burst accounting.

  * TTFT  — arrival -> first sampled token (queueing plus chunked prefill).
  * ITL   — gaps between a request's consecutive tokens.
  * tok/s — generated tokens over the busy window (first arrival to last
            retirement).
  * slot occupancy — time-weighted fraction of KV slots in use, and per
            tier when the scheduler serves several (a tier can starve
            while the total looks healthy).
  * decode dispatches / token-steps — how amortized the decode loop ran.
  * speculation — rounds, draft / verify / catch-up dispatches, tokens
            drafted, accepted, rejected, bonus and emitted, and
            ``dispatches_per_token`` over both decode paths.  Identities:
            drafted == accepted + rejected, emitted == accepted + bonus,
            and at drain total_new_tokens == first tokens (len(ttft)) +
            decode_tokens_emitted + spec_tokens_emitted.
  * queue wait — admission minus the latest enqueue, per priority class
            (a preempted request's second wait is charged to its requeue).
  * preemptions — slots evicted for a higher class or by a faulted
            dispatch (``preempt_reasons``: priority / fault);
            ``finish_reasons`` adds ``preempted_resumed`` (finished after
            >= 1 preemption) as an overlay, not a term of the sum.
  * SLO accounting — every submitted request retires with exactly one
            finish reason: eos / length / capacity, or the shed reasons
            rejected / deadline_exceeded / fault, so ``finish_reasons``
            sums to ``n_requests``.  Rejections by kind, downgrades, and
            faulted dispatches (``faults``) with the request-slots they
            hit and their kinds.  Latency samples come only from requests
            that delivered a first token; with more than one priority
            class, ``per_priority`` gives TTFT / e2e percentiles by class.
  * prefix cache (paged pools) — requests that adopted cached prompt
            pages (hits) or none (misses), the tokens adopted, TTFT split
            by hit and miss (a hit skips its cached chunks), and per tier
            the arena's pages in use, cache-only and free at their
            extremes, copy-on-write copies and evictions.

All K tokens of a decode burst surface at its end, so raw ITL percentiles
are burst-granular; ``itl_burst_spread_*`` spreads each burst's wall time
over the tokens it emitted.  Timestamps come from the scheduler's clock.
``report()`` is JSON-clean: empty statistics are None, never NaN.

``ServeMetrics(n_slots, registry=reg)`` also publishes into a
``repro_torch.obs.MetricsRegistry`` the reference's families, under its
names, help strings and labels (arrivals, retirements by tier and reason,
tokens, decode dispatches and token-steps, the burst K, TTFT, e2e,
preemptions, rejections, downgrades, faults, queue waits, speculation);
``registry=None`` changes nothing.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def burst_spread_itl(token_times: List[float],
                     token_dispatches: List[int]) -> List[float]:
    """Per-token ITL with each dispatch's wall time spread uniformly over
    the tokens it emitted (a group of m tokens after a token at t_prev
    contributes m samples of (t_group_end - t_prev) / m)."""
    n = len(token_times)
    if n < 2 or len(token_dispatches) != n:
        return list(np.diff(np.asarray(token_times))) if n > 1 else []
    out: List[float] = []
    i = 0
    while i < n:
        j = i
        while j + 1 < n and token_dispatches[j + 1] == token_dispatches[i]:
            j += 1
        if i == 0:
            if j > 0:
                out.extend([(token_times[j] - token_times[0]) / j] * j)
        else:
            m = j - i + 1
            out.extend([(token_times[j] - token_times[i - 1]) / m] * m)
        i = j + 1
    return out


class ServeMetrics:
    def __init__(self, n_slots: int, registry=None):
        self.n_slots = n_slots              # over every tier
        # {tier: n_slots} when the scheduler serves several KV tiers
        self.tiers: Optional[Dict[str, int]] = None
        self.ttft: List[float] = []
        # TTFT by prefix-cache outcome (slab pools fill ttft_miss only)
        self.ttft_hit: List[float] = []
        self.ttft_miss: List[float] = []
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.pages: Dict[str, Dict[str, int]] = {}    # by tier
        self.itl: List[float] = []
        self.itl_spread: List[float] = []
        self.e2e: List[float] = []
        self.n_requests = 0
        self.n_arrived = 0
        self.total_new_tokens = 0
        self.finish_reasons: Dict[str, int] = {}
        self.n_resumed = 0
        self.n_preemptions = 0
        self.preempt_reasons: Dict[str, int] = {}   # priority | fault
        self.n_rejections = 0
        self.rejection_kinds: Dict[str, int] = {}
        self.n_downgrades = 0
        self.n_fault_events = 0       # faulted dispatches
        self.n_fault_requests = 0     # request-slots those dispatches hit
        self.fault_kinds: Dict[str, int] = {}
        self.queue_wait: Dict[int, List[float]] = {}
        self._prio_ttft: Dict[int, List[float]] = {}
        self._prio_e2e: Dict[int, List[float]] = {}
        self.first_arrival: Optional[float] = None
        self.last_finish: Optional[float] = None
        self._occ_integral = 0.0
        self._occ_time = 0.0
        self._tier_occ: Dict[str, float] = {}
        self._last_sample: Optional[float] = None
        self.decode_dispatches = 0
        self.decode_token_steps = 0
        self.decode_tokens_emitted = 0
        self.burst_hist: Dict[int, int] = {}
        self.tier_dispatches: Dict[str, int] = {}
        self.spec_rounds = 0
        self.spec_draft_dispatches = 0
        self.spec_verify_dispatches = 0
        self.spec_catchup_dispatches = 0   # draft-KV replay prefill chunks
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0      # emitted tokens matching drafts
        self.spec_tokens_rejected = 0
        self.spec_bonus_tokens = 0         # the verify's own samples
        self.spec_tokens_emitted = 0
        self.spec_accept_hist: Dict[int, int] = {}  # accepted a round -> n
        self._reg = registry
        if registry is not None:
            self._r_arrived = registry.counter(
                "serve_requests_arrived_total", "requests submitted")
            self._r_finished = registry.counter(
                "serve_requests_finished_total",
                "requests retired, by finish reason and KV tier")
            self._r_tokens = registry.counter(
                "serve_new_tokens_total", "generated tokens, by KV tier")
            self._r_dispatch = registry.counter(
                "serve_decode_dispatches_total",
                "jitted decode/burst entries, by KV tier")
            self._r_steps = registry.counter(
                "serve_decode_token_steps_total",
                "planned decode token-steps, by KV tier")
            self._r_burst = registry.histogram(
                "serve_burst_k", "planned burst length per decode dispatch",
                buckets=(1, 2, 4, 8, 16, 32, 64))
            self._r_ttft = registry.histogram(
                "serve_ttft_seconds", "time to first token")
            self._r_e2e = registry.histogram(
                "serve_e2e_seconds", "request arrival -> retirement")
            self._r_preempt = registry.counter(
                "serve_preemptions_total",
                "decode slots evicted and requeued, by reason and KV tier")
            self._r_reject = registry.counter(
                "serve_rejections_total",
                "requests shed at admission, by verdict kind")
            self._r_downgrade = registry.counter(
                "serve_downgrades_total",
                "KV-tier downgrades under pressure, by from/to tier")
            self._r_fault = registry.counter(
                "serve_faults_total", "faulted dispatches, by fault kind")
            self._r_qwait = registry.histogram(
                "serve_queue_wait_seconds",
                "enqueue -> admission wait, by priority class")
            self._r_spec_rounds = registry.counter(
                "serve_spec_rounds_total",
                "speculative draft/verify rounds, by KV tier")
            self._r_spec_disp = registry.counter(
                "serve_spec_dispatches_total",
                "speculation dispatches, by kind "
                "(draft / verify / catchup) and KV tier")
            self._r_spec_tok = registry.counter(
                "serve_spec_tokens_total",
                "draft-window token outcomes, by result "
                "(accepted / rejected / bonus) and KV tier")
            self._r_spec_acc = registry.histogram(
                "serve_spec_accepted_per_verify",
                "draft tokens accepted per verify dispatch",
                buckets=(0, 1, 2, 4, 8, 16, 32))

    def on_arrival(self, now: float) -> None:
        self.n_arrived += 1
        if self.first_arrival is None:
            self.first_arrival = now
        if self._reg is not None:
            self._r_arrived.inc()

    def on_admit(self, req) -> None:
        """WAITING -> PREFILL: the queue wait since the latest enqueue, by
        priority class."""
        t0 = req.last_enqueue_time if req.last_enqueue_time is not None \
            else req.arrival_time
        if req.admit_time is None or t0 is None:
            return
        wait = max(req.admit_time - t0, 0.0)
        self.queue_wait.setdefault(req.priority, []).append(wait)
        if self._reg is not None:
            self._r_qwait.observe(wait, priority=str(req.priority))

    def on_preempt(self, req, reason: str = "priority") -> None:
        """A slot was evicted and its request requeued: for a higher class
        ('priority') or by a faulted dispatch ('fault')."""
        self.n_preemptions += 1
        self.preempt_reasons[reason] = self.preempt_reasons.get(reason, 0) + 1
        if self._reg is not None:
            self._r_preempt.inc(reason=reason, tier=req.tier or "")

    def on_reject(self, req) -> None:
        """The serving policy shed the request at submit (its typed verdict
        in ``req.rejection``)."""
        kind = getattr(req.rejection, "kind", None) or "unknown"
        self.n_rejections += 1
        self.rejection_kinds[kind] = self.rejection_kinds.get(kind, 0) + 1
        if self._reg is not None:
            self._r_reject.inc(kind=kind)

    def on_downgrade(self, req) -> None:
        """The serving policy moved the request to a denser KV tier."""
        self.n_downgrades += 1
        if self._reg is not None:
            self._r_downgrade.inc(src=req.downgraded_from or "",
                                  dst=req.tier or "")

    def on_fault(self, fault, n_requests: int) -> None:
        """One dispatch faulted (raised or returned poisoned output),
        invalidating ``n_requests`` slots."""
        self.n_fault_events += 1
        self.n_fault_requests += n_requests
        kind = getattr(fault, "kind", None) or "unknown"
        self.fault_kinds[kind] = self.fault_kinds.get(kind, 0) + 1
        if self._reg is not None:
            self._r_fault.inc(kind=kind)

    def on_step(self, now: float,
                used_slots: Union[int, Mapping[str, int]]) -> None:
        """Sample occupancy, weighted by the wall time since the last
        sample; ``used_slots`` is a count or {tier: count}."""
        per_tier = used_slots if isinstance(used_slots, Mapping) else None
        if per_tier is not None:
            used_slots = sum(per_tier.values())
        if self._last_sample is not None:
            dt = max(now - self._last_sample, 0.0)
            self._occ_integral += dt * (used_slots / self.n_slots)
            self._occ_time += dt
            if per_tier is not None and self.tiers:
                for tier, used in per_tier.items():
                    self._tier_occ[tier] = (self._tier_occ.get(tier, 0.0)
                                            + dt * used / self.tiers[tier])
        self._last_sample = now

    def on_pages(self, tier: str, pool) -> None:
        """Sample a paged pool's arena after a step."""
        acc = self.pages.setdefault(tier, {
            "n_pages": pool.n_pages, "used_peak": 0, "cached_peak": 0,
            "free_min": pool.pages_free})
        acc["used_peak"] = max(acc["used_peak"], pool.pages_in_use)
        acc["cached_peak"] = max(acc["cached_peak"], pool.pages_cached)
        acc["free_min"] = min(acc["free_min"], pool.pages_free)
        acc.update(used=pool.pages_in_use, cached=pool.pages_cached,
                   free=pool.pages_free, cow_copies=pool.n_cow_copies,
                   evictions=pool.n_evictions)

    def on_decode_burst(self, k: int, tokens_emitted: int,
                        tier: Optional[str] = None) -> None:
        self.decode_dispatches += 1
        self.decode_token_steps += k
        self.decode_tokens_emitted += tokens_emitted
        self.burst_hist[k] = self.burst_hist.get(k, 0) + 1
        if tier is not None:
            self.tier_dispatches[tier] = self.tier_dispatches.get(tier, 0) + 1
        if self._reg is not None:
            t = tier or ""
            self._r_dispatch.inc(tier=t)
            self._r_steps.inc(k, tier=t)
            self._r_burst.observe(k, tier=t)

    def on_spec_round(self, k: int, rows: int, drafted: int, accepted: int,
                      emitted: int, catchup_dispatches: int = 0,
                      tier: Optional[str] = None) -> None:
        """One speculative round of ``rows`` cohort rows: a K-step draft
        burst and one verify dispatch, after ``catchup_dispatches`` draft
        prefill chunks.  ``drafted``: K a row; ``accepted``: emitted
        tokens that matched drafts; ``emitted``: every token that
        surfaced (accepted plus at most one bonus a row)."""
        bonus = emitted - accepted
        assert 0 <= accepted <= drafted and 0 <= bonus <= rows, \
            (drafted, accepted, emitted, rows)
        self.spec_rounds += 1
        self.spec_draft_dispatches += 1
        self.spec_verify_dispatches += 1
        self.spec_catchup_dispatches += catchup_dispatches
        self.spec_tokens_drafted += drafted
        self.spec_tokens_accepted += accepted
        self.spec_tokens_rejected += drafted - accepted
        self.spec_bonus_tokens += bonus
        self.spec_tokens_emitted += emitted
        self.spec_accept_hist[accepted] = \
            self.spec_accept_hist.get(accepted, 0) + 1
        if self._reg is not None:
            t = tier or ""
            self._r_spec_rounds.inc(tier=t)
            self._r_spec_disp.inc(kind="draft", tier=t)
            self._r_spec_disp.inc(kind="verify", tier=t)
            if catchup_dispatches:
                self._r_spec_disp.inc(catchup_dispatches, kind="catchup",
                                      tier=t)
            if accepted:
                self._r_spec_tok.inc(accepted, result="accepted", tier=t)
            if drafted - accepted:
                self._r_spec_tok.inc(drafted - accepted, result="rejected",
                                     tier=t)
            if bonus:
                self._r_spec_tok.inc(bonus, result="bonus", tier=t)
            self._r_spec_acc.observe(accepted, tier=t)

    def on_finish(self, req) -> None:
        self.n_requests += 1
        self.total_new_tokens += req.n_generated
        self.last_finish = req.finish_time
        reason = req.finish_reason or "unknown"
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1
        if req.n_preemptions > 0:
            self.n_resumed += 1
        ttft = e2e = None
        if req.first_token_time is not None and req.arrival_time is not None:
            ttft = req.first_token_time - req.arrival_time
            self.ttft.append(ttft)
            hit = req.prefix_hit_tokens > 0
            if hit:
                self.prefix_hits += 1
                self.prefix_hit_tokens += req.prefix_hit_tokens
            else:
                self.prefix_misses += 1
            (self.ttft_hit if hit else self.ttft_miss).append(ttft)
            self._prio_ttft.setdefault(req.priority, []).append(ttft)
            if req.finish_time is not None:
                e2e = req.finish_time - req.arrival_time
                self.e2e.append(e2e)
                self._prio_e2e.setdefault(req.priority, []).append(e2e)
        if len(req.token_times) > 1:
            self.itl.extend(np.diff(np.asarray(req.token_times)).tolist())
            self.itl_spread.extend(burst_spread_itl(req.token_times,
                                                    req.token_dispatches))
        if self._reg is not None:
            tier = req.tier or ""
            self._r_finished.inc(tier=tier, reason=reason)
            self._r_tokens.inc(req.n_generated, tier=tier)
            if ttft is not None:
                self._r_ttft.observe(ttft)
            if e2e is not None:
                self._r_e2e.observe(e2e)

    @property
    def occupancy_mean(self) -> float:
        return self._occ_integral / self._occ_time if self._occ_time else 0.0

    def report(self) -> Dict:
        wall = ((self.last_finish - self.first_arrival)
                if self.first_arrival is not None
                and self.last_finish is not None else 0.0)
        out = {
            "n_requests": self.n_requests,
            "total_new_tokens": self.total_new_tokens,
            "wall_s": wall,
            "tokens_per_s": self.total_new_tokens / wall if wall > 0 else None,
            "slot_occupancy_mean": self.occupancy_mean,
        }
        if self.tiers is not None:
            out["tiers"] = dict(self.tiers)
            if self._occ_time:
                out["tier_occupancy_mean"] = {
                    t: v / self._occ_time
                    for t, v in sorted(self._tier_occ.items())}
        if self.decode_dispatches:
            out["decode_dispatches"] = self.decode_dispatches
            out["decode_token_steps"] = self.decode_token_steps
            out["decode_tokens_emitted"] = self.decode_tokens_emitted
            out["burst_hist"] = {str(k): v for k, v
                                 in sorted(self.burst_hist.items())}
            if self.tiers is not None:
                out["decode_dispatches_by_tier"] = dict(
                    sorted(self.tier_dispatches.items()))
        if self.spec_rounds:
            out["spec"] = {
                "rounds": self.spec_rounds,
                "draft_dispatches": self.spec_draft_dispatches,
                "verify_dispatches": self.spec_verify_dispatches,
                "catchup_dispatches": self.spec_catchup_dispatches,
                "tokens_drafted": self.spec_tokens_drafted,
                "tokens_accepted": self.spec_tokens_accepted,
                "tokens_rejected": self.spec_tokens_rejected,
                "bonus_tokens": self.spec_bonus_tokens,
                "tokens_emitted": self.spec_tokens_emitted,
                "acceptance_rate":
                    self.spec_tokens_accepted / self.spec_tokens_drafted
                    if self.spec_tokens_drafted else None,
                "accepted_per_verify_dispatch":
                    self.spec_tokens_accepted / self.spec_verify_dispatches,
                "emitted_per_verify_dispatch":
                    self.spec_tokens_emitted / self.spec_verify_dispatches,
                "accept_hist": {str(a): c for a, c in
                                sorted(self.spec_accept_hist.items())},
                "plain_tokens_emitted": self.decode_tokens_emitted,
            }
        if (self.spec_rounds or self.decode_dispatches) \
                and self.total_new_tokens:
            # every dispatch that advanced decode state (plain steps and
            # bursts, drafts, verifies, draft catch-up chunks) per token
            out["dispatches_per_token"] = (
                self.decode_dispatches + self.spec_draft_dispatches
                + self.spec_verify_dispatches
                + self.spec_catchup_dispatches) / self.total_new_tokens
        if self.prefix_hits:
            out["prefix_hits"] = self.prefix_hits
            out["prefix_misses"] = self.prefix_misses
            out["prefix_hit_rate"] = self.prefix_hits / (
                self.prefix_hits + self.prefix_misses)
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
            for name, xs in (("ttft_hit", self.ttft_hit),
                             ("ttft_miss", self.ttft_miss)):
                if xs:
                    out[f"{name}_mean_s"] = float(np.mean(xs))
                    out[f"{name}_p50_s"] = _pct(xs, 50)
        if self.pages:
            out["pages"] = {t: dict(v) for t, v in sorted(self.pages.items())}
        for name, xs in (("ttft", self.ttft), ("itl", self.itl),
                         ("e2e_latency", self.e2e),
                         ("itl_burst_spread", self.itl_spread)):
            if xs:
                out[f"{name}_mean_s"] = float(np.mean(xs))
                out[f"{name}_p50_s"] = _pct(xs, 50)
                out[f"{name}_p95_s"] = _pct(xs, 95)
        if self.finish_reasons:
            fr = dict(sorted(self.finish_reasons.items()))
            if self.n_resumed:
                fr["preempted_resumed"] = self.n_resumed
            out["finish_reasons"] = fr
        if self.queue_wait:
            for q in (50, 95):
                out[f"queue_wait_p{q}_s"] = {
                    str(p): _pct(xs, q)
                    for p, xs in sorted(self.queue_wait.items())}
        if self.n_preemptions:
            out["preemptions"] = self.n_preemptions
            out["preempt_reasons"] = dict(sorted(self.preempt_reasons.items()))
        if self.n_rejections:
            out["rejections"] = self.n_rejections
            out["rejection_kinds"] = dict(sorted(self.rejection_kinds.items()))
        if self.n_downgrades:
            out["downgrades"] = self.n_downgrades
        if self.n_fault_events:
            out["faults"] = self.n_fault_events
            out["fault_requests"] = self.n_fault_requests
            out["fault_kinds"] = dict(sorted(self.fault_kinds.items()))
        classes = set(self._prio_ttft) | set(self._prio_e2e)
        if len(classes) > 1:
            per: Dict[str, Dict] = {}
            for p in sorted(classes):
                d: Dict = {}
                for name, xs in (("ttft", self._prio_ttft.get(p)),
                                 ("e2e", self._prio_e2e.get(p))):
                    if xs:
                        for q in (50, 95, 99):
                            d[f"{name}_p{q}_s"] = _pct(xs, q)
                        d[f"n_{name}"] = len(xs)
                per[str(p)] = d
            out["per_priority"] = per
        return out
