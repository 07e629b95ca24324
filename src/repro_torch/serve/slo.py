"""SLO policy: admission control, KV-tier downgrade, cost-model planning
(torch twin of ``repro/serve/slo.py``; host-side, no tensors).

Three levers, all priced by the paper's two-phase streaming cost model
(``perfmodel.analytical.decode_latency`` on the channel-streaming GEMV
engine):

  * **Admission control** — ``admit()`` estimates the time to drain the
    backlog and sheds work with a typed ``Rejection`` (queue_full /
    drain_time / deadline_unmeetable).  Requests at or above
    ``protect_priority`` (class numbers <= it) are never rejected.
  * **Graceful degradation** — under pressure ``admit()`` moves
    ``Request.kv_policy`` along ``downgrade_map`` (e.g. bf16 -> int8):
    precision as a runtime capacity lever.  The downgrade engages above
    ``downgrade_high_s`` estimated drain and releases below
    ``downgrade_low_s`` (hysteresis: a backlog at the threshold does not
    flap between tiers).
  * **Cost-model planning** — ``burst_cap()`` and
    ``prefill_chunks_per_step()`` size the decode burst K and the prefill
    chunks of a round from the modeled step latency against
    ``max_step_s``.

Every threshold is in COST-MODEL seconds: the paper's V80 FPGA model, not
the wall clock of the card or host that serves.  The model is monotone in
the backlog, which is what admission needs.  Estimates are pure functions
of the scheduler's state: the policy makes no clock call and no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .request import RequestState


@dataclasses.dataclass(frozen=True)
class Rejection:
    """Typed verdict of a shed request (``Request.rejection``): ``kind``
    'queue_full' (waiting depth cap), 'drain_time' (estimated drain past
    the cap) or 'deadline_unmeetable' (the estimated drain is past the
    request's TTFT deadline); ``estimate_s`` the drain estimate."""
    kind: str
    detail: str
    estimate_s: Optional[float] = None

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "detail": self.detail,
                "estimate_s": self.estimate_s}


class SLOPolicy:
    def __init__(self, *,
                 max_queue_delay_s: Optional[float] = None,
                 max_waiting: Optional[int] = None,
                 protect_priority: int = 0,
                 downgrade_map: Optional[Dict[str, str]] = None,
                 downgrade_high_s: Optional[float] = None,
                 downgrade_low_s: Optional[float] = None,
                 max_step_s: Optional[float] = None):
        """``max_queue_delay_s``: reject unprotected arrivals once the
        estimated drain exceeds it (None: never).  ``max_waiting``: cap on
        the waiting queue for unprotected arrivals.  ``protect_priority``:
        requests with ``priority <= protect_priority`` are never rejected.
        ``downgrade_map``: {from_tier: to_tier} applied while degraded,
        which engages above ``downgrade_high_s`` and releases below
        ``downgrade_low_s`` (< high).  ``max_step_s``: modeled latency
        budget of a round, which sizes bursts and prefill chunks (None:
        the scheduler's fixed caps).  The model prices the XtraMAC
        deployment of the model's projection scheme (w8a8 where the model
        has none of its own)."""
        if (downgrade_high_s is None) != (downgrade_low_s is None):
            raise ValueError("give both downgrade_high_s and "
                             "downgrade_low_s, or neither")
        if downgrade_high_s is not None \
                and not downgrade_low_s < downgrade_high_s:
            raise ValueError(
                f"hysteresis band inverted: downgrade_low_s "
                f"{downgrade_low_s} must be < downgrade_high_s "
                f"{downgrade_high_s}")
        if downgrade_map and downgrade_high_s is None:
            raise ValueError("downgrade_map without downgrade_high_s/"
                             "downgrade_low_s thresholds never fires")
        self.max_queue_delay_s = max_queue_delay_s
        self.max_waiting = max_waiting
        self.protect_priority = protect_priority
        self.downgrade_map = dict(downgrade_map or {})
        self.downgrade_high_s = downgrade_high_s
        self.downgrade_low_s = downgrade_low_s
        self.max_step_s = max_step_s
        self.degraded = False           # hysteresis state
        self.last_estimate_s: Optional[float] = None
        self._step_memo: Dict = {}

    # ------------------------------------------------------------------
    def _model_step_s(self, engine, batch: int, context: int,
                      kv_bytes_per_token: int) -> float:
        """Modeled seconds of one decode token-step at this shape; the
        context is bucketed to a power of two so the memo stays small."""
        batch = max(int(batch), 1)
        context = max(int(context), 1)
        ctx_bucket = 1 << (context - 1).bit_length()
        key = (batch, ctx_bucket, kv_bytes_per_token)
        t = self._step_memo.get(key)
        if t is None:
            from repro_torch.perfmodel.analytical import (
                _DEPLOY, decode_latency, gemv_engine_for)
            scheme = engine.cfg.scheme_proj
            if scheme not in _DEPLOY:
                scheme = "w8a8"
            t = decode_latency(
                engine.cfg, scheme, batch=batch, context=ctx_bucket,
                design="xtramac",
                kv_bytes_per_token=kv_bytes_per_token,
                engine_model=gemv_engine_for(scheme))["t_total_s"]
            self._step_memo[key] = t
        return t

    def estimate_queue_delay_s(self, sched) -> float:
        """Modeled time to drain everything in the system: outstanding
        decode tokens amortize over every slot of every tier, outstanding
        prefill tokens serialize one chunk a round on top.  Monotone in
        the backlog.  While the scheduler's speculation planner is active,
        decode drains in rounds of K draft steps (at the draft pool's KV
        bytes) and one verify step, each emitting the planner's expected
        tokens a row."""
        engine = sched.engine
        pool = sched.pool
        n_slots = sum(p.n_slots for p in sched.pools.values())
        dec_toks = 0
        pre_toks = 0
        ctx_sum, ctx_n = 0, 0
        for r in sched.running.values():
            dec_toks += max(r.sampling.max_new_tokens - r.n_generated, 0)
            if r.state is RequestState.PREFILL:
                pre_toks += max(r.prefill_len - r.prefill_pos, 0)
            if r.slot is not None:
                ctx_sum += int(sched.pools[r.tier].lengths[r.slot])
                ctx_n += 1
        for r in sched.waiting:
            dec_toks += r.sampling.max_new_tokens
            pre_toks += r.prefill_len
        context = ctx_sum // ctx_n if ctx_n else pool.max_len // 2
        t_tok = self._model_step_s(engine, n_slots, context,
                                   pool.bytes_per_token)
        c = engine.scfg.prefill_chunk
        planner = sched.spec_planner
        if planner is not None and planner.active:
            dpool = sched.draft.pools.get(sched.default_tier)
            draft_bpt = dpool.bytes_per_token if dpool is not None \
                else pool.bytes_per_token
            t_draft = self._model_step_s(engine, n_slots, context,
                                         draft_bpt)
            t_round = planner.k * t_draft + t_tok
            e_tokens = max(planner.expected_tokens_per_round(), 1.0)
            est = (dec_toks / max(n_slots, 1)) / e_tokens * t_round \
                + (pre_toks / c) * t_tok
        else:
            est = (dec_toks / max(n_slots, 1) + pre_toks / c) * t_tok
        self.last_estimate_s = est
        return est

    # ------------------------------------------------------------------
    def admit(self, req, sched) -> Optional[Rejection]:
        """Verdict for ``req`` against the current backlog: None to accept
        (after downgrading its KV tier in place while degraded — the
        scheduler re-resolves the tier), or a ``Rejection`` to shed."""
        est = self.estimate_queue_delay_s(sched)
        # hysteresis: engage above high, release below low, hold between
        if self.downgrade_high_s is not None:
            if not self.degraded and est > self.downgrade_high_s:
                self.degraded = True
            elif self.degraded and est < self.downgrade_low_s:
                self.degraded = False
        if self.degraded and self.downgrade_map:
            cur = req.kv_policy if req.kv_policy is not None \
                else sched.default_tier
            target = self.downgrade_map.get(cur)
            if target is not None and target in sched.pools \
                    and req.downgraded_from is None:
                req.downgraded_from = cur
                req.kv_policy = target
        if req.priority <= self.protect_priority:
            return None
        if self.max_waiting is not None \
                and len(sched.waiting) >= self.max_waiting:
            return Rejection(
                "queue_full",
                f"{len(sched.waiting)} waiting >= cap {self.max_waiting}",
                est)
        if self.max_queue_delay_s is not None \
                and est > self.max_queue_delay_s:
            return Rejection(
                "drain_time",
                f"estimated drain {est:.3g}s > cap "
                f"{self.max_queue_delay_s:.3g}s", est)
        if req.ttft_deadline_s is not None and est > req.ttft_deadline_s:
            return Rejection(
                "deadline_unmeetable",
                f"estimated drain {est:.3g}s > ttft deadline "
                f"{req.ttft_deadline_s:.3g}s", est)
        return None

    # ------------------------------------------------------------------
    def burst_cap(self, sched, cohort: List, pool, max_burst: int) -> int:
        """Largest decode-burst K whose modeled time fits ``max_step_s``
        (the scheduler's own caps apply on top: it only shrinks a burst)."""
        if self.max_step_s is None or not cohort:
            return max_burst
        ctx = sum(int(pool.lengths[r.slot]) for r in cohort) // len(cohort)
        t = self._model_step_s(sched.engine, len(cohort), ctx,
                               pool.bytes_per_token)
        if t <= 0:
            return max_burst
        return max(1, min(max_burst, int(self.max_step_s / t)))

    def prefill_chunks_per_step(self, sched) -> int:
        """Prefill-chunk dispatches one round may issue: enough to fill
        ``max_step_s`` (a chunk of C tokens priced as C single-row
        token-steps), at least 1, at most 8."""
        if self.max_step_s is None:
            return 1
        engine = sched.engine
        pool = sched.pool
        c = engine.scfg.prefill_chunk
        t_chunk = c * self._model_step_s(engine, 1, pool.max_len // 2,
                                         pool.bytes_per_token)
        if t_chunk <= 0:
            return 1
        return max(1, min(8, int(self.max_step_s / t_chunk)))

    def snapshot(self) -> Dict:
        """Policy state for reports."""
        return {
            "degraded": self.degraded,
            "last_estimate_s": self.last_estimate_s,
            "max_queue_delay_s": self.max_queue_delay_s,
            "max_waiting": self.max_waiting,
            "protect_priority": self.protect_priority,
            "downgrade_map": dict(self.downgrade_map),
            "downgrade_high_s": self.downgrade_high_s,
            "downgrade_low_s": self.downgrade_low_s,
            "max_step_s": self.max_step_s,
        }
