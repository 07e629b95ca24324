"""Serving metrics: TTFT, ITL, tokens/s, slot occupancy, burst accounting.

  * TTFT  — arrival -> first sampled token (queueing plus chunked prefill).
  * ITL   — gaps between a request's consecutive tokens.
  * tok/s — generated tokens over the busy window (first arrival to last
            retirement).
  * slot occupancy — time-weighted fraction of KV slots in use.
  * decode dispatches / token-steps — how amortized the decode loop ran.

All K tokens of a decode burst surface at its end, so raw ITL percentiles
are burst-granular; ``itl_burst_spread_*`` spreads each burst's wall time
over the tokens it emitted.  Timestamps come from the scheduler's clock.
``report()`` is JSON-clean: empty statistics are None, never NaN.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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
    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.ttft: List[float] = []
        self.itl: List[float] = []
        self.itl_spread: List[float] = []
        self.e2e: List[float] = []
        self.n_requests = 0
        self.total_new_tokens = 0
        self.finish_reasons: Dict[str, int] = {}
        self.first_arrival: Optional[float] = None
        self.last_finish: Optional[float] = None
        self._occ_integral = 0.0
        self._occ_time = 0.0
        self._last_sample: Optional[float] = None
        self.decode_dispatches = 0
        self.decode_token_steps = 0
        self.decode_tokens_emitted = 0
        self.burst_hist: Dict[int, int] = {}

    def on_arrival(self, now: float) -> None:
        if self.first_arrival is None:
            self.first_arrival = now

    def on_step(self, now: float, used_slots: int) -> None:
        """Sample occupancy, weighted by the wall time since the last
        sample."""
        if self._last_sample is not None:
            dt = max(now - self._last_sample, 0.0)
            self._occ_integral += dt * (used_slots / self.n_slots)
            self._occ_time += dt
        self._last_sample = now

    def on_decode_burst(self, k: int, tokens_emitted: int) -> None:
        self.decode_dispatches += 1
        self.decode_token_steps += k
        self.decode_tokens_emitted += tokens_emitted
        self.burst_hist[k] = self.burst_hist.get(k, 0) + 1

    def on_finish(self, req) -> None:
        self.n_requests += 1
        self.total_new_tokens += req.n_generated
        self.last_finish = req.finish_time
        reason = req.finish_reason or "unknown"
        self.finish_reasons[reason] = self.finish_reasons.get(reason, 0) + 1
        if req.first_token_time is not None and req.arrival_time is not None:
            self.ttft.append(req.first_token_time - req.arrival_time)
            if req.finish_time is not None:
                self.e2e.append(req.finish_time - req.arrival_time)
        if len(req.token_times) > 1:
            self.itl.extend(np.diff(np.asarray(req.token_times)).tolist())
            self.itl_spread.extend(burst_spread_itl(req.token_times,
                                                    req.token_dispatches))

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
        if self.decode_dispatches:
            out["decode_dispatches"] = self.decode_dispatches
            out["decode_token_steps"] = self.decode_token_steps
            out["decode_tokens_emitted"] = self.decode_tokens_emitted
            out["burst_hist"] = {str(k): v for k, v
                                 in sorted(self.burst_hist.items())}
        for name, xs in (("ttft", self.ttft), ("itl", self.itl),
                         ("e2e_latency", self.e2e),
                         ("itl_burst_spread", self.itl_spread)):
            if xs:
                out[f"{name}_mean_s"] = float(np.mean(xs))
                out[f"{name}_p50_s"] = _pct(xs, 50)
                out[f"{name}_p95_s"] = _pct(xs, 95)
        if self.finish_reasons:
            out["finish_reasons"] = dict(sorted(self.finish_reasons.items()))
        return out
