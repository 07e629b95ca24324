"""Serving-side fault tolerance (copy of the serving half of
``repro/runtime/fault_tolerance.py``; host-side, no tensors).

  * ``StepFault``   — the typed failure a serving dispatch raises when a
    step dies or returns poisoned output (an injected test fault, NaN
    logits).  The scheduler catches it, and nothing else, on the hot path
    and recovers by preempt-and-requeue.
  * ``RetryBudget`` — per-key bounded retry with exponential backoff:
    each fault on a key grants a hold of 1, 2, 4, ... scheduler steps
    until the key's budget is exhausted, when the caller retires the work.
"""
from __future__ import annotations

from typing import Dict, Optional


class StepFault(RuntimeError):
    """One engine dispatch failed or produced poisoned output.

    ``kind``: 'injected' (test hook), 'nan' (out-of-range step output), or
    any other tag the injector returns."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"step fault [{kind}]{': ' + detail if detail else ''}")
        self.kind = kind
        self.detail = detail


class RetryBudget:
    """Bounded retry-and-backoff bookkeeping, keyed by work unit.

    ``record_fault(key)`` returns the steps to hold the key back before
    retrying (1, 2, 4, ...), or ``None`` once the key has exhausted
    ``max_retries``.  ``clear(key)`` forgets a key's history."""

    def __init__(self, max_retries: int = 3):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = max_retries
        self.faults: Dict = {}

    def record_fault(self, key) -> Optional[int]:
        n = self.faults.get(key, 0) + 1
        self.faults[key] = n
        if n > self.max_retries:
            return None
        return 1 << (n - 1)

    def n_faults(self, key) -> int:
        return self.faults.get(key, 0)

    def clear(self, key) -> None:
        self.faults.pop(key, None)
