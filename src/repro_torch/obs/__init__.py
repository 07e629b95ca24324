"""Serving observability (torch twin of ``repro.obs``): Chrome trace
events, a metrics registry and a model-vs-measured step profiler for the
continuous-batching scheduler.

The pieces are independent and each optional; ``Observability`` bundles
them for ``Scheduler(engine, obs=...)`` and
``ServingEngine.generate({"tokens": ...}, ..., obs=...)``.  ``obs=None`` (the default) is a strict no-op: the scheduler
takes no extra clock sample, makes no extra host sync, dispatch or kernel
launch.  With the bundle attached it adds no host sync either: every hook
is a host-side record taken around syncs the scheduler already makes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .profiler import StepProfiler, step_cost
from .registry import (DEFAULT_TIME_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, SnapshotWriter)
from .trace import PID_REQUESTS, PID_SCHEDULER, Tracer

__all__ = [
    "Counter", "DEFAULT_TIME_BUCKETS", "Gauge", "Histogram",
    "MetricsRegistry", "Observability", "PID_REQUESTS", "PID_SCHEDULER",
    "SnapshotWriter", "StepProfiler", "Tracer", "step_cost",
]


@dataclasses.dataclass
class Observability:
    """What the scheduler takes.  Any field may be None: each hook is
    guarded on the field it needs."""
    tracer: Optional[Tracer] = None
    registry: Optional[MetricsRegistry] = None
    profiler: Optional[StepProfiler] = None
    # periodic JSONL snapshots of ``registry`` (scheduler clock time)
    snapshots: Optional[SnapshotWriter] = None

    def on_step(self, now: float) -> None:
        """Called by the scheduler once a step, after the round."""
        if self.snapshots is not None:
            self.snapshots.maybe_write(now)
