"""Metrics registry (torch twin of ``repro/obs/registry.py``): labeled
counters, gauges and histograms, a Prometheus-style text exposition and a
periodic JSONL snapshot writer.

The scheduler publishes its queue, slot, admission, chunk and host-sync
tallies here and ``ServeMetrics`` its dispatch, burst, latency,
preemption, fault and speculation accounting, into one shared registry.
Every update is a host-side dict write: a registry adds no host sync and
no device work.  Families expose in name order and label sets in sorted
order, so ``expose()`` and ``snapshot()`` are pure functions of the
recorded values, and equal to the reference's for the same values.
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# latency buckets in seconds, wide enough for CPU runs and the card alike
DEFAULT_TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Mapping[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


def _fmt(v: float) -> str:
    """A value as the exposition writes it: integers stay integral."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: Dict[LabelKey, float] = {}

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self.values):
            lines.append(f"{self.name}{_label_str(key)} "
                         f"{_fmt(self.values[key])}")
        return lines

    def snapshot(self):
        return [{"labels": dict(key), "value": self.values[key]}
                for key in sorted(self.values)]

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, "counters only go up"
        key = _label_key(labels)
        self.values[key] = self.values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.values[_label_key(labels)] = float(value)


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        assert self.buckets, "histogram needs at least one bucket"
        # by label set: [bucket counts (the last one +Inf), sum, count]
        self.values: Dict[LabelKey, List] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        entry = self.values.get(key)
        if entry is None:
            entry = self.values[key] = [[0] * (len(self.buckets) + 1),
                                        0.0, 0]
        counts = entry[0]
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        entry[1] += float(value)
        entry[2] += 1

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(self.values):
            counts, total, n = self.values[key]
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                lk = _label_str(key + (("le", _fmt(b)),))
                lines.append(f"{self.name}_bucket{lk} {cum}")
            lk = _label_str(key + (("le", "+Inf"),))
            lines.append(f"{self.name}_bucket{lk} {cum + counts[-1]}")
            lines.append(f"{self.name}_sum{_label_str(key)} {_fmt(total)}")
            lines.append(f"{self.name}_count{_label_str(key)} {n}")
        return lines

    def snapshot(self):
        out = []
        for key in sorted(self.values):
            counts, total, n = self.values[key]
            out.append({"labels": dict(key),
                        "buckets": {_fmt(b): c for b, c
                                    in zip(self.buckets, counts)},
                        "inf": counts[-1], "sum": total, "count": n})
        return out


class MetricsRegistry:
    """Get-or-create families: asking for a name again returns the family
    registered under it (of the same kind, else ValueError), so the
    scheduler and ``ServeMetrics`` share one registry."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m
        m = self._metrics[name] = cls(name, help, **kw)
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition, one block per family by name."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """{name: [{labels, value or histogram}, ...]}, JSON-clean."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


class SnapshotWriter:
    """JSONL snapshots of a registry, one compact object a line stamped
    with the scheduler clock time that wrote it; ``maybe_write(now)``
    writes when ``every_s`` has passed since the last one (the first call
    always writes).  The file is truncated when the writer is made."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 every_s: float = 1.0):
        self.registry = registry
        self.path = path
        self.every_s = float(every_s)
        self._last: Optional[float] = None
        self.n_written = 0
        open(path, "w").close()

    def maybe_write(self, now: float) -> bool:
        if self._last is not None and now - self._last < self.every_s:
            return False
        self.write(now)
        return True

    def write(self, now: float) -> None:
        self._last = now
        line = json.dumps({"ts": round(now, 6),
                           "metrics": self.registry.snapshot()},
                          sort_keys=True, separators=(",", ":"),
                          allow_nan=False)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        self.n_written += 1
