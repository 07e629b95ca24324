"""Chrome trace events for the serving path (torch twin of
``repro/obs/trace.py``; its output is the reference's byte for byte).

The scheduler emits one span per request phase (WAITING / PREFILL /
DECODE), one complete event per engine dispatch (a prefill chunk, a
decode step or burst with its K, tier and slots, a speculative draft and
verify) and counter samples of the queue and the slots, all stamped by
the scheduler's injectable clock.  Under a virtual clock two runs give
byte-identical files.

Layout (docs/observability.md):

  pid 1 "requests"   one tid per request id: WAITING / PREFILL / DECODE
                     spans and first_token / finished / preempted instants.
  pid 2 "scheduler"  tid 0 the prefill lane, tid 1 + i the decode lane of
                     the i-th KV tier (sorted), then a draft and a verify
                     lane per tier when speculation is on; queue_depth and
                     slots_used counter tracks.

The file is the trace-event "JSON array format", one event per line with
sorted keys and compact separators, which Perfetto
(https://ui.perfetto.dev) and chrome://tracing open as it is.  Times are
given in seconds (the scheduler clock's unit) and written in
microseconds.  On the card a decode event closes after the scheduler's
read of the sampled ids, so its duration is the dispatch's device time
plus the host's; a prefill chunk that computes no logits closes when its
launches are queued.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# the two processes the scheduler writes to
PID_REQUESTS = 1
PID_SCHEDULER = 2


def _us(t_s: float) -> float:
    """Seconds to microseconds, the trace's time unit."""
    return round(t_s * 1e6, 3)


class Tracer:
    """An append-only buffer of trace events in emission order; the same
    event stream serializes to the same bytes."""

    def __init__(self):
        self.events: List[Dict] = []
        self._named: set = set()

    def process_name(self, pid: int, name: str) -> None:
        key = ("process", pid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        key = ("thread", pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def complete(self, name: str, t0_s: float, t1_s: float, *, pid: int,
                 tid: int, cat: str = "serve",
                 args: Optional[Dict] = None) -> None:
        """One 'X' (complete) event over [t0_s, t1_s]."""
        evt = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
               "ts": _us(t0_s), "dur": _us(max(t1_s - t0_s, 0.0))}
        if args:
            evt["args"] = args
        self.events.append(evt)

    def instant(self, name: str, t_s: float, *, pid: int, tid: int,
                cat: str = "serve", args: Optional[Dict] = None) -> None:
        evt = {"ph": "i", "s": "t", "name": name, "cat": cat, "pid": pid,
               "tid": tid, "ts": _us(t_s)}
        if args:
            evt["args"] = args
        self.events.append(evt)

    def counter(self, name: str, t_s: float, values: Dict[str, float], *,
                pid: int = PID_SCHEDULER, tid: int = 0,
                cat: str = "serve") -> None:
        """One 'C' (counter) sample: a stacked track."""
        self.events.append({"ph": "C", "name": name, "cat": cat, "pid": pid,
                            "tid": tid, "ts": _us(t_s),
                            "args": dict(values)})

    def to_json(self) -> str:
        """A closed JSON array with one self-contained event per line
        (valid JSON, greppable line by line)."""
        lines = [json.dumps(e, sort_keys=True, separators=(",", ":"),
                            allow_nan=False)
                 for e in self.events]
        return "[\n" + ",\n".join(lines) + "\n]\n"

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    def __len__(self) -> int:
        return len(self.events)
