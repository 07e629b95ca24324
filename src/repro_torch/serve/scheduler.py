"""Continuous-batching scheduler: FCFS admission over one slot KV pool
(torch twin of the FCFS core of ``repro/serve/scheduler.py``).

Each ``step()``:
  1. **Admission** — waiting requests are admitted in arrival order while
     the pool has a free slot, at any time, including mid-flight between
     decode steps.
  2. **One prefill chunk** — the oldest PREFILL request advances by one
     chunk (chunked prefill interleaved with decode).  On its final chunk
     the first token is sampled (the request's TTFT event).
  3. **One decode round** — every DECODE slot advances, as one burst of K
     token-steps on the device (``engine.decode_burst``) or a single step
     for K = 1.  K is the least, over the decoding rows, of the tokens a
     row can still emit before its length or capacity limit, capped by
     ``max_burst``, rounded down to a power of two, and clamped to 1 while
     a request waits or a prefill is in flight (so admission latency and
     prefill interleaving match a burst-free scheduler).  EOS cannot be
     planned; rows that sample it stop on the device.

Retirement (EOS / max-new-tokens / slot capacity) frees the slot at once.
With greedy sampling a request's tokens do not depend on its slot, its
batch-mates or its admission time — except under W8A8 weights, whose
per-tensor activation scale spans every row of a call (the reference's
``kernels/ops.py:327``), so batch-mates move a row's logits.  The clock is
injectable for tests.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from .kv_pool import KVCachePool
from .metrics import ServeMetrics
from .request import Request, RequestState
from .sampling import sample_one


class Scheduler:
    def __init__(self, engine, *,
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine
        self.pool: KVCachePool = engine.new_pool()
        self.max_burst = engine.scfg.max_burst
        if self.max_burst < 1:
            raise ValueError("max_burst must be >= 1")
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}          # slot -> request
        self.finished: List[Request] = []
        self.metrics = ServeMetrics(self.pool.n_slots)
        self._clock = clock
        self._next_id = 0
        self.n_steps = 0
        self._dispatch_seq = 0      # engine dispatches (prefill and decode)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def n_decode_steps(self) -> int:
        return self.metrics.decode_token_steps

    def submit(self, req: Request) -> Request:
        need = req.prompt_len + req.sampling.max_new_tokens
        if need > self.pool.max_len:
            raise ValueError(f"request needs {need} cache positions > slot "
                             f"capacity {self.pool.max_len}")
        if req.id is None:
            req.id = self._next_id
        self._next_id = max(self._next_id, req.id) + 1
        req.state = RequestState.WAITING
        req.arrival_time = self._clock()
        self.metrics.on_arrival(req.arrival_time)
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
        while self.waiting and self.pool.n_free:
            req = self.waiting.popleft()
            req.slot = self.pool.alloc()
            req.prefill_pos = 0
            req.state = RequestState.PREFILL
            req.prompt_padded, _ = self.engine.pad_prompt(req.prompt)
            self.running[req.slot] = req

        self._prefill_one_chunk(emitted, finished_now)

        dec = sorted((r for r in self.running.values()
                      if r.state is RequestState.DECODE), key=lambda r: r.id)
        if dec:
            k = self._plan_burst(dec)
            if k <= 1:
                self._decode_single(dec, emitted, finished_now)
            else:
                self._decode_burst(dec, k, emitted, finished_now)

        self.n_steps += 1
        self.metrics.on_step(self._clock(), self.pool.n_used)
        return {"emitted": emitted, "finished": finished_now}

    # ------------------------------------------------------------------
    def _plan_burst(self, dec: List[Request]) -> int:
        if self.max_burst <= 1 or self.waiting or any(
                r.state is RequestState.PREFILL for r in self.running.values()):
            return 1
        k = self.max_burst
        for r in dec:
            budget = r.sampling.max_new_tokens - r.n_generated
            capacity = self.pool.max_len - int(self.pool.lengths[r.slot]) - 1
            k = min(k, max(1, min(budget, capacity)))
        return 1 << (k.bit_length() - 1)

    def _prefill_one_chunk(self, emitted: List,
                           finished_now: List[Request]) -> None:
        pre = [r for r in self.running.values()
               if r.state is RequestState.PREFILL]
        if not pre:
            return
        req = min(pre, key=lambda r: r.id)
        self._dispatch_seq += 1
        c = self.engine.scfg.prefill_chunk
        start = req.prefill_pos
        logits = self.engine.prefill_chunk_into_slot(
            self.pool, req.slot, req.prompt_padded, start,
            prompt_len=req.prompt_len)
        req.prefill_pos = min(start + c, req.prompt_len)
        if req.prefill_pos >= req.prompt_len:
            req.state = RequestState.DECODE
            tok = sample_one(logits[(req.prompt_len - 1) % c])
            self._emit(req, tok, emitted, finished_now)

    def _decode_single(self, dec: List[Request], emitted: List,
                       finished_now: List[Request]) -> None:
        tokens = np.zeros((self.pool.n_slots,), np.int32)
        for r in dec:
            tokens[r.slot] = r.last_token
        self._dispatch_seq += 1
        toks = self.engine.decode_slots(self.pool, tokens)
        self.metrics.on_decode_burst(1, len(dec))
        for r in dec:
            self.pool.lengths[r.slot] += 1      # the input token's KV
            self._emit(r, int(toks[r.slot]), emitted, finished_now)

    def _decode_burst(self, dec: List[Request], k: int, emitted: List,
                      finished_now: List[Request]) -> None:
        n = self.pool.n_slots
        tokens = np.zeros((n,), np.int32)
        eos = np.full((n,), -1, np.int32)
        active = np.zeros((n,), bool)
        rem = np.zeros((n,), np.int32)
        for r in dec:
            tokens[r.slot] = r.last_token
            eos[r.slot] = r.sampling.eos_id
            active[r.slot] = True
            rem[r.slot] = r.sampling.max_new_tokens - r.n_generated
        self._dispatch_seq += 1
        toks, valid = self.engine.decode_burst(self.pool, tokens, k, active,
                                               rem, eos)
        self.metrics.on_decode_burst(k, int(valid.sum()))
        # replay in step-major order; slots captured first because _emit
        # may retire a request mid-replay
        rows = [(r, r.slot) for r in dec]
        for t in range(k):
            for r, slot in rows:
                if valid[t, slot]:
                    self._emit(r, int(toks[t, slot]), emitted, finished_now)

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
        elif req.prompt_len + req.n_generated >= self.pool.max_len:
            self._retire(req, "capacity", now, finished_now)

    def _retire(self, req: Request, reason: str, now: float,
                finished_now: List[Request]) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = now
        del self.running[req.slot]
        self.pool.free(req.slot)
        req.slot = None
        self.finished.append(req)
        finished_now.append(req)
        self.metrics.on_finish(req)
