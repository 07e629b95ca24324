"""The port's serving policy layers against the JAX reference, on the CPU at
granite-smoke size, slab and paged pools (the paged pool's scenarios run
from ``tests/test_torch_slo_paged.py``, so that a run that spreads files
over workers runs the two halves side by side).

* Scenarios (the meshless ones of ``tests/test_slo_serving.py``): TTFT
  shedding, e2e retirement, typed rejections and protect priority,
  drain-time and deadline-unmeetable verdicts, downgrade hysteresis,
  cost-model planning, fault recovery (killed and poisoned dispatches),
  retry exhaustion and backoff, an injector that never fires, and the
  accounting identity.  Each runs, with the same seeded prompts and the
  same injected clock, on the port's scheduler and on the reference's
  (meshless, ``PrecisionPolicy(kernel='pallas')``); finish reasons,
  rejection kinds and estimates, downgrades, preemption and fault
  reasons, burst plans, backoff holds and the ``(kind, seq)`` log of the
  fault injector must be the reference's, and the reference's own
  assertions hold on both.  Tokens: a recovered request emits its
  fault-free run's tokens bit for bit (each side against itself), and the
  port's tokens are the reference's under the serving contract (equal, or
  parting first where the reference's top-2 gap, teacher-forced, is at
  most 0.1).
* ``SLOPolicy`` refuses what the reference refuses, with its messages.
* The fence catches ``StepFault`` alone: any other error a dispatch
  raises leaves ``Scheduler.step()``.
* ``launch/serve.py``'s ``--slo-*`` / fault flags build the policy and the
  seeded injector (quiet until armed, then its faults draw for draw) that
  the reference's ``benchmarks/serve_bench.py`` builds from them.
Every scenario draws its prompts from its own ``np.random.default_rng``.
"""
import argparse
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro.serve import SLOPolicy as RefSLOPolicy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.serve import (add_policy_args, build_fault_injector,
                                      build_slo)
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine, SLOPolicy,
                               StepFault)
from repro_torch.serve.sampling import batched_step_keys

DECIDED_GAP = 0.1
# report keys the two schedulers must agree on exactly
REPORT_KEYS = ("n_requests", "total_new_tokens", "finish_reasons",
               "preemptions", "preempt_reasons", "rejections",
               "rejection_kinds", "downgrades", "faults", "fault_requests",
               "fault_kinds", "burst_hist", "decode_dispatches",
               "decode_token_steps", "decode_tokens_emitted",
               "prefix_hits", "prefix_misses", "prefix_hit_tokens")


@pytest.fixture(scope="module")
def weights():
    cfg = ref_config("granite-8b", smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = get_config("granite-8b", smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


class Hook:
    """The fault injector of the hooked engines: quiet until ``arm(fn)``,
    then ``fn(kind, seq)`` with ``seq`` counted from the arming (as a
    fresh engine counts), every consultation logged."""

    def __init__(self):
        self.fn, self.base, self.last, self.log = None, 0, 0, []

    def __call__(self, kind, seq):
        self.last = seq
        if self.fn is None:
            return None
        self.log.append((kind, seq - self.base))
        return self.fn(kind, seq - self.base)

    def arm(self, fn):
        self.fn, self.base, self.log = fn, self.last, []


class Side:
    """One implementation's serving classes and its engines, cached by
    configuration (an engine carries no state between schedulers but its
    compiled steps and its fault counter)."""

    def __init__(self, name, weights):
        self.name, self.weights, self._engines = name, weights, {}
        ref = name == "ref"
        self.Request = RefRequest if ref else Request
        self.SamplingParams = RefSamplingParams if ref else SamplingParams
        self.Scheduler = RefScheduler if ref else Scheduler
        self.SLOPolicy = RefSLOPolicy if ref else SLOPolicy

    def engine(self, paged, n_slots=2, hooked=False):
        """(engine, its Hook or None): max_len 48, chunk 8, bf16 default
        tier; hooked engines allow 2 fault retries a request."""
        key = (paged, n_slots, hooked)
        if key not in self._engines:
            cfg, params, pcfg, port = self.weights
            hook = Hook() if hooked else None
            kw = dict(max_len=48, n_slots=n_slots, prefill_chunk=8,
                      paged=paged, fault_injector=hook, max_fault_retries=2)
            if self.name == "ref":
                eng = RefEngine(cfg, params, RefServeConfig(
                    policy=RefPolicy(kv="bf16", kernel="pallas"), **kw))
            else:
                eng = ServingEngine(pcfg, port, ServeConfig(
                    policy=PrecisionPolicy(kv="bf16"), device="cpu", **kw))
            self._engines[key] = (eng, hook)
        return self._engines[key]

    def sp(self, temp=0.0, max_new=24):
        return self.SamplingParams(max_new_tokens=max_new, temperature=temp,
                                   seed=7)


@pytest.fixture(scope="module")
def sides(weights):
    return {"port": Side("port", weights), "ref": Side("ref", weights)}


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _record(sched, extra=None):
    """What a scenario leaves behind: per request (in finish order) its
    id, reason, tier, downgrade, faults, preemptions, rejection, tokens
    and what the contract check needs; the agreed report keys."""
    rep = sched.metrics.report()
    json.dumps(rep, allow_nan=False)
    reqs = []
    for r in sched.finished:
        rej = None if r.rejection is None else r.rejection.to_dict()
        reqs.append({"id": r.id, "reason": r.finish_reason, "tier": r.tier,
                     "downgraded_from": r.downgraded_from,
                     "n_faults": r.n_faults,
                     "n_preemptions": r.n_preemptions, "rejection": rej,
                     "tokens": list(r.output_tokens),
                     "prompt": r.prompt.tolist(),
                     "temperature": float(r.sampling.temperature),
                     "seed": r.sampling.seed})
    out = {"requests": reqs, "n_steps": sched.n_steps,
           "report": {k: rep[k] for k in REPORT_KEYS if k in rep}}
    out.update(extra or {})
    return out


def _outputs(sched):
    return {r.id: list(r.output_tokens) for r in sched.finished}


# ---------------------------------------------------------------------------
# The scenarios: each runs on one side and asserts the reference test's
# claims there; the test then holds the port's record to the reference's
# ---------------------------------------------------------------------------
def ttft_deadline(side, paged, vocab):
    t = [0.0]
    eng, _ = side.engine(paged, n_slots=1)
    s = side.Scheduler(eng, clock=lambda: t[0])
    s.submit(side.Request(_prompts(vocab, [8])[0], side.sp(max_new=16),
                          id=0))
    s.step()            # seat id 0 before the deadline request arrives
    s.submit(side.Request(_prompts(vocab, [8], 1)[0], side.sp(max_new=4),
                          id=1, ttft_deadline_s=0.5))
    for _ in range(3):
        s.step()
        t[0] += 1.0
    s.run(max_steps=500)
    assert {r.id: r.finish_reason for r in s.finished} == \
        {0: "length", 1: "deadline_exceeded"}
    assert s.metrics.report()["finish_reasons"]["deadline_exceeded"] == 1
    assert len(s.metrics.ttft) == 1 and len(s.metrics.e2e) == 1
    return _record(s)


def e2e_deadline(side, paged, vocab):
    t = [0.0]
    eng, _ = side.engine(paged, n_slots=1)
    s = side.Scheduler(eng, clock=lambda: t[0])
    r = s.submit(side.Request(_prompts(vocab, [8])[0], side.sp(max_new=32),
                              id=0, e2e_deadline_s=2.5))
    while not r.is_finished:
        s.step()
        t[0] += 1.0
    assert r.finish_reason == "deadline_exceeded"
    assert 0 < r.n_generated < 32 and r.slot is None
    assert s.pool.n_free == s.pool.n_slots
    return _record(s)


def rejection_protect(side, paged, vocab):
    eng, _ = side.engine(paged)
    slo = side.SLOPolicy(max_waiting=2, protect_priority=0)
    s = side.Scheduler(eng, slo=slo)
    rejected = 0
    for p in _prompts(vocab, [8] * 8):
        r = s.submit(side.Request(p, side.sp(max_new=4), priority=2))
        if r.is_finished:
            rejected += 1
            assert r.finish_reason == "rejected"
            assert r.rejection.kind == "queue_full"
    assert rejected > 0
    protected = s.submit(side.Request(_prompts(vocab, [8], 9)[0],
                                      side.sp(max_new=4), priority=0))
    assert not protected.is_finished
    s.run(max_steps=500)
    rep = s.metrics.report()
    assert rep["rejection_kinds"] == {"queue_full": rejected}
    assert rep["finish_reasons"]["rejected"] == rejected
    return _record(s, {"snapshot": slo.snapshot()})


def drain_and_deadline(side, paged, vocab):
    eng, _ = side.engine(paged)
    s = side.Scheduler(eng, slo=side.SLOPolicy(max_queue_delay_s=1e-9))
    first = s.submit(side.Request(_prompts(vocab, [8])[0],
                                  side.sp(max_new=4), priority=1))
    assert not first.is_finished
    second = s.submit(side.Request(_prompts(vocab, [8], 1)[0],
                                   side.sp(max_new=4), priority=1))
    assert second.is_finished and second.rejection.kind == "drain_time"
    assert second.rejection.estimate_s > 0
    s.run(max_steps=500)
    s2 = side.Scheduler(eng, slo=side.SLOPolicy())
    s2.submit(side.Request(_prompts(vocab, [8])[0], side.sp(max_new=4),
                           priority=1))
    doomed = s2.submit(side.Request(_prompts(vocab, [8], 1)[0],
                                    side.sp(max_new=4), priority=1,
                                    ttft_deadline_s=1e-12))
    assert doomed.is_finished
    assert doomed.rejection.kind == "deadline_unmeetable"
    s2.run(max_steps=500)
    return _record(s, {"second": _record(s2)})


def downgrade_hysteresis(side, paged, vocab):
    eng, _ = side.engine(paged)
    hi = 1e-6
    slo = side.SLOPolicy(downgrade_map={"bf16": "int8"},
                         downgrade_high_s=hi, downgrade_low_s=hi / 10)
    s = side.Scheduler(eng, tiers=["bf16", "int8"], slo=slo)
    states = []
    r1 = s.submit(side.Request(_prompts(vocab, [8])[0], side.sp(max_new=8)))
    states.append((r1.tier, slo.degraded, slo.last_estimate_s))
    assert r1.tier == "bf16" and not slo.degraded
    r2 = s.submit(side.Request(_prompts(vocab, [8], 1)[0],
                               side.sp(max_new=8)))
    states.append((r2.tier, slo.degraded, slo.last_estimate_s))
    assert slo.degraded and r2.tier == "int8" \
        and r2.downgraded_from == "bf16"
    assert slo.downgrade_low_s < slo.last_estimate_s
    s.run(max_steps=500)
    r3 = s.submit(side.Request(_prompts(vocab, [8], 2)[0],
                               side.sp(max_new=8)))
    states.append((r3.tier, slo.degraded, slo.last_estimate_s))
    assert not slo.degraded and r3.tier == "bf16" \
        and r3.downgraded_from is None
    s.run(max_steps=500)
    assert s.metrics.report()["downgrades"] == 1
    assert r2.tier == "int8"
    return _record(s, {"states": states, "snapshot": slo.snapshot()})


def cost_model_planning(side, paged, vocab):
    eng, _ = side.engine(paged, n_slots=4)
    tight = side.SLOPolicy(max_step_s=1e-12)
    loose = side.SLOPolicy(max_step_s=10.0)
    s = side.Scheduler(eng, slo=tight)
    for i, p in enumerate(_prompts(vocab, [8, 8])):
        s.submit(side.Request(p, side.sp(max_new=8), id=i))
    s.run(max_steps=500)
    assert set(s.metrics.report()["burst_hist"]) == {"1"}
    plan = {"tight_chunks": tight.prefill_chunks_per_step(s)}
    assert plan["tight_chunks"] == 1
    s2 = side.Scheduler(eng, slo=loose)
    for i, p in enumerate(_prompts(vocab, [8, 8])):
        s2.submit(side.Request(p, side.sp(max_new=8), id=i))
    dec = list(s2.running.values())
    plan.update(loose_cap=loose.burst_cap(s2, dec, s2.pool, 8),
                loose_chunks=loose.prefill_chunks_per_step(s2))
    assert plan["loose_cap"] == 8 and plan["loose_chunks"] >= 1
    s2.run(max_steps=500)
    plan["drained_estimate"] = tight.estimate_queue_delay_s(s2)
    assert plan["drained_estimate"] == 0.0
    return _record(s, {"plan": plan, "second": _record(s2)})


def _fault_recovery(side, paged, vocab, mode):
    prompts = _prompts(vocab, [16, 12])

    def run(fn):
        eng, hook = side.engine(paged, hooked=True)
        hook.arm(fn)
        s = side.Scheduler(eng)
        for i, p in enumerate(prompts):
            s.submit(side.Request(p, side.sp(temp=0.8, max_new=12), id=i))
        s.run(max_steps=2000)
        return s, list(hook.log)

    ref, clean_log = run(None)
    fired = []
    s, log = run(lambda kind, seq: (fired.append(seq) or mode)
                 if seq == 5 and not fired else None)
    assert fired == [5]
    assert _outputs(s) == _outputs(ref)          # bit for bit, own side
    rep = s.metrics.report()
    assert rep["faults"] == 1 and rep["fault_kinds"] == {mode: 1}
    assert rep["preempt_reasons"].get("fault", 0) >= 1
    return _record(s, {"log": log, "clean_log": clean_log,
                       "clean": _record(ref)})


def fault_injected(side, paged, vocab):
    return _fault_recovery(side, paged, vocab, "injected")


def fault_nan(side, paged, vocab):
    return _fault_recovery(side, paged, vocab, "nan")


def fault_exhaustion(side, paged, vocab):
    eng, hook = side.engine(paged, hooked=True)
    hook.arm(lambda kind, seq: "injected" if kind != "prefill" else None)
    s = side.Scheduler(eng)
    reqs = [s.submit(side.Request(p, side.sp(max_new=8), id=i))
            for i, p in enumerate(_prompts(vocab, [16, 12]))]
    holds = {}
    while s.has_work:
        s.step()
        for r in s.waiting:
            if r.n_faults:
                holds.setdefault(r.id, []).append(
                    r.hold_until_step - s.n_steps)
        assert s.n_steps < 2000
    for r in reqs:
        assert r.finish_reason == "fault" and r.n_faults == 3
        assert r.slot is None
    assert any(max(h) >= 1 for h in holds.values())
    assert s.pool.n_free == s.pool.n_slots
    if paged:
        s.pool.allocator.check()
    rep = s.metrics.report()
    assert rep["finish_reasons"]["fault"] == 2
    assert rep["fault_requests"] >= 6
    return _record(s, {"holds": {str(k): v for k, v in holds.items()},
                       "log": list(hook.log)})


def injector_inert(side, paged, vocab):
    prompts = _prompts(vocab, [16, 12])
    runs = []
    for hooked in (False, True):
        eng, hook = side.engine(paged, hooked=hooked)
        if hook is not None:
            hook.arm(lambda kind, seq: None)
        s = side.Scheduler(eng)
        for i, p in enumerate(prompts):
            s.submit(side.Request(p, side.sp(max_new=8), id=i))
        s.run(max_steps=500)
        runs.append(s)
    plain, quiet = runs
    assert _outputs(plain) == _outputs(quiet)
    assert not plain._ft_check and quiet._ft_check
    assert plain.metrics.n_fault_events == quiet.metrics.n_fault_events == 0
    return _record(plain, {"quiet": _record(quiet)})


def accounting(side, paged, vocab):
    t = [0.0]
    eng, _ = side.engine(paged)
    slo = side.SLOPolicy(max_waiting=3, protect_priority=0)
    s = side.Scheduler(eng, clock=lambda: t[0], slo=slo)
    rng = np.random.default_rng(3)
    for i in range(12):
        s.submit(side.Request(
            rng.integers(1, vocab, (8,)).astype(np.int32),
            side.sp(max_new=4), priority=int(i % 2) * 5,
            ttft_deadline_s=4.0 if i % 3 == 0 else None))
        t[0] += 0.1
    while s.has_work:
        s.step()
        t[0] += 1.0
        assert s.n_steps < 500
    rep = s.metrics.report()
    assert json.loads(json.dumps(rep, allow_nan=False)) == rep
    disjoint = sum(v for k, v in rep["finish_reasons"].items()
                   if k != "preempted_resumed")
    assert disjoint == rep["n_requests"] == s.metrics.n_arrived == 12
    assert set(rep["queue_wait_p50_s"]) <= {"0", "5"}
    assert "per_priority" in rep
    for cls in rep["per_priority"].values():
        assert all(v is not None for v in cls.values())
    # the reference rounds these percentiles to 4 decimals
    return _record(s, {"snapshot": slo.snapshot(),
                       "per_priority": _round4(rep["per_priority"]),
                       "queue_wait_p50_s": _round4(rep["queue_wait_p50_s"])})


def _round4(d):
    return {k: _round4(v) if isinstance(v, dict) else round(v, 4)
            for k, v in d.items()}


SCENARIOS = [ttft_deadline, e2e_deadline, rejection_protect,
             drain_and_deadline, downgrade_hysteresis, cost_model_planning,
             fault_injected, fault_nan, fault_exhaustion, injector_inert,
             accounting]


# ---------------------------------------------------------------------------
# The port's record against the reference's
# ---------------------------------------------------------------------------
def _strip_tokens(rec):
    """The record without tokens and estimates (compared apart)."""
    if isinstance(rec, dict):
        return {k: _strip_tokens(v) for k, v in rec.items()
                if k not in ("tokens", "estimate_s", "last_estimate_s")}
    if isinstance(rec, list):
        return [_strip_tokens(v) for v in rec]
    if isinstance(rec, tuple):
        return tuple(_strip_tokens(v) for v in rec
                     if not isinstance(v, float))
    return rec


def _estimates(rec, out=None):
    """Every cost-model estimate in a record, in order."""
    out = [] if out is None else out
    if isinstance(rec, dict):
        for k, v in rec.items():
            if k in ("estimate_s", "last_estimate_s") and v is not None:
                out.append(v)
            else:
                _estimates(v, out)
    elif isinstance(rec, (list, tuple)):
        for v in rec:
            if isinstance(v, float) and isinstance(rec, tuple):
                out.append(v)
            else:
                _estimates(v, out)
    return out


def _requests(rec, out=None):
    out = [] if out is None else out
    if isinstance(rec, dict):
        out.extend(rec.get("requests", []))
        for k, v in rec.items():
            if k != "requests":
                _requests(v, out)
    return out


def _reference_gap(weights, req, step):
    """The reference's top-2 gap (Gumbel-perturbed for a temperature row)
    at generated token ``step`` of ``req``, teacher-forced on its own
    tokens through a fresh meshless engine at the request's tier."""
    cfg, params, _, _ = weights
    eng = RefEngine(cfg, params, RefServeConfig(
        max_len=48, n_slots=2, prefill_chunk=8,
        policy=RefPolicy(kv="bf16", kernel="pallas")))
    pool = eng.new_pool(kv_dtype=req["tier"])
    slot = pool.alloc()
    logits = np.asarray(eng.prefill_into_slots(
        pool, [slot], [np.asarray(req["prompt"], np.int32)])[0], np.float32)
    feed = np.zeros((pool.n_slots,), np.int32)
    for tok in req["tokens"][:step]:
        feed[slot] = tok
        logits = np.asarray(eng.decode_slots_with_logits(pool, feed),
                            np.float32)[slot]
        pool.lengths[slot] += 1
    scores = logits
    if req["temperature"] > 0:
        key = batched_step_keys([req["seed"]], [req["id"]], [step], 1)[0, 0]
        noise = jax.random.gumbel(jnp.asarray(key), (logits.shape[0],),
                                  jnp.float32)
        t = jnp.maximum(jnp.float32(req["temperature"]), jnp.float32(1e-6))
        scores = np.asarray(noise + jnp.asarray(logits) / t)
    top2 = np.sort(scores)[-2:]
    return float(top2[1] - top2[0])


def _hold_tokens_to_reference(weights, port_rec, ref_rec):
    """Equal tokens, or the first parting where the reference's top-2 gap
    is at most ``DECIDED_GAP`` (its tokens at that step were a near tie)."""
    port_reqs, ref_reqs = _requests(port_rec), _requests(ref_rec)
    assert len(port_reqs) == len(ref_reqs)
    for p, r in zip(port_reqs, ref_reqs):
        if p["tokens"] == r["tokens"]:
            continue
        j = next((i for i, (a, b) in enumerate(zip(p["tokens"],
                                                   r["tokens"])) if a != b),
                 None)
        assert j is not None, (p["id"], "token counts differ")
        gap = _reference_gap(weights, r, j)
        assert gap <= DECIDED_GAP, (p["id"], j, gap)


@pytest.mark.parametrize("paged", [False], ids=["slab"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_reference(weights, sides, scenario, paged):
    _scenario_equals_reference(weights, sides, scenario, paged)


def _scenario_equals_reference(weights, sides, scenario, paged):
    vocab = weights[2].vocab
    port = scenario(sides["port"], paged, vocab)
    ref = scenario(sides["ref"], paged, vocab)
    assert _strip_tokens(port) == _strip_tokens(ref)
    est_p, est_r = _estimates(port), _estimates(ref)
    assert len(est_p) == len(est_r)
    np.testing.assert_allclose(est_p, est_r, rtol=1e-12, atol=0)
    _hold_tokens_to_reference(weights, port, ref)


# ---------------------------------------------------------------------------
# Validation and the fence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(downgrade_high_s=1.0), "both"),
    (dict(downgrade_high_s=1.0, downgrade_low_s=2.0), "inverted"),
    (dict(downgrade_map={"bf16": "int8"}), "never fires")])
def test_policy_validation_equals_reference(kw, match):
    with pytest.raises(ValueError, match=match) as port:
        SLOPolicy(**kw)
    with pytest.raises(ValueError, match=match) as ref:
        RefSLOPolicy(**kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kind", ["prefill", "decode", "burst"])
def test_fence_catches_only_step_faults(weights, kind):
    """A dispatch that raises anything but ``StepFault`` (here a stand-in
    for a CUDA error) ends the run: the error leaves ``step()`` and no
    request is requeued or retired for it."""
    _, _, pcfg, port = weights

    class DeviceError(RuntimeError):
        pass

    def injector(k, seq):
        if k == kind:
            raise DeviceError("CUDA error: an illegal memory access")
        return None

    eng = ServingEngine(pcfg, port, ServeConfig(
        max_len=48, n_slots=2, prefill_chunk=8, max_burst=8,
        policy=PrecisionPolicy(kv="bf16"), device="cpu",
        fault_injector=injector))
    s = Scheduler(eng)
    s.submit(Request(_prompts(pcfg.vocab, [12])[0],
                     SamplingParams(max_new_tokens=8)))
    with pytest.raises(DeviceError) as err:
        for _ in range(50):
            s.step()
    assert not isinstance(err.value, StepFault)
    assert s.metrics.n_fault_events == 0 and not s.finished
    assert s.metrics.preempt_reasons.get("fault", 0) == 0


def test_step_fault_is_what_the_fence_catches(weights):
    """The same dispatch raising ``StepFault`` is recovered from."""
    _, _, pcfg, port = weights
    fired = []

    def injector(k, seq):
        if k == "decode" and not fired:
            fired.append(seq)
            raise StepFault("shard", "lost")
        return None

    eng = ServingEngine(pcfg, port, ServeConfig(
        max_len=48, n_slots=2, prefill_chunk=8, max_burst=1,
        policy=PrecisionPolicy(kv="bf16"), device="cpu",
        fault_injector=injector))
    s = Scheduler(eng)
    r = s.submit(Request(_prompts(pcfg.vocab, [12])[0],
                         SamplingParams(max_new_tokens=8)))
    s.run(max_steps=200)
    assert fired and r.finish_reason == "length" and r.n_faults == 1
    assert s.metrics.report()["fault_kinds"] == {"shard": 1}


def _reference_bench():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "serve_bench.py"
    spec = importlib.util.spec_from_file_location("ref_serve_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["--slo-max-waiting", "4", "--slo-protect-priority", "1"],
    ["--slo-max-queue-delay-s", "2.5", "--slo-downgrade", "bf16:int8",
     "--slo-high-s", "0.5", "--slo-low-s", "0.1", "--slo-max-step-s", "1.1"],
    ["--fault-rate", "0.1", "--seed", "7"],
    ["--fault-rate", "0.35", "--seed", "3", "--slo-max-waiting", "2"]])
def test_launch_flags_build_the_reference_policy_and_injector(argv):
    bench = _reference_bench()
    ap = argparse.ArgumentParser()
    add_policy_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    mine, theirs = build_slo(args), bench.build_slo(args)
    assert (mine is None) == (theirs is None)
    if mine is not None:
        assert mine.snapshot() == theirs.snapshot()
    (inj, arm), (rinj, rarm) = build_fault_injector(args), \
        bench.build_fault_injector(args)
    assert (inj is None) == (rinj is None)
    if inj is None:
        return
    kinds = ["prefill", "decode", "burst"]
    assert [inj(kinds[i % 3], i) for i in range(5)] == [None] * 5
    arm()
    rarm()
    got = [inj(kinds[i % 3], i) for i in range(400)]
    assert got == [rinj(kinds[i % 3], i) for i in range(400)]
    assert {"nan", "injected"} <= set(got)
