"""The port's serving slice against the JAX reference at granite-smoke and
minitron-smoke size.

* Teacher-forced: the port's ServingEngine and a meshless reference
  ServingEngine with ``PrecisionPolicy(kernel='pallas')`` (the kernel path
  the port reproduces) prefill the same prompts and decode the same tokens;
  logits agree within rtol/atol 5e-2 at every step, and greedy ids agree
  wherever the reference's top-2 gap exceeds 0.1.
* The port's scheduler: mid-flight admission and decode bursts give the
  tokens a request gets served alone; slots are reused; metrics are sane.
* W8A8 (minitron): one activation scale spans every row of a linear's
  call, so batch-mates move a row's logits — in the reference and, the
  same way, in the port; a serve run repeats exactly.
* KV tiers, temperature and preemption: one port engine serves bf16,
  int8 and fp8 requests side by side, each request's tokens those of its
  single-tier run; the greedy rows are the reference's mixed-tier
  scheduler's, the temperature rows the reference's wherever its perturbed
  top-2 gap exceeds 0.1 (teacher-forced); a preempted request resumes to
  its unpreempted tokens.
All on the CPU (the kernels' plain versions); weights from the reference's
seeded QuantMaker through the bridge.
"""
import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine, bytes_per_slot)
from repro_torch.serve.sampling import batched_step_keys, sample_rows

TOL = 5e-2
DECIDED_GAP = 0.1


def _smoke_weights(arch, policy_weights=()):
    cfg = get_config(arch, smoke=True)
    plan = RefPolicy(weights=policy_weights).validate_for(cfg) \
        .resolved_plan(cfg) if policy_weights else None
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0),
                                                plan=plan))
    pcfg = port_config(arch, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, pcfg, port


@pytest.fixture(scope="module")
def weights():
    return _smoke_weights("granite-8b")


@pytest.fixture(scope="module")
def minitron_weights():
    return _smoke_weights("minitron-8b")


def _engine(weights, tier="bf16", policy_weights=(), **kw):
    _, _, pcfg, port = weights
    kw.setdefault("max_len", 48)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pcfg, port, ServeConfig(
        policy=PrecisionPolicy(weights=policy_weights, kv=tier),
        device="cpu", **kw))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _ref_engine(weights, tier, policy_weights=(), **kw):
    cfg, params, _, _ = weights
    kw.setdefault("max_len", 32)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return RefEngine(cfg, params, RefServeConfig(
        policy=RefPolicy(weights=policy_weights, kv=tier, kernel="pallas"),
        **kw))


# the smoke models of the float packed schemes, by test id: (arch, policy
# weights); "mixed" is starcoder2 with fp8 attention and mxfp4 FFN
FLOAT_PACKED = {"starcoder2-15b": ("starcoder2-15b", ()),
                "nemotron-4-340b": ("nemotron-4-340b", ()),
                "mixed": ("starcoder2-15b", (("attn.*", "fp8"),
                                             ("ffn.*", "mxfp4")))}


@functools.lru_cache(maxsize=None)
def _float_packed_weights(case):
    return _smoke_weights(*FLOAT_PACKED[case])


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", list(FLOAT_PACKED))
def test_teacher_forced_logits_match_reference_engine_on_float_packed(
        case, tier):
    """starcoder2-smoke (mxfp4, GELU), nemotron-smoke (mxfp4, squared
    ReLU) and starcoder2-smoke under fp8 attention / mxfp4 FFN, against
    the reference engine; with fp8 KV run op by op (``jax.disable_jit``):
    under ``jit`` XLA keeps some bf16 intermediates in f32, which moves
    fp8 KV codes (``test_torch_model.py``)."""
    _teacher_forced_vs_reference(_float_packed_weights(case), tier,
                                 eager=tier == "fp8",
                                 policy_weights=FLOAT_PACKED[case][1])


def test_scheduler_serves_starcoder2_with_the_reference_tokens():
    """starcoder2-smoke through the port's Scheduler (staggered admission,
    int8 KV, bursts): each request's greedy tokens equal the reference
    engine's for that request."""
    weights = _float_packed_weights("starcoder2-15b")
    eng = _engine(weights, "int8")
    ref = _ref_engine(weights, "int8", max_len=48)
    prompts = _prompts(eng.cfg.vocab, (8, 6, 10, 13), seed=9)
    sched = Scheduler(eng)
    reqs = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[:2]]
    while sched.n_decode_steps < 2:
        sched.step()
    reqs += [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[2:]]
    sched.run(max_steps=200)
    for req, p in zip(reqs, prompts):
        want = ref.generate({"tokens": p[None]}, max_new_tokens=6)
        assert req.is_finished and req.n_generated == 6
        np.testing.assert_array_equal(np.asarray(req.output_tokens),
                                      want["generated"][0])


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_teacher_forced_logits_match_reference_engine(weights, tier):
    _teacher_forced_vs_reference(weights, tier)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_teacher_forced_logits_match_reference_engine_on_w8a8(
        minitron_weights, tier):
    """minitron-smoke, against the reference engine run op by op
    (``jax.disable_jit``): under ``jit`` XLA keeps some bf16
    intermediates in f32, which moves W8A8 activation codes away from the
    reference's own op-by-op result (ROADMAP R6)."""
    _teacher_forced_vs_reference(minitron_weights, tier, eager=True)


def _teacher_forced_vs_reference(weights, tier, eager=False,
                                 policy_weights=()):
    cfg = weights[0]
    ref_ctx = jax.disable_jit if eager else contextlib.nullcontext
    ref = _ref_engine(weights, tier, policy_weights)
    port = _engine(weights, tier, policy_weights, max_len=32)
    prompts = _prompts(cfg.vocab, (11, 8, 5), seed=5)
    rpool, ppool = ref.new_pool(), port.new_pool()
    slots = [rpool.alloc() for _ in prompts]
    assert slots == [ppool.alloc() for _ in prompts]
    with ref_ctx():
        want = [np.asarray(x, np.float32)
                for x in ref.prefill_into_slots(rpool, slots, prompts)]
    got = [x.numpy() for x in port.prefill_into_slots(ppool, slots, prompts)]
    steps = [(np.stack(want), np.stack(got))]
    toks = np.zeros((4,), np.int32)
    toks[slots] = np.stack(want).argmax(-1)
    for _ in range(4):
        with ref_ctx():
            w = np.asarray(ref.decode_slots_with_logits(rpool, toks),
                           np.float32)[slots]
        g = port.decode_slots_with_logits(ppool, toks).numpy()[slots]
        steps.append((w, g))
        for s in slots:
            rpool.lengths[s] += 1
            ppool.lengths[s] += 1
        toks[slots] = w.argmax(-1)              # teacher forcing
    n_decided = 0
    for w, g in steps:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        top2 = np.sort(w, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > DECIDED_GAP
        n_decided += int(decided.sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      w.argmax(-1)[decided])
    assert n_decided >= len(steps)      # the check compared real tokens


def test_w8a8_batch_mates_move_a_rows_logits_on_both_sides(minitron_weights):
    """Row 0 keeps its prompt while its batch-mate's prompt changes.  Under
    W8A8 the decode step quantizes both rows with one activation scale, so
    row 0's logits change in the reference; the port reproduces the
    reference's logits in both batches."""
    cfg = minitron_weights[0]
    a, mate1, mate2 = _prompts(cfg.vocab, (9, 7, 7), seed=8)
    rows = {}
    for mate in (mate1, mate2):
        ref = _ref_engine(minitron_weights, "bf16", n_slots=2)
        port = _engine(minitron_weights, max_len=32, n_slots=2)
        rpool, ppool = ref.new_pool(), port.new_pool()
        slots = [rpool.alloc(), rpool.alloc()]
        assert slots == [ppool.alloc(), ppool.alloc()]
        with jax.disable_jit():
            pre = np.stack([np.asarray(x, np.float32) for x in
                            ref.prefill_into_slots(rpool, slots, [a, mate])])
        port.prefill_into_slots(ppool, slots, [a, mate])
        toks = pre.argmax(-1).astype(np.int32)
        with jax.disable_jit():
            want = np.asarray(ref.decode_slots_with_logits(rpool, toks),
                              np.float32)
        got = port.decode_slots_with_logits(ppool, toks).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        rows[len(rows)] = (want[0], got[0])
    (ref1, port1), (ref2, port2) = rows[0], rows[1]
    assert np.abs(ref1 - ref2).max() > 0       # the reference's property
    assert np.abs(port1 - port2).max() > 0     # reproduced by the port


def test_w8a8_serving_admits_mid_flight_and_repeats_exactly(minitron_weights):
    """A staggered serve run on minitron-smoke finishes every request, and
    the same run repeated gives the same tokens (the solo-run property does
    not hold under W8A8: see the test above)."""
    prompts = _prompts(minitron_weights[0].vocab, (8, 6, 10, 13), seed=4)
    outputs = []
    for _ in range(2):
        sched = Scheduler(_engine(minitron_weights, "int8"))
        reqs = [sched.submit(Request(prompt=p, sampling=SamplingParams(
            max_new_tokens=5))) for p in prompts[:2]]
        while sched.n_decode_steps < 2:
            sched.step()
        assert any(r.n_generated > 0 for r in reqs)
        reqs += [sched.submit(Request(prompt=p, sampling=SamplingParams(
            max_new_tokens=5))) for p in prompts[2:]]
        sched.run(max_steps=200)
        assert all(r.is_finished and r.n_generated == 5 for r in reqs)
        outputs.append([r.output_tokens for r in reqs])
    assert outputs[0] == outputs[1]


def test_scheduler_mid_flight_admission_matches_solo_runs(weights):
    eng = _engine(weights)
    prompts = _prompts(eng.cfg.vocab, (8, 6, 10, 13), seed=4)
    solo = [eng.generate({"tokens": p[None]},
                         max_new_tokens=5)["generated"][0] for p in prompts]
    sched = Scheduler(eng)
    first = [sched.submit(Request(prompt=p,
                                  sampling=SamplingParams(max_new_tokens=5)))
             for p in prompts[:2]]
    while sched.n_decode_steps < 2:
        sched.step()
    assert any(r.n_generated > 0 for r in first)
    late = [sched.submit(Request(prompt=p,
                                 sampling=SamplingParams(max_new_tokens=5)))
            for p in prompts[2:]]
    sched.run(max_steps=200)
    for req, want in zip(first + late, solo):
        assert req.is_finished and req.finish_reason == "length"
        np.testing.assert_array_equal(np.asarray(req.output_tokens), want)


def test_one_shot_batch_matches_solo_and_bursts_match_single_steps(weights):
    eng = _engine(weights, "int8")
    prompts = _prompts(eng.cfg.vocab, (9, 9, 9), seed=6)
    batch = eng.generate({"tokens": np.stack(prompts)}, max_new_tokens=12)
    for row, p in zip(batch["generated"], prompts):
        np.testing.assert_array_equal(
            row, eng.generate({"tokens": p[None]},
                              max_new_tokens=12)["generated"][0])
    single = _engine(weights, "int8", max_burst=1)
    np.testing.assert_array_equal(
        batch["generated"],
        single.generate({"tokens": np.stack(prompts)},
                        max_new_tokens=12)["generated"])


def test_slot_reuse_eos_and_metrics(weights):
    eng = _engine(weights)
    prompts = _prompts(eng.cfg.vocab, (6, 9, 5), seed=7) * 3
    probe = eng.generate({"tokens": prompts[0][None]},
                         max_new_tokens=4)["generated"][0]
    clock = iter(range(10_000))
    sched = Scheduler(eng, clock=lambda: float(next(clock)))
    reqs = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=4, eos_id=int(probe[1]) if i == 0 else -1)))
        for i, p in enumerate(prompts)]
    max_used = 0
    while sched.has_work:
        sched.step()
        assert sched.pool.n_used <= sched.pool.n_slots
        max_used = max(max_used, sched.pool.n_used)
    assert max_used == sched.pool.n_slots
    assert reqs[0].finish_reason == "eos" and reqs[0].n_generated == 2
    assert all(r.finish_reason == "length" for r in reqs[1:])
    rep = sched.metrics.report()
    json.dumps(rep, allow_nan=False)
    assert rep["n_requests"] == len(prompts)
    assert rep["total_new_tokens"] == sum(r.n_generated for r in reqs)
    assert rep["tokens_per_s"] > 0 and 0 < rep["slot_occupancy_mean"] <= 1
    assert rep["ttft_p50_s"] > 0 and rep["itl_p50_s"] > 0


def test_serving_entry_points_refuse_what_is_not_ported(weights):
    """What is still refused: a request at a KV tier the scheduler does
    not serve (at submit), a CUDA engine without a card, and a request
    that overflows its slot."""
    _, _, pcfg, port = weights
    eng = _engine(weights, max_len=16)
    with pytest.raises(ValueError, match="no pool at that tier"):
        Scheduler(eng, tiers=["bf16", "int8"]).submit(Request(
            prompt=np.ones(4, np.int32), kv_policy="fp8"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(pcfg, port, ServeConfig())      # device="cuda"
    with pytest.raises(ValueError, match="cache positions"):
        Scheduler(eng).submit(Request(prompt=np.ones(12, np.int32),
                                      sampling=SamplingParams(
                                          max_new_tokens=8)))


def test_engine_holds_parameters_to_the_policy_schemes():
    """A policy that keeps ``attn.wo`` dense needs parameters built with
    the same plan; a mismatch raises at engine construction."""
    pcfg = port_config("granite-8b", smoke=True)
    policy = PrecisionPolicy(weights=(("attn.wo", "bf16"),), kv="fp8")
    plan = policy.validate_for(pcfg).resolved_plan(pcfg)
    params = T.build_params(pcfg, C.QuantMaker(1, device="cpu", plan=plan))
    assert isinstance(params.layers[0].attn["wo"], C.DenseLinear)
    eng = ServingEngine(pcfg, params, ServeConfig(policy=policy, max_len=24,
                                                  prefill_chunk=8,
                                                  device="cpu"))
    out = eng.generate({"tokens": np.arange(1, 10, dtype=np.int32)[None]},
                       max_new_tokens=3)
    assert out["generated"].shape == (1, 3)
    assert eng.new_pool().kv_dtype == "fp8"
    with pytest.raises(ValueError, match="attn.wo"):
        ServingEngine(pcfg, params, ServeConfig(device="cpu"))


# ---------------------------------------------------------------------------
# KV tiers side by side, temperature rows, priority preemption
# ---------------------------------------------------------------------------
TIERS = ("bf16", "int8", "fp8")
TIER_SEED = 7


def _tier_jobs(vocab):
    """(id, prompt, tier, temperature): two requests a tier, temperature
    rows on each tier."""
    prompts = _prompts(vocab, (9, 6, 11, 8, 7, 10), seed=13)
    tiers = ("bf16", "int8", "fp8", "int8", "bf16", "fp8")
    temps = (0.0, 0.7, 0.0, 0.0, 0.8, 0.9)
    return list(zip(range(6), prompts, tiers, temps))


def _serve_jobs(sched, jobs, request_cls, sampling_cls, *, tiered=True,
                late_from=None, max_new=6):
    """Submit ``jobs`` (the ones from ``late_from`` on once two decode steps
    ran); returns {id: tokens}."""
    def submit(job):
        rid, prompt, tier, temp = job
        return sched.submit(request_cls(
            prompt=prompt, id=rid, kv_policy=tier if tiered else None,
            sampling=sampling_cls(temperature=temp, max_new_tokens=max_new,
                                  seed=TIER_SEED)))

    late_from = len(jobs) if late_from is None else late_from
    reqs = [submit(j) for j in jobs[:late_from]]
    while jobs[late_from:] and sched.n_decode_steps < 2:
        sched.step()
    reqs += [submit(j) for j in jobs[late_from:]]
    sched.run(max_steps=400)
    assert all(r.is_finished and r.n_generated == max_new for r in reqs)
    return {r.id: list(r.output_tokens) for r in reqs}


@pytest.fixture(scope="module")
def mixed_run(weights):
    """The port's mixed-tier run: one engine, three pools of 2 slots,
    requests admitted mid-flight."""
    jobs = _tier_jobs(weights[0].vocab)
    sched = Scheduler(_engine(weights, max_len=32, n_slots=2),
                      tiers=list(TIERS))
    got = _serve_jobs(sched, jobs, Request, SamplingParams, late_from=3)
    return jobs, got, sched


@pytest.fixture(scope="module")
def ref_mixed_run(weights):
    """The reference's jitted mixed-tier run of the same jobs, meshless,
    ``PrecisionPolicy(kernel='pallas')``: {id: tokens}."""
    ref = _ref_engine(weights, "bf16", max_len=32, n_slots=2)
    return _serve_jobs(RefScheduler(ref, tiers=list(TIERS)),
                       _tier_jobs(weights[0].vocab), RefRequest,
                       RefSamplingParams, late_from=3)


def test_mixed_tier_engine_equals_single_tier_runs(weights, mixed_run):
    """One engine serves bf16, int8 and fp8 requests (greedy and seeded
    temperature rows) side by side: every request's tokens are, bit for
    bit, those of a single-tier engine at its tier."""
    jobs, got, sched = mixed_run
    for tier in TIERS:
        eng = _engine(weights, tier, max_len=32, n_slots=2)
        want = _serve_jobs(Scheduler(eng), [j for j in jobs if j[2] == tier],
                           Request, SamplingParams, tiered=False)
        for rid, tokens in want.items():
            assert got[rid] == tokens, (rid, tier)
    rep = sched.metrics.report()
    assert rep["tiers"] == {"bf16": 2, "int8": 2, "fp8": 2}
    assert rep["n_requests"] == 6
    assert set(rep["decode_dispatches_by_tier"]) == set(TIERS)
    json.dumps(rep, allow_nan=False)


def test_mixed_tier_greedy_rows_equal_reference_scheduler(weights, mixed_run,
                                                          ref_mixed_run):
    """The greedy rows equal the reference's meshless mixed-tier scheduler
    with ``PrecisionPolicy(kernel='pallas')``: bf16 and int8 from its
    jitted run, fp8 from its run op by op (under ``jit`` XLA keeps some
    bf16 intermediates in f32, which moves fp8 KV codes)."""
    jobs, got, _ = mixed_run
    greedy = [j for j in jobs if j[3] == 0.0]
    for rid, _, tier, _ in greedy:
        if tier != "fp8":
            assert got[rid] == ref_mixed_run[rid], (rid, tier)
    fp8 = [j for j in greedy if j[2] == "fp8"]
    assert fp8
    ref = _ref_engine(weights, "bf16", max_len=32, n_slots=2)
    with jax.disable_jit():
        eager = _serve_jobs(RefScheduler(ref, tiers=list(TIERS)), fp8,
                            RefRequest, RefSamplingParams)
    for rid, *_ in fp8:
        assert got[rid] == eager[rid], rid


def _ref_perturbed_scores(logits, keys, temp):
    """The reference's Gumbel-perturbed scores, [T, V]."""
    t = jnp.maximum(jnp.float32(temp), jnp.float32(1e-6))
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[1],),
                                                 jnp.float32))(keys)
    return np.asarray(noise + jnp.asarray(logits) / t)


def test_temperature_rows_equal_reference_where_decided(weights, mixed_run,
                                                       ref_mixed_run):
    """Teacher-forced on the reference's tokens of each bf16 / int8
    temperature row: the port's sampler, on the port's logits and the
    same keys, picks the reference's token at every step where the
    reference's perturbed top-2 gap exceeds 0.1."""
    jobs, _, _ = mixed_run
    n_decided = 0
    for rid, prompt, tier, temp in jobs:
        if temp == 0.0 or tier == "fp8":
            continue
        tokens = ref_mixed_run[rid]
        ref = _ref_engine(weights, tier, max_len=32, n_slots=2)
        port = _engine(weights, tier, max_len=32, n_slots=2)
        rpool, ppool = ref.new_pool(), port.new_pool()
        slot = rpool.alloc()
        assert ppool.alloc() == slot
        r_rows = [np.asarray(x, np.float32) for x in
                  ref.prefill_into_slots(rpool, [slot], [prompt])]
        p_rows = list(port.prefill_into_slots(ppool, [slot], [prompt]))
        feed = np.zeros((2,), np.int32)
        for tok in tokens[:-1]:
            feed[slot] = tok
            r_rows.append(np.asarray(ref.decode_slots_with_logits(
                rpool, feed), np.float32)[slot])
            p_rows.append(port.decode_slots_with_logits(ppool, feed)[slot])
            rpool.lengths[slot] += 1
            ppool.lengths[slot] += 1
        keys = batched_step_keys([TIER_SEED], [rid], [0], len(tokens))[0]
        scores = _ref_perturbed_scores(np.stack(r_rows), keys, temp)
        np.testing.assert_array_equal(scores.argmax(-1), tokens)
        ids = sample_rows(torch.stack(p_rows), keys,
                          np.full(len(tokens), temp, np.float32)).numpy()
        top2 = np.sort(scores, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > DECIDED_GAP
        np.testing.assert_array_equal(ids[decided],
                                      np.asarray(tokens)[decided])
        n_decided += int(decided.sum())
    assert n_decided >= 6


def _contended(eng, prompts, temp, max_new=24):
    """Two low-class requests fill both slots and decode; a high-class
    arrival then preempts one of them."""
    sp = SamplingParams(temperature=temp, max_new_tokens=max_new,
                        seed=TIER_SEED)
    s = Scheduler(eng)
    s.submit(Request(prompts[1], sp, id=1, priority=5))
    s.submit(Request(prompts[2], sp, id=2, priority=5))
    for _ in range(5):
        s.step()
    s.submit(Request(prompts[0], sp, id=0, priority=0))
    s.run(max_steps=500)
    return s


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "temp"])
def test_preempt_resume_equals_unpreempted_run(weights, temp):
    """A high-class arrival preempts a decoding request; the victim is
    requeued with prompt + generated[:-1], replays it without emitting,
    and ends with the tokens of an unpreempted run."""
    eng = _engine(weights, max_len=48, n_slots=2)
    prompts = _prompts(eng.cfg.vocab, (16, 12, 9), seed=0)
    base = Scheduler(eng)
    for i, p in enumerate(prompts):
        base.submit(Request(p, SamplingParams(
            temperature=temp, max_new_tokens=24, seed=TIER_SEED), id=i))
    base.run(max_steps=500)
    want = {r.id: list(r.output_tokens) for r in base.finished}
    s = _contended(eng, prompts, temp)
    assert sum(r.n_preemptions for r in s.finished) >= 1
    assert {r.id: list(r.output_tokens) for r in s.finished} == want
    victim = next(r for r in s.finished if r.n_preemptions > 0)
    assert victim.resume_prompt is None and victim.slot is None
    assert victim.finish_reason == "length"
    rep = s.metrics.report()
    assert rep["finish_reasons"]["preempted_resumed"] >= 1
    assert rep["preempt_reasons"] == {"priority": rep["preemptions"]}
    assert set(rep["queue_wait_p50_s"]) == {"0", "5"}


def test_victim_selection_lowest_class_least_generated(weights):
    """The victim is of the lowest class, then the least generated; an
    equal class never preempts."""
    eng = _engine(weights, max_len=48, n_slots=3, max_burst=1)
    prompts = _prompts(eng.cfg.vocab, (8, 8, 8, 8), seed=0)

    def sp(n):
        return SamplingParams(max_new_tokens=n)

    s = Scheduler(eng)
    s.submit(Request(prompts[0], sp(24), id=0, priority=1))
    s.step()
    s.step()
    s.submit(Request(prompts[1], sp(24), id=1, priority=5))
    s.submit(Request(prompts[2], sp(24), id=2, priority=5))
    for _ in range(6):
        s.step()
    gen = {r.id: r.n_generated for r in s.running.values()}
    assert set(gen) == {0, 1, 2}
    s.submit(Request(prompts[3], sp(4), id=3, priority=5))
    s.step()
    assert all(r.n_preemptions == 0 for r in s.running.values())
    assert len(s.waiting) == 1
    s.submit(Request(prompts[3], sp(4), id=4, priority=0))
    s.step()
    assert [r.id for r in s.waiting if r.n_preemptions > 0] == [2]
    assert gen[2] <= gen[1]
    s.run(max_steps=500)
    assert all(r.finish_reason == "length" for r in s.finished)


def test_mixed_tier_decode_cohorts_one_dispatch_per_tier(weights):
    """One dispatch per active tier cohort per round: 1 (bf16 alone) + 2 +
    2 (both) + 1 (int8 alone) = 6 for 6 decode token-steps, as the
    reference counts."""
    eng = _engine(weights, max_len=32, n_slots=2, max_burst=1)
    sched = Scheduler(eng, tiers=["bf16", "int8"])
    p = np.arange(1, 9, dtype=np.int32)
    for i, tier in enumerate(("bf16", "int8")):
        sched.submit(Request(prompt=p, id=i, kv_policy=tier,
                             sampling=SamplingParams(max_new_tokens=4)))
    sched.run(max_steps=100)
    assert sched.metrics.decode_token_steps == 6
    assert sched.n_decode_dispatches == 6
    assert sched.metrics.report()["decode_dispatches_by_tier"] == {
        "bf16": 3, "int8": 3}


def test_budget_derived_tier_pools_capacity_ratio():
    """From one cache budget per tier the int8 tier holds >= 1.9x the bf16
    slots at d_head 128 (codes 4 a word plus one f32 scale a position and
    head: 2 Dh / (Dh + 4)); the bytes counted on the meta device are the
    bytes the pool allocates."""
    pcfg = dataclasses.replace(port_config("granite-8b", smoke=True),
                               d_head=128)
    params = T.build_params(pcfg, C.QuantMaker(0, device="cpu"))
    eng = ServingEngine(pcfg, params, ServeConfig(
        max_len=32, prefill_chunk=8, cache_budget_bytes=1_000_000,
        device="cpu"))
    sched = Scheduler(eng, tiers=list(TIERS))
    slots = {t: p.n_slots for t, p in sched.pools.items()}
    assert slots["int8"] >= 1.9 * slots["bf16"], slots
    assert slots["fp8"] == slots["int8"]
    for tier, pool in sched.pools.items():
        assert pool.kv_dtype == tier
        per = bytes_per_slot(pcfg, 32, kv_dtype=tier, align=8)
        assert pool.cache_bytes == per * pool.n_slots
        assert pool.n_slots == 1_000_000 // per
    assert sched.pools["bf16"].bytes_per_token > \
        1.9 * sched.pools["int8"].bytes_per_token
