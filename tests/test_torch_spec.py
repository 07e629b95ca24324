"""The port's speculative decoding against its plain decode and against the
JAX reference, on the CPU at granite-smoke size (slab pool; the paged
pool's runs are in ``tests/test_torch_spec_paged.py``, so that a run that
spreads files over workers runs the two halves side by side).

* Spec on equals spec off bit for bit, each side against itself: greedy,
  seeded temperature, EOS retiring at the same position, corrupt drafts
  (the same output and the same committed KV bytes), and a run in which
  whole rounds accept every draft.
* The port's ``Scheduler(spec=...)`` against the reference's on the same
  prompts: tokens equal, or parting first where the reference's top-2 gap
  (teacher-forced) is at most 0.1; the per-round log (K, rows, drafted,
  accepted, emitted, catch-up dispatches) equal to the reference's for
  every round before a token parts.  A round's tokens are its drafts as
  well as what it emits; a draft that parts is held to the same rule on
  the reference's draft engine (int8 KV).
* A killed or a poisoned verify recovers: the fault injector's
  ``(kind, seq)`` log is the reference's and the output the fault-free
  run's.
* ``SpecPlanner``, ``accept_longest_prefix``, ``spec_round_latency`` (rel
  1e-12) and the SLO drain estimate under speculation (rel 1e-12) equal
  the reference's; ``SpecConfig`` refuses what the reference refuses, with
  its messages; the policy's JSON is the reference's; ``launch/serve.py``'s
  ``--spec*`` flags build the reference's ``SpecConfig``.
* The draft twin holds the target's parameter tensors (same storage) and
  is cached per draft policy.
The card's run of the same contract is ``tests/test_torch_spec_card.py``.
No test here uses hypothesis; each draws from its own seeded generator.
"""
import argparse
import dataclasses
import importlib.util
import itertools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as RS
from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.perfmodel.analytical import \
    spec_round_latency as ref_spec_round_latency
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve.spec import accept_longest_prefix as ref_accept
import repro_torch.serve as PS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.serve import add_spec_args, build_spec
from repro_torch.perfmodel.analytical import spec_round_latency
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve.spec import DraftEngine, accept_longest_prefix
from repro_torch.serve.sampling import batched_step_keys
from test_torch_slo import Hook

DECIDED_GAP = 0.1
MAX_LEN, N_SLOTS, CHUNK = 48, 4, 8
SEED = 13                    # the requests' sampling seed
STATS = ("k", "rows", "drafted", "accepted", "emitted", "catchup_dispatches")


@pytest.fixture(scope="module")
def weights():
    cfg = ref_config("granite-8b", smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = get_config("granite-8b", smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


class Side:
    """One implementation's serving module and its engine per pool kind
    (an engine carries no state between schedulers but its draft twins
    and its fault counter, so one compiles once for every test)."""

    def __init__(self, name, weights):
        self.name, self.weights, self._engines = name, weights, {}
        self.M = RS if name == "ref" else PS
        self.clean_runs = {}            # the fault tests' fault-free runs

    def engine(self, paged=False):
        """(engine, its fault Hook, quiet until armed): max_len 48, 4
        slots, chunk 8, bursts of up to 8, bf16 KV, 2 fault retries."""
        if paged not in self._engines:
            cfg, params, pcfg, port = self.weights
            hook = Hook()
            kw = dict(max_len=MAX_LEN, n_slots=N_SLOTS, prefill_chunk=CHUNK,
                      max_burst=8, paged=paged, fault_injector=hook,
                      max_fault_retries=2)
            if self.name == "ref":
                eng = RS.ServingEngine(cfg, params, RS.ServeConfig(
                    policy=RefPolicy(kv="bf16", kernel="pallas"), **kw))
            else:
                eng = PS.ServingEngine(pcfg, port, PS.ServeConfig(
                    policy=PrecisionPolicy(kv="bf16"), device="cpu", **kw))
            self._engines[paged] = (eng, hook)
        return self._engines[paged]


@pytest.fixture(scope="module")
def sides(weights):
    return {"port": Side("port", weights), "ref": Side("ref", weights)}


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _serve(side, eng, prompts, spec=None, temp=0.0, max_new=17, eos=-1):
    """Serve ``prompts`` (ids 0..) through a fresh scheduler: ({id: tokens},
    rounds, scheduler).  Each spec round records the requests' tokens at
    its draft (``context``), its drafts and the stats it reported."""
    M = side.M
    s = M.Scheduler(eng, spec=spec)
    rounds = []
    if spec is not None:
        burst, on_round = s.draft.draft_burst, s.metrics.on_spec_round

        def draft_burst(tier, pool, rows, k, keys, temps):
            toks = np.asarray(burst(tier, pool, rows, k, keys, temps))
            rounds.append({
                "context": {r.id: list(r.output_tokens) for r, _ in rows},
                "drafts": {r.id: [int(t) for t in toks[:, slot]]
                           for r, slot in rows}})
            return toks

        def spec_round(**kw):
            rounds[-1].update(kw)
            on_round(**kw)

        s.draft.draft_burst = draft_burst
        s.metrics.on_spec_round = spec_round
    reqs = [s.submit(M.Request(prompt=p, id=i, sampling=M.SamplingParams(
        temperature=temp, max_new_tokens=max_new, eos_id=eos, seed=SEED)))
        for i, p in enumerate(prompts)]
    s.run(max_steps=600)
    assert all(r.is_finished for r in reqs)
    return {r.id: list(r.output_tokens) for r in reqs}, rounds, s


def _check_accounting(s):
    """The reference's identities of the spec accounting."""
    m = s.metrics
    assert m.spec_rounds > 0
    assert m.spec_tokens_drafted == (m.spec_tokens_accepted
                                     + m.spec_tokens_rejected)
    assert m.spec_tokens_emitted == (m.spec_tokens_accepted
                                     + m.spec_bonus_tokens)
    assert 0 < m.spec_bonus_tokens <= m.spec_rounds * N_SLOTS
    assert m.total_new_tokens == (len(m.ttft) + m.decode_tokens_emitted
                                  + m.spec_tokens_emitted)
    assert sum(k * v for k, v in m.spec_accept_hist.items()) \
        == m.spec_tokens_accepted
    rep = m.report()
    assert json.loads(json.dumps(rep, allow_nan=False)) == rep
    spec = rep["spec"]
    assert spec["rounds"] == spec["draft_dispatches"] \
        == spec["verify_dispatches"] == m.spec_rounds
    assert rep["dispatches_per_token"] > 0


# ---------------------------------------------------------------------------
# (a) Spec on equals spec off, bit for bit (the port against itself)
# ---------------------------------------------------------------------------
def _spec_equals_plain(weights, sides, paged, temp, lens=(9, 6, 11, 14),
                       max_new=17):
    """Returns the spec run's rounds and scheduler."""
    side = sides["port"]
    eng, _ = side.engine(paged)
    prompts = _prompts(weights[2].vocab, lens, seed=1)
    plain, _, _ = _serve(side, eng, prompts, temp=temp, max_new=max_new)
    got, rounds, s = _serve(side, eng, prompts, PS.SpecConfig(), temp=temp,
                            max_new=max_new)
    assert got == plain
    assert s.metrics.spec_tokens_accepted > 0
    _check_accounting(s)
    # one verify dispatch a spec round, one draft burst before it
    assert len(rounds) == s.metrics.spec_rounds
    if paged:
        s.pool.allocator.check()
        assert s.pool.pages_in_use == 0
    return rounds, s


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "temperature"])
def test_spec_equals_plain_decode_slab(weights, sides, temp):
    _spec_equals_plain(weights, sides, False, temp)


def test_fully_accepted_rounds_keep_the_draft_in_step(weights, sides):
    """A round that accepts every draft emits K+1 tokens while the draft
    wrote K positions; the next round's catch-up replays the missing one.
    The run has such rounds followed by further spec rounds, and its
    output is still the plain decode's."""
    rounds, _ = _spec_equals_plain(weights, sides, False, 0.8, lens=(9, 6),
                                   max_new=13)
    full = [i for i, r in enumerate(rounds)
            if r["accepted"] == r["drafted"]]
    assert any(i + 1 < len(rounds) for i in full), rounds
    for i in full:
        if i + 1 < len(rounds):
            # every row of the full round that drafts again catches up
            again = set(rounds[i]["drafts"]) & set(rounds[i + 1]["drafts"])
            assert rounds[i + 1]["catchup_dispatches"] >= len(again)


def test_spec_eos_retires_at_the_plain_position(weights, sides):
    side = sides["port"]
    eng, _ = side.engine()
    prompts = _prompts(weights[2].vocab, [8], seed=5)
    probe, _, _ = _serve(side, eng, prompts, max_new=16)
    seq = probe[0]
    i = next(j for j in range(2, len(seq)) if seq[j] not in seq[:j])
    plain, _, s0 = _serve(side, eng, prompts, max_new=16, eos=seq[i])
    got, _, s = _serve(side, eng, prompts, PS.SpecConfig(), max_new=16,
                       eos=seq[i])
    assert got == plain and len(got[0]) == i + 1
    assert s.finished[0].finish_reason == s0.finished[0].finish_reason \
        == "eos"
    assert s.metrics.spec_rounds > 0
    assert s.pool.n_free == s.pool.n_slots


def _committed_kv(pool, slot, length):
    out = []
    for slab in pool.cache:
        leaves = [slab.packed, slab.scales] if hasattr(slab, "packed") \
            else [slab]
        out.extend(a[:, slot, :length].clone() for a in leaves)
    return out


def test_corrupt_drafts_same_output_and_committed_kv(weights, sides):
    """Every draft garbled: every round rejects all, emits the verify's
    own first sample and commits one position; the output and the
    committed target KV are the plain run's, byte for byte."""
    side = sides["port"]
    eng, _ = side.engine()
    prompts = _prompts(weights[2].vocab, [8], seed=6)
    plain, _, s0 = _serve(side, eng, prompts, max_new=9)
    kv0 = _committed_kv(s0.pool, 0, len(prompts[0]) + len(plain[0]) - 1)
    spec = PS.SpecConfig(corrupt_drafts=True, cooldown_rounds=1,
                         max_collapses=100)
    got, _, s = _serve(side, eng, prompts, spec, max_new=9)
    assert got == plain
    m = s.metrics
    assert m.spec_rounds > 0 and m.spec_tokens_accepted == 0
    assert m.spec_tokens_rejected == m.spec_tokens_drafted
    for a, b in zip(kv0, _committed_kv(s.pool, 0, kv0[0].shape[1])):
        assert torch.equal(a, b)


def test_collapse_falls_back_to_plain_bursts(weights, sides):
    """Corrupt drafts at K = 4: the planner halves K to 1, collapses,
    cools down, probes, and after ``max_collapses`` stays off at a
    bounded number of rounds; plain bursts resume and the output is the
    plain run's."""
    side = sides["port"]
    eng, _ = side.engine()
    prompts = _prompts(weights[2].vocab, [8], seed=7)
    spec = PS.SpecConfig(k_init=4, k_max=4, corrupt_drafts=True,
                         cooldown_rounds=2, cooldown_backoff=2,
                         max_collapses=2)
    plain, _, _ = _serve(side, eng, prompts, max_new=30)
    got, rounds, s = _serve(side, eng, prompts, spec, max_new=30)
    assert got == plain
    snap = s.spec_planner.snapshot()
    assert snap["off"] and snap["collapses"] == 2
    assert len(rounds) == s.metrics.spec_rounds \
        <= spec.k_init.bit_length() + spec.max_collapses - 1
    assert [r["k"] for r in rounds[:3]] == [4, 2, 1]
    assert any(k > 1 for k in s.metrics.burst_hist)


# ---------------------------------------------------------------------------
# (b) The port's scheduler against the reference's
# ---------------------------------------------------------------------------
def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _gap(ref_side, kv, prompt, tokens, step, temp, rid):
    """The reference's top-2 gap (Gumbel-perturbed for a temperature row)
    for token ``step`` of request ``rid``, teacher-forced on ``tokens``
    through a fresh pool of its slab engine at KV tier ``kv``."""
    eng, _ = ref_side.engine()
    pool = eng.new_pool(kv_dtype=kv)
    slot = pool.alloc()
    logits = np.asarray(eng.prefill_into_slots(
        pool, [slot], [np.asarray(prompt, np.int32)])[0], np.float32)
    feed = np.zeros((pool.n_slots,), np.int32)
    for tok in tokens[:step]:
        feed[slot] = tok
        logits = np.asarray(eng.decode_slots_with_logits(pool, feed),
                            np.float32)[slot]
        pool.lengths[slot] += 1
    if temp > 0:
        key = batched_step_keys([SEED], [rid], [step], 1)[0, 0]
        noise = jax.random.gumbel(jnp.asarray(key), (logits.shape[0],),
                                  jnp.float32)
        t = jnp.maximum(jnp.float32(temp), jnp.float32(1e-6))
        logits = np.asarray(noise + jnp.asarray(logits) / t)
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _hold_to_reference(ref_side, prompts, temp, port, ref):
    """Tokens under the serving contract, then the per-round logs up to
    the first round a token of which parts.  Returns the rounds
    compared."""
    (p_out, p_rounds), (r_out, r_rounds) = port, ref
    parted = {}
    for rid, r_toks in r_out.items():
        p_toks = p_out[rid]
        parted[rid] = len(r_toks)
        if p_toks == r_toks:
            continue
        j = _first_difference(p_toks, r_toks)
        assert j is not None, (rid, "token counts differ")
        gap = _gap(ref_side, "bf16", prompts[rid], r_toks, j, temp, rid)
        assert gap <= DECIDED_GAP, (rid, j, gap)
        parted[rid] = j
    compared = 0
    for pr, rr in zip(p_rounds, r_rounds):
        if pr["context"] != rr["context"]:
            break
        s = len(rr["drafts"][next(iter(rr["drafts"]))]) + 1
        if any(len(ctx) + s > parted[rid]
               for rid, ctx in rr["context"].items()):
            break
        if pr["drafts"] != rr["drafts"]:
            rid = next(i for i in rr["drafts"]
                       if pr["drafts"][i] != rr["drafts"][i])
            j = _first_difference(pr["drafts"][rid], rr["drafts"][rid])
            ctx = rr["context"][rid]
            gap = _gap(ref_side, "int8", prompts[rid],
                       ctx + rr["drafts"][rid], len(ctx) + j, temp, rid)
            assert gap <= DECIDED_GAP, (rid, len(ctx) + j, gap)
            break
        assert {k: pr.get(k) for k in STATS} \
            == {k: rr.get(k) for k in STATS}, (compared, pr, rr)
        compared += 1
    else:
        if all(p_out[i] == r_out[i] for i in r_out):
            assert len(p_rounds) == len(r_rounds)
    return compared


def _spec_matches_reference(weights, sides, paged):
    prompts = _prompts(weights[2].vocab, [9, 6, 11], seed=1)
    compared = 0
    for temp in (0.0, 0.8):
        runs = []
        for name in ("port", "ref"):
            side = sides[name]
            eng, _ = side.engine(paged)
            out, rounds, s = _serve(side, eng, prompts, side.M.SpecConfig(),
                                    temp=temp, max_new=13)
            assert s.metrics.spec_rounds > 0
            runs.append((out, rounds))
        compared += _hold_to_reference(sides["ref"], prompts, temp, *runs)
    assert compared > 0


def test_scheduler_matches_reference_slab(weights, sides):
    _spec_matches_reference(weights, sides, False)


# ---------------------------------------------------------------------------
# (e) A killed or a poisoned verify recovers
# ---------------------------------------------------------------------------
def _verify_fault_recovers(weights, sides, paged, mode):
    """The first verify after arming is killed ('injected') or poisoned
    ('nan'): its rows are requeued with the lengths uncommitted, resume,
    and emit the fault-free run's tokens; the injector's log is the
    reference's."""
    prompts = _prompts(weights[2].vocab, [9, 6, 11], seed=3)
    logs = {}
    for name in ("port", "ref"):
        side = sides[name]
        eng, hook = side.engine(paged)
        if paged not in side.clean_runs:
            side.clean_runs[paged] = _serve(
                side, eng, prompts, side.M.SpecConfig(), temp=0.8,
                max_new=13)[0]
        clean = side.clean_runs[paged]
        fired = []

        def fault(kind, seq, fired=fired):
            if kind == "verify" and not fired:
                fired.append(seq)
                return mode
            return None

        hook.arm(fault)
        got, _, s = _serve(side, eng, prompts, side.M.SpecConfig(),
                           temp=0.8, max_new=13)
        logs[name] = list(hook.log)
        hook.arm(None)
        assert fired and got == clean
        assert s.metrics.fault_kinds == {mode: 1}
        assert s.metrics.preempt_reasons.get("fault", 0) >= 1
    assert logs["port"] == logs["ref"]


@pytest.mark.parametrize("mode", ["injected", "nan"])
def test_verify_fault_recovers_like_reference_slab(weights, sides, mode):
    _verify_fault_recovers(weights, sides, False, mode)


# ---------------------------------------------------------------------------
# (f) The draft twin
# ---------------------------------------------------------------------------
def test_draft_twin_shares_the_target_tensors(weights, sides):
    eng, _ = sides["port"].engine()
    a = DraftEngine(eng, PS.SpecConfig())
    b = DraftEngine(eng, PS.SpecConfig(corrupt_drafts=True))
    c = DraftEngine(eng, PS.SpecConfig(draft_kv="fp8"))
    assert a.engine is b.engine and c.engine is not a.engine
    assert a.pools is not b.pools
    assert a.engine.policy == dataclasses.replace(eng.policy, kv="int8")
    assert set(eng.draft_engines) == {a.engine.policy.to_json(),
                                      c.engine.policy.to_json()}
    scfg = a.engine.scfg
    assert not scfg.paged and scfg.cache_budget_bytes is None \
        and scfg.fault_injector is None
    for twin in (a.engine, c.engine):
        assert twin.params is eng.params
        mine = dict(twin.params.state_dict(keep_vars=True))
        theirs = dict(eng.params.state_dict(keep_vars=True))
        assert mine.keys() == theirs.keys() and mine
        for name, t in theirs.items():
            assert mine[name].data_ptr() == t.data_ptr(), name


# ---------------------------------------------------------------------------
# (c) The planner and the acceptance rule, exactly the reference's
# ---------------------------------------------------------------------------
PLANNER_CONFIGS = [
    dict(),
    dict(k_init=4, k_max=8, cooldown_rounds=2, cooldown_backoff=2,
         max_collapses=2),
    dict(k_init=1, k_max=4, accept_floor=0.4, accept_raise=0.6,
         ema_alpha=0.3, max_cooldown_rounds=5),
    dict(k_init=2, k_max=2, accept_floor=0.0, accept_raise=1.0)]


@pytest.mark.parametrize("i", range(len(PLANNER_CONFIGS)))
def test_planner_equals_reference(i):
    rng = np.random.default_rng(100 + i)
    kw = PLANNER_CONFIGS[i]
    mine, theirs = (PS.SpecPlanner(PS.SpecConfig(**kw)),
                    RS.SpecPlanner(RS.SpecConfig(**kw)))
    for _ in range(400):
        rows = []
        for slot in range(int(rng.integers(1, 5))):
            req = SimpleNamespace(
                sampling=SimpleNamespace(
                    max_new_tokens=int(rng.integers(1, 40))),
                n_generated=int(rng.integers(0, 8)))
            rows.append((req, slot))
        pool = SimpleNamespace(max_len=64,
                               lengths=rng.integers(0, 64, (4,)))
        k = mine.plan(rows, pool)
        assert k == theirs.plan(rows, pool)
        if k:
            drafted = k * len(rows)
            bias = rng.random()
            accepted = int(rng.binomial(drafted, bias))
            mine.observe(drafted, accepted)
            theirs.observe(drafted, accepted)
        assert mine.snapshot() == theirs.snapshot()
        assert (mine.k, mine.ema, mine.cooldown, mine.off, mine.active) \
            == (theirs.k, theirs.ema, theirs.cooldown, theirs.off,
                theirs.active)
        assert mine.expected_tokens_per_round() \
            == theirs.expected_tokens_per_round()


def test_accept_longest_prefix_equals_reference():
    rng = np.random.default_rng(21)
    for _ in range(3000):
        k = int(rng.integers(1, 9))
        draft = rng.integers(0, 4, (k,))
        verified = rng.integers(0, 4, (k + 1,))
        cut = int(rng.integers(0, k + 1))
        verified[:cut] = draft[:cut]
        eos = int(rng.integers(-1, 4))
        rem = int(rng.integers(1, k + 3))
        assert accept_longest_prefix(draft, verified, eos, rem) \
            == ref_accept(draft, verified, eos, rem)


# ---------------------------------------------------------------------------
# (d) SpecConfig validation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(k_init=0), dict(k_max=0), dict(k_init=4, k_max=2),
    dict(accept_floor=0.9, accept_raise=0.5), dict(accept_raise=1.5),
    dict(accept_floor=-0.1), dict(draft_kv="int4"), dict(draft_kv="fp16")])
def test_spec_config_validation_equals_reference(kw):
    with pytest.raises(ValueError) as mine:
        PS.SpecConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        RS.SpecConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_spec_config_defaults_equal_reference():
    mine, theirs = PS.SpecConfig(), RS.SpecConfig()
    assert [f.name for f in dataclasses.fields(mine)] \
        == [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


# ---------------------------------------------------------------------------
# Prices, the SLO estimate, the policy's JSON and the launch flags
# ---------------------------------------------------------------------------
SCHEME_PAIRS = [("awq_int4", "w8a8"), ("mxfp4", "fp8"), ("fp8", "awq_int4"),
                ("w8a8", "mxfp4")]


@pytest.mark.parametrize("draft_scheme,target_scheme", SCHEME_PAIRS)
def test_spec_round_latency_equals_reference(draft_scheme, target_scheme):
    """granite-8b FULL's geometry (no weights: the model is analytic)."""
    cfg, rcfg = get_config("granite-8b"), ref_config("granite-8b")
    grid = itertools.product((1, 2, 4, 8), (1, 8, 23), (1, 512, 4096),
                             (0.0, 0.3, 0.7, 0.95),
                             (None, 73728.0), (True, False),
                             ("xtramac", "vendor"))
    n = 0
    for k, b, ctx, a, kvb, engine_model, design in grid:
        if engine_model and design == "vendor":
            continue
        kw = dict(k=k, batch=b, context=ctx, acceptance=a, design=design,
                  draft_scheme=draft_scheme, target_scheme=target_scheme,
                  kv_bytes_per_token=kvb,
                  draft_kv_bytes_per_token=None if kvb is None else kvb / 2,
                  use_engine_model=engine_model)
        mine, theirs = spec_round_latency(cfg, **kw), \
            ref_spec_round_latency(rcfg, **kw)
        assert mine.keys() == theirs.keys()
        for key, v in theirs.items():
            if isinstance(v, str):
                assert mine[key] == v, (kw, key)
            else:
                np.testing.assert_allclose(mine[key], v, rtol=1e-12, atol=0,
                                           err_msg=f"{kw} {key}")
        n += 1
    assert n == 4 * 3 * 3 * 4 * 2 * 3


def test_slo_estimate_under_speculation_equals_reference(weights, sides):
    """After every step of a spec run, while the two schedulers hold the
    same state (each request's tokens and length, the planner's
    snapshot), the drain estimate is the reference's; the planner is
    active and the draft pool built at some of those steps."""
    prompts = _prompts(weights[2].vocab, [9, 6, 11], seed=4)
    scheds = {}
    for name in ("port", "ref"):
        side = sides[name]
        eng, _ = side.engine()
        s = side.M.Scheduler(eng, spec=side.M.SpecConfig(),
                             slo=side.M.SLOPolicy())
        for i, p in enumerate(prompts):
            s.submit(side.M.Request(prompt=p, id=i, sampling=side.M.
                                    SamplingParams(temperature=0.8,
                                                   max_new_tokens=17,
                                                   seed=SEED)))
        scheds[name] = (s, [])
    spec_steps = 0
    while any(s.has_work for s, _ in scheds.values()):
        state = []
        for s, ests in scheds.values():
            s.step()
            ests.append(s.slo.estimate_queue_delay_s(s))
            state.append((
                sorted((r.id, list(r.output_tokens), int(s.pool.lengths[
                    r.slot])) for r in s.running.values()),
                s.spec_planner.snapshot()))
        if state[0] != state[1]:
            break
        np.testing.assert_allclose(scheds["port"][1][-1],
                                   scheds["ref"][1][-1], rtol=1e-12, atol=0)
        s = scheds["port"][0]
        spec_steps += bool(s.spec_planner.active and s.running
                           and "bf16" in s.draft.pools)
    assert spec_steps > 0


@pytest.mark.parametrize("weights_, kv", [
    ((), "bf16"), ((("attn.*", "fp8"), ("ffn.*", "mxfp4")), "int8"),
    ((("attn.wq", "awq_int4"),), "fp8")])
def test_policy_json_equals_reference(weights_, kv):
    mine = PrecisionPolicy(weights=weights_, kv=kv)
    theirs = RefPolicy(weights=weights_, kv=kv)
    assert mine.to_json() == theirs.to_json()
    assert mine.to_dict() == theirs.to_dict()
    assert PrecisionPolicy.from_json(mine.to_json()) == mine
    assert PrecisionPolicy.from_json(mine.to_json(indent=2)) == mine
    # the reference's file, whatever its kernel route, reads as the same
    for kernel in ("auto", "jnp", "pallas"):
        ref_json = RefPolicy(weights=weights_, kv=kv, kernel=kernel).to_json()
        assert PrecisionPolicy.from_json(ref_json) == mine


@pytest.mark.parametrize("bad", [{"kv": "bf16", "kernal": "auto"},
                                 {"kernel": "triton"}, {"kv": "int4"}])
def test_policy_from_dict_refuses_what_reference_refuses(bad):
    with pytest.raises(ValueError) as mine:
        PrecisionPolicy.from_dict(bad)
    with pytest.raises(ValueError) as theirs:
        RefPolicy.from_dict(bad)
    assert str(mine.value) == str(theirs.value)


def _reference_bench():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "serve_bench.py"
    spec = importlib.util.spec_from_file_location("ref_serve_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [], ["--spec"], ["--spec", "--spec-k", "2"],
    ["--spec", "--spec-k", "8", "--spec-draft-kv", "fp8", "--spec-corrupt"],
    ["--spec", "--spec-draft-kv", "bf16"], ["--spec", "--spec-draft-kv",
                                            "{policy}"]])
def test_spec_flags_build_the_reference_config(argv, tmp_path):
    path = tmp_path / "draft_policy.json"
    path.write_text(PrecisionPolicy(weights=(("ffn.*", "mxfp4"),),
                                    kv="fp8").to_json())
    argv = [str(path) if a == "{policy}" else a for a in argv]
    ap = argparse.ArgumentParser()
    add_spec_args(ap)
    args = ap.parse_args(argv)
    mine = build_spec(args)
    theirs = _reference_bench().build_spec(argparse.Namespace(
        spec=args.spec, draft_policy=args.spec_draft_kv, spec_k=args.spec_k,
        spec_corrupt=args.spec_corrupt))
    assert (mine is None) == (theirs is None) == (not args.spec)
    if mine is None:
        return
    for f in dataclasses.fields(theirs):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name == "draft_policy":
            assert (a is None) == (b is None)
            assert a is None or a.to_json() == b.to_json()
        else:
            assert a == b, f.name
