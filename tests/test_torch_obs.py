"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``), on the CPU at granite-smoke size.

* ``Tracer``, ``MetricsRegistry`` and ``SnapshotWriter`` fed one seeded
  call sequence write the reference's bytes.
* ``obs=None`` is a strict no-op: host syncs == decode dispatches + 2 x
  requests and clock calls == requests + tokens + steps, each equal to the
  reference scheduler's count on the same requests; the full bundle
  changes no token, sync, dispatch, step or burst count.
* Under one virtual clock (every call advances it 0.125 s) the port's
  Chrome trace, registry exposition, snapshot JSONL and profiler report
  are the reference's byte for byte, greedy with no EOS, in four cases:
  one tier with bursts; bf16 + int8 tiers; a paged pool with shared
  prefixes; a priority preemption.  With speculation the traces are equal
  event by event up to the first verify whose round's tokens part.
* ``step_cost`` FLOPs equal the reference's ``compiled_step_cost`` at
  k = 1 and 4 on the slab pool; its bytes equal a hand count.
* ``python -m repro_torch.launch.serve --trace ... --metrics-out ...``
  writes the trace, the exposition and the snapshots and reports
  ``model_measured``; ``ServingEngine.generate(obs=...)`` traces.
The reference's engine runs its default (XLA) kernels: without EOS the
schedule does not depend on token values, so the traces compare whatever
tokens come out; the spec case runs ``kernel='pallas'``, the kernels the
port reproduces, since acceptance reads tokens.
"""
import json
import pkgutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.obs as RO
import repro.serve as RS
import repro_torch
import repro_torch.obs as PO
import repro_torch.serve as PS
from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.quant.policy import PrecisionPolicy

MAX_LEN, N_SLOTS, CHUNK = 48, 4, 8
SNAPSHOT_EVERY_S = 1.0


@pytest.fixture(scope="module")
def weights():
    cfg = ref_config("granite-8b", smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = get_config("granite-8b", smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


class VirtualClock:
    """Every call advances the time by ``dt`` (tests/test_obs.py's)."""

    def __init__(self, dt=0.125):
        self.now = 0.0
        self.dt = dt
        self.calls = 0

    def __call__(self):
        self.calls += 1
        self.now += self.dt
        return self.now


class Side:
    """One implementation (the port or the reference) and its engines,
    one per configuration, built once for the module."""

    def __init__(self, name, weights):
        self.name, self.weights, self._engines = name, weights, {}
        self.S = RS if name == "ref" else PS
        self.O = RO if name == "ref" else PO

    def engine(self, kernel=None, **kw):
        key = (kernel, tuple(sorted(kw.items())))
        if key not in self._engines:
            cfg, params, pcfg, port = self.weights
            kw = dict(dict(max_len=MAX_LEN, n_slots=N_SLOTS,
                           prefill_chunk=CHUNK, max_burst=8), **kw)
            if self.name == "ref":
                policy = RefPolicy(kv="bf16", kernel=kernel or "auto")
                eng = RS.ServingEngine(cfg, params, RS.ServeConfig(
                    policy=policy, **kw))
            else:
                eng = PS.ServingEngine(pcfg, port, PS.ServeConfig(
                    policy=PrecisionPolicy(kv="bf16"), device="cpu", **kw))
            self._engines[key] = eng
        return self._engines[key]

    def bundle(self, path):
        """The full bundle, its snapshots written to ``path``."""
        reg = self.O.MetricsRegistry()
        return self.O.Observability(
            tracer=self.O.Tracer(), registry=reg,
            profiler=self.O.StepProfiler(self.engine().cfg),
            snapshots=self.O.SnapshotWriter(reg, str(path),
                                            every_s=SNAPSHOT_EVERY_S))


@pytest.fixture(scope="module")
def sides(weights):
    return {"port": Side("port", weights), "ref": Side("ref", weights)}


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# The four serving cases: (engine kwargs, scheduler kwargs, jobs), a job
# being (id, prompt, tier, priority, the step it arrives at)
# ---------------------------------------------------------------------------
def _case(name, vocab):
    if name == "bursts":
        prompts = _prompts(vocab, [9, 6, 11], seed=3)
        return {}, {}, [(i, p, None, 0, 0) for i, p in enumerate(prompts)]
    if name == "tiers":
        prompts = _prompts(vocab, [9, 6, 11, 8, 7], seed=5)
        tiers = ("bf16", "int8")
        return ({"n_slots": 2}, {"tiers": list(tiers)},
                [(i, p, tiers[i % 2], 0, 0 if i < 3 else 4)
                 for i, p in enumerate(prompts)])
    if name == "paged":
        rng = np.random.default_rng(11)
        prefix = rng.integers(1, vocab, (2 * CHUNK,)).astype(np.int32)
        tails = _prompts(vocab, [5, 3, 9, 0], seed=12)
        prompts = [np.concatenate([prefix, t]).astype(np.int32)
                   for t in tails]
        # the first request registers the prefix pages; the rest adopt them
        return ({"paged": True}, {},
                [(i, p, None, 0, 0 if i == 0 else 5)
                 for i, p in enumerate(prompts)])
    if name == "preempt":
        prompts = _prompts(vocab, [9, 6, 11], seed=7)
        # two low-class requests fill both slots; the class-0 arrival
        # preempts the one with the least output
        return ({"n_slots": 2}, {},
                [(0, prompts[0], None, 5, 0), (1, prompts[1], None, 5, 0),
                 (2, prompts[2], None, 0, 2)])
    raise ValueError(name)


CASES = ("bursts", "tiers", "paged", "preempt")


def _serve(side, case, obs=None, max_new=12, spec=None, temp=0.0,
           kernel=None):
    """Serve ``case``'s jobs on ``side`` under a fresh virtual clock:
    (scheduler, clock, requests by id)."""
    eng_kw, sched_kw, jobs = _case(case, side.weights[2].vocab)
    S = side.S
    clock = VirtualClock()
    sched = S.Scheduler(side.engine(kernel, **eng_kw), clock=clock, obs=obs,
                        spec=spec, **sched_kw)
    reqs, pending = {}, list(jobs)
    while pending or sched.has_work:
        for job in [j for j in pending if j[4] <= sched.n_steps]:
            rid, prompt, tier, prio, _ = job
            reqs[rid] = sched.submit(S.Request(
                prompt=prompt, id=rid, kv_policy=tier, priority=prio,
                sampling=S.SamplingParams(temperature=temp, seed=3,
                                          max_new_tokens=max_new)))
            pending.remove(job)
        assert sched.n_steps < 400
        sched.step()
    assert all(r.is_finished and r.n_generated == max_new
               for r in reqs.values())
    return sched, clock, reqs


def _outputs(obs, path):
    return {"trace": obs.tracer.to_json(),
            "exposition": obs.registry.expose(),
            "snapshots": Path(path).read_bytes(),
            "report": json.dumps(obs.profiler.report(), sort_keys=True,
                                 allow_nan=False)}


# ---------------------------------------------------------------------------
# Primitives fed one seeded call sequence
# ---------------------------------------------------------------------------
def _feed_primitives(O, rng_seed, path):
    """A seeded sequence of tracer / registry / snapshot calls."""
    rng = np.random.default_rng(rng_seed)
    tr = O.Tracer()
    reg = O.MetricsRegistry()
    snaps = O.SnapshotWriter(reg, str(path), every_s=0.5)
    tiers = ("bf16", "int8", "fp8")
    t = 0.0
    for _ in range(200):
        t += float(rng.integers(1, 9)) / 16
        op = int(rng.integers(0, 9))
        tier = tiers[int(rng.integers(0, 3))]
        tid = int(rng.integers(0, 5))
        if op == 0:
            tr.process_name(int(rng.integers(1, 3)), f"p{tid}")
        elif op == 1:
            tr.thread_name(2, tid, f"lane:{tier}")
        elif op == 2:
            tr.complete("decode_burst", t, t + float(rng.random()),
                        pid=2, tid=tid,
                        args={"tier": tier, "k": int(rng.integers(1, 9)),
                              "slots": sorted(rng.choice(8, 3, False)
                                              .tolist())})
        elif op == 3:
            tr.instant("first_token", t, pid=1, tid=tid,
                       args=None if tid % 2 else {"n": tid})
        elif op == 4:
            tr.counter("slots_used", t, {tier: int(rng.integers(0, 8))})
        elif op == 5:
            reg.counter("c_total", "a counter").inc(
                float(rng.integers(0, 4)), tier=tier)
        elif op == 6:
            reg.gauge("g", "a gauge").set(float(rng.random()) * 10,
                                          tier=tier)
        elif op == 7:
            reg.histogram("h_seconds", "a histogram").observe(
                float(rng.exponential(0.3)), tier=tier)
            reg.histogram("k", "K", buckets=(1, 2, 4, 8)).observe(
                int(rng.integers(1, 12)))
        else:
            snaps.maybe_write(t)
    snaps.write(t + 1.0)
    return tr.to_json(), reg.expose(), Path(path).read_bytes(), \
        json.dumps(reg.snapshot(), sort_keys=True)


@pytest.mark.parametrize("seed", range(4))
def test_primitives_write_the_reference_bytes(seed, tmp_path):
    got = _feed_primitives(PO, seed, tmp_path / "port.jsonl")
    want = _feed_primitives(RO, seed, tmp_path / "ref.jsonl")
    for name, g, w in zip(("trace", "exposition", "snapshots", "snapshot"),
                          got, want):
        assert g == w, name
    json.loads(got[0])


def test_registry_refuses_a_kind_change_and_counts_up():
    reg = PO.MetricsRegistry()
    c = reg.counter("n_total", "n")
    assert reg.counter("n_total") is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("n_total")
    with pytest.raises(AssertionError):
        c.inc(-1)


# ---------------------------------------------------------------------------
# obs=None is a strict no-op; the bundle changes nothing served
# ---------------------------------------------------------------------------
def test_disabled_obs_is_noop_and_enabled_changes_nothing(sides, tmp_path):
    counts = {}
    for name in ("port", "ref"):
        sched, clock, reqs = _serve(sides[name], "bursts")
        n_req = len(reqs)
        n_tok = sum(r.n_generated for r in reqs.values())
        assert sched.n_host_syncs == sched.n_decode_dispatches + 2 * n_req
        assert clock.calls == n_req + n_tok + sched.n_steps
        counts[name] = (sched.n_host_syncs, sched.n_decode_dispatches,
                        sched.n_steps, clock.calls,
                        dict(sched.metrics.burst_hist))
        if name == "port":
            base = sched, reqs
    assert counts["port"] == counts["ref"]
    assert any(k > 1 for k in counts["port"][4])
    obs = sides["port"].bundle(tmp_path / "snap.jsonl")
    full, _, reqs = _serve(sides["port"], "bursts", obs=obs)
    sched, base_reqs = base
    assert {i: r.output_tokens for i, r in reqs.items()} == \
        {i: r.output_tokens for i, r in base_reqs.items()}
    assert (full.n_host_syncs, full.n_decode_dispatches, full.n_steps,
            full.metrics.burst_hist) == \
        (sched.n_host_syncs, sched.n_decode_dispatches, sched.n_steps,
         sched.metrics.burst_hist)
    assert len(obs.tracer) > 0 and obs.profiler.n_records > 0
    assert obs.snapshots.n_written > 0


def test_disabled_obs_makes_no_obs_call(sides, monkeypatch):
    """With obs=None no tracer, registry or profiler method runs: every
    one of them raises here."""
    def boom(*a, **kw):
        raise AssertionError("an obs hook ran with obs=None")

    for cls in (PO.Tracer, PO.Counter, PO.Gauge, PO.Histogram,
                PO.StepProfiler, PO.SnapshotWriter):
        for attr in ("complete", "instant", "counter", "inc", "set",
                     "observe", "record_decode", "record_prefill",
                     "maybe_write"):
            if hasattr(cls, attr):
                monkeypatch.setattr(cls, attr, boom)
    for case in ("bursts", "preempt"):
        _serve(sides["port"], case)


# ---------------------------------------------------------------------------
# Byte for byte the reference's, under one virtual clock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_obs_outputs_equal_reference_byte_for_byte(sides, case, tmp_path):
    outs, scheds = {}, {}
    for name in ("port", "ref"):
        path = tmp_path / f"{name}.jsonl"
        obs = sides[name].bundle(path)
        scheds[name], clock, _ = _serve(sides[name], case, obs=obs)
        outs[name] = _outputs(obs, path)
        outs[name]["clock_calls"] = clock.calls
    for key in outs["ref"]:
        assert outs["port"][key] == outs["ref"][key], key
    port = scheds["port"]
    events = json.loads(outs["port"]["trace"])
    spans = {(e["tid"], e["name"]) for e in events
             if e["ph"] == "X" and e["pid"] == PO.PID_REQUESTS}
    for r in port.finished:
        for phase in ("WAITING", "PREFILL", "DECODE"):
            assert (r.id, phase) in spans
    bursts = [e for e in events if e["name"] == "decode_burst"]
    assert len(bursts) == port.n_decode_dispatches
    m = port.metrics
    reg = port.obs.registry
    assert reg.get("serve_host_syncs_total").value() == port.n_host_syncs
    assert reg.get("serve_scheduler_steps_total").value() == port.n_steps
    assert sum(reg.get("serve_decode_dispatches_total").values.values()) \
        == port.n_decode_dispatches
    chunks = [e for e in events if e["name"] == "prefill_chunk"]
    assert sum(reg.get("serve_prefill_chunks_total").values.values()) \
        == len(chunks)
    if case == "bursts":
        assert any(e["args"]["k"] > 1 for e in bursts)
    if case == "tiers":
        assert {e["args"]["tier"] for e in bursts} == {"bf16", "int8"}
    if case == "paged":
        assert m.prefix_hits > 0
        assert reg.get("serve_prefix_hits_total").value(tier="bf16") \
            == m.prefix_hits
        assert "serve_pages" in outs["port"]["exposition"]
    if case == "preempt":
        assert m.n_preemptions > 0
        assert any(e["name"] == "preempted" for e in events)
        assert reg.get("serve_preemptions_total").value(
            reason="priority", tier="bf16") == m.n_preemptions


TRACE_EVENT_KEYS = {
    "M": {"ph", "name", "pid", "tid", "args"},
    "X": {"ph", "name", "cat", "pid", "tid", "ts", "dur", "args"},
    "i": {"ph", "s", "name", "cat", "pid", "tid", "ts", "args"},
    "C": {"ph", "name", "cat", "pid", "tid", "ts", "args"},
}


def test_trace_schema_and_reports_are_json_clean(sides, tmp_path):
    obs = sides["port"].bundle(tmp_path / "s.jsonl")
    sched, _, _ = _serve(sides["port"], "tiers", obs=obs)
    for e in json.loads(obs.tracer.to_json()):
        allowed = TRACE_EVENT_KEYS[e["ph"]]
        assert set(e) <= allowed and set(e) >= allowed - {"args"}, e
    for rep in (obs.profiler.report(), obs.registry.snapshot(),
                sched.metrics.report()):
        assert json.loads(json.dumps(rep, allow_nan=False)) == rep
    lines = (tmp_path / "s.jsonl").read_text().splitlines()
    assert len(lines) == obs.snapshots.n_written > 1
    assert all(json.loads(s)["metrics"] for s in lines)


# ---------------------------------------------------------------------------
# Speculation: event by event up to the first parting round
# ---------------------------------------------------------------------------
def _spec_run(side, prompts, temp):
    eng = side.engine("pallas" if side.name == "ref" else None)
    obs = side.O.Observability(tracer=side.O.Tracer(),
                               registry=side.O.MetricsRegistry())
    sched = side.S.Scheduler(eng, clock=VirtualClock(), obs=obs,
                             spec=side.S.SpecConfig())
    rounds = []
    burst = sched.draft.draft_burst

    def draft_burst(tier, pool, rows, k, keys, temps):
        toks = np.asarray(burst(tier, pool, rows, k, keys, temps))
        rounds.append({"context": {r.id: list(r.output_tokens)
                                   for r, _ in rows},
                       "drafts": {r.id: [int(t) for t in toks[:, slot]]
                                  for r, slot in rows}})
        return toks

    sched.draft.draft_burst = draft_burst
    reqs = [sched.submit(side.S.Request(
        prompt=p, id=i, sampling=side.S.SamplingParams(
            temperature=temp, max_new_tokens=13, seed=13)))
        for i, p in enumerate(prompts)]
    sched.run(max_steps=600)
    out = {r.id: list(r.output_tokens) for r in reqs}
    return sched, json.loads(obs.tracer.to_json()), rounds, out


def _first_parting_round(port, ref):
    """The index of the first spec round whose context, drafts or emitted
    tokens part between the two runs (None: none does)."""
    (_, _, p_rounds, p_out), (_, _, r_rounds, r_out) = port, ref
    for i, (pr, rr) in enumerate(zip(p_rounds, r_rounds)):
        if pr != rr:
            return i
        s = len(next(iter(rr["drafts"].values()))) + 1
        for rid, ctx in rr["context"].items():
            n = len(ctx)
            if p_out[rid][n:n + s] != r_out[rid][n:n + s]:
                return i
    return None if len(p_rounds) == len(r_rounds) else \
        min(len(p_rounds), len(r_rounds))


def test_spec_trace_equals_reference_up_to_first_parting_round(sides):
    prompts = _prompts(sides["port"].weights[2].vocab, [9, 6, 11], seed=1)
    compared = 0
    for temp in (0.0, 0.8):
        port = _spec_run(sides["port"], prompts, temp)
        ref = _spec_run(sides["ref"], prompts, temp)
        p_events, r_events = port[1], ref[1]
        names = [e["name"] for e in p_events]
        assert "spec_draft" in names and "spec_verify" in names
        lanes = {e["args"]["name"] for e in p_events if e["ph"] == "M"}
        assert {"draft:bf16", "verify:bf16"} <= lanes
        parting = _first_parting_round(port, ref)
        if parting is None:
            assert p_events == r_events
            cut = len(r_events)
        else:
            verifies = [i for i, e in enumerate(r_events)
                        if e["name"] == "spec_verify"]
            cut = verifies[parting]
            assert p_events[:cut] == r_events[:cut], temp
        compared += sum(e["name"] == "spec_verify" for e in r_events[:cut])
        reg = port[0].obs.registry
        assert reg.get("serve_spec_rounds_total").value(tier="bf16") == \
            port[0].metrics.spec_rounds == names.count("spec_verify")
    assert compared > 0


# ---------------------------------------------------------------------------
# step_cost
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4])
def test_step_cost_flops_equal_compiled_step_cost(sides, k):
    """The port's count of a step's matrix products is the reference's
    HLO count exactly (every dot of its compiled decode step)."""
    ref_eng = sides["ref"].engine()
    want = RO.compiled_step_cost(ref_eng, ref_eng.new_pool(), k=k)
    port_eng = sides["port"].engine()
    got = PO.step_cost(port_eng, port_eng.new_pool(), k=k)
    assert got["flops"] == want["flops"]
    assert got["flops_per_token_step"] == want["flops_per_token_step"]
    for key in ("k", "n_slots", "kv_dtype", "paged", "collective_bytes"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_step_cost_bytes_equal_a_hand_count(sides, tier):
    cfg = sides["port"].weights[2]
    eng = sides["port"].engine()
    pool = eng.new_pool(kv_dtype=tier)
    d, hq, hk, dh, f, v, layers = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.d_ff, cfg.vocab,
                                   cfg.n_layers)
    group = 128                              # awq_int4's scale group

    def int4_leaf(k, n):                     # int32 words, f32 scales
        return k * n // 2 + -(-k // group) * n * 4

    layer = (int4_leaf(d, hq * dh) + 2 * int4_leaf(d, hk * dh)
             + int4_leaf(hq * dh, d) + 2 * int4_leaf(d, f)
             + int4_leaf(f, d) + 2 * d * 4)  # two f32 norms
    weights = layers * layer + d * 4 + d * v * 2     # final norm, lm_head
    # K and V a position a layer: bf16, or int8 codes + an f32 scale a head
    per_pos = layers * 2 * hk * (dh * 2 if tier == "bf16" else dh + 4)
    assert pool.bytes_per_token == per_pos
    n, ctx = N_SLOTS, pool.capacity
    step = (weights + n * d * 2 + n * ctx * per_pos + n * per_pos
            + 2 * n * v * 4)
    for k in (1, 8):
        cost = PO.step_cost(eng, pool, k=k)
        assert cost["hbm_bytes"] == k * step
        assert cost["context"] == ctx
    at = PO.step_cost(eng, pool, k=1, context=17)
    assert at["hbm_bytes"] == step - n * (ctx - 17) * per_pos
    assert at["flops"] == PO.step_cost(eng, pool)["flops"] \
        - n * 4 * layers * hq * dh * (ctx - 17)


def test_step_cost_refuses_moe():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)

    class Eng:
        pass

    eng = Eng()
    eng.cfg = cfg
    with pytest.raises(NotImplementedError, match="dense"):
        PO.step_cost(eng, None)


# ---------------------------------------------------------------------------
# Profiler pieces
# ---------------------------------------------------------------------------
def test_profiler_fallback_and_tier_pricing_equal_reference(weights):
    cfg, _, pcfg, _ = weights
    for scheme in (None, "bf16", "fp8"):
        got = PO.StepProfiler(pcfg, scheme=scheme)
        want = RO.StepProfiler(cfg, scheme=scheme)
        assert (got.scheme, got.scheme_fallback) == \
            (want.scheme, want.scheme_fallback)
        for rows, ctx, kvb in ((1, 1, 256), (4, 1024, 1024),
                               (4, 1024, 2048)):
            assert got._model_step_s(rows, ctx, kvb) == \
                want._model_step_s(rows, ctx, kvb)


# ---------------------------------------------------------------------------
# Entry points: generate(obs=...) and launch/serve.py's flags
# ---------------------------------------------------------------------------
def test_generate_threads_obs(sides):
    eng = sides["port"].engine()
    prompts = np.stack(_prompts(eng.cfg.vocab, [6, 6], seed=4))
    plain = eng.generate({"tokens": prompts}, max_new_tokens=5)
    obs = PO.Observability(tracer=PO.Tracer(), registry=PO.MetricsRegistry(),
                           profiler=PO.StepProfiler(eng.cfg))
    traced = eng.generate({"tokens": prompts}, max_new_tokens=5, obs=obs)
    assert np.array_equal(plain["generated"], traced["generated"])
    events = json.loads(obs.tracer.to_json())
    assert sum(e["name"] == "finished" for e in events) == 2
    assert obs.registry.get("serve_requests_finished_total").value(
        tier="bf16", reason="length") == 2
    assert obs.profiler.report()["per_tier"]["bf16"]["dispatches"] > 0


def test_serve_flags_write_trace_metrics_and_model_measured(tmp_path,
                                                            capsys):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    launch_serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "12", "--max-new", "6",
                       "--n-slots", "4", "--prefill-chunk", "8",
                       "--trace", str(trace), "--metrics-out", str(prom)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    events = json.load(open(trace))
    assert sum(e["name"] == "finished" for e in events) == 3
    text = prom.read_text()
    assert "# TYPE serve_burst_k histogram" in text
    assert 'serve_requests_finished_total{reason="length",tier="bf16"} 3' \
        in text
    snaps = (tmp_path / "m.prom.jsonl").read_text().splitlines()
    assert snaps and all(json.loads(s)["metrics"] for s in snaps)
    mm = report["model_measured"]
    assert mm["scheme"] == "awq_int4" and mm["per_tier"]["bf16"]
    assert report["trace_events"] == len(events)
    assert json.loads(json.dumps(report, allow_nan=False)) == report


def test_serve_without_flags_reports_no_model_measured(capsys):
    launch_serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--max-new", "3",
                       "--n-slots", "2", "--prefill-chunk", "8"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "model_measured" not in report


# ---------------------------------------------------------------------------
# The package stands alone
# ---------------------------------------------------------------------------
def test_obs_package_is_covered_by_the_import_checks():
    sys.path.insert(0, str(Path(__file__).parent))
    import test_torch_imports as TI
    files = {p.name for p in TI._port_files() if p.parent.name == "obs"}
    assert files == {"__init__.py", "trace.py", "registry.py",
                     "profiler.py"}
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.registry", "repro_torch.obs.profiler"} <= names
    for path in TI._port_files():
        if path.parent.name == "obs":
            assert not TI.FORBIDDEN.findall(path.read_text()), path
