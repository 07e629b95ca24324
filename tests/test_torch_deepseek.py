"""The port serving deepseek-v2-smoke (MLA, 8 routed experts top-2 and 2
shared, fp8) on the CPU through the kernels' plain versions, against the
JAX reference's meshless engine (its Pallas kernels in interpret mode):

* teacher-forced logits of prefill chunks and absorbed decode steps within
  5e-2 of the reference engine's, greedy ids equal wherever the reference's
  top-2 gap exceeds 0.1 (the serving contract), on the reference's expert
  ids;
* the scheduler: staggered admission and bursts, every request equal to
  itself served alone bit for bit; a request preempted by a high-class
  arrival and resumed equals its unpreempted run;
* ``Routes`` records and replays the MoE layers' ids through the MLA
  model;
* the one-shot entry point ``launch/serve.py --arch deepseek-v2-236b --smoke
  --device cpu``.
"""
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import common as RC
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro.serve.kv_pool import KVCachePool as RefKVCachePool
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as serve_main
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine)

ARCH = "deepseek-v2-236b"
TOL = 5e-2
DECIDED_GAP = 0.1


@functools.lru_cache(maxsize=None)
def _smoke():
    cfg = get_config(ARCH, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    pcfg = port_config(ARCH, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, pcfg, port


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _engine(**kw):
    _, _, pcfg, port = _smoke()
    kw.setdefault("max_len", 48)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pcfg, port, ServeConfig(device="cpu", **kw))


def _loop_vmap(fn, *a, **k):
    """``jax.vmap`` as a loop over the mapped axis, so that each routing
    group's ids reach the host callback on their own, in order; the same
    function."""
    def mapped(*args):
        outs = [fn(*(x[i] for x in args)) for i in range(len(args[0]))]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return mapped


@pytest.fixture
def reference_routes(monkeypatch):
    """Records the reference's expert ids (each routing group's [S, k], in
    the order the reference runs them) and makes the port's ``route``
    take them in call order: a call of B rows takes the next B groups."""
    recorded = []
    route = RM._route

    def recording_route(x, router_w, cfg):
        gates, idx, probs = route(x, router_w, cfg)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), idx,
                           ordered=True)
        return gates, idx, probs

    monkeypatch.setattr(RM, "_route", recording_route)
    monkeypatch.setattr(RM, "jax", types.SimpleNamespace(
        vmap=_loop_vmap, nn=jax.nn, lax=jax.lax))
    port_route = M.route
    taken = [0]

    def replaying(x, router, cfg, *, plain=False, routes=None):
        b, n = x.shape[0], taken[0]
        assert n + b <= len(recorded)
        ids = torch.from_numpy(np.stack(recorded[n:n + b])).long()
        taken[0] += b
        return port_route(x, router, cfg, plain=plain,
                          routes=M.Routes([ids]))

    monkeypatch.setattr(M, "route", replaying)
    return recorded, taken


def test_teacher_forced_logits_match_reference_engine(reference_routes):
    """Prefill (two chunks for an 11-token prompt: the second expands K /
    V over the first's latents) and 4 absorbed decode steps of 3 slots at
    unequal lengths, teacher-forced on the reference's greedy ids, with
    the port taking the reference's expert ids: with bf16 router logits,
    8 experts and random weights the k-th and (k+1)-th logits tie exactly
    (gap 0) at some tokens, and a one-ulp difference between the two
    frameworks' hidden states flips such a tie (``test_torch_mla`` holds
    the routing to the reference's on one input, ties included)."""
    cfg, params, _, _ = _smoke()
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=32, n_slots=4, prefill_chunk=8,
        policy=RefPolicy(kernel="pallas")))
    port = _engine(max_len=32)
    prompts = _prompts(cfg.vocab, (11, 8, 5), seed=5)
    # the reference's ``new_pool`` hands MLA's cache spec the tier's name,
    # which ``mla_cache_spec`` does not take: its pool is built here with
    # the dtype itself (the same slab pool ``new_pool`` would build)
    rpool = RefKVCachePool(cfg, 4, 32, kv_dtype=jnp.bfloat16, align=8)
    ppool = port.new_pool()
    assert ppool.cache[0].shape == (2, 4, 32, 32)       # the latent slabs
    slots = [rpool.alloc() for _ in prompts]
    assert slots == [ppool.alloc() for _ in prompts]
    want = [np.asarray(x, np.float32)
            for x in ref.prefill_into_slots(rpool, slots, prompts)]
    got = [x.numpy() for x in port.prefill_into_slots(ppool, slots, prompts)]
    steps = [(np.stack(want), np.stack(got))]
    toks = np.zeros((4,), np.int32)
    toks[slots] = np.stack(want).argmax(-1)
    for _ in range(4):
        w = np.asarray(ref.decode_slots_with_logits(rpool, toks),
                       np.float32)[slots]
        g = port.decode_slots_with_logits(ppool, toks).numpy()[slots]
        steps.append((w, g))
        for s in slots:
            rpool.lengths[s] += 1
            ppool.lengths[s] += 1
        toks[slots] = w.argmax(-1)              # teacher forcing
    # 4 prefill chunks of one row and 4 decode steps of 4 slots, each
    # through both MoE layers, every group taken by the port
    recorded, taken = reference_routes
    assert len(recorded) == taken[0] == (4 + 4 * 4) * cfg.n_layers
    n_decided = 0
    for w, g in steps:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        top2 = np.sort(w, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > DECIDED_GAP
        n_decided += int(decided.sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      w.argmax(-1)[decided])
    assert n_decided >= len(steps)      # the check compared real tokens


@pytest.mark.parametrize("max_burst", [8, 1], ids=["bursts", "single"])
def test_scheduler_serves_requests_equal_to_their_solo_runs(max_burst):
    """Staggered admission: each request's greedy tokens equal the request
    served alone, bit for bit (a decode row routes as its own group and
    attends over its own latents, so its batch-mates cannot move it)."""
    eng = _engine(max_burst=max_burst)
    prompts = _prompts(eng.cfg.vocab, (8, 6, 10, 13, 17), seed=4)
    solo = [eng.generate({"tokens": p[None]},
                         max_new_tokens=6)["generated"][0] for p in prompts]
    sched = Scheduler(eng)
    first = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[:2]]
    while sched.n_decode_steps < 2:
        sched.step()
    late = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        max_new_tokens=6))) for p in prompts[2:]]
    sched.run(max_steps=200)
    for req, want in zip(first + late, solo):
        assert req.is_finished and req.finish_reason == "length"
        np.testing.assert_array_equal(np.asarray(req.output_tokens), want)
    rep = sched.metrics.report()
    assert rep["decode_token_steps"] > 0
    if max_burst > 1:
        assert max(map(int, rep["burst_hist"])) > 1


def test_preempt_resume_equals_unpreempted_run():
    """A high-class arrival preempts a decoding request; the victim is
    requeued with prompt + generated[:-1], replays it through prefill
    chunks (the latents rewritten) and ends with the tokens of an
    unpreempted run."""
    eng = _engine(max_len=48, n_slots=2)
    prompts = _prompts(eng.cfg.vocab, (16, 12, 9), seed=0)
    sp = SamplingParams(max_new_tokens=24)
    base = Scheduler(eng)
    for i, p in enumerate(prompts):
        base.submit(Request(p, sp, id=i))
    base.run(max_steps=500)
    want = {r.id: list(r.output_tokens) for r in base.finished}
    s = Scheduler(eng)
    s.submit(Request(prompts[1], sp, id=1, priority=5))
    s.submit(Request(prompts[2], sp, id=2, priority=5))
    for _ in range(5):
        s.step()
    s.submit(Request(prompts[0], sp, id=0, priority=0))
    s.run(max_steps=500)
    assert sum(r.n_preemptions for r in s.finished) >= 1
    assert {r.id: list(r.output_tokens) for r in s.finished} == want
    victim = next(r for r in s.finished if r.n_preemptions > 0)
    assert victim.finish_reason == "length"
    assert s.metrics.report()["finish_reasons"]["preempted_resumed"] >= 1


def test_replayed_routes_reproduce_the_recorded_run():
    """``Routes`` through the MLA model: a recorded prefill chunk and decode
    step replayed give the same logits bit for bit."""
    _, _, pcfg, port = _smoke()
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(1, pcfg.vocab, (2, 8))).long()

    def run(routes):
        cache = T.init_cache(pcfg, 2, 16, device="cpu")
        pre = T.forward(pcfg, port, toks, cache=cache, cache_index=0,
                        mode="prefill_chunk", routes=routes)
        dec = T.forward(pcfg, port, toks[:, :1], cache=cache,
                        cache_index=torch.tensor([8, 8]), mode="decode",
                        routes=routes)
        return pre, dec

    rec = M.Routes()
    want = run(rec)
    assert len(rec.ids) == 2 * pcfg.n_layers
    got = run(M.Routes(rec.ids))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_serve_entry_point_runs_deepseek_smoke_on_the_cpu(capsys):
    serve_main.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "3", "--prompt-len", "12", "--max-new", "4",
                     "--prefill-chunk", "8"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["arch"] == "deepseek-v2-smoke" and rep["kv"] == "bf16"
    assert rep["finish_reasons"] == {"length": 3}
    assert rep["total_new_tokens"] == 12
