"""The port's serving slice against the JAX reference at granite-smoke size.

* Teacher-forced: the port's ServingEngine and a meshless reference
  ServingEngine with ``PrecisionPolicy(kernel='pallas')`` (the kernel path
  the port reproduces) prefill the same prompts and decode the same tokens;
  logits agree within rtol/atol 5e-2 at every step, and greedy ids agree
  wherever the reference's top-2 gap exceeds 0.1.
* The port's scheduler: mid-flight admission and decode bursts give the
  tokens a request gets served alone; slots are reused; metrics are sane.
All on the CPU (the kernels' plain versions); weights from the reference's
seeded QuantMaker through the bridge.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine)

TOL = 5e-2
DECIDED_GAP = 0.1


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("granite-8b", smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = port_config("granite-8b", smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")
    return cfg, params, pcfg, port


def _engine(weights, tier="bf16", **kw):
    _, _, pcfg, port = weights
    kw.setdefault("max_len", 48)
    kw.setdefault("n_slots", 4)
    kw.setdefault("prefill_chunk", 8)
    return ServingEngine(pcfg, port, ServeConfig(
        policy=PrecisionPolicy(kv=tier), device="cpu", **kw))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_teacher_forced_logits_match_reference_engine(weights, tier):
    cfg, params, _, _ = weights
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=32, n_slots=4, prefill_chunk=8,
        policy=RefPolicy(kv=tier, kernel="pallas")))
    port = _engine(weights, tier, max_len=32)
    prompts = _prompts(cfg.vocab, (11, 8, 5), seed=5)
    rpool, ppool = ref.new_pool(), port.new_pool()
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
    n_decided = 0
    for w, g in steps:
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        top2 = np.sort(w, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > DECIDED_GAP
        n_decided += int(decided.sum())
        np.testing.assert_array_equal(g.argmax(-1)[decided],
                                      w.argmax(-1)[decided])
    assert n_decided >= len(steps)      # the check compared real tokens


def test_scheduler_mid_flight_admission_matches_solo_runs(weights):
    eng = _engine(weights)
    prompts = _prompts(eng.cfg.vocab, (8, 6, 10, 13), seed=4)
    solo = [eng.generate(p[None], max_new_tokens=5)["generated"][0]
            for p in prompts]
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
    batch = eng.generate(np.stack(prompts), max_new_tokens=12)
    for row, p in zip(batch["generated"], prompts):
        np.testing.assert_array_equal(
            row, eng.generate(p[None], max_new_tokens=12)["generated"][0])
    single = _engine(weights, "int8", max_burst=1)
    np.testing.assert_array_equal(
        batch["generated"],
        single.generate(np.stack(prompts), max_new_tokens=12)["generated"])


def test_slot_reuse_eos_and_metrics(weights):
    eng = _engine(weights)
    prompts = _prompts(eng.cfg.vocab, (6, 9, 5), seed=7) * 3
    probe = eng.generate(prompts[0][None], max_new_tokens=4)["generated"][0]
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
    _, _, pcfg, port = weights
    with pytest.raises(NotImplementedError):
        SamplingParams(temperature=0.7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(pcfg, port, ServeConfig())      # device="cuda"
    eng = _engine(weights, max_len=16)
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
    out = eng.generate(np.arange(1, 10, dtype=np.int32)[None],
                       max_new_tokens=3)
    assert out["generated"].shape == (1, 3)
    assert eng.new_pool().kv_dtype == "fp8"
    with pytest.raises(ValueError, match="attn.wo"):
        ServingEngine(pcfg, params, ServeConfig(device="cpu"))
