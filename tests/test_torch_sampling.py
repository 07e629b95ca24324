"""The port's temperature sampling against the JAX reference on the CPU.

* Key schedule, exact: ``PRNGKey``, ``fold_in``, ``Request.step_key`` /
  ``step_keys`` and ``batched_step_keys`` equal ``jax.random`` and
  ``repro.serve`` bit for bit (jax 0.9.0 with its defaults: x64 off,
  ``jax_threefry_partitionable`` on), and so do the random bits and the
  uniforms of a [V] draw.
* Gumbel noise: ``-log(-log(u))`` with each platform's ``log`` (torch's
  and XLA's agree to one ulp on the same input; ROADMAP R9), so the noise
  is held to GUMBEL_EPS x eps x max(|g|, 1), not to the bit.
* ``sample_rows``: the reference's ids, but on rows whose top-2 perturbed
  scores lie within NEAR_TIE; greedy rows are ``argmax`` whatever their
  key, and a batch without a temperature row draws no noise.
* Bursts: a K-step burst with temperature rows emits what K single steps
  emit, on the port's engine and scheduler (granite-smoke, plain kernels).
Every test draws from its own ``np.random.default_rng``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Request as RefRequest
from repro.serve import SamplingParams as RefSamplingParams
from repro.serve.sampling import batched_step_keys as ref_batched_step_keys
from repro.serve.sampling import sample_one as ref_sample_one
from repro.serve.sampling import sample_tokens as ref_sample_tokens
from repro_torch.configs import get_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.serve import (Request, SamplingParams, Scheduler,
                               ServeConfig, ServingEngine, threefry)
from repro_torch.serve.sampling import (batched_step_keys, sample_one,
                                        sample_rows, temperature_scores)

SEEDS = [0, 7, 13, 2**31 - 1, -1]
DATA = [0, 1, 7, 4096, 2**31 - 1]
WIDTHS = [1, 511, 512, 49152]
# torch's and XLA's CPU log differ by one ulp on some inputs; through the
# two logs of -log(-log(u)) that leaves the Gumbel noise within 4 eps of
# max(|g|, 1) (largest seen: 4 eps, at |g| < 1 where -log(u) is near 1)
GUMBEL_EPS = 4
NEAR_TIE = 1e-5
# rows of the sampler test whose ids may differ: only near ties, at most
# this many in the whole draw
MAX_NEAR_TIE_MISSES = 1


def _key_words(key) -> torch.Tensor:
    return threefry.keys_tensor(np.asarray(key).reshape(-1, 2), "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(key))
    for d in DATA:
        want = np.asarray(jax.random.fold_in(key, d))
        got = threefry.fold_in(threefry.prng_key(seed), d)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_step_keys_equal_the_references(seed):
    """``Request.step_key`` / ``step_keys`` and ``batched_step_keys`` at
    ids and steps up to 2^31 - 1, against the reference's."""
    rng = np.random.default_rng(abs(seed) % 97)
    for rid, n_gen in [(0, 0), (7, 2), (2**31 - 1, 5)]:
        ref = RefRequest(prompt=np.arange(1, 4), id=rid,
                         sampling=RefSamplingParams(seed=seed))
        port = Request(prompt=np.arange(1, 4), id=rid,
                       sampling=SamplingParams(seed=seed))
        ref.output_tokens = [0] * n_gen
        port.output_tokens = [0] * n_gen
        np.testing.assert_array_equal(port.step_key(),
                                      np.asarray(ref.step_key()))
        np.testing.assert_array_equal(port.step_keys(6), ref.step_keys(6))
    seeds = np.full(5, seed)
    ids = np.append(rng.integers(0, 2**31 - 1, 4), 2**31 - 1)
    starts = np.append(rng.integers(0, 2**31 - 64, 4), 2**31 - 8)
    np.testing.assert_array_equal(batched_step_keys(seeds, ids, starts, 8),
                                  ref_batched_step_keys(seeds, ids, starts, 8))


# ids at and past the edges of int32 and uint32: the reference folds a
# request id in as a uint32 (``step_key`` / ``step_keys``) and takes ids,
# seeds and starts as int32 in ``batched_step_keys``; both raise
# ``OverflowError`` outside those ranges
EDGE_IDS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1, -1, 2**40 + 7]


def _same_or_both_raise(port_fn, ref_fn):
    """The reference's result and the port's are equal, or both raise
    ``OverflowError``; True where they raised."""
    try:
        want = np.asarray(ref_fn())
    except OverflowError:
        with pytest.raises(OverflowError):
            port_fn()
        return True
    np.testing.assert_array_equal(port_fn(), want)
    return False


@pytest.mark.parametrize("rid", EDGE_IDS)
def test_step_keys_refuse_the_ids_the_reference_refuses(rid):
    """P4: an id outside [0, 2^32) raises ``OverflowError`` in the port's
    ``Request.step_key`` / ``step_keys`` wherever ``jax.random.fold_in``
    raises in the reference's (it used to alias id mod 2^32), and ids 0 ...
    2^32 - 1 keep the reference's keys."""
    ref = RefRequest(prompt=np.arange(1, 4), id=rid,
                     sampling=RefSamplingParams(temperature=0.8, seed=7))
    port = Request(prompt=np.arange(1, 4), id=rid,
                   sampling=SamplingParams(temperature=0.8, seed=7))
    raised = [_same_or_both_raise(port.step_key, ref.step_key),
              _same_or_both_raise(lambda: port.step_keys(3),
                                  lambda: ref.step_keys(3))]
    assert raised == [not 0 <= rid < 2**32] * 2


@pytest.mark.parametrize("rid", EDGE_IDS + [-2**31, -2**31 - 1])
def test_batched_step_keys_refuse_what_the_reference_refuses(rid):
    """``batched_step_keys`` takes ids as int32, as the reference's does:
    equal keys inside [-2^31, 2^31), ``OverflowError`` outside, for ids,
    seeds and starts alike."""
    raised = _same_or_both_raise(
        lambda: batched_step_keys([7], [rid], [0], 2),
        lambda: ref_batched_step_keys([7], [rid], [0], 2))
    assert raised == (not -2**31 <= rid < 2**31)
    for seeds, starts in (([rid], [0]), ([7], [rid])):
        _same_or_both_raise(
            lambda: batched_step_keys(seeds, [3], starts, 2),
            lambda: ref_batched_step_keys(seeds, [3], starts, 2))


def test_scheduler_refuses_an_id_past_uint32(engine):
    """``Request(id=2**32 + 1)`` at temperature 0.8: the first token's key
    raises, as the reference's ``fold_in`` does, instead of serving the
    keys of id 1."""
    sched = Scheduler(engine)
    sched.submit(Request(prompt=np.arange(1, 9, dtype=np.int32), id=2**32 + 1,
                         sampling=SamplingParams(temperature=0.8, seed=7,
                                                 max_new_tokens=2)))
    with pytest.raises(OverflowError, match="uint32"):
        sched.run(max_steps=20)


@pytest.mark.parametrize("v", WIDTHS)
def test_random_bits_and_uniforms_equal_jax(v):
    rng = np.random.default_rng(v)
    for seed, data in zip(rng.integers(-2**31, 2**31 - 1, 3), DATA):
        key = jax.random.fold_in(jax.random.PRNGKey(int(seed)), data)
        words = _key_words(key)
        bits = np.asarray(jax.random.bits(key, (v,), jnp.uint32))
        np.testing.assert_array_equal(
            threefry.random_bits(words, v)[0].numpy(), bits.astype(np.int64))
        for lo, hi in [(0.0, 1.0), (threefry.F32_TINY, 1.0)]:
            want = np.asarray(jax.random.uniform(key, (v,), jnp.float32,
                                                 lo, hi))
            got = threefry.uniform(words, v, lo, hi)[0].numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("v", WIDTHS)
def test_gumbel_noise_within_stated_ulps(v):
    rng = np.random.default_rng(100 + v)
    worst = 0.0
    for seed in rng.integers(0, 2**31 - 1, 4):
        key = jax.random.PRNGKey(int(seed))
        want = np.asarray(jax.random.gumbel(key, (v,), jnp.float32))
        got = threefry.gumbel(_key_words(key), v)[0].numpy()
        eps = np.finfo(np.float32).eps * np.maximum(np.abs(want), 1.0)
        worst = max(worst, float((np.abs(got - want) / eps).max()))
    assert worst <= GUMBEL_EPS, worst


def _ref_scores(logits, keys, temps):
    """The reference's perturbed scores (its own Gumbel noise), [N, V]."""
    t = jnp.maximum(jnp.asarray(temps), jnp.float32(1e-6))[:, None]
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[1],),
                                                 jnp.float32))(keys)
    return np.asarray(noise + jnp.asarray(logits) / t)


@pytest.mark.parametrize("v", [512, 4096])
def test_sample_rows_equals_reference_but_near_ties(v):
    """Mixed greedy and temperature rows on the same f32 logits, keys and
    temperatures: the port's ids are the reference's, except on rows
    whose top-2 perturbed scores (the reference's) lie within NEAR_TIE."""
    rng = np.random.default_rng(v)
    n = 48
    temps = rng.choice(np.array([0.0, -1.0, 0.3, 0.8, 1.0, 1.7],
                                np.float32), n)
    misses = 0
    for draw in range(4):
        logits = (rng.normal(0, 1 + draw, (n, v))).astype(np.float32)
        keys = batched_step_keys(rng.integers(0, 2**31 - 1, n),
                                 np.arange(n), rng.integers(0, 64, n), 1)[:, 0]
        want = np.asarray(ref_sample_tokens(jnp.asarray(logits),
                                            jnp.asarray(keys),
                                            jnp.asarray(temps)))
        got = sample_rows(torch.from_numpy(logits), keys, temps).numpy()
        top2 = np.sort(_ref_scores(logits, keys, temps), -1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0] <= NEAR_TIE) & (temps > 0)
        differ = got != want
        assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
        misses += int(differ.sum())
        # the port's own scores pick its ids
        hot = temps > 0
        own = temperature_scores(torch.from_numpy(logits[hot]), keys[hot],
                                 torch.from_numpy(temps[hot]))
        np.testing.assert_array_equal(own.argmax(-1).numpy(), got[hot])
    assert misses <= MAX_NEAR_TIE_MISSES


def test_greedy_rows_ignore_their_keys_and_draw_no_noise(monkeypatch):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 2, (6, 300)).astype(np.float32))
    greedy = logits.argmax(-1).to(torch.int32)
    temps = np.array([0.0, 0.9, -0.5, 0.0, 0.4, 0.0], np.float32)
    ids = [sample_rows(logits, batched_step_keys(np.full(6, s), np.arange(6),
                                                 np.zeros(6), 1)[:, 0], temps)
           for s in (1, 2, 3)]
    cold = temps <= 0
    for got in ids:
        torch.testing.assert_close(got[cold], greedy[cold], rtol=0, atol=0)
    assert any(not torch.equal(a[~cold], ids[0][~cold]) for a in ids[1:])

    def no_noise(*a, **k):
        raise AssertionError("a greedy batch drew Gumbel noise")

    monkeypatch.setattr(threefry, "gumbel", no_noise)
    got = sample_rows(logits, np.zeros((6, 2), np.uint32),
                      np.zeros(6, np.float32))
    torch.testing.assert_close(got, greedy, rtol=0, atol=0)


def test_sample_one_equals_reference():
    rng = np.random.default_rng(21)
    for t in (0.0, 0.6, 1.3):
        logits = rng.normal(0, 2, (700,)).astype(np.float32)
        key = batched_step_keys([5], [rng.integers(0, 99)], [3], 1)[0, 0]
        want = ref_sample_one(jnp.asarray(logits), jnp.asarray(key), t)
        assert sample_one(torch.from_numpy(logits), key, t) == want


# ---------------------------------------------------------------------------
# Bursts with temperature rows on the port's engine (granite-smoke)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine():
    cfg = get_config("granite-8b", smoke=True)
    params = T.build_params(cfg, C.QuantMaker(0, device="cpu"))
    return ServingEngine(cfg, params, ServeConfig(
        max_len=48, n_slots=4, prefill_chunk=8, max_burst=8, device="cpu"))


def _run(engine, prompts, *, max_burst, temperature, seed, max_new=6):
    engine = ServingEngine(engine.cfg, engine.params, dataclasses.replace(
        engine.scfg, max_burst=max_burst))
    sched = Scheduler(engine)
    reqs = [sched.submit(Request(prompt=p, sampling=SamplingParams(
        temperature=temperature if i != 1 else 0.0, max_new_tokens=max_new,
        seed=seed))) for i, p in enumerate(prompts)]
    sched.run(max_steps=400)
    assert all(r.is_finished for r in reqs)
    return [list(r.output_tokens) for r in reqs], sched


def test_burst_equals_single_steps_with_temperature_rows(engine):
    """Rows 0 and 2 sample at 0.8, row 1 is greedy: max_burst=8 emits the
    tokens of max_burst=1, and another seed moves the sampled rows."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, engine.cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 11, 6)]
    want, s1 = _run(engine, prompts, max_burst=1, temperature=0.8, seed=13)
    got, s8 = _run(engine, prompts, max_burst=8, temperature=0.8, seed=13)
    assert got == want
    assert any(k > 1 for k in s8.metrics.burst_hist)
    assert all(k == 1 for k in s1.metrics.burst_hist)
    other, _ = _run(engine, prompts, max_burst=8, temperature=0.8, seed=14)
    assert other[1] == want[1] and other != want


def test_engine_burst_primitive_equals_single_steps(engine):
    """decode_burst(K=4) with a temperature row emits what 4 decode_slots
    calls emit with the same keys, and commits the same lengths."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, engine.cfg.vocab, (n,)).astype(np.int32)
               for n in (9, 7)]
    temps = np.array([0.9, 0.0, 0.0, 0.0], np.float32)
    keys = batched_step_keys(np.full(4, 5), np.arange(4), np.ones(4), 4)
    keys = keys.transpose(1, 0, 2).copy()                     # [K, n, 2]
    out = []
    for burst in (True, False):
        pool = engine.new_pool()
        slots = [pool.alloc() for _ in prompts]
        first = engine.prefill_into_slots(pool, slots, prompts)
        tokens = np.zeros((4,), np.int32)
        tokens[slots] = [int(x.argmax()) for x in first]
        active = np.zeros((4,), bool)
        active[slots] = True
        if burst:
            toks, valid = engine.decode_burst(
                pool, tokens, keys, temps, active, np.full(4, 9, np.int32),
                np.full(4, -1, np.int32))
            assert valid[:, slots].all()
            out.append((toks[:, slots], pool.lengths.copy()))
            continue
        steps = []
        for t in range(4):
            ids = engine.decode_slots(pool, tokens, keys[t], temps)
            pool.lengths[slots] += 1
            tokens[slots] = ids[slots]
            steps.append(ids[slots])
        out.append((np.stack(steps), pool.lengths.copy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
