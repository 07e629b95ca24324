"""``ServingEngine.generate`` takes the reference's batch dict and, for the
dense / MoE families, returns the reference's keys: granite-smoke through
the port's engine and a meshless reference engine with
``PrecisionPolicy(kernel='pallas')`` on the same ``ServeConfig``.

Five prompts over four slots (one waits for a slot), 8 new tokens each,
greedy with bursts of up to 8, greedy one step a dispatch, and at
temperature 0.8: the key sets are equal; ``prompt_len``, ``batch``,
``decode_dispatches``, ``decode_token_steps``, ``host_syncs`` and
``burst_hist`` are equal (without an EOS the schedule does not depend on
the tokens), and so are the lengths and finish reasons.  Each row's ids
equal the reference's up to the row's first parting, which must fall on
a step where the reference's top-2 gap (its Gumbel-perturbed scores at
temperature) is at most 0.1: the reference's decision scores are read
along its own tokens through its own pool steps, every row in a slot of
its own (a dense row's logits do not depend on its batch-mates).
On the CPU, through the kernels' plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import transformer as RT
from repro.models.common import QuantMaker as RefQuantMaker
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.sampling import batched_step_keys

GAP = 0.1
ROWS, PROMPT, NEW, SEED = 5, 9, 8, 4
COUNTERS = ("prompt_len", "batch", "decode_dispatches", "decode_token_steps",
            "host_syncs", "burst_hist")


@functools.lru_cache(maxsize=None)
def smoke_models():
    cfg = get_config("granite-8b", smoke=True)
    params = RT.build_params(cfg, RefQuantMaker(jax.random.PRNGKey(0)))
    pcfg = port_config("granite-8b", smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


def engines(**kw):
    """The port's engine and the reference's on one serving config."""
    cfg, params, pcfg, port = smoke_models()
    kw = {"max_len": 32, "n_slots": 4, "prefill_chunk": 8, **kw}
    ref = RefEngine(cfg, params, RefServeConfig(
        policy=RefPolicy(kernel="pallas"), **kw))
    mine = ServingEngine(pcfg, port, ServeConfig(
        policy=PrecisionPolicy(), device="cpu", **kw))
    return ref, mine


def decision_scores(tokens, gen, temperature):
    """The reference's decision scores [B, T, V] along its own ids ``gen``
    [B, T]: its logits through its pool steps (each row in its own slot),
    Gumbel-perturbed at temperature with each request's step keys (row i
    is request id i)."""
    ref, _ = engines(n_slots=8)
    pool = ref.new_pool()
    slots = [pool.alloc() for _ in tokens]
    rows = [np.stack([np.asarray(x, np.float32) for x in
                      ref.prefill_into_slots(pool, slots, list(tokens))])]
    feed = np.zeros((pool.n_slots,), np.int32)
    for t in range(gen.shape[1] - 1):
        feed[slots] = gen[:, t]
        rows.append(np.asarray(ref.decode_slots_with_logits(pool, feed),
                               np.float32)[slots])
        for s in slots:
            pool.lengths[s] += 1
    logits = np.stack(rows, axis=1)                      # [B, T, V]
    if temperature <= 0:
        return logits
    keys = batched_step_keys([SEED] * len(tokens), list(range(len(tokens))),
                             [0] * len(tokens), gen.shape[1])
    out = []
    for r in range(len(tokens)):
        noise = jax.vmap(lambda k: jax.random.gumbel(
            k, (logits.shape[-1],), jnp.float32))(jnp.asarray(keys[r]))
        out.append(np.asarray(noise + jnp.asarray(logits[r]) / temperature))
    return np.stack(out)


@pytest.mark.parametrize("temperature, max_burst", [(0.0, 8), (0.0, 1),
                                                    (0.8, 8)],
                         ids=["greedy", "single_steps", "temperature"])
def test_generate_returns_the_references_keys_and_counters(temperature,
                                                           max_burst):
    ref, mine = engines(temperature=temperature, max_burst=max_burst)
    tokens = np.random.default_rng(30).integers(
        1, ref.cfg.vocab, (ROWS, PROMPT)).astype(np.int32)
    want = ref.generate({"tokens": tokens}, max_new_tokens=NEW, seed=SEED)
    got = mine.generate({"tokens": tokens}, max_new_tokens=NEW, seed=SEED)
    assert set(got) == set(want)
    for key in COUNTERS:
        assert got[key] == want[key], key
    if max_burst == 1:
        assert got["burst_hist"] == {1: got["decode_dispatches"]}
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["finish_reasons"] == want["finish_reasons"] == \
        ["length"] * ROWS
    gen = np.asarray(want["generated"])
    assert got["generated"].shape == gen.shape == (ROWS, NEW)
    scores = decision_scores(tokens, gen, temperature)
    np.testing.assert_array_equal(scores.argmax(-1), gen)
    top2 = np.sort(scores, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    for r in range(ROWS):
        differ = np.flatnonzero(got["generated"][r] != gen[r])
        if differ.size:
            assert gaps[r, differ[0]] <= GAP, (r, differ[0])
    assert (gaps > GAP).sum() >= ROWS       # the rule compared real tokens


def test_generate_takes_the_batch_dict_only():
    _, mine = engines()
    tokens = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match="patches"):
        mine.generate({"tokens": tokens, "patches": np.zeros((1, 4, 64))},
                      max_new_tokens=2)
    with pytest.raises(TypeError, match="dict"):
        mine.generate(tokens, max_new_tokens=2)
