"""whisper-smoke served by the port's ``ServingEngine`` against the JAX
reference's engine, the models of ``test_torch_whisper.py`` (the
reference's seeded weights with drawn LayerNorm gammas and betas), on the
CPU through the kernels' plain versions; the reference runs meshless with
``PrecisionPolicy(kernel='pallas')``:

* ``generate`` on ``{"tokens", "frames"}`` (the static-batch loop: one
  prefill through the encoder and the decoder, then decode steps over the
  cached encoder output) against the reference's ``generate`` (its jitted
  loop), greedy, at temperature 0.8 and with an EOS: ids equal up to each
  row's first parting, which must fall where the reference's top-2 gap
  (its perturbed scores at temperature) is at most 0.1; ``prompt_len``,
  ``batch``, lengths and finish reasons equal;
* ``score`` (mode ``train``, labels < 0 masked) within 5e-2 of the
  reference's;
* the pools and the scheduler refuse the audio family, and a batch
  without ``frames`` on it, or with ``frames`` on any other family, or
  of another shape, raises ValueError.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import declare_execution
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import Scheduler, ServeConfig, ServingEngine
from repro_torch.serve.kv_pool import KVCachePool, PagedKVPool
from test_torch_whisper import (GAP, TOL, draw_batch, smoke_models,
                                top2_gap)

NEW = 8


def engines(*, temperature=0.0, eos_id=-1, kv="bf16", max_len=32):
    cfg, params, _, pcfg, port = smoke_models()
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=RefPolicy(kv=kv, kernel="pallas")))
    mine = ServingEngine(pcfg, port, ServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=PrecisionPolicy(kv=kv), device="cpu"))
    return ref, mine


def reference_scores(ref, batch, gen, seed, temperature):
    """The reference's decision scores [B, T, V] along its own ids ``gen``:
    its logits through its jitted prefill / decode steps, Gumbel-perturbed
    at temperature under the loop's key chain."""
    b, s = batch["tokens"].shape
    cache = RT.init_cache(ref.cfg, b, s + gen.shape[1],
                          kv_dtype=ref.scfg.kv_dtype)
    logits, cache = ref._prefill(ref.params, batch, cache)
    key = jax.random.PRNGKey(seed)
    keys, rows = [key], [logits]
    for i in range(gen.shape[1] - 1):
        key, sub = jax.random.split(key)
        logits, cache = ref._decode(ref.params, jnp.asarray(gen[:, i:i + 1]),
                                    cache, jnp.int32(s + i))
        keys.append(sub)
        rows.append(logits)
    out = []
    for k, lg in zip(keys, rows):
        lg = np.asarray(lg, np.float32)
        if temperature > 0:
            lg = np.asarray(jax.random.gumbel(k, lg.shape)) + lg / temperature
        out.append(lg)
    return np.stack(out, axis=1)


def generate_vs_reference(*, temperature=0.0, eos_id=-1, s=12, seed=3,
                          kv="bf16"):
    declare_execution(kernel="pallas")
    ref, mine = engines(temperature=temperature, eos_id=eos_id, kv=kv)
    batch = draw_batch(70, 2, s, ref.cfg)
    want = ref.generate(batch, max_new_tokens=NEW, seed=seed)
    got = mine.generate(batch, max_new_tokens=NEW, seed=seed)
    assert (got["prompt_len"], got["batch"]) == (want["prompt_len"],
                                                 want["batch"]) == (s, 2)
    assert got["generated"].dtype == np.int32
    if eos_id < 0:
        scores = reference_scores(ref, batch, np.asarray(want["generated"]),
                                  seed, temperature)
        np.testing.assert_array_equal(scores.argmax(-1), want["generated"])
        gaps = top2_gap(scores)
        for r in range(2):
            differ = np.flatnonzero(got["generated"][r]
                                    != want["generated"][r])
            if differ.size:
                assert gaps[r, differ[0]] <= GAP, (r, differ[0])
        if temperature > 0:     # Gumbel noise widens the gaps
            assert (gaps > GAP).sum() >= NEW
        np.testing.assert_array_equal(got["lengths"], want["lengths"])
        assert got["finish_reasons"] == want["finish_reasons"]
    return got, want, batch


@functools.lru_cache(maxsize=None)
def free_run():
    return generate_vs_reference()


def test_generate_greedy_matches_reference():
    got, want, _ = free_run()
    assert got["generated"].shape == (2, NEW)
    assert got["finish_reasons"] == ["length"] * 2
    # at least one row agrees all the way (the EOS test builds on it)
    assert any((got["generated"][r] == want["generated"][r]).all()
               for r in range(2))


def test_generate_with_int8_kv_matches_reference():
    got, _, _ = generate_vs_reference(kv="int8", seed=5)
    assert got["generated"].shape == (2, NEW)


def test_generate_at_temperature_matches_reference_and_repeats():
    got, _, batch = generate_vs_reference(temperature=0.8, seed=9)
    mine = engines(temperature=0.8)[1]
    again = mine.generate(batch, max_new_tokens=NEW, seed=9)
    np.testing.assert_array_equal(again["generated"], got["generated"])


def test_generate_eos_masks_and_stops_like_reference():
    """EOS = the third id of a row that agrees with the reference all the
    way: each row stops after its first EOS (later ids masked to 0, reason
    'eos'), as in the reference's loop.  (On these random smoke weights a
    greedy row may repeat one id: it then stops after its first.)"""
    free, free_ref, batch = free_run()
    agree = [r for r in range(2) if (free["generated"][r]
                                     == free_ref["generated"][r]).all()]
    assert agree, "no row of the free run agrees with the reference"
    r0 = agree[0]
    eos = int(free["generated"][r0, 2])
    declare_execution(kernel="pallas")
    ref, mine = engines(eos_id=eos)
    want = ref.generate(batch, max_new_tokens=NEW, seed=3)
    got = mine.generate(batch, max_new_tokens=NEW, seed=3)
    for r in range(2):
        row = got["generated"][r]
        if (free["generated"][r] == free_ref["generated"][r]).all():
            np.testing.assert_array_equal(row, np.asarray(
                want["generated"][r]))
            assert got["lengths"][r] == want["lengths"][r]
            assert got["finish_reasons"][r] == want["finish_reasons"][r]
        hit = np.flatnonzero(free["generated"][r] == eos)
        n = hit[0] + 1 if hit.size else NEW
        assert got["lengths"][r] == n and (row[n:] == 0).all()
    first = np.flatnonzero(free["generated"][r0] == eos)[0]
    assert got["lengths"][r0] == first + 1 <= 3
    assert got["finish_reasons"][r0] == "eos"


def test_score_matches_reference():
    declare_execution(kernel="pallas")
    ref, mine = engines()
    s = 14
    batch = draw_batch(71, 2, s, ref.cfg)
    labels = np.random.default_rng(72).integers(0, ref.cfg.vocab, (2, s))
    labels[0, :3] = -1                      # masked positions
    batch["labels"] = labels.astype(np.int32)
    want = np.asarray(ref.score(batch), np.float32)
    got = mine.score(batch)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # the train logits cover the tokens alone (no frame rows)
    assert tuple(mine.train_logits(batch).shape) == (2, s, ref.cfg.vocab)


def test_pools_and_scheduler_refuse_the_audio_family():
    _, _, _, pcfg, port = smoke_models()
    engine = ServingEngine(pcfg, port, ServeConfig(max_len=32,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="families"):
        engine.new_pool(2)
    with pytest.raises(ValueError, match="families"):
        Scheduler(engine)
    for pool in (KVCachePool, PagedKVPool):
        with pytest.raises(ValueError, match="families"):
            pool(pcfg, 2, 32, device="cpu")


def test_batches_carry_frames_exactly_on_the_audio_family():
    _, _, _, pcfg, port = smoke_models()
    engine = ServingEngine(pcfg, port, ServeConfig(max_len=32,
                                                   device="cpu"))
    batch = draw_batch(73, 2, 4, pcfg)
    with pytest.raises(ValueError, match="frames"):
        engine.generate({"tokens": batch["tokens"]}, max_new_tokens=2)
    with pytest.raises(ValueError, match="frames"):
        engine.score({"tokens": batch["tokens"],
                      "labels": batch["tokens"]})
    short = dict(batch, frames=batch["frames"][:, :-1])
    with pytest.raises(ValueError, match="frames"):
        engine.generate(short, max_new_tokens=2)
    with pytest.raises(ValueError, match="patches"):
        engine.generate(dict(batch, patches=batch["frames"]),
                        max_new_tokens=2)
    for arch in ("granite-8b", "phi-3-vision-4.2b"):
        cfg = port_config(arch, smoke=True)
        other = ServingEngine(cfg, T.build_params(
            cfg, C.QuantMaker(0, device="cpu")), ServeConfig(max_len=32,
                                                             device="cpu"))
        tokens = {"tokens": batch["tokens"], "frames": batch["frames"]}
        if arch != "granite-8b":
            tokens["patches"] = np.zeros((2, cfg.n_patches, cfg.d_model),
                                         np.float32)
        with pytest.raises(ValueError, match="frames"):
            other.generate(tokens, max_new_tokens=2)
    # the served batch itself goes through, frames as a tensor too
    out = engine.generate(dict(batch, frames=torch.from_numpy(
        batch["frames"])), max_new_tokens=2)
    assert out["generated"].shape == (2, 2)
