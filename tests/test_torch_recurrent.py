"""The recurrent families served by the port against the JAX reference at
smoke size, on the CPU through the kernels' plain versions; the reference
runs meshless with ``PrecisionPolicy(kernel='pallas')`` (its Pallas
kernels in interpret mode), on weights from its seeded ``QuantMaker``
carried over by the bridge.  This file holds zamba2-smoke (Mamba-2 +
shared attention, awq_int4; 5 layers, a shared block after every 2) and
the static-batch ``generate``; ``test_torch_recurrent_w8a8.py`` holds
xlstm-smoke (W8A8):

* ``forward``: a prefill from an empty cache at S = 32 (the chunked SSD:
  ``ssm_chunk`` is 16) and at S = 20 (the sequential one), then 6 decode
  steps at an int index, teacher-forced on the reference's greedy ids,
  with bf16 and with int8 KV: logits within rtol / atol 5e-2 of the
  jitted reference's, greedy ids equal wherever the reference's top-2 gap
  exceeds 0.1;
* ``ServingEngine.generate`` (the static-batch loop) against the
  reference's ``generate``: greedy, at temperature 0.8 with a seed, and
  with an ``eos_id`` that a row meets (post-EOS masking, lengths, finish
  reasons, and the early stop of a batch whose rows all met it).  Ids are
  equal up to each row's first parting, and a parting is allowed only at
  a step where the reference's top-2 gap (its perturbed scores at
  temperature) is at most 0.1 — the reference's logits are read along its
  own tokens through its own jitted prefill / decode steps;
* the slot pools refuse both recurrent families, as the reference's do.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import declare_execution
from repro.models import common as RC
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro.serve.kv_pool import KVCachePool as RefPool
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.kv_pool import KVCachePool, PagedKVPool

TOL = dict(rtol=5e-2, atol=5e-2)
GAP = 0.1
STEPS = 6


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def smoke_models(arch):
    cfg = get_config(arch, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    pcfg = port_config(arch, smoke=True)
    port = params_from_numpy(pcfg, jax.tree_util.tree_map(np.asarray,
                                                          params),
                             device="cpu")
    return cfg, params, pcfg, port


def top2_gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_logits(got, want):
    """Within 5e-2, and the same argmax wherever the gap exceeds 0.1."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, **TOL)
    decided = top2_gap(want) > GAP
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def teacher_forced(arch, tier, s, seed, eager=False):
    """Prefill at S = ``s`` then STEPS decode steps, both sides fed the
    reference's greedy ids; each step's logits held by ``assert_logits``.
    ``eager`` runs the reference op by op."""
    cfg, params, pcfg, port = smoke_models(arch)
    tokens = np.random.default_rng(seed).integers(
        1, cfg.vocab, (2, s)).astype(np.int32)
    rcache = RT.init_cache(cfg, 2, s + STEPS, kv_dtype=tier)
    pcache = T.init_cache(pcfg, 2, s + STEPS, kv_dtype=tier, device="cpu")
    if eager:
        ctx, fwd = jax.disable_jit, RT.forward
    else:
        ctx = contextlib.nullcontext
        fwd = jax.jit(RT.forward, static_argnums=(0,),
                      static_argnames=("mode",))
    with ctx():
        want, _, rcache = fwd(cfg, params, {"tokens": jnp.asarray(tokens)},
                              cache=rcache, cache_index=0, mode="prefill")
    got = T.forward(pcfg, port, torch.from_numpy(tokens).long(),
                    cache=pcache, cache_index=0, mode="prefill")
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    assert_logits(got, want)
    for i in range(STEPS):
        ids = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)[:, None]
        with ctx():
            want, _, rcache = fwd(cfg, params, {"tokens": jnp.asarray(ids)},
                                  cache=rcache, cache_index=jnp.int32(s + i),
                                  mode="decode")
        got = T.forward(pcfg, port, torch.from_numpy(ids).long(),
                        cache=pcache, cache_index=s + i, mode="decode")
        assert_logits(got, want)


@pytest.mark.parametrize("s", [32, 20], ids=["chunked", "sequential"])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_zamba2_forward_matches_reference(tier, s):
    declare_execution(kernel="pallas")
    teacher_forced("zamba2-7b", tier, s, seed=40 + s)


# ---------------------------------------------------------------------------
# The static-batch generate loop
# ---------------------------------------------------------------------------
def engines(arch, *, temperature=0.0, eos_id=-1, kv="bf16", max_len=64):
    cfg, params, pcfg, port = smoke_models(arch)
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=RefPolicy(kv=kv, kernel="pallas")))
    mine = ServingEngine(pcfg, port, ServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=PrecisionPolicy(kv=kv), device="cpu"))
    return ref, mine


def reference_scores(ref, tokens, gen, seed, temperature):
    """The reference's decision scores along its own ids ``gen`` [B, T]:
    the logits (greedy) or the Gumbel-perturbed ``logits / T`` under the
    loop's key chain, from its jitted prefill / decode steps."""
    b, s = tokens.shape
    cache = RT.init_cache(ref.cfg, b, s + gen.shape[1],
                          kv_dtype=ref.scfg.kv_dtype)
    logits, cache = ref._prefill(ref.params, {"tokens": jnp.asarray(tokens)},
                                 cache)
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
    return np.stack(out, axis=1)                        # [B, T, V]


def assert_same_ids_but_near_ties(got, want, scores):
    """Per row: equal ids up to the first parting, which must fall on a
    step whose reference top-2 gap is at most GAP."""
    gaps = top2_gap(scores)
    for r in range(want.shape[0]):
        differ = np.flatnonzero(got[r] != want[r])
        if differ.size:
            t = differ[0]
            assert gaps[r, t] <= GAP, (r, t, gaps[r, t])


def generate_vs_reference(arch, *, temperature=0.0, eos_id=-1, s=20,
                          new=8, seed=3, rows=2, prompt_seed=60):
    ref, mine = engines(arch, temperature=temperature, eos_id=eos_id)
    tokens = np.random.default_rng(prompt_seed).integers(
        1, ref.cfg.vocab, (rows, s)).astype(np.int32)
    want = ref.generate({"tokens": tokens}, max_new_tokens=new, seed=seed)
    got = mine.generate({"tokens": tokens}, max_new_tokens=new, seed=seed)
    assert (got["prompt_len"], got["batch"]) == (s, rows)
    assert got["generated"].dtype == np.int32
    if eos_id < 0:
        scores = reference_scores(ref, tokens, np.asarray(want["generated"]),
                                  seed, temperature)
        assert_same_ids_but_near_ties(got["generated"], want["generated"],
                                      scores)
    return got, want, tokens


@functools.lru_cache(maxsize=None)
def free_run(arch):
    """The greedy generate of both engines on one batch (cached: the EOS
    test picks its EOS from it)."""
    declare_execution(kernel="pallas")
    return generate_vs_reference(arch)


def test_generate_greedy_matches_reference():
    got, want, _ = free_run("zamba2-7b")
    assert got["generated"].shape == (2, 8)
    assert got["finish_reasons"] == want["finish_reasons"] == ["length"] * 2
    np.testing.assert_array_equal(got["lengths"], want["lengths"])


def test_generate_at_temperature_matches_reference_and_repeats():
    declare_execution(kernel="pallas")
    got, want, tokens = generate_vs_reference("zamba2-7b", temperature=0.8,
                                              seed=9)
    mine = engines("zamba2-7b", temperature=0.8)[1]
    again = mine.generate({"tokens": tokens}, max_new_tokens=8, seed=9)
    np.testing.assert_array_equal(again["generated"], got["generated"])
    other = mine.generate({"tokens": tokens}, max_new_tokens=8, seed=10)
    assert (other["generated"] != got["generated"]).any()


def test_generate_eos_masks_and_stops_like_reference():
    """EOS = the id the first row that agrees with the reference all the
    way emits third: that row stops there (later ids masked to 0, length
    3, reason 'eos') while the other runs on, each row as the reference's
    where its free run agreed (a row parted at a near tie is held to the
    masking rule on its own ids); served alone, that row ends the loop
    after 3 tokens."""
    declare_execution(kernel="pallas")
    free, free_ref, tokens = free_run("zamba2-7b")
    agree = [r for r in range(2) if (free["generated"][r]
                                     == free_ref["generated"][r]).all()
             and free["generated"][r, 2] not in free["generated"][r, :2]]
    assert agree, "no row of the free run agrees with the reference"
    r0 = agree[0]
    eos = int(free["generated"][r0, 2])
    ref, mine = engines("zamba2-7b", eos_id=eos)
    want = ref.generate({"tokens": tokens}, max_new_tokens=8, seed=3)
    got = mine.generate({"tokens": tokens}, max_new_tokens=8, seed=3)
    for r in range(2):
        row = got["generated"][r]
        if (free["generated"][r] == free_ref["generated"][r]).all():
            np.testing.assert_array_equal(row, np.asarray(
                want["generated"][r]))
            assert got["lengths"][r] == want["lengths"][r]
            assert got["finish_reasons"][r] == want["finish_reasons"][r]
        hit = np.flatnonzero(free["generated"][r] == eos)
        n = hit[0] + 1 if hit.size else 8
        assert got["lengths"][r] == n and (row[n:] == 0).all()
        assert got["finish_reasons"][r] == ("eos" if hit.size else "length")
    assert got["lengths"][r0] == 3 and got["finish_reasons"][r0] == "eos"
    alone = mine.generate({"tokens": tokens[r0:r0 + 1]}, max_new_tokens=8,
                          seed=3)
    np.testing.assert_array_equal(alone["generated"],
                                  free["generated"][r0:r0 + 1, :3])
    assert alone["finish_reasons"] == ["eos"]


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_pools_refuse_the_recurrent_families(arch):
    cfg, _, pcfg, port = smoke_models(arch)
    engine = ServingEngine(pcfg, port, ServeConfig(max_len=64,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="families"):
        engine.new_pool(2)
    for pool in (KVCachePool, PagedKVPool):
        with pytest.raises(ValueError, match="families"):
            pool(pcfg, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="families"):
        RefPool(cfg, 2, 64)
    with pytest.raises(ValueError, match="recurrent"):
        T.forward(pcfg, port, torch.zeros((1, 4), dtype=torch.long),
                  cache=T.init_cache(pcfg, 1, 8, device="cpu"),
                  cache_index=0, mode="prefill_chunk")
