"""The VLM (phi-3-vision's family) served by the port against the JAX
reference at phi3v-smoke size (2 layers, d_model 64, 4 patch rows, fp8
weights, tied embeddings), on the CPU through the kernels' plain
versions; the reference runs meshless with
``PrecisionPolicy(kernel='pallas')``, on weights from its seeded
``QuantMaker`` carried over by the bridge.  Patches are drawn at the
embedding table's scale from each test's own generator.

* the bridge round trip keeps every bit (no ``lm_head``: tied), and the
  leaf names, shapes and resolved plans are the reference's;
* a prefill of patches + S tokens from an empty cache, then 8 decode
  steps at index ``n_patches + S + i``, teacher-forced on the reference's
  greedy ids, against the reference engine's jitted ``_prefill`` /
  ``_decode``, at bf16 and int8 KV, with S such that the prefill's
  attention is one block and several KV chunks: logits within rtol / atol
  5e-2, the same argmax wherever the reference's top-2 gap exceeds 0.1;
* ``generate`` on ``{"tokens", "patches"}`` against the reference's
  ``generate`` (greedy, at temperature 0.8, with an EOS): ids equal up to
  each row's first parting, which must fall where the reference's top-2
  gap (its perturbed scores at temperature) is at most 0.1; ``prompt_len``,
  ``batch``, lengths and finish reasons equal;
* the port's own prefill + decode at position ``n_patches + S - 1``
  against its ``train`` logits at the last row (the reference's
  ``test_prefill_decode_consistency``), 5e-2;
* other patches move the logits, on both sides;
* ``score`` (mode ``train``, patch rows dropped, labels < 0 masked)
  within 5e-2 of the reference's, for the VLM and a dense model;
* the pools and the scheduler refuse the VLM; mode ``train`` refuses the
  MoE and recurrent families.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import common as RC
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch.roofline import model_params
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy, leaf_info
from repro_torch.serve import Scheduler, ServeConfig, ServingEngine
from repro_torch.serve.kv_pool import KVCachePool, PagedKVPool

ARCH = "phi-3-vision-4.2b"
TOL = dict(rtol=5e-2, atol=5e-2)
GAP = 0.1
STEPS = 8


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def smoke_models(arch=ARCH):
    cfg = get_config(arch, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    pcfg = port_config(arch, smoke=True)
    return cfg, params, tree, pcfg, params_from_numpy(pcfg, tree,
                                                      device="cpu")


def draw_batch(seed, rows, s, cfg):
    """{'tokens' [rows, s] int32, 'patches' [rows, Np, D] f32} from
    ``default_rng(seed)``, patches at the embedding table's scale."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (rows, s)).astype(np.int32),
            "patches": (rng.normal(size=(rows, cfg.n_patches, cfg.d_model))
                        * 0.02).astype(np.float32)}


def port_batch(batch):
    return (torch.from_numpy(batch["tokens"]).long(),
            torch.from_numpy(batch["patches"]))


def top2_gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_logits(got, want):
    """Within 5e-2, and the same argmax wherever the gap exceeds 0.1."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, **TOL)
    decided = top2_gap(want) > GAP
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()
    return int(decided.sum())


def engines(*, temperature=0.0, eos_id=-1, kv="bf16", max_len=64,
            arch=ARCH):
    cfg, params, _, pcfg, port = smoke_models(arch)
    ref = RefEngine(cfg, params, RefServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=RefPolicy(kv=kv, kernel="pallas")))
    mine = ServingEngine(pcfg, port, ServeConfig(
        max_len=max_len, temperature=temperature, eos_id=eos_id,
        policy=PrecisionPolicy(kv=kv), device="cpu"))
    return ref, mine


# ---------------------------------------------------------------------------
# Parameters and policy
# ---------------------------------------------------------------------------
def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    if hasattr(want, "packed"):
        for field in ("packed", "scales"):
            np.testing.assert_array_equal(getattr(got, field),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{path}.{field}")
        assert (got.scheme_name, tuple(got.shape), got.name) == \
            (want.scheme_name, tuple(want.shape), want.name), path
        return
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.view(np.int16)
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_bridge_round_trip_keeps_every_bit():
    _, _, tree, _, port = smoke_models()
    assert "lm_head" not in tree and port.lm_head is None
    _assert_trees_equal(params_to_numpy(port), tree)
    # the port's own walk builds the same leaves (the draws differ)
    mine = params_to_numpy(T.build_params(port_config(ARCH, smoke=True),
                                          C.QuantMaker(1, device="cpu")))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if hasattr(t, "packed"):
            return (np.shape(t.packed), np.shape(t.scales), t.scheme_name,
                    tuple(t.shape), t.name)
        a = np.asarray(t)
        return a.shape, a.dtype.itemsize
    assert shapes(mine) == shapes(tree)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_leaf_info_policy_and_params_match_reference(smoke):
    cfg, pcfg = get_config(ARCH, smoke=smoke), port_config(ARCH, smoke=smoke)
    assert leaf_info(pcfg) == ref_leaf_info(cfg)
    assert "lm_head" not in leaf_info(pcfg)
    for weights in ((), (("attn.*", "bf16"),), (("ffn.w_down", "fp8"),)):
        mine = PrecisionPolicy(weights=weights, kv="fp8").validate_for(pcfg)
        ref = RefPolicy(weights=weights, kv="fp8").validate_for(cfg)
        assert mine.resolved_plan(pcfg) == ref.resolved_plan(cfg)
    # tied: the embedding table once, no lm_head
    d, f, layers = pcfg.d_model, pcfg.d_ff, pcfg.n_layers
    layer = 2 * d + 4 * d * pcfg.n_heads * pcfg.head_dim + 3 * d * f
    assert model_params(pcfg)["total"] == \
        pcfg.vocab * d + d + layers * layer


# ---------------------------------------------------------------------------
# Teacher-forced prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [12, 124], ids=["one_block", "kv_chunks"])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_prefill_and_decode_match_reference_engine(tier, s):
    ref, _ = engines(kv=tier)
    cfg, _, _, pcfg, port = smoke_models()
    batch = draw_batch(10 + s, 2, s, cfg)
    index = cfg.n_patches + s
    rcache = RT.init_cache(cfg, 2, index + STEPS, kv_dtype=ref.scfg.kv_dtype)
    pcache = T.init_cache(pcfg, 2, index + STEPS, kv_dtype=tier,
                          device="cpu")
    want, rcache = ref._prefill(ref.params, batch, rcache)
    tokens, patches = port_batch(batch)
    got = T.forward(pcfg, port, tokens, cache=pcache, cache_index=0,
                    mode="prefill", patches=patches)
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    decided = assert_logits(got[:, -1], want)
    for i in range(STEPS):
        ids = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        want, rcache = ref._decode(ref.params, jnp.asarray(ids), rcache,
                                   jnp.int32(index + i))
        got = T.forward(pcfg, port, torch.from_numpy(ids).long(),
                        cache=pcache, cache_index=index + i, mode="decode")
        decided += assert_logits(got[:, -1], want)
    # smoke logits span ~0.7 (tied embeddings at scale 0.02), so few
    # greedy decisions are wider than 0.1
    assert decided >= 1


def test_prefill_then_decode_equals_train_logits():
    """The port alone: a prefill of patches + S - 1 tokens, then token S -
    1 decoded at position n_patches + S - 1, against mode ``train`` over
    patches + S tokens at its last row."""
    cfg, _, _, pcfg, port = smoke_models()
    s = 16
    tokens, patches = port_batch(draw_batch(7, 2, s, cfg))
    full = T.forward(pcfg, port, tokens, cache=None, cache_index=0,
                     mode="train", patches=patches)
    assert full.shape == (2, cfg.n_patches + s, cfg.vocab)
    cache = T.init_cache(pcfg, 2, cfg.n_patches + s, device="cpu")
    T.forward(pcfg, port, tokens[:, :-1], cache=cache, cache_index=0,
              mode="prefill", patches=patches)
    dec = T.forward(pcfg, port, tokens[:, -1:], cache=cache,
                    cache_index=cfg.n_patches + s - 1, mode="decode")
    np.testing.assert_allclose(_f32(dec[:, 0]), _f32(full[:, -1]), **TOL)


def test_other_patches_move_the_logits_on_both_sides():
    ref, _ = engines()
    cfg, _, _, pcfg, port = smoke_models()
    batch = draw_batch(3, 2, 10, cfg)
    other = dict(batch, patches=draw_batch(4, 2, 10, cfg)["patches"])
    outs = []
    for b in (batch, other):
        rcache = RT.init_cache(cfg, 2, cfg.n_patches + 10)
        want, _ = ref._prefill(ref.params, b, rcache)
        tokens, patches = port_batch(b)
        got = T.forward(pcfg, port, tokens,
                        cache=T.init_cache(pcfg, 2, cfg.n_patches + 10,
                                           device="cpu"),
                        cache_index=0, mode="prefill", patches=patches)
        assert_logits(got[:, -1], want)
        outs.append((_f32(got[:, -1]), _f32(want)))
    scale = np.abs(outs[0][1]).max()
    for side in (0, 1):
        assert np.abs(outs[0][side] - outs[1][side]).max() > 0.05 * scale


# ---------------------------------------------------------------------------
# The static-batch generate loop and score
# ---------------------------------------------------------------------------
def reference_scores(ref, batch, gen, seed, temperature):
    """The reference's decision scores [B, T, V] along its own ids ``gen``:
    its logits through its jitted prefill / decode steps (positions after
    the patch prefix), Gumbel-perturbed at temperature under the loop's
    key chain."""
    b, s = batch["tokens"].shape
    index = ref.cfg.n_patches + s
    cache = RT.init_cache(ref.cfg, b, index + gen.shape[1],
                          kv_dtype=ref.scfg.kv_dtype)
    logits, cache = ref._prefill(ref.params, batch, cache)
    key = jax.random.PRNGKey(seed)
    keys, rows = [key], [logits]
    for i in range(gen.shape[1] - 1):
        key, sub = jax.random.split(key)
        logits, cache = ref._decode(ref.params, jnp.asarray(gen[:, i:i + 1]),
                                    cache, jnp.int32(index + i))
        keys.append(sub)
        rows.append(logits)
    out = []
    for k, lg in zip(keys, rows):
        lg = np.asarray(lg, np.float32)
        if temperature > 0:
            lg = np.asarray(jax.random.gumbel(k, lg.shape)) + lg / temperature
        out.append(lg)
    return np.stack(out, axis=1)


def generate_vs_reference(*, temperature=0.0, eos_id=-1, s=12, new=8,
                          seed=3):
    ref, mine = engines(temperature=temperature, eos_id=eos_id)
    batch = draw_batch(60, 2, s, ref.cfg)
    want = ref.generate(batch, max_new_tokens=new, seed=seed)
    got = mine.generate(batch, max_new_tokens=new, seed=seed)
    for key in ("prompt_len", "batch"):
        assert got[key] == want[key], key
    assert (got["prompt_len"], got["batch"]) == (s, 2)
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
            assert (gaps > GAP).sum() >= new
        np.testing.assert_array_equal(got["lengths"], want["lengths"])
        assert got["finish_reasons"] == want["finish_reasons"]
    return got, want, batch


@functools.lru_cache(maxsize=None)
def free_run():
    return generate_vs_reference()


def test_generate_greedy_matches_reference():
    got, want, _ = free_run()
    assert got["generated"].shape == (2, 8)
    assert got["finish_reasons"] == ["length"] * 2


def test_generate_at_temperature_matches_reference_and_repeats():
    got, _, batch = generate_vs_reference(temperature=0.8, seed=9)
    mine = engines(temperature=0.8)[1]
    again = mine.generate(batch, max_new_tokens=8, seed=9)
    np.testing.assert_array_equal(again["generated"], got["generated"])


def test_generate_eos_masks_and_stops_like_reference():
    """EOS = the third id of a row that agrees with the reference all the
    way (and has not emitted it before): that row stops there (later ids
    masked to 0, length 3, reason 'eos'), as in the reference's loop."""
    free, free_ref, batch = free_run()
    agree = [r for r in range(2) if (free["generated"][r]
                                     == free_ref["generated"][r]).all()
             and free["generated"][r, 2] not in free["generated"][r, :2]]
    assert agree, "no row of the free run agrees with the reference"
    r0 = agree[0]
    eos = int(free["generated"][r0, 2])
    ref, mine = engines(eos_id=eos)
    want = ref.generate(batch, max_new_tokens=8, seed=3)
    got = mine.generate(batch, max_new_tokens=8, seed=3)
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
    assert got["lengths"][r0] == 3 and got["finish_reasons"][r0] == "eos"


@pytest.mark.parametrize("arch", [ARCH, "granite-8b"])
def test_score_matches_reference(arch):
    ref, mine = engines(arch=arch)
    cfg = ref.cfg
    s = 14
    if arch == ARCH:
        batch = draw_batch(21, 2, s, cfg)
    else:
        batch = {"tokens": np.random.default_rng(21).integers(
            1, cfg.vocab, (2, s)).astype(np.int32)}
    labels = np.random.default_rng(22).integers(0, cfg.vocab, (2, s))
    labels[0, :3] = -1                      # masked positions
    batch["labels"] = labels.astype(np.int32)
    want = np.asarray(ref.score(batch), np.float32)
    got = mine.score(batch)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# What the VLM and mode ``train`` refuse
# ---------------------------------------------------------------------------
def test_pools_and_scheduler_refuse_the_vlm():
    _, _, _, pcfg, port = smoke_models()
    engine = ServingEngine(pcfg, port, ServeConfig(max_len=64,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="families"):
        engine.new_pool(2)
    with pytest.raises(ValueError, match="families"):
        Scheduler(engine)
    for pool in (KVCachePool, PagedKVPool):
        with pytest.raises(ValueError, match="families"):
            pool(pcfg, 2, 64, device="cpu")
    cache = T.init_cache(pcfg, 1, 16, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.long)
    patches = torch.zeros((1, pcfg.n_patches, pcfg.d_model))
    with pytest.raises(ValueError, match="prefill"):
        T.forward(pcfg, port, tokens, cache=cache, cache_index=0,
                  mode="prefill_chunk")
    with pytest.raises(ValueError, match="patches"):
        T.forward(pcfg, port, tokens, cache=cache, cache_index=0,
                  mode="prefill")
    with pytest.raises(ValueError, match="patches"):
        T.forward(pcfg, port, tokens[:, :1], cache=cache, cache_index=8,
                  mode="decode", patches=patches)
    with pytest.raises(ValueError, match="patches"):
        engine.generate({"tokens": tokens.numpy()}, max_new_tokens=2)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-7b"])
def test_train_mode_refuses_moe_and_recurrent_families(arch):
    pcfg = port_config(arch, smoke=True)
    params = T.build_params(pcfg, C.QuantMaker(0, device="cpu"))
    with pytest.raises(NotImplementedError, match="train"):
        T.forward(pcfg, params, torch.ones((1, 4), dtype=torch.long),
                  cache=None, cache_index=0, mode="train")
