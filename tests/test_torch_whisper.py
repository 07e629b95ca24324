"""The audio encoder-decoder (whisper-medium's family) in the port against
the JAX reference at whisper-smoke size (2 encoder + 2 decoder blocks,
d_model 64, 8 frames, W8A8 projections and FFN, LayerNorm with a bias,
tied embeddings), on the CPU through the kernels' plain versions.  The
reference's weights come from its seeded ``QuantMaker``; every norm's
gamma and beta are then drawn on its numpy tree (its ``Maker`` makes them
1 and 0, which could not catch a dropped or swapped bias), and both sides
run on that tree, the port's through the bridge.  Under W8A8 the
reference runs op by op (``jax.disable_jit()``: jitted, XLA keeps bf16
intermediates in f32 and moves int8 activation codes, ROADMAP R6) on its
jnp route (``declare_execution(kernel='jnp')``, bit for bit its Pallas
route), and both sides run the same batch (one activation scale a call
over every row, R10):

* the config twin, field for field, and the leaf set, plans and shapes;
* ``layer_norm`` bit for bit once the port takes XLA's mean, sum and
  rsqrt (``_reference_r9_ops``, ROADMAP R9);
* non-causal ``attend`` (the dense path and the chunked one) bit for bit
  op by op under the same ops;
* one encoder block and ``cross_attn_forward`` against the reference's;
* a prefill (encoder over the frames, decoder over the prompt) and 6
  teacher-forced decode steps at bf16 and int8 KV: logits within rtol /
  atol 5e-2, greedy ids equal where the reference's top-2 gap exceeds
  0.1; the port's own prefill + decode against its train logits;
* other frames move the logits, on both sides;
* the bridge round trip keeps every bit, betas included, and a tree key
  the bridge does not map raises.

``test_torch_whisper_serve.py`` holds ``generate``, ``score`` and the
refusals (split out so xdist's ``--dist loadfile`` runs the halves on two
workers).
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import declare_execution
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy, leaf_info
from test_torch_model import _reference_r9_ops

ARCH = "whisper-medium"
TOL = dict(rtol=5e-2, atol=5e-2)
GAP = 0.1
STEPS = 6
# the norms of the audio tree: (stack key or None, norm key)
NORMS = [(None, "ln_f"), (None, "enc_ln_f"), ("enc_layers", "ln1"),
         ("enc_layers", "ln2"), ("dec_layers", "ln1"), ("dec_layers", "ln_x"),
         ("dec_layers", "ln2")]


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def draw_norms(tree: dict, seed: int) -> None:
    """Every LayerNorm's gamma (1 + 0.2 N(0, 1)) and beta (0.2 N(0, 1))
    drawn in place, f32, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for stack, key in NORMS:
        ln = tree[key] if stack is None else tree[stack][key]
        shape = np.shape(ln["g"])
        ln["g"] = (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        ln["b"] = (0.2 * rng.normal(size=shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def smoke_models():
    """(reference config, reference params, numpy tree, port config, port
    params): the reference's seeded weights with drawn norms, on both
    sides."""
    cfg = get_config(ARCH, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    draw_norms(tree, 90)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    pcfg = port_config(ARCH, smoke=True)
    return cfg, params, tree, pcfg, params_from_numpy(pcfg, tree,
                                                      device="cpu")


def draw_batch(seed, rows, s, cfg):
    """{'tokens' [rows, s] int32, 'frames' [rows, n_frames, D] f32} from
    ``default_rng(seed)``, frames at the embedding table's scale."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (rows, s)).astype(np.int32),
            "frames": (rng.normal(size=(rows, cfg.n_frames, cfg.d_model))
                       * 0.02).astype(np.float32)}


def top2_gap(scores: np.ndarray) -> np.ndarray:
    top = np.sort(scores, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def assert_logits(got, want):
    """Within 5e-2, and the same argmax wherever the gap exceeds 0.1;
    returns how many positions the gap decided."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, **TOL)
    decided = top2_gap(want) > GAP
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()
    return int(decided.sum())


# ---------------------------------------------------------------------------
# Config, leaves and the bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_matches_reference_field_for_field(smoke):
    mine, ref = port_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    for field in dataclasses.fields(mine):
        assert getattr(mine, field.name) == getattr(ref, field.name), \
            field.name
    assert mine.head_dim == ref.head_dim
    assert (mine.encoder_layers, mine.n_frames) == \
        ((24, 1500) if not smoke else (2, 8))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_leaf_info_and_plans_match_reference(smoke):
    cfg, pcfg = get_config(ARCH, smoke=smoke), port_config(ARCH, smoke=smoke)
    assert leaf_info(pcfg) == ref_leaf_info(cfg)
    for weights in ((), (("attn.*", "bf16"),), (("ffn.w_out", "fp8"),)):
        mine = PrecisionPolicy(weights=weights, kv="int8").validate_for(pcfg)
        ref = RefPolicy(weights=weights, kv="int8").validate_for(cfg)
        assert mine.resolved_plan(pcfg) == ref.resolved_plan(cfg)


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
    assert got.dtype == want.dtype, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if hasattr(t, "packed"):
        return (np.shape(t.packed), np.shape(t.scales), t.scheme_name,
                tuple(t.shape), t.name)
    a = np.asarray(t)
    return a.shape, a.dtype.itemsize


def test_bridge_round_trip_keeps_every_bit_betas_included():
    _, _, tree, pcfg, port = smoke_models()
    assert "lm_head" not in tree
    back = params_to_numpy(port)
    _assert_trees_equal(back, tree)
    for stack, key in NORMS:          # the drawn betas went across
        ln = back[key] if stack is None else back[stack][key]
        assert np.abs(ln["b"]).max() > 0.05
    # the port's own walk builds the same leaves (the draws differ)
    mine = params_to_numpy(T.build_params(pcfg, C.QuantMaker(1, device="cpu")))
    assert _shapes(mine) == _shapes(tree)
    # the cross-attention's leaves count as attn.*: per name, 2 encoder
    # and 2 x 2 decoder leaves
    names = collections.Counter(n for n, _ in T.linear_leaves(port))
    assert names == {**{f"attn.{k}": 6 for k in ("wq", "wk", "wv", "wo")},
                     "ffn.w_in": 4, "ffn.w_out": 4}


def _with(tree, path, value):
    """A shallow copy of ``tree`` with ``value`` at the key ``path``."""
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _with(tree[path[0]], path[1:], value)
    return out


@pytest.mark.parametrize("arch,path", [
    ("granite-8b", ("layers", "ln1", "b")),
    ("granite-8b", ("ln_f", "b")),
    ("granite-8b", ("layers", "xattn")),
    ("granite-8b", ("enc_pos",)),
    ("zamba2-7b", ("mamba_ln", "b")),
    ("zamba2-7b", ("shared_attn", "ln2", "b")),
    (ARCH, ("enc_layers", "ln1", "scale")),
    (ARCH, ("lm_head",)),
    (ARCH, ("enc_layers", "moe")),
], ids=lambda v: v if isinstance(v, str) else ".".join(v))
def test_bridge_raises_on_a_key_it_does_not_map(arch, path):
    """A norm's beta where the family has RMS norms, a block leaf or table
    the reader does not know: ValueError, never a silent drop."""
    if arch == ARCH:
        tree, pcfg = smoke_models()[2], port_config(ARCH, smoke=True)
    else:
        cfg = get_config(arch, smoke=True)
        tree = jax.tree_util.tree_map(np.asarray, RT.build_params(
            cfg, RC.QuantMaker(jax.random.PRNGKey(0))))
        pcfg = port_config(arch, smoke=True)
    params_from_numpy(pcfg, tree, device="cpu")       # the tree as it is
    with pytest.raises(ValueError, match="no mapping"):
        params_from_numpy(pcfg, _with(tree, path, np.zeros(3, np.float32)),
                          device="cpu")


def test_check_supported_refuses_other_audio_layouts():
    pcfg = port_config(ARCH, smoke=True)
    for change in (dict(norm="rms"), dict(use_rope=True),
                   dict(tie_embeddings=False), dict(encoder_layers=0),
                   dict(encoder_layers=4), dict(n_frames=0)):
        with pytest.raises(NotImplementedError, match="audio"):
            T.check_supported(dataclasses.replace(pcfg, **change))


# ---------------------------------------------------------------------------
# LayerNorm, non-causal attention, one block, cross-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_layer_norm_matches_reference_bitwise(dtype):
    """Bit for bit once the port takes XLA's mean, sum and rsqrt
    (``_reference_r9_ops``); the variance is the sum of squared
    deviations over n (``jnp.var``, correction 0)."""
    rng = np.random.default_rng(91)
    x = (rng.normal(size=(4, 7, 64)) * 3 + 1).astype(np.float32)
    g = (1 + 0.2 * rng.normal(size=64)).astype(np.float32)
    b = (0.2 * rng.normal(size=64)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    with jax.disable_jit():
        want = RC.layer_norm(jnp.asarray(x, jdt), jnp.asarray(g),
                             jnp.asarray(b))
    tx = _bf16(x) if dtype == "bf16" else torch.from_numpy(x)
    with _reference_r9_ops():
        got = C.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # outside it, within a few ulps of the reference's
    got = C.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("sk,kv_chunk", [(8, 64), (128, 64)],
                         ids=["dense", "chunked"])
def test_non_causal_attend_matches_reference_bitwise_op_by_op(sk, kv_chunk):
    """Every key allowed (the encoder's self-attention over its frames):
    one score block at Sk 8, the online softmax over KV chunks at Sk 128,
    bit for bit op by op with XLA's softmax, exp and sum (R9)."""
    rng = np.random.default_rng(92 + sk)
    b, h, hk, dh = 2, 4, 4, 16
    q = rng.normal(size=(b, sk, h, dh)) * 2
    k = rng.normal(size=(b, sk, hk, dh)) * 2
    v = rng.normal(size=(b, sk, hk, dh))
    with jax.disable_jit():
        want = RA.attend(jnp.asarray(q, jnp.bfloat16),
                         jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), causal=False,
                         kv_chunk=kv_chunk)
    with _reference_r9_ops():
        got = A.attend(_bf16(q), _bf16(k), _bf16(v), causal=False,
                       kv_chunk=kv_chunk)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # the causal mask would give other values
    causal = A.attend(_bf16(q), _bf16(k), _bf16(v), kv_chunk=kv_chunk)
    assert not np.allclose(_f32(causal), _f32(want), atol=1e-2)


def _layer(tree, stack, l=0):
    return jax.tree_util.tree_map(lambda a: a[l], tree[stack])


def test_encoder_block_and_cross_attention_match_reference():
    """One encoder block (LayerNorms, non-causal attention, GELU FFN, all
    W8A8) over drawn frames, and the first decoder block's
    cross-attention over that block's output, against the reference's
    ``_tf_block_apply(causal=False)`` / ``cross_attn_forward`` op by op:
    bit for bit with XLA's R9 ops."""
    cfg, params, _, pcfg, port = smoke_models()
    declare_execution(kernel="jnp")
    rng = np.random.default_rng(93)
    x = (rng.normal(size=(2, cfg.n_frames, cfg.d_model))).astype(np.float32)
    dec = (rng.normal(size=(2, 5, cfg.d_model))).astype(np.float32)
    lp, dp = _layer(params, "enc_layers"), _layer(params, "dec_layers")
    with jax.disable_jit():
        want, _, _ = RT._tf_block_apply(cfg, lp, jnp.asarray(x, jnp.bfloat16),
                                        causal=False)
        want_x = RA.cross_attn_forward(dp["xattn"], cfg.attn_cfg(False),
                                       jnp.asarray(dec, jnp.bfloat16), want)
    acfg = dataclasses.replace(T.attn_cfg(pcfg), causal=False)
    with _reference_r9_ops():
        got = T._audio_block(pcfg, port.enc_layers[0], _bf16(x), acfg,
                             A.gqa_forward, cache=None, cache_index=0,
                             enc=None, plain=False)
        got_x = A.cross_attn_forward(port.dec_layers[0].xattn, acfg,
                                     _bf16(dec), got)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert got_x.shape == dec.shape
    np.testing.assert_array_equal(_f32(got_x), _f32(want_x))


# ---------------------------------------------------------------------------
# Teacher-forced prefill and decode
# ---------------------------------------------------------------------------
def port_inputs(batch):
    return (torch.from_numpy(batch["tokens"]).long(),
            torch.from_numpy(batch["frames"]))


def reference_prefill(cfg, params, batch, cache):
    with jax.disable_jit():
        logits, _, cache = RT.forward(
            cfg, params, {"tokens": jnp.asarray(batch["tokens"]),
                          "frames": jnp.asarray(batch["frames"])},
            cache=cache, cache_index=0, mode="prefill")
    return logits, cache


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_prefill_and_decode_match_reference_op_by_op(tier):
    """A prefill of 2 rows (8 frames, 12 tokens) from an empty cache, then
    STEPS decode steps fed the reference's greedy ids; the encoder output
    the prefill writes into the cache is the reference's bit for bit."""
    cfg, params, _, pcfg, port = smoke_models()
    declare_execution(kernel="jnp")
    s = 12
    batch = draw_batch(94, 2, s, cfg)
    rcache = RT.init_cache(cfg, 2, s + STEPS, kv_dtype=tier)
    pcache = T.init_cache(pcfg, 2, s + STEPS, kv_dtype=tier, device="cpu")
    want, rcache = reference_prefill(cfg, params, batch, rcache)
    tokens, frames = port_inputs(batch)
    got = T.forward(pcfg, port, tokens, cache=pcache, cache_index=0,
                    mode="prefill", frames=frames)
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_array_equal(_f32(pcache["enc"]), _f32(rcache["enc"]))
    decided = assert_logits(got[:, -1], want[:, -1])
    for i in range(STEPS):
        ids = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)[:, None]
        with jax.disable_jit():
            want, _, rcache = RT.forward(
                cfg, params, {"tokens": jnp.asarray(ids)}, cache=rcache,
                cache_index=jnp.int32(s + i), mode="decode")
        got = T.forward(pcfg, port, torch.from_numpy(ids).long(),
                        cache=pcache, cache_index=s + i, mode="decode")
        decided += assert_logits(got[:, -1], want[:, -1])
    assert decided >= 1


def test_prefill_then_decode_equals_train_logits():
    """The port alone: a prefill of S - 1 tokens, then token S - 1 decoded
    at position S - 1, against mode ``train`` over the S tokens at its
    last row (the encoder run in both)."""
    cfg, _, _, pcfg, port = smoke_models()
    s = 10
    tokens, frames = port_inputs(draw_batch(95, 2, s, cfg))
    full = T.forward(pcfg, port, tokens, cache=None, cache_index=0,
                     mode="train", frames=frames)
    assert full.shape == (2, s, cfg.vocab)
    cache = T.init_cache(pcfg, 2, s, device="cpu")
    T.forward(pcfg, port, tokens[:, :-1], cache=cache, cache_index=0,
              mode="prefill", frames=frames)
    dec = T.forward(pcfg, port, tokens[:, -1:], cache=cache,
                    cache_index=s - 1, mode="decode")
    np.testing.assert_allclose(_f32(dec[:, 0]), _f32(full[:, -1]), **TOL)


def test_other_frames_move_the_logits_on_both_sides():
    """Frames of another seed move the first token's logits on both sides
    (a dropped encoder or cross-attention would not), each side still
    within 5e-2 of the other."""
    cfg, params, _, pcfg, port = smoke_models()
    declare_execution(kernel="jnp")
    batch = draw_batch(96, 2, 6, cfg)
    other = dict(batch, frames=draw_batch(97, 2, 6, cfg)["frames"])
    outs = []
    for b in (batch, other):
        want, _ = reference_prefill(cfg, params, b, RT.init_cache(cfg, 2, 6))
        tokens, frames = port_inputs(b)
        got = T.forward(pcfg, port, tokens,
                        cache=T.init_cache(pcfg, 2, 6, device="cpu"),
                        cache_index=0, mode="prefill", frames=frames)
        assert_logits(got[:, -1], want[:, -1])
        outs.append((_f32(got[:, -1]), _f32(want[:, -1])))
    scale = np.abs(outs[0][1]).max()
    for side in (0, 1):
        assert np.abs(outs[0][side] - outs[1][side]).max() > 0.05 * scale


def test_forward_refuses_misplaced_frames_and_modes():
    _, _, _, pcfg, port = smoke_models()
    cache = T.init_cache(pcfg, 1, 8, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.long)
    frames = torch.zeros((1, pcfg.n_frames, pcfg.d_model))
    with pytest.raises(ValueError, match="frames"):
        T.forward(pcfg, port, tokens, cache=cache, cache_index=0,
                  mode="prefill")
    with pytest.raises(ValueError, match="frames"):
        T.forward(pcfg, port, tokens[:, :1], cache=cache, cache_index=4,
                  mode="decode", frames=frames)
    with pytest.raises(ValueError, match="prefill"):
        T.forward(pcfg, port, tokens, cache=cache, cache_index=0,
                  mode="prefill_chunk")
    with pytest.raises(ValueError, match="int index"):
        T.forward(pcfg, port, tokens[:, :1], cache=cache,
                  cache_index=torch.tensor([4]), mode="decode")
    gcfg = port_config("granite-8b", smoke=True)
    gparams = T.build_params(gcfg, C.QuantMaker(0, device="cpu"))
    with pytest.raises(ValueError, match="frames"):
        T.forward(gcfg, gparams, tokens, cache=None, cache_index=0,
                  mode="train", frames=frames)
