"""The port's model layer against the JAX reference at granite-smoke and
minitron-smoke size: the parameter bridge, the numerics helpers, prefill
attention, the non-gated squared-ReLU FFN and the forward pass (prefill
chunk + decode) through the kernels' plain versions."""
import contextlib

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
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch import logit_spread as LS
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import leaf_info

RNG = np.random.default_rng(41)
LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)   # tests/test_kv_quant.py:247


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t) -> np.ndarray:
    return np.asarray(t.to(torch.float32) if torch.is_tensor(t) else t,
                      np.float32)


def _smoke_models(arch):
    cfg = get_config(arch, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    pcfg = port_config(arch, smoke=True)
    return cfg, params, tree, pcfg, params_from_numpy(pcfg, tree,
                                                       device="cpu")


@pytest.fixture(scope="module")
def smoke():
    return _smoke_models("granite-8b")


@pytest.fixture(scope="module")
def minitron():
    return _smoke_models("minitron-8b")


def test_bridge_round_trip_keeps_words_and_bits(smoke):
    _, _, tree, _, port = smoke
    back = params_to_numpy(port)
    for name, leaf in tree["layers"]["attn"].items():
        np.testing.assert_array_equal(back["layers"]["attn"][name].packed,
                                      leaf.packed)
        np.testing.assert_array_equal(back["layers"]["attn"][name].scales,
                                      leaf.scales)
        assert back["layers"]["attn"][name].scheme_name == leaf.scheme_name
    for name, leaf in tree["layers"]["ffn"].items():
        np.testing.assert_array_equal(back["layers"]["ffn"][name].packed,
                                      leaf.packed)
    for key in ("embed", "lm_head"):
        np.testing.assert_array_equal(back[key], tree[key].view(np.int16))
    np.testing.assert_array_equal(back["layers"]["ln1"]["g"],
                                  tree["layers"]["ln1"]["g"])


def test_port_quantmaker_builds_the_reference_leaf_set():
    pcfg = port_config("granite-8b", smoke=True)
    params = T.build_params(pcfg, C.QuantMaker(3, device="cpu"))
    info = leaf_info(pcfg)
    blk = params.layers[0]
    for name, (k, n, scheme) in info.items():
        group, _, leaf = name.partition(".")
        mod = params.lm_head if name == "lm_head" else \
            getattr(blk, group)[leaf]
        if scheme == "bf16":
            assert isinstance(mod, C.DenseLinear)
            assert tuple(mod.weight.shape) == (k, n)
        else:
            assert isinstance(mod, C.QLinear) and mod.shape == (k, n)
            assert mod.scheme_name == scheme
            assert tuple(mod.packed.shape) == (k // 8, n)
    assert len(params.layers) == pcfg.n_layers
    # same seed, same weights
    again = T.build_params(pcfg, C.QuantMaker(3, device="cpu"))
    assert torch.equal(again.layers[1].ffn["w_up"].packed,
                       params.layers[1].ffn["w_up"].packed)


def test_rms_norm_and_rope_match_reference():
    x = RNG.normal(size=(2, 5, 4, 16)).astype(np.float32)
    g = RNG.normal(size=(16,)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    want = RC.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g))
    got = C.rms_norm(_bf16(x), torch.from_numpy(g))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7, atol=1e-6)
    want = RC.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = C.apply_rope(_bf16(x), torch.from_numpy(pos).long())
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("sk,kv_chunk", [(32, 64), (128, 32)])
def test_prefill_attend_matches_reference(sk, kv_chunk):
    """Dense (one score block) and chunked online softmax, causal with a
    chunk offset and a valid length, at bf16 tolerance."""
    b, sq, h, hk, dh, off = 1, 8, 4, 2, 16, 16
    q = RNG.normal(size=(b, sq, h, dh))
    k = RNG.normal(size=(b, sk, hk, dh))
    v = RNG.normal(size=(b, sk, hk, dh))
    valid = np.array([off + sq], np.int32)
    want = RA.attend(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), causal=True, q_offset=off,
                     kv_chunk=kv_chunk, kv_valid_len=jnp.asarray(valid))
    got = A.attend(_bf16(q), _bf16(k), _bf16(v), q_offset=off,
                   kv_chunk=kv_chunk, kv_valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_forward_prefill_chunk_and_decode_match_reference(smoke, tier):
    """One 8-token prefill chunk into a 2-row cache, then 2 decode steps
    (per-row cache index), against the reference forward with its Pallas
    kernels (interpret mode, meshless)."""
    _forward_vs_reference(smoke, tier)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_forward_matches_reference_on_the_w8a8_model(minitron, tier):
    """The same on minitron-smoke (W8A8 linears, squared-ReLU FFN), against
    the reference run op by op (``jax.disable_jit``): the prefill logits
    are then bit for bit the reference's.  Under ``jit`` XLA keeps some
    bf16 intermediates in f32 (excess precision), which moves W8A8
    activation codes: the jitted reference parts from its own op-by-op
    run by up to ~0.1 in the logits at this size (ROADMAP R6)."""
    _forward_vs_reference(minitron, tier, eager=True)


def test_jitted_reference_parts_from_its_op_by_op_run_under_w8a8(minitron):
    """Why the W8A8 comparisons run the reference op by op: jitted, its
    prefill logits differ from its own op-by-op ones (XLA keeps some bf16
    intermediates in f32, and one moved int8 activation code moves the
    output), while the port's equal the op-by-op ones bit for bit."""
    cfg, params, _, pcfg, port = minitron
    declare_execution(kernel="pallas")
    tokens = np.arange(3, 11, dtype=np.int32)[None]

    def ref_logits():
        return np.asarray(RT.forward(
            cfg, params, {"tokens": tokens}, cache=RT.init_cache(cfg, 1, 16),
            cache_index=0, mode="prefill_chunk")[0], np.float32)

    jitted = ref_logits()
    with jax.disable_jit():
        eager = ref_logits()
    got = T.forward(pcfg, port, torch.from_numpy(tokens).long(),
                    cache=T.init_cache(pcfg, 1, 16, device="cpu"),
                    cache_index=0, mode="prefill_chunk")
    assert np.abs(jitted - eager).max() > 0
    np.testing.assert_array_equal(_f32(got), eager)


def _forward_vs_reference(models, tier, eager=False):
    """Prefill then decode, port against reference; ``eager`` runs the
    reference op by op and holds the prefill logits bit for bit."""
    cfg, params, _, pcfg, port = models
    declare_execution(kernel="pallas")
    ref_ctx = jax.disable_jit if eager else contextlib.nullcontext
    tokens = RNG.integers(1, cfg.vocab, (2, 8)).astype(np.int32)
    rcache = RT.init_cache(cfg, 2, 32, kv_dtype=tier)
    pcache = T.init_cache(pcfg, 2, 32, kv_dtype=tier, device="cpu")
    for r in range(2):
        slot = jax.tree_util.tree_map(lambda a: a[:, r:r + 1], rcache)
        with ref_ctx():
            want, _, slot = RT.forward(cfg, params,
                                       {"tokens": tokens[r:r + 1]},
                                       cache=slot, cache_index=0,
                                       mode="prefill_chunk")
        rcache = jax.tree_util.tree_map(
            lambda full, s: full.at[:, r:r + 1].set(s), rcache, slot)
        got = T.forward(pcfg, port, torch.from_numpy(tokens[r:r + 1]).long(),
                        cache=tuple(s[:, r:r + 1] for s in pcache),
                        cache_index=0, mode="prefill_chunk")
        np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL)
        if eager:
            np.testing.assert_array_equal(_f32(got), _f32(want))
    lengths = np.array([8, 8], np.int32)
    toks = np.asarray(want[0, -1:]).argmax(-1).repeat(2).astype(np.int32)
    for _ in range(2):
        with ref_ctx():
            want, _, rcache = RT.forward(cfg, params,
                                         {"tokens": toks[:, None]},
                                         cache=rcache,
                                         cache_index=jnp.asarray(lengths),
                                         mode="decode")
        got = T.forward(pcfg, port, torch.from_numpy(toks[:, None]).long(),
                        cache=pcache,
                        cache_index=torch.from_numpy(lengths).long(),
                        mode="decode")
        np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL)
        lengths += 1
        toks = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)


def test_bridge_round_trip_keeps_w8a8_int8_codes(minitron):
    """Raw int8 codes and per-channel scales of every w8a8 leaf, the
    non-gated FFN's ``w_in`` / ``w_out`` included, bit for bit; the port
    keeps the codes transposed for its kernel."""
    _, _, tree, pcfg, port = minitron
    back = params_to_numpy(port)
    assert set(back["layers"]["ffn"]) == {"w_in", "w_out"}
    for group in ("attn", "ffn"):
        for name, leaf in tree["layers"][group].items():
            got = back["layers"][group][name]
            assert got.packed.dtype == np.int8 and got.scheme_name == "w8a8"
            np.testing.assert_array_equal(got.packed, leaf.packed)
            np.testing.assert_array_equal(got.scales, leaf.scales)
            assert got.shape == tuple(leaf.shape)
    w_in = port.layers[1].ffn["w_in"]
    k, n = w_in.shape
    assert tuple(w_in.packed.shape) == (n, k)
    np.testing.assert_array_equal(w_in.packed.t().numpy(),
                                  tree["layers"]["ffn"]["w_in"].packed[1])
    for key in ("embed", "lm_head"):
        np.testing.assert_array_equal(back[key], tree[key].view(np.int16))


def test_port_quantmaker_builds_the_w8a8_leaf_set():
    pcfg = port_config("minitron-8b", smoke=True)
    params = T.build_params(pcfg, C.QuantMaker(3, device="cpu"))
    blk = params.layers[0]
    for name, (k, n, scheme) in leaf_info(pcfg).items():
        group, _, leaf = name.partition(".")
        mod = params.lm_head if name == "lm_head" else \
            getattr(blk, group)[leaf]
        if scheme == "bf16":
            assert isinstance(mod, C.DenseLinear)
            continue
        assert isinstance(mod, C.QLinear) and mod.scheme_name == "w8a8"
        assert mod.packed.dtype == torch.int8
        assert tuple(mod.packed.shape) == (n, k)           # transposed
        assert tuple(mod.reference_codes().shape) == (k, n)
        assert tuple(mod.scales.shape) == (1, n)


def test_relu2_matches_reference_bitwise():
    x = RNG.normal(size=(3, 7, 64)).astype(np.float32) * 4
    want = RC.activate("relu2", jnp.asarray(x, jnp.bfloat16))
    got = C.activate("relu2", _bf16(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("rows", [1, 8])
def test_non_gated_ffn_block_matches_reference_bitwise(minitron, rows):
    """w_in -> squared ReLU in bf16 -> w_out, both linears W8A8 (one
    activation scale per call), bit for bit in bf16."""
    cfg, params, _, pcfg, port = minitron
    layer = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ffn"])
    x = RNG.normal(size=(rows, 5, cfg.d_model)).astype(np.float32)
    want = RT._ffn_apply(cfg, layer, jnp.asarray(x, jnp.bfloat16))
    got = T._ffn(pcfg, port.layers[0].ffn, _bf16(x), plain=False)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_init_cache_layouts():
    pcfg = port_config("granite-8b", smoke=True)
    k, v = T.init_cache(pcfg, 3, 24, kv_dtype="bf16", device="cpu")
    assert k.shape == (2, 3, 24, 2, 16) and k.dtype == torch.bfloat16
    k, v = T.init_cache(pcfg, 3, 24, kv_dtype="fp8", device="cpu")
    assert k.packed.shape == (2, 3, 24, 2, 4) and k.packed.dtype == torch.int32
    assert k.scales.shape == (2, 3, 24, 2) and k.scheme_name == "fp8"
    assert k[1].packed.shape == (3, 24, 2, 4)


@pytest.mark.parametrize("variant,passes", [
    ("plain_again", True), ("plain_splitk", True), ("plain_splitkv", True),
    ("drop_split", False), ("drop_group", False)])
def test_logit_check_passes_a_reordered_sum_and_fails_planted_faults(
        smoke, variant, passes):
    """The model-phase check of chip_smoke.py, at smoke size on the CPU:
    the plain path summed in another order passes it, a matmul that loses
    a split-K partial or a weight group fails it."""
    _logit_check_variant(smoke, variant, passes)


def _logit_check_variant(models, variant, passes):
    _, _, _, pcfg, port = models
    prompts = torch.as_tensor(RNG.integers(1, pcfg.vocab, (3, 8)))
    want_layers, got_layers = [], []
    want, ids = LS.teacher_forced(pcfg, port, prompts, 2, kv="bf16",
                                  plain=True, max_len=16,
                                  layer_out=want_layers)
    plain, replace = LS.RUNS[variant]
    with LS.plain_ops(replace):
        got, _ = LS.teacher_forced(pcfg, port, prompts, 2, kv="bf16",
                                   plain=plain, max_len=16, feed=ids,
                                   layer_out=got_layers)
    assert want.shape == (3, 3, pcfg.vocab)
    assert len(want_layers) == (3 + 2) * pcfg.n_layers
    res = LS.logit_check(got, want)
    assert res["finite"] and res["logits_ok"] is passes
    spread = LS.layer_spread(got_layers, want_layers, pcfg.n_layers)
    if variant == "plain_again":
        assert res["max_abs_logit_diff"] == 0.0
        assert spread["layer_rel_diff"] == [0.0] * pcfg.n_layers
    if not passes:
        assert min(spread["layer_rel_diff"]) > LS.LOGIT_REL_TOL
    return res


@pytest.mark.parametrize("variant,passes", [
    ("plain_again", True), ("plain_splitk", True), ("plain_splitkv", True),
    ("drop_split", False), ("drop_group", False)])
def test_logit_check_on_w8a8_passes_reordered_sums_and_fails_faults(
        minitron, variant, passes):
    """The same on minitron-smoke: the reordered int32 sum is exact (no
    difference at all), the split-KV attention order passes, a dropped
    K slice or a dropped block of 128 K rows fails."""
    res = _logit_check_variant(minitron, variant, passes)
    if variant == "plain_splitk":
        assert res["max_abs_logit_diff"] == 0.0


def test_witness_rule_takes_a_kernel_spread_only_next_to_its_witness():
    kernels = {"max_abs_logit_diff": 0.31, "logits_ok": False}
    assert LS.witness_check(kernels, {"max_abs_logit_diff": 0.30})
    assert LS.witness_check(kernels, {"max_abs_logit_diff": 0.21})
    assert not LS.witness_check(kernels, {"max_abs_logit_diff": 0.2})
    assert not LS.witness_check(kernels, {"max_abs_logit_diff": 0.0})
