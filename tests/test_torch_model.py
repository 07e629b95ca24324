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
from repro.quant.policy import PrecisionPolicy as RPolicy
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch import logit_spread as LS
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import leaf_info

LOGIT_TOL = dict(rtol=5e-2, atol=5e-2)   # tests/test_kv_quant.py:247
# token draws of the W8A8 forward test (ROADMAP P3): 0-7, and 17 and 23,
# where R9's ops move more than one logit at this size
W8A8_DRAWS = (*range(8), 17, 23)
# ROADMAP R9: the prefill logits that the port's own ops move off the op-by-op
# reference's, by (token draw, KV tier, row): at most how many, each by at
# most how much ("ulp": one bf16 ulp of the reference's value).  Every draw
# and row not listed is the reference's bit for bit.
R9_MOVED = {
    # the lm_head's dense dot sums K in another order: single logits
    (0, "int8", 1): (1, "ulp"), (4, "int8", 1): (1, "ulp"),
    (6, "int8", 1): (1, "ulp"), (17, "int8", 1): (2, "ulp"),
    # the final norm's rsqrt moves one position's normalized row
    (17, "bf16", 0): (198, 0.016),
    # layer 1's norm rsqrt moves 62 int8 activation codes and 10 KV codes
    # by one step each, then the lm_head's dot
    (23, "int8", 0): (1651, 0.036),
}
# ROADMAP R9: XLA's CPU ops that the port does not reproduce, by the name
# of the torch function the port calls for each
R9_OPS = {"rsqrt": jax.lax.rsqrt, "sin": jnp.sin, "cos": jnp.cos,
          "matmul": jnp.dot, "exp": jnp.exp, "softmax": jax.nn.softmax,
          "mean": jnp.mean, "sum": jnp.sum}


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f32(t) -> np.ndarray:
    return np.asarray(t.to(torch.float32) if torch.is_tensor(t) else t,
                      np.float32)


@contextlib.contextmanager
def _reference_r9_ops():
    """Inside this context the port's float CPU tensors take XLA's own
    rsqrt, sin, cos, dense dot, exp, softmax, mean and sum, run op by op
    (ROADMAP R9: which bits each gives depends on the CPU model and on the
    shape), so that every other op of the port is held bit for bit."""
    saved = {name: getattr(torch, name) for name in R9_OPS}
    floats = (torch.float32, torch.bfloat16)

    def via_jax(name):
        def op(*args, dim=None, keepdim=False, **kw):
            tensors = [a for a in args if torch.is_tensor(a)]
            if kw or any(a.device.type != "cpu" or a.dtype not in floats
                         for a in tensors):
                more = {} if dim is None else {"dim": dim}
                if keepdim:
                    more["keepdim"] = keepdim
                return saved[name](*args, **more, **kw)
            ins = [jnp.asarray(a.to(torch.float32).numpy()).astype(
                jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
                for a in args]
            more = {} if dim is None else {"axis": dim}
            if keepdim:
                more["keepdims"] = keepdim
            with jax.disable_jit():
                out = R9_OPS[name](*ins, **more)
            out = np.array(out.astype(jnp.float32))
            return torch.from_numpy(out).to(args[0].dtype)
        return op

    try:
        for name in R9_OPS:
            setattr(torch, name, via_jax(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch, name, fn)


def _smoke_models(arch, weights=()):
    cfg = get_config(arch, smoke=True)
    plan = RPolicy(weights=weights).validate_for(cfg).resolved_plan(cfg) \
        if weights else None
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0),
                                                plan=plan))
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
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
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
    rng = np.random.default_rng(42)
    b, sq, h, hk, dh, off = 1, 8, 4, 2, 16, 16
    q = rng.normal(size=(b, sq, h, dh))
    k = rng.normal(size=(b, sk, hk, dh))
    v = rng.normal(size=(b, sk, hk, dh))
    valid = np.array([off + sq], np.int32)
    want = RA.attend(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), causal=True, q_offset=off,
                     kv_chunk=kv_chunk, kv_valid_len=jnp.asarray(valid))
    got = A.attend(_bf16(q), _bf16(k), _bf16(v), q_offset=off,
                   kv_chunk=kv_chunk, kv_valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sk,kv_chunk", [(64, 128), (128, 32)])
def test_prefill_attend_matches_reference_bitwise_op_by_op(sk, kv_chunk):
    """Prefill attention (dense and chunked) on bf16 inputs is the
    reference's op-by-op result bit for bit once the port takes XLA's
    softmax, exp and sum (ROADMAP R9): masks, scaling, the einsums and the
    online-softmax carries are the reference's to the bit."""
    rng = np.random.default_rng(48)
    b, sq, h, hk, dh, off = 4, 16, 8, 2, 16, 16
    q = rng.normal(size=(b, sq, h, dh)) * 2
    k = rng.normal(size=(b, sk, hk, dh)) * 2
    v = rng.normal(size=(b, sk, hk, dh))
    valid = np.array([off + sq, off + sq - 3, off + 1, off + sq], np.int32)
    with jax.disable_jit():
        want = RA.attend(jnp.asarray(q, jnp.bfloat16),
                         jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), causal=True,
                         q_offset=off, kv_chunk=kv_chunk,
                         kv_valid_len=jnp.asarray(valid))
    with _reference_r9_ops():
        got = A.attend(_bf16(q), _bf16(k), _bf16(v), q_offset=off,
                       kv_chunk=kv_chunk, kv_valid_len=torch.from_numpy(valid))
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("name", list(R9_OPS))
def test_reference_r9_ops_part_from_torchs_on_the_cpu(name):
    """Why the bitwise checks hand the port XLA's ops (ROADMAP R9): op by
    op on the CPU each of torch's differs from XLA's in the last bit for
    some inputs, and inside ``_reference_r9_ops`` it is XLA's."""
    rng = np.random.default_rng(49)
    v = (np.abs(rng.normal(size=(1000, 100))) * 10 + 1e-3).astype(np.float32)
    args = (v,)
    kw = {"dim": -1} if name in ("softmax", "mean", "sum") else {}
    if name == "exp":
        args = (v - 20,)
    if name == "matmul":
        args = (v[:8, :64], rng.normal(size=(64, 1024)).astype(np.float32))
    ins = [torch.from_numpy(a) for a in args]
    with jax.disable_jit():
        want = np.asarray(R9_OPS[name](*map(jnp.asarray, args),
                                       **({"axis": -1} if kw else {})))
    assert (getattr(torch, name)(*ins, **kw).numpy() != want).any()
    with _reference_r9_ops():
        np.testing.assert_array_equal(
            getattr(torch, name)(*ins, **kw).numpy(), want)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_forward_prefill_chunk_and_decode_match_reference(smoke, tier):
    """One 8-token prefill chunk into a 2-row cache, then 2 decode steps
    (per-row cache index), against the reference forward with its Pallas
    kernels (interpret mode, meshless)."""
    _forward_vs_reference(smoke, tier, seed=43)


@pytest.mark.parametrize("seed", W8A8_DRAWS)
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_forward_matches_reference_on_the_w8a8_model(minitron, tier, seed):
    """The same on minitron-smoke (W8A8 linears, squared-ReLU FFN), against
    the reference run op by op (``jax.disable_jit``), for several token
    draws.  The prefill logits are the reference's bit for bit except
    where R9_MOVED says, and bit for bit everywhere once the port takes
    XLA's R9 ops: norms, RoPE, attention, the int8 quantizers, the KV
    quantize and the W8A8 matmul are the reference's to the bit.  Under
    ``jit`` XLA keeps some bf16 intermediates in f32 (excess precision),
    which moves W8A8 activation codes: the jitted reference parts from its
    own op-by-op run by up to ~0.1 in the logits at this size (ROADMAP
    R6)."""
    _forward_vs_reference(minitron, tier, seed=seed, eager=True)


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


def _forward_vs_reference(models, tier, seed, eager=False, moved=R9_MOVED):
    """Prefill then decode, port against reference; ``eager`` runs the
    reference op by op and holds the prefill logits bit for bit: the
    port's own except where ``moved`` says, and the port's on XLA's R9 ops
    everywhere."""
    cfg, params, _, pcfg, port = models
    declare_execution(kernel="pallas")
    ref_ctx = jax.disable_jit if eager else contextlib.nullcontext
    tokens = np.random.default_rng(seed).integers(
        1, cfg.vocab, (2, 8)).astype(np.int32)
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
            _assert_moved_only_by_r9(_f32(got), _f32(want),
                                     *moved.get((seed, tier, r), (0, 0)))
            with _reference_r9_ops():
                exact = T.forward(
                    pcfg, port, torch.from_numpy(tokens[r:r + 1]).long(),
                    cache=T.init_cache(pcfg, 1, 32, kv_dtype=tier,
                                       device="cpu"),
                    cache_index=0, mode="prefill_chunk")
            np.testing.assert_array_equal(_f32(exact), _f32(want))
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


def _assert_moved_only_by_r9(got, want, count, bound):
    """At most ``count`` elements differ, each by at most ``bound`` (one
    bf16 ulp of ``want`` for "ulp"); all others are equal bit for bit."""
    moved = got != want
    assert moved.sum() <= count, (moved.sum(), count)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    lim = ulp if bound == "ulp" else np.full_like(want, bound)
    assert (np.abs(got - want)[moved] <= lim[moved]).all()


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
    x = np.random.default_rng(44).normal(size=(3, 7, 64)).astype(
        np.float32) * 4
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
    x = np.random.default_rng(45).normal(
        size=(rows, 5, cfg.d_model)).astype(np.float32)
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
    ("plain_groupk", True), ("drop_split", False), ("drop_group", False)])
def test_logit_check_passes_a_reordered_sum_and_fails_planted_faults(
        smoke, variant, passes):
    """The model-phase check of chip_smoke.py, at smoke size on the CPU:
    the plain path summed in another order passes it, a matmul that loses
    a split-K partial or a weight group fails it."""
    _logit_check_variant(smoke, variant, passes)


def _logit_check_variant(models, variant, passes):
    _, _, _, pcfg, port = models
    prompts = torch.as_tensor(
        np.random.default_rng(46).integers(1, pcfg.vocab, (3, 8)))
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
    ("plain_groupk", True), ("drop_split", False), ("drop_group", False)])
def test_logit_check_on_w8a8_passes_reordered_sums_and_fails_faults(
        minitron, variant, passes):
    """The same on minitron-smoke: the reordered int32 sum is exact (no
    difference at all), the split-KV attention order passes, a dropped
    K slice or a dropped block of 128 K rows fails."""
    res = _logit_check_variant(minitron, variant, passes)
    if variant in ("plain_splitk", "plain_groupk"):   # no packed leaf moves
        assert res["max_abs_logit_diff"] == 0.0


def test_witness_rule_takes_a_kernel_spread_only_next_to_its_witness():
    kernels = {"max_abs_logit_diff": 0.31, "logits_ok": False}
    assert LS.witness_check(kernels, {"max_abs_logit_diff": 0.30})
    assert LS.witness_check(kernels, {"max_abs_logit_diff": 0.21})
    assert not LS.witness_check(kernels, {"max_abs_logit_diff": 0.2})
    assert not LS.witness_check(kernels, {"max_abs_logit_diff": 0.0})
