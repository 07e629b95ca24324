"""The port's float packed models against the JAX reference at smoke
size: starcoder2-smoke (mxfp4, non-gated GELU FFN), nemotron-smoke (mxfp4,
squared ReLU) and starcoder2-smoke under fp8 attention / mxfp4 FFN
weights.  GELU on every bf16 input, the GELU FFN block, the bridge and
the port's QuantMaker on mxfp4 / fp8 leaves, and the forward pass
(prefill chunk + decode) in the three KV tiers through the kernels'
plain versions.  Helpers from ``test_torch_model.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import declare_execution
from repro.models import common as RC
from repro.models import transformer as RT
from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy, leaf_info
from test_torch_model import (LOGIT_TOL, _bf16, _f32, _forward_vs_reference,
                              _smoke_models)

# the mixed plan of the float packed schemes: fp8 attention, mxfp4 FFN
MIXED_WEIGHTS = (("attn.*", "fp8"), ("ffn.*", "mxfp4"))
# ROADMAP R9 on these models (token draw 64), by test id: the prefill
# logits the port's lm_head dense dot (K summed in another order) moves
# off the op-by-op reference's, by (draw, KV tier, row): how many, by how
# much; all others are the reference's bit for bit
R9_MOVED_FLOAT = {
    "starcoder2-15b": {(64, "int8", 1): (1, "ulp")},
    "nemotron-4-340b": {(64, "int8", 0): (1, "ulp")},
    "mixed": {(64, "int8", 0): (1, "ulp"), (64, "fp8", 0): (1, "ulp")},
}


@pytest.fixture(scope="module")
def starcoder2():
    return _smoke_models("starcoder2-15b")


# ---------------------------------------------------------------------------
def _all_finite_bf16() -> np.ndarray:
    f = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return f[np.isfinite(f)]


def test_gelu_matches_reference_on_every_bf16_input():
    """``activate('gelu')`` is ``jax.nn.gelu`` bit for bit on all 65,280
    finite bf16 inputs but 508, where the exact result lies below the f32
    normal range: XLA's CPU flushes it to zero, torch keeps it (a
    subnormal, or 2^-126 after rounding)."""
    x = _all_finite_bf16()
    want = _f32(RC.activate("gelu", jnp.asarray(x, jnp.bfloat16)))
    got = C.activate("gelu", _bf16(x))
    assert got.dtype == torch.bfloat16
    got = _f32(got)
    moved = got.view(np.uint32) != want.view(np.uint32)
    assert x.size == 65_280 and moved.sum() == 508
    assert (want[moved] == 0).all()
    assert (np.abs(got[moved]) <= 2.0 ** -126).all()


def test_fused_tanh_gelu_misses_the_reference():
    """Why ``activate('gelu')`` runs op by op: torch's fused
    ``gelu(approximate='tanh')`` rounds once, in f32, and differs from
    ``jax.nn.gelu`` on 1,518 finite bf16 inputs, by more than FTZ."""
    x = _all_finite_bf16()
    want = _f32(RC.activate("gelu", jnp.asarray(x, jnp.bfloat16)))
    fused = _f32(torch.nn.functional.gelu(_bf16(x), approximate="tanh"))
    moved = fused != want
    assert moved.sum() == 1_518
    assert np.abs(fused - want)[moved].max() > 2.0 ** -126


@pytest.mark.parametrize("rows", [1, 8])
def test_non_gated_gelu_ffn_block_matches_reference_bitwise(starcoder2, rows):
    """w_in -> GELU in bf16 (no f32 cast) -> w_out, both linears mxfp4
    through the reference's Pallas kernel (interpret mode) and the port's
    plain version, bit for bit in bf16."""
    cfg, params, _, pcfg, port = starcoder2
    declare_execution(kernel="pallas")
    layer = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["ffn"])
    x = np.random.default_rng(63).normal(
        size=(rows, 5, cfg.d_model)).astype(np.float32)
    want = RT._ffn_apply(cfg, layer, jnp.asarray(x, jnp.bfloat16))
    got = T._ffn(pcfg, port.layers[0].ffn, _bf16(x), plain=False)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("case", list(R9_MOVED_FLOAT))
def test_forward_matches_reference_on_float_packed_models(case, tier):
    """One prefill chunk and 2 decode steps on starcoder2-smoke (mxfp4,
    GELU), nemotron-smoke (mxfp4, squared ReLU, d_ff 256) and
    starcoder2-smoke under fp8 attention / mxfp4 FFN, against the
    reference forward with its Pallas kernels (interpret mode) run op by
    op: the prefill logits are the reference's bit for bit but where
    R9_MOVED_FLOAT says, and everywhere on XLA's R9 ops.  (Under ``jit``
    XLA keeps some bf16 intermediates in f32, which moves fp8 KV codes:
    see the test below.)"""
    arch, weights = (("starcoder2-15b", MIXED_WEIGHTS) if case == "mixed"
                     else (case, ()))
    _forward_vs_reference(_smoke_models(arch, weights), tier, seed=64,
                          eager=True, moved=R9_MOVED_FLOAT[case])


def test_jitted_reference_parts_from_its_op_by_op_run_under_fp8_kv(
        starcoder2):
    """Why the fp8-KV comparisons run the reference op by op: jitted, its
    prefill logits on starcoder2-smoke part from its own op-by-op ones by
    more than the 5e-2 tolerance (a K or V value kept in f32 lands on
    another fp8 code), while the port's equal the op-by-op ones bit for
    bit."""
    cfg, params, _, pcfg, port = starcoder2
    declare_execution(kernel="pallas")
    tokens = np.random.default_rng(43).integers(
        1, cfg.vocab, (1, 8)).astype(np.int32)

    def ref_logits():
        return np.asarray(RT.forward(
            cfg, params, {"tokens": tokens},
            cache=RT.init_cache(cfg, 1, 32, kv_dtype="fp8"), cache_index=0,
            mode="prefill_chunk")[0], np.float32)

    jitted = ref_logits()
    with jax.disable_jit():
        eager = ref_logits()
    got = T.forward(pcfg, port, torch.from_numpy(tokens).long(),
                    cache=T.init_cache(pcfg, 1, 32, kv_dtype="fp8",
                                       device="cpu"),
                    cache_index=0, mode="prefill_chunk")
    assert np.abs(jitted - eager).max() > LOGIT_TOL["atol"]
    np.testing.assert_array_equal(_f32(got), eager)


@pytest.mark.parametrize("weights", [(), MIXED_WEIGHTS],
                         ids=["mxfp4", "fp8_attn_mxfp4_ffn"])
def test_bridge_round_trip_keeps_float_packed_leaves(weights):
    """starcoder2-smoke (GELU config) under its mxfp4 plan and under the
    mixed plan: every leaf's int32 words, f32 scales and scheme, the
    tables and norms, bit for bit through the port and back."""
    _, _, tree, pcfg, port = _smoke_models("starcoder2-15b", weights)
    assert pcfg.activation == "gelu" and not pcfg.gated_ffn
    back = params_to_numpy(port)
    want_schemes = {"attn": "fp8" if weights else "mxfp4", "ffn": "mxfp4"}
    for group in ("attn", "ffn"):
        for name, leaf in tree["layers"][group].items():
            got = back["layers"][group][name]
            assert got.scheme_name == leaf.scheme_name == want_schemes[group]
            assert got.packed.dtype == np.int32
            assert got.scales.dtype == np.float32
            np.testing.assert_array_equal(got.packed, leaf.packed)
            np.testing.assert_array_equal(got.scales, leaf.scales)
    for key in ("embed", "lm_head"):
        np.testing.assert_array_equal(back[key], tree[key].view(np.int16))
    np.testing.assert_array_equal(back["layers"]["ln2"]["g"],
                                  tree["layers"]["ln2"]["g"])


@pytest.mark.parametrize("arch,weights", [
    ("starcoder2-15b", ()), ("nemotron-4-340b", ()),
    ("starcoder2-15b", MIXED_WEIGHTS)])
def test_port_quantmaker_builds_the_float_packed_leaf_set(arch, weights):
    """The port's QuantMaker quantizes mxfp4 and fp8 leaves itself, on the
    reference's leaf names and shapes: int32 words [K/per, N], scales
    [K/32, N] (mxfp4, powers of two) or [1, N] (fp8)."""
    pcfg = port_config(arch, smoke=True)
    plan = PrecisionPolicy(weights=weights).validate_for(pcfg) \
        .resolved_plan(pcfg)
    params = T.build_params(pcfg, C.QuantMaker(3, device="cpu", plan=plan))
    blk = params.layers[0]
    assert set(blk.ffn) == {"w_in", "w_out"}
    for name, (k, n, _) in leaf_info(pcfg).items():
        group, _, leaf = name.partition(".")
        mod = params.lm_head if name == "lm_head" else \
            getattr(blk, group)[leaf]
        if plan[name] == "bf16":
            assert isinstance(mod, C.DenseLinear)
            continue
        assert isinstance(mod, C.QLinear) and mod.scheme_name == plan[name]
        per = 8 if plan[name] == "mxfp4" else 4
        assert tuple(mod.packed.shape) == (k // per, n)
        assert mod.packed.dtype == torch.int32
        if plan[name] == "mxfp4":
            assert tuple(mod.scales.shape) == (k // 32, n)
            mant, _ = torch.frexp(mod.scales)
            assert (mant == 0.5).all()
        else:
            assert tuple(mod.scales.shape) == (1, n)
