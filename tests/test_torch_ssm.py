"""The port's recurrent layers (``repro_torch.models.ssm``) against the JAX
reference's (``repro/models/ssm.py``) on the same seeded numpy inputs, on
the CPU through the kernels' plain versions; the reference runs meshless
with its Pallas kernels in interpret mode:

* ``ssd_naive``, ``ssd_chunked`` and ``ssd_step`` continuing a chunked run,
  with ``normalize`` False (Mamba-2) and True (mLSTM): outputs and states
  within rtol / atol 1e-5 (f32 throughout; exp and sums are each
  platform's own); at chunk 128, where the reference's normalized chunked
  form underflows to 0 / 0 (ROADMAP R13), the port's within 1e-5 of the
  scale of the sequential form's;
* ``causal_conv1d`` with and without a conv state: bit for bit against
  the reference run op by op (every bf16 product and sum rounded);
* ``mamba2_forward`` (zamba2-smoke, awq_int4), ``mlstm_forward`` and
  ``slstm_forward`` (xlstm-smoke, W8A8) on the reference's weights
  through the bridge, in the three forms the reference picks by S (S = 32:
  chunked, S = 20: sequential, then S = 1 with the state: one step):
  the reference run op by op (jitted, XLA keeps the conv's bf16 products
  and sums in f32: ROADMAP R6's pattern); the bf16 outputs within rtol
  2^-7 (two bf16 ulps) and atol 2^-8 of the output's scale (a one-ulp
  rounding flip of an out-projection input spreads over its row; the
  packed matmul's rtol 2e-3 / atol 1e-3 bounds its f32 outputs, not a
  bf16 result), f32 states within 1e-5, conv states bit for bit;
* the bridge both ways on both trees (packed words, int8 codes, scales and
  bf16 tables bit for bit), ``leaf_info`` and ``model_params`` against the
  reference's walks, and ``check_supported`` on the recurrent families.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import declare_execution
from repro.models import common as RC
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.quant.policy import PrecisionPolicy as RefPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import common as C
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.quant.policy import PrecisionPolicy, leaf_info

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _assert_bf16_out(got, want):
    """A block's bf16 output: within two bf16 ulps of each value (rtol
    2^-7) plus 2^-8 of the output's scale (a one-ulp flip of an input of
    the out projection, after an f32 sum in another order, spreads over
    its row)."""
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    cfg = get_config(arch, smoke=True)
    params = RT.build_params(cfg, RC.QuantMaker(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    pcfg = port_config(arch, smoke=True)
    return cfg, params, tree, pcfg, params_from_numpy(pcfg, tree,
                                                       device="cpu")


def _inputs(rng, b, s, nh, dk, dv):
    q, k = (rng.normal(size=(b, s, nh, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, nh, dv)).astype(np.float32)
    lf = -np.log1p(np.exp(-rng.normal(size=(b, s, nh)))).astype(np.float32)
    li = rng.normal(size=(b, s, nh)).astype(np.float32)
    return q, k, v, lf, li


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_states(got, want, tol=F32_TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **tol)


# ---------------------------------------------------------------------------
# The three forms of the recurrence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["naive", "chunked", "step_after_chunked"])
@pytest.mark.parametrize("normalize", [False, True])
def test_ssd_forms_match_reference(normalize, form):
    rng = np.random.default_rng(3 + normalize)
    b, s, nh, dk, dv, chunk = 2, 32, 3, 8, 6, 8
    arrays = _inputs(rng, b, s, nh, dk, dv)
    if form == "naive":
        want_y, want_st = jax.jit(functools.partial(
            RS.ssd_naive, normalize=normalize))(*arrays)
        got_y, got_st = S.ssd_naive(*_torch(*arrays), normalize=normalize)
    else:
        want_y, want_st = jax.jit(functools.partial(
            RS.ssd_chunked, chunk=chunk, normalize=normalize))(*arrays)
        got_y, got_st = S.ssd_chunked(*_torch(*arrays), chunk=chunk,
                                      normalize=normalize)
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), **F32_TOL)
    _assert_states(got_st, want_st)
    if form != "step_after_chunked":
        return
    # three decode steps carrying the chunked run's state on
    for t in range(3):
        step = [a[:, 0] for a in _inputs(rng, b, 1, nh, dk, dv)]
        want_y, want_st = jax.jit(functools.partial(
            RS.ssd_step, normalize=normalize))(want_st, *step)
        got_y, got_st = S.ssd_step(got_st, *_torch(*step),
                                   normalize=normalize)
        np.testing.assert_allclose(_f32(got_y), _f32(want_y), **F32_TOL)
        _assert_states(got_st, want_st)


def test_ssd_chunked_masks_the_overflowing_exponent():
    """A decay of -6 a step makes the intra-chunk exponent reach ~90 above
    the diagonal of a 16-step chunk: exp overflows to inf there, and the
    select drops it (a 0 / 1 multiply would give inf * 0 = NaN)."""
    rng = np.random.default_rng(5)
    q, k, v, lf, li = _inputs(rng, 1, 32, 2, 4, 4)
    lf = np.full_like(lf, -6.0)
    c = np.cumsum(lf[0, :16, 0])
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.float32(li[0, 15, 0] - c[15] + c[0])))
    got, st = S.ssd_chunked(*_torch(q, k, v, lf, li), chunk=16)
    want, want_st = RS.ssd_chunked(q, k, v, lf, li, chunk=16)
    assert torch.isfinite(got).all() and all(torch.isfinite(a).all()
                                             for a in st)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    _assert_states(st, want_st)


def test_ssd_chunked_normalized_survives_a_long_chunk():
    """R13: at chunk 128 with the gates' usual statistics (log-forget about
    -0.7 a step), the reference's normalized chunked form carries exp(L_t)
    ~ e^-90 in both its numerator and its denominator; a flushing platform
    (XLA's CPU, the card) makes the quotient 0 / 0.  The port takes the
    factor out: finite with subnormals flushed too, and the sequential
    form's outputs and state within 1e-5 of their scale."""
    rng = np.random.default_rng(9)
    b, s, nh, d = 1, 256, 2, 16
    q, v = (rng.normal(size=(b, s, nh, d)).astype(np.float32)
            for _ in range(2))
    k = (rng.normal(size=(b, s, nh, d)) / np.sqrt(d)).astype(np.float32)
    lf = -np.log1p(np.exp(-0.5 * rng.normal(size=(b, s, nh)))).astype(
        np.float32)
    li = (0.5 * rng.normal(size=(b, s, nh))).astype(np.float32)
    assert lf[0, :128].sum(axis=0).max() < -87.0      # e^-87: subnormal
    want_y, want_st = jax.jit(functools.partial(
        RS.ssd_naive, normalize=True))(q, k, v, lf, li)
    flushed = torch.set_flush_denormal(True)
    try:
        got_y, got_st = S.ssd_chunked(*_torch(q, k, v, lf, li), chunk=128,
                                      normalize=True)
    finally:
        if flushed:
            torch.set_flush_denormal(False)
    assert torch.isfinite(got_y).all()
    for g, w in zip((got_y, *got_st), (want_y, *want_st)):
        w = _f32(w)
        np.testing.assert_allclose(_f32(g), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_bit_for_bit_op_by_op(with_state):
    rng = np.random.default_rng(7 + with_state)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    w = (rng.normal(size=(4, 12)) * 0.5).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    with jax.disable_jit():
        want, want_st = RS.causal_conv1d(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
            None if st is None else jnp.asarray(st, jnp.bfloat16))
    got, got_st = S.causal_conv1d(_bf16(x), _bf16(w),
                                  None if st is None else _bf16(st))
    assert got.dtype == got_st.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    np.testing.assert_array_equal(_f32(got_st), _f32(want_st))


# ---------------------------------------------------------------------------
# The blocks on the reference's weights
# ---------------------------------------------------------------------------
def _block(kind):
    """(reference forward, reference block cfg, reference leaves, port
    forward, port block cfg, port leaves, d_model)."""
    if kind == "mamba2":
        cfg, params, _, pcfg, port = _smoke("zamba2-7b")
        lp = jax.tree_util.tree_map(lambda a: a[1], params["mamba"])
        return (RS.mamba2_forward, cfg.mamba_cfg(), lp, S.mamba2_forward,
                T.mamba_cfg(pcfg), port.mamba[1].p, cfg.d_model)
    cfg, params, _, pcfg, port = _smoke("xlstm-350m")
    if kind == "mlstm":
        lp = jax.tree_util.tree_map(lambda a: a[1, 0], params["mlstm"])
        return (RS.mlstm_forward, cfg.mlstm_cfg(), lp, S.mlstm_forward,
                T.mlstm_cfg(pcfg), port.mlstm[1].p, cfg.d_model)
    lp = jax.tree_util.tree_map(lambda a: a[1], params["slstm"])
    return (RS.slstm_forward, cfg.slstm_cfg(), lp, S.slstm_forward,
            T.slstm_cfg(pcfg), port.slstm[1].p, cfg.d_model)


def _run_ref(fn, bcfg, lp, x, carry, eager):
    """The reference block, jitted or op by op (``eager``): jitted, XLA
    keeps the conv's bf16 products and sums in f32, which moves a Mamba-2
    block's outputs by up to 4 bf16 ulps and its f32 state by ~1e-3, and
    under W8A8 moves int8 activation codes (ROADMAP R6)."""
    if fn is RS.slstm_forward:
        def run(p, x, st):
            return fn(p, bcfg, x, state=st)
        args = (lp, x, carry)
    else:
        def run(p, x, st, cv):
            return fn(p, bcfg, x, state=st, conv_state=cv)
        args = (lp, x) + (carry if carry is not None else (None, None))
    if eager:
        with jax.disable_jit():
            return run(*args)
    return jax.jit(run)(*args)


def _run_port(fn, bcfg, p, x, carry):
    if fn is S.slstm_forward:
        return fn(p, bcfg, x, state=carry)
    state, conv = carry if carry is not None else (None, None)
    return fn(p, bcfg, x, state=state, conv_state=conv)


def _assert_carry(got, want):
    """States within f32 tolerance; conv states bit for bit."""
    if isinstance(got, S.SLSTMState):
        _assert_states(got, want)
        return
    (gst, gconv), (wst, wconv) = got, want
    _assert_states(gst, wst)
    for g, w in zip(gconv if isinstance(gconv, tuple) else (gconv,),
                    wconv if isinstance(wconv, tuple) else (wconv,)):
        np.testing.assert_array_equal(_f32(g), _f32(w))


@pytest.mark.parametrize("kind,form", [
    ("mamba2", "chunked"), ("mamba2", "naive_then_steps"),
    ("mlstm", "chunked"), ("mlstm", "naive_then_steps"),
    ("slstm", "naive_then_steps")])
def test_block_forward_matches_reference(kind, form):
    """S = 32 takes the chunked form (chunk 16); S = 12 the sequential
    one, then two single-token steps on its state (sLSTM has one form: a
    loop over S).  The W8A8 blocks run the reference's jnp route, whose
    exact int32 sum and epilogue are the Pallas kernel's bit for bit
    (``test_reference_w8a8_routes_agree``).  Every block's reference
    runs op by op (``_run_ref``)."""
    declare_execution(kernel="pallas" if kind == "mamba2" else "jnp")
    eager = True
    rfn, rcfg, lp, pfn, pcfg, pp, d = _block(kind)
    rng = np.random.default_rng({"mamba2": 11, "mlstm": 12,
                                 "slstm": 13}[kind])
    s = 32 if form == "chunked" else 12
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    want, want_c = _run_ref(rfn, rcfg, lp, jnp.asarray(x, jnp.bfloat16),
                            None, eager)
    got, got_c = _run_port(pfn, pcfg, pp, _bf16(x), None)
    assert got.dtype == torch.bfloat16 and got.shape == (2, s, d)
    _assert_bf16_out(got, want)
    _assert_carry(got_c, want_c)
    if form == "chunked":
        return
    for _ in range(2):
        x = rng.normal(size=(2, 1, d)).astype(np.float32)
        want, want_c = _run_ref(rfn, rcfg, lp, jnp.asarray(x, jnp.bfloat16),
                                want_c, eager)
        got, got_c = _run_port(pfn, pcfg, pp, _bf16(x), got_c)
        _assert_bf16_out(got, want)
        _assert_carry(got_c, want_c)


def test_reference_w8a8_routes_agree():
    """The reference's two W8A8 routes (Pallas interpret, jnp) give the
    same bits on an xlstm-smoke leaf: the int32 sum is exact in both and
    the epilogue ``acc * (w_scale * x_scale)`` is associated alike."""
    from repro.kernels.ops import quantized_matmul as ref_qmm
    from repro.quant.schemes import QuantizedLinearWeights, get_scheme
    _, params, _, _, _ = _smoke("xlstm-350m")
    leaf = jax.tree_util.tree_map(lambda a: a[0, 0], params["mlstm"]["w_q"])
    qw = QuantizedLinearWeights(get_scheme(leaf.scheme_name), leaf.packed,
                                leaf.scales, leaf.shape, name=leaf.name)
    x = jnp.asarray(np.random.default_rng(17).normal(
        size=(40, leaf.shape[0])), jnp.bfloat16)
    outs = []
    for mode in ("pallas", "jnp"):
        declare_execution(kernel=mode)
        with jax.disable_jit():
            outs.append(_f32(ref_qmm(x, qw, out_dtype=jnp.float32)))
    np.testing.assert_array_equal(*outs)


def test_softplus_and_log_sigmoid_follow_jax_past_20():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; torch's
    ``F.softplus`` returns x itself past 20."""
    x = np.array([-30.0, -5.0, 0.0, 3.0, 19.5, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(_f32(S.softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    np.testing.assert_allclose(_f32(S.log_sigmoid(torch.from_numpy(x))),
                               np.asarray(jax.nn.log_sigmoid(x)), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# Leaves, bridge, walks
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


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_bridge_round_trip_keeps_every_bit(arch):
    _, _, tree, pcfg, port = _smoke(arch)
    _assert_trees_equal(params_to_numpy(port), tree)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_port_walk_builds_the_reference_leaves(arch):
    """The port's QuantMaker walk gives the reference's tree: the same
    leaves, shapes, dtypes and schemes (draws differ)."""
    _, _, tree, pcfg, _ = _smoke(arch)
    mine = params_to_numpy(T.build_params(pcfg, C.QuantMaker(1,
                                                             device="cpu")))

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
@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_leaf_info_and_policy_match_reference(arch, smoke):
    cfg, pcfg = get_config(arch, smoke=smoke), port_config(arch, smoke=smoke)
    assert leaf_info(pcfg) == ref_leaf_info(cfg)
    assert "lm_head" not in leaf_info(pcfg)
    for weights in ((), (("ssm.*", "fp8"),), (("ssm.w_out", "mxfp4"),)):
        if arch == "xlstm-350m" and weights and weights[0][1] == "mxfp4" \
                and not smoke:
            continue
        mine = PrecisionPolicy(weights=weights).validate_for(pcfg)
        ref = RefPolicy(weights=weights).validate_for(cfg)
        assert mine.resolved_plan(pcfg) == ref.resolved_plan(cfg)
    bad = (("ffn.*", "fp8"),) if arch == "xlstm-350m" \
        else (("ssm.w_up", "fp8"),)
    for policy in (PrecisionPolicy(weights=bad), RefPolicy(weights=bad)):
        with pytest.raises(ValueError, match="matches no leaf"):
            policy.validate_for(pcfg if isinstance(policy, PrecisionPolicy)
                                else cfg)


def test_check_supported_admits_the_recurrent_configs_and_no_more():
    for arch in ("xlstm-350m", "zamba2-7b"):
        for smoke in (False, True):
            T.check_supported(port_config(arch, smoke=smoke))
    xl, zb = port_config("xlstm-350m"), port_config("zamba2-7b")
    for base, bad in ((xl, dict(d_ff=64)), (xl, dict(n_layers=20)),
                      (xl, dict(tie_embeddings=False)),
                      (zb, dict(norm="layer")), (zb, dict(use_mla=True)),
                      (zb, dict(gated_ffn=False, activation="gelu"))):
        with pytest.raises(NotImplementedError, match="recurrent families"):
            T.check_supported(dataclasses.replace(base, **bad))
