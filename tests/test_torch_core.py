"""The port's XtraMAC core (``repro_torch.core``) against the reference's
(``repro.core``), bit for bit (tolerance 0: every value compared is an
integer bit pattern, or a float64 compared by its bits).

Same seeded numpy inputs into both; the port runs on the CPU, where its
Stage-2 multiply takes the virtual-DSP kernel's plain version:
  * formats: every codec on every bit pattern of each <= 16-bit format,
    ``quantize_f64`` on seeded values with +/-0, +/-inf, NaN, subnormals,
    overflow and round-to-even ties;
  * ``solve_lane_plan`` for every pair of ``REGISTRY`` formats, capped at 4
    and uncapped: the same plan, or both raise;
  * ``xtramac`` on the combinations of tests/test_mac_bitexact.py at its
    sizes (exhaustive where it is), its directed special values and
    ``xtramac_switching``; ``ref_mac.mac_exact_vec`` on samples;
  * ``packed_multiply`` / ``xtramac_packed`` on the combinations of
    tests/test_packing.py, and the packed path against ``per_lane_reference``;
  * ``XtraMACPipeline`` results issue by issue;
  * the resource model's tables, calibration and estimates, and the GEMV
    engine's Table VII.
Tests marked ``gpu`` run the datapath through the CUDA kernel on a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import formats as RF
from repro.core import gemv_engine as RG
from repro.core import mac as RM
from repro.core import packing as RP
from repro.core import pipeline as RPL
from repro.core import ref_mac as RR
from repro.core import resource_model as RRM
from repro_torch import core
from repro_torch.core import formats as F
from repro_torch.core import gemv_engine as G
from repro_torch.core import mac as M
from repro_torch.core import packing as P
from repro_torch.core import pipeline as PL
from repro_torch.core import ref_mac as R
from repro_torch.core import resource_model as RMOD
from repro_torch.kernels import ops

FORMATS = sorted(F.REGISTRY)
SMALL_FORMATS = [n for n in FORMATS if F.REGISTRY[n].bits <= 16]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


def _f64_bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(np.int64)


def _rand_bits(rng, fmt, n):
    return rng.integers(0, 1 << fmt.bits, size=n, dtype=np.int64)


def _patterns(fmt, seed=0):
    """Every bit pattern of a <= 16-bit format; else 65,536 seeded ones
    plus the all-zeros and all-ones words."""
    if fmt.bits <= 16:
        return np.arange(1 << fmt.bits, dtype=np.int64)
    rng = np.random.default_rng(seed)
    return np.concatenate([_rand_bits(rng, fmt, 1 << 16),
                           [0, (1 << fmt.bits) - 1]])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FORMATS)
def test_format_codecs_on_every_bit_pattern(name):
    fmt, rfmt = F.REGISTRY[name], RF.REGISTRY[name]
    assert dataclasses.asdict(fmt) == dataclasses.asdict(rfmt)
    assert (fmt.bits, fmt.is_float, fmt.magnitude_bits) == \
        (rfmt.bits, rfmt.is_float, rfmt.magnitude_bits)
    bits = _patterns(fmt)
    tb = _t(bits)
    np.testing.assert_array_equal(
        _f64_bits(fmt.decode_to_f64(tb).numpy()),
        _f64_bits(rfmt.decode_to_f64(bits)))
    if fmt.is_float:
        for got, want in zip(fmt.fields(tb), rfmt.fields(bits)):
            np.testing.assert_array_equal(got.numpy(), want)
        for fn in ("is_nan", "is_inf", "is_zero_daz"):
            np.testing.assert_array_equal(getattr(fmt, fn)(tb).numpy(),
                                          getattr(rfmt, fn)(bits))
        for prop in ("bias", "exp_max_field", "max_unbiased_exp",
                     "min_unbiased_exp", "max_finite"):
            assert getattr(fmt, prop) == getattr(rfmt, prop), prop
        for sign in (0, 1):
            assert fmt.max_finite_bits(sign) == rfmt.max_finite_bits(sign)
            if fmt.special_rule == "ieee":
                assert fmt.inf_bits(sign) == rfmt.inf_bits(sign)
        if fmt.special_rule != "none":
            assert fmt.qnan_bits == rfmt.qnan_bits
        # encode of the decoded fields (normal codes) re-packs the pattern
        s, e, m = rfmt.fields(bits)
        e_u = e - rfmt.bias
        m_full = m | (1 << rfmt.man_bits)
        np.testing.assert_array_equal(
            fmt.encode(_t(s), _t(e_u), _t(m_full)).numpy(),
            rfmt.encode(s, e_u, m_full))
        assert fmt.encode(1, 3, 5) == int(rfmt.encode(1, 3, 5))
    else:
        assert (fmt.min_value, fmt.max_value) == (rfmt.min_value,
                                                  rfmt.max_value)
        span = 1 << min(fmt.bits, 16)
        ints = np.concatenate([np.arange(-span, span, dtype=np.int64),
                               [fmt.min_value - 1, fmt.max_value + 1,
                                -(1 << 62), 1 << 62]])
        np.testing.assert_array_equal(fmt.encode_from_int(_t(ints)).numpy(),
                                      rfmt.encode_from_int(ints))
    # round trip through quantize_f64, and the exhaustive enumerator
    vals = rfmt.decode_to_f64(bits)
    np.testing.assert_array_equal(
        F.quantize_f64(fmt, torch.from_numpy(vals)).numpy(),
        RF.quantize_f64(rfmt, vals))
    if fmt.bits <= 16:
        np.testing.assert_array_equal(
            F.all_bit_patterns(fmt, device="cpu").numpy(),
            RF.all_bit_patterns(rfmt))
    else:
        with pytest.raises(ValueError):
            F.all_bit_patterns(fmt, device="cpu")


def _quantize_inputs(rfmt, seed):
    """Seeded float64 values: wide-exponent randoms, specials, subnormals,
    overflow, and the midpoints of the format's finite grid (ties)."""
    rng = np.random.default_rng(seed)
    wide = rng.normal(size=4000) * np.exp2(rng.integers(-160, 160, 4000))
    near = rng.normal(size=4000) * 4.0
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                         5e-324, -5e-324, 1e-310, 2.0 ** -1022, 1e308,
                         -1e308, 1.7976931348623157e308, 0.5, -0.5, 1.5,
                         2.5, -2.5, 2.0 ** 63, -2.0 ** 63, 1e30, -1e30])
    if rfmt.is_float:
        specials = np.concatenate([specials, [rfmt.max_finite * s * k
                                   for s in (1, -1)
                                   for k in (1.0, 1.0001, 1.5, 2.0, 0.9999)]])
    grid = []
    if rfmt.bits <= 16:
        v = rfmt.decode_to_f64(RF.all_bit_patterns(rfmt))
        v = np.unique(v[np.isfinite(v)])
        grid = (v[1:] + v[:-1]) / 2
    return np.concatenate([wide, near, specials, grid])


@pytest.mark.parametrize("name", FORMATS)
def test_quantize_f64_specials_ties_and_overflow(name):
    fmt, rfmt = F.REGISTRY[name], RF.REGISTRY[name]
    vals = _quantize_inputs(rfmt, seed=7)
    with np.errstate(invalid="ignore", over="ignore"):
        want = RF.quantize_f64(rfmt, vals)
    got = F.quantize_f64(fmt, torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    # numpy and Python inputs are made on the requested device
    np.testing.assert_array_equal(
        F.quantize_f64(fmt, vals[:50], device="cpu").numpy(), want[:50])


def test_exp2i_is_exact_over_the_normal_range():
    k = torch.arange(-1022, 1024)
    np.testing.assert_array_equal(F.exp2i(k).numpy(),
                                  np.ldexp(1.0, k.numpy()))
    x = torch.tensor([5e-324, 3.0, 0.75], dtype=torch.float64)
    kk = torch.tensor([1097, -1070, 1])
    np.testing.assert_array_equal(F.ldexp_exact(x, kk).numpy(),
                                  np.ldexp(x.numpy(), kk.numpy()))


def test_get_format_unknown_name_raises():
    with pytest.raises(KeyError):
        F.get_format("int9")


# ---------------------------------------------------------------------------
# Stage 1 and the exhaustive / randomized MAC combinations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SMALL_FORMATS)
def test_map_operand_every_bit_pattern(name):
    bits = np.arange(1 << F.REGISTRY[name].bits, dtype=np.int64)
    got = M.map_operand(F.REGISTRY[name], _t(bits))
    want = RM.map_operand(RF.REGISTRY[name], bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _grid(a, b, c_fmt, rng):
    A, B = np.meshgrid(a, b, indexing="ij")
    return A.ravel(), B.ravel(), _rand_bits(rng, c_fmt, A.size)


def _case_inputs(case, rng):
    """Inputs of the tests/test_mac_bitexact.py case ``case``, same sizes."""
    cfg = RM.MacConfig.make(*case[1])
    kind = case[0]
    if kind == "exhaustive_a":          # A exhaustive x 4096 (B, C) draws
        a = np.arange(1 << cfg.fmt_a.bits, dtype=np.int64)
        b = _rand_bits(rng, cfg.fmt_b, 4096)
        c = _rand_bits(rng, cfg.fmt_c, 4096)
        A, B = np.meshgrid(a, b, indexing="ij")
        return cfg, A.ravel(), B.ravel(), np.broadcast_to(c, A.shape).ravel()
    if kind == "exhaustive_ab":
        a = np.arange(1 << cfg.fmt_a.bits, dtype=np.int64)
        b = np.arange(1 << cfg.fmt_b.bits, dtype=np.int64)
        return (cfg, *_grid(a, b, cfg.fmt_c, rng))
    n = case[2]
    return (cfg, _rand_bits(rng, cfg.fmt_a, n), _rand_bits(rng, cfg.fmt_b, n),
            _rand_bits(rng, cfg.fmt_c, n))


MAC_CASES = [
    ("exhaustive_a", ("fp4_e2m1", "bf16", "bf16", "bf16")),
    ("exhaustive_ab", ("fp8_e4m3", "fp8_e4m3", "bf16", "bf16")),
    ("random", ("fp8_e5m2", "fp8_e5m2", "fp16", "fp16"), 50_000),
    ("exhaustive_a", ("int4", "bf16", "bf16", "bf16")),
    ("exhaustive_ab", ("int8", "int8", "int32", "int32")),
    ("random", ("bf16", "bf16", "bf16", "bf16"), 200_000),
    ("random", ("fp16", "fp16", "fp16", "fp16"), 200_000),
    ("random", ("bf16", "bf16", "fp32", "fp32"), 100_000),
    ("random", ("int2", "bf16", "bf16", "bf16"), 30_000),
    ("random", ("int3", "bf16", "bf16", "bf16"), 30_000),
    ("random", ("int5", "fp16", "fp16", "fp16"), 30_000),
    ("random", ("int6", "bf16", "bf16", "bf16"), 30_000),
    ("random", ("int7", "fp16", "fp16", "fp16"), 30_000),
    ("random", ("int8", "bf16", "bf16", "bf16"), 30_000),
    ("random", ("fp4_e2m1", "fp4_e2m1", "bf16", "bf16"), 30_000),
    ("random", ("fp8_e4m3", "bf16", "bf16", "bf16"), 30_000),
    ("random", ("fp8_e4m3", "fp16", "fp16", "fp16"), 30_000),
]


@pytest.mark.parametrize("case", MAC_CASES,
                         ids=lambda c: f"{c[0]}-{'x'.join(c[1])}")
def test_xtramac_equals_reference(case):
    rng = np.random.default_rng(11)
    rcfg, a, b, c = _case_inputs(case, rng)
    cfg = M.MacConfig.make(*case[1])
    assert cfg.name == rcfg.name
    got = M.xtramac(cfg, _t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(got, RM.xtramac(rcfg, a, b, c))
    # and the port's exact oracle on a sample
    idx = rng.choice(a.size, 300, replace=False)
    np.testing.assert_array_equal(
        got[idx], R.mac_exact_vec(cfg.fmt_a, cfg.fmt_b, cfg.fmt_c, cfg.fmt_p,
                                  a[idx], b[idx], c[idx]))


def test_int32_saturation_equals_reference():
    cfg = M.MacConfig.make("int8", "int8", "int32", "int32")
    a = np.full(4, 0x80, dtype=np.int64)
    b = np.full(4, 0x80, dtype=np.int64)
    c = np.array([0x7FFFFFFF, 0x7FFF0000, 0x80000000, 0], dtype=np.int64)
    got = M.xtramac(cfg, _t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(
        got, RM.xtramac(RM.MacConfig.make("int8", "int8", "int32", "int32"),
                        a, b, c))
    np.testing.assert_array_equal(got, R.mac_exact_vec(
        "int8", "int8", "int32", "int32", a, b, c))


def test_special_values_directed_equal_reference():
    bf = F.BF16
    qnan, pinf, ninf = bf.qnan_bits, bf.inf_bits(0), bf.inf_bits(1)
    one, sub = 0x3F80, 0x0001
    cases = [
        (qnan, one, one), (one, qnan, one), (one, one, qnan),
        (pinf, 0, one),
        (pinf, one, ninf), (ninf, one, pinf),
        (pinf, one, one), (one, one, pinf), (ninf, one, one),
        (sub, one, one), (one, sub, one), (one, one, sub),
        (0x0080, 0x0080, 0),
        (bf.max_finite_bits(0), bf.max_finite_bits(0), 0),
        (one, one, one | 0x8000),
    ]
    a, b, c = (np.array(x, dtype=np.int64) for x in zip(*cases))
    for combo in (("bf16",) * 4, ("bf16", "bf16", "bf16", "fp8_e4m3"),
                  ("bf16", "bf16", "bf16", "fp4_e2m1")):
        got = M.xtramac(M.MacConfig.make(*combo), _t(a), _t(b), _t(c)).numpy()
        np.testing.assert_array_equal(
            got, RM.xtramac(RM.MacConfig.make(*combo), a, b, c))
        if combo[3] != "fp4_e2m1":      # the oracle has no NaN code for fp4
            np.testing.assert_array_equal(got,
                                          R.mac_exact_vec(*combo, a, b, c))


def test_xtramac_switching_equals_reference():
    rng = np.random.default_rng(12)
    combos = [("int4", "bf16", "bf16", "bf16"), ("bf16", "bf16", "bf16", "bf16")]
    n = 10_000
    a, b, c = (_rand_bits(rng, RF.BF16, n) for _ in range(3))
    sel = rng.integers(0, 2, size=n)
    got = M.xtramac_switching([M.MacConfig.make(*x) for x in combos],
                              _t(sel), _t(a), _t(b), _t(c)).numpy()
    np.testing.assert_array_equal(got, RM.xtramac_switching(
        [RM.MacConfig.make(*x) for x in combos], sel, a, b, c))


def test_numpy_inputs_are_made_on_the_requested_device():
    cfg = M.MacConfig.make("int4", "bf16", "bf16", "bf16")
    got = M.xtramac(cfg, np.array([3]), np.array([0x3FC0]),
                    np.array([0x3E80]), device="cpu")
    assert got.device.type == "cpu"
    assert F.BF16.decode_to_f64(got).item() == 4.75     # 3 * 1.5 + 0.25


@pytest.mark.parametrize("combo", [("fp8_e4m3", "fp8_e4m3", "bf16", "bf16"),
                                   ("int8", "int8", "int32", "int32"),
                                   ("fp4_e2m1", "bf16", "bf16", "fp16")])
def test_mac_exact_vec_equals_reference_on_samples(combo):
    rng = np.random.default_rng(13)
    fa, fb, fc, _ = (F.REGISTRY[x] for x in combo)
    a, b, c = (_rand_bits(rng, f, 2000) for f in (fa, fb, fc))
    np.testing.assert_array_equal(R.mac_exact_vec(*combo, a, b, c),
                                  RR.mac_exact_vec(*combo, a, b, c))
    for x in (a[0], b[0]):
        got = R.decode_value(combo[0], x)
        want = RR.decode_value(combo[0], x)
        assert got == want or (np.isnan(got) and np.isnan(want))


# ---------------------------------------------------------------------------
# the lane-plan solver and the packed path
# ---------------------------------------------------------------------------
def _plan_fields(plan):
    return (plan.fmt_a.name, plan.fmt_b.name, plan.w_a, plan.w_b, plan.stride,
            plan.offsets_a, plan.offsets_b, plan.guard, plan.l_a, plan.l_b,
            plan.w_lane, plan.parallelism, plan.lane_positions,
            plan.dsp_utilization)


@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("fmt_a", FORMATS)
def test_solve_lane_plan_every_registry_pair(fmt_a, cap):
    for fmt_b in FORMATS:
        try:
            want = _plan_fields(RP.solve_lane_plan(fmt_a, fmt_b,
                                                   max_parallelism=cap))
        except AssertionError:
            with pytest.raises(AssertionError):
                P.solve_lane_plan(fmt_a, fmt_b, max_parallelism=cap)
            continue
        got = _plan_fields(P.solve_lane_plan(fmt_a, fmt_b,
                                             max_parallelism=cap))
        assert got == want, (fmt_a, fmt_b, cap)


def test_packing_constants_equal_reference():
    assert P.PAPER_PARALLELISM == RP.PAPER_PARALLELISM
    assert P.SOLVER_BEYOND_PAPER == RP.SOLVER_BEYOND_PAPER
    assert (P.DSP48E2_LA, P.DSP48E2_LB, P.DSP48E2_WMUL) == \
        (RP.DSP48E2_LA, RP.DSP48E2_LB, RP.DSP48E2_WMUL)
    for name in FORMATS:
        assert P.max_magnitude(F.REGISTRY[name]) == \
            RP.max_magnitude(RF.REGISTRY[name])


def test_solver_beyond_paper_is_a_lower_bound():
    """The uncapped solver finds more lanes than SOLVER_BEYOND_PAPER records
    for FP4xFP4 (8, not 6) and INT2xBF16 (4, not 3); the reference's tests
    check only >=, and both solvers agree."""
    found = {pair: P.solve_lane_plan(*pair).parallelism
             for pair in P.SOLVER_BEYOND_PAPER}
    assert found == {("fp4_e2m1", "fp4_e2m1"): 8, ("fp4_e2m1", "bf16"): 3,
                     ("int2", "bf16"): 4}
    assert found == {pair: RP.solve_lane_plan(*pair).parallelism
                     for pair in RP.SOLVER_BEYOND_PAPER}


def test_utilization_models_equal_reference():
    pairs = [("int4", "bf16"), ("fp8_e4m3", "fp8_e4m3"), ("fp4_e2m1", "bf16"),
             ("int8", "int8"), ("bf16", "bf16"), ("int8", "fp16")]
    for pair in pairs:
        assert P.utilization_xtramac(*pair) == RP.utilization_xtramac(*pair)
        for up in ("bf16", "fp32"):
            assert P.utilization_upcast(*pair, up) == \
                RP.utilization_upcast(*pair, up)
    assert P.utilization_spatial(pairs) == RP.utilization_spatial(pairs)
    assert P.utilization_temporal_bf16_over_int8() == \
        RP.utilization_temporal_bf16_over_int8()


PACKED_PLANS = ([(pair, 4) for pair in sorted(RP.PAPER_PARALLELISM)]
                + [(pair, None) for pair in sorted(RP.SOLVER_BEYOND_PAPER)]
                + [(("fp32", "int16"), None), (("fp16", "fp16"), None)])


@pytest.mark.parametrize("pair,cap", PACKED_PLANS,
                         ids=lambda x: "x".join(x) if isinstance(x, tuple)
                         else str(x))
def test_packed_multiply_equals_reference(pair, cap):
    rng = np.random.default_rng(14)
    plan = P.solve_lane_plan(*pair, max_parallelism=cap)
    rplan = RP.solve_lane_plan(*pair, max_parallelism=cap)
    n_a, n_b = len(plan.offsets_a), len(plan.offsets_b)
    a = rng.integers(0, 1 << plan.w_a, size=(20_000, n_a), dtype=np.int64)
    b = rng.integers(0, 1 << plan.w_b, size=(20_000, n_b), dtype=np.int64)
    want = RP.packed_multiply(rplan, a, b)
    np.testing.assert_array_equal(
        P.packed_multiply(plan, _t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(
        P.packed_multiply(plan, _t(a), _t(b), plain=True).numpy(), want)
    np.testing.assert_array_equal(P.pack_port(plan.offsets_a, _t(a)).numpy(),
                                  RP.pack_port(rplan.offsets_a, a))
    # leading dimensions are kept
    np.testing.assert_array_equal(
        P.packed_multiply(plan, _t(a).reshape(100, 200, n_a),
                          _t(b).reshape(100, 200, n_b)).numpy(),
        want.reshape(100, 200, -1))


def test_lane_isolation_exhaustive_fp8():
    plan = P.solve_lane_plan("fp8_e4m3", "fp8_e4m3", max_parallelism=4)
    n_a = len(plan.offsets_a)
    mags = np.arange(16)
    grids = np.meshgrid(*([mags] * (n_a + len(plan.offsets_b))), indexing="ij")
    a = np.stack(grids[:n_a], axis=-1).reshape(-1, n_a)
    b = np.stack(grids[n_a:], axis=-1).reshape(-1, len(plan.offsets_b))
    prods = P.packed_multiply(plan, _t(a), _t(b)).numpy()
    for lane, (i, j, _) in enumerate(plan.lane_positions):
        np.testing.assert_array_equal(prods[..., lane], a[:, i] * b[:, j])


PACKED_COMBOS = [
    ("int4", "bf16", "bf16", "bf16"),
    ("fp8_e4m3", "fp8_e4m3", "bf16", "bf16"),
    ("bf16", "bf16", "bf16", "bf16"),
    ("int8", "int8", "int32", "int32"),
    ("fp4_e2m1", "bf16", "bf16", "bf16"),
    ("fp8_e4m3", "fp16", "fp16", "fp16"),
]


def _packed_inputs(cfg, plan, n, rng):
    a = rng.integers(0, 1 << cfg.fmt_a.bits, size=(n, len(plan.offsets_a)),
                     dtype=np.int64)
    b = rng.integers(0, 1 << cfg.fmt_b.bits, size=(n, len(plan.offsets_b)),
                     dtype=np.int64)
    c = rng.integers(0, 1 << min(cfg.fmt_c.bits, 32),
                     size=(n, plan.parallelism), dtype=np.int64)
    return a, b, c


@pytest.mark.parametrize("combo", PACKED_COMBOS, ids="x".join)
def test_xtramac_packed_equals_reference_and_per_lane(combo):
    rng = np.random.default_rng(15)
    cfg, rcfg = M.MacConfig.make(*combo), RM.MacConfig.make(*combo)
    plan = P.solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
    rplan = RP.solve_lane_plan(rcfg.fmt_a, rcfg.fmt_b, max_parallelism=4)
    a, b, c = _packed_inputs(cfg, plan, 5_000, rng)
    want = RP.xtramac_packed(rcfg, rplan, a, b, c)
    for plain in (False, True):
        got = P.xtramac_packed(cfg, plan, _t(a), _t(b), _t(c), plain=plain)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        P.per_lane_reference(cfg, plan, _t(a), _t(b), _t(c)).numpy(),
        RP.per_lane_reference(rcfg, rplan, a, b, c))
    np.testing.assert_array_equal(want, RP.per_lane_reference(
        rcfg, rplan, a, b, c))


def test_package_exports_match_reference():
    import repro.core as ref_core
    names = [n for n in dir(ref_core) if not n.startswith("_")
             and not isinstance(getattr(ref_core, n), type(dataclasses))]
    assert names and all(hasattr(core, n) for n in names)


# ---------------------------------------------------------------------------
# the cycle-level pipeline
# ---------------------------------------------------------------------------
def _ops(cfgs, plans, sels, rng, op_cls):
    ops_ = []
    for sel in sels:
        cfg, plan = cfgs[sel], plans[sel]
        ops_.append(op_cls(
            int(sel),
            rng.integers(0, 1 << cfg.fmt_a.bits, size=len(plan.offsets_a)),
            rng.integers(0, 1 << cfg.fmt_b.bits, size=len(plan.offsets_b)),
            rng.integers(0, 1 << min(cfg.fmt_c.bits, 32),
                         size=plan.parallelism)))
    return ops_


@pytest.mark.parametrize("stage_cycles", [(1, 1, 1, 1), (1, 1, 3, 1)])
def test_pipeline_issue_by_issue_equals_reference(stage_cycles):
    combos = [("int8", "int8", "int32", "int32"), ("bf16",) * 4,
              ("fp8_e4m3", "fp8_e4m3", "bf16", "bf16"),
              ("fp4_e2m1", "bf16", "bf16", "bf16")]
    pipe = PL.XtraMACPipeline([M.MacConfig.make(*c) for c in combos],
                              stage_cycles, device="cpu")
    rpipe = RPL.XtraMACPipeline([RM.MacConfig.make(*c) for c in combos],
                                stage_cycles)
    assert (pipe.latency, pipe.parallelism) == (rpipe.latency,
                                                rpipe.parallelism)
    rng = np.random.default_rng(16)
    ops_ = _ops(rpipe.configs, rpipe.plans,
                [i % len(combos) for i in range(60)], rng, RPL.Op)
    schedule = ops_[:20] + [None, None] + ops_[20:] + [None] * pipe.latency
    for op in schedule:
        got = pipe.step(None if op is None else PL.Op(
            op.dtype_sel, op.a_bits, op.b_bits, op.c_bits))
        want = rpipe.step(op)
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    assert pipe.cycle == rpipe.cycle == len(schedule)


def test_pipeline_run_launches_nothing_on_the_cpu():
    cfgs = [M.MacConfig.make("int4", "bf16", "bf16", "bf16"),
            M.MacConfig.make("bf16", "bf16", "bf16", "bf16")]
    pipe = PL.XtraMACPipeline(cfgs, device="cpu")
    rng = np.random.default_rng(17)
    ops_ = _ops(cfgs, pipe.plans, [i % 2 for i in range(16)], rng, PL.Op)
    before = ops.launch_counts()["virtual_dsp_multiply"]
    results = pipe.run(ops_)
    assert ops.launch_counts()["virtual_dsp_multiply"] == before
    assert len(results) == len(ops_)
    for op, got in zip(ops_, results):
        want = P.per_lane_reference(
            cfgs[op.dtype_sel], pipe.plans[op.dtype_sel], _t(op.a_bits)[None],
            _t(op.b_bits)[None], _t(op.c_bits)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the analytic models
# ---------------------------------------------------------------------------
def test_resource_model_tables_and_calibration_equal_reference():
    assert RMOD.TABLE_III == {k: RMOD.Resources(*dataclasses.astuple(v))
                              for k, v in RRM.TABLE_III.items()}
    for key, (vendor, ours) in RRM.TABLE_IV.items():
        assert dataclasses.astuple(RMOD.TABLE_IV[key][0]) == \
            dataclasses.astuple(vendor)
        assert dataclasses.astuple(RMOD.TABLE_IV[key][1]) == \
            dataclasses.astuple(ours)
    assert {d: {k: dataclasses.astuple(v) for k, v in row.items()}
            for d, row in RMOD.TABLE_V.items()} == \
        {d: {k: dataclasses.astuple(v) for k, v in row.items()}
         for d, row in RRM.TABLE_V.items()}
    assert RMOD.PAPER_MEAN_REDUCTION == RRM.PAPER_MEAN_REDUCTION
    assert RMOD.FMAX_SCALING_MHZ == RRM.FMAX_SCALING_MHZ
    for n in range(0, 6):
        assert RMOD.fmax_mhz(n) == RRM.fmax_mhz(n)
    for n in (1, 512, 1024, 1500, 1920, 4000):
        assert RMOD.system_fmax_mhz(n) == RRM.system_fmax_mhz(n)
    assert RMOD.CALIBRATION_R2 == RRM.CALIBRATION_R2
    np.testing.assert_array_equal(RMOD._LUT_COEF, RRM._LUT_COEF)
    np.testing.assert_array_equal(RMOD._FF_COEF, RRM._FF_COEF)


@pytest.mark.parametrize("fmt_a,fmt_bcp", [
    ("int8", "bf16"), ("int8", "fp16"), ("fp4_e2m1", "bf16"),
    ("fp4_e2m1", "fp16"), ("fp8_e4m3", "bf16"), ("fp8_e4m3", "fp16"),
    ("int4", "bf16"), ("fp8_e5m2", "bf16"), ("bf16", "bf16")])
def test_resource_model_estimates_equal_reference(fmt_a, fmt_bcp):
    """Table IV per-lane costs and compute density where measured, the
    parametric model where not (Fig. 8 / Table IV / V numbers)."""
    for fn in ("xtramac_per_lane", "vendor_per_lane"):
        assert dataclasses.astuple(getattr(RMOD, fn)(fmt_a, fmt_bcp)) == \
            dataclasses.astuple(getattr(RRM, fn)(fmt_a, fmt_bcp))
    assert RMOD.compute_density(fmt_a, fmt_bcp) == \
        RRM.compute_density(fmt_a, fmt_bcp)
    combos = [(fmt_a, fmt_bcp, fmt_bcp, fmt_bcp), ("bf16",) * 4]
    got = RMOD.estimate_instance([M.MacConfig.make(*c) for c in combos])
    want = RRM.estimate_instance([RM.MacConfig.make(*c) for c in combos])
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(RMOD.analyze_instance(
        [M.MacConfig.make(*c) for c in combos])) == dataclasses.astuple(
        RRM.analyze_instance([RM.MacConfig.make(*c) for c in combos]))


def test_gemv_engine_table_vii_equals_reference():
    assert G.table_vii() == RG.table_vii()
    cfg, rcfg = G.GemvEngineConfig(), RG.GemvEngineConfig()
    assert (cfg.n_mac_per_channel, cfg.n_instances, cfg.freq_hz,
            cfg.macs_per_cycle) == (rcfg.n_mac_per_channel, rcfg.n_instances,
                                    rcfg.freq_hz, rcfg.macs_per_cycle)
    for m in (1, 8, 64):
        for k, n in ((4096, 4096), (4096, 12288)):
            assert G.gemv_latency_s(cfg, m, k, n) == \
                RG.gemv_latency_s(rcfg, m, k, n)
    per = RMOD.Resources(436, 302, 1)
    assert dataclasses.astuple(G.resource_scaling(per, 1920)) == \
        dataclasses.astuple(RG.resource_scaling(RRM.Resources(436, 302, 1),
                                                1920))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("combo", PACKED_COMBOS, ids="x".join)
def test_datapath_on_card_equals_plain_and_cpu(cuda_device, combo):
    """xtramac_packed through the kernel on the card == the plain path on
    the card == the CPU run, bit for bit; one kernel launch per call."""
    rng = np.random.default_rng(18)
    cfg = M.MacConfig.make(*combo)
    plan = P.solve_lane_plan(cfg.fmt_a, cfg.fmt_b, max_parallelism=4)
    a, b, c = (_t(x) for x in _packed_inputs(cfg, plan, 50_000, rng))
    want = P.xtramac_packed(cfg, plan, a, b, c).numpy()
    before = ops.launch_counts()["virtual_dsp_multiply"]
    got = P.xtramac_packed(cfg, plan, a.to(cuda_device), b.to(cuda_device),
                           c.to(cuda_device))
    assert ops.launch_counts()["virtual_dsp_multiply"] == before + 1
    plain = P.xtramac_packed(cfg, plan, a.to(cuda_device), b.to(cuda_device),
                             c.to(cuda_device), plain=True)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(plain.cpu().numpy(), want)


@pytest.mark.gpu
def test_pipeline_on_card_equals_cpu(cuda_device):
    cfgs = [M.MacConfig.make("int4", "bf16", "bf16", "bf16"),
            M.MacConfig.make("bf16", "bf16", "bf16", "bf16")]
    card = PL.XtraMACPipeline(cfgs, device=cuda_device)
    host = PL.XtraMACPipeline(cfgs, device="cpu")
    ops_ = _ops(cfgs, host.plans, [i % 2 for i in range(16)],
                np.random.default_rng(19), PL.Op)
    before = ops.launch_counts()["virtual_dsp_multiply"]
    got = card.run(ops_)
    assert ops.launch_counts()["virtual_dsp_multiply"] == before + len(ops_)
    for g, w in zip(got, host.run(ops_)):
        np.testing.assert_array_equal(g, w)
