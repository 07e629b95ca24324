"""The port's codecs against the JAX reference: packing, weight decode and
quantization (packed schemes and w8a8's raw int8 codes), per-tensor int8
activation quantization, KV quantization (including the E4M3 subnormal
flush) and the KV cache writes are exact; the configs copy the
reference's; the precision policy resolves like the reference's.  Inputs
come from numpy with fixed seeds."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.packed_matmul import decode_codes_arith
from repro.quant import kv_cache as RKV
from repro.quant import schemes as RS
from repro.quant.pack import pack_codes_np
from repro.quant.policy import PrecisionPolicy as RPolicy
from repro.quant.policy import leaf_info as ref_leaf_info
from repro_torch.configs import get_config as port_config
from repro_torch.quant import kv_cache as KV
from repro_torch.quant import schemes as S
from repro_torch.quant.pack import pack_codes, unpack_codes
from repro_torch.quant.policy import PrecisionPolicy, leaf_info

RNG = np.random.default_rng(23)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _kv_data(b=3, s=24, hk=2, dh=16):
    x = RNG.normal(size=(b, s, hk, dh))
    x *= np.exp(RNG.normal(size=(b, s, hk, 1)))   # spread the group scales
    return x.astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_codes_exact_vs_reference(bits):
    codes = RNG.integers(0, 1 << bits, (64, 24))
    want = pack_codes_np(codes, bits)
    got = pack_codes(_t(codes), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_codes(got, bits).numpy(), codes)


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
def test_decode_codes_every_code_exact(scheme):
    rs, ps = RS.get_scheme(scheme), S.get_scheme(scheme)
    codes = np.arange(1 << rs.weight_bits, dtype=np.int32)
    want = np.asarray(decode_codes_arith(rs, jnp.asarray(codes)))
    got = S.decode_codes(ps, _t(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    # the LUT path of the reference (core.formats codecs) agrees too
    np.testing.assert_array_equal(
        got, np.asarray(RS.decode_codes(rs, jnp.asarray(codes))))


@pytest.mark.parametrize("k,n", [(64, 32), (256, 48), (512, 16)])
def test_quantize_weights_awq_int4_exact(k, n):
    w = (RNG.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    want = RS.quantize_weights(RS.get_scheme("awq_int4"), w)
    packed, scales = S.quantize_weights(S.get_scheme("awq_int4"), _t(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
def test_dequantize_exact(scheme):
    k, n = 256, 32
    w = RNG.normal(size=(k, n)).astype(np.float32)
    qw = RS.quantize_weights(RS.get_scheme(scheme), w)
    want = np.asarray(RS.dequantize(qw, dtype=jnp.float32))
    got = S.dequantize(S.get_scheme(scheme), _t(qw.packed), _t(qw.scales),
                       (k, n))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_pack_unpack_exact():
    codes = RNG.integers(0, 256, (5, 7, 2, 16))
    want = np.asarray(RS.kv_pack_codes(jnp.asarray(codes)))
    got = S.kv_pack_codes(_t(codes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(S.kv_unpack_codes(got).numpy(), codes)


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_kv_quantize_exact(tier):
    x = _kv_data()
    want_p, want_s = RS.kv_quantize(RS.get_kv_scheme(tier), jnp.asarray(x))
    got_p, got_s = S.kv_quantize(S.get_kv_scheme(tier), _t(x))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    want = np.asarray(RS.kv_dequantize(RS.get_kv_scheme(tier), want_p, want_s,
                                       jnp.float32))
    got = S.kv_dequantize(S.get_kv_scheme(tier), got_p, got_s, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp8_encode_flushes_subnormals_like_reference():
    """Around and below the E4M3 min normal 2^-6 the reference flushes to
    signed zero (or rounds up to the min normal); torch's float8 cast would
    keep subnormals.  Also the RN-even tie 61.99 -> 60 and random values
    over the whole clipped range."""
    edge = np.array([0.0, -0.0, 1e-40, 2.0 ** -10, 7.5 * 2.0 ** -10,
                     15.49 * 2.0 ** -10, 15.5 * 2.0 ** -10, 15.51 * 2.0 ** -10,
                     2.0 ** -6, 61.99, 448.0, -448.0], np.float32)
    small = RNG.uniform(-2.0 ** -5, 2.0 ** -5, 4000).astype(np.float32)
    wide = (RNG.normal(size=4000) * np.exp(RNG.normal(size=4000) * 3))
    wide = np.clip(wide, -448, 448).astype(np.float32)
    x = np.concatenate([edge, -edge, small, wide])
    want = np.asarray(RS._encode_fp8_e4m3(jnp.asarray(x)))
    got = S._encode_fp8_e4m3(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    e_field, m_field = (got >> 3) & 0xF, got & 7
    assert not np.any((e_field == 0) & (m_field != 0)), "subnormal code"


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_cache_writes_exact(tier):
    """Prefill slice write then per-row decode writes, in place in the port
    and functional in the reference, leave identical slabs."""
    b, s, hk, dh = 3, 16, 2, 16
    chunk = _kv_data(b=1, s=8, hk=hk, dh=dh)
    rows_vals = _kv_data(b=b, s=1, hk=hk, dh=dh)
    offsets = np.array([8, 3, 15], np.int32)

    ref = RKV.kv_slab_spec((b, s, hk, dh), tier)
    zeros = lambda sd: jnp.zeros(sd.shape, sd.dtype)  # noqa: E731
    if isinstance(ref, RKV.QuantizedKV):
        ref = RKV.QuantizedKV(zeros(ref.packed), zeros(ref.scales), tier)
    else:
        ref = zeros(ref)
    slot = lambda c: c[1:2] if not isinstance(c, RKV.QuantizedKV) else \
        RKV.QuantizedKV(c.packed[1:2], c.scales[1:2], tier)  # noqa: E731
    ref_slot = RKV.cache_write_slice(slot(ref), jnp.asarray(chunk,
                                                            jnp.bfloat16), 4)
    port = KV.kv_slab((b, s, hk, dh), tier, "cpu")
    KV.cache_write_slice(port[1:2], _t(chunk).to(torch.bfloat16), 4)
    ref = RKV.cache_write_rows(
        jnp_set_slot(ref, ref_slot, tier), jnp.asarray(rows_vals, jnp.bfloat16),
        jnp.arange(b), jnp.asarray(offsets))
    KV.cache_write_rows(port, _t(rows_vals).to(torch.bfloat16),
                        torch.arange(b), _t(offsets).long())
    if tier == "bf16":
        np.testing.assert_array_equal(
            port.to(torch.float32).numpy(), np.asarray(ref, np.float32))
    else:
        np.testing.assert_array_equal(port.packed.numpy(),
                                      np.asarray(ref.packed))
        np.testing.assert_array_equal(port.scales.numpy(),
                                      np.asarray(ref.scales))
    np.testing.assert_array_equal(
        KV.cache_read(port, torch.float32).to(torch.float32).numpy(),
        np.asarray(RKV.cache_read(ref, jnp.float32), np.float32))


def jnp_set_slot(full, slot_slab, tier):
    if isinstance(full, RKV.QuantizedKV):
        return RKV.QuantizedKV(full.packed.at[1:2].set(slot_slab.packed),
                               full.scales.at[1:2].set(slot_slab.scales), tier)
    return full.at[1:2].set(slot_slab)


def test_policy_resolves_like_reference():
    cfg, pcfg = get_config("granite-8b", smoke=True), \
        port_config("granite-8b", smoke=True)
    assert leaf_info(pcfg) == ref_leaf_info(cfg)
    weights = (("attn.wo", "fp8"), ("ffn.*", "mxfp4"))
    want = RPolicy(weights=weights, kv="int8").validate_for(cfg)
    got = PrecisionPolicy(weights=weights, kv="int8").validate_for(pcfg)
    assert got.resolved_plan(pcfg) == want.resolved_plan(cfg)
    assert got.kv == want.kv == "int8"


@pytest.mark.parametrize("bad", [
    dict(weights=(("attn.*", "int3"),)),
    dict(kv="int4"),
])
def test_policy_rejects_unknown_names(bad):
    with pytest.raises(ValueError):
        PrecisionPolicy(**bad)


def test_policy_rejects_pattern_matching_no_leaf():
    pcfg = port_config("granite-8b", smoke=True)
    with pytest.raises(ValueError, match="matches no leaf"):
        PrecisionPolicy(weights=(("mlp.*", "fp8"),)).validate_for(pcfg)


# ---------------------------------------------------------------------------
# w8a8: raw int8 weight codes and per-tensor activation codes
# ---------------------------------------------------------------------------
def _w8a8_weights(k, n):
    """Normal weights with crafted columns: column 0 has absmax 127 (scale
    exactly 1, so its x.5 entries are ties), column 1 is all zero (the
    1e-12 absmax floor), column 2 holds both +absmax and -absmax."""
    w = (RNG.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 0] = RNG.integers(-126, 126, k) + 0.5
    w[0, 0] = 127.0
    w[:, 1] = 0.0
    w[1, 2] = -np.abs(w[:, 2]).max()
    w[2, 2] = -w[1, 2]
    return w


@pytest.mark.parametrize("k,n", [(64, 32), (256, 48), (96, 8)])
def test_quantize_weights_w8a8_exact(k, n):
    w = _w8a8_weights(k, n)
    want = RS.quantize_weights(RS.get_scheme("w8a8"), w)
    codes, scales = S.quantize_weights(S.get_scheme("w8a8"), _t(w))
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (k, n)
    assert tuple(scales.shape) == (1, n)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want.scales))
    # ties round half to even; the all-zero column quantizes to 0; the
    # extremes land on +-127 (a symmetric scale never reaches the -128 clip)
    np.testing.assert_array_equal(codes[1:, 0].numpy(),
                                  np.rint(w[1:, 0]).astype(np.int8))
    assert not codes[:, 1].any() and scales[0, 1] > 0
    assert codes[1, 2] == -127 and codes[2, 2] == 127


def _activations(kind):
    if kind == "ties":      # absmax 127: scale exactly 1, x.5 are ties
        x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0],
                      [127.0, 3.5, -3.5, 0.0, 4.5, -4.5, 5.49, -5.51]])
    elif kind == "zero":
        x = np.zeros((3, 16))
    elif kind == "extremes":
        x = RNG.normal(size=(4, 32)) * np.exp(RNG.normal(size=(4, 32)) * 3)
        x[0, 0] = -np.abs(x).max() * 1.5
        x[3, 5] = 1e-30
    else:                   # decode rows / a prefill chunk of activations
        x = RNG.normal(size=(9, 64)) * 3
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "zero", "extremes"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activations_int8_exact(kind, dtype):
    x = _activations(kind)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = _t(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    want_codes, want_scale = RS.quantize_activations_int8(xj)
    codes, scale = S.quantize_activations_int8(xt)
    assert codes.dtype == torch.int8 and codes.shape == xt.shape
    assert scale.dtype == torch.float32 and scale.dim() == 0
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    assert scale.item() == float(want_scale)
    if kind == "ties":
        assert codes[0, :6].tolist() == [0, 2, 2, 0, -2, -2]
    if kind == "zero":
        assert scale.item() == np.float32(1e-12) / np.float32(127)
    if kind == "extremes":
        assert codes.min() == -127


@pytest.mark.parametrize("arch", ["granite-8b", "minitron-8b",
                                  "starcoder2-15b", "nemotron-4-340b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_port_config_copies_the_reference_field_for_field(arch, smoke):
    ref, port = get_config(arch, smoke=smoke), port_config(arch, smoke=smoke)
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(ref, field.name), \
            field.name
    assert port.head_dim == ref.head_dim


def test_policy_resolves_like_reference_on_the_non_gated_ffn():
    cfg, pcfg = get_config("minitron-8b", smoke=True), \
        port_config("minitron-8b", smoke=True)
    info = leaf_info(pcfg)
    assert info == ref_leaf_info(cfg)
    assert {"ffn.w_in", "ffn.w_out"} <= set(info) and "ffn.w_up" not in info
    weights = (("attn.wo", "awq_int4"), ("ffn.w_out", "bf16"))
    want = RPolicy(weights=weights, kv="int8").validate_for(cfg)
    got = PrecisionPolicy(weights=weights, kv="int8").validate_for(pcfg)
    assert got.resolved_plan(pcfg) == want.resolved_plan(cfg)
    assert got.resolved_plan(pcfg)["ffn.w_in"] == "w8a8"


# ---------------------------------------------------------------------------
# mxfp4 / fp8: float codes with power-of-two or per-channel scales
# ---------------------------------------------------------------------------
def _float_weights(k, n, seed):
    """Normal weights with an all-zero column (the 1e-12 absmax floor) and a
    column of tiny values next to one large one (codes that flush to 0)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = rng.normal(size=k).astype(np.float32) * 1e-9
    w[0, 1] = 3.0
    return w


def _near_pow2_absmax(reach=512):
    """Every f32 within ``reach`` ulps of 3 * 2^m for each m that keeps
    absmax at or above the 1e-12 floor and finite: absmax / 6 then lies
    just below, on, or just above each power of two 2^(m-1) it can reach."""
    m = np.arange(-41, 127)
    centre = (3.0 * np.ldexp(1.0, m)).astype(np.float32).view(np.int32)
    bits = centre[:, None] + np.arange(-reach, reach + 1)[None, :]
    a = bits.astype(np.int32).view(np.float32).ravel()
    return a[np.isfinite(a) & (a >= np.float32(1e-12))]


def _near_pow2_leaf(k, absmax, seed):
    """[K, len(absmax)] f32 weights whose every 32-group of column c has
    absmax exactly ``absmax[c]`` (one entry +-absmax, the rest inside)."""
    rng = np.random.default_rng(seed)
    n = absmax.size
    w = (rng.uniform(-0.999, 0.999, size=(k, n)) * absmax).astype(np.float32)
    for g0 in range(0, k, 32):
        rows = g0 + rng.integers(0, min(32, k - g0), n)
        w[rows, np.arange(n)] = absmax * rng.choice([-1, 1], n)
    return w


def _assert_quantized_like_reference(name, w):
    want = RS.quantize_weights(RS.get_scheme(name), w)
    packed, scales = S.quantize_weights(S.get_scheme(name), _t(w))
    assert packed.dtype == torch.int32 and scales.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want.scales))
    return packed, scales


@pytest.mark.parametrize("scheme", ["mxfp4", "fp8"])
@pytest.mark.parametrize("k,n", [(64, 32), (256, 48), (512, 16), (8, 12),
                                 (16, 5), (96, 7)])
def test_quantize_weights_float_schemes_exact(scheme, k, n):
    """Words and scales bit for bit, K a multiple of 32 and K < 32 (one
    group of K), with an all-zero column and tiny values beside a large one."""
    w = _float_weights(k, n, seed=k + n)
    packed, scales = _assert_quantized_like_reference(scheme, w)
    g = S.effective_group(S.get_scheme(scheme).group_size, k)
    assert tuple(scales.shape) == (k // g, n)
    assert not S.unpack_codes(packed, S.get_scheme(scheme).weight_bits)[
        :, 0].any()


@pytest.mark.parametrize("scheme", ["mxfp4", "fp8"])
def test_quantize_weights_absmax_near_powers_of_two_exact(scheme):
    """Columns whose absmax / 6 lies on every f32 of a band around each
    power of two it can reach (and absmax / 448 beside them): mxfp4's
    exponent takes the reference's f32 log2 rounding there."""
    a = _near_pow2_absmax()
    _assert_quantized_like_reference(scheme, _near_pow2_leaf(64, a, seed=61))


def test_pow2_scale_takes_the_reference_f32_log2_rounding():
    """The exponent probe: x = 2^k (1 + j 2^-23), k in -30..9, j in 0..7.
    The reference's f32 log2 rounds 98 of these 320 down to k, so their
    scale stays 2^k where the exact ceil(log2) gives 2^(k+1); the port
    gives the reference's scale on all 320, and on every f32 within 1024
    ulps of each power of two from 2^-44 to 2^125."""
    k, j = np.arange(-30, 10), np.arange(8)
    x = (np.ldexp(1.0, k)[:, None] * (1 + j[None] * 2.0 ** -23)).astype(
        np.float32).ravel()
    want = np.exp2(np.ceil(np.log2(x)))
    exact = np.exp2(np.ceil(np.log2(x.astype(np.float64))))
    assert x.size == 320 and (want != exact).sum() == 98
    np.testing.assert_array_equal(S.pow2_scale(_t(x)).numpy(), want)
    centre = np.ldexp(1.0, np.arange(-44, 126)).astype(np.float32).view(
        np.int32)
    band = (centre[:, None] + np.arange(-1024, 1025)[None]).astype(
        np.int32).view(np.float32).ravel()
    np.testing.assert_array_equal(S.pow2_scale(_t(band)).numpy(),
                                  np.exp2(np.ceil(np.log2(band))))


@pytest.mark.parametrize("scheme", ["mxfp4", "fp8", "awq_int4", "w8a8"])
def test_quantize_weights_in_column_blocks_equals_one_block(scheme,
                                                            monkeypatch):
    """Column blocks (here 3 columns of K = 256, the last one short) give
    the words and scales of the whole leaf quantized at once."""
    w = _float_weights(256, 11, seed=62)
    whole = S.quantize_weights(S.get_scheme(scheme), _t(w))
    monkeypatch.setattr(S, "QUANT_BLOCK_ELEMS", 3 * 256)
    blocks = S.quantize_weights(S.get_scheme(scheme), _t(w))
    for a, b in zip(whole, blocks):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["mxfp4", "fp8"])
@pytest.mark.parametrize("k,n", [(6144, 6144), (6144, 512), (6144, 24576),
                                 (24576, 6144)])
def test_quantize_weights_on_card_equals_cpu(scheme, k, n):
    """starcoder2-15b's leaf shapes quantized on the card, the first
    columns with absmax near 3 * 2^m in every group: words and scales bit
    for bit the CPU's (which the tests above hold to the reference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = torch.from_numpy(_float_weights(k, n, seed=k + n))
    near = _near_pow2_absmax(reach=8)
    near = near[::-(-near.size // min(n, 2048))]
    w[:, :near.size] = _t(_near_pow2_leaf(k, near, seed=n))
    got = S.quantize_weights(S.get_scheme(scheme), w.cuda())
    want = S.quantize_weights(S.get_scheme(scheme), w)
    for g, c in zip(got, want):
        assert torch.equal(g.cpu(), c)


def test_policy_resolves_the_mixed_plan_like_reference_on_starcoder2():
    """fp8 attention and mxfp4 FFN on starcoder2 (GELU, non-gated): every
    leaf name resolves as in the reference, and the plan validates (K of
    every leaf packs whole words and 32-groups)."""
    cfg, pcfg = get_config("starcoder2-15b"), port_config("starcoder2-15b")
    assert leaf_info(pcfg) == ref_leaf_info(cfg)
    weights = (("attn.*", "fp8"), ("ffn.*", "mxfp4"))
    want = RPolicy(weights=weights, kv="fp8").validate_for(cfg)
    got = PrecisionPolicy(weights=weights, kv="fp8").validate_for(pcfg)
    plan = got.resolved_plan(pcfg)
    assert plan == want.resolved_plan(cfg)
    assert {plan[n] for n in ("attn.wq", "attn.wk", "attn.wv", "attn.wo")} \
        == {"fp8"}
    assert plan["ffn.w_in"] == plan["ffn.w_out"] == "mxfp4"
    assert plan["lm_head"] == "bf16"
