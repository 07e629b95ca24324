"""The port's codecs against the JAX reference: packing, weight decode and
quantization, KV quantization (including the E4M3 subnormal flush) and the
KV cache writes are exact; the precision policy resolves like the
reference's.  Inputs come from numpy with fixed seeds."""
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
