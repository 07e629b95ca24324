"""The port's kernels against the JAX reference's Pallas kernels.

On the CPU the wrappers take their plain versions; those are held against
the reference kernels run in interpret mode and against the reference's
jnp oracles:
  * packed GEMV / matmul (all three packed schemes) at the tolerance of the
    reference's kernel tests (rtol 2e-3, atol 1e-3: f32 sums in another
    order, see ROADMAP R1);
  * the w8a8 int8 matmul bit for bit (its int32 sums are exact);
  * decode attention (bf16 / int8 / fp8 slabs) to one bf16 ulp (rtol
    2^-7): both round an f32 result to bf16 — also with zero-length rows,
    which attend their whole slab with equal weights;
  * the virtual-DSP lane multiply (K6) bit for bit, against the reference
    kernel in interpret mode and its int64 oracle, for every paper
    datatype pair.
Tests marked ``gpu`` run the CUDA kernels against the plain versions and
skip when no card is present.
"""
from ctypes import sizeof as ctypes_sizeof

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import gqa_decode_attention as ref_decode
from repro.kernels.ops import quantized_matmul as ref_quantized_matmul
from repro.kernels.packed_matmul import decode_codes_arith
from repro.kernels.packed_matmul import packed_gemv as ref_gemv
from repro.kernels.packed_matmul import packed_matmul as ref_matmul
from repro.kernels.packed_matmul import w8a8_matmul as ref_w8a8
from repro.kernels.xtramac_mac import virtual_dsp_multiply as ref_vdsp
from repro.core import packing as RP
from repro.quant import kv_cache as RKV
from repro.quant import schemes as RS
from repro_torch.core import packing as P
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import packed_matmul as PM
from repro_torch.kernels import w8a8_matmul as W8
from repro_torch.kernels import xtramac_mac as XM
from repro_torch.quant import schemes as S
from repro_torch.quant.kv_cache import QuantizedKV
from repro_torch.quant.pack import unpack_codes

RNG = np.random.default_rng(31)
MM_TOL = dict(rtol=2e-3, atol=1e-3)
ATTN_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _weights(scheme, k, n):
    w = (RNG.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return RS.quantize_weights(RS.get_scheme(scheme), w)


# ---------------------------------------------------------------------------
# packed GEMV / matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 512, 256), (16, 256, 128),
                                   (64, 512, 128)])
def test_packed_matmul_plain_vs_reference_kernel(scheme, m, k, n):
    qw = _weights(scheme, k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref_fn = ref_gemv if m <= 8 else ref_matmul
    want_kernel = np.asarray(ref_fn(xj, qw, interpret=True))
    want_oracle = np.asarray(ref.packed_matmul_ref(xj, qw))
    port_fn = PM.packed_gemv if m <= 8 else PM.packed_matmul
    got = port_fn(_bf16(x), _t(qw.packed), _t(qw.scales),
                  S.get_scheme(scheme)).numpy()
    np.testing.assert_allclose(got, want_kernel, **MM_TOL)
    np.testing.assert_allclose(got, want_oracle, **MM_TOL)


def test_quantized_matmul_dispatch_keeps_leading_dims():
    qw = _weights("awq_int4", 256, 64)
    x = _bf16(RNG.normal(size=(2, 3, 256)))
    scheme = S.get_scheme("awq_int4")
    out = ops.quantized_matmul(x, _t(qw.packed), _t(qw.scales), scheme)
    assert out.shape == (2, 3, 64) and out.dtype == torch.bfloat16
    plain = PM.packed_matmul_plain(x.reshape(6, 256), _t(qw.packed),
                                   _t(qw.scales), scheme)
    torch.testing.assert_close(out.reshape(6, 64), plain.to(torch.bfloat16),
                               rtol=0, atol=0)
    assert sum(ops.launch_counts().values()) == 0   # plain calls never count


@pytest.mark.parametrize("m,k,n,scheme", [(1, 4096, 1024, "awq_int4"),
                                          (8, 14336, 4096, "awq_int4"),
                                          (8, 4096, 14336, "fp8"),
                                          (3, 4096, 4096, "mxfp4")])
def test_gemv_split_plan_covers_k_within_shared_memory(m, k, n, scheme):
    sch = S.get_scheme(scheme)
    kps, splits = PM.gemv_plan(m, k, n, sch)
    assert (splits - 1) * kps < k <= splits * kps
    assert m * kps <= 11776                        # staged x fits its budget
    assert PM.gemv_smem_bytes(m, kps, sch) <= 227 * 1024
    assert -(-n // 128) * splits >= 132


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m,k,n", [(8, 14336, 4096), (8, 4096, 14336),
                                   (1, 4096, 1024), (8, 4096, 1024),
                                   (3, 4096, 4096), (1, 14336, 4096),
                                   (8, 72, 8)])
def test_gemv_plan_fills_the_card_in_whole_stages_and_groups(scheme, m, k, n):
    """K1's launch plan, a plain function of shapes: whole ring stages
    (128 K for 4-bit codes, 64 for fp8) and whole scale groups per split;
    four blocks' shared memory fit one SM (228 KB; 1 KB reserved and the
    barriers per block) at every shape, K = 14336 and M = 8 included, so a
    grid of up to 528 blocks is resident at once; at most 32 splits for
    the last block to sum in order; at least 132 blocks wherever K has 33
    stages (N = 1024 included)."""
    sch = S.get_scheme(scheme)
    kps, splits = PM.gemv_plan(m, k, n, sch)
    stage = 128 if sch.weight_bits == 4 else 64
    group = S.effective_group(sch.group_size, k)
    assert kps % stage == 0 and (group == k or kps % group == 0)
    assert (splits - 1) * kps < k <= splits * kps
    assert 4 * (PM.gemv_smem_bytes(m, kps, sch) + 1024 + 128) <= 228 * 1024
    blocks = -(-n // 128) * splits
    assert blocks <= 528 and splits <= 32
    if k >= 33 * stage:
        assert blocks >= 132
    assert PM.gemv_plan(m, k, n, sch) == (kps, splits)


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(256, 128), (4096, 128)])
def test_gemv_grouped_association_vs_reference_kernel(scheme, m, k, n):
    """K1's association and split order (per scale group x @ codes in f32
    times the group's scale, groups then splits summed in order) against
    the reference's interpret-mode GEMV and its jnp oracle."""
    qw = _weights(scheme, k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want_kernel = np.asarray(ref_gemv(xj, qw, interpret=True))
    want_oracle = np.asarray(ref.packed_matmul_ref(xj, qw))
    got = PM.packed_gemv_ordered(_bf16(x), _t(qw.packed), _t(qw.scales),
                                 S.get_scheme(scheme)).numpy()
    np.testing.assert_allclose(got, want_kernel, **MM_TOL)
    np.testing.assert_allclose(got, want_oracle, **MM_TOL)


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
def test_gemv_grouped_sums_splits_in_fixed_order(scheme):
    """The twin's splits are ``gemv_plan``'s: each split's groups summed
    in K order (scale times x @ codes), the splits' sums added to zero in
    split order — equal bit for bit to that sum written out, and run to
    run."""
    sch = S.get_scheme(scheme)
    m, k, n = 8, 4096, 128
    qw = _weights(scheme, k, n)
    x, packed, scales = (_bf16(RNG.normal(size=(m, k))), _t(qw.packed),
                         _t(qw.scales))
    kps, splits = PM.gemv_plan(m, k, n, sch)
    assert splits > 1
    group = S.effective_group(sch.group_size, k)
    vals = PM.bf16_from_bits(PM.kernel_decode_bf16(
        sch, unpack_codes(packed, sch.weight_bits))).to(torch.float32)
    xf = x.to(torch.float32)
    want = torch.zeros((m, n), dtype=torch.float32)
    for z in range(splits):
        k0, k1 = z * kps, min(k, (z + 1) * kps)
        if group == k:
            want += scales[0] * (xf[:, k0:k1] @ vals[k0:k1])
            continue
        part = torch.zeros((m, n), dtype=torch.float32)
        for g0 in range(k0, k1, group):
            part += scales[g0 // group] * (xf[:, g0:g0 + group]
                                           @ vals[g0:g0 + group])
        want += part
    got = PM.packed_gemv_ordered(x, packed, scales, sch)
    assert torch.equal(got, want)
    assert torch.equal(got, PM.packed_gemv_ordered(x, packed, scales, sch))


@pytest.mark.parametrize("scheme,splits", [("mxfp4", 53), ("fp8", 51)])
@pytest.mark.parametrize("n", [128, 18432])
def test_gemv_plan_lets_the_x_slice_cap_pass_32_splits(scheme, splits, n):
    """nemotron-4-340b's down projection (K = 73728) at M = 8: the 23 KB
    x slice of a block caps a split at 1408 (fp8: 1472) rows of K, so the
    plan runs more than 32 splits, still whole stages and groups that
    cover K, with four blocks' shared memory within an SM."""
    sch = S.get_scheme(scheme)
    kps, got = PM.gemv_plan(8, 73728, n, sch)
    assert got == splits > 32
    assert 8 * kps <= 11776 and (splits - 1) * kps < 73728 <= splits * kps
    assert kps % (128 if sch.weight_bits == 4 else 64) == 0
    assert 4 * (PM.gemv_smem_bytes(8, kps, sch) + 1024 + 128) <= 228 * 1024


@pytest.mark.parametrize("scheme", ["mxfp4", "fp8"])
def test_gemv_grouped_sums_53_splits_like_the_reference(scheme):
    """K1's association and order over the 53 (fp8: 51) splits of
    K = 73728 against the reference's jnp oracle, at N = 128."""
    m, k, n = 8, 73728, 128
    qw = _weights(scheme, k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    want = np.asarray(ref.packed_matmul_ref(jnp.asarray(x, jnp.bfloat16), qw))
    got = PM.packed_gemv_ordered(_bf16(x), _t(qw.packed), _t(qw.scales),
                                 S.get_scheme(scheme)).numpy()
    np.testing.assert_allclose(got, want, **MM_TOL)


@pytest.mark.parametrize("fn", [PM.packed_gemv, PM.packed_matmul])
def test_packed_wrappers_raise_on_devices_without_a_kernel(fn):
    scheme = S.get_scheme("awq_int4")
    x = torch.empty((2, 256), dtype=torch.bfloat16, device="meta")
    packed = torch.empty((32, 64), dtype=torch.int32, device="meta")
    scales = torch.empty((2, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(x, packed, scales, scheme)


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
def test_kernel_decode_gives_every_code_exactly_in_bf16(scheme):
    """K2 feeds the tensor cores the codes as bf16: every code of int4,
    e2m1 and e4m3, decoded by K2's integer operations, is bit for bit the
    bf16 cast of the reference decode (DAZ, NaN code as 0), and that cast
    is exact."""
    sch = S.get_scheme(scheme)
    codes = torch.arange(1 << sch.weight_bits)
    bits = PM.kernel_decode_bf16(sch, codes)
    want = _t(decode_codes_arith(RS.get_scheme(scheme),
                                 jnp.asarray(codes.numpy(), jnp.int32)))
    got = PM.bf16_from_bits(bits)
    assert torch.equal(got.view(torch.int16),
                       want.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got.to(torch.float32), want)


@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m,k,n", [(16, 256, 128), (64, 512, 128),
                                   (16, 4096, 128)])
def test_grouped_association_vs_reference_kernel(scheme, m, k, n):
    """K2's association — per scale group, x @ codes in f32, times the
    group's scale, summed in group order — against the reference's
    interpret-mode kernel (which scales each code before the sum)."""
    qw = _weights(scheme, k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32)
    want = np.asarray(ref_matmul(jnp.asarray(x, jnp.bfloat16), qw,
                                 interpret=True))
    got = PM.packed_matmul_ordered(_bf16(x), _t(qw.packed), _t(qw.scales),
                                   S.get_scheme(scheme)).numpy()
    np.testing.assert_allclose(got, want, **MM_TOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(64, 4096, 14336), (64, 4096, 4096),
                                   (64, 4096, 1024), (64, 14336, 4096),
                                   (8, 4096, 1022), (9, 4096, 1000),
                                   (100, 4096, 14336), (1, 72, 6)])
def test_matmul_plan_tiles_k_and_fills_the_card(m, k, n, bits):
    mt, nt, kps, splits = PM.matmul_plan(m, k, n, bits)
    assert mt == (1 if m <= 16 else 4)
    assert nt == (2 if mt == 4 and bits == 4 else 1)
    assert kps % 128 == 0 and (splits - 1) * kps < k <= splits * kps
    blocks = -(-n // (64 * nt)) * -(-m // (16 * mt))
    assert blocks * splits <= 264 or splits == 1
    if splits > 1:                       # split only short of 2 per SM
        assert blocks < 132 and kps >= 4 * 128
    if (m, n) == (64, 14336):            # 112 or 224 blocks
        assert splits == (2 if bits == 4 else 1)


@pytest.mark.parametrize("scheme,m,n,packed_off,scales_off,route", [
    ("awq_int4", 8, 4096, 0, 0, "gemv"),
    ("awq_int4", 1, 14336, 0, 0, "gemv"),
    ("awq_int4", 9, 4096, 0, 0, "matmul"),
    ("awq_int4", 64, 14336, 0, 0, "matmul"),
    ("awq_int4", 8, 1022, 0, 0, "matmul"),    # N % 4 != 0
    ("mxfp4", 4, 4096, 4, 0, "matmul"),       # words not 16-byte aligned
    ("fp8", 2, 4096, 0, 8, "matmul"),         # scales not 16-byte aligned
])
def test_linear_route_sends_what_k1_refuses_to_k2(scheme, m, n, packed_off,
                                                   scales_off, route):
    sch = S.get_scheme(scheme)
    assert ops.linear_route(sch, m, 4096, n, 1024 + packed_off,
                            2048 + scales_off) == route


@pytest.mark.parametrize("k,x_off,w_off,takes", [
    (4096, 0, 0, True), (16384, 0, 0, True), (4100, 0, 0, False),
    (200, 0, 0, False), (4096, 8, 0, False), (4096, 0, 4, False)])
def test_w8a8_pads_k_where_the_kernel_needs_it(k, x_off, w_off, takes):
    """Nothing is padded any more: every W8A8 leaf takes the one route, K5
    on the operands as they are.  A K or an address that does not suit
    16-byte copies (``takes`` False) only narrows that operand's copies in
    the kernel, to the widest of 4 or 1 bytes that divides both; and the
    product of an x view at that offset is the reference's bit for bit."""
    sch = S.get_scheme("w8a8")
    assert ops.linear_route(sch, 8, k, 64, 8192 + w_off, 0) == "w8a8"
    widths = [W8.copy_width(k, addr) for addr in (4096 + x_off, 8192 + w_off)]
    assert (widths == [16, 16]) is takes
    for width, addr in zip(widths, (4096 + x_off, 8192 + w_off)):
        assert k % width == 0 and addr % width == 0
        assert width == 16 or k % (4 * width) or addr % (4 * width)
    kk = min(k, 200)
    (rxc, rxs, qw), (xc, xs, wt, ws) = _w8a8_operands(3, kk, 40)
    buf = torch.zeros(3 * kk + 16, dtype=torch.int8)
    xv = buf[x_off:x_off + 3 * kk].view(3, kk)
    xv.copy_(xc)
    np.testing.assert_array_equal(
        W8.w8a8_matmul(xv, xs, wt, ws).numpy(),
        np.asarray(ref.w8a8_matmul_ref(rxc, rxs, qw.packed, qw.scales)))


# ---------------------------------------------------------------------------
# w8a8 int8 matmul
# ---------------------------------------------------------------------------
def _w8a8_operands(m, k, n):
    """(reference codes and scales, the port's: codes with the weights
    transposed to the kernel's [N, K] layout)."""
    qw = _weights("w8a8", k, n)
    x = RNG.normal(size=(m, k)).astype(np.float32) * 2
    xc, xs = RS.quantize_activations_int8(jnp.asarray(x, jnp.bfloat16))
    port = (_t(xc), torch.tensor(float(xs), dtype=torch.float32),
            _t(qw.packed).t().contiguous(), _t(qw.scales))
    return (xc, xs, qw), port


# M in {1, 3, 8, 9, 64}; K, N that fill the reference's 128 / 512 blocks
# and that do not
@pytest.mark.parametrize("m,k,n", [(1, 512, 128), (3, 192, 80),
                                   (8, 1024, 256), (9, 96, 40),
                                   (64, 640, 384), (64, 512, 128)])
def test_w8a8_plain_vs_reference_kernel_bitwise(m, k, n):
    (xc, xs, qw), (pxc, pxs, pwt, pws) = _w8a8_operands(m, k, n)
    want_kernel = np.asarray(ref_w8a8(xc, xs, qw.packed, qw.scales,
                                      interpret=True))
    want_oracle = np.asarray(ref.w8a8_matmul_ref(xc, xs, qw.packed,
                                                 qw.scales))
    got = W8.w8a8_matmul(pxc, pxs, pwt, pws)           # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_oracle)
    np.testing.assert_array_equal(
        W8.w8a8_matmul_plain(pxc, pxs, pwt, pws).numpy(), want_oracle)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_quantized_matmul_w8a8_matches_reference_dispatch(lead):
    """The whole dispatch — one per-tensor scale over every row of the
    call, the int8 matmul, the cast to bf16 — bit for bit against the
    reference's ``quantized_matmul`` with its kernel in interpret mode."""
    k, n = 128, 96
    qw = _weights("w8a8", k, n)
    x = RNG.normal(size=lead + (k,)).astype(np.float32)
    want = ref_quantized_matmul(jnp.asarray(x, jnp.bfloat16), qw,
                                use_kernel=True, interpret=True)
    scheme = S.get_scheme("w8a8")
    wt = _t(qw.packed).t().contiguous()
    got = ops.quantized_matmul(_bf16(x), wt, _t(qw.scales), scheme)
    plain = ops.quantized_matmul(_bf16(x), wt, _t(qw.scales), scheme,
                                 plain=True)
    assert got.shape == lead + (n,) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    assert torch.equal(got, plain)
    assert sum(ops.launch_counts().values()) == 0   # plain calls never count


@pytest.mark.parametrize("wave", [264, 132])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 1024),
                                   (8, 4096, 16384), (64, 16384, 4096),
                                   (3, 96, 40)])
def test_w8a8_split_plan_covers_k_in_steps_of_64(m, k, n, wave):
    """Splits of whole 512-K ring stages (so of 64-K mma steps) that cover
    K, as many as fit the grid in one wave of resident blocks, at most one
    a stage."""
    kps, splits = W8.split_plan(m, k, n, wave)
    assert kps % W8.BK == 0 and kps % 64 == 0
    assert (splits - 1) * kps < k <= splits * kps
    tiles = -(-n // W8.COLS) * -(-m // (8 * W8.x_groups(m)))
    assert tiles * splits <= max(wave, tiles)
    assert 2 * splits > min(-(-k // W8.BK), max(1, wave // tiles))


@pytest.mark.parametrize("m,groups", [(1, 1), (8, 1), (9, 2), (16, 2),
                                      (17, 4), (32, 4), (33, 8), (64, 8),
                                      (100, 8)])
def test_w8a8_x_groups_cover_the_rows(m, groups):
    """x rows a block takes: the smallest of 8, 16, 32, 64 that holds M;
    larger M runs in blocks of 64 rows."""
    assert W8.x_groups(m) == groups
    assert 8 * groups >= min(m, 64)


def test_w8a8_wrapper_raises_on_devices_without_a_kernel():
    xc = torch.empty((2, 64), dtype=torch.int8, device="meta")
    xs = torch.empty((), dtype=torch.float32, device="meta")
    wt = torch.empty((32, 64), dtype=torch.int8, device="meta")
    ws = torch.empty((1, 32), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        W8.w8a8_matmul(xc, xs, wt, ws)


@pytest.mark.parametrize("k,fits", [(W8.MAX_K, True), (W8.MAX_K + 1, False)])
def test_w8a8_refuses_k_that_could_overflow_the_int32_sum(k, fits):
    """Every product (-128) * (-128) is the largest int32 sum: K * 2^14,
    which fits at K = MAX_K and is 2^31 one K later, on any device."""
    xc = torch.full((1, k), -128, dtype=torch.int8)
    xs = torch.ones((), dtype=torch.float32)
    wt = torch.full((1, k), -128, dtype=torch.int8)
    ws = torch.ones((1, 1), dtype=torch.float32)
    if not fits:
        assert k * 2 ** 14 == 2 ** 31
        with pytest.raises(ValueError, match="overflow"):
            W8.w8a8_matmul(xc, xs, wt, ws)
        return
    assert W8.w8a8_matmul(xc, xs, wt, ws).item() == k * 2 ** 14 < 2 ** 31


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
def _attn_inputs(b=3, s=48, h=4, hk=2, dh=16):
    q = RNG.normal(size=(b, 1, h, dh)).astype(np.float32)
    k = RNG.normal(size=(b, s, hk, dh)).astype(np.float32)
    v = RNG.normal(size=(b, s, hk, dh)).astype(np.float32)
    lens = np.array([s, 1, 20], np.int32)[:b]
    return q, k, v, lens


def _slabs(tier, k, v):
    """(reference slabs, port slabs) holding the same bytes."""
    if tier == "bf16":
        return ((jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)),
                (_bf16(k), _bf16(v)))
    sch = RS.get_kv_scheme(tier)
    refs = tuple(RKV.QuantizedKV(*RS.kv_quantize(sch, jnp.asarray(a)), tier)
                 for a in (k, v))
    ports = tuple(QuantizedKV(_t(r.packed), _t(r.scales), tier) for r in refs)
    return refs, ports


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_decode_attention_plain_vs_reference_kernel(tier):
    q, k, v, lens = _attn_inputs()
    (rk, rv), (pk, pv) = _slabs(tier, k, v)
    qj = jnp.asarray(q, jnp.bfloat16)
    want_kernel = np.asarray(ref_decode(qj, rk, rv, jnp.asarray(lens),
                                        interpret=True), np.float32)
    want_oracle = np.asarray(ref.decode_attention_ref(qj, rk, rv,
                                                      jnp.asarray(lens)),
                             np.float32)
    got = DA.gqa_decode_attention(_bf16(q), pk, pv, _t(lens))
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want_kernel, **ATTN_TOL)
    np.testing.assert_allclose(got, want_oracle, **ATTN_TOL)


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_decode_attention_empty_rows_match_reference_kernel(tier):
    """A row with kv_valid_len == 0: the reference masks every score to the
    same -1e30, so every position gets the same weight and the output is
    the mean of V over the whole slab; the port computes the same."""
    q, k, v, _ = _attn_inputs()
    lens = np.array([0, 7, 0], np.int32)
    (rk, rv), (pk, pv) = _slabs(tier, k, v)
    qj = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(ref_decode(qj, rk, rv, jnp.asarray(lens),
                                 interpret=True), np.float32)
    got = DA.gqa_decode_attention(_bf16(q), pk, pv, _t(lens))
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, **ATTN_TOL)
    v_read = np.asarray(RKV.cache_read(rv, jnp.float32), np.float32) \
        if tier != "bf16" else np.asarray(rv, np.float32)
    mean_v = np.repeat(v_read[0].mean(0), 2, axis=0)     # [H, Dh], rep 2
    np.testing.assert_allclose(got[0, 0], mean_v, **ATTN_TOL)


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("h,hk,dh", [(12, 2, 192), (4, 4, 112)])
def test_decode_attention_plain_wide_heads_vs_reference_kernel(tier, h, hk,
                                                               dh):
    """The head layouts the port's kernel now takes: nemotron-4-340b's
    d_head 192 (GQA, rep 6 here) and zamba2-7b's 112 (rep 1)."""
    q, k, v, lens = _attn_inputs(b=3, s=40, h=h, hk=hk, dh=dh)
    (rk, rv), (pk, pv) = _slabs(tier, k, v)
    qj = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(ref_decode(qj, rk, rv, jnp.asarray(lens),
                                 interpret=True), np.float32)
    got = DA.gqa_decode_attention(_bf16(q), pk, pv, _t(lens))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               **ATTN_TOL)


def test_decode_copy_width_follows_rows_and_alignment():
    assert DA.copy_width(256, 0, 1 << 20) == 16       # bf16, Dh 128
    assert DA.copy_width(112, 0, 0) == 16             # int8 codes, Dh 112
    assert DA.copy_width(72, 0, 0) == 8               # bf16, Dh 36
    assert DA.copy_width(36, 0, 0) == 4               # codes, Dh 36
    assert DA.copy_width(256, 8, 0) == 8              # a slab 8-aligned
    with pytest.raises(ValueError):
        DA.copy_width(256, 2, 0)


@pytest.mark.parametrize("b,hk,sk", [(8, 8, 1024), (8, 8, 512), (1, 2, 48)])
def test_decode_split_plan_tiles_the_sequence(b, hk, sk):
    """Fixed spans of at most SPAN positions (two tiles) cover every
    position exactly once; the plan takes the slab length only — never
    kv_valid_len — so the host reads no lengths."""
    import inspect
    assert list(inspect.signature(DA.split_plan).parameters) == ["sk"]
    span, splits = DA.split_plan(sk)
    assert span == DA.SPAN <= 2 * DA.TILE and span % DA.TILE == 0
    covered = np.zeros(sk, np.int64)
    for sp in range(splits):
        covered[sp * span:min((sp + 1) * span, sk)] += 1
    assert (covered == 1).all() and (splits - 1) * span < sk


def test_decode_attention_raises_on_devices_without_a_kernel():
    q = torch.empty((1, 1, 4, 16), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        DA.gqa_decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32))


def test_build_targets_hopper_and_keys_libraries_by_source_and_flags():
    cmd = build.nvcc_command("packed_matmul", build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/packed_matmul.cu")
    a = build.library_path("packed_matmul")
    assert a == build.library_path("packed_matmul")
    assert a != build.library_path("packed_matmul", ("-Xptxas=-v",))
    assert a.parent == build.BUILD_DIR
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()


# ---------------------------------------------------------------------------
# the virtual-DSP lane multiply (K6)
# ---------------------------------------------------------------------------
def _vdsp_inputs(plan, t, seed, all_max=False):
    """Seeded magnitudes below 2^w per port (the reference kernel test's
    draw), or every magnitude 2^w - 1 (the full-width product)."""
    rng = np.random.default_rng(seed)
    n_a, n_b = len(plan.offsets_a), len(plan.offsets_b)
    if all_max:
        return (np.full((t, n_a), (1 << plan.w_a) - 1, np.int64),
                np.full((t, n_b), (1 << plan.w_b) - 1, np.int64))
    return (rng.integers(0, 1 << plan.w_a, size=(t, n_a), dtype=np.int64),
            rng.integers(0, 1 << plan.w_b, size=(t, n_b), dtype=np.int64))


VDSP_CASES = [(pair, "random") for pair in sorted(RP.PAPER_PARALLELISM)] + [
    (("bf16", "bf16"), "max")]


@pytest.mark.parametrize("pair,draw", VDSP_CASES,
                         ids=lambda x: "x".join(x) if isinstance(x, tuple)
                         else x)
def test_virtual_dsp_plain_vs_reference_kernel_bitwise(pair, draw):
    plan = P.solve_lane_plan(*pair, max_parallelism=4)
    rplan = RP.solve_lane_plan(*pair, max_parallelism=4)
    t = 2048 if draw == "random" else 256
    a, b = _vdsp_inputs(plan, t, 41, all_max=draw == "max")
    want_kernel = np.asarray(ref_vdsp(a, b, rplan, bt=512 if t > 256 else 256,
                                      interpret=True))
    want_oracle = ref.virtual_dsp_ref(rplan, a, b)
    got = XM.virtual_dsp_multiply(_t(a), _t(b), plan)
    assert got.dtype == torch.int32 and got.shape == want_kernel.shape
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_oracle)
    np.testing.assert_array_equal(
        XM.virtual_dsp_plain(_t(a), _t(b), plan).numpy(), want_oracle)
    np.testing.assert_array_equal(
        XM.virtual_dsp_multiply_wide(_t(a), _t(b), plan).numpy(), want_oracle)
    assert ops.virtual_dsp_multiply is XM.virtual_dsp_multiply


@pytest.mark.parametrize("pair", [("fp16", "fp16"), ("fp32", "int16"),
                                  ("int16", "int16"), ("fp32", "bf16")])
def test_virtual_dsp_multiply_raises_outside_reference_domain(pair):
    """The reference kernel's lane window is <= 19 bits below bit 48
    (its _extract_lane asserts); the int64 entry takes these plans."""
    plan = P.solve_lane_plan(*pair)
    a, b = _vdsp_inputs(plan, 64, 42)
    with pytest.raises(ValueError, match="reference kernel's domain"):
        XM.virtual_dsp_multiply(_t(a), _t(b), plan)
    with pytest.raises(AssertionError):
        ref_vdsp(a, b, RP.solve_lane_plan(*pair), bt=64, interpret=True)
    np.testing.assert_array_equal(
        XM.virtual_dsp_multiply_wide(_t(a), _t(b), plan).numpy(),
        ref.virtual_dsp_ref(RP.solve_lane_plan(*pair), a, b))


def test_virtual_dsp_wrappers_raise_on_devices_without_a_kernel():
    plan = P.solve_lane_plan("int4", "bf16", max_parallelism=4)
    a = torch.empty((4, 2), dtype=torch.int32, device="meta")
    b = torch.empty((4, 1), dtype=torch.int32, device="meta")
    for fn in (XM.virtual_dsp_multiply, XM.virtual_dsp_multiply_wide):
        with pytest.raises(ValueError, match="no kernel"):
            fn(a, b, plan)
    with pytest.raises(ValueError, match="shapes"):
        XM.virtual_dsp_multiply(torch.zeros((4, 3), dtype=torch.int32),
                                torch.zeros((4, 1), dtype=torch.int32), plan)


def test_virtual_dsp_kernel_plan_mirrors_the_lane_plan():
    plan = P.solve_lane_plan("fp4_e2m1", "fp4_e2m1")          # 2 x 4 lanes
    k = XM._kernel_plan(plan)
    assert (k.n_a, k.n_b, k.n_lanes, k.stride) == (2, 4, 8, plan.stride)
    assert list(k.off_a[:2]) == list(plan.offsets_a)
    assert list(k.off_b[:4]) == list(plan.offsets_b)
    assert list(k.pos[:8]) == [p for (_, _, p) in plan.lane_positions]
    assert ctypes_sizeof(k) == 4 * (4 + 2 * XM.MAX_PORT_LANES + XM.MAX_LANES)


# every plan K6 runs: the paper pairs capped at 4 lanes, the beyond-paper
# plans uncapped within the reference kernel's domain, and fp32 x int16 (the
# int64 entry's 40-bit lanes)
VDSP_RUN_PLANS = (
    [(pair, 4) for pair in sorted(RP.PAPER_PARALLELISM)]
    + [(pair, None) for pair in sorted(RP.SOLVER_BEYOND_PAPER)
       if RP.solve_lane_plan(*pair).stride <= XM.REF_MAX_STRIDE]
    + [(("fp32", "int16"), None)])


@pytest.mark.parametrize("pair,cap", VDSP_RUN_PLANS,
                         ids=lambda x: "x".join(x) if isinstance(x, tuple)
                         else str(x))
def test_virtual_dsp_kernel_variant_specialises_every_plan_that_runs(pair,
                                                                      cap):
    plan = P.solve_lane_plan(*pair, max_parallelism=cap)
    k = XM._kernel_plan(plan)
    v = XM.kernel_variant(k.n_a, k.n_b, k.n_lanes)
    assert v > 0 and XM.SPECIALISED[v - 1] == (k.n_a, k.n_b)
    assert k.n_lanes == k.n_a * k.n_b == plan.parallelism


def test_virtual_dsp_kernel_variant_is_generic_elsewhere():
    assert XM.kernel_variant(3, 2, 6) == 0           # no such body
    assert XM.kernel_variant(2, 2, 3) == 0           # not every (i, j) a lane
    assert len(set(XM.SPECIALISED)) == len(XM.SPECIALISED) == 6


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m,n", [(1, 512), (8, 512), (9, 512), (64, 512),
                                 (100, 512), (64, 1000), (8, 1022)])
def test_packed_kernels_match_plain_on_card(cuda_device, scheme, m, n):
    """K1 and K2 as ``quantized_matmul`` routes them: M <= 8 to K1 where
    it takes the leaf, everything else (ragged N, N % 4 != 0) to K2."""
    qw = _weights(scheme, 1024, n)
    x = _bf16(RNG.normal(size=(m, 1024))).to(cuda_device)
    packed, scales = _t(qw.packed).to(cuda_device), _t(qw.scales).to(cuda_device)
    sch = S.get_scheme(scheme)
    route = ops.linear_route(sch, m, 1024, n, packed.data_ptr(),
                             scales.data_ptr())
    assert route == ("gemv" if m <= 8 and n % 4 == 0 else "matmul")
    before = ops.launch_counts()[f"packed_{route}"]
    got = ops.quantized_matmul(x, packed, scales, sch,
                               out_dtype=torch.float32)
    assert ops.launch_counts()[f"packed_{route}"] == before + 1
    want = PM.packed_matmul_plain(x, packed, scales, sch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("h,hk,dh", [(32, 8, 128), (32, 4, 64),
                                     (32, 32, 112), (96, 8, 192)])
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, tier, h,
                                                       hk, dh):
    q, k, v, lens = _attn_inputs(b=3, s=150, h=h, hk=hk, dh=dh)
    _, (pk, pv) = _slabs(tier, k, v)
    if tier == "bf16":
        pk, pv = pk.to(cuda_device), pv.to(cuda_device)
    else:
        pk = QuantizedKV(pk.packed.to(cuda_device), pk.scales.to(cuda_device),
                         tier)
        pv = QuantizedKV(pv.packed.to(cuda_device), pv.scales.to(cuda_device),
                         tier)
    qd, ld = _bf16(q).to(cuda_device), _t(lens).to(cuda_device)
    got = DA.gqa_decode_attention(qd, pk, pv, ld).float()
    want = DA.decode_attention_plain(qd, pk, pv, ld).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1024), (8, 4096, 16384),
                                   (64, 16384, 4096), (9, 208, 136),
                                   (33, 1040, 250), (100, 512, 384),
                                   (8, 4100, 256), (64, 200, 40)])
def test_w8a8_kernel_matches_plain_on_card_bitwise(cuda_device, m, k, n):
    """K % 16 != 0 (the last two) runs the kernel's 4-byte copy body."""
    _, (xc, xs, wt, ws) = _w8a8_operands(m, k, n)
    xc, xs, wt, ws = (t.to(cuda_device) for t in (xc, xs, wt, ws))
    before = W8.launches["w8a8_matmul"]
    got = W8.w8a8_matmul(xc, xs, wt, ws)
    assert W8.launches["w8a8_matmul"] == before + 1
    want = W8.w8a8_matmul_plain(xc, xs, wt, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _w8a8_card_operands(m, k, n, device, x_offset=0):
    """Uniform int8 codes (x as a view ``x_offset`` bytes past an aligned
    buffer) and positive scales, made on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(m * 100003 + k * 7 + n)
    buf = torch.randint(-128, 128, (m * k + 16,), generator=gen,
                        device=device, dtype=torch.int32).to(torch.int8)
    xc = buf[x_offset:x_offset + m * k].view(m, k)
    wt = torch.randint(-128, 128, (n, k), generator=gen, device=device,
                       dtype=torch.int32).to(torch.int8)
    ws = torch.rand((1, n), generator=gen, device=device) * 1e-3 + 1e-4
    xs = torch.rand((), generator=gen, device=device) * 1e-2 + 1e-3
    return xc, xs, wt, ws


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(4096, 1024), (16384, 256), (4100, 250),
                                 (208, 40), (200, 136)])
@pytest.mark.parametrize("m", list(range(1, 10)) + [16, 17, 33, 64, 100])
def test_w8a8_kernel_every_row_count_on_card_bitwise(cuda_device, m, k, n):
    """Every decode row count, the edges of each x-group body and row
    blocks past 64, at aligned and unaligned K and ragged N: one launch,
    the plain version's bits."""
    xc, xs, wt, ws = _w8a8_card_operands(m, k, n, cuda_device)
    before = W8.launches["w8a8_matmul"]
    got = W8.w8a8_matmul(xc, xs, wt, ws)
    assert W8.launches["w8a8_matmul"] == before + 1
    want = W8.w8a8_matmul_plain(xc, xs, wt, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (33, 200, 136)])
@pytest.mark.parametrize("x_offset", range(1, 16))
def test_w8a8_kernel_takes_x_at_any_byte_offset_on_card(cuda_device, m, k,
                                                        n, x_offset):
    """x as a view at byte offsets 1-15 (narrower copies), no copy made:
    the plain version's bits."""
    xc, xs, wt, ws = _w8a8_card_operands(m, k, n, cuda_device, x_offset)
    assert xc.data_ptr() % 16 == x_offset % 16
    got = W8.w8a8_matmul(xc, xs, wt, ws)
    want = W8.w8a8_matmul_plain(xc, xs, wt, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_decode_attention_empty_rows_on_card(cuda_device, tier):
    q, k, v, _ = _attn_inputs(b=3, s=96, h=32, hk=8, dh=128)
    lens = _t(np.array([0, 50, 0], np.int32)).to(cuda_device)
    _, (pk, pv) = _slabs(tier, k, v)
    if tier == "bf16":
        pk, pv = pk.to(cuda_device), pv.to(cuda_device)
    else:
        pk = QuantizedKV(pk.packed.to(cuda_device), pk.scales.to(cuda_device),
                         tier)
        pv = QuantizedKV(pv.packed.to(cuda_device), pv.scales.to(cuda_device),
                         tier)
    qd = _bf16(q).to(cuda_device)
    got = DA.gqa_decode_attention(qd, pk, pv, lens).float()
    want = DA.decode_attention_plain(qd, pk, pv, lens).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("pair,draw", VDSP_CASES,
                         ids=lambda x: "x".join(x) if isinstance(x, tuple)
                         else x)
def test_virtual_dsp_kernel_matches_plain_on_card(cuda_device, pair, draw):
    plan = P.solve_lane_plan(*pair, max_parallelism=4)
    a, b = _vdsp_inputs(plan, 100_003, 43, all_max=draw == "max")
    a, b = _t(a).to(cuda_device), _t(b).to(cuda_device)
    before = ops.launch_counts()["virtual_dsp_multiply"]
    got = XM.virtual_dsp_multiply(a, b, plan)
    wide = XM.virtual_dsp_multiply_wide(a, b, plan)
    assert ops.launch_counts()["virtual_dsp_multiply"] == before + 2
    want = XM.virtual_dsp_plain(a, b, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.to(torch.int64), want)
    assert torch.equal(wide, want)


@pytest.mark.gpu
def test_virtual_dsp_wide_kernel_matches_plain_on_card(cuda_device):
    """The int64 instantiation on a 40-bit lane (fp32 x int16)."""
    plan = P.solve_lane_plan("fp32", "int16")
    a, b = _vdsp_inputs(plan, 100_003, 44)
    a, b = _t(a).to(cuda_device), _t(b).to(cuda_device)
    got = P.packed_multiply(plan, a, b)
    want = P.packed_multiply(plan, a, b, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_gemv_kernel_matches_plain_on_card_at_every_m(cuda_device, scheme, m):
    """K1 at every decode row count, on a leaf split many ways (K = 4096,
    N = 1024): one launch, within the matmul tolerance of the plain
    version, closer still to its twin in its own association and order,
    and the same bits run to run."""
    qw = _weights(scheme, 4096, 1024)
    x = _bf16(RNG.normal(size=(m, 4096))).to(cuda_device)
    packed, scales = _t(qw.packed).to(cuda_device), _t(qw.scales).to(cuda_device)
    sch = S.get_scheme(scheme)
    before = ops.launch_counts()["packed_gemv"]
    got = PM.packed_gemv(x, packed, scales, sch)
    assert ops.launch_counts()["packed_gemv"] == before + 1
    again = PM.packed_gemv(x, packed, scales, sch)
    want = PM.packed_matmul_plain(x, packed, scales, sch)
    twin = PM.packed_gemv_ordered(x, packed, scales, sch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MM_TOL)
    torch.testing.assert_close(got, twin, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["mxfp4", "fp8"])
@pytest.mark.parametrize("n", [128, 1024])
def test_gemv_kernel_past_32_splits_on_card(cuda_device, scheme, n):
    """K1 at K = 73728, M = 8 (53 splits, fp8 51, more than one wave of
    blocks for N = 1024): one launch, within the matmul tolerance of the
    plain version and close to its twin."""
    qw = _weights(scheme, 73728, n)
    x = _bf16(RNG.normal(size=(8, 73728))).to(cuda_device)
    packed, scales = _t(qw.packed).to(cuda_device), _t(qw.scales).to(cuda_device)
    sch = S.get_scheme(scheme)
    assert PM.gemv_plan(8, 73728, n, sch)[1] > 32
    before = ops.launch_counts()["packed_gemv"]
    got = PM.packed_gemv(x, packed, scales, sch)
    assert ops.launch_counts()["packed_gemv"] == before + 1
    want = PM.packed_matmul_plain(x, packed, scales, sch)
    twin = PM.packed_gemv_ordered(x, packed, scales, sch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MM_TOL)
    torch.testing.assert_close(got, twin, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("pair,cap", VDSP_RUN_PLANS,
                         ids=lambda x: "x".join(x) if isinstance(x, tuple)
                         else str(x))
def test_virtual_dsp_kernel_on_a_ragged_tile_on_card(cuda_device, pair, cap):
    """T = 3 * 1024 + 37 issues: no whole number of any body's row tile
    (256, 512 or 1024 issues), in both instantiations."""
    plan = P.solve_lane_plan(*pair, max_parallelism=cap)
    a, b = _vdsp_inputs(plan, 3 * 1024 + 37, 45)
    a, b = _t(a).to(cuda_device), _t(b).to(cuda_device)
    want = XM.virtual_dsp_plain(a, b, plan)
    wide = XM.virtual_dsp_multiply_wide(a, b, plan)
    torch.cuda.synchronize()
    assert torch.equal(wide, want)
    if plan.stride <= XM.REF_MAX_STRIDE:
        got = XM.virtual_dsp_multiply(a, b, plan)
        torch.cuda.synchronize()
        assert torch.equal(got.to(torch.int64), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("view", ["column_slice", "transposed", "unaligned"])
def test_virtual_dsp_kernel_on_non_contiguous_views_on_card(cuda_device,
                                                            view, dtype):
    """Magnitudes as views (fp4 x bf16: 3 x 1 lanes, rows of 12 / 24 and 4
    / 8 bytes): columns of a wider array (as ``core/packing`` slices
    per-lane fields), a transposed array, and a contiguous view that
    starts off a 16-byte boundary (the kernel's element copies)."""
    plan = P.solve_lane_plan("fp4_e2m1", "bf16", max_parallelism=4)
    t = 10_001
    a, b = _vdsp_inputs(plan, t + 1, 46)
    a, b = _t(a).to(cuda_device, dtype), _t(b).to(cuda_device, dtype)
    if view == "column_slice":
        a = torch.cat([a, a], dim=1)[1:, 1:4]
        b = torch.cat([b, b, b], dim=1)[1:, 1:2]
    elif view == "transposed":
        a, b = a[1:].t().contiguous().t(), b[1:].t().contiguous().t()
    else:
        a, b = a[1:], b[1:]
        assert a.is_contiguous() and a.data_ptr() % 16 != 0
        assert b.is_contiguous() and b.data_ptr() % 16 != 0
    want = XM.virtual_dsp_plain(a, b, plan)
    got = (XM.virtual_dsp_multiply(a, b, plan) if dtype == torch.int32
           else P.packed_multiply(plan, a, b))
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got.to(torch.int64), want)
