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
    which attend their whole slab with equal weights.
Tests marked ``gpu`` run the CUDA kernels against the plain versions and
skip when no card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import gqa_decode_attention as ref_decode
from repro.kernels.ops import quantized_matmul as ref_quantized_matmul
from repro.kernels.packed_matmul import packed_gemv as ref_gemv
from repro.kernels.packed_matmul import packed_matmul as ref_matmul
from repro.kernels.packed_matmul import w8a8_matmul as ref_w8a8
from repro.quant import kv_cache as RKV
from repro.quant import schemes as RS
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import packed_matmul as PM
from repro_torch.kernels import w8a8_matmul as W8
from repro_torch.quant import schemes as S
from repro_torch.quant.kv_cache import QuantizedKV

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
    per = 32 // sch.weight_bits
    wps, splits = PM.gemv_split_plan(m, k, n, sch)
    assert (splits - 1) * wps < k // per <= splits * wps
    assert 4 * m * wps * per <= 32 * 1024          # staged x fits its budget
    tiles = -(-n // 128)
    assert tiles * splits >= min(132, tiles * (k // per) // 8)


@pytest.mark.parametrize("fn", [PM.packed_gemv, PM.packed_matmul])
def test_packed_wrappers_raise_on_devices_without_a_kernel(fn):
    scheme = S.get_scheme("awq_int4")
    x = torch.empty((2, 256), dtype=torch.bfloat16, device="meta")
    packed = torch.empty((32, 64), dtype=torch.int32, device="meta")
    scales = torch.empty((2, 64), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fn(x, packed, scales, scheme)


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


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 1024),
                                   (8, 4096, 16384), (64, 16384, 4096),
                                   (3, 96, 40)])
def test_w8a8_split_plan_covers_k_in_steps_of_64(m, k, n):
    kps, splits = W8.split_plan(m, k, n)
    assert kps % 64 == 0 and kps >= 256
    assert (splits - 1) * kps < k <= splits * kps
    blocks = -(-n // 128) * -(-m // (16 * W8.m_tiles(m)))
    assert blocks * splits >= min(132, blocks * -(-k // 256))


def test_w8a8_wrapper_raises_on_devices_without_a_kernel():
    xc = torch.empty((2, 64), dtype=torch.int8, device="meta")
    xs = torch.empty((), dtype=torch.float32, device="meta")
    wt = torch.empty((32, 64), dtype=torch.int8, device="meta")
    ws = torch.empty((1, 32), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        W8.w8a8_matmul(xc, xs, wt, ws)


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


@pytest.mark.parametrize("b,hk,sk", [(8, 8, 1024), (8, 8, 512), (1, 2, 48)])
def test_decode_split_plan_tiles_the_sequence(b, hk, sk):
    split_len, splits = DA.split_plan(b, hk, sk)
    assert split_len % 32 == 0
    assert (splits - 1) * split_len < sk <= splits * split_len


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
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["awq_int4", "mxfp4", "fp8"])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_packed_kernels_match_plain_on_card(cuda_device, scheme, m):
    qw = _weights(scheme, 1024, 512)
    x = _bf16(RNG.normal(size=(m, 1024))).to(cuda_device)
    packed, scales = _t(qw.packed).to(cuda_device), _t(qw.scales).to(cuda_device)
    sch = S.get_scheme(scheme)
    fn = PM.packed_gemv if m <= 8 else PM.packed_matmul
    got = fn(x, packed, scales, sch)
    want = PM.packed_matmul_plain(x, packed, scales, sch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_decode_attention_kernel_matches_plain_on_card(cuda_device, tier):
    q, k, v, lens = _attn_inputs(b=3, s=96, h=32, hk=8, dh=128)
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
                                   (33, 1040, 250), (100, 512, 384)])
def test_w8a8_kernel_matches_plain_on_card_bitwise(cuda_device, m, k, n):
    _, (xc, xs, wt, ws) = _w8a8_operands(m, k, n)
    xc, xs, wt, ws = (t.to(cuda_device) for t in (xc, xs, wt, ws))
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
