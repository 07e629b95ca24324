"""The port's kernels against the JAX reference's Pallas kernels.

On the CPU the wrappers take their plain versions; those are held against
the reference kernels run in interpret mode and against the reference's
jnp oracles:
  * packed GEMV / matmul (all three packed schemes) at the tolerance of the
    reference's kernel tests (rtol 2e-3, atol 1e-3: f32 sums in another
    order, see ROADMAP R1);
  * decode attention (bf16 / int8 / fp8 slabs) to one bf16 ulp (rtol
    2^-7): both round an f32 result to bf16.
Tests marked ``gpu`` run the CUDA kernels against the plain versions and
skip when no card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import gqa_decode_attention as ref_decode
from repro.kernels.packed_matmul import packed_gemv as ref_gemv
from repro.kernels.packed_matmul import packed_matmul as ref_matmul
from repro.quant import kv_cache as RKV
from repro.quant import schemes as RS
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import packed_matmul as PM
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
