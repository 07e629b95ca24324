// Packed-weight mixed-precision GEMV and matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/packed_matmul.py:
// _packed_matmul_kernel, as reached through packed_gemv (M <= 8, every
// decode linear) and packed_matmul (M > 8, every prefill-chunk linear).
//
// Computes out[M, N] (f32) = x[M, K] (bf16) @ W[K, N], where W is stored as
// int32 words [K/per, N] holding per = 8 (int4, fp4 e2m1) or 4 (fp8 e4m3)
// codes little-endian along K, plus f32 scales [K/group, N] ([1, N] per
// channel).  Each code is decoded arithmetically (two's complement int;
// e2m1 / e4m3 with a zero exponent read as 0 and the e4m3 NaN code read as
// 0), multiplied by its group scale in f32, and accumulated in f32 — the
// reference's fused-dequant numerics.  Only the order of the f32 sums
// differs from the reference.
//
// What bounds it on the H100:
//  * GEMV (M <= 8): the bytes of the packed words and scales (3.35 TB/s);
//    there are at most 16 flops per weight byte.  Each thread streams four
//    neighbouring columns with one 16-byte load per word row (a warp reads
//    512 contiguous bytes), decodes in registers and keeps M x 4 f32 sums.
//    K is split across blocks so that a narrow N still fills the 132 SMs;
//    the split-K partials go to an f32 scratch and a second kernel sums
//    them in a fixed order, so results are deterministic run to run.
//  * matmul (M > 8): the f32 FMAs on the CUDA cores.  It is a plain
//    shared-memory tiling (64 x 64 outputs per block, 4 x 4 per thread)
//    over x and the decoded, scaled W tile, with the same split-K and
//    fixed-order reduction as the GEMV so that a prefill chunk (M = 64)
//    still fills the SMs.  Tensor cores (codes as the bf16 operand, scales
//    applied to f32 partials) are later work.
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Format { INT4 = 0, FP4_E2M1 = 1, FP8_E4M3 = 2 };

template <int FMT> struct FormatBits { static constexpr int value = 4; };
template <> struct FormatBits<FP8_E4M3> { static constexpr int value = 8; };

template <int FMT>
__device__ __forceinline__ float decode_code(uint32_t c) {
  if (FMT == INT4) {
    return static_cast<float>(static_cast<int32_t>(c << 28) >> 28);
  } else if (FMT == FP4_E2M1) {
    const uint32_t e = (c >> 1) & 3u, m = c & 1u;
    // (2 + m) * 2^(e - 2) == (1 + m/2) * 2^(e - 1); e == 0 reads as 0 (DAZ)
    const float mag =
        e == 0 ? 0.f : __uint_as_float(((e + 126u) << 23) | (m << 22));
    return (c >> 3) & 1u ? -mag : mag;
  } else {
    const uint32_t e = (c >> 3) & 15u, m = c & 7u;
    // (8 + m) * 2^(e - 10) == (1 + m/8) * 2^(e - 7); DAZ, NaN code reads 0
    const bool zero = e == 0 || (e == 15 && m == 7);
    const float mag =
        zero ? 0.f : __uint_as_float(((e + 120u) << 23) | (m << 20));
    return (c >> 7) & 1u ? -mag : mag;
  }
}

// ---------------------------------------------------------------------------
// GEMV: grid (ceil(N / 128), splits), 256 threads = 8 warps.  Lane l owns
// columns [col, col + 4) of the block's 128; warp w takes word rows
// w0 + w, w0 + w + 8, ... of the block's split.  Shared memory holds the
// split's x slice as f32, then (reused) the per-warp sums.
// ---------------------------------------------------------------------------
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvCols = 128;

template <int FMT, int M>
__global__ void __launch_bounds__(kGemvThreads)
packed_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                   const int32_t* __restrict__ w,
                   const float* __restrict__ scales,
                   float* __restrict__ partial, int K, int N, int group,
                   int words_per_split) {
  constexpr int BITS = FormatBits<FMT>::value;
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  extern __shared__ float smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kGemvCols + lane * 4;
  const int w0 = blockIdx.y * words_per_split;
  const int w1 = min(w0 + words_per_split, K / PER);
  const int span = words_per_split * PER;       // x row stride in smem
  const int used = (w1 - w0) * PER;

  for (int i = threadIdx.x; i < M * used; i += kGemvThreads) {
    const int m = i / used, kk = i - m * used;
    smem[m * span + kk] =
        __bfloat162float(x[static_cast<size_t>(m) * K + w0 * PER + kk]);
  }
  __syncthreads();

  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  if (col < N) {
    for (int wi = w0 + warp; wi < w1; wi += kGemvWarps) {
      const int4 wv =
          *reinterpret_cast<const int4*>(w + static_cast<size_t>(wi) * N + col);
      const float4 sv = *reinterpret_cast<const float4*>(
          scales + static_cast<size_t>((wi * PER) / group) * N + col);
      const uint32_t words[4] = {static_cast<uint32_t>(wv.x),
                                 static_cast<uint32_t>(wv.y),
                                 static_cast<uint32_t>(wv.z),
                                 static_cast<uint32_t>(wv.w)};
      const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
      const float* xr = smem + (wi - w0) * PER;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float wd[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wd[c] = decode_code<FMT>((words[c] >> (i * BITS)) & MASK) * sc[c];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float xv = xr[m * span + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wd[c], acc[m][c]);
        }
      }
    }
  }

  // fixed-order reduction of the 8 warps' sums (smem reused)
  __syncthreads();
  float* red = smem;                               // [warps][M][128]
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[(warp * M + m) * kGemvCols + lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols, c = i - m * kGemvCols;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kGemvWarps; ++wp) s += red[(wp * M + m) * kGemvCols + c];
    const int gc = blockIdx.x * kGemvCols + c;
    if (gc < N)
      partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + gc] = s;
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int mn,
                                     int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * mn + i];
  out[i] = s;
}

template <int FMT, int M>
cudaError_t launch_gemv_m(const __nv_bfloat16* x, const int32_t* w,
                          const float* scales, float* partial, int K, int N,
                          int group, int words_per_split, int splits,
                          cudaStream_t stream) {
  constexpr int PER = 32 / FormatBits<FMT>::value;
  const size_t xs = sizeof(float) * M * words_per_split * PER;
  const size_t rs = sizeof(float) * kGemvWarps * M * kGemvCols;
  const size_t smem = xs > rs ? xs : rs;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_gemv_kernel<FMT, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  packed_gemv_kernel<FMT, M><<<grid, kGemvThreads, smem, stream>>>(
      x, w, scales, partial, K, N, group, words_per_split);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_gemv(const __nv_bfloat16* x, const int32_t* w,
                        const float* scales, float* partial, int M, int K,
                        int N, int group, int words_per_split, int splits,
                        cudaStream_t stream) {
#define GEMV_CASE(MM)                                                        \
  case MM:                                                                   \
    return launch_gemv_m<FMT, MM>(x, w, scales, partial, K, N, group,        \
                                  words_per_split, splits, stream);
  switch (M) {
    GEMV_CASE(1) GEMV_CASE(2) GEMV_CASE(3) GEMV_CASE(4)
    GEMV_CASE(5) GEMV_CASE(6) GEMV_CASE(7) GEMV_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef GEMV_CASE
}

// ---------------------------------------------------------------------------
// Matmul: grid (ceil(N / 64), ceil(M / 64), splits), 256 threads as 16 x 16,
// each thread a 4 x 4 output tile of split z's partial sum over K rows
// [z * k_per_split, (z + 1) * k_per_split).  Per K step of 32: x tile
// (transposed) and the decoded, scaled W tile as f32 in shared memory.
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32;

template <int FMT>
__global__ void __launch_bounds__(256)
packed_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                     const int32_t* __restrict__ w,
                     const float* __restrict__ scales,
                     float* __restrict__ partial, int M, int K, int N,
                     int group, int k_per_split) {
  constexpr int BITS = FormatBits<FMT>::value;
  constexpr int PER = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int WROWS = kBK / PER;
  __shared__ __align__(16) float xs[kBK][kBM + 4];
  __shared__ __align__(16) float ws[kBK][kBN + 4];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(kbeg + k_per_split, K);
  const int kw = kend / PER;
  float acc[4][4] = {};

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += 256) {
      const int mm = i / kBK, kk = i - mm * kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < kend)
                       ? __bfloat162float(x[static_cast<size_t>(gm) * K + gk])
                       : 0.f;
    }
    for (int i = tid; i < WROWS * kBN; i += 256) {
      const int r = i / kBN, c = i - r * kBN;
      const int gw = k0 / PER + r, gn = n0 + c;
      const bool ok = gn < N && gw < kw;
      const uint32_t word =
          ok ? static_cast<uint32_t>(w[static_cast<size_t>(gw) * N + gn]) : 0u;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int gk = gw * PER + p;
        const float s =
            ok ? scales[static_cast<size_t>(gk / group) * N + gn] : 0.f;
        ws[r * PER + p][c] = decode_code<FMT>((word >> (p * BITS)) & MASK) * s;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x bf16 [M, K]; w int32 [K/per, N]; scales f32 [ceil(K/group), N];
// partial f32 [splits, M, N] scratch; out f32 [M, N].  1 <= M <= 8,
// N % 4 == 0, 16-byte aligned w / scales; fmt: 0 int4, 1 fp4, 2 fp8.
int packed_gemv(const void* x, const void* w, const void* scales,
                void* partial, void* out, int M, int K, int N, int fmt,
                int group, int words_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* pp = static_cast<float*>(partial);
  cudaError_t e;
  switch (fmt) {
    case INT4:
      e = launch_gemv<INT4>(xb, wp, sp, pp, M, K, N, group, words_per_split,
                            splits, s);
      break;
    case FP4_E2M1:
      e = launch_gemv<FP4_E2M1>(xb, wp, sp, pp, M, K, N, group,
                                words_per_split, splits, s);
      break;
    case FP8_E4M3:
      e = launch_gemv<FP8_E4M3>(xb, wp, sp, pp, M, K, N, group,
                                words_per_split, splits, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const int mn = M * N;
  splitk_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(
      pp, static_cast<float*>(out), mn, splits);
  return cudaGetLastError();
}

// x bf16 [M, K]; w int32 [K/per, N]; scales f32 [ceil(K/group), N];
// partial f32 [splits, M, N] scratch; out f32 [M, N]; k_per_split a
// multiple of 32; fmt as above.
int packed_matmul(const void* x, const void* w, const void* scales,
                  void* partial, void* out, int M, int K, int N, int fmt,
                  int group, int k_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* pp = static_cast<float*>(partial);
  switch (fmt) {
    case INT4:
      packed_matmul_kernel<INT4><<<grid, 256, 0, s>>>(xb, wp, sp, pp, M, K, N,
                                                      group, k_per_split);
      break;
    case FP4_E2M1:
      packed_matmul_kernel<FP4_E2M1><<<grid, 256, 0, s>>>(
          xb, wp, sp, pp, M, K, N, group, k_per_split);
      break;
    case FP8_E4M3:
      packed_matmul_kernel<FP8_E4M3><<<grid, 256, 0, s>>>(
          xb, wp, sp, pp, M, K, N, group, k_per_split);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int mn = M * N;
  splitk_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(
      pp, static_cast<float*>(out), mn, splits);
  return cudaGetLastError();
}

}  // extern "C"
