// W8A8 matmul for Hopper (sm_90a): int8 activation codes x int8 weight
// codes -> exact int32 sums -> f32 descale, on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/packed_matmul.py:_w8a8_kernel,
// reached through w8a8_matmul.  Computes
//   out[m, n] = float(sum_k x[m, k] * w[k, n]) * (w_scales[n] * x_scale)
// with x int8 [M, K] (one per-tensor scale, a device scalar) and w int8
// codes with per-channel f32 scales [N].  The int32 sum is exact and so
// independent of its order; the epilogue converts it with round-to-nearest
// and multiplies by the f32 product w_scales[n] * x_scale, the reference's
// association, so the output equals ref.w8a8_matmul_ref bit for bit.
// No overflow: |sum| <= K * 128 * 128, below 2^31 for K up to 131072
// (minitron-8b's widest K is 16384).  Built without fast-math.
//
// Layout: the weight codes are stored transposed, wt [N, K] (each output
// column's K codes contiguous), so one 16-byte load gives 16 consecutive K
// of one column — what the mma B fragment ("col") takes without shuffles.
//
// What bounds it on the H100: at decode (M <= 8) the weight bytes, K * N
// (3.35 TB/s); at a 64-row prefill chunk still the bytes (2 * 64 ops per
// weight byte against ~590 int8 ops per byte at the tensor cores' peak).
// Its design: mma.sync.m16n8k32 s8 x s8 -> s32.  Each warp owns 16 * MT
// rows x 32 columns (MT m-tiles x 4 n-tiles of 8) and walks its K range in
// steps of 64: lane (g = lane / 4, t = lane % 4) loads 16 bytes of row g
// (and g + 8) of x and 16 bytes of column g of each n-tile, all at K offset
// 16 t, and feeds them to two mmas.  That assigns the mma's 32 K slots to
// other K indices than the natural order, the same permutation for A and
// B, which an exact integer sum does not see.  Loads go straight from
// global memory (16 bytes a lane, fully used sectors); 4 warps make a
// block of 128 columns.  K is split over blocks until the grid holds about
// two waves; with more than one split each block writes int32 partials and
// a second kernel sums them (exact in any order) and applies the epilogue.
//
// C interface: launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNTiles = 4;                       // n-tiles of 8 per warp
constexpr int kColsPerBlock = kWarps * kNTiles * 8;
constexpr int kKStep = 64;                       // K per loop step

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ float descale(int acc, float w_scale, float x_scale) {
  return __int2float_rn(acc) * (w_scale * x_scale);
}

// grid (ceil(N / 128), ceil(M / (16 MT)), splits), kThreads threads.
template <int MT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
            const float* __restrict__ w_scales,
            const float* __restrict__ x_scale, int32_t* __restrict__ partial,
            float* __restrict__ out, int M, int K, int N, int k_per_split) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kColsPerBlock + warp * kNTiles * 8;
  const int m0 = blockIdx.y * 16 * MT;
  const int k0 = blockIdx.z * k_per_split;
  const int k1 = min(K, k0 + k_per_split);

  int acc[MT][kNTiles][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // rows g and g + 8 of each m-tile, column g of each n-tile
  const int8_t* xrow[MT][2];
  bool xok[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * i + 8 * h + g;
      xok[i][h] = r < M;
      xrow[i][h] = x + static_cast<size_t>(xok[i][h] ? r : 0) * K;
    }
  const int8_t* wrow[kNTiles];
  bool wok[kNTiles];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int c = n0 + 8 * j + g;
    wok[j] = c < N;
    wrow[j] = wt + static_cast<size_t>(wok[j] ? c : 0) * K;
  }

#pragma unroll 2
  for (int kb = k0; kb < k1; kb += kKStep) {
    const int kk = kb + 16 * t;         // K % 16 == 0: 16 codes in or out
    const bool kin = kk < k1;
    uint4 a[MT][2], b[kNTiles];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) b[j] = load16(wrow[j] + kk, kin && wok[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) a[i][h] = load16(xrow[i][h] + kk, kin && xok[i][h]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        // K slots 4t..4t+3 <- kk+0..3 (x, b.x), 16+4t.. <- kk+4..7 (y)
        mma_s8(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b[j].x,
               b[j].y);
        // second mma: kk+8..11 (z) and kk+12..15 (w)
        mma_s8(acc[i][j], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b[j].z,
               b[j].w);
      }
  }

  // accumulator fragment: rows g (c0, c1) and g + 8 (c2, c3), columns 2t
  // and 2t + 1 of the n-tile
  const bool direct = gridDim.z == 1;
  const float xs = direct ? *x_scale : 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + 16 * i + g + 8 * (r >> 1);
        const int col = n0 + 8 * j + 2 * t + (r & 1);
        if (row >= M || col >= N) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        if (direct) {
          out[o] = descale(acc[i][j][r], w_scales[col], xs);
        } else {
          partial[static_cast<size_t>(blockIdx.z) * M * N + o] = acc[i][j][r];
        }
      }
}

// Sums the splits' int32 partials (exact) and applies the epilogue.
__global__ void w8a8_reduce_kernel(const int32_t* __restrict__ partial,
                                   const float* __restrict__ w_scales,
                                   const float* __restrict__ x_scale,
                                   float* __restrict__ out, int M, int N,
                                   int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  const float xs = *x_scale;
  for (size_t o = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       o < mn; o += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += partial[s * mn + o];
    out[o] = descale(acc, w_scales[o % N], xs);
  }
}

template <int MT>
cudaError_t launch(const int8_t* x, const int8_t* wt, const float* ws,
                   const float* xs, int32_t* partial, float* out, int M,
                   int K, int N, int k_per_split, int splits,
                   cudaStream_t s) {
  dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock,
            (M + 16 * MT - 1) / (16 * MT), splits);
  w8a8_kernel<MT><<<grid, kThreads, 0, s>>>(x, wt, ws, xs, partial, out, M,
                                            K, N, k_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x int8 [M, K]; wt int8 [N, K] (weight codes, transposed); w_scales f32
// [N]; x_scale f32 [1] on the device; partial int32 [splits, M, N] (unused
// when splits == 1); out f32 [M, N].  K % 16 == 0, x and wt 16-byte
// aligned, k_per_split a multiple of 64, m_tiles in {1, 2, 4}.
int w8a8_matmul(const void* x, const void* wt, const void* w_scales,
                const void* x_scale, void* partial, void* out, int M, int K,
                int N, int m_tiles, int k_per_split, int splits,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wt);
  const auto* ws = static_cast<const float*>(w_scales);
  const auto* xs = static_cast<const float*>(x_scale);
  auto* pp = static_cast<int32_t*>(partial);
  auto* op = static_cast<float*>(out);
  cudaError_t e;
  switch (m_tiles) {
    case 1: e = launch<1>(xp, wp, ws, xs, pp, op, M, K, N, k_per_split, splits, s); break;
    case 2: e = launch<2>(xp, wp, ws, xs, pp, op, M, K, N, k_per_split, splits, s); break;
    case 4: e = launch<4>(xp, wp, ws, xs, pp, op, M, K, N, k_per_split, splits, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(std::min<size_t>((mn + 255) / 256, 132 * 8));
  w8a8_reduce_kernel<<<blocks, 256, 0, s>>>(pp, ws, xs, op, M, N, splits);
  return cudaGetLastError();
}

}  // extern "C"
