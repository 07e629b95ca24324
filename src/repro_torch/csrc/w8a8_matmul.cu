// W8A8 matmul for Hopper (sm_90a): int8 activation codes x int8 weight
// codes -> exact int32 sums -> f32 descale, on the int8 tensor cores, in
// one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/packed_matmul.py:_w8a8_kernel,
// reached through w8a8_matmul.  Computes
//   out[m, n] = float(sum_k x[m, k] * w[k, n]) * (w_scales[n] * x_scale)
// with x int8 [M, K] (one per-tensor scale, a device scalar) and w int8
// codes with per-channel f32 scales [N].  The int32 sum is exact and so
// independent of its order; the epilogue converts it with round-to-nearest
// and multiplies by the f32 product w_scales[n] * x_scale, the reference's
// association, so the output equals ref.w8a8_matmul_ref bit for bit.
// No overflow: |sum| <= K * 128 * 128, below 2^31 for K up to 131071
// (minitron-8b's widest K is 16384).  Built without fast-math.
//
// What bounds it on the H100: the weight bytes, K * N (3.35 TB/s), at
// decode (M <= 8) and at a 64-row prefill chunk alike (2 * 64 ops per
// weight byte against ~590 int8 ops per byte at the tensor cores' peak).
// So the design streams the weights and keeps many bytes in flight:
//
// * Layout.  The weight codes are stored transposed, wt [N, K] (each
//   output column's K codes contiguous): 16 output columns x 32 K of wt is
//   exactly the row-major A operand of mma.sync.m16n8k32.s8, and 8 rows of
//   x (K-major) its B operand.  So at decode the weights fill the mma's
//   16-row side and x rows its 8-wide side (rows past M unused); prefill
//   chunks take x rows in groups of 8 (XG groups a block, <= 64 rows).
// * A ring of kStages stages in shared memory, each 64 columns x 512 K of
//   weights (32 KB: 512-byte runs of each weight row, which the HBM serves
//   faster than the 256-byte runs of 128 x 256 tiles) and the block's x
//   rows over the same K, fed with cp.async copies issued kStages - 1
//   stages ahead: up to 64 KB of weights in flight per block, two blocks
//   per SM at decode.  Each x byte is copied once per block and read by
//   all four warps from shared memory.
// * Fragments.  Warp w owns columns [16 kNT w, 16 kNT (w + 1)) of the
//   block (kNT 16-column mma tiles).  Per 64 K, lane (g = lane / 4, t =
//   lane % 4)
//   reads 16 bytes at K offset 16 t of columns g and g + 8 of each tile and
//   of x row g of each group, and feeds two mmas (bytes 0-7, 8-15): the
//   mma's 32 K slots take other K indices than the natural order, the same
//   permutation for A and B, which an exact integer sum does not see.  A
//   staged row's 16-byte chunk c sits at c ^ 4 in odd rows, so the eight
//   lanes of each 128-bit shared load phase hit distinct banks.
// * Any K and any alignment, no copies: the copy width is 16 bytes where
//   the operand and K allow it, else 4, else 1 (plain loads), chosen per
//   operand (the weights' as a template parameter); copies past the split's
//   K are zero-filled.
// * One launch.  K is split so that the grid is one wave of the blocks the
//   SMs hold.  With several splits each block adds its int32 sums into an
//   L2-resident accumulator [M, N] (red.add: exact, so any order gives the
//   same sum); the last block of a tile (a counter per tile) applies the
//   epilogue, zeroes the accumulator and resets the counter, so both are
//   zero again for the next launch on the stream.
//
// C interface: launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // four warps
constexpr int kCols = 64;                      // output columns a block
constexpr int kNT = kCols / 64;                // 16-column mma tiles a warp
constexpr int kBK = 512;                       // K per ring stage
constexpr int kStages = 3;
constexpr int kMaxDevices = 16;

template <int XG>
struct Stage {
  static constexpr int W = kCols * kBK;        // weight bytes
  static constexpr int X = 8 * XG * kBK;       // x bytes (8 XG rows)
  static constexpr int BYTES = W + X;
  static constexpr int SMEM = kStages * BYTES;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of (row, k) in a staged [rows][kBK] tile
__device__ __forceinline__ int swz(int row, int k) {
  return row * kBK + ((((k >> 4) ^ ((row & 1) << 2))) << 4) + (k & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// the first rows of src [*, K] (row stride K), K [kb, kb + kBK), into
// tile; K at or past kend reads as zero.  VEC: bytes a copy, dividing K and
// the address of src.
template <int VEC>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const int8_t* src, int K, int rows,
                                           int kb, int kend) {
  constexpr int PER_ROW = kBK / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, kk = (i % PER_ROW) * VEC;
    const bool in = kb + kk < kend;
    const int8_t* p = in ? src + static_cast<size_t>(r) * K + kb + kk
                         : src;
    unsigned char* d = tile + swz(r, kk);
    if constexpr (VEC == 16) {
      cp_async16(d, p, in);
    } else if constexpr (VEC == 4) {
      cp_async4(d, p, in);
    } else {
      *d = in ? static_cast<unsigned char>(__ldg(p)) : 0;
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float descale(int acc, float w_scale,
                                         float x_scale) {
  return __int2float_rn(acc) * (w_scale * x_scale);
}

// grid (ceil(N / kCols), ceil(M / (8 XG)), splits), kThreads threads,
// Stage<XG>::SMEM bytes of dynamic shared memory.  Split z sums K
// [z * k_per_split, min(K, (z + 1) * k_per_split)), k_per_split a multiple
// of kBK.  accum int32 [M, N] and counters (one per tile) are zero.
template <int VW, int XG>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
            const float* __restrict__ w_scales,
            const float* __restrict__ x_scale, int32_t* __restrict__ accum,
            int* __restrict__ counters, float* __restrict__ out, int M, int K,
            int N, int k_per_split, int xvec) {
  using S = Stage<XG>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * 8 * XG;
  const int splits = gridDim.z;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int nst = (kend - kbeg + kBK - 1) / kBK;
  const int wrows = min(kCols, N - n0), xrows = min(8 * XG, M - m0);
  const int8_t* wsrc = wt + static_cast<size_t>(n0) * K;
  const int8_t* xsrc = x + static_cast<size_t>(m0) * K;

  // rows past N or M are not copied: they feed only outputs never stored
  auto load = [&](int s) {
    unsigned char* st = smem + (s % kStages) * S::BYTES;
    const int kb = kbeg + s * kBK;
    stage_rows<VW>(st, wsrc, K, wrows, kb, kend);
    if (xvec == 16) {
      stage_rows<16>(st + S::W, xsrc, K, xrows, kb, kend);
    } else if (xvec == 4) {
      stage_rows<4>(st + S::W, xsrc, K, xrows, kb, kend);
    } else {
      stage_rows<1>(st + S::W, xsrc, K, xrows, kb, kend);
    }
  };

  int acc[kNT][XG][4];
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int j = 0; j < XG; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load(s);
    cp_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_wait_ring();
    __syncthreads();      // stage it landed; slot (it - 1) % kStages free
    if (it + kStages - 1 < nst) load(it + kStages - 1);
    cp_commit();
    const unsigned char* ws = smem + (it % kStages) * S::BYTES;
    const unsigned char* xs = ws + S::W;
#pragma unroll
    for (int j = 0; j < kBK / 64; ++j) {
      const int kk = 64 * j + 16 * t;
      uint4 a[kNT][2];
#pragma unroll
      for (int c = 0; c < kNT; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[c][h] = *reinterpret_cast<const uint4*>(
              ws + swz(16 * kNT * warp + 16 * c + 8 * h + g, kk));
#pragma unroll
      for (int q = 0; q < XG; ++q) {
        const uint4 b =
            *reinterpret_cast<const uint4*>(xs + swz(8 * q + g, kk));
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          mma_s8(acc[c][q], a[c][0].x, a[c][1].x, a[c][0].y, a[c][1].y, b.x,
                 b.y);
          mma_s8(acc[c][q], a[c][0].z, a[c][1].z, a[c][0].w, a[c][1].w, b.z,
                 b.w);
        }
      }
    }
  }

  // accumulator fragment: c0 (column g, x row 2t), c1 (g, 2t + 1), c2
  // (g + 8, 2t), c3 (g + 8, 2t + 1) of each tile and group
  const float xsc = *x_scale;
  float wsc[kNT][2];
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 16 * kNT * warp + 16 * c + 8 * h + g;
      wsc[c][h] = col < N ? w_scales[col] : 0.f;
    }
  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < kNT; ++c)
#pragma unroll
      for (int q = 0; q < XG; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = n0 + 16 * kNT * warp + 16 * c + g + 8 * (r >> 1);
          const int row = m0 + 8 * q + 2 * t + (r & 1);
          if (row < M && col < N)
            out[static_cast<size_t>(row) * N + col] =
                descale(acc[c][q][r], wsc[c][r >> 1], xsc);
        }
  };
  if (splits == 1) {
    store();
    return;
  }
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int q = 0; q < XG; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n0 + 16 * kNT * warp + 16 * c + g + 8 * (r >> 1);
        const int row = m0 + 8 * q + 2 * t + (r & 1);
        if (row < M && col < N)
          atomicAdd(accum + static_cast<size_t>(row) * N + col, acc[c][q][r]);
      }

  // the last block of this tile applies the epilogue: every thread's adds
  // are fenced before the barrier, then thread 0's acquire-release add on
  // the tile's counter publishes them and, for the last block, makes every
  // other split's visible
  __threadfence();
  __syncthreads();
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counter)
                 : "memory");
    last_block = before == splits - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // all the tile's sums in flight at once, then the epilogue; the
  // accumulator is left zero
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int q = 0; q < XG; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n0 + 16 * kNT * warp + 16 * c + g + 8 * (r >> 1);
        const int row = m0 + 8 * q + 2 * t + (r & 1);
        const size_t o = static_cast<size_t>(row) * N + col;
        acc[c][q][r] = row < M && col < N ? __ldcg(accum + o) : 0;
      }
  store();
#pragma unroll
  for (int c = 0; c < kNT; ++c)
#pragma unroll
    for (int q = 0; q < XG; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = n0 + 16 * kNT * warp + 16 * c + g + 8 * (r >> 1);
        const int row = m0 + 8 * q + 2 * t + (r & 1);
        if (row < M && col < N) accum[static_cast<size_t>(row) * N + col] = 0;
      }
  if (threadIdx.x == 0) *counter = 0;
}

// the dynamic shared memory attribute, once per kernel and device
template <typename Kernel>
cudaError_t set_smem_attribute(Kernel* kernel, int smem,
                               bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int VW, int XG>
cudaError_t launch(const int8_t* x, const int8_t* wt, const float* ws,
                   const float* xs, int32_t* accum, int* counters, float* out,
                   int M, int K, int N, int k_per_split, int splits, int xvec,
                   cudaStream_t s) {
  static bool ready[kMaxDevices] = {};
  cudaError_t e = set_smem_attribute(w8a8_kernel<VW, XG>, Stage<XG>::SMEM,
                                     ready);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kCols - 1) / kCols, (M + 8 * XG - 1) / (8 * XG), splits);
  w8a8_kernel<VW, XG><<<grid, kThreads, Stage<XG>::SMEM, s>>>(
      x, wt, ws, xs, accum, counters, out, M, K, N, k_per_split, xvec);
  return cudaGetLastError();
}

template <int VW>
cudaError_t launch_vw(const int8_t* x, const int8_t* wt, const float* ws,
                      const float* xs, int32_t* accum, int* counters,
                      float* out, int M, int K, int N, int x_groups,
                      int k_per_split, int splits, int xvec, cudaStream_t s) {
  switch (x_groups) {
    case 1: return launch<VW, 1>(x, wt, ws, xs, accum, counters, out, M, K, N, k_per_split, splits, xvec, s);
    case 2: return launch<VW, 2>(x, wt, ws, xs, accum, counters, out, M, K, N, k_per_split, splits, xvec, s);
    case 4: return launch<VW, 4>(x, wt, ws, xs, accum, counters, out, M, K, N, k_per_split, splits, xvec, s);
    case 8: return launch<VW, 8>(x, wt, ws, xs, accum, counters, out, M, K, N, k_per_split, splits, xvec, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int XG>
cudaError_t occupancy(int* blocks_per_sm) {
  static bool ready[kMaxDevices] = {};
  cudaError_t e = set_smem_attribute(w8a8_kernel<16, XG>, Stage<XG>::SMEM,
                                     ready);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, w8a8_kernel<16, XG>, kThreads, Stage<XG>::SMEM);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the x_groups body one SM holds on the current device.
int w8a8_blocks_per_sm(int x_groups, int* blocks_per_sm) {
  switch (x_groups) {
    case 1: return occupancy<1>(blocks_per_sm);
    case 2: return occupancy<2>(blocks_per_sm);
    case 4: return occupancy<4>(blocks_per_sm);
    case 8: return occupancy<8>(blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// x int8 [M, K]; wt int8 [N, K] (weight codes, transposed); w_scales f32
// [N]; x_scale f32 [1] on the device; out f32 [M, N]; accum int32 [M, N]
// and counters int32 [ceil(N / 64) * ceil(M / (8 x_groups))], zero (the
// kernel leaves them zero), for launches on one stream at a time; unused
// with one split.  x_groups in {1, 2, 4, 8}; k_per_split a multiple of 512;
// wvec / xvec (16, 4 or 1) divide K and the address of wt / x.
int w8a8_matmul(const void* x, const void* wt, const void* w_scales,
                const void* x_scale, void* accum, void* counters, void* out,
                int M, int K, int N, int x_groups, int k_per_split,
                int splits, int wvec, int xvec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wt);
  const auto* ws = static_cast<const float*>(w_scales);
  const auto* xs = static_cast<const float*>(x_scale);
  auto* ap = static_cast<int32_t*>(accum);
  auto* cp = static_cast<int*>(counters);
  auto* op = static_cast<float*>(out);
  if (M < 1 || K < 1 || N < 1 || k_per_split % kBK != 0 ||
      (K + k_per_split - 1) / k_per_split != splits)
    return cudaErrorInvalidValue;
  switch (wvec) {
    case 16: return launch_vw<16>(xp, wp, ws, xs, ap, cp, op, M, K, N, x_groups, k_per_split, splits, xvec, s);
    case 4: return launch_vw<4>(xp, wp, ws, xs, ap, cp, op, M, K, N, x_groups, k_per_split, splits, xvec, s);
    case 1: return launch_vw<1>(xp, wp, ws, xs, ap, cp, op, M, K, N, x_groups, k_per_split, splits, xvec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
