// Packed-weight mixed-precision GEMV and matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/packed_matmul.py:
// _packed_matmul_kernel, as reached through packed_gemv (M <= 8, every
// decode linear: K1) and packed_matmul (M > 8, every prefill-chunk linear,
// and the decode shapes K1 does not take: K2).
//
// Computes out[M, N] (f32) = x[M, K] (bf16) @ W[K, N], where W is stored as
// int32 words [K/per, N] holding per = 8 (int4, fp4 e2m1) or 4 (fp8 e4m3)
// codes little-endian along K, plus f32 scales [K/group, N] ([1, N] per
// channel).  Each code is decoded arithmetically (two's complement int;
// e2m1 / e4m3 with a zero exponent read as 0 and the e4m3 NaN code read as
// 0) and accumulated in f32.  K1 multiplies each code by its group scale
// before the sum (the reference's fused-dequant association); K2 sums
// x * code per scale group and then multiplies the group's f32 partial by
// its scale.  Both differ from the reference only in the order and
// association of f32 operations.
//
// What bounds them on the H100:
//  * GEMV (M <= 8, K1): the bytes of the packed words and scales (3.35
//    TB/s); there are at most 16 flops per weight byte.  Each thread
//    streams four neighbouring columns with one 16-byte load per word row
//    (a warp reads 512 contiguous bytes), decodes in registers and keeps
//    M x 4 f32 sums.  K is split across blocks so that a narrow N still
//    fills the 132 SMs; the split-K partials go to an f32 scratch and a
//    second kernel sums them in a fixed order, so results are
//    deterministic run to run.
//  * matmul (K2): at a 64-row prefill chunk, still the bytes (2 * 64 flops
//    per 4-bit weight, ~256 per byte, below the ~295 at which bf16 tensor
//    cores become the limit); in practice x, which every column tile reads
//    whole through L2, and the mma.sync issue.  It runs on the bf16
//    tensor cores (mma.sync m16n8k16), decoding each packed word once per
//    block into bf16 registers, with x and the words staged through a
//    3-stage cp.async ring.  Tiles of 64 columns (128 for 4-bit codes,
//    half the x traffic) fill the SMs at N = 14336; K is split (same
//    fixed-order reduction as the GEMV) only where the grid would hold
//    fewer than two blocks per SM, as at N = 4096 and 1024.
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
// Matmul (K2) on the bf16 tensor cores: mma.sync.m16n8k16, f32 accumulate.
//
// The mma computes out^T = W^T x^T: its 16 "rows" are 16 output columns
// (the decoded weights are the A operand, made in registers) and its 8
// "columns" are 8 rows of x (the B operand, read from shared memory).
// Block: BM = 8 MT rows of x by BN = 64 NT columns; 4 warps side by side,
// warp w owns columns [16 NT w, 16 NT (w + 1)) and all BM rows.  K
// advances in stages of 128 through a 3-stage cp.async ring (16-byte
// copies of x and of the packed words, zero-filled past M, N and the
// split's K; 4-byte word copies where N % 4 != 0 or a pointer is not
// 16-byte aligned).  Each block walks its stages starting at stage
// blockIdx.x % stages, so the column tiles of a row tile do not all read
// the same K of x at once; the order is fixed per tile (deterministic).
//
// The unit of work is 4 words of one column, UNIT = 4 * PER codes of K
// (32 for int4 / fp4, 16 for fp8).  Thread (g = lane / 4, t = lane % 4)
// decodes word t of columns g and g + 8 to bf16 pairs in registers and
// feeds them to PER / 4 mmas; its mma K slots (2t, 2t + 1, 2t + 8,
// 2t + 9) take codes PER t + 4j + (0, 1, 2, 3) of the unit in mma j, and
// the x operand takes x at the same K (one 16- or 8-byte shared load per
// 8-row tile, whose halves are the B registers as they land), so every K
// slot pairs the same K in both operands.  Each code is exact in bf16
// (int4 -8..7; e2m1 and e4m3 have at most 3 mantissa bits and exponents
// within bf16's range), so each product x * code is exact and the tensor
// cores sum it in f32.  The group scale is applied to f32 partials: `part`
// sums one scale group (a unit for mxfp4's 32, a stage for awq_int4's
// 128) and is folded as acc += s[g, n] * part at the group's end; a
// per-channel scale (fp8) multiplies the split's whole sum once.  The
// scale is never folded into the bf16 operand.
// ---------------------------------------------------------------------------
constexpr int kMmThreads = 128;
constexpr int kMmBK = 128;                  // K per pipeline stage
constexpr int kMmStages = 3;
constexpr int kMmScaleRows = kMmBK / 32;    // scale groups per stage
// when a scale group's f32 partial is scaled into the sum: after every
// unit (group 32, 4-bit codes), after every stage (group 128), or once
// after the split (one group: a per-channel scale)
enum FoldMode { kFoldUnit = 0, kFoldStage = 1, kFoldEnd = 2 };

template <int FMT> struct MmFmt {
  static constexpr int PER = 32 / FormatBits<FMT>::value;
  static constexpr int UNIT = 4 * PER;
  // x row padding (bf16) that keeps the x-operand loads free of bank
  // conflicts: a row is 320 bytes (16-byte loads) or 288 (8-byte loads)
  static constexpr int XPAD = PER == 8 ? 32 : 16;
};

// MT 8-row tiles of x (2: M <= 16; 8: a 64-row prefill chunk), NT
// 16-column tiles per warp.
template <int FMT, int MT, int NT> struct MmTile {
  static constexpr int PER = MmFmt<FMT>::PER;
  static constexpr int BM = 8 * MT, BN = 64 * NT;
  static constexpr int XLD = kMmBK + MmFmt<FMT>::XPAD;  // bf16 per x row
  static constexpr int WROWS = kMmBK / PER;             // word rows
  static constexpr int WLD = BN + 8;      // words per row: quads hit 32 banks
  static constexpr int X_BYTES = BM * XLD * 2;
  static constexpr int W_BYTES = WROWS * WLD * 4;
  static constexpr int S_BYTES = kMmScaleRows * BN * 4;
  static constexpr int STAGE = X_BYTES + W_BYTES + S_BYTES;
  static constexpr int SMEM = kMmStages * STAGE;
};

// cp.async of 16 / 4 bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The codes of one word as bf16 pairs: pair p holds code 2p (low half) and
// code 2p + 1 (high half), bit for bit decode_code's value (DAZ, the e4m3
// NaN code as 0).  kernels/packed_matmul.py:kernel_decode_bf16 is its twin.
template <int FMT>
__device__ __forceinline__ void decode_pairs(
    uint32_t w, uint32_t (&out)[MmFmt<FMT>::PER / 2]) {
  if constexpr (FMT == INT4) {
    // offset binary c ^ 8 as the mantissa of 128.0: 128 + c + 8, minus 136
    w ^= 0x88888888u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t r =
          ((w >> (8 * p)) & 0xFu) | (((w >> (8 * p + 4)) & 0xFu) << 16);
      uint32_t v;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(v)
          : "r"(r | 0x43004300u), "r"(0x3F803F80u), "r"(0xC308C308u));
      out[p] = v;
    }
  } else if constexpr (FMT == FP4_E2M1) {
    // (e, m) << 6 is bf16's (exponent, mantissa) less the bias 126
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t r =
          ((w >> (8 * p)) & 0xFu) | (((w >> (8 * p + 4)) & 0xFu) << 16);
      const uint32_t keep = __vcmpne2(r & 0x00060006u, 0u);
      out[p] = ((((r & 0x00070007u) << 6) + 0x3F003F00u) & keep) |
               ((r & 0x00080008u) << 12);
    }
  } else {
    // (e, m) << 4 is bf16's (exponent, mantissa) less the bias 120
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t r =
          ((w >> (16 * p)) & 0xFFu) | (((w >> (16 * p + 8)) & 0xFFu) << 16);
      const uint32_t mag = r & 0x007F007Fu;
      const uint32_t keep =
          __vcmpne2(r & 0x00780078u, 0u) & __vcmpne2(mag, 0x007F007Fu);
      out[p] = (((mag << 4) + 0x3C003C00u) & keep) | ((r & 0x00800080u) << 8);
    }
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits).  Split z sums K rows
// [z * k_per_split, min(K, (z + 1) * k_per_split)) into out[z] (the output
// itself when there is one split).  x rows are ldx apart (ldx % 8 == 0,
// zero past K); vec: N % 4 == 0 and w, scales 16-byte aligned; fold_mode:
// when a group's f32 partial is scaled into the sum (FoldMode).
template <int FMT, int MT, int NT>
__global__ void __launch_bounds__(kMmThreads, 2)
packed_mma_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                  const int32_t* __restrict__ w,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int M, int K, int N, int group, int k_per_split, int vec,
                  int fold_mode) {
  using T = MmTile<FMT, MT, NT>;
  constexpr int PER = T::PER, UNIT = MmFmt<FMT>::UNIT;
  constexpr int BM = T::BM, BN = T::BN, XLD = T::XLD, WLD = T::WLD;
  constexpr int XCH = BM * (kMmBK / 8) / kMmThreads;   // x chunks / thread
  constexpr int WCH = T::WROWS * (BN / 4) / kMmThreads;
  static_assert(XCH * kMmThreads == BM * (kMmBK / 8), "x chunks");
  static_assert(WCH * kMmThreads == T::WROWS * (BN / 4), "word chunks");
  extern __shared__ __align__(16) unsigned char mm_smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int kwend = kend / PER;       // K and split ends are whole words
  const int nk = (kend - kbeg + kMmBK - 1) / kMmBK;
  const int rot = blockIdx.x % nk;
  const int wcol = warp * 16 * NT;    // the warp's first column
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(mm_smem));

  // Each thread's copies: x chunks (rows xr0 + 16 i, K offset xkc) and
  // 16-byte word chunks (word rows wr + (kMmThreads / (BN / 4)) i, columns
  // wnc .. wnc + 3), the same in every stage.
  const int xr0 = tid / (kMmBK / 8), xkc = (tid % (kMmBK / 8)) * 8;
  const __nv_bfloat16* xsrc = x + static_cast<size_t>(m0 + xr0) * ldx + xkc;
  const int wr = tid / (BN / 4), wnc = (tid % (BN / 4)) * 4;

  auto stage_k0 = [&](int it) {
    const int st = it + rot;
    return kbeg + (st < nk ? st : st - nk) * kMmBK;
  };

  auto load = [&](int slot, int it) {
    const int k0 = stage_k0(it);
    const unsigned st = sbase + slot * T::STAGE;
    const bool kin = k0 + xkc < kend;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int r = xr0 + (kMmThreads / (kMmBK / 8)) * i;
      const bool ok = kin && m0 + r < M;
      cp_async16(st + (r * XLD + xkc) * 2,
                 ok ? xsrc + static_cast<size_t>(r - xr0) * ldx + k0 : x, ok);
    }
    const unsigned ws = st + T::X_BYTES;
    const int wr0 = k0 / PER;
    if (vec) {
#pragma unroll
      for (int i = 0; i < WCH; ++i) {
        const int r = wr + (kMmThreads / (BN / 4)) * i;
        const bool ok = wr0 + r < kwend && n0 + wnc < N;
        cp_async16(ws + (r * WLD + wnc) * 4,
                   ok ? w + static_cast<size_t>(wr0 + r) * N + n0 + wnc : w, ok);
      }
    } else {
      for (int c = tid; c < T::WROWS * BN; c += kMmThreads) {
        const int r = c / BN, nc = c % BN;
        const bool ok = wr0 + r < kwend && n0 + nc < N;
        cp_async4(ws + (r * WLD + nc) * 4,
                  ok ? w + static_cast<size_t>(wr0 + r) * N + n0 + nc : w, ok);
      }
    }
    // the scale rows of the groups this stage touches (one per unit when
    // a group is a unit; rows past the split zero-filled)
    const unsigned ss = ws + T::W_BYTES;
    const int g0 = k0 / group;
    const int rows = fold_mode == kFoldUnit ? kMmBK / UNIT
                     : fold_mode == kFoldStage;
    for (int c = tid; c < rows * (vec ? BN / 4 : BN); c += kMmThreads) {
      const int per_row = vec ? BN / 4 : BN;
      const int r = c / per_row, nc = (c % per_row) * (vec ? 4 : 1);
      const bool ok = n0 + nc < N && (g0 + r) * group < kend;
      const float* src =
          ok ? scales + static_cast<size_t>(g0 + r) * N + n0 + nc : scales;
      if (vec) cp_async16(ss + (r * BN + nc) * 4, src, ok);
      else cp_async4(ss + (r * BN + nc) * 4, src, ok);
    }
  };

  // thread (g, t) of the warp: out[rows 2t, 2t + 1 of each 8-row tile]
  // [columns g (c0, c1) and g + 8 (c2, c3) of each 16-column tile]
  float acc[NT][MT][4], part[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][i][r] = part[j][i][r] = 0.f;

  // acc += s[group, column] * part, then part = 0
  auto fold_group = [&](const float* srow) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float s0 = srow[wcol + 16 * j + g], s1 = srow[wcol + 16 * j + g + 8];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[j][i][0] = fmaf(s0, part[j][i][0], acc[j][i][0]);
        acc[j][i][1] = fmaf(s0, part[j][i][1], acc[j][i][1]);
        acc[j][i][2] = fmaf(s1, part[j][i][2], acc[j][i][2]);
        acc[j][i][3] = fmaf(s1, part[j][i][3], acc[j][i][3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) part[j][i][r] = 0.f;
      }
    }
  };

  // Groups end with every unit (kFoldUnit), with every stage (kFoldStage)
  // or with the split (kFoldEnd: one group, all of K).  Every unit of a
  // stage is computed, with no branch between units: past the split's end
  // x, the words and the scales were zero-filled, so they add 0.
  auto compute = [&](int slot) {
    const unsigned char* st = mm_smem + slot * T::STAGE;
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const auto* ws = reinterpret_cast<const uint32_t*>(st + T::X_BYTES);
    const auto* ss = reinterpret_cast<const float*>(st + T::X_BYTES + T::W_BYTES);
#pragma unroll
    for (int u = 0; u < kMmBK / UNIT; ++u) {
      uint32_t xb[MT][PER / 2];         // B: x rows g of each 8-row tile
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* xr = xs + (8 * i + g) * XLD + u * UNIT + PER * t;
        if constexpr (PER == 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr);
          xb[i][0] = v.x; xb[i][1] = v.y; xb[i][2] = v.z; xb[i][3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(xr);
          xb[i][0] = v.x; xb[i][1] = v.y;
        }
      }
      uint32_t wa[NT][2][PER / 2];      // A: columns g and g + 8
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          decode_pairs<FMT>(ws[(u * 4 + t) * WLD + wcol + 16 * j + 8 * h + g],
                            wa[j][h]);
#pragma unroll
      for (int jj = 0; jj < PER / 4; ++jj)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma_bf16(part[j][i], wa[j][0][2 * jj], wa[j][1][2 * jj],
                     wa[j][0][2 * jj + 1], wa[j][1][2 * jj + 1],
                     xb[i][2 * jj], xb[i][2 * jj + 1]);
      if (fold_mode == kFoldUnit) fold_group(ss + u * BN);
    }
    if (fold_mode == kFoldStage) fold_group(ss);
  };

#pragma unroll
  for (int s = 0; s < kMmStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kMmStages - 2>();
    __syncthreads();       // stage it landed for all; stage it - 1 consumed
    const int nx = it + kMmStages - 1;
    if (nx < nk) load(nx % kMmStages, nx);
    cp_async_commit();
    compute(it % kMmStages);
  }

  if (fold_mode == kFoldEnd) {   // one group: the per-channel scale, once
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + wcol + 16 * j + 8 * h + g;
        const float sc = col < N ? scales[col] : 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          acc[j][i][2 * h] = sc * part[j][i][2 * h];
          acc[j][i][2 * h + 1] = sc * part[j][i][2 * h + 1];
        }
      }
  }

  float* o = out + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + 8 * i + 2 * t + (r & 1);
        const int col = n0 + wcol + 16 * j + 8 * (r >> 1) + g;
        if (row < M && col < N) o[static_cast<size_t>(row) * N + col] = acc[j][i][r];
      }
}

// Sets a kernel's shared-memory attributes once per device, at its first
// launch there: the dynamic shared-memory limit, and a carveout that gives
// shared memory all of the SM's 228 KB.  (Setting them at every launch
// costs host time on each call of the serving loop.)
constexpr int kMaxDevices = 16;

template <typename Kernel>
cudaError_t set_smem_attributes(Kernel* kernel, int smem,
                                bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kMaxDevices && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <int FMT, int MT, int NT>
cudaError_t launch_mma(const __nv_bfloat16* x, int ldx, const int32_t* w,
                       const float* scales, float* out, int M, int K, int N,
                       int group, int k_per_split, int splits, int vec,
                       cudaStream_t stream) {
  using T = MmTile<FMT, MT, NT>;
  const int fold_mode = group == K ? kFoldEnd
                        : group == kMmBK ? kFoldStage
                        : group == MmFmt<FMT>::UNIT ? kFoldUnit : -1;
  if (fold_mode < 0) return cudaErrorInvalidValue;
  static bool ready[kMaxDevices] = {};
  cudaError_t e =
      set_smem_attributes(packed_mma_kernel<FMT, MT, NT>, T::SMEM, ready);
  if (e != cudaSuccess) return e;
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  packed_mma_kernel<FMT, MT, NT><<<grid, kMmThreads, T::SMEM, stream>>>(
      x, ldx, w, scales, out, M, K, N, group, k_per_split, vec, fold_mode);
  return cudaGetLastError();
}

// m_tiles: 16-row tiles of the block (1 or 4), n_tiles: 64-column tiles
template <int FMT>
cudaError_t launch_mma_fmt(const __nv_bfloat16* x, int ldx, const int32_t* w,
                           const float* scales, float* out, int M, int K,
                           int N, int group, int m_tiles, int n_tiles,
                           int k_per_split, int splits, int vec,
                           cudaStream_t s) {
#define MMA_CASE(MTL, NTL)                                                   \
  if (m_tiles == MTL && n_tiles == NTL)                                      \
    return launch_mma<FMT, 2 * MTL, NTL>(x, ldx, w, scales, out, M, K, N,    \
                                         group, k_per_split, splits, vec, s);
  MMA_CASE(1, 1) MMA_CASE(4, 1) MMA_CASE(4, 2)
#undef MMA_CASE
  return cudaErrorInvalidValue;
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

// x bf16 [M, ldx] (ldx % 8 == 0, 16-byte aligned, zero in columns
// K..ldx); w int32 [K/per, N]; scales f32 [ceil(K/group), N]; partial f32
// [splits, M, N] scratch (unused for one split); out f32 [M, N].  group is
// K (one group), 128, or 32 for the 4-bit formats;
// k_per_split a multiple of 128; m_tiles (16 rows) in {1, 4}, n_tiles (64
// columns) 1, or 2 with m_tiles 4;
// vec: N % 4 == 0 and 16-byte aligned w and scales; fmt as above.
int packed_matmul(const void* x, int ldx, const void* w, const void* scales,
                  void* partial, void* out, int M, int K, int N, int fmt,
                  int group, int m_tiles, int n_tiles, int k_per_split,
                  int splits, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  cudaError_t e;
  switch (fmt) {
    case INT4:
      e = launch_mma_fmt<INT4>(xb, ldx, wp, sp, dst, M, K, N, group, m_tiles,
                               n_tiles, k_per_split, splits, vec, s);
      break;
    case FP4_E2M1:
      e = launch_mma_fmt<FP4_E2M1>(xb, ldx, wp, sp, dst, M, K, N, group,
                                   m_tiles, n_tiles, k_per_split, splits, vec,
                                   s);
      break;
    case FP8_E4M3:
      e = launch_mma_fmt<FP8_E4M3>(xb, ldx, wp, sp, dst, M, K, N, group,
                                   m_tiles, n_tiles, k_per_split, splits, vec,
                                   s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return e;
  const int mn = M * N;
  splitk_reduce_kernel<<<(mn + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), mn, splits);
  return cudaGetLastError();
}

}  // extern "C"
