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
// 0) into bf16, where it is exact, and the tensor cores sum x * code in
// f32.  Both kernels sum x * code per scale group and then multiply the
// group's f32 partial by its scale; they differ from the reference (which
// scales each code before the sum) only in the order and association of
// f32 operations.
//
// What bounds them on the H100:
//  * GEMV (M <= 8, K1): the bytes of the packed words and scales (3.35
//    TB/s; at most 16 flops per weight byte) -- in practice, at these
//    sizes, each block's latency chain and the decode's instructions.
//    The math runs on the bf16 tensor cores (the <= 8 rows of x are the
//    mma's B operand), the decode makes two codes per integer op, the
//    words stream through a 3-stage ring of Tensor Memory Accelerator bulk
//    copies (one 512-byte row a copy), K is split until the grid holds up
//    to four blocks per SM, and the splits are summed in the same launch
//    (the last block of a column tile, in fixed order).
//  * matmul (K2): at a 64-row prefill chunk, still the bytes (2 * 64 flops
//    per 4-bit weight, ~256 per byte, below the ~295 at which bf16 tensor
//    cores become the limit); in practice x, which every column tile reads
//    whole through L2, and the mma.sync issue.  It runs on the bf16
//    tensor cores (mma.sync m16n8k16), decoding each packed word once per
//    block into bf16 registers, with x and the words staged through a
//    3-stage cp.async ring.  Tiles of 64 columns (128 for 4-bit codes,
//    half the x traffic) fill the SMs at N = 14336; K is split (partials
//    summed in a fixed order by a second kernel) only where the grid would
//    hold fewer than two blocks per SM, as at N = 4096 and 1024.
//
// Expert-grouped forms run over a stack of expert leaves, as the
// reference's repro/models/moe.py:_expert_ffn reaches _packed_matmul_kernel
// through jax.vmap over the expert axis: one launch per leaf, group g
// multiplying its own M rows of x by the leaf of expert expert[g].  Expert
// ids and row counts are read on the device, so the host neither learns
// which experts hold tokens nor launches per expert; a group's rows past
// rows[g] are written as zeros.  Every grouped launch, decode pairs and
// capacity buffers of any height alike (grouped K1 at M <= 8, grouped K2
// past it), runs one persistent body (grouped_gemv_kernel, below): it
// merges the rows that name one expert into items, so an expert's words
// are read once per item, and walks the work with whole-tile TMA copies,
// summing in an order fixed by the leaf alone.
//
// C interface: every entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

enum Format { INT4 = 0, FP4_E2M1 = 1, FP8_E4M3 = 2 };

template <int FMT> struct FormatBits { static constexpr int value = 4; };
template <> struct FormatBits<FP8_E4M3> { static constexpr int value = 8; };

// The expert grouping of a grouped launch: group g multiplies x rows
// [g M, g M + M) by the words and scales of expert expert[g] into output
// rows [g M, g M + M), of which its first rows[g] hold data; the grouped
// body reads expert and rows into its work list.
struct ExpertGroups {
  const int32_t* expert;   // [G] expert of each group, in [0, n_experts)
  const int32_t* rows;     // [G] rows of each group that hold data (<= M)
  int n_groups;            // G
  int n_experts;           // experts in the leaf's stack
};

// Group gi's expert (trapping on an id outside the stack, which would
// read past the weights) and its rows that hold data, clamped to [0, M].
__device__ __forceinline__ int group_expert(const ExpertGroups& eg, int gi) {
  const int e = eg.expert[gi];
  if (e < 0 || e >= eg.n_experts) __trap();
  return e;
}

__device__ __forceinline__ int group_rows(const ExpertGroups& eg, int gi,
                                          int M) {
  return min(M, max(0, eg.rows[gi]));
}

// The fixed-order sum of K2's split-K partials: out = p[0] + p[1] + ...
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int mn,
                                     int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * mn + i];
  out[i] = s;
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
  float* o = out + static_cast<size_t>(blockIdx.z) * M * N;
  const int split = blockIdx.z, rows = M;   // rows of x that hold data
  const int kbeg = split * k_per_split;
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
      const bool ok = kin && m0 + r < rows;
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
  if (fold_mode < 0 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  static bool ready[kMaxDevices] = {};
  cudaError_t e = set_smem_attributes(packed_mma_kernel<FMT, MT, NT>,
                                      T::SMEM, ready);
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

// ---------------------------------------------------------------------------
// GEMV (K1) on the bf16 tensor cores, 1 <= M <= 8: mma.sync.m16n8k16 with
// the decoded weights as A (16 output columns) and x as B (its <= 8 rows
// fill the mma's 8-wide operand; rows past M are zero).
//
// Grid (ceil(N / 128), splits); 128 threads, warp w owns the 32 columns
// [c0 + 32 w, c0 + 32 w + 32) of the block's 128 and the split's whole K.
// A stage is 16 word rows (128 K for 4-bit codes, 64 for fp8) of the
// block's 128 columns plus the scale rows of the groups that end in it.
// Thread 0 copies each stage with the Tensor Memory Accelerator's bulk
// copies (one 512-byte row each, cp.async.bulk) into a 3-stage ring that
// completes on one mbarrier per stage, so the words move in few large
// requests and no thread spends registers or instructions on them; x's
// slice of the split (M rows) arrives once per block the same way.  At
// most ~56 KB of shared memory a block, so four blocks share an SM and a
// grid of up to 528 blocks is resident at once: what bounds a decode leaf
// is the latency chain of each block (copy, compute, partial, counter),
// so the plan fills one such wave.
//
// A unit is 4 word rows (32 K; 16 for fp8): thread (g = lane / 4, t = lane
// % 4) reads word row t of its warp's columns 4g .. 4g + 3 (16 bytes; rows
// padded to 544 bytes so the warp's reads hit all 32 banks once).  The
// mma's A rows g and g + 8 are the thread's columns 4g + 2j and 4g + 2j + 1
// (j = 0, 1: two 16-column mma tiles per warp), so one 16-byte read feeds
// both tiles and the f32 sums of x rows 2t, 2t + 1 leave as 16-byte
// stores of 4 columns.  The decode makes pair p of a word from codes p and
// p + PER / 2 (nibbles p, p + 4 of a 4-bit word; bytes p, p + 2 of an fp8
// word) in one or two integer ops; the x pair beside it is permuted to the
// same two K as it is read.  Decoded codes are exact in bf16, so the
// tensor cores sum exact products in f32.  The group scale multiplies the
// f32 partial of its group after the group's last unit (a per-channel
// scale multiplies the split's sum once), never the bf16 operand: K2's
// association.
//
// With splits > 1 each block writes its f32 partial [M, 128] to a scratch;
// the last block of a column tile to finish (a counter per tile, reset by
// that block) sums the tile's partials in split order 0, 1, ... and
// writes the output, so one launch does all and results do not depend on
// which block finishes last.  kernels/packed_matmul.py:packed_gemv_ordered
// is its plain twin in that association and order.
// ---------------------------------------------------------------------------
constexpr int kGvThreads = 128;
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvCols = 32 * kGvWarps;
constexpr int kGvUnits = 4;                  // units per ring stage
constexpr int kGvRows = 4 * kGvUnits;        // word rows per stage
constexpr int kGvStages = 3;
constexpr int kGvRowBytes = kGvCols * 4 + 32;   // 544: 136 words, 8 mod 32
constexpr int kGvWordBytes = kGvStages * kGvRows * kGvRowBytes;
constexpr int kGvScaleBytes = kGvStages * kGvUnits * kGvCols * 4;
constexpr int kGvXElems = 11776;             // M x K of x a block stages
constexpr int kGvMaxSmem =
    kGvWordBytes + kGvScaleBytes + 2 * (kGvXElems + 8 * 32);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "GV_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra GV_WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The codes of one word as bf16 pairs, pair p holding codes p (low half)
// and p + PER / 2 (high half), bit for bit decode_pairs' values.
template <int FMT>
__device__ __forceinline__ void decode_split_pairs(
    uint32_t w, uint32_t (&out)[MmFmt<FMT>::PER / 2]) {
  if constexpr (FMT == INT4) {
    w ^= 0x88888888u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t r = ((w >> (4 * p)) & 0x000F000Fu) | 0x43004300u;
      uint32_t v;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(v)
          : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
      out[p] = v;
    }
  } else if constexpr (FMT == FP4_E2M1) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t r = (w >> (4 * p)) & 0x000F000Fu;
      const uint32_t keep = __vcmpne2(r & 0x00060006u, 0u);
      out[p] = ((((r & 0x00070007u) << 6) + 0x3F003F00u) & keep) |
               ((r & 0x00080008u) << 12);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t r = (w >> (8 * p)) & 0x00FF00FFu;
      const uint32_t mag = r & 0x007F007Fu;
      const uint32_t keep =
          __vcmpne2(r & 0x00780078u, 0u) & __vcmpne2(mag, 0x007F007Fu);
      out[p] = (((mag << 4) + 0x3C003C00u) & keep) | ((r & 0x00800080u) << 8);
    }
  }
}

// x rows are ldx apart (ldx % 8 == 0, zero in columns K..ldx); split z sums
// K rows [z * k_per_split, min(K, (z + 1) * k_per_split)); k_per_split is a
// multiple of the stage's K and, unless group == K, of group, which is a
// multiple of the unit's K (a group spans group_units units).
template <int FMT>
__global__ void __launch_bounds__(kGvThreads)
packed_gemv_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                   const int32_t* __restrict__ w,
                   const float* __restrict__ scales,
                   float* __restrict__ partial, float* __restrict__ out,
                   int* __restrict__ counters, int M, int K, int N, int group,
                   int k_per_split) {
  constexpr int PER = MmFmt<FMT>::PER, UNIT = 4 * PER;
  constexpr int STAGE_K = kGvUnits * UNIT;
  extern __shared__ __align__(128) unsigned char gv_smem[];
  __shared__ __align__(8) uint64_t full[kGvStages];
  __shared__ __align__(8) uint64_t xbar;
  __shared__ int last_block;
  unsigned char* wring = gv_smem;
  auto* sring = reinterpret_cast<float*>(gv_smem + kGvWordBytes);
  auto* xs = reinterpret_cast<__nv_bfloat16*>(gv_smem + kGvWordBytes +
                                              kGvScaleBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kGvCols;
  const int rows = M;                 // rows of x that hold data
  const int col = c0 + warp * 32 + 4 * g;
  const bool colok = col < N;
  const unsigned col_bytes = 4u * min(kGvCols, N - c0);
  const int splits = gridDim.y, z = blockIdx.y;
  const int kbeg = z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int kwend = kend / PER;
  const int nst = (kend - kbeg + STAGE_K - 1) / STAGE_K;
  const int xld = k_per_split + MmFmt<FMT>::XPAD;
  const bool fold_end = group == K;
  const int group_units = fold_end ? 0 : group / UNIT;

  // thread 0: stage s's word rows and the scale rows of the groups that end
  // in it (units past the split's K are neither copied nor folded)
  auto copy_stage = [&](int s) {
    const int slot = s % kGvStages, k0 = kbeg + s * STAGE_K;
    const int row0 = k0 / PER, rows = min(kGvRows, kwend - row0);
    unsigned bytes = rows * col_bytes;
    int srow[kGvUnits];
#pragma unroll
    for (int u = 0; u < kGvUnits; ++u) {
      const int uk0 = k0 + u * UNIT;
      srow[u] = !fold_end && uk0 < kend &&
                        ((uk0 - kbeg) / UNIT + 1) % group_units == 0
                    ? uk0 / group
                    : -1;
      if (srow[u] >= 0) bytes += col_bytes;
    }
    mbar_expect_tx(&full[slot], bytes);
    unsigned char* dst = wring + slot * kGvRows * kGvRowBytes;
    for (int r = 0; r < rows; ++r)
      bulk_copy(dst + r * kGvRowBytes, w + static_cast<size_t>(row0 + r) * N + c0,
                col_bytes, &full[slot]);
#pragma unroll
    for (int u = 0; u < kGvUnits; ++u)
      if (srow[u] >= 0)
        bulk_copy(sring + (slot * kGvUnits + u) * kGvCols,
                  scales + static_cast<size_t>(srow[u]) * N + c0, col_bytes,
                  &full[slot]);
  };

  // x's slice [kbeg, kbeg + k_per_split): copied up to ldx, zero past it
  const int xcopy = min(kbeg + k_per_split, ldx) - kbeg;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kGvStages; ++s) mbar_init(&full[s], 1);
    mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&xbar, 2u * rows * xcopy);
    for (int m = 0; m < rows; ++m)
      bulk_copy(xs + m * xld, x + static_cast<size_t>(m) * ldx + kbeg,
                2u * xcopy, &xbar);
    for (int s = 0; s < kGvStages - 1 && s < nst; ++s) copy_stage(s);
  }
  for (int i = tid; i < rows * (k_per_split - xcopy); i += kGvThreads) {
    const int m = i / (k_per_split - xcopy);
    xs[m * xld + xcopy + (i - m * (k_per_split - xcopy))] =
        __float2bfloat16(0.f);
  }
  mbar_wait(&xbar, 0);
  __syncthreads();

  float acc[2][4], part[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = part[j][r] = 0.f;

  // acc += s[column] * part, then part = 0 (A row g: column 4g + 2j, r 0-1;
  // row g + 8: column 4g + 2j + 1, r 2-3)
  auto fold = [&](float4 s) {
    const float sc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[j][r] = fmaf(sc[2 * j + (r >> 1)], part[j][r], acc[j][r]);
        part[j][r] = 0.f;
      }
  };

  const __nv_bfloat16* xrow = xs + g * xld + PER * t;
  const int wofs = t * kGvRowBytes + (warp * 32 + 4 * g) * 4;
  int units_in_group = 0;
  for (int it = 0; it < nst; ++it) {
    if (it > 0) __syncthreads();       // slot (it - 1) % stages consumed
    if (tid == 0 && it + kGvStages - 1 < nst) copy_stage(it + kGvStages - 1);
    const int slot = it % kGvStages, k0 = kbeg + it * STAGE_K;
    mbar_wait(&full[slot], (it / kGvStages) & 1);

    const unsigned char* ws = wring + slot * kGvRows * kGvRowBytes + wofs;
#pragma unroll
    for (int u = 0; u < kGvUnits; ++u) {
      const uint4 wv = *reinterpret_cast<const uint4*>(ws + 4 * u * kGvRowBytes);
      uint32_t xb[PER / 2];
      const __nv_bfloat16* xr = xrow + (k0 - kbeg) + u * UNIT;
      if constexpr (PER == 8) {
        const uint4 v = g < rows ? *reinterpret_cast<const uint4*>(xr)
                              : make_uint4(0u, 0u, 0u, 0u);
        xb[0] = __byte_perm(v.x, v.z, 0x5410);
        xb[1] = __byte_perm(v.x, v.z, 0x7632);
        xb[2] = __byte_perm(v.y, v.w, 0x5410);
        xb[3] = __byte_perm(v.y, v.w, 0x7632);
      } else {
        const uint2 v = g < rows ? *reinterpret_cast<const uint2*>(xr)
                              : make_uint2(0u, 0u);
        xb[0] = __byte_perm(v.x, v.y, 0x5410);
        xb[1] = __byte_perm(v.x, v.y, 0x7632);
      }
      uint32_t d[4][PER / 2];
      decode_split_pairs<FMT>(static_cast<uint32_t>(wv.x), d[0]);
      decode_split_pairs<FMT>(static_cast<uint32_t>(wv.y), d[1]);
      decode_split_pairs<FMT>(static_cast<uint32_t>(wv.z), d[2]);
      decode_split_pairs<FMT>(static_cast<uint32_t>(wv.w), d[3]);
#pragma unroll
      for (int jj = 0; jj < PER / 4; ++jj)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          mma_bf16(part[j], d[2 * j][2 * jj], d[2 * j + 1][2 * jj],
                   d[2 * j][2 * jj + 1], d[2 * j + 1][2 * jj + 1],
                   xb[2 * jj], xb[2 * jj + 1]);
      if (!fold_end && k0 + u * UNIT < kend &&
          ++units_in_group == group_units) {
        units_in_group = 0;
        fold(*reinterpret_cast<const float4*>(
            sring + (slot * kGvUnits + u) * kGvCols + warp * 32 + 4 * g));
      }
    }
  }
  if (fold_end)     // one group: the per-channel scale, once per split
    fold(colok ? *reinterpret_cast<const float4*>(scales + col)
               : make_float4(0.f, 0.f, 0.f, 0.f));

  // rows 2t and 2t + 1 of columns col .. col + 3
  const float4 r0 = make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
  const float4 r1 = make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
  float* dst = splits == 1 ? out : partial + static_cast<size_t>(z) * M * N;
  if (colok) {
    if (2 * t < M)
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(2 * t) * N + col) = r0;
    if (2 * t + 1 < M)
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(2 * t + 1) * N + col) = r1;
  }
  if (splits == 1) return;

  // the last block of this column tile sums its splits in order: after
  // the barrier, thread 0's acquire-release add publishes the block's
  // partial and, for the last block, makes every other split's visible
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counters + blockIdx.x)
                 : "memory");
    last_block = before == splits - 1;
  }
  __syncthreads();
  if (!last_block) return;
  if (colok) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 2 * t + h;
      if (row >= M) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int zz = 0; zz < splits; ++zz) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            partial + (static_cast<size_t>(zz) * M + row) * N + col));
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col) = s;
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

template <int FMT>
cudaError_t launch_gemv(const __nv_bfloat16* x, int ldx, const int32_t* w,
                        const float* scales, float* partial, float* out,
                        int* counters, int M, int K, int N, int group,
                        int k_per_split, int splits, cudaStream_t stream) {
  constexpr int UNIT = MmFmt<FMT>::UNIT;
  const int smem = kGvWordBytes + kGvScaleBytes +
                   2 * M * (k_per_split + MmFmt<FMT>::XPAD);
  if (M < 1 || M > 8 || N % 4 != 0 || k_per_split % (kGvUnits * UNIT) != 0 ||
      (group != K && (group % UNIT != 0 || k_per_split % group != 0)) ||
      smem > kGvMaxSmem || (K + k_per_split - 1) / k_per_split != splits)
    return cudaErrorInvalidValue;
  static bool ready[kMaxDevices] = {};
  cudaError_t e = set_smem_attributes(packed_gemv_kernel<FMT>, kGvMaxSmem,
                                      ready);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kGvCols - 1) / kGvCols, splits);
  packed_gemv_kernel<FMT><<<grid, kGvThreads, smem, stream>>>(
      x, ldx, w, scales, partial, out, counters, M, K, N, group, k_per_split);
  return cudaGetLastError();
}

int gemv_entry(const void* x, int ldx, const void* w, const void* scales,
               void* partial, void* out, void* counters, int M, int K, int N,
               int fmt, int group, int k_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* pp = static_cast<float*>(partial);
  auto* op = static_cast<float*>(out);
  auto* cp = static_cast<int*>(counters);
  switch (fmt) {
    case INT4:
      return launch_gemv<INT4>(xb, ldx, wp, sp, pp, op, cp, M, K, N, group,
                               k_per_split, splits, s);
    case FP4_E2M1:
      return launch_gemv<FP4_E2M1>(xb, ldx, wp, sp, pp, op, cp, M, K, N,
                                   group, k_per_split, splits, s);
    case FP8_E4M3:
      return launch_gemv<FP8_E4M3>(xb, ldx, wp, sp, pp, op, cp, M, K, N,
                                   group, k_per_split, splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Expert-grouped K1 / K2: one persistent body over a work list built on
// the device, for groups of any height M.  It replaces the Pallas kernel's
// body as the reference reaches it through jax.vmap over the experts
// (repro/models/moe.py:_expert_ffn, lines 92-110: every decode (row,
// expert) pair and every capacity buffer of a prefill chunk, one launch
// per expert leaf).  What bounds it on the H100: the bytes of the distinct
// experts' words and scales (3.35 TB/s).  The math does not: even a
// 512-token chunk's buffers of 40 rows do ~2 x 40 flops a 4-bit code, ~160
// a weight byte, under the ~295 at which the bf16 tensor cores bind.
//
// Work list.  Every block reads expert[G] and rows[G] once and builds the
// same list in shared memory: the (group, row) sources that hold data,
// sorted by expert (stable: group, then row, order), cut into items of at
// most R = 8 NF sources of one expert (an expert of n rows takes ceil(n /
// R) items, an expert with none takes none).  NF, the n8 fragments of the
// mma's B operand an item fills, grows with M: 1 at M <= 8 (grouped K1),
// 2 or 4 past it.  A unit of work is an item's U = 32 CW columns over the
// whole of K, numbered item-major, so the units of one expert are adjacent;
// an expert's words are read once per item, not once per group.  The
// sources of an item are the columns of the mma's B operand, so merging
// groups into an item changes no row's sum: each output element is its
// own dot product.  Rows past rows[g] are written as zeros.
//
// Walk.  Block b takes units b, b + grid, ...: the grid is one wave (two
// blocks an SM at NF = 1, one past it), no block waits on another, and the
// blocks in flight read one expert's neighbouring tiles (taking units from
// a counter in device memory instead measured no faster).  The last warp
// is the producer: for each ring stage of a unit it waits for a free slot,
// writes the stage's unit to shared memory and issues, from its lanes at
// once, Tensor Memory Accelerator copies of the words' SR-row x 32-column
// boxes (a tensor map over the stack viewed as [E K / per, N] words,
// 128-byte rows swizzled), one of the stage's scale rows (a map over [E K /
// group, N], a box U wide) and a bulk copy of each source's x slice.  The
// other warps are the consumers: CW column boxes by the leaf's KW K chunks
// of the stage's rows (KW = 4, or 2 on leaves of N >= 1536), warp (cw, kw)
// running K1's decode on its chunk of box cw and one mma.sync (m16n8k16,
// the rows as B) a fragment for each decoded tile, then freeing the slot.
// At a unit's end the K warps past the first hand their sums to it through
// shared memory, and it adds them in warp order and stores.  The int4
// decode spends one lop3 a code pair (mask, sign flip and bf16 offset
// together), the swizzled box gives each thread its 16 bytes in one load,
// and a whole chunk runs without a branch.
//
// Why the wide items and units: x crosses L2 once per unit, the words once
// per item, so at R rows an item and U columns a unit x moves ~4 R / U
// bytes through L2 per byte of words (4-bit codes), and each item decodes
// its expert's words once per row of fragments it fills.  Items of 8 rows
// in units of 32 columns (grouped K1's form) read and decode a 40-row
// expert's words 5 times and move x as many bytes again; items of 32 rows
// in units of 64 (N < 1536) or 128 columns over 8 consumer warps, one
// block an SM, read them twice and x ~1-2x of them (12 warps, a third
// wider, measured 2-10 % faster but spill at the 128 registers a thread
// ptxas gives 416 threads).  Past M ~20 the consumers' issue rate binds as
// much as the copies (launch/grouped_ablation.py), so a chunk runs one
// branch-free loop per count of fragments that hold sources.  K1's body
// with a grid axis over the groups (the first grouped forms, K1's and
// K2's) moved ~1.25 TB/s of requested bytes whatever they were;
// persistent forms that split K across blocks spent 2-4 us of each unit
// in the cross-block sum (PERF.md holds the measurements).
//
// Order.  Fixed by the leaf alone (kernels/packed_matmul.py:
// grouped_gemv_plan): a warp folds scale x partial every min(group, chunk)
// of K, in K order (a per-channel scale multiplies the warp's whole sum
// once), and a column's output is its K warps' sums added in order.
// Neither NF nor CW changes which warp sums which K or how, so a row's
// output does not depend on what shares its launch, nor on M.
// kernels/packed_matmul.py:packed_gemv_grouped_ordered is the plain twin
// in this order.
// ---------------------------------------------------------------------------
constexpr int kGkRingRows = 256;              // NF = 1: word rows the ring holds
constexpr int kGkBlocksPerSm = 2;             // NF = 1: blocks an SM
constexpr int kGwWarps = 8;                   // NF > 1: consumer warps
constexpr int kGwMidFrags = 2;                // NF at 9 <= M <= 16 (else 4)
constexpr int kGwRingBytes = 160 * 1024;      // NF > 1: bytes the ring holds
constexpr int kGkMaxExperts = 512;
constexpr int kGkMaxSources = 6144;           // G x M of one launch, at most
constexpr int kGkCols = 32;                   // a box's columns: 128 bytes
constexpr int kGkMaxSmem = 225 * 1024;        // dynamic shared memory, at most

// the K warps of a leaf of N columns: 4, or 2 where N >= 1536 (a unit's
// columns then span two boxes at NF = 1)
int gk_k_warps(int N) { return N >= 1536 ? 2 : 4; }

// the n8 fragments of an item at M rows a group
int gk_fragments(int M) { return M <= 8 ? 1 : M <= 16 ? kGwMidFrags : 4; }

// a unit's 32-column boxes: 4 consumer warps at NF = 1, kGwWarps past it
constexpr int gk_boxes(int kw, int nf) {
  return (nf == 1 ? 4 : kGwWarps) / kw;
}

// A form of the body: a ring stage is SR word rows (64, or 32 where K / per
// is an odd multiple of 32, so that no stage runs past K) of CW boxes; the
// consumer warps split as CW column boxes by KW K chunks (a warp's chunk
// is SR / KW rows, 2-8 units of 4 rows); an item fills NF fragments.
template <int FMT, int SR, int KW, int CW, int NF> struct GkFmt {
  static constexpr int PER = MmFmt<FMT>::PER, UNIT = 4 * PER;
  static constexpr int WARPS = KW * CW;          // consumer warps
  static constexpr int THREADS = 32 * (WARPS + 1);
  static constexpr int BLOCKS = NF == 1 ? kGkBlocksPerSm : 1;
  static constexpr int ROWS = 8 * NF;            // an item's sources
  static constexpr int CHUNK_ROWS = SR / KW;
  static constexpr int UNITS = CHUNK_ROWS / 4;  // units a warp's chunk holds
  static constexpr int CHUNK_K = CHUNK_ROWS * PER, STAGE_K = SR * PER;
  static constexpr int BOX_BYTES = SR * kGkCols * 4;   // one box of words
  static constexpr int WORD_BYTES = CW * BOX_BYTES;
  // one source's x slice of a stage: STAGE_K bf16, rows padded by 64 / 32
  // bytes (K1's XPAD) so that the B-operand reads hit all banks
  static constexpr int X_PITCH = 2 * (STAGE_K + MmFmt<FMT>::XPAD);
  static constexpr int X_BYTES = ROWS * X_PITCH;
  static constexpr int STAGES =
      NF == 1 ? kGkRingRows / (SR * CW)
              : kGwRingBytes / (WORD_BYTES + X_BYTES) > 2
                    ? kGwRingBytes / (WORD_BYTES + X_BYTES) : 2;
  // the sums the K warps past the first hand over at a unit's end
  static constexpr int RED_BYTES = (KW - 1) * CW * NF * 8 * 32 * 4;
  static_assert(BOX_BYTES % 1024 == 0, "the words' swizzle atoms");
};

// Scale rows a stage's box holds: none for one group (group == K); the
// stage's groups where a group divides the stage's K (and divides, or is a
// multiple of, a warp's chunk); one where the stage lies in one group.
// -1: a group the body does not take.
int gk_scale_rows(int per, int sr, int kw, int K, int group) {
  const int unit = 4 * per, chunk = sr / kw * per;
  const int stage = sr * per;
  if (group == K) return 0;
  if (group % unit == 0 && stage % group == 0 &&
      (chunk % group == 0 || group % chunk == 0))
    return stage / group;
  if (group % stage == 0) return 1;
  return -1;
}

// the stage rows of a leaf of K / per word rows (kernels/packed_matmul.py:
// grouped_gemv_plan)
int gk_stage_rows(int rows) { return rows % 64 != 0 && rows % 32 == 0 ? 32 : 64; }

// The codes of one word as bf16 pairs, as decode_split_pairs gives them;
// int4 with each nibble pair's mask, sign flip and offset in one lop3:
// (c & 0xF) ^ 0x4308 is 128 + (c ^ 8) in bf16, less 136 by the fma.
template <int FMT>
__device__ __forceinline__ void gk_decode(uint32_t w,
                                          uint32_t (&out)[MmFmt<FMT>::PER / 2]) {
  if constexpr (FMT == INT4) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t r, v;
      asm("lop3.b32 %0, %1, 0x000F000F, 0x43084308, 0x6A;\n"
          : "=r"(r)
          : "r"(w >> (4 * p)));
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(v)
          : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
      out[p] = v;
    }
  } else {
    decode_split_pairs<FMT>(w, out);
  }
}

// what the producer tells the consumers about a ring slot
struct GkStage {
  int unit;        // -1: no more work
  int k0;          // first K of the stage
  int last;        // the unit's last stage
  int expert, nsrc, src0;   // the item: expert, sources [src0, src0 + nsrc)
  int tile;        // the unit's U columns: [U tile, U tile + U)
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the 2-D tile at (column c, row r) of a tensor map into shared memory,
// completing on bar
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

template <int WARPS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
}

// x: [G M, ldx] bf16 rows, ldx a multiple
// of 8 and at least K rounded up to the unit's K (32 / 16), zero past K;
// out: [G M, N]; scales: the stack's [E, K / group, N] f32 (read here for a
// per-channel scale only); scale_rows: the scale map's box height.  The
// words' map swizzles 128-byte rows (16-byte chunk j of row r lands at
// chunk j ^ (r % 8)).
template <int FMT, int SR, int KW, int CW, int NF>
__global__ void __launch_bounds__(GkFmt<FMT, SR, KW, CW, NF>::THREADS,
                                  GkFmt<FMT, SR, KW, CW, NF>::BLOCKS)
grouped_gemv_kernel(const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap,
                    const __nv_bfloat16* __restrict__ x, int ldx,
                    const float* __restrict__ scales, float* __restrict__ out,
                    ExpertGroups eg, int M, int K, int N, int group,
                    int scale_rows) {
  using F = GkFmt<FMT, SR, KW, CW, NF>;
  constexpr int PER = F::PER, UNIT = F::UNIT, CHUNK_K = F::CHUNK_K;
  constexpr int STAGE_K = F::STAGE_K, S = F::STAGES, COLS = CW * kGkCols;
  constexpr int NW = F::WARPS, R = F::ROWS, THREADS = F::THREADS;
  extern __shared__ unsigned char gk_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S], red_free;
  __shared__ GkStage info[S];
  __shared__ int n_units;

  // the ring (1024-byte aligned): words, scale rows, x slices a stage;
  // then the K warps' sums at a unit's end; then the work list
  const int scale_bytes = (scale_rows * COLS * 4 + 127) / 128 * 128;
  const int stage_bytes =
      (F::WORD_BYTES + scale_bytes + F::X_BYTES + 1023) / 1024 * 1024;
  unsigned char* ring = gk_raw + ((1024 - (smem_u32(gk_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + S * stage_bytes);
  const int E = eg.n_experts, G = eg.n_groups;
  int* s_cnt = reinterpret_cast<int*>(red) + F::RED_BYTES / 4;   // [E]
  int* s_base = s_cnt + E;          // [E + 1] first source of each expert
  int* s_ibase = s_base + E + 1;    // [E + 1] first item of each expert
  int* s_grp = s_ibase + E + 1;     // [G] expert | rows << 16 of each group
  int* s_src = s_grp + G;           // sources in expert order: rows g M + r

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + COLS - 1) / COLS;
  const bool fold_end = group == K;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    mbar_init(&red_free, CW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < E; i += THREADS) s_cnt[i] = 0;
  __syncthreads();
  // each group's expert and rows, once; rows per expert
  for (int g = tid; g < G; g += THREADS) {
    const int e = group_expert(eg, g), r = group_rows(eg, g, M);
    s_grp[g] = e | r << 16;
    if (r > 0) atomicAdd(&s_cnt[e], r);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scans of sources and items (ceil(n / R)) over the experts:
    // lane l takes experts [l per, (l + 1) per)
    const int per = (E + 31) / 32;
    const int lo = min(E, lane * per), hi = min(E, lo + per);
    int src = 0, items = 0;
    for (int e = lo; e < hi; ++e) {
      src += s_cnt[e];
      items += (s_cnt[e] + R - 1) / R;
    }
    int src_in = src, items_in = items;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int a = __shfl_up_sync(0xffffffffu, src_in, d);
      const int b = __shfl_up_sync(0xffffffffu, items_in, d);
      if (lane >= d) { src_in += a; items_in += b; }
    }
    src = src_in - src;
    items = items_in - items;
    for (int e = lo; e < hi; ++e) {
      const int n = s_cnt[e];
      s_base[e] = src;
      s_ibase[e] = items;
      src += n;
      items += (n + R - 1) / R;
      s_cnt[e] = 0;               // from here: sources placed so far
    }
    if (lane == 31) {
      s_base[E] = src_in;
      s_ibase[E] = items_in;
      n_units = items_in * tiles;
    }
    __syncwarp();
    // each source's place: groups in order, 32 at a time; a lane's rows go
    // after those of the lower lanes that name its expert
    for (int c0 = 0; c0 < G; c0 += 32) {
      const int g = c0 + lane;
      const int v = g < G ? s_grp[g] : 0;
      const int r = v >> 16;
      const int e = r > 0 ? (v & 0xffff) : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      unsigned lower = peers & ((1u << lane) - 1u);
      const int rounds = __reduce_max_sync(0xffffffffu, __popc(lower));
      int before = 0;
      for (int i = 0; i < rounds; ++i) {
        const int from = lower ? __ffs(lower) - 1 : lane;
        const int w = __shfl_sync(0xffffffffu, r, from);
        if (lower) {
          before += w;
          lower &= lower - 1u;
        }
      }
      const int placed = r > 0 ? s_cnt[e] : 0;
      __syncwarp();
      if (r > 0) {
        const int pos = s_base[e] + placed + before;
        for (int j = 0; j < r; ++j) s_src[pos + j] = g * M + j;
        if ((peers >> lane) == 1u) s_cnt[e] = placed + before + r;
      }
      __syncwarp();
    }
  } else if (warp < NW) {
    // rows past each group's count: zeros (groups shared out over blocks)
    for (int g = blockIdx.x; g < G; g += gridDim.x) {
      const int r = s_grp[g] >> 16;
      float4* dst = reinterpret_cast<float4*>(
          out + (static_cast<size_t>(g) * M + r) * N);
      const int n4 = (M - r) * N / 4;
      for (int i = tid - 32; i < n4; i += 32 * (NW - 1))
        dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int total = n_units;
  const int nst = (K + STAGE_K - 1) / STAGE_K;

  if (warp == NW) {
    // ---- producer: units blockIdx.x, + gridDim.x, ... ----
    // a stage's scale rows: scale_rows a stage where a group divides the
    // stage's K, else one row every group / STAGE_K stages
    const int groups_k = fold_end ? 0 : K / group;
    const int stages_per_row =
        fold_end || STAGE_K % group == 0 ? 1 : group / STAGE_K;
    int q = 0;                              // stages issued so far
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      const int item = u / tiles, tile = u - item * tiles;
      // the item's expert: the last e with s_ibase[e] <= item
      int lo = 0, hi = E;
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (s_ibase[mid] <= item) lo = mid; else hi = mid;
      }
      const int e = lo;
      const int src0 = s_base[e] + R * (item - s_ibase[e]);
      const int nsrc = min(R, s_base[e + 1] - src0);
      const int wrow0 = e * (K / PER);
      int srow = e * groups_k, in_row = 0;  // the stage's first scale row
      for (int s = 0; s < nst; ++s, ++q) {
        const int slot = q % S, k0 = s * STAGE_K;
        // x up to K, in whole units (zero past K up to ldx)
        const int xbytes = (min(STAGE_K, K - k0) + UNIT - 1) / UNIT * UNIT * 2;
        mbar_wait(&empty[slot], ((q / S) & 1) ^ 1);
        unsigned char* st = ring + slot * stage_bytes;
        if (lane == 0) {
          info[slot] = {u, k0, s == nst - 1, e, nsrc, src0, tile};
          mbar_expect_tx(&full[slot], F::WORD_BYTES + nsrc * xbytes +
                                          scale_rows * COLS * 4);
        }
        __syncwarp();
        // copies [0, CW): the word boxes; CW: the scale rows; then one a
        // source's x
        for (int c = lane; c < CW + 1 + nsrc; c += 32) {
          if (c < CW) {
            tma_tile(st + c * F::BOX_BYTES, &wmap,
                     tile * COLS + c * kGkCols, wrow0 + k0 / PER,
                     &full[slot]);
          } else if (c == CW) {
            if (!fold_end)
              tma_tile(st + F::WORD_BYTES, &smap, tile * COLS, srow,
                       &full[slot]);
          } else {
            const int j = c - CW - 1;
            bulk_copy(st + F::WORD_BYTES + scale_bytes + j * F::X_PITCH,
                      x + static_cast<size_t>(s_src[src0 + j]) * ldx + k0,
                      xbytes, &full[slot]);
          }
        }
        if (++in_row == stages_per_row) {
          in_row = 0;
          srow += scale_rows;
        }
      }
    }
    // no more work: a last slot says so
    const int slot = q % S;
    mbar_wait(&empty[slot], ((q / S) & 1) ^ 1);
    if (lane == 0) {
      info[slot].unit = -1;
      mbar_arrive(&full[slot]);
    }
    return;
  }

  // ---- consumers: warp (cw, kw) takes word rows [kw, kw + 1) SR / KW of
  // box cw ----
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp % KW, cw = warp / KW;
  // units a fold spans: one, or the whole chunk
  const int fold_units = fold_end ? F::UNITS : min(group, CHUNK_K) / UNIT;
  const int fold_shift = __ffs(fold_units) - 1;   // 1, 2 or 4 units
  // this warp's first scale row in a stage's box (0 where the stage lies
  // in one group)
  const int my_srow =
      fold_end || STAGE_K % group != 0 ? 0 : CHUNK_K * kw / group;
  // fragment f, thread (g, t): sources 8 f + 2 t, 8 f + 2 t + 1 at columns
  // 4 g .. 4 g + 3 of box cw (A row g: column 4g + 2j, r 0-1; row g + 8:
  // column 4g + 2j + 1, r 2-3)
  float acc[NF][2][4], part[NF][2][4];
  // thread (g, t): word row kw SR / KW + 4 u + t, columns 4 g .. 4 g + 3
  // of box cw: the row's 16-byte chunk g, swizzled to chunk g ^ ((4 u + t)
  // % 8); eight lanes meet in two banks' worth of rows at most
  const int wrow = cw * F::BOX_BYTES + (F::CHUNK_ROWS * kw + t) * kGkCols * 4;
  const int wch0 = (g ^ t) * 16, wch1 = (g ^ (4 + t)) * 16;
  // box cw's sums from K warps 1 .. KW - 1, handed to warp 0: [warp][the
  // NF x 8 accumulators][lane]
  float* box_red = red + cw * (KW - 1) * (NF * 8 * 32) + lane;
  int n_done = 0;             // units this warp has finished
  for (int q = 0;; ++q) {
    const int slot = q % S;
    mbar_wait(&full[slot], (q / S) & 1);
    const GkStage in = info[slot];
    if (in.unit < 0) break;
    if (in.k0 == 0) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][j][r] = part[f][j][r] = 0.f;
    }
    const unsigned char* st = ring + slot * stage_bytes;
    const unsigned char* ws = st + wrow;
    const float* sw = reinterpret_cast<const float*>(st + F::WORD_BYTES) +
                      my_srow * COLS + cw * kGkCols + 4 * g;
    // fragment f's B column g: source 8 f + g's slice
    const auto* xk = reinterpret_cast<const __nv_bfloat16*>(
                         st + F::WORD_BYTES + scale_bytes + g * F::X_PITCH) +
                     CHUNK_K * kw + PER * t;
    const int chunk_k0 = in.k0 + CHUNK_K * kw;

    // the chunk's units and folds over the item's NA fragments that hold
    // sources (a chunk's loop has no branch between fragments)
    auto run = [&](auto active) {
      constexpr int NA = decltype(active)::value;
      // unit u of the chunk: 4 word rows, 4 PER of K
      auto unit = [&](int u) {
        const uint4 wv = *reinterpret_cast<const uint4*>(
            ws + u * 4 * kGkCols * 4 + (u % 2 ? wch1 : wch0));
        uint32_t d[4][PER / 2];
        gk_decode<FMT>(wv.x, d[0]);
        gk_decode<FMT>(wv.y, d[1]);
        gk_decode<FMT>(wv.z, d[2]);
        gk_decode<FMT>(wv.w, d[3]);
#pragma unroll
        for (int f = 0; f < NA; ++f) {
          const bool xg = 8 * f + g < in.nsrc;   // B column g: a source
          const __nv_bfloat16* xf = xk + f * 4 * F::X_PITCH + u * UNIT;
          uint32_t xb[PER / 2];
          if constexpr (PER == 8) {
            const uint4 v = xg ? *reinterpret_cast<const uint4*>(xf)
                               : make_uint4(0u, 0u, 0u, 0u);
            xb[0] = __byte_perm(v.x, v.z, 0x5410);
            xb[1] = __byte_perm(v.x, v.z, 0x7632);
            xb[2] = __byte_perm(v.y, v.w, 0x5410);
            xb[3] = __byte_perm(v.y, v.w, 0x7632);
          } else {
            const uint2 v = xg ? *reinterpret_cast<const uint2*>(xf)
                               : make_uint2(0u, 0u);
            xb[0] = __byte_perm(v.x, v.y, 0x5410);
            xb[1] = __byte_perm(v.x, v.y, 0x7632);
          }
#pragma unroll
          for (int jj = 0; jj < PER / 4; ++jj)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_bf16(part[f][j], d[2 * j][2 * jj], d[2 * j + 1][2 * jj],
                       d[2 * j][2 * jj + 1], d[2 * j + 1][2 * jj + 1],
                       xb[2 * jj], xb[2 * jj + 1]);
        }
      };
      // the fold that ends with unit u: the i-th of the chunk takes row
      // srow + i of the slot's scale box
      auto fold = [&](int u) {
        if (fold_end || ((u + 1) & (fold_units - 1)) != 0) return;
        const float4 s4 = *reinterpret_cast<const float4*>(
            sw + (((u + 1) >> fold_shift) - 1) * COLS);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int f = 0; f < NA; ++f)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[f][j][r] = fmaf(sc[2 * j + (r >> 1)], part[f][j][r],
                                  acc[f][j][r]);
              part[f][j][r] = 0.f;
            }
      };
      if (chunk_k0 + CHUNK_K <= K) {     // the whole chunk lies in K
#pragma unroll
        for (int u = 0; u < F::UNITS; ++u) {
          unit(u);
          fold(u);
        }
      } else if (chunk_k0 < K) {         // K ends in the chunk
#pragma unroll
        for (int u = 0; u < F::UNITS; ++u) {
          const int span0 = chunk_k0 + (u + 1 - fold_units) * UNIT;
          if (chunk_k0 + u * UNIT < K) unit(u);
          if (span0 < K) fold(u);        // spans past K hold nothing
        }
      }
    };
    // fragments past the item's sources hold zeros and are skipped
    const int na = (in.nsrc + 7) / 8;
    if constexpr (NF == 1) {
      run(std::integral_constant<int, 1>{});
    } else if constexpr (NF == 2) {
      if (na == 1) run(std::integral_constant<int, 1>{});
      else run(std::integral_constant<int, 2>{});
    } else {
      static_assert(NF == 4, "items of 8, 16 or 32 sources");
      if (na == 1) run(std::integral_constant<int, 1>{});
      else if (na == 2) run(std::integral_constant<int, 2>{});
      else if (na == 3) run(std::integral_constant<int, 3>{});
      else run(std::integral_constant<int, 4>{});
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (!in.last) continue;

    // ---- the unit's end: each box's K warps' sums added in order ----
    const int col = in.tile * COLS + cw * kGkCols + 4 * g;
    if (fold_end) {            // one group: the per-channel scale, once
      const float4 s4 = col < N
          ? *reinterpret_cast<const float4*>(
                scales + static_cast<size_t>(in.expert) * N + col)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[f][j][r] = sc[2 * j + (r >> 1)] * part[f][j][r];
    }
    if (kw > 0) {    // hand the sums over once the last unit's are read
      if (n_done > 0) mbar_wait(&red_free, (n_done - 1) & 1);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            box_red[((kw - 1) * NF * 8 + (f * 2 + j) * 4 + r) * 32] =
                acc[f][j][r];
    }
    consumer_sync<NW>();
    ++n_done;
    if (kw > 0) continue;
#pragma unroll
    for (int w = 0; w < KW - 1; ++w)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[f][j][r] += box_red[(w * NF * 8 + (f * 2 + j) * 4 + r) * 32];
    __syncwarp();
    if (lane == 0) mbar_arrive(&red_free);
    if (col >= N) continue;
    // sources 8 f + 2 t and 8 f + 2 t + 1: columns col .. col + 3
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * f + 2 * t + h;
        if (row < in.nsrc)
          *reinterpret_cast<float4*>(
              out + static_cast<size_t>(s_src[in.src0 + row]) * N + col) =
              make_float4(acc[f][0][h], acc[f][0][2 + h], acc[f][1][h],
                          acc[f][1][2 + h]);
      }
  }
}

// the number of SMs of the current device (looked up once per device)
int sm_count() {
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int n = dev < kMaxDevices ? count[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) count[dev] = n;
  }
  return n;
}

template <int FMT, int SR, int KW, int NF>
cudaError_t launch_grouped_gemv(const CUtensorMap& wmap,
                                const CUtensorMap& smap,
                                const __nv_bfloat16* x, int ldx,
                                const float* scales, float* out,
                                const ExpertGroups& eg, int M, int K, int N,
                                int group, cudaStream_t stream) {
  constexpr int CW = gk_boxes(KW, NF);
  using F = GkFmt<FMT, SR, KW, CW, NF>;
  const int scale_rows = gk_scale_rows(F::PER, SR, KW, K, group);
  const int sources = eg.n_groups * M;
  const int stage_bytes = (F::WORD_BYTES +
                           (scale_rows * CW * kGkCols * 4 + 127) / 128 * 128 +
                           F::X_BYTES + 1023) / 1024 * 1024;
  const long long smem =
      1024 + static_cast<long long>(F::STAGES) * stage_bytes + F::RED_BYTES +
      4ll * (3 * eg.n_experts + 2 + eg.n_groups + sources);
  if (M < 1 || N % 4 != 0 || ldx % 8 != 0 ||
      ldx < (K + F::UNIT - 1) / F::UNIT * F::UNIT || scale_rows < 0 ||
      scale_rows > 256 || eg.n_experts > kGkMaxExperts ||
      sources > kGkMaxSources || smem > kGkMaxSmem)
    return cudaErrorInvalidValue;
  static bool ready[kMaxDevices] = {};
  cudaError_t e = set_smem_attributes(grouped_gemv_kernel<FMT, SR, KW, CW, NF>,
                                      kGkMaxSmem, ready);
  if (e != cudaSuccess) return e;
  grouped_gemv_kernel<FMT, SR, KW, CW, NF>
      <<<F::BLOCKS * sm_count(), F::THREADS, static_cast<int>(smem),
         stream>>>(wmap, smap, x, ldx, scales, out, eg, M, K, N, group,
                   scale_rows);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_grouped_gemv_fmt(const CUtensorMap& wmap,
                                    const CUtensorMap& smap,
                                    const __nv_bfloat16* x, int ldx,
                                    const float* scales, float* out,
                                    const ExpertGroups& eg, int M, int K,
                                    int N, int group, cudaStream_t stream) {
  const int sr = gk_stage_rows(K / MmFmt<FMT>::PER);
  const int kw = gk_k_warps(N), nf = gk_fragments(M);
#define GK_CASE(SR, KW, NF)                                                  \
  if (sr == SR && kw == KW && nf == NF)                                      \
    return launch_grouped_gemv<FMT, SR, KW, NF>(wmap, smap, x, ldx, scales,  \
                                                out, eg, M, K, N, group,     \
                                                stream);
#define GK_FORMS(NF) \
  GK_CASE(32, 4, NF) GK_CASE(32, 2, NF) GK_CASE(64, 4, NF) GK_CASE(64, 2, NF)
  GK_FORMS(1) GK_FORMS(kGwMidFrags) GK_FORMS(4)
#undef GK_FORMS
#undef GK_CASE
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, N] row-major map of 4-byte elements in boxes of box_cols
// columns by box_rows rows (out-of-bounds elements read as zero)
int encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               long long rows, int N, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(fn(map, type, 2, const_cast<void*>(base), dims,
                             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

int matmul_entry(const void* x, int ldx, const void* w, const void* scales,
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
                                   m_tiles, n_tiles, k_per_split, splits,
                                   vec, s);
      break;
    case FP8_E4M3:
      e = launch_mma_fmt<FP8_E4M3>(xb, ldx, wp, sp, dst, M, K, N, group,
                                   m_tiles, n_tiles, k_per_split, splits,
                                   vec, s);
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

// The expert grouping of a stack of n_experts leaves [K/per, N] words and
// [K/group, N] scales each; false for a format or group that does not tile
// K.
bool expert_groups(const void* expert, const void* rows, int n_groups,
                   int n_experts, int K, int fmt, int group,
                   ExpertGroups* eg) {
  const int per = fmt == FP8_E4M3 ? 4 : 8;
  if (fmt < INT4 || fmt > FP8_E4M3 || K % per || group < 1 || K % group ||
      n_experts < 1)
    return false;
  *eg = {static_cast<const int32_t*>(expert), static_cast<const int32_t*>(rows),
         n_groups, n_experts};
  return true;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x bf16 [M, ldx] (ldx % 8 == 0, 16-byte aligned, zero in columns
// K..ldx); w int32 [K/per, N]; scales f32 [ceil(K/group), N]; partial f32
// [splits, M, N] scratch (unused for one split); out f32 [M, N]; counters
// int32 [ceil(N / 128)], zero (the last block of each column tile resets
// its counter), for launches on one stream at a time.  1 <= M <= 8,
// N % 4 == 0, 16-byte aligned w and scales; group K or a multiple of 32
// (4-bit codes) / 16 (fp8) dividing k_per_split, a multiple of 128 / 64;
// fmt: 0 int4, 1 fp4, 2 fp8.
int packed_gemv(const void* x, int ldx, const void* w, const void* scales,
                void* partial, void* out, void* counters, int M, int K, int N,
                int fmt, int group, int k_per_split, int splits,
                void* stream) {
  return gemv_entry(x, ldx, w, scales, partial, out, counters, M, K, N, fmt,
                    group, k_per_split, splits, stream);
}

// The tensor maps packed_gemv_grouped reads a stack through at M rows a
// group, written to maps (2 x 128 bytes): the words w int32 [E, K/per, N]
// as [E K/per, N] in boxes of a ring stage's rows (64, or 32) x 32
// columns, 128-byte swizzled, then the scales f32 [E, K/group, N] as
// [E K/group, N] in boxes of the scale rows a ring stage holds by a unit's
// columns (zeros for one group, group == K, whose scales the kernel reads
// itself).  0, the CUresult of cuTensorMapEncodeTiled, or -1 (no driver
// entry point, or a scale group the grouped body does not take).
int grouped_gemv_tensor_maps(const void* w, const void* scales, int E, int K,
                             int N, int M, int fmt, int group, void* maps) {
  const int per = fmt == FP8_E4M3 ? 4 : 8;
  const int sr = gk_stage_rows(K / per), kw = gk_k_warps(N);
  const int cw = gk_boxes(kw, gk_fragments(M));
  const int scale_rows = gk_scale_rows(per, sr, kw, K, group);
  if (scale_rows < 0 || scale_rows > 256) return -1;
  CUtensorMap m[2];
  memset(m, 0, sizeof m);
  int err = encode_map(&m[0], CU_TENSOR_MAP_DATA_TYPE_INT32, w,
                       static_cast<long long>(E) * (K / per), N, kGkCols, sr,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0 && scale_rows > 0)
    err = encode_map(&m[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales,
                     static_cast<long long>(E) * (K / group), N, cw * kGkCols,
                     scale_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0) memcpy(maps, m, sizeof m);
  return err;
}

// Grouped K1 / K2 over G groups of M rows of an expert stack (the
// persistent grouped body): x bf16 [G M, ldx] (ldx % 8 == 0 and at least K
// rounded up to 32 for 4-bit codes / 16 for fp8, zero past K, 16-byte
// aligned); maps from grouped_gemv_tensor_maps at the same M; scales the
// stack's f32 [E, K/group, N]; expert int32 [G] (each in [0, E)) and rows
// int32 [G] on the device; out f32 [G, M, N].  M >= 1, N % 4 == 0, E <=
// 512, G M <= 6144; group K, or as kernels/packed_matmul.py:
// grouped_gemv_plan takes it; fmt as packed_gemv's.
int packed_gemv_grouped(const void* x, int ldx, const void* maps,
                        const void* scales, void* out, const void* expert,
                        const void* rows, int G, int E, int M, int K, int N,
                        int fmt, int group, void* stream) {
  ExpertGroups eg;
  if (!expert_groups(expert, rows, G, E, K, fmt, group, &eg))
    return cudaErrorInvalidValue;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<float*>(out);
  switch (fmt) {
    case INT4:
      return launch_grouped_gemv_fmt<INT4>(m[0], m[1], xb, ldx, sp, op, eg, M,
                                           K, N, group, s);
    case FP4_E2M1:
      return launch_grouped_gemv_fmt<FP4_E2M1>(m[0], m[1], xb, ldx, sp, op, eg,
                                               M, K, N, group, s);
    case FP8_E4M3:
      return launch_grouped_gemv_fmt<FP8_E4M3>(m[0], m[1], xb, ldx, sp, op, eg,
                                               M, K, N, group, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  return matmul_entry(x, ldx, w, scales, partial, out, M, K, N, fmt, group,
                      m_tiles, n_tiles, k_per_split, splits, vec, stream);
}

}  // extern "C"
