// Split-KV flash-decode attention over a bf16, int8 or fp8 KV slab for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/decode_attention.py:
// _decode_bf16_kernel (bf16 slab) and _decode_quant_kernel (int8 / fp8 e4m3
// codes packed four per int32 word along d_head, one f32 scale per
// (position, head)), both reached through gqa_decode_attention.
//
// Computes, for every slot row b and query head h (Sq == 1, GQA group
// hk = h / rep):
//   out[b, 0, h] = softmax_j(q[b, 0, h] / sqrt(Dh) . K[b, j, hk]) V[b, j, hk]
// over the valid positions j < kv_valid_len[b], in f32 after the loads,
// with the reference's online-softmax update (running max, normaliser and
// accumulator; masked scores -1e30; output / max(l, 1e-30)), rounded to
// bf16 at the end.  Quantized slabs are dequantized in the kernel: code
// value times its position-head scale, in f32.
//
// What bounds it on the H100: the bytes of the valid KV positions (3.35
// TB/s) — each K/V element is used by rep = H / Hk query heads only.  Its
// design: one block per (KV split, KV head, slot row); the block loads the
// rep query heads of its group once and walks its share of the positions
// below kv_valid_len in tiles of 32, dequantizing each K/V tile into shared
// memory once for all rep heads (lane j scores position j, a warp per
// head).  Splitting the sequence gives B * Hk * splits blocks, enough to
// fill the SMs at decode batch sizes; a second kernel merges the splits'
// (max, sum, accumulator) partials.  Positions past kv_valid_len are never
// read, so a ragged batch moves only its valid bytes.  A row with
// kv_valid_len == 0 yields 0 (the serving path always has >= 1).
//
// C interface: launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Slab { BF16 = 0, INT8 = 1, FP8_E4M3 = 2 };

constexpr int kTile = 32;        // positions per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 4;   // rep <= 16
constexpr int kMaxDimsPerLane = 4;   // Dh <= 128
constexpr float kNeg = -1e30f;

template <int KIND>
__device__ __forceinline__ float decode8(uint32_t c) {
  if (KIND == INT8) {
    return static_cast<float>(static_cast<int32_t>(c << 24) >> 24);
  } else {
    const uint32_t e = (c >> 3) & 15u, m = c & 7u;
    const bool zero = e == 0 || (e == 15 && m == 7);
    const float mag =
        zero ? 0.f : __uint_as_float(((e + 120u) << 23) | (m << 20));
    return (c >> 7) & 1u ? -mag : mag;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Loads tile positions [t0, t0 + kTile) of one (row, KV head) into
// dst[kTile][Dh + 1] as f32; positions >= t1 are zero-filled.
template <int KIND>
__device__ __forceinline__ void load_tile(float* dst, const void* slab,
                                          const float* scales, int b, int hk,
                                          int t0, int t1, int Sk, int Hk,
                                          int Dh) {
  const int ld = Dh + 1;
  if (KIND == BF16) {
    const auto* s = static_cast<const __nv_bfloat16*>(slab);
    for (int i = threadIdx.x; i < kTile * Dh; i += kThreads) {
      const int j = i / Dh, d = i - j * Dh, pos = t0 + j;
      dst[j * ld + d] =
          pos < t1 ? __bfloat162float(
                         s[((static_cast<size_t>(b) * Sk + pos) * Hk + hk) * Dh + d])
                   : 0.f;
    }
  } else {
    const auto* s = static_cast<const int32_t*>(slab);
    const int dw = Dh / 4;
    for (int i = threadIdx.x; i < kTile * dw; i += kThreads) {
      const int j = i / dw, wd = i - j * dw, pos = t0 + j;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (pos < t1) {
        const size_t ph = (static_cast<size_t>(b) * Sk + pos) * Hk + hk;
        const uint32_t word = static_cast<uint32_t>(s[ph * dw + wd]);
        const float sc = scales[ph];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = decode8<KIND>((word >> (8 * c)) & 0xFFu) * sc;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[j * ld + wd * 4 + c] = v[c];
    }
  }
}

// grid (splits, Hk, B), kThreads threads.  Writes one (m, l, acc) partial
// per (row, head, split).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const void* __restrict__ kslab,
                      const void* __restrict__ vslab,
                      const float* __restrict__ kscales,
                      const float* __restrict__ vscales,
                      const int32_t* __restrict__ lens,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Sk, int H, int Hk,
                      int Dh, int split_len, float scale) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = H / Hk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = Dh + 1;
  float* qs = smem;                       // [rep][Dh]
  float* kt = qs + rep * Dh;              // [kTile][Dh + 1]
  float* vt = kt + kTile * ld;            // [kTile][Dh + 1]
  float* pt = vt + kTile * ld;            // [rep][kTile]

  const int len = min(lens[b], Sk);
  const int s0 = sp * split_len;
  const int s1 = min(s0 + split_len, len);

  for (int i = threadIdx.x; i < rep * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    qs[i] = __bfloat162float(
                q[(static_cast<size_t>(b) * H + hk * rep + r) * Dh + d]) * scale;
  }

  float m_run[kMaxRowsPerWarp], l_run[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m_run[rr] = kNeg;
    l_run[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) acc[rr][i] = 0.f;
  }

  for (int t0 = s0; t0 < s1; t0 += kTile) {
    __syncthreads();   // previous tile fully consumed (and q staged)
    load_tile<KIND>(kt, kslab, kscales, b, hk, t0, s1, Sk, Hk, Dh);
    load_tile<KIND>(vt, vslab, vscales, b, hk, t0, s1, Sk, Hk, Dh);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= rep) continue;      // warp-uniform
      float s = kNeg;
      if (t0 + lane < s1) {
        s = 0.f;
        const float* qr = qs + r * Dh;
        const float* kr = kt + lane * ld;
        for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
      }
      const float m_new = fmaxf(m_run[rr], warp_max(s));
      const float corr = expf(m_run[rr] - m_new);
      const float p = expf(s - m_new);
      l_run[rr] = l_run[rr] * corr + warp_sum(p);
      pt[r * kTile + lane] = p;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kMaxDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d >= Dh) continue;
        float a = acc[rr][i] * corr;
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) a = fmaf(pt[r * kTile + j], vt[j * ld + d], a);
        acc[rr][i] = a;
      }
      __syncwarp();
      m_run[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= rep) continue;
    const size_t o = (static_cast<size_t>(b) * H + hk * rep + r) * splits + sp;
    if (lane == 0) {
      part_m[o] = m_run[rr];
      part_l[o] = l_run[rr];
    }
#pragma unroll
    for (int i = 0; i < kMaxDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < Dh) part_acc[o * Dh + d] = acc[rr][i];
    }
  }
}

// grid (H, B), Dh threads: merge the splits and normalise.
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      __nv_bfloat16* __restrict__ out, int H,
                                      int Dh, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = (static_cast<size_t>(b) * H + h) * splits;
  float m = kNeg;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part_m[base + s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(part_m[base + s] - m);
    l = fmaf(part_l[base + s], w, l);
    a = fmaf(part_acc[(base + s) * Dh + d], w, a);
  }
  out[(static_cast<size_t>(b) * H + h) * Dh + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q bf16 [B, 1, H, Dh]; kslab / vslab: bf16 [B, Sk, Hk, Dh] (kind 0) or
// int32 [B, Sk, Hk, Dh/4] packed codes (kind 1 int8, 2 fp8) with f32
// scales [B, Sk, Hk] (ignored for kind 0); lens int32 [B]; partials f32
// [B, H, splits] (m, l) and [B, H, splits, Dh] (acc); out bf16
// [B, 1, H, Dh].  H % Hk == 0, H / Hk <= 16, Dh <= 128, Dh % 4 == 0.
int decode_attention(const void* q, const void* kslab, const void* vslab,
                     const void* kscales, const void* vscales,
                     const void* lens, void* part_m, void* part_l,
                     void* part_acc, void* out, int B, int Sk, int H, int Hk,
                     int Dh, int kind, int split_len, int splits, float scale,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rep = H / Hk;
  const size_t smem =
      sizeof(float) * (rep * Dh + 2 * kTile * (Dh + 1) + rep * kTile);
  dim3 grid(splits, Hk, B);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ks = static_cast<const float*>(kscales);
  const auto* vs = static_cast<const float*>(vscales);
  const auto* ln = static_cast<const int32_t*>(lens);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  switch (kind) {
    case BF16:
      decode_partial_kernel<BF16><<<grid, kThreads, smem, s>>>(
          qb, kslab, vslab, ks, vs, ln, pm, pl, pa, Sk, H, Hk, Dh, split_len, scale);
      break;
    case INT8:
      decode_partial_kernel<INT8><<<grid, kThreads, smem, s>>>(
          qb, kslab, vslab, ks, vs, ln, pm, pl, pa, Sk, H, Hk, Dh, split_len, scale);
      break;
    case FP8_E4M3:
      decode_partial_kernel<FP8_E4M3><<<grid, kThreads, smem, s>>>(
          qb, kslab, vslab, ks, vs, ln, pm, pl, pa, Sk, H, Hk, Dh, split_len, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<<<dim3(H, B), Dh, 0, s>>>(
      pm, pl, pa, static_cast<__nv_bfloat16*>(out), H, Dh, splits);
  return cudaGetLastError();
}

}  // extern "C"
