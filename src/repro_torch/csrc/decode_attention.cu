// Split-KV flash-decode attention over a bf16, int8 or fp8 KV slab for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/decode_attention.py:
// _decode_bf16_kernel (bf16 slab, K3) and _decode_quant_kernel (int8 / fp8
// e4m3 codes packed four per int32 word along d_head, one f32 scale per
// (position, head), K4), both reached through gqa_decode_attention.
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
// design:
//  * A fixed split: block (s, hk, b) owns positions [64 s, 64 s + 64) of
//    one (row, KV head); the grid is ceil(Sk / 64) x Hk x B whatever the
//    lengths, so the host never reads kv_valid_len.  A block whose span
//    starts at or past its row's length exits at once; no block walks
//    more than two tiles, so a ragged batch costs its valid bytes and no
//    long row serialises the launch.
//  * Loads: the span's two tiles of 32 positions are copied into shared
//    memory with cp.async (16-byte copies where the row length and the
//    slab's alignment allow, else 8 or 4), both in flight at once; tile 1
//    lands while tile 0 is scored and summed.  Positions past the span's
//    end are zero-filled (and weigh 0).
//  * Compute: warp w takes positions 8 w .. 8 w + 7 of each tile, for 4
//    query heads of the group at a time (rep <= 16: up to 4 passes), so
//    each K / V element is read (and, for codes, dequantized: code *
//    scale) by one warp once per pass.  Lane l owns dims [DPL l, DPL l +
//    DPL), DPL = ceil(Dh / 32) a template parameter (Dh <= 256), and keeps
//    its q slices (prescaled in f32) and accumulators in registers.  The 8
//    positions' scores are the lanes' partial dot products summed across
//    the warp by a transposing reduction (9 shuffles for 8 sums), after
//    which lane l holds position 8 w + (l / 4) % 8; each warp runs its own
//    online softmax, the value sum takes each position's weight by a
//    shuffle, and the block merges its 4 warps' (max, sum, accumulator) in
//    warp order through shared memory.
//  * A second kernel merges the active spans' (max, sum, accumulator)
//    partials in span order and normalises.
// A row with kv_valid_len == 0 attends every position of its slab with
// equal weight (the mean of V over all Sk), as the reference does: there
// every score is masked to the same -1e30.  The serving path always has
// >= 1.
//
// C interface: launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Slab { BF16 = 0, INT8 = 1, FP8_E4M3 = 2 };

constexpr int kTile = 32;            // positions per tile (one per lane)
constexpr int kSpan = 64;            // positions per block: two tiles
constexpr int kTilesPerSpan = kSpan / kTile;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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

// cp.async of `bytes` (16, 8 or 4) bytes, zero-filled when !ok
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane dims [d0, d0 + DPL) of one tile row as f32: a bf16 row, or a row
// of int8 / fp8 codes times its position-head scale; dims >= Dh read 0.
// Dh % 4 == 0, so an aligned pair or quad of dims is in or out as a whole.
template <int KIND, int DPL>
__device__ __forceinline__ void read_row(const unsigned char* row, float sc,
                                         int d0, int Dh, float (&v)[DPL]) {
  if constexpr (KIND == BF16) {
    const auto* r = reinterpret_cast<const __nv_bfloat16*>(row);
    if constexpr (DPL % 2 == 0) {
#pragma unroll
      for (int i = 0; i < DPL; i += 2) {
        float2 f = make_float2(0.f, 0.f);
        if (d0 + i < Dh)
          f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(r + d0 + i));
        v[i] = f.x;
        v[i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        v[i] = d0 + i < Dh ? __bfloat162float(r[d0 + i]) : 0.f;
    }
  } else if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const uint32_t w =
          d0 + i < Dh ? *reinterpret_cast<const uint32_t*>(row + d0 + i) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[i + c] = decode8<KIND>((w >> (8 * c)) & 0xFFu) * sc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      v[i] = d0 + i < Dh ? decode8<KIND>(row[d0 + i]) * sc : 0.f;
  }
}

// Sums v[i] (i < 8) over the warp's 32 lanes; lane l gets the sum of
// v[(l >> 2) & 7].  Halves are exchanged at offsets 16, 8 and 4 (7
// shuffles), then a butterfly over 2 and 1: 9 shuffles for 8 sums.
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float send = b4 ? v[m] : v[m + 4], keep = b4 ? v[m + 4] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = b3 ? v[m] : v[m + 2], keep = b3 ? v[m + 2] : v[m];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? v[0] : v[1], keep = b2 ? v[1] : v[0];
  float s = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// max / sum over lanes that hold distinct positions (bits 2-4 of the lane)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (ceil(Sk / kSpan), Hk, B), kThreads threads.  Writes one (m, l,
// acc) partial per (row, head, active span); spans past a row's length
// write nothing (the combine kernel reads only the active ones).
// row_bytes: bytes of one (position, head) row of the slab (2 Dh or Dh);
// chunk: the cp.async width, dividing row_bytes and the slabs' alignment.
//
// Warp w takes positions 8 w .. 8 w + 7 of each tile of the span, for up
// to 4 query heads of the group at once (heads 4 c .. 4 c + 3, chunk c):
// it runs its own online softmax over its positions, and the block then
// merges the 4 warps' (max, sum, accumulator) in warp order.  Shared
// memory: per tile {K rows, V rows, K scales, V scales} as copied from
// the slab, then the merge buffer [warp][head][Dh + 2].
template <int KIND, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const __nv_bfloat16* __restrict__ q,
                      const unsigned char* __restrict__ kslab,
                      const unsigned char* __restrict__ vslab,
                      const float* __restrict__ kscales,
                      const float* __restrict__ vscales,
                      const int32_t* __restrict__ lens,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Sk, int H, int Hk,
                      int Dh, int row_bytes, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQuant = KIND != BF16;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int rep = H / Hk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int lb = lens[b];
  const bool empty = lb <= 0;           // uniform weights over the slab
  const int len = empty ? Sk : min(lb, Sk);
  const int s0 = sp * kSpan;
  if (s0 >= len) return;
  const int s1 = min(s0 + kSpan, len);
  const int ntiles = (s1 - s0 + kTile - 1) / kTile;

  const int tile_bytes = kTile * row_bytes;
  const int stage_bytes = 2 * tile_bytes + 2 * kTile * 4;
  for (int t = 0; t < ntiles; ++t) {
    unsigned char* st = smem + t * stage_bytes;
    const int t0 = s0 + t * kTile;
    const int per_row = row_bytes / chunk;
    for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
      const int j = i / per_row, c = (i - j * per_row) * chunk;
      const bool ok = t0 + j < s1;
      const size_t off = ok ? ((static_cast<size_t>(b) * Sk + t0 + j) * Hk + hk)
                                  * row_bytes + c
                            : 0;
      cp_async(st + j * row_bytes + c, kslab + off, chunk, ok);
      cp_async(st + tile_bytes + j * row_bytes + c, vslab + off, chunk, ok);
    }
    if (kQuant && threadIdx.x < 2 * kTile) {
      const int j = threadIdx.x & (kTile - 1);
      const bool ok = t0 + j < s1;
      const size_t ph = ok ? (static_cast<size_t>(b) * Sk + t0 + j) * Hk + hk : 0;
      const float* src = threadIdx.x < kTile ? kscales + ph : vscales + ph;
      cp_async(st + 2 * tile_bytes + threadIdx.x * 4, src, 4, ok);
    }
    cp_async_commit();
  }
  float* mrg = reinterpret_cast<float*>(smem + kTilesPerSpan * stage_bytes);
  const int mld = Dh + 2;                       // [warp][head][m, l, acc]

  const int d0 = lane * DPL;
  const int pi = (lane >> 2) & 7;   // lane's position in the warp's 8
  const int j0 = 8 * warp;          // the warp's first position in a tile
  for (int c = 0; c * 4 < rep; ++c) {
    // this lane's q slices of heads 4 c .. 4 c + 3, prescaled in f32
    float qv[4][DPL];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = 4 * c + rr;
      const __nv_bfloat16* qr =
          q + (static_cast<size_t>(b) * H + hk * rep + (r < rep ? r : 0)) * Dh;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qv[rr][i] = r < rep && d0 + i < Dh
                        ? __bfloat162float(qr[d0 + i]) * scale : 0.f;
    }
    float m_run[4], l_run[4], acc[4][DPL];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      m_run[rr] = kNeg;
      l_run[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
    }

    for (int t = 0; t < ntiles; ++t) {
      if (c == 0) {                 // tile t lands once, for every chunk
        if (t + 1 < ntiles) cp_async_wait<kTilesPerSpan - 1>();
        else cp_async_wait<0>();
        __syncthreads();
      }
      const unsigned char* kt = smem + t * stage_bytes;
      const unsigned char* vt = kt + tile_bytes;
      const float* ksc = reinterpret_cast<const float*>(vt + tile_bytes);
      const float* vsc = ksc + kTile;
      const int n = min(kTile, s1 - (s0 + t * kTile));   // valid positions
      if (j0 >= n) continue;                             // warp-uniform

      // scores of the warp's 8 positions (zero-filled past n)
      float part[4][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float kv[DPL];
        read_row<KIND, DPL>(kt + (j0 + i) * row_bytes,
                            kQuant ? ksc[j0 + i] : 1.f, d0, Dh, kv);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) s = fmaf(qv[rr][d], kv[d], s);
          part[rr][i] = s;
        }
      }
      // lane l: position j0 + pi; online softmax update over the 8
      const bool valid = j0 + pi < n;
      float p[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float s = warp_sum8(part[rr], lane);
        s = valid && !empty ? s : kNeg;
        const float m_new = fmaxf(m_run[rr], group_max(s));
        const float corr = expf(m_run[rr] - m_new);
        p[rr] = valid ? expf(s - m_new) : 0.f;
        l_run[rr] = l_run[rr] * corr + group_sum(p[rr]);
        m_run[rr] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[rr][d] *= corr;
      }
      // value sum; position j0 + i's weight comes from lane 4 i
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float vv[DPL];
        read_row<KIND, DPL>(vt + (j0 + i) * row_bytes,
                            kQuant ? vsc[j0 + i] : 1.f, d0, Dh, vv);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const float pj = __shfl_sync(0xffffffffu, p[rr], 4 * i);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[rr][d] = fmaf(pj, vv[d], acc[rr][d]);
        }
      }
    }

    // merge the warps' partials of each head, in warp order
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float* mw = mrg + (warp * 4 + rr) * mld;
      if (lane == 0) {
        mw[0] = m_run[rr];
        mw[1] = l_run[rr];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        if (d0 + i < Dh) mw[2 + d0 + i] = acc[rr][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * Dh; idx += kThreads) {
      const int rr = idx / Dh, d = idx - rr * Dh, r = 4 * c + rr;
      if (r >= rep) continue;
      float m = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mrg[(w * 4 + rr) * mld]);
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* mw = mrg + (w * 4 + rr) * mld;
        const float wt = expf(mw[0] - m);
        l = fmaf(mw[1], wt, l);
        a = fmaf(mw[2 + d], wt, a);
      }
      const size_t o = (static_cast<size_t>(b) * H + hk * rep + r) * splits + sp;
      if (d == 0) {
        part_m[o] = m;
        part_l[o] = l;
      }
      part_acc[o * Dh + d] = a;
    }
    __syncthreads();               // the merge buffer is free again
  }
}

// grid (H, B), Dh rounded up to 32 threads (<= 256): merge the row's
// active spans in span order and normalise.  The spans' weights
// exp(m_s - m) are computed once into shared memory (up to kCombineChunk
// spans at a time).
constexpr int kCombineChunk = 256;

__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      const int32_t* __restrict__ lens,
                                      __nv_bfloat16* __restrict__ out, int Sk,
                                      int H, int Dh, int splits) {
  __shared__ float wts[kCombineChunk];
  __shared__ float red[8];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const bool live = d < Dh;        // blockDim.x is Dh rounded up to 32
  const int len = lens[b] <= 0 ? Sk : min(lens[b], Sk);
  const int active = (len + kSpan - 1) / kSpan;
  const size_t base = (static_cast<size_t>(b) * H + h) * splits;
  // m: the largest span max
  float m = kNeg;
  for (int s = d; s < active; s += blockDim.x) m = fmaxf(m, part_m[base + s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  float l = 0.f, a = 0.f;
  for (int c0 = 0; c0 < active; c0 += kCombineChunk) {
    const int cn = min(kCombineChunk, active - c0);
    __syncthreads();
    for (int s = d; s < cn; s += blockDim.x)
      wts[s] = expf(part_m[base + c0 + s] - m);
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < cn; ++s) {
      l = fmaf(part_l[base + c0 + s], wts[s], l);
      if (live) a = fmaf(part_acc[(base + c0 + s) * Dh + d], wts[s], a);
    }
  }
  if (live)
    out[(static_cast<size_t>(b) * H + h) * Dh + d] =
        __float2bfloat16(a / fmaxf(l, 1e-30f));
}

struct Args {
  const __nv_bfloat16* q;
  const unsigned char *k, *v;
  const float *ks, *vs;
  const int32_t* lens;
  float *pm, *pl, *pa;
  int Sk, H, Hk, Dh, row_bytes, chunk;
  float scale;
};

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

// shared memory of one block: the span's tiles and the merge buffer
constexpr int partial_smem(int row_bytes, int Dh) {
  return kTilesPerSpan * (2 * kTile * row_bytes + 2 * kTile * 4) +
         kWarps * 4 * (Dh + 2) * 4;
}

template <int KIND, int DPL>
cudaError_t launch_partial(const Args& a, dim3 grid, cudaStream_t s) {
  static bool ready[kMaxDevices] = {};
  // the limit for the widest Dh this instantiation takes (bf16 rows)
  cudaError_t e = set_smem_attributes(decode_partial_kernel<KIND, DPL>,
                                      partial_smem(64 * DPL, 32 * DPL), ready);
  if (e != cudaSuccess) return e;
  const int smem = partial_smem(a.row_bytes, a.Dh);
  decode_partial_kernel<KIND, DPL><<<grid, kThreads, smem, s>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.lens, a.pm, a.pl, a.pa, a.Sk, a.H, a.Hk,
      a.Dh, a.row_bytes, a.chunk, a.scale);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const Args& a, dim3 grid, cudaStream_t s) {
  switch ((a.Dh + 31) / 32) {
    case 1: return launch_partial<KIND, 1>(a, grid, s);
    case 2: return launch_partial<KIND, 2>(a, grid, s);
    case 3: return launch_partial<KIND, 3>(a, grid, s);
    case 4: return launch_partial<KIND, 4>(a, grid, s);
    case 5: return launch_partial<KIND, 5>(a, grid, s);
    case 6: return launch_partial<KIND, 6>(a, grid, s);
    case 7: return launch_partial<KIND, 7>(a, grid, s);
    case 8: return launch_partial<KIND, 8>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q bf16 [B, 1, H, Dh]; kslab / vslab: bf16 [B, Sk, Hk, Dh] (kind 0) or
// int32 [B, Sk, Hk, Dh/4] packed codes (kind 1 int8, 2 fp8) with f32
// scales [B, Sk, Hk] (ignored for kind 0); lens int32 [B]; partials f32
// [B, H, splits] (m, l) and [B, H, splits, Dh] (acc) with splits =
// ceil(Sk / 64); out bf16 [B, 1, H, Dh].  H % Hk == 0, H / Hk <= 16,
// Dh <= 256, Dh % 4 == 0; chunk in {4, 8, 16} divides the slab row's
// bytes and both slabs' alignment.
int decode_attention(const void* q, const void* kslab, const void* vslab,
                     const void* kscales, const void* vscales,
                     const void* lens, void* part_m, void* part_l,
                     void* part_acc, void* out, int B, int Sk, int H, int Hk,
                     int Dh, int kind, int chunk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (Sk + kSpan - 1) / kSpan;
  Args a{static_cast<const __nv_bfloat16*>(q),
         static_cast<const unsigned char*>(kslab),
         static_cast<const unsigned char*>(vslab),
         static_cast<const float*>(kscales),
         static_cast<const float*>(vscales),
         static_cast<const int32_t*>(lens),
         static_cast<float*>(part_m), static_cast<float*>(part_l),
         static_cast<float*>(part_acc), Sk, H, Hk, Dh,
         kind == BF16 ? 2 * Dh : Dh, chunk, scale};
  dim3 grid(splits, Hk, B);
  cudaError_t e;
  switch (kind) {
    case BF16: e = launch_kind<BF16>(a, grid, s); break;
    case INT8: e = launch_kind<INT8>(a, grid, s); break;
    case FP8_E4M3: e = launch_kind<FP8_E4M3>(a, grid, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  decode_combine_kernel<<<dim3(H, B), (Dh + 31) / 32 * 32, 0, s>>>(
      a.pm, a.pl, a.pa, a.lens, static_cast<__nv_bfloat16*>(out), Sk, H, Dh,
      splits);
  return cudaGetLastError();
}

}  // extern "C"
