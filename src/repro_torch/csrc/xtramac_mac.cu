// The XtraMAC virtual-DSP packed multiply for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel repro/kernels/xtramac_mac.py:_vdsp_kernel,
// reached through virtual_dsp_multiply, and runs Stage 2 of the port's
// packed MAC datapath (core/packing.py:packed_multiply).  Per issue t it
// computes paper Eqs. (9)-(11):
//   A = OR_i a[t, i] << off_a[i]          B = OR_j b[t, j] << off_b[j]
//   P = A * B                             (one wide multiply)
//   out[t, l] = (P >> pos[l]) & (2^stride - 1)
// with the lane positions pos[l] = off_a[i] + off_b[j] in i-major order.
// The ports are OR-ed, not added, as both references do.
//
// The TPU kernel split the 27 x 18-bit product into 13/9-bit limbs and
// three 16-bit result limbs because its vector lanes are 32 bits wide; the
// card multiplies in 64 bits, so one thread forms both words and takes a
// single wide multiply (exact: a valid plan's product is at most 45 bits).
// Inputs are sign-extended to 64 bits, the product is taken mod 2^64 and
// shifted arithmetically, the same bits as the plain torch version's int64
// arithmetic for any input.  Where the kernel finds both words below 2^32
// (every valid plan on in-range magnitudes) it takes one 32 x 32 -> 64
// mul.wide instead of the 64 x 64 multiply; the bits are the same.
//
// One body, templated on the element type: int32 in and out for
// virtual_dsp_multiply (the reference kernel's domain, lanes <= 19 bits),
// int64 for packed_multiply, where lanes reach 40 bits (fp32 pairs).
//
// What bounds it on the H100: the bytes, T * (n_a + n_b + P) elements read
// or written once against a handful of integer instructions per element --
// provided the instructions stay few: loops over the plan struct's full
// size behind guards on its counts cost more instructions than the bytes take
// (launch/vdsp_ablation.py).  The design:
//  * a block owns a tile of TILE consecutive issues; the tile's rows of a
//    and b are contiguous ([T, n] row-major), so they are staged into
//    shared memory with 16-byte cp.async copies (a warp reads 512
//    contiguous bytes), element copies only for an unaligned tensor or the
//    ragged end of the last tile;
//  * each thread computes RPT independent issues from shared memory (rows
//    tid, tid + 256, ...: a warp's shared accesses are contiguous), and
//    writes its lanes into an output tile in shared memory;
//  * the [TILE, P] output tile leaves with 16-byte coalesced stores;
//  * the body is specialised on (n_a, n_b) for the plans that run (the
//    paper pairs capped at 4 lanes, core/packing.py's beyond-paper plans,
//    fp32 x int16): the port loops are unrolled to their exact trip
//    counts and rows move with vector shared-memory accesses.  A generic
//    instantiation of the same kernel takes any other plan
//    LanePlan.validate admits (kernels/xtramac_mac.py:kernel_variant picks).
//
// C interface: launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

constexpr int kMaxPortLanes = 16;
constexpr int kMaxLanes = 32;

// Mirrors kernels/xtramac_mac.py:_Plan.  Outside the unnamed namespace: the
// C entry points take it, and a parameter type with internal linkage would
// keep them out of the library's exported symbols.
struct VdspLanePlan {
  int n_a, n_b, n_lanes, stride;
  int off_a[kMaxPortLanes];
  int off_b[kMaxPortLanes];
  int pos[kMaxLanes];
};

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;   // a specialised tile's bytes, at most
constexpr int kMaxDevices = 16;

// (n_a, n_b) of the specialised bodies, in kernels/xtramac_mac.py's
// SPECIALISED order (variant v = index + 1; 0 is the generic body)
constexpr int kVariantNa[] = {1, 2, 3, 2, 1, 2};
constexpr int kVariantNb[] = {1, 1, 1, 2, 4, 4};

// Rows per thread of a specialised body: 4 while the tile's a, b and out
// rows fit the budget, else 2, else 1.
template <typename T, int NA, int NB>
struct Rows {
  static constexpr int kRowBytes = (NA + NB + NA * NB) * sizeof(T);
  static constexpr int value = kThreads * 4 * kRowBytes <= kSmemBudget   ? 4
                               : kThreads * 2 * kRowBytes <= kSmemBudget ? 2
                                                                         : 1;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// n elements of T from global src to shared dst: 16-byte copies where src
// is 16-byte aligned (vec), then element copies for the rest.
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* __restrict__ src,
                                         int n, bool vec) {
  constexpr int E = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int chunks = n / E;
    for (int c = threadIdx.x; c < chunks; c += kThreads)
      cp_async16(dst + c * E, src + c * E);
    done = chunks * E;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// n elements of T from shared src to global dst: 16-byte stores where dst
// is 16-byte aligned (vec), then element stores.
template <typename T>
__device__ __forceinline__ void stage_out(T* __restrict__ dst, const T* src,
                                          int n, bool vec) {
  constexpr int E = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int chunks = n / E;
    for (int c = threadIdx.x; c < chunks; c += kThreads)
      *reinterpret_cast<uint4*>(dst + c * E) =
          *reinterpret_cast<const uint4*>(src + c * E);
    done = chunks * E;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// One row of N elements between shared memory and registers, as one 8- or
// 16-byte access (or two 16-byte ones) where the row's width allows.
template <typename T, int N>
__device__ __forceinline__ void row_load(const T* s, T (&v)[N]) {
  constexpr int B = N * sizeof(T);
  if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(s);
    *reinterpret_cast<uint2*>(v) = u;
  } else if constexpr (B % 16 == 0) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      reinterpret_cast<uint4*>(v)[i] = reinterpret_cast<const uint4*>(s)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = s[i];
  }
}

template <typename T, int N>
__device__ __forceinline__ void row_store(T* s, const T (&v)[N]) {
  constexpr int B = N * sizeof(T);
  if constexpr (B == 8) {
    *reinterpret_cast<uint2*>(s) = *reinterpret_cast<const uint2*>(v);
  } else if constexpr (B % 16 == 0) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      reinterpret_cast<uint4*>(s)[i] = reinterpret_cast<const uint4*>(v)[i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = v[i];
  }
}

// A * B mod 2^64: one 32 x 32 -> 64 multiply where both words are below
// 2^32, else the 64 x 64 multiply (the same bits either way).
__device__ __forceinline__ unsigned long long wide_product(
    unsigned long long wa, unsigned long long wb) {
  if (((wa | wb) >> 32) == 0ull) {
    unsigned long long p;
    asm("mul.wide.u32 %0, %1, %2;\n"
        : "=l"(p)
        : "r"(static_cast<unsigned>(wa)), "r"(static_cast<unsigned>(wb)));
    return p;
  }
  return wa * wb;
}

// lane l of the product: an arithmetic shift (torch's >> on int64), masked
template <typename T>
__device__ __forceinline__ T lane_of(unsigned long long p, int pos,
                                     unsigned long long mask) {
  return static_cast<T>(
      static_cast<unsigned long long>(static_cast<long long>(p) >> pos) &
      mask);
}

template <typename T>
__device__ __forceinline__ unsigned long long port_bits(T v, int off) {
  return static_cast<unsigned long long>(static_cast<long long>(v)) << off;
}

// Grid: ceil(rows / TILE) blocks of 256 threads, TILE = 256 * RPT issues.
// Shared memory: the tile's a rows, b rows and output rows, in that order.
// NA == 0: the generic body, the plan's counts read at run time.
template <typename T, int NA, int NB, int RPT>
__global__ void __launch_bounds__(kThreads)
    vdsp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, long long rows, const VdspLanePlan plan,
                int vec_a, int vec_b, int vec_out) {
  constexpr int TILE = kThreads * RPT;
  extern __shared__ __align__(16) unsigned char vdsp_smem[];
  const int na = NA > 0 ? NA : plan.n_a;
  const int nb = NA > 0 ? NB : plan.n_b;
  const int np = NA > 0 ? NA * NB : plan.n_lanes;
  T* sa = reinterpret_cast<T*>(vdsp_smem);
  T* sb = sa + TILE * na;         // TILE * n * sizeof(T): a multiple of 16
  T* so = sb + TILE * nb;

  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nr = static_cast<int>(min(static_cast<long long>(TILE), rows - t0));
  stage_in(sa, a + t0 * na, nr * na, vec_a);
  stage_in(sb, b + t0 * nb, nr * nb, vec_b);
  cp_async_wait_all();
  __syncthreads();

  const unsigned long long mask = (1ull << plan.stride) - 1ull;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.x + k * kThreads;
    if (r >= nr) break;
    unsigned long long wa = 0, wb = 0;
    if constexpr (NA > 0) {
      constexpr int NP = NA * NB;
      alignas(16) T va[NA];
      alignas(16) T vb[NB];
      alignas(16) T vo[NP];
      row_load(sa + r * NA, va);
      row_load(sb + r * NB, vb);
#pragma unroll
      for (int i = 0; i < NA; ++i) wa |= port_bits(va[i], plan.off_a[i]);
#pragma unroll
      for (int j = 0; j < NB; ++j) wb |= port_bits(vb[j], plan.off_b[j]);
      const unsigned long long p = wide_product(wa, wb);
#pragma unroll
      for (int l = 0; l < NP; ++l) vo[l] = lane_of<T>(p, plan.pos[l], mask);
      row_store(so + r * NP, vo);
    } else {
      for (int i = 0; i < na; ++i) wa |= port_bits(sa[r * na + i], plan.off_a[i]);
      for (int j = 0; j < nb; ++j) wb |= port_bits(sb[r * nb + j], plan.off_b[j]);
      const unsigned long long p = wide_product(wa, wb);
      for (int l = 0; l < np; ++l) so[r * np + l] = lane_of<T>(p, plan.pos[l], mask);
    }
  }
  __syncthreads();
  stage_out(out + t0 * np, so, nr * np, vec_out);
}

template <typename T, int NA, int NB, int RPT>
cudaError_t launch_body(const T* a, const T* b, T* out, long long rows,
                        const VdspLanePlan& plan, int vec_a, int vec_b,
                        int vec_out, cudaStream_t stream) {
  constexpr int TILE = kThreads * RPT;
  const int smem = TILE * (plan.n_a + plan.n_b + plan.n_lanes) *
                   static_cast<int>(sizeof(T));
  if (smem > kSmemBudget) {     // the generic body on a wide plan: once per device
    static bool ready[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices || !ready[dev]) {
      e = cudaFuncSetAttribute(vdsp_kernel<T, NA, NB, RPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kThreads * (2 * kMaxPortLanes + kMaxLanes) *
                                   static_cast<int>(sizeof(int64_t)));
      if (e != cudaSuccess) return e;
      if (dev < kMaxDevices) ready[dev] = true;
    }
  }
  const long long blocks = (rows + TILE - 1) / TILE;
  vdsp_kernel<T, NA, NB, RPT><<<static_cast<unsigned>(blocks), kThreads, smem,
                                stream>>>(a, b, out, rows, plan, vec_a, vec_b,
                                          vec_out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows,
           const VdspLanePlan* plan, int variant, void* stream) {
  if (rows <= 0 || plan->n_a < 1 || plan->n_a > kMaxPortLanes ||
      plan->n_b < 1 || plan->n_b > kMaxPortLanes || plan->n_lanes < 1 ||
      plan->n_lanes > kMaxLanes || plan->stride < 1 || plan->stride > 63 ||
      variant < 0 || variant > 6)
    return cudaErrorInvalidValue;
  if (variant > 0 && (plan->n_a != kVariantNa[variant - 1] ||
                      plan->n_b != kVariantNb[variant - 1] ||
                      plan->n_lanes != plan->n_a * plan->n_b))
    return cudaErrorInvalidValue;
  const auto* ap = static_cast<const T*>(a);
  const auto* bp = static_cast<const T*>(b);
  auto* op = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int va = reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vb = reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int vo = reinterpret_cast<uintptr_t>(out) % 16 == 0;
#define VDSP_CASE(V, NA, NB)                                                  \
  case V:                                                                     \
    return launch_body<T, NA, NB, Rows<T, NA, NB>::value>(ap, bp, op, rows,   \
                                                          *plan, va, vb, vo,  \
                                                          s);
  switch (variant) {
    VDSP_CASE(1, 1, 1)
    VDSP_CASE(2, 2, 1)
    VDSP_CASE(3, 3, 1)
    VDSP_CASE(4, 2, 2)
    VDSP_CASE(5, 1, 4)
    VDSP_CASE(6, 2, 4)
    default:
      return launch_body<T, 0, 0, 1>(ap, bp, op, rows, *plan, va, vb, vo, s);
  }
#undef VDSP_CASE
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a [rows, n_a], b [rows, n_b], out [rows, n_lanes], all int32 and
// contiguous; plan on the host (copied into the launch's parameters);
// variant: the specialised body (kernels/xtramac_mac.py:kernel_variant), 0
// for the generic one.
int vdsp_multiply_i32(const void* a, const void* b, void* out, long long rows,
                      const VdspLanePlan* plan, int variant, void* stream) {
  return launch<int32_t>(a, b, out, rows, plan, variant, stream);
}

// The same over int64 tensors.
int vdsp_multiply_i64(const void* a, const void* b, void* out, long long rows,
                      const VdspLanePlan* plan, int variant, void* stream) {
  return launch<int64_t>(a, b, out, rows, plan, variant, stream);
}

}  // extern "C"
