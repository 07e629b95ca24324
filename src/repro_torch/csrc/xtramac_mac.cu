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
// single unsigned 64-bit multiply (exact: a valid plan's product is at
// most 45 bits).  Inputs are sign-extended to 64 bits and the product is
// taken mod 2^64, the same bits as the plain torch version's int64
// arithmetic for any input.
//
// One body, templated on the element type: int32 in and out for
// virtual_dsp_multiply (the reference kernel's domain, lanes <= 19 bits),
// int64 for packed_multiply, where lanes reach 40 bits (fp32 pairs).
//
// What bounds it on the H100: the bytes, T * (n_a + n_b + P) elements read
// or written once against a handful of integer instructions per element.
// Its design: a grid-stride loop, one thread per issue; the plan is a
// struct passed by value and its per-port loops are unrolled to the
// struct's fixed size with guards, so the offsets stay in the parameter
// bank.  Adjacent threads touch adjacent rows, so a warp's loads and
// stores cover contiguous bytes.
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
constexpr long long kMaxBlocks = 132 * 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    vdsp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ out, long long rows, const VdspLanePlan plan) {
  const unsigned long long mask = (1ull << plan.stride) - 1ull;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < rows; t += step) {
    const T* at = a + t * plan.n_a;
    const T* bt = b + t * plan.n_b;
    unsigned long long wa = 0, wb = 0;
#pragma unroll
    for (int i = 0; i < kMaxPortLanes; ++i) {
      if (i < plan.n_a)
        wa |= static_cast<unsigned long long>(static_cast<long long>(at[i]))
              << plan.off_a[i];
    }
#pragma unroll
    for (int j = 0; j < kMaxPortLanes; ++j) {
      if (j < plan.n_b)
        wb |= static_cast<unsigned long long>(static_cast<long long>(bt[j]))
              << plan.off_b[j];
    }
    const unsigned long long p = wa * wb;
    T* ot = out + t * plan.n_lanes;
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      if (l < plan.n_lanes) ot[l] = static_cast<T>((p >> plan.pos[l]) & mask);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows,
           const VdspLanePlan* plan, void* stream) {
  if (rows <= 0 || plan->n_a < 1 || plan->n_a > kMaxPortLanes ||
      plan->n_b < 1 || plan->n_b > kMaxPortLanes || plan->n_lanes < 1 ||
      plan->n_lanes > kMaxLanes || plan->stride < 1 || plan->stride > 63)
    return cudaErrorInvalidValue;
  const long long blocks =
      std::min<long long>((rows + kThreads - 1) / kThreads, kMaxBlocks);
  vdsp_kernel<T><<<static_cast<int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), rows, *plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a [rows, n_a], b [rows, n_b], out [rows, n_lanes], all int32 and
// contiguous; plan on the host (copied into the launch's parameters).
int vdsp_multiply_i32(const void* a, const void* b, void* out, long long rows,
                      const VdspLanePlan* plan, void* stream) {
  return launch<int32_t>(a, b, out, rows, plan, stream);
}

// The same over int64 tensors.
int vdsp_multiply_i64(const void* a, const void* b, void* out, long long rows,
                      const VdspLanePlan* plan, void* stream) {
  return launch<int64_t>(a, b, out, rows, plan, stream);
}

}  // extern "C"
