"""Where the first design of K6 (the virtual-DSP lane multiply) spent its
time: variants of it, built apart from the port, timed beside K6 and the
broadcast multiply on the same inputs.

  PYTHONPATH=src python -m repro_torch.launch.vdsp_ablation

The first design (csrc/xtramac_mac.cu before its redesign) ran one thread
per issue in a grid-stride loop of at most 132 x 16 blocks, read the plan
from the launch's parameters with its per-port loops unrolled to the
struct's fixed size behind guards, and moved each element 4 or 8 bytes at
a time.  ``SOURCE`` below holds that kernel and the variants, selected by
``mode``:

  0 first      the first design as it was;
  1 copies     its loads and stores alone (the words XOR-ed, no multiply,
               no extraction);
  2 no_extract pack and multiply, then every lane gets the product's low
               bits (no shift-and-mask loop);
  3 rows4      four consecutive issues per thread;
  4 fixed      the loops fixed to the plan's 2 x 1 lanes (no guards);
  5 tiled_copy the redesign's data movement alone: 16-byte cp.async
               staging of a tile of rows, 16-byte stores of the output
               tile (a's words in every lane).

Cases: int4 x bf16 (2 x 1 lanes, P = 2) in int32 and fp32 x int16 (1 x 1,
int64; modes 0-3 and 5), at the Table VII GEMV's 50,331,648 lane MACs.
Each time is the median of 20 calls (CUDA events, L2 flushed before each,
``kernel_times.time_ms``).  The variants are built with ``nvcc`` into
``build/ablation/`` and are not part of the port.  Prints one JSON line per
case and the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.core import packing as P
from repro_torch.kernels import build
from repro_torch.kernels.xtramac_mac import (_kernel_plan, _Plan,
                                             virtual_dsp_multiply)
from repro_torch.launch.kernel_times import LANE_MACS, time_ms

MODES = ("first", "copies", "no_extract", "rows4", "fixed", "tiled_copy")

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <algorithm>

struct VdspLanePlan {
  int n_a, n_b, n_lanes, stride;
  int off_a[16];
  int off_b[16];
  int pos[32];
};

namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(256)
    first_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, long long rows, const VdspLanePlan plan) {
  const unsigned long long mask = (1ull << plan.stride) - 1ull;
  constexpr int R = MODE == 3 ? 4 : 1;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * R;
  for (long long t0 = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) * R;
       t0 < rows; t0 += step) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const long long t = t0 + q;
      if (t >= rows) break;
      const T* at = a + t * plan.n_a;
      const T* bt = b + t * plan.n_b;
      T* ot = out + t * plan.n_lanes;
      unsigned long long wa = 0, wb = 0;
      if (MODE == 4) {
        wa = static_cast<unsigned long long>(static_cast<long long>(at[0]))
                 << plan.off_a[0] |
             static_cast<unsigned long long>(static_cast<long long>(at[1]))
                 << plan.off_a[1];
        wb = static_cast<unsigned long long>(static_cast<long long>(bt[0]))
             << plan.off_b[0];
        const unsigned long long p = wa * wb;
        ot[0] = static_cast<T>((p >> plan.pos[0]) & mask);
        ot[1] = static_cast<T>((p >> plan.pos[1]) & mask);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < plan.n_a) {
          const unsigned long long v =
              static_cast<unsigned long long>(static_cast<long long>(at[i]));
          wa = MODE == 1 ? wa ^ v : wa | (v << plan.off_a[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < plan.n_b) {
          const unsigned long long v =
              static_cast<unsigned long long>(static_cast<long long>(bt[j]));
          wb = MODE == 1 ? wb ^ v : wb | (v << plan.off_b[j]);
        }
      }
      const unsigned long long p = MODE == 1 ? wa ^ wb : wa * wb;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        if (l < plan.n_lanes)
          ot[l] = MODE == 0 || MODE == 3
                      ? static_cast<T>((p >> plan.pos[l]) & mask)
                      : static_cast<T>(p);
      }
    }
  }
}

// the redesign's data movement: a tile of 1024 rows of a and b staged
// with 16-byte cp.async, the [1024, P] tile of a's words stored 16 bytes
// at a time
template <typename T>
__global__ void __launch_bounds__(256)
    tiled_copy_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, long long rows,
                      const VdspLanePlan plan) {
  constexpr int TILE = 1024, E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + TILE * plan.n_a;
  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  const int nr = static_cast<int>(min(static_cast<long long>(TILE), rows - t0));
  const int na = nr * plan.n_a, nb = nr * plan.n_b;
  for (int c = threadIdx.x; c < na / E; c += 256) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(sa + c * E));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(a + t0 * plan.n_a + c * E) : "memory");
  }
  for (int c = threadIdx.x; c < nb / E; c += 256) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(sb + c * E));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(b + t0 * plan.n_b + c * E) : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int no = nr * plan.n_lanes;
  T* o = out + t0 * plan.n_lanes;
  for (int c = threadIdx.x; c < no / E; c += 256)
    *reinterpret_cast<uint4*>(o + c * E) =
        *reinterpret_cast<const uint4*>(sa + (c * E) % (TILE * plan.n_a));
}

template <typename T>
int launch(const void* a, const void* b, void* out, long long rows,
           const VdspLanePlan* plan, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const T*>(a);
  const auto* bp = static_cast<const T*>(b);
  auto* op = static_cast<T*>(out);
  const int blocks = static_cast<int>(
      std::min<long long>((rows + 255) / 256, 132 * 16));
  switch (mode) {
    case 0: first_kernel<T, 0><<<blocks, 256, 0, s>>>(ap, bp, op, rows, *plan); break;
    case 1: first_kernel<T, 1><<<blocks, 256, 0, s>>>(ap, bp, op, rows, *plan); break;
    case 2: first_kernel<T, 2><<<blocks, 256, 0, s>>>(ap, bp, op, rows, *plan); break;
    case 3: first_kernel<T, 3><<<blocks, 256, 0, s>>>(ap, bp, op, rows, *plan); break;
    case 4: first_kernel<T, 4><<<blocks, 256, 0, s>>>(ap, bp, op, rows, *plan); break;
    case 5:
      tiled_copy_kernel<T><<<static_cast<unsigned>((rows + 1023) / 1024), 256,
                             1024 * (plan->n_a + plan->n_b) * sizeof(T), s>>>(
          ap, bp, op, rows, *plan);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {
int ablate_i32(const void* a, const void* b, void* out, long long rows,
               const VdspLanePlan* plan, int mode, void* stream) {
  return launch<int32_t>(a, b, out, rows, plan, mode, stream);
}
int ablate_i64(const void* a, const void* b, void* out, long long rows,
               const VdspLanePlan* plan, int mode, void* stream) {
  return launch<int64_t>(a, b, out, rows, plan, mode, stream);
}
}
"""


def load_variants() -> ctypes.CDLL:
    """Compile ``SOURCE`` (sm_90a, the port's flags) into
    ``build/ablation/`` and load it."""
    out_dir = build.BUILD_DIR.parent / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "vdsp_ablation.cu", out_dir / "vdsp_ablation.so"
    src.write_text(SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.ablate_i32, lib.ablate_i64):
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.POINTER(_Plan), ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vdsp_ablation: no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    lib = load_variants()
    for pair, cap, dtype in ((("int4", "bf16"), 4, torch.int32),
                             (("fp32", "int16"), None, torch.int64)):
        plan = P.solve_lane_plan(*pair, max_parallelism=cap)
        kplan = _kernel_plan(plan)
        t = LANE_MACS // plan.parallelism
        a = torch.randint(0, P.max_magnitude(plan.fmt_a) + 1,
                          (t, kplan.n_a), generator=gen, device=dev,
                          dtype=dtype)
        b = torch.randint(0, P.max_magnitude(plan.fmt_b) + 1,
                          (t, kplan.n_b), generator=gen, device=dev,
                          dtype=dtype)
        out = torch.empty((t, kplan.n_lanes), dtype=dtype, device=dev)
        fn = lib.ablate_i32 if dtype == torch.int32 else lib.ablate_i64
        stream = torch.cuda.current_stream().cuda_stream
        want = (virtual_dsp_multiply(a, b, plan) if dtype == torch.int32
                else P.packed_multiply(plan, a, b))
        rows = {"k6": lambda: (virtual_dsp_multiply(a, b, plan)
                               if dtype == torch.int32
                               else P.packed_multiply(plan, a, b)),
                "broadcast_multiply": lambda: (a[:, :, None]
                                               * b[:, None, :]).flatten(1)}
        for mode, name in enumerate(MODES):
            if name == "fixed" and (kplan.n_a, kplan.n_b) != (2, 1):
                continue
            rows[name] = (lambda m=mode: fn(a.data_ptr(), b.data_ptr(),
                                            out.data_ptr(), t,
                                            ctypes.byref(kplan), m, stream))
        for name, call in rows.items():
            ms = time_ms(call, flush)
            case = {"variant": name, "pair": "x".join(pair),
                    "dtype": str(dtype).split(".")[-1], "t": t,
                    "p": plan.parallelism, "ms": ms}
            if name in ("first", "rows4", "fixed"):
                err = call()
                torch.cuda.synchronize()
                case["equal_to_k6"] = err == 0 and bool(torch.equal(out, want))
            print(json.dumps(case), flush=True)
        del a, b, out, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
