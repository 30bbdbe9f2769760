// Shared helpers of the port's hand-written Hopper kernels: dtype codes,
// float <-> compute-dtype conversion, warp reductions and the C-level
// error reporting every entry point uses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dfu {

using bf16 = __nv_bfloat16;

// dtype codes shared with the Python wrappers (ops/_build.py::DTYPE_CODES)
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round-to-nearest-even, as XLA's astype(bfloat16)
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace dfu

// Every entry point sets the device, launches, and returns
// cudaGetLastError(): a refused launch (too many threads, too much shared
// memory) never runs, and a later synchronize would not report it.
#define DFU_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
