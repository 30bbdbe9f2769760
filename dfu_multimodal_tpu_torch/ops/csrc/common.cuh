// Shared helpers of the port's hand-written Hopper kernels: dtype codes,
// float <-> compute-dtype conversion, warp reductions, the host's
// per-device caches (shared-memory limits, SM counts) and the C-level
// error reporting every entry point uses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

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

// Per-device host state cached for the life of the process (devices
// 0 .. MAX_DEVICES - 1; others are asked on every call).
constexpr int MAX_DEVICES = 64;

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: `set` is the kernel's own record (a static of
// its launcher), the bytes set on each device, 0 before the first call.
// cudaFuncSetAttribute costs a call into the CUDA runtime, and a block of
// four products would otherwise pay it four times.
template <typename K>
cudaError_t smem_limit_once(K kernel, int bytes,
                            std::atomic<int> (&set)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < MAX_DEVICES && set[device].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < MAX_DEVICES) set[device].store(bytes);
  return err;
}

// The SM count of `device`, asked of the runtime once per device.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> cached[MAX_DEVICES];  // 0 = not asked yet
  if (device >= 0 && device < MAX_DEVICES && (*sms = cached[device].load()))
    return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < MAX_DEVICES)
    cached[device].store(*sms);
  return err;
}

}  // namespace dfu

// Every entry point sets the device, launches, and returns
// cudaGetLastError(): a refused launch (too many threads, too much shared
// memory) never runs, and a later synchronize would not report it.
#define DFU_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
