// Entry points of the softmax attention kernels (attention_kernels.cuh)
// for Hopper (sm_90a): K6 (packed qkv forward and backward), K9
// ((B, H, N, D) forward and backward) and K5 (the combined forward +
// backward of the attention-block backward).  What the kernels replace,
// what bounds them and how they are built is in attention_kernels.cuh.

#include "attention_kernels.cuh"
#include "common.cuh"

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every entry: d in {8, 16, 32, 64}; scale = d^-0.5; pow2: the scale is a
// power of two (q pre-scaled in the compute dtype).  A backward takes
// `stats`, fp32 scratch of 3·batch·heads·n floats in which its query side
// leaves each row's statistics for its key side: the bf16 kernels always,
// fp32 when a head does not fit one block (attention_kernels.cuh).

// K6 forward: qkv (batch, n, 3·heads·d) -> attn (batch, n, heads·d).
int dfu_qkv_attention_fwd(int device, int dtype, const void* qkv, void* attn,
                          int batch, int n, int heads, int d, float scale,
                          int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return qkv_fwd<bf16>(qkv, attn, batch, n, heads, d, scale, pow2, s);
  return qkv_fwd<float>(qkv, attn, batch, n, heads, d, scale, pow2, s);
}

// K6 backward: qkv (batch, n, 3·heads·d), dout (batch, n, heads·d) ->
// dqkv (batch, n, 3·heads·d).
int dfu_qkv_attention_bwd(int device, int dtype, const void* qkv,
                          const void* dout, void* dqkv, void* stats,
                          int batch, int n, int heads, int d, float scale,
                          int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return qkv_bwd<bf16, false>(qkv, dout, nullptr, dqkv, stats, batch, n,
                                heads, d, scale, pow2, s);
  return qkv_bwd<float, false>(qkv, dout, nullptr, dqkv, stats, batch, n,
                               heads, d, scale, pow2, s);
}

// K5: qkv, dout -> attn (batch, n, heads·d) and dqkv (batch, n, 3·heads·d).
int dfu_qkv_attention_fwdbwd(int device, int dtype, const void* qkv,
                             const void* dout, void* attn, void* dqkv,
                             void* stats, int batch, int n, int heads,
                             int d, float scale, int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return qkv_bwd<bf16, true>(qkv, dout, attn, dqkv, stats, batch, n,
                               heads, d, scale, pow2, s);
  return qkv_bwd<float, true>(qkv, dout, attn, dqkv, stats, batch, n, heads,
                              d, scale, pow2, s);
}

// K9 forward: q, k, v (batch, heads, n, d) -> o (batch, heads, n, d).
int dfu_attention_fwd(int device, int dtype, const void* q, const void* k,
                      const void* v, void* o, int batch, int heads, int n,
                      int d, float scale, int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return bhnd_fwd<bf16>(q, k, v, o, batch, heads, n, d, scale, pow2, s);
  return bhnd_fwd<float>(q, k, v, o, batch, heads, n, d, scale, pow2, s);
}

// K9 backward: q, k, v, dout (batch, heads, n, d) -> dq, dk, dv.
int dfu_attention_bwd(int device, int dtype, const void* q, const void* k,
                      const void* v, const void* dout, void* dq, void* dk,
                      void* dv, void* stats, int batch, int heads, int n,
                      int d, float scale, int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return bhnd_bwd<bf16>(q, k, v, dout, dq, dk, dv, stats, batch, heads, n,
                          d, scale, pow2, s);
  return bhnd_bwd<float>(q, k, v, dout, dq, dk, dv, stats, batch, heads, n,
                         d, scale, pow2, s);
}

}  // extern "C"
