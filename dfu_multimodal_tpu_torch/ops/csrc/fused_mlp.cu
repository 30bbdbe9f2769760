// Fused 3-layer fusion-head MLP for Hopper (sm_90a).
//
// Replaces: dfu_multimodal_tpu/ops/fused_mlp.py::_fused_mlp_kernel (K3):
//   relu(relu(x·w1 + b1)·w2 + b2)·w3 + b3 in one pass, the eval forward of
//   the multimodal late-fusion head (2816 -> 512 -> 256 -> 2).
//
// What bounds it on the H100: bytes.  On the serving path x is fp32
//   (the trunks return fp32 features), so the weights are 5.8 MB of fp32
//   for 2·B·1.57 M FLOP: at B = 8 about 4 FLOP per weight byte, far under
//   the card's ridge; the launch itself and how many SMs stream w1 decide
//   the time.
//
// What the design does about it: one launch, as on the TPU.  Each block
//   owns ROWS batch rows, stages them in shared memory, and computes all
//   three layers there: the hidden activations (ROWS x 512, ROWS x 256)
//   never leave shared memory.  Threads own output columns, so the weight
//   reads are coalesced along the output dim and each weight element read
//   feeds ROWS FMAs.  The last layer (2 outputs) is a warp reduction per
//   (row, output).  With B = 8 only two blocks stream w1; splitting the
//   first layer over more SMs is later work.
//
// Numerics follow the Pallas kernel: operands in x's dtype (fp32 or bf16),
// fp32 accumulation, ReLU on the fp32 sum plus bias, hidden activations
// rounded to x's dtype, fp32 output.

#include "common.cuh"

namespace dfu {
namespace {

constexpr int ROWS = 4, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, const T* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out,
                 int batch, int d0, int d1, int d2, int d3) {
  extern __shared__ float smem[];
  float* xs = smem;                  // ROWS x d0
  float* h1 = xs + ROWS * d0;        // ROWS x d1
  float* h2 = h1 + ROWS * d1;        // ROWS x d2
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, batch - r0);
  const int tid = threadIdx.x;

  for (int i = tid; i < ROWS * d0; i += blockDim.x) {
    const int r = i / d0, k = i % d0;
    xs[i] = r < nr ? to_f(x[static_cast<size_t>(r0 + r) * d0 + k]) : 0.f;
  }
  __syncthreads();

  // layer 1: h1 = relu(x·w1 + b1), rounded to T
  for (int c = tid; c < d1; c += blockDim.x) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d0; ++k) {
      const float w = to_f(w1[static_cast<size_t>(k) * d1 + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[r * d0 + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      h1[r * d1 + c] = to_f(from_f<T>(fmaxf(acc[r] + b1[c], 0.f)));
  }
  __syncthreads();

  // layer 2: h2 = relu(h1·w2 + b2), rounded to T
  for (int c = tid; c < d2; c += blockDim.x) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d1; ++k) {
      const float w = to_f(w2[static_cast<size_t>(k) * d2 + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(h1[r * d1 + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      h2[r * d2 + c] = to_f(from_f<T>(fmaxf(acc[r] + b2[c], 0.f)));
  }
  __syncthreads();

  // layer 3: out = h2·w3 + b3, one warp per (row, output)
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int o = warp; o < nr * d3; o += nwarps) {
    const int r = o / d3, c = o % d3;
    float acc = 0.f;
    for (int k = lane; k < d2; k += 32)
      acc = fmaf(h2[r * d2 + k], to_f(w3[static_cast<size_t>(k) * d3 + c]),
                 acc);
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(r0 + r) * d3 + c] = acc + b3[c];
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out,
           int batch, int d0, int d1, int d2, int d3, cudaStream_t s) {
  const size_t smem = sizeof(float) * ROWS * (static_cast<size_t>(d0) + d1 + d2);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_kernel<T><<<cdiv(batch, ROWS), THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), batch, d0, d1,
      d2, d3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, d0) in the compute dtype; w1 (d0, d1), w2 (d1, d2), w3 (d2, d3)
// in x's dtype; biases fp32; out (batch, d3) fp32.
int dfu_fused_mlp(int device, int dtype, const void* x, const void* w1,
                  const void* b1, const void* w2, const void* b2,
                  const void* w3, const void* b3, void* out, int batch,
                  int d0, int d1, int d2, int d3, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch<bf16>(x, w1, b1, w2, b2, w3, b3, out, batch, d0, d1, d2, d3,
                        s);
  return launch<float>(x, w1, b1, w2, b2, w3, b3, out, batch, d0, d1, d2, d3,
                       s);
}

}  // extern "C"
