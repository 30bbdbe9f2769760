// The forward attention core shared by the bf16/fp32 encoder block
// (vit_block.cu, output in the compute dtype) and the int8 serving blocks
// (vit_block_q8.cu, output fp32, which the next row quantisation reads).
//
// qkv (B, N, 3C) packed [q | k | v], heads sliced by column, -> attn
// (B, N, C) in TO.  One block per (query chunk, head, image); the head's K
// and V are staged in shared memory as fp32 (K rows padded to D+1 floats so
// that lanes reading different keys hit different banks).  One warp per
// query row: the q row lives in registers, each lane scores keys
// j = lane, lane+32, ..., the row max and sum are warp reductions, and
// each lane accumulates D/32 output columns over all keys.
//
// Numerics of the TPU kernels' _attention_head: q·kᵀ in fp32 scaled by
// 1/sqrt(D), fp32 softmax statistics, the un-normalised exp matrix rounded
// to the compute dtype as the P·V operand, and the division by the fp32
// row sum deferred past P·V.
#pragma once

#include "common.cuh"

namespace dfu {
namespace {

constexpr int ATT_QCHUNK = 64, ATT_THREADS = 256;

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const T* __restrict__ qkv, TO* __restrict__ out, int n,
                 int heads, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_QCHUNK;
  const int c = heads * D, ld = 3 * c;
  float* ks = smem;                    // n x (D + 1)
  float* vs = ks + n * (D + 1);        // n x D
  float* ps = vs + n * D;              // one n-row of scores per warp
  const T* base = qkv + static_cast<size_t>(b) * n * ld;

  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int j = i / D, d = i % D;
    const T* row = base + static_cast<size_t>(j) * ld + h * D + d;
    ks[j * (D + 1) + d] = to_f(row[c]);
    vs[j * D + d] = to_f(row[2 * c]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* p = ps + warp * n;
  const int qend = min(q0 + ATT_QCHUNK, n);
  constexpr int PER = (D + 31) / 32;

  for (int qi = q0 + warp; qi < qend; qi += nwarps) {
    float q[D];
    const T* qrow = base + static_cast<size_t>(qi) * ld + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = to_f(qrow[d]);

    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * (D + 1);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(q[d], kr[d], s);
      s *= scale;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - mx);
      sum += e;
      p[j] = to_f(from_f<T>(e));       // P·V operand in the compute dtype
    }
    sum = warp_sum(sum);
    __syncwarp();

    float o[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) o[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float pj = p[j];
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int d = lane + 32 * t;
        if (d < D) o[t] = fmaf(pj, vs[j * D + d], o[t]);
      }
    }
    TO* orow = out + (static_cast<size_t>(b) * n + qi) * c + h * D;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_f<TO>(o[t] / sum);
    }
    __syncwarp();                      // p is rewritten by the next row
  }
}

template <typename T, typename TO, int D>
int launch_attention(const void* qkv, void* out, int batch, int n, int heads,
                     float scale, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n) * (2 * D + 1) +
                       static_cast<size_t>(ATT_THREADS / 32) * n);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, TO, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(n, ATT_QCHUNK), heads, batch);
  attention_kernel<T, TO, D><<<grid, ATT_THREADS, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<TO*>(out), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// head dim d in {16, 32, 64, 128}
template <typename T, typename TO>
int dispatch_attention(int d, const void* qkv, void* out, int batch, int n,
                       int heads, float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_attention<T, TO, 16>(qkv, out, batch, n, heads, scale,
                                          s);
    case 32:
      return launch_attention<T, TO, 32>(qkv, out, batch, n, heads, scale,
                                          s);
    case 64:
      return launch_attention<T, TO, 64>(qkv, out, batch, n, heads, scale,
                                          s);
    case 128:
      return launch_attention<T, TO, 128>(qkv, out, batch, n, heads, scale,
                                           s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dfu
