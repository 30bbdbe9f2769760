// LayerNorm forward and backward kernels for Hopper (sm_90a), shared by
// the ViT encoder blocks (vit_block.cu) and the attention-block backward
// (attn_block_bwd.cu).  One warp per row, all statistics in fp32; the
// backward's column sums (dgamma, dbeta), which the TPU kernels carry
// across a sequential grid, become per-64-row column partials reduced in
// a fixed order by a second pass: deterministic, no atomics.
#pragma once

#include "common.cuh"

namespace dfu {
namespace {

// ----------------------------------------------------------- LayerNorm
// One warp per row; three passes over the row (mean, centred variance,
// write), all in fp32.  rows x C in, rows x C out in the compute dtype.
template <typename T>
__global__ void layernorm_kernel(const T* __restrict__ x,
                                 const float* __restrict__ g,
                                 const float* __restrict__ b,
                                 T* __restrict__ y, int rows, int c,
                                 float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * c;
  T* yr = y + static_cast<size_t>(row) * c;
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += to_f(xr[i]);
  const float mu = warp_sum(s) / c;
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = to_f(xr[i]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / c + eps);
  for (int i = lane; i < c; i += 32)
    yr[i] = from_f<T>((to_f(xr[i]) - mu) * rstd * g[i] + b[i]);
}

// ---------------------------------------------------- LayerNorm backward
// dx = resid + rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat)) with
// dxhat = dy·gamma, one warp per row in fp32 (statistics recomputed from
// x as the forward does); each row's mean and rstd go to `stats` (2, rows)
// for the column pass.
template <typename T>
__global__ void layernorm_bwd_rows(const T* __restrict__ x,
                                   const T* __restrict__ resid,
                                   const float* __restrict__ dy,
                                   const float* __restrict__ gamma,
                                   T* __restrict__ dx,
                                   float* __restrict__ stats, int rows, int c,
                                   float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * c;
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += to_f(x[base + i]);
  const float mu = warp_sum(s) / c;
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = to_f(x[base + i]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / c + eps);
  float m1 = 0.f, m2 = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float dxh = dy[base + i] * gamma[i];
    m1 += dxh;
    m2 += dxh * (to_f(x[base + i]) - mu) * rstd;
  }
  m1 = warp_sum(m1) / c;
  m2 = warp_sum(m2) / c;
  for (int i = lane; i < c; i += 32) {
    const float xh = (to_f(x[base + i]) - mu) * rstd;
    const float dxh = dy[base + i] * gamma[i];
    dx[base + i] =
        from_f<T>(to_f(resid[base + i]) + rstd * (dxh - m1 - xh * m2));
  }
  if (lane == 0) {
    stats[row] = mu;
    stats[rows + row] = rstd;
  }
}

// Column partials over LNB_ROWS rows, rows in order, one thread per
// column: partial[XHAT][blk][col] = Σ g and, with XHAT, partial[0][blk]
// [col] = Σ g·xhat (xhat from x and the rows' mean and rstd in `stats`).
// The LN backward's dgamma/dbeta and K10's bias gradients both take it.
constexpr int LNB_ROWS = 64, LNB_THREADS = 128;

template <bool XHAT, typename G, typename T>
__global__ void column_partials(const G* __restrict__ g,
                                const T* __restrict__ x,
                                const float* __restrict__ stats,
                                float* __restrict__ partial, int rows,
                                int c) {
  const int col = blockIdx.x * LNB_THREADS + threadIdx.x;
  const int blk = blockIdx.y, nblk = gridDim.y;
  if (col >= c) return;
  const int r0 = blk * LNB_ROWS, r1 = min(r0 + LNB_ROWS, rows);
  float s1 = 0.f, s2 = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = static_cast<size_t>(r) * c + col;
    if constexpr (XHAT) {
      const float xh = (to_f(x[i]) - stats[r]) * stats[rows + r];
      s1 += to_f(g[i]) * xh;
    }
    s2 += to_f(g[i]);
  }
  if constexpr (XHAT) partial[static_cast<size_t>(blk) * c + col] = s1;
  partial[static_cast<size_t>(XHAT ? nblk + blk : blk) * c + col] = s2;
}

// out0[i] = Σ_z partial[0][z][i] and, with SUMS = 2, out1[i] = Σ_z
// partial[1][z][i], z in order, one thread per i: the second pass of
// column_partials and of any fp32 partials laid out (parts, len).
template <int SUMS>
__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out0,
                                float* __restrict__ out1, int parts,
                                long long len) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= len) return;
  float s1 = 0.f, s2 = 0.f;
  for (int z = 0; z < parts; ++z) {
    s1 += partial[z * len + i];
    if constexpr (SUMS == 2)
      s2 += partial[static_cast<long long>(parts + z) * len + i];
  }
  out0[i] = s1;
  if constexpr (SUMS == 2) out1[i] = s2;
}

template <int SUMS>
void launch_reduce(const float* partial, float* out0, float* out1, int parts,
                   long long len, int threads, cudaStream_t s) {
  reduce_partials<SUMS><<<static_cast<int>((len + threads - 1) / threads),
                          threads, 0, s>>>(partial, out0, out1, parts, len);
}

template <typename T>
void launch_layernorm(const void* x, const void* g, const void* b, void* y,
                      int rows, int c, float eps, cudaStream_t s) {
  const int threads = 256, rows_per_block = threads / 32;
  layernorm_kernel<T><<<cdiv(rows, rows_per_block), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<T*>(y), rows, c, eps);
}

template <typename T>
void launch_layernorm_bwd(const void* x, const void* resid, const void* dy,
                          const void* gamma, void* dx, void* stats,
                          void* partial, void* dgamma, void* dbeta, int rows,
                          int c, float eps, cudaStream_t s) {
  const int threads = 256, rows_per_block = threads / 32;
  layernorm_bwd_rows<T><<<cdiv(rows, rows_per_block), threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(resid),
      static_cast<const float*>(dy), static_cast<const float*>(gamma),
      static_cast<T*>(dx), static_cast<float*>(stats), rows, c, eps);
  const int nblk = cdiv(rows, LNB_ROWS);
  column_partials<true, float, T>
      <<<dim3(cdiv(c, LNB_THREADS), nblk), LNB_THREADS, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(stats), static_cast<float*>(partial), rows,
      c);
  launch_reduce<2>(static_cast<const float*>(partial),
                   static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                   nblk, c, LNB_THREADS, s);
}

}  // namespace
}  // namespace dfu
