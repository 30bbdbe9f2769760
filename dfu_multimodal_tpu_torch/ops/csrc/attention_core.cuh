// The forward attention core shared by the fp32 encoder block
// (vit_block.cu, output in the compute dtype; the bf16 block runs the
// tensor-core forward of attention_fwd_mma.cuh) and the int8 serving
// blocks in both dtypes (vit_block_q8.cu, output fp32, which the next row
// quantisation reads).
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
//
// ToMe's key bias (proportional attention): an optional fp32 (B, N) row
// added to every score of key j after the scale, s·scale + bias[b][j],
// in both passes of the tiled kernel; nullptr for none.
//
// A head whose K and V do not fit one block's shared memory (N ≈ 420 at
// D = 64: serving at 336² or 384², N = 442 or 577) runs attention_tiled
// instead: ATT_TROWS query rows per block, K and V streamed through
// shared memory in ATT_TK-key tiles, two passes (the row max, then exp,
// the row sum and e·V against that max).  Each lane takes the keys lane,
// lane + 32, ... of each tile in order, so the sum and e·V run in the
// whole-head kernel's order and the output is the same, bit for bit.
#pragma once

#include "common.cuh"

namespace dfu {
namespace {

constexpr int ATT_QCHUNK = 64, ATT_THREADS = 256;
constexpr int ATT_TK = 64, ATT_RPW = 2;          // the tiled kernel's
constexpr int ATT_TROWS = (ATT_THREADS / 32) * ATT_RPW;
constexpr size_t ATT_MAX_SMEM = 232448;          // bytes a block may hold

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const T* __restrict__ qkv, TO* __restrict__ out, int n,
                 int heads, float scale, const float* __restrict__ bias) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_QCHUNK;
  const int c = heads * D, ld = 3 * c;
  float* ks = smem;                    // n x (D + 1)
  float* vs = ks + n * (D + 1);        // n x D
  float* ps = vs + n * D;              // one n-row of scores per warp
  const T* base = qkv + static_cast<size_t>(b) * n * ld;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;

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
      // the bias after the rounded scale (no FMA contraction)
      s = brow != nullptr ? __fadd_rn(__fmul_rn(s, scale), brow[j])
                          : s * scale;
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
__global__ void __launch_bounds__(ATT_THREADS)
attention_tiled(const T* __restrict__ qkv, TO* __restrict__ out, int n,
                int heads, float scale, const float* __restrict__ bias) {
  extern __shared__ float smem[];
  constexpr int PER = (D + 31) / 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_TROWS;
  const int c = heads * D, ld = 3 * c;
  float* ks = smem;                    // ATT_TK x (D + 1)
  float* vs = ks + ATT_TK * (D + 1);   // ATT_TK x D
  float* qs = vs + ATT_TK * D;         // ATT_TROWS x D
  float* ps = qs + ATT_TROWS * D;      // one ATT_TK-row of e per warp
  const T* base = qkv + static_cast<size_t>(b) * n * ld;
  const float* brow =
      bias != nullptr ? bias + static_cast<size_t>(b) * n : nullptr;
  for (int i = threadIdx.x; i < ATT_TROWS * D; i += blockDim.x) {
    const int qi = q0 + i / D, d = i % D;
    qs[i] = qi < n ? to_f(base[static_cast<size_t>(qi) * ld + h * D + d])
                   : 0.f;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ps + warp * ATT_TK;
  float mx[ATT_RPW], sum[ATT_RPW], o[ATT_RPW][PER];
#pragma unroll
  for (int r = 0; r < ATT_RPW; ++r) {
    mx[r] = -INFINITY;
    sum[r] = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) o[r][t] = 0.f;
  }
  // pass 0: the row max; pass 1: e = exp(s - max), its sum and e·V
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < n; j0 += ATT_TK) {
      const int cnt = min(ATT_TK, n - j0);
      for (int i = threadIdx.x; i < cnt * D; i += blockDim.x) {
        const int j = i / D, d = i % D;
        const T* row = base + static_cast<size_t>(j0 + j) * ld + h * D + d;
        ks[j * (D + 1) + d] = to_f(row[c]);
        if (pass == 1) vs[j * D + d] = to_f(row[2 * c]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < ATT_RPW; ++r) {
        const float* q = qs + (warp * ATT_RPW + r) * D;
        for (int jj = lane; jj < cnt; jj += 32) {
          const float* kr = ks + jj * (D + 1);
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) s = fmaf(q[d], kr[d], s);
          s = brow != nullptr
                  ? __fadd_rn(__fmul_rn(s, scale), brow[j0 + jj])
                  : s * scale;
          if (pass == 0) {
            mx[r] = fmaxf(mx[r], s);
          } else {
            const float e = expf(s - mx[r]);
            sum[r] += e;
            p[jj] = to_f(from_f<T>(e));  // P·V operand, compute dtype
          }
        }
        if (pass == 1) {
          __syncwarp();
          for (int jj = 0; jj < cnt; ++jj) {
            const float pj = p[jj];
#pragma unroll
            for (int t = 0; t < PER; ++t) {
              const int d = lane + 32 * t;
              if (d < D) o[r][t] = fmaf(pj, vs[jj * D + d], o[r][t]);
            }
          }
          __syncwarp();                // p is the next row's
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < ATT_RPW; ++r) {
      if (pass == 0)
        mx[r] = warp_max(mx[r]);
      else
        sum[r] = warp_sum(sum[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ATT_RPW; ++r) {
    const int qi = q0 + warp * ATT_RPW + r;
    if (qi >= n) continue;
    TO* orow = out + (static_cast<size_t>(b) * n + qi) * c + h * D;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_f<TO>(o[r][t] / sum[r]);
    }
  }
}

// The whole-head kernel when the head's K and V fit one block, else the
// tiled one (the same output).
template <typename T, typename TO, int D>
int launch_attention(const void* qkv, void* out, int batch, int n, int heads,
                     float scale, const float* bias, cudaStream_t s) {
  const size_t whole =
      sizeof(float) * (static_cast<size_t>(n) * (2 * D + 1) +
                       static_cast<size_t>(ATT_THREADS / 32) * n);
  const bool tiled = whole > ATT_MAX_SMEM;
  const size_t smem =
      tiled ? sizeof(float) * (ATT_TK * (2 * D + 1) + ATT_TROWS * D +
                               (ATT_THREADS / 32) * ATT_TK)
            : whole;
  auto kernel = tiled ? attention_tiled<T, TO, D> : attention_kernel<T, TO, D>;
  // the limit each kernel has been given on each device
  static std::atomic<int> whole_limit[MAX_DEVICES], tiled_limit[MAX_DEVICES];
  const int bytes = static_cast<int>(smem);
  const cudaError_t err = tiled ? smem_limit_once(kernel, bytes, tiled_limit)
                                : smem_limit_once(kernel, bytes, whole_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(cdiv(n, tiled ? ATT_TROWS : ATT_QCHUNK), heads, batch);
  kernel<<<grid, ATT_THREADS, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<TO*>(out), n, heads, scale,
      bias);
  return static_cast<int>(cudaGetLastError());
}

// head dim d in {16, 32, 64, 128}; bias: the fp32 (batch, n) key bias, or
// nullptr
template <typename T, typename TO>
int dispatch_attention(int d, const void* qkv, void* out, int batch, int n,
                       int heads, float scale, const float* bias,
                       cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_attention<T, TO, 16>(qkv, out, batch, n, heads, scale,
                                          bias, s);
    case 32:
      return launch_attention<T, TO, 32>(qkv, out, batch, n, heads, scale,
                                          bias, s);
    case 64:
      return launch_attention<T, TO, 64>(qkv, out, batch, n, heads, scale,
                                          bias, s);
    case 128:
      return launch_attention<T, TO, 128>(qkv, out, batch, n, heads, scale,
                                           bias, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dfu
