// The port's fp32 GEMM tile (the parity dtype's products), shared by the
// ViT blocks (vit_block.cu), K10 (attn_block_bwd.cu) and the ResNet
// bottleneck and stage (resnet_block.cu), and the epilogues and A loaders
// every product of the port follows:
//
//   out (M, N) = epilogue(A (M, K) @ B)
//
// row-major, fp32 accumulation on the FMA pipes (no TF32); B is stored
// (K, N), or (N, K) and read transposed when TRANS_B.  A is staged
// through a loader: DenseA reads a row-major (M, K) matrix, Conv3x3A
// gathers the nine taps of a stride-1, same-padding 3x3 convolution on
// image-major NHWC rows (the implicit GEMM of the ResNet bottleneck).
// Ragged M/N/K are zero-filled on load and masked on store.  The A and B
// tiles are loaded element by element and not pipelined.  The tile body
// is a __device__ function of its origin and its shared buffers: the
// __global__ kernel below runs one tile per block, and a persistent
// kernel (resnet_block.cu's fp32 stage kernel) loops one block over many
// tiles with buffers (SimtSmem) it declares once.  bf16 runs
// gemm_sm90.cuh's TMA + wgmma GEMM over the same epilogues.
#pragma once

#include "common.cuh"

namespace dfu {
namespace {

enum Epilogue {
  EPI_BIAS = 0,            // out = T(acc + bias)
  EPI_BIAS_GELU = 1,       // out = T(gelu(acc + bias))
  EPI_BIAS_RESID = 2,      // out = T(aux + T(acc + bias)), aux (m, n) T
  EPI_BIAS_GELU_AUX = 3,   // aux = acc + bias (fp32), out = T(gelu(aux))
  EPI_DGELU = 4,           // out = T(acc * gelu'(aux)), aux (m, n) fp32
  EPI_NONE = 5,            // out = T(acc)
  EPI_F32 = 6,             // out = acc, out fp32
  EPI_BIAS_RELU = 7,       // out = T(max(acc + bias, 0))
  EPI_BIAS_RESID_RELU = 8  // out = T(max(aux + T(acc + bias), 0)), aux T
};

__host__ __device__ constexpr bool epi_has_bias(int epi) {
  return epi <= EPI_BIAS_GELU_AUX || epi == EPI_BIAS_RELU ||
         epi == EPI_BIAS_RESID_RELU;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// d/dv gelu_erf(v) = Phi(v) + v * phi(v)
__device__ __forceinline__ float dgelu_erf(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f)) +
         v * 0.39894228040143268f * expf(-0.5f * v * v);
}

// out[row, col] = epilogue(acc), in the compute dtype T unless EPI_F32.
template <typename T, int EPI>
__device__ __forceinline__ void store_out(float acc, int row, int col, int n,
                                          const float* __restrict__ bias,
                                          void* __restrict__ aux,
                                          void* __restrict__ out) {
  const size_t i = static_cast<size_t>(row) * n + col;
  if constexpr (EPI == EPI_F32) {
    static_cast<float*>(out)[i] = acc;
    return;
  } else {
    float v = acc;
    if constexpr (EPI == EPI_DGELU)
      v *= dgelu_erf(static_cast<const float*>(aux)[i]);
    if constexpr (epi_has_bias(EPI)) v += bias[col];
    if constexpr (EPI == EPI_BIAS_GELU_AUX) static_cast<float*>(aux)[i] = v;
    if constexpr (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_AUX)
      v = gelu_erf(v);
    // aux + o with o rounded to the compute dtype first, as the TPU
    // kernels add the residual in the compute dtype
    if constexpr (EPI == EPI_BIAS_RESID || EPI == EPI_BIAS_RESID_RELU)
      v = to_f(static_cast<const T*>(aux)[i]) + to_f(from_f<T>(v));
    if constexpr (EPI == EPI_BIAS_RELU || EPI == EPI_BIAS_RESID_RELU)
      v = fmaxf(v, 0.f);
    static_cast<T*>(out)[i] = from_f<T>(v);
  }
}

// ------------------------------------------------------------ A loaders
// A thread of a tile loads one fixed column of each K step for a fixed
// set of rows, so a loader splits an element's address into a Row part
// (computed once per block) and a Col part (once per K step); at() gives
// the element or 0 outside A.

// A (m, k) row-major.
template <typename T>
struct DenseA {
  const T* a;
  int m, k;
  struct Row { const T* p; };            // null past the ragged row edge
  struct Col { int kk; bool ok; };
  __device__ __forceinline__ Row row(int r) const {
    return {r < m ? a + static_cast<size_t>(r) * k : nullptr};
  }
  __device__ __forceinline__ Col col(int kk) const { return {kk, kk < k}; }
  __device__ __forceinline__ T at(Row r, Col c) const {
    return (r.p != nullptr && c.ok) ? r.p[c.kk] : from_f<T>(0.f);
  }
};

// The implicit GEMM of a 3x3, stride-1, same-padding convolution: y is
// (m, c) with m = B·h·w image-major NHWC rows, K = 9·c with the taps
// (dy, dx) row-major, A[r, t·c + ch] = y[r + dy·w + dx, ch] when the
// neighbour lies inside the same image (0 <= row+dy < h, 0 <= col+dx < w,
// row = (r / w) mod h), else 0 — which also masks the rows a shift would
// carry across an image boundary.
template <typename T>
struct Conv3x3A {
  const T* y;
  int m, c, h, w;
  struct Row { int r, yy, xx; };          // r < 0 past the ragged row edge
  struct Col { int off, ch, dy, dx; bool ok; };
  __device__ __forceinline__ Row row(int r) const {
    if (r >= m) return {-1, 0, 0};
    return {r, (r / w) % h, r % w};
  }
  __device__ __forceinline__ Col col(int kk) const {
    const int t = kk / c, dy = t / 3 - 1, dx = t % 3 - 1;
    return {dy * w + dx, kk - t * c, dy, dx, kk < 9 * c};
  }
  __device__ __forceinline__ T at(Row r, Col q) const {
    const int yy = r.yy + q.dy, xx = r.xx + q.dx;
    const bool in = r.r >= 0 && q.ok && yy >= 0 && yy < h && xx >= 0 &&
                    xx < w;
    return in ? y[static_cast<size_t>(r.r + q.off) * c + q.ch]
              : from_f<T>(0.f);
  }
};

// ---------------------------------------------------- fp32 GEMM (SIMT)
// A 64x64 tile per block of 256 threads, 4x4 outputs per thread, K in
// steps of 16.
constexpr int SBM = 64, SBN = 64, SBK = 16, STHREADS = 256;

struct SimtSmem {
  float As[SBK][SBM + 4];  // transposed: As[k][m]
  float Bs[SBK][SBN + 4];
};

// The output tile at (row0, col0), computed by the block's STHREADS
// threads; a caller that runs another tile with the same buffers
// synchronises the block first.
template <int EPI, bool TRANS_B, typename ALoad>
__device__ __forceinline__ void
gemm_f32_tile(ALoad A, const float* __restrict__ B,
              const float* __restrict__ bias, void* __restrict__ aux,
              void* __restrict__ out, int m, int n, int k, int row0,
              int col0, float (*__restrict__ As)[SBM + 4],
              float (*__restrict__ Bs)[SBN + 4]) {
  constexpr int RSTEP = STHREADS / SBK, NROWS = SBM / RSTEP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int a_col = tid % SBK, a_row = tid / SBK;

  typename ALoad::Row rows[NROWS];
#pragma unroll
  for (int j = 0; j < NROWS; ++j) rows[j] = A.row(row0 + a_row + j * RSTEP);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SBK) {
    const typename ALoad::Col col = A.col(k0 + a_col);
#pragma unroll
    for (int j = 0; j < NROWS; ++j)
      As[a_col][a_row + j * RSTEP] = A.at(rows[j], col);
    for (int i = tid; i < SBK * SBN; i += STHREADS) {
      // TRANS_B: k index fastest, so the global reads run along B's rows
      const int r = TRANS_B ? i % SBK : i / SBN;
      const int c = TRANS_B ? i / SBK : i % SBN;
      const int gr = k0 + r, gc = col0 + c;
      const size_t at = TRANS_B ? static_cast<size_t>(gc) * k + gr
                                : static_cast<size_t>(gr) * n + gc;
      Bs[r][c] = (gr < k && gc < n) ? B[at] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty * 4 + i, gc = col0 + tx * 4 + j;
      if (gr < m && gc < n)
        store_out<float, EPI>(acc[i][j], gr, gc, n, bias, aux, out);
    }
}

// One 64x64 output tile per block: grid (cdiv(n, SBN), cdiv(m, SBM)).
template <int EPI, bool TRANS_B, typename ALoad>
__global__ void __launch_bounds__(STHREADS)
gemm_f32_simt(ALoad A, const float* __restrict__ B,
              const float* __restrict__ bias, void* __restrict__ aux,
              void* __restrict__ out, int m, int n, int k) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  gemm_f32_tile<EPI, TRANS_B>(A, B, bias, aux, out, m, n, k,
                              blockIdx.y * SBM, blockIdx.x * SBN, As, Bs);
}

// out (m, n) = epilogue(a (m, k) @ B) in fp32 over a dense row-major A,
// with B = b (k, n), or b (n, k) read transposed when trans_b.
template <int EPI>
void launch_gemm_t(int trans_b, const void* a, const void* b,
                   const float* bias, void* aux, void* out, int m, int n,
                   int k, cudaStream_t s) {
  const dim3 grid(cdiv(n, SBN), cdiv(m, SBM));
  const DenseA<float> A{static_cast<const float*>(a), m, k};
  const float* B = static_cast<const float*>(b);
  if (trans_b)
    gemm_f32_simt<EPI, true><<<grid, STHREADS, 0, s>>>(A, B, bias, aux, out,
                                                       m, n, k);
  else
    gemm_f32_simt<EPI, false><<<grid, STHREADS, 0, s>>>(A, B, bias, aux, out,
                                                        m, n, k);
}

}  // namespace
}  // namespace dfu
