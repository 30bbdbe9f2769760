// The whole attention-block backward (K10) for Hopper (sm_90a).
//
// Replaces: dfu_multimodal_tpu/ops/vit_block.py::_attn_block_bwd_kernel
//   (the one-kernel backward of x + proj(MHA(qkv(LN1(x)))) behind the
//   alternative custom VJP _attn_block_bwd_fused): from the block inputs
//   (x, wqkv, bqkv, wproj, LN1's g1 and b1) and the output gradient g it
//   recomputes LN1 and qkv, runs the attention forward (for the projection
//   weight gradient) and backward per head, and gives dx and all six
//   parameter gradients, the weight gradients summed over the batch in
//   fp32.
//
// What bounds it on the H100: 22·B·N·C² + 12·B·N²·C operations (qkv 6,
//   dattn 2, dwproj 2, dwqkv 6, dy 6 in units of B·N·C²; the attention
//   forward 4 and backward 8 in units of B·N²·C): 46.6 GFLOP at ViT-B/16,
//   B = 16 (47 us at the bf16 peak) against 28.7 MB of operands and
//   results (8.6 us at 3.35 TB/s): operation-bound.
//
// What the design does about it: the TPU kernel keeps one image's whole
//   chain in VMEM and carries the weight-gradient sums in fp32 output
//   blocks revisited by every step of a sequential grid.  Blocks of a
//   Hopper grid run in parallel and in no order, so here the chain is a
//   fixed sequence of the port's own kernels on the caller's stream, each
//   filling the card: LN1 (layernorm.cuh), the qkv and dattn products
//   (gemm_tile.cuh), the attention forward + backward (K5's kernel of
//   attention_kernels.cuh, tiled past the shared memory of one block), the
//   weight-gradient products dwproj = attnᵀ·g and dwqkv = yᵀ·dqkv over
//   all B·N rows, split into fixed WG_ROWS-row chunks whose fp32 partials
//   a second pass sums in chunk order, the bias column sums the same way,
//   dy = dqkv·wqkvᵀ in fp32, and the LN backward with its dg1/db1 column
//   partials.  No atomics anywhere: two calls give equal bits.  The
//   intermediates (y, qkv, dattn, attn, dqkv, dy, the partials) live in
//   one scratch buffer the caller allocates (dfu_attn_block_bwd_scratch
//   gives its size).  One persistent launch with grid-wide barriers, and
//   wgmma/TMA for the products, are later work.
//
// Numerics are K10's (vit_block.py:264-399), not the chain rule's: LN in
// fp32; qkv and dattn rounded to the compute dtype; q scaled by d^-0.5 in
// the compute dtype for every head dim (K5/K6 scale the fp32 scores
// instead when the scale is no power of two); P normalised in fp32 and
// rounded for attn = P_c·v and dv = P_cᵀ·do; dS rounded; dq = dS·k·scale
// and dk = dSᵀ·q·scale with q and k unscaled; attn and dqkv rounded
// before the weight products (compute-dtype operands, fp32 accumulation);
// dbqkv = Σ dqkv of the rounded dqkv, dbproj = Σ g in fp32; dy fp32; dx =
// g + rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)) rounded once to x's dtype.
// Every parameter gradient leaves in fp32.

#include "attention_kernels.cuh"
#include "common.cuh"
#include "gemm_tile.cuh"
#include "layernorm.cuh"

#include <mma.h>

namespace dfu {
namespace {

constexpr int WG_ROWS = 1024;                   // rows per fp32 partial

// ------------------------------------------------ weight-gradient tiles
// partial[z] (m, n) = Σ over rows r of chunk z of a[r][m]·b[r][n]: both
// operands row-major over the B·N rows, so the reduction runs down their
// rows.  A 64x64 output tile per block; a K step stages 32 rows of a and
// b, each coalesced along its row.
constexpr int GBM = 64, GBN = 64, GBK = 32, GTHREADS = 128;
constexpr int GLDA = GBM + 8, GLDB = GBN + 8, GLDC = GBN + 4;

// bf16 on the tensor cores: the staged a tile is [k][m], read as the
// column-major A fragment of aᵀ.
__global__ void __launch_bounds__(GTHREADS)
wgrad_bf16_wmma(const bf16* __restrict__ a, const bf16* __restrict__ b,
                float* __restrict__ partial, int rows, int m, int n) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[GBK * GLDA];
  __shared__ __align__(32) bf16 Bs[GBK * GLDB];
  __shared__ __align__(32) float Cs[GBM * GLDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int r0 = blockIdx.z * WG_ROWS, r1 = min(rows, r0 + WG_ROWS);
  const bf16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = r0; k0 < r1; k0 += GBK) {
    for (int i = tid; i < GBK * GBM; i += GTHREADS) {
      const int kk = i / GBM, c = i % GBM, r = k0 + kk;
      As[kk * GLDA + c] = (r < r1 && m0 + c < m)
                              ? a[static_cast<size_t>(r) * m + m0 + c]
                              : zero;
    }
    for (int i = tid; i < GBK * GBN; i += GTHREADS) {
      const int kk = i / GBN, c = i % GBN, r = k0 + kk;
      Bs[kk * GLDB + c] = (r < r1 && n0 + c < n)
                              ? b[static_cast<size_t>(r) * n + n0 + c]
                              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * GLDA + wm * 32 + i * 16,
                               GLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * GLDB + wn * 32 + j * 16,
                               GLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * GLDC + wn * 32 + j * 16,
                              acc[i][j], GLDC, wmma::mem_row_major);
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.z) * m * n;
  for (int i = tid; i < GBM * GBN; i += GTHREADS) {
    const int r = i / GBN, c = i % GBN;
    if (m0 + r < m && n0 + c < n)
      out[static_cast<size_t>(m0 + r) * n + n0 + c] = Cs[r * GLDC + c];
  }
}

// fp32 on the FMA pipes (no TF32): 256 threads, 4x4 outputs each, K in
// steps of 16 rows.
constexpr int FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
wgrad_f32_simt(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ partial, int rows, int m, int n) {
  __shared__ float As[FBK][GBM + 4];
  __shared__ float Bs[FBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int r0 = blockIdx.z * WG_ROWS, r1 = min(rows, r0 + WG_ROWS);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = r0; k0 < r1; k0 += FBK) {
    for (int i = tid; i < FBK * GBM; i += FTHREADS) {
      const int kk = i / GBM, c = i % GBM, r = k0 + kk;
      As[kk][c] = (r < r1 && m0 + c < m)
                      ? a[static_cast<size_t>(r) * m + m0 + c] : 0.f;
      Bs[kk][c] = (r < r1 && n0 + c < n)
                      ? b[static_cast<size_t>(r) * n + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
}

// out (m, n) fp32 = Σ over all rows of a[r][m]·b[r][n]: chunk partials
// into `part` (ceil(rows / WG_ROWS) x m x n), then their sum in order.
template <typename T>
void launch_wgrad(const T* a, const T* b, float* part, float* out, int rows,
                  int m, int n, cudaStream_t s) {
  const int parts = cdiv(rows, WG_ROWS);
  if constexpr (sizeof(T) == 2)
    wgrad_bf16_wmma<<<dim3(cdiv(n, GBN), cdiv(m, GBM), parts), GTHREADS, 0,
                      s>>>(a, b, part, rows, m, n);
  else
    wgrad_f32_simt<<<dim3(cdiv(n, GBN), cdiv(m, GBM), parts), FTHREADS, 0,
                     s>>>(a, b, part, rows, m, n);
  launch_reduce<1>(part, out, nullptr, parts, static_cast<long long>(m) * n,
                   256, s);
}

// out (c) fp32 = Σ over all rows of t[r][col]: LNB_ROWS-row partials
// into `part` (layernorm.cuh's column_partials), then their sum in order.
template <typename T>
void launch_colsum(const T* t, float* part, float* out, int rows, int c,
                   cudaStream_t s) {
  const int parts = cdiv(rows, LNB_ROWS);
  column_partials<false, T, T>
      <<<dim3(cdiv(c, LNB_THREADS), parts), LNB_THREADS, 0, s>>>(
          t, nullptr, nullptr, part, rows, c);
  launch_reduce<1>(part, out, nullptr, parts, c, 256, s);
}

// Byte offsets of the intermediates in the scratch buffer, each aligned
// to 256 bytes.
struct Scratch {
  size_t y, qkv, dattn, attn, dqkv, dy, attn_stats, ln_stats, ln_part,
      wpart_qkv, wpart_proj, cpart_qkv, cpart_proj, total;
};

Scratch scratch_layout(size_t es, int batch, int n, int c, int heads) {
  const size_t rows = static_cast<size_t>(batch) * n, f = sizeof(float);
  const size_t wparts = cdiv(static_cast<int>(rows), WG_ROWS);
  const size_t cparts = cdiv(static_cast<int>(rows), LNB_ROWS);
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  Scratch sc;
  sc.y = take(rows * c * es);
  sc.qkv = take(rows * 3 * c * es);
  sc.dattn = take(rows * c * es);
  sc.attn = take(rows * c * es);
  sc.dqkv = take(rows * 3 * c * es);
  sc.dy = take(rows * c * f);
  sc.attn_stats = take(3 * rows * heads * f);
  sc.ln_stats = take(2 * rows * f);
  sc.ln_part = take(2 * static_cast<size_t>(cdiv(static_cast<int>(rows),
                                                 LNB_ROWS)) * c * f);
  sc.wpart_qkv = take(wparts * c * 3 * c * f);
  sc.wpart_proj = take(wparts * c * c * f);
  sc.cpart_qkv = take(cparts * 3 * c * f);
  sc.cpart_proj = take(cparts * c * f);
  sc.total = off;
  return sc;
}

template <typename T>
int attn_block_bwd(const void* x, const void* g, const void* g1,
                   const void* b1, const void* wqkv, const void* bqkv,
                   const void* wproj, void* dx, float* dwqkv, float* dbqkv,
                   float* dwproj, float* dbproj, float* dg1, float* db1,
                   void* scratch, int batch, int n, int c, int heads,
                   float scale, float eps, cudaStream_t s) {
  const int rows = batch * n, d = c / heads;
  const int dt = sizeof(T) == 2 ? DT_BF16 : DT_F32;
  const Scratch sc = scratch_layout(sizeof(T), batch, n, c, heads);
  char* base = static_cast<char*>(scratch);
  T* y = reinterpret_cast<T*>(base + sc.y);
  T* qkv = reinterpret_cast<T*>(base + sc.qkv);
  T* dattn = reinterpret_cast<T*>(base + sc.dattn);
  T* attn = reinterpret_cast<T*>(base + sc.attn);
  T* dqkv = reinterpret_cast<T*>(base + sc.dqkv);
  float* dy = reinterpret_cast<float*>(base + sc.dy);

  launch_layernorm<T>(x, g1, b1, y, rows, c, eps, s);
  launch_gemm_t<EPI_BIAS>(dt, 0, y, wqkv, static_cast<const float*>(bqkv),
                          nullptr, qkv, rows, 3 * c, c, s);
  launch_gemm_t<EPI_NONE>(dt, 1, g, wproj, nullptr, nullptr, dattn, rows, c,
                          c, s);
  // K10 pre-scales q in the compute dtype for every head dim (pow2 = 1)
  int err = qkv_bwd<T, true>(qkv, dattn, attn, dqkv, base + sc.attn_stats,
                             batch, n, heads, d, scale, 1, s);
  if (err != 0) return err;
  launch_wgrad<T>(attn, static_cast<const T*>(g),
                  reinterpret_cast<float*>(base + sc.wpart_proj), dwproj,
                  rows, c, c, s);
  launch_wgrad<T>(y, dqkv, reinterpret_cast<float*>(base + sc.wpart_qkv),
                  dwqkv, rows, c, 3 * c, s);
  launch_colsum<T>(dqkv, reinterpret_cast<float*>(base + sc.cpart_qkv),
                   dbqkv, rows, 3 * c, s);
  launch_colsum<T>(static_cast<const T*>(g),
                   reinterpret_cast<float*>(base + sc.cpart_proj), dbproj,
                   rows, c, s);
  launch_gemm_t<EPI_F32>(dt, 1, dqkv, wqkv, nullptr, nullptr, dy, rows, c,
                         3 * c, s);
  launch_layernorm_bwd<T>(x, g, dy, g1, dx, base + sc.ln_stats,
                          base + sc.ln_part, dg1, db1, rows, c, eps, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of scratch dfu_attn_block_bwd_fused needs, into *bytes.
int dfu_attn_block_bwd_scratch(int dtype, int batch, int n, int c,
                               int heads, long long* bytes) {
  *bytes = static_cast<long long>(
      scratch_layout(dtype == DT_BF16 ? 2 : 4, batch, n, c, heads).total);
  return 0;
}

// x, g, dx (batch, n, c) and wqkv (c, 3c), wproj (c, c) in the compute
// dtype; g1, b1 (c), bqkv (3c) fp32; results dwqkv (c, 3c), dbqkv (3c),
// dwproj (c, c), dbproj, dg1, db1 (c) fp32; scratch of
// dfu_attn_block_bwd_scratch bytes; head dim c / heads in {8, 16, 32, 64};
// scale = (c / heads)^-0.5.
int dfu_attn_block_bwd_fused(int device, int dtype, const void* x,
                             const void* g, const void* g1, const void* b1,
                             const void* wqkv, const void* bqkv,
                             const void* wproj, void* dx, void* dwqkv,
                             void* dbqkv, void* dwproj, void* dbproj,
                             void* dg1, void* db1, void* scratch, int batch,
                             int n, int c, int heads, float scale, float eps,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == DT_BF16)
    return attn_block_bwd<bf16>(x, g, g1, b1, wqkv, bqkv, wproj, dx,
                                f(dwqkv), f(dbqkv), f(dwproj), f(dbproj),
                                f(dg1), f(db1), scratch, batch, n, c, heads,
                                scale, eps, s);
  return attn_block_bwd<float>(x, g, g1, b1, wqkv, bqkv, wproj, dx, f(dwqkv),
                               f(dbqkv), f(dwproj), f(dbproj), f(dg1), f(db1),
                               scratch, batch, n, c, heads, scale, eps, s);
}

}  // extern "C"
