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
//   filling the card: LN1 (layernorm.cuh), the qkv and dattn products,
//   the attention forward + backward (K5's kernels: in bf16 the mma.sync
//   pair of attention_bwd_mma.cuh, in fp32 attention_kernels.cuh's, tiled
//   past the shared memory of one block), the weight-gradient products
//   dwproj = attnᵀ·g and dwqkv = yᵀ·dqkv over all B·N rows, split into
//   fixed WG_ROWS-row chunks whose fp32 partials a second pass sums in
//   chunk order, the bias column sums the same way, dy = dqkv·wqkvᵀ in
//   fp32, and the LN backward with its dg1/db1 column partials.  In bf16
//   every product runs on gemm_sm90.cuh's persistent TMA + wgmma GEMM:
//   qkv, dattn and dy in the chain rule's modes (B_MN with its bias; B_K,
//   a weight read transposed), and the weight gradients in its WGRAD mode
//   (both operands MN-major, A through wgmma's transpose bit, 128 x 128
//   tiles of each chunk: 144 + 432 tiles at B = 16); fp32 on gemm_tile.
//   cuh's SIMT tile and a SIMT weight-gradient tile.  The k sums keep the
//   WMMA tiles' order (16-deep steps in k order, a chunk's rows in row
//   order), so the bf16 results kept their bits.  No atomics anywhere:
//   two calls give equal bits.  The intermediates (y, qkv, dattn, attn,
//   dqkv, dy, the partials) live in one scratch buffer the caller
//   allocates (dfu_attn_block_bwd_scratch gives its size).  One
//   persistent launch with grid-wide barriers is later work.
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
#include "gemm_sm90.cuh"
#include "gemm_sm90_single.cuh"
#include "gemm_tile.cuh"
#include "layernorm.cuh"

namespace dfu {
namespace {

using sm90::WG_ROWS;                    // rows per fp32 partial

namespace sm90 {

// The weight-gradient partials (WGRAD): partial[z] (m, n) fp32 = Σ over
// the rows r of chunk z (rows z·WG_ROWS .. +WG_ROWS-1) of a[r][i]·b[r][j],
// a (rows, m) and b (rows, n) bf16 row-major; partial holds ceil(rows /
// WG_ROWS) chunks.  128 x 128 tiles of each chunk, its rows in 16-deep
// steps in row order.  Bases 16-byte aligned, m and n multiples of 8
// (else cudaErrorInvalidValue).
inline cudaError_t wgrad(const void* a, const void* b, float* partial,
                         int rows, int m, int n, int device,
                         cudaStream_t s) {
  if (rows < 1 || m < 8 || n < 8 || m % 8 || n % 8)
    return cudaErrorInvalidValue;
  Args p{};
  cudaError_t err = encode(&p.a1, a, rows, m, BK);
  if (err == cudaSuccess) err = encode(&p.b1, b, rows, n, BK);
  if (err != cudaSuccess) return err;
  p.out1 = partial;
  p.m = m;
  p.n = n;
  p.k = rows;
  return launch<WG_BN, WGRAD>(p, device, s);
}

}  // namespace sm90

// ------------------------------------------------ weight-gradient tiles
// partial[z] (m, n) = Σ over rows r of chunk z of a[r][m]·b[r][n]: both
// operands row-major over the B·N rows, so the reduction runs down their
// rows.  bf16 runs gemm_sm90.cuh's WGRAD mode; fp32 a 64x64 output tile
// per block, a K step staging 16 rows of a and b, each coalesced along
// its row.
constexpr int GBM = 64, GBN = 64;

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
cudaError_t launch_wgrad(const T* a, const T* b, float* part, float* out,
                         int rows, int m, int n, int device,
                         cudaStream_t s) {
  const int parts = cdiv(rows, WG_ROWS);
  if constexpr (sizeof(T) == 2) {
    const cudaError_t err = sm90::wgrad(a, b, part, rows, m, n, device, s);
    if (err != cudaSuccess) return err;
  } else {
    wgrad_f32_simt<<<dim3(cdiv(n, GBN), cdiv(m, GBM), parts), FTHREADS, 0,
                     s>>>(a, b, part, rows, m, n);
  }
  launch_reduce<1>(part, out, nullptr, parts, static_cast<long long>(m) * n,
                   256, s);
  return cudaGetLastError();
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
                   float scale, float eps, int device, cudaStream_t s) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int rows = batch * n, d = c / heads;
  const Scratch sc = scratch_layout(sizeof(T), batch, n, c, heads);
  char* base = static_cast<char*>(scratch);
  T* y = reinterpret_cast<T*>(base + sc.y);
  T* qkv = reinterpret_cast<T*>(base + sc.qkv);
  T* dattn = reinterpret_cast<T*>(base + sc.dattn);
  T* attn = reinterpret_cast<T*>(base + sc.attn);
  T* dqkv = reinterpret_cast<T*>(base + sc.dqkv);
  float* dy = reinterpret_cast<float*>(base + sc.dy);
  const float* fqkv = static_cast<const float*>(bqkv);

  launch_layernorm<T>(x, g1, b1, y, rows, c, eps, s);
  // the data products: bf16 on the TMA + wgmma GEMM in the chain rule's
  // modes (qkv: wqkv MN-major; dattn, dy: the weight read transposed)
  cudaError_t err = cudaSuccess;
  if constexpr (BF16) {
    err = sm90::gemm(EPI_BIAS, 0, 0, y, wqkv, fqkv, nullptr, qkv, rows,
                     3 * c, c, device, s);
    if (err == cudaSuccess)
      err = sm90::gemm(EPI_NONE, 1, 0, g, wproj, nullptr, nullptr, dattn,
                       rows, c, c, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    launch_gemm_t<EPI_BIAS>(0, y, wqkv, fqkv, nullptr, qkv, rows, 3 * c, c,
                            s);
    launch_gemm_t<EPI_NONE>(1, g, wproj, nullptr, nullptr, dattn, rows, c, c,
                            s);
  }
  // K10 pre-scales q in the compute dtype for every head dim (pow2 = 1)
  int rc = qkv_bwd<T, true>(qkv, dattn, attn, dqkv, base + sc.attn_stats,
                            batch, n, heads, d, scale, 1, s);
  if (rc != 0) return rc;
  err = launch_wgrad<T>(attn, static_cast<const T*>(g),
                        reinterpret_cast<float*>(base + sc.wpart_proj),
                        dwproj, rows, c, c, device, s);
  if (err == cudaSuccess)
    err = launch_wgrad<T>(y, dqkv,
                          reinterpret_cast<float*>(base + sc.wpart_qkv),
                          dwqkv, rows, c, 3 * c, device, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_colsum<T>(dqkv, reinterpret_cast<float*>(base + sc.cpart_qkv),
                   dbqkv, rows, 3 * c, s);
  launch_colsum<T>(static_cast<const T*>(g),
                   reinterpret_cast<float*>(base + sc.cpart_proj), dbproj,
                   rows, c, s);
  if constexpr (BF16) {
    err = sm90::gemm(EPI_F32, 1, sm90::DY_BN, dqkv, wqkv, nullptr, nullptr,
                     dy, rows, c, 3 * c, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    launch_gemm_t<EPI_F32>(1, dqkv, wqkv, nullptr, nullptr, dy, rows, c,
                           3 * c, s);
  }
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
                                scale, eps, device, s);
  return attn_block_bwd<float>(x, g, g1, b1, wqkv, bqkv, wproj, dx, f(dwqkv),
                               f(dbqkv), f(dwproj), f(dbproj), f(dg1), f(db1),
                               scratch, batch, n, c, heads, scale, eps,
                               device, s);
}

}  // extern "C"
