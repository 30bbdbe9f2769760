// Softmax attention over a strided operand for Hopper (sm_90a): forward,
// backward, and the combined forward + backward of the attention-block
// backward.  The entry points are in attention.cu (K5, K6, K9) and
// attn_block_bwd.cu (K10, which runs the combined kernel inside its own
// sequence).
//
// Replaces (dfu_multimodal_tpu/ops/attention.py):
//   K6 _qkv_attention_fwd_kernel / _qkv_attention_bwd_kernel: packed qkv
//      (B, N, 3C) -> attn (B, N, C); backward (qkv, dO) -> dQKV (B, N, 3C),
//      packed [dq | dk | dv] by column;
//   K9 _attention_fwd_kernel / _attention_bwd_kernel: q, k, v (B, H, N, D)
//      -> o; backward -> dq, dk, dv;
//   K5 _qkv_attention_fwdbwd_kernel: the packed layout, the softmax
//      computed once for both the re-forward output O and dQKV.
// The kernels are written once, over a strided operand (a base pointer
// plus batch, head and row strides; the D columns of a row contiguous),
// so neither layout is copied into the other: packed, q = qkv + h·D,
// k = q + C, v = q + 2C with row stride 3C; (B, H, N, D), row stride D and
// head stride N·D.
//
// What bounds them on the H100: per (image, head) the forward does two
//   N x N x D products (S = QKᵀ, O = PV), the backward five (S, dP = dO·Vᵀ,
//   dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO) and the fused one six.  At
//   ViT-B/16 (12 heads, N = 197, D = 64) the forward at B = 8 is 0.95 GFLOP
//   against 9.7 MB in bf16, the backward at B = 16 4.8 GFLOP against
//   34 MB: the bound is the bytes (3 us and 10 us at 3.35 TB/s).
//
// What the design does about it: the TPU kernels hold one image's heads
//   in VMEM and walk them in order.  Here one block per (head, image)
//   holds the head's K and V as fp32 in shared memory (rows padded
//   against bank conflicts) and walks the query rows, one warp per row:
//   each warp forms its row of S and P in shared memory (the N x N matrix
//   never exists) and writes its output row.  The forward splits the
//   query rows over FWD_ROWS-row blocks as well (4 x 12 x 8 = 384 blocks
//   at the serving batch; 108 KB each, two per SM).  The backward walks
//   every row of the head in one block, in tiles of 8: after a barrier
//   all 256 threads add the tile's dSᵀ·Q and Pᵀ·dO into dK and dV
//   accumulators kept in shared memory across the tiles (in row order: no
//   atomics, deterministic); K, V, dK, dV and the tile's rows take 220 KB
//   of the 227 KB a block may hold at N = 197, D = 64.  These products run
//   on the FMA pipes (SIMT fp32).
//
// Which kernel runs: bf16 runs none of the SIMT kernels below.  Its
//   forward (K6, K9) and its backward (K5, K6, K9 and K10's attention
//   step) are tensor-core kernels with one path for every N:
//   attention_fwd_mma.cuh (Fwd<bf16, D>) and attention_bwd_mma.cuh
//   (Bwd<WRITE_O>::At<bf16, D>: a query-side kernel, then a key-side
//   kernel).  fp32 keeps the SIMT kernels described here: TF32 products
//   would miss fp32's budget.
//
// An fp32 head whose whole-head kernel does not fit one block's shared
//   memory (the forward past N ≈ 420, the backward past N = 208 at
//   D = 64) runs the tiled kernels instead, which stream K and V through
//   shared memory in TK-key tiles and keep only a few query rows per
//   block:
//   - forward (attention_fwd_tiled): three passes over the key tiles per
//     QROWS query rows: the row max, the row sum of exp(S − max), then P
//     normalised against them and P·V.  Each lane scores the keys lane,
//     lane + 32, ... of every tile in order, so the max, the lane sums and
//     P·V's order over the keys are those of the whole-head kernel: the
//     output is the same, bit for bit.  No running rescale of the output.
//   - backward, the FlashAttention-2 split without atomics: a query-side
//     kernel (attention_bwd_rows_tiled) per QROWS rows takes the max and
//     sum as above, then δ = rowsum(dP∘P) from the fp32 P (and, with
//     WRITE_O, O = P_c·V), then dQ = dS·K·scale over the key tiles, and
//     writes each row's max, sum and δ to fp32 scratch; a key-side kernel
//     (attention_bwd_keys_tiled) per TK keys walks the query rows in tiles
//     of 8, recomputes P and dS from those statistics, and adds dSᵀ·Q and
//     P_cᵀ·dO in row order.  Every sum runs in the whole-head kernel's
//     order, so dQ, dK, dV (and O) equal its results.
//
// Numerics follow the Pallas kernels (_softmax_probs_c): compute-dtype
// score operands with fp32 accumulation (q pre-scaled by 1/sqrt(D) in the
// compute dtype when `prescale` is set — the scale is a power of two,
// D = 16, 64, or the caller is K10, which always pre-scales — else the
// fp32 scores scaled after the product), fp32 max/exp/sum with P
// normalised BEFORE P·V, P rounded to the compute dtype for O and dV, the
// output rounded to the compute dtype, dS = P∘(dP − rowsum(dP∘P)) rounded
// to the compute dtype, dQ = dS·K·scale and dK = dSᵀ·Q·scale (Q unscaled).
#pragma once

#include <type_traits>

#include "attention_bwd_mma.cuh"
#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace dfu {
namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int FWD_ROWS = 64;          // query rows per forward block
constexpr int TK = 64;                // keys per tile of the tiled kernels
constexpr int RPW = 2;                // query rows per warp, tiled kernels
constexpr int QROWS = WARPS * RPW;    // query rows per tiled query block
constexpr size_t MAX_SMEM = 232448;   // bytes a block may hold on sm_90

// Element (b, h, row, col) of an operand lies at
// p[b·sb + h·sh + row·sr + col].
template <typename P>
struct Strided {
  P* p;
  long long sb, sh, sr;
  __device__ P* row(int b, int h, int r) const {
    return p + b * sb + h * sh + r * sr;
  }
};

size_t fwd_smem(int n, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * (d + 1) +
                          static_cast<size_t>(WARPS) * n);
}

size_t bwd_smem(int n, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(n) * (d + 1) + 2 * static_cast<size_t>(n) * d +
          2 * static_cast<size_t>(WARPS) * n + 2 * WARPS * d);
}

// K and V of head (b, h) into padded fp32 rows of shared memory.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(const Strided<const T>& k,
                                         const Strided<const T>& v, int b,
                                         int h, int n, float* ks, float* vs) {
  constexpr int LDK = D + 1;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int j = i / D, d = i % D;
    ks[j * LDK + d] = to_f(k.row(b, h, j)[d]);
    vs[j * LDK + d] = to_f(v.row(b, h, j)[d]);
  }
}

// One warp: the query row (pre-scaled in the compute dtype when the scale
// is a power of two) against every staged key; leaves the row of
// exp(S - max) in p and returns its sum.
template <int D>
__device__ __forceinline__ float score_row(const float* qr, const float* ks,
                                           float* p, int n, float post,
                                           int lane) {
  constexpr int LDK = D + 1;
  float mx = -INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float* kr = ks + j * LDK;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s *= post;
    p[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(p[j] - mx);
    p[j] = e;
    sum += e;
  }
  return warp_sum(sum);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(Strided<const T> q, Strided<const T> k,
                     Strided<const T> v, Strided<T> o, int n, float scale,
                     int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;
  constexpr int PER = (D + 31) / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  float* ks = smem;                       // n x LDK
  float* vs = ks + n * LDK;               // n x LDK
  float* ps = vs + n * LDK;               // WARPS x n: one P row per warp
  stage_kv<T, D>(k, v, b, h, n, ks, vs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ps + warp * n;
  const float post = pow2 ? 1.f : scale;
  const int r1 = min(n, static_cast<int>(blockIdx.x + 1) * FWD_ROWS);
  for (int qi = blockIdx.x * FWD_ROWS + warp; qi < r1; qi += WARPS) {
    const T* qrow = q.row(b, h, qi);
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float x = to_f(qrow[d]);
      qr[d] = pow2 ? to_f(from_f<T>(x * scale)) : x;
    }
    const float sum = score_row<D>(qr, ks, p, n, post, lane);
    for (int j = lane; j < n; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();
    float acc[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) acc[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float pj = p[j];
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int d = lane + 32 * t;
        if (d < D) acc[t] = fmaf(pj, vs[j * LDK + d], acc[t]);
      }
    }
    T* orow = o.row(b, h, qi);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_f<T>(acc[t]);
    }
    __syncwarp();                         // p is the next row's
  }
}

// Backward of one head in one block; with WRITE_O it also writes the
// re-forward output O (the combined kernel K5).
template <typename T, int D, bool WRITE_O>
__global__ void __launch_bounds__(THREADS)
attention_bwd_kernel(Strided<const T> q, Strided<const T> k,
                     Strided<const T> v, Strided<const T> dout, Strided<T> o,
                     Strided<T> dq, Strided<T> dk, Strided<T> dv, int n,
                     float scale, int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;
  constexpr int PER = (D + 31) / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  float* ks = smem;                       // n x LDK
  float* vs = ks + n * LDK;               // n x LDK
  float* dks = vs + n * LDK;              // n x D  (dK accumulator)
  float* dvs = dks + n * D;               // n x D  (dV accumulator)
  float* ps = dvs + n * D;                // WARPS x n: P (fp32, then T)
  float* dss = ps + WARPS * n;            // WARPS x n: dP, then dS
  float* qs = dss + WARPS * n;            // WARPS x D: the tile's q rows
  float* dos = qs + WARPS * D;            // WARPS x D: the tile's dO rows
  stage_kv<T, D>(k, v, b, h, n, ks, vs);
  for (int i = threadIdx.x; i < n * D; i += THREADS) dks[i] = dvs[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ps + warp * n;
  float* ds = dss + warp * n;
  float* qw = qs + warp * D;
  float* dow = dos + warp * D;
  const float post = pow2 ? 1.f : scale;

  for (int t0 = 0; t0 < n; t0 += WARPS) {
    const int qi = t0 + warp;
    if (qi < n) {
      const T* qrow = q.row(b, h, qi);
      const T* drow = dout.row(b, h, qi);
      for (int d = lane; d < D; d += 32) {
        qw[d] = to_f(qrow[d]);
        dow[d] = to_f(drow[d]);
      }
      __syncwarp();
      float qr[D], dr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = pow2 ? to_f(from_f<T>(qw[d] * scale)) : qw[d];
        dr[d] = dow[d];
      }
      const float sum = score_row<D>(qr, ks, p, n, post, lane);
      // P normalised, dP row, and rowsum(dP∘P)
      float rs = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = p[j] / sum;
        const float* vr = vs + j * LDK;
        float dpj = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dpj = fmaf(dr[d], vr[d], dpj);
        p[j] = pj;
        ds[j] = dpj;
        rs = fmaf(dpj, pj, rs);
      }
      rs = warp_sum(rs);
      for (int j = lane; j < n; j += 32) {
        const float pj = p[j];
        ds[j] = to_f(from_f<T>(pj * (ds[j] - rs)));
        p[j] = to_f(from_f<T>(pj));       // P·V and dV operand
      }
      __syncwarp();
      // O = P·V and dQ = dS·K (lanes over columns)
      float oa[PER], dqa[PER];
#pragma unroll
      for (int t = 0; t < PER; ++t) oa[t] = dqa[t] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float pj = p[j], dsj = ds[j];
#pragma unroll
        for (int t = 0; t < PER; ++t) {
          const int d = lane + 32 * t;
          if (d < D) {
            if constexpr (WRITE_O) oa[t] = fmaf(pj, vs[j * LDK + d], oa[t]);
            dqa[t] = fmaf(dsj, ks[j * LDK + d], dqa[t]);
          }
        }
      }
      T* dqrow = dq.row(b, h, qi);
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          if constexpr (WRITE_O) o.row(b, h, qi)[d] = from_f<T>(oa[t]);
          dqrow[d] = from_f<T>(dqa[t] * scale);
        }
      }
    } else {                              // past the last row: adds nothing
      for (int j = lane; j < n; j += 32) p[j] = ds[j] = 0.f;
      for (int d = lane; d < D; d += 32) qw[d] = dow[d] = 0.f;
    }
    __syncthreads();
    // dK += dSᵀ·Q and dV += Pᵀ·dO over the tile's rows, in row order
    for (int i = threadIdx.x; i < n * D; i += THREADS) {
      const int j = i / D, d = i % D;
      float ak = dks[i], av = dvs[i];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ak = fmaf(dss[w * n + j], qs[w * D + d], ak);
        av = fmaf(ps[w * n + j], dos[w * D + d], av);
      }
      dks[i] = ak;
      dvs[i] = av;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int j = i / D, d = i % D;
    dk.row(b, h, j)[d] = from_f<T>(dks[i] * scale);
    dv.row(b, h, j)[d] = from_f<T>(dvs[i]);
  }
}

// ------------------------------------------------------- tiled kernels

// Keys j0 .. j0 + cnt - 1 of head (b, h) of `src` into padded fp32 rows.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const Strided<const T>& src,
                                           int b, int h, int j0, int cnt,
                                           float* dst) {
  for (int i = threadIdx.x; i < cnt * D; i += THREADS) {
    const int j = i / D, d = i % D;
    dst[j * (D + 1) + d] = to_f(src.row(b, h, j0 + j)[d]);
  }
}

// Query rows r0 .. r0 + rows - 1 of head (b, h) into `dst` (rows x D fp32,
// rows past n zero), each element through `f`.
template <typename T, int D, typename F>
__device__ __forceinline__ void stage_rows(const Strided<const T>& src,
                                           int b, int h, int r0, int rows,
                                           int n, float* dst, F f) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = r0 + i / D, d = i % D;
    dst[i] = r < n ? f(to_f(src.row(b, h, r)[d])) : 0.f;
  }
}

// q·k over D in the whole-head kernels' order (q pre-scaled or not).
template <int D>
__device__ __forceinline__ float dot_row(const float* qr, const float* kr) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
  return s;
}

// The score of query row `qr` against tile key jj, as score_row forms it.
template <int D>
__device__ __forceinline__ float tile_score(const float* qr, const float* ks,
                                            int jj, float post) {
  return dot_row<D>(qr, ks + jj * (D + 1)) * post;
}

// Per warp: the row max and the row sum of exp(S − max) of each of its
// RPW rows (pre-scaled q rows at qs + row·D) over every key tile, in
// score_row's order.  Two passes over the tiles; all threads call it.
template <typename T, int D>
__device__ __forceinline__ void row_stats(const Strided<const T>& k, int b,
                                          int h, int n, const float* qs,
                                          float* ks, float post, int warp,
                                          int lane, float (&mx)[RPW],
                                          float (&sum)[RPW]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    mx[r] = -INFINITY;
    sum[r] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int j0 = 0; j0 < n; j0 += TK) {
      const int cnt = min(TK, n - j0);
      stage_tile<T, D>(k, b, h, j0, cnt, ks);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float* qr = qs + (warp * RPW + r) * D;
        for (int jj = lane; jj < cnt; jj += 32) {
          const float s = tile_score<D>(qr, ks, jj, post);
          if (pass == 0)
            mx[r] = fmaxf(mx[r], s);
          else
            sum[r] += expf(s - mx[r]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (pass == 0)
        mx[r] = warp_max(mx[r]);
      else
        sum[r] = warp_sum(sum[r]);
    }
  }
}

// K6/K9 forward over key tiles: QROWS query rows per block.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_tiled(Strided<const T> q, Strided<const T> k,
                    Strided<const T> v, Strided<T> o, int n, float scale,
                    int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;
  constexpr int PER = (D + 31) / 32;
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * QROWS;
  float* ks = smem;                       // TK x LDK
  float* vs = ks + TK * LDK;              // TK x LDK
  float* qs = vs + TK * LDK;              // QROWS x D, q as scored
  float* pt = qs + QROWS * D;             // WARPS x TK: a row's P tile
  stage_rows<T, D>(q, b, h, r0, QROWS, n, qs, [=](float x) {
    return pow2 ? to_f(from_f<T>(x * scale)) : x;
  });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float post = pow2 ? 1.f : scale;
  float mx[RPW], sum[RPW];
  row_stats<T, D>(k, b, h, n, qs, ks, post, warp, lane, mx, sum);

  float* p = pt + warp * TK;
  float acc[RPW][PER];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int t = 0; t < PER; ++t) acc[r][t] = 0.f;
  for (int j0 = 0; j0 < n; j0 += TK) {
    const int cnt = min(TK, n - j0);
    stage_tile<T, D>(k, b, h, j0, cnt, ks);
    stage_tile<T, D>(v, b, h, j0, cnt, vs);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float* qr = qs + (warp * RPW + r) * D;
      for (int jj = lane; jj < cnt; jj += 32)
        p[jj] = to_f(from_f<T>(expf(tile_score<D>(qr, ks, jj, post) - mx[r]) /
                               sum[r]));
      __syncwarp();
      for (int jj = 0; jj < cnt; ++jj) {
        const float pj = p[jj];
#pragma unroll
        for (int t = 0; t < PER; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[r][t] = fmaf(pj, vs[jj * LDK + d], acc[r][t]);
        }
      }
      __syncwarp();                       // p is the next row's
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = r0 + warp * RPW + r;
    if (qi >= n) continue;
    T* orow = o.row(b, h, qi);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int d = lane + 32 * t;
      if (d < D) orow[d] = from_f<T>(acc[r][t]);
    }
  }
}

// Query side of the tiled backward: per row the max and sum (row_stats),
// then δ = rowsum(dP∘P) (and O = P_c·V with WRITE_O) over the key tiles,
// then dQ = dS·K·scale; writes max, sum and δ to stats[0..2][bh·n + row].
template <typename T, int D, bool WRITE_O>
__global__ void __launch_bounds__(THREADS)
attention_bwd_rows_tiled(Strided<const T> q, Strided<const T> k,
                         Strided<const T> v, Strided<const T> dout,
                         Strided<T> o, Strided<T> dq, float* stats, int n,
                         float scale, int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;
  constexpr int PER = (D + 31) / 32;
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * QROWS;
  float* ks = smem;                       // TK x LDK
  float* vs = ks + TK * LDK;              // TK x LDK
  float* qs = vs + TK * LDK;              // QROWS x D, q as scored
  float* dos = qs + QROWS * D;            // QROWS x D, dO
  float* pt = dos + QROWS * D;            // WARPS x TK: P_c, then dS
  stage_rows<T, D>(q, b, h, r0, QROWS, n, qs, [=](float x) {
    return pow2 ? to_f(from_f<T>(x * scale)) : x;
  });
  stage_rows<T, D>(dout, b, h, r0, QROWS, n, dos, [](float x) { return x; });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float post = pow2 ? 1.f : scale;
  float mx[RPW], sum[RPW];
  row_stats<T, D>(k, b, h, n, qs, ks, post, warp, lane, mx, sum);

  float* p = pt + warp * TK;
  float rs[RPW], oa[RPW][PER], dqa[RPW][PER];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    rs[r] = 0.f;
#pragma unroll
    for (int t = 0; t < PER; ++t) oa[r][t] = dqa[r][t] = 0.f;
  }
  // pass 3: δ (and O); pass 4: dQ with the finished δ
  for (int pass = 3; pass <= 4; ++pass) {
    for (int j0 = 0; j0 < n; j0 += TK) {
      const int cnt = min(TK, n - j0);
      stage_tile<T, D>(k, b, h, j0, cnt, ks);
      stage_tile<T, D>(v, b, h, j0, cnt, vs);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float* qr = qs + (warp * RPW + r) * D;
        const float* dr = dos + (warp * RPW + r) * D;
        for (int jj = lane; jj < cnt; jj += 32) {
          const float pj =
              expf(tile_score<D>(qr, ks, jj, post) - mx[r]) / sum[r];
          const float dpj = dot_row<D>(dr, vs + jj * LDK);
          if (pass == 3) {
            rs[r] = fmaf(dpj, pj, rs[r]);
            p[jj] = to_f(from_f<T>(pj));
          } else {
            p[jj] = to_f(from_f<T>(pj * (dpj - rs[r])));
          }
        }
        __syncwarp();
        if (pass == 4 || WRITE_O) {
          for (int jj = 0; jj < cnt; ++jj) {
            const float w = p[jj];
#pragma unroll
            for (int t = 0; t < PER; ++t) {
              const int d = lane + 32 * t;
              if (d < D) {
                if (pass == 3)
                  oa[r][t] = fmaf(w, vs[jj * LDK + d], oa[r][t]);
                else
                  dqa[r][t] = fmaf(w, ks[jj * LDK + d], dqa[r][t]);
              }
            }
          }
        }
        __syncwarp();                     // p is the next row's
      }
      __syncthreads();
    }
    if (pass == 3) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) rs[r] = warp_sum(rs[r]);
    }
  }

  const long long rows = static_cast<long long>(gridDim.z) * gridDim.y * n;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = r0 + warp * RPW + r;
    if (qi >= n) continue;
    if (lane == 0) {
      stats[bh * n + qi] = mx[r];
      stats[rows + bh * n + qi] = sum[r];
      stats[2 * rows + bh * n + qi] = rs[r];
    }
    T* dqrow = dq.row(b, h, qi);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        if constexpr (WRITE_O) o.row(b, h, qi)[d] = from_f<T>(oa[r][t]);
        dqrow[d] = from_f<T>(dqa[r][t] * scale);
      }
    }
  }
}

// Key side of the tiled backward: TK keys per block; walks the query rows
// in tiles of WARPS (one row per warp), recomputes P and dS from the
// stats the query side wrote, and adds dSᵀ·Q and P_cᵀ·dO into dK and dV
// in row order, as the whole-head kernel does.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_keys_tiled(Strided<const T> q, Strided<const T> k,
                         Strided<const T> v, Strided<const T> dout,
                         Strided<T> dk, Strided<T> dv, const float* stats,
                         int n, float scale, int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * TK;
  const int cnt = min(TK, n - j0);
  float* ks = smem;                       // TK x LDK
  float* vs = ks + TK * LDK;              // TK x LDK
  float* dks = vs + TK * LDK;             // TK x D  (dK accumulator)
  float* dvs = dks + TK * D;              // TK x D  (dV accumulator)
  float* ps = dvs + TK * D;               // WARPS x TK: P_c
  float* dss = ps + WARPS * TK;           // WARPS x TK: dS
  float* qs = dss + WARPS * TK;           // WARPS x D: the tile's q rows
  float* qss = qs + WARPS * D;            // WARPS x D: the same, as scored
  float* dos = qss + WARPS * D;           // WARPS x D: the tile's dO rows
  stage_tile<T, D>(k, b, h, j0, cnt, ks);
  stage_tile<T, D>(v, b, h, j0, cnt, vs);
  for (int i = threadIdx.x; i < TK * D; i += THREADS) dks[i] = dvs[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float post = pow2 ? 1.f : scale;
  const long long rows = static_cast<long long>(gridDim.z) * gridDim.y * n;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  float* p = ps + warp * TK;
  float* ds = dss + warp * TK;
  float* qw = qs + warp * D;
  float* qsw = qss + warp * D;
  float* dow = dos + warp * D;
  for (int t0 = 0; t0 < n; t0 += WARPS) {
    const int qi = t0 + warp;
    if (qi < n) {
      const T* qrow = q.row(b, h, qi);
      const T* drow = dout.row(b, h, qi);
      for (int d = lane; d < D; d += 32) {
        const float x = to_f(qrow[d]);
        qw[d] = x;
        qsw[d] = pow2 ? to_f(from_f<T>(x * scale)) : x;
        dow[d] = to_f(drow[d]);
      }
      __syncwarp();
      const float mx = stats[bh * n + qi], sum = stats[rows + bh * n + qi];
      const float rs = stats[2 * rows + bh * n + qi];
      for (int jj = lane; jj < TK; jj += 32) {
        if (jj < cnt) {
          const float pj = expf(tile_score<D>(qsw, ks, jj, post) - mx) / sum;
          const float dpj = dot_row<D>(dow, vs + jj * LDK);
          ds[jj] = to_f(from_f<T>(pj * (dpj - rs)));
          p[jj] = to_f(from_f<T>(pj));
        } else {
          ds[jj] = p[jj] = 0.f;
        }
      }
    } else {                              // past the last row: adds nothing
      for (int jj = lane; jj < TK; jj += 32) p[jj] = ds[jj] = 0.f;
      for (int d = lane; d < D; d += 32) qw[d] = dow[d] = 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt * D; i += THREADS) {
      const int jj = i / D, d = i % D;
      float ak = dks[i], av = dvs[i];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ak = fmaf(dss[w * TK + jj], qs[w * D + d], ak);
        av = fmaf(ps[w * TK + jj], dos[w * D + d], av);
      }
      dks[i] = ak;
      dvs[i] = av;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cnt * D; i += THREADS) {
    const int jj = i / D, d = i % D;
    dk.row(b, h, j0 + jj)[d] = from_f<T>(dks[i] * scale);
    dv.row(b, h, j0 + jj)[d] = from_f<T>(dvs[i]);
  }
}

size_t fwd_tiled_smem(int d) {
  return sizeof(float) * (2 * TK * (d + 1) + QROWS * d + WARPS * TK);
}

size_t bwd_rows_smem(int d) {
  return sizeof(float) * (2 * TK * (d + 1) + 2 * QROWS * d + WARPS * TK);
}

size_t bwd_keys_smem(int d) {
  return sizeof(float) *
         (2 * TK * (d + 1) + 2 * TK * d + 2 * WARPS * TK + 3 * WARPS * d);
}

// launch_dyn (attention_bwd_mma.cuh) on THREADS threads a block
template <typename K, typename... A>
int launch_smem(K kernel, dim3 grid, size_t smem, cudaStream_t s,
                A... args) {
  return launch_dyn(kernel, grid, THREADS, smem, s, args...);
}

// ------------------------------------------------------------ launchers

// The forward: bf16 on the tensor cores (attention_fwd_mma.cuh, every n),
// fp32 on the SIMT kernels (whole-head, or tiled past one block).
template <typename T, int D>
struct Fwd {
  static int run(Strided<const T> q, Strided<const T> k, Strided<const T> v,
                 Strided<T> o, float* /*stats*/, int batch, int heads, int n,
                 float scale, int pow2, cudaStream_t s) {
    if constexpr (std::is_same_v<T, bf16>) {
      return launch_attention_fwd_mma<D>(q, k, v, o, batch, heads, n, scale,
                                         pow2, s);
    } else {
      const size_t smem = fwd_smem(n, D);
      if (smem > MAX_SMEM)
        return launch_smem(attention_fwd_tiled<T, D>,
                           dim3(cdiv(n, QROWS), heads, batch),
                           fwd_tiled_smem(D), s, q, k, v, o, n, scale, pow2);
      return launch_smem(attention_fwd_kernel<T, D>,
                         dim3(cdiv(n, FWD_ROWS), heads, batch), smem, s, q, k,
                         v, o, n, scale, pow2);
    }
  }
};

// The backward: bf16 on the tensor cores (attention_bwd_mma.cuh, every
// n), fp32 on the SIMT kernels (whole-head, or tiled past one block).
// `stats` is fp32 scratch of 3·batch·heads·n floats: each query row's
// statistics, passed from the query side to the key side by the bf16
// kernels and by the fp32 tiled kernels (unused by the fp32 whole-head
// kernel).
template <bool WRITE_O>
struct Bwd {
  template <typename T, int D>
  struct At {
    static int run(Strided<const T> q, Strided<const T> k,
                   Strided<const T> v, Strided<const T> dout, Strided<T> o,
                   Strided<T> dq, Strided<T> dk, Strided<T> dv, float* stats,
                   int batch, int heads, int n, float scale, int pow2,
                   cudaStream_t s) {
      if constexpr (std::is_same_v<T, bf16>) {
        return launch_attention_bwd_mma<D, WRITE_O>(
            q, k, v, dout, o, dq, dk, dv, stats, batch, heads, n, scale,
            pow2, s);
      } else {
        const size_t smem = bwd_smem(n, D);
        if (smem <= MAX_SMEM)
          return launch_smem(attention_bwd_kernel<T, D, WRITE_O>,
                             dim3(heads, batch), smem, s, q, k, v, dout, o,
                             dq, dk, dv, n, scale, pow2);
        const int err = launch_smem(
            attention_bwd_rows_tiled<T, D, WRITE_O>,
            dim3(cdiv(n, QROWS), heads, batch), bwd_rows_smem(D), s, q, k,
            v, dout, o, dq, stats, n, scale, pow2);
        if (err != 0) return err;
        return launch_smem(attention_bwd_keys_tiled<T, D>,
                           dim3(cdiv(n, TK), heads, batch), bwd_keys_smem(D),
                           s, q, k, v, dout, dk, dv,
                           static_cast<const float*>(stats), n, scale, pow2);
      }
    }
  };
};

// L<T, D>::run(args...) for the head dims the kernels are built for.
template <typename T, template <typename, int> class L, typename... A>
int by_head_dim(int d, A... a) {
  switch (d) {
    case 8: return L<T, 8>::run(a...);
    case 16: return L<T, 16>::run(a...);
    case 32: return L<T, 32>::run(a...);
    case 64: return L<T, 64>::run(a...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The packed layouts: rows of width `ld` (3C for qkv and dqkv, C for the
// output and dO), head h at column offset h·D, part `part` (0 q, 1 k, 2 v)
// at column offset part·C.
template <typename P>
Strided<P> packed(P* base, int part, int n, int heads, int d, int ld) {
  return {base + static_cast<long long>(part) * heads * d,
          static_cast<long long>(n) * ld, d, ld};
}

// (B, H, N, D), contiguous.
template <typename P>
Strided<P> bhnd(P* base, int n, int heads, int d) {
  return {base, static_cast<long long>(heads) * n * d,
          static_cast<long long>(n) * d, d};
}

template <typename T>
int qkv_fwd(const void* qkv_, void* attn_, int batch, int n, int heads,
            int d, float scale, int pow2, cudaStream_t s) {
  const T* qkv = static_cast<const T*>(qkv_);
  const int c = heads * d;
  return by_head_dim<T, Fwd>(
      d, packed(qkv, 0, n, heads, d, 3 * c), packed(qkv, 1, n, heads, d, 3 * c),
      packed(qkv, 2, n, heads, d, 3 * c),
      packed(static_cast<T*>(attn_), 0, n, heads, d, c),
      static_cast<float*>(nullptr), batch, heads, n, scale, pow2, s);
}

template <typename T, bool WRITE_O>
int qkv_bwd(const void* qkv_, const void* dout_, void* attn_, void* dqkv_,
            void* stats, int batch, int n, int heads, int d, float scale,
            int pow2, cudaStream_t s) {
  const T* qkv = static_cast<const T*>(qkv_);
  T* dqkv = static_cast<T*>(dqkv_);
  const int c = heads * d;
  return by_head_dim<T, Bwd<WRITE_O>::template At>(
      d, packed(qkv, 0, n, heads, d, 3 * c), packed(qkv, 1, n, heads, d, 3 * c),
      packed(qkv, 2, n, heads, d, 3 * c),
      packed(static_cast<const T*>(dout_), 0, n, heads, d, c),
      packed(static_cast<T*>(attn_), 0, n, heads, d, c),
      packed(dqkv, 0, n, heads, d, 3 * c), packed(dqkv, 1, n, heads, d, 3 * c),
      packed(dqkv, 2, n, heads, d, 3 * c), static_cast<float*>(stats), batch,
      heads, n, scale, pow2, s);
}

template <typename T>
int bhnd_fwd(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int n, int d, float scale, int pow2, cudaStream_t s) {
  return by_head_dim<T, Fwd>(
      d, bhnd(static_cast<const T*>(q), n, heads, d),
      bhnd(static_cast<const T*>(k), n, heads, d),
      bhnd(static_cast<const T*>(v), n, heads, d),
      bhnd(static_cast<T*>(o), n, heads, d), static_cast<float*>(nullptr),
      batch, heads, n, scale, pow2, s);
}

template <typename T>
int bhnd_bwd(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, void* stats, int batch, int heads,
             int n, int d, float scale, int pow2, cudaStream_t s) {
  const Strided<T> no_o = bhnd(static_cast<T*>(nullptr), n, heads, d);
  return by_head_dim<T, Bwd<false>::template At>(
      d, bhnd(static_cast<const T*>(q), n, heads, d),
      bhnd(static_cast<const T*>(k), n, heads, d),
      bhnd(static_cast<const T*>(v), n, heads, d),
      bhnd(static_cast<const T*>(dout), n, heads, d), no_o,
      bhnd(static_cast<T*>(dq), n, heads, d),
      bhnd(static_cast<T*>(dk), n, heads, d),
      bhnd(static_cast<T*>(dv), n, heads, d), static_cast<float*>(stats),
      batch, heads, n, scale, pow2, s);
}

// K1's attention step in bf16 (vit_block.cu), and K7/K8's with an fp32
// output (TO = float, vit_block_q8.cu): the tensor-core forward with the
// softmax division deferred past P·V (attention_fwd_mma.cuh, DEFER), qkv
// (batch, n, 3·heads·d) -> attn (batch, n, heads·d), d in {16, 32, 64,
// 128}; bias: ToMe's fp32 (batch, n) key bias, or nullptr.
template <typename T, typename TO = T>
int qkv_fwd_deferred(const void* qkv_, void* attn_, int batch, int n,
                     int heads, int d, float scale, int pow2,
                     const float* bias, cudaStream_t s) {
  static_assert(std::is_same_v<T, bf16>, "the tensor-core forward is bf16");
  const T* qkv = static_cast<const T*>(qkv_);
  const int c = heads * d;
  const Strided<const T> q = packed(qkv, 0, n, heads, d, 3 * c),
                         k = packed(qkv, 1, n, heads, d, 3 * c),
                         v = packed(qkv, 2, n, heads, d, 3 * c);
  const Strided<TO> o = packed(static_cast<TO*>(attn_), 0, n, heads, d, c);
  switch (d) {
    case 16: return launch_attention_fwd_mma<16, true>(
        q, k, v, o, batch, heads, n, scale, pow2, s, bias);
    case 32: return launch_attention_fwd_mma<32, true>(
        q, k, v, o, batch, heads, n, scale, pow2, s, bias);
    case 64: return launch_attention_fwd_mma<64, true>(
        q, k, v, o, batch, heads, n, scale, pow2, s, bias);
    case 128: return launch_attention_fwd_mma<128, true>(
        q, k, v, o, batch, heads, n, scale, pow2, s, bias);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dfu
