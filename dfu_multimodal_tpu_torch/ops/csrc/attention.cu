// Softmax attention over a strided operand for Hopper (sm_90a): forward,
// backward, and the combined forward + backward of the attention-block
// backward.
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
//   of the 227 KB a block may hold at N = 197, D = 64.  Every product runs
//   on the FMA pipes (SIMT fp32): the tensor cores, TMA and more than one
//   backward block per SM are later work.
//
// Numerics follow the Pallas kernels (_softmax_probs_c): compute-dtype
// score operands with fp32 accumulation (q pre-scaled by 1/sqrt(D) in the
// compute dtype when that is a power of two, D = 16, 64; else the fp32
// scores scaled after the product, D = 8, 32), fp32 max/exp/sum with P
// normalised BEFORE P·V, P rounded to the compute dtype for O and dV, the
// output rounded to the compute dtype, dS = P∘(dP − rowsum(dP∘P)) rounded
// to the compute dtype, dQ = dS·K·scale and dK = dSᵀ·Q·scale (Q unscaled).

#include "common.cuh"

namespace dfu {
namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int FWD_ROWS = 64;          // query rows per forward block
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

template <typename T, int D>
struct Fwd {
  static int run(Strided<const T> q, Strided<const T> k, Strided<const T> v,
                 Strided<T> o, int batch, int heads, int n, float scale,
                 int pow2, cudaStream_t s) {
    const size_t smem = fwd_smem(n, D);
    if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_fwd_kernel<T, D>
        <<<dim3(cdiv(n, FWD_ROWS), heads, batch), THREADS, smem, s>>>(
            q, k, v, o, n, scale, pow2);
    DFU_RETURN_LAST_ERROR();
  }
};

template <bool WRITE_O>
struct Bwd {
  template <typename T, int D>
  struct At {
    static int run(Strided<const T> q, Strided<const T> k,
                   Strided<const T> v, Strided<const T> dout, Strided<T> o,
                   Strided<T> dq, Strided<T> dk, Strided<T> dv, int batch,
                   int heads, int n, float scale, int pow2, cudaStream_t s) {
      const size_t smem = bwd_smem(n, D);
      if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
      cudaError_t err = cudaFuncSetAttribute(
          attention_bwd_kernel<T, D, WRITE_O>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      attention_bwd_kernel<T, D, WRITE_O>
          <<<dim3(heads, batch), THREADS, smem, s>>>(
              q, k, v, dout, o, dq, dk, dv, n, scale, pow2);
      DFU_RETURN_LAST_ERROR();
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
      packed(static_cast<T*>(attn_), 0, n, heads, d, c), batch, heads, n,
      scale, pow2, s);
}

template <typename T, bool WRITE_O>
int qkv_bwd(const void* qkv_, const void* dout_, void* attn_, void* dqkv_,
            int batch, int n, int heads, int d, float scale, int pow2,
            cudaStream_t s) {
  const T* qkv = static_cast<const T*>(qkv_);
  T* dqkv = static_cast<T*>(dqkv_);
  const int c = heads * d;
  return by_head_dim<T, Bwd<WRITE_O>::template At>(
      d, packed(qkv, 0, n, heads, d, 3 * c), packed(qkv, 1, n, heads, d, 3 * c),
      packed(qkv, 2, n, heads, d, 3 * c),
      packed(static_cast<const T*>(dout_), 0, n, heads, d, c),
      packed(static_cast<T*>(attn_), 0, n, heads, d, c),
      packed(dqkv, 0, n, heads, d, 3 * c), packed(dqkv, 1, n, heads, d, 3 * c),
      packed(dqkv, 2, n, heads, d, 3 * c), batch, heads, n, scale, pow2, s);
}

template <typename T>
int bhnd_fwd(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int n, int d, float scale, int pow2, cudaStream_t s) {
  return by_head_dim<T, Fwd>(
      d, bhnd(static_cast<const T*>(q), n, heads, d),
      bhnd(static_cast<const T*>(k), n, heads, d),
      bhnd(static_cast<const T*>(v), n, heads, d),
      bhnd(static_cast<T*>(o), n, heads, d), batch, heads, n, scale, pow2, s);
}

template <typename T>
int bhnd_bwd(const void* q, const void* k, const void* v, const void* dout,
             void* dq, void* dk, void* dv, int batch, int heads, int n, int d,
             float scale, int pow2, cudaStream_t s) {
  const Strided<T> no_o = bhnd(static_cast<T*>(nullptr), n, heads, d);
  return by_head_dim<T, Bwd<false>::template At>(
      d, bhnd(static_cast<const T*>(q), n, heads, d),
      bhnd(static_cast<const T*>(k), n, heads, d),
      bhnd(static_cast<const T*>(v), n, heads, d),
      bhnd(static_cast<const T*>(dout), n, heads, d), no_o,
      bhnd(static_cast<T*>(dq), n, heads, d),
      bhnd(static_cast<T*>(dk), n, heads, d),
      bhnd(static_cast<T*>(dv), n, heads, d), batch, heads, n, scale, pow2,
      s);
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 when the forward (bwd = 0) or backward (bwd = 1) kernel takes a head
// of n rows of dimension d in one block's shared memory, else 0.
int dfu_attention_fits(int bwd, int n, int d) {
  if (d != 8 && d != 16 && d != 32 && d != 64) return 0;
  return (bwd ? bwd_smem(n, d) : fwd_smem(n, d)) <= MAX_SMEM;
}

// Every entry: d in {8, 16, 32, 64}; scale = d^-0.5; pow2: the scale is a
// power of two (q pre-scaled in the compute dtype).

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
                          const void* dout, void* dqkv, int batch, int n,
                          int heads, int d, float scale, int pow2,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return qkv_bwd<bf16, false>(qkv, dout, nullptr, dqkv, batch, n, heads, d,
                                scale, pow2, s);
  return qkv_bwd<float, false>(qkv, dout, nullptr, dqkv, batch, n, heads, d,
                               scale, pow2, s);
}

// K5: qkv, dout -> attn (batch, n, heads·d) and dqkv (batch, n, 3·heads·d).
int dfu_qkv_attention_fwdbwd(int device, int dtype, const void* qkv,
                             const void* dout, void* attn, void* dqkv,
                             int batch, int n, int heads, int d, float scale,
                             int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return qkv_bwd<bf16, true>(qkv, dout, attn, dqkv, batch, n, heads, d,
                               scale, pow2, s);
  return qkv_bwd<float, true>(qkv, dout, attn, dqkv, batch, n, heads, d,
                              scale, pow2, s);
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
                      void* dv, int batch, int heads, int n, int d,
                      float scale, int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return bhnd_bwd<bf16>(q, k, v, dout, dq, dk, dv, batch, heads, n, d,
                          scale, pow2, s);
  return bhnd_bwd<float>(q, k, v, dout, dq, dk, dv, batch, heads, n, d,
                         scale, pow2, s);
}

}  // extern "C"
