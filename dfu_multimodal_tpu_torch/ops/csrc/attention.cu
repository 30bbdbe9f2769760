// Packed-qkv attention forward + backward in one kernel for Hopper
// (sm_90a).
//
// Replaces: dfu_multimodal_tpu/ops/attention.py::
//   _qkv_attention_fwdbwd_kernel (K5), the Pallas kernel the
//   rematerialising attention-block backward calls: from the packed qkv
//   (B, N, 3C) and the attention output's gradient dO (B, N, C) it
//   computes each head's softmax once and emits the re-forward output
//   O (B, N, C) and dQKV (B, N, 3C), packed [dq | dk | dv] by column.
//
// What bounds it on the H100: per (image, head) six N x N x D products
//   (S = QKᵀ, O = PV, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO): at
//   the training batch (16 images, 12 heads, N = 197, D = 64) 5.7 GFLOP
//   against 39 MB read and written once, so the bound is the bytes
//   (12 us at 3.35 TB/s; 6 us of bf16 tensor-core work).
//
// What the design does about it: the TPU kernel holds one image's whole
//   qkv in VMEM and walks the heads in order.  Here one block per
//   (head, image) (192 blocks at B = 16) holds the head's K and V as fp32
//   in shared memory and walks the query rows in tiles of 8, one warp per
//   row: each warp forms its row of S, P and dS (score rows in shared
//   memory, so the full N x N matrix never exists), writes its O and dQ
//   rows, and after a barrier all 256 threads add the tile's dSᵀ·Q and
//   Pᵀ·dO into dK and dV accumulators that stay in shared memory across
//   the tiles (in row order: no atomics, deterministic).  K, V, dK, dV
//   (4 x 197 x 64 fp32, K and V rows padded against bank conflicts) and
//   the tile's rows take 220 KB of the 227 KB a block may hold at D = 64.
//   Every product runs on the FMA pipes (SIMT fp32); the tensor cores and
//   more than one block per SM are later work.
//
// Numerics follow the Pallas kernel: compute-dtype score operands with
// fp32 accumulation (q pre-scaled by 1/sqrt(D) in the compute dtype when
// that is a power of two, else the fp32 scores scaled), fp32 max/exp/sum
// with P normalised BEFORE P·V, P rounded to the compute dtype for O and
// dV, dS = P∘(dP − rowsum(dP∘P)) rounded to the compute dtype,
// dQ = dS·K·scale and dK = dSᵀ·Q·scale (Q unscaled).

#include "common.cuh"

namespace dfu {
namespace {

constexpr int FB_WARPS = 8, FB_THREADS = FB_WARPS * 32;
constexpr size_t MAX_SMEM = 232448;   // bytes a block may hold on sm_90

size_t fwdbwd_smem(int n, int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(n) * (d + 1) + 2 * static_cast<size_t>(n) * d +
          2 * static_cast<size_t>(FB_WARPS) * n + 2 * FB_WARPS * d);
}

template <typename T, int D>
__global__ void __launch_bounds__(FB_THREADS)
qkv_attention_fwdbwd_kernel(const T* __restrict__ qkv,
                            const T* __restrict__ dout, T* __restrict__ attn,
                            T* __restrict__ dqkv, int n, int heads,
                            float scale, int pow2) {
  extern __shared__ float smem[];
  constexpr int LDK = D + 1;              // padded rows: lanes hit other banks
  constexpr int PER = (D + 31) / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = heads * D, ld = 3 * c;
  float* ks = smem;                       // n x LDK
  float* vs = ks + n * LDK;               // n x LDK
  float* dks = vs + n * LDK;              // n x D  (dK accumulator)
  float* dvs = dks + n * D;               // n x D  (dV accumulator)
  float* ps = dvs + n * D;                // FB_WARPS x n: P (fp32, then T)
  float* dss = ps + FB_WARPS * n;         // FB_WARPS x n: dP, then dS
  float* qs = dss + FB_WARPS * n;         // FB_WARPS x D: the tile's q rows
  float* dos = qs + FB_WARPS * D;         // FB_WARPS x D: the tile's dO rows
  const T* base = qkv + static_cast<size_t>(b) * n * ld;
  const T* dbase = dout + static_cast<size_t>(b) * n * c;

  for (int i = threadIdx.x; i < n * D; i += FB_THREADS) {
    const int j = i / D, d = i % D;
    const T* row = base + static_cast<size_t>(j) * ld + h * D + d;
    ks[j * LDK + d] = to_f(row[c]);
    vs[j * LDK + d] = to_f(row[2 * c]);
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ps + warp * n;
  float* ds = dss + warp * n;
  float* qw = qs + warp * D;
  float* dow = dos + warp * D;
  const float post = pow2 ? 1.f : scale;

  for (int t0 = 0; t0 < n; t0 += FB_WARPS) {
    const int qi = t0 + warp;
    if (qi < n) {
      const T* qrow = base + static_cast<size_t>(qi) * ld + h * D;
      const T* drow = dbase + static_cast<size_t>(qi) * c + h * D;
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
      // S row and its max (lanes over keys)
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
      sum = warp_sum(sum);
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
      float o[PER], dq[PER];
#pragma unroll
      for (int t = 0; t < PER; ++t) o[t] = dq[t] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float pj = p[j], dsj = ds[j];
#pragma unroll
        for (int t = 0; t < PER; ++t) {
          const int d = lane + 32 * t;
          if (d < D) {
            o[t] = fmaf(pj, vs[j * LDK + d], o[t]);
            dq[t] = fmaf(dsj, ks[j * LDK + d], dq[t]);
          }
        }
      }
      T* orow = attn + (static_cast<size_t>(b) * n + qi) * c + h * D;
      T* dqrow = dqkv + (static_cast<size_t>(b) * n + qi) * ld + h * D;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int d = lane + 32 * t;
        if (d < D) {
          orow[d] = from_f<T>(o[t]);
          dqrow[d] = from_f<T>(dq[t] * scale);
        }
      }
    } else {                              // past the last row: adds nothing
      for (int j = lane; j < n; j += 32) p[j] = ds[j] = 0.f;
      for (int d = lane; d < D; d += 32) qw[d] = dow[d] = 0.f;
    }
    __syncthreads();
    // dK += dSᵀ·Q and dV += Pᵀ·dO over the tile's rows, in row order
    for (int i = threadIdx.x; i < n * D; i += FB_THREADS) {
      const int j = i / D, d = i % D;
      float ak = dks[i], av = dvs[i];
#pragma unroll
      for (int w = 0; w < FB_WARPS; ++w) {
        ak = fmaf(dss[w * n + j], qs[w * D + d], ak);
        av = fmaf(ps[w * n + j], dos[w * D + d], av);
      }
      dks[i] = ak;
      dvs[i] = av;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n * D; i += FB_THREADS) {
    const int j = i / D, d = i % D;
    T* row = dqkv + (static_cast<size_t>(b) * n + j) * ld + h * D + d;
    row[c] = from_f<T>(dks[i] * scale);
    row[2 * c] = from_f<T>(dvs[i]);
  }
}

template <typename T, int D>
int launch_fwdbwd(const void* qkv, const void* dout, void* attn, void* dqkv,
                  int batch, int n, int heads, float scale, int pow2,
                  cudaStream_t s) {
  const size_t smem = fwdbwd_smem(n, D);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attention_fwdbwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_attention_fwdbwd_kernel<T, D><<<dim3(heads, batch), FB_THREADS, smem,
                                      s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(attn), static_cast<T*>(dqkv), n, heads, scale, pow2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwdbwd(int d, const void* qkv, const void* dout, void* attn,
                    void* dqkv, int batch, int n, int heads, float scale,
                    int pow2, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch_fwdbwd<T, 16>(qkv, dout, attn, dqkv, batch, n, heads,
                                  scale, pow2, s);
    case 32:
      return launch_fwdbwd<T, 32>(qkv, dout, attn, dqkv, batch, n, heads,
                                  scale, pow2, s);
    case 64:
      return launch_fwdbwd<T, 64>(qkv, dout, attn, dqkv, batch, n, heads,
                                  scale, pow2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// qkv (batch, n, 3·heads·d), dout (batch, n, heads·d) -> attn
// (batch, n, heads·d), dqkv (batch, n, 3·heads·d); d in {16, 32, 64};
// pow2: scale is a power of two (q pre-scaled in the compute dtype).
int dfu_qkv_attention_fwdbwd(int device, int dtype, const void* qkv,
                             const void* dout, void* attn, void* dqkv,
                             int batch, int n, int heads, int d, float scale,
                             int pow2, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return dispatch_fwdbwd<bf16>(d, qkv, dout, attn, dqkv, batch, n, heads,
                                 scale, pow2, s);
  return dispatch_fwdbwd<float>(d, qkv, dout, attn, dqkv, batch, n, heads,
                                scale, pow2, s);
}

}  // extern "C"
