// Int8 ViT encoder-block kernels for Hopper (sm_90a): the serving path.
//
// Replaces: dfu_multimodal_tpu/ops/vit_block_q8.py::_attn_block_q8_kernel
//   and ::_mlp_block_q8_kernel (K7, dynamic per-row activation scales) and
//   ::_attn_block_q8s_kernel and ::_mlp_block_q8s_kernel (K8, calibrated
//   static scales): x + proj(MHA(qkv(LN1(x)))) and x + fc2(GELU(fc1(LN2(x))))
//   with int8 weights (per output channel) and int8 activations.
//
// What bounds it on the H100: at the serving batch (8 images, 1576 token
//   rows) the attention block does 7.44 GOP of int8 products and 0.95 GFLOP
//   of attention against 7.2 MB of operands (4.7 us at 1979 TOP/s int8 and
//   989 TFLOP/s bf16), the MLP block 14.9 GOP against 9.6 MB (7.5 us): both
//   are operation-bound.
//
// What the design does about it: the TPU kernels keep two images' (or 384
//   rows') whole block in VMEM.  A Hopper SM has 227 KB of shared memory and
//   blocks run in parallel in no order, so each TPU kernel becomes a chain
//   of launches that each fill the card:
//   - ln_quant: one warp per row, LayerNorm in fp32, the row absmax, int8
//     y_q and the row scale a[r] (or, static, the calibrated 1/s);
//   - gemm_s8: int8 x int8 -> int32 on the tensor cores (WMMA signed char
//     16x16x16, a 64x64 tile per block of 4 warps, K in steps of 64).  The
//     int32 sum is flushed into an fp32 accumulator at the end of every
//     K group: acc·a[r, g]·s[m] (dynamic) or acc·s_eff[m] (static).  The fc2
//     product has one group per 768-wide hidden chunk, because each chunk of
//     h was quantised with its own row scale; the other products have one
//     group.  The epilogue adds the bias, then casts to the compute dtype
//     (qkv), adds the residual (proj, fc2), applies exact-erf GELU into fp32
//     (dynamic fc1) or GELU and the static quantisation into int8 (static
//     fc1);
//   - quant_rows: one warp per (row, group) of an fp32 tensor, the absmax,
//     int8 and the scale (the attention output over C, the GELU output over
//     each 768 chunk), or the static quantisation;
//   - the attention core of attention_core.cuh with an fp32 output.
//   The int8 activations, the fp32 attention output and the fp32 GELU
//   output go through HBM; fusing them away and wgmma/TMA pipelining are
//   later work.
//
// Numerics follow the Pallas kernels and the plain versions in
// ops/vit_block_q8.py operation by operation: round half to even (rintf),
// clip to [-127, 127], a = max(absmax / 127, 1e-12) applied as y·(1/a), the
// dequantisation (acc·a)·s then + bias, the chunk sums added in chunk
// order.  The arithmetic that decides a rounding uses __fmul_rn / __fadd_rn
// so that nvcc cannot contract it into an FMA the plain version does not
// do; the int32 products are exact.  What still differs is the order of the
// LayerNorm and attention sums and erff's last bit, which can move a value
// across a rounding boundary (one int8 step) now and then.  GELU is exact
// erf (the Pallas kernels' logistic form exists only because Mosaic cannot
// lower erf).

#include "attention_core.cuh"
#include "common.cuh"

#include <mma.h>

#include <cstdint>

namespace dfu {
namespace {

enum QEpilogue {
  QEPI_OUT = 0,       // out = T(v)
  QEPI_RESID = 1,     // out = T(resid + T(v))
  QEPI_GELU_F32 = 2,  // out = gelu(v), fp32
  QEPI_GELU_Q8 = 3    // out = int8(gelu(v)·inv[0])
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// clip(round_half_even(y·inv), -127, 127)
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  const float r = rintf(__fmul_rn(y, inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// a = max(absmax / 127, 1e-12)
__device__ __forceinline__ float row_scale_of(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.f), 1e-12f);
}

// ------------------------------------------------- LayerNorm + quantise
// One warp per row of x (rows, c) in the compute dtype: mean and centred
// variance in fp32, y = ((x - mu)·rstd)·g + b, then (dynamic) the row's
// absmax and a[r], and y_q = int8(y·(1/a[r])); static: y_q = int8(y·inv[0]).
// y is recomputed, identically, in each pass.
template <typename T, bool STATIC>
__global__ void ln_quant_kernel(const T* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ b,
                                int8_t* __restrict__ q, float* __restrict__ a,
                                const float* __restrict__ inv, int rows, int c,
                                float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * c;
  int8_t* qr = q + static_cast<size_t>(row) * c;
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s += to_f(xr[i]);
  const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(c));
  float v = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d = __fsub_rn(to_f(xr[i]), mu);
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(warp_sum(v), static_cast<float>(c));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  auto y_at = [&](int i) {
    const float xh = __fmul_rn(__fsub_rn(to_f(xr[i]), mu), rstd);
    return __fadd_rn(__fmul_rn(xh, g[i]), b[i]);
  };
  float scale_inv;
  if constexpr (STATIC) {
    scale_inv = inv[0];
  } else {
    float m = 0.f;
    for (int i = lane; i < c; i += 32) m = fmaxf(m, fabsf(y_at(i)));
    const float ar = row_scale_of(warp_max(m));
    if (lane == 0) a[row] = ar;
    scale_inv = __fdiv_rn(1.f, ar);
  }
  for (int i = lane; i < c; i += 32) qr[i] = quant_i8(y_at(i), scale_inv);
}

// ---------------------------------------------------- quantise fp32 rows
// y (rows, groups·width) fp32; one warp per (row, group): dynamic writes
// a[row·groups + group] = max(absmax / 127, 1e-12) and the int8 of
// y·(1/a); static quantises with inv[0].
template <bool STATIC>
__global__ void quant_rows_kernel(const float* __restrict__ y,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ a,
                                  const float* __restrict__ inv, int rows,
                                  int width, int groups) {
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= rows * groups) return;
  const size_t base = static_cast<size_t>(wid) * width;  // row-major groups
  float scale_inv;
  if constexpr (STATIC) {
    scale_inv = inv[0];
  } else {
    float m = 0.f;
    for (int i = lane; i < width; i += 32) m = fmaxf(m, fabsf(y[base + i]));
    const float ar = row_scale_of(warp_max(m));
    if (lane == 0) a[wid] = ar;
    scale_inv = __fdiv_rn(1.f, ar);
  }
  for (int i = lane; i < width; i += 32)
    q[base + i] = quant_i8(y[base + i], scale_inv);
}

// ------------------------------------------------ int8 GEMM (WMMA s8)
// out (m, n) = epilogue(Σ_g (A (m, k) @ B (k, n))_g · row_scale[r, g] ·
// col_scale[n] + bias), row-major, A and B int8.  K is cut into groups of
// `group` (a multiple of QBK): the int32 fragments are flushed into fp32
// registers at each group's end.  row_scale (m, groups) is null for the
// static kernels.  A 64x64 output tile per block of 4 warps, each warp a
// 32x32 quadrant of 2x2 16x16x16 fragments.  The tiles sit in shared
// memory as 16-byte-wide planes (A by 16 k-columns, B by 16 n-columns) so
// that every fragment starts 256-bit aligned with a 16-byte stride.  k and
// n are multiples of 64 (the wrapper checks); ragged m is zero-filled on
// load and masked on store.
constexpr int QBM = 64, QBN = 64, QBK = 64, QTHREADS = 128;
constexpr int QLDC = QBN + 4;
constexpr int QPER = QBM * QBN / QTHREADS;  // fp32 accumulators per thread

template <typename T, int EPI>
__global__ void __launch_bounds__(QTHREADS)
gemm_s8_wmma(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
             const float* __restrict__ row_scale, int groups,
             const float* __restrict__ col_scale,
             const float* __restrict__ bias, const T* __restrict__ resid,
             const float* __restrict__ inv, void* __restrict__ out, int m,
             int n, int k, int group) {
  using namespace nvcuda;
  __shared__ __align__(128) int8_t As[QBK / 16][QBM * 16];
  __shared__ __align__(128) int8_t Bs[QBN / 16][QBK * 16];
  __shared__ __align__(128) int Cs[QBM * QLDC];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * QBM, col0 = blockIdx.x * QBN;

  float facc[QPER];
#pragma unroll
  for (int i = 0; i < QPER; ++i) facc[i] = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < k; k0 += QBK) {
    // 16-byte vectors: A row r, k-plane p; B k-row r, n-plane p
    for (int v = tid; v < QBM * QBK / 16; v += QTHREADS) {
      const int r = v >> 2, p = v & 3;
      const int gr = row0 + r;
      int4 val = make_int4(0, 0, 0, 0);
      if (gr < m)
        val = *reinterpret_cast<const int4*>(
            A + static_cast<size_t>(gr) * k + k0 + 16 * p);
      *reinterpret_cast<int4*>(&As[p][r * 16]) = val;
    }
    for (int v = tid; v < QBK * QBN / 16; v += QTHREADS) {
      const int r = v >> 2, p = v & 3;
      *reinterpret_cast<int4*>(&Bs[p][r * 16]) =
          *reinterpret_cast<const int4*>(
              B + static_cast<size_t>(k0 + r) * n + col0 + 16 * p);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[kk][(wm * 32 + i * 16) * 16], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[wn * 2 + j][kk * 16 * 16], 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if ((k0 + QBK) % group == 0) {
      // end of a K group: fp32 += (acc·a[r, g])·s[col], then restart
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(
              Cs + (wm * 32 + i * 16) * QLDC + wn * 32 + j * 16, acc[i][j],
              QLDC, wmma::mem_row_major);
      __syncthreads();
      const int gi = (k0 + QBK) / group - 1;
#pragma unroll
      for (int i = 0; i < QPER; ++i) {
        const int e = tid + i * QTHREADS;
        const int r = e / QBN, c = e % QBN, gr = row0 + r;
        float v = static_cast<float>(Cs[r * QLDC + c]);
        if (row_scale != nullptr)
          v = __fmul_rn(
              v, gr < m ? row_scale[static_cast<size_t>(gr) * groups + gi]
                        : 0.f);
        facc[i] = __fadd_rn(facc[i], __fmul_rn(v, col_scale[col0 + c]));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
    }
  }

#pragma unroll
  for (int i = 0; i < QPER; ++i) {
    const int e = tid + i * QTHREADS;
    const int r = e / QBN, c = e % QBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= m) continue;
    const size_t o = static_cast<size_t>(gr) * n + gc;
    const float v = __fadd_rn(facc[i], bias[gc]);
    if constexpr (EPI == QEPI_OUT) {
      static_cast<T*>(out)[o] = from_f<T>(v);
    } else if constexpr (EPI == QEPI_RESID) {
      // x + o with o rounded to the compute dtype first, as the TPU kernel
      static_cast<T*>(out)[o] =
          from_f<T>(__fadd_rn(to_f(resid[o]), to_f(from_f<T>(v))));
    } else if constexpr (EPI == QEPI_GELU_F32) {
      static_cast<float*>(out)[o] = gelu_erf(v);
    } else {
      static_cast<int8_t*>(out)[o] = quant_i8(gelu_erf(v), inv[0]);
    }
  }
}

template <typename T>
void launch_gemm_s8(int epi, const void* a, const void* b,
                    const float* row_scale, int groups,
                    const float* col_scale, const float* bias,
                    const void* resid, const float* inv, void* out, int m,
                    int n, int k, int group, cudaStream_t s) {
  dim3 grid(n / QBN, cdiv(m, QBM));
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const T* R = static_cast<const T*>(resid);
  switch (epi) {
#define DFU_Q8_CASE(E)                                                       \
    case E:                                                                  \
      gemm_s8_wmma<T, E><<<grid, QTHREADS, 0, s>>>(                          \
          A, B, row_scale, groups, col_scale, bias, R, inv, out, m, n, k,    \
          group);                                                            \
      break;
    DFU_Q8_CASE(QEPI_OUT)
    DFU_Q8_CASE(QEPI_RESID)
    DFU_Q8_CASE(QEPI_GELU_F32)
    DFU_Q8_CASE(QEPI_GELU_Q8)
#undef DFU_Q8_CASE
  }
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (rows, c) in the compute dtype, g/b (c) fp32 -> q (rows, c) int8 and,
// when a is not null, a (rows) fp32 (dynamic); else quantised with inv[0].
int dfu_q8_ln_quant(int device, int dtype, const void* x, const void* g,
                    const void* b, void* q, void* a, const void* inv,
                    int rows, int c, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = cdiv(rows, threads / 32);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  int8_t* qi = static_cast<int8_t*>(q);
  float* af = static_cast<float*>(a);
  const float* iv = static_cast<const float*>(inv);
#define DFU_LNQ(T, ST)                                                     \
  ln_quant_kernel<T, ST><<<blocks, threads, 0, s>>>(                       \
      static_cast<const T*>(x), gf, bf, qi, af, iv, rows, c, eps)
  if (dtype == DT_BF16) {
    if (a == nullptr) DFU_LNQ(bf16, true); else DFU_LNQ(bf16, false);
  } else {
    if (a == nullptr) DFU_LNQ(float, true); else DFU_LNQ(float, false);
  }
#undef DFU_LNQ
  DFU_RETURN_LAST_ERROR();
}

// y (rows, groups·width) fp32 -> q int8 of the same shape and, when a is
// not null, a (rows, groups) fp32; else quantised with inv[0].
int dfu_q8_quant_rows(int device, const void* y, void* q, void* a,
                      const void* inv, int rows, int width, int groups,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = cdiv(rows * groups, threads / 32);
  if (a == nullptr)
    quant_rows_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(y), static_cast<int8_t*>(q), nullptr,
        static_cast<const float*>(inv), rows, width, groups);
  else
    quant_rows_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(y), static_cast<int8_t*>(q),
        static_cast<float*>(a), nullptr, rows, width, groups);
  DFU_RETURN_LAST_ERROR();
}

// out (m, n) = epilogue(int8 a (m, k) @ int8 b (k, n)) dequantised per
// K group (see gemm_s8_wmma).  epi is a QEpilogue; row_scale (m, groups)
// fp32 or null; col_scale, bias (n) fp32; resid (m, n) in the compute
// dtype for QEPI_RESID; inv (1) fp32 for QEPI_GELU_Q8; out in the compute
// dtype (QEPI_OUT, QEPI_RESID), fp32 (QEPI_GELU_F32) or int8
// (QEPI_GELU_Q8).  k, n and group multiples of 64, group dividing k.
int dfu_q8_gemm(int device, int dtype, int epi, const void* a, const void* b,
                const void* row_scale, int groups, const void* col_scale,
                const void* bias, const void* resid, const void* inv,
                void* out, int m, int n, int k, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (epi < QEPI_OUT || epi > QEPI_GELU_Q8 || n % QBN || k % QBK ||
      group % QBK || k % group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(row_scale);
  const float* cs = static_cast<const float*>(col_scale);
  const float* bs = static_cast<const float*>(bias);
  const float* iv = static_cast<const float*>(inv);
  if (dtype == DT_BF16)
    launch_gemm_s8<bf16>(epi, a, b, rs, groups, cs, bs, resid, iv, out, m, n,
                         k, group, s);
  else
    launch_gemm_s8<float>(epi, a, b, rs, groups, cs, bs, resid, iv, out, m,
                          n, k, group, s);
  DFU_RETURN_LAST_ERROR();
}

// qkv (batch, n, 3·heads·d) in the compute dtype -> out (batch, n,
// heads·d) fp32; d in {16, 32, 64, 128}.
int dfu_q8_attention(int device, int dtype, const void* qkv, void* out,
                     int batch, int n, int heads, int d, float scale,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return dispatch_attention<bf16, float>(d, qkv, out, batch, n, heads,
                                           scale, s);
  return dispatch_attention<float, float>(d, qkv, out, batch, n, heads, scale,
                                          s);
}

}  // extern "C"
