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
//   are operation-bound, and only wgmma reaches the int8 rate.
//
// What the design does about it: the TPU kernels keep two images' (or 384
//   rows') whole block in VMEM.  A Hopper SM has 227 KB of shared memory and
//   blocks run in parallel in no order, so each TPU kernel becomes a chain
//   of launches that each fill the card:
//   - ln_quant: one warp per row, LayerNorm in fp32, the row absmax, int8
//     y_q and the row scale a[r] (or, static, the calibrated 1/s);
//   - the int8 products on gemm_sm90.cuh's persistent TMA + wgmma GEMM
//     (its S8 / S8_GROUPS modes): int8 x int8 -> int32 on wgmma.m64nNk32,
//     A and the weight both K-major (the weight's (out, in) copy, made by
//     the model once per weight version), 128 x BN tiles with BN from
//     pick_bn.  The int32 sum is flushed into an fp32 accumulator at the
//     end of every K group: acc·a[r, g]·s[m] (dynamic) or acc·s_eff[m]
//     (static).  The fc2 product has one group per 768-wide hidden chunk,
//     because each chunk of h was quantised with its own row scale; the
//     other products have one group.  The epilogue adds the bias, then
//     casts to the compute dtype (qkv), adds the residual (proj, fc2),
//     applies exact-erf GELU into fp32 (dynamic fc1) or GELU and the
//     static quantisation into int8 (static fc1);
//   - quant_rows: one warp per (row, group) of an fp32 tensor, the absmax,
//     int8 and the scale (the attention output over C, the GELU output over
//     each 768 chunk), or the static quantisation;
//   - the attention step with an fp32 output: in bf16 the tensor-core
//     forward of attention_fwd_mma.cuh with the softmax division deferred
//     past e·V (the Pallas kernel's _attention_head, as K1's), in fp32 the
//     SIMT core of attention_core.cuh.
//   The int8 activations, the fp32 attention output and the fp32 GELU
//   output go through HBM; fusing them away is later work.
//
// Numerics follow the Pallas kernels and the plain versions in
// ops/vit_block_q8.py operation by operation: round half to even (rintf),
// clip to [-127, 127], a = max(absmax / 127, 1e-12) applied as y·(1/a), the
// dequantisation (acc·a)·s then + bias, the chunk sums added in chunk
// order.  The arithmetic that decides a rounding uses __fmul_rn / __fadd_rn
// so that nvcc cannot contract it into an FMA the plain version does not
// do; the int32 products are exact.  What still differs is the order of the
// LayerNorm and attention sums, the bf16 attention's ex2 exponential, and
// erff's last bit, which can move a value across a rounding boundary (one
// int8 step) now and then.  GELU is exact erf (the Pallas kernels'
// logistic form exists only because Mosaic cannot lower erf).

#include "attention_core.cuh"
#include "attention_kernels.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"

#include <cstdint>

namespace dfu {
namespace {

using sm90::quant_i8;

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

namespace sm90 {

// The tile width gemm_s8 takes for an (m, n, k) product with K groups of
// `group` under epilogue `qepi`: pick_bn_s8's, narrow (at most 128) for
// the grouped product (its two sums spilled at 192) and for the GELU
// epilogues (fc1 ran 1.2-1.35x slower at 192 than at 128 at every row
// count: tools/bench_vit_fwd.py).
inline cudaError_t s8_width(int qepi, int m, int n, int k, int group,
                            int device, int* bn) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const bool narrow =
      group < k || qepi == QEPI_GELU_F32 || qepi == QEPI_GELU_Q8;
  *bn = pick_bn_s8(m, n, narrow, sms);
  return cudaSuccess;
}

// K7/K8's int8 products: out (m, n) = QEpilogue `qepi` of v = Σ_g
// (a_g · b_gᵀ)·row_scale[r, g]·col_scale[n] + bias, a (m, k) int8, b (n,
// k) int8 (the weight's K-major (out, in) copy), the k sums cut into K
// groups of `group` (k / group of them; dynamic row_scale (m, k / group)
// fp32, or null for static scales), each group's int32 sum dequantised
// into fp32 when it ends.  dtype: the compute dtype of QEPI_OUT /
// QEPI_RESID's out and resid; QEPI_GELU_F32's out is fp32 and
// QEPI_GELU_Q8's int8 (scaled by inv[0] first).  col_scale, bias (n)
// fp32.  bn: 64, 96, 128 or 192, or 0 for s8_width's.  Bases 16-byte
// aligned; n a multiple of 8, k and group of 32, group dividing k (else
// cudaErrorInvalidValue).
inline cudaError_t gemm_s8(int qepi, int dtype, int bn, const void* a,
                           const void* b, const float* row_scale,
                           const float* col_scale, const float* bias,
                           const void* resid, const float* inv, void* out,
                           int m, int n, int k, int group, int device,
                           cudaStream_t s) {
  if (qepi < QEPI_OUT || qepi > QEPI_GELU_Q8 ||
      (dtype != DT_F32 && dtype != DT_BF16) || m < 1 || n < 8 || n % 8 ||
      k < 32 || k % 32 || group < 32 || group % 32 || k % group)
    return cudaErrorInvalidValue;
  if (bn == 0) {
    const cudaError_t err = s8_width(qepi, m, n, k, group, device, &bn);
    if (err != cudaSuccess) return err;
  }
  if (bn != 64 && bn != 96 && bn != 128 && bn != 192)
    return cudaErrorInvalidValue;
  Args p{};
  cudaError_t err = encode(&p.a1, a, m, k, BM, 1);
  if (err == cudaSuccess) err = encode(&p.b1, b, n, k, bn, 1);
  if (err != cudaSuccess) return err;
  p.bias = bias;
  p.aux = resid;
  p.out1 = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.epi = qepi;
  p.row_scale = row_scale;
  p.col_scale = col_scale;
  p.inv = inv;
  p.groups = k / group;
  p.group_steps = group / 32;
  p.dtype = dtype;
  return group < k ? launch_width<S8_GROUPS>(bn, p, device, s)
                   : launch_width<S8>(bn, p, device, s);
}

}  // namespace sm90

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

// out (m, n) = epilogue(int8 a (m, k) @ the weight) dequantised per K
// group of `group` (gemm_sm90.cuh's sm90::gemm_s8).  b is the weight's
// K-major (n, k) int8 copy; epi is a QEpilogue; row_scale (m, k / group)
// fp32 or null; col_scale, bias (n) fp32; resid (m, n) in the compute
// dtype for QEPI_RESID; inv (1) fp32 for QEPI_GELU_Q8; out in the compute
// dtype (QEPI_OUT, QEPI_RESID), fp32 (QEPI_GELU_F32) or int8
// (QEPI_GELU_Q8).  bn: the tile width (64, 96, 128, 192) or 0 for the
// launcher's pick.  n a multiple of 8, k and group of 32, group dividing
// k.
int dfu_q8_gemm(int device, int dtype, int epi, const void* a, const void* b,
                const void* row_scale, const void* col_scale,
                const void* bias, const void* resid, const void* inv,
                void* out, int m, int n, int k, int group, int bn,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::gemm_s8(
      epi, dtype, bn, a, b, static_cast<const float*>(row_scale),
      static_cast<const float*>(col_scale), static_cast<const float*>(bias),
      resid, static_cast<const float*>(inv), out, m, n, k, group, device,
      static_cast<cudaStream_t>(stream)));
}

// The tile width dfu_q8_gemm picks for an (m, n, k) product with K groups
// of `group` under epilogue `epi`.
int dfu_q8_gemm_width(int device, int epi, int m, int n, int k, int group,
                      int* bn) {
  return static_cast<int>(sm90::s8_width(epi, m, n, k, group, device, bn));
}

// qkv (batch, n, 3·heads·d) in the compute dtype -> out (batch, n,
// heads·d) fp32; d in {16, 32, 64, 128}; bias: ToMe's fp32 (batch, n) key
// bias, or null.  bf16: the tensor-core forward with the deferred division
// (attention_kernels.cuh::qkv_fwd_deferred); fp32: the SIMT core.
int dfu_q8_attention(int device, int dtype, const void* qkv, void* out,
                     int batch, int n, int heads, int d, float scale,
                     const void* bias, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(bias);
  if (dtype == DT_BF16) {
    int e2 = 0;     // q is scaled in bf16 when the scale is a power of two
    const int pow2 = frexpf(scale, &e2) == 0.5f;
    return qkv_fwd_deferred<bf16, float>(qkv, out, batch, n, heads, d, scale,
                                         pow2, kb, s);
  }
  return dispatch_attention<float, float>(d, qkv, out, batch, n, heads, scale,
                                          kb, s);
}

}  // extern "C"
