// ViT encoder-block kernels for Hopper (sm_90a): forward and backward.
//
// Replaces: dfu_multimodal_tpu/ops/vit_block.py::_attn_block_kernel (K1,
//   x + proj(MHA(qkv(LN1(x))))), ::_mlp_block_kernel (K2,
//   x + fc2(GELU(fc1(LN2(x))))) and ::_mlp_block_bwd_kernel (K4: LN2/fc1
//   recompute, dGELU, dx with the LN backward, y/h/dhpre for the weight
//   gradients, dg2/db2), the Pallas kernels of the fused ViT-B/16 encoder.
//   The attention-block backward chain rule (vit_block.py::_attn_block_bwd)
//   also runs its LayerNorm, data products and LN backward on these
//   kernels; the one-kernel attention-block backward K10 has its own entry
//   in attn_block_bwd.cu over the same LayerNorm (layernorm.cuh) and GEMMs
//   (gemm_sm90.cuh in bf16, gemm_tile.cuh's SIMT tile in fp32).
//
// What bounds it on the H100: at the serving batch (8 images, 1576 token
//   rows) each forward block reads 14 MB of bf16 weights for ~22 GFLOP,
//   so the GEMMs sit near the ~295 FLOP/byte ridge and the launches are
//   short; at batch 128 the GEMMs are tensor-core bound (~350 GFLOP per
//   block).  K4 at the training batch (16 images, 3152 rows) is three
//   GEMMs of 14.9 GFLOP each (44.6 GFLOP) against 68 MB of operands and
//   outputs: operation-bound (45 us at the bf16 peak).  Attention is
//   2·N²·D per head and small next to the projections (N = 197 is
//   ragged, D = 64).
//
// What the design does about it: the TPU kernels keep one image's (or
//   128 rows') whole block in VMEM and carry sums across a sequential
//   grid.  A Hopper SM has 227 KB of shared memory and blocks run in
//   parallel in no order, so each TPU kernel becomes a chain of launches
//   that each fill the card: a warp-per-row fp32 LayerNorm
//   (layernorm.cuh); in bf16 the products on gemm_sm90.cuh's persistent
//   TMA + wgmma GEMM, whose epilogue adds the bias and applies exact-erf
//   GELU or the residual (K1: qkv, proj; K2: fc1, fc2; K4: fc1 and dh as
//   one dual product whose fp32 pre-activation stays in registers, then
//   dy), and K1's attention step on the tensor cores
//   (attention_fwd_mma.cuh with the deferred division: mma.sync over
//   64-key cp.async tiles of the packed qkv, two passes); in fp32 the
//   products on gemm_tile.cuh's SIMT tile (B read as stored or
//   transposed, so dh = g·w2ᵀ and dy = dhpre·w1ᵀ need no copy of the
//   weights; K4's epilogues keep the fp32 pre-activation and apply the
//   exact dGELU) and K1's attention on attention_core.cuh, which holds
//   one head's K and V in shared memory (or, past ~420 tokens at D = 64,
//   streams them in key tiles) with an exact two-pass fp32 softmax.  K4's
//   dg2/db2, a sum over all rows that the TPU grid accumulated in order,
//   becomes per-64-row column partials in a (blocks, C) fp32 buffer
//   reduced by a second pass: deterministic, no atomics.  The ragged row
//   edge (3152 rows) is masked in every kernel, so nothing is padded.
//   The qkv, attention output and MLP hidden intermediates of K1/K2 go
//   through HBM, and LayerNorm is its own launch; fusing LN into the
//   products' A loads is later work.
//
// Numerics follow the Pallas kernels: fp32 LayerNorm statistics, matmul
// operands in the compute dtype with fp32 accumulation, q·kᵀ scaled by
// 1/sqrt(D) in fp32, softmax statistics in fp32, the un-normalised exp
// matrix rounded to the compute dtype as the P·V operand and the division
// by the fp32 row sum deferred past P·V.  GELU is the exact erf form, and
// its derivative Φ(x) + x·φ(x) (the Pallas kernels' logistic approximation
// exists only because Mosaic cannot lower erf).

#include "attention_core.cuh"
#include "attention_kernels.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_sm90_single.cuh"
#include "gemm_tile.cuh"
#include "layernorm.cuh"

#include <chrono>

namespace dfu {
namespace {
namespace sm90 {

// K4's bf16 products: (y, g) -> h, dhpre (the dual product), then
// dy = dhpre·w1ᵀ in fp32.  y, g (rows, c); w1 (c, hidden); w2 (hidden, c);
// b1 (hidden) fp32; h, dhpre (rows, hidden) bf16; dy (rows, c) fp32.  All
// bases 16-byte aligned, c and hidden multiples of 8.
inline cudaError_t mlp_bwd_products(const void* y, const void* g,
                                    const void* w1, const float* b1,
                                    const void* w2, void* h, void* dhpre,
                                    float* dy, int rows, int c, int hidden,
                                    int device, cudaStream_t s) {
  if (rows < 1 || c < 8 || hidden < 8 || c % 8 || hidden % 8)
    return cudaErrorInvalidValue;
  Args dual{};
  cudaError_t err = encode(&dual.a1, y, rows, c, BM);
  if (err == cudaSuccess) err = encode(&dual.b1, w1, c, hidden, BK);
  if (err == cudaSuccess) err = encode(&dual.a2, g, rows, c, BM);
  if (err == cudaSuccess) err = encode(&dual.b2, w2, hidden, c, 128);
  if (err == cudaSuccess) err = encode(&dual.o1, h, rows, hidden, 64);
  if (err == cudaSuccess) err = encode(&dual.o2, dhpre, rows, hidden, 64);
  if (err != cudaSuccess) return err;
  dual.bias = b1;
  dual.m = rows;
  dual.n = hidden;
  dual.k = c;
  err = launch<128, DUAL>(dual, device, s);
  if (err != cudaSuccess) return err;
  Args dyp{};
  err = encode(&dyp.a1, dhpre, rows, hidden, BM);
  if (err == cudaSuccess) err = encode(&dyp.b1, w1, c, hidden, DY_BN);
  if (err != cudaSuccess) return err;
  dyp.out1 = dy;
  dyp.m = rows;
  dyp.n = c;
  dyp.k = hidden;
  dyp.epi = EPI_F32;
  return launch<DY_BN, B_K>(dyp, device, s);
}

}  // namespace sm90
}  // namespace
}  // namespace dfu

using namespace dfu;

namespace {

// An fp32 product on gemm_tile.cuh's SIMT tile (bf16 runs gemm_sm90.cuh).
template <int EPI>
void launch_simt(int trans_b, const void* a, const void* b,
                 const float* bias, void* aux, void* out, int m, int n, int k,
                 cudaStream_t s) {
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

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: rows x c in the compute dtype; g, b: c fp32.
int dfu_layernorm(int device, int dtype, const void* x, const void* g,
                  const void* b, void* y, int rows, int c, float eps,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    launch_layernorm<bf16>(x, g, b, y, rows, c, eps, s);
  else
    launch_layernorm<float>(x, g, b, y, rows, c, eps, s);
  DFU_RETURN_LAST_ERROR();
}

// x, resid, dx: rows x c in the compute dtype; dy: rows x c fp32; gamma,
// dgamma, dbeta: c fp32; scratch stats (2, rows) and partial
// (2, ceil(rows / 64), c) fp32.  See layernorm_bwd_rows.
int dfu_layernorm_bwd(int device, int dtype, const void* x, const void* resid,
                      const void* dy, const void* gamma, void* dx,
                      void* stats, void* partial, void* dgamma, void* dbeta,
                      int rows, int c, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    launch_layernorm_bwd<bf16>(x, resid, dy, gamma, dx, stats, partial,
                               dgamma, dbeta, rows, c, eps, s);
  else
    launch_layernorm_bwd<float>(x, resid, dy, gamma, dx, stats, partial,
                                dgamma, dbeta, rows, c, eps, s);
  DFU_RETURN_LAST_ERROR();
}

// out (m, n) = epilogue(a (m, k) @ B): B = b (k, n), or b (n, k) read
// transposed when trans_b.  epi is an Epilogue; aux is the residual
// (m, n) in the compute dtype for EPI_BIAS_RESID, the fp32 (m, n)
// pre-activation written by EPI_BIAS_GELU_AUX and read by EPI_DGELU, else
// unused; bias (n) fp32 for epi <= EPI_BIAS_GELU_AUX; out is fp32 for
// EPI_F32, else the compute dtype.  bf16 runs on the TMA + wgmma GEMM
// (gemm_sm90.cuh: EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID, EPI_NONE,
// EPI_F32; 16-byte-aligned bases, n and k multiples of 8; anything else
// is cudaErrorInvalidValue), fp32 on gemm_tile.cuh's SIMT tile.
int dfu_gemm(int device, int dtype, int epi, int trans_b, const void* a,
             const void* b, const void* bias, void* aux, void* out, int m,
             int n, int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == DT_BF16)
    return static_cast<int>(sm90::gemm(epi, trans_b, 0, a, b, bf, aux, out,
                                       m, n, k, device, s));
  switch (epi) {
#define DFU_GEMM_CASE(E)                                                  \
    case E:                                                               \
      launch_simt<E>(trans_b, a, b, bf, aux, out, m, n, k, s);            \
      break;
    DFU_GEMM_CASE(EPI_BIAS)
    DFU_GEMM_CASE(EPI_BIAS_GELU)
    DFU_GEMM_CASE(EPI_BIAS_RESID)
    DFU_GEMM_CASE(EPI_BIAS_GELU_AUX)
    DFU_GEMM_CASE(EPI_DGELU)
    DFU_GEMM_CASE(EPI_NONE)
    DFU_GEMM_CASE(EPI_F32)
#undef DFU_GEMM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  DFU_RETURN_LAST_ERROR();
}

// dfu_gemm's bf16 product at tile width bn (64, 96, 128 or 192; 0 lets
// gemm_sm90.cuh's pick_bn choose): tools/bench_vit_fwd.py times each.
int dfu_gemm_sm90(int device, int epi, int trans_b, int bn, const void* a,
                  const void* b, const void* bias, const void* aux, void* out,
                  int m, int n, int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::gemm(epi, trans_b, bn, a, b,
                                     static_cast<const float*>(bias), aux,
                                     out, m, n, k, device,
                                     static_cast<cudaStream_t>(stream)));
}

// The tile width dfu_gemm's bf16 product of m rows, n columns and depth k
// takes (gemm_sm90.cuh's pick_bn) into *bn.
int dfu_gemm_sm90_width(int device, int trans_b, int m, int n, int k,
                        int* bn) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bn = sm90::pick_bn(m, n, k, !trans_b, sms);
  return 0;
}

// K4's bf16 products on the TMA + wgmma GEMM (gemm_sm90.cuh): the dual
// product h = bf16(gelu(y·w1 + b1)), dhpre = bf16((g·w2ᵀ)·gelu'(y·w1 + b1))
// in one launch, then dy = dhpre·w1ᵀ (fp32) in a second.  y, g (rows, c),
// w1 (c, hidden), w2 (hidden, c), h, dhpre (rows, hidden) bf16; b1
// (hidden) and dy (rows, c) fp32; bases 16-byte aligned, c and hidden
// multiples of 8 (else cudaErrorInvalidValue).
int dfu_mlp_block_bwd_gemms(int device, const void* y, const void* g,
                            const void* w1, const void* b1, const void* w2,
                            void* h, void* dhpre, void* dy, int rows, int c,
                            int hidden, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sm90::mlp_bwd_products(
      y, g, w1, static_cast<const float*>(b1), w2, h, dhpre,
      static_cast<float*>(dy), rows, c, hidden, device,
      static_cast<cudaStream_t>(stream)));
}

// The host cost of one tensor map of the products above: encodes the map
// of a (rows, cols) bf16 matrix at `base` `iters` times and writes the
// mean nanoseconds to *ns.
int dfu_tensor_map_encode_ns(const void* base, int rows, int cols, int iters,
                             double* ns) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const cudaError_t err = sm90::encode(&map, base, rows, cols, sm90::BM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const std::chrono::duration<double, std::nano> dt =
      std::chrono::steady_clock::now() - t0;
  *ns = dt.count() / (iters > 0 ? iters : 1);
  return 0;
}

// qkv (batch, n, 3·heads·d) -> out (batch, n, heads·d); d in {16,32,64,128}.
// bias: ToMe's fp32 (batch, n) key bias (proportional attention), added to
// every query's score of each key, or null.  bf16 runs the tensor-core
// forward with K1's deferred division (attention_fwd_mma.cuh;
// 16-byte-aligned qkv and out), fp32 the SIMT core of attention_core.cuh.
int dfu_attention(int device, int dtype, const void* qkv, void* out,
                  int batch, int n, int heads, int d, float scale,
                  const void* bias, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(bias);
  if (dtype == DT_BF16) {
    int e2 = 0;     // q is scaled in bf16 when the scale is a power of two
    const int pow2 = frexpf(scale, &e2) == 0.5f;
    return qkv_fwd_deferred<bf16>(qkv, out, batch, n, heads, d, scale, pow2,
                                  kb, s);
  }
  return dispatch_attention<float, float>(d, qkv, out, batch, n, heads,
                                         scale, kb, s);
}

}  // extern "C"
