// The bf16 single product's host launcher on gemm_sm90.cuh's GEMM (its
// B_MN and B_K modes), shared by the ViT blocks and the attention chain
// rule (vit_block.cu) and K10 (attn_block_bwd.cu).  A header of its own:
// a non-template function instantiates every kernel it can launch in
// each file that includes it, and the int8 and ResNet libraries launch
// none of these.
#pragma once

#include "gemm_sm90.cuh"

namespace dfu {
namespace {
namespace sm90 {

// out (m, n) = epilogue(a (m, k) · B) with bf16 operands: B = b (k, n)
// read as stored (MN-major), or b (n, k) read transposed (K-major) when
// trans_b; epi one of EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID (aux the
// (m, n) bf16 residual), EPI_NONE (bf16 out) or EPI_F32 (fp32 out);
// bias (n) fp32.  bn: the tile width, 64, 96, 128 or 192, or 0 for
// pick_bn's.  Bases 16-byte aligned, n and k multiples of 8 (else
// cudaErrorInvalidValue).  Two tensor maps are encoded a call (a, b).
inline cudaError_t gemm(int epi, int trans_b, int bn, const void* a,
                        const void* b, const float* bias, const void* aux,
                        void* out, int m, int n, int k, int device,
                        cudaStream_t s) {
  const bool ok_epi = epi == EPI_BIAS || epi == EPI_BIAS_GELU ||
                      epi == EPI_BIAS_RESID || epi == EPI_NONE ||
                      epi == EPI_F32;
  if (!ok_epi || m < 1 || n < 8 || k < 8 || n % 8 || k % 8)
    return cudaErrorInvalidValue;
  if (bn == 0) {
    int sms = 0;
    const cudaError_t err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    bn = pick_bn(m, n, k, !trans_b, sms);
  }
  if (bn != 64 && bn != 96 && bn != 128 && bn != 192)
    return cudaErrorInvalidValue;
  Args p{};
  cudaError_t err = encode(&p.a1, a, m, k, BM);
  if (err == cudaSuccess)
    err = trans_b ? encode(&p.b1, b, n, k, bn) : encode(&p.b1, b, k, n, BK);
  if (err != cudaSuccess) return err;
  p.bias = bias;
  p.aux = aux;
  p.out1 = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.epi = epi;
  return trans_b ? launch_width<B_K>(bn, p, device, s)
                 : launch_width<B_MN>(bn, p, device, s);
}

}  // namespace sm90
}  // namespace
}  // namespace dfu
