// Int8 convolution for Hopper (sm_90a): the int8 ResNet trunk's convs.
//
// Replaces no TPU kernel.  dfu_multimodal_tpu/models/resnet_q8.py::_QConv
//   (:59) is an XLA convolution on int8 operands with int32 sums:
//   xq = clip(round_half_even(x_f32 / act_scale), -127, 127), the int32
//   convolution of xq with the HWIO int8 kernel at stride s and padding
//   kh // 2, then y = T(float(acc)·(act_scale·ws) + bias), T the compute
//   dtype, and the ReLU the Int8Bottleneck applies after it.  PyTorch has
//   no int8 convolution on CUDA, so the port writes one.
//
// What bounds it on the H100: the ResNet-50 trunk at the serving batch (8
//   images, 224²) does 65 GOP of int8 products over its 52 convs, 33 us at
//   1979 TOP/s; its int8 and bf16 activations are ~0.2 GB read and written
//   once, 60 us at 3.35 TB/s.  Most convs are bytes-bound (the 1x1s of the
//   early stages), the 3x3s of the late stages operation-bound.
//
// What the design does about it (a simple first version, two launches a
// conv):
//   - im2col_q8: one thread per 8 channels of one (output pixel, tap):
//     reads 8 activations (16 or 32 bytes) of the NHWC input in the
//     compute dtype, quantises them with a true IEEE division by the
//     static scale (the JAX package divides; no reciprocal), and writes
//     8 int8 of the (B·Ho·Wo, kh·kw·Cin) A operand in column order (tap
//     row-major over (dy, dx), then channel), zeros where the tap lies
//     outside the image; an int8 input (the block input quantised once for
//     conv1 and the projection) is copied, not quantised.  A 1x1 stride-1
//     conv of an int8 input skips it: A is the input itself.  A 3x3 conv
//     reads each input 9 times (through L2) and writes A 9 times the
//     input's int8 size: fusing the gather into the GEMM's producer, as
//     K11's CONV mode does for bf16, is later work;
//   - the product on gemm_sm90.cuh's persistent TMA + wgmma GEMM in its S8
//     mode (wgmma.m64nNk32.s32.s8.s8): A and B K-major, B the kernel's
//     (Cout, kh·kw·Cin) int8 copy (made once per weight version), one K
//     group flushed with row scale 1 and column scale s' = act_scale·ws
//     (fp32, made once per weight version, as :87 multiplies it), so the
//     flush gives float(acc)·s' rounded once, then + bias: JAX's order.
//     The epilogue casts to T (QEPI_OUT), with ReLU (QEPI_OUT_RELU: conv1
//     and conv2), or adds the shortcut and applies ReLU (QEPI_RESID_RELU:
//     conv3, T(max(T(shortcut + T(v)), 0)), the block's relu(x + y)).
//
// Numbers: the int32 sums are exact in any order, the flush and epilogue
// round the same operations in the same order as the plain version
// (ops/conv_q8.py::conv_q8_ref), so the kernel equals it bit for bit.
// TMA needs 16-byte row strides: k = kh·kw·Cin a multiple of 32 (the
// GEMM's k32 step), Cout a multiple of 8, Cin of 8 (the gather's unit);
// ResNet-50's widths meet all three.

#include "common.cuh"
#include "gemm_sm90.cuh"

#include <cstdint>

namespace dfu {
namespace {

constexpr int DT_I8 = 2;  // the gather's int8 input (a pre-quantised one)

__device__ __forceinline__ int8_t quant_div(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

__device__ __forceinline__ uint2 pack8(const float (&v)[8], float s) {
  uint2 out;
  char4* o = reinterpret_cast<char4*>(&out);
  o[0] = make_char4(quant_div(v[0], s), quant_div(v[1], s),
                    quant_div(v[2], s), quant_div(v[3], s));
  o[1] = make_char4(quant_div(v[4], s), quant_div(v[5], s),
                    quant_div(v[6], s), quant_div(v[7], s));
  return out;
}

// 8 int8 of the 8 values at p (16-byte aligned), quantised by s.
__device__ __forceinline__ uint2 quant8(const float* p, float s) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return pack8(v, s);
}

__device__ __forceinline__ uint2 quant8(const bf16* p, float s) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __low2float(h[i]);
    v[2 * i + 1] = __high2float(h[i]);
  }
  return pack8(v, s);
}

__device__ __forceinline__ uint2 quant8(const int8_t* p, float) {
  return *reinterpret_cast<const uint2*>(p);
}

// a (batch·ho·wo, kh·kw·c) int8 from x (batch, h, w, c): item i is the 8
// channels 8·(i % (c / 8)) of tap (i / (c / 8)) % (kh·kw) of output pixel
// i / (kh·kw·c / 8), at a + 8·i.
template <typename T>
__global__ void im2col_q8_kernel(const T* __restrict__ x,
                                 const float* __restrict__ act_scale,
                                 int8_t* __restrict__ a, int batch, int h,
                                 int w, int c, int ho, int wo, int kh, int kw,
                                 int stride, int pad) {
  const int c8 = c / 8, taps = kh * kw;
  const long long total = static_cast<long long>(batch) * ho * wo * taps * c8;
  const float s = act_scale == nullptr ? 1.f : act_scale[0];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int cc = static_cast<int>(i % c8);
    const long long t = i / c8;
    const int tap = static_cast<int>(t % taps);
    const long long pix = t / taps;
    const int ox = static_cast<int>(pix % wo);
    const long long r = pix / wo;
    const int oy = static_cast<int>(r % ho);
    const int b = static_cast<int>(r / ho);
    const int iy = oy * stride - pad + tap / kw;
    const int ix = ox * stride - pad + tap % kw;
    uint2 out = make_uint2(0u, 0u);
    if (iy >= 0 && iy < h && ix >= 0 && ix < w)
      out = quant8(x + ((static_cast<size_t>(b) * h + iy) * w + ix) * c +
                       8 * cc,
                   s);
    *reinterpret_cast<uint2*>(a + 8 * i) = out;
  }
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, h, w, c) NHWC in dtype (DT_F32, DT_BF16, or DT_I8: copied) ->
// a (batch·ho·wo, kh·kw·c) int8, quantised by act_scale[0] (fp32; unused
// for DT_I8).  c a multiple of 8, x 16-byte aligned (8-byte for DT_I8).
int dfu_conv_q8_im2col(int device, int dtype, const void* x,
                       const void* act_scale, void* a, int batch, int h,
                       int w, int c, int ho, int wo, int kh, int kw,
                       int stride, int pad, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 8 || c % 8 || batch < 1 || ho < 1 || wo < 1 || kh < 1 || kw < 1 ||
      stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total =
      static_cast<long long>(batch) * ho * wo * kh * kw * (c / 8);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 32LL * sms ? want : 32LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* ai = static_cast<int8_t*>(a);
  const float* sc = static_cast<const float*>(act_scale);
#define DFU_IM2COL(T)                                                       \
  im2col_q8_kernel<T><<<blocks, threads, 0, s>>>(                           \
      static_cast<const T*>(x), sc, ai, batch, h, w, c, ho, wo, kh, kw,     \
      stride, pad)
  if (dtype == DT_F32) DFU_IM2COL(float);
  else if (dtype == DT_BF16) DFU_IM2COL(bf16);
  else if (dtype == DT_I8) DFU_IM2COL(int8_t);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef DFU_IM2COL
  DFU_RETURN_LAST_ERROR();
}

// out (m, n) = epilogue epi (QEPI_OUT, QEPI_RESID, QEPI_OUT_RELU or
// QEPI_RESID_RELU) of v = float(a · bᵀ)·col_scale + bias: a (m, k) int8, b
// (n, k) int8 (the kernel's K-major copy), col_scale and bias (n) fp32,
// resid and out (m, n) in the compute dtype.  Bases 16-byte aligned, n a
// multiple of 8, k of 32.
int dfu_conv_q8_gemm(int device, int dtype, int epi, const void* a,
                     const void* b, const void* col_scale, const void* bias,
                     const void* resid, void* out, int m, int n, int k,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using namespace sm90;
  const bool resid_epi = epi == QEPI_RESID || epi == QEPI_RESID_RELU;
  if ((epi != QEPI_OUT && epi != QEPI_OUT_RELU && !resid_epi) ||
      (resid_epi && resid == nullptr) ||
      (dtype != DT_F32 && dtype != DT_BF16) || m < 1 || n < 8 || n % 8 ||
      k < 32 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = pick_bn_s8(m, n, false, sms);
  Args p{};
  err = encode(&p.a1, a, m, k, BM, 1);
  if (err == cudaSuccess) err = encode(&p.b1, b, n, k, bn, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias = static_cast<const float*>(bias);
  p.aux = resid;
  p.out1 = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.epi = epi;
  p.row_scale = nullptr;        // static scales: the flush's a is 1
  p.col_scale = static_cast<const float*>(col_scale);
  p.inv = nullptr;
  p.groups = 1;
  p.group_steps = k / 32;
  p.dtype = dtype;
  return static_cast<int>(
      launch_width<S8>(bn, p, device, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
