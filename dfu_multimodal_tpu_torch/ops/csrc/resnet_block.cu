// Fused stride-1 ResNet bottleneck for Hopper (sm_90a), forward only.
//
// Replaces: dfu_multimodal_tpu/ops/resnet_block.py::_bottleneck_kernel
//   and ::_bottleneck_proj_kernel (K11): with BatchNorm folded into the
//   convolutions outside the kernel,
//     out = relu(sc + T(conv3(relu(conv3x3(relu(conv1 x)))) + b3))
//   where sc is x (identity) or T(x @ wd + bd) (the 1x1 projection of
//   stage 1 block 0).  Activations are image-major NHWC rows (B·H·W, C).
//
// What bounds it on the H100: ResNet-50's stride-1 bottlenecks at the
//   serving batch (8 images, bf16) do 3.5-3.7 GFLOP each against 9-26 MB
//   of x, output and weights: 3.5-7.7 us at the card's peaks, bytes-bound
//   at 56x56 and 28x28 and 7x7, operation-bound at 14x14
//   (chip_smoke.py::kernel_bounds).  The three products are small (K = 64
//   to 2048, N = 64 to 2048), and at 7x7 only 392 rows (7 row tiles) are
//   there to spread over 132 SMs.
//
// What the design does about it: the TPU kernel keeps one image's rows in
//   VMEM and builds the 3x3 from sublane rolls plus masks.  Here the 3x3 is
//   an implicit GEMM (gemm_tile.cuh::Conv3x3A): M = B·H·W rows, N = Cmid,
//   K = 9·Cmid, the A tile gathered tap by tap from y1 with the neighbour
//   masked when it falls outside its own image, so no im2col buffer is
//   written.  Each block is a short chain of launches of the port's hand
//   GEMM tile (WMMA bf16 / SIMT fp32, fp32 accumulation) with fused
//   epilogues: conv1 + bias + ReLU -> y1, 3x3 + bias + ReLU -> y2,
//   [projection + bias -> sc], conv3 + bias rounded to the compute dtype,
//   + shortcut in the compute dtype, ReLU -> out.  y1, y2 (and sc) go
//   through device memory: 2·rows·Cmid·2 bytes each way (plus rows·Cout·2
//   for sc) beyond the bound's x and out, ~2x the bound's bytes at 56x56.
//   Keeping y1 (a spatial tile plus a one-row halo) and y2 in shared
//   memory, pipelined loads (TMA + wgmma) and split-K for the 7x7 stage
//   are the next speed work.
//
// Numerics follow the Pallas kernel: operands in the compute dtype, fp32
// accumulation, y1 and y2 rounded to the compute dtype after bias and
// ReLU, y3 rounded after its bias, the residual add and the final ReLU in
// the compute dtype.

#include "common.cuh"
#include "gemm_tile.cuh"

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (rows, cin) and out (rows, cout) in the compute dtype, rows = B·h·w
// image-major; w1 (cin, cmid), w2 (9·cmid, cmid) row-stacked 3x3 taps
// ((dy, dx) row-major), w3 (cmid, cout) in the compute dtype; b1, b2 (cmid)
// and b3 (cout) fp32.  Projection: wd (cin, cout) and bd (cout) with the
// scratch sc (rows, cout); identity (cin == cout): wd, bd and sc null.
// Scratch y1, y2 (rows, cmid) in the compute dtype.
int dfu_bottleneck(int device, int dtype, const void* x, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* w3, const void* b3, const void* wd,
                   const void* bd, void* y1, void* y2, void* sc, void* out,
                   int rows, int h, int w, int cin, int cmid, int cout,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_gemm<EPI_BIAS_RELU, false, DenseA>(
      dtype, x, w1, static_cast<const float*>(b1), nullptr, y1, rows, cmid,
      cin, s, cin);
  launch_gemm<EPI_BIAS_RELU, false, Conv3x3A>(
      dtype, y1, w2, static_cast<const float*>(b2), nullptr, y2, rows, cmid,
      9 * cmid, s, cmid, h, w);
  const void* shortcut = x;
  if (wd != nullptr) {
    launch_gemm<EPI_BIAS, false, DenseA>(
        dtype, x, wd, static_cast<const float*>(bd), nullptr, sc, rows, cout,
        cin, s, cin);
    shortcut = sc;
  }
  launch_gemm<EPI_BIAS_RESID_RELU, false, DenseA>(
      dtype, y2, w3, static_cast<const float*>(b3),
      const_cast<void*>(shortcut), out, rows, cout, cmid, s, cmid);
  DFU_RETURN_LAST_ERROR();
}

}  // extern "C"
