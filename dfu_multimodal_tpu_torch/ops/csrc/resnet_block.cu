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
//   to 4608, N = 64 to 2048), and at 7x7 only 392 rows (4 row tiles of
//   128) are there to spread over 132 SMs.
//
// What the design does about it: the TPU kernel keeps one image's rows in
//   VMEM and builds the 3x3 from sublane rolls plus masks.  Here each block
//   is a short chain of launches with fused epilogues: conv1 + bias + ReLU
//   -> y1, the 3x3 + bias + ReLU -> y2, [projection + bias -> sc], conv3 +
//   bias rounded to the compute dtype, + shortcut in the compute dtype,
//   ReLU -> out.  In bf16 every product runs on gemm_sm90.cuh's persistent
//   TMA + wgmma GEMM (128-row tiles at pick_bn's widths, or 64 x 64 tiles
//   two blocks an SM where 128-row tiles would leave SMs idle: the 7x7 and
//   14x14 stages at the serving batch; the weights read as stored through
//   wgmma's transpose bit, no copy).  The 3x3 is its CONV mode, an
//   implicit GEMM (M = B·H·W rows, N = Cmid, K = 9·Cmid) read from y1 in
//   place, so no im2col buffer is written: where Cmid % 64 == 0 (every
//   ResNet-50 stage) each 64-deep stage lies inside one tap and its A tile
//   is one TMA box of y1's rows shifted by the tap, the rows whose
//   neighbour lies outside their own image zeroed in the consumers'
//   registers; other Cmid (multiples of 8) are gathered by the producer
//   warpgroup with cp.async (whose issue rate, not the tensor cores, then
//   sets the pace).  A projection block with Cin == Cmid (ResNet-50's)
//   runs conv3 and the shortcut in one launch (PROJ: two accumulators over
//   one k loop), so sc never goes through device memory.  No split-K: the
//   k sums keep the WMMA tile's order.  fp32 (the parity dtype) runs
//   gemm_tile.cuh's SIMT tile, the 3x3 through its Conv3x3A loader.  y1
//   and y2 go through device memory: 2·rows·Cmid·2 bytes each way beyond
//   the bound's x and out; the 3x3 reads y1 nine times, mostly from L2.
//   Keeping y1 (a spatial tile plus a one-row halo) and y2 on chip is the
//   next speed work.
//
// Numerics follow the Pallas kernel: operands in the compute dtype, fp32
// accumulation, y1 and y2 rounded to the compute dtype after bias and
// ReLU, y3 rounded after its bias, the residual add and the final ReLU in
// the compute dtype.  The bf16 k sums run in 16-deep tensor-core steps in
// the flat k order (tap-major for the 3x3), so the stage kernel below,
// which walks the same tiles, equals the chain of K11 calls bit for bit.

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

#include <cooperative_groups.h>

using namespace dfu;

// ------------------------------------------------------ the stage kernel
//
// Replaces: dfu_multimodal_tpu/ops/resnet_block.py::_stage_kernel (K12):
//   the stride-1 identity bottlenecks of one ResNet stage chained in one
//   kernel, x <- relu(x + T(conv3(relu(conv3x3(relu(conv1 x + b1)) + b2))
//   + b3)) for each block, BatchNorm folded by the caller, Cin = Cout = C
//   and each block's own Cmid.  On the TPU the activations between blocks
//   never leave VMEM.
//
// What bounds it on the H100: ResNet-50's stage tails at the serving batch
//   (8 images, bf16) do 3.49 GFLOP per block against one read of x, one
//   write of the output and each block's weights: 7.8 us at 56x56 (bytes),
//   10.6, 17.7 and 7.1 us at 28x28, 14x14 and 7x7 (operations;
//   chip_smoke.py::kernel_bounds).
//
// What the design does about it: one SM holds 227 KB of shared memory and
//   one 56x56x256 bf16 image is 1.6 MB, so the TPU's whole-image blocks do
//   not carry over.  This is one persistent cooperative launch per stage:
//   a grid no larger than the card can hold at once walks block by block
//   through three phases, conv1 + bias + ReLU -> y1, the 3x3 implicit GEMM
//   + bias + ReLU -> y2, conv3 + bias + residual + ReLU -> the next
//   activation, with a grid-wide barrier between phases (3n - 1 in all):
//   the 3x3 reads neighbouring rows of y1, conv3 all of y2's columns and
//   the next conv1 all of the activation's.  In bf16 each phase walks
//   gemm_sm90.cuh's tile body, the warp-specialised TMA + wgmma GEMM that
//   K11 launches (B_MN for conv1 and conv3, CONV for the 3x3), at K11's
//   tile shape for the stage's 3x3 (128 rows at pick_bn's width, or 64 x
//   64 two blocks an SM where 128-row tiles leave SMs idle), so the
//   stage equals the chain of K11 calls bit for bit.  The ring of stages
//   and its barriers live across the phases: a block's stage index and
//   parity carry on from one phase into the next.  Every tensor map (each
//   block's three weights and its y1 / y2 views, the three activation
//   buffers) is encoded on the host and travels in the kernel's parameter
//   space.  The epilogues write with generic stores and the next phase
//   reads by TMA (the async proxy) on other SMs, so each thread fences
//   the async proxy on both sides of the barrier.  fp32 (the parity
//   dtype) walks gemm_tile.cuh's SIMT tiles.  y1, y2 and a second
//   activation buffer are scratch that the wrapper allocates; at the
//   serving batch they fit the 50 MB L2 (stage 1: 12.8 MB per activation,
//   3.2 MB each for y1 and y2), so the barrier takes the place of a launch
//   gap and most inter-block traffic stays in L2.  Tiles plus a halo kept
//   in shared memory, or clusters with distributed shared memory, are the
//   next speed work.
//
// Block k reads its input (x for k = 0) and writes the other buffer; the
// caller's x is never written, and the order is chosen so that the last
// block writes out.

namespace dfu {
namespace {

namespace cg = cooperative_groups;

// the most blocks one launch takes (ResNet-152's stage 3 has 35 identity
// blocks): the weight pointers travel in the kernel's parameter space
constexpr int kMaxStageBlocks = 40;

// The fp32 stage kernel's operands (pointers; bf16: sm90::StageArgs).
struct StageParams {
  const void* x;
  void* out;
  void* buf;          // the second activation buffer (rows, c); n >= 2
  void* y1;           // (rows, max cmid) scratch, the compute dtype
  void* y2;
  const void* w[kMaxStageBlocks][3];     // w1 (c, cmid), w2 (9·cmid,
  const float* b[kMaxStageBlocks][3];    // cmid), w3 (cmid, c); b1, b2, b3
  int cmid[kMaxStageBlocks];
  int nblocks, rows, h, w_img, c;
};

// The tiles of one fp32 phase, out (m, n) = epilogue(A @ B): block i of
// the grid computes tiles i, i + gridDim.x, ... (row-major over the tile
// grid), then synchronises so that the next tile may reuse its buffers.
template <int EPI, typename ALoad>
__device__ __forceinline__ void phase_tiles(ALoad A, const float* B,
                                            const float* bias, void* aux,
                                            void* out, int m, int n, int k,
                                            SimtSmem& sm) {
  const int tn = (n + SBN - 1) / SBN, tiles = tn * ((m + SBM - 1) / SBM);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    gemm_f32_tile<EPI, false>(A, B, bias, aux, out, m, n, k,
                              (t / tn) * SBM, (t % tn) * SBN, sm.As, sm.Bs);
    __syncthreads();
  }
}

// __grid_constant__: the blocks' tables are indexed at run time, read in
// the parameter space where they arrive, not copied per thread.
__global__ void __launch_bounds__(STHREADS)
stage_f32_simt(const __grid_constant__ StageParams p) {
  __shared__ SimtSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int rows = p.rows, c = p.c;
  float* y1 = static_cast<float*>(p.y1);
  float* y2 = static_cast<float*>(p.y2);
  const float* cur = static_cast<const float*>(p.x);
  for (int blk = 0; blk < p.nblocks; ++blk) {
    const int cmid = p.cmid[blk];
    float* nxt = static_cast<float*>(((p.nblocks - 1 - blk) % 2 == 0)
                                         ? p.out
                                         : p.buf);
    phase_tiles<EPI_BIAS_RELU>(DenseA<float>{cur, rows, c},
                               static_cast<const float*>(p.w[blk][0]),
                               p.b[blk][0], nullptr, y1, rows, cmid, c, sm);
    grid.sync();
    phase_tiles<EPI_BIAS_RELU>(Conv3x3A<float>{y1, rows, cmid, p.h, p.w_img},
                               static_cast<const float*>(p.w[blk][1]),
                               p.b[blk][1], nullptr, y2, rows, cmid,
                               9 * cmid, sm);
    grid.sync();
    phase_tiles<EPI_BIAS_RESID_RELU>(DenseA<float>{y2, rows, cmid},
                                     static_cast<const float*>(p.w[blk][2]),
                                     p.b[blk][2], const_cast<float*>(cur),
                                     nxt, rows, c, cmid, sm);
    if (blk + 1 < p.nblocks) grid.sync();
    cur = nxt;
  }
}

}  // namespace
}  // namespace dfu

// ------------------------------------------------------- the bottleneck

namespace dfu {
namespace {
namespace sm90 {

// One bf16 product of the bottleneck on the TMA + wgmma GEMM: out (m, n) =
// epilogue `epi` (EPI_BIAS, EPI_BIAS_RELU, EPI_BIAS_RESID_RELU with aux the
// (m, n) shortcut) of a (m, k) · b, b (k, n) read as stored (MN-major);
// with conv_h > 0 the 3x3's implicit GEMM over a = y (m, k / 9) of conv_h x
// conv_w images.  Bases 16-byte aligned, n and k multiples of 8.
inline cudaError_t product(int epi, const void* a, const void* b,
                           const float* bias, const void* aux, void* out,
                           int m, int n, int k, int device, cudaStream_t s,
                           int conv_h = 0, int conv_w = 0) {
  if (m < 1 || n < 8 || k < 8 || n % 8 || k % 8)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  // 64 x 64 tiles, two blocks an SM, where even 128 x 64 tiles leave SMs
  // idle (the 7x7 and 14x14 stages at the serving batch); else pick_bn's
  const bool small = cdiv(m, BM) * cdiv(n, 64) < sms;
  const int rows = small ? 64 : BM;
  const int bn = small ? 64 : pick_bn(m, n, k, true, sms);
  Args p{};
  // the 3x3's A by TMA when every 64-deep stage lies inside one tap
  const int tma_a = conv_h == 0 || (k / 9) % BK == 0;
  err = encode(&p.b1, b, k, n, BK);
  if (err == cudaSuccess && tma_a)
    err = encode(&p.a1, a, m, conv_h == 0 ? k : k / 9, rows);
  if (err != cudaSuccess) return err;
  p.bias = bias;
  p.aux = aux;
  p.out1 = out;
  p.m = m;
  p.n = n;
  p.k = k;
  p.epi = epi;
  if (conv_h == 0)
    return small ? launch<64, B_MN, 64>(p, device, s)
                 : launch_width<B_MN>(bn, p, device, s);
  p.conv_y = static_cast<const bf16*>(a);
  p.conv_c = k / 9;
  p.conv_h = conv_h;
  p.conv_w = conv_w;
  p.conv_tma = tma_a;
  return small ? launch<64, CONV, 64>(p, device, s)
               : launch_width<CONV>(bn, p, device, s);
}

// K11's conv3 with its projection shortcut in one launch (PROJ, 128 x 128
// tiles): out (m, n) = T(max(T(x·wd + bd) + T(y2·w3 + b3), 0)), y2 (m, k)
// and x (m, k) (Cmid == Cin == k), w3 and wd (k, n) read as stored.
inline cudaError_t conv3_proj(const void* y2, const void* w3,
                              const float* b3, const void* x, const void* wd,
                              const float* bd, void* out, int m, int n, int k,
                              int device, cudaStream_t s) {
  if (m < 1 || n < 8 || k < 8 || n % 8 || k % 8) return cudaErrorInvalidValue;
  Args p{};
  cudaError_t err = encode(&p.a1, y2, m, k, BM);
  if (err == cudaSuccess) err = encode(&p.b1, w3, k, n, BK);
  if (err == cudaSuccess) err = encode(&p.a2, x, m, k, BM);
  if (err == cudaSuccess) err = encode(&p.b2, wd, k, n, BK);
  if (err != cudaSuccess) return err;
  p.bias = b3;
  p.bias2 = bd;
  p.out1 = out;
  p.m = m;
  p.n = n;
  p.k = k;
  return launch<128, PROJ>(p, device, s);
}


// ------------------------------------------------- the bf16 stage kernel

// One bf16 stage launch's operands: every tensor map the phases read, in
// the kernel's parameter space where TMA takes them (three a block and
// two views of the scratch: 27 KB at kMaxStageBlocks, under the 32 KB of
// parameters sm_90 takes since CUDA 12.1), and the pointers the
// epilogues read and write.
struct StageArgs {
  CUtensorMap act[3];                   // x, buf, out (rows, c): RM rows
  CUtensorMap w1[kMaxStageBlocks];      // (c, cmid), 64-row boxes
  CUtensorMap w2[kMaxStageBlocks];      // (9·cmid, cmid)
  CUtensorMap w3[kMaxStageBlocks];      // (cmid, c)
  CUtensorMap y1[kMaxStageBlocks];      // (rows, cmid) views: RM rows
  CUtensorMap y2[kMaxStageBlocks];
  const float* b[kMaxStageBlocks][3];   // b1, b2, b3
  void* act_ptr[3];
  bf16* y1_ptr;
  bf16* y2_ptr;
  int cmid[kMaxStageBlocks];
  int nblocks, rows, h, w, c;
  int gather;        // some block's Cmid % 64 != 0: its 3x3 gathers A
};
static_assert(sizeof(StageArgs) <= 32764, "kernel parameter space");

// The barrier between two phases, over the whole grid: every thread of
// every block, the producer warpgroup's included, so no TMA load of the
// next phase is issued before it.  The epilogues wrote the phase's
// outputs with generic stores and the next phase reads them by TMA (the
// async proxy) on other SMs: each thread fences the async proxy before
// the grid's release / acquire, and after it.
__device__ __forceinline__ void grid_barrier() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cg::this_grid().sync();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One phase of the stage: this block's tiles of a MODE product (B_MN or
// CONV) on the ring from its `used`-th stage on; returns the stages the
// block has used after it (every thread counts them, so the producer
// threads that issue no load of a phase stay in step).
template <int BN, int MODE, int RM>
__device__ __forceinline__ int stage_phase(const Scalars& q, const Maps& mp,
                                           const void* smem, bool producer,
                                           int used, int extra) {
  using T = Tile<BN, MODE, RM>;
  const Ring<T> r(smem);
  const int stage = used % T::STAGES;
  const uint32_t phase = (used / T::STAGES) & 1;
  if (producer)
    produce<BN, MODE, RM>(q, mp, r, stage, phase, extra);
  else
    consume<BN, MODE, RM>(q, mp, r, stage, phase);
  // the producer warp whose lane 0 issued the loads reconverges before
  // the grid barrier
  __syncwarp();
  return used + Walk<BN, MODE, RM>(q).stages(q);
}

// K12 in bf16: the blocks' three phases on gemm_sm90.cuh's tile body, RM
// x BN tiles, one ring shared by the B_MN and CONV phases.  A full
// barrier counts 129 arrivals a stage where a 3x3 gathers (its 128
// gathering threads and the expect_tx; the TMA phases' producer then
// arrives 128 times more), else 1.
template <int BN, int RM>
__global__ void __launch_bounds__(Tile<BN, CONV, RM>::THREADS,
                                  Tile<BN, CONV, RM>::BLOCKS_PER_SM)
stage_kernel(const __grid_constant__ StageArgs s) {
  using T = Tile<BN, CONV, RM>;
  using D = Tile<BN, B_MN, RM>;
  static_assert(T::STAGE == D::STAGE && T::STAGES == D::STAGES &&
                    T::EPI_WG == D::EPI_WG && T::SMEM == D::SMEM,
                "one ring for both modes");
  extern __shared__ uint8_t smem_raw[];
  Ring<T>(smem_raw).init(s.gather ? 129 : 1);
  const bool producer = threadIdx.x >> 7 == T::GROUPS;
  if (producer)
    setmaxnreg_dec<T::PRODUCER_REGS>();
  else
    setmaxnreg_inc<T::CONSUMER_REGS>();
  const int extra = s.gather ? 128 : 0;
  int used = 0, cur = 0;           // ring stages used; cur's act index
  for (int blk = 0; blk < s.nblocks; ++blk) {
    const int cmid = s.cmid[blk];
    const int nxt = (s.nblocks - 1 - blk) % 2 == 0 ? 2 : 1;
    Scalars q{};                   // conv1 + bias + ReLU -> y1
    q.m = s.rows;
    q.n = cmid;
    q.k = s.c;
    q.epi = EPI_BIAS_RELU;
    q.bias = s.b[blk][0];
    q.out1 = s.y1_ptr;
    used = stage_phase<BN, B_MN, RM>(q, Maps{&s.act[cur], &s.w1[blk]},
                                     smem_raw, producer, used, extra);
    grid_barrier();
    q.k = 9 * cmid;                // the 3x3 + bias + ReLU -> y2
    q.bias = s.b[blk][1];
    q.out1 = s.y2_ptr;
    q.conv_y = s.y1_ptr;
    q.conv_c = cmid;
    q.conv_h = s.h;
    q.conv_w = s.w;
    q.conv_tma = cmid % BK == 0;
    used = stage_phase<BN, CONV, RM>(q, Maps{&s.y1[blk], &s.w2[blk]},
                                     smem_raw, producer, used, extra);
    grid_barrier();
    Scalars q3{};                  // conv3 + bias + x + ReLU -> next
    q3.m = s.rows;
    q3.n = s.c;
    q3.k = cmid;
    q3.epi = EPI_BIAS_RESID_RELU;
    q3.bias = s.b[blk][2];
    q3.aux = s.act_ptr[cur];
    q3.out1 = s.act_ptr[nxt];
    used = stage_phase<BN, B_MN, RM>(q3, Maps{&s.y2[blk], &s.w3[blk]},
                                     smem_raw, producer, used, extra);
    if (blk + 1 < s.nblocks) grid_barrier();
    cur = nxt;
  }
}

// The stage kernel's tile for rows of a stage whose widest Cmid is cmid:
// K11's shape for the stage's 3x3 (product above, n = cmid, k = 9·cmid),
// 64 x 64 where 128 x 64 tiles would leave SMs idle, else 128 rows at
// pick_bn's width.
inline cudaError_t stage_tile(int device, int rows, int cmid, int* rm,
                              int* bn) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const bool small = cdiv(rows, BM) * cdiv(cmid, 64) < sms;
  *rm = small ? 64 : BM;
  *bn = small ? 64 : pick_bn(rows, cmid, 9 * cmid, true, sms);
  return cudaSuccess;
}

// One cooperative launch of stage_kernel<BN, RM>: min(tiles, blocks the
// card holds at once) blocks.  The shared-memory limit is set once per
// device before the occupancy is asked.  A refused launch returns its
// error (cudaErrorCooperativeLaunchTooLarge among them).
template <int BN, int RM>
cudaError_t stage_launch(const StageArgs& s, int tiles, int device,
                         cudaStream_t st) {
  using T = Tile<BN, CONV, RM>;
  static std::atomic<int> limit[MAX_DEVICES];
  const auto kernel = stage_kernel<BN, RM>;
  int sms = 0, per_sm = 0;
  cudaError_t err = smem_limit_once(kernel, T::SMEM, limit);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        T::THREADS, T::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {const_cast<StageArgs*>(&s)};
  // a refused launch returns its error and leaves it as the last error:
  // read it back so that it is cleared, not reported by the next call
  cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                              dim3(grid), dim3(T::THREADS), args, T::SMEM,
                              st);
  return cudaGetLastError();
}

// dfu_resnet_stage in bf16: the tensor maps of every block, then one
// launch.  Bases 16-byte aligned, c and every Cmid multiples of 8 (else
// cudaErrorInvalidValue).
inline cudaError_t stage(const void* x, const void* const* weights,
                         const int* cmids, int nblocks, void* y1, void* y2,
                         void* buf, void* out, int rows, int h, int w, int c,
                         int device, cudaStream_t st) {
  if (c < 8 || c % 8) return cudaErrorInvalidValue;
  int widest = 0, gather = 0;
  for (int i = 0; i < nblocks; ++i) {
    if (cmids[i] < 8 || cmids[i] % 8) return cudaErrorInvalidValue;
    widest = cmids[i] > widest ? cmids[i] : widest;
    gather |= cmids[i] % BK != 0;
  }
  int rm = 0, bn = 0;
  cudaError_t err = stage_tile(device, rows, widest, &rm, &bn);
  if (err != cudaSuccess) return err;
  StageArgs s{};
  // one block has no second buffer: its slot maps out, never read
  const void* acts[3] = {x, buf != nullptr ? buf : out, out};
  for (int a = 0; a < 3 && err == cudaSuccess; ++a) {
    err = encode(&s.act[a], acts[a], rows, c, rm);
    s.act_ptr[a] = const_cast<void*>(acts[a]);
  }
  int tiles = 0;                      // of the largest phase
  for (int i = 0; i < nblocks && err == cudaSuccess; ++i) {
    const void* const* wb = weights + 6 * i;
    const int cmid = cmids[i];
    err = encode(&s.w1[i], wb[0], c, cmid, BK);
    if (err == cudaSuccess) err = encode(&s.w2[i], wb[2], 9 * cmid, cmid, BK);
    if (err == cudaSuccess) err = encode(&s.w3[i], wb[4], cmid, c, BK);
    if (err == cudaSuccess) err = encode(&s.y1[i], y1, rows, cmid, rm);
    if (err == cudaSuccess) err = encode(&s.y2[i], y2, rows, cmid, rm);
    for (int j = 0; j < 3; ++j)
      s.b[i][j] = static_cast<const float*>(wb[2 * j + 1]);
    s.cmid[i] = cmid;
    const int t = cdiv(rows, rm) * cdiv(cmid > c ? cmid : c, bn);
    tiles = t > tiles ? t : tiles;
  }
  if (err != cudaSuccess) return err;
  s.y1_ptr = static_cast<bf16*>(y1);
  s.y2_ptr = static_cast<bf16*>(y2);
  s.nblocks = nblocks;
  s.rows = rows;
  s.h = h;
  s.w = w;
  s.c = c;
  s.gather = gather;
  if (rm == 64) return stage_launch<64, 64>(s, tiles, device, st);
  switch (bn) {
    case 64: return stage_launch<64, BM>(s, tiles, device, st);
    case 96: return stage_launch<96, BM>(s, tiles, device, st);
    case 128: return stage_launch<128, BM>(s, tiles, device, st);
    case 192: return stage_launch<192, BM>(s, tiles, device, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90

// One fp32 product on gemm_tile.cuh's SIMT tile, A staged by ALoad<float>
// {a, m, args...} (DenseA: k; Conv3x3A: c, h, w).
template <int EPI, template <typename> class ALoad, typename... Args>
void launch_simt(const void* a, const void* b, const float* bias, void* aux,
                 void* out, int m, int n, int k, cudaStream_t s,
                 Args... args) {
  const dim3 grid(cdiv(n, SBN), cdiv(m, SBM));
  gemm_f32_simt<EPI, false><<<grid, STHREADS, 0, s>>>(
      ALoad<float>{static_cast<const float*>(a), m, args...},
      static_cast<const float*>(b), bias, aux, out, m, n, k);
}

}  // namespace
}  // namespace dfu

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (rows, cin) and out (rows, cout) in the compute dtype, rows = B·h·w
// image-major; w1 (cin, cmid), w2 (9·cmid, cmid) row-stacked 3x3 taps
// ((dy, dx) row-major), w3 (cmid, cout) in the compute dtype; b1, b2 (cmid)
// and b3 (cout) fp32.  Projection: wd (cin, cout) and bd (cout) with the
// scratch sc (rows, cout), null in bf16 when cin == cmid (one product);
// identity (cin == cout): wd, bd and sc null.
// Scratch y1, y2 (rows, cmid) in the compute dtype.  bf16 runs the TMA +
// wgmma GEMM: bases 16-byte aligned, cin, cmid and cout multiples of 8
// (else cudaErrorInvalidValue); fp32 the SIMT tile.
int dfu_bottleneck(int device, int dtype, const void* x, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* w3, const void* b3, const void* wd,
                   const void* bd, void* y1, void* y2, void* sc, void* out,
                   int rows, int h, int w, int cin, int cmid, int cout,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(b1);
  const float* f2 = static_cast<const float*>(b2);
  const float* f3 = static_cast<const float*>(b3);
  const float* fd = static_cast<const float*>(bd);
  const void* shortcut = wd != nullptr ? sc : x;
  if (dtype == DT_BF16) {
    if (cin % 8 || cmid % 8 || cout % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    err = sm90::product(EPI_BIAS_RELU, x, w1, f1, nullptr, y1, rows, cmid,
                        cin, device, s);
    if (err == cudaSuccess)
      err = sm90::product(EPI_BIAS_RELU, y1, w2, f2, nullptr, y2, rows, cmid,
                          9 * cmid, device, s, h, w);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (wd != nullptr && cin == cmid)    // the shortcut in conv3's launch
      return static_cast<int>(sm90::conv3_proj(y2, w3, f3, x, wd, fd, out,
                                               rows, cout, cmid, device, s));
    if (wd != nullptr)
      err = sm90::product(EPI_BIAS, x, wd, fd, nullptr, sc, rows, cout, cin,
                          device, s);
    if (err == cudaSuccess)
      err = sm90::product(EPI_BIAS_RESID_RELU, y2, w3, f3, shortcut, out,
                          rows, cout, cmid, device, s);
    return static_cast<int>(err);
  }
  launch_simt<EPI_BIAS_RELU, DenseA>(x, w1, f1, nullptr, y1, rows, cmid, cin,
                                     s, cin);
  launch_simt<EPI_BIAS_RELU, Conv3x3A>(y1, w2, f2, nullptr, y2, rows, cmid,
                                       9 * cmid, s, cmid, h, w);
  if (wd != nullptr)
    launch_simt<EPI_BIAS, DenseA>(x, wd, fd, nullptr, sc, rows, cout, cin, s,
                                  cin);
  launch_simt<EPI_BIAS_RESID_RELU, DenseA>(y2, w3, f3,
                                           const_cast<void*>(shortcut), out,
                                           rows, cout, cmid, s, cmid);
  DFU_RETURN_LAST_ERROR();
}

int dfu_stage_max_blocks() { return kMaxStageBlocks; }

// The bf16 stage kernel's tile for `rows` rows and a widest Cmid of cmid
// (K11's shape for the stage's 3x3): *rm rows x *bn columns.
int dfu_stage_tile(int device, int rows, int cmid, int* rm, int* bn) {
  return static_cast<int>(sm90::stage_tile(device, rows, cmid, rm, bn));
}

// One cooperative launch for n identity bottlenecks on x (rows, c) in the
// compute dtype, rows = B·h·w image-major.  weights holds 6·n pointers,
// block by block (w1, b1, w2, b2, w3, b3) in fused_bottleneck's layouts;
// cmids the n Cmid.  Scratch: y1, y2 (rows, max cmid) and, for n >= 2,
// buf (rows, c), all in the compute dtype.  bf16 runs the TMA + wgmma
// stage kernel (16-byte-aligned bases, c and every Cmid multiples of 8,
// else cudaErrorInvalidValue), fp32 the SIMT one.  Returns
// cudaErrorNotSupported on a card without cooperative launch, and the
// launch's own error (cudaErrorCooperativeLaunchTooLarge among them)
// otherwise.
int dfu_resnet_stage(int device, int dtype, const void* x,
                     const void* const* weights, const int* cmids,
                     int nblocks, void* y1, void* y2, void* buf, void* out,
                     int rows, int h, int w, int c, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks < 1 || nblocks > kMaxStageBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  int coop = 0, sms = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return static_cast<int>(sm90::stage(x, weights, cmids, nblocks, y1, y2,
                                        buf, out, rows, h, w, c, device, s));
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);

  StageParams p{};
  p.x = x;
  p.out = out;
  p.buf = buf;
  p.y1 = y1;
  p.y2 = y2;
  p.nblocks = nblocks;
  p.rows = rows;
  p.h = h;
  p.w_img = w;
  p.c = c;
  int tiles = 0;                 // of the largest phase
  for (int i = 0; i < nblocks; ++i) {
    const void* const* wb = weights + 6 * i;
    p.w[i][0] = wb[0];
    p.w[i][1] = wb[2];
    p.w[i][2] = wb[4];
    p.b[i][0] = static_cast<const float*>(wb[1]);
    p.b[i][1] = static_cast<const float*>(wb[3]);
    p.b[i][2] = static_cast<const float*>(wb[5]);
    p.cmid[i] = cmids[i];
    const int widest = cmids[i] > c ? cmids[i] : c;
    const int t = cdiv(rows, SBM) * cdiv(widest, SBN);
    if (t > tiles) tiles = t;
  }
  const void* kernel = reinterpret_cast<const void*>(stage_f32_simt);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      STHREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  void* args[] = {&p};
  // a refused launch returns its error and leaves it as the last error:
  // read it back so that it is cleared, not reported by the next call
  cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(STHREADS), args, 0, s);
  DFU_RETURN_LAST_ERROR();
}

}  // extern "C"
