// The bf16 and int8 products of the ViT blocks on Hopper's TMA and wgmma
// (sm_90a): one warp-specialised, persistent GEMM, with K4's fc1 and dh
// fused into a dual product.
//
// Replaces, in bf16 (with the LayerNorm kernels of layernorm.cuh and, for
// K1, the attention step of attention_fwd_mma.cuh around it), the
// products of dfu_multimodal_tpu/ops/vit_block.py's
//   _attn_block_kernel (K1): qkv = y·wqkv + bqkv, out = x + (attn·wproj +
//     bproj);
//   _mlp_block_kernel (K2): h = gelu(y·w1 + b1), out = x + (h·w2 + b2b);
//   _mlp_block_bwd_kernel (K4): per row block, y = LN2(x), hpre = y·w1 +
//     b1, h = gelu(hpre), dh = g·w2ᵀ, dhpre = dh·gelu'(hpre), dy =
//     dhpre·w1ᵀ, then the LN backward; hpre and dh stay in VMEM for each
//     hidden chunk, so "no fp32 GELU/LN intermediate ever reaches HBM";
// and the data products of the attention-block chain rule (vit_block.py::
// _attn_block_bwd: the qkv recompute, dattn = g·wprojᵀ, dy = dqkv·wqkvᵀ),
// which the JAX package leaves to XLA; and the bf16 products of
// dfu_multimodal_tpu/ops/resnet_block.py's _bottleneck_kernel and
// _bottleneck_proj_kernel (K11, launched by resnet_block.cu): conv1, the
// 3x3 as an implicit GEMM (the CONV mode) and conv3, with the projection
// shortcut folded into conv3's launch (the PROJ mode), 64-row tiles where
// 128-row tiles leave SMs idle; the same tiles walked phase by phase in
// one cooperative launch for ::_stage_kernel (K12, resnet_block.cu's
// stage kernel, over the device functions produce / consume below); the
// products of vit_block.py::_attn_block_bwd_kernel (K10, launched by
// attn_block_bwd.cu): qkv, dattn and dy in the chain rule's modes, and
// its weight gradients in the WGRAD mode (aᵀ·b over row chunks, both
// operands MN-major).  fp32 (the parity dtype) keeps gemm_tile.cuh's
// SIMT chain.  And, in both compute dtypes, the four int8
// products of dfu_multimodal_tpu/ops/vit_block_q8.py's _attn_block_q8_
// kernel / _mlp_block_q8_kernel (K7) and _attn_block_q8s_kernel /
// _mlp_block_q8s_kernel (K8), launched by vit_block_q8.cu (the int8
// modes, below).
//
// What bounds it on the H100: operations.  K4 at the training batch (16
//   images, 3152 rows, C = 768, hidden = 3072) is three products of 14.9
//   GFLOP, 45 us at the 989 TFLOP/s bf16 peak against ~27 us for its
//   operands and outputs at 3.35 TB/s; K1's two products at the serving
//   batch (1576 rows) are 7.4 GFLOP against 7.9 MB (7.5 us against 2.4
//   us), K2's 14.9 GFLOP against 14.2 MB.  Only wgmma reaches that rate,
//   so the products run on it; and K4's chain wrote and read back the fp32
//   pre-activation (38.7 MB each way), which the dual product never writes.
//
// What the design does about it:
//   - 384 threads a block, one block an SM, persistent over the output
//     tiles (tile = blockIdx.x + i·gridDim.x), so the next tile's loads
//     run under this tile's epilogue: warpgroup 2 is the producer
//     (setmaxnreg 40; one thread starts cp.async.bulk.tensor loads into a
//     ring of shared-memory stages, each completing on its mbarrier), the
//     warpgroups 0 and 1 the consumers (setmaxnreg 232), 64 rows each, on
//     wgmma.mma_async m64nNk16 with A and B read through shared-memory
//     descriptors; a consumer releases a stage as soon as the wgmma group
//     that read it has retired (wait_group 0: with 3 stages, releasing one
//     k step later, wait_group 1, is slower: tools/bench_k4.py);
//   - tiles are 64 bf16 (128 bytes) deep, 128-byte swizzled by TMA, and
//     read by the matching descriptors: every A is K-major; a weight read
//     as stored ((k, n): qkv, proj, fc1, fc2, and K4's w1 in the dual) is
//     an MN-major B, loaded as 64-column boxes and read through wgmma's
//     transpose bit; a weight read transposed ((n, k): K4's w2 and dy's
//     w1, the chain rule's wproj and wqkv) is a K-major B.  No copy of any
//     weight is made;
//   - the dual product (y, g) -> (h, dhpre): each 128 x 128 output tile
//     (rows x hidden) accumulates y·w1 and g·w2ᵀ in two fp32 register
//     accumulators over the same k loop (K = C); the epilogue forms
//     hpre = acc1 + b1 in registers, writes h and then dhpre in bf16 to a
//     16 KB shared buffer per consumer group and stores each by TMA;
//   - the single products, 128 x BN tiles: the epilogue (gemm_tile.cuh's
//     EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID, EPI_NONE, a uniform branch
//     on the launch's `epi`) writes bf16 into a padded 64 x BN buffer per
//     consumer group, whose 128 threads then copy it out in 16-byte
//     chunks, adding EPI_BIAS_RESID's residual chunk on the way; EPI_F32
//     (dy) stores fp32 pairs straight from the accumulators.  BN is 64,
//     96, 128 or 192, chosen per launch by pick_bn from the rounds of
//     tiles over the SMs (tools/bench_vit_fwd.py times each width); 192
//     was the fastest dy width of 64, 96, 128 and 192 at B = 16 and 128;
//   - the ragged row edge (3152 = 24.6 x 128) and any K or N that is no
//     multiple of the tile are zero-filled by TMA loads, and clipped by
//     the TMA stores (h, dhpre) or masked on the way out.
//     TMA needs 16-byte-aligned bases and row strides: the wrappers raise
//     ValueError otherwise (C, 3C and hidden multiples of 8).
//   - sums have a fixed order (k16 steps in k order, no split-K, no
//     atomics): two calls give the same bits.
//   - K11's modes: CONV, the 3x3's implicit GEMM (A from y1 by a TMA box
//     of rows shifted by the stage's tap, the rows whose neighbour lies
//     outside their image zeroed in the consumers' ldmatrix fragments and
//     wgmma fed A from registers; or, for Cmid % 64 != 0, gathered by the
//     producer warpgroup with cp.async), and PROJ, conv3 and the
//     projection shortcut over one k loop in two accumulators; both
//     products MN-major B, as B_MN.  Where 128-row tiles leave SMs idle,
//     B_MN and CONV take 64 x 64 tiles (Tile<..., 64>: one consumer
//     warpgroup, two blocks an SM);
//   - the int8 modes (S8, S8_GROUPS): the same ring, producer and tile
//     walk, a stage 128 int8 deep (the bf16 stage's byte geometry: 128-
//     byte rows, 128-byte swizzle, a k32 step 32 bytes along the row, so
//     the K-major descriptors are the bf16 ones).  wgmma has no transpose
//     for 8-bit types, so both operands are K-major: B is the weight's
//     (out, in) int8 copy, which the model makes once per weight version.
//     wgmma.m64nNk32.s32.s8.s8 sums into int32 registers; at the end of
//     each K group (one for qkv, proj and fc1; fc2's four 768-wide hidden
//     chunks, each quantised with its own row scale) the products are
//     retired (wait_group 0) and the int32 sums flushed into fp32 as
//     facc + (float(acc)·a[r, g])·s[n] (flush_group), then zeroed.  The
//     epilogue (store_s8) adds the bias and casts (qkv), adds the residual
//     to the rounded output (proj, fc2), or applies erf GELU into fp32
//     (dynamic fc1) or into int8 with the static scale (static fc1).  The
//     int8 ResNet's convolutions (conv_q8.cu, no TPU kernel: they replace
//     models/resnet_q8.py's XLA convs) run the S8 mode with static scales
//     on an im2col A and add ReLU variants of the bias and residual
//     epilogues.
//   - WGRAD (K10's dwproj = attnᵀ·g, dwqkv = yᵀ·dqkv): K is the B·N
//     rows, so A = aᵀ is MN-major like B_MN's B: two 64-column boxes of
//     64 rows a stage, read through wgmma's transpose bit for A; 128 x 128
//     tiles of each WG_ROWS-row chunk, each into its chunk's fp32 partial
//     (attn_block_bwd.cu sums them in chunk order); a box that starts past
//     m or n is not loaded (its rows and columns are never stored);
//   - produce and consume take the ring's stage and parity, so one
//     persistent kernel (K12's) runs product after product on one ring.
//
// Numbers: gemm_tile.cuh's chain and the Pallas kernels', bf16 operands
// with fp32 accumulation, the epilogue in fp32 rounded to bf16 once (the
// residual's sum T(aux + T(acc + bias)), as the TPU kernels add it in the
// compute dtype), K4's hpre kept in fp32 (registers), h =
// bf16(gelu_erf(hpre)), dhpre = bf16(dh · dgelu_erf(hpre)), dy in fp32.
// The k sums take the WMMA tile's order too (16-deep tensor-core steps in
// k order into fp32), and on an H100 K4's outputs equal the WMMA chain's
// bit for bit.
//
// The int8 modes keep vit_block_q8.cu's WMMA kernel's numbers bit for bit:
// the int32 sums are exact in any order, and the flush and the epilogues
// round the same operations in the same order (__fmul_rn / __fadd_rn, no
// FMA).
//
// Tensor maps are encoded on the host for every call
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point: no -lcuda) and passed as a __grid_constant__ parameter; the
// shared-memory limit and the SM count are asked once per device.
#pragma once

#include "common.cuh"
#include "gemm_tile.cuh"

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

namespace dfu {
namespace {
namespace sm90 {

constexpr int BM = 128, BK = 64;
constexpr int BOX_MN = 64 * BK * 2;     // one 64 x 64 MN-major box, 8 KB
constexpr int SMEM_RING = 196608;       // bytes of stages the dual takes
constexpr int SMEM_MAX = 232448;        // bytes a block may hold on sm_90
constexpr int DY_BN = 192;              // the dy product's tile width
constexpr int WG_ROWS = 1024;           // WGRAD's rows per fp32 partial
constexpr int WG_BN = 128;              // and its tile width

// What a launch computes.  DUAL: K4's dual product.  B_MN: one product
// whose B (k, n) is read as stored, MN-major (a weight of a forward
// product); B_K: one product whose B is read from an (n, k) matrix,
// K-major (a weight read transposed: dy = dhpre·w1ᵀ, dattn = g·wprojᵀ).
// S8 and S8_GROUPS: one int8 product of K7/K8, A (m, k) and B (n, k)
// both K-major (the weight's (out, in) copy), int32 sums dequantised into
// fp32 at the end of each K group: S8 has one group, S8_GROUPS several
// (fc2's hidden chunks), whose fp32 sum it keeps in registers.  CONV: the
// implicit GEMM of K11's 3x3 (B_MN's B, w2 (9·c, c) as stored), its A
// tile loaded from y (m, c) by TMA or gathered by the producer warpgroup
// (conv_tma_a, conv_a below).  PROJ: K11's conv3 with its projection
// shortcut, out = T(max(T(a2·b2 + bias2) + T(a1·b1 + bias), 0)), both Bs
// MN-major, over one k loop (Cmid == Cin).  WGRAD: K10's weight
// gradients, partial[z] (m, n) = a[rows of chunk z]ᵀ · b[rows of chunk z]
// over WG_ROWS-row chunks of a (rows, m) and b (rows, n), both row-major:
// K is the rows, so both operands are MN-major (A read through wgmma's
// transpose bit, as B_MN reads B), loaded as 64-column boxes of 64 rows.
enum Mode {
  DUAL = 0, B_MN = 1, B_K = 2, S8 = 3, S8_GROUPS = 4, CONV = 5, PROJ = 6,
  WGRAD = 7
};

__host__ __device__ constexpr bool is_s8(int mode) {
  return mode == S8 || mode == S8_GROUPS;
}

// The int8 products' epilogues: v = Σ_g (acc_g·a[r, g])·s[n] + bias[n]
// in fp32 (a = 1 for static scales), then
enum QEpilogue {
  QEPI_OUT = 0,         // out = T(v), T the compute dtype
  QEPI_RESID = 1,       // out = T(resid + T(v)), resid (m, n) T
  QEPI_GELU_F32 = 2,    // out = gelu(v), fp32
  QEPI_GELU_Q8 = 3,     // out = int8(gelu(v)·inv[0])
  QEPI_OUT_RELU = 4,    // out = max(T(v), 0) (the int8 convolution's)
  QEPI_RESID_RELU = 5   // out = max(T(resid + T(v)), 0)
};

// clip(round_half_even(y·inv), -127, 127)
__device__ __forceinline__ int8_t quant_i8(float y, float inv) {
  const float r = rintf(__fmul_rn(y, inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// The operands of one launch.  DUAL: a1 = y, b1 = w1 (MN-major), a2 = g,
// b2 = w2 (read as w2ᵀ), bias = b1, o1 = h, o2 = dhpre (bf16, stored by
// TMA in 64 x 64 boxes).  Else: out1 (m, n) = epilogue `epi` (gemm_tile.
// cuh's Epilogue) of a1 · b1, with bias (n) fp32 and aux the (m, n) bf16
// residual of EPI_BIAS_RESID; out1 fp32 for EPI_F32, else bf16.  The
// int8 modes: epi is a QEpilogue, dtype the compute dtype (DT_BF16 or
// DT_F32) of QEPI_OUT / QEPI_RESID and aux their residual, row_scale (m,
// groups) fp32 the dynamic row scales (null: static), col_scale (n) fp32,
// inv (1) fp32 QEPI_GELU_Q8's reciprocal scale, and a K group is
// group_steps k32 steps deep.  CONV: A is conv_y, the (m, conv_c) bf16
// rows of conv_h x conv_w images (k = 9·conv_c); with conv_tma, a1 is its
// tensor map (128-row boxes) and A comes by TMA (conv_tma_a), else by the
// producer's gather (conv_a).  WGRAD: k is the rows, out1 the fp32
// partials (ceil(k / WG_ROWS), m, n).
//
// Scalars is what the tiles read besides the tensor maps: the stage
// kernel (resnet_block.cu) builds one for each phase on the device, with
// the maps in its own parameter space (Maps points at them).
struct Scalars {
  const float* bias;
  const float* bias2;     // PROJ: the shortcut's bias
  const void* aux;
  void* out1;
  int m, n, k, epi;
  const float* row_scale;
  const float* col_scale;
  const float* inv;
  int groups, group_steps, dtype;
  const bf16* conv_y;
  int conv_c, conv_h, conv_w, conv_tma;
};

struct Args : Scalars {
  CUtensorMap a1, b1, a2, b2, o1, o2;
};

// The tensor maps a launch's tiles read (null where unused): in the
// parameter space, where TMA takes them.
struct Maps {
  const CUtensorMap *a1, *b1, *a2, *b2, *o1, *o2;
};

// A tile of RM rows (BM, or 64 for products whose 128-row tiles cannot
// fill the card: one consumer warpgroup, two blocks an SM) and BN columns.
template <int BN, int MODE, int RM = BM>
struct Tile {
  static_assert((MODE != DUAL && MODE != PROJ) || BN == 128,
                "the dual products' Bs are two boxes");
  static_assert(RM == BM || (RM == 64 && (MODE == B_MN || MODE == CONV)),
                "64-row tiles: the single bf16 products");
  static_assert(MODE != WGRAD || RM == BM, "WGRAD: two A boxes a tile");
  static constexpr int GROUPS = RM / 64;              // consumer warpgroups
  static constexpr int THREADS = (GROUPS + 1) * 128;  // and one producer
  static constexpr int BLOCKS_PER_SM = RM == BM ? 1 : 2;
  static constexpr int BUDGET = SMEM_MAX / BLOCKS_PER_SM;
  // RM rows of 128 bytes (WGRAD: RM / 64 MN-major boxes of 64 k rows)
  static constexpr int TILE_A = RM * BK * 2;
  // 64-column boxes of an MN-major B (BN = 96 loads two, the second
  // half used)
  static constexpr int BOXES = (BN + 63) / 64;
  // a K-major B (bf16 or int8): BN rows of 128 bytes
  static constexpr int TILE_B =
      MODE == B_K || is_s8(MODE) ? BN * BK * 2 : BOXES * BOX_MN;
  static constexpr int STAGE =
      MODE == DUAL || MODE == PROJ ? 2 * (TILE_A + TILE_B) : TILE_A + TILE_B;
  // offsets in a stage, each a multiple of 1024 (the swizzle's period)
  static constexpr int A1 = 0, B1 = TILE_A, A2 = TILE_A + TILE_B,
                       B2 = 2 * TILE_A + TILE_B;
  // the epilogue buffer of each consumer group: the dual product's 64
  // rows of h (then of dhpre), 128 bf16 each in TMA's swizzled boxes;
  // the single product's 64 rows of BN bf16, each padded by 16 bytes so
  // that the eight rows a warp writes at once fall on distinct banks
  static constexpr int LDE = BN + 8;
  // (WGRAD stores fp32 from its registers: no buffer)
  static constexpr int EPI_WG = MODE == DUAL    ? 64 * BN * 2
                                : MODE == WGRAD ? 0
                                                : 64 * LDE * 2;
  // as many stages as fit beside the epilogue buffers, barriers and the
  // 1 KB that aligns the ring (3 dual; 4 at BN = 192, 8 at 64)
  static constexpr int FIT = (BUDGET - 1024 - GROUPS * EPI_WG - 2 * 8 * 8) /
                             STAGE;
  static constexpr int STAGES =
      MODE == DUAL ? SMEM_RING / STAGE : (FIT < 8 ? FIT : 8);
  // the ring, the epilogue buffers, the full and empty barriers, and 1 KB
  // to align the ring
  static constexpr int SMEM = STAGES * STAGE + GROUPS * EPI_WG +
                              2 * STAGES * 8 + 1024;
  static_assert(SMEM <= BUDGET, "shared memory");
  // registers a thread after setmaxnreg: the producer's (more for the
  // CONV gather's coordinates), and the consumers' share of the rest
  static constexpr int PRODUCER_REGS = MODE == CONV ? 56 : 40;
  static constexpr int CONSUMER_REGS =
      (65536 / BLOCKS_PER_SM - 128 * PRODUCER_REGS) / (128 * GROUPS) / 8 * 8 >
              232
          ? 232
          : (65536 / BLOCKS_PER_SM - 128 * PRODUCER_REGS) / (128 * GROUPS) /
                8 * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box of `map` at (c0 innermost, c1) into shared memory at dst; its
// bytes complete on barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from src to shared memory at dst, or 16 zero bytes when
// bytes == 0 (src is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte-aligned swizzle atoms of 8 rows x 128 bytes): lbo and sbo in
// bytes.  K-major: sbo = 1024 (the next 8 rows), lbo unused.  MN-major:
// lbo = the stride of 64-element MN chunks, sbo = 1024 (the next 8 k).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Shared-memory byte offset of row r (0..63), columns 8j + 2·(lane % 4)
// and the next, in a buffer of 64-column boxes (8 KB each, 128-byte rows)
// whose 16-byte chunks are swizzled as TMA's 128-byte mode lays them: the
// eight rows a warp writes at once fall on distinct banks.
__device__ __forceinline__ uint32_t epi_offset(int r, int j, int lane) {
  return (j >> 3) * 8192 + r * 128 + (((j & 7) ^ (r & 7)) << 4) +
         ((lane & 3) << 2);
}

__device__ __forceinline__ void st_shared_bf16x2(uint32_t addr, float lo,
                                                 float hi) {
  const __nv_bfloat162 v(from_f<bf16>(lo), from_f<bf16>(hi));
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}

// Named barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void sync_group(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The 64 x 64 box of shared memory at src to `map` at (c0, c1): rows and
// columns outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// A consumer group's 64 x 128 bf16 buffer (written by its 128 threads) to
// `map` at columns n0.., rows row0..: the writes made visible to TMA, one
// thread stores the boxes that lie inside the tensor and waits until TMA
// has read them, so the buffer may be written again.
template <typename P>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           uint32_t buf, int n0, int row0,
                                           const P& p, int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  sync_group(1 + wg);
  if (threadIdx.x % 128 == 0 && row0 < p.m) {
    tma_store(map, buf, n0, row0);
    if (n0 + 64 < p.n) tma_store(map, buf + 8192, n0 + 64, row0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  sync_group(1 + wg);
}

// d (64 x N, fp32) += A (64 x 16) · B (16 x N) through descriptors: A
// K-major, or MN-major when TRANS_A (WGRAD); B K-major, or MN-major when
// TRANS_B.
template <int TRANS_B, int TRANS_A>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_B, int TRANS_A>
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %52, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_B, int TRANS_A>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_B, int TRANS_A>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %100, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1), "n"(TRANS_B), "n"(TRANS_A));
}

template <int N, int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192, "tile width");
  if constexpr (N == 64) wgmma_m64n64k16<TRANS_B, TRANS_A>(d, a, b);
  else if constexpr (N == 96) wgmma_m64n96k16<TRANS_B, TRANS_A>(d, a, b);
  else if constexpr (N == 128) wgmma_m64n128k16<TRANS_B, TRANS_A>(d, a, b);
  else wgmma_m64n192k16<TRANS_B, TRANS_A>(d, a, b);
}

// d (64 x N, fp32) += A (64 x 16, bf16 fragments in registers, each
// warp's 16 rows laid out as mma.m16n8k16's A) · B (16 x N) through a
// descriptor, K-major, or MN-major when TRANS_B.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n96k16(float (&d)[48],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192, "tile width");
  if constexpr (N == 64) wgmma_rs_m64n64k16<TRANS_B>(d, a, b);
  else if constexpr (N == 96) wgmma_rs_m64n96k16<TRANS_B>(d, a, b);
  else if constexpr (N == 128) wgmma_rs_m64n128k16<TRANS_B>(d, a, b);
  else wgmma_rs_m64n192k16<TRANS_B>(d, a, b);
}

// The A fragment of one warp's 16 rows x 16 k of a 128-byte-swizzled
// K-major tile (rows of 128 bytes, 16-byte chunks XORed with row % 8):
// lane l addresses row row0 + l % 16, chunk chunk0 + l / 16.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], uint32_t tile,
                                           int row0, int chunk0, int lane) {
  const int r = row0 + (lane & 15), c = chunk0 + (lane >> 4);
  const uint32_t addr = tile + r * 128 + ((c ^ (r & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d (64 x N, int32) += A (64 x 32) · B (32 x N), int8, both K-major through
// descriptors (wgmma has no transpose for 8-bit types).
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n96k32(int (&d)[48], uint64_t a,
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n192k32(int (&d)[96], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 192, "tile width");
  if constexpr (N == 64) wgmma_s8_m64n64k32(d, a, b);
  else if constexpr (N == 96) wgmma_s8_m64n96k32(d, a, b);
  else if constexpr (N == 128) wgmma_s8_m64n128k32(d, a, b);
  else wgmma_s8_m64n192k32(d, a, b);
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Eight bf16 of `a` plus eight of `b`, each sum in fp32 (with `relu`,
// max(sum, 0)) rounded to bf16: EPI_BIAS_RESID's T(aux + T(acc + bias))
// and EPI_BIAS_RESID_RELU's T(max(aux + T(acc + bias), 0)) once `b` holds
// T(acc + bias).
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b, bool relu) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = __low2float(x[i]) + __low2float(y[i]);
    float hi = __high2float(x[i]) + __high2float(y[i]);
    if (relu) {
      lo = fmaxf(lo, 0.f);
      hi = fmaxf(hi, 0.f);
    }
    o[i] = __nv_bfloat162(from_f<bf16>(lo), from_f<bf16>(hi));
  }
  return r;
}

// max(o, 0) of eight bf16, each compared in fp32 (exact).
__device__ __forceinline__ uint4 relu_bf16x8(uint4 a) {
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __nv_bfloat162(from_f<bf16>(fmaxf(__low2float(x[i]), 0.f)),
                          from_f<bf16>(fmaxf(__high2float(x[i]), 0.f)));
  return a;
}

// A consumer group's 64 x BN bf16 tile, staged in its padded buffer (row
// stride LDE elements), out to device memory in 16-byte chunks of the rows
// below m and the columns below n, adding the (m, n) bf16 residual
// p.aux chunk by chunk when `resid` (T(aux + o), or T(max(aux + o, 0))
// when `relu`), else max(o, 0) when `relu`.  The group syncs before (its
// threads wrote the buffer) and after (the buffer is the next tile's).
template <int BN, int LDE, int BATCH = BN / 16>
__device__ __forceinline__ void copy_out_bf16(uint32_t buf, int m0, int n0,
                                              int wg, const Scalars& p,
                                              bool resid, bool relu = false) {
  sync_group(1 + wg);
  constexpr int CHUNKS = BN / 8;     // 16-byte chunks of a tile row
  constexpr int PER = 64 * CHUNKS / 128;     // a thread's chunks
  static_assert(PER % BATCH == 0, "whole batches");
  const int t = threadIdx.x % 128;
  if (BATCH == 1 || !resid) {
    // a chunk at a time: nothing to wait for without a residual (the
    // int8 products take this loop with one too: batches made the
    // 192-wide kernel spill)
    for (int i = t; i < 64 * CHUNKS; i += 128) {
      const int rr = i / CHUNKS, cc = i % CHUNKS;
      const int row = m0 + wg * 64 + rr, col = n0 + 8 * cc;
      if (row >= p.m || col >= p.n) continue;
      const size_t at = static_cast<size_t>(row) * p.n + col;
      uint4 o = ld_shared_v4(buf + 2 * (rr * LDE + 8 * cc));
      if (resid)
        o = add_bf16x8(
            *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.aux) +
                                            at), o, relu);
      else if (relu)
        o = relu_bf16x8(o);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out1) + at) = o;
    }
  } else {
    // the residual's chunks loaded BATCH at a time, all of a batch's
    // loads in flight before its first add (a load and its add chunk by
    // chunk left conv3 at stage 1 20% slower)
#pragma unroll
    for (int j0 = 0; j0 < PER; j0 += BATCH) {
      uint4 res[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = t + 128 * (j0 + j), rr = i / CHUNKS, cc = i % CHUNKS;
        const int row = m0 + wg * 64 + rr, col = n0 + 8 * cc;
        if (row < p.m && col < p.n)
          res[j] = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(p.aux) +
              static_cast<size_t>(row) * p.n + col);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = t + 128 * (j0 + j), rr = i / CHUNKS, cc = i % CHUNKS;
        const int row = m0 + wg * 64 + rr, col = n0 + 8 * cc;
        if (row >= p.m || col >= p.n) continue;
        const size_t at = static_cast<size_t>(row) * p.n + col;
        const uint4 o = add_bf16x8(
            res[j], ld_shared_v4(buf + 2 * (rr * LDE + 8 * cc)), relu);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out1) + at) = o;
      }
    }
  }
  sync_group(1 + wg);
}

// The int8 modes' K-group flush: facc += (float(acc)·a[r, g])·s[col] in
// fp32, each product and sum rounded once (no FMA: the plain version's
// order), then acc = 0.  Accumulator i of n-octet j = i / 4 is row row0
// (+8 for i % 4 >= 2) and column n0 + 8j + 2·(lane % 4) (+1 for odd i);
// rows past m take a = 0 (they are never stored).  Static (no row_scale):
// facc += float(acc)·s[col].
template <int R>
__device__ __forceinline__ void flush_group(float (&facc)[R], int (&acc)[R],
                                            const Scalars& p, int row0, int n0,
                                            int lane, int g) {
  const bool dynamic = p.row_scale != nullptr;
  float a[2] = {1.f, 1.f};
  if (dynamic) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      a[half] = row < p.m
                    ? p.row_scale[static_cast<size_t>(row) * p.groups + g]
                    : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    const float s0 = col < p.n ? p.col_scale[col] : 0.f;
    const float s1 = col < p.n ? p.col_scale[col + 1] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float v = static_cast<float>(acc[i]);
      if (dynamic) v = __fmul_rn(v, a[e >> 1]);
      facc[i] = __fadd_rn(facc[i], __fmul_rn(v, (e & 1) ? s1 : s0));
      acc[i] = 0;
    }
  }
}

// The int8 modes' epilogue of this group's 64 rows of a tile: v = facc +
// bias, then the QEpilogue.  bf16 QEPI_OUT / QEPI_RESID (and their ReLU
// variants) go through the
// group's padded buffer and copy_out_bf16, as the bf16 products do; the
// fp32 and int8 outputs are stored as pairs straight from the registers
// (a quad of lanes writes 32 contiguous bytes of fp32 a row).
template <int BN, int LDE>
__device__ __forceinline__ void store_s8(const float (&facc)[BN / 2],
                                         const Scalars& p, uint32_t buf, int m0,
                                         int n0, int wg, int warp, int lane) {
  const int r = warp * 16 + (lane >> 2);
  const bool resid = p.epi == QEPI_RESID || p.epi == QEPI_RESID_RELU;
  const bool relu = p.epi == QEPI_OUT_RELU || p.epi == QEPI_RESID_RELU;
  if (p.dtype == DT_BF16 && p.epi != QEPI_GELU_F32 && p.epi != QEPI_GELU_Q8) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const float b0 = col < p.n ? p.bias[col] : 0.f;
      const float b1 = col < p.n ? p.bias[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        st_shared_bf16x2(
            buf + 2 * ((r + 8 * half) * LDE + 8 * j + 2 * (lane & 3)),
            __fadd_rn(facc[i], b0), __fadd_rn(facc[i + 1], b1));
      }
    }
    copy_out_bf16<BN, LDE, 1>(buf, m0, n0, wg, p, resid, relu);
    return;
  }
  const float inv = p.epi == QEPI_GELU_Q8 ? p.inv[0] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= p.n) continue;          // n % 8 == 0: col + 1 < n too
    const float b0 = p.bias[col], b1 = p.bias[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wg * 64 + r + 8 * half;
      if (row >= p.m) continue;
      const size_t at = static_cast<size_t>(row) * p.n + col;
      const int i = 4 * j + 2 * half;
      const float v0 = __fadd_rn(facc[i], b0), v1 = __fadd_rn(facc[i + 1], b1);
      if (p.epi == QEPI_GELU_Q8) {
        *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out1) + at) =
            make_char2(quant_i8(gelu_erf(v0), inv),
                       quant_i8(gelu_erf(v1), inv));
        continue;
      }
      float2 o = make_float2(v0, v1);
      if (p.epi == QEPI_GELU_F32) {
        o = make_float2(gelu_erf(v0), gelu_erf(v1));
      } else if (resid) {
        const float2 x =
            *reinterpret_cast<const float2*>(static_cast<const float*>(p.aux) +
                                             at);
        o = make_float2(__fadd_rn(x.x, v0), __fadd_rn(x.y, v1));
      }
      if (relu) o = make_float2(fmaxf(o.x, 0.f), fmaxf(o.y, 0.f));
      *reinterpret_cast<float2*>(static_cast<float*>(p.out1) + at) = o;
    }
  }
}

// A row's (row in image) << 16 | column, or a row past every image for
// rows past m, so that no neighbour of it is inside.
__device__ __forceinline__ int image_yx(int r, int m, int h, int w) {
  return r < m ? ((r / w) % h) << 16 | (r % w) : 0x7FFF << 16;
}

// Whether the neighbour (dy, dx) of the row packed as yx lies in its image.
__device__ __forceinline__ bool inside(int yx, int dy, int dx, int h, int w) {
  const int yy = (yx >> 16) + dy, xx = (yx & 0xFFFF) + dx;
  return yy >= 0 && yy < h && xx >= 0 && xx < w;
}

// The tiles of one launch a block computes (tile = blockIdx.x + i ·
// gridDim.x, row-major over the tile grid) and the k stages of each.
// WGRAD: the tiles of each WG_ROWS-row chunk z in turn, each k loop over
// its own chunk's rows only (the last chunk's ragged end zero-filled by
// TMA), so no stage reads the next chunk's rows.
template <int BN, int MODE, int RM>
struct Walk {
  static constexpr int KSTAGE = is_s8(MODE) ? 2 * BK : BK;  // k a stage
  int n_tiles, mn_tiles, tiles, kblocks;

  __device__ __forceinline__ explicit Walk(const Scalars& p) {
    n_tiles = (p.n + BN - 1) / BN;
    mn_tiles = (p.m + RM - 1) / RM * n_tiles;
    if constexpr (MODE == WGRAD) {
      tiles = mn_tiles * ((p.k + WG_ROWS - 1) / WG_ROWS);
      kblocks = WG_ROWS / BK;
    } else {
      tiles = mn_tiles;
      kblocks = (p.k + KSTAGE - 1) / KSTAGE;
    }
  }

  // `tile`'s rows m0.., columns n0.., and its k loop: kb stages from k0
  __device__ __forceinline__ void at(int tile, const Scalars& p, int& m0,
                                     int& n0, int& k0, int& kb) const {
    k0 = 0;
    kb = kblocks;
    if constexpr (MODE == WGRAD) {
      const int z = tile / mn_tiles;
      tile -= z * mn_tiles;
      k0 = z * WG_ROWS;
      if (p.k - k0 < WG_ROWS) kb = (p.k - k0 + BK - 1) / BK;
    }
    m0 = tile / n_tiles * RM;
    n0 = tile % n_tiles * BN;
  }

  // the ring stages this block's tiles take
  __device__ __forceinline__ int stages(const Scalars& p) const {
    int n = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0, k0, kb;
      at(tile, p, m0, n0, k0, kb);
      n += kb;
    }
    return n;
  }
};

// Arrive `count` times on barrier bar.
__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// A block's shared memory: the ring of stages (from a 1024-byte boundary
// of the shared window), the consumer groups' epilogue buffers, then the
// full and empty barriers of the stages.  A block uses its stages in
// order over all the tiles it computes: its n-th stage is slot n %
// STAGES, of parity (n / STAGES) % 2.
template <class T>
struct Ring {
  uint32_t base, epi, full, empty;

  __device__ __forceinline__ explicit Ring(const void* smem) {
    base = (smem_u32(smem) + 1023u) & ~1023u;
    epi = base + T::STAGES * T::STAGE;             // GROUPS x EPI_WG
    full = epi + T::GROUPS * T::EPI_WG;            // STAGES barriers
    empty = full + T::STAGES * 8;                  // STAGES barriers
  }

  // thread 0: a full barrier counts `arrivals` a stage, an empty one one
  // arrival from each consumer group; then the block synchronises
  __device__ __forceinline__ void init(int arrivals) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < T::STAGES; ++s) {
        mbar_init(full + 8 * s, arrivals);
        mbar_init(empty + 8 * s, T::GROUPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The CONV producer when c % 64 == 0: a 64-deep stage lies inside one tap
// (dy, dx), and its A tile is y's flat rows m0 + dy·w + dx .. +RM-1,
// channels c0 .. c0 + 63: one TMA load of the tensor map a1 (rows outside
// y load as zeros), beside B's.  A row whose neighbour falls outside its
// own image (the shift carries it into the next image row, or image) reads
// a real row of y here: the consumers zero those rows in their A
// fragments.  One thread issues every load, as for the dense products,
// and arrives `extra` times more on each full barrier (the stage kernel's
// barriers count 129 arrivals where one of its phases gathers).
template <int BN, int RM>
__device__ __forceinline__ void conv_tma_a(const Scalars& p, const Maps& mp,
                                           const Ring<Tile<BN, CONV, RM>>& r,
                                           int stage, uint32_t phase,
                                           int extra) {
  using T = Tile<BN, CONV, RM>;
  if (threadIdx.x != T::GROUPS * 128) return;
  tma_prefetch(mp.a1);
  tma_prefetch(mp.b1);
  const Walk<BN, CONV, RM> walk(p);
  for (int tile = blockIdx.x; tile < walk.tiles; tile += gridDim.x) {
    int m0, n0, k0, kbs;
    walk.at(tile, p, m0, n0, k0, kbs);
    for (int kb = 0; kb < kbs; ++kb) {
      const int kk0 = kb * BK, tap = kk0 / p.conv_c;
      const int shift = (tap / 3 - 1) * p.conv_w + tap % 3 - 1;
      const uint32_t st = r.base + stage * T::STAGE, bar = r.full + 8 * stage;
      mbar_wait(r.empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(bar, T::STAGE);
      if (extra) mbar_arrive_n(bar, extra);
      tma_load(st + T::A1, mp.a1, bar, kk0 - tap * p.conv_c, m0 + shift);
#pragma unroll
      for (int i = 0; i < T::BOXES; ++i)
        tma_load(st + T::B1 + i * BOX_MN, mp.b1, bar, n0 + 64 * i, kk0);
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The CONV producer: all 128 threads of the producer warpgroup fill each
// stage's RM x 64 A tile of the 3x3's implicit GEMM, A[r, t·c + ch] =
// y[r + dy·w + dx, ch] when the neighbour (dy, dx) = (t / 3 - 1, t % 3 -
// 1) of row r lies inside r's own image, else 0 (gemm_tile.cuh's
// Conv3x3A): k in the flat (tap, channel) order, the order of the k16
// steps of every other mode.  c % 8 == 0 keeps each 16-byte chunk inside
// one tap.  Thread t copies chunk t % 8 of rows t / 8 + 16j (j < RM / 16)
// with cp.async (zero-filled outside the image, past m and past k) into
// TMA's 128-byte swizzled layout; thread 0 also loads B by TMA.  A stage's
// full barrier counts 129 arrivals: thread 0's expect_tx for B, and one
// from each thread that the hardware makes once the thread's copies have
// landed (cp.async.mbarrier.arrive.noinc), so no thread waits for its own
// copies.  cp.async writes through the generic proxy, which wgmma's
// descriptors do not read without a proxy fence (a fence per stage, in
// the producer or the consumers, measured 2.5-3x slower a stage than the
// TMA products): the consumers take A into registers with ldmatrix and
// issue wgmma with A from registers, B through its descriptor.
template <int BN, int RM>
__device__ __forceinline__ void conv_a(const Scalars& p, const Maps& mp,
                                       const Ring<Tile<BN, CONV, RM>>& r,
                                       int stage, uint32_t phase) {
  using T = Tile<BN, CONV, RM>;
  constexpr int J = RM / 16;          // rows a thread copies
  const int t = threadIdx.x - T::GROUPS * 128, cc = t & 7, rb = t >> 3;
  const int c = p.conv_c, h = p.conv_h, w = p.conv_w, k_end = 9 * c;
  if (t == 0) tma_prefetch(mp.b1);
  const Walk<BN, CONV, RM> walk(p);
  for (int tile = blockIdx.x; tile < walk.tiles; tile += gridDim.x) {
    int m0, n0, k0, kbs;
    walk.at(tile, p, m0, n0, k0, kbs);
    // (row in image) << 16 | column of this thread's rows; rows past m
    // take a row past every image, so no tap is inside
    int yx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) yx[j] = image_yx(m0 + rb + 16 * j, p.m, h, w);
    for (int kb = 0; kb < kbs; ++kb) {
      const uint32_t st = r.base + stage * T::STAGE, bar = r.full + 8 * stage;
      mbar_wait(r.empty + 8 * stage, phase ^ 1);
      if (t == 0) {
        mbar_expect_tx(bar, T::TILE_B);
#pragma unroll
        for (int i = 0; i < T::BOXES; ++i)
          tma_load(st + T::B1 + i * BOX_MN, mp.b1, bar, n0 + 64 * i, kb * BK);
      }
      const int k = kb * BK + 8 * cc;
      const bool k_in = k < k_end;
      const int tap = k_in ? k / c : 4;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bf16* src0 = p.conv_y + (k - tap * c) +
                         static_cast<ptrdiff_t>(dy * w + dx) * c;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int rr = rb + 16 * j;
        const bool in = k_in && inside(yx[j], dy, dx, h, w);
        cp_async_16(st + T::A1 + rr * 128 + ((cc ^ (rr & 7)) << 4),
                    in ? src0 + static_cast<size_t>(m0 + rr) * c : p.conv_y,
                    in ? 16 : 0);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(bar)
                   : "memory");
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The producer warpgroup's part of a launch, from the ring's stage and
// parity given (the stage kernel's phases carry them on): CONV's
// producers above, else one thread that issues every TMA load, arriving
// `extra` times more on each full barrier.  WGRAD loads only the boxes
// that start inside a or b (a box wholly past m or n would hold only
// zeros, for rows and columns that are never stored) and expects their
// bytes.
template <int BN, int MODE, int RM>
__device__ __forceinline__ void produce(const Scalars& p, const Maps& mp,
                                        const Ring<Tile<BN, MODE, RM>>& r,
                                        int stage, uint32_t phase,
                                        int extra) {
  using T = Tile<BN, MODE, RM>;
  constexpr bool TWO = MODE == DUAL || MODE == PROJ;
  if constexpr (MODE == CONV) {
    if (p.conv_tma)
      conv_tma_a<BN, RM>(p, mp, r, stage, phase, extra);
    else
      conv_a<BN, RM>(p, mp, r, stage, phase);
  } else {
    if (threadIdx.x != T::GROUPS * 128) return;
    tma_prefetch(mp.a1);
    tma_prefetch(mp.b1);
    if constexpr (TWO) {
      tma_prefetch(mp.a2);
      tma_prefetch(mp.b2);
    }
    const Walk<BN, MODE, RM> walk(p);
    for (int tile = blockIdx.x; tile < walk.tiles; tile += gridDim.x) {
      int m0, n0, k0, kbs;
      walk.at(tile, p, m0, n0, k0, kbs);
      for (int kb = 0; kb < kbs; ++kb) {
        const int kk0 = k0 + kb * Walk<BN, MODE, RM>::KSTAGE;
        const uint32_t st = r.base + stage * T::STAGE,
                       bar = r.full + 8 * stage;
        mbar_wait(r.empty + 8 * stage, phase ^ 1);   // the slot is free
        if constexpr (MODE == WGRAD) {
          int boxes = 0;
#pragma unroll
          for (int i = 0; i < RM / 64; ++i) boxes += m0 + 64 * i < p.m;
#pragma unroll
          for (int i = 0; i < T::BOXES; ++i) boxes += n0 + 64 * i < p.n;
          mbar_expect_tx(bar, boxes * BOX_MN);
        } else {
          mbar_expect_tx(bar, T::STAGE);
        }
        if (extra) mbar_arrive_n(bar, extra);
        if constexpr (MODE == WGRAD) {
#pragma unroll
          for (int i = 0; i < RM / 64; ++i)
            if (m0 + 64 * i < p.m)
              tma_load(st + T::A1 + i * BOX_MN, mp.a1, bar, m0 + 64 * i, kk0);
#pragma unroll
          for (int i = 0; i < T::BOXES; ++i)
            if (n0 + 64 * i < p.n)
              tma_load(st + T::B1 + i * BOX_MN, mp.b1, bar, n0 + 64 * i, kk0);
        } else {
          tma_load(st + T::A1, mp.a1, bar, kk0, m0);
          if constexpr (MODE == DUAL) {
            tma_load(st + T::B1, mp.b1, bar, n0, kk0);
            tma_load(st + T::B1 + BOX_MN, mp.b1, bar, n0 + 64, kk0);
            tma_load(st + T::A2, mp.a2, bar, kk0, m0);
            tma_load(st + T::B2, mp.b2, bar, kk0, n0);
          } else if constexpr (MODE == PROJ) {
#pragma unroll
            for (int i = 0; i < T::BOXES; ++i) {
              tma_load(st + T::B1 + i * BOX_MN, mp.b1, bar, n0 + 64 * i, kk0);
              tma_load(st + T::B2 + i * BOX_MN, mp.b2, bar, n0 + 64 * i, kk0);
            }
            tma_load(st + T::A2, mp.a2, bar, kk0, m0);
          } else if constexpr (MODE == B_MN) {
#pragma unroll
            for (int i = 0; i < T::BOXES; ++i)
              tma_load(st + T::B1 + i * BOX_MN, mp.b1, bar, n0 + 64 * i, kk0);
          } else {                       // B_K and the int8 modes
            tma_load(st + T::B1, mp.b1, bar, kk0, n0);
          }
        }
        if (++stage == T::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// The consumer warpgroups' part of a launch (64 rows of each tile a
// group), from the ring's stage and parity given.
template <int BN, int MODE, int RM>
__device__ __forceinline__ void consume(const Scalars& p, const Maps& mp,
                                        const Ring<Tile<BN, MODE, RM>>& r,
                                        int stage, uint32_t phase) {
  using T = Tile<BN, MODE, RM>;
  constexpr bool DUALP = MODE == DUAL;
  constexpr bool TWO = MODE == DUAL || MODE == PROJ;   // two accumulators
  constexpr bool S8P = is_s8(MODE);
  constexpr int R = BN / 2;
  using Acc = std::conditional_t<S8P, int, float>;
  Acc acc1[R];
  float acc2[TWO ? R : 1];
  float facc[MODE == S8_GROUPS ? R : 1];   // the flushed K groups' sum
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const uint32_t a_rows = wg * 64 * 128;   // this group's 64 rows of A
  const Walk<BN, MODE, RM> walk(p);
  for (int tile = blockIdx.x; tile < walk.tiles; tile += gridDim.x) {
    int m0, n0, k0, kbs;
    walk.at(tile, p, m0, n0, k0, kbs);
    // this thread's first row (accumulators i % 4 < 2; +8 for the rest)
    const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
    // CONV by TMA: the image positions of the two rows whose A fragments
    // this thread holds (row0 and row0 + 8)
    int yx_lo = 0, yx_hi = 0;
    if constexpr (MODE == CONV) {
      yx_lo = image_yx(row0, p.m, p.conv_h, p.conv_w);
      yx_hi = image_yx(row0 + 8, p.m, p.conv_h, p.conv_w);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc1[i] = Acc(0);
    if constexpr (TWO) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc2[i] = 0.f;
    }
    if constexpr (MODE == S8_GROUPS) {
#pragma unroll
      for (int i = 0; i < R; ++i) facc[i] = 0.f;
    }
    for (int kb = 0; kb < kbs; ++kb) {
      mbar_wait(r.full + 8 * stage, phase);
      const uint32_t st = r.base + stage * T::STAGE;
      // CONV: A into registers (the gather writes it through the generic
      // proxy); wgmma reads only B through its descriptor.  By TMA, the
      // rows whose neighbour at this stage's tap lies outside their
      // image are zeroed here.
      uint32_t af[MODE == CONV ? BK / 16 : 1][4];
      if constexpr (MODE == CONV) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          ldmatrix_a(af[kk], st + T::A1, wg * 64 + warp * 16, 2 * kk, lane);
        if (p.conv_tma) {
          const int tap = kb * BK / p.conv_c, dy = tap / 3 - 1,
                    dx = tap % 3 - 1;
          const uint32_t lo = inside(yx_lo, dy, dx, p.conv_h, p.conv_w)
                                  ? ~0u : 0u;
          const uint32_t hi = inside(yx_hi, dy, dx, p.conv_h, p.conv_w)
                                  ? ~0u : 0u;
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            af[kk][0] &= lo;
            af[kk][2] &= lo;
            af[kk][1] &= hi;
            af[kk][3] &= hi;
          }
        }
      }
      fence_regs(acc1);
      if constexpr (TWO) fence_regs(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // a k16 (bf16) or k32 (int8) step is 32 bytes along a K-major
        // row, 16 rows (2048 bytes) down an MN-major box
        const uint64_t a1 = desc_sw128(st + T::A1 + a_rows + 32 * kk, 16,
                                       1024);
        if constexpr (DUALP) {
          wgmma<BN, 1>(acc1, a1,
                       desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024));
          wgmma<BN, 0>(acc2,
                       desc_sw128(st + T::A2 + a_rows + 32 * kk, 16, 1024),
                       desc_sw128(st + T::B2 + 32 * kk, 16, 1024));
        } else if constexpr (MODE == PROJ) {
          wgmma<BN, 1>(acc1, a1,
                       desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024));
          wgmma<BN, 1>(acc2,
                       desc_sw128(st + T::A2 + a_rows + 32 * kk, 16, 1024),
                       desc_sw128(st + T::B2 + 2048 * kk, BOX_MN, 1024));
        } else if constexpr (MODE == CONV) {
          wgmma_rs<BN, 1>(acc1, af[kk],
                          desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024));
        } else if constexpr (MODE == B_MN) {
          wgmma<BN, 1>(acc1, a1,
                       desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024));
        } else if constexpr (MODE == WGRAD) {
          // A: this group's 64-column box of a, its k16 step 16 rows
          // down, read transposed (MN-major) as B is
          wgmma<BN, 1, 1>(
              acc1, desc_sw128(st + T::A1 + wg * BOX_MN + 2048 * kk, BOX_MN,
                               1024),
              desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024));
        } else if constexpr (S8P) {
          wgmma_s8<BN>(acc1, a1, desc_sw128(st + T::B1 + 32 * kk, 16, 1024));
          if constexpr (MODE == S8_GROUPS) {
            // the k32 steps done; a K group ends here: retire the
            // products, flush, and restart the int32 sums (steps past k
            // read TMA's zeros and end no group)
            const int steps = kb * (BK / 16) + kk + 1;
            if (steps % p.group_steps == 0 && 32 * steps <= p.k) {
              wgmma_commit();
              fence_regs(acc1);
              wgmma_wait();
              flush_group(facc, acc1, p, row0, n0, lane,
                          steps / p.group_steps - 1);
              fence_regs(acc1);
              wgmma_fence();
            }
          }
        } else {
          wgmma<BN, 0>(acc1, a1, desc_sw128(st + T::B1 + 32 * kk, 16, 1024));
        }
      }
      wgmma_commit();
      fence_regs(acc1);
      if constexpr (TWO) fence_regs(acc2);
      wgmma_wait();       // this stage's products have read it
      if (threadIdx.x % 128 == 0) mbar_arrive(r.empty + 8 * stage);
      if (++stage == T::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    fence_regs(acc1);
    if constexpr (TWO) fence_regs(acc2);

    // epilogue: accumulator i of n-octet j holds row 16·warp + lane/4
    // (+8 for i = 2, 3) and columns 8j + 2·(lane % 4) (+1 for odd i)
    if constexpr (S8P) {
      const uint32_t buf = r.epi + wg * T::EPI_WG;
      if constexpr (MODE == S8_GROUPS) {
        store_s8<BN, T::LDE>(facc, p, buf, m0, n0, wg, warp, lane);
      } else {
        // the one K group's flush into a fresh fp32 sum
        float sum[R];
#pragma unroll
        for (int i = 0; i < R; ++i) sum[i] = 0.f;
        flush_group(sum, acc1, p, row0, n0, lane, 0);
        store_s8<BN, T::LDE>(sum, p, buf, m0, n0, wg, warp, lane);
      }
    } else if constexpr (DUALP) {
      // h to this group's 64 x 128 buffer (the layout TMA stores:
      // two 64-column boxes, 128-byte rows, chunks swizzled by row),
      // dhpre kept in acc2; stored by TMA, then dhpre likewise
      const uint32_t buf = r.epi + wg * T::EPI_WG;
      const int rr = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const float bias0 = col < p.n ? p.bias[col] : 0.f;
        const float bias1 = col < p.n ? p.bias[col + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          const float hp0 = acc1[i] + bias0, hp1 = acc1[i + 1] + bias1;
          acc2[i] *= dgelu_erf(hp0);
          acc2[i + 1] *= dgelu_erf(hp1);
          st_shared_bf16x2(buf + epi_offset(rr + 8 * half, j, lane),
                           gelu_erf(hp0), gelu_erf(hp1));
        }
      }
      store_tile(mp.o1, buf, n0, m0 + wg * 64, p, wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          st_shared_bf16x2(buf + epi_offset(rr + 8 * half, j, lane),
                           acc2[4 * j + 2 * half],
                           acc2[4 * j + 2 * half + 1]);
      store_tile(mp.o2, buf, n0, m0 + wg * 64, p, wg);
    } else if (MODE == WGRAD || p.epi == EPI_F32) {
      // fp32 pairs straight from the registers (WGRAD: into the partial
      // of the tile's chunk)
      float* out = static_cast<float*>(p.out1);
      if constexpr (MODE == WGRAD)
        out += static_cast<size_t>(k0 / WG_ROWS) * p.m * p.n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= p.n) continue;        // n % 8 == 0: col + 1 < n too
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= p.m) continue;
          reinterpret_cast<float2*>(out + static_cast<size_t>(row) * p.n +
                                    col)[0] =
              make_float2(acc1[4 * j + 2 * half],
                          acc1[4 * j + 2 * half + 1]);
        }
      }
    } else if constexpr (MODE == PROJ) {
      // the chain's arithmetic (EPI_BIAS for the shortcut, then
      // EPI_BIAS_RESID_RELU): sc = T(acc2 + bias2), y3 = T(acc1 + bias),
      // out = T(max(sc + y3, 0)) through the padded buffer
      const uint32_t buf = r.epi + wg * T::EPI_WG;
      const int rr = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const bool in = col < p.n;
        const float b0 = in ? p.bias[col] : 0.f;
        const float b1 = in ? p.bias[col + 1] : 0.f;
        const float s0 = in ? p.bias2[col] : 0.f;
        const float s1 = in ? p.bias2[col + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          const float v0 = to_f(from_f<bf16>(acc2[i] + s0)) +
                           to_f(from_f<bf16>(acc1[i] + b0));
          const float v1 = to_f(from_f<bf16>(acc2[i + 1] + s1)) +
                           to_f(from_f<bf16>(acc1[i + 1] + b1));
          st_shared_bf16x2(
              buf + 2 * ((rr + 8 * half) * T::LDE + 8 * j + 2 * (lane & 3)),
              fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
      }
      copy_out_bf16<BN, T::LDE>(buf, m0, n0, wg, p, false);
    } else {
      // bf16 out, gemm_tile.cuh's store_out arithmetic: o = T(acc +
      // bias), T(gelu(acc + bias)) or T(acc) into this group's padded 64
      // x BN buffer, then 16-byte chunks of rows below m and columns
      // below n out to device memory (EPI_BIAS_RELU takes max(o, 0)
      // there, the same bits as T(max(acc + bias, 0)): rounding keeps
      // the sign and 0; EPI_BIAS_RESID adds its residual chunk: T(aux +
      // o); EPI_BIAS_RESID_RELU T(max(aux + o, 0))).  A ReLU branch in
      // the register loop above cost the ViT products 4-30%.
      const uint32_t buf = r.epi + wg * T::EPI_WG;
      const int rr = warp * 16 + (lane >> 2);
      const bool bias = p.epi != EPI_NONE;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const bool in = bias && col < p.n;
        const float bias0 = in ? p.bias[col] : 0.f;
        const float bias1 = in ? p.bias[col + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = acc1[4 * j + 2 * half], v1 = acc1[4 * j + 2 * half + 1];
          if (bias) {
            v0 += bias0;
            v1 += bias1;
          }
          if (p.epi == EPI_BIAS_GELU) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          st_shared_bf16x2(
              buf + 2 * ((rr + 8 * half) * T::LDE + 8 * j + 2 * (lane & 3)),
              v0, v1);
        }
      }
      copy_out_bf16<BN, T::LDE>(
          buf, m0, n0, wg, p,
          p.epi == EPI_BIAS_RESID || p.epi == EPI_BIAS_RESID_RELU,
          p.epi == EPI_BIAS_RESID_RELU || p.epi == EPI_BIAS_RELU);
    }
  }
}

// One block: 384 threads; warpgroups 0 and 1 consume (64 rows each),
// warpgroup 2 produces (64-row tiles: 256 threads, warpgroup 0 consumes,
// 1 produces).  Output tiles RM x BN, walked persistently.  A stage is 128
// bytes of k deep: 64 bf16 or 128 int8.
template <int BN, int MODE, int RM = BM>
__global__ void __launch_bounds__(Tile<BN, MODE, RM>::THREADS,
                                  Tile<BN, MODE, RM>::BLOCKS_PER_SM)
gemm_kernel(const __grid_constant__ Args p) {
  using T = Tile<BN, MODE, RM>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<T> r(smem_raw);
  // the producer's expect_tx (CONV's gather: and each gathering thread's)
  r.init(MODE == CONV && !p.conv_tma ? 129 : 1);
  const Maps mp{&p.a1, &p.b1, &p.a2, &p.b2, &p.o1, &p.o2};
  if (threadIdx.x >> 7 == T::GROUPS) {
    // (CONV's gather: 128 producing threads, each holding its rows'
    // coordinates)
    setmaxnreg_dec<T::PRODUCER_REGS>();
    produce<BN, MODE, RM>(p, mp, r, 0, 0, 0);
  } else {
    setmaxnreg_inc<T::CONSUMER_REGS>();
    consume<BN, MODE, RM>(p, mp, r, 0, 0);
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded; null if the
// driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) bf16 (elem = 2) or int8 (elem = 1) matrix as
// boxes of 128 bytes of columns (swizzled) x box_rows rows; out-of-bounds
// elements load as zeros.
inline cudaError_t encode(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows, int elem = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map,
                        elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One persistent launch of gemm_kernel<BN, MODE, RM>: min(tiles, blocks
// the SMs hold at once) blocks.  The shared-memory limit is set and the SM
// count asked once per device.
template <int BN, int MODE, int RM = BM>
cudaError_t launch(const Args& args, int device, cudaStream_t s) {
  using T = Tile<BN, MODE, RM>;
  static std::atomic<int> limit[MAX_DEVICES];
  int sms = 0;
  cudaError_t err =
      smem_limit_once(gemm_kernel<BN, MODE, RM>, T::SMEM, limit);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(args.m, RM) * cdiv(args.n, BN) *
                    (MODE == WGRAD ? cdiv(args.k, WG_ROWS) : 1);
  const int slots = sms * T::BLOCKS_PER_SM;
  gemm_kernel<BN, MODE, RM>
      <<<tiles < slots ? tiles : slots, T::THREADS, T::SMEM, s>>>(args);
  return cudaGetLastError();
}

// Of `widths` (0: skipped), the tile width of a product of m rows and n
// columns whose rounds of tiles over the card's SMs cost least, a tile of
// width w taking w + fixed column-equivalents (its A tile, the k loop's
// fixed steps and the epilogue); the first of equal costs.
inline int least_rounds(int m, int n, int sms, int fixed,
                        const int (&widths)[4]) {
  int best = 0;
  long long best_cost = -1;
  for (const int w : widths) {
    if (w == 0) continue;
    const long long tiles =
        static_cast<long long>(cdiv(m, BM)) * cdiv(n, w);
    const long long cost = (tiles + sms - 1) / sms * (w + fixed);
    if (best_cost < 0 || cost < best_cost) {
      best = w;
      best_cost = cost;
    }
  }
  return best;
}

// The bf16 products' tile width (m rows, n columns, depth k): the least
// rounds at a fixed cost of TILE_FIXED.  An MN-major B at width 96 loads
// two 64-column boxes and its n96 steps ran about twice as long per k step
// as n128's (tools/bench_vit_fwd.py: fc2, k = 3072, 1576 rows, 0.0292 ms
// at 96 against 0.0203 at 128), so past MN96_MAX_K it is not picked.
constexpr int TILE_FIXED = 64, MN96_MAX_K = 1024;

inline int pick_bn(int m, int n, int k, bool mn_major, int sms) {
  const int widths[4] = {192, 128, mn_major && k > MN96_MAX_K ? 0 : 96, 64};
  return least_rounds(m, n, sms, TILE_FIXED, widths);
}

// The int8 products' tile width: the least rounds at a fixed cost of
// S8_TILE_FIXED (their k = 768 loop is 6 stages, the bf16 products' 12),
// and, when `narrow`, no 192-wide tile.  Fitted on ViT-B/16's products at
// 197-25216 rows (tools/bench_vit_fwd.py, NVIDIA H100 80GB HBM3): the
// fastest width at each but qkv at 3152 rows (96, 6% behind 192).
constexpr int S8_TILE_FIXED = 16;

inline int pick_bn_s8(int m, int n, bool narrow, int sms) {
  const int widths[4] = {narrow ? 0 : 192, 128, 96, 64};
  return least_rounds(m, n, sms, S8_TILE_FIXED, widths);
}

template <int MODE>
cudaError_t launch_width(int bn, const Args& args, int device,
                         cudaStream_t s) {
  switch (bn) {
    case 64: return launch<64, MODE>(args, device, s);
    case 96: return launch<96, MODE>(args, device, s);
    case 128: return launch<128, MODE>(args, device, s);
    case 192:
      // the grouped int8 product's consumers hold an int32 and an fp32
      // sum of BN / 2 registers each: at 192 ptxas spilled them (520
      // bytes a thread), so it stops at 128
      if constexpr (MODE == S8_GROUPS) return cudaErrorInvalidValue;
      else return launch<192, MODE>(args, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace
}  // namespace dfu
