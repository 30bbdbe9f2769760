// The bf16 softmax-attention forward of K6, K9 and K1's attention step on
// Hopper's tensor cores (sm_90a), over the strided operand of
// attention_kernels.cuh.
//
// Replaces (dfu_multimodal_tpu/ops/attention.py), in bf16:
//   K9 _attention_fwd_kernel: q, k, v (B, H, N, D) -> o (B, H, N, D);
//   K6 _qkv_attention_fwd_kernel: packed qkv (B, N, 3C) -> attn (B, N, C);
// and (dfu_multimodal_tpu/ops/vit_block.py, vit_block_q8.py) K1
// _attn_block_kernel's and K7/K8 _attn_block_q8(s)_kernel's per-head
// _attention_head over their packed qkv, with the DEFER flag (K7/K8 with
// an fp32 output).  fp32 keeps the SIMT kernels of attention_kernels.cuh
// (attention_fwd_kernel / attention_fwd_tiled) and of attention_core.cuh
// (K1, K7, K8): TF32 products would miss fp32's budget.
//
// What bounds it on the H100: per (image, head) two N x N x D products
// (S = QKᵀ, O = PV) against q, k, v read once and o written once.  At
// ViT-B/16's serving shape (B = 8, 12 heads, N = 197, D = 64) that is
// 0.95 GFLOP (1 us at 989 TFLOP/s) against 9.7 MB (2.9 us at 3.35 TB/s):
// the bytes bound it.
//
// What the design does about it: one block of 4 warps per 64 query rows
// of one (head, image) — grid (cdiv(N, 64), heads, batch), 384 blocks at
// the serving shape, all resident at once (46 KB of shared memory and
// 128 threads each) — so the card reads each operand from device memory
// about once and K, V a few more times from L2.  Each warp owns 16 query
// rows; its Q fragment stays in registers for the whole block.  K and V
// stream through shared memory in 64-key bf16 tiles, a two-stage
// cp.async ring of 16-byte chunks (rows padded by 16 bytes at D >= 16, so
// the 8 rows an ldmatrix reads fall on distinct banks; D = 8's 16-byte
// rows need no padding).  Products are
// mma.sync.m16n8k16 bf16 with fp32 accumulation, operands from ldmatrix
// (.trans for V, whose rows are keys).  Two passes over the key tiles:
//   1. S = QKᵀ per tile; the running row max m and the running sum l of
//      exp(S − m) (l rescaled by exp(m_old − m_new) when m grows), each
//      reduced over the quad of lanes that hold a row;
//   2. S recomputed, P = exp(S − m) · (1/l) rounded to bf16 in registers:
//      the m16n8 accumulator fragments of two key octets are the A
//      fragment of the next k16 step of O += P·V (no round trip through
//      shared memory).
// O is rounded to bf16 once, staged in the Q tile's shared memory and
// stored in 16-byte chunks (an fp32 O, the int8 blocks', is stored from
// the fragments).  Pass 2 recomputes S: 3 N²D products for 2,
// and each score's exponential is taken twice.  Those, not the bytes,
// bound it on the card: the exponential is exp(x − y) = 2^(x·log2 e −
// y·log2 e), one FFMA (the scale after the product folded in) and one
// ex2.approx on the MUFU unit per score and pass, and only the last tile
// is masked.
//
// The numbers are the Pallas kernels' (_softmax_probs_c): bf16 score
// operands with fp32 accumulation; when d^-0.5 is a power of two (D = 16,
// 64) q is scaled in bf16 before the product (exact: an exponent shift),
// else the fp32 scores are scaled after it (inside the FFMA above); fp32
// row max and sum, the exponential within ~1e-6 of expf relative (P is
// then rounded to bf16, 4e-3); P
// normalised BEFORE P·V and rounded to bf16; O accumulated in fp32 and
// rounded to bf16 once.  No online rescale of O (FlashAttention-2's
// normalisation after P·V is a different function).  Keys past N get −inf
// before the max; query rows past N are zero-filled and never stored.
//
// ToMe's key bias (K1/K7/K8 with proportional attention): an optional
// fp32 (batch, n) row, bias[b][j] added to every query's score of key j
// in natural-log units, as the Pallas kernels add it: S·scale (S alone
// when q was pre-scaled) rounded, plus the bias, rounded, then times
// log2 e; never S·(scale·log2 e) + bias.  Both passes add it to the
// recomputed S of each tile before the last tile's −inf mask, so they
// see the same scores; keys past n read no bias.  K6 and K9 pass none.
//
// DEFER, K1's numerics (_attention_head): the softmax division is
// deferred past P·V.  Pass 1 takes the row max alone (no exponential);
// pass 2 forms e = exp(S − m) in fp32, adds the uncast e into the fp32
// row sum l, rounds e to bf16 as the A fragment of O += bf16(e)·V, and the
// end divides O by l and rounds to bf16 once.  The same two passes and
// products, one exponential a score instead of two.
//
// D = 128 (K1's widest head): 85 KB of shared memory, so two blocks an
// SM.  D = 8: the k16 step of S = QKᵀ needs 16 columns, so the upper halves of
// the fragments (Q's a2, a3 and K's b1: columns 8..15) are zero registers;
// P·V needs nothing extra (its k-dimension is the keys, n8 = D).
//
// Needs 16-byte-aligned rows: the base pointers 16-byte aligned (the
// wrappers raise otherwise) and every stride a multiple of 8 elements,
// which D in {8, 16, 32, 64, 128} gives every layout.  Sums have a fixed order
// (no atomics): two calls give the same bits.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace dfu {
namespace {

constexpr int MMA_WARPS = 4, MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_BM = 16 * MMA_WARPS;   // query rows per block
constexpr int MMA_BN = 64;               // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; with src_bytes = 0 the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), each
// rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of a register times `scale` in fp32, each rounded back to
// bf16 (q pre-scaled as the compute dtype rounds it)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * scale, __high2float(v) * scale);
}

template <int D>
struct MmaFwd {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 128,
                "head dim");
  static constexpr int LDS = D == 8 ? 8 : D + 8;  // shared row, elements
  static constexpr int CHUNKS = D / 8;            // 16-byte chunks a row
  static constexpr int KSTEPS = D < 16 ? 1 : D / 16;  // k16 steps of QKᵀ
  static constexpr int OT = D / 8;                // n8 tiles of O
  static constexpr int TILE = MMA_BN * LDS;       // elements of a tile
  // Q | K stage 0 | V stage 0 | K stage 1 | V stage 1: 45 KB at D = 64,
  // 85 KB at D = 128 (dynamic shared memory past 48 KB)
  static constexpr int SMEM = 5 * TILE * 2;
};

// Rows r0 .. r0 + 63 of head (b, h) of `x` into `dst` (LDS-element rows);
// rows past n are zero-filled.
template <int D, typename Op>
__device__ __forceinline__ void load_tile_async(const Op& x, int b, int h,
                                                int r0, int n, bf16* dst) {
  using S = MmaFwd<D>;
  for (int i = threadIdx.x; i < MMA_BN * S::CHUNKS; i += MMA_THREADS) {
    const int r = i / S::CHUNKS, c = i % S::CHUNKS;
    const bool in = r0 + r < n;
    cp_async16(dst + r * S::LDS + c * 8, x.row(b, h, in ? r0 + r : 0) + c * 8,
               in ? 16 : 0);
  }
}

// 2^x on the MUFU unit (ex2.approx: within 2 ulp of fp32 2^x; results
// below 2^-126 flush to 0, 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// S (16 x 64 fp32: eight m16n8 fragments) = this warp's Q rows against
// the 64 keys of the tile at ks.  Lane l addresses row l % 8 of ldmatrix
// matrix l / 8.
template <int D>
__device__ __forceinline__ void score_tile(
    const uint32_t (&qf)[MmaFwd<D>::KSTEPS][4], const bf16* ks, int lane,
    float (&s)[8][4]) {
  using S = MmaFwd<D>;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (D == 8) {
    // b0 of key octets 4h .. 4h + 3 (columns 0..7); b1, columns 8..15, is 0
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t b[4];
      ldsm_x4(b, ks + (32 * hf + lane) * S::LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(s[4 * hf + j], qf[0], b[j], 0u);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices: keys 16np + 0..7 | 8..15 by lane / 16, columns
        // 16kk + 0..7 | 8..15 by (lane / 8) % 2 -> b0, b1 of octets
        // 2np and 2np + 1
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * np + (lane & 7) + 8 * (lane >> 4)) * S::LDS +
                       16 * kk + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
  }
}

// DEFER: K1's numerics (pass 1 the row max alone; pass 2 the sum from the
// uncast exponentials and O = bf16(e)·V divided by it at the end), else
// K6/K9's (P normalised before P·V).
template <int D, bool DEFER, typename In, typename Out>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma(In q, In k, In v, Out o, int n, float scale, int pow2,
                  const float* __restrict__ bias) {
  using S = MmaFwd<D>;
  // Q | K stage 0 | V stage 0 | K stage 1 | V stage 1; O is staged in Q's
  extern __shared__ __align__(16) bf16 fwd_mma_sm[];
  bf16* const sm = fwd_mma_sm;
  bf16* qs = sm;
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * MMA_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + MMA_BN - 1) / MMA_BN, steps = 2 * tiles;

  // step st < tiles (pass 1) loads K tile st; step st >= tiles (pass 2)
  // loads K and V of tile st - tiles; stage st % 2
  auto prefetch = [&](int st) {
    bf16* kst = sm + (1 + 2 * (st & 1)) * S::TILE;
    const int j0 = (st < tiles ? st : st - tiles) * MMA_BN;
    load_tile_async<D>(k, b, h, j0, n, kst);
    if (st >= tiles) load_tile_async<D>(v, b, h, j0, n, kst + S::TILE);
  };
  load_tile_async<D>(q, b, h, r0, n, qs);
  prefetch(0);
  cp_async_commit();

  uint32_t qf[S::KSTEPS][4];
  // rows g = lane / 4 and g + 8 of the warp's 16: the running max of the
  // scaled scores in base-2 units (S·post) and the running sum of
  // 2^(S·post − m) = exp(S·scale − max)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  float oacc[S::OT][4];
#pragma unroll
  for (int t = 0; t < S::OT; ++t) oacc[t][0] = oacc[t][1] = oacc[t][2] =
      oacc[t][3] = 0.f;
  // the scale after the product (1 when q was scaled before it), times
  // log2 e: exp(x − y) = 2^(x·log2 e − y·log2 e), one FFMA and one ex2.
  // With a key bias the scale goes in first (pre, below) and post is
  // log2 e alone.
  const float pre = pow2 ? 1.f : scale;
  const float post = (bias != nullptr ? 1.f : pre) * LOG2E;
  const float* brow = bias != nullptr ? bias + static_cast<size_t>(b) * n
                                      : nullptr;

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) prefetch(st + 1);
    cp_async_commit();                    // an empty group at the last step
    cp_async_wait_one();                  // step st's tile (and Q) landed
    __syncthreads();
    if (st == 0) {
      // a0..a3: rows 0..7 | 8..15 by (lane / 8) % 2, columns 0..7 | 8..15
      // by lane / 16
      const bf16* qrow =
          qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * S::LDS;
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk) {
        if constexpr (D == 8) {
          ldsm_x2(qf[kk][0], qf[kk][1], qrow);
          qf[kk][2] = qf[kk][3] = 0u;     // columns 8..15 of the k16 step
        } else {
          ldsm_x4(qf[kk], qrow + 16 * kk + 8 * (lane >> 4));
        }
        if (pow2) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
        }
      }
    }
    const bf16* ks = sm + (1 + 2 * (st & 1)) * S::TILE;
    const int j0 = (st < tiles ? st : st - tiles) * MMA_BN;
    float s[8][4];
    score_tile<D>(qf, ks, lane, s);
    // fragment s[j]: keys j0 + 8j + 2(lane % 4) + {0, 1}, rows g ([0], [1])
    // and g + 8 ([2], [3]); the key bias (natural-log units), then in the
    // last tile keys past n get −inf
    if (brow != nullptr) {
      const int c0 = j0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * j + e;
          const float bk = key < n ? __ldg(brow + key) : 0.f;
          s[j][e] = __fadd_rn(__fmul_rn(s[j][e], pre), bk);
          s[j][e + 2] = __fadd_rn(__fmul_rn(s[j][e + 2], pre), bk);
        }
    }
    if (n - j0 < MMA_BN) {
      const int c0 = j0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + (e & 1) >= n) s[j][e] = -INFINITY;
    }

    if (st < tiles) {                     // pass 1: running max and sum
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        mt[r] = fmaxf(m[r], mt[r] * post);  // post > 0 keeps the order
        if constexpr (!DEFER)
          l[r] *= fast_exp2(m[r] - mt[r]);  // 0 at the first tile
        m[r] = mt[r];
      }
      // DEFER: the max alone; its sum is taken in pass 2
      if constexpr (!DEFER) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          l[0] += fast_exp2(fmaf(s[j][0], post, -m[0])) +
                  fast_exp2(fmaf(s[j][1], post, -m[0]));
          l[1] += fast_exp2(fmaf(s[j][2], post, -m[1])) +
                  fast_exp2(fmaf(s[j][3], post, -m[1]));
        }
        if (st == tiles - 1) {            // the quad's partial sums
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            inv[r] = 1.f / l[r];
          }
        }
      }
    } else {                              // pass 2: O += P·V
      const bf16* vs = ks + S::TILE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // keys 16kk .. 16kk + 15: octets 2kk and 2kk + 1 of S are the A
        // fragment (a0 = row g, a1 = row g + 8; a2, a3 the next octet)
        uint32_t pa[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* f = s[2 * kk + hf];
          if constexpr (DEFER) {
            // e = exp(S − m) in fp32: its sum uncast, its bf16 the operand
            const float e0 = fast_exp2(fmaf(f[0], post, -m[0]));
            const float e1 = fast_exp2(fmaf(f[1], post, -m[0]));
            const float e2 = fast_exp2(fmaf(f[2], post, -m[1]));
            const float e3 = fast_exp2(fmaf(f[3], post, -m[1]));
            l[0] += e0 + e1;
            l[1] += e2 + e3;
            pa[2 * hf] = pack_bf16(e0, e1);
            pa[2 * hf + 1] = pack_bf16(e2, e3);
          } else {
            pa[2 * hf] =
                pack_bf16(fast_exp2(fmaf(f[0], post, -m[0])) * inv[0],
                          fast_exp2(fmaf(f[1], post, -m[0])) * inv[0]);
            pa[2 * hf + 1] =
                pack_bf16(fast_exp2(fmaf(f[2], post, -m[1])) * inv[1],
                          fast_exp2(fmaf(f[3], post, -m[1])) * inv[1]);
          }
        }
        // V rows (keys) 16kk + 0..7 | 8..15 by (lane / 8) % 2, columns
        // 16dp + 0..7 | 8..15 by lane / 16, transposed: b0, b1 of O's
        // octets 2dp and 2dp + 1
        const bf16* vrow =
            vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * S::LDS;
        if constexpr (D == 8) {
          uint32_t b0, b1;
          ldsm_x2_t(b0, b1, vrow);
          mma_bf16(oacc[0], pa, b0, b1);
        } else {
#pragma unroll
          for (int dp = 0; dp < S::OT / 2; ++dp) {
            uint32_t bv[4];
            ldsm_x4_t(bv, vrow + 16 * dp + 8 * (lane >> 4));
            mma_bf16(oacc[2 * dp], pa, bv[0], bv[1]);
            mma_bf16(oacc[2 * dp + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                      // the stage is the next-but-one's
  }

  if constexpr (DEFER) {
    // the quad's partial sums, then O / l (a division, as the Pallas
    // kernel's o / s)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int dt = 0; dt < S::OT; ++dt) {
      oacc[dt][0] /= l[0];
      oacc[dt][1] /= l[0];
      oacc[dt][2] /= l[1];
      oacc[dt][3] /= l[1];
    }
  }
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same_v<decltype(o.p), float*>) {
    // an fp32 O (the int8 blocks' attention output): fp32 pairs of the
    // rows below n straight from the fragments, 32 contiguous bytes a
    // row and quad
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 16 * warp + g + 8 * half;
      if (row >= n) continue;
#pragma unroll
      for (int dt = 0; dt < S::OT; ++dt)
        *reinterpret_cast<float2*>(o.row(b, h, row) + 8 * dt + 2 * t) =
            make_float2(oacc[dt][2 * half], oacc[dt][2 * half + 1]);
    }
  } else {
    // O in bf16 through the warp's own rows of the Q tile, then 16-byte
    // stores of the rows below n
    bf16* ow = qs + 16 * warp * S::LDS;
#pragma unroll
    for (int dt = 0; dt < S::OT; ++dt) {
      *reinterpret_cast<uint32_t*>(ow + g * S::LDS + 8 * dt + 2 * t) =
          pack_bf16(oacc[dt][0], oacc[dt][1]);
      *reinterpret_cast<uint32_t*>(ow + (g + 8) * S::LDS + 8 * dt + 2 * t) =
          pack_bf16(oacc[dt][2], oacc[dt][3]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * S::CHUNKS; i += 32) {
      const int r = i / S::CHUNKS, c = i % S::CHUNKS;
      const int row = r0 + 16 * warp + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o.row(b, h, row) + 8 * c) =
            *reinterpret_cast<const uint4*>(ow + r * S::LDS + 8 * c);
    }
  }
}

// Launches the bf16 forward on (batch, heads, n) of strided q, k, v, o
// (DEFER: K1's numerics; bias: the fp32 (batch, n) key bias, or none);
// returns the CUDA error of the launch.  Past 48 KB of shared memory
// (D = 128) the limit is raised once per device.
template <int D, bool DEFER = false, typename In, typename Out>
int launch_attention_fwd_mma(In q, In k, In v, Out o, int batch, int heads,
                             int n, float scale, int pow2, cudaStream_t s,
                             const float* bias = nullptr) {
  constexpr int smem = MmaFwd<D>::SMEM;
  if constexpr (smem > 48 * 1024) {
    static std::atomic<int> limit[MAX_DEVICES];
    const cudaError_t err = smem_limit_once(
        attention_fwd_mma<D, DEFER, In, Out>, smem, limit);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_fwd_mma<D, DEFER><<<dim3(cdiv(n, MMA_BM), heads, batch),
                                MMA_THREADS, smem, s>>>(q, k, v, o, n, scale,
                                                        pow2, bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dfu
