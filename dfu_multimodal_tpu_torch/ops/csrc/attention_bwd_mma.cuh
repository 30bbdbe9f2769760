// The bf16 softmax-attention backward of K5, K6, K9 and K10's attention
// step on Hopper's tensor cores (sm_90a), over the strided operand of
// attention_kernels.cuh, for every token count.
//
// Replaces (dfu_multimodal_tpu/ops/attention.py), in bf16:
//   K9 _attention_bwd_kernel: q, k, v, dO (B, H, N, D) -> dq, dk, dv;
//   K6 _qkv_attention_bwd_kernel: packed qkv (B, N, 3C), dO (B, N, C) ->
//      dqkv (B, N, 3C);
//   K5 _qkv_attention_fwdbwd_kernel: the same, and the re-forward output
//      O (B, N, C) from the same softmax (WRITE_O);
// and the attention step of K10 (vit_block.py::_attn_block_bwd_kernel),
// which attn_block_bwd.cu runs through qkv_bwd<T, true> with q pre-scaled.
// fp32 keeps the SIMT kernels of attention_kernels.cuh: TF32 products
// would miss fp32's gradient budget.
//
// What bounds it on the H100: per (image, head) five N x N x D products
// (S = QKᵀ, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO; six with O =
// P·V) against q, k, v, dO read once and dq, dk, dv (and O) written once.
// At ViT-B/16's training shape (B = 16, 12 heads, N = 197, D = 64) that
// is 4.8 GFLOP (4.8 us at 989 TFLOP/s) against 34 MB (10 us at 3.35
// TB/s): the bytes bound it.
//
// What the design does about it: the FlashAttention-2 split into a
// query-side and a key-side kernel, both grid (cdiv(N, 64), heads,
// batch), 4 warps x 16 rows, mma.sync.m16n8k16 bf16 with fp32
// accumulation and ldmatrix operands, with the forward's pieces
// (attention_fwd_mma.cuh): the two-stage cp.async ring of 64-row tiles
// with 16-byte-padded rows, the ex2-based exponential, −inf on the keys
// past N of the last tile, zero upper fragment halves at D = 8.  No
// atomics: each output element is summed by one warp, in tile order, and
// two calls give the same bits.
//   1. Query side (attention_bwd_q_mma): each warp keeps its 16 rows of q
//      and dO as A fragments in registers and walks the key tiles three
//      times:
//      (a) S = QKᵀ; the running row max m and the rescaled sum l (the
//          forward's pass 1);
//      (b) S again, P = exp(S − m)·(1/l) in fp32, dP = dO·Vᵀ; δ +=
//          rowsum(dP∘P) in fp32; with WRITE_O, O += P_c·V, P_c rounded to
//          bf16 in registers as the A fragment;
//      (c) S and dP again; dS = P∘(dP − δ) rounded to bf16 in registers,
//          the A fragment of dQ += dS·K (K's keys as k, ldmatrix.trans).
//      It writes dQ·scale and O, and each row's m, 1/l and δ to the fp32
//      `stats` scratch (3·batch·heads·N floats).
//   2. Key side (attention_bwd_kv_mma): each warp keeps its 16 keys of K
//      and V as A fragments and walks the query tiles (q, dO and their
//      rows' stats through the ring) in order, per 32-query half:
//      Sᵀ = K·Qᵀ, Pᵀ from the stats (query rows past N masked to 0, their
//      stats never used), dPᵀ = V·dOᵀ, dSᵀ = Pᵀ∘(dPᵀ − δ) rounded to bf16;
//      dV += Pᵀ_c·dO and dK += dSᵀ·Q, both A fragments from registers and
//      the B operands (queries as k) by ldmatrix.trans.  dK·scale and dV
//      are stored once.
//   That is 10 (11 with O) N²D products for the single-pass 5 (6), and
//   four exponentials a score; no N x N tensor reaches device memory.
//
// The numbers are the Pallas kernels' (_softmax_probs_c and the backward
// around it): bf16 score operands with fp32 accumulation; q scaled in
// bf16 before the product when `pow2` is set (d^-0.5 a power of two, or
// K10 for every D), else the fp32 scores scaled after it; fp32 max and
// sum, P normalised in fp32; δ = rowsum(dP∘P) from the fp32 P and dP
// (not rowsum(dO∘O), which differs by O's rounding); dS = P∘(dP − δ)
// rounded to bf16; P rounded to bf16 for O and dV; dQ = dS·K·scale and
// dK = dSᵀ·Q·scale with Q unscaled; each output rounded to bf16 once.
// The key side scores Sᵀ with Q as the B operand: a power-of-two scale is
// exact in bf16, so it is folded into the exponent's FFMA there; any
// other pre-scale (K10 at D = 8, 32) rounds each B fragment of Q in
// registers as the query side rounds q.  Sᵀ and S are the same products
// in another operand order, so P need not match the query side's bit for
// bit; it is within the exponential's 2 ulp.
//
// Needs 16-byte-aligned rows (the wrappers raise otherwise), as the
// forward.
#pragma once

#include <stdint.h>

#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace dfu {
namespace {

// 4 bytes from device to shared memory (zero-filled when src_bytes = 0)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// This warp's 16 rows at `rows` (LDS-element rows of a shared tile) as
// the A fragments of the k16 steps over D.
template <int D>
__device__ __forceinline__ void load_a_frags(
    uint32_t (&af)[MmaFwd<D>::KSTEPS][4], const bf16* rows, int lane) {
  using S = MmaFwd<D>;
  const bf16* r = rows + ((lane & 7) + 8 * ((lane >> 3) & 1)) * S::LDS;
#pragma unroll
  for (int kk = 0; kk < S::KSTEPS; ++kk) {
    if constexpr (D == 8) {
      ldsm_x2(af[kk][0], af[kk][1], r);
      af[kk][2] = af[kk][3] = 0u;         // columns 8..15 of the k16 step
    } else {
      ldsm_x4(af[kk], r + 16 * kk + 8 * (lane >> 4));
    }
  }
}

// s (16 x 32 fp32: four m16n8 fragments) = the A rows `af` against the 32
// rows at `rows` of a shared tile (the B operand, its rows as n); with
// `bscale` each B register is first multiplied by `mul` and rounded to
// bf16.  The forward's score_tile for half a tile.
template <int D>
__device__ __forceinline__ void score_half(
    const uint32_t (&af)[MmaFwd<D>::KSTEPS][4], const bf16* rows, int lane,
    float (&s)[4][4], bool bscale = false, float mul = 1.f) {
  using S = MmaFwd<D>;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if constexpr (D == 8) {
    // b0 of octets 0..3 (columns 0..7); b1, columns 8..15, is 0
    uint32_t b[4];
    ldsm_x4(b, rows + lane * S::LDS);
    if (bscale) {
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = scale_bf16x2(b[i], mul);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_bf16(s[j], af[0], b[j], 0u);
  } else {
#pragma unroll
    for (int kk = 0; kk < S::KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, rows + (16 * np + (lane & 7) + 8 * (lane >> 4)) * S::LDS +
                       16 * kk + 8 * ((lane >> 3) & 1));
        if (bscale) {
#pragma unroll
          for (int i = 0; i < 4; ++i) b[i] = scale_bf16x2(b[i], mul);
        }
        mma_bf16(s[2 * np], af[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], af[kk], b[2], b[3]);
      }
    }
  }
}

// acc (16 x D fp32) += a (16 x 16 bf16, registers) · the 16 rows at `rows`
// of a shared tile (rows as k, columns as n: ldmatrix.trans).
template <int D>
__device__ __forceinline__ void mma_rows_t(float (&acc)[MmaFwd<D>::OT][4],
                                           const uint32_t (&a)[4],
                                           const bf16* rows, int lane) {
  using S = MmaFwd<D>;
  const bf16* r = rows + ((lane & 7) + 8 * ((lane >> 3) & 1)) * S::LDS;
  if constexpr (D == 8) {
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, r);
    mma_bf16(acc[0], a, b0, b1);
  } else {
#pragma unroll
    for (int dp = 0; dp < S::OT / 2; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, r + 16 * dp + 8 * (lane >> 4));
      mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
    }
  }
}

// The A fragment of the k16 step over columns 16kk .. 16kk + 15 from the
// fp32 fragments x[2kk], x[2kk + 1] (rows g, g + 8), each rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x0)[4],
                                       const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[MmaFwd<D>::OT][4]) {
#pragma unroll
  for (int t = 0; t < MmaFwd<D>::OT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
}

// The warp's 16 x D accumulator times `mul`, rounded to bf16, through its
// own 16 rows at `stage` of a shared tile, then 16-byte stores to rows
// row0 .. row0 + 15 of head (b, h) of `out` that lie below n.
template <int D, typename Out>
__device__ __forceinline__ void store_rows(
    const float (&acc)[MmaFwd<D>::OT][4], float mul, bf16* stage,
    const Out& out, int b, int h, int row0, int n, int lane) {
  using S = MmaFwd<D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < S::OT; ++dt) {
    *reinterpret_cast<uint32_t*>(stage + g * S::LDS + 8 * dt + 2 * t) =
        pack_bf16(acc[dt][0] * mul, acc[dt][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * S::LDS + 8 * dt + 2 * t) =
        pack_bf16(acc[dt][2] * mul, acc[dt][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * S::CHUNKS; i += 32) {
    const int r = i / S::CHUNKS, c = i % S::CHUNKS;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out.row(b, h, row0 + r) + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * S::LDS + 8 * c);
  }
  __syncwarp();
}

// Shared memory of each kernel, bytes: six tiles (the query side: Q, dO,
// two stages of K and V; the key side: K, V, two stages of Q and dO),
// and on the key side two stages of the query tile's stats.
template <int D>
constexpr size_t bwd_mma_smem(bool keys) {
  return 6 * MmaFwd<D>::TILE * sizeof(bf16) +
         (keys ? 2 * 3 * MMA_BN * sizeof(float) : 0);
}

template <int D, bool WRITE_O, typename In, typename Out>
__global__ void __launch_bounds__(MMA_THREADS)
attention_bwd_q_mma(In q, In k, In v, In dout, Out o, Out dq, float* stats,
                    int n, float scale, int pow2) {
  using S = MmaFwd<D>;
  extern __shared__ __align__(16) unsigned char bwd_mma_sm[];
  bf16* sm = reinterpret_cast<bf16*>(bwd_mma_sm);
  bf16* qs = sm;                          // Q; O is staged in its rows
  bf16* dos = sm + S::TILE;               // dO; dQ is staged in its rows
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * MMA_BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + MMA_BN - 1) / MMA_BN, steps = 3 * tiles;

  // step st: pass st / tiles over key tile st % tiles; pass (a) loads K,
  // passes (b) and (c) K and V; stage st % 2
  auto prefetch = [&](int st) {
    bf16* kst = sm + (2 + 2 * (st & 1)) * S::TILE;
    const int j0 = (st % tiles) * MMA_BN;
    load_tile_async<D>(k, b, h, j0, n, kst);
    if (st >= tiles) load_tile_async<D>(v, b, h, j0, n, kst + S::TILE);
  };
  load_tile_async<D>(q, b, h, r0, n, qs);
  load_tile_async<D>(dout, b, h, r0, n, dos);
  prefetch(0);
  cp_async_commit();

  uint32_t qf[S::KSTEPS][4], dof[S::KSTEPS][4];
  // rows g = lane / 4 and g + 8 of the warp's 16: the running max in
  // base-2 units (S·post), the running sum, 1 / sum, and δ
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float inv[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float acc[S::OT][4];                    // O in pass (b), then dQ
  zero_acc<D>(acc);
  const float post = (pow2 ? 1.f : scale) * LOG2E;
  const int c0 = 2 * (lane & 3);

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) prefetch(st + 1);
    cp_async_commit();                    // an empty group at the last step
    cp_async_wait_one();                  // step st's tiles (and Q, dO)
    __syncthreads();
    if (st == 0) {
      load_a_frags<D>(qf, qs + 16 * warp * S::LDS, lane);
      load_a_frags<D>(dof, dos + 16 * warp * S::LDS, lane);
      if (pow2) {
#pragma unroll
        for (int kk = 0; kk < S::KSTEPS; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
      }
    }
    const int pass = st / tiles, j0 = (st - pass * tiles) * MMA_BN;
    const bf16* ks = sm + (2 + 2 * (st & 1)) * S::TILE;
    const bf16* vs = ks + S::TILE;
    const bool last = n - j0 < MMA_BN;

    if (pass == 0) {                      // (a): running max and sum
      float s[8][4];
      score_tile<D>(qf, ks, lane, s);
      if (last) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + c0 + 8 * j + (e & 1) >= n) s[j][e] = -INFINITY;
      }
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
        mt[r] = fmaxf(m[r], mt[r] * post);
        l[r] *= fast_exp2(m[r] - mt[r]);
        m[r] = mt[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l[0] += fast_exp2(fmaf(s[j][0], post, -m[0])) +
                fast_exp2(fmaf(s[j][1], post, -m[0]));
        l[1] += fast_exp2(fmaf(s[j][2], post, -m[1])) +
                fast_exp2(fmaf(s[j][3], post, -m[1]));
      }
      if (st == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          inv[r] = 1.f / l[r];
        }
      }
    } else {                              // (b) δ (and O), (c) dQ
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float p[4][4], dp[4][4];
        score_half<D>(qf, ks + 32 * hf * S::LDS, lane, p);
        score_half<D>(dof, vs + 32 * hf * S::LDS, lane, dp);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool past =
                last && j0 + 32 * hf + c0 + 8 * j + (e & 1) >= n;
            p[j][e] = past ? 0.f
                           : fast_exp2(fmaf(p[j][e], post, -m[r])) * inv[r];
            if (pass == 1)
              dl[r] = fmaf(dp[j][e], p[j][e], dl[r]);
            else                          // dS, in dp's registers
              dp[j][e] = p[j][e] * (dp[j][e] - dl[r]);
          }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const bf16* rows =
              (pass == 1 ? vs : ks) + (32 * hf + 16 * kk) * S::LDS;
          uint32_t a[4];
          if (pass == 1) {
            if constexpr (WRITE_O) {
              pack_a(a, p[2 * kk], p[2 * kk + 1]);
              mma_rows_t<D>(acc, a, rows, lane);
            }
          } else {
            pack_a(a, dp[2 * kk], dp[2 * kk + 1]);
            mma_rows_t<D>(acc, a, rows, lane);
          }
        }
      }
      if (st == 2 * tiles - 1) {          // δ complete; O out
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
          dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
        }
        if constexpr (WRITE_O) {
          store_rows<D>(acc, 1.f, qs + 16 * warp * S::LDS, o, b, h,
                        r0 + 16 * warp, n, lane);
          zero_acc<D>(acc);
        }
      }
    }
    __syncthreads();                      // the stage is the next-but-one's
  }

  store_rows<D>(acc, scale, dos + 16 * warp * S::LDS, dq, b, h,
                r0 + 16 * warp, n, lane);
  if ((lane & 3) == 0) {
    const long long rows = static_cast<long long>(gridDim.z) * gridDim.y * n;
    const long long bh = static_cast<long long>(b) * gridDim.y + h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * warp + (lane >> 2) + 8 * r;
      if (row < n) {
        stats[bh * n + row] = m[r];
        stats[rows + bh * n + row] = inv[r];
        stats[2 * rows + bh * n + row] = dl[r];
      }
    }
  }
}

// Three blocks an SM: at most 168 registers a thread (unbounded it takes
// 220 at D = 64 and two fit; tools/bench_attention_bwd.py times both).
template <int D, typename In, typename Out>
__global__ void __launch_bounds__(MMA_THREADS, 3)
attention_bwd_kv_mma(In q, In k, In v, In dout, Out dk, Out dv,
                     const float* stats, int n, float scale, int pow2) {
  using S = MmaFwd<D>;
  extern __shared__ __align__(16) unsigned char bwd_mma_sm[];
  bf16* sm = reinterpret_cast<bf16*>(bwd_mma_sm);
  bf16* ks = sm;                          // K; dK is staged in its rows
  bf16* vs = sm + S::TILE;                // V; dV is staged in its rows
  float* sst = reinterpret_cast<float*>(sm + 6 * S::TILE);
  const int h = blockIdx.y, b = blockIdx.z, j0 = blockIdx.x * MMA_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (n + MMA_BN - 1) / MMA_BN;
  const long long rows = static_cast<long long>(gridDim.z) * gridDim.y * n;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  // query tile it: Q and dO rows, and each row's m, 1/l, δ (zero past n)
  auto prefetch = [&](int it) {
    bf16* qst = sm + (2 + 2 * (it & 1)) * S::TILE;
    const int i0 = it * MMA_BN;
    load_tile_async<D>(q, b, h, i0, n, qst);
    load_tile_async<D>(dout, b, h, i0, n, qst + S::TILE);
    float* st = sst + (it & 1) * 3 * MMA_BN;
    for (int i = threadIdx.x; i < 3 * MMA_BN; i += MMA_THREADS) {
      const int a = i / MMA_BN, r = i % MMA_BN;
      const bool in = i0 + r < n;
      cp_async4(st + i, stats + a * rows + bh * n + (in ? i0 + r : 0),
                in ? 4 : 0);
    }
  };
  load_tile_async<D>(k, b, h, j0, n, ks);
  load_tile_async<D>(v, b, h, j0, n, vs);
  prefetch(0);
  cp_async_commit();

  // a power-of-two scale is exact in bf16: fold it into the exponent;
  // another pre-scale rounds Q's B fragments as the query side rounds q
  const bool exact = (__float_as_uint(scale) & 0x7fffffu) == 0;
  const bool bscale = pow2 && !exact;
  const float post = (bscale ? 1.f : scale) * LOG2E;
  const int c0 = 2 * (lane & 3);
  uint32_t kf[S::KSTEPS][4], vf[S::KSTEPS][4];
  float dka[S::OT][4], dva[S::OT][4];
  zero_acc<D>(dka);
  zero_acc<D>(dva);

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) prefetch(it + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (it == 0) {
      load_a_frags<D>(kf, ks + 16 * warp * S::LDS, lane);
      load_a_frags<D>(vf, vs + 16 * warp * S::LDS, lane);
    }
    const int i0 = it * MMA_BN;
    const bf16* qt = sm + (2 + 2 * (it & 1)) * S::TILE;
    const bf16* dot = qt + S::TILE;
    const float* mt = sst + (it & 1) * 3 * MMA_BN;
    const float* it_inv = mt + MMA_BN;
    const float* it_dl = mt + 2 * MMA_BN;
    const bool last = n - i0 < MMA_BN;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // fragment j: keys g, g + 8 of the warp's 16 ([0, 1], [2, 3]) and
      // queries 32hf + 8j + c0 + {0, 1} of the tile
      float p[4][4], ds[4][4];
      score_half<D>(kf, qt + 32 * hf * S::LDS, lane, p, bscale, scale);
      score_half<D>(vf, dot + 32 * hf * S::LDS, lane, ds);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * hf + 8 * j + c0 + (e & 1);
          if (last && i0 + c >= n) {
            p[j][e] = ds[j][e] = 0.f;
          } else {
            p[j][e] = fast_exp2(fmaf(p[j][e], post, -mt[c])) * it_inv[c];
            ds[j][e] = p[j][e] * (ds[j][e] - it_dl[c]);
          }
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = (32 * hf + 16 * kk) * S::LDS;
        uint32_t a[4];
        pack_a(a, p[2 * kk], p[2 * kk + 1]);
        mma_rows_t<D>(dva, a, dot + r, lane);
        pack_a(a, ds[2 * kk], ds[2 * kk + 1]);
        mma_rows_t<D>(dka, a, qt + r, lane);
      }
    }
    __syncthreads();
  }

  store_rows<D>(dka, scale, ks + 16 * warp * S::LDS, dk, b, h,
                j0 + 16 * warp, n, lane);
  store_rows<D>(dva, 1.f, vs + 16 * warp * S::LDS, dv, b, h, j0 + 16 * warp,
                n, lane);
}

// Sets a kernel's dynamic shared memory and launches it on `grid` x
// `threads`; returns the CUDA error of either.
template <typename K, typename... A>
int launch_dyn(K kernel, dim3 grid, int threads, size_t smem,
               cudaStream_t s, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launches the bf16 backward on (batch, heads, n): the query side, then
// the key side on the same stream; `stats` is fp32 scratch of
// 3·batch·heads·n floats.  Returns the CUDA error of a launch.
template <int D, bool WRITE_O, typename In, typename Out>
int launch_attention_bwd_mma(In q, In k, In v, In dout, Out o, Out dq,
                             Out dk, Out dv, float* stats, int batch,
                             int heads, int n, float scale, int pow2,
                             cudaStream_t s) {
  const dim3 grid(cdiv(n, MMA_BM), heads, batch);
  const int err = launch_dyn(attention_bwd_q_mma<D, WRITE_O, In, Out>, grid,
                             MMA_THREADS, bwd_mma_smem<D>(false), s, q, k, v,
                             dout, o, dq, stats, n, scale, pow2);
  if (err != 0) return err;
  return launch_dyn(attention_bwd_kv_mma<D, In, Out>, grid, MMA_THREADS,
                    bwd_mma_smem<D>(true), s, q, k, v, dout, dk, dv,
                    static_cast<const float*>(stats), n, scale, pow2);
}

}  // namespace
}  // namespace dfu
