// Fused 3-layer fusion-head MLP for Hopper (sm_90a).
//
// Replaces: dfu_multimodal_tpu/ops/fused_mlp.py::_fused_mlp_kernel (K3):
//   relu(relu(x·w1 + b1)·w2 + b2)·w3 + b3 in one pass, the eval forward of
//   the multimodal late-fusion head (2816 -> 512 -> 256 -> 2).
//
// What bounds it on the H100: bytes.  On the serving path x is fp32
//   (the trunks return fp32 features), so the weights are 5.8 MB of fp32
//   for 2·B·1.57 M FLOP: at B = 8 about 4 FLOP per weight byte, far under
//   the card's ridge, 1.7 us at 3.35 TB/s.  That rate needs w1 streamed by
//   most of the 132 SMs at once, with 16-byte loads.
//
// What the design does about it: one cooperative launch (grid no larger
//   than the card holds at once, as K12's stage kernel), two grid
//   barriers (cooperative_groups):
//   1. layer 1 split over (64-column block x K slice) tiles, the K slices
//      as deep as makes about one tile per SM (2816 = 16 x 176: 128 tiles
//      at 512 columns); each tile's weights are loaded once, all of a
//      thread's 16-byte loads in flight together, and staged in shared
//      memory as fp32 (k, column); each weight then feeds the 8 batch rows
//      of a pass (x staged beside it; a batch of any size takes passes of
//      8 rows).  Thread (quarter, column) sums its quarter of the slice in
//      k order, and the quarters are added in order.  The fp32 partial
//      sums go to scratch, (slice, batch, column); barrier;
//   2. h1 = T(relu(sum of the slices' partials in slice order + b1)),
//      spread over every thread of the grid, to scratch; barrier;
//   3. layer 2 on h1 as layer 1 on x (at most 8 K slices);
//   4. layer 3 through arrival tickets (an atomic add on counters block 0
//      zeroed before the barrier, each after a fence that makes the
//      block's writes visible): the last K slice of each 64-column block
//      of layer 2 to arrive makes that block's h2 = T(relu(sum of the
//      slices + b2)) and its share of h2·w3, and the last column block to
//      finish sums the shares in column-block order + b3.  No block reads
//      more than its own column block's partials, so the tail is spread
//      over the card (one SM reading all of them took 9-12 us).
//   Every staging step issues all of a thread's loads before it uses one
//   (x beside the weights, the partials slice by slice): the kernel is a
//   chain of a few load latencies, not of one per element.
//   No atomics on values: every sum has a fixed order, so two calls give
//   equal bits.
//   A weight is read in place in either layout: (in, out) row-major (the
//   JAX layout) or nn.Linear's (out, in) weight seen transposed, so the
//   model passes fc.weight.t() and copies nothing per call.  A 16-byte
//   load holds 4 (fp32) or 8 (bf16) columns of one k row in the first, as
//   many k of one column in the second; both are staged into the same
//   (k, column) tile and summed by the same code, so the two layouts give
//   equal bits.
//
// Numerics follow the Pallas kernel: operands in x's dtype (fp32 or bf16),
// fp32 accumulation, ReLU on the fp32 sum plus bias, hidden activations
// rounded to x's dtype, fp32 output.  The sums run in another order than
// a single pass would (quarters of K slices, then the slices).

#include "common.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace dfu {
namespace {

namespace cg = cooperative_groups;

// threads a block; output columns a tile; batch rows a pass; the deepest K
// slice (a multiple of 16 rows: whole 16-byte chunks of a K-major weight,
// and GROUPS equal row quarters); the most K slices of layer 2 (layer 3
// sums them per element); the staged tile's row stride in floats
constexpr int THREADS = 256, WARPS = THREADS / 32, CB = 64, BT = 8;
constexpr int GROUPS = THREADS / CB, KS_MAX = 256, S2_MAX = 8, LDW = CB + 1;

// the staged weights, x and the row quarters' sums, fp32; layer 3 stages
// BT rows of a column block's h2 and its CB rows of w3 (up to D3_MAX
// wide) in the same space
constexpr int SMEM = static_cast<int>(sizeof(float)) *
                     (KS_MAX * LDW + BT * KS_MAX + GROUPS * BT * CB);
constexpr int D3_MAX = 256;
static_assert(BT * CB + CB * D3_MAX <= SMEM / static_cast<int>(sizeof(float)),
              "layer 3's staging");

// A (k, n) weight in x's dtype read in place: element (kk, nn) at
// w[kk·ld + nn] (N-major, the (in, out) layout) or w[nn·ld + kk] (K-major,
// nn.Linear's (out, in) weight seen transposed).  vec: 16-byte loads of
// whole chunks are aligned (base and ld).
struct Weight {
  const void* w;
  int kmajor, ld, vec;
};

struct Params {
  const void* x;          // (batch, d0), x's dtype
  Weight w[3];
  const float* b[3];
  float* out;             // (batch, d3) fp32
  float* p1;              // (s1, batch, d1) scratch: layer 1's partials
  float* p2;              // (s2, batch, d2) scratch: layer 2's partials
  float* h1;              // (batch, d1) scratch: layer 2's input
  float* q;               // (ncb2, batch, d3) scratch: layer 3's partials
  unsigned* tickets;      // scratch: ncb2 column blocks' + 1
  int batch, d0, d1, d2, d3;
  int ks1, s1, ks2, s2;   // each layer's K slice depth and slice count
};

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// `valid` elements of x's dtype at p (the rest 0), as 16 raw bytes: one
// 16-byte load when `vec` and the chunk is whole.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int valid, int vec) {
  if (vec && valid == vec_of<T>())
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < vec_of<T>(); ++i)
    if (i < valid) e[i] = p[i];
  return r;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int i) {
  return to_f(reinterpret_cast<const T*>(&r)[i]);
}

// The layer's input rows b0.. (BT of them, zeros past the batch) x the K
// slice k0..k0+kn (zeros past it) as fp32, row stride ks: load_x reads a
// thread's XPT elements into registers (X(b, kk) gives one), all reads in
// flight together, and store_x puts them into xs.
constexpr int XPT = BT * KS_MAX / THREADS;

template <typename XLoad>
__device__ __forceinline__ void load_x(const XLoad& X, int batch, int b0,
                                       int k0, int kn, int ks,
                                       float (&v)[XPT]) {
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = threadIdx.x + THREADS * j, bb = i / ks, kk = i % ks;
    v[j] = i < BT * ks && b0 + bb < batch && kk < kn ? X(b0 + bb, k0 + kk)
                                                     : 0.f;
  }
}

__device__ __forceinline__ void store_x(const float (&v)[XPT], int ks,
                                        float* __restrict__ xs) {
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = threadIdx.x + THREADS * j;
    if (i < BT * ks) xs[i] = v[j];
  }
}

// Layer 1's input: x (batch, d0) in its dtype.
template <typename T>
struct InputX {
  const T* x;
  int d0;
  __device__ __forceinline__ float operator()(int b, int kk) const {
    return to_f(x[static_cast<size_t>(b) * d0 + kk]);
  }
};

// Layer 2's input: h1 (batch, d1), fp32 values of x's dtype, made by the
// grid from layer 1's partials before the second barrier (other blocks
// wrote it: read past L1).
struct HiddenX {
  const float* h1;
  int d1;
  __device__ __forceinline__ float operator()(int b, int kk) const {
    return __ldcg(h1 + static_cast<size_t>(b) * d1 + kk);
  }
};

// Chunk i of a staged tile (ks rows, CB columns): its first row kk and
// column c, and whether the tile has it.  N-major: chunk i holds VEC
// columns of row i / (CB / VEC).  K-major: VEC rows of one column, chunk
// kq = 4·(i / THREADS) + i % 4 along k of column (i / 4) % CB.
template <int VEC>
__device__ __forceinline__ bool chunk_at(int kmajor, int i, int ks, int& kk,
                                         int& c) {
  if (kmajor) {
    const int kq = 4 * (i / THREADS) + i % 4;
    kk = kq * VEC;
    c = i / 4 % CB;
    return kk < ks;
  }
  kk = i / (CB / VEC);
  c = i % (CB / VEC) * VEC;
  return kk < ks;
}

// One tile's weights, rows k0..k0+kn (zeros to ks) and columns c0..c0+CB
// (zeros past n), into ws[k·LDW + c] as fp32, whatever the weight's
// layout: every 16-byte chunk of the tile is loaded first (NCH a thread,
// all in flight at once), then stored.  N-major: a warp loads two rows of
// 16 (fp32) or 32 (bf16) chunks.  K-major: a warp loads 4 chunks along k
// of each of 8 columns (whole 32-byte sectors), chunk index along k
// kq = 4·(i / 256) + i % 4, column (i / 4) % 64 for chunk i = tid +
// 256·it; with LDW = 65 its stores fall on distinct banks but for pairs.
template <typename T>
__device__ __forceinline__ void stage_w(const Weight& W, int n, int ks,
                                        int c0, int k0, int kn,
                                        float* __restrict__ ws) {
  constexpr int VEC = vec_of<T>(), NCH = KS_MAX * CB / VEC / THREADS;
  const T* w = static_cast<const T*>(W.w);
  const int tid = threadIdx.x;
  uint4 wr[NCH];
#pragma unroll
  for (int it = 0; it < NCH; ++it) {
    int kk, c;
    const bool in = chunk_at<VEC>(W.kmajor, tid + THREADS * it, ks, kk, c);
    const int valid = !in ? 0
                      : W.kmajor ? (c0 + c < n ? min(VEC, kn - kk) : 0)
                                 : (kk < kn ? min(VEC, n - c0 - c) : 0);
    const T* src = W.kmajor ? w + static_cast<size_t>(c0 + c) * W.ld + k0 + kk
                            : w + static_cast<size_t>(k0 + kk) * W.ld + c0 + c;
    wr[it] = valid > 0 ? load_chunk(src, valid, W.vec)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < NCH; ++it) {
    int kk, c;
    if (!chunk_at<VEC>(W.kmajor, tid + THREADS * it, ks, kk, c)) continue;
    if (W.kmajor) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ws[(kk + e) * LDW + c] = elem<T>(wr[it], e);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) ws[kk * LDW + c + e] = elem<T>(wr[it], e);
    }
  }
}

// The fp32 partial sums of one layer, P[s][b][n] = sum over k in K slice s
// of X[b][k]·W[k][n], over this block's (column block, slice) tiles, and
// done(column block, smem) after each.  X (a loader) gives the input.
// The tile's weights are staged once (stage_w),
// then each pass of BT batch rows: thread (g, c) sums its column c over
// the g-th quarter of the slice's rows in k order, and the four quarters
// are added in order through shared memory.  Both layouts run this one
// sum, so they give equal bits.
template <typename T, typename XLoad, typename Done>
__device__ void layer_partials(const XLoad& X, const Weight& W, int batch,
                               int k, int n, int ks, int slices,
                               float* __restrict__ P, float* smem,
                               const Done& done) {
  float* ws = smem;                         // KS_MAX x LDW
  float* xs = ws + KS_MAX * LDW;            // BT x ks
  float* red = xs + BT * KS_MAX;            // GROUPS x BT x CB
  const int tid = threadIdx.x, c = tid % CB, g = tid / CB;
  const int ncb = (n + CB - 1) / CB, tiles = ncb * slices;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c0 = tile % ncb * CB, s = tile / ncb, k0 = s * ks;
    const int kn = min(ks, k - k0), rows = ks / GROUPS;
    float xv[XPT];
    load_x(X, batch, 0, k0, kn, ks, xv);      // beside the weights' loads
    stage_w<T>(W, n, ks, c0, k0, kn, ws);
    for (int b0 = 0; b0 < batch; b0 += BT) {
      if (b0 > 0) load_x(X, batch, b0, k0, kn, ks, xv);
      store_x(xv, ks, xs);
      __syncthreads();
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      for (int kk = g * rows; kk < (g + 1) * rows; ++kk) {
        const float wv = ws[kk * LDW + c];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(xs[b * ks + kk], wv, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) red[(g * BT + b) * CB + c] = acc[b];
      __syncthreads();
      for (int o = tid; o < BT * CB; o += THREADS) {
        const int b = o / CB, cc = o % CB;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < GROUPS; ++q) v += red[(q * BT + b) * CB + cc];
        if (b0 + b < batch && c0 + cc < n)
          P[(static_cast<size_t>(s) * batch + b0 + b) * n + c0 + cc] = v;
      }
      __syncthreads();
    }
    done(tile % ncb, smem);
  }
}

// What a block does once a tile's partials are written: nothing (layer 1).
struct NoTail {
  __device__ void operator()(int, float*) const {}
};

template <typename T>
__device__ __forceinline__ float weight_at(const Weight& W, int kk, int nn) {
  const T* w = static_cast<const T*>(W.w);
  return to_f(W.kmajor ? w[static_cast<size_t>(nn) * W.ld + kk]
                       : w[static_cast<size_t>(kk) * W.ld + nn]);
}

// Take an arrival ticket on *counter (after a fence that makes this
// block's writes visible) and return whether this block arrived last of
// `of`; the last block then fences before it reads the others' writes.
__device__ __forceinline__ bool last_of(unsigned* counter, unsigned of) {
  __shared__ unsigned arrived;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    arrived = atomicAdd(counter, 1u);
  }
  __syncthreads();
  if (arrived != of - 1) return false;
  __threadfence();
  return true;
}

// After a layer-2 tile of column block cb: the last of the block's s2 K
// slices to arrive finishes it, h2 = T(relu(sum of the slices in slice
// order + b2)) for its columns c0.. (a pass of BT rows at a time, staged
// in shared memory with its rows of w3, every read of a pass in flight at
// once), and layer 3's partial q[cb][b][o] = sum over those columns of
// h2·w3 (a warp per (row, output), lanes over the columns, a butterfly);
// the last column block to finish sums q in column-block order + b3.
template <typename T>
struct Layer3 {
  const Params& p;
  __device__ void operator()(int cb, float* smem) const {
    if (!last_of(p.tickets + cb, p.s2)) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c0 = cb * CB, ncb = (p.d2 + CB - 1) / CB;
    const int nw = CB * p.d3;
    float* hs = smem;                      // BT x CB
    float* w3s = smem + BT * CB;           // CB x d3
    const size_t step = static_cast<size_t>(p.batch) * p.d2;
    for (int b0 = 0; b0 < p.batch; b0 += BT) {
      for (int base = 0; base < BT * CB || base < nw; base += 2 * THREADS) {
        float v[2], wv[2];
        const float* at[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = base + tid + THREADS * j;
          const int b = b0 + i / CB, c = c0 + i % CB;
          const int kk = c0 + i / p.d3, o = i % p.d3;
          wv[j] = i < nw && kk < p.d2 ? weight_at<T>(p.w[2], kk, o) : 0.f;
          v[j] = 0.f;
          at[j] = i < BT * CB && b < p.batch && c < p.d2
                      ? p.p2 + static_cast<size_t>(b) * p.d2 + c
                      : nullptr;
        }
        for (int s0 = 0; s0 < p.s2; s0 += S2_MAX)
#pragma unroll
          for (int u = 0; u < S2_MAX; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (at[j] != nullptr && s0 + u < p.s2)
                v[j] += __ldcg(at[j] + (s0 + u) * step);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = base + tid + THREADS * j;
          if (i < BT * CB)
            hs[i] = at[j] == nullptr
                        ? 0.f
                        : to_f(from_f<T>(fmaxf(v[j] + p.b[1][c0 + i % CB],
                                               0.f)));
          if (i < nw) w3s[i] = wv[j];
        }
      }
      __syncthreads();
      for (int pr = warp; pr < BT * p.d3; pr += WARPS) {
        const int b = pr / p.d3, o = pr % p.d3;
        float acc = 0.f;
        for (int c = lane; c < CB; c += 32)
          acc = fmaf(hs[b * CB + c], w3s[c * p.d3 + o], acc);
        acc = warp_sum(acc);
        if (lane == 0 && b0 + b < p.batch)
          p.q[(static_cast<size_t>(cb) * p.batch + b0 + b) * p.d3 + o] = acc;
      }
      __syncthreads();
    }
    if (!last_of(p.tickets + ncb, ncb)) return;
    for (int i = tid; i < p.batch * p.d3; i += THREADS) {
      float v = 0.f;
      for (int c = 0; c < ncb; ++c)
        v += __ldcg(p.q + static_cast<size_t>(c) * p.batch * p.d3 + i);
      p.out[i] = v + p.b[2][i % p.d3];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  // 1. layer 1's partial sums; the layer-2 tickets zeroed before the
  //    barrier that orders them before every arrival
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= (p.d2 + CB - 1) / CB; i += THREADS)
      p.tickets[i] = 0u;
  layer_partials<T>(InputX<T>{static_cast<const T*>(p.x), p.d0}, p.w[0],
                    p.batch, p.d0, p.d1, p.ks1, p.s1, p.p1, smem, NoTail{});
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  // 2. h1 = T(relu(sum of layer 1's slices in slice order + b1)), spread
  //    over the grid
  const size_t step = static_cast<size_t>(p.batch) * p.d1;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < p.batch * p.d1;
       i += gridDim.x * THREADS) {
    float v = 0.f;
#pragma unroll 16
    for (int s = 0; s < p.s1; ++s) v += __ldcg(p.p1 + s * step + i);
    p.h1[i] = to_f(from_f<T>(fmaxf(v + p.b[0][i % p.d1], 0.f)));
  }
  grid.sync();
  // 3. layer 2's partial sums; 4. each column block's last slice to
  //    arrive runs its share of layer 3, the last column block the sum
  layer_partials<T>(HiddenX{p.h1, p.d1}, p.w[1], p.batch, p.d1, p.d2,
                    p.ks2, p.s2, p.p2, smem, Layer3<T>{p});
}

// The split of one launch: each layer's K slices (about one tile of CB
// columns per SM for layer 1; at most S2_MAX for layer 2), slice depths
// multiples of 16 (whole 16-byte chunks) no deeper than KS_MAX, and the
// scratch's byte offsets (16-byte aligned).
struct Plan {
  int ks1, s1, ks2, s2;
  size_t off_p2, off_h1, off_q, off_tickets, bytes;
};

inline int slice_depth(int k, int slices) {
  const int d = (cdiv(k, slices) + 15) / 16 * 16;
  return d < KS_MAX ? d : KS_MAX;
}

inline Plan plan(int sms, int batch, int d0, int d1, int d2, int d3) {
  Plan q{};
  const int per1 = sms / cdiv(d1, CB);
  q.ks1 = slice_depth(d0, per1 > 1 ? per1 : 1);
  q.s1 = cdiv(d0, q.ks1);
  const int per2 = sms / cdiv(d2, CB);
  q.ks2 = slice_depth(d1, per2 < 1 ? 1 : per2 < S2_MAX ? per2 : S2_MAX);
  q.s2 = cdiv(d1, q.ks2);
  auto up16 = [](size_t v) { return (v + 15) / 16 * 16; };
  const int ncb2 = cdiv(d2, CB);
  q.off_p2 = up16(sizeof(float) * q.s1 * batch * d1);
  q.off_h1 = q.off_p2 + up16(sizeof(float) * q.s2 * batch * d2);
  q.off_q = q.off_h1 + up16(sizeof(float) * batch * d1);
  q.off_tickets = q.off_q + up16(sizeof(float) * ncb2 * batch * d3);
  q.bytes = q.off_tickets + up16(sizeof(unsigned) * (ncb2 + 1));
  return q;
}

inline Weight weight(const void* w, int kmajor, int ld, int elem) {
  const int vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  ld % (16 / elem) == 0;
  return {w, kmajor, ld, vec};
}

template <typename T>
cudaError_t launch(Params& p, int device, cudaStream_t s) {
  static std::atomic<int> limit[MAX_DEVICES];
  static std::atomic<int> occupancy[MAX_DEVICES];   // 0: not asked yet
  const void* kernel = reinterpret_cast<const void*>(fused_mlp_kernel<T>);
  cudaError_t err = smem_limit_once(fused_mlp_kernel<T>, SMEM, limit);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  int per_sm = device < MAX_DEVICES ? occupancy[device].load() : 0;
  if (per_sm == 0) {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    if (device < MAX_DEVICES) occupancy[device].store(per_sm);
  }
  const int tiles1 = cdiv(p.d1, CB) * p.s1, tiles2 = cdiv(p.d2, CB) * p.s2;
  const int want = tiles1 > tiles2 ? tiles1 : tiles2;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  void* args[] = {&p};
  // a refused launch returns its error and leaves it as the last error:
  // read it back so that it is cleared, not reported by the next call
  cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args, SMEM,
                              s);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dfu

using namespace dfu;

extern "C" {

const char* dfu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The bytes of scratch dfu_fused_mlp needs for this shape, into *bytes.
int dfu_fused_mlp_scratch(int device, int batch, int d0, int d1, int d2,
                          int d3, long long* bytes) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = static_cast<long long>(plan(sms, batch, d0, d1, d2, d3).bytes);
  return 0;
}

// x (batch, d0) contiguous in the compute dtype; w1 (d0, d1), w2 (d1, d2),
// w3 (d2, d3) in x's dtype, each either row-major (kmajor 0, row stride
// ld = its column count) or the transposed view of an (out, in) row-major
// matrix (kmajor 1, ld = its row count); biases fp32; out (batch, d3)
// fp32; scratch of dfu_fused_mlp_scratch's bytes.  One cooperative launch;
// cudaErrorNotSupported on a card without cooperative launch;
// cudaErrorInvalidValue past d3 = D3_MAX (layer 3 stages a column
// block's rows of w3 in shared memory).
int dfu_fused_mlp(int device, int dtype, const void* x, const void* w1,
                  int kmajor1, int ld1, const void* b1, const void* w2,
                  int kmajor2, int ld2, const void* b2, const void* w3,
                  int kmajor3, int ld3, const void* b3, void* out,
                  void* scratch, int batch, int d0, int d1, int d2, int d3,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || d0 < 1 || d1 < 1 || d2 < 1 || d3 < 1 || d3 > D3_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elem = dtype == DT_BF16 ? 2 : 4;
  const Plan q = plan(sms, batch, d0, d1, d2, d3);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Params p{};
  p.x = x;
  p.w[0] = weight(w1, kmajor1, ld1, elem);
  p.w[1] = weight(w2, kmajor2, ld2, elem);
  p.w[2] = weight(w3, kmajor3, ld3, elem);
  p.b[0] = static_cast<const float*>(b1);
  p.b[1] = static_cast<const float*>(b2);
  p.b[2] = static_cast<const float*>(b3);
  p.out = static_cast<float*>(out);
  p.p1 = reinterpret_cast<float*>(base);
  p.p2 = reinterpret_cast<float*>(base + q.off_p2);
  p.h1 = reinterpret_cast<float*>(base + q.off_h1);
  p.q = reinterpret_cast<float*>(base + q.off_q);
  p.tickets = reinterpret_cast<unsigned*>(base + q.off_tickets);
  p.batch = batch;
  p.d0 = d0;
  p.d1 = d1;
  p.d2 = d2;
  p.d3 = d3;
  p.ks1 = q.ks1;
  p.s1 = q.s1;
  p.ks2 = q.ks2;
  p.s2 = q.s2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == DT_BF16 ? launch<bf16>(p, device, s)
                                           : launch<float>(p, device, s));
}

}  // extern "C"
