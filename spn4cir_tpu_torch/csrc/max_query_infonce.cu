// Max-over-query bank InfoNCE for Hopper (sm_90a): the BLIP-2 stage-2 loss's
// forward statistics and its backward dfeats, over a dense (M, Q, D) bank and
// over an int8 one with (M, Q) scales.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` (reached through
// `_run_forward` and `_run_backward` of `max_query_infonce_pallas`) in
// spn4cir_tpu/ops/maxquery_kernels.py.
//
//     sims[b, m, q] = feats[b] · bank[m, q]             (int8: · s[m, q] too)
//     logits[b, m]  = max_q sims[b, m, q] / tau          (B, M), never stored
//     forward : per row  mx = max_m logits, se = Σ_m exp(logits - mx),
//               pos = logits[label], el = Σ_m exp(logits - mx)·logits;
//               loss = mean_b(log se + mx - pos),
//               dtau_unit = mean_b((pos - el/se) / tau)
//     backward: dfeats[b] = Σ_m w[b, m] · bank[m, q*(b, m)],
//               w = (P - onehot(label)) · g  (int8: · s[m, q*]),
//               P = exp(logits - mx)/se from the saved (mx, se),
//               g = gout / (B·tau), q* = the FIRST q that reaches the max
//
// int8: the scale multiplies the sim BEFORE the max and 1/tau follows, in the
// TPU kernel's order of roundings; the backward's weight carries the scale of
// the routed query and the product runs on the raw values. bf16 and int8
// values widen exactly to float32, so every product is a float32 FMA on the
// CUDA cores. feats (B, D) float32; labels int32 (B,); B, M, Q >= 1; D % 32
// == 0. Rows past B and bank rows past M are masked in the kernels: nothing
// is padded outside. The bank is read in its own (M, Q, D) layout (the TPU
// path relaid it out to (Q, Mp, D) for its VMEM blocks).
//
// What bounds it (B = 32, M = 65,536, Q = 32, D = 256): the forward reads the
// bank once, 2.15 GB in float32 (1.07 GB bf16; 0.54 GB int8 + 8.4 MB of
// scales), and does 2·B·M·Q·D = 34.4 GFLOP: 0.641 ms at 3.35 TB/s for float32,
// and by operations 0.513 ms at 67 TFLOP/s for bf16 and int8. The backward
// does the same plus 2·B·M·D for the routed sum (35.4 GFLOP; 0.641 / 0.529
// ms). At 16 bytes of float32 bank per 2·B = 64 operations the float32 FMA
// rate, not memory, bounds it once the bank chunk is shared by all the CTA's
// rows. The design:
//   - grid = (bank splits, row tiles); a split is a run of tiles of kCols
//     bank rows; about one CTA per SM (`split_plan`);
//   - the CTA's 32 feats rows are staged ONCE in shared memory, transposed
//     (B > 32 takes more row tiles: grid.y = ceil(B / 32)); the bank is streamed in chunks of kCols rows x 32
//     depth for one query q at a time, prefetched into registers one chunk
//     ahead, widened into shared memory; each thread computes a 4 x 8 block
//     of the (rows x kCols) sims tile, and after the last depth chunk folds
//     it into a running max over q held in registers;
//   - forward: after the last q of a tile, online-softmax statistics per row
//     over the thread's columns; at the end of the split the threads that
//     share a row merge with xor shuffles and one float4 (mx, se, pos, el)
//     per (split, row) goes to scratch; a one-block merge kernel combines
//     the splits in index order and writes the statistics, the loss and
//     dtau_unit;
//   - backward: the running max keeps its argmax (strictly greater moves it,
//     so the first q wins a tie, as the TPU's `taken` mask does); after the
//     last q of a tile the weights and the routed q go to shared memory, and
//     each warp adds w · bank[m, q*] for its own rows into a dfeats
//     accumulator in shared memory, reading the routed bank rows from
//     global memory (coalesced, 4 bank rows in flight per warp); each split
//     writes its partial dfeats to scratch and a reduce kernel sums the
//     splits in index order.
// No atomics: every sum has a fixed order, so results are run-to-run
// identical for a given split plan. The split merge and the dfeats reduce are
// split_merge.cuh's, shared with bank_infonce.cu.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "split_merge.cuh"

namespace {

using split_merge::merge_stats;
struct mq_split {};  // names the merge / reduce kernels

constexpr int kThreads = split_merge::kThreads;
constexpr int kBK = 32;        // depth of one bank chunk
constexpr int kMaxJ = 4;       // float4 columns a lane owns in the gather
constexpr int kMaxD = 128 * kMaxJ;
constexpr int kSmemLimit = 232448;

// kTX threads across the bank columns, kThreads / kTX across the rows; each
// thread owns 4 rows x 8 columns of the sims tile.
constexpr int kTX = 32;
constexpr int kRows = 4 * (kThreads / kTX);  // feats rows per CTA: 32
constexpr int kCols = 8 * kTX;               // bank rows per tile: 256
constexpr int kLdA = kRows + 4;
constexpr int kLdB = kCols + 4;

// Dynamic shared memory: the feats rows (D, kLdA), one bank chunk; the
// backward adds the tile's weights, the dfeats accumulator and the routed q.
constexpr size_t smem_bytes(int D, bool backward) {
  return (size_t(D) * kLdA + size_t(kBK) * kLdB +
          (backward ? size_t(kCols) * kRows + size_t(kRows) * D : 0)) * sizeof(float) +
         (backward ? size_t(kCols) * kRows * sizeof(short) : 0);
}
static_assert(smem_bytes(kMaxD, true) <= kSmemLimit, "the widest D must fit");

struct Args {
  const float* q;          // (B, D)
  const void* bank;        // (M, Q, D) float32 / bfloat16 / int8
  const float* scales;     // (M, Q) for int8, else null
  const int* labels;       // (B,)
  const float* mx_in;      // backward: the forward's (B,) statistics
  const float* se_in;
  const float* gout;       // backward: the upstream scalar gradient
  float tau;
  int B, M, Q, D, tiles_per_split, n_splits;
  float4* part;            // forward scratch (n_splits, B): (mx, se, pos, el)
  float *mx, *se, *pos, *el, *out2;
  float* dq_part;          // backward scratch (n_splits, B, D)
  float* dq;               // (B, D)
};

__device__ __forceinline__ void widen(const uint4& w, float* out, float) {
  const float* e = reinterpret_cast<const float*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = e[i];
}

__device__ __forceinline__ void widen(const uint4& w, float* out, __nv_bfloat16) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void widen(const uint4& w, float* out, int8_t) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = float(e[i]);
}

// Four consecutive values of a bank row, widened.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
  return make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]), __bfloat162float(e[2]),
                     __bfloat162float(e[3]));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 w = *reinterpret_cast<const char4*>(p);
  return make_float4(float(w.x), float(w.y), float(w.z), float(w.w));
}

// One chunk of the bank: kCols rows (m) of query q, depth [k0, k0 + kBK), as
// 16-byte loads held in registers; groups of neighbouring lanes read one
// row's contiguous bytes. Rows past M load as zeros.
template <typename T>
struct Chunk {
  static constexpr int kElem = 16 / sizeof(T);
  static constexpr int kPerRow = kBK / kElem;
  static constexpr int kN = kCols * kPerRow / kThreads;
  static_assert(kCols * kPerRow % kThreads == 0, "chunk does not divide");
  uint4 v[kN];

  __device__ __forceinline__ void load(const T* __restrict__ bank, int col0, int q, int k0,
                                       int M, int Q, int D) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      const int c = idx / kPerRow, kq = (idx % kPerRow) * kElem;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (col0 + c < M)
        v[i] = *reinterpret_cast<const uint4*>(bank + (size_t(col0 + c) * Q + q) * D + k0 + kq);
    }
  }

  // widened into Bs, transposed: Bs[k][c]
  __device__ __forceinline__ void store(float* Bs, int ldB) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      const int c = idx / kPerRow, kq = (idx % kPerRow) * kElem;
      float f[kElem];
      widen(v[i], f, T());
#pragma unroll
      for (int e = 0; e < kElem; ++e) Bs[(kq + e) * ldB + c] = f[e];
    }
  }
};

// Column of the tile owned by accumulator slot b of thread column tx.
__device__ __forceinline__ int tile_col(int tx, int b) {
  return tx * 4 + (b & 3) + kTX * 4 * (b >> 2);
}

// The CTA's feats rows [row0, row0 + kRows) into As (D, kLdA), transposed;
// rows past B are zeros.
__device__ __forceinline__ void stage_rows(const float* __restrict__ q, int row0, int B, int D,
                                           float* As) {
  const int d4 = D / 4;
  for (int idx = threadIdx.x; idx < kRows * d4; idx += kThreads) {
    const int r = idx / d4, k = (idx % d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < B) v = *reinterpret_cast<const float4*>(q + size_t(row0 + r) * D + k);
    As[(k + 0) * kLdA + r] = v.x;
    As[(k + 1) * kLdA + r] = v.y;
    As[(k + 2) * kLdA + r] = v.z;
    As[(k + 3) * kLdA + r] = v.w;
  }
}

// acc[a][b] += Σ_{kk < kBK} As[k0 + kk][ty*4 + a] · Bs[kk][tile_col(tx, b)].
__device__ __forceinline__ void chunk_product(const float* As, const float* Bs, int k0, int tx,
                                              int ty, float acc[4][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(As + (k0 + kk) * kLdA + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + kTX * 4 + tx * 4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// The chunk walk shared by both kernels: chunk c of the split is tile
// tile_begin + c / (Q·nk), query (c % (Q·nk)) / nk, depth chunk c % nk.
struct Walk {
  int tile_begin, per_tile, nk;
  __device__ __forceinline__ void at(int c, int& tile, int& q, int& kc) const {
    tile = tile_begin + c / per_tile;
    const int rem = c % per_tile;
    q = rem / nk;
    kc = rem % nk;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mq_fwd_kernel(const Args args) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // (D, kLdA)
  float* Bs = As + size_t(args.D) * kLdA;       // (kBK, kLdB)
  const T* __restrict__ bank = static_cast<const T*>(args.bank);
  const int B = args.B, M = args.M, Q = args.Q, D = args.D;
  const float tau = args.tau;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int row0 = blockIdx.y * kRows;
  const int n_tiles = (M + kCols - 1) / kCols;
  const Walk walk{int(blockIdx.x) * args.tiles_per_split, Q * (D / kBK), D / kBK};
  const int tile_end = min(walk.tile_begin + args.tiles_per_split, n_tiles);
  const int n_chunks = max(tile_end - walk.tile_begin, 0) * walk.per_tile;

  Chunk<T> pre;
  if (n_chunks > 0) pre.load(bank, walk.tile_begin * kCols, 0, 0, M, Q, D);
  stage_rows(args.q, row0, B, D, As);

  float mx[4], se[4], el[4], pos[4];
  int lab[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    mx[a] = -CUDART_INF_F;
    se[a] = el[a] = pos[a] = 0.f;
    lab[a] = row < B ? args.labels[row] : -1;
  }

  float acc[4][8], best[4][8], sc[8];
  for (int c = 0; c < n_chunks; ++c) {
    int tile, qq, kc;
    walk.at(c, tile, qq, kc);
    const int col0 = tile * kCols;
    pre.store(Bs, kLdB);
    __syncthreads();  // Bs (and, the first time, As) published
    if (c + 1 < n_chunks) {
      int nt, nq, nkc;
      walk.at(c + 1, nt, nq, nkc);
      pre.load(bank, nt * kCols, nq, nkc * kBK, M, Q, D);
    }
    if (kc == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      if constexpr (kQuant) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int col = col0 + tile_col(tx, b);
          sc[b] = col < M ? args.scales[size_t(col) * Q + qq] : 0.f;
        }
      }
    }
    chunk_product(As, Bs, kc * kBK, tx, ty, acc);
    __syncthreads();  // Bs free for the next chunk
    if (kc != walk.nk - 1) continue;
    // the sims of query qq are complete: fold them into the max over q
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float s = acc[a][b];
        if constexpr (kQuant) s *= sc[b];
        best[a][b] = qq == 0 ? s : fmaxf(best[a][b], s);
      }
    if (qq != Q - 1) continue;
    // the tile's logits are complete: online-softmax statistics
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float l[8];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int col = col0 + tile_col(tx, b);
        l[b] = best[a][b] / tau;
        if (col < M) {
          tmax = fmaxf(tmax, l[b]);
          if (col == lab[a]) pos[a] += l[b];
        }
      }
      if (tmax > -CUDART_INF_F) {
        const float nm = fmaxf(mx[a], tmax);
        const float scale = expf(mx[a] - nm);
        float s = 0.f, e = 0.f;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (col0 + tile_col(tx, b) < M) {
            const float p = expf(l[b] - nm);
            s += p;
            e = fmaf(p, l[b], e);
          }
        }
        se[a] = se[a] * scale + s;
        el[a] = el[a] * scale + e;
        mx[a] = nm;
      }
    }
  }

  // the kTX threads of a row are the 32 lanes of a warp
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[a], off);
      const float os = __shfl_xor_sync(0xffffffffu, se[a], off);
      const float oe = __shfl_xor_sync(0xffffffffu, el[a], off);
      const float op = __shfl_xor_sync(0xffffffffu, pos[a], off);
      merge_stats(mx[a], se[a], el[a], om, os, oe);
      pos[a] += op;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + ty * 4 + a;
      if (row < B)
        args.part[size_t(blockIdx.x) * B + row] = make_float4(mx[a], se[a], pos[a], el[a]);
    }
  }
}

// dacc[r] += Σ_m Ws[m][r] · bank[col0 + m, Aq[m][r]] for the rows r of this
// warp, m in order; a lane owns the float4 columns 4·lane + 128·j.
template <typename T>
__device__ __forceinline__ void routed_sum(const T* __restrict__ bank, const float* Ws,
                                           const short* Aq, float* Dacc, int col0, int ncols,
                                           int row0, int B, int Q, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows && row0 + r < B; r += kThreads / 32) {
    float4 acc[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = 4 * lane + 128 * j;
      acc[j] = d < D ? *reinterpret_cast<const float4*>(Dacc + r * D + d)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int m0 = 0; m0 < ncols; m0 += 4) {
      float w[4];
      float4 v[4][kMaxJ];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u;
        w[u] = m < ncols ? Ws[m * kRows + r] : 0.f;
        const T* src = bank;
        if (w[u] != 0.f) src = bank + (size_t(col0 + m) * Q + Aq[m * kRows + r]) * D;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int d = 4 * lane + 128 * j;
          v[u][j] = (w[u] != 0.f && d < D) ? load4(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          acc[j].x = fmaf(w[u], v[u][j].x, acc[j].x);
          acc[j].y = fmaf(w[u], v[u][j].y, acc[j].y);
          acc[j].z = fmaf(w[u], v[u][j].z, acc[j].z);
          acc[j].w = fmaf(w[u], v[u][j].w, acc[j].w);
        }
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) *reinterpret_cast<float4*>(Dacc + r * D + d) = acc[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mq_bwd_kernel(const Args args) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  const int B = args.B, M = args.M, Q = args.Q, D = args.D;
  float* As = reinterpret_cast<float*>(smem4);             // (D, kLdA)
  float* Bs = As + size_t(D) * kLdA;                       // (kBK, kLdB)
  float* Ws = Bs + kBK * kLdB;                             // (kCols, kRows): weights
  float* Dacc = Ws + kCols * kRows;                        // (kRows, D): dfeats partial
  short* Aq = reinterpret_cast<short*>(Dacc + kRows * D);  // (kCols, kRows): routed q
  const T* __restrict__ bank = static_cast<const T*>(args.bank);
  const float tau = args.tau;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int row0 = blockIdx.y * kRows;
  const int n_tiles = (M + kCols - 1) / kCols;
  const Walk walk{int(blockIdx.x) * args.tiles_per_split, Q * (D / kBK), D / kBK};
  const int tile_end = min(walk.tile_begin + args.tiles_per_split, n_tiles);
  const int n_chunks = max(tile_end - walk.tile_begin, 0) * walk.per_tile;
  const float g = args.gout[0] / (float(B) * tau);

  Chunk<T> pre;
  if (n_chunks > 0) pre.load(bank, walk.tile_begin * kCols, 0, 0, M, Q, D);
  stage_rows(args.q, row0, B, D, As);
  for (int i = tid; i < kRows * D; i += kThreads) Dacc[i] = 0.f;

  float rmx[4], rse[4];
  int lab[4];
  bool live[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    live[a] = row < B;
    rmx[a] = live[a] ? args.mx_in[row] : 0.f;
    rse[a] = live[a] ? args.se_in[row] : 1.f;
    lab[a] = live[a] ? args.labels[row] : -1;
  }

  float acc[4][8], best[4][8], sc[8];
  int arg[4][8];
  for (int c = 0; c < n_chunks; ++c) {
    int tile, qq, kc;
    walk.at(c, tile, qq, kc);
    const int col0 = tile * kCols;
    pre.store(Bs, kLdB);
    __syncthreads();
    if (c + 1 < n_chunks) {
      int nt, nq, nkc;
      walk.at(c + 1, nt, nq, nkc);
      pre.load(bank, nt * kCols, nq, nkc * kBK, M, Q, D);
    }
    if (kc == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      if constexpr (kQuant) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int col = col0 + tile_col(tx, b);
          sc[b] = col < M ? args.scales[size_t(col) * Q + qq] : 0.f;
        }
      }
    }
    chunk_product(As, Bs, kc * kBK, tx, ty, acc);
    __syncthreads();
    if (kc != walk.nk - 1) continue;
    // the max over q and its first argmax: only a strictly greater sim moves it
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float s = acc[a][b];
        if constexpr (kQuant) s *= sc[b];
        if (qq == 0 || s > best[a][b]) {
          best[a][b] = s;
          arg[a][b] = qq;
        }
      }
    if (qq != Q - 1) continue;
    // the tile's weights (P - onehot)·g (·s[m, q*]) and routed queries
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int cl = tile_col(tx, b);
      const int col = col0 + cl;
      float w[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float p = col < M ? expf(best[a][b] / tau - rmx[a]) / rse[a] : 0.f;
        if (col == lab[a]) p -= 1.f;
        w[a] = (live[a] && col < M) ? p * g : 0.f;
        if constexpr (kQuant) {
          if (w[a] != 0.f) w[a] *= args.scales[size_t(col) * Q + arg[a][b]];
        }
      }
      *reinterpret_cast<float4*>(Ws + cl * kRows + ty * 4) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<short4*>(Aq + cl * kRows + ty * 4) =
          make_short4(short(arg[0][b]), short(arg[1][b]), short(arg[2][b]), short(arg[3][b]));
    }
    __syncthreads();
    routed_sum<T>(bank, Ws, Aq, Dacc, col0, min(kCols, M - col0), row0, B, Q, D);
  }

  __syncthreads();
  for (int i = tid; i < kRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), k = (i % (D / 4)) * 4;
    if (row0 + r < B)
      *reinterpret_cast<float4*>(args.dq_part + (size_t(blockIdx.x) * B + row0 + r) * D + k) =
          *reinterpret_cast<const float4*>(Dacc + r * D + k);
  }
}

template <typename T>
cudaError_t launch(const Args& args, bool backward, cudaStream_t st) {
  const size_t bytes = smem_bytes(args.D, backward);
  auto kernel = backward ? mq_bwd_kernel<T> : mq_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(args.n_splits, (args.B + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (backward)
    return split_merge::launch_dq_reduce<mq_split>(args.dq_part, args.n_splits, args.B, args.D,
                                                   args.dq, st);
  return split_merge::launch_merge<mq_split>(args.part, args.n_splits, args.B, args.tau, args.mx,
                                             args.se, args.pos, args.el, args.out2, st);
}

cudaError_t dispatch(const Args& args, int bank_dtype, bool backward, void* stream) {
  const long long n_tiles = (static_cast<long long>(args.M) + kCols - 1) / kCols;
  if (args.B <= 0 || args.M <= 0 || args.Q <= 0 || args.Q > 32767 || args.D <= 0 ||
      args.D % kBK != 0 || args.D > kMaxD || args.tiles_per_split <= 0 ||
      args.n_splits <= 0 || (bank_dtype == 2) != (args.scales != nullptr) ||
      static_cast<long long>(args.tiles_per_split) * args.n_splits < n_tiles ||
      static_cast<long long>(args.tiles_per_split) * (args.n_splits - 1) >= n_tiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bank_dtype) {
    case 0: return launch<float>(args, backward, st);
    case 1: return launch<__nv_bfloat16>(args, backward, st);
    case 2: return launch<int8_t>(args, backward, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points return a cudaError_t (0 on success); argument errors
// return cudaErrorInvalidValue without launching. bank_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then `scales` is (M, Q) float32, else null).
// The bank's splits are [i*tiles_per_split, (i+1)*tiles_per_split) tiles of
// 256 rows; D % 32 == 0 and D <= 512. feats, mx, se, pos, el, dq are
// float32; labels int32; part is (n_splits, B) float4 scratch; out2 = (loss,
// dtau_unit); dq_part is (n_splits, B, D) float32 scratch.
extern "C" int max_query_infonce_fwd(const void* q, const void* bank, const void* scales,
                                     const void* labels, float tau, int B, int M, int Q, int D,
                                     int bank_dtype, int tiles_per_split, int n_splits,
                                     void* part, void* mx, void* se, void* pos, void* el,
                                     void* out2, void* stream) {
  Args args{};
  args.q = static_cast<const float*>(q);
  args.bank = bank;
  args.scales = static_cast<const float*>(scales);
  args.labels = static_cast<const int*>(labels);
  args.tau = tau;
  args.B = B;
  args.M = M;
  args.Q = Q;
  args.D = D;
  args.tiles_per_split = tiles_per_split;
  args.n_splits = n_splits;
  args.part = static_cast<float4*>(part);
  args.mx = static_cast<float*>(mx);
  args.se = static_cast<float*>(se);
  args.pos = static_cast<float*>(pos);
  args.el = static_cast<float*>(el);
  args.out2 = static_cast<float*>(out2);
  return dispatch(args, bank_dtype, false, stream);
}

extern "C" int max_query_infonce_bwd(const void* q, const void* bank, const void* scales,
                                     const void* labels, const void* mx, const void* se,
                                     const void* gout, float tau, int B, int M, int Q, int D,
                                     int bank_dtype, int tiles_per_split, int n_splits,
                                     void* dq_part, void* dq, void* stream) {
  Args args{};
  args.q = static_cast<const float*>(q);
  args.bank = bank;
  args.scales = static_cast<const float*>(scales);
  args.labels = static_cast<const int*>(labels);
  args.mx_in = static_cast<const float*>(mx);
  args.se_in = static_cast<const float*>(se);
  args.gout = static_cast<const float*>(gout);
  args.tau = tau;
  args.B = B;
  args.M = M;
  args.Q = Q;
  args.D = D;
  args.tiles_per_split = tiles_per_split;
  args.n_splits = n_splits;
  args.dq_part = static_cast<float*>(dq_part);
  args.dq = static_cast<float*>(dq);
  return dispatch(args, bank_dtype, true, stream);
}
