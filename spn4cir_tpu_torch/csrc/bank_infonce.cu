// Full-bank InfoNCE for Hopper (sm_90a): forward statistics and backward dQ,
// over a dense bank and over an int8 bank with per-row scales.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` (reached through
// `bank_infonce_pallas`) and `_q8_fwd_kernel` and `_q8_bwd_kernel` (reached
// through `bank_infonce_q8_pallas`) in spn4cir_tpu/ops/bank_kernels.py.
//
//     logits = (Q · bankᵀ) / tau                (B, M), float32, never stored
//     forward : per row  mx = max_j logits, se = Σ_j exp(logits - mx),
//               pos = logits[label], el = Σ_j exp(logits - mx)·logits;
//               loss = mean_i(log se + mx - pos),
//               dtau_unit = mean_i((pos - el/se) / tau)
//     backward: dQ = ((P - onehot(label)) · g) · bank,  P = exp(logits - mx)/se
//               recomputed from the saved (mx, se), g = gout / (B·tau)
//
// int8 bank (values (M, D) int8, scales (M,) float32): the product runs on
// the raw values widened to float32 and the row's scale multiplies the logits
// column afterwards, then 1/tau, in the TPU kernel's order of roundings:
//
//     logits = ((Q · i8ᵀ) · s) / tau
//     dQ     = ((P - onehot) · g · s) · i8
//
// A bank row past M gets scale 0 and its scale is never read.
//
// Q is (B, D) float32; the bank is (M, D) float32, bfloat16 or int8, D % 16
// == 0. Rows past B and bank rows past M are masked in the kernels: nothing
// is padded outside. No atomics anywhere: every sum has a fixed order, so
// results are run-to-run identical for a given split plan. The merge and
// the reduce of the splits are split_merge.cuh's, shared with
// max_query_infonce.cu.
//
// What bounds them: 2·B·M·D operations per product against (B + M)·D values
// read, ~128-256 operations per bank byte at B = 256, so the operations, not
// memory, once a bank tile is reused from shared memory. The TPU grid walked
// the bank axis in order for each block of rows (two blocks at B = 256);
// here the bank axis is split across CTAs so that every SM has work.
//
// Forward, every bank (float32, bf16, int8; one template a route). From
// D = 256 on (`tc_logits`, the backward's rule) the logits tile is formed by
// the backward's split-TF32 mainloop (`logits_tile_tc`; the split is set out
// under Backward), so the forward and the coefficient kernel form
// bit-identical logits and P = exp(l - mx)/se in the backward sums to 1
// against the forward's own statistics: `bank_infonce_fwd_tc_kernel`, grid =
// (64-row tiles of Q, bank splits), a CTA walks its split's 128-row bank
// tiles through one three-stage cp.async ring that runs on across tile
// boundaries (the next tile's first chunks load while this tile's epilogue
// runs); per tile each thread folds its 4 rows x 8 columns into running (mx,
// se, el, pos) kept in shared memory (its own slots: no barrier, no
// registers held across the mainloop); once per split the four t lanes of a
// row merge by xor shuffles and the four column warps in warp order through
// shared memory. Bound at
// D = 640, B = 256, M = 65,536: 3 x 2·B·M·D = 64.4 GFLOP at the TF32 peak
// over a float32 bank, 0.13 ms, 2 x over a bf16 or int8 one, 0.087 ms.
// Below D = 256 the bank is widened to float32 and the product runs as
// float32 FMAs, as the TPU kernels do (`bank_infonce_fwd_kernel`): grid =
// (bank splits, 64-row tiles of Q); a CTA walks its split in tiles of 128
// bank rows, each logits tile a register-blocked product (`logits_tile`:
// 4 x 8 per thread, depth chunks of 16 staged transposed in shared memory;
// an int8 tile's 128 scales beside it in shared memory); each thread keeps
// online-softmax statistics for its 4 rows over its own columns, the 16
// threads of a row merge with xor shuffles. Either route writes one float4
// (mx, se, pos, el) per (split, row) to scratch, and a one-block merge
// kernel combines the splits in index order and writes the statistics, the
// loss and dtau_unit.
//
// Backward, every bank (float32, bf16, int8; one design, the tensor cores).
// Float32 FMAs cap a CUDA-core design near the library's SGEMMs (67 TFLOP/s
// peak against 4·B·M·D), so both products run on the tensor cores in split
// TF32 (`mma.sync.m16n8k8`, float32 accumulate; `mma_sync.cuh`): each
// float32 operand x = hi + lo, both TF32, and a product is lo·hi + hi·lo +
// hi·hi, which keeps about float32's accuracy (the dropped lo·lo and lo's
// own truncation are below 2^-21 relative). A bf16 bank is exact in TF32,
// and so are int8 values (7 bits against TF32's 11), so their lo is zero
// and two products run; over an int8 bank the scale enters the logits
// column and the coefficient (above), never the products. The tensor cores
// add partial sums to their accumulator rounding toward zero: each 32-deep
// stage's products go to a zeroed tile that is added to the running sum in
// float32, so the long sums round to nearest as FMAs do. Bound at D = 640,
// B = 256, M = 65,536: 3 x 4·B·M·D = 128.8 GFLOP at the TF32 peak (495
// TFLOP/s) over a float32 bank, 0.26 ms, and 2 x 4·B·M·D, 0.17 ms, over a
// bf16 or int8 one, against 0.09 ms of bytes (the bank, Q and the
// coefficient scratch written and read once). Two kernels, no logits tile
// formed twice:
//   (a) `bank_infonce_coef_tc_kernel`: per (64 query rows, 128 bank rows),
//       the logits over the full depth through a three-stage `cp.async` ring
//       of 32-deep chunks, then C = (exp(l - mx)/se - onehot)·g (int8: ·s)
//       written as float32 into a (B, ceil(M/128)·128) scratch, zero past M;
//   (b) `bank_infonce_dq_tc_kernel`: dQ = C · bank. B x D is only
//       ceil(B/64) x ceil(D/128) output tiles (20 at B = 256, D = 640), so
//       the bank axis is split across CTAs until the card holds two an SM;
//       each split walks its bank rows in 32-row stages through the same
//       kind of ring and writes its partial dQ to scratch, and the reduce
//       sums the splits in index order.
//   8 warps a CTA as 2 x 4 warp tiles of 32 x 32 (both kernels and the
//   tensor-core forward); fragment reads are free of bank conflicts by the
//   row strides (kTcLdA, coef_ld_bank, dq_ld_bank), one bank value a load,
//   widened to float32.
//   Below D = 256 (`tc_logits` off; no model's embedding is so narrow) the
//   logits of (a) run as float32 FMAs (`bank_infonce_coef_kernel`): unit
//   rows of few dimensions have logits up to 1/tau, where a product summed
//   in any other order than the plain version's misses the tolerance.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "mma_sync.cuh"
#include "split_merge.cuh"

namespace {

using split_merge::merge_stats;
struct bank_infonce_split {};  // names the merge / reduce kernels

constexpr int kThreads = split_merge::kThreads;
constexpr int kTileR = 64;    // query rows per CTA
constexpr int kTileC = 128;   // bank rows per logits tile
constexpr int kBK = 16;       // depth chunk of the logits product
constexpr int kLdA = kTileR + 4;
constexpr int kLdB = kTileC + 4;

__device__ __forceinline__ void widen8(const uint4& w, float* out) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// The scales of one 128-row bank tile into `ss`; rows past M get 0.
__device__ __forceinline__ void stage_scales(const float* __restrict__ scales, int col0, int M,
                                             float* ss) {
  const int tid = threadIdx.x;
  if (tid < kTileC) ss[tid] = col0 + tid < M ? scales[col0 + tid] : 0.f;
}

// Column of the tile owned by accumulator slot b of thread column tx.
__device__ __forceinline__ int tile_col(int tx, int b) {
  return tx * 4 + (b & 3) + 64 * (b >> 2);
}

// acc[a][b] = Σ_d q[row0 + ty*4 + a][d] · bank[col0 + tile_col(tx, b)][d].
// Rows >= B and bank rows >= M read as zeros. Ends with a barrier, so the
// staging buffers are free on return.
template <typename T>
__device__ __forceinline__ void logits_tile(const float* __restrict__ q,
                                            const T* __restrict__ bank, int row0, int col0,
                                            int B, int M, int D, float* As, float* Bs,
                                            float acc[4][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    {  // Q: 64 rows x 16 depth, one float4 per thread, stored transposed
      const int r = tid >> 2, kq = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < B)
        v = *reinterpret_cast<const float4*>(q + size_t(row0 + r) * D + k0 + kq);
      As[(kq + 0) * kLdA + r] = v.x;
      As[(kq + 1) * kLdA + r] = v.y;
      As[(kq + 2) * kLdA + r] = v.z;
      As[(kq + 3) * kLdA + r] = v.w;
    }
    if constexpr (sizeof(T) == 4) {  // bank: 128 rows x 16 depth
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + kThreads * i;
        const int c = idx >> 2, kq = (idx & 3) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col0 + c < M)
          v = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(bank) + size_t(col0 + c) * D + k0 + kq);
        Bs[(kq + 0) * kLdB + c] = v.x;
        Bs[(kq + 1) * kLdB + c] = v.y;
        Bs[(kq + 2) * kLdB + c] = v.z;
        Bs[(kq + 3) * kLdB + c] = v.w;
      }
    } else if constexpr (sizeof(T) == 2) {
      const int c = tid >> 1, kq = (tid & 1) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (col0 + c < M)
        widen8(*reinterpret_cast<const uint4*>(bank + size_t(col0 + c) * D + k0 + kq), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[(kq + e) * kLdB + c] = v[e];
    } else {  // int8: 8 values per thread, the tile's rows across the lanes,
              // so every thread stages and the stores are conflict-free
      const int c = tid & (kTileC - 1), kq = (tid >> 7) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (col0 + c < M) {
        const uint2 w = *reinterpret_cast<const uint2*>(bank + size_t(col0 + c) * D + k0 + kq);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = float(e8[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[(kq + e) * kLdB + c] = v[e];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * kLdA + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + 64 + tx * 4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bank_infonce_fwd_kernel(const float* __restrict__ q, const T* __restrict__ bank,
                        const float* __restrict__ scales, const int* __restrict__ labels,
                        float tau, int B, int M, int D, int tiles_per_split,
                        float4* __restrict__ part) {
  constexpr bool kQuant = sizeof(T) == 1;
  __shared__ __align__(16) float As[kBK * kLdA];
  __shared__ __align__(16) float Bs[kBK * kLdB];
  // int8: the tile's scales, two buffers by tile parity, so that a thread
  // already in the next tile never overwrites what a slower one still reads
  __shared__ float Ss[2][kTileC];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kTileR;
  const int n_tiles = (M + kTileC - 1) / kTileC;
  const int tile_begin = blockIdx.x * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  float mx[4], se[4], el[4], pos[4];
  int lab[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    mx[a] = -CUDART_INF_F;
    se[a] = el[a] = pos[a] = 0.f;
    lab[a] = row < B ? labels[row] : -1;
  }

  float acc[4][8];
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kTileC;
    const float* ss = Ss[(tile - tile_begin) & 1];
    if constexpr (kQuant) stage_scales(scales, col0, M, Ss[(tile - tile_begin) & 1]);
    logits_tile<T>(q, bank, row0, col0, B, M, D, As, Bs, acc);  // its barriers publish ss
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float l[8];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int col = col0 + tile_col(tx, b);
        if constexpr (kQuant)
          l[b] = acc[a][b] * ss[tile_col(tx, b)] / tau;
        else
          l[b] = acc[a][b] / tau;
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

  // the 16 threads of a row (tx = 0..15) are 16 neighbouring lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
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
      if (row < B) part[size_t(blockIdx.x) * B + row] = make_float4(mx[a], se[a], pos[a], el[a]);
    }
  }
}

// ===========================================================================
// Backward, every bank: two tensor-core products in split TF32
// ===========================================================================

using namespace mma_sync;  // cp.async, TF32 split, mma.sync and the split-TF32 step

constexpr int kTcThreads = 256;  // 8 warps as 2 (rows) x 4 (columns) of 32 x 32
constexpr int kTcRows = 64;      // query rows a CTA owns, both kernels
constexpr int kTcCols = 128;     // bank rows (coefficient kernel) / dQ columns (dQ kernel)
constexpr int kTcDepth = 32;     // depth of a ring stage
constexpr int kTcStages = 3;     // ring stages: two in flight while one is multiplied
constexpr int kTcLdA = kTcDepth + 4;   // Q and C tiles, float: lanes read 4g + t, no conflict

// Row strides of the bank tiles, in elements; rows stay multiples of 16
// bytes for cp.async. The coefficient kernel's tile has rows of depth:
// lanes read words float 36g + t, bf16 20g + t/2, int8 12g (the four t of a
// row share a word). The dQ kernel's tile has rows of bank rows (depth of
// its product): float 136t + g, bf16 68t + g/2, int8 36t + g/4.
template <typename T>
__host__ __device__ constexpr int coef_ld_bank() {
  return sizeof(T) == 4 ? kTcDepth + 4 : (sizeof(T) == 2 ? kTcDepth + 8 : kTcDepth + 16);
}

template <typename T>
__host__ __device__ constexpr int dq_ld_bank() {
  return sizeof(T) == 1 ? kTcCols + 16 : kTcCols + 8;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return float(x); }

// The m16n8k8 A fragments of a warp's 32 rows [row0, row0 + 32), depths
// [k8, k8 + 8), from a float tile of row stride kTcLdA: per 16 rows one
// `ldmatrix` of four 8 x 4 tiles, rows 0-7 | 8-15 x depths 0-3 | 4-7.
__device__ __forceinline__ void a_frags_tf32(float (&av)[2][4], const float* a, int row0, int k8,
                                             int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    uint32_t r[4];
    ldsm_x4(r, a + (row0 + 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8) * kTcLdA + k8 +
                   (lane >> 4) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) av[mi][i] = __uint_as_float(r[i]);
  }
}

template <typename T>
constexpr size_t coef_smem_bytes() {
  return size_t(kTcStages) *
         (kTcRows * kTcLdA * sizeof(float) + kTcCols * coef_ld_bank<T>() * sizeof(T));
}

template <typename T>
constexpr size_t dq_smem_bytes() {
  return size_t(kTcStages) *
         (kTcRows * kTcLdA * sizeof(float) + kTcDepth * dq_ld_bank<T>() * sizeof(T));
}

// The coefficient of one accumulator value: acc = (Q·bankᵀ)[row][col] over
// the full depth, sc the column's int8 scale (1 over a dense bank). In the
// order of roundings of the TPU kernels: l = acc·s/tau, then
// (exp(l - mx)/se - onehot)·g·s; a column past M gets 0.
template <bool kQuant>
__device__ __forceinline__ float coefficient(float acc, float sc, int col, int M, int lab,
                                             float tau, float rmx, float rse, float gs) {
  if (kQuant) acc *= sc;
  float p = col < M ? expf(acc / tau - rmx) / rse : 0.f;
  if (col == lab) p -= 1.f;
  p *= gs;
  return kQuant ? p * sc : p;
}

// The int8 scale of column col of the bank, 0 past M (never read there).
template <bool kQuant>
__device__ __forceinline__ float column_scale(const float* __restrict__ scales, int col, int M) {
  if (!kQuant) return 1.f;
  return col < M ? scales[col] : 0.f;
}

// Depth chunk k0 of the Q tile (rows row0..) and of the bank tile (rows
// col0..) into ring stage st: rows past B or M and depths past D
// zero-filled. One cp.async per 16 bytes; the caller commits the group.
template <typename T>
__device__ __forceinline__ void fetch_logits_chunk(float* As, T* Bs, const float* __restrict__ q,
                                                   const T* __restrict__ bank, int row0, int col0,
                                                   int k0, int st, int B, int M, int D) {
  constexpr int kLdB = coef_ld_bank<T>();
  constexpr int kPer = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr int kCopiesB = kTcDepth / kPer;  // copies a bank row of a stage
  const int tid = threadIdx.x;
  float* a = As + st * kTcRows * kTcLdA;
  T* b = Bs + st * kTcCols * kLdB;
  for (int i = tid; i < kTcRows * (kTcDepth / 4); i += kTcThreads) {
    const int r = i / (kTcDepth / 4), c = (i % (kTcDepth / 4)) * 4;
    const bool valid = row0 + r < B && k0 + c < D;
    cp_async16(a + r * kTcLdA + c, q + (valid ? size_t(row0 + r) * D + k0 + c : 0), valid);
  }
  for (int i = tid; i < kTcCols * kCopiesB; i += kTcThreads) {
    const int r = i / kCopiesB, c = (i % kCopiesB) * kPer;
    const bool valid = col0 + r < M && k0 + c < D;
    cp_async16(b + r * kLdB + c, bank + (valid ? size_t(col0 + r) * D + k0 + c : 0), valid);
  }
}

// The logits tile of the coefficient kernel and of the tensor-core forward,
// one mainloop, so both form bit-identical logits: acc (this warp's 32 x 32
// of a 64-row x 128-column tile, m16n8k8 accumulator layout) = Q·bankᵀ over
// the full depth, from the ring's chunks [kc0, kc0 + n_chunks), chunk kc in
// stage kc % kTcStages. fetch(kc) loads chunk kc into its stage and commits
// one cp.async group (an empty one past the caller's last chunk). The caller
// has issued the chunks up to kc0 + kTcStages - 2; on return those up to
// kc0 + n_chunks + kTcStages - 2 are issued, so a caller that walks several
// tiles has the next tile's first chunks in flight during its epilogue.
template <typename T, typename Fetch>
__device__ __forceinline__ void logits_tile_tc(const float* As, const T* Bs, int kc0,
                                               int n_chunks, const Fetch& fetch,
                                               float (&acc)[2][4][4]) {
  constexpr int kLdB = coef_ld_bank<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp >> 2), wn = 32 * (warp & 3);
  zero_tile(acc);
  for (int kc = kc0; kc < kc0 + n_chunks; ++kc) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // chunk kc is in; every warp is done with chunk kc - 1's stage
    fetch(kc + kTcStages - 1);
    const float* a = As + (kc % kTcStages) * kTcRows * kTcLdA;
    const T* b = Bs + (kc % kTcStages) * kTcCols * kLdB;
    float part[2][4][4];
    zero_tile(part);
#pragma unroll
    for (int k8 = 0; k8 < kTcDepth; k8 += 8) {
      float av[2][4], bv[4][2];
      a_frags_tf32(av, a, wm, k8, lane);
      if constexpr (sizeof(T) == 4) {  // B(k, n) = bank row n, depth k: n8 tiles in pairs
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, reinterpret_cast<const float*>(b) +
                         (wn + 16 * np + (lane & 7) + (lane >> 4) * 8) * kLdB + k8 +
                         ((lane >> 3) & 1) * 4);
          bv[2 * np][0] = __uint_as_float(r[0]);
          bv[2 * np][1] = __uint_as_float(r[1]);
          bv[2 * np + 1][0] = __uint_as_float(r[2]);
          bv[2 * np + 1][1] = __uint_as_float(r[3]);
        }
      } else {  // bf16, int8: one value a load, widened
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const T* br = b + (wn + 8 * ni + g) * kLdB + k8 + t;
          bv[ni][0] = to_float(br[0]);
          bv[ni][1] = to_float(br[4]);
        }
      }
      mma_step_3xtf32<(sizeof(T) < 4)>(part, av, bv);
    }
    add_tile(acc, part);
  }
}

// (a) C[row][col] = (exp(l - mx)/se - onehot(label))·g for a 64-row tile of
// Q and a 128-row tile of the bank, l = (Q·bankᵀ)/tau over the full depth
// in a cp.async ring of 32-deep stages (int8: l = (Q·i8ᵀ)·s/tau and C·s).
// C is (B, ldc) float32, ldc = the bank's tiles x 128: the columns past M
// get 0, rows past B are not written.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
bank_infonce_coef_tc_kernel(const float* __restrict__ q, const T* __restrict__ bank,
                            const float* __restrict__ scales, const int* __restrict__ labels,
                            const float* __restrict__ mx, const float* __restrict__ se,
                            const float* __restrict__ gout, float tau, int B, int M, int D,
                            int ldc, float* __restrict__ coef) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);                      // stages of (kTcRows, kTcLdA)
  T* Bs = reinterpret_cast<T*>(As + kTcStages * kTcRows * kTcLdA);  // stages of (kTcCols, kLdB)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp >> 2), wn = 32 * (warp & 3);
  const int row0 = blockIdx.x * kTcRows, col0 = blockIdx.y * kTcCols;
  const int n_chunks = (D + kTcDepth - 1) / kTcDepth;

  auto fetch = [&](int kc) {
    if (kc < n_chunks)
      fetch_logits_chunk<T>(As, Bs, q, bank, row0, col0, kc * kTcDepth, kc % kTcStages, B, M, D);
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int kc = 0; kc < kTcStages - 1; ++kc) fetch(kc);
  float acc[2][4][4];
  logits_tile_tc<T>(As, Bs, 0, n_chunks, fetch, acc);

  const float gs = gout[0] / (float(B) * tau);
  float sc[4][2];  // this thread's columns' scales, read once
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sc[ni][e] = column_scale<kQuant>(scales, col0 + wn + 8 * ni + 2 * t + e, M);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm + 16 * mi + g + 8 * h;
      if (row >= B) continue;
      const float rmx = mx[row], rse = se[row];
      const int lab = labels[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + wn + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(coef + size_t(row) * ldc + col) = make_float2(
            coefficient<kQuant>(acc[mi][ni][2 * h], sc[ni][0], col, M, lab, tau, rmx, rse, gs),
            coefficient<kQuant>(acc[mi][ni][2 * h + 1], sc[ni][1], col + 1, M, lab, tau, rmx,
                                rse, gs));
      }
    }
}

// The tensor-core forward's shared memory beyond the ring: each thread's
// running (mx, se, el, pos) of its 4 rows, (16, kTcThreads) float; the
// column warps' merged statistics, (4, kTcRows) float4; the tile's labels.
constexpr int kFwdStats = 16;

template <typename T>
constexpr size_t fwd_tc_smem_bytes() {
  return coef_smem_bytes<T>() + size_t(kFwdStats) * kTcThreads * sizeof(float) +
         4 * kTcRows * sizeof(float4) + kTcRows * sizeof(int);
}

// Forward statistics from the split-TF32 logits (D >= 256): per (64-row tile
// of Q, split of the bank) one float4 (mx, se, pos, el) a row over the
// split's bank tiles, l = acc/tau (int8: acc·s/tau), columns past M masked.
// The ring runs on across the split's tiles: chunk kc is depth chunk
// kc % n_chunks of tile tile_begin + kc / n_chunks.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
bank_infonce_fwd_tc_kernel(const float* __restrict__ q, const T* __restrict__ bank,
                           const float* __restrict__ scales, const int* __restrict__ labels,
                           float tau, int B, int M, int D, int tiles_per_split,
                           float4* __restrict__ part) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);                      // stages of (kTcRows, kTcLdA)
  T* Bs = reinterpret_cast<T*>(As + kTcStages * kTcRows * kTcLdA);  // stages of (kTcCols, kLdB)
  float* stats = reinterpret_cast<float*>(Bs + kTcStages * kTcCols * coef_ld_bank<T>());
  float4* red = reinterpret_cast<float4*>(stats + kFwdStats * kTcThreads);
  int* lab_s = reinterpret_cast<int*>(red + 4 * kTcRows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp >> 2), wn = 32 * (warp & 3);
  const int row0 = blockIdx.x * kTcRows;
  const int n_tiles = (M + kTcCols - 1) / kTcCols;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int n_chunks = (D + kTcDepth - 1) / kTcDepth;
  const int n_ring = (tile_end - tile_begin) * n_chunks;

  auto fetch = [&](int kc) {
    if (kc < n_ring)
      fetch_logits_chunk<T>(As, Bs, q, bank, row0, (tile_begin + kc / n_chunks) * kTcCols,
                            (kc % n_chunks) * kTcDepth, kc % kTcStages, B, M, D);
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int kc = 0; kc < kTcStages - 1; ++kc) fetch(kc);

  // stats[(4r + k) * kTcThreads + tid]: k = 0 mx, 1 se, 2 el, 3 pos of this
  // thread's row r = 2mi + h (tile row wm + 16mi + 8h + g); lab_s is
  // published by the mainloop's first barrier
  if (tid < kTcRows) lab_s[tid] = row0 + tid < B ? labels[row0 + tid] : -1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    stats[(4 * r + 0) * kTcThreads + tid] = -CUDART_INF_F;
#pragma unroll
    for (int k = 1; k < 4; ++k) stats[(4 * r + k) * kTcThreads + tid] = 0.f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    float acc[2][4][4];
    logits_tile_tc<T>(As, Bs, (tile - tile_begin) * n_chunks, n_chunks, fetch, acc);
    const int col0 = tile * kTcCols + wn + 2 * t;  // this thread's first column
    float sc[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[ni][e] = column_scale<kQuant>(scales, col0 + 8 * ni + e, M);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* rs = stats + 4 * (2 * mi + h) * kTcThreads + tid;
        const int lab = lab_s[wm + 16 * mi + 8 * h + g];
        float l[8];
        float tmax = -CUDART_INF_F, pos = rs[3 * kTcThreads];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * ni + e;
            float a = acc[mi][ni][2 * h + e];
            if (kQuant) a *= sc[ni][e];
            l[2 * ni + e] = a / tau;
            if (col < M) {
              tmax = fmaxf(tmax, l[2 * ni + e]);
              if (col == lab) pos += l[2 * ni + e];
            }
          }
        rs[3 * kTcThreads] = pos;
        if (tmax > -CUDART_INF_F) {
          const float m0 = rs[0];
          const float nm = fmaxf(m0, tmax);
          const float scale = expf(m0 - nm);
          float s = 0.f, el = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col0 + 8 * (j >> 1) + (j & 1) < M) {
              const float p = expf(l[j] - nm);
              s += p;
              el = fmaf(p, l[j], el);
            }
          }
          rs[0] = nm;
          rs[kTcThreads] = rs[kTcThreads] * scale + s;
          rs[2 * kTcThreads] = rs[2 * kTcThreads] * scale + el;
        }
      }
  }

  // the four t lanes of a row (xor 1, then 2), then the four column warps
  // of a row in warp order; only empty cp.async groups are left
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* rs = stats + 4 * r * kTcThreads + tid;
    float m = rs[0], s = rs[kTcThreads], e = rs[2 * kTcThreads], p = rs[3 * kTcThreads];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const float oe = __shfl_xor_sync(0xffffffffu, e, off);
      const float op = __shfl_xor_sync(0xffffffffu, p, off);
      merge_stats(m, s, e, om, os, oe);
      p += op;
    }
    if (t == 0)
      red[(warp & 3) * kTcRows + wm + 16 * (r >> 1) + 8 * (r & 1) + g] = make_float4(m, s, p, e);
  }
  __syncthreads();
  if (tid < kTcRows && row0 + tid < B) {
    const float4 v = red[tid];
    float m = v.x, s = v.y, p = v.z, e = v.w;
#pragma unroll
    for (int wc = 1; wc < 4; ++wc) {
      const float4 o = red[wc * kTcRows + tid];
      merge_stats(m, s, e, o.x, o.y, o.w);
      p += o.z;
    }
    part[size_t(blockIdx.y) * B + row0 + tid] = make_float4(m, s, p, e);
  }
}

// (a') The same coefficient with the logits tile on the CUDA cores
// (`logits_tile`: float32 FMAs in depth order), for shallow banks (the
// wrapper's plan picks it below D = 256; no model's embedding is that
// narrow). There the rows' logits are large (|l| ~ 1/(sqrt(D) tau)) and one
// float32 rounding of l moves P by more than the checks allow against a
// plain version whose logits come from a float32 product in depth order;
// a product in any other order, split TF32 or exactly rounded, does not
// hold them. The dQ product stays on the tensor cores.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bank_infonce_coef_kernel(const float* __restrict__ q, const T* __restrict__ bank,
                         const float* __restrict__ scales, const int* __restrict__ labels,
                         const float* __restrict__ mx, const float* __restrict__ se,
                         const float* __restrict__ gout, float tau, int B, int M, int D, int ldc,
                         float* __restrict__ coef) {
  constexpr bool kQuant = sizeof(T) == 1;
  __shared__ __align__(16) float As[kBK * kLdA];
  __shared__ __align__(16) float Bs[kBK * kLdB];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kTileR, col0 = blockIdx.y * kTileC;
  float acc[4][8];
  logits_tile<T>(q, bank, row0, col0, B, M, D, As, Bs, acc);
  const float gs = gout[0] / (float(B) * tau);
  float sc[8];  // this thread's columns' scales, read once
#pragma unroll
  for (int b = 0; b < 8; ++b) sc[b] = column_scale<kQuant>(scales, col0 + tile_col(tx, b), M);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    if (row >= B) continue;
    const float rmx = mx[row], rse = se[row];
    const int lab = labels[row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // columns tile_col(tx, 4j .. 4j + 3)
      const int col = col0 + tile_col(tx, 4 * j);
      float c4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c4[e] = coefficient<kQuant>(acc[a][4 * j + e], sc[4 * j + e], col + e, M, lab, tau, rmx,
                                    rse, gs);
      *reinterpret_cast<float4*>(coef + size_t(row) * ldc + col) =
          make_float4(c4[0], c4[1], c4[2], c4[3]);
    }
  }
}

// (b) dq_part[split] = C[:, split's bank rows] · bank[split's bank rows, :]
// for a 64-row x 128-column tile of dQ: a split walks its bank tiles in
// 32-row stages of C and of the bank through a cp.async ring.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
bank_infonce_dq_tc_kernel(const float* __restrict__ coef, const T* __restrict__ bank, int B,
                          int M, int D, int ldc, int tiles_per_split,
                          float* __restrict__ dq_part) {
  constexpr int kLdB = dq_ld_bank<T>();
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kCopiesB = kTcCols / kPer;  // copies a bank row of a stage
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);                      // stages of (kTcRows, kTcLdA)
  T* Bs = reinterpret_cast<T*>(As + kTcStages * kTcRows * kTcLdA);  // stages of (kTcDepth, kLdB)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp >> 2), wn = 32 * (warp & 3);
  const int row0 = blockIdx.x * kTcRows, c0 = blockIdx.y * kTcCols;
  const int n_tiles = (M + kTcCols - 1) / kTcCols;
  const int tile_begin = blockIdx.z * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int m_begin = tile_begin * kTcCols;
  const int n_chunks = (tile_end - tile_begin) * (kTcCols / kTcDepth);

  // bank rows [m0, m0 + 32) of C's columns and of the bank into stage kc;
  // rows past B or M and columns past D zero-filled
  auto fetch = [&](int kc) {
    if (kc < n_chunks) {
      const int st = kc % kTcStages, m0 = m_begin + kc * kTcDepth;
      float* a = As + st * kTcRows * kTcLdA;
      T* b = Bs + st * kTcDepth * kLdB;
      for (int i = tid; i < kTcRows * (kTcDepth / 4); i += kTcThreads) {
        const int r = i / (kTcDepth / 4), c = (i % (kTcDepth / 4)) * 4;
        const bool valid = row0 + r < B;
        cp_async16(a + r * kTcLdA + c, coef + (valid ? size_t(row0 + r) * ldc + m0 + c : 0),
                   valid);
      }
      for (int i = tid; i < kTcDepth * kCopiesB; i += kTcThreads) {
        const int r = i / kCopiesB, c = (i % kCopiesB) * kPer;
        const bool valid = m0 + r < M && c0 + c < D;
        cp_async16(b + r * kLdB + c, bank + (valid ? size_t(m0 + r) * D + c0 + c : 0), valid);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;
  for (int kc = 0; kc < kTcStages - 1; ++kc) fetch(kc);
  for (int kc = 0; kc < n_chunks; ++kc) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    fetch(kc + kTcStages - 1);
    const float* a = As + (kc % kTcStages) * kTcRows * kTcLdA;
    const T* b = Bs + (kc % kTcStages) * kTcDepth * kLdB;
    float part[2][4][4];
    zero_tile(part);
    // float32 (B split too): two steps at a time, or ptxas spills at 128
    // registers
#pragma unroll (sizeof(T) == 4 ? 2 : 4)
    for (int k8 = 0; k8 < kTcDepth; k8 += 8) {
      float av[2][4], bv[4][2];
      a_frags_tf32(av, a, wm, k8, lane);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {  // B(k, n) = bank row k, column n
        const T* br = b + (k8 + t) * kLdB + wn + 8 * ni + g;
        bv[ni][0] = to_float(br[0]);
        bv[ni][1] = to_float(br[4 * kLdB]);
      }
      mma_step_3xtf32<(sizeof(T) < 4)>(part, av, bv);
    }
    add_tile(acc, part);
  }

  float* out = dq_part + size_t(blockIdx.z) * B * D;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm + 16 * mi + g + 8 * h;
      if (row >= B) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + wn + 8 * ni + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(out + size_t(row) * D + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

bool plan_ok(int B, int M, int D, int tiles_per_split, int n_splits) {
  if (B <= 0 || M <= 0 || D <= 0 || D % 16 != 0 || tiles_per_split <= 0 || n_splits <= 0)
    return false;
  const long long n_tiles = (static_cast<long long>(M) + kTileC - 1) / kTileC;
  return static_cast<long long>(tiles_per_split) * n_splits >= n_tiles &&
         static_cast<long long>(tiles_per_split) * (n_splits - 1) < n_tiles;
}

// The forward over any bank: the statistics kernel of the route over the
// splits of the bank, then the merge of the splits in index order. scales:
// the int8 bank's, nullptr over a dense one.
template <typename T>
cudaError_t launch_fwd(const void* q, const void* bank, const void* scales, const void* labels,
                       float tau, int B, int M, int D, int tiles_per_split, int n_splits,
                       bool tc_logits, void* part, void* mx, void* se, void* pos, void* el,
                       void* out2, cudaStream_t st) {
  static_assert(kTcRows == kTileR && kTcCols == kTileC, "both forward kernels tile alike");
  const int row_tiles = (B + kTileR - 1) / kTileR;
  if (tc_logits) {
    if (n_splits > 65535) return cudaErrorInvalidValue;  // grid.y
    auto kernel = bank_infonce_fwd_tc_kernel<T>;
    // the kernel's shared-memory limit, set once (the first caller's result)
    static const cudaError_t smem_err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(fwd_tc_smem_bytes<T>()));
    if (smem_err != cudaSuccess) return smem_err;
    // row tiles side by side, so the CTAs that read one bank tile run together
    kernel<<<dim3(row_tiles, n_splits), kTcThreads, fwd_tc_smem_bytes<T>(), st>>>(
        static_cast<const float*>(q), static_cast<const T*>(bank),
        static_cast<const float*>(scales), static_cast<const int*>(labels), tau, B, M, D,
        tiles_per_split, static_cast<float4*>(part));
  } else {
    if (row_tiles > 65535) return cudaErrorInvalidValue;  // grid.y
    bank_infonce_fwd_kernel<T><<<dim3(n_splits, row_tiles), kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const T*>(bank),
        static_cast<const float*>(scales), static_cast<const int*>(labels), tau, B, M, D,
        tiles_per_split, static_cast<float4*>(part));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_merge<bank_infonce_split>(part, n_splits, B, tau, mx, se, pos, el,
                                                       out2, st);
}

// The backward over any bank: coefficient kernel, dQ kernel over the splits
// of the bank, then the reduce of the splits in index order. scales: the
// int8 bank's, nullptr over a dense one.
template <typename T>
cudaError_t launch_bwd(const void* q, const void* bank, const void* scales, const void* labels,
                       const void* mx, const void* se, const void* gout, float tau, int B, int M,
                       int D, int tiles_per_split, int n_splits, bool tc_logits, void* coef,
                       void* dq_part, void* dq, cudaStream_t st) {
  static_assert(kTcRows == kTileR && kTcCols == kTileC, "both coefficient kernels tile alike");
  const int n_tiles = (M + kTcCols - 1) / kTcCols;
  if (n_tiles > 65535) return cudaErrorInvalidValue;  // grid.y of the coefficient kernel
  const int ldc = n_tiles * kTcCols;
  auto coef_kernel = bank_infonce_coef_tc_kernel<T>;
  auto dq_kernel = bank_infonce_dq_tc_kernel<T>;
  // the kernels' shared-memory limit, set once (the first caller's result)
  static const cudaError_t smem_err = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        coef_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(coef_smem_bytes<T>()));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(dq_smem_bytes<T>()));
  }();
  if (smem_err != cudaSuccess) return smem_err;
  cudaError_t err;
  const int row_tiles = (B + kTcRows - 1) / kTcRows;
  // row tiles side by side, so the CTAs that read one bank tile run together
  const dim3 coef_grid(row_tiles, n_tiles);
  if (tc_logits)
    coef_kernel<<<coef_grid, kTcThreads, coef_smem_bytes<T>(), st>>>(
        static_cast<const float*>(q), static_cast<const T*>(bank),
        static_cast<const float*>(scales), static_cast<const int*>(labels),
        static_cast<const float*>(mx), static_cast<const float*>(se),
        static_cast<const float*>(gout), tau, B, M, D, ldc, static_cast<float*>(coef));
  else
    bank_infonce_coef_kernel<T><<<coef_grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const T*>(bank),
        static_cast<const float*>(scales), static_cast<const int*>(labels),
        static_cast<const float*>(mx), static_cast<const float*>(se),
        static_cast<const float*>(gout), tau, B, M, D, ldc, static_cast<float*>(coef));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(row_tiles, (D + kTcCols - 1) / kTcCols, n_splits), kTcThreads,
              dq_smem_bytes<T>(), st>>>(static_cast<const float*>(coef),
                                        static_cast<const T*>(bank), B, M, D, ldc,
                                        tiles_per_split, static_cast<float*>(dq_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_dq_reduce<bank_infonce_split>(dq_part, n_splits, B, D, dq, st);
}

}  // namespace

// Every entry point returns a cudaError_t (0 on success); argument errors
// return cudaErrorInvalidValue without launching. bank_dtype: 0 = float32,
// 1 = bfloat16. q, mx, se, pos, el, dq are float32; labels int32; part is
// (n_splits, B) float4 scratch; out2 = (loss, dtau_unit); dq_part is
// (n_splits, B, D) float32 scratch. The bank's splits are
// [i*tiles_per_split, (i+1)*tiles_per_split) tiles of 128 rows: the
// forwards' statistics and the backwards' dQ product are split so;
// tc_logits: 1 forms the logits on the tensor cores, 0 on the CUDA cores;
// the backwards take coef, (B, ceil(M/128)*128) float32 scratch for the
// coefficient. The q8 entry points take the int8 values (M, D) and the
// float32 scales (M,).
extern "C" int bank_infonce_fwd(const void* q, const void* bank, const void* labels, float tau,
                                int B, int M, int D, int bank_dtype, int tiles_per_split,
                                int n_splits, int tc_logits, void* part, void* mx, void* se,
                                void* pos, void* el, void* out2, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == 0)
    return launch_fwd<float>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split, n_splits,
                             tc_logits != 0, part, mx, se, pos, el, out2, st);
  if (bank_dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split,
                                     n_splits, tc_logits != 0, part, mx, se, pos, el, out2, st);
  return cudaErrorInvalidValue;
}

extern "C" int bank_infonce_bwd(const void* q, const void* bank, const void* labels,
                                const void* mx, const void* se, const void* gout, float tau,
                                int B, int M, int D, int bank_dtype, int tiles_per_split,
                                int n_splits, int tc_logits, void* coef, void* dq_part,
                                void* dq, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == 0)
    return launch_bwd<float>(q, bank, nullptr, labels, mx, se, gout, tau, B, M, D,
                             tiles_per_split, n_splits, tc_logits != 0, coef, dq_part, dq, st);
  if (bank_dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, bank, nullptr, labels, mx, se, gout, tau, B, M, D,
                                     tiles_per_split, n_splits, tc_logits != 0, coef, dq_part,
                                     dq, st);
  return cudaErrorInvalidValue;
}

extern "C" int bank_infonce_q8_fwd(const void* q, const void* values, const void* scales,
                                   const void* labels, float tau, int B, int M, int D,
                                   int tiles_per_split, int n_splits, int tc_logits, void* part,
                                   void* mx, void* se, void* pos, void* el, void* out2,
                                   void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  return launch_fwd<int8_t>(q, values, scales, labels, tau, B, M, D, tiles_per_split, n_splits,
                            tc_logits != 0, part, mx, se, pos, el, out2,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int bank_infonce_q8_bwd(const void* q, const void* values, const void* scales,
                                   const void* labels, const void* mx, const void* se,
                                   const void* gout, float tau, int B, int M, int D,
                                   int tiles_per_split, int n_splits, int tc_logits, void* coef,
                                   void* dq_part, void* dq, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  return launch_bwd<int8_t>(q, values, scales, labels, mx, se, gout, tau, B, M, D,
                            tiles_per_split, n_splits, tc_logits != 0, coef, dq_part, dq,
                            static_cast<cudaStream_t>(stream));
}
