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
// The 128 scales of a bank tile are read once into shared memory beside the
// values; a bank row past M gets scale 0 and its scale is never read.
//
// Q is (B, D) float32; the bank is (M, D) float32, bfloat16 or int8 and is
// widened to float32 before the product, as the TPU kernels do, so both
// products run as float32 FMAs on the CUDA cores. D % 16 == 0. The backward
// keeps a 64 x W accumulator tile of dQ in registers, W <= 512: a wider D is
// cut into equal slices of W columns along a third grid axis, and each
// slice's CTA recomputes the full-depth logits tile (which needs all of D)
// and accumulates only its columns of dQ. That costs one more logits product
// per extra slice, and keeps the register budget and the order of every sum.
// Rows past B and bank rows past M are masked in the kernel: nothing is
// padded outside.
//
// What bounds it: 2·B·M·D operations per product against (B + M)·D values
// read, i.e. ~128-256 operations per bank byte at B = 256: the float32 FMA
// rate bounds it, not memory, once the bank tile is reused from shared
// memory. The TPU grid walked the bank axis in order for each block of rows
// (two blocks at B = 256); here the bank axis is split across CTAs so that
// every SM has work:
//   - grid = (bank splits, 64-row tiles of Q[, slices of dQ's columns in the
//     backward]); a CTA walks its split in
//     tiles of 128 bank rows; each logits tile is a register-blocked product
//     (4 x 8 per thread, depth chunks of 16 staged transposed in shared
//     memory);
//   - forward: each thread keeps online-softmax statistics for its 4 rows
//     over its own columns; at the end of the split the 16 threads that
//     share a row merge with xor shuffles, and one float4 (mx, se, pos, el)
//     per (split, row) goes to scratch. A one-block merge kernel combines
//     the splits in index order, writes the four statistics, the loss and
//     dtau_unit (tree reduction over rows in a fixed order);
//   - backward: the coefficient tile (P - onehot)·g goes to shared memory
//     and the second product accumulates a 64 x W tile of dQ in registers
//     (4 x 32 per thread at W = 512), streaming the same bank tile in chunks
//     of 8 rows;
//     each split writes its partial dQ to scratch and a reduce kernel sums
//     the splits in index order.
// No atomics: every sum has a fixed order, so results are run-to-run
// identical for a given split plan. The merge and the reduce are
// split_merge.cuh's, shared with max_query_infonce.cu.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "split_merge.cuh"

namespace {

using split_merge::merge_stats;
struct bank_infonce_split {};  // names the merge / reduce kernels

constexpr int kThreads = split_merge::kThreads;
constexpr int kTileR = 64;    // query rows per CTA
constexpr int kTileC = 128;   // bank rows per logits tile
constexpr int kBK = 16;       // depth chunk of the logits product
constexpr int kBK2 = 8;       // bank rows per chunk of the dQ product
constexpr int kSliceD = 512;  // backward: widest slice of dQ columns per CTA
constexpr int kLdA = kTileR + 4;
constexpr int kLdB = kTileC + 4;

__device__ __forceinline__ void widen8(const uint4& w, float* out) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void widen16(const uint4& w, float* out) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = float(e[i]);
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

constexpr size_t kBwdSmemFloats = size_t(kBK) * kLdA + size_t(kBK) * kLdB +
                                  size_t(kTileC) * kLdA + size_t(kBK2) * kSliceD +
                                  2 * size_t(kTileC);

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bank_infonce_bwd_kernel(const float* __restrict__ q, const T* __restrict__ bank,
                        const float* __restrict__ scales, const int* __restrict__ labels,
                        const float* __restrict__ mx, const float* __restrict__ se,
                        const float* __restrict__ gout, float tau, int B, int M, int D,
                        int tiles_per_split, int W, float* __restrict__ dq_part) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // (kBK, kLdA)
  float* Bs = As + kBK * kLdA;                    // (kBK, kLdB)
  float* Ps = Bs + kBK * kLdB;                    // (kTileC, kLdA): coefficient, transposed
  float* B2 = Ps + kTileC * kLdA;                 // (kBK2, W): bank rows of the dQ product
  float* Ss = B2 + kBK2 * kSliceD;                // (2, kTileC): int8 scales, by tile parity
  const int d0 = blockIdx.z * W;                  // this CTA's slice of dQ: [d0, d0 + W)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * kTileR;
  const int n_tiles = (M + kTileC - 1) / kTileC;
  const int tile_begin = blockIdx.x * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const float g = gout[0] / (float(B) * tau);

  float rmx[4], rse[4];
  int lab[4];
  bool live[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    live[a] = row < B;
    rmx[a] = live[a] ? mx[row] : 0.f;
    rse[a] = live[a] ? se[row] : 1.f;
    lab[a] = live[a] ? labels[row] : -1;
  }

  // dacc[a][4*j + e] accumulates dQ[row0 + ty*4 + a][d0 + 64*j + tx*4 + e]
  float dacc[4][32];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 32; ++c) dacc[a][c] = 0.f;

  float acc[4][8];
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * kTileC;
    const float* ss = Ss + ((tile - tile_begin) & 1) * kTileC;
    if constexpr (kQuant) stage_scales(scales, col0, M, Ss + ((tile - tile_begin) & 1) * kTileC);
    logits_tile<T>(q, bank, row0, col0, B, M, D, As, Bs, acc);  // its barriers publish ss
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int c = tile_col(tx, b);
      const int col = col0 + c;
      float sc = 1.f;
      if constexpr (kQuant) sc = ss[c];
      float coef[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float lg = acc[a][b];
        if constexpr (kQuant) lg *= sc;
        float p = col < M ? expf(lg / tau - rmx[a]) / rse[a] : 0.f;
        if (col == lab[a]) p -= 1.f;
        coef[a] = live[a] ? p * g : 0.f;
        if constexpr (kQuant) coef[a] *= sc;
      }
      *reinterpret_cast<float4*>(Ps + c * kLdA + ty * 4) =
          make_float4(coef[0], coef[1], coef[2], coef[3]);
    }
    __syncthreads();

    for (int m0 = 0; m0 < kTileC; m0 += kBK2) {
      // columns [d0, d0 + W) of 8 bank rows; W % 64 == 0 and D % 16 == 0,
      // so a 4-, 8- or 16-wide load that starts below D ends at or below it
      if constexpr (sizeof(T) == 4) {
        const int n4 = kBK2 * W / 4;
        for (int i = tid; i < n4; i += kThreads) {
          const int m = (i * 4) / W, dl = (i * 4) - m * W;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (col0 + m0 + m < M && d0 + dl < D)
            v = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(bank) + size_t(col0 + m0 + m) * D + d0 + dl);
          *reinterpret_cast<float4*>(B2 + m * W + dl) = v;
        }
      } else if constexpr (sizeof(T) == 2) {
        const int n8 = kBK2 * W / 8;
        for (int i = tid; i < n8; i += kThreads) {
          const int m = (i * 8) / W, dl = (i * 8) - m * W;
          float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (col0 + m0 + m < M && d0 + dl < D)
            widen8(*reinterpret_cast<const uint4*>(bank + size_t(col0 + m0 + m) * D + d0 + dl),
                   v);
          *reinterpret_cast<float4*>(B2 + m * W + dl) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(B2 + m * W + dl + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
      } else {
        const int n16 = kBK2 * W / 16;
        for (int i = tid; i < n16; i += kThreads) {
          const int m = (i * 16) / W, dl = (i * 16) - m * W;
          float v[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) v[e] = 0.f;
          if (col0 + m0 + m < M && d0 + dl < D)
            widen16(*reinterpret_cast<const uint4*>(bank + size_t(col0 + m0 + m) * D + d0 + dl),
                    v);
#pragma unroll
          for (int e = 0; e < 16; e += 4)
            *reinterpret_cast<float4*>(B2 + m * W + dl + e) =
                make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kBK2; ++m) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + (m0 + m) * kLdA + ty * 4);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int dl = 64 * j + tx * 4;
          if (dl < W && d0 + dl < D) {
            const float4 b4 = *reinterpret_cast<const float4*>(B2 + m * W + dl);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              dacc[a][4 * j + 0] = fmaf(pv[a], b4.x, dacc[a][4 * j + 0]);
              dacc[a][4 * j + 1] = fmaf(pv[a], b4.y, dacc[a][4 * j + 1]);
              dacc[a][4 * j + 2] = fmaf(pv[a], b4.z, dacc[a][4 * j + 2]);
              dacc[a][4 * j + 3] = fmaf(pv[a], b4.w, dacc[a][4 * j + 3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + ty * 4 + a;
    if (!live[a]) continue;
    float* out = dq_part + (size_t(blockIdx.x) * B + row) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dl = 64 * j + tx * 4;
      if (dl < W && d0 + dl < D)
        *reinterpret_cast<float4*>(out + d0 + dl) = make_float4(
            dacc[a][4 * j + 0], dacc[a][4 * j + 1], dacc[a][4 * j + 2], dacc[a][4 * j + 3]);
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

template <typename T>
cudaError_t launch_fwd(const void* q, const void* bank, const void* scales, const void* labels,
                       float tau, int B, int M, int D, int tiles_per_split, int n_splits,
                       void* part, void* mx, void* se, void* pos, void* el, void* out2,
                       cudaStream_t st) {
  dim3 grid(n_splits, (B + kTileR - 1) / kTileR);
  bank_infonce_fwd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(bank),
      static_cast<const float*>(scales), static_cast<const int*>(labels), tau, B, M, D,
      tiles_per_split, static_cast<float4*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_merge<bank_infonce_split>(part, n_splits, B, tau, mx, se, pos, el,
                                                       out2, st);
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* bank, const void* scales, const void* labels,
                       const void* mx, const void* se, const void* gout, float tau, int B,
                       int M, int D, int tiles_per_split, int n_splits, int d_slice,
                       void* dq_part, void* dq, cudaStream_t st) {
  if (d_slice <= 0 || d_slice > kSliceD || d_slice % 64 != 0) return cudaErrorInvalidValue;
  const size_t bytes = kBwdSmemFloats * sizeof(float);
  auto kernel = bank_infonce_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(n_splits, (B + kTileR - 1) / kTileR, (D + d_slice - 1) / d_slice);
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(bank),
      static_cast<const float*>(scales), static_cast<const int*>(labels),
      static_cast<const float*>(mx), static_cast<const float*>(se),
      static_cast<const float*>(gout), tau, B, M, D, tiles_per_split, d_slice,
      static_cast<float*>(dq_part));
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
// [i*tiles_per_split, (i+1)*tiles_per_split) tiles of 128 rows. d_slice is
// the backward's slice of dQ columns per CTA: a multiple of 64, at most 512;
// ceil(D / d_slice) slices cover D. The q8 entry points take the int8 values
// (M, D) and the float32 scales (M,).
extern "C" int bank_infonce_fwd(const void* q, const void* bank, const void* labels, float tau,
                                int B, int M, int D, int bank_dtype, int tiles_per_split,
                                int n_splits, void* part, void* mx, void* se, void* pos,
                                void* el, void* out2, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == 0)
    return launch_fwd<float>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split, n_splits,
                             part, mx, se, pos, el, out2, st);
  if (bank_dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split,
                                     n_splits, part, mx, se, pos, el, out2, st);
  return cudaErrorInvalidValue;
}

extern "C" int bank_infonce_bwd(const void* q, const void* bank, const void* labels,
                                const void* mx, const void* se, const void* gout, float tau,
                                int B, int M, int D, int bank_dtype, int tiles_per_split,
                                int n_splits, int d_slice, void* dq_part, void* dq,
                                void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_dtype == 0)
    return launch_bwd<float>(q, bank, nullptr, labels, mx, se, gout, tau, B, M, D,
                             tiles_per_split, n_splits, d_slice, dq_part, dq, st);
  if (bank_dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, bank, nullptr, labels, mx, se, gout, tau, B, M, D,
                                     tiles_per_split, n_splits, d_slice, dq_part, dq, st);
  return cudaErrorInvalidValue;
}

extern "C" int bank_infonce_q8_fwd(const void* q, const void* values, const void* scales,
                                   const void* labels, float tau, int B, int M, int D,
                                   int tiles_per_split, int n_splits, void* part, void* mx,
                                   void* se, void* pos, void* el, void* out2, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  return launch_fwd<int8_t>(q, values, scales, labels, tau, B, M, D, tiles_per_split, n_splits,
                            part, mx, se, pos, el, out2, static_cast<cudaStream_t>(stream));
}

extern "C" int bank_infonce_q8_bwd(const void* q, const void* values, const void* scales,
                                   const void* labels, const void* mx, const void* se,
                                   const void* gout, float tau, int B, int M, int D,
                                   int tiles_per_split, int n_splits, int d_slice,
                                   void* dq_part, void* dq, void* stream) {
  if (!plan_ok(B, M, D, tiles_per_split, n_splits)) return cudaErrorInvalidValue;
  return launch_bwd<int8_t>(q, values, scales, labels, mx, se, gout, tau, B, M, D,
                            tiles_per_split, n_splits, d_slice, dq_part, dq,
                            static_cast<cudaStream_t>(stream));
}
