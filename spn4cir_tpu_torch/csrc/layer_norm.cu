// LayerNorm over the last axis for Hopper (sm_90a): activations in bf16 or
// float32, statistics and affine in float32, the output rounded once to the
// activations' type. The towers' `models/layers.py:LayerNorm` calls it.
//
//     mean = Σ_c x[c] / W        rstd = (Σ_c (x[c] - mean)² / W + eps)^-½
//     y[c] = T(w[c] · ((x[c] - mean) · rstd) + b[c])
//
// and its gradient, with x̂ = (x - mean) · rstd and g = w · dy:
//
//     dx[c] = T(rstd · (g[c] - Σ g / W - x̂[c] · Σ g·x̂ / W))
//     dw[c] = Σ_rows dy[c] · x̂[c]          db[c] = Σ_rows dy[c]
//
// It replaces no Pallas kernel: the JAX package leaves its LayerNorm to XLA,
// which fuses the float32 casts into the normalisation. Without it the port
// ran a bf16 -> f32 copy, aten's float32 LayerNorm and an f32 -> bf16 copy
// forward, and two casts, the dx kernel and a dweight / dbias kernel
// backward, every intermediate a float32 tensor twice the activation's size.
//
// What bounds it: bytes. The work is a few operations an element against 4
// bytes moved (bf16 x read, y written) forward and 6 backward (dy and x
// read, dx written), so the design keeps every byte to one trip and the
// loads in flight:
//   - each row is read once, in 16-byte vectors (8 bf16 or 4 float32 values
//     a lane) when the width and the pointers allow, one value a lane
//     otherwise; the row stays in registers in its own type, and the mean,
//     the centred variance and the output are three passes over registers,
//     not over memory;
//   - one warp a row, 8 warps (rows) a block, up to 24 bf16 or 8 float32
//     values a lane; a wider row takes 2, 4 or 8 warps, which add their
//     warp sums through shared memory (`ln_plan` in ops/layer_norm.py picks
//     the vector width, the vectors a lane and the warps a row from the
//     width, the type and the alignment alone);
//   - nothing but y leaves the forward: the backward reads x anyway, so it
//     takes the row's mean and rstd again from the registers, by the same
//     code (`row_stats`; in the same order wherever the backward's plan is
//     the forward's, as it is on every aligned tensor), and no statistics
//     tensor is
//     allocated, written or read (8 bytes a row each way, and one
//     allocation a call on the host, which paces the towers' steps);
//   - the backward walks rows with a grid-stride loop over as many blocks as
//     the card holds at once (two an SM: its registers are held to 128 a
//     thread, which on the H100 took the bf16 backward at (19,712, 640) from
//     0.0596 to 0.0494 ms), keeps each column's Σ dy·x̂ and Σ dy of its
//     rows in registers, folds the block's warps in order through shared
//     memory and writes one float32 partial row (2·W values) a block, a few
//     hundred in all; `ln_f32_dparams_kernel` then sums the partials column
//     by column in a fixed order into the first partial row, [dw | db],
//     each thread with 16 partial rows in flight.
// No atomics: every sum has a fixed order, so a relaunch gives the same bits.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWidth = 4096;         // the backward's shared fold holds 2·W
constexpr int kSlices = 32;             // row slices of a dparams block
constexpr int kSliceLoads = 16;         // partial rows a slice loads at once

// VEC consecutive values of one row: one 16-byte load at VEC·sizeof(T) = 16.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Frag {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC float32 values from p (16-byte aligned when VEC % 4 == 0).
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&o)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      o[i] = t.x;
      o[i + 1] = t.y;
      o[i + 2] = t.z;
      o[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = p[i];
  }
}

// The sums s[0..N) of one row, on every thread of the row: a butterfly in
// each warp (every lane ends with the same bits), then, at 2-8 warps a row,
// the row's warp sums added in warp order through shared memory. Every
// thread of the block calls it (row_warps is the block's).
template <int N>
__device__ __forceinline__ void row_reduce(float (&s)[N], float (*red)[N], int row_warps,
                                           int warp, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
  }
  if (row_warps == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][i] = s[i];
  }
  __syncthreads();
  const int first = warp - warp % row_warps;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t = red[first][i];
    for (int k = 1; k < row_warps; ++k) t += red[first + k][i];
    s[i] = t;
  }
  __syncthreads();
}

// The mean and rstd of the row whose vectors v[0..NV) this thread holds
// (columns (j·tpr + t)·VEC), on every thread of the row: the sum, then the
// sum of squares of the centred values, both over registers.
template <typename T, int VEC, int NV>
__device__ __forceinline__ void row_stats(const Frag<T, VEC> (&v)[NV], bool live, int tpr, int t,
                                          int width, float eps, float (*red)[1], int row_warps,
                                          int warp, int lane, float& mean, float& rstd) {
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (live && c < width) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[0] += to_f(v[j].v[k]);
    }
  }
  row_reduce<1>(s, red, row_warps, warp, lane);
  mean = s[0] / float(width);
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (live && c < width) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = to_f(v[j].v[k]) - mean;
        q[0] += d * d;
      }
    }
  }
  row_reduce<1>(q, red, row_warps, warp, lane);
  rstd = rsqrtf(q[0] / float(width) + eps);
}

// One row a group of row_warps warps; lane t of the group holds vectors j
// at columns (j·32·row_warps + t)·VEC.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, 1)
    ln_f32_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y, long long rows, int width,
                      int row_warps, float eps) {
  __shared__ float red[kWarps][1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpr = 32 * row_warps;
  const int t = (warp % row_warps) * 32 + lane;
  const long long row = (long long)blockIdx.x * (kWarps / row_warps) + warp / row_warps;
  const bool live = row < rows;
  const long long base = (live ? row : 0) * (long long)width;

  Frag<T, VEC> v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (live && c < width) v[j] = *reinterpret_cast<const Frag<T, VEC>*>(x + base + c);
  }
  float mean, rstd;
  row_stats<T, VEC, NV>(v, live, tpr, t, width, eps, red, row_warps, warp, lane, mean, rstd);
  if (!live) return;  // no barrier follows
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * tpr + t) * VEC;
    if (c < width) {
      float wv[VEC], bv[VEC];
      load_f32<VEC>(w + c, wv);
      load_f32<VEC>(b + c, bv);
      Frag<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.v[k] = from_f<T>(wv[k] * ((to_f(v[j].v[k]) - mean) * rstd) + bv[k]);
      *reinterpret_cast<Frag<T, VEC>*>(y + base + c) = o;
    }
  }
}

// dx of every row (when dx is given) and, when part is given, the block's
// partial row of Σ dy·x̂ (columns [0, W)) and Σ dy (columns [W, 2W)) over its
// rows: part[blockIdx.x · 2W + ...].
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, 2)
    ln_f32_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ part,
                      long long rows, int width, int row_warps, float eps) {
  __shared__ float red1[kWarps][1];
  __shared__ float red[kWarps][2];
  __shared__ float fold[2 * kMaxWidth];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tpr = 32 * row_warps;
  const int t = (warp % row_warps) * 32 + lane;
  const int per_block = kWarps / row_warps;
  const int group = warp / row_warps;
  const long long groups = (rows + per_block - 1) / per_block;
  const float inv_w = 1.f / float(width);

  float ag[NV][VEC], ab[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) ag[j][k] = ab[j][k] = 0.f;
  }

  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const long long row = gi * per_block + group;
    const bool live = row < rows;
    const long long base = (live ? row : 0) * (long long)width;
    Frag<T, VEC> xv[NV], gv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * tpr + t) * VEC;
      if (live && c < width) {
        xv[j] = *reinterpret_cast<const Frag<T, VEC>*>(x + base + c);
        gv[j] = *reinterpret_cast<const Frag<T, VEC>*>(dy + base + c);
      }
    }
    float m, r;
    row_stats<T, VEC, NV>(xv, live, tpr, t, width, eps, red1, row_warps, warp, lane, m, r);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * tpr + t) * VEC;
      if (live && c < width) {
        float wv[VEC];
        load_f32<VEC>(w + c, wv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xh = (to_f(xv[j].v[k]) - m) * r;
          const float g = to_f(gv[j].v[k]);
          const float wg = wv[k] * g;
          s[0] += wg;
          s[1] += wg * xh;
          ag[j][k] += g * xh;
          ab[j][k] += g;
        }
      }
    }
    row_reduce<2>(s, red, row_warps, warp, lane);
    if (live && dx != nullptr) {
      const float a = s[0] * inv_w, bq = s[1] * inv_w;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * tpr + t) * VEC;
        if (c < width) {
          float wv[VEC];
          load_f32<VEC>(w + c, wv);
          Frag<T, VEC> o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xh = (to_f(xv[j].v[k]) - m) * r;
            const float wg = wv[k] * to_f(gv[j].v[k]);
            o.v[k] = from_f<T>(r * (wg - a - xh * bq));
          }
          *reinterpret_cast<Frag<T, VEC>*>(dx + base + c) = o;
        }
      }
    }
  }
  if (part == nullptr) return;  // the same for the whole block

  // the block's row groups folded in group order, then one partial row
  for (int gi = 0; gi < per_block; ++gi) {
    if (group == gi) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * tpr + t) * VEC;
        if (c < width) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (gi == 0) {
              fold[c + k] = ag[j][k];
              fold[width + c + k] = ab[j][k];
            } else {
              fold[c + k] += ag[j][k];
              fold[width + c + k] += ab[j][k];
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.x * 2 * width;
  for (int i = threadIdx.x; i < 2 * width; i += kThreads) out[i] = fold[i];
}

// part[c] = Σ_p part[p · cols + c] for the cols = 2W columns [dw | db],
// written over the first partial row: a block of 32 columns x 32 row
// slices; a slice loads its every 32nd partial row, up to kSliceLoads at
// once, and sums them in order; then the 32 slices are added in order. A
// column is read only by its block, and written after the block's barrier.
__global__ void __launch_bounds__(32 * kSlices)
    ln_f32_dparams_kernel(float* part, int parts, int cols) {
  __shared__ float sums[kSlices][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (col < cols) {
    for (int p0 = ty; p0 < parts; p0 += kSlices * kSliceLoads) {
      float v[kSliceLoads];
#pragma unroll
      for (int i = 0; i < kSliceLoads; ++i) {
        const int p = p0 + i * kSlices;
        v[i] = p < parts ? part[(long long)p * cols + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSliceLoads; ++i) acc += v[i];
    }
  }
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float total = sums[0][tx];
    for (int k = 1; k < kSlices; ++k) total += sums[k][tx];
    part[col] = total;
  }
}

template <typename T, int VEC, int NV>
int launch_fwd(const void* x, const void* w, const void* b, void* y, long long rows, int width,
               int row_warps, float eps, cudaStream_t stream) {
  const long long per_block = kWarps / row_warps;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  ln_f32_fwd_kernel<T, VEC, NV><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, width, row_warps, eps);
  return int(cudaGetLastError());
}

template <typename T, int VEC, int NV>
int launch_bwd(const void* dy, const void* x, const void* w, void* dx, void* part, int grid,
               long long rows, int width, int row_warps, float eps, cudaStream_t stream) {
  ln_f32_bwd_kernel<T, VEC, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(dx), static_cast<float*>(part), rows, width, row_warps, eps);
  return int(cudaGetLastError());
}

template <typename T, int VEC, int NV>
int occupancy_bwd(int* blocks_per_sm) {
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ln_f32_bwd_kernel<T, VEC, NV>, kThreads, 0));
}

}  // namespace

// The instantiations `ln_plan` picks from: bf16 in vectors of 8 (1-3 a
// lane) or single values (up to 16 a lane); float32 in vectors of 4 (1-2 a
// lane, 3-4 only at 8 warps a row) or single values (up to 16).
#define LN_DISPATCH(FN, ...)                                                        \
  {                                                                                 \
    if (dtype == 1 && vec == 8 && nv == 1) return FN<__nv_bfloat16, 8, 1>(__VA_ARGS__); \
    if (dtype == 1 && vec == 8 && nv == 2) return FN<__nv_bfloat16, 8, 2>(__VA_ARGS__); \
    if (dtype == 1 && vec == 8 && nv == 3) return FN<__nv_bfloat16, 8, 3>(__VA_ARGS__); \
    if (dtype == 1 && vec == 1 && nv == 16) return FN<__nv_bfloat16, 1, 16>(__VA_ARGS__); \
    if (dtype == 0 && vec == 4 && nv == 1) return FN<float, 4, 1>(__VA_ARGS__);     \
    if (dtype == 0 && vec == 4 && nv == 2) return FN<float, 4, 2>(__VA_ARGS__);     \
    if (dtype == 0 && vec == 4 && nv == 3) return FN<float, 4, 3>(__VA_ARGS__);     \
    if (dtype == 0 && vec == 4 && nv == 4) return FN<float, 4, 4>(__VA_ARGS__);     \
    if (dtype == 0 && vec == 1 && nv == 16) return FN<float, 1, 16>(__VA_ARGS__);   \
    return int(cudaErrorInvalidValue);                                              \
  }

static int dispatch_bwd(const void* dy, const void* x, int dtype, const void* w, void* dx,
                        void* part, int grid, long long rows, int width, int vec, int nv,
                        int row_warps, float eps, cudaStream_t stream) {
  LN_DISPATCH(launch_bwd, dy, x, w, dx, part, grid, rows, width, row_warps, eps, stream);
}

static bool geometry_ok(long long rows, int width, int vec, int nv, int row_warps) {
  return rows >= 1 && width >= 1 && width <= kMaxWidth && width % vec == 0 &&
         (row_warps == 1 || row_warps == 2 || row_warps == 4 || row_warps == 8) &&
         (long long)32 * row_warps * nv * vec >= width;
}

// dtype: 0 float32, 1 bf16. x, y (rows, width) contiguous; w, b (width,)
// float32. Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a geometry
// the kernels do not take.
extern "C" int ln_f32_fwd(const void* x, int dtype, const void* w, const void* b, void* y,
                          long long rows, int width, int vec, int nv, int row_warps, float eps,
                          void* stream) {
  if (!geometry_ok(rows, width, vec, nv, row_warps)) return int(cudaErrorInvalidValue);
  LN_DISPATCH(launch_fwd, x, w, b, y, rows, width, row_warps, eps,
              static_cast<cudaStream_t>(stream));
}

// dy, x, dx (rows, width) contiguous in x's type; w (width,) float32; eps
// the forward's. dx or part may be null (that output is skipped); part is
// (grid, 2·width) float32, and its first row becomes the column sums
// [dw | db] (a second launch, on the same stream).
extern "C" int ln_f32_bwd(const void* dy, const void* x, int dtype, const void* w, void* dx,
                          void* part, int grid, long long rows, int width, int vec, int nv,
                          int row_warps, float eps, void* stream) {
  if (!geometry_ok(rows, width, vec, nv, row_warps) || grid < 1)
    return int(cudaErrorInvalidValue);
  const int err = dispatch_bwd(dy, x, dtype, w, dx, part, grid, rows, width, vec, nv,
                               row_warps, eps, static_cast<cudaStream_t>(stream));
  if (err != 0 || part == nullptr) return err;
  const int cols = 2 * width;
  ln_f32_dparams_kernel<<<(cols + 31) / 32, dim3(32, kSlices), 0,
                          static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(part), grid,
                                                               cols);
  return int(cudaGetLastError());
}

// Blocks of the backward kernel an SM holds at once, for its grid.
extern "C" int ln_f32_bwd_occupancy(int dtype, int vec, int nv, int* blocks_per_sm) {
  LN_DISPATCH(occupancy_bwd, blocks_per_sm);
}
