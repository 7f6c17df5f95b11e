// Int8 weight-only matrix product for Hopper (sm_90a), for the LLaMA
// decoders' decode steps.
//
// Replaces the TPU kernel `_kernel` (reached through `quant_matmul`) in
// spn4cir_tpu/ops/quant_matmul.py.
//
//     y[r, f] = (Σ_d x[r, d] · W[d, f]) · s[f]     summed in float32, y in x's type
//
// x (R, D) float32 or bf16 (the caller flattens leading dims); W (D, F) int8,
// the JAX package's layout; s (F,) float32. Any R, D, F >= 1: ragged edges are
// masked in the kernel (the TPU's VMEM-budget block shrinking has no
// counterpart here).
//
// What bounds it: bytes at decode. The int8 weight is read once: (4096, 4096)
// is 16.8 MB, 0.0050 ms at 3.35 TB/s; (4096, 11008) 45.1 MB, 0.0135 ms;
// lm_head (4096, 32000) 131 MB, 0.039 ms. At R rows it does 2·R·D·F
// operations on the CUDA cores (x stays float32, so no tensor-core type fits
// it exactly), which past R ~ 8 weigh as much as the bytes. The design:
//   - grid = (row tiles of RT <= 8, 256-column tiles, splits of D); the row
//     tiles of one column tile are neighbours in launch order, so a weight
//     tile that two row tiles need is read from HBM once and then from L2;
//   - a block is 4 warps on the same 256 columns: a lane owns 8 consecutive
//     columns (one 8-byte load; a warp reads 256 contiguous bytes of a W
//     row), the warps take interleaved rows of the block's D range, 8 loads
//     in flight each; float32 accumulators RT x 8 live in registers;
//   - the x rows are staged in shared memory as float32 in chunks of 128
//     along D and read as broadcasts;
//   - the 4 warps' sums are added in a fixed order through shared memory;
//     with one split the block scales, casts and writes y, with more it
//     writes float32 partials and a reduce kernel adds the splits in index
//     order, then scales and casts.
// No atomics: a relaunch gives the same bits.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 256;      // columns of a block: 32 lanes x 8
constexpr int kChunk = 128;     // depth of an x chunk in shared memory
constexpr int kUnroll = 8;      // W rows a warp keeps in flight

template <typename X>
__device__ __forceinline__ float widen(X v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename X>
__device__ __forceinline__ X narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 int8 weights of one W row at column c0 (masked past F; vec: F % 8 == 0).
__device__ __forceinline__ uint2 load_w(const int8_t* row, int c0, int F, bool vec) {
  if (vec) {
    if (c0 < F) return *reinterpret_cast<const uint2*>(row + c0);
    return make_uint2(0u, 0u);
  }
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (c0 + e < F) lo |= uint32_t(uint8_t(row[c0 + e])) << (8 * e);
    if (c0 + 4 + e < F) hi |= uint32_t(uint8_t(row[c0 + 4 + e])) << (8 * e);
  }
  return make_uint2(lo, hi);
}

struct Args {
  const void* x;
  const int8_t* w;
  const float* s;
  int R, D, F, d_per_split, n_splits;
  void* y;
  float* part;  // (n_splits, R, F)
};

template <typename X, int RT>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(const Args a) {
  __shared__ float xs[RT][kChunk];
  __shared__ float red[kWarps][RT][kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * RT;
  const int col0 = blockIdx.y * kCols;
  const int c0 = col0 + lane * 8;
  const int d_begin = blockIdx.z * a.d_per_split;
  const int d_end = min(a.D, d_begin + a.d_per_split);
  const bool vec = (a.F % 8) == 0;
  const X* x = static_cast<const X*>(a.x);

  float acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;

  for (int dc = d_begin; dc < d_end; dc += kChunk) {
    const int depth = min(kChunk, d_end - dc);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < RT * kChunk; i += kThreads) {
      const int r = i / kChunk, dd = i % kChunk;
      xs[r][dd] = (r0 + r < a.R && dd < depth) ? widen(x[size_t(r0 + r) * a.D + dc + dd]) : 0.f;
    }
    __syncthreads();
    for (int base = warp; base < depth; base += kWarps * kUnroll) {
      uint2 wr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int dd = base + u * kWarps;
        wr[u] = dd < depth ? load_w(a.w + size_t(dc + dd) * a.F, c0, a.F, vec) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int dd = base + u * kWarps;
        if (dd >= depth) break;
        float wf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wf[e] = float(int8_t((wr[u].x >> (8 * e)) & 0xffu));
          wf[4 + e] = float(int8_t((wr[u].y >> (8 * e)) & 0xffu));
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float xv = xs[r][dd];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(xv, wf[e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp][r][lane * 8 + e] = acc[r][e];
  __syncthreads();
  for (int i = threadIdx.x; i < RT * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int row = r0 + r, col = col0 + c;
    if (row >= a.R || col >= a.F) continue;
    float sum = red[0][r][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[w][r][c];
    if (a.n_splits == 1) {
      static_cast<X*>(a.y)[size_t(row) * a.F + col] = narrow<X>(sum * a.s[col]);
    } else {
      a.part[(size_t(blockIdx.z) * a.R + row) * a.F + col] = sum;
    }
  }
}

// y = (Σ_split part[split]) · s, the splits in index order, cast to X.
template <typename X>
__global__ void __launch_bounds__(256) quant_matmul_reduce_kernel(const float* part, const float* s,
                                                                  int n_splits, int R, int F,
                                                                  X* y) {
  const size_t i = size_t(blockIdx.x) * 256 + threadIdx.x;
  const size_t n = size_t(R) * F;
  if (i >= n) return;
  float sum = part[i];
  for (int sp = 1; sp < n_splits; ++sp) sum += part[sp * n + i];
  y[i] = narrow<X>(sum * s[i % F]);
}

template <typename X, int RT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 grid((a.R + RT - 1) / RT, (a.F + kCols - 1) / kCols, a.n_splits);
  quant_matmul_kernel<X, RT><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  const size_t n = size_t(a.R) * a.F;
  quant_matmul_reduce_kernel<X><<<unsigned((n + 255) / 256), 256, 0, st>>>(
      a.part, a.s, a.n_splits, a.R, a.F, static_cast<X*>(a.y));
  return cudaGetLastError();
}

template <typename X>
cudaError_t dispatch_rows(const Args& a, int rows_per_tile, cudaStream_t st) {
  switch (rows_per_tile) {
    case 1: return launch<X, 1>(a, st);
    case 2: return launch<X, 2>(a, st);
    case 4: return launch<X, 4>(a, st);
    case 8: return launch<X, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x_dtype: 0 float32, 1 bf16; rows_per_tile in {1, 2, 4, 8}; d_per_split a
// multiple of 128 unless there is one split. Returns a cudaError_t.
extern "C" int quant_matmul(const void* x, int x_dtype, const void* w, const void* scales, int R,
                            int D, int F, int rows_per_tile, int d_per_split, int n_splits,
                            void* y, void* part, void* stream) {
  if (R < 1 || D < 1 || F < 1 || d_per_split < 1 || n_splits < 1 ||
      (n_splits > 1 && d_per_split % kChunk) || (F + kCols - 1) / kCols > 65535)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(scales);
  a.R = R;
  a.D = D;
  a.F = F;
  a.d_per_split = d_per_split;
  a.n_splits = n_splits;
  a.y = y;
  a.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return int(dispatch_rows<float>(a, rows_per_tile, st));
    case 1: return int(dispatch_rows<__nv_bfloat16>(a, rows_per_tile, st));
    default: return int(cudaErrorInvalidValue);
  }
}
