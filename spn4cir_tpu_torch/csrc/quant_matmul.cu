// Int8 weight-only matrix product for Hopper (sm_90a), for the LLaMA
// decoders' decode steps.
//
// Replaces the TPU kernel `_kernel` (reached through `quant_matmul`) in
// spn4cir_tpu/ops/quant_matmul.py.
//
//     y[r, f] = (Σ_d x[r, d] · W[d, f]) · s[f]     summed in float32, y in x's type
//
// x (R, D) float32 or bf16 (the caller flattens leading dims); W (D, F) int8,
// the JAX package's layout, read as it lies (no re-packed copy); s (F,)
// float32. Any R, D, F >= 1: ragged edges are masked in the kernel.
//
// What bounds it: bytes at decode. The int8 weight is read once: (4096,
// 11008) is 45.1 MB, 0.0135 ms at 3.35 TB/s. On the CUDA cores its 2·R·D·F
// float32 operations weighed as much past R ~ 8, so the products run on the
// bf16 tensor cores, exactly:
//   - an int8 value is exact in bf16, and a float32 x is split once, as it is
//     staged, into three bf16 terms hi + mid + lo (8 + 8 + 8 significand
//     bits: their sum is x for finite x in bf16's normal range); each term
//     times W is exact in float32, so three `mma.sync.m16n8k16` over one W
//     fragment give float32 x @ W (bf16 x: one). At 16 rows that is 3 x 1.44
//     GFLOP at (4096, 11008), 0.0044 ms at 989 TFLOP/s, below the bytes;
//   - the tensor cores truncate their accumulation, so each warp sums one
//     ring stage (32 of depth, 3 terms) into a zeroed tile and adds it to its
//     float32 sums (the summation of bank_infonce.cu);
//   - operand roles yᵀ = Wᵀ·xᵀ: y's columns are the MMA's M, x's <= 16 rows
//     its N (one or two n8 tiles), so every weight tile is read once for all
//     16 rows of a decode step. The order of M inside a warp's 64 columns and
//     of K inside a 16-deep step is free as long as A and B agree: a lane
//     (g, t) takes W rows 4t..4t+3 and columns 8g..8g+7 (four 8-byte shared
//     loads, no transpose), and its B fragment is x[row][4t..4t+3], one
//     8-byte load; an int8 pair of two rows becomes a bf16 pair with one
//     byte permute, two masks and one bf16x2 add;
//   - a `cp.async` ring of 4 W stages (64 rows x 256 columns) and x stages
//     one ahead of W, so the float32 split of stage k+1 is done while stage
//     k's products run, with one barrier a stage; the copies' slow path
//     (rows not 16-byte aligned) lies out of line;
//   - grid = (splits of D, 256-column tiles, 16-row tiles); the splits of a
//     column tile form one thread-block cluster (up to 16, past 8
//     non-portable). `split_plan` takes the most splits whose clusters the
//     card holds all at once (the occupancy API's count a cluster size):
//     shorter blocks, and no second wave. Each block leaves its partial in
//     shared memory, and the blocks of the cluster add the splits in index
//     order through distributed shared memory, scale, cast and write y. One
//     launch, no float32 scratch in device memory.
// No atomics: every sum has a fixed order, so a relaunch gives the same bits.

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

using mma_sync::bf16;

constexpr int kColWarps = 4;                            // warps across a block's columns
constexpr int kDepthWarps = 2;                          // warps across a stage's depth
constexpr int kThreads = 32 * kColWarps * kDepthWarps;  // 256
constexpr int kCols = 64 * kColWarps;                   // columns of W a block: 256
constexpr int kDepth = 64;                              // rows of W a ring stage
constexpr int kStages = 4;                              // W stages in the ring
constexpr int kXSlots = kStages + 1;                    // x stages, one ahead of W
constexpr int kWLd = kCols + 16;                        // bytes of a W row in shared memory
constexpr int kXLd = kDepth + 16;                       // bf16 of an x row (planes, bf16 x)
constexpr int kPLd = kCols + 4;                         // floats of a partial row
constexpr int kMaxSplits = 16;                          // a cluster, non-portable past 8
constexpr int kSteps = kDepth / 16 / kDepthWarps;       // 16-deep steps of a warp a stage
constexpr int kCopyRows = kThreads / (kCols / 16);      // W rows one pass of 16-byte copies covers
static_assert(kSteps >= 1 && kDepth % kCopyRows == 0, "stage shape");
static_assert(16 * kDepth * 4 / 16 <= kThreads, "16 float32 rows of x a stage: a chunk a thread");

// Shared memory of a block over NT n8 tiles (8·NT rows of x).
template <typename X, int NT>
struct Layout {
  static constexpr bool kSplit = std::is_same<X, float>::value;
  static constexpr int kRows = 8 * NT;
  static constexpr int kW = kStages * kDepth * kWLd;
  // float32 x as it lies (rows of kDepth floats); bf16 x in rows of kXLd
  static constexpr int kXRow = kSplit ? kDepth * 4 : kXLd * 2;
  static constexpr int kX = kXSlots * kRows * kXRow;
  // float32 x as three bf16 planes (hi, mid, lo), two stages of them
  static constexpr int kPlanes = kSplit ? 2 * 3 * kRows * kXLd * 2 : 0;
  static constexpr int kBytes = kW + kX + kPlanes;
  static_assert(kRows * kPLd * 4 <= kW, "the partial reuses the W ring");
};

struct Args {
  const void* x;
  const int8_t* w;
  const float* s;
  int R, D, F, d_per_split, n_splits;
  int w_vec, x_vec;  // 16-byte aligned rows: cp.async, else byte loads
  void* y;
};

// The copies' slow path, for rows that are not 16-byte aligned: 16 bytes of
// W row k from column c (zero past k_end and F), and of x row r from depth k
// (zero past R and k_end), as plain loads and a shared-memory store. Out of
// line, so that the aligned path's main loop stays short.
__device__ __noinline__ void copy_w_bytes(uint8_t* dst, const int8_t* w, int k, int c, int k_end,
                                          int F) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (k < k_end) {
    for (int e = 0; e < 16; ++e)
      if (c + e < F) v[e >> 2] |= uint32_t(uint8_t(w[size_t(k) * F + c + e])) << (8 * (e & 3));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <typename X>
__device__ __noinline__ void copy_x_values(uint8_t* dst, const X* x, int r, int k, int R, int D,
                                           int k_end) {
  using Raw = typename std::conditional<sizeof(X) == 4, uint32_t, uint16_t>::type;
  constexpr int n = 16 / sizeof(X);
  const Raw* src = reinterpret_cast<const Raw*>(x) + size_t(r) * D;
  union {
    uint4 u;
    Raw v[n];
  } chunk;
#pragma unroll
  for (int e = 0; e < n; ++e) chunk.v[e] = (r < R && k + e < k_end) ? src[k + e] : Raw(0);
  *reinterpret_cast<uint4*>(dst) = chunk.u;
}

// Two float32 values as three bf16 pairs, hi + mid + lo (low halves: x0):
// each term the round-to-nearest of what the earlier ones left, so the sum
// is x exactly for finite x in bf16's normal range; inf and NaN go whole
// into hi.
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = mma_sync::pack_bf16(x0, x1);
  const float r0 = finite(x0) ? x0 - __uint_as_float(hi << 16) : 0.f;
  const float r1 = finite(x1) ? x1 - __uint_as_float(hi & 0xffff0000u) : 0.f;
  mid = mma_sync::pack_bf16(r0, r1);
  lo = mma_sync::pack_bf16(r0 - __uint_as_float(mid << 16),
                           r1 - __uint_as_float(mid & 0xffff0000u));
}

// A bf16 pair of two int8 weights, exact: byte b of u (low half) and byte b
// of v (high half). With the byte at bits 0-7 of a half, (byte & 0x7f) |
// 0x4300 is the bf16 128 + (byte & 127) and (byte & 0x80) | 0xc300 is -128 -
// (byte & 128); their sum is the int8 value, exact in bf16.
// (a & m) | c in one instruction (the compiler splits it in two when both
// constants are immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t m, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(m), "r"(c));
  return d;
}

template <int b>
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, uint32_t v) {
  const uint32_t t = __byte_perm(u, v, b | ((4 + b) << 8));
  const uint32_t mag = and_or(t, 0x007f007fu, 0x43004300u);
  const uint32_t off = and_or(t, 0x00800080u, 0xc300c300u);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(mag), "r"(0x3f803f80u), "r"(off));
  return r;
}

// The A fragments of M tile i (columns 8g + 2i, 8g + 2i + 1 of the warp's 64)
// from the lane's W rows 4t..4t+3: k = 2t, 2t+1 are rows 4t, 4t+1 and k =
// 2t+8, 2t+9 rows 4t+2, 4t+3.
template <int i>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint2 (&w)[4]) {
  constexpr int b = (i & 1) * 2;
  const uint32_t u0 = i < 2 ? w[0].x : w[0].y, u1 = i < 2 ? w[1].x : w[1].y;
  const uint32_t u2 = i < 2 ? w[2].x : w[2].y, u3 = i < 2 ? w[3].x : w[3].y;
  a[0] = widen_pair<b>(u0, u1);
  a[1] = widen_pair<b + 1>(u0, u1);
  a[2] = widen_pair<b>(u2, u3);
  a[3] = widen_pair<b + 1>(u2, u3);
}

template <typename X>
__device__ __forceinline__ X narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16(v); }

template <typename X, int NT>
__global__ void __launch_bounds__(kThreads, 2) quant_matmul_tc_kernel(const Args a) {
  using L = Layout<X, NT>;
  constexpr bool kSplit = L::kSplit;
  constexpr int kTerms = kSplit ? 3 : 1;
  constexpr int kRows = L::kRows;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* w_ring = smem;
  uint8_t* x_ring = smem + L::kW;
  bf16* planes = reinterpret_cast<bf16*>(smem + L::kW + L::kX);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % kColWarps, kw = warp / kColWarps;
  const int col0 = blockIdx.y * kCols;
  const int r0 = blockIdx.z * kRows;
  const int d_begin = blockIdx.x * a.d_per_split;
  const int d_end = min(a.D, d_begin + a.d_per_split);
  const int n_k = (d_end - d_begin + kDepth - 1) / kDepth;
  const X* x = static_cast<const X*>(a.x);

  // This thread's copies of a stage: W rows wr + kCopyRows·j, 16 bytes at
  // column col0 + wc; x row xr, 16 bytes at depth xk (threads past the x
  // stage's chunks copy none). The aligned path walks a pointer a stage;
  // only the rows past d_end (the split's last stage) are zero-filled.
  constexpr int kXChunks = kRows * kDepth * int(sizeof(X)) / 16;
  constexpr int kXPerRow = kDepth * int(sizeof(X)) / 16;
  const int wr = tid / (kCols / 16), wc = (tid % (kCols / 16)) * 16;
  const int xr = tid / kXPerRow, xk = (tid % kXPerRow) * (16 / int(sizeof(X)));
  const bool w_cols = col0 + wc < a.F, x_row = r0 + xr < a.R && tid < kXChunks;
  const int8_t* w_src = w_cols ? a.w + size_t(d_begin + wr) * a.F + col0 + wc : a.w;
  const X* x_src = x_row ? x + size_t(r0 + xr) * a.D + d_begin + xk : x;
  const size_t w_step = size_t(kCopyRows) * a.F;
  auto issue_w = [&](int st) {
    if (st >= n_k) return;
    uint8_t* dst = w_ring + (st % kStages) * kDepth * kWLd + wr * kWLd + wc;
    const int k = d_begin + st * kDepth + wr;
    if (a.w_vec) {
      const int8_t* src = w_src + size_t(st) * kDepth * a.F;
#pragma unroll
      for (int j = 0; j < kDepth / kCopyRows; ++j)
        mma_sync::cp_async16(dst + j * kCopyRows * kWLd, w_cols ? src + j * w_step : a.w,
                             w_cols && k + j * kCopyRows < d_end);
    } else {
      for (int j = 0; j < kDepth / kCopyRows; ++j)
        copy_w_bytes(dst + j * kCopyRows * kWLd, a.w, k + j * kCopyRows, col0 + wc, d_end, a.F);
    }
  };
  auto issue_x = [&](int st) {
    if (st >= n_k || tid >= kXChunks) return;
    uint8_t* dst = x_ring + (st % kXSlots) * kRows * L::kXRow + xr * L::kXRow + xk * int(sizeof(X));
    const int k = d_begin + st * kDepth + xk;
    if (a.x_vec)
      mma_sync::cp_async16(dst, x_row ? x_src + st * kDepth : x, x_row && k < d_end);
    else
      copy_x_values<X>(dst, x, r0 + xr, k, a.R, a.D, d_end);
  };
  // float32 x of stage st -> planes[st & 1]: hi, mid, lo, each (kRows, kXLd);
  // the rows past R stay zero from the start
  const int x_rows = min(kRows, a.R - r0);
  auto split_x = [&](int st) {
    if constexpr (kSplit) {
      if (st >= n_k) return;
      const float* src = reinterpret_cast<const float*>(x_ring + (st % kXSlots) * kRows * L::kXRow);
      bf16* dst = planes + (st & 1) * 3 * kRows * kXLd;
      for (int i = tid; i < x_rows * kDepth / 4; i += kThreads) {
        const int row = i / (kDepth / 4), k = (i % (kDepth / 4)) * 4;
        const float4 v = *reinterpret_cast<const float4*>(src + row * kDepth + k);
        uint2 hi, mid, lo;
        split3(v.x, v.y, hi.x, mid.x, lo.x);
        split3(v.z, v.w, hi.y, mid.y, lo.y);
        *reinterpret_cast<uint2*>(dst + row * kXLd + k) = hi;
        *reinterpret_cast<uint2*>(dst + (kRows + row) * kXLd + k) = mid;
        *reinterpret_cast<uint2*>(dst + (2 * kRows + row) * kXLd + k) = lo;
      }
    }
  };

  // the ring: group A = x(0); group st = W(st) + x(st + 1)
  issue_x(0);
  mma_sync::cp_async_commit();
  for (int st = 0; st < kStages - 1; ++st) {
    issue_w(st);
    issue_x(st + 1);
    mma_sync::cp_async_commit();
  }
  if constexpr (kSplit) {
    if (x_rows < kRows) {
      for (int i = tid; i < L::kPlanes / 16; i += kThreads)
        reinterpret_cast<uint4*>(planes)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    mma_sync::cp_async_wait<kStages - 1>();
    __syncthreads();
    split_x(0);
  }

  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    mma_sync::cp_async_wait<kStages - 2>();  // W(it) and x(it + 1) have landed
    __syncthreads();
    issue_w(it + kStages - 1);
    issue_x(it + kStages);
    mma_sync::cp_async_commit();
    split_x(it + 1);

    const uint8_t* ws = w_ring + (it % kStages) * kDepth * kWLd + cw * 64 + 8 * g;
    const bf16* xs = kSplit ? planes + (it & 1) * 3 * kRows * kXLd
                            : reinterpret_cast<const bf16*>(x_ring + (it % kXSlots) * kRows * L::kXRow);
    float stage[4][NT][4];
#pragma unroll
    for (int kk2 = 0; kk2 < kSteps; ++kk2) {
      const int k = (kw * kSteps + kk2) * 16 + 4 * t;
      uint2 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const uint2*>(ws + (k + j) * kWLd);
      // B fragments, terms in the order they are summed: lo, mid, hi
      uint32_t bq[NT][kTerms][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int u = 0; u < kTerms; ++u) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              xs + ((kTerms - 1 - u) * kRows + n * 8 + g) * kXLd + k);
          bq[n][u][0] = v.x;
          bq[n][u][1] = v.y;
        }
      uint32_t af[4][4];
      a_frag<0>(af[0], w);
      a_frag<1>(af[1], w);
      a_frag<2>(af[2], w);
      a_frag<3>(af[3], w);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int u = 0; u < kTerms; ++u) {
            if (kk2 == 0 && u == 0)
              mma_sync::mma16816_zero(stage[i][n], af[i], bq[n][u][0], bq[n][u][1]);
            else
              mma_sync::mma16816(stage[i][n], af[i], bq[n][u][0], bq[n][u][1]);
          }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += stage[i][n][e];
  }

  // the block's partial (kRows, kCols) in shared memory: the depth warps in
  // order. acc[i][n][2h + e] is column 8g + 2i + h of the warp, row 8n + 2t + e.
  mma_sync::cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  auto at = [&](int n, int e) { return part + (8 * n + 2 * t + e) * kPLd + cw * 64 + 8 * g; };
#pragma unroll
  for (int dw = 0; dw < kDepthWarps; ++dw) {
    if (kw == dw) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float4* p = reinterpret_cast<float4*>(at(n, e));
          float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
          if (dw > 0) {
            o0 = p[0];
            o1 = p[1];
          }
          p[0] = make_float4(o0.x + acc[0][n][e], o0.y + acc[0][n][2 + e], o0.z + acc[1][n][e],
                             o0.w + acc[1][n][2 + e]);
          p[1] = make_float4(o1.x + acc[2][n][e], o1.y + acc[2][n][2 + e], o1.z + acc[3][n][e],
                             o1.w + acc[3][n][2 + e]);
        }
    }
    if (dw + 1 < kDepthWarps) __syncthreads();
  }

  // the splits of the cluster in index order, scaled and cast: each block
  // of the cluster writes its share of the tile
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_splits = a.n_splits, rank = int(cluster.block_rank());
  X* y = static_cast<X*>(a.y);
  for (int i = rank * kThreads + tid; i < kRows * kCols / 4; i += n_splits * kThreads) {
    const int row = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    // four splits' loads in flight at once, then their sum in order
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n_splits; j0 += 4) {
      float4 o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j0 + j < n_splits)
          o[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, j0 + j) +
                                                  row * kPLd + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j0 + j < n_splits) {
          sum.x += o[j].x;
          sum.y += o[j].y;
          sum.z += o[j].z;
          sum.w += o[j].w;
        }
      }
    }
    const int r = r0 + row, col = col0 + c;
    if (r >= a.R) continue;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < a.F) y[size_t(r) * a.F + col + e] = narrow<X>(v[e] * a.s[col + e]);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename X, int NT>
cudaError_t prepare() {
  auto kern = quant_matmul_tc_kernel<X, NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<X, NT>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// a launch of `grid` blocks in clusters of n_splits along x
template <typename X, int NT>
cudaLaunchConfig_t config(dim3 grid, int n_splits, cudaLaunchAttribute* attr, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<X, NT>::kBytes;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename X, int NT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaError_t err = prepare<X, NT>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const dim3 grid(a.n_splits, (a.F + kCols - 1) / kCols, (a.R + 8 * NT - 1) / (8 * NT));
  const cudaLaunchConfig_t cfg = config<X, NT>(grid, a.n_splits, attr, st);
  err = cudaLaunchKernelEx(&cfg, quant_matmul_tc_kernel<X, NT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// clusters of n_splits blocks that the card holds at once
template <typename X, int NT>
cudaError_t clusters(int n_splits, int* count) {
  cudaError_t err = prepare<X, NT>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<X, NT>(dim3(n_splits, 1, 1), n_splits, attr, nullptr);
  return cudaOccupancyMaxActiveClusters(count, quant_matmul_tc_kernel<X, NT>, &cfg);
}

template <typename X>
cudaError_t dispatch(const Args& a, int n_tiles, cudaStream_t st) {
  return n_tiles == 1 ? launch<X, 1>(a, st) : launch<X, 2>(a, st);
}

}  // namespace

// Clusters of n_splits blocks of the kernel for x_dtype (0 float32, 1 bf16)
// and n_tiles n8 tiles (1: up to 8 rows of x a block, 2: up to 16) that the
// card holds at once. Returns a cudaError_t.
extern "C" int quant_matmul_clusters(int x_dtype, int n_tiles, int n_splits, int* count) {
  if ((x_dtype != 0 && x_dtype != 1) || (n_tiles != 1 && n_tiles != 2) || n_splits < 1 ||
      n_splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  if (x_dtype == 0)
    return int(n_tiles == 1 ? clusters<float, 1>(n_splits, count)
                            : clusters<float, 2>(n_splits, count));
  return int(n_tiles == 1 ? clusters<bf16, 1>(n_splits, count) : clusters<bf16, 2>(n_splits, count));
}

// x_dtype: 0 float32, 1 bf16; n_tiles: 1 or 2 (8·n_tiles rows of x a
// block); D cut into n_splits <= 8 splits of d_per_split (a multiple of 64
// unless there is one split). Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for arguments the kernel does not take.
extern "C" int quant_matmul(const void* x, int x_dtype, const void* w, const void* scales, int R,
                            int D, int F, int n_tiles, int d_per_split, int n_splits, void* y,
                            void* stream) {
  if (R < 1 || D < 1 || F < 1 || (x_dtype != 0 && x_dtype != 1) ||
      (n_tiles != 1 && n_tiles != 2) || n_splits < 1 || n_splits > kMaxSplits ||
      d_per_split < 1 || (n_splits > 1 && d_per_split % kDepth) ||
      (long long)(n_splits - 1) * d_per_split >= D || (long long)n_splits * d_per_split < D ||
      (F + kCols - 1) / kCols > 65535 || (R + 8 * n_tiles - 1) / (8 * n_tiles) > 65535)
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
  const int x_size = x_dtype == 0 ? 4 : 2;
  a.w_vec = F % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.x_vec = (size_t(D) * x_size) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.y = y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return int(dispatch<float>(a, n_tiles, st));
  return int(dispatch<bf16>(a, n_tiles, st));
}
