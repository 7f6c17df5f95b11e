// Grouped SwiGLU experts for Hopper (sm_90a), kernel #14: every routed row
// of a mixture-of-experts layer through its expert's MLP,
//
//     h[r] = bf16(silu(x[src[r]] · Wg[e]ᵀ) ⊙ (x[src[r]] · Wu[e]ᵀ))     (R, I)
//     y[r] = bf16(h[r] · Wd[e]ᵀ)                                      (R, D)
//
// for the rows r in [off[e], off[e+1]) of expert e: rows sorted by expert,
// `src` the token each sorted row reads, `off` (E + 1,) the groups' bounds,
// all on the device. bf16 operands on the tensor cores (`mma.sync`
// m16n8k16), float32 sums, SwiGLU in float32 in the first product's
// epilogue, one rounding to bf16 per output.
//
// It replaces no Pallas kernel: the JAX package has no mixture of experts.
// Without it a layer runs a Python loop over 64 experts, which needs each
// group's size on the host (a sync a layer) and ~500 launches.
//
// What bounds it: at a decode step (~12 rows an expert) the bytes of the
// experts' weights, every expert's 17 MB read once a layer; at a prefill
// (~3,800 rows an expert) the products. So:
//   - the tile schedule comes from the device offsets: block y of the grid
//     takes the y-th BM-row tile of the concatenated groups (each block
//     finds its expert by a warp scan of ceil(count / BM) over the experts),
//     the grid is sized for the worst case, ceil(R / BM) + E tiles, and the
//     blocks past the last tile return at once. Nothing waits on the host;
//     an empty expert has no tile and its weights are never read;
//   - two tile shapes (`moe_plan` in ops/moe_grouped.py): BM = 32 rows with
//     4 warps where groups are small, so a decode step's weights stream
//     through ~1,400 blocks with little padding; BM = 128 with 8 warps
//     where groups are large, so each weight tile is reused by 128 rows;
//   - a 4-stage `cp.async` ring of 32-deep slices of the rows and of the
//     weights' rows (the gate's and the up projection's together in the
//     first product), `ldmatrix` fragment loads, rows padded to 40 values
//     (80 bytes) so that the 8 rows of a fragment fall in distinct banks;
//   - the first product gathers its rows through `src` in the copy itself,
//     so the permuted activations are never written out.
// The block (0, 0) of the first product adds the launch's rows and the
// number of experts that received any to a device counter (one thread, one
// launch after another on a stream: no atomics). No atomics anywhere else:
// each output is one block's sum in a fixed order, so a relaunch gives the
// same bits.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_sync.cuh"

namespace {

using mma_sync::bf16;

constexpr int kBK = 32;             // depth of a stage
constexpr int kStages = 4;          // the cp.async ring
constexpr int kLd = kBK + 8;        // a staged row: 40 bf16, 80 bytes
constexpr int kMaxExperts = 256;

template <int BM, int BN, int kMats>
constexpr int smem_bytes() {
  return kStages * (BM + kMats * BN) * kLd * int(sizeof(bf16));
}

// Block `tile` of the concatenated groups: its expert, its first sorted row
// and its number of rows; false past the last tile. `stats` (may be null):
// block (0, 0) adds [rows, experts with rows, 1] to it.
template <int BM>
__device__ bool find_tile(const int* __restrict__ offsets, int experts, int tile, int* s_cnt,
                          int* s_hit, long long* stats, int& expert, int& row0, int& rows) {
  const int tid = threadIdx.x;
  if (tid == 0) s_hit[0] = -1;
  for (int e = tid; e < experts; e += blockDim.x) s_cnt[e] = offsets[e + 1] - offsets[e];
  __syncthreads();
  if (tid < 32) {
    const int per = (experts + 31) / 32;
    const int lo = min(tid * per, experts), hi = min(lo + per, experts);
    int sum = 0, hit = 0;
    for (int e = lo; e < hi; ++e) {
      sum += (s_cnt[e] + BM - 1) / BM;
      hit += s_cnt[e] > 0;
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += v;
    }
    int start = incl - sum;
    for (int e = lo; e < hi; ++e) {
      const int n = (s_cnt[e] + BM - 1) / BM;
      if (tile >= start && tile < start + n) {
        s_hit[0] = e;
        s_hit[1] = (tile - start) * BM;
      }
      start += n;
    }
    if (stats != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) hit += __shfl_xor_sync(0xffffffffu, hit, d);
      if (tid == 0) {
        stats[0] += offsets[experts] - offsets[0];
        stats[1] += hit;
        stats[2] += 1;
      }
    }
  }
  __syncthreads();
  expert = s_hit[0];
  if (expert < 0) return false;
  row0 = offsets[expert] + s_hit[1];
  rows = min(BM, s_cnt[expert] - s_hit[1]);
  return true;
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + __expf(-v)); }

// out[row0 + r, n0 + c] for the block's tile: kMats = 2 takes the gate's and
// the up projection's rows from w0 and w1 and writes silu(g) ⊙ u, kMats = 1
// writes the product of w0. A's rows are a[src[r]] (src given) or a[row0 +
// r]; w* (E, n, k) row-major, out (R, n).
template <int BM, int BN, int WM, int WN, int kMats>
__global__ void __launch_bounds__(WM* WN * 32)
    moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ src, int lda,
                    const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                    const int* __restrict__ offsets, int experts, int n, int k,
                    bf16* __restrict__ out, long long* __restrict__ stats) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  constexpr int kChunks = kBK / 8;  // 16-byte copies a staged row
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tiles of m16 x n16 steps");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kStages * BM * kLd;
  __shared__ int s_cnt[kMaxExperts];
  __shared__ int s_hit[2];
  __shared__ int s_src[BM];

  int expert, row0, rows;
  if (!find_tile<BM>(offsets, experts, blockIdx.y, s_cnt, s_hit, stats, expert, row0, rows))
    return;
  const int tid = threadIdx.x;
  for (int r = tid; r < BM; r += kThreads)
    s_src[r] = r < rows ? (src != nullptr ? src[row0 + r] : row0 + r) : -1;
  __syncthreads();

  const int n0 = blockIdx.x * BN;
  const long long wstride = static_cast<long long>(n) * k;
  const bf16* wa = w0 + expert * wstride;
  const bf16* wb = kMats == 2 ? w1 + expert * wstride : wa;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* da = sa + stage * BM * kLd;
    for (int c = tid; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks, kk = k0 + (c % kChunks) * 8;
      const int row = s_src[r];
      const bool valid = row >= 0 && kk < k;
      mma_sync::cp_async16(da + r * kLd + (c % kChunks) * 8,
                           valid ? a + static_cast<long long>(row) * lda + kk : a, valid);
    }
    bf16* db = sb + stage * kMats * BN * kLd;
    for (int c = tid; c < kMats * BN * kChunks; c += kThreads) {
      const int r = c / kChunks, kk = k0 + (c % kChunks) * 8;
      const int col = n0 + r % BN;
      const bool valid = col < n && kk < k;
      const bf16* w = r < BN ? wa : wb;
      mma_sync::cp_async16(db + r * kLd + (c % kChunks) * 8,
                           valid ? w + static_cast<long long>(col) * k + kk : wa, valid);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  float acc[kMats][MI][NI][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][mi][ni][i] = 0.f;

  const int ktiles = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    mma_sync::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    mma_sync::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load_stage(next % kStages, next);
    mma_sync::cp_async_commit();
    const bf16* ta = sa + (kt % kStages) * BM * kLd;
    const bf16* tb = sb + (kt % kStages) * kMats * BN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma_sync::ldsm_x4(af[mi], mma_sync::a_frag<kLd>(ta, wm * WTM + mi * 16, kk, lane));
#pragma unroll
      for (int m = 0; m < kMats; ++m)
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t bfr[4];
          mma_sync::ldsm_x4(bfr, mma_sync::b_frag<kLd>(tb + m * BN * kLd,
                                                       wn * WTN + nj * 16, kk, lane));
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_sync::mma16816(acc[m][mi][2 * nj], af[mi], bfr[0], bfr[1]);
            mma_sync::mma16816(acc[m][mi][2 * nj + 1], af[mi], bfr[2], bfr[3]);
          }
        }
    }
  }
  mma_sync::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * WTM + mi * 16 + g + half * 8;
      if (r >= rows) continue;
      bf16* orow = out + static_cast<long long>(row0 + r) * n;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn * WTN + ni * 8 + 2 * t;
        if (col >= n) continue;
        float v0 = acc[0][mi][ni][2 * half], v1 = acc[0][mi][ni][2 * half + 1];
        if (kMats == 2) {
          v0 = silu(v0) * acc[kMats - 1][mi][ni][2 * half];
          v1 = silu(v1) * acc[kMats - 1][mi][ni][2 * half + 1];
        }
        *reinterpret_cast<uint32_t*>(orow + col) = mma_sync::pack_bf16(v0, v1);
      }
    }
}

template <int BM, int BN, int WM, int WN, int kMats>
int launch(const bf16* a, const int* src, int lda, const bf16* w0, const bf16* w1,
           const int* offsets, int experts, int rows, int n, int k, bf16* out,
           long long* stats, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<BM, BN, kMats>();
  auto kernel = moe_gemm_kernel<BM, BN, WM, WN, kMats>;
  static bool configured = false;  // the attribute is set once a process
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return int(err);
    configured = true;
  }
  const int tiles = (rows + BM - 1) / BM + std::min(experts, rows);
  const dim3 grid((n + BN - 1) / BN, tiles);
  kernel<<<grid, WM * WN * 32, kSmem, stream>>>(a, src, lda, w0, w1, offsets, experts, n, k,
                                                out, stats);
  return int(cudaGetLastError());
}

}  // namespace

// x (T, hidden) bf16, its rows read through src (R,) int32; w_gate, w_up (E,
// inter, hidden), w_down (E, hidden, inter) bf16, contiguous; offsets (E + 1,)
// int32 with offsets[0] = 0 and offsets[E] = R; h (R, inter) and y (R,
// hidden) bf16 outputs; route 0 the small-group tiles, 1 the large-group
// ones; stats (3,) int64 or null. Two launches on `stream`.
extern "C" int moe_grouped_swiglu(const void* x, const int* src, int lda, const void* w_gate,
                                  const void* w_up, const void* w_down, const int* offsets,
                                  int experts, int rows, int hidden, int inter, void* h, void* y,
                                  int route, long long* stats, void* stream) {
  if (experts < 1 || experts > kMaxExperts || rows < 1 || hidden % 8 || inter % 8 || lda % 8 ||
      (route != 0 && route != 1))
    return int(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wg = static_cast<const bf16*>(w_gate);
  const auto* wu = static_cast<const bf16*>(w_up);
  const auto* wd = static_cast<const bf16*>(w_down);
  auto* hb = static_cast<bf16*>(h);
  auto* yb = static_cast<bf16*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  int err;
  if (route == 0) {
    err = launch<32, 64, 2, 2, 2>(xb, src, lda, wg, wu, offsets, experts, rows, inter, hidden,
                                  hb, stats, s);
    if (err != 0) return err;
    return launch<32, 128, 2, 2, 1>(hb, nullptr, inter, wd, nullptr, offsets, experts, rows,
                                    hidden, inter, yb, nullptr, s);
  }
  err = launch<128, 64, 4, 2, 2>(xb, src, lda, wg, wu, offsets, experts, rows, inter, hidden,
                                 hb, stats, s);
  if (err != 0) return err;
  return launch<128, 128, 4, 2, 1>(hb, nullptr, inter, wd, nullptr, offsets, experts, rows,
                                   hidden, inter, yb, nullptr, s);
}
