// Short-sequence self-attention for Hopper (sm_90a): forward and backward.
//
// The forward replaces the TPU kernel `_packed_fwd_kernel` in
// spn4cir_tpu/ops/attention_kernels.py (reached through
// `packed_attention_pallas` / `packed_causal_attention_pallas`); the
// backward (second half of this file) replaces `_packed_bwd_kernel`. For each of
// BH (batch*head) slices it computes
//
//     o = softmax(q k^T [+ causal mask]) v
//
// with q pre-scaled by the caller; q, k, v, o are (BH, S, D) contiguous,
// S <= 128, D <= 128, float32 or bfloat16. Logits and softmax run in float32;
// P is rounded to the input type before P*V (as the TPU kernel and the plain
// PyTorch version do); P*V accumulates in float32; the output is stored in
// the input type.
//
// What bounds it: at the serving shapes (vision S=50, text S=77, D=64) each
// slice is two tiny products (S x S x D) plus a softmax over S values, a few
// hundred thousand FLOPs against ~25-40 KB of q/k/v. The TPU version packed
// several heads into one block-diagonal GEMM to fill its matrix unit; here
// the products run on the CUDA cores from shared memory, so the kernel is
// bound by latency, shared-memory traffic per FMA and occupancy (slices in
// flight), not by the tensor-core rate. One query row per warp would make
// two shared-memory loads per FMA; the register blocking below cuts that.
//
// Design:
//   - one block per (slice, tile of kTileQ query rows); grid.x = slice so
//     that BH can exceed 65535, grid.y = row tile;
//   - K (transposed, (D, S)) and V ((S, D)) of the slice are staged in
//     shared memory as float32, with 16-byte global loads where the shapes
//     and pointers allow;
//   - each warp takes kRows query rows at a time, so every K or V value
//     read from shared memory feeds kRows FMAs, and q / P are read as
//     float4 broadcasts:
//       logits: lanes own keys (lane, lane+32, ...), accumulate over D;
//       softmax: per row, warp-shuffle max and sum, P rounded to the input
//                type and written to a per-warp (S, kRows) buffer;
//       P*V:    lanes own output columns (lane, lane+32, ...);
//   - causal groups stop at their last row's diagonal and mask per row.
// Each sum runs in order: over D for a logit, over keys for an output.
// Shared memory: D4*S + S*D + kWarps*kRows*(D4 + S) floats, D4 = D rounded
// up to 4 (S*D too, for alignment); 160 KB at S=D=128, so sizes above 48 KB
// are enabled with cudaFuncSetAttribute.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;   // query rows per warp pass (P buffer is float4)
constexpr int kTileQ = 64;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
constexpr int kKeySlots = kMaxS / 32;
constexpr int kColSlots = kMaxD / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ __forceinline__ int round_up4(int x) { return (x + 3) & ~3; }

size_t smem_bytes(int s, int d) {
  const size_t d4 = round_up4(d);
  return sizeof(float) *
         (d4 * s + round_up4(s * d) + size_t(kWarps) * kRows * (d4 + s));
}

// Stage rows [0, n_keys) of K (transposed) and V into shared memory.
template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k, const T* __restrict__ v,
                                         float* kt, float* vs, int s, int d, int n_keys,
                                         bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int n = n_keys * d;
  if (vec) {  // d % kVec == 0 and 16-byte aligned rows
    for (int i = threadIdx.x * kVec; i < n; i += blockDim.x * kVec) {
      const uint4 kw = *reinterpret_cast<const uint4*>(k + i);
      const uint4 vw = *reinterpret_cast<const uint4*>(v + i);
      const T* ke = reinterpret_cast<const T*>(&kw);
      const T* ve = reinterpret_cast<const T*>(&vw);
      const int r = i / d, c = i - r * d;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kt[(c + e) * s + r] = to_f32(ke[e]);
        vs[i + e] = to_f32(ve[e]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / d, c = i - r * d;
      kt[c * s + r] = to_f32(k[i]);
      vs[i] = to_f32(v[i]);
    }
  }
}

template <typename T, bool kCausal>
__global__ void __launch_bounds__(kWarps * 32)
short_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int s, int d,
                           int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d4 = round_up4(d);
  float* kt = smem;                        // (d4, s); rows >= d are zero
  float* vs = kt + d4 * s;                 // (s, d)
  float* qs = vs + round_up4(s * d);      // (kWarps, kRows, d4), 16-byte aligned
  float* ps = qs + kWarps * kRows * d4;    // (kWarps, s, kRows)

  const size_t base = size_t(blockIdx.x) * s * d;
  const int row0 = blockIdx.y * kTileQ;
  const int row_end = min(row0 + kTileQ, s);
  // a causal tile never reads keys past its last row
  const int s_keys = kCausal ? row_end : s;

  stage_kv(k + base, v + base, kt, vs, s, d, s_keys, vec != 0);
  for (int i = d * s + threadIdx.x; i < d4 * s; i += blockDim.x) kt[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * kRows * d4;
  float* pw = ps + warp * s * kRows;
  const int n_cslots = (d + 31) >> 5;

  for (int g0 = row0 + warp * kRows; g0 < row_end; g0 += kWarps * kRows) {
    const int n_rows = min(kRows, row_end - g0);
    for (int i = lane; i < kRows * d4; i += 32) {
      const int r = i / d4, c = i - r * d4;
      qw[i] = (r < n_rows && c < d) ? to_f32(q[base + size_t(g0 + r) * d + c]) : 0.f;
    }
    __syncwarp();

    // keys this group reads: all of them, or up to its last row's diagonal
    const int n_keys = kCausal ? g0 + n_rows : s;
    const int n_kslots = (n_keys + 31) >> 5;

    float acc[kRows][kKeySlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) acc[r][t] = 0.f;

    for (int c = 0; c < d4; c += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = *reinterpret_cast<const float4*>(qw + r * d4 + c);
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        if (t < n_kslots) {
          const int j = min(lane + 32 * t, n_keys - 1);  // keys past n_keys: masked below
          const float* kc = kt + c * s + j;
          const float k0 = kc[0], k1 = kc[s], k2 = kc[2 * s], k3 = kc[3 * s];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = acc[r][t];
            a = fmaf(qv[r].x, k0, a);
            a = fmaf(qv[r].y, k1, a);
            a = fmaf(qv[r].z, k2, a);
            a = fmaf(qv[r].w, k3, a);
            acc[r][t] = a;
          }
        }
      }
    }

    // softmax per row; P (rounded to T) into pw as (key, row) float4s
    float p[kRows][kKeySlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int keys_r = kCausal ? min(g0 + r + 1, n_keys) : s;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t)
        if (t < n_kslots && lane + 32 * t < keys_r) mx = fmaxf(mx, acc[r][t]);
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) {
        const float e = (t < n_kslots && lane + 32 * t < keys_r) ? expf(acc[r][t] - mx) : 0.f;
        p[r][t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < kKeySlots; ++t) p[r][t] = to_f32(from_f32<T>(p[r][t] / sum));
    }
#pragma unroll
    for (int t = 0; t < kKeySlots; ++t) {
      const int j = lane + 32 * t;
      if (t < n_kslots && j < n_keys)
        *reinterpret_cast<float4*>(pw + j * kRows) =
            make_float4(p[0][t], p[1][t], p[2][t], p[3][t]);
    }
    __syncwarp();

    float out[kRows][kColSlots];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kColSlots; ++u) out[r][u] = 0.f;
    for (int j = 0; j < n_keys; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(pw + j * kRows);
      const float* vr = vs + j * d;
#pragma unroll
      for (int u = 0; u < kColSlots; ++u) {
        if (u < n_cslots) {
          const int c = lane + 32 * u;
          const float vv = c < d ? vr[c] : 0.f;
          out[0][u] = fmaf(pj.x, vv, out[0][u]);
          out[1][u] = fmaf(pj.y, vv, out[1][u]);
          out[2][u] = fmaf(pj.z, vv, out[2][u]);
          out[3][u] = fmaf(pj.w, vv, out[3][u]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < n_rows) {
#pragma unroll
        for (int u = 0; u < kColSlots; ++u) {
          const int c = lane + 32 * u;
          if (u < n_cslots && c < d) o[base + size_t(g0 + r) * d + c] = from_f32<T>(out[r][u]);
        }
      }
    }
    __syncwarp();  // qw / pw are rewritten by the next group
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int s,
                   int d, cudaStream_t stream) {
  const size_t bytes = smem_bytes(s, d);
  auto kernel = short_attention_fwd_kernel<T, kCausal>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  constexpr int kVec = 16 / sizeof(T);
  const int vec = d % kVec == 0 && aligned16(k) && aligned16(v);
  dim3 grid(bh, (s + kTileQ - 1) / kTileQ);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                               static_cast<const T*>(v), static_cast<T*>(o), s, d,
                                               vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel `_packed_bwd_kernel`. Per slice, with P recomputed
// from q and k exactly as the forward computes it:
//
//     dV = Pbᵀ·dO        dP = dO·Vᵀ        dS = P ∘ (dP - rowsum(dP ∘ P))
//     dQ = dSb·K         dK = dSbᵀ·Q
//
// Pb and dSb are P and dS rounded to the input type before their products
// (as the TPU kernel does); every product accumulates in float32; outputs
// are stored in the input type. dO arrives in the input type.
//
// What bounds it: five S x S x D products per slice, ~3.8 MFLOP at S=77,
// D=64 against ~70 KB of q/k/v/dO/dq/dk/dv traffic: operations, on the
// CUDA cores, fed from shared memory. dK and dV sum over query rows, so one
// block owns a whole slice and no sum crosses blocks. Every shape the
// forward takes (S, D <= 128) has to fit one block's shared memory, so no
// more than two (S, D) operands are resident at a time:
//   - two operand buffers of float32 with an odd row stride (D + 1), so that
//     both row-wise and column-wise reads are free of bank conflicts, hold
//     (q, k), then (dO, v), then (k, q); one (S, S + 1) float32 buffer holds
//     the logits, then P, then dSb. 2·S·(D+1) + S·(S+1) floats: 63 KB at
//     S=77, D=64 and 194 KB at S=D=128, enabled with cudaFuncSetAttribute;
//   - Pb is rounded as dV's product reads P, and dP never reaches shared
//     memory: its tile stays in the registers of the product that made it,
//     rowsum(dP ∘ P) is summed there (over a thread's columns, then across
//     the 16 threads of a row with warp shuffles) and dSb overwrites P in
//     place, each thread writing only the entries it owns;
//   - each product is a block-level register-blocked GEMM (`block_gemm`):
//     256 threads as 16 x 16, thread (ty, tx) owning rows ty + 16a and
//     columns tx + 16b for a, b < kMT. kMT is a template parameter chosen
//     from max(S, D) (4 up to 64, 5 up to 80, else 8): with the tile counts
//     known at compile time no instruction slot goes to a multiply-add that
//     is predicated off (at S=77 a fixed 8 x 8 tile spent 64 slots per depth
//     step on 25 useful ones, and the instruction rate bounded the kernel);
//   - causal slices skip the 16 x 16 blocks above the diagonal in the two
//     S x S products and bound the reduction range in the other three;
//     masked entries of P are exact zeros, so they add nothing to
//     rowsum(dP ∘ P) and their dS is zero: no row reads above its diagonal.
// Each sum runs in a fixed order.

constexpr int kBwdThreads = 256;
constexpr int kKUnroll = 4;  // depth steps in flight per thread in block_gemm

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// acc[a][b] = Σ_k A[i*sai + k*sak] · B[k*sbk + j*sbj] for i = ty + 16a < I,
// j = tx + 16b < J, with A rounded to TR as it is read. kMode bounds the
// work of causal slices:
//   0: all k;   1: k < 16a + 16 (A(i, k) = 0 for k > i);
//   2: k >= 16a (A(i, k) = 0 for k < i);   3: skip blocks b > a (j > i).
template <int kMT, int kMode, typename TR>
__device__ __forceinline__ void block_gemm_acc(const float* __restrict__ A, int sai, int sak,
                                               const float* __restrict__ B, int sbk, int sbj,
                                               int I, int J, int K, float (&acc)[kMT][kMT]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ni = (I + 15) >> 4, nj = (J + 15) >> 4;
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < kMT; ++b) acc[a][b] = 0.f;

#pragma unroll (kKUnroll)
  for (int k = 0; k < K; ++k) {
    float bv[kMT];
#pragma unroll
    for (int b = 0; b < kMT; ++b)
      bv[b] = b < nj ? B[k * sbk + min(tx + 16 * b, J - 1) * sbj] : 0.f;
#pragma unroll
    for (int a = 0; a < kMT; ++a) {
      bool use = a < ni;
      if (kMode == 1) use = use && k < 16 * a + 16;
      if (kMode == 2) use = use && k >= 16 * a;
      if (use) {
        const float av = round_to<TR>(A[min(ty + 16 * a, I - 1) * sai + k * sak]);
#pragma unroll
        for (int b = 0; b < kMT; ++b)
          if (b < nj && !(kMode == 3 && b > a)) acc[a][b] = fmaf(av, bv[b], acc[a][b]);
      }
    }
  }
}

// The same product with every C(i, j) handed to store(i, j, value).
template <int kMT, int kMode, typename TR = float, typename Store>
__device__ __forceinline__ void block_gemm(const float* __restrict__ A, int sai, int sak,
                                           const float* __restrict__ B, int sbk, int sbj,
                                           int I, int J, int K, Store store) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kMT][kMT];
  block_gemm_acc<kMT, kMode, TR>(A, sai, sak, B, sbk, sbj, I, J, K, acc);
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < kMT; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      if (i < I && j < J) store(i, j, acc[a][b]);
    }
}

// Two (S, D) operands of one slice into shared memory as float32, row
// stride ld.
template <typename T>
__device__ __forceinline__ void stage_pair(const T* __restrict__ x, const T* __restrict__ y,
                                           float* xs, float* ys, int s, int d, int ld) {
  for (int idx = threadIdx.x; idx < s * d; idx += kBwdThreads) {
    const int r = idx / d, c = idx - r * d;
    xs[r * ld + c] = to_f32(x[idx]);
    ys[r * ld + c] = to_f32(y[idx]);
  }
}

size_t bwd_smem_bytes(int s, int d) {
  return sizeof(float) * (size_t(2) * s * (d + 1) + size_t(s) * (s + 1));
}

// Blocks per SM that the register budget must allow: the small tiles would
// otherwise take ~95 registers and two blocks where shared memory has room
// for four (S, D <= 64) or three (S = 77, D = 64).
constexpr int bwd_min_blocks(int mt) { return mt == 4 ? 4 : (mt == 5 ? 3 : 1); }

template <typename T, bool kCausal, int kMT>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks(kMT))
short_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int s,
                           int d) {
  extern __shared__ float4 smem4[];
  const int ld = d + 1, lp = s + 1;
  float* xs = reinterpret_cast<float*>(smem4);  // (s, ld): q, then dO, then k
  float* ys = xs + s * ld;                      // (s, ld): k, then v, then q
  float* p = ys + s * ld;                       // (s, lp): logits, P, then dSb

  const size_t base = size_t(blockIdx.x) * s * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  stage_pair(q + base, k + base, xs, ys, s, d, ld);
  __syncthreads();

  // logits[i][j] = Σ_c q[i][c] k[j][c]
  block_gemm<kMT, kCausal ? 3 : 0>(xs, ld, 1, ys, 1, ld, s, s, d,
                                   [&](int i, int j, float x) { p[i * lp + j] = x; });
  __syncthreads();

  // q and k have been read: dO and v take their places while P is formed
  stage_pair(dout + base, v + base, xs, ys, s, d, ld);
  for (int i = warp; i < s; i += kBwdThreads / 32) {
    const int n = kCausal ? i + 1 : s;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p[i * lp + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[i * lp + j] - mx);
      p[i * lp + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < s; j += 32) p[i * lp + j] = j < n ? p[i * lp + j] / sum : 0.f;
  }
  __syncthreads();

  // dV[j][c] = Σ_i Pb[i][j] dO[i][c]
  block_gemm<kMT, kCausal ? 2 : 0, T>(p, 1, lp, xs, ld, 1, s, d, s, [&](int j, int c, float x) {
    dv[base + size_t(j) * d + c] = from_f32<T>(x);
  });

  // dP[i][j] = Σ_c dO[i][c] v[j][c], kept in registers
  float dp[kMT][kMT];
  block_gemm_acc<kMT, kCausal ? 3 : 0, float>(xs, ld, 1, ys, 1, ld, s, s, d, dp);
  // delta[i] = Σ_j dP[i][j] P[i][j]: this thread's columns, then the 16
  // threads (half a warp) that share row i
  float delta[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    const int i = ty + 16 * a;
    float part = 0.f;
#pragma unroll
    for (int b = 0; b < kMT; ++b) {
      const int j = tx + 16 * b;
      if (i < s && j < s) part = fmaf(dp[a][b], p[i * lp + j], part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    delta[a] = part;
  }
  __syncthreads();  // dV and every delta have read P; dO and v are done with

  // dSb over P in place, each thread its own entries
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < kMT; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      if (i < s && j < s) p[i * lp + j] = round_to<T>(p[i * lp + j] * (dp[a][b] - delta[a]));
    }
  stage_pair(k + base, q + base, xs, ys, s, d, ld);
  __syncthreads();

  // dQ[i][c] = Σ_j dSb[i][j] k[j][c];  dK[j][c] = Σ_i dSb[i][j] q[i][c]
  block_gemm<kMT, kCausal ? 1 : 0>(p, lp, 1, xs, ld, 1, s, d, s, [&](int i, int c, float x) {
    dq[base + size_t(i) * d + c] = from_f32<T>(x);
  });
  block_gemm<kMT, kCausal ? 2 : 0>(p, 1, lp, ys, ld, 1, s, d, s, [&](int j, int c, float x) {
    dk[base + size_t(j) * d + c] = from_f32<T>(x);
  });
}

template <typename T, bool kCausal, int kMT>
cudaError_t launch_bwd_tiles(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, int bh, int s, int d,
                             cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes(s, d);
  auto kernel = short_attention_bwd_kernel<T, kCausal, kMT>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<bh, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), s, d);
  return cudaGetLastError();
}

// 16 * kMT covers both S and D.
template <typename T, bool kCausal>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, int bh, int s, int d, cudaStream_t stream) {
  const int extent = s > d ? s : d;
  if (extent <= 64)
    return launch_bwd_tiles<T, kCausal, 4>(q, k, v, dout, dq, dk, dv, bh, s, d, stream);
  if (extent <= 80)
    return launch_bwd_tiles<T, kCausal, 5>(q, k, v, dout, dq, dk, dv, bh, s, d, stream);
  return launch_bwd_tiles<T, kCausal, 8>(q, k, v, dout, dq, dk, dv, bh, s, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// argument errors return cudaErrorInvalidValue without launching.
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int dtype, int causal,
                                   void* stream) {
  if (bh <= 0 || s <= 0 || s > kMaxS || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return causal ? launch<float, true>(q, k, v, o, bh, s, d, st)
                  : launch<float, false>(q, k, v, o, bh, s, d, st);
  }
  if (dtype == 1) {
    return causal ? launch<__nv_bfloat16, true>(q, k, v, o, bh, s, d, st)
                  : launch<__nv_bfloat16, false>(q, k, v, o, bh, s, d, st);
  }
  return cudaErrorInvalidValue;
}

// Backward of short_attention_fwd: dq, dk, dv from q, k, v and dout, all
// (BH, S, D) contiguous in one dtype, for every shape the forward takes.
// Same codes and return value as above.
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, int bh,
                                   int s, int d, int dtype, int causal, void* stream) {
  if (bh <= 0 || s <= 0 || s > kMaxS || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return causal ? launch_bwd<float, true>(q, k, v, dout, dq, dk, dv, bh, s, d, st)
                  : launch_bwd<float, false>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  }
  if (dtype == 1) {
    return causal ? launch_bwd<__nv_bfloat16, true>(q, k, v, dout, dq, dk, dv, bh, s, d, st)
                  : launch_bwd<__nv_bfloat16, false>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  }
  return cudaErrorInvalidValue;
}
