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
// What bounds the forward: at the serving and training shapes (vision S=50,
// text S=77, D=64) each slice is two small products (S x S x D) around a
// softmax over S values: at the flagship text shape (2560, 77, 64) causal,
// 1.97 GFLOP against 100.9 MB of q, k, v, o in bfloat16, so the bytes bound
// it (0.030 ms at 3.35 TB/s; the bf16 tensor-core rate would take 0.002).
// The TPU version packed several heads into one block-diagonal product to
// fill its matrix unit. Two routes here, chosen by the caller
// (`short_forward_route` in ops/attention_kernels.py):
//
// bfloat16 with D % 8 == 0: the tensor cores (`short_attention_fwd_tc_kernel`),
// built to keep the bytes moving:
//   - a slice fits a block whole: its q, k, v are copied once into shared
//     memory as bf16 by 16-byte `cp.async` (rows past S zero-filled by the
//     copy's source size, the pad columns [D, kD) zeroed once), and
//     `ldmatrix` (`.trans` for V) feeds `mma.sync.m16n8k16` (bf16 in,
//     float32 accumulate; `mma_sync.cuh`, shared with long_attention.cu);
//   - each block walks several slices (as many blocks as the card holds at
//     once, slice blockIdx.x, + gridDim.x, ...) through a two-stage ring:
//     the next slice's copies are in flight while this one is multiplied;
//   - one warp per 16 query rows, the slice padded to kNS steps of 16 rows
//     (4 for S <= 64, 5 for S <= 80, else 8) and the depth to kD = 64 or
//     128: every loop count is a compile-time constant (run-time bounds
//     turned unrolled steps into branches in #2 and #3);
//   - the whole row of logits stays in registers (at most 16 n-tiles of 8),
//     so the softmax is exact in one pass: row max and sum across the quad
//     by `__shfl_xor_sync`, no online rescaling; P is normalised, rounded to
//     bf16 in registers (the TPU kernel's `p.astype(q.dtype)`) and, since
//     the accumulator layout of m16n8k16 is the A layout of the next
//     product, multiplied by V directly;
//   - causal slices skip the key steps wholly above a row group's diagonal
//     in both products and mask the diagonal step; masked P entries are
//     exact zeros.
//   2 depths x 3 row counts x causal or not = 12 instantiations. Sources
//   must start on a 16-byte boundary; the entry point refuses others.
//
// float32, and bfloat16 at any other D: the CUDA cores. TF32 would keep
// about three decimal digits where the float32 check asks for 1e-5. The
// products run from shared memory as float32 FMAs; one query row per warp
// would make two shared-memory loads per FMA, so the register blocking
// below cuts that:
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
//
// Every sum has a fixed order and no atomics are used: two launches give
// the same bits, on either route.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "mma_sync.cuh"

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
// Forward, bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

using namespace mma_sync;  // bf16, cp.async, ldmatrix, mma.sync, fragments

constexpr float kLog2e = 1.4426950408889634f;

// kNS: 16-row steps a slice is padded to, queries and keys alike (4 for
// S <= 64, 5 for S <= 80, else 8); one warp per step of query rows.
template <int kD, int kNS>
constexpr size_t tc_smem_bytes() {
  return size_t(2) * 3 * 16 * kNS * (kD + 8) * sizeof(bf16);  // 2 stages of q, k, v
}

template <int kD, int kNS, bool kCausal>
__global__ void __launch_bounds__(32 * kNS)
short_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o, int bh, int s,
                              int d) {
  constexpr int kS = 16 * kNS, ld = kD + 8, kThreads = 32 * kNS;
  constexpr int kNK = kD / 16, kNO = kD / 8, kTile = kS * ld;
  extern __shared__ uint4 smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);  // 2 stages of (q, k, v), each (kS, ld)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;  // the warp's 16 query rows
  const int r0 = row0 + g, r1 = r0 + 8;
  const bool active = row0 < s;

  // the pad columns [d, kD) of every row of both stages, once: cp.async
  // never writes there
  const int pad_chunks = (kD - d) / 8;
  for (int idx = threadIdx.x; idx < 2 * 3 * kS * pad_chunks; idx += kThreads) {
    const int r = idx / pad_chunks, c = d + (idx - r * pad_chunks) * 8;
    *reinterpret_cast<uint4*>(ring + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  // one slice's q, k, v rows [0, kS) into stage st, 16 bytes a copy; rows
  // past s zero-filled by the copy's source size
  const int row_chunks = d / 8;
  auto fetch = [&](int slice, int st) {
    if (slice < bh) {
      const size_t base = size_t(slice) * s * d;
      bf16* dst = ring + st * 3 * kTile;
      for (int idx = threadIdx.x; idx < kS * row_chunks; idx += kThreads) {
        const int r = idx / row_chunks, c = (idx - r * row_chunks) * 8;
        const bool valid = r < s;
        const size_t src = base + size_t(valid ? r : 0) * d + c;
        cp_async16(dst + r * ld + c, q + src, valid);
        cp_async16(dst + kTile + r * ld + c, k + src, valid);
        cp_async16(dst + 2 * kTile + r * ld + c, v + src, valid);
      }
    }
    cp_async_commit();  // an empty group past the last slice keeps the count
  };

  fetch(blockIdx.x, 0);
  int st = 0;
  for (int slice = blockIdx.x; slice < bh; slice += gridDim.x, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this slice is in; every warp is done with the other stage
    fetch(slice + gridDim.x, st ^ 1);
    if (!active) continue;
    const bf16* qs = ring + st * 3 * kTile;
    const bf16* ks = qs + kTile;
    const bf16* vs = ks + kTile;

    // logits of the warp's rows: every key step, or (causal) the steps up to
    // and including the diagonal one, p <= warp
    float sc[2 * kNS][4];
#pragma unroll
    for (int n = 0; n < 2 * kNS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      uint32_t qf[4];
      ldsm_x4(qf, a_frag<ld>(qs, row0, 16 * kk, lane));
#pragma unroll
      for (int p = 0; p < kNS; ++p) {
        if (kCausal && p > warp) break;
        uint32_t b[4];
        ldsm_x4(b, b_frag<ld>(ks, 16 * p, 16 * kk, lane));
        mma16816(sc[2 * p], qf, b[0], b[1]);
        mma16816(sc[2 * p + 1], qf, b[2], b[3]);
      }
    }

    // the whole row is in registers: an exact softmax in one pass. Keys past
    // s and (causal) past the row get probability 0; every row keeps key 0.
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 2 * kNS; ++n) {
      if (kCausal && n / 2 > warp) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * n + 2 * t + e;
        if (j >= s || (kCausal && j > r0)) sc[n][e] = -CUDART_INF_F;
        if (j >= s || (kCausal && j > r1)) sc[n][e + 2] = -CUDART_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * kNS; ++n) {
      if (kCausal && n / 2 > warp) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = exp2f(fmaf(sc[n][i], kLog2e, i < 2 ? -ml0 : -ml1));
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    // P normalised, then rounded to bf16 in registers: the A fragments of P V
    uint32_t pf[kNS][4];
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      if (kCausal && p > warp) break;
      pf[p][0] = pack_bf16(sc[2 * p][0] * inv0, sc[2 * p][1] * inv0);
      pf[p][1] = pack_bf16(sc[2 * p][2] * inv1, sc[2 * p][3] * inv1);
      pf[p][2] = pack_bf16(sc[2 * p + 1][0] * inv0, sc[2 * p + 1][1] * inv0);
      pf[p][3] = pack_bf16(sc[2 * p + 1][2] * inv1, sc[2 * p + 1][3] * inv1);
    }

    float acc[kNO][4];
#pragma unroll
    for (int n = 0; n < kNO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      if (kCausal && p > warp) break;
#pragma unroll
      for (int np = 0; np < kNO / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, bt_frag<ld>(vs, 16 * p, 16 * np, lane));
        mma16816(acc[2 * np], pf[p], b[0], b[1]);
        mma16816(acc[2 * np + 1], pf[p], b[2], b[3]);
      }
    }

    bf16* out = o + size_t(slice) * s * d;
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= d) break;
      if (r0 < s)
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(r0) * d + col) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
      if (r1 < s)
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(r1) * d + col) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
    }
  }
}

// The shared-memory limit of a tensor-core kernel, set, and the blocks of it
// the card holds at once: a launcher finds them once (on the first caller's
// device) and keeps them in a static of its own.
struct Resident {
  cudaError_t err;
  int blocks;
};

template <typename Kernel>
Resident find_resident(Kernel kernel, int threads, size_t bytes) {
  Resident r{cudaSuccess, 0};
  int device = 0, sms = 0, per_sm = 0;
  if (bytes > 48 * 1024 &&
      (r.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    int(bytes))) != cudaSuccess)
    return r;
  if ((r.err = cudaGetDevice(&device)) != cudaSuccess) return r;
  if ((r.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return r;
  r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  r.blocks = sms * (per_sm > 0 ? per_sm : 1);
  return r;
}

// A grid of as many blocks as the card holds at once (at most one per
// slice); each block walks its slices blockIdx.x, + gridDim.x, ...
template <int kD, int kNS, bool kCausal>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int s,
                      int d, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<kD, kNS>();
  constexpr int threads = 32 * kNS;
  auto kernel = short_attention_fwd_tc_kernel<kD, kNS, kCausal>;
  static const Resident resident = find_resident(kernel, threads, bytes);
  if (resident.err != cudaSuccess) return resident.err;
  const int blocks = bh < resident.blocks ? bh : resident.blocks;
  kernel<<<blocks, threads, bytes, stream>>>(static_cast<const bf16*>(q),
                                             static_cast<const bf16*>(k),
                                             static_cast<const bf16*>(v), static_cast<bf16*>(o),
                                             bh, s, d);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t launch_tc_depth(const void* q, const void* k, const void* v, void* o, int bh,
                            int s, int d, cudaStream_t stream) {
  if (d <= 64) {
    if (s <= 64) return launch_tc<64, 4, kCausal>(q, k, v, o, bh, s, d, stream);
    if (s <= 80) return launch_tc<64, 5, kCausal>(q, k, v, o, bh, s, d, stream);
    return launch_tc<64, 8, kCausal>(q, k, v, o, bh, s, d, stream);
  }
  if (s <= 64) return launch_tc<128, 4, kCausal>(q, k, v, o, bh, s, d, stream);
  if (s <= 80) return launch_tc<128, 5, kCausal>(q, k, v, o, bh, s, d, stream);
  return launch_tc<128, 8, kCausal>(q, k, v, o, bh, s, d, stream);
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
// (as the TPU kernel does); rowsum(dP ∘ P) comes from the float32 P; every
// product accumulates in float32; outputs are stored in the input type. dO
// arrives in the input type.
//
// What bounds it: five S x S x D products per slice against seven (S, D)
// tensors moved (q, k, v, dO in, dq, dk, dv out). At the flagship text shape
// (2560, 77, 64) causal in bf16 that is 4.92 GFLOP against 176.6 MB: the
// bytes bound it (0.053 ms at 3.35 TB/s; the bf16 tensor cores would take
// 0.005 ms), but only on the tensor cores: as float32 FMAs on the CUDA cores
// the five products took 0.72 ms (~7 TFLOP/s). dK and dV sum over query
// rows, so one block owns a whole slice and no sum crosses blocks. Two
// routes, chosen by the caller (`short_route` in ops/attention_kernels.py):
//
// bfloat16 with D % 8 == 0: the tensor cores (`short_attention_bwd_tc_kernel`),
// built from the forward's pieces:
//   - a block walks whole slices (as many blocks as the card holds at once);
//     q, k, v and dO are copied once each as bf16 by 16-byte `cp.async`
//     (rows past S zero-filled, the pad columns [D, kD) zeroed once); the
//     next slice's k and v are in flight while this one's phase 2 runs, and
//     the other blocks of the SM (three at S = 77) cover the rest;
//   - phase 1, a warp per 16 query rows: the row's logits (q kᵀ) and dP
//     (dO vᵀ) by `mma.sync.m16n8k16` from `ldmatrix` fragments, an exact
//     one-pass softmax in registers (the forward's), delta = rowsum(dP ∘ P)
//     across the quad by `__shfl_xor_sync`, dS in place of dP; Pb and dSb go
//     to two shared (S, S) bf16 tiles, and dQ = dSb·K takes the warp's own
//     dSb rows back from their tile by `ldmatrix` (held in registers beside
//     P and dP, they spilled at 80 rows, causal);
//   - phase 2, after one barrier, a warp per 16 keys: dV = Pbᵀ·dO and dK =
//     dSbᵀ·Q, the A fragments of Pbᵀ and dSbᵀ by `ldmatrix.trans` from the
//     shared tiles, dO and q by `.trans` as the B side; every sum runs over
//     the query rows in step order;
//   - causal slices skip the key steps above a row group's diagonal in
//     phase 1 and the query steps above a key group's diagonal in phase 2;
//     masked P and dS entries are exact zeros;
//   - rows padded to kNS steps of 16 (64 / 80 / 128) and the depth to kD =
//     64 / 128 as template parameters, so every loop count is a compile-time
//     constant: 12 instantiations. Shared memory 4·kS·(kD + 8) + 2·kS·(kS +
//     8) bf16: 72.5 KB at S = 77, D = 64 (three blocks an SM), 204 KB at S =
//     D = 128 (one).
//
// float32, and bfloat16 at any other D: the CUDA cores (TF32 would miss the
// float32 check of 1e-4), from shared memory as float32 FMAs:
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
//     is predicated off;
//   - causal slices skip the 16 x 16 blocks above the diagonal in the two
//     S x S products and bound the reduction range in the other three;
//     masked entries of P are exact zeros, so they add nothing to
//     rowsum(dP ∘ P) and their dS is zero: no row reads above its diagonal.
// Each sum runs in a fixed order on either route.

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

// ---------------------------------------------------------------------------
// Backward, bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

template <int kD, int kNS>
constexpr size_t bwd_tc_smem_bytes() {
  return size_t(4) * 16 * kNS * (kD + 8) * sizeof(bf16) +       // q, k, v, dO
         size_t(2) * 16 * kNS * (16 * kNS + 8) * sizeof(bf16);  // Pb, dSb
}

// Blocks an SM must hold, for the register budget: as many as shared memory
// admits (228 KB an SM, 1 KB of it reserved a block), but never fewer than
// 128 registers a thread.
template <int kD, int kNS>
constexpr int bwd_tc_min_blocks() {
  constexpr int by_smem = int(233472 / (bwd_tc_smem_bytes<kD, kNS>() + 1024));
  constexpr int by_regs = 65536 / (128 * 32 * kNS);
  return by_smem < by_regs ? (by_smem > 0 ? by_smem : 1) : by_regs;
}

template <int kD, int kNS, bool kCausal>
__global__ void __launch_bounds__(32 * kNS, bwd_tc_min_blocks<kD, kNS>())
short_attention_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              bf16* __restrict__ dq, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int bh, int s, int d) {
  constexpr int kS = 16 * kNS, ld = kD + 8, lp = kS + 8, kThreads = 32 * kNS;
  constexpr int kNK = kD / 16, kNO = kD / 8, kTile = kS * ld;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // (kS, ld) each: q, k, v, dO
  bf16* ks = qs + kTile;
  bf16* vs = ks + kTile;
  bf16* dos = vs + kTile;
  bf16* ps = dos + kTile;    // (kS, lp): Pb
  bf16* dss = ps + kS * lp;  // (kS, lp): dSb

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // phase 1: the warp's 16 query rows; phase 2: its 16 keys
  const int row0 = 16 * warp;
  const int r0 = row0 + g, r1 = r0 + 8;
  const bool active = row0 < s;

  // the pad columns [d, kD) of the four operand tiles, and the Pb / dSb rows
  // of a warp past s (phase 2 reads them as zeros), once: nothing else
  // writes there
  const int pad_chunks = (kD - d) / 8;
  for (int idx = threadIdx.x; idx < 4 * kS * pad_chunks; idx += kThreads) {
    const int r = idx / pad_chunks, c = d + (idx - r * pad_chunks) * 8;
    *reinterpret_cast<uint4*>(qs + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!active)
    for (int idx = lane; idx < 16 * (kS / 8); idx += 32) {
      const int r = row0 + idx / (kS / 8), c = (idx % (kS / 8)) * 8;
      *reinterpret_cast<uint4*>(ps + r * lp + c) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dss + r * lp + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  // rows [0, kS) of two of a slice's tensors into their tiles, 16 bytes a
  // copy; rows past s zero-filled by the copy's source size
  const int row_chunks = d / 8;
  auto fetch2 = [&](int slice, const bf16* x, bf16* xs, const bf16* y, bf16* ys) {
    if (slice < bh) {
      const size_t base = size_t(slice) * s * d;
      for (int idx = threadIdx.x; idx < kS * row_chunks; idx += kThreads) {
        const int r = idx / row_chunks, c = (idx - r * row_chunks) * 8;
        const bool valid = r < s;
        const size_t src = base + size_t(valid ? r : 0) * d + c;
        cp_async16(xs + r * ld + c, x + src, valid);
        cp_async16(ys + r * ld + c, y + src, valid);
      }
    }
    cp_async_commit();  // an empty group past the last slice keeps the count
  };

  fetch2(blockIdx.x, q, qs, dout, dos);
  fetch2(blockIdx.x, k, ks, v, vs);
  for (int slice = blockIdx.x; slice < bh; slice += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // this slice is in; every warp is done with the last
    const size_t base = size_t(slice) * s * d;

    // ---- phase 1: the warp's query rows ----
    if (active) {
      // logits and dP of the warp's rows: every key step, or (causal) the
      // steps up to and including the diagonal one, p <= warp
      float sc[2 * kNS][4], dp[2 * kNS][4];
#pragma unroll
      for (int n = 0; n < 2 * kNS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, a_frag<ld>(qs, row0, 16 * kk, lane));
        ldsm_x4(df, a_frag<ld>(dos, row0, 16 * kk, lane));
#pragma unroll
        for (int p = 0; p < kNS; ++p) {
          if (kCausal && p > warp) break;
          uint32_t b[4];
          ldsm_x4(b, b_frag<ld>(ks, 16 * p, 16 * kk, lane));
          mma16816(sc[2 * p], qf, b[0], b[1]);
          mma16816(sc[2 * p + 1], qf, b[2], b[3]);
          ldsm_x4(b, b_frag<ld>(vs, 16 * p, 16 * kk, lane));
          mma16816(dp[2 * p], df, b[0], b[1]);
          mma16816(dp[2 * p + 1], df, b[2], b[3]);
        }
      }

      // P: the forward's exact one-pass softmax. Keys past s and (causal)
      // past the row get probability 0; every row keeps key 0.
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 2 * kNS; ++n) {
        if (kCausal && n / 2 > warp) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * n + 2 * t + e;
          if (j >= s || (kCausal && j > r0)) sc[n][e] = -CUDART_INF_F;
          if (j >= s || (kCausal && j > r1)) sc[n][e + 2] = -CUDART_INF_F;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2 * kNS; ++n) {
        if (kCausal && n / 2 > warp) break;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sc[n][i] = exp2f(fmaf(sc[n][i], kLog2e, i < 2 ? -ml0 : -ml1));
        sum0 += sc[n][0] + sc[n][1];
        sum1 += sc[n][2] + sc[n][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;

      // P normalised in float32; delta = rowsum(dP ∘ P) from it, across the
      // quad; Pb to its shared tile
      float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2 * kNS; ++n) {
        if (kCausal && n / 2 > warp) break;
        sc[n][0] *= inv0;
        sc[n][1] *= inv0;
        sc[n][2] *= inv1;
        sc[n][3] *= inv1;
        dl0 = fmaf(dp[n][0], sc[n][0], fmaf(dp[n][1], sc[n][1], dl0));
        dl1 = fmaf(dp[n][2], sc[n][2], fmaf(dp[n][3], sc[n][3], dl1));
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + r0 * lp + col) = pack_bf16(sc[n][0], sc[n][1]);
        *reinterpret_cast<uint32_t*>(ps + r1 * lp + col) = pack_bf16(sc[n][2], sc[n][3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
      }

      // dS = P ∘ (dP - delta), rounded to bf16, to the dSb tile
#pragma unroll
      for (int n = 0; n < 2 * kNS; ++n) {
        if (kCausal && n / 2 > warp) break;
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dss + r0 * lp + col) =
            pack_bf16(sc[n][0] * (dp[n][0] - dl0), sc[n][1] * (dp[n][1] - dl0));
        *reinterpret_cast<uint32_t*>(dss + r1 * lp + col) =
            pack_bf16(sc[n][2] * (dp[n][2] - dl1), sc[n][3] * (dp[n][3] - dl1));
      }
      __syncwarp();  // the warp's dSb rows are whole

      // dQ = dSb K, dSb's A fragments read back from the tile (held in
      // registers beside P and dP they spilled at 80 rows, causal) and K's
      // rows as this product's depth (`.trans`)
      float acc[kNO][4];
#pragma unroll
      for (int n = 0; n < kNO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int p = 0; p < kNS; ++p) {
        if (kCausal && p > warp) break;
        uint32_t a[4];
        ldsm_x4(a, a_frag<lp>(dss, row0, 16 * p, lane));
#pragma unroll
        for (int np = 0; np < kNO / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<ld>(ks, 16 * p, 16 * np, lane));
          mma16816(acc[2 * np], a, b[0], b[1]);
          mma16816(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= d) break;
        if (r0 < s)
          *reinterpret_cast<__nv_bfloat162*>(dq + base + size_t(r0) * d + col) =
              __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        if (r1 < s)
          *reinterpret_cast<__nv_bfloat162*>(dq + base + size_t(r1) * d + col) =
              __floats2bfloat162_rn(acc[n][2], acc[n][3]);
      }
    }
    __syncthreads();  // Pb and dSb are whole; k and v are read no more
    fetch2(slice + gridDim.x, k, ks, v, vs);

    // ---- phase 2: the warp's keys ----
    if (active) {
      // dV = Pbᵀ dO and dK = dSbᵀ q over the query steps p, or (causal) the
      // steps from the diagonal one on, p >= warp
      float adv[kNO][4], adk[kNO][4];
#pragma unroll
      for (int n = 0; n < kNO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) adv[n][i] = adk[n][i] = 0.f;
#pragma unroll
      for (int p = 0; p < kNS; ++p) {
        if (kCausal && p < warp) continue;
        // the A fragments of Pbᵀ and dSbᵀ (keys row0.., queries 16p..): the
        // shared tiles' 16 x 16 blocks at (16p, row0), transposed
        uint32_t pa[4], sa[4];
        ldsm_x4_trans(pa, b_frag<lp>(ps, 16 * p, row0, lane));
        ldsm_x4_trans(sa, b_frag<lp>(dss, 16 * p, row0, lane));
#pragma unroll
        for (int np = 0; np < kNO / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_frag<ld>(dos, 16 * p, 16 * np, lane));
          mma16816(adv[2 * np], pa, b[0], b[1]);
          mma16816(adv[2 * np + 1], pa, b[2], b[3]);
          ldsm_x4_trans(b, bt_frag<ld>(qs, 16 * p, 16 * np, lane));
          mma16816(adk[2 * np], sa, b[0], b[1]);
          mma16816(adk[2 * np + 1], sa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= d) break;
        if (r0 < s) {
          *reinterpret_cast<__nv_bfloat162*>(dv + base + size_t(r0) * d + col) =
              __floats2bfloat162_rn(adv[n][0], adv[n][1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + base + size_t(r0) * d + col) =
              __floats2bfloat162_rn(adk[n][0], adk[n][1]);
        }
        if (r1 < s) {
          *reinterpret_cast<__nv_bfloat162*>(dv + base + size_t(r1) * d + col) =
              __floats2bfloat162_rn(adv[n][2], adv[n][3]);
          *reinterpret_cast<__nv_bfloat162*>(dk + base + size_t(r1) * d + col) =
              __floats2bfloat162_rn(adk[n][2], adk[n][3]);
        }
      }
    }
    __syncthreads();  // q and dO are read no more
    fetch2(slice + gridDim.x, q, qs, dout, dos);
  }
}

// As the forward: as many blocks as the card holds at once, each walking
// its slices blockIdx.x, + gridDim.x, ...
template <int kD, int kNS, bool kCausal>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                          void* dq, void* dk, void* dv, int bh, int s, int d,
                          cudaStream_t stream) {
  constexpr size_t bytes = bwd_tc_smem_bytes<kD, kNS>();
  constexpr int threads = 32 * kNS;
  auto kernel = short_attention_bwd_tc_kernel<kD, kNS, kCausal>;
  static const Resident resident = find_resident(kernel, threads, bytes);
  if (resident.err != cudaSuccess) return resident.err;
  const int blocks = bh < resident.blocks ? bh : resident.blocks;
  kernel<<<blocks, threads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), bh, s, d);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t launch_bwd_tc_depth(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, int bh, int s, int d,
                                cudaStream_t st) {
  if (d <= 64) {
    if (s <= 64) return launch_bwd_tc<64, 4, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
    if (s <= 80) return launch_bwd_tc<64, 5, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
    return launch_bwd_tc<64, 8, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  }
  if (s <= 64) return launch_bwd_tc<128, 4, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  if (s <= 80) return launch_bwd_tc<128, 5, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  return launch_bwd_tc<128, 8, kCausal>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tensor_cores: 1 runs a bfloat16
// input on the tensor cores (D % 8 == 0 and q, k, v on a 16-byte boundary,
// else cudaErrorInvalidValue), 0 on the CUDA cores. Returns a cudaError_t (0
// on success); argument errors return cudaErrorInvalidValue without
// launching.
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int dtype, int causal,
                                   int tensor_cores, void* stream) {
  if (bh <= 0 || s <= 0 || s > kMaxS || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1 || d % 8 != 0 || !(aligned16(q) && aligned16(k) && aligned16(v)))
      return cudaErrorInvalidValue;
    return causal ? launch_tc_depth<true>(q, k, v, o, bh, s, d, st)
                  : launch_tc_depth<false>(q, k, v, o, bh, s, d, st);
  }
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
// Same codes and return value as above; tensor_cores asks dout, too, to
// start on a 16-byte boundary.
extern "C" int short_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, int bh,
                                   int s, int d, int dtype, int causal, int tensor_cores,
                                   void* stream) {
  if (bh <= 0 || s <= 0 || s > kMaxS || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1 || d % 8 != 0 ||
        !(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
      return cudaErrorInvalidValue;
    return causal ? launch_bwd_tc_depth<true>(q, k, v, dout, dq, dk, dv, bh, s, d, st)
                  : launch_bwd_tc_depth<false>(q, k, v, dout, dq, dk, dv, bh, s, d, st);
  }
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
