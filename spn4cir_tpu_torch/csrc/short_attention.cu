// Short-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_fwd_kernel` in
// spn4cir_tpu/ops/attention_kernels.py (reached through
// `packed_attention_pallas` / `packed_causal_attention_pallas`). For each of
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
