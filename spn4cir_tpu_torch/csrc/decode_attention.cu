// Decode-step attention for Hopper (sm_90a): one new query per (batch row,
// head) against a layer of the stacked KV cache, for the LLaMA decoders.
//
// Replaces the TPU kernel `_kernel` (reached through `decode_attention`) in
// spn4cir_tpu/ops/decode_attn.py.
//
//     logits[b, h, l] = q[b, h] · K[b, l, kvh] · hd^-½   (int8: · k_scale[b, l])
//                       + bias[b, l]
//     w               = softmax_l(logits)                 (int8: · v_scale[b, l])
//     ctx[b, h]       = Σ_l w[b, h, l] · V[b, l, kvh]
//
// kvh = h / (H / KVH): grouped-query attention reads its kv head, and
// KVH == H is multi-head attention. K and V are the (B, L, KVH·hd) layer of
// the (n_layers, B, L, KVH·hd) cache, passed as a base pointer with a batch
// and a row stride: the layer is never copied. float32, bf16 or int8 cache;
// q float32 or bf16; bias (B, L) float32 carries the causal bound and the
// left-pad mask (-1e9, and exp(-1e9 - m) is exactly 0 in float32); int8
// scales (B, L) float32. The output is (B, H, hd) in the cache's type, float32
// for int8. hd % 8 == 0, hd <= 128; any L >= 1, masked in the kernel.
//
// The TPU kernel rounds the normalised weights to V's type before the V
// product; this one keeps an online softmax in float32 and rounds once, at
// the output. The two differ by a bf16 rounding of the weights (the stated
// bf16 tolerance), and not at all in float32 beyond the order of the sums.
//
// What bounds it: bytes. Every K and V row of the layer is read once and
// nothing of the (B, H, L) logits goes to memory: at B=16, L=1,842, H=32,
// hd=128 in bf16 that is 483 MB, 0.144 ms at 3.35 TB/s, for 4·B·H·L·hd =
// 0.48 GFLOP. The design:
//   - grid = (splits of L, H, B): a (b, h) pair takes ceil(L / rows) blocks so
//     that small batches still fill the 132 SMs (`split_plan`); each block
//     keeps its own (max, sum, ctx[hd]);
//   - a lane owns 8 values of hd (one 16-byte load of bf16, two of float32,
//     one 8-byte load of int8); a group of G = pow2 >= hd/8 lanes owns a row,
//     and a warp takes 32/G rows at a time, 4 such steps in flight;
//   - the q·k dot is reduced across the group with xor shuffles, each group
//     runs its own online softmax, and the groups and warps merge in a fixed
//     order at the end (shuffles, then shared memory);
//   - with one split the block writes ctx; with more it writes (ctx, max, sum)
//     to scratch and a merge kernel combines the splits in index order.
// No atomics: every sum has a fixed order, so a relaunch gives the same bits.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // values of hd a lane owns
constexpr int kMaxHd = 128;
constexpr int kUnroll = 4;     // row steps of a warp in flight

// 8 cache values of one row, as loaded, then widened to float32.
template <typename T>
struct Row8;

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void widen(float (&o)[kVec]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void widen(float (&o)[kVec]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float32 is exact: a shift
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<int8_t> {
  uint2 u;
  __device__ __forceinline__ void load(const int8_t* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint2(0u, 0u); }
  __device__ __forceinline__ void widen(float (&o)[kVec]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = float(int8_t((u.x >> (8 * i)) & 0xffu));
      o[4 + i] = float(int8_t((u.y >> (8 * i)) & 0xffu));
    }
  }
};

template <typename T>
struct Out;  // the output type: the cache's, float32 for int8
template <>
struct Out<float> {
  using type = float;
  static __device__ __forceinline__ float cast(float x) { return x; }
};
template <>
struct Out<__nv_bfloat16> {
  using type = __nv_bfloat16;
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) { return __float2bfloat16(x); }
};
template <>
struct Out<int8_t> {
  using type = float;
  static __device__ __forceinline__ float cast(float x) { return x; }
};

// (m, s, acc) <- (m, s, acc) + (om, os, oacc): two online-softmax partials.
__device__ __forceinline__ void merge(float& m, float& s, float (&acc)[kVec], float om, float os,
                                      const float (&oacc)[kVec]) {
  if (om == -CUDART_INF_F) return;
  const float nm = fmaxf(m, om);
  const float a = expf(m - nm), b = expf(om - nm);  // m == -inf gives a = 0
  s = s * a + os * b;
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = acc[e] * a + oacc[e] * b;
  m = nm;
}

struct Args {
  const void* q;
  int q_bf16;
  const void* k;
  const void* v;
  long long stride_b, stride_l;  // elements, of both K and V
  const float* bias;
  long long bias_stride_b;
  const float* k_scale;
  const float* v_scale;
  long long scale_stride_b;
  int B, H, KVH, hd, L, rows_per_split, n_splits, group;
  float sm_scale;
  void* out;
  float* part;  // (B, H, n_splits, hd + 2): ctx, max, sum
};

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  __shared__ float s_m[kWarps], s_s[kWarps];
  __shared__ float s_acc[kWarps][kMaxHd];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = a.group, rows_per_step = 32 / G;
  const int slot = lane / G, j = lane % G;  // the row slot; the hd chunk
  const bool active = j * kVec < a.hd;
  const int kvh = h / (a.H / a.KVH);

  float q[kVec];
  {
    const size_t off = (size_t(b) * a.H + h) * a.hd + j * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) q[e] = 0.f;
    if (active) {
      if (a.q_bf16) {
        Row8<__nv_bfloat16> r;
        r.load(static_cast<const __nv_bfloat16*>(a.q) + off);
        r.widen(q);
      } else {
        Row8<float> r;
        r.load(static_cast<const float*>(a.q) + off);
        r.widen(q);
      }
    }
  }
  const T* kb = static_cast<const T*>(a.k) + b * a.stride_b + size_t(kvh) * a.hd + j * kVec;
  const T* vb = static_cast<const T*>(a.v) + b * a.stride_b + size_t(kvh) * a.hd + j * kVec;
  const float* bias = a.bias + b * a.bias_stride_b;
  const float* ksc = kQuant ? a.k_scale + b * a.scale_stride_b : nullptr;
  const float* vsc = kQuant ? a.v_scale + b * a.scale_stride_b : nullptr;

  const int l0 = split * a.rows_per_split;
  const int l1 = min(a.L, l0 + a.rows_per_split);
  float m = -CUDART_INF_F, s = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  const int step = kWarps * rows_per_step;
  for (int base = l0; base < l1; base += kUnroll * step) {
    Row8<T> kr[kUnroll], vr[kUnroll];
    int row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = base + (u * kWarps + warp) * rows_per_step + slot;
      if (active && row[u] < l1) {
        kr[u].load(kb + row[u] * a.stride_l);
        vr[u].load(vb + row[u] * a.stride_l);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kv[kVec];
      kr[u].widen(kv);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(q[e], kv[e], dot);
      for (int o = G >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (row[u] < l1) {
        float logit = dot * a.sm_scale;
        if (kQuant) logit *= ksc[row[u]];
        logit += bias[row[u]];
        const float nm = fmaxf(m, logit);
        const float c = expf(m - nm), p = expf(logit - nm);
        s = s * c + p;
        const float w = kQuant ? p * vsc[row[u]] : p;
        float vv[kVec];
        vr[u].widen(vv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(w, vv[e], acc[e] * c);
        m = nm;
      }
    }
  }

  // the row slots of the warp, in a fixed order of xor partners
  for (int o = G; o < 32; o <<= 1) {
    float oacc[kVec];
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int e = 0; e < kVec; ++e) oacc[e] = __shfl_xor_sync(0xffffffffu, acc[e], o);
    merge(m, s, acc, om, os, oacc);
  }
  if (lane < G && active) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) s_acc[warp][j * kVec + e] = acc[e];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= a.hd) return;
  float bm = -CUDART_INF_F;
  for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, s_m[w]);
  float bs = 0.f, ba = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    if (s_m[w] == -CUDART_INF_F) continue;  // a warp that had no row
    const float e = expf(s_m[w] - bm);
    bs += s_s[w] * e;
    ba += s_acc[w][d] * e;
  }
  const size_t pair = size_t(b) * a.H + h;
  if (a.n_splits == 1) {
    using O = typename Out<T>::type;
    static_cast<O*>(a.out)[pair * a.hd + d] = Out<T>::cast(ba / bs);
    return;
  }
  float* part = a.part + (pair * a.n_splits + split) * (a.hd + 2);
  part[d] = ba;
  if (d == 0) {
    part[a.hd] = bm;
    part[a.hd + 1] = bs;
  }
}

// out[b, h] = Σ_split ctx·e / Σ_split sum·e, e = exp(max_split - max), the
// splits in index order.
template <typename T>
__global__ void __launch_bounds__(kMaxHd) decode_attention_merge_kernel(const float* part,
                                                                        int n_splits, int hd,
                                                                        void* out) {
  const size_t pair = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= hd) return;
  const float* p = part + pair * n_splits * (hd + 2);
  float bm = -CUDART_INF_F;
  for (int i = 0; i < n_splits; ++i) bm = fmaxf(bm, p[i * (hd + 2) + hd]);
  float bs = 0.f, ba = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float* pi = p + i * (hd + 2);
    const float e = expf(pi[hd] - bm);
    bs += pi[hd + 1] * e;
    ba += pi[d] * e;
  }
  using O = typename Out<T>::type;
  static_cast<O*>(out)[pair * hd + d] = Out<T>::cast(ba / bs);
}

template <typename T, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const dim3 grid(a.n_splits, a.H, a.B);
  decode_attention_kernel<T, kQuant><<<grid, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  decode_attention_merge_kernel<T><<<a.B * a.H, kMaxHd, 0, st>>>(a.part, a.n_splits, a.hd, a.out);
  return cudaGetLastError();
}

}  // namespace

// cache_dtype: 0 float32, 1 bf16, 2 int8 (k_scale / v_scale then given);
// sm_scale = hd^-½ as the caller rounds it to float32.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a geometry the
// kernel does not take.
extern "C" int decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                                int cache_dtype, long long stride_b, long long stride_l,
                                const void* bias, long long bias_stride_b, const void* k_scale,
                                const void* v_scale, long long scale_stride_b, int B, int H,
                                int KVH, int hd, int L, int rows_per_split, int n_splits,
                                float sm_scale, void* out, void* part, void* stream) {
  if (hd % kVec || hd > kMaxHd || hd <= 0 || KVH <= 0 || H % KVH || L < 1 || B < 1 ||
      rows_per_split < 1 || n_splits < 1)
    return int(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.q_bf16 = q_bf16;
  a.k = k;
  a.v = v;
  a.stride_b = stride_b;
  a.stride_l = stride_l;
  a.bias = static_cast<const float*>(bias);
  a.bias_stride_b = bias_stride_b;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.scale_stride_b = scale_stride_b;
  a.B = B;
  a.H = H;
  a.KVH = KVH;
  a.hd = hd;
  a.L = L;
  a.rows_per_split = rows_per_split;
  a.n_splits = n_splits;
  a.group = 1;
  while (a.group * kVec < hd) a.group <<= 1;
  a.sm_scale = sm_scale;
  a.out = out;
  a.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0: return int(launch<float, false>(a, st));
    case 1: return int(launch<__nv_bfloat16, false>(a, st));
    case 2: return int(launch<int8_t, true>(a, st));
    default: return int(cudaErrorInvalidValue);
  }
}
