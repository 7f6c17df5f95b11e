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
// 0.48 GFLOP, so what counts is keeping the loads in flight while rows are
// reduced, and filling the card with blocks. The design:
//   - grid = (splits of L, H, B): `split_plan` cuts each (b, h) pair's rows
//     into the fewest splits that give every SM a block (one at B >= 5 for
//     32 heads, five at B = 1), at most 8; the splits of a pair form one
//     thread-block cluster;
//   - each warp owns a ring of 3 tiles in shared memory, filled with
//     `cp.async` (K, V, and the tile's bias and scales), and takes every 8th
//     tile of the block's rows: two tiles are in flight while one is reduced,
//     and the warps never wait for each other (`__syncwarp` only);
//   - a tile is 2 KB of K and V at hd = 128 over bf16 and int8 (2 and 4 rows
//     a lane group; 4 blocks an SM), 4 KB over float32 (2 rows): a lane owns
//     8 values of hd and a group of G = pow2 >= hd/8 lanes a row, q in
//     registers. The tile's dot products are reduced across the group
//     together, then one tile max, one rescale of the running (max, sum,
//     ctx), the exponentials and the V product: a softmax per tile, not per
//     row. Logits are kept in log2 units, so each exponential is one `ex2`;
//     int8 widens by a byte permute and an add (no conversion instruction);
//   - the lane groups of a warp and the warps merge in a fixed order
//     (shuffles, then shared memory); with one split the block writes ctx,
//     with more the blocks of the cluster merge the splits in index order
//     through distributed shared memory. One launch, no scratch.
// No atomics: every sum has a fixed order, so a relaunch gives the same bits.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;     // tiles in a warp's ring
constexpr int kVec = 8;        // values of hd a lane owns
constexpr int kMaxHd = 128;
constexpr int kMaxSplits = 8;  // a portable cluster

// 8 cache values of one row: copied into shared memory, then loaded and
// widened to float32.
template <typename T>
struct Row8;

template <>
struct Row8<float> {
  float4 a, b;
  static __device__ __forceinline__ void copy(float* dst, const float* src, bool valid) {
    mma_sync::cp_async16(dst, src, valid);
    mma_sync::cp_async16(dst + 4, src + 4, valid);
  }
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void widen(float (&o)[kVec]) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  static __device__ __forceinline__ void copy(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              bool valid) {
    mma_sync::cp_async16(dst, src, valid);
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
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
  static __device__ __forceinline__ void copy(int8_t* dst, const int8_t* src, bool valid) {
    mma_sync::cp_async8(dst, src, valid);
  }
  __device__ __forceinline__ void load(const int8_t* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  // byte ^ 0x80 = v + 128 placed in the low bits of 2^23 is the float32
  // 2^23 + v + 128, so one subtraction gives v exactly: a byte permute and an
  // add a value, where a conversion instruction runs at a quarter of the rate
  __device__ __forceinline__ void widen(float (&o)[kVec]) const {
    const uint32_t lo = u.x ^ 0x80808080u, hi = u.y ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = __uint_as_float(__byte_perm(lo, 0x4b000000u, 0x7540 | i)) - 8388736.f;
      o[4 + i] = __uint_as_float(__byte_perm(hi, 0x4b000000u, 0x7540 | i)) - 8388736.f;
    }
  }
};

// rows of a lane group in one tile: 2 KB of K and V at hd = 128 over bf16
// and int8 (4 blocks an SM), 4 KB over float32
template <typename T>
__host__ __device__ constexpr int group_rows() {
  return sizeof(T) == 1 ? 4 : 2;
}

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

// 2^x, one MUFU operation (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// (m, s, acc) <- (m, s, acc) + (om, os, oacc): two online-softmax partials,
// maxima in log2 units.
__device__ __forceinline__ void merge(float& m, float& s, float (&acc)[kVec], float om, float os,
                                      const float (&oacc)[kVec]) {
  if (om == -CUDART_INF_F) return;
  const float nm = fmaxf(m, om);
  const float a = exp2_approx(m - nm), b = exp2_approx(om - nm);  // m == -inf gives a = 0
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
  int B, H, KVH, hd, L, rows_per_split, n_splits;
  int group;        // lanes of a row: pow2 >= hd / 8
  int tile_bytes;   // one tile of a warp's ring
  float sm_scale;
  void* out;
};

// lanes of a row: pow2 >= hd / 8
__host__ __device__ inline int lane_group(int hd) {
  int g = 1;
  while (g * kVec < hd) g <<= 1;
  return g;
}

// bytes of one tile of a warp's ring: K and V rows, the bias and, int8, the
// two scales of each row
template <typename T, bool kQuant>
int tile_bytes(int hd) {
  const int rows = (32 / lane_group(hd)) * group_rows<T>();
  const int bytes = 2 * rows * hd * int(sizeof(T)) + rows * 4 * (kQuant ? 3 : 1);
  return (bytes + 15) / 16 * 16;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads, 2) decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float s_m[kWarps], s_s[kWarps];
  __shared__ float s_acc[kWarps][kMaxHd];
  __shared__ float s_part[kMaxHd + 2];  // the block's (ctx, max, sum), for its cluster
  constexpr int kRows = group_rows<T>();
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = a.hd, G = a.group, slots = 32 / G;
  const int slot = lane / G, j = lane % G;  // the row slot; the hd chunk
  const int rows = slots * kRows;           // rows of a tile
  const bool active = j * kVec < hd;
  const int kvh = h / (a.H / a.KVH);

  float q[kVec];
  {
    const size_t off = (size_t(b) * a.H + h) * hd + j * kVec;
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
  const T* kb = static_cast<const T*>(a.k) + b * a.stride_b + size_t(kvh) * hd + j * kVec;
  const T* vb = static_cast<const T*>(a.v) + b * a.stride_b + size_t(kvh) * hd + j * kVec;
  const float* bias = a.bias + b * a.bias_stride_b;
  const float* ksc = kQuant ? a.k_scale + b * a.scale_stride_b : nullptr;
  const float* vsc = kQuant ? a.v_scale + b * a.scale_stride_b : nullptr;

  const float scale2 = a.sm_scale * kLog2e;
  const int l0 = split * a.rows_per_split;
  const int l1 = min(a.L, l0 + a.rows_per_split);
  const int tiles = (l1 - l0 + rows - 1) / rows;
  // this warp's tiles: warp, warp + kWarps, ...
  const int mine = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
  unsigned char* wring = ring + warp * kStages * a.tile_bytes;

  // tile i of this warp -> slot i % kStages: K (rows, hd), V (rows, hd),
  // bias (rows) and, int8, k_scale and v_scale (rows); rows past l1 zero
  auto issue = [&](int i) {
    if (i < mine) {
      unsigned char* st = wring + (i % kStages) * a.tile_bytes;
      T* ks = reinterpret_cast<T*>(st);
      T* vs = ks + rows * hd;
      float* bs = reinterpret_cast<float*>(vs + rows * hd);
      const int base = l0 + (warp + kWarps * i) * rows;
      if (active) {
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int r = rr * slots + slot, row = base + r;
          const bool valid = row < l1;
          const long long off = (long long)(valid ? row : l0) * a.stride_l;
          Row8<T>::copy(ks + r * hd + j * kVec, kb + off, valid);
          Row8<T>::copy(vs + r * hd + j * kVec, vb + off, valid);
        }
      }
      for (int r = lane; r < rows; r += 32) {
        const int row = base + r;
        const bool valid = row < l1;
        const int src = valid ? row : l0;
        mma_sync::cp_async4(bs + r, bias + src, valid);
        if (kQuant) {
          mma_sync::cp_async4(bs + rows + r, ksc + src, valid);
          mma_sync::cp_async4(bs + 2 * rows + r, vsc + src, valid);
        }
      }
    }
    mma_sync::cp_async_commit();
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  float m = -CUDART_INF_F, s = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    mma_sync::cp_async_wait<kStages - 2>();  // tile i has landed
    __syncwarp();
    issue(i + kStages - 1);
    const unsigned char* st = wring + (i % kStages) * a.tile_bytes;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = ks + rows * hd;
    const float* bs = reinterpret_cast<const float*>(vs + rows * hd);
    const int base = l0 + (warp + kWarps * i) * rows;

    float lg[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float dot = 0.f;
      if (active) {
        Row8<T> kr;
        kr.load(ks + (rr * slots + slot) * hd + j * kVec);
        float kv[kVec];
        kr.widen(kv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(q[e], kv[e], dot);
      }
      lg[rr] = dot;
    }
    // the tile's dot products reduced over the group's lanes, together
    for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) lg[rr] += __shfl_xor_sync(0xffffffffu, lg[rr], o);
    }
    // logits in log2 units: the softmax is the same, and each exponential
    // one ex2
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = rr * slots + slot;
      float dot = lg[rr] * scale2;
      if (kQuant) dot *= bs[rows + r];
      lg[rr] = base + r < l1 ? fmaf(bs[r], kLog2e, dot) : -CUDART_INF_F;
      tmax = fmaxf(tmax, lg[rr]);
    }
    // one rescale a tile; a slot whose rows all lie past l1 adds nothing
    const float nm = fmaxf(m, tmax);
    if (nm == -CUDART_INF_F) continue;
    const float c = exp2_approx(m - nm);
    s *= c;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= c;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = rr * slots + slot;
      const float p = exp2_approx(lg[rr] - nm);
      s += p;
      if (active) {
        const float w = kQuant ? p * bs[2 * rows + r] : p;
        Row8<T> vr;
        vr.load(vs + r * hd + j * kVec);
        float vv[kVec];
        vr.widen(vv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(w, vv[e], acc[e]);
      }
    }
    m = nm;
  }
  mma_sync::cp_async_wait<0>();

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
  // the warps in order (a warp with no row adds nothing)
  const int d = threadIdx.x;
  float bm = -CUDART_INF_F, bsum = 0.f, bacc = 0.f;
  if (d < hd) {
    for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, s_m[w]);
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w] == -CUDART_INF_F) continue;
      const float e = exp2_approx(s_m[w] - bm);
      bsum += s_s[w] * e;
      bacc += s_acc[w][d] * e;
    }
  }
  using O = typename Out<T>::type;
  O* out = static_cast<O*>(a.out) + (size_t(b) * a.H + h) * hd;
  if (a.n_splits == 1) {  // the whole grid alike
    if (d < hd) out[d] = Out<T>::cast(bacc / bsum);
    return;
  }
  // the splits of the pair, in index order: out = Σ ctx·e / Σ sum·e with
  // e = exp(max_split - max); a split whose rows are all masked holds a max
  // near -1e9 and so an e of 0
  if (d < hd) s_part[d] = bacc;
  if (d == 0) {
    s_part[hd] = bm;
    s_part[hd + 1] = bsum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = a.n_splits;
  if (d < hd && d % n == int(cluster.block_rank())) {
    float gm = -CUDART_INF_F;
    for (int i = 0; i < n; ++i) gm = fmaxf(gm, cluster.map_shared_rank(s_part, i)[hd]);
    float gs = 0.f, ga = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* p = cluster.map_shared_rank(s_part, i);
      const float e = exp2_approx(p[hd] - gm);
      gs += p[hd + 1] * e;
      ga += p[d] * e;
    }
    out[d] = Out<T>::cast(ga / gs);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename T, bool kQuant>
cudaError_t prepare(int hd, int* blocks_per_sm) {
  auto kern = decode_attention_kernel<T, kQuant>;
  const int smem = kWarps * kStages * tile_bytes<T, kQuant>(hd);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads, smem);
}

template <typename T, bool kQuant>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int smem = kWarps * kStages * a.tile_bytes;
  cudaError_t err = prepare<T, kQuant>(a.hd, nullptr);
  if (err != cudaSuccess) return err;
  if (a.n_splits == 1) {  // no cluster to merge
    decode_attention_kernel<T, kQuant><<<dim3(1, a.H, a.B), kThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.H, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, kQuant>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Blocks of the kernel for cache_dtype (0 float32, 1 bf16, 2 int8) at head
// dim hd that one SM holds at once. Returns a cudaError_t.
extern "C" int decode_attention_occupancy(int cache_dtype, int hd, int* blocks_per_sm) {
  if (cache_dtype < 0 || cache_dtype > 2 || hd % kVec || hd <= 0 || hd > kMaxHd)
    return int(cudaErrorInvalidValue);
  switch (cache_dtype) {
    case 0: return int(prepare<float, false>(hd, blocks_per_sm));
    case 1: return int(prepare<__nv_bfloat16, false>(hd, blocks_per_sm));
    default: return int(prepare<int8_t, true>(hd, blocks_per_sm));
  }
}

// cache_dtype: 0 float32, 1 bf16, 2 int8 (k_scale / v_scale then given);
// sm_scale = hd^-½ as the caller rounds it to float32; L cut into n_splits
// <= 8 splits of rows_per_split rows. Returns a cudaError_t; 1
// (cudaErrorInvalidValue) for a geometry the kernel does not take.
extern "C" int decode_attention(const void* q, int q_bf16, const void* k, const void* v,
                                int cache_dtype, long long stride_b, long long stride_l,
                                const void* bias, long long bias_stride_b, const void* k_scale,
                                const void* v_scale, long long scale_stride_b, int B, int H,
                                int KVH, int hd, int L, int rows_per_split, int n_splits,
                                float sm_scale, void* out, void* stream) {
  if (hd % kVec || hd > kMaxHd || hd <= 0 || KVH <= 0 || H % KVH || L < 1 || B < 1 ||
      rows_per_split < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      (long long)(n_splits - 1) * rows_per_split >= L ||
      (long long)n_splits * rows_per_split < L || H > 65535 || B > 65535 || cache_dtype < 0 ||
      cache_dtype > 2)
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
  a.group = lane_group(hd);
  a.sm_scale = sm_scale;
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cache_dtype) {
    case 0: a.tile_bytes = tile_bytes<float, false>(hd); return int(launch<float, false>(a, st));
    case 1:
      a.tile_bytes = tile_bytes<__nv_bfloat16, false>(hd);
      return int(launch<__nv_bfloat16, false>(a, st));
    default: a.tile_bytes = tile_bytes<int8_t, true>(hd); return int(launch<int8_t, true>(a, st));
  }
}
