// Long-sequence maskless self-attention for Hopper (sm_90a): forward and
// backward, for every sequence length.
//
// The forward replaces the TPU kernel `_fwd_kernel` in
// spn4cir_tpu/ops/attention_kernels.py (reached through
// `fused_attention_pallas` / `_run_forward`); the backward (second half of
// this file) replaces `_bwd_kernel` (`_run_backward`). For each of BH
// (batch*head) slices the forward computes
//
//     o = softmax(q k^T) v
//
// with q pre-scaled by the caller; q, k, v, o are (BH, S, D) contiguous,
// any S >= 1, D <= 128 and a multiple of 8 (64 for the ViT-B/16 and ViT-L/14
// towers, 88 for EVA-g), float32 or bfloat16. Logits and softmax run in
// float32, P is rounded to the input type before P*V, P*V accumulates in
// float32 and the output is stored in the input type.
//
// What bounds it: per slice two S x S x D products around a softmax over S
// keys, 42.6 MFLOP each at BLIP's S=577, D=64, against 4 x 73.9 KB of q, k,
// v, o: by the card's peaks the bytes and the tensor-core operations take
// about the same time, and on the CUDA cores (this kernel) the float32
// multiply-add rate bounds it by far. The TPU kernel keeps one slice's
// whole S x S score block on chip; a Hopper block has 227 KB of shared
// memory, so the keys are walked in tiles.
//
// Design:
//   - one block of 256 threads per (slice, tile of 64 query rows); grid.x =
//     slice, grid.y = row tile; the keys go by in tiles of 64, K and V of a
//     tile staged in shared memory as float32 with 16-byte global loads;
//     ragged last tiles are masked in the kernel (rows past S are staged as
//     zeros, keys past S get probability 0), so nothing is padded on the host;
//   - online softmax: each row keeps a running maximum m and sum l; a new
//     tile's un-normalised P = exp(logit - m) is rounded to the input type
//     and multiplied into the float32 accumulator, which is rescaled when m
//     grows; o = acc / l at the end. Rounding. The TPU kernel and the plain
//     PyTorch version normalise P in float32 and round it then; here the
//     un-normalised P is rounded and the division follows. Both round a
//     value in [0, 1] once to 8 bits (bfloat16), so the results differ by
//     bfloat16 rounding noise and are held at the tolerance of the
//     short-sequence kernel (2e-2); in float32 nothing is rounded and only
//     the order of the sums differs (1e-5). The two-sweep form (statistics
//     first, then products) would match the plain version more closely at
//     1.5x the multiply-adds, which are what bounds this kernel;
//   - threads as 16 x 16: in a logits product thread (ty, tx) owns rows
//     ty + 16a and keys tx + 16b (a, b < 4) and reads both operands as
//     float4 along the depth; row statistics are reduced over the 16 lanes
//     of a half-warp by shuffles; in a product with V (or K, Q, dO) the
//     thread owns the same rows and the columns 4tx .. 4tx+3 (+64), reading
//     P as float4 along the keys and the other operand as float4 along the
//     columns. Row strides of D + 4 (and 68 for P) keep every 16-byte
//     shared-memory read free of bank conflicts;
//   - the forward also writes the rows' log-sum-exp (BH, S) float32 for the
//     backward.
// Each sum runs in a fixed order and no atomics are used: two launches give
// the same bits.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kMT = kTile / 16;  // rows (and keys) per thread in a tile
constexpr int kLdP = kTile + 4;  // row stride of the P / dS tiles
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// over the 16 lanes that share a row (tx = lane & 15)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + kTile) of one slice's (S, D) operand into shared memory
// as float32, row stride ld; rows past S are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, float* dst, int row0,
                                           int s, int d, int ld, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {  // 16-byte aligned rows (d % 8 == 0)
    const int per_row = d / kVec;
    for (int idx = threadIdx.x; idx < kTile * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * kVec;
      float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
      if (row0 + r < s) {
        const uint4 w = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * d + c);
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i)
          out[i] = make_float4(to_f32(e[4 * i]), to_f32(e[4 * i + 1]), to_f32(e[4 * i + 2]),
                               to_f32(e[4 * i + 3]));
      } else {
#pragma unroll
        for (int i = 0; i < kVec / 4; ++i) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      dst[r * ld + c] = row0 + r < s ? to_f32(src[size_t(row0 + r) * d + c]) : 0.f;
    }
  }
}

// acc[a][b] = sum over c < d of X[(ty + 16a) ld + c] * Y[(tx + 16b) ld + c]
__device__ __forceinline__ void product_nt(const float* __restrict__ X,
                                           const float* __restrict__ Y, int ld, int d,
                                           float (&acc)[kMT][kMT]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < kMT; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 x[kMT], y[kMT];
#pragma unroll
    for (int a = 0; a < kMT; ++a)
      x[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * ld + c);
#pragma unroll
    for (int b = 0; b < kMT; ++b)
      y[b] = *reinterpret_cast<const float4*>(Y + (tx + 16 * b) * ld + c);
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int b = 0; b < kMT; ++b) {
        float t = acc[a][b];
        t = fmaf(x[a].x, y[b].x, t);
        t = fmaf(x[a].y, y[b].y, t);
        t = fmaf(x[a].z, y[b].z, t);
        t = fmaf(x[a].w, y[b].w, t);
        acc[a][b] = t;
      }
  }
}

// acc[a][4u + e] += sum over j < kTile of A[(ty + 16a) kLdP + j] *
// B[j ld + 4tx + 64u + e], for the columns below d.
template <int kDU>
__device__ __forceinline__ void product_nn(const float* __restrict__ A,
                                           const float* __restrict__ B, int ld, int d,
                                           float (&acc)[kMT][4 * kDU]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float av[kMT][4];
#pragma unroll
    for (int a = 0; a < kMT; ++a) {
      const float4 t = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * kLdP + j);
      av[a][0] = t.x;
      av[a][1] = t.y;
      av[a][2] = t.z;
      av[a][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int u = 0; u < kDU; ++u) {
        const int col = 4 * tx + 64 * u;
        float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < d) bv = *reinterpret_cast<const float4*>(B + (j + jj) * ld + col);
#pragma unroll
        for (int a = 0; a < kMT; ++a) {
          const float p = av[a][jj];
          acc[a][4 * u + 0] = fmaf(p, bv.x, acc[a][4 * u + 0]);
          acc[a][4 * u + 1] = fmaf(p, bv.y, acc[a][4 * u + 1]);
          acc[a][4 * u + 2] = fmaf(p, bv.z, acc[a][4 * u + 2]);
          acc[a][4 * u + 3] = fmaf(p, bv.w, acc[a][4 * u + 3]);
        }
      }
    }
  }
}

// Rows first + ty + 16a (below s) of acc, scaled per row, into (S, D) dst.
template <typename T, int kDU>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int first, int s, int d,
                                           const float (&acc)[kMT][4 * kDU],
                                           const float (&scale)[kMT]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    const int i = first + ty + 16 * a;
    if (i >= s) continue;
#pragma unroll
    for (int u = 0; u < kDU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * u + e;
        if (col < d) dst[size_t(i) * d + col] = from_f32<T>(acc[a][4 * u + e] * scale[a]);
      }
  }
}

template <typename T, int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int s, int d, int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // (kTile, ld)
  float* ks = qs + kTile * ld;                  // (kTile, ld)
  float* vs = ks + kTile * ld;                  // (kTile, ld)
  float* ps = vs + kTile * ld;                  // (kTile, kLdP): P rounded to T

  const size_t base = size_t(blockIdx.x) * s * d;
  const int row0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage_tile(q + base, qs, row0, s, d, ld, vec != 0);

  float m[kMT], l[kMT], out[kMT][4 * kDU];
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kDU; ++c) out[a][c] = 0.f;
  }

  for (int key0 = 0; key0 < s; key0 += kTile) {
    __syncthreads();  // the last tile's products have read ks, vs and ps
    stage_tile(k + base, ks, key0, s, d, ld, vec != 0);
    stage_tile(v + base, vs, key0, s, d, ld, vec != 0);
    __syncthreads();

    float acc[kMT][kMT];
    product_nt(qs, ks, ld, d, acc);
#pragma unroll
    for (int a = 0; a < kMT; ++a) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < kMT; ++b)
        if (key0 + tx + 16 * b < s) mx = fmaxf(mx, acc[a][b]);
      // every tile holds at least one key below s, so the maximum is finite
      const float m_new = fmaxf(m[a], row_max(mx));
      const float rescale = expf(m[a] - m_new);  // 0 at the first tile
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < kMT; ++b) {
        const float p = key0 + tx + 16 * b < s ? expf(acc[a][b] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * a) * kLdP + tx + 16 * b] = round_to<T>(p);
      }
      l[a] = l[a] * rescale + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kDU; ++c) out[a][c] *= rescale;
    }
    __syncthreads();
    product_nn<kDU>(ps, vs, ld, d, out);
  }

  float inv[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    inv[a] = 1.f / l[a];
    const int i = row0 + ty + 16 * a;
    if (tx == 0 && i < s) lse[size_t(blockIdx.x) * s + i] = m[a] + logf(l[a]);
  }
  store_rows<T, kDU>(o + base, row0, s, d, out, inv);
}

size_t fwd_smem_bytes(int d) {
  return sizeof(float) * (size_t(3) * kTile * (d + 4) + kTile * kLdP);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int kDU>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int s, int d, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes(d);
  auto kernel = long_attention_fwd_kernel<T, kDU>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid(bh, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(o), lse, s,
                                            d, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel `_bwd_kernel`. Per slice, with P = exp(q k^T - lse)
// recomputed from the forward's log-sum-exp (the TPU kernel recomputes the
// whole softmax; a block here sees one tile of keys at a time):
//
//     dV = Pb^T dO       dP = dO V^T       dS = P o (dP - delta)
//     dQ = dSb K         dK = dSb^T Q
//
// Pb and dSb are P and dS rounded to the input type before their products,
// as in the TPU kernel; every product accumulates in float32. delta is
// rowsum(dO o O), which equals the TPU kernel's rowsum(dP o P) in exact
// arithmetic and saves a sweep over the keys; with a bfloat16 O it rounds
// differently, so bfloat16 is held at 5e-2 (as the short-sequence backward)
// and float32 at 1e-4.
//
// What bounds it: five S x S x D products per slice by the count of the
// function (7 tensors of bytes against them: operations, even at the
// tensor-core peak). dQ sums over the keys and dK, dV over the query rows.
// To keep every sum inside one block, in a fixed order and free of float
// atomics, two kernels each own their outputs:
//   - `dq`: one block per (slice, 64 query rows) walks the key tiles:
//     logits, dP, dSb into shared memory, dQ += dSb K. It also forms delta
//     for its rows and writes it to a (BH, S) scratch;
//   - `dkv`: one block per (slice, 64 keys) walks the query tiles: logits,
//     dP, then Pb and dSb transposed into shared memory, dV += Pb^T dO and
//     dK += dSb^T Q.
// Seven products are executed for the five counted (the logits and dP are
// formed in both kernels); partial sums through global memory and a reduce
// would move more bytes than the recomputation costs here.

template <typename T, int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const T* __restrict__ o, const float* __restrict__ lse,
                             T* __restrict__ dq, float* __restrict__ delta, int s, int d,
                             int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // (kTile, ld) each
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;                 // (kTile, kLdP): dS rounded to T

  const size_t base = size_t(blockIdx.x) * s * d;
  const size_t stat = size_t(blockIdx.x) * s;
  const int row0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage_tile(q + base, qs, row0, s, d, ld, vec != 0);
  stage_tile(dout + base, dos, row0, s, d, ld, vec != 0);
  __syncthreads();

  float lse_r[kMT], delta_r[kMT], acc[kMT][4 * kDU];
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    const int i = row0 + ty + 16 * a;
    float part = 0.f;
    if (i < s)
      for (int c = tx; c < d; c += 16)
        part = fmaf(dos[(ty + 16 * a) * ld + c], to_f32(o[base + size_t(i) * d + c]), part);
    delta_r[a] = row_sum(part);
    lse_r[a] = i < s ? lse[stat + i] : 0.f;
    if (tx == 0 && i < s) delta[stat + i] = delta_r[a];
#pragma unroll
    for (int c = 0; c < 4 * kDU; ++c) acc[a][c] = 0.f;
  }

  for (int key0 = 0; key0 < s; key0 += kTile) {
    __syncthreads();  // the last tile's product has read ks and dss
    stage_tile(k + base, ks, key0, s, d, ld, vec != 0);
    stage_tile(v + base, vs, key0, s, d, ld, vec != 0);
    __syncthreads();

    float sc[kMT][kMT], dp[kMT][kMT];
    product_nt(qs, ks, ld, d, sc);
    product_nt(dos, vs, ld, d, dp);
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int b = 0; b < kMT; ++b) {
        const float p = key0 + tx + 16 * b < s ? expf(sc[a][b] - lse_r[a]) : 0.f;
        dss[(ty + 16 * a) * kLdP + tx + 16 * b] = round_to<T>(p * (dp[a][b] - delta_r[a]));
      }
    __syncthreads();
    product_nn<kDU>(dss, ks, ld, d, acc);
  }

  float one[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) one[a] = 1.f;
  store_rows<T, kDU>(dq + base, row0, s, d, acc, one);
}

template <typename T, int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int s, int d, int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* ks = reinterpret_cast<float*>(smem4);  // (kTile, ld) each
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* pt = dos + kTile * ld;                 // (kTile keys, kLdP): P^T rounded to T
  float* dst = pt + kTile * kLdP;               // (kTile keys, kLdP): dS^T rounded to T
  float* lse_s = dst + kTile * kLdP;            // (kTile)
  float* delta_s = lse_s + kTile;               // (kTile)

  const size_t base = size_t(blockIdx.x) * s * d;
  const size_t stat = size_t(blockIdx.x) * s;
  const int key0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage_tile(k + base, ks, key0, s, d, ld, vec != 0);
  stage_tile(v + base, vs, key0, s, d, ld, vec != 0);

  float acc_dk[kMT][4 * kDU], acc_dv[kMT][4 * kDU];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int c = 0; c < 4 * kDU; ++c) {
      acc_dk[a][c] = 0.f;
      acc_dv[a][c] = 0.f;
    }

  for (int row0 = 0; row0 < s; row0 += kTile) {
    __syncthreads();  // the last tile's products have read qs, dos, pt and dst
    stage_tile(q + base, qs, row0, s, d, ld, vec != 0);
    stage_tile(dout + base, dos, row0, s, d, ld, vec != 0);
    if (threadIdx.x < kTile) {
      const int i = row0 + threadIdx.x;
      lse_s[threadIdx.x] = i < s ? lse[stat + i] : 0.f;
      delta_s[threadIdx.x] = i < s ? delta[stat + i] : 0.f;
    }
    __syncthreads();

    // rows: query rows ty + 16a; columns: keys tx + 16b
    float sc[kMT][kMT], dp[kMT][kMT];
    product_nt(qs, ks, ld, d, sc);
    product_nt(dos, vs, ld, d, dp);
#pragma unroll
    for (int a = 0; a < kMT; ++a)
#pragma unroll
      for (int b = 0; b < kMT; ++b) {
        const int il = ty + 16 * a, jl = tx + 16 * b;
        const bool valid = row0 + il < s && key0 + jl < s;
        const float p = valid ? expf(sc[a][b] - lse_s[il]) : 0.f;
        pt[jl * kLdP + il] = round_to<T>(p);
        dst[jl * kLdP + il] = round_to<T>(p * (dp[a][b] - delta_s[il]));
      }
    __syncthreads();
    // rows: keys ty + 16a; depth: the tile's query rows
    product_nn<kDU>(pt, dos, ld, d, acc_dv);
    product_nn<kDU>(dst, qs, ld, d, acc_dk);
  }

  float one[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) one[a] = 1.f;
  store_rows<T, kDU>(dv + base, key0, s, d, acc_dv, one);
  store_rows<T, kDU>(dk + base, key0, s, d, acc_dk, one);
}

size_t dq_smem_bytes(int d) {
  return sizeof(float) * (size_t(4) * kTile * (d + 4) + kTile * kLdP);
}

size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (size_t(4) * kTile * (d + 4) + 2 * kTile * kLdP + 2 * kTile);
}

template <typename T, int kDU>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int bh, int s, int d, cudaStream_t stream) {
  auto dq_kernel = long_attention_bwd_dq_kernel<T, kDU>;
  auto dkv_kernel = long_attention_bwd_dkv_kernel<T, kDU>;
  cudaError_t err = allow_smem(dq_kernel, dq_smem_bytes(d));
  if (err != cudaSuccess) return err;
  err = allow_smem(dkv_kernel, dkv_smem_bytes(d));
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  dim3 grid(bh, (s + kTile - 1) / kTile);
  dq_kernel<<<grid, kThreads, dq_smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(o), lse, static_cast<T*>(dq), delta, s,
      d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is complete before the second kernel reads it
  dkv_kernel<<<grid, kThreads, dkv_smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, d,
      vec);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || s <= 0 || d <= 0 || d > kMaxD || d % 8 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: (BH, S, D) contiguous; lse:
// (BH, S) float32, written. Returns a cudaError_t (0 on success); argument
// errors return cudaErrorInvalidValue without launching.
extern "C" int long_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int s, int d, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return d <= 64 ? launch_fwd<float, 1>(q, k, v, o, l, bh, s, d, st)
                   : launch_fwd<float, 2>(q, k, v, o, l, bh, s, d, st);
  }
  if (dtype == 1) {
    return d <= 64 ? launch_fwd<__nv_bfloat16, 1>(q, k, v, o, l, bh, s, d, st)
                   : launch_fwd<__nv_bfloat16, 2>(q, k, v, o, l, bh, s, d, st);
  }
  return cudaErrorInvalidValue;
}

// Backward of long_attention_fwd: dq, dk, dv from q, k, v, dout and the
// forward's o and lse, all (BH, S, D) contiguous in one dtype (lse and the
// scratch delta (BH, S) float32). Same codes and return value as above.
extern "C" int long_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* o, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv, int bh, int s,
                                  int d, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    return d <= 64
               ? launch_bwd<float, 1>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st)
               : launch_bwd<float, 2>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st);
  }
  if (dtype == 1) {
    return d <= 64 ? launch_bwd<__nv_bfloat16, 1>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d,
                                                  st)
                   : launch_bwd<__nv_bfloat16, 2>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d,
                                                  st);
  }
  return cudaErrorInvalidValue;
}
