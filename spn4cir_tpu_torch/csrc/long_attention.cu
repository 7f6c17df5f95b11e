// Long-sequence maskless self-attention for Hopper (sm_90a): forward and
// backward, for every sequence length.
//
// The forward replaces the TPU kernel `_fwd_kernel` in
// spn4cir_tpu/ops/attention_kernels.py (reached through
// `fused_attention_pallas` / `_run_forward`); the backward replaces
// `_bwd_kernel` (`_run_backward`). For each of BH (batch*head) slices the
// forward computes
//
//     o = softmax(q k^T) v
//
// with q pre-scaled by the caller; q, k, v, o are (BH, S, D) contiguous,
// any S >= 1, D <= 128 and a multiple of 8 (64 for the ViT-B/16 and ViT-L/14
// towers, 88 for EVA-g), float32 or bfloat16. Logits and softmax run in
// float32, P is rounded to the input type before P*V, P*V accumulates in
// float32 and the output is stored in the input type. The forward also
// writes the rows' log-sum-exp (BH, S) float32 for the backward.
//
// What bounds it. Per slice two S x S x D products around a softmax over S
// keys: at BLIP's (BH, S, D) = (1536, 577, 64) 130.9 GFLOP against 4 x 113 MB
// of q, k, v, o in bfloat16, so at the card's peaks 0.132 ms of bf16
// tensor-core operations against 0.135 ms of bytes; the backward's five
// products (5 x 65.4 GFLOP) against 7 tensors are bound by the operations
// (0.331 ms). On the CUDA cores the float32 multiply-add rate (67 TFLOP/s)
// alone would take 1.95 ms for the forward, so bfloat16 inputs go to the
// tensor cores.
//
// Two routes, chosen by the dtype code of the C entry points:
//
// bfloat16: the tensor cores (`*_tc_kernel`s). `mma.sync.m16n8k16` (bf16 in,
// float32 accumulate), operands from shared memory by `ldmatrix`, tiles
// brought in by `cp.async`, all as inline PTX (`mma_sync.cuh`, shared with
// short_attention.cu).
//   - One block of 4 warps per (slice, tile of 64 query rows) in the forward
//     and in the dQ kernel, per (slice, tile of 64 keys) in the dK/dV
//     kernel; a warp owns 16 rows (keys), and the forward keeps its Q
//     fragments in registers for the whole key loop. A warp whose rows all
//     lie past S skips the products. The block index is linear, tiles of
//     one slice side by side, so the blocks in flight share their slices'
//     K and V in the L2.
//   - The walked operand (K and V in tiles of 64 keys; Q and dO in tiles of
//     32 rows, with their lse and delta, in the dK/dV kernel, whose two
//     (16, D) accumulators leave fewer registers) goes through a two-stage
//     ring in shared memory kept in bfloat16: `cp.async` lands tile j+1
//     while tile j is multiplied (a third stage cost a block per SM at
//     D = 64 and gained nothing). Rows past S are zero-filled by
//     `cp.async`'s source size; rows are kD + 8 elements apart so the 8 row
//     addresses of an `ldmatrix` fall in 8 different bank groups.
//   - Depth: instantiated on the padded depth kD = 64, 96, 128 (3 kernels x
//     3 = 9 instantiations); D is copied and the columns [D, kD) are zeroed
//     once in shared memory, so every D % 8 == 0 up to 128 runs, D = 88
//     (EVA-g) as 96. Every loop count is a compile-time constant on a full
//     tile: with bounds known only at run time the unrolled steps split
//     into branches that kept `ldmatrix` from running ahead of the
//     products, and the kernels were markedly slower.
//   - Online softmax in float32 registers: row max over the 4 lanes of a
//     quad by `__shfl_xor_sync`, keys past S get probability 0, the running
//     sum is reduced across the quad once at the end. The un-normalised P
//     is rounded to bf16 in registers and used directly as the A fragment
//     of P*V (the accumulator layout of m16n8k16 is the A layout of the next
//     product; V through `ldmatrix.trans`): P never goes through shared
//     memory. o = acc / l at the end.
//   - Ragged tail: the last tile, in a second copy of the tile's body,
//     copies and multiplies only the 16-key (16-row) steps that hold a key
//     (row) and masks the keys past S; at S = 577 or 257 the one key left
//     over costs a quarter of a tile.
//   - Sources must be 16-byte aligned (`cp.async`); the entry points refuse
//     a misaligned pointer with cudaErrorInvalidValue and the wrapper raises
//     before that.
//
// float32: the CUDA cores (`long_attention_*_kernel`s, no `_tc`). TF32 would
// keep about three decimal digits where the float32 checks ask for 1e-5
// (forward) and 1e-4 (backward) and a float32 loss through twelve layers for
// 2e-4, so float32 inputs keep exact float32 products:
//   - one block of 256 threads per (slice, 64 query rows), keys in tiles of
//     64 staged as float32; threads as 16 x 16, thread (ty, tx) owning rows
//     ty + 16a and keys tx + 16b (a, b < 4), row statistics reduced over the
//     16 lanes of a half-warp; products with V (K, Q, dO) own the columns
//     4tx .. 4tx+3 (+64). Row strides of D + 4 (68 for P) keep every 16-byte
//     shared-memory read free of bank conflicts. 2 depth classes x 3 = 6
//     instantiations.
//
// Rounding. The TPU kernel and the plain PyTorch version normalise P in
// float32 and round it then; here the un-normalised P is rounded and the
// division follows. Both round a value in [0, 1] once to bfloat16, so the
// results differ by rounding noise and are held at 2e-2; in float32 only the
// order of the sums differs (1e-5). Each sum runs in a fixed order and no
// atomics are used: two launches give the same bits.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "mma_sync.cuh"

namespace {

constexpr int kMaxD = 128;

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// ===========================================================================
// float32: the CUDA cores
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kMT = kTile / 16;  // rows (and keys) per thread in a tile
constexpr int kLdP = kTile + 4;  // row stride of the P / dS tiles

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

// Rows [row0, row0 + kTile) of one slice's (S, D) operand into shared memory,
// row stride ld; rows past S are zeros.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, float* dst, int row0,
                                           int s, int d, int ld, bool vec) {
  if (vec) {  // 16-byte aligned rows (d % 8 == 0)
    const int per_row = d / 4;
    for (int idx = threadIdx.x; idx < kTile * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx - r * per_row) * 4;
      float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
      *out = row0 + r < s ? *reinterpret_cast<const float4*>(src + size_t(row0 + r) * d + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      dst[r * ld + c] = row0 + r < s ? src[size_t(row0 + r) * d + c] : 0.f;
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
template <int kDU>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int first, int s, int d,
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
        if (col < d) dst[size_t(i) * d + col] = acc[a][4 * u + e] * scale[a];
      }
  }
}

template <int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int s, int d, int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // (kTile, ld)
  float* ks = qs + kTile * ld;                  // (kTile, ld)
  float* vs = ks + kTile * ld;                  // (kTile, ld)
  float* ps = vs + kTile * ld;                  // (kTile, kLdP)

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
        ps[(ty + 16 * a) * kLdP + tx + 16 * b] = p;
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
  store_rows<kDU>(o + base, row0, s, d, out, inv);
}

size_t fwd_smem_bytes(int d) {
  return sizeof(float) * (size_t(3) * kTile * (d + 4) + kTile * kLdP);
}

template <int kDU>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int s, int d, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes(d);
  auto kernel = long_attention_fwd_kernel<kDU>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid(bh, (s + kTile - 1) / kTile);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o),
                                            lse, s, d, vec);
  return cudaGetLastError();
}

// Backward. Per slice, with P = exp(q k^T - lse) recomputed from the
// forward's log-sum-exp (the TPU kernel recomputes the whole softmax; a block
// here sees one tile of keys at a time):
//
//     dV = Pb^T dO       dP = dO V^T       dS = P o (dP - delta)
//     dQ = dSb K         dK = dSb^T Q
//
// Pb and dSb are P and dS rounded to the input type before their products,
// as in the TPU kernel; every product accumulates in float32. delta is
// rowsum(dO o O), which equals the TPU kernel's rowsum(dP o P) in exact
// arithmetic and saves a sweep over the keys; with a bfloat16 O it rounds
// differently, so bfloat16 is held at 5e-2 (as the short-sequence backward)
// and float32 at 1e-4. dQ sums over the keys and dK, dV over the query rows.
// To keep every sum inside one block, in a fixed order and free of float
// atomics, two kernels each own their outputs (both routes):
//   - `dq`: one block per (slice, 64 query rows) walks the key tiles:
//     logits, dP, dS, dQ += dSb K. It also forms delta for its rows and
//     writes it to a (BH, S) scratch;
//   - `dkv`: one block per (slice, 64 keys) walks the query tiles: logits
//     and dP transposed, dV += Pb^T dO and dK += dSb^T Q.
// Seven products are executed for the five counted (the logits and dP are
// formed in both kernels); partial sums through global memory and a reduce
// would move more bytes than the recomputation costs here.

template <int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ o, const float* __restrict__ lse,
                             float* __restrict__ dq, float* __restrict__ delta, int s, int d,
                             int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // (kTile, ld) each
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;                 // (kTile, kLdP): dS

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
        part = fmaf(dos[(ty + 16 * a) * ld + c], o[base + size_t(i) * d + c], part);
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
        dss[(ty + 16 * a) * kLdP + tx + 16 * b] = p * (dp[a][b] - delta_r[a]);
      }
    __syncthreads();
    product_nn<kDU>(dss, ks, ld, d, acc);
  }

  float one[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) one[a] = 1.f;
  store_rows<kDU>(dq + base, row0, s, d, acc, one);
}

template <int kDU>
__global__ void __launch_bounds__(kThreads)
long_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int s, int d,
                              int vec) {
  extern __shared__ float4 smem4[];
  const int ld = d + 4;
  float* ks = reinterpret_cast<float*>(smem4);  // (kTile, ld) each
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* pt = dos + kTile * ld;                 // (kTile keys, kLdP): P^T
  float* dst = pt + kTile * kLdP;               // (kTile keys, kLdP): dS^T
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
        pt[jl * kLdP + il] = p;
        dst[jl * kLdP + il] = p * (dp[a][b] - delta_s[il]);
      }
    __syncthreads();
    // rows: keys ty + 16a; depth: the tile's query rows
    product_nn<kDU>(pt, dos, ld, d, acc_dv);
    product_nn<kDU>(dst, qs, ld, d, acc_dk);
  }

  float one[kMT];
#pragma unroll
  for (int a = 0; a < kMT; ++a) one[a] = 1.f;
  store_rows<kDU>(dv + base, key0, s, d, acc_dv, one);
  store_rows<kDU>(dk + base, key0, s, d, acc_dk, one);
}

size_t dq_smem_bytes(int d) {
  return sizeof(float) * (size_t(4) * kTile * (d + 4) + kTile * kLdP);
}

size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (size_t(4) * kTile * (d + 4) + 2 * kTile * kLdP + 2 * kTile);
}

template <int kDU>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int bh, int s, int d, cudaStream_t stream) {
  auto dq_kernel = long_attention_bwd_dq_kernel<kDU>;
  auto dkv_kernel = long_attention_bwd_dkv_kernel<kDU>;
  cudaError_t err = allow_smem(dq_kernel, dq_smem_bytes(d));
  if (err != cudaSuccess) return err;
  err = allow_smem(dkv_kernel, dkv_smem_bytes(d));
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  dim3 grid(bh, (s + kTile - 1) / kTile);
  dq_kernel<<<grid, kThreads, dq_smem_bytes(d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(o), lse,
      static_cast<float*>(dq), delta, s, d, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is complete before the second kernel reads it
  dkv_kernel<<<grid, kThreads, dkv_smem_bytes(d), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s, d, vec);
  return cudaGetLastError();
}

// ===========================================================================
// bfloat16: the tensor cores
// ===========================================================================

using namespace mma_sync;  // bf16, cp.async, ldmatrix, mma.sync, fragments

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // rows (keys) a block owns
constexpr int kTcKeys = 64;             // keys per ring stage (forward, dQ)
constexpr int kTcQRows = 32;            // query rows per ring stage (dK/dV)
constexpr int kStages = 2;              // ring stages: kStages - 1 tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// The block's 16-byte copies of rows of a slice's (S, D) operand into a tile
// of row stride ld: this thread copies chunk c of rows r, r + step, ...
struct RowCopier {
  int r, c, step;

  __device__ explicit RowCopier(int d) {
    const int per_row = d / 8;
    step = kTcThreads / per_row;
    r = threadIdx.x / per_row;
    c = (threadIdx.x - r * per_row) * 8;
    if (r >= step) r = 1 << 30;  // the threads left over copy nothing
  }

  // rows [row0, row0 + n), columns below d; rows past S zero-filled
  template <int ld>
  __device__ __forceinline__ void rows(const bf16* __restrict__ src, bf16* dst, int row0, int n,
                                       int s, int d) const {
    for (int i = r; i < n; i += step) {
      const bool valid = row0 + i < s;
      cp_async16(dst + i * ld + c, src + size_t(valid ? row0 + i : 0) * d + c, valid);
    }
  }
};

// n floats of a (BH, S) statistic from row0 on; zeros past S
__device__ __forceinline__ void load_stat(const float* __restrict__ src, float* dst, int row0,
                                          int n, int s) {
  for (int i = threadIdx.x; i < n; i += kTcThreads) {
    const bool valid = row0 + i < s;
    cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

// zeros in the pad columns [d, kD) of n rows; cp.async never writes there
template <int kD>
__device__ __forceinline__ void zero_pad(bf16* t, int n, int d) {
  const int per_row = (kD - d) / 8;
  for (int idx = threadIdx.x; idx < n * per_row; idx += kTcThreads) {
    const int r = idx / per_row, c = d + (idx - r * per_row) * 8;
    *reinterpret_cast<uint4*>(t + r * (kD + 8) + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// how many 16-row steps of a tile from row0 on hold a row below s
__device__ __forceinline__ int live_steps(int row0, int s, int max_steps) {
  return min(max_steps, (s - row0 + 15) / 16);
}

// One key tile for a warp's 16 query rows: S = Q K^T over the tile's live
// 16-key steps (all of them, every key below S, when kFull), the online
// softmax, acc += P V.
template <int kD, bool kFull>
__device__ __forceinline__ void fwd_tile(const uint32_t (&qf)[kD / 16][4], const bf16* kt,
                                         const bf16* vt, int key0, int s, int ns, int lane,
                                         float (&acc)[kD / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int kNK = kD / 16, kNO = kD / 8, kNS = kTcKeys / 16, ld = kD + 8;
  const int steps = kFull ? kNS : ns;
  const int t = lane & 3;

  float sc[2 * kNS][4];
#pragma unroll
  for (int n = 0; n < 2 * kNS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk)
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      if (p >= steps) break;
      uint32_t b[4];
      ldsm_x4(b, b_frag<ld>(kt, 16 * p, 16 * kk, lane));
      mma16816(sc[2 * p], qf[kk], b[0], b[1]);
      mma16816(sc[2 * p + 1], qf[kk], b[2], b[3]);
    }

  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int n = 0; n < 2 * kNS; ++n) {
    if (n >= 2 * steps) break;
    if (!kFull) {  // keys past s: probability 0
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * n + 2 * t + e >= s) sc[n][e] = sc[n][e + 2] = -CUDART_INF_F;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
    mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every tile holds a key below s, so mx0, mx1 are finite; 0 at the first
  const float r0 = exp2f((m[0] - mx0) * kLog2e), r1 = exp2f((m[1] - mx1) * kLog2e);
  m[0] = mx0;
  m[1] = mx1;
  const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
  uint32_t pf[kNS][4];  // P rounded to bf16: the A fragments of P V
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
    float e[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[h][i] = exp2f(fmaf(sc[2 * p + h][i], kLog2e, i < 2 ? -ml0 : -ml1));
    sum0 += e[0][0] + e[0][1] + e[1][0] + e[1][1];
    sum1 += e[0][2] + e[0][3] + e[1][2] + e[1][3];
    pf[p][0] = pack_bf16(e[0][0], e[0][1]);
    pf[p][1] = pack_bf16(e[0][2], e[0][3]);
    pf[p][2] = pack_bf16(e[1][0], e[1][1]);
    pf[p][3] = pack_bf16(e[1][2], e[1][3]);
  }
  l[0] = l[0] * r0 + sum0;  // this lane's share; the quad's shares add at the end
  l[1] = l[1] * r1 + sum1;
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    acc[n][0] *= r0;
    acc[n][1] *= r0;
    acc[n][2] *= r1;
    acc[n][3] *= r1;
  }

#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
#pragma unroll
    for (int np = 0; np < kNO / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt_frag<ld>(vt, 16 * p, 16 * np, lane));
      mma16816(acc[2 * np], pf[p], b[0], b[1]);
      mma16816(acc[2 * np + 1], pf[p], b[2], b[3]);
    }
  }
}

// Instantiated on the padded depth kD (64, 96 or 128): every D with
// round_up(D, 16) <= kD runs here, the columns [D, kD) zero in shared memory.
template <int kD>
__global__ void __launch_bounds__(kTcThreads)
long_attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int s, int d) {
  constexpr int kNK = kD / 16, kNO = kD / 8, kNS = kTcKeys / 16, ld = kD + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // (kTcRows, ld)
  bf16* ks = qs + kTcRows * ld;                 // kStages stages of (kTcKeys, ld)
  bf16* vs = ks + kStages * kTcKeys * ld;

  const int n_row_tiles = (s + kTcRows - 1) / kTcRows;
  const int slice = blockIdx.x / n_row_tiles;
  const int row0 = (blockIdx.x - slice * n_row_tiles) * kTcRows;
  const size_t base = size_t(slice) * s * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = row0 + 16 * warp;
  const bool active = wrow < s;
  const int n_tiles = (s + kTcKeys - 1) / kTcKeys;
  const RowCopier copier(d);

  // key tile jt of K and V into its stage, the live 16-key steps only
  auto fetch = [&](int jt) {
    if (jt < n_tiles) {
      const int key1 = jt * kTcKeys, rows = 16 * live_steps(key1, s, kNS);
      const int st = (jt % kStages) * kTcKeys * ld;
      copier.rows<ld>(k + base, ks + st, key1, rows, s, d);
      copier.rows<ld>(v + base, vs + st, key1, rows, s, d);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  zero_pad<kD>(qs, kTcRows + 2 * kStages * kTcKeys, d);
  copier.rows<ld>(q + base, qs, row0, kTcRows, s, d);  // with tile 0's group
  for (int jt = 0; jt < kStages - 1; ++jt) fetch(jt);

  uint32_t qf[kNK][4];
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's stage
    fetch(j + kStages - 1);
    if (!active) continue;
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) ldsm_x4(qf[kk], a_frag<ld>(qs, 16 * warp, 16 * kk, lane));
    }
    const bf16* kt = ks + (j % kStages) * kTcKeys * ld;
    const bf16* vt = vs + (j % kStages) * kTcKeys * ld;
    const int key0 = j * kTcKeys;
    if (key0 + kTcKeys <= s)
      fwd_tile<kD, true>(qf, kt, vt, key0, s, kNS, lane, acc, m, l);
    else
      fwd_tile<kD, false>(qf, kt, vt, key0, s, live_steps(key0, s, kNS), lane, acc, m, l);
  }
  if (!active) return;

  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int i0 = wrow + g, i1 = wrow + g + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* lse_slice = lse + size_t(slice) * s;
  if (t == 0 && i0 < s) lse_slice[i0] = m[0] + logf(l0);
  if (t == 0 && i1 < s) lse_slice[i1] = m[1] + logf(l1);
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= d) break;
    if (i0 < s)
      *reinterpret_cast<__nv_bfloat162*>(o + base + size_t(i0) * d + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (i1 < s)
      *reinterpret_cast<__nv_bfloat162*>(o + base + size_t(i1) * d + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// One key tile for a warp's 16 query rows (qw, dow: their Q and dO rows in
// shared memory): S = Q K^T, dP = dO V^T, dS = P o (dP - delta) rounded to
// bf16 in registers, dQ += dS K. ll: the rows' lse in log2 units.
template <int kD, bool kFull>
__device__ __forceinline__ void dq_tile(const bf16* qw, const bf16* dow, const bf16* kt,
                                        const bf16* vt, int key0, int s, int ns, int lane,
                                        const float (&ll)[2], const float (&dl)[2],
                                        float (&acc)[kD / 8][4]) {
  constexpr int kNK = kD / 16, kNO = kD / 8, kNS = kTcKeys / 16, ld = kD + 8;
  const int steps = kFull ? kNS : ns;
  const int t = lane & 3;

  float sc[2 * kNS][4], dpv[2 * kNS][4];
#pragma unroll
  for (int n = 0; n < 2 * kNS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = dpv[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    uint32_t aq[4], ado[4];
    ldsm_x4(aq, a_frag<ld>(qw, 0, 16 * kk, lane));
    ldsm_x4(ado, a_frag<ld>(dow, 0, 16 * kk, lane));
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      if (p >= steps) break;
      uint32_t b[4];
      ldsm_x4(b, b_frag<ld>(kt, 16 * p, 16 * kk, lane));
      mma16816(sc[2 * p], aq, b[0], b[1]);
      mma16816(sc[2 * p + 1], aq, b[2], b[3]);
      ldsm_x4(b, b_frag<ld>(vt, 16 * p, 16 * kk, lane));
      mma16816(dpv[2 * p], ado, b[0], b[1]);
      mma16816(dpv[2 * p + 1], ado, b[2], b[3]);
    }
  }

  uint32_t dsf[kNS][4];  // the A fragments of dS K
#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
    float e[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * p + h;
        const bool live = kFull || key0 + 8 * n + 2 * t + (i & 1) < s;
        const float pr = live ? exp2f(fmaf(sc[n][i], kLog2e, -ll[i >> 1])) : 0.f;
        e[h][i] = pr * (dpv[n][i] - dl[i >> 1]);
      }
    dsf[p][0] = pack_bf16(e[0][0], e[0][1]);
    dsf[p][1] = pack_bf16(e[0][2], e[0][3]);
    dsf[p][2] = pack_bf16(e[1][0], e[1][1]);
    dsf[p][3] = pack_bf16(e[1][2], e[1][3]);
  }

#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
#pragma unroll
    for (int np = 0; np < kNO / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt_frag<ld>(kt, 16 * p, 16 * np, lane));
      mma16816(acc[2 * np], dsf[p], b[0], b[1]);
      mma16816(acc[2 * np + 1], dsf[p], b[2], b[3]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
long_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const bf16* __restrict__ o, const float* __restrict__ lse,
                                bf16* __restrict__ dq, float* __restrict__ delta, int s,
                                int d) {
  constexpr int kNO = kD / 8, kNS = kTcKeys / 16, ld = kD + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // (kTcRows, ld)
  bf16* dos = qs + kTcRows * ld;                // (kTcRows, ld)
  bf16* ks = dos + kTcRows * ld;                // kStages stages of (kTcKeys, ld)
  bf16* vs = ks + kStages * kTcKeys * ld;
  float* delta_s = reinterpret_cast<float*>(vs + kStages * kTcKeys * ld);  // (kTcRows)

  const int n_row_tiles = (s + kTcRows - 1) / kTcRows;
  const int slice = blockIdx.x / n_row_tiles;
  const int row0 = (blockIdx.x - slice * n_row_tiles) * kTcRows;
  const size_t base = size_t(slice) * s * d;
  const size_t stat = size_t(slice) * s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = row0 + 16 * warp;
  const bool active = wrow < s;
  const int n_tiles = (s + kTcKeys - 1) / kTcKeys;
  const RowCopier copier(d);

  auto fetch = [&](int jt) {
    if (jt < n_tiles) {
      const int key1 = jt * kTcKeys, rows = 16 * live_steps(key1, s, kNS);
      const int st = (jt % kStages) * kTcKeys * ld;
      copier.rows<ld>(k + base, ks + st, key1, rows, s, d);
      copier.rows<ld>(v + base, vs + st, key1, rows, s, d);
    }
    cp_async_commit();
  };
  zero_pad<kD>(qs, 2 * kTcRows + 2 * kStages * kTcKeys, d);
  copier.rows<ld>(q + base, qs, row0, kTcRows, s, d);
  copier.rows<ld>(dout + base, dos, row0, kTcRows, s, d);
  for (int jt = 0; jt < kStages - 1; ++jt) fetch(jt);

  // delta = rowsum(dO o O) for the warp's rows, a lane every 32nd column
  for (int r = 0; r < 16; ++r) {
    const int i = wrow + r;
    float part = 0.f;
    if (i < s)
      for (int c = lane; c < d; c += 32)
        part = fmaf(__bfloat162float(dout[base + size_t(i) * d + c]),
                    __bfloat162float(o[base + size_t(i) * d + c]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      delta_s[16 * warp + r] = part;
      if (i < s) delta[stat + i] = part;
    }
  }
  __syncwarp();
  const int i0 = wrow + g, i1 = wrow + g + 8;
  const float dl[2] = {delta_s[16 * warp + g], delta_s[16 * warp + g + 8]};
  const float ll[2] = {i0 < s ? lse[stat + i0] * kLog2e : 0.f,
                       i1 < s ? lse[stat + i1] * kLog2e : 0.f};

  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* qw = qs + 16 * warp * ld;
  const bf16* dow = dos + 16 * warp * ld;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(j + kStages - 1);
    if (!active) continue;
    const bf16* kt = ks + (j % kStages) * kTcKeys * ld;
    const bf16* vt = vs + (j % kStages) * kTcKeys * ld;
    const int key0 = j * kTcKeys;
    if (key0 + kTcKeys <= s)
      dq_tile<kD, true>(qw, dow, kt, vt, key0, s, kNS, lane, ll, dl, acc);
    else
      dq_tile<kD, false>(qw, dow, kt, vt, key0, s, live_steps(key0, s, kNS), lane, ll, dl, acc);
  }
  if (!active) return;

#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= d) break;
    if (i0 < s)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + size_t(i0) * d + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (i1 < s)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + size_t(i1) * d + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// One query tile of kM rows for a warp's 16 keys (kw, vw: their K and V rows
// in shared memory; lt, dlt: the tile's lse and delta): S^T = K Q^T, dP^T =
// V dO^T, P^T and dS^T rounded to bf16 in registers, dV += P^T dO, dK +=
// dS^T Q.
template <int kD, int kM, bool kFull>
__device__ __forceinline__ void dkv_tile(const bf16* kw, const bf16* vw, const bf16* qt,
                                         const bf16* dot, const float* lt, const float* dlt,
                                         int row0, int s, int ns, int lane,
                                         float (&adk)[kD / 8][4], float (&adv)[kD / 8][4]) {
  constexpr int kNK = kD / 16, kNO = kD / 8, kNS = kM / 16, ld = kD + 8;
  const int steps = kFull ? kNS : ns;
  const int t = lane & 3;

  float sc[2 * kNS][4], dpv[2 * kNS][4];
#pragma unroll
  for (int n = 0; n < 2 * kNS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = dpv[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    uint32_t ak[4], av[4];
    ldsm_x4(ak, a_frag<ld>(kw, 0, 16 * kk, lane));
    ldsm_x4(av, a_frag<ld>(vw, 0, 16 * kk, lane));
#pragma unroll
    for (int p = 0; p < kNS; ++p) {
      if (p >= steps) break;
      uint32_t b[4];
      ldsm_x4(b, b_frag<ld>(qt, 16 * p, 16 * kk, lane));
      mma16816(sc[2 * p], ak, b[0], b[1]);
      mma16816(sc[2 * p + 1], ak, b[2], b[3]);
      ldsm_x4(b, b_frag<ld>(dot, 16 * p, 16 * kk, lane));
      mma16816(dpv[2 * p], av, b[0], b[1]);
      mma16816(dpv[2 * p + 1], av, b[2], b[3]);
    }
  }

  // the columns are query rows, each with its own lse and delta
  uint32_t pf[kNS][4], dsf[kNS][4];
#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
    float ep[2][4], es[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 8 * (2 * p + h) + 2 * t;  // this lane's first column
      const float2 lc = *reinterpret_cast<const float2*>(lt + c);
      const float2 dc = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * p + h;
        const bool live = kFull || row0 + c + (i & 1) < s;
        const float pr = live ? exp2f((sc[n][i] - ((i & 1) ? lc.y : lc.x)) * kLog2e) : 0.f;
        ep[h][i] = pr;
        es[h][i] = pr * (dpv[n][i] - ((i & 1) ? dc.y : dc.x));
      }
    }
    pf[p][0] = pack_bf16(ep[0][0], ep[0][1]);
    pf[p][1] = pack_bf16(ep[0][2], ep[0][3]);
    pf[p][2] = pack_bf16(ep[1][0], ep[1][1]);
    pf[p][3] = pack_bf16(ep[1][2], ep[1][3]);
    dsf[p][0] = pack_bf16(es[0][0], es[0][1]);
    dsf[p][1] = pack_bf16(es[0][2], es[0][3]);
    dsf[p][2] = pack_bf16(es[1][0], es[1][1]);
    dsf[p][3] = pack_bf16(es[1][2], es[1][3]);
  }

#pragma unroll
  for (int p = 0; p < kNS; ++p) {
    if (p >= steps) break;
#pragma unroll
    for (int np = 0; np < kNO / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, bt_frag<ld>(dot, 16 * p, 16 * np, lane));
      mma16816(adv[2 * np], pf[p], b[0], b[1]);
      mma16816(adv[2 * np + 1], pf[p], b[2], b[3]);
      ldsm_x4_trans(b, bt_frag<ld>(qt, 16 * p, 16 * np, lane));
      mma16816(adk[2 * np], dsf[p], b[0], b[1]);
      mma16816(adk[2 * np + 1], dsf[p], b[2], b[3]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
long_attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int d) {
  constexpr int kNO = kD / 8, kM = kTcQRows, kNS = kM / 16, ld = kD + 8;
  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);  // (kTcRows, ld)
  bf16* vs = ks + kTcRows * ld;                 // (kTcRows, ld)
  bf16* qs = vs + kTcRows * ld;                 // kStages stages of (kM, ld)
  bf16* dos = qs + kStages * kM * ld;
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kM * ld);  // stages of kM
  float* delta_s = lse_s + kStages * kM;

  const int n_key_tiles = (s + kTcRows - 1) / kTcRows;
  const int slice = blockIdx.x / n_key_tiles;
  const int key0 = (blockIdx.x - slice * n_key_tiles) * kTcRows;
  const size_t base = size_t(slice) * s * d;
  const size_t stat = size_t(slice) * s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = key0 + 16 * warp;
  const bool active = wkey < s;
  const int n_tiles = (s + kM - 1) / kM;
  const RowCopier copier(d);

  // query tile jt of Q, dO and their rows' lse and delta into its stage
  auto fetch = [&](int jt) {
    if (jt < n_tiles) {
      const int r1 = jt * kM, rows = 16 * live_steps(r1, s, kNS);
      const int st = jt % kStages;
      copier.rows<ld>(q + base, qs + st * kM * ld, r1, rows, s, d);
      copier.rows<ld>(dout + base, dos + st * kM * ld, r1, rows, s, d);
      load_stat(lse + stat, lse_s + st * kM, r1, kM, s);
      load_stat(delta + stat, delta_s + st * kM, r1, kM, s);
    }
    cp_async_commit();
  };
  zero_pad<kD>(ks, 2 * kTcRows + 2 * kStages * kM, d);
  copier.rows<ld>(k + base, ks, key0, kTcRows, s, d);
  copier.rows<ld>(v + base, vs, key0, kTcRows, s, d);
  for (int jt = 0; jt < kStages - 1; ++jt) fetch(jt);

  float adk[kNO][4], adv[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) adk[n][i] = adv[n][i] = 0.f;
  const bf16* kw = ks + 16 * warp * ld;
  const bf16* vw = vs + 16 * warp * ld;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(j + kStages - 1);
    if (!active) continue;
    const int st = j % kStages, row0 = j * kM;
    const bf16* qt = qs + st * kM * ld;
    const bf16* dot = dos + st * kM * ld;
    if (row0 + kM <= s)
      dkv_tile<kD, kM, true>(kw, vw, qt, dot, lse_s + st * kM, delta_s + st * kM, row0, s,
                             kNS, lane, adk, adv);
    else
      dkv_tile<kD, kM, false>(kw, vw, qt, dot, lse_s + st * kM, delta_s + st * kM, row0, s,
                              live_steps(row0, s, kNS), lane, adk, adv);
  }
  if (!active) return;

  const int i0 = wkey + g, i1 = wkey + g + 8;
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= d) break;
    if (i0 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dv + base + size_t(i0) * d + col) =
          __floats2bfloat162_rn(adv[n][0], adv[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + base + size_t(i0) * d + col) =
          __floats2bfloat162_rn(adk[n][0], adk[n][1]);
    }
    if (i1 < s) {
      *reinterpret_cast<__nv_bfloat162*>(dv + base + size_t(i1) * d + col) =
          __floats2bfloat162_rn(adv[n][2], adv[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dk + base + size_t(i1) * d + col) =
          __floats2bfloat162_rn(adk[n][2], adk[n][3]);
    }
  }
}

template <int kD>
size_t tc_smem_bytes(int bf16_rows, int float_rows) {
  return size_t(bf16_rows) * (kD + 8) * sizeof(bf16) + size_t(float_rows) * sizeof(float);
}

template <int kD>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                          int bh, int s, int d, cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes<kD>(kTcRows + 2 * kStages * kTcKeys, 0);
  auto kernel = long_attention_fwd_tc_kernel<kD>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((s + kTcRows - 1) / kTcRows);
  kernel<<<blocks, kTcThreads, bytes, stream>>>(static_cast<const bf16*>(q),
                                                static_cast<const bf16*>(k),
                                                static_cast<const bf16*>(v),
                                                static_cast<bf16*>(o), lse, s, d);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                          const void* o, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int bh, int s, int d, cudaStream_t stream) {
  constexpr int kM = kTcQRows;
  auto dq_kernel = long_attention_bwd_dq_tc_kernel<kD>;
  auto dkv_kernel = long_attention_bwd_dkv_tc_kernel<kD>;
  const size_t dq_bytes = tc_smem_bytes<kD>(2 * kTcRows + 2 * kStages * kTcKeys, kTcRows);
  const size_t dkv_bytes = tc_smem_bytes<kD>(2 * kTcRows + 2 * kStages * kM, 2 * kStages * kM);
  cudaError_t err = allow_smem(dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(dkv_kernel, dkv_bytes);
  if (err != cudaSuccess) return err;
  const int blocks = bh * ((s + kTcRows - 1) / kTcRows);
  dq_kernel<<<blocks, kTcThreads, dq_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(o), lse,
      static_cast<bf16*>(dq), delta, s, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: delta is complete before the second kernel reads it
  dkv_kernel<<<blocks, kTcThreads, dkv_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, d);
  return cudaGetLastError();
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || s <= 0 || d <= 0 || d > kMaxD || d % 8 != 0;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; q, k, v
// and dout 16-byte aligned). q, k, v, o: (BH, S, D) contiguous; lse: (BH, S)
// float32, written. Returns a cudaError_t (0 on success); argument errors
// return cudaErrorInvalidValue without launching.
extern "C" int long_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int s, int d, int dtype, void* stream) {
  if (bad_shape(bh, s, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return d <= 64 ? launch_fwd<1>(q, k, v, o, l, bh, s, d, st)
                   : launch_fwd<2>(q, k, v, o, l, bh, s, d, st);
  }
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v))) return cudaErrorInvalidValue;
    return d <= 64   ? launch_fwd_tc<64>(q, k, v, o, l, bh, s, d, st)
           : d <= 96 ? launch_fwd_tc<96>(q, k, v, o, l, bh, s, d, st)
                     : launch_fwd_tc<128>(q, k, v, o, l, bh, s, d, st);
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
    return d <= 64 ? launch_bwd<1>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st)
                   : launch_bwd<2>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st);
  }
  if (dtype == 1) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout)))
      return cudaErrorInvalidValue;
    return d <= 64   ? launch_bwd_tc<64>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st)
           : d <= 96 ? launch_bwd_tc<96>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st)
                     : launch_bwd_tc<128>(q, k, v, dout, o, l, dl, dq, dk, dv, bh, s, d, st);
  }
  return cudaErrorInvalidValue;
}
