// The gated delta rule of Kimi Delta Attention (KDA) for Hopper (sm_90a),
// kernel #15: one (sequence, head) a block, its float32 state S (d_k x d_v)
// carried over the tokens,
//
//     k̂ = k / ‖k‖          q̂ = q / ‖q‖ · d_k^-½         α = exp(g)
//     S ← Diag(α) S
//     S ← S + β k̂ (v − Sᵀk̂)ᵀ
//     o = Sᵀq̂
//
// with ‖x‖ = (Σ x² + 1e-6)^½, g the per-channel log decay (≤ 0), β one value
// a head and token. Two entries: `kda_decode` reads each S once, takes one
// token and writes S back once, in place; `kda_prefill` starts from S = 0,
// keeps S on chip over all the prompt's tokens and writes the final S once.
//
// It replaces no Pallas kernel: the JAX package has no linear attention.
// Without it a decode step of one KDA layer at batch 256 is about ten
// passes of tensor code over 0.54 GB of float32 state.
//
// What bounds it: at a decode step the state's bytes (64 KB a head read and
// written, against 7 flops an element); in the prefill the token inputs'
// bytes (q, k, g, v in float32, 2 KB a head and token) and, close behind,
// the instruction issue of the per-token arithmetic. So:
//   - S never leaves the chip between the tokens of a launch: thread j of a
//     block holds column j of S (128 floats) in registers, and every term
//     of the rule is computed column by column. With a = α_i S_ij,
//         u_j = ‖k‖⁻¹ Σ_i a_ij k_i        d_j = β (v_j − u_j)
//         S'_ij = a_ij + ‖k‖⁻¹ k_i d_j
//         o_j = rq Σ_i a_ij q_i + d_j ‖k‖⁻¹ rq (k·q)       rq = ‖q‖⁻¹ d_k^-½
//     so no sum crosses threads but the three norms, which each warp takes
//     by shuffles: one pass over the registers for u and o's first term,
//     one for the update, no barrier between them;
//   - a column of S is read by one thread, row by row, so each warp's load
//     or store of a row is one 128-byte transaction; the decode step's grid
//     of B x H blocks keeps 128 loads a thread in flight. The column takes
//     128 of a thread's registers, so a block of 128 threads runs at two
//     blocks an SM (at three, the 168-register cap spilled 186 values of
//     the column to local memory);
//   - in the prefill the next token's q, k, g, v and β are copied into the
//     other half of a double buffer in shared memory (`cp.async`) while the
//     block works on this one: one barrier a token. Each warp turns g into
//     α in a buffer of its own (4 `exp` a lane).
// No atomics: each output is one thread's sums in a fixed order, so a
// relaunch gives the same bits.

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_sync.cuh"

namespace {

constexpr int kD = 128;                 // d_k = d_v
constexpr int kThreads = kD;            // a thread a column of S
constexpr int kWarps = kThreads / 32;
constexpr float kNormEps = 1e-6f;

// one token's inputs: k, q, g and v of one head, then β
struct __align__(16) Token {
  float vec[4][kD];
  float beta;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Block (h, b): the `tokens` tokens of head h of sequence b. q, k, g, v (B,
// T, H, 128) and beta (B, T, H) float32, contiguous; o (B, T, H, 128); state
// (B, H, 128, 128), read when `load` (else S starts at 0) and written once
// at the end.
__device__ __forceinline__ void recur(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v, const float* __restrict__ g,
                                      const float* __restrict__ beta, float* state,
                                      float* __restrict__ o, int tokens, int heads, float scale,
                                      bool load) {
  __shared__ Token buf[2];
  __shared__ __align__(16) float alpha[kWarps][kD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  const long long first = static_cast<long long>(b) * tokens * heads + h;   // (b, 0, h)
  float* col = state + (static_cast<long long>(b) * heads + h) * kD * kD + j;

  // warp w copies array w (k, q, g, v) of token t, 16 bytes a lane
  auto fetch = [&](int t, int slot) {
    const long long row = first + static_cast<long long>(t) * heads;
    const float* src = warp == 0 ? k : warp == 1 ? q : warp == 2 ? g : v;
    mma_sync::cp_async16(&buf[slot].vec[warp][lane * 4], src + row * kD + lane * 4, true);
    if (j == 0) mma_sync::cp_async4(&buf[slot].beta, beta + row, true);
    mma_sync::cp_async_commit();
  };

  fetch(0, 0);
  float s[kD];
  if (load) {
#pragma unroll
    for (int i = 0; i < kD; ++i) s[i] = col[i * kD];
  } else {
#pragma unroll
    for (int i = 0; i < kD; ++i) s[i] = 0.f;
  }

  for (int t = 0; t < tokens; ++t) {
    const int slot = t & 1;
    mma_sync::cp_async_wait<0>();
    __syncthreads();  // token t is in; every thread is done with token t - 1
    if (t + 1 < tokens) fetch(t + 1, slot ^ 1);
    const Token& in = buf[slot];
    const float4* k4 = reinterpret_cast<const float4*>(in.vec[0]);
    const float4* q4 = reinterpret_cast<const float4*>(in.vec[1]);
    const float4 gl = reinterpret_cast<const float4*>(in.vec[2])[lane];
    reinterpret_cast<float4*>(alpha[warp])[lane] =
        make_float4(expf(gl.x), expf(gl.y), expf(gl.z), expf(gl.w));
    const float4 kl = k4[lane], ql = q4[lane];
    const float rk = rsqrtf(warp_sum(dot4(kl, kl)) + kNormEps);
    const float rq = rsqrtf(warp_sum(dot4(ql, ql)) + kNormEps) * scale;
    const float kq = warp_sum(dot4(kl, ql));
    __syncwarp();

    const float4* a4 = reinterpret_cast<const float4*>(alpha[warp]);
    float u0 = 0.f, u1 = 0.f, p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int i = 0; i < kD; i += 4) {
      const float4 a = a4[i / 4], kv = k4[i / 4], qv = q4[i / 4];
      s[i] *= a.x;
      s[i + 1] *= a.y;
      s[i + 2] *= a.z;
      s[i + 3] *= a.w;
      u0 = fmaf(s[i], kv.x, u0);
      u1 = fmaf(s[i + 1], kv.y, u1);
      p0 = fmaf(s[i], qv.x, p0);
      p1 = fmaf(s[i + 1], qv.y, p1);
      u0 = fmaf(s[i + 2], kv.z, u0);
      u1 = fmaf(s[i + 3], kv.w, u1);
      p0 = fmaf(s[i + 2], qv.z, p0);
      p1 = fmaf(s[i + 3], qv.w, p1);
    }
    const float d = in.beta * (in.vec[3][j] - (u0 + u1) * rk);
    const float dk = d * rk;
#pragma unroll
    for (int i = 0; i < kD; i += 4) {
      const float4 kv = k4[i / 4];
      s[i] = fmaf(kv.x, dk, s[i]);
      s[i + 1] = fmaf(kv.y, dk, s[i + 1]);
      s[i + 2] = fmaf(kv.z, dk, s[i + 2]);
      s[i + 3] = fmaf(kv.w, dk, s[i + 3]);
    }
    o[(first + static_cast<long long>(t) * heads) * kD + j] = (p0 + p1) * rq + dk * rq * kq;
  }

#pragma unroll
  for (int i = 0; i < kD; ++i) col[i * kD] = s[i];
}

__global__ void __launch_bounds__(kThreads, 2)
    kda_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ beta, float* state, float* __restrict__ o,
                      int heads, float scale) {
  recur(q, k, v, g, beta, state, o, 1, heads, scale, true);
}

__global__ void __launch_bounds__(kThreads, 2)
    kda_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ beta, float* state, float* __restrict__ o,
                       int tokens, int heads, float scale) {
  recur(q, k, v, g, beta, state, o, tokens, heads, scale, false);
}

bool bad_shape(int batch, int tokens, int heads, int dim) {
  return batch < 1 || batch > 65535 || tokens < 1 || heads < 1 || dim != kD;
}

}  // namespace

// q, k, v, g (B, 1, H, 128) and beta (B, 1, H) float32, contiguous and
// 16-byte aligned; state (B, H, 128, 128) float32, updated in place; o (B,
// 1, H, 128) float32 out. One launch on `stream`.
extern "C" int kda_decode(const float* q, const float* k, const float* v, const float* g,
                          const float* beta, float* state, float* o, int batch, int heads,
                          int dim, float scale, void* stream) {
  if (bad_shape(batch, 1, heads, dim)) return int(cudaErrorInvalidValue);
  kda_decode_kernel<<<dim3(heads, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, g, beta, state, o, heads, scale);
  return int(cudaGetLastError());
}

// q, k, v, g (B, T, H, 128) and beta (B, T, H) float32, contiguous and
// 16-byte aligned; the recurrence from S = 0 over the T tokens; state (B,
// H, 128, 128) float32 receives the final S; o (B, T, H, 128) float32 out.
// One launch on `stream`.
extern "C" int kda_prefill(const float* q, const float* k, const float* v, const float* g,
                           const float* beta, float* state, float* o, int batch, int tokens,
                           int heads, int dim, float scale, void* stream) {
  if (bad_shape(batch, tokens, heads, dim)) return int(cudaErrorInvalidValue);
  kda_prefill_kernel<<<dim3(heads, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, g, beta, state, o, tokens, heads, scale);
  return int(cudaGetLastError());
}
