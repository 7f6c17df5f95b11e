// Variants of the tensor-core bank InfoNCE forward (`bank_infonce_fwd_tc_kernel`
// in spn4cir_tpu_torch/csrc/bank_infonce.cu), for measuring tuning levers
// against it; built and timed by bank_fwd_levers.py, never by the package.
// The source is included whole, so every helper is the package's own, and
// each variant gets entry points of its own with the forwards' signatures.
// VAR_STAGES: ring stages over bf16 / int8 banks (float32 keeps 3: four
// would hold one CTA an SM). VAR_MODE: 0 the A split per fragment, as the
// package does; 1 Q split into TF32 hi / lo once per launch, into global
// scratch (bf16 / int8 only; float32 takes mode 0: two A tiles a stage
// would hold one CTA an SM); 2 the A tile split once per chunk in shared
// memory, hi in place and lo beside it, one more barrier a chunk (every
// bank type). Every variant forms the same logits bit for bit.
#include "bank_infonce.cu"

#ifndef VAR_STAGES
#define VAR_STAGES 3
#endif
#ifndef VAR_MODE
#define VAR_MODE 0
#endif

namespace {

template <typename T>
__host__ __device__ constexpr int var_stages() {
  return sizeof(T) < 4 ? VAR_STAGES : 3;
}
template <typename T> __host__ __device__ constexpr int var_mode() {
  return (VAR_MODE == 1 && sizeof(T) == 4) ? 0 : VAR_MODE;
}

template <typename T>
__host__ __device__ constexpr size_t var_a_floats() {  // A floats a stage (two tiles in mode 1)
  return size_t(kTcRows) * kTcLdA * (var_mode<T>() == 1 ? 2 : 1);
}
template <typename T>
constexpr size_t var_smem_bytes() {
  return size_t(var_stages<T>()) * (var_a_floats<T>() * 4 + kTcCols * coef_ld_bank<T>() * sizeof(T)) +
         (var_mode<T>() == 2 ? kTcRows * kTcLdA * 4 : 0) + size_t(kFwdStats) * kTcThreads * 4 +
         4 * kTcRows * 16 + kTcRows * 4;
}

__global__ void split_q_kernel(const float* __restrict__ q, float* __restrict__ qh,
                               float* __restrict__ ql, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t h, l;
    split_tf32(q[i], h, l);
    qh[i] = __uint_as_float(h);
    ql[i] = __uint_as_float(l);
  }
}

template <bool kExactB>
__device__ __forceinline__ void mma_step_presplit(float (&part)[2][4][4], const uint32_t (&ah)[2][4],
                                                  const uint32_t (&al)[2][4],
                                                  const float (&bv)[4][2]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    uint32_t bh[2], bl[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kExactB)
        bh[j] = __float_as_uint(bv[ni][j]);
      else
        split_tf32(bv[ni][j], bh[j], bl[j]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma1688_tf32(part[mi][ni], al[mi], bh[0], bh[1]);
      if (!kExactB) mma1688_tf32(part[mi][ni], ah[mi], bl[0], bl[1]);
      mma1688_tf32(part[mi][ni], ah[mi], bh[0], bh[1]);
    }
  }
}

__device__ __forceinline__ void a_bits(uint32_t (&r2)[2][4], const float* a, int row0, int k8,
                                       int lane) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(r2[mi], a + (row0 + 16 * mi + (lane & 7) + ((lane >> 3) & 1) * 8) * kTcLdA + k8 +
                        (lane >> 4) * 4);
}

template <typename T>
__device__ __forceinline__ void b_frags(float (&bv)[4][2], const T* b, int wn, int k8, int lane) {
  constexpr int kLdB = coef_ld_bank<T>();
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, reinterpret_cast<const float*>(b) +
                     (wn + 16 * np + (lane & 7) + (lane >> 4) * 8) * kLdB + k8 +
                     ((lane >> 3) & 1) * 4);
      bv[2 * np][0] = __uint_as_float(r[0]);
      bv[2 * np][1] = __uint_as_float(r[1]);
      bv[2 * np + 1][0] = __uint_as_float(r[2]);
      bv[2 * np + 1][1] = __uint_as_float(r[3]);
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const T* br = b + (wn + 8 * ni + g) * kLdB + k8 + t;
      bv[ni][0] = to_float(br[0]);
      bv[ni][1] = to_float(br[4]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
fwd_var_kernel(const float* __restrict__ q, const float* __restrict__ qh,
               const float* __restrict__ ql, const T* __restrict__ bank,
               const float* __restrict__ scales, const int* __restrict__ labels, float tau, int B,
               int M, int D, int tiles_per_split, float4* __restrict__ part) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kS = var_stages<T>();
  constexpr int kMode = var_mode<T>();
  constexpr int kLdB = coef_ld_bank<T>();
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kCopiesB = kTcDepth / kPer;
  constexpr int kAStage = int(var_a_floats<T>());
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  T* Bs = reinterpret_cast<T*>(As + kS * kAStage);
  float* lo_buf = reinterpret_cast<float*>(Bs + kS * kTcCols * kLdB);
  float* stats = lo_buf + (kMode == 2 ? kTcRows * kTcLdA : 0);
  float4* red = reinterpret_cast<float4*>(stats + kFwdStats * kTcThreads);
  int* lab_s = reinterpret_cast<int*>(red + 4 * kTcRows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp >> 2), wn = 32 * (warp & 3);
  const int row0 = blockIdx.x * kTcRows;
  const int n_tiles = (M + kTcCols - 1) / kTcCols;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);
  const int n_chunks = (D + kTcDepth - 1) / kTcDepth;
  const int n_ring = (tile_end - tile_begin) * n_chunks;

  auto fetch = [&](int kc) {
    if (kc < n_ring) {
      const int st = kc % kS, k0 = (kc % n_chunks) * kTcDepth;
      const int col0 = (tile_begin + kc / n_chunks) * kTcCols;
      float* a = As + st * kAStage;
      T* b = Bs + st * kTcCols * kLdB;
      for (int i = tid; i < kTcRows * (kTcDepth / 4); i += kTcThreads) {
        const int r = i / (kTcDepth / 4), c = (i % (kTcDepth / 4)) * 4;
        const bool valid = row0 + r < B && k0 + c < D;
        const size_t off = valid ? size_t(row0 + r) * D + k0 + c : 0;
        if (kMode == 1) {
          cp_async16(a + r * kTcLdA + c, qh + off, valid);
          cp_async16(a + kTcRows * kTcLdA + r * kTcLdA + c, ql + off, valid);
        } else {
          cp_async16(a + r * kTcLdA + c, q + off, valid);
        }
      }
      for (int i = tid; i < kTcCols * kCopiesB; i += kTcThreads) {
        const int r = i / kCopiesB, c = (i % kCopiesB) * kPer;
        const bool valid = col0 + r < M && k0 + c < D;
        cp_async16(b + r * kLdB + c, bank + (valid ? size_t(col0 + r) * D + k0 + c : 0), valid);
      }
    }
    cp_async_commit();
  };
  for (int kc = 0; kc < kS - 1; ++kc) fetch(kc);

  if (tid < kTcRows) lab_s[tid] = row0 + tid < B ? labels[row0 + tid] : -1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    stats[(4 * r + 0) * kTcThreads + tid] = -CUDART_INF_F;
#pragma unroll
    for (int k = 1; k < 4; ++k) stats[(4 * r + k) * kTcThreads + tid] = 0.f;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    float acc[2][4][4];
    zero_tile(acc);
    const int kc0 = (tile - tile_begin) * n_chunks;
    for (int kc = kc0; kc < kc0 + n_chunks; ++kc) {
      cp_async_wait<kS - 2>();
      __syncthreads();
      fetch(kc + kS - 1);
      float* a = As + (kc % kS) * kAStage;
      const T* b = Bs + (kc % kS) * kTcCols * kLdB;
      if (kMode == 2) {  // split the A tile once: hi in place, lo beside
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = tid + kTcThreads * j;
          const int r = i >> 3, c = (i & 7) * 4;
          float4 v = *reinterpret_cast<const float4*>(a + r * kTcLdA + c);
          uint32_t h[4], l[4];
          split_tf32(v.x, h[0], l[0]);
          split_tf32(v.y, h[1], l[1]);
          split_tf32(v.z, h[2], l[2]);
          split_tf32(v.w, h[3], l[3]);
          *reinterpret_cast<uint4*>(a + r * kTcLdA + c) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(lo_buf + r * kTcLdA + c) = make_uint4(l[0], l[1], l[2], l[3]);
        }
        __syncthreads();
      }
      float part[2][4][4];
      zero_tile(part);
#pragma unroll
      for (int k8 = 0; k8 < kTcDepth; k8 += 8) {
        float bv[4][2];
        b_frags<T>(bv, b, wn, k8, lane);
        if (kMode == 0) {
          float av[2][4];
          a_frags_tf32(av, a, wm, k8, lane);
          mma_step_3xtf32<(sizeof(T) < 4)>(part, av, bv);
        } else {
          uint32_t ah[2][4], al[2][4];
          a_bits(ah, a, wm, k8, lane);
          a_bits(al, kMode == 1 ? a + kTcRows * kTcLdA : lo_buf, wm, k8, lane);
          mma_step_presplit<(sizeof(T) < 4)>(part, ah, al, bv);
        }
      }
      add_tile(acc, part);
    }
    const int col0 = tile * kTcCols + wn + 2 * t;
    float sc[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[ni][e] = column_scale<kQuant>(scales, col0 + 8 * ni + e, M);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* rs = stats + 4 * (2 * mi + h) * kTcThreads + tid;
        const int lab = lab_s[wm + 16 * mi + 8 * h + g];
        float l[8];
        float tmax = -CUDART_INF_F, pos = rs[3 * kTcThreads];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * ni + e;
            float av = acc[mi][ni][2 * h + e];
            if (kQuant) av *= sc[ni][e];
            l[2 * ni + e] = av / tau;
            if (col < M) {
              tmax = fmaxf(tmax, l[2 * ni + e]);
              if (col == lab) pos += l[2 * ni + e];
            }
          }
        rs[3 * kTcThreads] = pos;
        if (tmax > -CUDART_INF_F) {
          const float m0 = rs[0];
          const float nm = fmaxf(m0, tmax);
          const float scale = expf(m0 - nm);
          float s = 0.f, el = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col0 + 8 * (j >> 1) + (j & 1) < M) {
              const float p = expf(l[j] - nm);
              s += p;
              el = fmaf(p, l[j], el);
            }
          }
          rs[0] = nm;
          rs[kTcThreads] = rs[kTcThreads] * scale + s;
          rs[2 * kTcThreads] = rs[2 * kTcThreads] * scale + el;
        }
      }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* rs = stats + 4 * r * kTcThreads + tid;
    float m = rs[0], s = rs[kTcThreads], e = rs[2 * kTcThreads], p = rs[3 * kTcThreads];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      const float oe = __shfl_xor_sync(0xffffffffu, e, off);
      const float op = __shfl_xor_sync(0xffffffffu, p, off);
      merge_stats(m, s, e, om, os, oe);
      p += op;
    }
    if (t == 0)
      red[(warp & 3) * kTcRows + wm + 16 * (r >> 1) + 8 * (r & 1) + g] = make_float4(m, s, p, e);
  }
  __syncthreads();
  if (tid < kTcRows && row0 + tid < B) {
    const float4 v = red[tid];
    float m = v.x, s = v.y, p = v.z, e = v.w;
#pragma unroll
    for (int wc = 1; wc < 4; ++wc) {
      const float4 o = red[wc * kTcRows + tid];
      merge_stats(m, s, e, o.x, o.y, o.w);
      p += o.z;
    }
    part[size_t(blockIdx.y) * B + row0 + tid] = make_float4(m, s, p, e);
  }
}

// mode 1's (2, B, D) scratch of Q's halves, grown on demand: this source
// only measures, so it allocates where the package's wrappers would
float* g_qsplit = nullptr;
size_t g_qsplit_n = 0;

template <typename T>
cudaError_t launch_var(const void* q, const void* bank, const void* scales, const void* labels,
                       float tau, int B, int M, int D, int tiles_per_split, int n_splits,
                       void* part, void* mx, void* se, void* pos, void* el, void* out2,
                       cudaStream_t st) {
  const float* qh = nullptr;
  const float* ql = nullptr;
  if (var_mode<T>() == 1) {
    const size_t n = size_t(B) * D;
    if (n > g_qsplit_n) {
      if (g_qsplit) cudaFree(g_qsplit);
      cudaMalloc(&g_qsplit, 2 * n * sizeof(float));
      g_qsplit_n = n;
    }
    split_q_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(q), g_qsplit,
                                                     g_qsplit + n, int(n));
    qh = g_qsplit;
    ql = g_qsplit + n;
  }
  auto kernel = fwd_var_kernel<T>;
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(var_smem_bytes<T>()));
  if (smem_err != cudaSuccess) return smem_err;
  kernel<<<dim3((B + kTcRows - 1) / kTcRows, n_splits), kTcThreads, var_smem_bytes<T>(), st>>>(
      static_cast<const float*>(q), qh, ql, static_cast<const T*>(bank),
      static_cast<const float*>(scales), static_cast<const int*>(labels), tau, B, M, D,
      tiles_per_split, static_cast<float4*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_merge<bank_infonce_split>(part, n_splits, B, tau, mx, se, pos, el,
                                                       out2, st);
}

}  // namespace

extern "C" int var_smem(int code) {
  return code == 0 ? int(var_smem_bytes<float>())
                   : (code == 1 ? int(var_smem_bytes<__nv_bfloat16>()) : int(var_smem_bytes<int8_t>()));
}

extern "C" int bank_infonce_fwd_var(const void* q, const void* bank, const void* labels, float tau,
                                    int B, int M, int D, int bank_dtype, int tiles_per_split,
                                    int n_splits, int tc_logits, void* part, void* mx, void* se,
                                    void* pos, void* el, void* out2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tc_logits) return cudaErrorInvalidValue;
  if (bank_dtype == 0)
    return launch_var<float>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split, n_splits,
                             part, mx, se, pos, el, out2, st);
  return launch_var<__nv_bfloat16>(q, bank, nullptr, labels, tau, B, M, D, tiles_per_split,
                                   n_splits, part, mx, se, pos, el, out2, st);
}

extern "C" int bank_infonce_q8_fwd_var(const void* q, const void* values, const void* scales,
                                       const void* labels, float tau, int B, int M, int D,
                                       int tiles_per_split, int n_splits, int tc_logits,
                                       void* part, void* mx, void* se, void* pos, void* el,
                                       void* out2, void* stream) {
  if (!tc_logits) return cudaErrorInvalidValue;
  return launch_var<int8_t>(q, values, scales, labels, tau, B, M, D, tiles_per_split, n_splits,
                            part, mx, se, pos, el, out2, static_cast<cudaStream_t>(stream));
}
