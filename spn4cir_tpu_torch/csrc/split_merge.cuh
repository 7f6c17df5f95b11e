// The second launch of the split-bank InfoNCE kernels (bank_infonce.cu and
// max_query_infonce.cu): a first kernel splits the bank axis across CTAs and
// writes per-split partials; these combine them in split index order, so
// every sum has a fixed order and a relaunch gives the same bits.
//
//   - merge_kernel: one block; per row, the online-softmax partials
//     (mx, se, pos, el) of the splits merged in index order; then the loss
//     mean_b(log se + mx - pos) and dtau_unit mean_b((pos - el/se) / tau)
//     by a tree reduction over the rows;
//   - dq_reduce_kernel: dq = Σ_split dq_part[split], splits in index order.
//
// `Tag` is an empty type of the including file, so that each kernel family
// keeps kernels of its own name in a profiler trace.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace split_merge {

constexpr int kThreads = 256;

// Merge two online-softmax partials (m, s, e) <- (m, s, e) + (om, os, oe).
__device__ __forceinline__ void merge_stats(float& m, float& s, float& e, float om, float os,
                                            float oe) {
  const float nm = fmaxf(m, om);
  if (nm == -CUDART_INF_F) return;  // both sides empty
  const float sa = expf(m - nm), sb = expf(om - nm);
  s = s * sa + os * sb;
  e = e * sa + oe * sb;
  m = nm;
}

// part: (n_splits, B) float4 (mx, se, pos, el); out2 = (loss, dtau_unit).
template <typename Tag>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float4* __restrict__ part, int n_splits, int B, float tau,
             float* __restrict__ mx, float* __restrict__ se, float* __restrict__ pos,
             float* __restrict__ el, float* __restrict__ out2) {
  __shared__ float s_loss[kThreads];
  __shared__ float s_dtau[kThreads];
  const int tid = threadIdx.x;
  float loss = 0.f, dtau = 0.f;
  for (int row = tid; row < B; row += kThreads) {
    float m = -CUDART_INF_F, s = 0.f, e = 0.f, p = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float4 v = part[size_t(sp) * B + row];
      merge_stats(m, s, e, v.x, v.y, v.w);
      p += v.z;
    }
    mx[row] = m;
    se[row] = s;
    pos[row] = p;
    el[row] = e;
    loss += logf(s) + m - p;
    dtau += (p - e / s) / tau;
  }
  s_loss[tid] = loss;
  s_dtau[tid] = dtau;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
      s_loss[tid] += s_loss[tid + half];
      s_dtau[tid] += s_dtau[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out2[0] = s_loss[0] / float(B);
    out2[1] = s_dtau[0] / float(B);
  }
}

// part: (n_splits, n4) float4; dq: (n4,) float4.
template <typename Tag>
__global__ void __launch_bounds__(kThreads)
dq_reduce_kernel(const float4* __restrict__ part, int n_splits, int n4,
                 float4* __restrict__ dq) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int sp = 1; sp < n_splits; ++sp) {
    const float4 v = part[size_t(sp) * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dq[i] = s;
}

template <typename Tag>
cudaError_t launch_merge(const void* part, int n_splits, int B, float tau, void* mx, void* se,
                         void* pos, void* el, void* out2, cudaStream_t st) {
  merge_kernel<Tag><<<1, kThreads, 0, st>>>(
      static_cast<const float4*>(part), n_splits, B, tau, static_cast<float*>(mx),
      static_cast<float*>(se), static_cast<float*>(pos), static_cast<float*>(el),
      static_cast<float*>(out2));
  return cudaGetLastError();
}

// dq_part: (n_splits, B, D) float32; dq: (B, D) float32; D % 4 == 0.
template <typename Tag>
cudaError_t launch_dq_reduce(const void* dq_part, int n_splits, int B, int D, void* dq,
                             cudaStream_t st) {
  const int n4 = B * D / 4;
  dq_reduce_kernel<Tag><<<(n4 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float4*>(dq_part), n_splits, n4, static_cast<float4*>(dq));
  return cudaGetLastError();
}

}  // namespace split_merge
