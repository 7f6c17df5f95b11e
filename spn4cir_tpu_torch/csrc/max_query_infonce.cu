// Max-over-query bank InfoNCE for Hopper (sm_90a): the BLIP-2 stage-2 loss's
// forward statistics and its backward dfeats, over a dense (M, Q, D) bank and
// over an int8 one with (M, Q) scales.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel` (reached through
// `_run_forward` and `_run_backward` of `max_query_infonce_pallas`) in
// spn4cir_tpu/ops/maxquery_kernels.py.
//
//     sims[b, m, q] = feats[b] · bank[m, q]             (int8: · s[m, q] too)
//     logits[b, m]  = max_q sims[b, m, q] / tau          (B, M)
//     route[b, m]   = q* = the FIRST q that reaches the max
//     forward : per row  mx = max_m logits, se = Σ_m exp(logits - mx),
//               pos = logits[label], el = Σ_m exp(logits - mx)·logits;
//               loss = mean_b(log se + mx - pos),
//               dtau_unit = mean_b((pos - el/se) / tau)
//     backward: dfeats[b] = Σ_m w[b, m] · bank[m, q*(b, m)],
//               w = (P - onehot(label)) · g  (int8: · s[m, q*]),
//               P = exp(logits - mx)/se from the saved (mx, se),
//               g = gout / (B·tau)
//
// int8: the scale multiplies the sim BEFORE the max and 1/tau follows, in the
// TPU kernel's order of roundings; the backward's weight carries the scale of
// the routed query and the product runs on the raw values. feats (B, D)
// float32; labels int32 (B,); B, M, Q >= 1, Q <= 32767; D % 32 == 0, D <= 512.
// Rows past B and bank rows past M are masked in the kernels: nothing is
// padded outside.
//
// What bounds them (B = 32, M = 65,536, Q = 32, D = 256). The forward reads
// the bank once, 2,147 / 1,074 / 545 MB over float32 / bf16 / int8 (with the
// scales), and writes 12.6 MB of residuals: 0.645 / 0.324 / 0.167 ms at
// 3.35 TB/s. Its products, 2·B·M·Q·D = 34.4 GFLOP, take three TF32 products
// over a float32 bank (0.208 ms at 495 TFLOP/s) and three bf16 ones over a
// bf16 or int8 bank (0.104 ms at 989), so the bytes bound every bank type.
// The backward reads the residuals, the distinct routed rows bank[m, q*]
// (about 64% of the bank at uniform routing) and their scales, and writes
// dfeats; its 2·B·M·D FMAs are 0.016 ms: its bound is the routed bytes,
// about 0.41 / 0.21 / 0.11 ms.
//
// Forward, `mq_fwd_tc_kernel`: tensor-core products over the bank as the
// (M·Q, D) matrix it is.
//   - grid = (32-row tiles of feats, splits of the m axis); a split is a run
//     of tiles of whole m's (256 // Q m's a tile, at Q = 32 eight; past
//     Q = 256 one m's rows take several tiles and the running max is carried
//     across them), so every max over q is complete inside one CTA
//     (`mq_plan` on the host);
//   - the CTA's 32 feats rows are split ONCE in shared memory, in fragment
//     order, so a k16 step reads a lane's A fragments as 16-byte loads: over
//     a float32 bank into TF32 hi + lo (m16n8k8; 64 KB at D = 256); over a
//     bf16 or int8 bank into three bf16 terms whose sum is the value
//     exactly (m16n8k16; 48 KB), the bank values being exact in bf16 (int8
//     widened by a byte permute into 128 + x and -128 - (x & 128));
//   - the bank tile (256 consecutive rows of (M·Q, D)) is streamed in 128-byte
//     row slices (32 / 64 / 128 deep over float32 / bf16 / int8) through a
//     three-stage `cp.async` ring that runs on across the split's tiles; the
//     16-byte chunks of a slice are XOR-swizzled by row, so a warp's B
//     fragments load without bank conflicts; the order of depth inside a
//     k16 step is permuted (lane t holds depths 4t..4t+3) so that a lane's
//     four B values are one load, and A is staged in the same order;
//   - 8 warps side by side over the tile's 256 columns, each a 32 x 32 warp
//     tile: three products a step either way (`mma_step_split`: lo·hi +
//     hi·lo + hi·hi in TF32; or lo, mid, hi times the bank in bf16), the
//     small terms first; each 32-deep block goes into a zeroed tile added
//     in float32 (the tensor cores' accumulation rounds toward zero). Over
//     bf16 and int8 banks the bf16 route is 6-11% faster than split TF32
//     (PERF.md's kernel table, row 9);
//   - epilogue, Q = 32: a warp's 32 columns are one m: the first argmax in
//     registers and two xor shuffles (only a strictly greater sim moves it;
//     a tie of values goes to the lower q); other Q: the tile's sims are
//     staged in the ring stage the tile has just finished with and scanned,
//     8 threads a row; then 1/tau, one online-softmax fold a (row, m) into
//     running (mx, se, el, pos), and, when asked, the logit and q* written as
//     residuals for the backward ((M, B) float32 and int16);
//   - at the end of a split the 8 slots of a row (warps, or scan threads)
//     merge in slot order and one float4 (mx, se, pos, el) per (split, row)
//     goes to scratch; split_merge.cuh's merge kernel combines the splits in
//     index order and writes the statistics, the loss and dtau_unit.
// Backward, `mq_routed_bwd_kernel`: a routed gather product over the
// forward's residuals; no sim is recomputed and feats is not read.
//   - grid = (splits of the m axis, 32-row tiles); a CTA walks its m's in
//     stages of 1-4 m's through a three-stage `cp.async` ring;
//   - per m, each warp reads the tile's 32 routed q* (one int16 a lane, loaded
//     a stage ahead), groups equal ones (`__match_any_sync`) and ranks the
//     distinct ones; only those rows bank[m, q*] are copied into the stage,
//     each once, warp w copying ranks w, w + 8, ... (one ballot each),
//     beside the tile's logits (and, int8, the routed scales);
//   - each warp owns 4 rows of dfeats, a lane 4 columns of every 128, in
//     registers; one lane a (m, row) pair forms w = (exp(l - mx)/se -
//     onehot)·g (·s), the warp takes it by shuffle, and dfeats[b] += w · row
//     in m order, as float32 FMAs;
//   - each split writes its partial dfeats to scratch and split_merge.cuh's
//     reduce sums the splits in index order.
// No atomics: every sum has a fixed order, so results are run-to-run
// identical for a given plan.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "mma_sync.cuh"
#include "split_merge.cuh"

namespace {

using namespace mma_sync;  // cp.async, the TF32 split and the split-TF32 step
using split_merge::merge_stats;
struct mq_split {};  // names the merge / reduce kernels

constexpr int kThreads = split_merge::kThreads;  // 8 warps
constexpr int kRows = 32;        // feats rows per CTA, both kernels
constexpr int kCols = 256;       // bank rows of (M·Q, D) per forward tile
constexpr int kSliceBytes = 128; // bytes of a bank row one ring stage holds
constexpr int kStageBytes = kCols * kSliceBytes;  // 32 KB: also the (kRows, kCols) sims
constexpr int kStages = 3;       // ring stages: two in flight while one is used
constexpr int kSlots = 8;        // per-row statistics slots merged at a split's end
constexpr int kMaxD = 512;
constexpr int kMaxJ = kMaxD / 128;  // float4 columns of every 128 a lane owns (backward)
constexpr int kMaxStageM = 4;    // m's per backward stage at most
constexpr int kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStageBytes == kRows * kCols * int(sizeof(float)), "sims fit one stage");
static_assert(size_t(kMaxD) * 256 + size_t(kStages) * kStageBytes <= kSmemLimit,
              "the widest D must fit");

// Running online-softmax statistics of one row.
struct Stats {
  float mx, se, el, pos;
};

__device__ __forceinline__ Stats empty_stats() { return Stats{-CUDART_INF_F, 0.f, 0.f, 0.f}; }

// Fold one logit l of the row into s.
__device__ __forceinline__ void fold(Stats& s, float l, bool is_label) {
  const float nm = fmaxf(s.mx, l);
  const float a = expf(s.mx - nm), p = expf(l - nm);
  s.se = s.se * a + p;
  s.el = s.el * a + p * l;
  s.mx = nm;
  if (is_label) s.pos += l;
}

// (best, arg) <- the first argmax of the two: the larger value, on a tie of
// values the lower index.
__device__ __forceinline__ void take_max(float& best, int& arg, float ob, int oa) {
  if (ob > best || (ob == best && oa < arg)) {
    best = ob;
    arg = oa;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The 16-byte chunk c of row r of a ring stage lies at chunk c ^ swz(r): the
// rows whose B loads share one shared-memory wavefront (2 over float32, 4
// over bf16, 8 over int8) land on disjoint banks.
template <typename T>
__device__ __forceinline__ int swz(int r) {
  return (r % (8 / int(sizeof(T)))) * int(sizeof(T));
}

// Four bank values (depths 4t..4t+3 of a k16 step) as float32; bf16 and int8
// widen exactly (int8 by a byte permute into 2^23 + 128 + x).
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4], float) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4], __nv_bfloat16) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(w.x << 16);
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const unsigned char* p, float (&v)[4], int8_t) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + i)) - 8388736.f;
}

// The forward's product route: over a bf16 or int8 bank the bank values are
// exact in bf16 and feats is split into three bf16 terms whose sum is it
// exactly, so three bf16 products (m16n8k16) give the float32 products; over
// a float32 bank split TF32 (m16n8k8, three products).
template <typename T>
constexpr bool kBf16Route = sizeof(T) < 4;

// 32-bit words of the CTA's split feats per unit of D: TF32 hi + lo, or
// three bf16 terms
template <typename T>
__host__ __device__ constexpr int feats_words() {
  return kBf16Route<T> ? 48 : 64;
}

// Two float32 values as three bf16 pairs, hi + mid + lo (low halves: x0):
// each term the round-to-nearest of what the earlier ones left, so the sum
// is x exactly for finite x in bf16's normal range; inf and NaN go whole
// into hi.
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float r0 = finite(x0) ? x0 - __uint_as_float(hi << 16) : 0.f;
  const float r1 = finite(x1) ? x1 - __uint_as_float(hi & 0xffff0000u) : 0.f;
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - __uint_as_float(mid << 16), r1 - __uint_as_float(mid & 0xffff0000u));
}

// Two int8 values of u (the bytes `sel` picks to bits 0-7 and 16-23) as a
// bf16 pair, exact: (byte & 0x7f) | 0x4300 is the bf16 128 + (byte & 127),
// (byte & 0x80) | 0xc300 is -128 - (byte & 128), and their sum is the int8.
__device__ __forceinline__ uint32_t int8_pair_bf16(uint32_t u, uint32_t sel) {
  const uint32_t t = __byte_perm(u, 0u, sel);
  const uint32_t mag = (t & 0x007f007fu) | 0x43004300u;
  const uint32_t off = (t & 0x00800080u) | 0xc300c300u;
  const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                                   *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Where a forward tile lies in the (M·Q, D) bank: rows [r0, r0 + n) are the
// m's [m0, m0 + nm) when Q <= 256 (tiles of kCols / Q whole m's), else the
// queries [q0, q0 + n) of m0 (ceil(Q / kCols) tiles an m; `last` ends it).
struct Tile {
  long long r0;
  int n, m0, nm, q0;
  bool last;
};

__device__ __forceinline__ Tile tile_at(int t, int M, int Q) {
  Tile tl;
  if (Q <= kCols) {
    const int mt = kCols / Q;
    tl.m0 = t * mt;
    tl.nm = min(mt, M - tl.m0);
    tl.q0 = 0;
    tl.n = tl.nm * Q;
    tl.last = true;
  } else {
    const int qt = (Q + kCols - 1) / kCols;
    tl.m0 = t / qt;
    tl.nm = 1;
    tl.q0 = (t % qt) * kCols;
    tl.n = min(kCols, Q - tl.q0);
    tl.last = t % qt == qt - 1;
  }
  tl.r0 = static_cast<long long>(tl.m0) * Q + tl.q0;
  return tl;
}

struct FwdArgs {
  const float* q;        // (B, D)
  const void* bank;      // (M, Q, D) float32 / bfloat16 / int8
  const float* scales;   // (M, Q) for int8, else null
  const int* labels;     // (B,)
  float tau;
  int B, M, Q, D, m_per_split;
  float4* part;          // (n_splits, B): (mx, se, pos, el)
  float* logits_t;       // (M, B) residual logits, or null
  int16_t* route_t;      // (M, B) residual q*, or null
};

// The CTA's feats rows [row0, row0 + 32) split into TF32 hi + lo, stored in
// m16n8k8 fragment order for the permuted depth of a k16 step kb: depth
// 16kb + 4t + 2s + e is lane t's register e (a0/a1, then a2/a3) of step s.
// Af[((kb * 2 + mi) * 4 + 2s + {0 hi, 1 lo}) * 32 + lane] is a lane's uint4
// a0..a3; rows past B are zeros.
__device__ __forceinline__ void stage_feats(const float* __restrict__ q, int row0, int B, int D,
                                            uint32_t* Af) {
  const int d4 = D / 4;
  for (int idx = threadIdx.x; idx < kRows * d4; idx += kThreads) {
    const int r = idx / d4, k = (idx % d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < B) v = *reinterpret_cast<const float4*>(q + size_t(row0 + r) * D + k);
    const float x[4] = {v.x, v.y, v.z, v.w};
    const int kb = k / 16, t = (k % 16) / 4, mi = r / 16, g = r % 8, hrow = (r % 16) / 8;
    const int lane = 4 * g + t;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // depth k + u: step s = u / 2, register hrow + 2e
      const int s = u / 2, e = u % 2;
      uint32_t hi, lo;
      split_tf32(x[u], hi, lo);
      uint32_t* base = Af + (((kb * 2 + mi) * 4 + 2 * s) * 32 + lane) * 4 + hrow + 2 * e;
      base[0] = hi;
      base[32 * 4] = lo;
    }
  }
}

// The same rows as three bf16 terms in m16n8k16 fragment order for the
// permuted depth of a k16 step kb: depths 16kb + 4t, +1 are lane t's a0 / a1
// (the logical 2t, 2t + 1), 16kb + 4t + 2, +3 its a2 / a3 (2t + 8, 2t + 9).
// Af[((kb * 2 + mi) * 3 + {0 hi, 1 mid, 2 lo}) * 32 + lane] is a lane's uint4
// a0..a3; rows past B are zeros.
__device__ __forceinline__ void stage_feats_bf16(const float* __restrict__ q, int row0, int B,
                                                 int D, uint32_t* Af) {
  const int d4 = D / 4;
  for (int idx = threadIdx.x; idx < kRows * d4; idx += kThreads) {
    const int r = idx / d4, k = (idx % d4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < B) v = *reinterpret_cast<const float4*>(q + size_t(row0 + r) * D + k);
    const int kb = k / 16, t = (k % 16) / 4, mi = r / 16, g = r % 8, hrow = (r % 16) / 8;
    uint32_t h[2][3];  // [depth pair][term]
    split3(v.x, v.y, h[0][0], h[0][1], h[0][2]);
    split3(v.z, v.w, h[1][0], h[1][1], h[1][2]);
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
#pragma unroll
      for (int tm = 0; tm < 3; ++tm)
        Af[(((kb * 2 + mi) * 3 + tm) * 32 + 4 * g + t) * 4 + 2 * pr + hrow] = h[pr][tm];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mq_fwd_tc_kernel(const FwdArgs args) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kDepth = kSliceBytes / int(sizeof(T));  // depth a stage holds
  constexpr int kPer = 16 / int(sizeof(T));              // elements a 16-byte chunk
  extern __shared__ float4 smem4[];
  const int B = args.B, M = args.M, Q = args.Q, D = args.D;
  uint32_t* Af = reinterpret_cast<uint32_t*>(smem4);  // the split feats: D x 256 / 192 bytes
  unsigned char* ring = reinterpret_cast<unsigned char*>(Af + D * feats_words<T>());  // 3 x 32 KB
  const T* __restrict__ bank = static_cast<const T*>(args.bank);
  const float tau = args.tau;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows, split = blockIdx.y;
  const bool q32 = Q == 32;  // the register epilogue
  const int mt = Q <= kCols ? kCols / Q : 1;
  const int qt = Q <= kCols ? 1 : (Q + kCols - 1) / kCols;
  const int n_groups = (M + mt - 1) / mt;
  const int gps = args.m_per_split / mt;  // tiles (Q <= 256) or m's (past it) a split
  const int tile_begin = split * gps * qt;
  const int tile_end = min((split + 1) * gps, n_groups) * qt;
  const int n_chunks = (D + kDepth - 1) / kDepth;
  const int n_ring = (tile_end - tile_begin) * n_chunks;

  // chunk kc of the split: depth slice kc % n_chunks of tile tile_begin +
  // kc / n_chunks, into stage kc % kStages; rows past the tile and depths
  // past D zero-filled. One cp.async group a call (an empty one past the end).
  auto fetch = [&](int kc) {
    if (kc < n_ring) {
      const Tile tl = tile_at(tile_begin + kc / n_chunks, M, Q);
      const int k0 = (kc % n_chunks) * kDepth;
      unsigned char* st = ring + (kc % kStages) * kStageBytes;
      for (int i = tid; i < kCols * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        const bool valid = r < tl.n && k0 + c * kPer < D;
        cp_async16(st + r * kSliceBytes + ((c ^ swz<T>(r)) << 4),
                   bank + (valid ? (tl.r0 + r) * D + k0 + c * kPer : 0), valid);
      }
    }
    cp_async_commit();
  };
  for (int kc = 0; kc < kStages - 1; ++kc) fetch(kc);
  // published by the mainloop's first barrier
  if constexpr (kBf16Route<T>)
    stage_feats_bf16(args.q, row0, B, D, Af);
  else
    stage_feats(args.q, row0, B, D, Af);

  // this thread's rows: q32, the warp tile's 16mi + 8h + g (slot = warp);
  // else the scan's row tid / 8 (slot = tid % 8)
  const int srow = tid >> 3, sj = tid & 7;
  Stats st[4];
  int lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st[i] = empty_stats();
    const int r = q32 ? 16 * (i >> 1) + 8 * (i & 1) + g : srow;
    lab[i] = row0 + r < B ? args.labels[row0 + r] : -1;
  }
  float carry = -CUDART_INF_F;  // Q > 256: the running max of m (scan threads)
  int carry_q = 0;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const Tile tl = tile_at(tile, M, Q);
    const int kc0 = (tile - tile_begin) * n_chunks;
    // int8: the scales of this lane's 8 columns (32warp + 8ni + 2t + e), read
    // now for the epilogue
    float sc[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 32 * warp + 8 * ni + 2 * t + e;
        sc[ni][e] = kQuant && col < tl.n ? args.scales[tl.r0 + col] : 1.f;
      }

    float acc[2][4][4];
    zero_tile(acc);
    for (int kc = kc0; kc < kc0 + n_chunks; ++kc) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk kc is in; every warp is done with chunk kc - 1's stage
      fetch(kc + kStages - 1);
      const unsigned char* stg = ring + (kc % kStages) * kStageBytes;
      const int k0 = (kc - kc0) * kDepth;
#pragma unroll
      for (int sb = 0; sb < kDepth / 32; ++sb) {  // 32-deep blocks of the stage
        if (k0 + 32 * sb >= D) break;
        float part[2][4][4];
        zero_tile(part);
#pragma unroll
        for (int kb2 = 0; kb2 < 2; ++kb2) {  // k16 steps
          const int kb = (k0 + 32 * sb) / 16 + kb2;
          // B(k, n) = bank row n: lane (g, t) reads row 32warp + 8ni + g,
          // depths 4t..4t+3 of the step
          const int byte = (32 * sb + 16 * kb2 + 4 * t) * int(sizeof(T));
          const unsigned char* brow[4];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int r = 32 * warp + 8 * ni + g;
            brow[ni] = stg + r * kSliceBytes + (((byte >> 4) ^ swz<T>(r)) << 4) + (byte & 15);
          }
          if constexpr (kBf16Route<T>) {
            uint32_t a[2][3][4];  // [mi][hi, mid, lo]
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int tm = 0; tm < 3; ++tm) {
                const uint4 w =
                    reinterpret_cast<const uint4*>(Af)[((kb * 2 + mi) * 3 + tm) * 32 + lane];
                a[mi][tm][0] = w.x, a[mi][tm][1] = w.y, a[mi][tm][2] = w.z, a[mi][tm][3] = w.w;
              }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              uint32_t b0, b1;
              if constexpr (sizeof(T) == 2) {
                const uint2 w = *reinterpret_cast<const uint2*>(brow[ni]);
                b0 = w.x, b1 = w.y;
              } else {
                const uint32_t u = *reinterpret_cast<const uint32_t*>(brow[ni]);
                b0 = int8_pair_bf16(u, 0x4140u);
                b1 = int8_pair_bf16(u, 0x4342u);
              }
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int tm = 2; tm >= 0; --tm) mma16816(part[mi][ni], a[mi][tm], b0, b1);
            }
          } else {
            uint4 a[2][4];  // [mi][hi s0, lo s0, hi s1, lo s1]
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int v = 0; v < 4; ++v)
                a[mi][v] = reinterpret_cast<const uint4*>(Af)[((kb * 2 + mi) * 4 + v) * 32 + lane];
            float bv4[4][4];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) load4(brow[ni], bv4[ni], T());
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              uint32_t ah[2][4], al[2][4];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                const uint4 h = a[mi][2 * s], l = a[mi][2 * s + 1];
                ah[mi][0] = h.x, ah[mi][1] = h.y, ah[mi][2] = h.z, ah[mi][3] = h.w;
                al[mi][0] = l.x, al[mi][1] = l.y, al[mi][2] = l.z, al[mi][3] = l.w;
              }
              float bv[4][2];
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                bv[ni][0] = bv4[ni][2 * s];
                bv[ni][1] = bv4[ni][2 * s + 1];
              }
              mma_step_split<(sizeof(T) < 4)>(part, ah, al, bv);
            }
          }
        }
        add_tile(acc, part);
      }
    }
    // the sims of the tile: acc[mi][ni][2h + e] is row 16mi + 8h + g, column
    // 32warp + 8ni + 2t + e
    if constexpr (kQuant) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][ni][i] *= sc[ni][i & 1];
    }

    if (q32) {
      // a warp's 32 columns are the m m0 + warp
      if (warp < tl.nm) {
        const int m = tl.m0 + warp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int mi = i >> 1, h = i & 1;
          float best = acc[mi][0][2 * h];
          int arg = 2 * t;
#pragma unroll
          for (int c = 1; c < 8; ++c) {  // this lane's columns in order: 8ni + 2t + e
            const float x = acc[mi][c >> 1][2 * h + (c & 1)];
            if (x > best) {
              best = x;
              arg = 8 * (c >> 1) + 2 * t + (c & 1);
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            take_max(best, arg, __shfl_xor_sync(kFull, best, off),
                     __shfl_xor_sync(kFull, arg, off));
          const float l = best / tau;
          fold(st[i], l, m == lab[i]);
          const int row = row0 + 16 * mi + 8 * h + g;
          if (args.logits_t && t == 0 && row < B) {
            args.logits_t[size_t(m) * B + row] = l;
            args.route_t[size_t(m) * B + row] = static_cast<int16_t>(arg);
          }
        }
      }
    } else {
      // stage the sims in the stage the tile's last chunk used, then scan them
      __syncthreads();  // every warp is done with that stage
      float* sims = reinterpret_cast<float*>(ring + ((kc0 + n_chunks - 1) % kStages) * kStageBytes);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            *reinterpret_cast<float2*>(sims + (16 * mi + 8 * h + g) * kCols + 32 * warp + 8 * ni +
                                       2 * t) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      __syncthreads();
      const float* srow_sims = sims + srow * kCols;
      const int row = row0 + srow;
      if (Q <= kCols) {
        for (int slot = sj; slot < tl.nm; slot += kSlots) {
          const float* s = srow_sims + slot * Q;
          float best = s[0];
          int arg = 0;
          for (int qq = 1; qq < Q; ++qq)
            if (s[qq] > best) {
              best = s[qq];
              arg = qq;
            }
          const int m = tl.m0 + slot;
          const float l = best / tau;
          fold(st[0], l, m == lab[0]);
          if (args.logits_t && row < B) {
            args.logits_t[size_t(m) * B + row] = l;
            args.route_t[size_t(m) * B + row] = static_cast<int16_t>(arg);
          }
        }
      } else {
        // 32 columns a scan thread, merged over the row's 8 threads, then
        // with the max carried from m's earlier tiles (which wins a tie)
        float best = -CUDART_INF_F;
        int arg = 0;
        for (int c = 32 * sj; c < min(32 * sj + 32, tl.n); ++c)
          if (srow_sims[c] > best || c == 32 * sj) {
            best = srow_sims[c];
            arg = c;
          }
#pragma unroll
        for (int off = 1; off < kSlots; off <<= 1)
          take_max(best, arg, __shfl_xor_sync(kFull, best, off),
                   __shfl_xor_sync(kFull, arg, off));
        if (tl.q0 == 0 || best > carry) {
          carry = best;
          carry_q = tl.q0 + arg;
        }
        if (tl.last && sj == 0) {
          const float l = carry / tau;
          fold(st[0], l, tl.m0 == lab[0]);
          if (args.logits_t && row < B) {
            args.logits_t[size_t(tl.m0) * B + row] = l;
            args.route_t[size_t(tl.m0) * B + row] = static_cast<int16_t>(carry_q);
          }
        }
      }
      // the next chunk's barrier keeps the stage until every scan is done
    }
  }

  // merge the 8 slots of each row in slot order; only empty cp.async groups
  // are left, so the ring is free for the slots
  cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(ring);  // (kSlots, kRows)
  if (q32) {
    if (t == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp * kRows + 16 * (i >> 1) + 8 * (i & 1) + g] =
            make_float4(st[i].mx, st[i].se, st[i].pos, st[i].el);
  } else {
    red[sj * kRows + srow] = make_float4(st[0].mx, st[0].se, st[0].pos, st[0].el);
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < B) {
    float4 v = red[tid];
    float m = v.x, s = v.y, p = v.z, e = v.w;
#pragma unroll
    for (int k = 1; k < kSlots; ++k) {
      v = red[k * kRows + tid];
      merge_stats(m, s, e, v.x, v.y, v.w);
      p += v.z;
    }
    args.part[size_t(split) * B + row0 + tid] = make_float4(m, s, p, e);
  }
}

template <typename T>
constexpr size_t fwd_smem_bytes(int D) {
  return size_t(D) * 4 * feats_words<T>() + size_t(kStages) * kStageBytes;
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// m's a backward stage holds: about 32 KB of row slots, kRows an m (the most
// distinct q* a 32-row tile can route to), 1-4 m's.
template <typename T>
__host__ __device__ constexpr int bwd_stage_m(int D) {
  return 32768 / (kRows * D * int(sizeof(T))) < 1
             ? 1
             : (32768 / (kRows * D * int(sizeof(T))) > kMaxStageM
                    ? kMaxStageM
                    : 32768 / (kRows * D * int(sizeof(T))));
}

template <typename T>
__host__ __device__ constexpr size_t bwd_stage_bytes(int D) {
  return size_t(bwd_stage_m<T>(D)) * kRows * D * sizeof(T);
}

// The stage's per-(m, row) arrays beside its row slots: the logit, the
// routed scale (int8) and the slot of the routed row.
constexpr size_t kBwdMeta = size_t(kMaxStageM) * kRows * (2 * sizeof(float) + sizeof(int));

template <typename T>
constexpr size_t bwd_smem_bytes(int D) {
  return size_t(kStages) * (bwd_stage_bytes<T>(D) + kBwdMeta);
}
static_assert(bwd_smem_bytes<float>(kMaxD) <= kSmemLimit, "the widest D must fit");

struct BwdArgs {
  const void* bank;          // (M, Q, D)
  const float* scales;       // (M, Q) for int8, else null
  const int* labels;         // (B,)
  const float* mx;           // (B,) the forward's statistics
  const float* se;
  const float* gout;         // the upstream scalar gradient
  const float* logits_t;     // (M, B) residuals of the forward
  const int16_t* route_t;
  float tau;
  int B, M, Q, D, m_per_split;
  float* dq_part;            // (n_splits, B, D)
};

__device__ __forceinline__ float4 row4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 row4(const __nv_bfloat16* p) {
  float v[4];
  load4(reinterpret_cast<const unsigned char*>(p), v, __nv_bfloat16());
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 row4(const int8_t* p) {
  float v[4];
  load4(reinterpret_cast<const unsigned char*>(p), v, int8_t());
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) mq_routed_bwd_kernel(const BwdArgs args) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ float4 smem4[];
  const int B = args.B, M = args.M, Q = args.Q, D = args.D;
  const int mc = bwd_stage_m<T>(D);
  const size_t stage_bytes = bwd_stage_bytes<T>(D);
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);  // kStages row-slot stages
  float* lg_s = reinterpret_cast<float*>(ring + kStages * stage_bytes);  // [st][u][b]
  float* sc_s = lg_s + kStages * kMaxStageM * kRows;
  int* slot_s = reinterpret_cast<int*>(sc_s + kStages * kMaxStageM * kRows);
  const T* __restrict__ bank = static_cast<const T*>(args.bank);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kRows, split = blockIdx.x;
  const int m_begin = split * args.m_per_split;
  const int m_end = min(m_begin + args.m_per_split, M);
  const int n_st = (m_end - m_begin + mc - 1) / mc;
  const bool router = row0 + lane < B;  // lane = a tile row when routing
  const int row_bytes = D * int(sizeof(T));

  // the q* of stage s's m's for row row0 + lane (-1 past B or the split)
  auto load_routes = [&](int s, int (&rq)[kMaxStageM]) {
#pragma unroll
    for (int u = 0; u < kMaxStageM; ++u) {
      const int m = m_begin + s * mc + u;
      rq[u] = (u < mc && m < m_end && router) ? int(args.route_t[size_t(m) * B + row0 + lane])
                                              : -1;
    }
  };
  // stage s: the distinct routed rows of each m, the logits and (int8) the
  // routed scales; one cp.async group a call (an empty one past the end)
  auto issue = [&](int s, const int (&rq)[kMaxStageM]) {
    if (s < n_st) {
      const int st = s % kStages;
      unsigned char* slots = ring + st * stage_bytes;
#pragma unroll
      for (int u = 0; u < kMaxStageM; ++u) {
        const int m = m_begin + s * mc + u;
        if (u >= mc || m >= m_end) break;
        const int q = rq[u];
        const unsigned same = __match_any_sync(kFull, q);
        const int first = __ffs(same) - 1;
        const unsigned owners = __ballot_sync(kFull, first == lane && q >= 0);
        if (warp == u) {  // the stage's arrays for this m, lane = row
          const int k = u * kRows + lane;
          slot_s[st * kMaxStageM * kRows + k] = q >= 0 ? __popc(owners & ((1u << first) - 1)) : -1;
          cp_async4(lg_s + st * kMaxStageM * kRows + k,
                    args.logits_t + (q >= 0 ? size_t(m) * B + row0 + lane : 0), q >= 0);
          if constexpr (kQuant)
            cp_async4(sc_s + st * kMaxStageM * kRows + k,
                      args.scales + (q >= 0 ? size_t(m) * Q + q : 0), q >= 0);
        }
        // distinct row k (in lane order) goes to slot u * kRows + k, copied
        // by warp k % 8: this warp's rows k = warp + 8j, each found by a
        // ballot of the owner of rank k
        const int rank = __popc(owners & ((1u << lane) - 1));
#pragma unroll
        for (int j = 0; j < kRows / (kThreads / 32); ++j) {
          const int k = warp + (kThreads / 32) * j;
          const unsigned who = __ballot_sync(kFull, first == lane && q >= 0 && rank == k);
          if (who == 0u) break;  // ranks are dense: none past this one
          const int qk = __shfl_sync(kFull, q, __ffs(who) - 1);
          const unsigned char* src = reinterpret_cast<const unsigned char*>(
              bank + (size_t(m) * Q + qk) * D);
          unsigned char* dst = slots + size_t(u * kRows + k) * row_bytes;
          for (int p = lane; p < row_bytes / 16; p += 32) cp_async16(dst + 16 * p, src + 16 * p, true);
        }
      }
    }
    cp_async_commit();
  };

  // this warp's 4 rows of dfeats, 4warp + i; a lane's columns 4lane + 128j.
  // Lane l forms the weight of row 4warp + l % 4 at the stage's m l / 4.
  const int wrow = row0 + 4 * warp + (lane & 3);
  const float rmx = wrow < B ? args.mx[wrow] : 0.f;
  const float rse = wrow < B ? args.se[wrow] : 1.f;
  const int lab = wrow < B ? args.labels[wrow] : -1;
  const float g = args.gout[0] / (float(B) * args.tau);
  float4 acc[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage s's m's into dfeats, from its slots and arrays
  auto accumulate = [&](int s) {
    const int st = s % kStages;
    const T* slots = reinterpret_cast<const T*>(ring + st * stage_bytes);
    // each (m, row) pair's weight and row slot, once, by lane 4u + i
    float pw = 0.f;
    int pslot = 0;
    {
      const int u = lane >> 2, m = m_begin + s * mc + u;
      if (u < mc && m < m_end && wrow < B) {
        const int k = (st * kMaxStageM + u) * kRows + 4 * warp + (lane & 3);
        float p = expf(lg_s[k] - rmx) / rse;
        if (m == lab) p -= 1.f;
        pw = p * g;
        if (kQuant) pw *= sc_s[k];
        pslot = slot_s[k];
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxStageM; ++u) {
      const int m = m_begin + s * mc + u;
      if (u >= mc || m >= m_end) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = __shfl_sync(kFull, pw, 4 * u + i);
        const int slot = __shfl_sync(kFull, pslot, 4 * u + i);
        if (row0 + 4 * warp + i >= B) break;
        const T* row = slots + size_t(u * kRows + slot) * D;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int d = 4 * lane + 128 * j;
          if (d < D) {
            const float4 v = row4(row + d);
            acc[i][j].x = fmaf(w, v.x, acc[i][j].x);
            acc[i][j].y = fmaf(w, v.y, acc[i][j].y);
            acc[i][j].z = fmaf(w, v.z, acc[i][j].z);
            acc[i][j].w = fmaf(w, v.w, acc[i][j].w);
          }
        }
      }
    }
  };
  int rq[kMaxStageM];
  for (int s = 0; s < kStages - 1; ++s) {
    load_routes(s, rq);
    issue(s, rq);
  }
  load_routes(kStages - 1, rq);  // a stage ahead of its issue
  for (int s = 0; s < n_st; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every warp is done with stage s - 1's slots
    issue(s + kStages - 1, rq);
    load_routes(s + kStages, rq);  // used by the next iteration's issue
    accumulate(s);
  }
  cp_async_wait<0>();

  float* out = args.dq_part + size_t(split) * B * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * warp + i;
    if (row >= B) break;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) *reinterpret_cast<float4*>(out + size_t(row) * D + d) = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// m's a forward tile holds (whole m's; 1 past Q = 256)
int fwd_tile_m(int Q) { return Q <= kCols ? kCols / Q : 1; }

bool args_ok(int B, int M, int Q, int D, int m_per_split, int n_splits) {
  if (B <= 0 || M <= 0 || Q <= 0 || Q > 32767 || D <= 0 || D % 32 != 0 || D > kMaxD ||
      m_per_split <= 0 || n_splits <= 0 || n_splits > 65535)
    return false;
  return static_cast<long long>(m_per_split) * n_splits >= M &&
         static_cast<long long>(m_per_split) * (n_splits - 1) < M;
}

template <typename T>
cudaError_t launch_fwd(const FwdArgs& args, int n_splits, float* mx, float* se, float* pos,
                       float* el, float* out2, cudaStream_t st) {
  const size_t bytes = fwd_smem_bytes<T>(args.D);
  auto kernel = mq_fwd_tc_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  // row tiles side by side, so the CTAs that read one bank tile run together
  kernel<<<dim3((args.B + kRows - 1) / kRows, n_splits), kThreads, bytes, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_merge<mq_split>(args.part, n_splits, args.B, args.tau, mx, se, pos,
                                             el, out2, st);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& args, int n_splits, float* dq, cudaStream_t st) {
  const size_t bytes = bwd_smem_bytes<T>(args.D);
  auto kernel = mq_routed_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  if ((args.B + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;  // grid.y
  kernel<<<dim3(n_splits, (args.B + kRows - 1) / kRows), kThreads, bytes, st>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return split_merge::launch_dq_reduce<mq_split>(args.dq_part, n_splits, args.B, args.D, dq, st);
}

}  // namespace

// Both entry points return a cudaError_t (0 on success); argument errors
// return cudaErrorInvalidValue without launching. bank_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (then `scales` is (M, Q) float32, else null). The
// m axis is cut into splits of m_per_split m's (the forward's a multiple of
// the m's a tile holds: 256 // Q, or 1 past Q = 256). feats, mx, se, pos, el,
// dq are float32; labels int32; part is (n_splits, B) float4 scratch; out2 =
// (loss, dtau_unit); dq_part is (n_splits, B, D) float32 scratch. The
// residuals logits_t (M, B) float32 and route_t (M, B) int16 are written by
// the forward when both are given (else both null) and read by the
// backward, which takes no feats.
extern "C" int max_query_infonce_fwd(const void* q, const void* bank, const void* scales,
                                     const void* labels, float tau, int B, int M, int Q, int D,
                                     int bank_dtype, int m_per_split, int n_splits, void* part,
                                     void* mx, void* se, void* pos, void* el, void* out2,
                                     void* logits_t, void* route_t, void* stream) {
  if (!args_ok(B, M, Q, D, m_per_split, n_splits) || m_per_split % fwd_tile_m(Q) != 0 ||
      (bank_dtype == 2) != (scales != nullptr) || (logits_t == nullptr) != (route_t == nullptr))
    return cudaErrorInvalidValue;
  FwdArgs args{};
  args.q = static_cast<const float*>(q);
  args.bank = bank;
  args.scales = static_cast<const float*>(scales);
  args.labels = static_cast<const int*>(labels);
  args.tau = tau;
  args.B = B;
  args.M = M;
  args.Q = Q;
  args.D = D;
  args.m_per_split = m_per_split;
  args.part = static_cast<float4*>(part);
  args.logits_t = static_cast<float*>(logits_t);
  args.route_t = static_cast<int16_t*>(route_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *fmx = static_cast<float*>(mx), *fse = static_cast<float*>(se),
        *fpos = static_cast<float*>(pos), *fel = static_cast<float*>(el),
        *fout = static_cast<float*>(out2);
  switch (bank_dtype) {
    case 0: return launch_fwd<float>(args, n_splits, fmx, fse, fpos, fel, fout, st);
    case 1: return launch_fwd<__nv_bfloat16>(args, n_splits, fmx, fse, fpos, fel, fout, st);
    case 2: return launch_fwd<int8_t>(args, n_splits, fmx, fse, fpos, fel, fout, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int max_query_infonce_bwd(const void* bank, const void* scales, const void* labels,
                                     const void* mx, const void* se, const void* gout,
                                     const void* logits_t, const void* route_t, float tau, int B,
                                     int M, int Q, int D, int bank_dtype, int m_per_split,
                                     int n_splits, void* dq_part, void* dq, void* stream) {
  if (!args_ok(B, M, Q, D, m_per_split, n_splits) || (bank_dtype == 2) != (scales != nullptr) ||
      logits_t == nullptr || route_t == nullptr)
    return cudaErrorInvalidValue;
  BwdArgs args{};
  args.bank = bank;
  args.scales = static_cast<const float*>(scales);
  args.labels = static_cast<const int*>(labels);
  args.mx = static_cast<const float*>(mx);
  args.se = static_cast<const float*>(se);
  args.gout = static_cast<const float*>(gout);
  args.logits_t = static_cast<const float*>(logits_t);
  args.route_t = static_cast<const int16_t*>(route_t);
  args.tau = tau;
  args.B = B;
  args.M = M;
  args.Q = Q;
  args.D = D;
  args.m_per_split = m_per_split;
  args.dq_part = static_cast<float*>(dq_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fdq = static_cast<float*>(dq);
  switch (bank_dtype) {
    case 0: return launch_bwd<float>(args, n_splits, fdq, st);
    case 1: return launch_bwd<__nv_bfloat16>(args, n_splits, fdq, st);
    case 2: return launch_bwd<int8_t>(args, n_splits, fdq, st);
    default: return cudaErrorInvalidValue;
  }
}
