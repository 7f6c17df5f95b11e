// Warp-level tensor-core building blocks for Hopper (sm_90a), as inline PTX:
// `cp.async` copies into shared memory, `ldmatrix` fragment loads,
// `mma.sync` products in bf16 (m16n8k16) and in TF32 (m16n8k8), the split of
// a float32 value into two TF32 values for 3xTF32 products, and a warp's
// 32 x 32 split-TF32 step with its zeroed partial tiles.
//
// Used by long_attention.cu and short_attention.cu (bf16 attention), by
// bank_infonce.cu and max_query_infonce.cu (the InfoNCE kernels in split
// TF32), by
// quant_matmul.cu (int8 weights on bf16 tensor cores) and, for its copies,
// by decode_attention.cu.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 / k8"), with
// lane = 4g + t (g = lane >> 2, t = lane & 3):
//   - accumulator C (16 x 8, float32), both shapes: c0, c1 at row g, columns
//     2t, 2t + 1; c2, c3 at row g + 8, the same columns;
//   - m16n8k16 bf16: A (16 x 16) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//     a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9), two bf16 a register;
//     B (16 x 8) b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g). So the
//     accumulators of two neighbouring n8 tiles, rounded to bf16 in pairs,
//     are the A fragment of a product over those 16 columns;
//   - m16n8k8 tf32: A (16 x 8) a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4),
//     a3 = (g+8, t+4); B (8 x 8) b0 = (t, g), b1 = (t+4, g).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace mma_sync {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until at most n of this thread's copy groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same for 32-bit values: an 8 x 4 tile of them is an 8 x 8 tile of b16
// pairs, so lane l addresses row l & 7 of tile l >> 3 and receives in r[i]
// the value at (g, t) of tile i, a TF32 fragment's layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, float32) = a * b, the accumulator starting from zero
__device__ __forceinline__ void mma16816_zero(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment addresses for a warp's lane. A 16 x 16 A operand at (row0, col0)
// of a row-major tile (rows = the product's rows): lane l points at row
// l & 15, column (l >> 4) * 8. A pair of n8 B operands (16 keys x 16 depth)
// from a tile whose rows are the product's columns (K for q k^T): key
// (l & 7) + (l >> 4) * 8, depth ((l >> 3) & 1) * 8; registers b0, b1 of the
// first n8 tile, then of the second. The same from a tile whose rows are
// the product's depth (V for P v, by `.trans`): row (l & 7) + ((l >> 3) & 1)
// * 8, column (l >> 4) * 8.
template <int ld>
__device__ __forceinline__ const bf16* a_frag(const bf16* t, int row0, int col0, int lane) {
  return t + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

template <int ld>
__device__ __forceinline__ const bf16* b_frag(const bf16* t, int key0, int col0, int lane) {
  return t + (key0 + (lane & 7) + (lane >> 4) * 8) * ld + col0 + ((lane >> 3) & 1) * 8;
}

template <int ld>
__device__ __forceinline__ const bf16* bt_frag(const bf16* t, int row0, int col0, int lane) {
  return t + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 + (lane >> 4) * 8;
}

// ---------------------------------------------------------------------------
// TF32
// ---------------------------------------------------------------------------

// x = hi + lo for a 3xTF32 product: hi = x rounded to TF32 (10 mantissa
// bits, to nearest, ties away from zero: half a TF32 unit added to the bits,
// then the low 13 bits masked), lo = x - hi, exact in float32 and at most
// 2^-11 |x|. The tensor cores read only the top 19 bits of a .tf32 operand,
// so lo enters the product truncated to 11 significant bits: x - hi - lo
// then stays below 2^-21 |x|. Three instructions a value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k8 step of a warp's 32 x 32 tile in split TF32 (bank_infonce.cu,
// max_query_infonce.cu): part[mi][ni] (16 x 8 each) += A (rows 16mi.., 8
// deep) * B (8 deep, columns 8ni..), A given split as ah + al (TF32 each, the
// m16n8k8 fragment layout: a0..a3), B as float values (bv[ni] = b0, b1). B is
// split as x = hi + lo and the product is lo·hi + hi·lo + hi·hi, the small
// terms first; lo·lo (2^-22 relative) is dropped. kExactB: B's values are
// exact in TF32 (a bf16 bank, or int8 values of at most 7 bits), so its lo is
// zero and two products run.
template <bool kExactB>
__device__ __forceinline__ void mma_step_split(float (&part)[2][4][4], const uint32_t (&ah)[2][4],
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

// The same from float A values in the fragment layout (av[mi] = a0..a3),
// split here.
template <bool kExactB>
__device__ __forceinline__ void mma_step_3xtf32(float (&part)[2][4][4], const float (&av)[2][4],
                                                const float (&bv)[4][2]) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(av[mi][i], ah[mi][i], al[mi][i]);
  mma_step_split<kExactB>(part, ah, al, bv);
}

// The tensor cores add a product's partial sums to their accumulator
// rounding toward zero, a bias that grows with the number of additions: each
// 32-deep stage's products go to a zeroed tile (`part`), which is then added
// to the running sum in float32, to nearest, as FMAs round.
__device__ __forceinline__ void zero_tile(float (&part)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mi][ni][i] = 0.f;
}

__device__ __forceinline__ void add_tile(float (&acc)[2][4][4], const float (&part)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] += part[mi][ni][i];
}

}  // namespace mma_sync
