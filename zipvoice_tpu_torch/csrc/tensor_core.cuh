// Tensor-core and asynchronous-copy building blocks of the redesigned B4, B5
// and B6 (rel_probs.cuh), B7 and B5 (rel_wide_consume.cuh) and B9
// (conv_glu.cu): inline PTX
// for `cp.async`, `ldmatrix` and `mma.sync` (sm_80 and later, built here
// for sm_90a).
//
// Fragment layouts are those of the PTX ISA for m16n8k16 (bf16) and m16n8k8
// (tf32), with g = lane / 4 and t = lane % 4:
//   A (16 x k, row):  bf16 a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 =
//                     A[g][2t+8..], a3 = A[g+8][2t+8..];
//                     tf32 a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                     a3 = A[g+8][t+4];
//   B (k x 8, col):   bf16 b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//                     tf32 b0 = B[t][g], b1 = B[t+4][g];
//   C/D (16 x 8):     c0, c1 = D[g][2t, 2t+1], c2, c3 = D[g+8][2t, 2t+1].
//
// f32 operands run as 3xTF32: x = hi + lo (split_tf32); a b ~ a_lo b_hi +
// a_hi b_lo + a_hi b_hi with f32 sums (the dropped a_lo b_lo is ~2^-21 of
// |a b|), which keeps f32's tolerance where one TF32 product (2^-11) does
// not.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zv {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of 16 (or 8, or 4) bytes; src_bytes = 0
// writes zeros and reads nothing (the ragged edges).
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
// 16 bytes of which the first src_bytes (1..16) are read, the rest zeroed
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// D += A B, m16n8k16, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B, m16n8k8, tf32 inputs, f32 accumulation.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo for 3xTF32: hi keeps x's sign, exponent and top 10 mantissa
// bits (the bits a TF32 product reads), lo = x - hi exactly; the product
// reads lo's top bits too, so what is lost is below 2^-21 of |x|.  Two
// full-rate integer and float operations, no conversion instruction.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A B in 3xTF32 on pre-split operands: the two small products go to
// their own sums `small`, so that no chain of three products waits on one
// accumulator; the result is big + small.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32_1688(small, al, bh0, bh1);
  mma_tf32_1688(big, ah, bh0, bh1);
  mma_tf32_1688(small, ah, bl0, bl1);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// A 1-D grid over (row tile, batch row) units u = tile * B + b, each cut
// into column blocks.  The kernels hold one block an SM, so the units are
// split further only where the SMs would otherwise idle: all of them where
// they fill less than three quarters of the SMs (a split costs each block
// its rows' prologue again, and never makes more blocks than SMs), and, past
// one wave, the units of the last, partial wave (its blocks then run
// beside each other instead of after a full wave's worth of time).
struct Split {
  int units_main;      // units in whole waves (or all of them)
  int z_main, w_main;  // their column blocks and the columns a block takes
  int z_tail, w_tail;  // the same for the remaining units
};

// Column blocks of width `unit * k` for `cols` columns cut about `want` ways.
inline void cut_columns(int cols, int unit, int want, int& z, int& w) {
  const int units = (cols + unit - 1) / unit;
  if (want < 1) want = 1;
  if (want > units) want = units;
  w = unit * ((units + want - 1) / want);
  z = (cols + w - 1) / w;
}

inline Split plan_split(int units, int cols, int unit, int sms) {
  Split sp;
  int rest = units;
  if (units > sms) {
    sp.units_main = units - units % sms;
    rest = units % sms;
    cut_columns(cols, unit, 1, sp.z_main, sp.w_main);
  } else {
    sp.units_main = 0;
  }
  const int want = rest == 0 || 4 * rest >= 3 * sms ? 1 : sms / rest;
  cut_columns(cols, unit, want, sp.z_tail, sp.w_tail);
  if (sp.units_main == 0) {
    sp.z_main = sp.z_tail;
    sp.w_main = sp.w_tail;
  }
  return sp;
}

inline int split_blocks(const Split& sp, int units) {
  return sp.units_main * sp.z_main + (units - sp.units_main) * sp.z_tail;
}

// Block `w`'s unit and its columns [c_lo, c_hi).
__device__ __forceinline__ void split_block(const Split& sp, int w, int cols, int& u, int& c_lo,
                                            int& c_hi) {
  const int main_blocks = sp.units_main * sp.z_main;
  int zi, width;
  if (w < main_blocks) {
    u = w / sp.z_main;
    zi = w - u * sp.z_main;
    width = sp.w_main;
  } else {
    const int r = w - main_blocks, k = r / sp.z_tail;
    u = sp.units_main + k;
    zi = r - k * sp.z_tail;
    width = sp.w_tail;
  }
  c_lo = zi * width;
  c_hi = min(cols, c_lo + width);
}

}  // namespace zv
