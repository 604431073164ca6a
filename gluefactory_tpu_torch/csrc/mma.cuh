// Warp-level building blocks of the tensor-core kernels: bf16 and TF32
// mma.sync, ldmatrix and cp.async as inline PTX on the card, lane shuffles,
// and the split-TF32 fragments of fp32 tiles in shared memory (fp32
// accuracy on the TF32 tensor cores).
// tests/cuda_emu/cuda_runtime.h defines GF_EMU_WARP and gives the same
// functions (and __shfl_xor_sync) as stand-ins that exchange fragments
// through per-warp scratch, so the kernels that call them run on the CPU
// unchanged. Every lane of a warp must reach each of these calls.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), g = lane >> 2, t = lane & 3, each 32-bit register two bf16
// with the lower column (A, C) or row (B) index in its low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8):             b0 (rows 2t..2t+1, col g), b1 (rows 2t+8.., col g)
//   C, D (16 x 8, fp32):    c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// and of mma.m16n8k8 with .tf32 operands (one 32-bit register an element;
// the hardware reads only a register's top 19 bits):
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8):             b0 (row t, col g), b1 (row t+4, col g)
//   C, D:                  as for m16n8k16.
// A k8 step's contraction order is free: reading A's column t as column 2t
// and column t+4 as 2t+1 (and B's rows alike) makes a C fragment an A
// fragment without moving data between lanes (see mma_tf32x3's callers).
#pragma once

#include "common.cuh"

namespace gf {

// two floats rounded to bf16 and packed, `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v >> 16)));
}

#ifndef GF_EMU_WARP

// d += a * b, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16_m16n8k16(float d[4], const unsigned a[4],
                                                  const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the bits of an fp32 value
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a * b, TF32 inputs, fp32 accumulators
__device__ __forceinline__ void mma_tf32_m16n8k8(float d[4], const unsigned a[4],
                                                 const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes); r[j] receives matrix j's
// (row g, cols 2t..2t+1), or with `trans` its (rows 2t..2t+1, col g).
__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* row) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], const void* row) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device to shared memory, asynchronously; zero-filled when
// `in` is false (src is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  int bytes = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

#endif  // GF_EMU_WARP

// x = hi + lo as two TF32 operands: hi is x rounded to TF32 to nearest, ties
// away (the value of to_tf32 for finite x, in two integer operations: on the
// card cvt.rna costs more), lo = x - hi exactly in fp32, of which the tensor
// core reads the top 19 bits: hi + lo holds x to about 2^-21
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b at about fp32 accuracy from the TF32 passes of split_tf32's
// parts (a_lo b_lo is dropped): the small terms first, the large one last.
// An operand that is exact in TF32 (bf16 data widened to fp32) has a zero lo
// part; its pass is left out.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_split(float d[4], const unsigned ahi[4], const unsigned alo[4],
                                          const unsigned bhi[2], const unsigned blo[2]) {
  if constexpr (!kAExact) mma_tf32_m16n8k8(d, alo, bhi);
  if constexpr (!kBExact) mma_tf32_m16n8k8(d, ahi, blo);
  mma_tf32_m16n8k8(d, ahi, bhi);
}
// the three passes of two fp32 operands
__device__ __forceinline__ void mma_tf32x3(float d[4], const unsigned ahi[4],
                                           const unsigned alo[4], const unsigned bhi[2],
                                           const unsigned blo[2]) {
  mma_split<false, false>(d, ahi, alo, bhi, blo);
}

// Fragments of one m16n8k8 step from an fp32 tile in shared memory (row
// stride kS floats, 16-byte aligned rows), each element split into TF32 hi
// and lo. Row-wise fragments come by ldmatrix: an fp32 element is a pair of
// b16 halves, so an 8 x 8 b16 matrix is 8 rows x 4 floats and lane (g, t)
// gets the float at (row g, column t). A stride of 4 (mod 32) floats keeps
// the eight rows of each ldmatrix, and the scalar loads of frag_b_cols, on
// distinct banks.
// A(r, k) = tile[m0 + r][k0 + k]
template <int kS>
__device__ __forceinline__ void frag_a(unsigned hi[4], unsigned lo[4], const float* tile, int m0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  unsigned r[4];
  ldsm_x4(r, tile + (m0 + l / 8 % 2 * 8 + l % 8) * kS + k0 + l / 16 * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}
// B of two n8 tiles, B(k, n) = tile[n0 + n][k0 + k] for n < 16 (the
// contraction runs along the tile's rows): [0..1] the tile at n0, [2..3] n0 + 8
template <int kS>
__device__ __forceinline__ void frag_b_rows(unsigned hi[4], unsigned lo[4], const float* tile,
                                            int n0, int k0) {
  const int l = threadIdx.x % 32;
  unsigned r[4];
  ldsm_x4(r, tile + (n0 + l / 16 * 8 + l % 8) * kS + k0 + l / 8 % 2 * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}
// B(k, n) = tile[k0 + k][n0 + n], contraction down the tile's columns, in
// the permuted order of frag_c: k = t is row 2t, k = t + 4 row 2t + 1
template <int kS>
__device__ __forceinline__ void frag_b_cols(unsigned hi[2], unsigned lo[2], const float* tile,
                                            int k0, int n0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + (k0 + 2 * t) * kS + n0 + g;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[kS], hi[1], lo[1]);
}
// The A fragment of the 16 x 8 block held as the C fragment c (columns
// 2t, 2t + 1 of rows g, g + 8), in the permuted order: no data moves
__device__ __forceinline__ void frag_c(unsigned hi[4], unsigned lo[4], const float c[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ float shfl_xor(float v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

// two neighbouring elements of a row in one store (p 8-byte aligned for
// float, 4-byte for bf16)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

}  // namespace gf
