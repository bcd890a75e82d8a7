// Error-compensated TF32 (3xTF32) on mma.sync.m16n8k8, and cp.async, shared by the f32
// attention kernels: the training attention's backward (propagation_attention_train.cu, K2)
// and the f32 PV and fc passes (attention_f32.cuh, propagation_attention.cu; K1 and K2's
// forward), and by the dilated conv (dilated_conv.cu, K5).
//
// Each f32 operand x splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi); a b accumulates
// as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, which keeps f32 accuracy (TF32
// alone keeps about 3 digits). The tensor core truncates as it accumulates, so callers sum
// short chains in a fresh accumulator and add them in round-to-nearest f32 (flush).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- 3xTF32 on mma.sync.m16n8k8: in a warp, g = lane / 4 and t = lane % 4. A (16 x 8,
// row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col): b0
// (t, g), b1 (t + 4, g); C (16 x 8): c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, 2t, 2t + 1).

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// cvt.rna.tf32.f32 for finite x (round to nearest, ties away from zero, 10 mantissa bits
// kept) in two integer operations: the cvt instruction compiles to a longer sequence.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32: hi = rna_tf32(x); lo's register holds x - hi plus half a TF32 ulp,
// of which the tensor core reads only the upper 19 bits, that is rna_tf32(x - hi) (the
// rounding CUTLASS's 3xTF32 path uses). Only an mma operand may take lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float c[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c += t, then t = 0. The tensor core truncates as it accumulates, which biases a long
// chain of products into one accumulator; a chain of a few k-steps summed in a fresh
// accumulator and added in round-to-nearest f32 keeps long sums unbiased.
__device__ __forceinline__ void flush(float c[4], float t[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] += t[i];
    t[i] = 0.f;
  }
}

// Fragments from per-thread pointers, so that a k-step's loads are a pointer plus a
// constant. A rows [r0, r0 + 16) x columns [c0, c0 + 8) of a row-major tile t of stride s:
// p = a_ptr(t, s, r0) + c0.
__device__ __forceinline__ int a_offset(int s, int r0) {
  return (r0 + ((threadIdx.x & 31) >> 2)) * s + (threadIdx.x & 3);
}

__device__ __forceinline__ const float* a_ptr(const float* t, int s, int r0) {
  return t + a_offset(s, r0);
}

__device__ __forceinline__ void load_a(FragA& f, const float* p, int s) {
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * s], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * s + 4], f.hi[3], f.lo[3]);
}

// The same from a tile stored split, hi and lo at the same offset of two arrays.
__device__ __forceinline__ void load_a_split(FragA& f, const uint32_t* hi, const uint32_t* lo,
                                             int s) {
  const int o[4] = {0, 8 * s, 4, 8 * s + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = hi[o[i]];
    f.lo[i] = lo[o[i]];
  }
}

// Swizzled tiles store element (r, c) at r * s + (c ^ (r & 4)): the 4-word halves of each
// 8 words swap on rows with bit 2 set. B (k0.. + 8) x (n0.. + 8) comes from the element
// offsets o[0] + step, o[1] + step of a thread, for n0 and k0 multiples of 8:
//   tile stored [n][k] (nk_offsets(s, n0)): step = k0;
//   tile stored [k][n] (kn_offsets(s, n0)): step = k0 * s.
__device__ __forceinline__ void nk_offsets(int o[2], int s, int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  o[0] = (n0 + g) * s + q + (g & 4);
  o[1] = (n0 + g) * s + q + 4 - (g & 4);
}

__device__ __forceinline__ void kn_offsets(int o[2], int s, int n0) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  o[0] = q * s + n0 + g;
  o[1] = (q + 4) * s + n0 + (g ^ 4);
}

__device__ __forceinline__ void load_b(FragB& f, const float* t, const int o[2], int step) {
  split(t[o[0] + step], f.hi[0], f.lo[0]);
  split(t[o[1] + step], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ int swz(int r, int c, int s) { return r * s + (c ^ (r & 4)); }

// ---- cp.async

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
