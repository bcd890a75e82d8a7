// Dropout for Hopper (sm_90a): y = keep ? x * inv_keep : 0 over a contiguous f32 or bf16
// [rows, C] tensor, element (row, c) kept when tdnet_keep(seed, row * C + c, threshold)
// (dropout_hash.cuh). The backward is the same kernel on dy with the same seed: the
// mask is regenerated, never stored. In bf16 the caller passes inv_keep already rounded to
// bf16 (the TPU kernel's scale is a weak-typed Python float, so JAX multiplies x by
// bf16(1 / (1 - rate)), 1.109375 at rate 0.1); x * inv_keep is then exact in f32 and is
// rounded to bf16 once.
//
// Replaces the TPU kernel tdnet_tpu/kernels/dropout.py: _kernel, reached through
// dropout_tpu (the attention fc's dropout, rate 0.1).
//
// Bound by memory: one read and one write of the tensor. At the TD4 training hop
// ([18,721, 512]) that is 77 MB in f32, 23 us at 3.35 TB/s, and 38 MB in bf16, 11.4 us.
// dropout_vec takes 16-byte vectors (4 f32 or 8 bf16 elements) when the tensor is 16-byte
// aligned and its size a multiple of 4 (8), one vector a thread in at most MAX_BLOCKS blocks,
// the grid striding on. The elements of a vector start at a multiple of 4 (8), so they share
// the high word of their index and, with it, the hash's high half (tdnet_hash_high), formed
// once a vector: 1 + 1/8 mixers an element in bf16, 1 + 1/4 in f32. dropout_scalar and
// dropout_bf16 take the rest, one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;
constexpr size_t MAX_BLOCKS = 8192;

// the elements of a 16-byte vector
template <typename V>
struct Lanes;
template <>
struct Lanes<float4> {
  static constexpr uint32_t N = 4;
};
template <>
struct Lanes<uint4> {
  static constexpr uint32_t N = 8;
};

// 4 f32 whose indices have low words lo .. lo + 3 and the hash's high half `high`
__device__ __forceinline__ float4 drop(float4 a, uint32_t lo, uint32_t high, uint32_t threshold,
                                       float inv_keep) {
  float4 r;
  r.x = tdnet_hash_low(lo, high) < threshold ? a.x * inv_keep : 0.f;
  r.y = tdnet_hash_low(lo + 1, high) < threshold ? a.y * inv_keep : 0.f;
  r.z = tdnet_hash_low(lo + 2, high) < threshold ? a.z * inv_keep : 0.f;
  r.w = tdnet_hash_low(lo + 3, high) < threshold ? a.w * inv_keep : 0.f;
  return r;
}

// 8 bf16, the same way; x * inv_keep in f32, rounded once
__device__ __forceinline__ uint4 drop(uint4 a, uint32_t lo, uint32_t high, uint32_t threshold,
                                      float inv_keep) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
  for (uint32_t j = 0; j < 8; ++j)
    e[j] = __float2bfloat16_rn(tdnet_hash_low(lo + j, high) < threshold
                                   ? __bfloat162float(e[j]) * inv_keep : 0.f);
  return a;
}

// nv vectors; vector i holds elements [i N, i N + N); seed_mix = tdnet_mix32(seed)
template <typename V>
__global__ void __launch_bounds__(THREADS)
dropout_vec(const V* __restrict__ x, V* __restrict__ y, size_t nv, uint32_t seed_mix,
            uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < nv;
       i += (size_t)gridDim.x * THREADS) {
    const uint64_t e = (uint64_t)i * Lanes<V>::N;
    y[i] = drop(x[i], (uint32_t)e, tdnet_hash_high(seed_mix, (uint32_t)(e >> 32)), threshold,
                inv_keep);
  }
}

__global__ void __launch_bounds__(THREADS)
dropout_scalar(const float* __restrict__ x, float* __restrict__ y, size_t n, uint32_t seed,
               uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS)
    y[i] = tdnet_keep(seed, i, threshold) ? x[i] * inv_keep : 0.f;
}

__global__ void __launch_bounds__(THREADS)
dropout_bf16(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n,
             uint32_t seed, uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS)
    y[i] = __float2bfloat16_rn(tdnet_keep(seed, i, threshold) ? __bfloat162float(x[i]) * inv_keep
                                                              : 0.f);
}

// one element (or vector) a thread, at most MAX_BLOCKS blocks
int blocks_for(size_t work) {
  const size_t want = (work + THREADS - 1) / THREADS;
  return (int)(want < MAX_BLOCKS ? (want > 0 ? want : 1) : MAX_BLOCKS);
}

template <typename V>
void launch_vec(const void* x, void* y, size_t n, uint32_t seed, uint32_t threshold,
                float inv_keep, cudaStream_t st) {
  const size_t nv = n / Lanes<V>::N;
  dropout_vec<V><<<blocks_for(nv), THREADS, 0, st>>>((const V*)x, (V*)y, nv, tdnet_mix32(seed),
                                                     threshold, inv_keep);
}

bool aligned16(const void* x, const void* y) {
  return (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
}

}  // namespace

extern "C" {

// x and y: n f32 elements, contiguous. Returns the launch's CUDA error, 0 if none.
int tdnet_dropout(const void* x, void* y, size_t n, unsigned int seed, unsigned int threshold,
                  float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 == 0 && aligned16(x, y))
    launch_vec<float4>(x, y, n, seed, threshold, inv_keep, st);
  else
    dropout_scalar<<<blocks_for(n), THREADS, 0, st>>>((const float*)x, (float*)y, n, seed,
                                                      threshold, inv_keep);
  return (int)cudaGetLastError();
}

// x and y: n bf16 elements, contiguous; inv_keep rounded to bf16 by the caller.
int tdnet_dropout_bf16(const void* x, void* y, size_t n, unsigned int seed,
                       unsigned int threshold, float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 8 == 0 && aligned16(x, y))
    launch_vec<uint4>(x, y, n, seed, threshold, inv_keep, st);
  else
    dropout_bf16<<<blocks_for(n), THREADS, 0, st>>>((const __nv_bfloat16*)x,
                                                    (__nv_bfloat16*)y, n, seed, threshold,
                                                    inv_keep);
  return (int)cudaGetLastError();
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
