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
// Bound by memory: one read and one write of the tensor and a few integer operations
// an element. At the TD4 training hop ([18,721, 512] f32) that is 77 MB, 23 us at
// 3.35 TB/s. Each thread handles 4 consecutive f32 (8 bf16) elements with one 16-byte load
// and store when the tensor is 16-byte aligned and its size a multiple of 4 (8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dropout_vec4(const float4* __restrict__ x, float4* __restrict__ y, size_t n4, uint32_t seed,
             uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * THREADS) {
    const float4 a = x[i];
    const uint64_t e = 4 * (uint64_t)i;
    float4 r;
    r.x = tdnet_keep(seed, e, threshold) ? a.x * inv_keep : 0.f;
    r.y = tdnet_keep(seed, e + 1, threshold) ? a.y * inv_keep : 0.f;
    r.z = tdnet_keep(seed, e + 2, threshold) ? a.z * inv_keep : 0.f;
    r.w = tdnet_keep(seed, e + 3, threshold) ? a.w * inv_keep : 0.f;
    y[i] = r;
  }
}

__global__ void __launch_bounds__(THREADS)
dropout_scalar(const float* __restrict__ x, float* __restrict__ y, size_t n, uint32_t seed,
               uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS)
    y[i] = tdnet_keep(seed, i, threshold) ? x[i] * inv_keep : 0.f;
}

// 8 bf16 a thread: one 16-byte load and store
__global__ void __launch_bounds__(THREADS)
dropout_bf16x8(const uint4* __restrict__ x, uint4* __restrict__ y, size_t n8, uint32_t seed,
               uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * THREADS) {
    uint4 a = x[i];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&a);
    const uint64_t base = 8 * (uint64_t)i;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(tdnet_keep(seed, base + j, threshold)
                                     ? __bfloat162float(e[j]) * inv_keep : 0.f);
    y[i] = a;
  }
}

__global__ void __launch_bounds__(THREADS)
dropout_bf16(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, size_t n,
             uint32_t seed, uint32_t threshold, float inv_keep) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS)
    y[i] = __float2bfloat16_rn(tdnet_keep(seed, i, threshold) ? __bfloat162float(x[i]) * inv_keep
                                                              : 0.f);
}

int blocks_for(size_t work) {
  const size_t want = (work + THREADS - 1) / THREADS;
  return (int)(want < 8192 ? (want > 0 ? want : 1) : 8192);
}

}  // namespace

extern "C" {

// x and y: n f32 elements, contiguous. Returns the launch's CUDA error, 0 if none.
int tdnet_dropout(const void* x, void* y, size_t n, unsigned int seed, unsigned int threshold,
                  float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const size_t work = vec ? n / 4 : n;
  const int blocks = blocks_for(work);
  if (vec)
    dropout_vec4<<<blocks, THREADS, 0, st>>>((const float4*)x, (float4*)y, work, seed, threshold,
                                             inv_keep);
  else
    dropout_scalar<<<blocks, THREADS, 0, st>>>((const float*)x, (float*)y, n, seed, threshold,
                                               inv_keep);
  return (int)cudaGetLastError();
}

// x and y: n bf16 elements, contiguous; inv_keep rounded to bf16 by the caller.
int tdnet_dropout_bf16(const void* x, void* y, size_t n, unsigned int seed,
                       unsigned int threshold, float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const size_t work = vec ? n / 8 : n;
  if (vec)
    dropout_bf16x8<<<blocks_for(work), THREADS, 0, st>>>((const uint4*)x, (uint4*)y, work, seed,
                                                         threshold, inv_keep);
  else
    dropout_bf16<<<blocks_for(work), THREADS, 0, st>>>((const __nv_bfloat16*)x,
                                                       (__nv_bfloat16*)y, n, seed, threshold,
                                                       inv_keep);
  return (int)cudaGetLastError();
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
