// Dropout for Hopper (sm_90a): y = keep ? x * inv_keep : 0 over a contiguous f32 [rows, C]
// tensor, element (row, c) kept when tdnet_keep(seed, row * C + c, threshold)
// (dropout_hash.cuh). The backward is the same kernel on dy with the same seed: the
// mask is regenerated, never stored.
//
// Replaces the TPU kernel tdnet_tpu/kernels/dropout.py: _kernel, reached through
// dropout_tpu (the attention fc's dropout, rate 0.1).
//
// Bound by memory: one read and one write of the tensor and a few integer operations
// an element. At the TD4 training hop ([18,721, 512] f32) that is 77 MB, 23 us at
// 3.35 TB/s. Each thread handles 4 consecutive elements with one 16-byte load and
// store when the tensor is 16-byte aligned and its size a multiple of 4.

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

}  // namespace

extern "C" {

// x and y: n f32 elements, contiguous. Returns the launch's CUDA error, 0 if none.
int tdnet_dropout(const void* x, void* y, size_t n, unsigned int seed, unsigned int threshold,
                  float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const size_t work = vec ? n / 4 : n;
  const size_t want = (work + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 8192 ? (want > 0 ? want : 1) : 8192);
  if (vec)
    dropout_vec4<<<blocks, THREADS, 0, st>>>((const float4*)x, (float4*)y, work, seed, threshold,
                                             inv_keep);
  else
    dropout_scalar<<<blocks, THREADS, 0, st>>>((const float*)x, (float*)y, n, seed, threshold,
                                               inv_keep);
  return (int)cudaGetLastError();
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
