// Hopper (sm_90a) helpers for the kernels that run on wgmma, mbarriers and bulk copies: the
// fused stem (fused_stem.cu, K4) and the bf16 propagation attention
// (propagation_attention.cu, K1). The tensor maps of TMA copies are encoded on the host by
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so a library needs
// no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared-memory matrix descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes (64 bf16), groups of 8 rows 1024 bytes apart. The swizzle follows the address
// bits, so a tile may start at any row (a tap's shift) or 32-byte k step.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((saddr(p) >> 4) & 0x3FFF) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory accesses (generic proxy) before the async proxy's (wgmma
// reads, bulk copies)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an mbarrier whose phase completes at COUNT arrivals (and the bytes they expect)
template <int COUNT = 1>
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "n"(COUNT));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

// one thread: the current phase of bar completes when `bytes` more have arrived
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// one thread: the box of `map` at coordinates (c0, c1, c2), innermost first, to shared dst
// (1024-byte aligned for the 128-byte swizzle), completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4}], [%5];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(saddr(bar))
      : "memory");
}

// Registers a thread of the executing warpgroup may hold: a producer warpgroup gives them
// up, consumer warpgroups take them (warp-uniform branches; the counts balance per SM
// sub-partition, so the consumers' increase never waits).
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A wait that outlasts any fill by orders of magnitude traps, which fails the launch instead
// of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries == (1 << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// The tries after which a consumer's wait gives up (a -D define sets a debug build's).
#ifndef TDNET_CONSUMER_POLLS
#define TDNET_CONSUMER_POLLS (1 << 24)
#endif

// A consumer warpgroup's wait. A warpgroup that takes registers by setmaxnreg must not hold a
// trap (ptxas then keeps the launch's register count there, and spills), so after
// TDNET_CONSUMER_POLLS tries it sets the error word *fault to 1 and exits: the launch then
// ends with part of its output unwritten, and the host reads the word where it synchronizes.
__device__ __forceinline__ void bar_wait_or_flag(uint64_t* bar, uint32_t parity,
                                                 unsigned int* fault) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    if (tries == TDNET_CONSUMER_POLLS) {
      atomicExch(fault, 1u);
      asm volatile("exit;");
    }
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// The tensor map of a bf16 tensor [d2][d1][d0] (d0 innermost, contiguous) read in boxes of
// 64 x rows x 1 elements with the 128-byte swizzle (a box row is one 128-byte swizzle row);
// elements outside the tensor read as zero. Returns a CUDA error code, 0 on success.
inline int bf16_tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                           uint64_t d2, uint32_t rows) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = (Encode)fn;
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};   // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
