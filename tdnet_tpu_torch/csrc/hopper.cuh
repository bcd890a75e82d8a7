// Hopper (sm_90a) helpers for the kernels that run on wgmma, mbarriers and bulk copies: the
// fused stem (fused_stem.cu, K4), the bf16 propagation attention (propagation_attention.cu,
// K1, and attention_bf16.cuh, shared with K2's forward), the bf16 training attention
// (propagation_attention_train.cu, K2) and the bf16 dilated conv (dilated_conv.cu, K5); K1, K2
// and K5 share the ring of TMA stages (Ring) and the consumers' error word
// (bar_wait_or_flag). The tensor maps of TMA copies are encoded on the host by
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so a library needs
// no -lcuda; the last 64 maps encoded are kept and reused for the same tensor and box.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>
#include <mutex>

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

// d (a warpgroup's 64 x 128 f32 fragment) = a b + (scale_d ? d : 0): a 64 x 16 bf16 K-major,
// b 128 n x 16 k bf16 K-major (TRANS_B 0) or N-major (1), both from shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// The compiler must not move reads of a wgmma accumulator above the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// The dynamic shared memory from its first 1024-byte boundary: `head` bytes (K1's attention
// kernels' q tile), the ring of `stages` stages of `stage` bytes, then the barriers: a full
// and an empty one a stage, and one for the head.
struct Ring {
  unsigned char* head;
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* head_full;
  __device__ Ring(unsigned char* smem, int stages, int stage, int head_bytes) {
    head = smem + ((1024 - (saddr(smem) & 1023)) & 1023);
    base = head + head_bytes;
    full = reinterpret_cast<uint64_t*>(base + (size_t)stages * stage);
    empty = full + stages;
    head_full = empty + stages;
  }
};

inline size_t ring_smem(int stages, int stage, int head_bytes) {
  return 1024 + head_bytes + (size_t)stages * (stage + 16) + 8;
}

// One thread: the full barriers expect one arrival (the producer's, with the stage's bytes),
// the empty ones one arrival from each warp of the RW consumer warpgroups.
template <int RW>
__device__ __forceinline__ void init_ring(const Ring& ring, int stages) {
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) {
      bar_init<1>(ring.full + s);
      bar_init<4 * RW>(ring.empty + s);
    }
  if (threadIdx.x == 0) bar_init<1>(ring.head_full);
  __syncthreads();
}

// The producer's wait before it refills stage s for chunk ch (the first round finds it free).
__device__ __forceinline__ void wait_free(const Ring& ring, int ch, int stages) {
  const int round = ch / stages;
  if (round > 0) bar_wait(ring.empty + ch % stages, (round - 1) & 1);
}

// Let KERNEL take `smem` bytes of dynamic shared memory on the current device, which the
// launch that follows runs on: cudaFuncSetAttribute acts on the current device alone, so the
// size allowed so far is kept for each device, and the attribute is set once for each larger
// size there.
constexpr int MAX_DEVICES = 64;

template <auto KERNEL>
int allow_smem(size_t smem) {
  static std::atomic<size_t> allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem <= allowed[dev].load()) return 0;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed[dev].store(smem);
  return (int)err;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoder, looked up once; the calling thread is first bound to its device's primary
// context (a driver call from a thread the runtime has not used yet, such as autograd's
// backward thread, finds no current context and fails with CUDA_ERROR_INVALID_CONTEXT).
inline int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled encode = nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (!encode) {
    void* found_fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found_fn, cudaEnableDefault,
                                  &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !found_fn) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)found_fn;
  }
  *fn = encode;
  return 0;
}

// The last maps encoded, by (device, base, dims, box rows, kind): a call whose tensors sit
// where the last call's did (the caching allocator hands the same blocks back) copies its maps
// instead of encoding them; a map encoded for one device is never served to a launch on
// another. A lock keeps calls from two host threads (a forward, autograd's backward thread)
// apart.
struct MapCache {
  std::mutex lock;
  struct Entry {
    int dev;
    const void* base;
    uint64_t d0, d1, d2;
    uint32_t rows, kind;
    CUtensorMap map;
  };
  static constexpr int SIZE = 64;
  Entry entries[SIZE] = {};
  int next = 0;
  const CUtensorMap* find(int dev, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                          uint32_t rows, uint32_t kind) const {
    for (const Entry& e : entries)
      if (e.base && e.dev == dev && e.base == base && e.d0 == d0 && e.d1 == d1 &&
          e.d2 == d2 && e.rows == rows && e.kind == kind)
        return &e.map;
    return nullptr;
  }
  void put(int dev, const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t rows,
           uint32_t kind, const CUtensorMap& map) {
    entries[next] = Entry{dev, base, d0, d1, d2, rows, kind, map};
    next = (next + 1) % SIZE;
  }
};

inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// The tensor map of a bf16 tensor [d2][d1][d0] (d0 innermost, contiguous) read in boxes of
// 64 x rows x 1 elements with the 128-byte swizzle (a box row is one 128-byte swizzle row);
// elements outside the tensor read as zero. Returns a CUDA error code, 0 on success.
inline int bf16_tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                           uint64_t d2, uint32_t rows) {
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(map_cache().lock);
  if (const CUtensorMap* hit = map_cache().find(dev, base, d0, d1, d2, rows, 0)) {
    *map = *hit;
    return 0;
  }
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};   // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {64, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "cuTensorMapEncodeTiled (bf16 [%llu][%llu][%llu] at %p, boxes of %u rows): "
            "CUresult %d\n", (unsigned long long)d2, (unsigned long long)d1,
            (unsigned long long)d0, base, rows, (int)r);
    return (int)cudaErrorInvalidValue;
  }
  map_cache().put(dev, base, d0, d1, d2, rows, 0, *map);
  return 0;
}

// The tensor map of a 32-bit tensor [d2][d1][d0] (f32 or bit words) read in boxes of
// box0 x rows x 1 (box0 a multiple of 4, no swizzle); elements outside the tensor read as zero.
inline int f32_tensor_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                          uint64_t d2, uint32_t box0, uint32_t rows) {
  const uint32_t kind = 1 + box0;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> guard(map_cache().lock);
  if (const CUtensorMap* hit = map_cache().find(dev, base, d0, d1, d2, rows, kind)) {
    *map = *hit;
    return 0;
  }
  EncodeTiled encode;
  const int err = encode_tiled(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {box0, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "cuTensorMapEncodeTiled (32-bit [%llu][%llu][%llu] at %p, boxes of %u x %u): "
            "CUresult %d\n", (unsigned long long)d2, (unsigned long long)d1,
            (unsigned long long)d0, base, box0, rows, (int)r);
    return (int)cudaErrorInvalidValue;
  }
  map_cache().put(dev, base, d0, d1, d2, rows, kind, *map);
  return 0;
}

}  // namespace
