// The deep-base stem tail in one pass, for Hopper (sm_90a):
//   c1 = relu(bn1(conv1(x)))   3x3, 64 -> 64, zero padding 1
//   c2 = relu(bn2(conv2(c1)))  3x3, 64 -> 128, zero padding 1
//   y  = maxpool(c2)           3x3, stride 2, padding 1
// on the NCHW output of conv0 (after its BN and ReLU), [n, 64, H, W] -> [n, 128, Hp, Wp],
// Hp = (H + 1) / 2, Wp = (W + 1) / 2. Inference only; the BNs come folded as f32
// (scale, bias) pairs [2, C]. Rounding points as the unfused eval ops (a conv in the
// storage type, then ops/norm.py:batch_norm_folded): the conv sums in f32 and rounds to
// the storage type, the affine runs in f32 (one fma) and rounds, then the ReLU. conv1
// results outside the image are 0 (conv2's zero padding), conv2 results outside it -inf
// (the pool's padding; post-ReLU values are >= 0 and every window holds a valid one).
//
// Replaces the TPU kernel tdnet_tpu/kernels/fused_stem.py: _fused_stem_kernel, reached
// through fused_stem_tail (stem_impl="fused" on deep-base backbones in eval).
//
// Bound by arithmetic: at TD2-PSP50 @1025x2049 the tail is
// 2 * 513 * 1025 * (9*64*64 + 9*64*128) = 116.3 GFLOP against about 101 MB in bf16 (the
// 64-channel input read once, the pooled 128-channel output written once): 0.118 ms on
// the tensor cores in bf16 (989 TFLOP/s), 0.705 ms in f32 with every product in 3xTF32
// on the tensor cores (495 / 3 TFLOP/s), 1.736 ms on the CUDA cores (67 TFLOP/s).
//
// Design: one kernel for both dtypes, templated on the product: bf16 on wgmma
// (m64n64k16, both operands from shared memory), f32 on mma.sync m16n8k8 in 3xTF32
// (tf32x3.cuh). A block owns a strip of PW pooled columns and a band of pooled rows, and
// marches down the band two image rows a step with rolling windows, so only the strip's
// column halo is computed twice:
//   - the input and conv1 results live in rings of 4 rows of RS = WT + 2 pixels, 64
//     channels a pixel; the 16-byte chunk c of a pixel at address a sits at c ^ ((a >> 7)
//     & 7), which is wgmma's 128-byte swizzle for bf16 and keeps ldmatrix free of bank
//     conflicts for f32. A conv is an implicit GEMM over GEMM row r * RS + c (two rows of
//     WT columns a pass; a tap (i, j) reads ring row r + i from column j on, so a wgmma
//     operand is a descriptor at a shifted address), and WT - (2 PW + 1) columns of each
//     row are computed and dropped;
//   - step k: conv1 of rows 2k, 2k + 1 (input rows 2k .. 2k + 3), then conv2 of the pair
//     before it in two halves of 64 output channels; the vertical max of the pool runs
//     in registers (a thread holds the same columns of both rows of a pair and carries
//     the pair's max to the next step), its row goes to the two conv1 rows that the step
//     freed, and the horizontal max reads it there and writes one pooled row, coalesced
//     along the row;
//   - the weights stream through a ring of chunks (bf16: 2 stages of a kernel row of 3
//     taps, [3][64 n][64 k]; f32: 3 stages of half a tap, [hi, lo][64 n][32 k]; rows of
//     128 B stored pre-swizzled by kernels/fused_stem.py) by cp.async.bulk on mbarriers,
//     one bulk copy a chunk, so the loads overlap the products across passes and steps;
//     a bf16 chunk's wgmma group runs on while the next chunk's is issued;
//   - the next two input rows come in as 16-byte cp.async vectors along W (aligned down,
//     the ragged end zero-filled) into a channel-major staging tile during the conv2
//     passes, and are transposed into the input ring between steps;
//   - f32: each chunk (32 input channels of one tap) sums its 3xTF32 products in a fresh
//     accumulator that is added in round-to-nearest f32 (the tensor core truncates as it
//     accumulates); activations are split into hi and lo as the fragments load.
// Each output is summed by one thread in a fixed order: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CIN = 64, CMID = 64, COUT = 128;
constexpr int THREADS = 256;   // 8 warps

// A weight chunk holds TAPS taps of 64 / SPLIT input channels (bf16: a row of the kernel,
// taps 3i .. 3i + 2; f32: half a tap, hi and lo), STAGE bytes, in a ring of STAGES.
struct Bf16 {
  typedef bf16 T;
  typedef __nv_bfloat162 T2;
  static constexpr int WT = 128;   // GEMM rows of one image row
  static constexpr int TAPS = 3, SPLIT = 1, STAGE = 24576, STAGES = 2;
};

struct F32 {
  typedef float T;
  typedef float2 T2;
  static constexpr int WT = 64;
  static constexpr int TAPS = 1, SPLIT = 2, STAGE = 16384, STAGES = 3;
};

template <class Tr>
struct Geo {
  static constexpr bool WG = sizeof(typename Tr::T) == 2;   // bf16 on wgmma
  static constexpr int ES = sizeof(typename Tr::T);
  static constexpr int PB = CIN * ES;              // bytes of a ring pixel
  static constexpr int VPB = COUT * ES;            // bytes of a pixel of the vertical max
  static constexpr int RS = Tr::WT + 2;            // ring row stride, pixels
  static constexpr int PW = (Tr::WT - 5) / 2;      // pooled columns a strip
  static constexpr int V = 16 / ES;                // elements of a 16-byte vector
  static constexpr int SPAN = (RS + 2 * (V - 1)) / V * V;   // staged elements a row
  static constexpr int CHUNKS = 9 * Tr::SPLIT / Tr::TAPS;   // weight chunks a pass
  // a thread's share of a pass's [2 rows][WT columns][64 channels]: columns col0 + 16 ct +
  // g + 8 h (ct < MT, h < 2) of both rows, channels ch0 + 8 nt + 2 t4 + {0, 1} (nt < NT):
  //   wgmma: 2 warpgroups along the columns, a warp 16 rows of a 64-pixel tile, 64 channels;
  //   mma.sync: 8 warps = 4 along the columns x 2 along the channels, 2 x 4 m16n8 tiles.
  static constexpr int MT = WG ? 1 : Tr::WT / 64;
  static constexpr int NT = WG ? 8 : 4;
  static constexpr int RING = 4 * RS * PB;
  static constexpr int XR = 0, CR = RING, WR = 2 * RING;   // input ring, conv1 ring, weights
  static constexpr int ST = WR + Tr::STAGES * Tr::STAGE;   // staging [2][64][SPAN]
  static constexpr int BAR = ST + 2 * CIN * SPAN * ES;     // an mbarrier a stage
  static constexpr int SMEM = BAR + 8 * Tr::STAGES;
  static_assert(Tr::WT * VPB <= 2 * RS * PB, "the vertical max fits in two conv1 rows");
  static_assert(2 * PW + 5 <= Tr::WT, "a strip's input columns fit in a ring row");
  static_assert(!WG || Tr::WT == 128, "wgmma: two 64-pixel tiles a row");
  static_assert(RING % 1024 == 0 && Tr::STAGE % 1024 == 0, "the swizzle's 1024-byte period");
  __device__ static int col0() {
    const int warp = threadIdx.x >> 5;
    return WG ? 64 * (warp >> 2) + 16 * (warp & 3) : (warp & 3) * (Tr::WT / 4);
  }
  __device__ static int ch0() { return WG ? 0 : 32 * (threadIdx.x >> 7); }
};

// ---- PTX helpers

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

// The shared-memory matrix descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes (64 bf16), groups of 8 rows 1024 bytes apart. The swizzle follows the address
// bits, so a tile may start at any row (a tap's shift) or 32-byte k step.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((saddr(p) >> 4) & 0x3FFF) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// d (a warpgroup's 64 x 64 f32 fragment: d[4 nt + e] as an m16n8 tile nt) += a b, bf16
// from shared memory: a 64 rows x 16 k, b 64 n x 16 k, both K-major
__device__ __forceinline__ void wgmma_64x64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
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

// 16 bytes global -> shared, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: `bytes` from global src to shared dst, completing on bar's current phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// A wait that outlasts any fill by orders of magnitude traps, so that a fault in the
// pipeline fails the launch instead of hanging the card.
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

// ---- the products of one weight chunk

// bf16: issue acc[r] += A x B for the chunk's 3 taps (i, j), r the pass's two rows. A, this
// warpgroup's 64-pixel tile of row r: ring row row0 + r + i from column 64 wg + j; B the
// stage `wst`. The caller commits and waits.
__device__ __forceinline__ void issue_wgmma(float (*acc)[8][4], const unsigned char* ring,
                                            int row0, int chunk, const unsigned char* wst) {
  using G = Geo<Bf16>;
  const int wg = threadIdx.x >> 7, i = chunk;   // chunk i holds taps (i, 0 .. 2)
#pragma unroll
  for (int j = 0; j < Bf16::TAPS; ++j) {
    uint64_t a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[r] = sw128_desc(ring + (((row0 + r + i) & 3) * G::RS + 64 * wg + j) * G::PB);
    const uint64_t b = sw128_desc(wst + j * 64 * 128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)   // k16 steps: 32 bytes, 2 in the descriptor's units
#pragma unroll
      for (int r = 0; r < 2; ++r) wgmma_64x64(&acc[r][0][0], a[r] + 2 * ks, b + 2 * ks);
  }
}

// f32: acc[mi][nt] += A x B in 3xTF32 for the chunk (32 input channels of one tap (i, j)),
// in a fresh accumulator added at the end. Warp (wm, wn): m-tiles mi (row r = mi / MT,
// column tile mi % MT) from ring row row0 + r + i, columns wm WT / 4 + 16 (mi % MT) + j
// on; n-tiles of channels 32 wn on.
__device__ __forceinline__ void chunk_tf32x3(float (*acc)[4][4], const unsigned char* ring,
                                             int row0, int chunk, const unsigned char* wst) {
  using G = Geo<F32>;
  constexpr int MT = G::MT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int tap = chunk / F32::SPLIT, kc0 = (chunk % F32::SPLIT) * 8, i = tap / 3, j = tap % 3;
  const int brow = 32 * wn + (lane & 7) + ((lane >> 4) << 3), bhalf = (lane >> 3) & 1;
  int pix[2 * MT];   // this lane's A row (pixel) of each m-tile
#pragma unroll
  for (int mi = 0; mi < 2 * MT; ++mi)
    pix[mi] = ((row0 + mi / MT + i) & 3) * G::RS + wm * (F32::WT / 4) + (mi % MT) * 16 +
              (lane & 15) + j;
  float part[2 * MT][4][4] = {};   // the chunk's chain
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {   // k8 steps: 32 bytes
    FragB bf[4];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int row = brow + 16 * np, ch = 2 * ks + bhalf;
      const unsigned char* p = wst + row * 128 + ((ch ^ (row & 7)) << 4);
      uint32_t r[4];
      ldsm_x4(r, p);
      bf[2 * np].hi[0] = r[0], bf[2 * np].hi[1] = r[1];
      bf[2 * np + 1].hi[0] = r[2], bf[2 * np + 1].hi[1] = r[3];
      ldsm_x4(r, p + 8192);
      bf[2 * np].lo[0] = r[0], bf[2 * np].lo[1] = r[1];
      bf[2 * np + 1].lo[0] = r[2], bf[2 * np + 1].lo[1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi) {
      const int ch = kc0 + 2 * ks + (lane >> 4);
      uint32_t a[4];
      ldsm_x4(a, ring + pix[mi] * G::PB + ((ch ^ (pix[mi] & 7)) << 4));
      FragA af;
#pragma unroll
      for (int q = 0; q < 4; ++q) split(__uint_as_float(a[q]), af.hi[q], af.lo[q]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma3(part[mi][nt], af, bf[nt]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2 * MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) flush(acc[mi][nt], part[mi][nt]);
}

// ---- the epilogue's arithmetic

// relu(round(fma(round(a), scale, bias))) of a channel pair, or `outside` for both
__device__ __forceinline__ __nv_bfloat162 bn_relu(float a0, float a1, const float (&sc)[2],
                                                  const float (&bi)[2], bool ok, float outside,
                                                  bf16) {
  if (!ok) return __floats2bfloat162_rn(outside, outside);
  const float v0 = fmaf(__bfloat162float(__float2bfloat16_rn(a0)), sc[0], bi[0]);
  const float v1 = fmaf(__bfloat162float(__float2bfloat16_rn(a1)), sc[1], bi[1]);
  return __floats2bfloat162_rn(fmaxf(__bfloat162float(__float2bfloat16_rn(v0)), 0.f),
                               fmaxf(__bfloat162float(__float2bfloat16_rn(v1)), 0.f));
}
__device__ __forceinline__ float2 bn_relu(float a0, float a1, const float (&sc)[2],
                                          const float (&bi)[2], bool ok, float outside, float) {
  if (!ok) return make_float2(outside, outside);
  return make_float2(fmaxf(fmaf(a0, sc[0], bi[0]), 0.f), fmaxf(fmaf(a1, sc[1], bi[1]), 0.f));
}

__device__ __forceinline__ __nv_bfloat162 max2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return __hmax2(a, b);
}
__device__ __forceinline__ float2 max2(float2 a, float2 b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}
__device__ __forceinline__ uint4 max_v(uint4 a, uint4 b, bf16) {
  uint32_t* pa = reinterpret_cast<uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 m = __hmax2(*reinterpret_cast<__nv_bfloat162*>(pa + q),
                               *reinterpret_cast<const __nv_bfloat162*>(pb + q));
    pa[q] = *reinterpret_cast<uint32_t*>(&m);
  }
  return a;
}
__device__ __forceinline__ uint4 max_v(uint4 a, uint4 b, float) {
  float* pa = reinterpret_cast<float*>(&a);
  const float* pb = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int q = 0; q < 4; ++q) pa[q] = fmaxf(pa[q], pb[q]);
  return a;
}

// the vertical max's pixel c: 16-byte chunks permuted by a Gray code of c, so that 8
// consecutive pixels and 8 consecutive even pixels fall on 8 different bank groups
__device__ __forceinline__ int vkey(int c) { return (c ^ (c >> 1)) & 7; }

// ---- the kernel

// Block (strip, band, image): pooled columns [pc0, pc0 + PW) of pooled rows
// [p0, p0 + band_rows) of image blockIdx.z. x [n, 64, H, W], y [n, 128, Hp, Wp] in T; wc the
// weight chunks (kernels/fused_stem.py:weight_chunks).
template <class Tr>
__global__ void __launch_bounds__(THREADS, 1)
stem_tc(const typename Tr::T* __restrict__ x, const unsigned char* __restrict__ wc,
        const float* __restrict__ sb1, const float* __restrict__ sb2, typename Tr::T* __restrict__ y,
        int n, int H, int W, int Hp, int Wp, int band_rows) {
  using G = Geo<Tr>;
  using T = typename Tr::T;
  using T2 = typename Tr::T2;
  constexpr int MT = G::MT, NT = G::NT, STAGES = Tr::STAGES, VECS = G::SPAN / G::V;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::BAR);
  const T* stg = reinterpret_cast<const T*>(smem + G::ST);

  const int pc0 = blockIdx.x * G::PW, p0 = blockIdx.y * band_rows;
  const int pb = min(band_rows, Hp - p0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int col0 = G::col0(), ch0 = G::ch0();
  const long long plane = (long long)H * W;
  const long long limit = (long long)(n - blockIdx.z) * CIN * plane;   // elements to x's end
  x += (size_t)blockIdx.z * CIN * plane;
  y += (size_t)blockIdx.z * COUT * Hp * Wp;
  const int x0 = 2 * pc0 - 3;   // image column of ring column 0 of the input
  const int xlo = max(x0, 0), xhi = min(x0 + G::RS, W);

  // weight chunk s of the block's sequence: step 0 runs conv1 only, every later step conv1
  // and both conv2 halves
  const int total = G::CHUNKS * (1 + 3 * (pb + 1));
  auto fill = [&](int s) {   // thread 0
    if (s >= total) return;
    const int q = s < G::CHUNKS ? s : (s - G::CHUNKS) % (3 * G::CHUNKS);
    bulk_load(smem + G::WR + (s % STAGES) * Tr::STAGE, wc + (size_t)q * Tr::STAGE, Tr::STAGE,
              bars + s % STAGES);
  };
  // input rows (2 p0 - 3 + w) .. + 1 -> staging, channel-major, each (row, channel) from
  // its aligned-down 16-byte vector on
  auto load_pair = [&](int w) {
    for (int e = threadIdx.x; e < 2 * CIN * VECS; e += THREADS) {
      const int v = e % VECS, c = (e / VECS) % CIN, rr = e / (VECS * CIN);
      const int yy = 2 * p0 - 3 + w + rr;
      if (yy < 0 || yy >= H || xlo >= xhi) continue;
      const long long lo = c * plane + (long long)yy * W + xlo, hi = lo + (xhi - xlo);
      const long long src = (lo & ~(long long)(G::V - 1)) + (long long)v * G::V;
      if (src >= hi) continue;
      cp_async_zfill(smem + G::ST + ((rr * CIN + c) * G::SPAN + v * G::V) * G::ES, x + src,
                     (int)min((long long)G::V, limit - src) * G::ES);
    }
    cp_commit();
  };
  // staging -> input ring rows w, w + 1 (pixel-major, swizzled), 0 outside the image
  auto store_pair = [&](int w) {
    constexpr int CV = CIN / G::V;
    const int plane_off = (int)(plane & (G::V - 1));
    for (int e = threadIdx.x; e < 2 * G::RS * CV; e += THREADS) {
      const int px = e % G::RS, cv = (e / G::RS) % CV, rr = e / (G::RS * CV);
      const int yy = 2 * p0 - 3 + w + rr, xx = x0 + px;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        // (row, channel c)'s staged row starts at x's element c plane + yy W + xlo aligned
        // down to a vector: that element sits (its index % V) into it
        const int row_off = (int)(((long long)yy * W + xlo) & (G::V - 1));
        T vals[G::V];
#pragma unroll
        for (int q = 0; q < G::V; ++q) {
          const int c = cv * G::V + q;
          vals[q] = stg[(rr * CIN + c) * G::SPAN + ((c * plane_off + row_off) & (G::V - 1)) +
                        (xx - xlo)];
        }
        v = *reinterpret_cast<const uint4*>(vals);
      }
      const int pix = ((w + rr) & 3) * G::RS + px;
      *reinterpret_cast<uint4*>(smem + G::XR + pix * G::PB + ((cv ^ (pix & 7)) << 4)) = v;
    }
    fence_async();
  };

  int s = 0;   // the next weight chunk to compute
  auto pass = [&](float (*acc)[NT][4], const unsigned char* ring, int row0) {
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < G::CHUNKS; ++c, ++s) {
      const unsigned char* wst = smem + G::WR + (s % STAGES) * Tr::STAGE;
      bar_wait(bars + s % STAGES, (s / STAGES) & 1);
      if constexpr (G::WG) {
        wgmma_fence();
        issue_wgmma(acc, ring, row0, c, wst);
        wgmma_commit();
        wgmma_wait<1>();   // chunk s - 1's products are done with their stage
      }
      __syncthreads();     // every warp is done with chunk s - 1: its stage may refill
      if (threadIdx.x == 0) {
        fence_async();
        fill(s + STAGES - 1);
      }
      if constexpr (!G::WG) chunk_tf32x3(acc, ring, row0, c, wst);
    }
    if constexpr (G::WG) wgmma_wait<0>();
  };
  // this thread's folded BN pairs for channels n0 + ch0 + 8 nt + 2 t4 + {0, 1} of sb
  // ([2, c]: scales, then biases)
  float sc[NT][2], bi[NT][2];
  auto bn_pairs = [&](const float* sb, int c, int n0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        sc[nt][q] = __ldg(sb + n0 + ch0 + 8 * nt + 2 * t4 + q);
        bi[nt][q] = __ldg(sb + c + n0 + ch0 + 8 * nt + 2 * t4 + q);
      }
  };

  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) bar_init(bars + i);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES - 1; ++i) fill(i);
  load_pair(0);
  cp_wait_all();
  __syncthreads();
  store_pair(0);
  __syncthreads();
  load_pair(2);
  cp_wait_all();
  __syncthreads();
  store_pair(2);
  __syncthreads();

  T2 carry[2][MT][NT][2];   // [half][column tile][n-tile][row g, g + 8]: the last pair's max
  T2 held[2][MT][NT][2];    // the pooled row's vertical max, until the conv1 rows are free
  float acc[2 * MT][NT][4];
#pragma unroll 1
  for (int k = 0; k <= pb + 1; ++k) {
    if (k <= pb) load_pair(2 * k + 4);
    // conv1 of rows 2k, 2k + 1 (image rows 2 p0 - 2 + 2k + r) -> conv1 ring, 0 outside
    pass(acc, smem + G::XR, 2 * k);
    bn_pairs(sb1, CMID, 0);
#pragma unroll
    for (int mi = 0; mi < 2 * MT; ++mi) {
      const int r = mi / MT, yy = 2 * p0 - 2 + 2 * k + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + (mi % MT) * 16 + g + 8 * h, xx = 2 * pc0 - 2 + c;
        const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
        const int pix = ((2 * k + r) & 3) * G::RS + c;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int byte = (ch0 + 8 * nt + 2 * t4) * G::ES;
          *reinterpret_cast<T2*>(smem + G::CR + pix * G::PB + (((byte >> 4) ^ (pix & 7)) << 4) +
                                 (byte & 15)) =
              bn_relu(acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1], sc[nt], bi[nt], ok, 0.f, T());
        }
      }
    }
    fence_async();
    if (k >= 1) {
      // conv2 of the pair j = k - 1 (image rows 2 p0 - 1 + 2j + r), two halves of 64 channels
      const int jp = k - 1, y0 = 2 * p0 - 1 + 2 * jp;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        pass(acc, smem + G::CR, 2 * jp);
        bn_pairs(sb2, COUT, 64 * hf);
#pragma unroll
        for (int ct = 0; ct < MT; ++ct)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int xx = 2 * pc0 - 1 + col0 + ct * 16 + g + 8 * h;
            const bool col = xx >= 0 && xx < W;
            const bool ok0 = col && y0 >= 0 && y0 < H, ok1 = col && y0 + 1 >= 0 && y0 + 1 < H;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const T2 v0 = bn_relu(acc[ct][nt][2 * h], acc[ct][nt][2 * h + 1], sc[nt], bi[nt],
                                    ok0, -INFINITY, T());
              const T2 v1 = bn_relu(acc[MT + ct][nt][2 * h], acc[MT + ct][nt][2 * h + 1], sc[nt],
                                    bi[nt], ok1, -INFINITY, T());
              if (jp >= 1) held[hf][ct][nt][h] = max2(carry[hf][ct][nt][h], v0);
              carry[hf][ct][nt][h] = max2(v0, v1);
            }
          }
      }
    }
    if (k <= pb) cp_wait_all();   // the staged input rows
    __syncthreads();               // every warp is done with the rings' rows that go now
    if (k <= pb) store_pair(2 * k + 4);
    const int pr = p0 + k - 2;     // the pooled row of this step
    unsigned char* vmax = smem + G::CR + ((2 * k - 2) & 3) * G::RS * G::PB;
    if (k >= 2) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int ct = 0; ct < MT; ++ct)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = col0 + ct * 16 + g + 8 * h;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int byte = (64 * hf + ch0 + 8 * nt + 2 * t4) * G::ES;
              *reinterpret_cast<T2*>(vmax + c * G::VPB + (((byte >> 4) ^ vkey(c)) << 4) +
                                     (byte & 15)) = held[hf][ct][nt][h];
            }
          }
    }
    __syncthreads();
    if (k >= 2) {
      // horizontal max: pooled column jj takes vertical-max columns 2jj .. 2jj + 2
      constexpr int CV = COUT / G::V;
      for (int e = threadIdx.x; e < G::PW * CV; e += THREADS) {
        const int jj = e % G::PW, cv = e / G::PW, pc = pc0 + jj;
        if (pc >= Wp) continue;
        uint4 m = *reinterpret_cast<const uint4*>(vmax + 2 * jj * G::VPB +
                                                  ((cv ^ vkey(2 * jj)) << 4));
#pragma unroll
        for (int d = 1; d < 3; ++d) {
          const int c = 2 * jj + d;
          m = max_v(m, *reinterpret_cast<const uint4*>(vmax + c * G::VPB + ((cv ^ vkey(c)) << 4)),
                    T());
        }
        const T* mv = reinterpret_cast<const T*>(&m);
#pragma unroll
        for (int q = 0; q < G::V; ++q)
          y[((size_t)(cv * G::V + q) * Hp + pr) * Wp + pc] = mv[q];
      }
    }
  }
}

template <class Tr>
int launch(const void* x, const void* wc, const void* sb1, const void* sb2, void* y, int n, int H,
           int W, int strips, int band_rows, cudaStream_t st) {
  using G = Geo<Tr>;
  const int Hp = (H + 1) / 2, Wp = (W + 1) / 2;
  const int bands = (Hp + band_rows - 1) / band_rows;
  if (strips != (Wp + G::PW - 1) / G::PW || band_rows < 1 || bands > 65535 || n > 65535 ||
      ((uintptr_t)x | (uintptr_t)wc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stem_tc<Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::SMEM);
  if (err != cudaSuccess) return (int)err;
  stem_tc<Tr><<<dim3(strips, bands, n), THREADS, G::SMEM, st>>>(
      (const typename Tr::T*)x, (const unsigned char*)wc, (const float*)sb1, (const float*)sb2,
      (typename Tr::T*)y, n, H, W, Hp, Wp, band_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, 64, H, W], y [n, 128, (H + 1) / 2, (W + 1) / 2] in the storage type (dtype 0:
// float32, 1: bfloat16), contiguous; x 16-byte aligned. wc the weight chunks as
// kernels/fused_stem.py:weight_chunks lays them out, 16-byte aligned; sb1 [2, 64] and sb2
// [2, 128] f32 (scale row, then bias row). The grid: `strips` strips of PW pooled columns
// (61 bf16, 29 f32) across (the exact count, else refused), bands of `band_rows` pooled
// rows down, n images. Returns the first CUDA error, 0 if none; a launch it refuses (a
// misaligned x, a wrong strip count) returns cudaErrorInvalidValue.
int tdnet_fused_stem(const void* x, const void* wc, const void* sb1, const void* sb2, void* y,
                     int n, int H, int W, int dtype, int strips, int band_rows, void* stream) {
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch<Bf16>(x, wc, sb1, sb2, y, n, H, W, strips, band_rows, st);
  if (dtype == 0) return launch<F32>(x, wc, sb1, sb2, y, n, H, W, strips, band_rows, st);
  return (int)cudaErrorInvalidValue;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
