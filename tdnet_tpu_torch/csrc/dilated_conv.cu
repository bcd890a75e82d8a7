// Stride-1 dilated 3x3 convolution for Hopper (sm_90a) on the tensor cores, f32 and bf16:
//   y[b, o, h, w] = sum_{c, i, j} x[b, c, h + i*d - p, w + j*d - p] * w[o, c, i, j]
// with zeros outside the image. The data gradient of such a conv is the same conv of dy
// with the spatially flipped, IO-swapped kernel and padding d*(k-1) - p, so this one
// kernel serves the forward and the dgrad (the weight pass flips and swaps, `flip`).
//
// Replaces the TPU kernel tdnet_tpu/kernels/dilated_conv.py: _dil_kernel, reached through
// conv2d_pallas_dil (the residual blocks' 3x3 convs with dilation >= 4 in training,
// conv_wgrad="pallas"), which writes the input's dtype: f32, or bf16 in the mixed-precision
// recipe. Both sum every product in f32 and round once to the output's dtype, as the TPU
// kernel does (preferred_element_type=f32, then .astype).
//
// Bound by arithmetic: at the TD4-PSP18 recipe's layer4 (97 x 193 grid, 512 -> 512)
// one conv is 2 * 18,721 * 9 * 512 * 512 = 88.3 GFLOP against 38 + 38 + 9 MB of x, y
// and weights in f32 (half that in bf16): f32 1.318 ms on the CUDA cores (67 TFLOP/s),
// 0.535 ms with every product in 3xTF32 on the tensor cores (495 / 3 TFLOP/s); bf16 0.089 ms
// at 989 TFLOP/s; memory traffic 0.025 ms (f32) or 0.013 ms (bf16) at 3.35 TB/s.
//
// Design: an implicit GEMM in three launches, two prep passes shared by both precisions and
// a main kernel for each:
//   1. prep_input (bf16: prep_input_bf16): one read of x (NCHW) writes NHWC images
//      zero-padded by p on every side (Hp x Wp), channels rounded up to a multiple of BK with
//      zeros, and enough zero rows below that the last tile's reads stay in range. f32 splits
//      each value into hi = rna_tf32(v) and lo = rna_tf32(v - hi) (3xTF32, tf32x3.cuh), so no
//      main loop splits.
//   2. prep_weights: w (OIHW) -> [9, Np, Kp], K-contiguous, zero-padded; for the dgrad the
//      same pass flips the taps and swaps O and I.
//   3. Output pixel (h, w) is GEMM row h*Wp + w, for w over the whole padded width, so tap
//      (i, j) reads A rows shifted by the constant i*d*Wp + j*d: every A tile is a plain
//      rectangle of the padded input, with no gather and no mask. Rows with w >= Wo are
//      computed and dropped in the epilogue (2d / Wp extra work: 4% at d4, 8% at d8 and 14%
//      at d16 on the 193-wide grid). M = Ho*Wp, N = co, K = 9 * Kp; a block owns 128 rows x
//      128 channels. A tile row is 128 bytes (32 f32 or 64 bf16 channels), stored in the
//      128-byte swizzle (the 16-byte chunk c of row r at c ^ (r % 8)).
//      dil_tc<F32>: mma.sync m16n8k8 in 3xTF32, 8 warps (64 x 32 each), stages of one tap
//      and 32 channels loaded by all threads with 16-byte cp.async into a 3-stage ring of
//      A hi, A lo, B hi, B lo (192 KB, one block an SM), fragments by ldmatrix.
//      dil_wgmma (bf16, k5:: below): wgmma m64n128k16 with both operands in shared memory,
//      fed by TMA; stages of one tap and 64 channels, tap-major as dil_tc's.
//   The tensor core truncates as it accumulates, so each chain is short: a stage's 4 k-steps
//   (f32: three products each, lo*hi, hi*lo, hi*hi; bf16: one), started from zero and added
//   to the tile's sum in round-to-nearest f32, stage after stage. One chain over all
//   9 * Kp / 16 bf16 k-steps put 0.13-0.25% of the outputs off the plain version's bits, with
//   a mean rounding bias up to 100x the plain version's; chains of 64 channels put 0.02% off,
//   with the plain version's bias (PERF.md §6). Each output element is summed by one thread
//   in a fixed order, with no split-K and no atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // GEMM rows (padded-width output pixels) per block
constexpr int BN = 128;        // output channels per block
constexpr int ROW = 128;       // bytes of a tile row: BK elements
constexpr int THREADS = 256;   // dil_tc: 8 warps, 2 along M (64 rows) x 4 along N (32 channels)
constexpr int TILE = BM * ROW; // bytes of one operand tile (BM == BN)
constexpr int YS = BM + 4;     // row stride of the epilogue's [BN][YS] f32 tile
constexpr int PT = 32;         // the prep passes' square tile
constexpr int BK_BF16 = ROW / 2;   // bf16 channels a stage

static_assert(BM == BN, "A and B tiles share one layout");

// dil_tc's precision: element type, operand tiles per matrix (hi and lo), channels of a
// stage, stages in the ring
struct F32 {
  using T = float;
  static constexpr int OPS = 2, BK = ROW / 4, STAGES = 3;
};

template <class P>
constexpr size_t smem_bytes() {
  return (size_t)P::STAGES * 2 * P::OPS * TILE;
}
static_assert(BN * YS * 4 <= smem_bytes<F32>(), "the epilogue's tile fits in the ring");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Store v at i. F32: v = hi + lo, both TF32 values stored as f32, hi = rna_tf32(v),
// lo = rna_tf32(v - hi). Bf16: v (a bf16 value, so exact) into hi; lo is unused.
__device__ __forceinline__ void put(float v, float* hi, float* lo, size_t i) {
  const float h = __uint_as_float(rna_tf32(v));
  hi[i] = h;
  lo[i] = __uint_as_float(rna_tf32(v - h));
}
__device__ __forceinline__ void put(float v, bf16* hi, bf16*, size_t i) {
  hi[i] = __float2bfloat16_rn(v);
}

// x [n, C, H, W] -> xh (, xl) [n, R, Kp] with R = gridDim.y * Wp: row hp * Wp + wp holds
// x[b, :, hp - pad, wp - pad], zero outside the image and for channels >= C. A block
// transposes a tile of 32 padded columns x 32 channels of one padded row through shared
// memory: reads coalesced along w, writes along channels.
template <class T>
__global__ void __launch_bounds__(THREADS)
prep_input(const T* __restrict__ x, T* __restrict__ xh, T* __restrict__ xl, int C, int H,
           int W, int Kp, int Wp, int pad) {
  __shared__ float s[PT][PT + 1];
  const int w0 = blockIdx.x * PT, hp = blockIdx.y, kt = Kp / PT;
  const int b = blockIdx.z / kt, c0 = (blockIdx.z % kt) * PT;
  const int tx = threadIdx.x % PT, ty = threadIdx.x / PT;
  const int h = hp - pad, w = w0 + tx - pad;
  const bool inside = h >= 0 && h < H && w >= 0 && w < W;
  for (int i = ty; i < PT; i += THREADS / PT) {
    const int c = c0 + i;
    s[i][tx] = inside && c < C ? to_f32(x[(((size_t)b * C + c) * H + h) * W + w]) : 0.f;
  }
  __syncthreads();
  const size_t rows = (size_t)gridDim.y * Wp;
  for (int i = ty; i < PT && w0 + i < Wp; i += THREADS / PT)
    put(s[tx][i], xh, xl, ((size_t)b * rows + (size_t)hp * Wp + w0 + i) * Kp + c0 + tx);
}

// The same for bf16 (xs [n, R, Kp], Kp a multiple of 64), in tiles of 64 padded columns x 64
// channels of one padded row, each thread reading 16 values, so that enough reads are in
// flight: reads coalesced along w, two channels a thread packed into one word of the staging
// tile [64 columns][33 words] (no bank conflicts either way), writes of a pixel's 64 channels
// (128 bytes) by one warp.
__global__ void __launch_bounds__(THREADS)
prep_input_bf16(const bf16* __restrict__ x, bf16* __restrict__ xs, int C, int H, int W, int Kp,
                int Wp, int pad) {
  __shared__ uint32_t s[2 * PT][PT + 1];
  const int w0 = blockIdx.x * 2 * PT, hp = blockIdx.y, kt = Kp / (2 * PT);
  const int b = blockIdx.z / kt, c0 = (blockIdx.z % kt) * 2 * PT;
  const int lane = threadIdx.x % PT, warp = threadIdx.x / PT, h = hp - pad;
  for (int i = warp; i < PT; i += THREADS / PT)   // channels c0 + 2i, + 1
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = lane + PT * k, w = w0 + p - pad, c = c0 + 2 * i;
      const bool inside = h >= 0 && h < H && w >= 0 && w < W;
      const size_t at = (((size_t)b * C + c) * H + h) * W + w;
      const bf16 zero = __float2bfloat16_rn(0.f);
      __nv_bfloat162 v;
      v.x = inside && c < C ? x[at] : zero;
      v.y = inside && c + 1 < C ? x[at + (size_t)H * W] : zero;
      s[p][i] = *reinterpret_cast<uint32_t*>(&v);
    }
  __syncthreads();
  uint32_t* out = reinterpret_cast<uint32_t*>(xs + ((size_t)b * gridDim.y + hp) * Wp * Kp + c0);
  for (int p = warp; p < 2 * PT && w0 + p < Wp; p += THREADS / PT)
    out[(size_t)(w0 + p) * (Kp / 2) + lane] = s[p][lane];
}

// w [wo, wi, 3, 3] -> wh (, wl) [9, Np, Kp]: B[t, n, k] = w[n, k, t] (forward: N = wo,
// K = wi) or, with flip, w[k, n, 8 - t] (dgrad: N = wi, K = wo), zero beyond N and K. A
// block stages the 32 x 288 contiguous values of 32 of w's rows and writes a 32 x 32 (n, k)
// tile of all 9 taps.
template <class T>
__global__ void __launch_bounds__(THREADS)
prep_weights(const T* __restrict__ w, T* __restrict__ wh, T* __restrict__ wl, int wo, int wi,
             int Np, int Kp, int flip) {
  __shared__ float s[PT][PT * 9 + 1];
  const int n0 = blockIdx.y * PT, k0 = blockIdx.x * PT;
  const int o0 = flip ? k0 : n0, c0 = flip ? n0 : k0;   // the tile's rows are w's o
  for (int e = threadIdx.x; e < PT * PT * 9; e += THREADS) {
    const int r = e / (PT * 9), q = e % (PT * 9), o = o0 + r, c = c0 + q / 9;
    s[r][q] = o < wo && c < wi ? to_f32(w[((size_t)o * wi + c0) * 9 + q]) : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * PT * PT; e += THREADS) {
    const int t = e / (PT * PT), n = (e / PT) % PT, k = e % PT;
    const float v = flip ? s[k][n * 9 + 8 - t] : s[n][k * 9 + t];
    put(v, wh, wl, ((size_t)t * Np + n0 + n) * Kp + k0 + k);
  }
}

// The 16-byte chunk `chunk` of row r of a [rows][ROW bytes] tile is stored at byte
// r * ROW + 16 ((chunk ^ (r % 8))): the chunks of a row are permuted by the row's low bits,
// so the 8 rows of an ldmatrix matrix hit 8 different bank groups.
__device__ __forceinline__ int tile_offset(int r, int chunk) {
  return r * ROW + ((chunk ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm4(uint32_t f[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void store(float* y, size_t i, float v) { y[i] = v; }

// y[b, n, h, w] for GEMM rows m = h * Wp + w in [m0, m0 + BM) and channels n in
// [n0, n0 + BN): sum over the 9 taps and Kp channels of A[m + tap offset, k] B[tap, n, k],
// A = the padded input of image b = blockIdx.z (R rows; xh + xl), B = the weights
// (wh + wl). Stages run tap-major, BK channels each.
template <class P>
__global__ void __launch_bounds__(THREADS, 1)
dil_tc(const typename P::T* __restrict__ xh, const typename P::T* __restrict__ xl,
       const typename P::T* __restrict__ wh, const typename P::T* __restrict__ wl,
       typename P::T* __restrict__ y, int Kp, int Np, int co, int Ho, int Wo, int Wp, int R,
       int dil) {
  using T = typename P::T;
  constexpr int OPS = P::OPS, BK = P::BK, STAGES = P::STAGES, E = 16 / sizeof(T);
  // [STAGES][A (hi, lo), B (hi, lo)][TILE bytes]
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int kc = Kp / BK, steps = 9 * kc, M = Ho * Wp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const T* xs[2] = {xh + (size_t)b * R * Kp, (OPS == 2 ? xl : xh) + (size_t)b * R * Kp};
  const T* ws[2] = {wh, OPS == 2 ? wl : wh};
  y += (size_t)b * co * Ho * Wo;

  // loads: this thread's 16-byte chunk e & 7 of rows e >> 3, e = tid + 256 i (i < 4), the
  // same offsets in every tile
  int so[4], go[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e >> 3, ch = e & 7;
    so[i] = tile_offset(r, ch);
    go[i] = r * Kp + ch * E;
  }
  auto load_stage = [&](int s) {
    const int tap = s / kc, c0 = (s - tap * kc) * BK;
    const int off = (tap / 3) * dil * Wp + (tap % 3) * dil;
    unsigned char* st = smem + (s % STAGES) * 2 * OPS * TILE;
    const size_t a0 = (size_t)(m0 + off) * Kp + c0, b0 = ((size_t)tap * Np + n0) * Kp + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < OPS; ++o) {
        cp_async16((float*)(st + o * TILE + so[i]), (const float*)(xs[o] + a0 + go[i]), true);
        cp_async16((float*)(st + (OPS + o) * TILE + so[i]), (const float*)(ws[o] + b0 + go[i]),
                   true);
      }
  };

  // fragments: A rows 64 wm + 16 mi (mi < 4) by ldmatrix.x4 (lanes 0-15 rows of k half 0,
  // 16-31 of half 1); B channels 32 wn + 16 np (np < 2), two n8 tiles an ldmatrix.x4
  // (lanes 8-15 and 24-31 give k half 1). A k-step is two 16-byte chunks: 8 f32.
  const int a_row = 64 * wm + (lane & 7) + (lane & 8), a_half = lane >> 4;
  const int b_row = 32 * wn + (lane & 7) + ((lane >> 4) << 3), b_half = (lane >> 3) & 1;

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait_group<STAGES - 2>();
    __syncthreads();   // stage s landed everywhere; the slot of stage s - 1 is free
    if (s + STAGES - 1 < steps) load_stage(s + STAGES - 1);
    cp_commit();
    const unsigned char* st = smem + (s % STAGES) * 2 * OPS * TILE;
    float t[4][4][4] = {};   // this stage's chain, from zero
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragB bf[4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int o = tile_offset(b_row + 16 * np, 2 * kk + b_half);
        uint32_t r[4];
        ldsm4(r, st + 2 * TILE + o);
        bf[2 * np].hi[0] = r[0], bf[2 * np].hi[1] = r[1];
        bf[2 * np + 1].hi[0] = r[2], bf[2 * np + 1].hi[1] = r[3];
        ldsm4(r, st + 3 * TILE + o);
        bf[2 * np].lo[0] = r[0], bf[2 * np].lo[1] = r[1];
        bf[2 * np + 1].lo[0] = r[2], bf[2 * np + 1].lo[1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int o = tile_offset(a_row + 16 * mi, 2 * kk + a_half);
        FragA af;
        ldsm4(af.hi, st + o);
        ldsm4(af.lo, st + TILE + o);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma3(t[mi][ni], af, bf[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) flush(acc[mi][ni], t[mi][ni]);
  }

  // epilogue: the tile through shared memory as [channel][row] in f32, then each warp writes
  // channels warp + 8 j, its lanes consecutive rows, dropping rows with w >= Wo or h >= Ho
  cp_wait_all();
  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wm + 16 * mi + g + 8 * h, c = 32 * wn + 8 * ni + 2 * t4;
        ys[c * YS + r] = acc[mi][ni][2 * h];
        ys[(c + 1) * YS + r] = acc[mi][ni][2 * h + 1];
      }
  __syncthreads();
  int dst[BM / 32];   // this lane's rows' offsets in a channel plane of y, -1 if dropped
#pragma unroll
  for (int q = 0; q < BM / 32; ++q) {
    const int m = m0 + lane + 32 * q, h = m / Wp, w = m - h * Wp;
    dst[q] = m < M && w < Wo ? h * Wo + w : -1;
  }
  const size_t plane = (size_t)Ho * Wo;
  for (int c = warp; c < BN && n0 + c < co; c += THREADS / 32)
#pragma unroll
    for (int q = 0; q < BM / 32; ++q)
      if (dst[q] >= 0) store(y, (size_t)(n0 + c) * plane + dst[q], ys[c * YS + lane + 32 * q]);
}

// ---------------------------------------------------------------------------
// bf16 (hopper.cuh): dil_wgmma, a producer warpgroup (one thread issues the TMA copies) and
// two consumer warpgroups (64 GEMM rows each, all 128 channels: a 64-register accumulator a
// thread) on a ring of STAGES mbarriered stages, as K1's bf16 kernels
// (propagation_attention.cu). A stage is one tap and 64 channels, tap-major as dil_tc's: the
// tap's [128 rows][64] box of the padded input (at its row shift) and its [128 n][64 k]
// weights. Its 4 k16 steps run as one wgmma group into a fresh 64-register chain; the next
// stage's group is issued into the other chain before this one is added to the sum, so the
// tensor cores run on while the CUDA cores add. Each output is the sum of the same chains in
// the same order as the mma.sync kernel this one replaced, and comes out with its bits
// (PERF.md §6): a stage of one kernel row (a box of BM + 2d rows serving its three taps, A
// from L2 once a row instead of once a tap) summed in another order, and phase 16 of
// chip_smoke.py, which holds the bf16 recipe's gradients to a float64 run, failed it. A
// consumer's wait that gives up sets the error word `fault` and exits (bar_wait_or_flag, as
// K1's; a trap makes ptxas spill in a warpgroup that takes registers by setmaxnreg; the exit
// makes it wait for each wgmma as it issues (C7518), which measured no slower here than a wait
// that goes on, PERF.md §6); the host reads the word where it synchronizes
// (kernels/fault.py:check_fault). A build with -DTDNET_K5_STARVE (and few
// TDNET_CONSUMER_POLLS) has producers that fill nothing, for the check that the word is
// reported (chip_smoke.py phase 13b). The epilogue writes y from the accumulators' registers,
// NCHW: a warp's store covers 8 consecutive pixels of 4 channels.
// ---------------------------------------------------------------------------

namespace k5 {

constexpr int CONSUMERS = 2;                  // warpgroups, 64 GEMM rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 24;             // registers a producer thread keeps
constexpr int CONSUMER_REGS = 240;            // and a consumer thread takes
constexpr int A_BYTES = BM * ROW;             // a stage: the input box, then the weights
constexpr int STAGE = A_BYTES + BN * ROW;
constexpr int STAGES = 4;                     // 6 measured slower at d4 (PERF.md §6)
constexpr int SMEM = 1024 + STAGES * (STAGE + 16) + 8;   // ring_smem(STAGES, STAGE, 0)
static_assert(SMEM <= 232448, "the ring fits a block's shared memory");

// Block (x, y, z): channels [BN x, + BN) and GEMM rows [BM y, + BM) of image z. Stage s is
// tap t = s / kc and channels [64 c, + 64), c = s % kc: the padded input's rows
// [BM y + (t / 3) d Wp + (t % 3) d, + BM) through tm_x ([n][R][Kp], boxes of 64 x BM) and tap
// t's weights through tm_w ([9][Np][Kp], boxes of 64 x BN).
__global__ void __launch_bounds__(THREADS, 1)
dil_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
          bf16* __restrict__ y, unsigned int* __restrict__ fault, int kc, int co, int Ho, int Wo,
          int Wp, int dil) {
  extern __shared__ unsigned char smem_k5[];
  const int steps = 9 * kc;
  const Ring ring(smem_k5, STAGES, STAGE, 0);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  init_ring<CONSUMERS>(ring, STAGES);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_K5_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x != 0) return;
    for (int s = 0; s < steps; ++s) {
      wait_free(ring, s, STAGES);
      const int tap = s / kc, c0 = (s - tap * kc) * BK_BF16;
      unsigned char* st = ring.base + (s % STAGES) * STAGE;
      uint64_t* full = ring.full + s % STAGES;
      bar_expect(full, STAGE);
      tma_load_3d(st, &tm_x, c0, m0 + (tap / 3) * dil * Wp + (tap % 3) * dil, b, full);
      tma_load_3d(st + A_BYTES, &tm_w, c0, n0, tap, full);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();
  const int cg = role - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  int in = 0, out = 0;     // the ring slots of the next stage to issue and of the oldest issued
  uint32_t in_phase = 0;   // the full barrier's phase of the next stage to issue
  // Wait for the next stage, then issue its chain into c as one wgmma group: 4 k16 steps, the
  // first with scale-d 0 (the chain starts from zero).
  auto issue = [&](float* c) {
    bar_wait_or_flag(ring.full + in, in_phase, fault);
    const unsigned char* st = ring.base + in * STAGE;
    const uint64_t a = sw128_desc(st + 64 * cg * ROW), w = sw128_desc(st + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 32 bytes a step: 2 in the descriptor's units
      wgmma_ss_128<0>(c, a + 2 * kk, w + 2 * kk, kk);
    wgmma_commit();
    if (++in == STAGES) in = 0, in_phase ^= 1;
  };
  float acc[64], c0[64], c1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // The oldest stage's chain, retired by a wait: free its slot and add the chain to the sum.
  auto retire = [&](float* c) {
    fence_regs<64>(c);
    if (lane == 0) bar_arrive(ring.empty + out);
    if (++out == STAGES) out = 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += c[i];
  };
  // Stage s + 1's chain is issued before stage s's is added. The loop issues unconditionally,
  // two stages a turn, so each chain's registers are the same at every turn: ptxas serializes
  // every wgmma of the kernel when it cannot follow which group an accumulator belongs to
  // (C7514; PERF.md §6).
  issue(c0);
  int s = 0;
  for (; s + 2 < steps; s += 2) {   // stage s's chain in c0, in flight
    issue(c1);
    wgmma_wait<1>();
    retire(c0);
    issue(c0);
    wgmma_wait<1>();
    retire(c1);
  }
  if (s + 1 < steps) {   // two stages left
    issue(c1);
    wgmma_wait<1>();
    retire(c0);
    wgmma_wait<0>();
    retire(c1);
  } else {
    wgmma_wait<0>();
    retire(c0);
  }

  // acc[4 j + 2 h + e]: GEMM row 16 warp + g + 8 h of the warpgroup's 64, channel 8 j + 2 t + e
  const int g = lane >> 2, t = lane & 3;
  const size_t plane = (size_t)Ho * Wo;
  y += (size_t)b * co * plane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * cg + 16 * warp + g + 8 * h, r = m / Wp, w = m - r * Wp;
    if (r >= Ho || w >= Wo) continue;
    bf16* yp = y + (size_t)r * Wo + w;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 8 * j + 2 * t + e;
        if (c < co) yp[(size_t)c * plane] = __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
      }
  }
}

}  // namespace k5

int ceil_to(int a, int m) { return (a + m - 1) / m * m; }

// The geometry of one conv and the checks both precisions make of its plan: 0, or
// cudaErrorInvalidValue for a plan that does not fit the tiles.
struct Geometry {
  int Hp, Wp, Ho, Wo;
  long long tiles;
  Geometry(int H, int W, int pad, int dil)
      : Hp(H + 2 * pad), Wp(W + 2 * pad), Ho(Hp - 2 * dil), Wo(Wp - 2 * dil),
        tiles(((long long)Ho * Wp + BM - 1) / BM) {}
  int check(int n, int cin, int cout, int dil, int hr, int Kp, int Np, int bk) const {
    const bool bad =
        n < 1 || n > 65535 || cin < 1 || cout < 1 || Ho < 1 || Wo < 1 || dil < 1 || hr < Hp ||
        Kp != ceil_to(cin, bk) || Np != ceil_to(cout, BN) || tiles > 65535 ||
        (long long)hr * Wp < tiles * BM + 2LL * dil * Wp + 2 * dil ||
        (long long)n * (Kp / PT) > 65535 || (long long)hr * Wp >= (1LL << 31);
    return bad ? (int)cudaErrorInvalidValue : 0;
  }
};

}  // namespace

extern "C" {

// y = the dilated conv of x [n, cin, H, W] with w, contiguous, f32:
//   flip = 0: w [cout, cin, 3, 3] (the forward);
//   flip = 1: w [cin, cout, 3, 3], used flipped and IO-swapped (the dgrad: x is dy).
// y [n, cout, Ho, Wo], Ho = H + 2 pad - 2 dil, Wo = W + 2 pad - 2 dil. Scratch, 16-byte
// aligned, sized by kernels/dilated_conv.py: conv_plan: xh, xl [n, hr * Wp, Kp] and wh, wl
// [9, Np, Kp] f32, Wp = W + 2 pad, Kp = cin rounded up to 32, Np = cout rounded up to BN;
// hr padded rows, enough that the last row tile's reads stay in range. A plan that does
// not fit these tiles is refused. Returns the first failed launch's CUDA error, 0 if none.
int tdnet_dilated_conv(const void* x, const void* w, void* xh, void* xl, void* wh, void* wl,
                       void* y, int n, int cin, int cout, int H, int W, int pad, int dil,
                       int flip, int hr, int Kp, int Np, void* stream) {
  const Geometry g(H, W, pad, dil);
  int err = g.check(n, cin, cout, dil, hr, Kp, Np, F32::BK);
  if (err == 0 && ((uintptr_t)xh | (uintptr_t)xl | (uintptr_t)wh | (uintptr_t)wl) % 16 != 0)
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  prep_input<float><<<dim3((g.Wp + PT - 1) / PT, hr, n * (Kp / PT)), THREADS, 0, st>>>(
      (const float*)x, (float*)xh, (float*)xl, cin, H, W, Kp, g.Wp, pad);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  prep_weights<float><<<dim3(Kp / PT, Np / PT), THREADS, 0, st>>>(
      (const float*)w, (float*)wh, (float*)wl, flip ? cin : cout, flip ? cout : cin, Np, Kp,
      flip);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  constexpr int smem = (int)smem_bytes<F32>();
  if ((err = allow_smem<dil_tc<F32>>(smem)) != 0) return err;
  dil_tc<F32><<<dim3(Np / BN, (unsigned)g.tiles, n), THREADS, smem, st>>>(
      (const float*)xh, (const float*)xl, (const float*)wh, (const float*)wl, (float*)y, Kp, Np,
      cout, g.Ho, g.Wo, g.Wp, hr * g.Wp, dil);
  return (int)cudaGetLastError();
}

// The same in bf16: x, w and y bf16; one scratch each, xs [n, hr * Wp, Kp] and ws [9, Np, Kp]
// bf16, Kp = cin rounded up to 64; `fault` the error word (one uint32 of device memory, which
// a consumer warpgroup that gives up on a barrier sets to 1).
int tdnet_dilated_conv_bf16(const void* x, const void* w, void* xs, void* ws, void* y,
                            void* fault, int n, int cin, int cout, int H, int W, int pad,
                            int dil, int flip, int hr, int Kp, int Np, void* stream) {
  const Geometry g(H, W, pad, dil);
  int err = g.check(n, cin, cout, dil, hr, Kp, Np, BK_BF16);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  prep_input_bf16<<<dim3((g.Wp + 2 * PT - 1) / (2 * PT), hr, n * (Kp / (2 * PT))), THREADS, 0,
                    st>>>((const bf16*)x, (bf16*)xs, cin, H, W, Kp, g.Wp, pad);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  prep_weights<bf16><<<dim3(Kp / PT, Np / PT), THREADS, 0, st>>>(
      (const bf16*)w, (bf16*)ws, nullptr, flip ? cin : cout, flip ? cout : cin, Np, Kp, flip);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  CUtensorMap tx, tw;
  if ((err = bf16_tensor_map(&tx, xs, Kp, (uint64_t)hr * g.Wp, n, BM)) != 0 ||
      (err = bf16_tensor_map(&tw, ws, Kp, Np, 9, BN)) != 0 ||
      (err = allow_smem<k5::dil_wgmma>(k5::SMEM)) != 0)
    return err;
  k5::dil_wgmma<<<dim3(Np / BN, (unsigned)g.tiles, n), k5::THREADS, k5::SMEM, st>>>(
      tx, tw, (bf16*)y, (unsigned int*)fault, Kp / BK_BF16, cout, g.Ho, g.Wo, g.Wp, dil);
  return (int)cudaGetLastError();
}

// dil_wgmma's registers a thread at launch (the consumers take CONSUMER_REGS by setmaxnreg)
// and its local memory a thread in bytes (spills)
int tdnet_dilated_conv_bf16_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k5::dil_wgmma);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
