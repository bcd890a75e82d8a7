// Stride-1 dilated 3x3 convolution for Hopper (sm_90a), f32 accuracy on the tensor cores:
//   y[b, o, h, w] = sum_{c, i, j} x[b, c, h + i*d - p, w + j*d - p] * w[o, c, i, j]
// with zeros outside the image. The data gradient of such a conv is the same conv of dy
// with the spatially flipped, IO-swapped kernel and padding d*(k-1) - p, so this one
// kernel serves the forward and the dgrad (the weight pass flips and swaps, `flip`).
//
// Replaces the TPU kernel tdnet_tpu/kernels/dilated_conv.py: _dil_kernel, reached through
// conv2d_pallas_dil (the residual blocks' 3x3 convs with dilation >= 4 in training,
// conv_wgrad="pallas").
//
// Bound by arithmetic: at the TD4-PSP18 recipe's layer4 (97 x 193 grid, 512 -> 512)
// one conv is 2 * 18,721 * 9 * 512 * 512 = 88.3 GFLOP against 38 + 38 + 9 MB of x, y
// and weights: 1.318 ms in f32 on the CUDA cores (67 TFLOP/s), 0.535 ms with every product
// in 3xTF32 on the tensor cores (495 / 3 TFLOP/s), 0.025 ms of memory traffic at 3.35 TB/s.
//
// Design: an implicit GEMM on mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh), in three launches.
//   1. prep_input: one read of x (NCHW) writes x_hi = rna_tf32(x) and x_lo = rna_tf32(x - hi)
//      as NHWC images zero-padded by p on every side (Hp x Wp), channels rounded up to a
//      multiple of BK with zeros, and enough zero rows below that the last tile's reads
//      stay in range. Both operands arrive split, so the main loop splits nothing.
//   2. prep_weights: w (OIHW) -> w_hi, w_lo [9, Np, Kp], K-contiguous, zero-padded; for the
//      dgrad the same pass flips the taps and swaps O and I.
//   3. dil_tc: output pixel (h, w) is GEMM row h*Wp + w, for w over the whole padded width,
//      so tap (i, j) reads A rows shifted by the constant i*d*Wp + j*d: every A tile is a
//      plain rectangle of x_hi / x_lo, loaded by 16-byte cp.async with no gather and no
//      mask. Rows with w >= Wo are computed and dropped in the epilogue (2d / Wp extra work:
//      4% at d4 and 8% at d8 on the 193-wide grid). M = Ho*Wp, N = co, K = 9 * Kp.
//      A block owns 128 rows x 128 channels (8 warps, 64 x 32 each) and walks K in stages
//      of one tap and 32 channels, in a 3-stage cp.async ring of swizzled tiles (192 KB,
//      one block an SM); ldmatrix reads the A and B fragments, and each stage's 4 k-steps
//      of three products (lo*hi, hi*lo, hi*hi) go to a fresh accumulator that is added in
//      round-to-nearest f32 (the tensor core truncates as it accumulates). Each output
//      element is summed by one thread in a fixed order, with no split-K and no atomics,
//      so two runs give the same bits. The epilogue writes y as NCHW through shared
//      memory, coalesced along pixels.
// The tiles are K-major rectangles, the layout wgmma and TMA need; this kernel uses neither.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 128;        // GEMM rows (padded-width output pixels) per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 32;         // input channels per stage: 4 k-steps, one chain
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 8 warps: 2 along M (64 rows) x 4 along N (32 channels)
constexpr int TILE = BM * BK;  // words of one operand tile (BM == BN)
constexpr int YS = BM + 4;     // row stride of the epilogue's [BN][YS] tile
constexpr size_t SMEM = sizeof(float) * STAGES * 4 * TILE;   // A hi, A lo, B hi, B lo
constexpr int PT = 32;         // the prep passes' square tile

static_assert(BM == BN, "A and B tiles share one layout");
static_assert(BN * YS <= STAGES * 4 * TILE, "the epilogue's tile fits in the ring");

// v = hi + lo, both TF32 values stored as f32: hi = rna_tf32(v), lo = rna_tf32(v - hi)
__device__ __forceinline__ void split_store(float v, float* hi, float* lo, size_t i) {
  const float h = __uint_as_float(rna_tf32(v));
  hi[i] = h;
  lo[i] = __uint_as_float(rna_tf32(v - h));
}

// x [n, C, H, W] -> xh, xl [n, R, Kp] with R = gridDim.y * Wp: row hp * Wp + wp holds
// x[b, :, hp - pad, wp - pad], zero outside the image and for channels >= C. A block
// transposes a tile of 32 padded columns x 32 channels of one padded row through shared
// memory: reads coalesced along w, writes along channels.
__global__ void __launch_bounds__(THREADS)
prep_input(const float* __restrict__ x, float* __restrict__ xh, float* __restrict__ xl, int C,
           int H, int W, int Kp, int Wp, int pad) {
  __shared__ float s[PT][PT + 1];
  const int w0 = blockIdx.x * PT, hp = blockIdx.y, kt = Kp / PT;
  const int b = blockIdx.z / kt, c0 = (blockIdx.z % kt) * PT;
  const int tx = threadIdx.x % PT, ty = threadIdx.x / PT;
  const int h = hp - pad, w = w0 + tx - pad;
  const bool inside = h >= 0 && h < H && w >= 0 && w < W;
  for (int i = ty; i < PT; i += THREADS / PT) {
    const int c = c0 + i;
    s[i][tx] = inside && c < C ? x[(((size_t)b * C + c) * H + h) * W + w] : 0.f;
  }
  __syncthreads();
  const size_t rows = (size_t)gridDim.y * Wp;
  for (int i = ty; i < PT && w0 + i < Wp; i += THREADS / PT)
    split_store(s[tx][i], xh, xl, ((size_t)b * rows + (size_t)hp * Wp + w0 + i) * Kp + c0 + tx);
}

// w [wo, wi, 3, 3] -> wh, wl [9, Np, Kp]: B[t, n, k] = w[n, k, t] (forward: N = wo, K = wi)
// or, with flip, w[k, n, 8 - t] (dgrad: N = wi, K = wo), zero beyond N and K. A block
// stages the 32 x 288 contiguous floats of 32 of w's rows and writes a 32 x 32 (n, k) tile
// of all 9 taps.
__global__ void __launch_bounds__(THREADS)
prep_weights(const float* __restrict__ w, float* __restrict__ wh, float* __restrict__ wl,
             int wo, int wi, int Np, int Kp, int flip) {
  __shared__ float s[PT][PT * 9 + 1];
  const int n0 = blockIdx.y * PT, k0 = blockIdx.x * PT;
  const int o0 = flip ? k0 : n0, c0 = flip ? n0 : k0;   // the tile's rows are w's o
  for (int e = threadIdx.x; e < PT * PT * 9; e += THREADS) {
    const int r = e / (PT * 9), q = e % (PT * 9), o = o0 + r, c = c0 + q / 9;
    s[r][q] = o < wo && c < wi ? w[((size_t)o * wi + c0) * 9 + q] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * PT * PT; e += THREADS) {
    const int t = e / (PT * PT), n = (e / PT) % PT, k = e % PT;
    const float v = flip ? s[k][n * 9 + 8 - t] : s[n][k * 9 + t];
    split_store(v, wh, wl, ((size_t)t * Np + n0 + n) * Kp + k0 + k);
  }
}

// Element (r, k) of a [rows][BK] tile is word r * BK + 4 ((k / 4) ^ (r % 8)) + k % 4: the
// 16-byte chunks of a row are permuted by the row's low bits, so the 8 rows of an ldmatrix
// matrix hit 8 different bank groups.
__device__ __forceinline__ int tile_offset(int r, int chunk) {
  return r * BK + ((chunk ^ (r & 7)) << 2);
}

__device__ __forceinline__ void ldsm4(uint32_t f[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// y[b, n, h, w] for GEMM rows m = h * Wp + w in [m0, m0 + BM) and channels n in
// [n0, n0 + BN): sum over the 9 taps and Kp channels of A[m + tap offset, k] B[tap, n, k],
// A = xh + xl for image b = blockIdx.z (R rows), B = wh + wl. Stages run tap-major, 32
// channels each; a stage is one chain.
__global__ void __launch_bounds__(THREADS, 1)
dil_tc(const float* __restrict__ xh, const float* __restrict__ xl, const float* __restrict__ wh,
       const float* __restrict__ wl, float* __restrict__ y, int Kp, int Np, int co, int Ho,
       int Wo, int Wp, int R, int dil) {
  extern __shared__ __align__(16) float smem[];   // [STAGES][A hi, A lo, B hi, B lo][TILE]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int kc = Kp / BK, steps = 9 * kc, M = Ho * Wp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  xh += (size_t)b * R * Kp;
  xl += (size_t)b * R * Kp;
  y += (size_t)b * co * Ho * Wo;

  // loads: this thread's 16-byte chunk e & 7 of rows e >> 3, e = tid + 256 i (i < 4), the
  // same offsets in all four tiles
  int so[4], go[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + i * THREADS, r = e >> 3, ch = e & 7;
    so[i] = tile_offset(r, ch);
    go[i] = r * Kp + ch * 4;
  }
  auto load_stage = [&](int s) {
    const int tap = s / kc, c0 = (s - tap * kc) * BK;
    const int off = (tap / 3) * dil * Wp + (tap % 3) * dil;
    float* st = smem + (s % STAGES) * 4 * TILE;
    const size_t a0 = (size_t)(m0 + off) * Kp + c0, b0 = ((size_t)tap * Np + n0) * Kp + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cp_async16(st + so[i], xh + a0 + go[i], true);
      cp_async16(st + TILE + so[i], xl + a0 + go[i], true);
      cp_async16(st + 2 * TILE + so[i], wh + b0 + go[i], true);
      cp_async16(st + 3 * TILE + so[i], wl + b0 + go[i], true);
    }
  };

  // fragments: A rows 64 wm + 16 mi (mi < 4) by ldmatrix.x4 (lanes 0-15 rows of k half 0,
  // 16-31 of half 1); B channels 32 wn + 16 np (np < 2), two n8 tiles an ldmatrix.x4
  // (lanes 8-15 and 24-31 give k half 1)
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
    const float* st = smem + (s % STAGES) * 4 * TILE;
    float t[4][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
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

  // epilogue: the tile through shared memory as [channel][row], then each warp writes
  // channels warp + 8 j, its lanes consecutive rows, dropping rows with w >= Wo or h >= Ho
  cp_wait_all();
  __syncthreads();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wm + 16 * mi + g + 8 * h, c = 32 * wn + 8 * ni + 2 * t4;
        smem[c * YS + r] = acc[mi][ni][2 * h];
        smem[(c + 1) * YS + r] = acc[mi][ni][2 * h + 1];
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
      if (dst[q] >= 0) y[(size_t)(n0 + c) * plane + dst[q]] = smem[c * YS + lane + 32 * q];
}

int ceil_to(int a, int m) { return (a + m - 1) / m * m; }

}  // namespace

extern "C" {

// y = the dilated conv of x [n, cin, H, W] with w, f32, contiguous:
//   flip = 0: w [cout, cin, 3, 3] (the forward);
//   flip = 1: w [cin, cout, 3, 3], used flipped and IO-swapped (the dgrad: x is dy).
// y [n, cout, Ho, Wo], Ho = H + 2 pad - 2 dil, Wo = W + 2 pad - 2 dil. Scratch, 16-byte
// aligned, sized by kernels/dilated_conv.py: conv_plan: xh, xl [n, hr * Wp, Kp] and wh, wl
// [9, Np, Kp] f32, Wp = W + 2 pad, Kp = cin rounded up to BK, Np = cout rounded up to BN;
// hr padded rows, enough that the last row tile's reads stay in range. A plan that does
// not fit these tiles is refused. Returns the first failed launch's CUDA error, 0 if none.
int tdnet_dilated_conv(const void* x, const void* w, void* xh, void* xl, void* wh, void* wl,
                       void* y, int n, int cin, int cout, int H, int W, int pad, int dil,
                       int flip, int hr, int Kp, int Np, void* stream) {
  const int Hp = H + 2 * pad, Wp = W + 2 * pad, Ho = Hp - 2 * dil, Wo = Wp - 2 * dil;
  const long long M = (long long)Ho * Wp, tiles = (M + BM - 1) / BM;
  const bool aligned = ((uintptr_t)xh | (uintptr_t)xl | (uintptr_t)wh | (uintptr_t)wl) % 16 == 0;
  if (n < 1 || n > 65535 || cin < 1 || cout < 1 || Ho < 1 || Wo < 1 || dil < 1 || hr < Hp ||
      Kp != ceil_to(cin, BK) || Np != ceil_to(cout, BN) || tiles > 65535 ||
      (long long)hr * Wp < tiles * BM + 2LL * dil * Wp + 2 * dil ||
      (long long)n * (Kp / PT) > 65535 || (long long)hr * Wp >= (1LL << 31) || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float *fxh = (float*)xh, *fxl = (float*)xl, *fwh = (float*)wh, *fwl = (float*)wl;
  prep_input<<<dim3((Wp + PT - 1) / PT, hr, n * (Kp / PT)), THREADS, 0, st>>>(
      (const float*)x, fxh, fxl, cin, H, W, Kp, Wp, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prep_weights<<<dim3(Kp / PT, Np / PT), THREADS, 0, st>>>(
      (const float*)w, fwh, fwl, flip ? cin : cout, flip ? cout : cin, Np, Kp, flip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dil_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dil_tc<<<dim3(Np / BN, (unsigned)tiles, n), THREADS, SMEM, st>>>(
      fxh, fxl, fwh, fwl, (float*)y, Kp, Np, cout, Ho, Wo, Wp, hr * Wp, dil);
  return (int)cudaGetLastError();
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
