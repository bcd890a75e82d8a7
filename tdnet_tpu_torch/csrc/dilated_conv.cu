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
// Design: an implicit GEMM on mma.sync in three launches, one template over the precision:
//   F32:  m16n8k8 in 3xTF32 (tf32x3.cuh); the prep passes split each operand into hi =
//         rna_tf32(v) and lo = rna_tf32(v - hi), so the main loop splits nothing.
//   Bf16: m16n8k16, bf16 operands, f32 accumulator: one product where 3xTF32 takes three;
//         the prep passes only pad and relayout.
//   1. prep_input: one read of x (NCHW) writes NHWC images zero-padded by p on every side
//      (Hp x Wp), channels rounded up to a multiple of BK with zeros, and enough zero rows
//      below that the last tile's reads stay in range.
//   2. prep_weights: w (OIHW) -> [9, Np, Kp], K-contiguous, zero-padded; for the dgrad the
//      same pass flips the taps and swaps O and I.
//   3. dil_tc: output pixel (h, w) is GEMM row h*Wp + w, for w over the whole padded width,
//      so tap (i, j) reads A rows shifted by the constant i*d*Wp + j*d: every A tile is a
//      plain rectangle of the padded input, loaded by 16-byte cp.async with no gather and no
//      mask. Rows with w >= Wo are computed and dropped in the epilogue (2d / Wp extra work:
//      4% at d4, 8% at d8 and 14% at d16 on the 193-wide grid). M = Ho*Wp, N = co,
//      K = 9 * Kp. A block owns 128 rows x 128 channels (8 warps, 64 x 32 each) and walks K in
//      stages of one tap and BK channels (32 f32 or 64 bf16: a tile row is 128 bytes either
//      way, so the swizzle and the ldmatrix addresses are the same in bytes), in a ring of
//      swizzled tiles (F32: 3 stages of A hi, A lo, B hi, B lo, 192 KB; Bf16: 4 stages of A,
//      B, 128 KB; one block an SM); ldmatrix reads the A and B fragments. Each stage's 4
//      k-steps (F32: of three products, lo*hi, hi*lo, hi*hi; Bf16: of one) go to a fresh
//      accumulator that is added in round-to-nearest f32: the tensor core truncates as it
//      accumulates: one chain over all 9 * Kp / 16 bf16 k-steps put 0.13-0.25% of the bf16
//      outputs off the plain version's bits, with a mean rounding bias up to 100x the plain
//      version's; short chains put 0.02% off, with the plain version's bias (PERF.md, runs
//      H2 and H3). Each output element is summed by one thread in a fixed order, with no
//      split-K and no atomics, so two runs give the same bits. The epilogue writes y as NCHW
//      through shared memory, coalesced along pixels.
// The tiles are K-major rectangles, the layout wgmma and TMA need; this kernel uses neither.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // GEMM rows (padded-width output pixels) per block
constexpr int BN = 128;        // output channels per block
constexpr int ROW = 128;       // bytes of a tile row: BK elements
constexpr int THREADS = 256;   // 8 warps: 2 along M (64 rows) x 4 along N (32 channels)
constexpr int TILE = BM * ROW; // bytes of one operand tile (BM == BN)
constexpr int YS = BM + 4;     // row stride of the epilogue's [BN][YS] f32 tile
constexpr int PT = 32;         // the prep passes' square tile

static_assert(BM == BN, "A and B tiles share one layout");

// the precisions: element type, operand tiles per matrix (hi and lo, or one), channels of a
// stage, stages in the ring
struct F32 {
  using T = float;
  static constexpr int OPS = 2, BK = ROW / 4, STAGES = 3;
};
struct Bf16 {
  using T = bf16;
  static constexpr int OPS = 1, BK = ROW / 2, STAGES = 4;
};

template <class P>
constexpr size_t smem_bytes() {
  return (size_t)P::STAGES * 2 * P::OPS * TILE;
}
static_assert(BN * YS * 4 <= smem_bytes<F32>() && BN * YS * 4 <= smem_bytes<Bf16>(),
              "the epilogue's tile fits in the ring");

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

// c += a b, m16n8k16, bf16 operands, f32 accumulator; fragments as ldmatrix gives them
// (A: rows g and g + 8 at k 2t.. and 2t + 8..; B: k 2t.. and 2t + 8.. of column g)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* y, size_t i, float v) { y[i] = v; }
__device__ __forceinline__ void store(bf16* y, size_t i, float v) {
  y[i] = __float2bfloat16_rn(v);
}

// y[b, n, h, w] for GEMM rows m = h * Wp + w in [m0, m0 + BM) and channels n in
// [n0, n0 + BN): sum over the 9 taps and Kp channels of A[m + tap offset, k] B[tap, n, k],
// A = the padded input of image b = blockIdx.z (R rows; F32: xh + xl), B = the weights
// (F32: wh + wl). Stages run tap-major, BK channels each.
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
  // (lanes 8-15 and 24-31 give k half 1). A k-step is two 16-byte chunks: 8 f32 or 16 bf16.
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
    if constexpr (OPS == 2) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldsm4(r, st + TILE + tile_offset(b_row + 16 * np, 2 * kk + b_half));
          bf[2 * np][0] = r[0], bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2], bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t af[4];
          ldsm4(af, st + tile_offset(a_row + 16 * mi, 2 * kk + a_half));
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(t[mi][ni], af, bf[ni]);
        }
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

int ceil_to(int a, int m) { return (a + m - 1) / m * m; }

// The three launches of one conv in precision P; xs, ws: the scratch's operands (F32: hi and
// lo; Bf16: one, the second unused).
template <class P>
int dilated_conv(const void* x, const void* w, void* const xs[2], void* const ws[2], void* y,
                 int n, int cin, int cout, int H, int W, int pad, int dil, int flip, int hr,
                 int Kp, int Np, void* stream) {
  using T = typename P::T;
  const int Hp = H + 2 * pad, Wp = W + 2 * pad, Ho = Hp - 2 * dil, Wo = Wp - 2 * dil;
  const long long M = (long long)Ho * Wp, tiles = (M + BM - 1) / BM;
  uintptr_t bits = 0;
  for (int o = 0; o < P::OPS; ++o) bits |= (uintptr_t)xs[o] | (uintptr_t)ws[o];
  if (n < 1 || n > 65535 || cin < 1 || cout < 1 || Ho < 1 || Wo < 1 || dil < 1 || hr < Hp ||
      Kp != ceil_to(cin, P::BK) || Np != ceil_to(cout, BN) || tiles > 65535 ||
      (long long)hr * Wp < tiles * BM + 2LL * dil * Wp + 2 * dil ||
      (long long)n * (Kp / PT) > 65535 || (long long)hr * Wp >= (1LL << 31) || bits % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  T *xh = (T*)xs[0], *xl = (T*)xs[1], *wh = (T*)ws[0], *wl = (T*)ws[1];
  prep_input<T><<<dim3((Wp + PT - 1) / PT, hr, n * (Kp / PT)), THREADS, 0, st>>>(
      (const T*)x, xh, xl, cin, H, W, Kp, Wp, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  prep_weights<T><<<dim3(Kp / PT, Np / PT), THREADS, 0, st>>>(
      (const T*)w, wh, wl, flip ? cin : cout, flip ? cout : cin, Np, Kp, flip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = (int)smem_bytes<P>();
  err = cudaFuncSetAttribute(dil_tc<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dil_tc<P><<<dim3(Np / BN, (unsigned)tiles, n), THREADS, smem, st>>>(
      xh, xl, wh, wl, (T*)y, Kp, Np, cout, Ho, Wo, Wp, hr * Wp, dil);
  return (int)cudaGetLastError();
}

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
  void* const xs[2] = {xh, xl};
  void* const ws[2] = {wh, wl};
  return dilated_conv<F32>(x, w, xs, ws, y, n, cin, cout, H, W, pad, dil, flip, hr, Kp, Np,
                           stream);
}

// The same in bf16: x, w and y bf16; one scratch each, xs [n, hr * Wp, Kp] and ws [9, Np, Kp]
// bf16, Kp = cin rounded up to 64.
int tdnet_dilated_conv_bf16(const void* x, const void* w, void* xs, void* ws, void* y, int n,
                            int cin, int cout, int H, int W, int pad, int dil, int flip, int hr,
                            int Kp, int Np, void* stream) {
  void* const xp[2] = {xs, nullptr};
  void* const wp[2] = {ws, nullptr};
  return dilated_conv<Bf16>(x, w, xp, wp, y, n, cin, cout, H, W, pad, dil, flip, hr, Kp, Np,
                            stream);
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
