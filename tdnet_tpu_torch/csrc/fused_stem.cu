// The deep-base stem tail in one pass, for Hopper (sm_90a):
//   c1 = relu(bn1(conv1(x)))   3x3, 64 -> 64, zero padding 1
//   c2 = relu(bn2(conv2(c1)))  3x3, 64 -> 128, zero padding 1
//   y  = maxpool(c2)           3x3, stride 2, padding 1
// on the NCHW output of conv0 (after its BN and ReLU), [n, 64, H, W] -> [n, 128, Hp, Wp],
// Hp = (H + 1) / 2, Wp = (W + 1) / 2. Inference only; the BNs come folded as f32
// (scale, bias) pairs [2, C]. Rounding points as the unfused eval ops (a conv in the
// storage type, then ops/norm.py:batch_norm_folded): the conv sums in f32 and rounds to
// the storage type, the affine runs in f32 (one fma) and rounds, then the ReLU.
//
// Replaces the TPU kernel tdnet_tpu/kernels/fused_stem.py: _fused_stem_kernel, reached
// through fused_stem_tail (stem_impl="fused" on deep-base backbones in eval).
//
// Bound by arithmetic: at TD2-PSP50 @1025x2049 the tail is
// 2 * 513 * 1025 * (9*64*64 + 9*64*128) = 116.3 GFLOP against about 101 MB in bf16 (the
// 64-channel input read once, the pooled 128-channel output written once): 0.118 ms on
// the tensor cores at 989 TFLOP/s, 0.030 ms of memory traffic. The unfused ops move the
// two full-resolution activations (67 and 135 MB in bf16) through memory twice more.
//
// Design. The TPU kernel keeps a full-width band of rows in VMEM; here one conv1 row at
// W = 1025 is already 131 KB in bf16, so a block owns a 2-D tile of pooled outputs and
// recomputes its halo: 8 x 8 pooled outputs need conv2 on 17 x 17, conv1 on 19 x 19 and
// the input on 21 x 21 pixels. Masking follows the TPU kernel: conv1 results outside
// the image are 0 (conv2's zero padding), conv2 results outside it -inf (the pool's
// padding; post-ReLU values are >= 0 and every window holds a valid one).
//   bf16: shared memory holds the input tile, the conv1 tile and one conv's weights
//     ([tap][k][n] rows); the convs are implicit GEMMs on the tensor cores (mma.sync
//     m16n8k16, f32 accumulate): a warp owns 16 output pixels x 64 channels, its A rows
//     are ldmatrix rows of the shifted input pixels, so a tap is an address offset. conv2
//     runs in two halves of 64 output channels, each pooled from shared memory.
//   f32: CUDA cores, a 4 x 8 pooled tile (13 x 21 input pixels) to fit f32 tiles in
//     shared memory; each thread sums 7 (conv1) or 5 (conv2) pixels x 8 channels, the
//     weights read through the read-only cache.
// Both read the NCHW input directly (the transpose happens in the tile load) and write
// NCHW, so the wrapper makes no layout copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CIN = 64, CMID = 64, COUT = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ bool inside(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Fragment layouts are those of mma.sync.m16n8k16.row.col:
// in a warp, g = lane / 4 and t = lane % 4; an accumulator tile holds rows g and g + 8,
// columns 2t and 2t + 1.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int PT = 8;                   // pooled outputs per tile side
constexpr int R2 = 2 * PT + 1;          // conv2 tile side: 17
constexpr int R1 = R2 + 2;              // conv1 tile side: 19
constexpr int RX = R1 + 2;              // input tile side: 21
constexpr int P2 = R2 * R2, P1 = R1 * R1, PX = RX * RX;   // 289, 361, 441 pixels
constexpr int CS = 72;                  // channel stride of a pixel in shared memory: 144 B
constexpr int WS = 72;                  // row stride of a [64 k][64 n] weight tap: 144 B
constexpr int X_ELEMS = PX * CS;        // the input tile; later conv2's half output
constexpr int W_ELEMS = 9 * 64 * WS;    // one conv's weights (conv2: one half)
constexpr int C1_ELEMS = P1 * CS;
constexpr size_t SMEM = (size_t)(X_ELEMS + W_ELEMS + C1_ELEMS) * sizeof(bf16);  // 198,432 B
static_assert(P2 * CS <= X_ELEMS, "conv2's half output reuses the input tile");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (j < 8) = this warp's 16 output pixels [16 tile, 16 tile + 16) of an out_w-wide
// tile (npx pixels) x 64 output channels of a 3x3 conv over src (src_w = out_w + 2 wide,
// pixel stride CS) with the weights w [9][64 k][WS].
__device__ __forceinline__ void conv_m16(float acc[8][4], const bf16* src, int src_w, int out_w,
                                         int npx, int tile, const bf16* w) {
  const int lane = threadIdx.x % 32;
  // ldmatrix x4: lane l gives the row (pixel) l % 16 of k half l / 16; rows past the
  // tile read a valid pixel and their results are dropped
  const int p = min(tile * 16 + lane % 16, npx - 1);
  const bf16* a_base = src + ((p / out_w) * src_w + p % out_w) * CS + (lane / 16) * 8;
  const bf16* b_base = w + ((lane % 8) + ((lane / 8) % 2) * 8) * WS + (lane / 16) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const bf16* a_tap = a_base + ((tap / 3) * src_w + tap % 3) * CS;
    const bf16* b_tap = b_base + tap * 64 * WS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_tap + kk * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_tap + kk * 16 * WS + jp * 16);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

// y = relu(round(fma(round(acc), scale, bias))) as a bf16 pair, or `outside` for
// pixels outside the image.
__device__ __forceinline__ __nv_bfloat162 bn_relu_pair(float a0, float a1, const float* sb,
                                                       int c_out, int n, bool ok, float outside) {
  if (!ok) return __floats2bfloat162_rn(outside, outside);
  const float v0 = fmaf(__bfloat162float(__float2bfloat16_rn(a0)), __ldg(sb + n), __ldg(sb + c_out + n));
  const float v1 = fmaf(__bfloat162float(__float2bfloat16_rn(a1)), __ldg(sb + n + 1),
                        __ldg(sb + c_out + n + 1));
  return __floats2bfloat162_rn(fmaxf(__bfloat162float(__float2bfloat16_rn(v0)), 0.f),
                               fmaxf(__bfloat162float(__float2bfloat16_rn(v1)), 0.f));
}

// rows [0, 9 * 64) x columns [col0, col0 + 64) of a row-major [9 * 64, ld] bf16 weight
// matrix into ws [9 * 64][WS], 16-byte vectors
__device__ __forceinline__ void load_weights(bf16* ws, const bf16* w, int ld, int col0) {
  for (int idx = threadIdx.x; idx < 9 * 64 * 8; idx += THREADS) {
    const int row = idx / 8, v = (idx % 8) * 8;
    *reinterpret_cast<uint4*>(ws + row * WS + v) =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)row * ld + col0 + v));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ sb1,
          const bf16* __restrict__ w2, const float* __restrict__ sb2, bf16* __restrict__ y,
          int H, int W, int Hp, int Wp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [PX][CS], then conv2's half [P2][CS]
  bf16* ws = xs + X_ELEMS;                         // [9 * 64][WS]
  bf16* c1s = ws + W_ELEMS;                        // [P1][CS]
  const int pr0 = blockIdx.y * PT, pc0 = blockIdx.x * PT;
  const int r2 = 2 * pr0 - 1, c2 = 2 * pc0 - 1;    // image row / column of tile pixel 0
  const int r1 = r2 - 1, c1 = c2 - 1, rx = r1 - 1, cx = c1 - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  x += (size_t)blockIdx.z * CIN * H * W;
  y += (size_t)blockIdx.z * COUT * Hp * Wp;

  // the input tile, zero outside the image (conv1's padding), transposed to pixel-major
  for (int idx = threadIdx.x; idx < CIN * PX; idx += THREADS) {
    const int c = idx / PX, p = idx % PX, r = rx + p / RX, col = cx + p % RX;
    xs[p * CS + c] = inside(r, col, H, W) ? x[((size_t)c * H + r) * W + col] : __float2bfloat16_rn(0.f);
  }
  load_weights(ws, w1, CMID, 0);
  __syncthreads();

  // conv1 -> bn1 -> relu into c1s, 0 outside the image
  for (int tile = warp; tile * 16 < P1; tile += THREADS / 32) {
    float acc[8][4];
    conv_m16(acc, xs, RX, R1, P1, tile, ws);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tile * 16 + g + 8 * h;
      if (p >= P1) continue;
      const bool ok = inside(r1 + p / R1, c1 + p % R1, H, W);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(c1s + p * CS + n) =
            bn_relu_pair(acc[j][2 * h], acc[j][2 * h + 1], sb1, CMID, n, ok, 0.f);
      }
    }
  }

  bf16* c2s = xs;
  for (int half = 0; half < 2; ++half) {
    __syncthreads();   // conv1 (or the last half's pool) is done with xs and ws
    load_weights(ws, w2, COUT, half * 64);
    __syncthreads();
    // conv2 -> bn2 -> relu for output channels [64 half, 64 half + 64), -inf outside
    for (int tile = warp; tile * 16 < P2; tile += THREADS / 32) {
      float acc[8][4];
      conv_m16(acc, c1s, R1, R2, P2, tile, ws);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tile * 16 + g + 8 * h;
        if (p >= P2) continue;
        const bool ok = inside(r2 + p / R2, c2 + p % R2, H, W);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(c2s + p * CS + n) =
              bn_relu_pair(acc[j][2 * h], acc[j][2 * h + 1], sb2 + half * 64, COUT, n, ok,
                           -INFINITY);
        }
      }
    }
    __syncthreads();
    // max-pool 3/2/1: pooled (i, j) takes tile pixels (2i .. 2i + 2, 2j .. 2j + 2)
    for (int idx = threadIdx.x; idx < 64 * PT * PT; idx += THREADS) {
      const int ch = idx / (PT * PT), i = (idx / PT) % PT, j = idx % PT;
      const int pr = pr0 + i, pc = pc0 + j;
      if (pr >= Hp || pc >= Wp) continue;
      float m = -INFINITY;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
          m = fmaxf(m, __bfloat162float(c2s[((2 * i + a) * R2 + 2 * j + b) * CS + ch]));
      y[((size_t)(half * 64 + ch) * Hp + pr) * Wp + pc] = __float2bfloat16_rn(m);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 on the CUDA cores.
// ---------------------------------------------------------------------------

namespace cc {

constexpr int PH = 4, PW = 8;           // pooled outputs per tile
constexpr int R2 = 2 * PH + 1, C2 = 2 * PW + 1;   // conv2 tile: 9 x 17
constexpr int R1 = R2 + 2, C1 = C2 + 2;           // conv1 tile: 11 x 19
constexpr int RX = R1 + 2, CX = C1 + 2;           // input tile: 13 x 21
constexpr int P2 = R2 * C2, P1 = R1 * C1, PX = RX * CX;   // 153, 209, 273 pixels
constexpr int XS = 65;                  // pixel stride (floats) of the input and conv1 tiles
constexpr int C2S = 129;                // pixel stride of the conv2 tile
constexpr int PPT1 = 7, PPT2 = 5;       // pixels per thread: 32 * 7 >= 209, 32 * 5 >= 153
static_assert(32 * PPT1 >= P1 && 32 * PPT2 >= P2, "one pass covers each tile");
constexpr size_t SMEM = (size_t)(PX * XS + P1 * XS + P2 * C2S) * sizeof(float);  // 204,268 B

// acc[q][e] = the 3x3 conv over src (pixel stride XS, src_w wide) at tile pixel
// lane + 32 q of an out_w-wide tile of npx pixels, output channel n0 + 8 (warp) + e,
// with the weights w [9][64][nout].
template <int PPT>
__device__ __forceinline__ void conv_px(float acc[PPT][8], const float* src, int src_w,
                                        int out_w, int npx, const float* w, int nout, int n0) {
  const int lane = threadIdx.x % 32, cg = threadIdx.x / 32;
  int base[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = min(lane + 32 * q, npx - 1);   // past the tile: a valid pixel, dropped
    base[q] = ((p / out_w) * src_w + p % out_w) * XS;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
  }
  const float* wc = w + n0 + 8 * cg;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * src_w + tap % 3) * XS;
    const float* wt = wc + (size_t)tap * 64 * nout;
#pragma unroll 4
    for (int c = 0; c < 64; ++c) {
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + c * nout));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + c * nout + 4));
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float xv = src[base[q] + off + c];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(xv, wv[e], acc[q][e]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_f32(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ sb1,
         const float* __restrict__ w2, const float* __restrict__ sb2, float* __restrict__ y,
         int H, int W, int Hp, int Wp) {
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;              // [PX][XS]
  float* c1s = xs + PX * XS;       // [P1][XS]
  float* c2s = c1s + P1 * XS;      // [P2][C2S]
  const int pr0 = blockIdx.y * PH, pc0 = blockIdx.x * PW;
  const int r2 = 2 * pr0 - 1, c2 = 2 * pc0 - 1;
  const int r1 = r2 - 1, c1 = c2 - 1, rx = r1 - 1, cx = c1 - 1;
  const int lane = threadIdx.x % 32, cg = threadIdx.x / 32;
  x += (size_t)blockIdx.z * CIN * H * W;
  y += (size_t)blockIdx.z * COUT * Hp * Wp;

  for (int idx = threadIdx.x; idx < CIN * PX; idx += THREADS) {
    const int c = idx / PX, p = idx % PX, r = rx + p / CX, col = cx + p % CX;
    xs[p * XS + c] = inside(r, col, H, W) ? x[((size_t)c * H + r) * W + col] : 0.f;
  }
  __syncthreads();

  {
    float acc[PPT1][8];
    conv_px<PPT1>(acc, xs, CX, C1, P1, w1, CMID, 0);
#pragma unroll
    for (int q = 0; q < PPT1; ++q) {
      const int p = lane + 32 * q;
      if (p >= P1) continue;
      const bool ok = inside(r1 + p / C1, c1 + p % C1, H, W);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = 8 * cg + e;
        c1s[p * XS + n] = ok ? fmaxf(fmaf(acc[q][e], __ldg(sb1 + n), __ldg(sb1 + CMID + n)), 0.f)
                             : 0.f;
      }
    }
  }
  __syncthreads();

  for (int n0 = 0; n0 < COUT; n0 += 64) {
    float acc[PPT2][8];
    conv_px<PPT2>(acc, c1s, C1, C2, P2, w2, COUT, n0);
#pragma unroll
    for (int q = 0; q < PPT2; ++q) {
      const int p = lane + 32 * q;
      if (p >= P2) continue;
      const bool ok = inside(r2 + p / C2, c2 + p % C2, H, W);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = n0 + 8 * cg + e;
        c2s[p * C2S + n] = ok ? fmaxf(fmaf(acc[q][e], __ldg(sb2 + n), __ldg(sb2 + COUT + n)), 0.f)
                              : -INFINITY;
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < COUT * PH * PW; idx += THREADS) {
    const int ch = idx / (PH * PW), i = (idx / PW) % PH, j = idx % PW;
    const int pr = pr0 + i, pc = pc0 + j;
    if (pr >= Hp || pc >= Wp) continue;
    float m = -INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) m = fmaxf(m, c2s[((2 * i + a) * C2 + 2 * j + b) * C2S + ch]);
    y[((size_t)ch * Hp + pr) * Wp + pc] = m;
  }
}

}  // namespace cc

}  // namespace

extern "C" {

// x [n, 64, H, W], y [n, 128, (H + 1) / 2, (W + 1) / 2], w1 [9, 64, 64] and w2 [9, 64, 128]
// tap-major ([i * 3 + j, c_in, c_out]), all in the storage type (dtype 0: float32,
// 1: bfloat16), contiguous, 16-byte aligned; sb1 [2, 64] and sb2 [2, 128] f32 (scale
// row, then bias row). Returns the first CUDA error, 0 if none.
int tdnet_fused_stem(const void* x, const void* w1, const void* sb1, const void* w2,
                     const void* sb2, void* y, int n, int H, int W, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Hp = (H + 1) / 2, Wp = (W + 1) / 2;
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(tc::stem_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tc::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Wp + tc::PT - 1) / tc::PT, (Hp + tc::PT - 1) / tc::PT, n);
    tc::stem_bf16<<<grid, THREADS, tc::SMEM, st>>>(
        (const bf16*)x, (const bf16*)w1, (const float*)sb1, (const bf16*)w2, (const float*)sb2,
        (bf16*)y, H, W, Hp, Wp);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    err = cudaFuncSetAttribute(cc::stem_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cc::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Wp + cc::PW - 1) / cc::PW, (Hp + cc::PH - 1) / cc::PH, n);
    cc::stem_f32<<<grid, THREADS, cc::SMEM, st>>>(
        (const float*)x, (const float*)w1, (const float*)sb1, (const float*)w2,
        (const float*)sb2, (float*)y, H, W, Hp, Wp);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
