// Propagation attention for Hopper (sm_90a): Y = softmax(q k^T * scale) v [@ W + b].
//
// Replaces the TPU kernel tdnet_tpu/kernels/propagation_attention.py:
// _attn_kernel / _attn_fc_kernel, reached through fused_propagation_attention.
//
// Per hop at the streaming shapes (d_k = 64, d_v = 512):
//   TD2-PSP50 @1025x2049: q 33,153 x 64 against 2,145 keys, about 99 GFLOP
//     (QK^T 9.1, PV 72.8, fc 17.4) for about 40 MB moved in bf16 (q, k, v, output);
//   TD4-PSP18 @769x1537, last hop: q 18,721 x 64 against 1,225 keys, about 36 GFLOP.
// About 2,500 FLOP per byte at TD2 (still over 900 with the 68 MB round trip of the
// PV result between the pv and fc launches below): the kernel is bound by
// arithmetic, not by memory.
//
// Design. The TPU kernel keeps all of K and V on chip and streams q blocks. On Hopper
// V alone (2,145 x 512 x 2 B in bf16) is ten times a block's shared memory, and a
// 512-wide f32 output row per q row is too much register state for one block. So:
//   1. stats: one pass over K chunks gives each q row its max m and its sum
//      l = sum exp(s - m) (the cheap d_k = 64 product only);
//   2. pv: each block owns 64 q rows and 128 of the d_v columns, walks the K/V
//      chunks, recomputes the 64 x 64 score tile, forms p = exp(s - m) / l exactly as
//      the reference does (no rescaling), rounds p to the input type like the
//      reference's cast, and accumulates p v in f32;
//   3. fc: a tiled GEMM with bias over the [n * Lq, d_v] PV result, which is written
//      in the input type first, as the reference casts it.
// Ragged Lq and Lkv edges are masked inside the kernels; nothing is padded.
// f32 inputs run on the CUDA cores in f32 (no TF32). bf16 inputs run on the tensor
// cores (mma.sync m16n8k16, f32 accumulate); the score tile stays in registers and
// becomes the A operand of the PV product directly.
// Blocks run in any order, so each carries nothing to the next: the sequential TPU
// grid becomes a loop over K/V chunks inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: CUDA cores (stats_f32 and pv_f32 in attention_f32.cuh), and the fc below.
// ---------------------------------------------------------------------------

constexpr int FC_BK = 32;

// y[m, n] = sum_k x[m, k] w[k, n] + bias[n]; kdim % 32 == 0, ndim % 128 == 0.
__global__ void __launch_bounds__(THREADS)
fc_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
       float* __restrict__ y, int m, int kdim, int ndim) {
  __shared__ float xs[BQ][FC_BK + 1];
  __shared__ float ws[FC_BK][BD];
  const int row0 = blockIdx.x * BQ, col0 = blockIdx.y * BD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += FC_BK) {
    for (int idx = threadIdx.x; idx < BQ * FC_BK; idx += THREADS) {
      const int r = idx / FC_BK, c = idx % FC_BK, g = row0 + r;
      xs[r][c] = g < m ? x[(size_t)g * kdim + k0 + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FC_BK * BD; idx += THREADS) {
      const int r = idx / BD, c = idx % BD;
      ws[r][c] = w[(size_t)(k0 + r) * ndim + col0 + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FC_BK; ++kk) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + tx + 16 * j;
      y[(size_t)r * ndim + c] = acc[i][j] + bias[c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. 128 threads = 4 warps; warp w owns q rows 16w..16w+15 of the
// block. Fragment layouts are those of mma.sync.m16n8k16.row.col: in a warp,
// g = lane / 4 and t = lane % 4; an accumulator tile holds rows g and g + 8,
// columns 2t and 2t + 1.
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;
constexpr int QS = DK + 8; // padded row stride (elements) of the q, k and x tiles: 144 B
constexpr int VS = BD + 8; // padded row stride of the v and w tiles: 272 B

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) x columns [col0, col0 + WIDTH) of a row-major bf16 matrix
// with leading dimension ld into a shared tile of row stride `stride`; rows past len
// are zero. 16-byte vectors: pointers, ld and col0 keep 16-byte alignment.
template <int WIDTH>
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* src, int ld,
                                          int row0, int col0, int len) {
  constexpr int VPR = WIDTH / 8;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += TC_THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8, g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < len) val = *reinterpret_cast<const uint4*>(src + (size_t)g * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
  }
}

// A fragments of this warp's 16 rows of a [64, QS] tile, for the 4 k16 steps of 64.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* row = tile + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * QS + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], row + kk * 16);
}

// s[j] (j < 8): the unscaled scores of this warp's rows against keys 8j..8j+7 of ks.
__device__ __forceinline__ void score_tile_tc(const uint32_t qa[4][4], const bf16* ks,
                                              float s[8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  const bf16* row = ks + ((lane % 8) + (lane / 16) * 8) * QS + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, row + jp * 16 * QS + kk * 16);
      mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
    }
}

// acc[j] (j < 16) += a (this warp's 16 x 64 block) * tile[64 x 128], with the tile
// row-major [k][n] in shared memory (row stride VS).
__device__ __forceinline__ void mma_kn_tile(float acc[16][4], const uint32_t a[4][4],
                                            const bf16* tile) {
  const int lane = threadIdx.x % 32;
  const bf16* row = tile + ((lane % 8) + ((lane / 8) % 2) * 8) * VS + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + kk * 16 * VS + jp * 16);
      mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// Store this warp's 16 x 128 accumulator (+ bias) as bf16 rows of y [.., ld].
__device__ __forceinline__ void store_acc(bf16* y, int ld, int row0, int col0, int rows,
                                          const float acc[16][4], const bf16* bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = row0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j + 2 * t;
    const float b0 = bias ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = bias ? __bfloat162float(bias[c + 1]) : 0.f;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(y + (size_t)r0 * ld + c) = pack_bf16(acc[j][0] + b0, acc[j][1] + b1);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(y + (size_t)(r0 + 8) * ld + c) =
          pack_bf16(acc[j][2] + b0, acc[j][3] + b1);
  }
}

__global__ void __launch_bounds__(TC_THREADS)
stats_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ row_max,
           float* __restrict__ row_sum, int lq, int lkv, float scale) {
  __shared__ __align__(16) bf16 qs[64 * QS];
  __shared__ __align__(16) bf16 ks[64 * QS];
  const int b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  load_tile<DK>(qs, QS, q, DK, q0, 0, lq);
  __syncthreads();
  uint32_t qa[4][4];
  load_a_frags(qa, qs);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
  for (int k0 = 0; k0 < lkv; k0 += BK) {
    __syncthreads();
    load_tile<DK>(ks, QS, k, DK, k0, 0, lkv);
    __syncthreads();
    float s[8][4];
    score_tile_tc(qa, ks, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) < lkv) merge_stats(m[e >> 1], l[e >> 1], s[j][e] * scale, 1.f);
  }
  // a row's 4 threads are the 4 lanes of one quad
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
      merge_stats(m[h], l[h], mo, lo);
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + warp * 16 + g + 8 * h;
      if (r < lq) {
        row_max[(size_t)b * lq + r] = m[h];
        row_sum[(size_t)b * lq + r] = l[h];
      }
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS)
pv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const float* __restrict__ row_max, const float* __restrict__ row_sum,
        bf16* __restrict__ o, int lq, int lkv, int dv, float scale) {
  __shared__ __align__(16) bf16 qs[64 * QS];
  __shared__ __align__(16) bf16 ks[64 * QS];
  __shared__ __align__(16) bf16 vs[64 * VS];
  const int b = blockIdx.z, d0 = blockIdx.y * BD, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  o += (size_t)b * lq * dv;
  load_tile<DK>(qs, QS, q, DK, q0, 0, lq);
  __syncthreads();
  uint32_t qa[4][4];
  load_a_frags(qa, qs);

  float mrow[2], lrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    mrow[h] = r < lq ? row_max[(size_t)b * lq + r] : 0.f;
    lrow[h] = r < lq ? row_sum[(size_t)b * lq + r] : 1.f;
  }
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < lkv; k0 += BK) {
    __syncthreads();
    load_tile<DK>(ks, QS, k, DK, k0, 0, lkv);
    load_tile<BD>(vs, VS, v, dv, k0, d0, lkv);
    __syncthreads();
    float s[8][4];
    score_tile_tc(qa, ks, s);
    // p = exp(s - m) / l, rounded to bf16, as the A fragments of the 4 key steps:
    // score tiles 2kk and 2kk + 1 are the two column halves of key step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = k0 + 8 * j + 2 * t + (e & 1) < lkv
                   ? expf(s[j][e] * scale - mrow[e >> 1]) / lrow[e >> 1] : 0.f;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    mma_kn_tile(acc, pa, vs);
  }
  store_acc(o, dv, q0, d0, lq, acc, nullptr);
}

// y[m, n] = sum_k x[m, k] w[k, n] + bias[n]; kdim % 64 == 0, ndim % 128 == 0.
__global__ void __launch_bounds__(TC_THREADS)
fc_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
        bf16* __restrict__ y, int m, int kdim, int ndim) {
  __shared__ __align__(16) bf16 xs[64 * QS];
  __shared__ __align__(16) bf16 ws[64 * VS];
  const int row0 = blockIdx.x * BQ, col0 = blockIdx.y * BD;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < kdim; k0 += 64) {
    __syncthreads();
    load_tile<64>(xs, QS, x, kdim, row0, k0, m);
    load_tile<BD>(ws, VS, w, ndim, k0, col0, kdim);
    __syncthreads();
    uint32_t a[4][4];
    load_a_frags(a, xs);
    mma_kn_tile(acc, a, ws);
  }
  store_acc(y, ndim, row0, col0, m, acc, bias);
}

int run_f32(const float* q, const float* k, const float* v, const float* w, const float* bias,
            float* o_tmp, float* out, float* row_max, float* row_sum, int n, int lq, int lkv,
            int dv, float scale, cudaStream_t st) {
  const dim3 g_rows((lq + BQ - 1) / BQ, 1, n);
  stats_f32<<<g_rows, THREADS, STATS_SMEM, st>>>(q, k, row_max, row_sum, lq, lkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pv_f32<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 g_pv((lq + BQ - 1) / BQ, dv / BD, n);
  pv_f32<false><<<g_pv, THREADS, PV_SMEM, st>>>(q, k, v, row_max, row_sum, w ? o_tmp : out,
                                                lq, lkv, dv, scale, 0u, 0u, 1.f);
  err = cudaGetLastError();
  if (err != cudaSuccess || !w) return (int)err;
  const dim3 g_fc((n * lq + BQ - 1) / BQ, dv / BD);
  fc_f32<<<g_fc, THREADS, 0, st>>>(o_tmp, w, bias, out, n * lq, dv, dv);
  return (int)cudaGetLastError();
}

int run_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* w, const bf16* bias,
             bf16* o_tmp, bf16* out, float* row_max, float* row_sum, int n, int lq, int lkv,
             int dv, float scale, cudaStream_t st) {
  const dim3 g_rows((lq + BQ - 1) / BQ, 1, n);
  stats_bf16<<<g_rows, TC_THREADS, 0, st>>>(q, k, row_max, row_sum, lq, lkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g_pv((lq + BQ - 1) / BQ, dv / BD, n);
  pv_bf16<<<g_pv, TC_THREADS, 0, st>>>(q, k, v, row_max, row_sum, w ? o_tmp : out, lq, lkv,
                                       dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !w) return (int)err;
  const dim3 g_fc((n * lq + BQ - 1) / BQ, dv / BD);
  fc_bf16<<<g_fc, TC_THREADS, 0, st>>>(o_tmp, w, bias, out, n * lq, dv, dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [n, lq, 64], k [n, lkv, 64], v [n, lkv, dv], w [dv, dv] and bias [dv] (both null:
// no fc), out [n, lq, dv], o_tmp [n, lq, dv] (used only with the fc), stats [2, n, lq]
// f32 scratch. dtype 0: float32, 1: bfloat16. dv % 128 == 0; pointers 16-byte aligned.
// Returns the first CUDA error of the launches, 0 if there is none.
int tdnet_propagation_attention(const void* q, const void* k, const void* v, const void* w,
                                const void* bias, void* o_tmp, void* out, void* stats, int n,
                                int lq, int lkv, int dv, float scale, int dtype,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)n * lq;
  if (dtype == 0)
    return run_f32((const float*)q, (const float*)k, (const float*)v, (const float*)w,
                   (const float*)bias, (float*)o_tmp, (float*)out, row_max, row_sum, n, lq,
                   lkv, dv, scale, st);
  if (dtype == 1)
    return run_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)w,
                    (const bf16*)bias, (bf16*)o_tmp, (bf16*)out, row_max, row_sum, n, lq, lkv,
                    dv, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
