// f32 tiles of the propagation attention on the CUDA cores, shared by the inference
// kernel (propagation_attention.cu, K1) and the training kernel
// (propagation_attention_train.cu, K2):
//   stats_f32: each q row's max m and sum l = sum_j exp(s_ij - m) over all keys;
//   pv_f32:    o = p v with p = exp(s - m) / l exact (no rescaling), optionally with
//              dropout: p -> keep ? p / (1 - rate) : 0, the mask from dropout_hash.cuh.
// Blocks of 256 threads as 16 x 16; a thread owns 4 rows (4 ty + i) and the columns
// tx + 16 j of a 64-wide tile. Keys are walked in chunks of 64; d_v is split over
// blocks of 128 columns. Ragged q and key edges are masked; nothing is padded.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int DK = 64;  // key width the kernels take
constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per chunk
constexpr int BD = 128; // d_v columns per PV block

constexpr int THREADS = 256;
constexpr int KS = DK + 1; // padded row stride of 64-wide tiles
constexpr int PS = BK + 1; // padded row stride of the p tile

constexpr size_t STATS_SMEM = sizeof(float) * (2 * 64 * KS);
constexpr size_t PV_SMEM = sizeof(float) * (2 * 64 * KS + BQ * PS + BK * BD);

// Merge two (max, sum of exp(s - max)) pairs; an empty pair has max -inf.
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : l * expf(m - mn);
  const float b = mo == -INFINITY ? 0.f : lo * expf(mo - mn);
  m = mn;
  l = a + b;
}

// Rows [row0, row0 + 64) x columns [col0, col0 + WIDTH) of a row-major [len, ld]
// matrix into a shared tile of row stride `stride`; rows past len are zero.
template <int WIDTH>
__device__ __forceinline__ void load_tile_f32(float* dst, int stride, const float* src, int ld,
                                              int row0, int col0, int len) {
  for (int idx = threadIdx.x; idx < 64 * WIDTH; idx += THREADS) {
    const int r = idx / WIDTH, c = idx % WIDTH, g = row0 + r;
    dst[r * stride + c] = g < len ? src[(size_t)g * ld + col0 + c] : 0.f;
  }
}

// Rows [row0, row0 + 64) of a row-major [len, 64] matrix into a padded shared tile.
__device__ __forceinline__ void load_rows64(float* dst, const float* src, int row0, int len) {
  load_tile_f32<DK>(dst, KS, src, DK, row0, 0, len);
}

__device__ __forceinline__ void zero_tile(float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
}

// s[i][j] += sum_d a[4 ty + i][d] * b[tx + 16 j][d] over d < DEPTH, both tiles row-major
// in shared memory with row strides sa and sb.
template <int DEPTH>
__device__ __forceinline__ void tile_dot_acc(const float* a, int sa, const float* b, int sb,
                                             float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int d = 0; d < DEPTH; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty * 4 + i) * sa + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * sb + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// s[i][j] = scale * q[4 ty + i] . k[tx + 16 j] over one 64 x 64 tile.
__device__ __forceinline__ void score_tile(const float* qs, const float* ks, float scale,
                                           float s[4][4]) {
  zero_tile(s);
  tile_dot_acc<DK>(qs, KS, ks, KS, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= scale;
}

__global__ void __launch_bounds__(THREADS)
stats_f32(const float* __restrict__ q, const float* __restrict__ k, float* __restrict__ row_max,
          float* __restrict__ row_sum, int lq, int lkv, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = smem + 64 * KS;
  const int b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  load_rows64(qs, q, q0, lq);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < lkv; k0 += BK) {
    __syncthreads();
    load_rows64(ks, k, k0, lkv);
    __syncthreads();
    float s[4][4];
    score_tile(qs, ks, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= lkv) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) merge_stats(m[i], l[i], s[i][j], 1.f);
    }
  }
  // the 16 threads of one row group are 16 neighbouring lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      merge_stats(m[i], l[i], mo, lo);
    }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r < lq) {
        row_max[(size_t)b * lq + r] = m[i];
        row_sum[(size_t)b * lq + r] = l[i];
      }
    }
  }
}

// o[b, r, d0 : d0 + 128] = sum_j p_rj v[b, j, d0 : d0 + 128]. With DROP, p_rj is kept
// when tdnet_keep(seed, (b * lq + r) * lkv + j, threshold) and then scaled by inv_keep.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
pv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ row_max, const float* __restrict__ row_sum,
       float* __restrict__ o, int lq, int lkv, int dv, float scale, uint32_t seed,
       uint32_t threshold, float inv_keep) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + 64 * KS;
  float* ps = ks + 64 * KS;  // [BQ][PS]: p rows by key
  float* vs = ps + BQ * PS;  // [BK][BD]
  const int b = blockIdx.z, d0 = blockIdx.y * BD, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  o += (size_t)b * lq * dv;
  load_rows64(qs, q, q0, lq);

  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    mrow[i] = r < lq ? row_max[(size_t)b * lq + r] : 0.f;
    lrow[i] = r < lq ? row_sum[(size_t)b * lq + r] : 1.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < lkv; k0 += BK) {
    __syncthreads();
    load_rows64(ks, k, k0, lkv);
    load_tile_f32<BD>(vs, BD, v, dv, k0, d0, lkv);
    __syncthreads();
    float s[4][4];
    score_tile(qs, ks, scale, s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = key < lkv ? expf(s[i][j] - mrow[i]) / lrow[i] : 0.f;
        if (DROP) {
          const uint64_t idx = (uint64_t)((size_t)b * lq + q0 + ty * 4 + i) * lkv + key;
          p = tdnet_keep(seed, idx, threshold) ? p * inv_keep : 0.f;
        }
        ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = vs[kk * BD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[(size_t)r * dv + d0 + tx + 16 * j] = acc[i][j];
  }
}

}  // namespace
