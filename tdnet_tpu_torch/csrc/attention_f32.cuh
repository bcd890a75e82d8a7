// The f32 propagation attention's shared part, for the inference kernel's f32 path
// (propagation_attention.cu, K1) and the training kernel's forward
// (propagation_attention_train.cu, K2):
//   stats_f32: each q row's max m and sum l = sum_j exp(s_ij - m) over all keys, on the CUDA
//              cores (blocks of 256 threads as 16 x 16; a thread owns rows 4 ty + i and keys
//              tx + 16 j of a 64 x 64 score tile);
//   chunk_p:   p = exp(s - m) / l exact (no rescaling), optionally with dropout (p -> keep ?
//              p / (1 - rate) : 0, the mask from dropout_hash.cuh), for a 64 x 32 tile of the
//              PV passes: K1's pv_tc (p v in 3xTF32 on the tensor cores) and K2's pv_fma (p v
//              on the CUDA cores in the order of a plain f32 GEMM);
//   sum_parts: partial outputs summed in a fixed order, float4s: K1's key ranges and the
//              q and key ranges of K2's backward. No atomics: two runs give the same bits.
//
// s stays on the CUDA cores, each score one fmaf a depth step from 0 in depth order and then
// the scale, in stats_f32, both PV passes and K2's backward alike: p is the same to the bit
// in all of them, sum_j p_ij agrees with the saved l, and the gradient of a bias shared by
// all keys (sum_j ds_ij, zero in exact arithmetic) stays at rounding level; s from TF32
// products broke that (PERF.md, run W1). The score is 64 of the 64 + d_v FLOP pairs of an
// element. Ragged q and key edges are masked; nothing is padded.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int DK = 64;  // key width the kernels take
constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per chunk

constexpr int PK = 32;  // keys per chunk of the PV passes (and depth per chunk of K1's fc)

constexpr int THREADS = 256;
constexpr int KS = DK + 1; // padded row stride of stats_f32's 64-wide tiles
constexpr int TS = DK + 4; // row stride of the PV passes' q and k tiles: 4 mod 32 words

constexpr size_t STATS_SMEM = sizeof(float) * (2 * 64 * KS);

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

// Rows [row0, row0 + ROWS) x columns [col0, col0 + W) of a row-major [len, ld] matrix into
// a shared tile of stride S (swizzled with SWZ), 16 bytes a copy; rows past len are zero.
template <int ROWS, int W, int S, bool SWZ>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int ld, int row0,
                                           int col0, int len) {
  constexpr int V = W / 4;
  for (int i = threadIdx.x; i < ROWS * V; i += THREADS) {
    const int r = i / V, c = (i % V) * 4, gr = row0 + r;
    const bool ok = gr < len;
    cp_async16(dst + (SWZ ? swz(r, c, S) : r * S + c), src + (size_t)(ok ? gr : 0) * ld + col0 + c,
               ok);
  }
}

// s[i][j] = scale * q[4 ty + i] . k[tx + 16 j] over a 64 x 32 tile (ty = tid / 16, tx =
// tid % 16), bit for bit as score_tile forms it (one fmaf a depth step from 0, in depth
// order, then the scale), from float4 reads of tiles of row stride TS.
__device__ __forceinline__ void score_tile_pv(const float* qs, const float* ks, float scale,
                                              float s[4][2]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DK; d += 4) {
    float4 x[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * TS + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      y[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * TS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float acc = s[i][j];
        acc = fmaf(x[i].x, y[j].x, acc);
        acc = fmaf(x[i].y, y[j].y, acc);
        acc = fmaf(x[i].z, y[j].z, acc);
        acc = fmaf(x[i].w, y[j].w, acc);
        s[i][j] = acc;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] *= scale;
}

// This thread's rows 4 ty + i of stats (row max and sum; 0 and 1 past lq).
__device__ __forceinline__ void load_row_stats(float mrow[4], float lrow[4],
                                               const float* row_max, const float* row_sum,
                                               int lq, int q0) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    mrow[i] = r < lq ? row_max[r] : 0.f;
    lrow[i] = r < lq ? row_sum[r] : 1.f;
  }
}

// p[i][j] for this thread's rows 4 ty + i and keys k0 + tx + 16 j of a 32-key chunk: the
// chunk's scores as score_tile_pv forms them, p = exp(s - m) / l (0 past lkv) and, with
// DROP, p kept when tdnet_keep(seed, (b * lq + r) * lkv + key, threshold) and then scaled by
// inv_keep. The same expression as K2's backward, so p is the same to the bit in both.
template <bool DROP>
__device__ __forceinline__ void chunk_p(float p[4][2], const float* qs, const float* ks,
                                        float scale, const float mrow[4], const float lrow[4],
                                        int b, int lq, int lkv, int q0, int k0, uint32_t seed,
                                        uint32_t threshold, float inv_keep) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][2];
  score_tile_pv(qs, ks, scale, s);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pv = key < lkv ? expf(s[i][j] - mrow[i]) / lrow[i] : 0.f;
      if (DROP) {
        const uint64_t idx = (uint64_t)((size_t)b * lq + q0 + ty * 4 + i) * lkv + key;
        pv = tdnet_keep(seed, idx, threshold) ? pv * inv_keep : 0.f;
      }
      p[i][j] = pv;
    }
  }
}

// out[i] = sum_p parts[p * count + i], summed in order p = 0, 1, ...; 4 floats a thread.
__global__ void __launch_bounds__(THREADS)
sum_parts(const float4* __restrict__ parts, float4* __restrict__ out, int nparts,
          size_t count4) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < count4;
       i += (size_t)gridDim.x * THREADS) {
    float4 s = parts[i];
    for (int p = 1; p < nparts; ++p) {
      const float4 x = parts[(size_t)p * count4 + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    out[i] = s;
  }
}

// sum_parts over `count` floats (a multiple of 4; parts and out 16-byte aligned).
int sum_into(const float* parts, float* out, int nparts, size_t count, cudaStream_t st) {
  if (count % 4) return (int)cudaErrorInvalidValue;
  const size_t count4 = count / 4, blocks = (count4 + THREADS - 1) / THREADS;
  sum_parts<<<(int)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(parts), reinterpret_cast<float4*>(out), nparts, count4);
  return (int)cudaGetLastError();
}

}  // namespace
