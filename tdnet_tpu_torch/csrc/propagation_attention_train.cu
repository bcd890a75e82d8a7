// Training propagation attention for Hopper (sm_90a), f32 on the CUDA cores:
//   forward  o = dropout(softmax(q k^T * scale)) v,
//   backward dq, dk, dv, with the dropout mask regenerated, never stored.
//
// Replaces the TPU kernels tdnet_tpu/kernels/propagation_attention_train.py:
// _fwd_kernel and _bwd_kernel, reached through fused_propagation_attention_train.
//
// Shapes of the TD4-PSP18 training recipe (769x1537, kv_stride 3): three hops per step,
// 2,145 x 2,145, 2,145 x 2,145 and 18,721 x 2,145 (Lq x Lkv), d_k 64, d_v 512.
// At the last hop the forward is 2 Lq Lkv (64 + 512) = 46 GFLOP and the backward
// (dq, dk, dv and the recomputed scores) at least 2 Lq Lkv (2 * 512 + 3 * 64) = 98 GFLOP,
// against 2 x 38 MB of q-side tensors: bound by arithmetic (67 TFLOP/s f32 on the
// CUDA cores: 0.7 and 1.5 ms).
//
// Design. The TPU kernel holds all of K and V in VMEM and carries dk and dv in f32
// across a sequential q grid. On Hopper V alone is 4.4 MB in f32 and blocks run in
// parallel, so nothing is carried between blocks:
//   forward   stats_f32 (row max m and sum l) then pv_f32<DROP> (attention_f32.cuh):
//             p = exp(s - m) / l exactly, the mask applied to p, d_v split over blocks
//             of 128 columns. m and l are saved for the backward.
//   backward  rowdot:  D_i = dy_i . o_i, the softmax-VJP term: with o = (p * keep / (1 -
//                      rate)) v, sum_j dp_ij p_ij = dy_i . o_i, dropout or not;
//             dq pass: q-major. A block owns 64 q rows and a range of key chunks;
//                      per chunk it recomputes s and p, forms dpd = dy v^T over all of
//                      d_v in 64-column steps, ds = p (mask(dpd) - D), dq += ds k.
//                      Key ranges are split over blocks (partials summed afterwards) so
//                      that the card has several waves of blocks at Lq = 2,145.
//             dkdv pass: KV-major. A block owns 64 keys, one 128-column slice of d_v and
//                      a range of q chunks; per chunk it recomputes s^T and p, then
//                      dv += pd^T dy[:, slice] and, since ds is linear in dpd, the
//                      slice's share of dk += ds_slice^T q, with the -p D term added by
//                      slice 0 only. Partials over q ranges and slices are summed after.
//             sum_parts: the partials summed in a fixed order (no atomics).
// The mask is a pure function of (seed, (b * Lq + i) * Lkv + j) (dropout_hash.cuh), so
// the forward, both backward passes and the plain PyTorch version draw the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"

namespace {

constexpr int VS = BD + 1;  // padded row stride of the 128-wide slice tiles
constexpr size_t DQ_SMEM = sizeof(float) * (5 * 64 * KS);
constexpr size_t DKDV_SMEM = sizeof(float) * (4 * 64 * KS + 2 * 64 * VS + 3 * 64);

struct Drop {
  uint32_t seed, threshold;
  float inv_keep;
};

// D[r] = sum_c dy[r, c] o[r, c]; one warp per row.
__global__ void __launch_bounds__(THREADS)
rowdot_f32(const float* __restrict__ dy, const float* __restrict__ o, float* __restrict__ d,
           int rows, int dv) {
  const int row = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / 32), lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* a = dy + (size_t)row * dv;
  const float* b = o + (size_t)row * dv;
  float s = 0.f;
  for (int c = lane; c < dv; c += 32) s = fmaf(a[c], b[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) d[row] = s;
}

// Partial dq of 64 q rows over key chunks [c_begin, c_end) of split blockIdx.y:
// dq_part[split, b, r, :] = scale * sum_j ds_rj k_j.
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dy, const float* __restrict__ row_max,
       const float* __restrict__ row_sum, const float* __restrict__ dsum,
       float* __restrict__ dq_part, int n, int lq, int lkv, int dv, float scale,
       int chunks_per_split, Drop drop) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + 64 * KS;
  float* dys = ks + 64 * KS;
  float* vs = dys + 64 * KS;
  float* dss = vs + 64 * KS;
  const int b = blockIdx.z, split = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k_begin = split * chunks_per_split * BK;
  const int k_end = min(lkv, k_begin + chunks_per_split * BK);
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  dy += (size_t)b * lq * dv;
  load_rows64(qs, q, q0, lq);

  float mrow[4], lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    mrow[i] = r < lq ? row_max[(size_t)b * lq + r] : 0.f;
    lrow[i] = r < lq ? row_sum[(size_t)b * lq + r] : 1.f;
    drow[i] = r < lq ? dsum[(size_t)b * lq + r] : 0.f;
  }
  float acc[4][4];
  zero_tile(acc);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows64(ks, k, k0, lkv);
    __syncthreads();
    float s[4][4], g[4][4];
    score_tile(qs, ks, scale, s);
    zero_tile(g);
    for (int c0 = 0; c0 < dv; c0 += 64) {  // g = dy v^T over all of d_v
      __syncthreads();
      load_tile_f32<64>(dys, KS, dy, dv, q0, c0, lq);
      load_tile_f32<64>(vs, KS, v, dv, k0, c0, lkv);
      __syncthreads();
      tile_dot_acc<64>(dys, KS, vs, KS, g);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = key < k_end ? expf(s[i][j] - mrow[i]) / lrow[i] : 0.f;
        float dp = g[i][j];
        if (DROP) {
          const uint64_t idx = (uint64_t)((size_t)b * lq + q0 + ty * 4 + i) * lkv + key;
          dp = tdnet_keep(drop.seed, idx, drop.threshold) ? dp * drop.inv_keep : 0.f;
        }
        dss[(ty * 4 + i) * KS + tx + 16 * j] = p * (dp - drow[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {  // acc += ds (64 x 64 keys) k (64 keys x 64)
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty * 4 + i) * KS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[kk * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
  }
  float* out = dq_part + ((size_t)split * n + b) * lq * DK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)r * DK + tx + 16 * j] = acc[i][j] * scale;
  }
}

// Partial dv and dk of 64 keys, d_v slice blockIdx.y, over q chunks of split blockIdx.z:
//   dv_part[qs, b, key, slice cols] = sum_r pd_rk dy_r[slice]
//   dk_part[qs * slices + slice, b, key, :] = scale * sum_r ds_rk(slice) q_r
template <bool DROP>
__global__ void __launch_bounds__(THREADS)
dkdv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ dy, const float* __restrict__ row_max,
         const float* __restrict__ row_sum, const float* __restrict__ dsum,
         float* __restrict__ dk_part, float* __restrict__ dv_part, int n, int lq, int lkv,
         int dv, float scale, int chunks_per_split, Drop drop) {
  extern __shared__ float smem[];
  float* ks = smem;            // [64 keys][KS]
  float* qs = ks + 64 * KS;    // [64 q][KS]
  float* pds = qs + 64 * KS;   // [64 keys][KS]: pd^T
  float* dss = pds + 64 * KS;  // [64 keys][KS]: ds^T (this slice's share)
  float* vs = dss + 64 * KS;   // [64 keys][VS]: v[:, slice]
  float* dys = vs + 64 * VS;   // [64 q][VS]: dy[:, slice]
  float* ms = dys + 64 * VS;   // the q chunk's m, l and D
  float* ls = ms + 64;
  float* ds_ = ls + 64;
  const int slice = blockIdx.y, slices = gridDim.y, qsplit = blockIdx.z / n,
            b = blockIdx.z % n;
  const int key0 = blockIdx.x * BK, d0 = slice * BD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_begin = qsplit * chunks_per_split * BQ;
  const int q_end = min(lq, q_begin + chunks_per_split * BQ);
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  dy += (size_t)b * lq * dv;
  row_max += (size_t)b * lq;
  row_sum += (size_t)b * lq;
  dsum += (size_t)b * lq;
  load_rows64(ks, k, key0, lkv);
  load_tile_f32<BD>(vs, VS, v, dv, key0, d0, lkv);

  float dva[4][8], dka[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dva[i][j] = 0.f;
  zero_tile(dka);

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();
    load_rows64(qs, q, q0, lq);
    load_tile_f32<BD>(dys, VS, dy, dv, q0, d0, lq);
    if (threadIdx.x < 64) {
      const int r = q0 + threadIdx.x;
      ms[threadIdx.x] = r < lq ? row_max[r] : 0.f;
      ls[threadIdx.x] = r < lq ? row_sum[r] : 1.f;
      ds_[threadIdx.x] = r < lq ? dsum[r] : 0.f;
    }
    __syncthreads();
    float st[4][4], g[4][4];  // rows: keys 4 ty + i; columns: q rows tx + 16 j
    score_tile(ks, qs, scale, st);
    zero_tile(g);
    tile_dot_acc<BD>(vs, VS, dys, VS, g);  // g = v[:, slice] dy[:, slice]^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, r = q0 + c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + ty * 4 + i;
        const float p = (r < q_end && key < lkv) ? expf(st[i][j] - ms[c]) / ls[c] : 0.f;
        float pd = p, dp = g[i][j];
        if (DROP) {
          const uint64_t idx = (uint64_t)((size_t)b * lq + r) * lkv + key;
          const bool kept = tdnet_keep(drop.seed, idx, drop.threshold);
          pd = kept ? p * drop.inv_keep : 0.f;
          dp = kept ? dp * drop.inv_keep : 0.f;
        }
        pds[(ty * 4 + i) * KS + c] = pd;
        dss[(ty * 4 + i) * KS + c] = p * (dp - (slice == 0 ? ds_[c] : 0.f));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BQ; ++kk) {
      float a[4], e[4], bd[8], bq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = pds[(ty * 4 + i) * KS + kk];
        e[i] = dss[(ty * 4 + i) * KS + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) bd[j] = dys[kk * VS + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j) bq[j] = qs[kk * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dva[i][j] = fmaf(a[i], bd[j], dva[i][j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) dka[i][j] = fmaf(e[i], bq[j], dka[i][j]);
      }
    }
  }
  float* dvo = dv_part + ((size_t)qsplit * n + b) * lkv * dv;
  float* dko = dk_part + ((size_t)(qsplit * slices + slice) * n + b) * lkv * DK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + ty * 4 + i;
    if (key >= lkv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) dvo[(size_t)key * dv + d0 + tx + 16 * j] = dva[i][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) dko[(size_t)key * DK + tx + 16 * j] = dka[i][j] * scale;
  }
}

// out[i] = sum_p parts[p * count + i], summed in order p = 0, 1, ...
__global__ void __launch_bounds__(THREADS)
sum_parts(const float* __restrict__ parts, float* __restrict__ out, int nparts, size_t count) {
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < count;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += parts[(size_t)p * count + i];
    out[i] = s;
  }
}

int sum_into(const float* parts, float* out, int nparts, size_t count, cudaStream_t st) {
  const int blocks = (int)((count + THREADS - 1) / THREADS < 4096 ? (count + THREADS - 1) / THREADS
                                                                  : 4096);
  sum_parts<<<blocks, THREADS, 0, st>>>(parts, out, nparts, count);
  return (int)cudaGetLastError();
}

template <bool DROP>
int forward(const float* q, const float* k, const float* v, float* o, float* row_max,
            float* row_sum, int n, int lq, int lkv, int dv, float scale, Drop drop,
            cudaStream_t st) {
  const dim3 g_rows((lq + BQ - 1) / BQ, 1, n);
  stats_f32<<<g_rows, THREADS, STATS_SMEM, st>>>(q, k, row_max, row_sum, lq, lkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pv_f32<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 g_pv((lq + BQ - 1) / BQ, dv / BD, n);
  pv_f32<DROP><<<g_pv, THREADS, PV_SMEM, st>>>(q, k, v, row_max, row_sum, o, lq, lkv, dv,
                                                scale, drop.seed, drop.threshold, drop.inv_keep);
  return (int)cudaGetLastError();
}

template <bool DROP>
int backward(const float* q, const float* k, const float* v, const float* o, const float* dy,
             const float* row_max, const float* row_sum, float* dsum, float* dq, float* dk,
             float* dv_out, float* dq_part, float* dk_part, float* dv_part, int n, int lq,
             int lkv, int dv, float scale, int ksplit, int qsplit, Drop drop, cudaStream_t st) {
  const int rows = n * lq;
  rowdot_f32<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(dy, o, dsum, rows,
                                                                            dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int kchunks = (lkv + BK - 1) / BK, qchunks = (lq + BQ - 1) / BQ;
  err = cudaFuncSetAttribute(dq_f32<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 g_dq(qchunks, ksplit, n);
  dq_f32<DROP><<<g_dq, THREADS, DQ_SMEM, st>>>(q, k, v, dy, row_max, row_sum, dsum, dq_part, n,
                                                lq, lkv, dv, scale,
                                                (kchunks + ksplit - 1) / ksplit, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dkdv_f32<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DKDV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int slices = dv / BD;
  const dim3 g_kv(kchunks, slices, qsplit * n);
  dkdv_f32<DROP><<<g_kv, THREADS, DKDV_SMEM, st>>>(q, k, v, dy, row_max, row_sum, dsum, dk_part,
                                                    dv_part, n, lq, lkv, dv, scale,
                                                    (qchunks + qsplit - 1) / qsplit, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if ((err = (cudaError_t)sum_into(dq_part, dq, ksplit, (size_t)n * lq * DK, st)) != cudaSuccess)
    return (int)err;
  if ((err = (cudaError_t)sum_into(dk_part, dk, qsplit * slices, (size_t)n * lkv * DK, st)) !=
      cudaSuccess)
    return (int)err;
  return sum_into(dv_part, dv_out, qsplit, (size_t)n * lkv * dv, st);
}

}  // namespace

extern "C" {

// q [n, lq, 64], k [n, lkv, 64], v [n, lkv, dv], out o [n, lq, dv]; stats [2, n, lq] f32
// (row max, row sum; kept for the backward). drop_threshold 0: no dropout. All f32,
// contiguous; dv % 128 == 0. Returns the first CUDA error, 0 if there is none.
int tdnet_attention_train_fwd(const void* q, const void* k, const void* v, void* o, void* stats,
                              int n, int lq, int lkv, int dv, float scale, unsigned int seed,
                              unsigned int drop_threshold, float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)n * lq;
  const Drop drop{seed, drop_threshold, inv_keep};
  if (drop_threshold)
    return forward<true>((const float*)q, (const float*)k, (const float*)v, (float*)o, row_max,
                         row_sum, n, lq, lkv, dv, scale, drop, st);
  return forward<false>((const float*)q, (const float*)k, (const float*)v, (float*)o, row_max,
                        row_sum, n, lq, lkv, dv, scale, drop, st);
}

// The backward of the call above, given its o and stats and the upstream dy [n, lq, dv].
// Scratch: dsum [n, lq], dq_part [ksplit, n, lq, 64], dk_part [qsplit * dv / 128, n, lkv, 64],
// dv_part [qsplit, n, lkv, dv]. Outputs dq [n, lq, 64], dk [n, lkv, 64], dv [n, lkv, dv].
int tdnet_attention_train_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dy, const void* stats, void* dsum, void* dq, void* dk,
                              void* dv_out, void* dq_part, void* dk_part, void* dv_part, int n,
                              int lq, int lkv, int dv, float scale, int ksplit, int qsplit,
                              unsigned int seed, unsigned int drop_threshold, float inv_keep,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* row_max = (const float*)stats;
  const float* row_sum = row_max + (size_t)n * lq;
  const Drop drop{seed, drop_threshold, inv_keep};
  if (drop_threshold)
    return backward<true>((const float*)q, (const float*)k, (const float*)v, (const float*)o,
                          (const float*)dy, row_max, row_sum, (float*)dsum, (float*)dq,
                          (float*)dk, (float*)dv_out, (float*)dq_part, (float*)dk_part,
                          (float*)dv_part, n, lq, lkv, dv, scale, ksplit, qsplit, drop, st);
  return backward<false>((const float*)q, (const float*)k, (const float*)v, (const float*)o,
                         (const float*)dy, row_max, row_sum, (float*)dsum, (float*)dq,
                         (float*)dk, (float*)dv_out, (float*)dq_part, (float*)dk_part,
                         (float*)dv_part, n, lq, lkv, dv, scale, ksplit, qsplit, drop, st);
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
