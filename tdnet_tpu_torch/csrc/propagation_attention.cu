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
// arithmetic, not by memory. At the TD2 hop in f32 the bound is 1.482 ms on the CUDA
// cores (67 TFLOP/s) and 0.602 ms with every product in 3xTF32 on the tensor cores
// (495 / 3 TFLOP/s); in bf16, 0.100 ms (989 TFLOP/s).
//
// Design. The TPU kernel keeps all of K and V on chip and streams q blocks. On Hopper
// V alone (2,145 x 512 x 2 B in bf16) is ten times a block's shared memory, and a
// 512-wide f32 output row per q row is too much register state for one block. So:
//   1. stats: one pass over K chunks gives each q row its max m and its sum
//      l = sum exp(s - m) (the cheap d_k = 64 product only);
//   2. pv: each block owns 64 q rows and a slice of the d_v columns, walks the K/V
//      chunks, recomputes the 64 x 64 score tile, forms p = exp(s - m) / l exactly as
//      the reference does (no rescaling), rounds p to the input type like the
//      reference's cast, and accumulates p v in f32;
//   3. fc: a tiled GEMM with bias over the [n * Lq, d_v] PV result, which is written
//      in the input type first, as the reference casts it.
// Ragged Lq and Lkv edges are masked inside the kernels; nothing is padded.
// f32 inputs (attention_f32.cuh, pv_tc and fc_tc below): s on the CUDA cores in f32 (the
// softmax's exponent and the training kernel's backward need its exact bits), p v and the
// fc on the tensor cores in 3xTF32 (mma.sync m16n8k8, each operand split into TF32 hi and
// lo; tf32x3.cuh), f32's accuracy, each 32-deep chunk of an 8-column tile one chain added
// in round-to-nearest f32; a block owns all 512 columns, so s is formed twice (stats and
// pv), and key ranges summed in order fill the card where q blocks alone do not. bf16
// inputs run on the tensor cores (mma.sync m16n8k16, f32 accumulate); the score tile stays
// in registers and becomes the A operand of the PV product directly.
// Blocks run in any order, so each carries nothing to the next: the sequential TPU
// grid becomes a loop over K/V chunks inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
#include "tf32x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: stats_f32, pv_tc and, where the keys are split into ranges, sum_parts (both
// attention_f32.cuh), then fc_tc: p v and the fc on the tensor cores in 3xTF32 (tf32x3.cuh).
// ---------------------------------------------------------------------------

constexpr int PS = PK + 4; // row stride of the split A tiles (p, x): 4 mod 32 words

// pv_tc's shared memory: q, k (two buffers), p's hi and lo, v (two buffers of PK x (CW + 8))
template <int CW>
constexpr size_t pv_smem() {
  return sizeof(float) * ((BQ + 2 * PK) * TS + 2 * BQ * PS + 2 * PK * (CW + 8));
}

// The A fragment of rows [r0, r0 + 16) x columns [k0, k0 + 8) of a tile of 32-bit words
// (row stride PS) with one ldmatrix.x4: its b16 8 x 8 matrices are 8 x 4 word blocks, and
// lane l receives word (l / 4, l % 4) of each, the A layout. p = a tile + ldsm_offset(r0) + k0.
__device__ __forceinline__ int ldsm_offset(int r0) {
  const int l = threadIdx.x & 31;
  return (r0 + (l & 7) + (l & 8)) * PS + ((l >> 4) << 2);
}

__device__ __forceinline__ void ldsm_a(uint32_t f[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// acc += a b over one PK-deep chunk in 3xTF32, for this warp's rows 32 (w % 2) + 16 m
// (m < 2) and 8-column tiles j (j < CW / 32) from column CW / 4 (w / 2). a is a [64][PS]
// tile stored split (ah, al), b the chunk's [PK][CW + 8] tile, swizzled. The chunk's 4
// k-steps of a tile go to a fresh accumulator, added to acc in round-to-nearest f32; the
// chunk's A fragments stay in registers while the tiles are walked.
template <int CW>
__device__ __forceinline__ void mma_chunk(float acc[2][CW / 32][4], const uint32_t* ah,
                                          const uint32_t* al, const float* bt) {
  constexpr int VS = CW + 8;
  const int warp = threadIdx.x >> 5, mw = warp & 1, nw = warp >> 1;
  const int pa = ldsm_offset(32 * mw);
  int bo[2];
  kn_offsets(bo, VS, nw * (CW / 4));
  FragA a[PK / 8][2];
#pragma unroll
  for (int kk = 0; kk < PK / 8; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      ldsm_a(a[kk][m].hi, ah + pa + 16 * m * PS + 8 * kk);
      ldsm_a(a[kk][m].lo, al + pa + 16 * m * PS + 8 * kk);
    }
#pragma unroll
  for (int j = 0; j < CW / 32; ++j) {
    float t[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < PK / 8; ++kk) {
      FragB bf;
      load_b(bf, bt + 8 * j, bo, 8 * kk * VS);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma3(t[m], a[kk][m], bf);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) flush(acc[m][j], t[m]);
  }
}

// y[r, c] = acc (mma_chunk's layout) + bias[c] (none if bias is null) for the block's rows
// from row0 below `rows` and its CW columns from col0, y row-major with leading dimension ld.
template <int CW>
__device__ __forceinline__ void store_rows(float* y, int ld, int row0, int col0, int rows,
                                           const float acc[2][CW / 32][4], const float* bias) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int mw = warp & 1, nw = warp >> 1;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 32 * mw + 16 * m + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < CW / 32; ++j) {
        const int c = col0 + nw * (CW / 4) + 8 * j + 2 * t4;
        float2 val = make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
        if (bias) {
          val.x += bias[c];
          val.y += bias[c + 1];
        }
        *reinterpret_cast<float2*>(y + (size_t)r * ld + c) = val;
      }
    }
}

// Partial output `range` of o = p v: o + range n lq dv gets, for batch blockIdx.z, rows
// [64 blockIdx.x, + 64) and columns [d0, d0 + CW) with d0 = CW (blockIdx.y % (dv / CW)),
// sum_j p_rj v[j, d0 ..] over the keys of chunks [range k_per, + k_per), range =
// blockIdx.y / (dv / CW). Per 32-key chunk: k and v stream in by cp.async, double-buffered;
// p (chunk_p) is split into TF32 hi and lo once, as it is written to shared memory; then
// warp w accumulates rows 32 (w % 2).. and CW / 4 columns from CW / 4 (w / 2) of p v
// (mma_chunk).
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
pv_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
      const float* __restrict__ row_max, const float* __restrict__ row_sum,
      float* __restrict__ o, int n, int lq, int lkv, int dv, float scale, int k_per) {
  constexpr int VS = CW + 8;
  extern __shared__ __align__(16) float smem_pv[];
  float* qs = smem_pv;                                          // [BQ][TS]
  float* ks = qs + BQ * TS;                                     // [2][PK][TS]
  uint32_t* ph = reinterpret_cast<uint32_t*>(ks + 2 * PK * TS); // [BQ][PS]: p, TF32 hi
  uint32_t* pl = ph + BQ * PS;                                  // and lo
  float* vs = reinterpret_cast<float*>(pl + BQ * PS);           // [2][PK][VS], swizzled
  const int col_blocks = dv / CW;
  const int q0 = blockIdx.x * BQ, d0 = (blockIdx.y % col_blocks) * CW;
  const int range = blockIdx.y / col_blocks, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c_begin = range * k_per, c_end = min((lkv + PK - 1) / PK, c_begin + k_per);
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  o += ((size_t)range * n + b) * lq * dv;

  auto stage_kv = [&](int c, int buf) {
    stage_tile<PK, DK, TS, false>(ks + buf * PK * TS, k, DK, c * PK, 0, lkv);
    stage_tile<PK, CW, VS, true>(vs + buf * PK * VS, v, dv, c * PK, d0, lkv);
  };
  stage_tile<BQ, DK, TS, false>(qs, q, DK, q0, 0, lq);
  stage_kv(c_begin, 0);
  cp_commit();

  float mrow[4], lrow[4];
  load_row_stats(mrow, lrow, row_max + (size_t)b * lq, row_sum + (size_t)b * lq, lq, q0);
  float acc[2][CW / 32][4] = {};
  for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's p and buffers are free
    if (c + 1 < c_end) stage_kv(c + 1, buf ^ 1);
    cp_commit();
    float p[4][2];
    chunk_p<false>(p, qs, ks + buf * PK * TS, scale, mrow, lrow, b, lq, lkv, q0, c * PK, 0u, 0u,
                   1.f);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = (ty * 4 + i) * PS + tx + 16 * j;
        split(p[i][j], ph[e], pl[e]);
      }
    __syncthreads();  // p written
    mma_chunk<CW>(acc, ph, pl, vs + buf * PK * VS);
  }
  store_rows<CW>(o, dv, q0, d0, lq, acc, nullptr);
}

template <int CW>
int launch_pv(dim3 grid, const float* q, const float* k, const float* v, const float* row_max,
              const float* row_sum, float* o, int n, int lq, int lkv, int dv, float scale,
              int k_per, cudaStream_t st) {
  constexpr size_t smem = pv_smem<CW>();
  cudaError_t err =
      cudaFuncSetAttribute(pv_tc<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_tc<CW><<<grid, THREADS, smem, st>>>(q, k, v, row_max, row_sum, o, n, lq, lkv, dv, scale,
                                         k_per);
  return (int)cudaGetLastError();
}

// fc_tc's shared memory: x (two buffers) and its hi and lo, w (two buffers of PK x (CW + 8))
template <int CW>
constexpr size_t fc_smem() {
  return sizeof(float) * (4 * BQ * PS + 2 * PK * (CW + 8));
}

// y[r, :] = x[r, :] w + bias in 3xTF32 for rows [64 blockIdx.x, + 64) and columns
// [CW blockIdx.y, + CW); x [m, kdim], w [kdim, ndim], kdim % 32 == 0, ndim % CW == 0.
// pv_tc's product with x in p's place: per 32-deep chunk x's tile is split into TF32 hi and
// lo once, and the chunk is one chain (mma_chunk); x and w stream in by cp.async,
// double-buffered.
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
fc_tc(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
      float* __restrict__ y, int m, int kdim, int ndim) {
  constexpr int VS = CW + 8;
  extern __shared__ __align__(16) float smem_fc[];
  float* xs = smem_fc;                                          // [2][BQ][PS]
  uint32_t* xh = reinterpret_cast<uint32_t*>(xs + 2 * BQ * PS); // [BQ][PS]: x, TF32 hi
  uint32_t* xl = xh + BQ * PS;                                  // and lo
  float* ws = reinterpret_cast<float*>(xl + BQ * PS);           // [2][PK][VS], swizzled
  const int row0 = blockIdx.x * BQ, col0 = blockIdx.y * CW, chunks = kdim / PK;
  auto stage = [&](int c, int buf) {
    stage_tile<BQ, PK, PS, false>(xs + buf * BQ * PS, x, kdim, row0, c * PK, m);
    stage_tile<PK, CW, VS, true>(ws + buf * PK * VS, w, ndim, c * PK, col0, kdim);
  };
  stage(0, 0);
  cp_commit();
  float acc[2][CW / 32][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    cp_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's split x and buffers are free
    if (c + 1 < chunks) stage(c + 1, buf ^ 1);
    cp_commit();
    const float* xt = xs + buf * BQ * PS;
    for (int i = threadIdx.x; i < BQ * PK; i += THREADS) {
      const int e = (i / PK) * PS + i % PK;
      split(xt[e], xh[e], xl[e]);
    }
    __syncthreads();
    mma_chunk<CW>(acc, xh, xl, ws + buf * PK * VS);
  }
  store_rows<CW>(y, ndim, row0, col0, m, acc, bias);
}

template <int CW>
int launch_fc(const float* x, const float* w, const float* bias, float* y, int m, int dv,
              cudaStream_t st) {
  constexpr size_t smem = fc_smem<CW>();
  cudaError_t err =
      cudaFuncSetAttribute(fc_tc<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fc_tc<CW><<<dim3((m + BQ - 1) / BQ, dv / CW), THREADS, smem, st>>>(x, w, bias, y, m, dv, dv);
  return (int)cudaGetLastError();
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

// The PV pass runs blocks of `cols` columns (128, 256 or 512, dividing dv) over key ranges of
// k_per 32-key chunks, with more than one range into o_parts [ranges, n, lq, dv], summed in
// order; the fc blocks of fc_cols columns.
int run_f32(const float* q, const float* k, const float* v, const float* w, const float* bias,
            float* o_tmp, float* out, float* o_parts, float* row_max, float* row_sum, int n,
            int lq, int lkv, int dv, float scale, int cols, int fc_cols, int k_per,
            cudaStream_t st) {
  const int ranges = k_per > 0 ? ((lkv + PK - 1) / PK + k_per - 1) / k_per : 0;
  auto width_ok = [dv](int c) { return (c == 128 || c == 256 || c == 512) && dv % c == 0; };
  if (ranges < 1 || !width_ok(cols) || (w && !width_ok(fc_cols)) || (ranges > 1 && !o_parts))
    return (int)cudaErrorInvalidValue;
  stats_f32<<<dim3((lq + BQ - 1) / BQ, 1, n), THREADS, STATS_SMEM, st>>>(q, k, row_max, row_sum,
                                                                       lq, lkv, scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  float* o = w ? o_tmp : out;
  const dim3 grid((lq + BQ - 1) / BQ, dv / cols * ranges, n);
  float* dst = ranges > 1 ? o_parts : o;
#define TDNET_PV(CW) \
  launch_pv<CW>(grid, q, k, v, row_max, row_sum, dst, n, lq, lkv, dv, scale, k_per, st)
  err = cols == 512 ? TDNET_PV(512) : cols == 256 ? TDNET_PV(256) : TDNET_PV(128);
#undef TDNET_PV
  if (err != 0) return err;
  if (ranges > 1 && (err = sum_into(o_parts, o, ranges, (size_t)n * lq * dv, st)) != 0)
    return err;
  if (!w) return 0;
  return fc_cols == 512   ? launch_fc<512>(o_tmp, w, bias, out, n * lq, dv, st)
         : fc_cols == 256 ? launch_fc<256>(o_tmp, w, bias, out, n * lq, dv, st)
                          : launch_fc<128>(o_tmp, w, bias, out, n * lq, dv, st);
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
// f32 only: the PV pass and the fc take column blocks of `cols` and `fc_cols` (128, 256 or
// 512, dividing dv), the PV pass key ranges of k_per 32-key chunks, and o_parts [ranges, n,
// lq, dv] holds the ranges' partial outputs where there is more than one (see run_f32).
// Returns the first CUDA error of the launches, 0 if there is none.
int tdnet_propagation_attention(const void* q, const void* k, const void* v, const void* w,
                                const void* bias, void* o_tmp, void* out, void* o_parts,
                                void* stats, int n, int lq, int lkv, int dv, float scale,
                                int cols, int fc_cols, int k_per, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)n * lq;
  if (dtype == 0)
    return run_f32((const float*)q, (const float*)k, (const float*)v, (const float*)w,
                   (const float*)bias, (float*)o_tmp, (float*)out, (float*)o_parts, row_max,
                   row_sum, n, lq, lkv, dv, scale, cols, fc_cols, k_per, st);
  if (dtype == 1)
    return run_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)w,
                    (const bf16*)bias, (bf16*)o_tmp, (bf16*)out, row_max, row_sum, n, lq, lkv,
                    dv, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
