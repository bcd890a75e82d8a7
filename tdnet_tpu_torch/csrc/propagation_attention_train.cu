// Training propagation attention for Hopper (sm_90a). bf16: see "bf16 (mixed-precision
// training)" below (wgmma and TMA, K1's forward kernels of attention_bf16.cuh with the mask,
// a backward of three passes). f32:
//   forward  o = dropout(softmax(q k^T * scale)) v, on the CUDA cores, each output summed
//            over the keys in order as a plain f32 GEMM sums it;
//   backward dq, dk, dv, on the tensor cores in error-compensated TF32 (3xTF32, tf32x3.cuh),
//            with the dropout mask regenerated, never stored; the scores s as the forward
//            forms them.
//
// Replaces the TPU kernels tdnet_tpu/kernels/propagation_attention_train.py:
// _fwd_kernel and _bwd_kernel, reached through fused_propagation_attention_train.
//
// Shapes of the TD4-PSP18 training recipe (769x1537, kv_stride 3): three hops per step,
// 2,145 x 2,145, 2,145 x 2,145 and 18,721 x 2,145 (Lq x Lkv), d_k 64, d_v 512.
//
// Forward: stats_f32 (row max m and sum l; attention_f32.cuh, shared with K1's f32 path),
// then pv_fma: p = exp(s - m) / l exactly (chunk_p), the mask applied to p, o = p v with one
// fmaf a key from 0 in key order; m and l are saved for the backward. 2 Lq Lkv (64 + 512)
// FLOP, 46.26 GFLOP at the last hop: 0.690 ms at 67 TFLOP/s f32 on the CUDA cores (0.280 ms
// with p v in 3xTF32 at 495 / 3 TFLOP/s); the 38 MB of inputs and output take 0.011 ms at
// 3.35 TB/s, so arithmetic bounds it; the card's bound for f32-accurate products is the
// 3xTF32 one. A block owns 64 q rows and 128, 256 or 512 columns (column_width in
// kernels/grid.py), so s is formed once per that many columns, and p v runs from register
// tiles of 8 rows x 4, 8 or 16 columns fed by float4 reads, 16 to 64 FMAs a shared-memory
// read. p v on the tensor cores in 3xTF32 (as K1's pv_tc) is the open redesign.
// Why p v stays on the CUDA cores here while K1's f32 path runs it in 3xTF32: the train
// step's check (chip_smoke.py phase 9) holds every gradient of the kernel path to 1e-3 of
// the plain path's, from the recipe's seeded initial state. A p v in 3xTF32 lies 7.4e-7 rms
// from the plain path's cuBLAS GEMM (itself 7.0e-7 from float64; the 3xTF32 one 2.4e-7),
// and with dropout off that moved a few head ReLUs across zero: path 1's LayerNorm bias
// gradient went to 19x its limit, with the kernel's forward values and the plain backward
// alike (PERF.md, runs D2-D4). Summed in the GEMM's order, the kernel lies 1.0e-7 from it.
//
// Backward. With s = scale q k^T, p = exp(s - m) / l, keep the mask, pd = keep ? p / (1 -
// rate) : 0 and D_i = dy_i . o_i (= sum_j dp_ij p_ij, dropout or not):
//   dv = pd^T dy,  dpd = dy v^T,  ds = p (keep ? dpd / (1 - rate) : 0 - D),
//   dk = scale ds^T q,  dq = scale ds k.
// The least work is 2 (3 * 64 + 2 * 512) = 2,432 FLOP per (i, j): s, dpd, dv, dk, dq once
// each. That is 11.19 GFLOP at 2,145 x 2,145 and 97.66 GFLOP at 18,721 x 2,145, 120.0 a
// step, against about 96 MB of inputs and outputs at the last hop (0.03 ms at 3.35 TB/s):
// bound by arithmetic. The products dpd, dv, dk and dq (2,304 of the 2,432 FLOP) run on
// mma.sync m16n8k8 tf32 in 3xTF32: each operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi), and a b accumulates as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
// first, which keeps f32 accuracy (TF32 alone keeps about 3 digits). Three products a
// product put the bound at 495 / 3 = 165 TFLOP/s: 0.068 ms at 2,145 x 2,145 and 0.592 ms
// at 18,721 x 2,145.
// Two rules keep sum_j ds_ij at zero to rounding, as softmax's invariance makes it in
// exact arithmetic (the gradient of a bias shared by all keys, such as w_ks's, is that
// sum): s is recomputed on the CUDA cores in the forward's order (score_tile), so p is the
// forward's p to the bit; and the tensor core, which truncates as it accumulates, sums
// only short chains (2 k-steps of dpd, a 64-row chunk of dv and dk, 32 keys of dq) in a
// fresh accumulator that is then added in round-to-nearest f32. With s in 3xTF32 and
// dpd in one chain the gradient of w_ks's bias was 100 times the plain version's.
//
// Design (the TPU kernel holds K and V in VMEM and carries dk and dv across a sequential q
// grid; here blocks run in parallel):
//   rowdot_f32  D = rowsum(dy * o), one warp a row.
//   dkdv_tc     KV-major, each (i, j) done once. A block owns 32 keys and all of d_v: v
//               [32, d_v] and k [32, 64] stay in shared memory, dv [32, d_v] in registers
//               (64 a thread at d_v 512), dk [32, 64] too. It walks a range of 64-row q
//               chunks; per chunk: s^T = k q^T (FMAs), p from the saved m and l, the mask from
//               dropout_hash.cuh, pd^T to shared memory; dy streamed in 128-column pieces
//               (cp.async, double-buffered; the next chunk's q and first piece load during
//               the last piece), per piece dpd^T += v_piece dy_piece^T and dv[:, piece] +=
//               pd^T dy_piece; then ds^T to shared memory and to an f32 scratch ds [n, Lq,
//               Lds] (Lds = Lkv rounded up to 32; 163 MB at the last hop), and dk += ds^T q.
//               pd^T and ds^T are split into TF32 hi and lo once, as they are written.
//               8 warps: warp w owns keys 16 (w % 2) and q columns 16 (w / 2) of s and dpd,
//               dv columns 16 w of each piece for all 32 keys, and dk columns 16 (w / 2)
//               of keys 16 (w % 2). Shared memory 217,600 bytes at d_v 512 and 198
//               registers a thread (ptxas): one block (8 warps) an SM.
//   dq_tc       dq = scale ds k, a 3xTF32 GEMM: 64 rows x 64 columns a block, 32 keys a
//               step, double-buffered; 99 registers a thread: 2 blocks an SM.
//   sum_parts   Lkv = 2,145 gives 68 key blocks against 132 SMs, so q ranges are split over
//               blocks (and key ranges for dq at small Lq); the dk, dv and dq partials are
//               summed in a fixed order (attention_f32.cuh). No atomics: two runs give
//               the same bits.
// Tiles that a warp reads in the mma's A layout (v, pd^T, ds^T: row g, column t of each
// 8 x 4 quad) have a row stride of 4 mod 32 words; q and dy, read both as (row g, column t)
// and as (row t, column g), have a stride of 8 mod 32 and swap their 4-word halves on rows
// with bit 2 set: both patterns are free of bank conflicts. The mask is a pure function of
// (seed, (b * Lq + i) * Lkv + j) (dropout_hash.cuh), so the forward, the backward and the
// plain PyTorch version draw the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "attention_bf16.cuh"
#include "attention_f32.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int BKV = 32;         // keys per block of dkdv_tc
constexpr int PIECE = 128;      // dy columns per streamed piece
constexpr int AS = DK + 4;      // row stride of the A-layout 64-wide tiles (k, pd^T, ds^T)
constexpr int QS = DK + 8;      // row stride of the swizzled q tile
constexpr int YS = PIECE + 8;   // row stride of the swizzled dy piece
constexpr int GM = 64;          // dq_tc: rows of dq per block
constexpr int GK = BKV;         // dq_tc: keys per step (one dkdv_tc key block)
constexpr int GAS = GK + 4;     // dq_tc: row stride of the ds tile (A layout)

template <int NP>  // d_v = 128 NP
constexpr size_t kv_smem() {
  return sizeof(float) *
         (BKV * (NP * PIECE + 4) + 5 * BKV * AS + 2 * BQ * QS + 2 * BQ * YS + 2 * 3 * BQ);
}

// ---- the forward's PV pass

constexpr int PT = BQ + 4;  // row stride of pv_fma's p tile, stored by key

// pv_fma's shared memory: q, k (two buffers), p by key, v (two buffers of PK x CW)
template <int CW>
constexpr size_t fma_smem() {
  return sizeof(float) * ((BQ + 2 * PK) * TS + PK * PT + 2 * PK * CW);
}

// o[b, r, d0 + c] = sum_j p_rj v[b, j, d0 + c] for rows [64 blockIdx.x, + 64), columns
// [d0, d0 + CW) with d0 = CW blockIdx.y, batch blockIdx.z, with p and the mask from chunk_p.
// Each output is one fmaf a key, from 0 and in key order, as a plain f32 GEMM sums it: the
// train step's forward then rounds as its plain path does (see the note at the top). Per
// 32-key chunk k and v stream in by cp.async, double-buffered, and p is stored by key; warp w
// owns rows 8 w.. and lane l columns 4 l + 128 g (g < CW / 128), 8 x 4 CW / 128 outputs.
template <int CW, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
pv_fma(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ row_max, const float* __restrict__ row_sum,
       float* __restrict__ o, int lq, int lkv, int dv, float scale, Drop drop) {
  constexpr int NG = CW / 128;
  extern __shared__ __align__(16) float smem_fma[];
  float* qs = smem_fma;        // [BQ][TS]
  float* ks = qs + BQ * TS;    // [2][PK][TS]
  float* pt = ks + 2 * PK * TS; // [PK][PT]: p by key
  float* vs = pt + PK * PT;    // [2][PK][CW]
  const int q0 = blockIdx.x * BQ, d0 = blockIdx.y * CW, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (lkv + PK - 1) / PK;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  o += (size_t)b * lq * dv;

  auto stage_kv = [&](int c, int buf) {
    stage_tile<PK, DK, TS, false>(ks + buf * PK * TS, k, DK, c * PK, 0, lkv);
    stage_tile<PK, CW, CW, false>(vs + buf * PK * CW, v, dv, c * PK, d0, lkv);
  };
  stage_tile<BQ, DK, TS, false>(qs, q, DK, q0, 0, lq);
  stage_kv(0, 0);
  cp_commit();

  float mrow[4], lrow[4];
  load_row_stats(mrow, lrow, row_max + (size_t)b * lq, row_sum + (size_t)b * lq, lq, q0);
  float acc[8][4 * NG] = {};
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    cp_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's p and buffers are free
    if (c + 1 < chunks) stage_kv(c + 1, buf ^ 1);
    cp_commit();
    float p[4][2];
    chunk_p<DROP>(p, qs, ks + buf * PK * TS, scale, mrow, lrow, b, lq, lkv, q0, c * PK,
                  drop.seed, drop.threshold, drop.inv_keep);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[(tx + 16 * j) * PT + ty * 4 + i] = p[i][j];
    __syncthreads();  // p written
    const float* vt = vs + buf * PK * CW + 4 * lane;
#pragma unroll 4
    for (int kk = 0; kk < PK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + kk * PT + 8 * warp);
      const float4 pb = *reinterpret_cast<const float4*>(pt + kk * PT + 8 * warp + 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(vt + kk * CW + 128 * g);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][4 * g] = fmaf(pr[r], x.x, acc[r][4 * g]);
          acc[r][4 * g + 1] = fmaf(pr[r], x.y, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(pr[r], x.z, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(pr[r], x.w, acc[r][4 * g + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + 8 * warp + r;
    if (row >= lq) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(o + (size_t)row * dv + d0 + 4 * lane + 128 * g) =
          make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
  }
}

template <int CW, bool DROP>
int launch_fma(const float* q, const float* k, const float* v, const float* row_max,
               const float* row_sum, float* o, int n, int lq, int lkv, int dv, float scale,
               Drop drop, cudaStream_t st) {
  constexpr size_t smem = fma_smem<CW>();
  cudaError_t err = cudaFuncSetAttribute(pv_fma<CW, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_fma<CW, DROP><<<dim3((lq + BQ - 1) / BQ, dv / CW, n), THREADS, smem, st>>>(
      q, k, v, row_max, row_sum, o, lq, lkv, dv, scale, drop);
  return (int)cudaGetLastError();
}

template <bool DROP>
int forward(const float* q, const float* k, const float* v, float* o, float* row_max,
            float* row_sum, int n, int lq, int lkv, int dv, float scale, int cols, Drop drop,
            cudaStream_t st) {
  if ((cols != 128 && cols != 256 && cols != 512) || dv % cols) return (int)cudaErrorInvalidValue;
  stats_f32<<<dim3((lq + BQ - 1) / BQ, 1, n), THREADS, STATS_SMEM, st>>>(q, k, row_max, row_sum,
                                                                       lq, lkv, scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
#define TDNET_FMA(CW) \
  launch_fma<CW, DROP>(q, k, v, row_max, row_sum, o, n, lq, lkv, dv, scale, drop, st)
  return cols == 512 ? TDNET_FMA(512) : cols == 256 ? TDNET_FMA(256) : TDNET_FMA(128);
#undef TDNET_FMA
}

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

// Keys [32 blockIdx.x, + 32) of batch blockIdx.z over the q chunks of range blockIdx.y:
//   dv_part[range, b, key, :] = sum_r pd_rk dy_r,  dk_part[range, b, key, :] = scale sum_r ds_rk q_r,
// and ds[b, r, key] for every r of the range (keys past lkv get 0).
template <int NP, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
        const float* __restrict__ dy, const float* __restrict__ row_max,
        const float* __restrict__ row_sum, const float* __restrict__ dsum,
        float* __restrict__ ds, float* __restrict__ dk_part, float* __restrict__ dv_part, int n,
        int lq, int lkv, int lds, float scale, int chunks_per_split, Drop drop) {
  constexpr int DV = NP * PIECE, VT = DV + 4;
  extern __shared__ __align__(16) float smem_tc[];
  float* vs = smem_tc;          // [BKV][VT]
  float* ks = vs + BKV * VT;    // [BKV][AS]
  // [BKV][AS] each: pd^T and ds^T of the chunk, split into TF32 hi and lo once
  uint32_t* pdh = reinterpret_cast<uint32_t*>(ks + BKV * AS);
  uint32_t* pdl = pdh + BKV * AS;
  uint32_t* dsh = pdl + BKV * AS;
  uint32_t* dsl = dsh + BKV * AS;
  float* qs = reinterpret_cast<float*>(dsl + BKV * AS);  // [2][BQ][QS], swizzled
  float* ys = qs + 2 * BQ * QS; // [2][BQ][YS], swizzled
  float* st = ys + 2 * BQ * YS; // [2][3][BQ]: the chunk's m, l and D
  const int key0 = blockIdx.x * BKV, range = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int mw = warp & 1, nw = warp >> 1;
  const int c_begin = range * chunks_per_split;
  const int c_end = min((lq + BQ - 1) / BQ, c_begin + chunks_per_split);
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * DV;
  dy += (size_t)b * lq * DV;
  row_max += (size_t)b * lq;
  row_sum += (size_t)b * lq;
  dsum += (size_t)b * lq;
  ds += (size_t)b * lq * lds;

  auto stage_q = [&](int c, int buf) {
    stage_tile<BQ, DK, QS, true>(qs + buf * BQ * QS, q, DK, c * BQ, 0, lq);
    if (threadIdx.x < 3 * BQ) {
      const int which = threadIdx.x / BQ, r = c * BQ + threadIdx.x % BQ;
      const float* src = which == 0 ? row_max : which == 1 ? row_sum : dsum;
      cp_async4(st + buf * 3 * BQ + threadIdx.x, src + (r < lq ? r : 0), r < lq);
    }
  };
  auto stage_y = [&](int c, int piece, int buf) {
    stage_tile<BQ, PIECE, YS, true>(ys + buf * BQ * YS, dy, DV, c * BQ, piece * PIECE, lq);
  };
  stage_tile<BKV, DV, VT, false>(vs, v, DV, key0, 0, lkv);
  stage_tile<BKV, DK, AS, false>(ks, k, DK, key0, 0, lkv);
  stage_q(c_begin, 0);
  stage_y(c_begin, 0, 0);
  cp_commit();

  // per-thread fragment pointers and offsets
  const float* va = a_ptr(vs, VT, 16 * mw);
  const int pa = a_offset(AS, 0);  // + 16 m AS: key tile m of pd^T and ds^T
  int y_nk[2][2], y_kn[2][2], q_kn[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    nk_offsets(y_nk[j], YS, 16 * nw + 8 * j);
    kn_offsets(y_kn[j], YS, 16 * warp + 8 * j);
    kn_offsets(q_kn[j], QS, 16 * nw + 8 * j);
  }

  float dva[NP][2][2][4] = {}, dka[2][4] = {};
  for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
    const int q0 = c * BQ;
    const float* qt = qs + (it & 1) * BQ * QS;
    const float* sm = st + (it & 1) * 3 * BQ;
    cp_wait_all();
    __syncthreads();

    // s^T: keys 16 mw.., q columns 16 nw.., on the CUDA cores in the forward's order
    // (score_tile: one fmaf a depth step from 0, then the scale), so that p is the
    // forward's p to the bit and sum_j ds_ij vanishes to rounding as in exact arithmetic
    float sa[2][4] = {};
    {
      const float* k0r = ks + (16 * mw + g) * AS;
#pragma unroll 4
      for (int d0 = 0; d0 < DK; d0 += 4) {
        float4 kv[2], qv[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) kv[h] = *reinterpret_cast<const float4*>(k0r + 8 * h * AS + d0);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = 16 * nw + 8 * j + 2 * t4 + c2;
            qv[j][c2] = *reinterpret_cast<const float4*>(qt + swz(col, d0, QS));
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 a = kv[e >> 1], b = qv[j][e & 1];
            float acc = sa[j][e];
            acc = fmaf(b.x, a.x, acc);
            acc = fmaf(b.y, a.y, acc);
            acc = fmaf(b.z, a.z, acc);
            acc = fmaf(b.w, a.w, acc);
            sa[j][e] = acc;
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] *= scale;
    }
    float p[2][4];
    uint32_t keep = 0u;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = 16 * mw + g + 8 * (e >> 1), col = 16 * nw + 8 * j + 2 * t4 + (e & 1);
        const int key = key0 + kr, r = q0 + col;
        const bool valid = key < lkv && r < lq;
        const float pv = valid ? expf(sa[j][e] - sm[col]) / sm[BQ + col] : 0.f;
        float pd = pv;
        if (DROP) {
          const bool kept =
              valid && tdnet_keep(drop.seed, ((uint64_t)b * lq + r) * lkv + key, drop.threshold);
          keep |= (uint32_t)kept << (4 * j + e);
          pd = kept ? pv * drop.inv_keep : 0.f;
        }
        p[j][e] = pv;
        split(pd, pdh[kr * AS + col], pdl[kr * AS + col]);
      }

    float ga[2][4] = {};  // dpd^T, the tiles of sa
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      const int buf = (it * NP + pc) & 1;
      cp_wait_all();
      __syncthreads();  // this piece landed, pd^T written, the other buffer free
      if (pc + 1 < NP) {
        stage_y(c, pc + 1, buf ^ 1);
      } else if (c + 1 < c_end) {
        stage_q(c + 1, (it + 1) & 1);
        stage_y(c + 1, 0, buf ^ 1);
      }
      cp_commit();
      const float* yt = ys + buf * BQ * YS;
      // dpd^T += v[:, piece] dy_piece^T, two k-steps a fresh accumulator
#pragma unroll 2
      for (int c0 = 0; c0 < PIECE; c0 += 16) {
        float tg[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 16; kk += 8) {
          FragA a;
          load_a(a, va + pc * PIECE + c0 + kk, VT);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            FragB bf;
            load_b(bf, yt, y_nk[j], c0 + kk);
            mma3(tg[j], a, bf);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) flush(ga[j], tg[j]);
      }
      // dv[:, piece] += pd^T dy_piece: all 32 keys, columns 16 w.. of the piece; the
      // chunk's 8 k-steps in a fresh accumulator
      float tv[2][2][4] = {};
#pragma unroll 2
      for (int r0 = 0; r0 < BQ; r0 += 8) {
        FragA a[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) load_a_split(a[m], pdh + pa + 16 * m * AS + r0,
                                                 pdl + pa + 16 * m * AS + r0, AS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB bf;
          load_b(bf, yt, y_kn[j], r0 * YS);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma3(tv[m][j], a[m], bf);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j) flush(dva[pc][m][j], tv[m][j]);
    }

    // ds = p (mask(dpd) - D)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = 16 * mw + g + 8 * (e >> 1), col = 16 * nw + 8 * j + 2 * t4 + (e & 1);
        const int r = q0 + col;
        float dp = ga[j][e];
        if (DROP) dp = (keep >> (4 * j + e)) & 1u ? dp * drop.inv_keep : 0.f;
        const float dsv = p[j][e] * (dp - sm[2 * BQ + col]);
        split(dsv, dsh[kr * AS + col], dsl[kr * AS + col]);
        if (r < lq) ds[(size_t)r * lds + key0 + kr] = dsv;
      }
    __syncthreads();
    // dk += ds^T q: keys 16 mw.., dk columns 16 nw..; the chunk in a fresh accumulator
    float tk[2][4] = {};
#pragma unroll 2
    for (int r0 = 0; r0 < BQ; r0 += 8) {
      FragA a;
      load_a_split(a, dsh + pa + 16 * mw * AS + r0, dsl + pa + 16 * mw * AS + r0, AS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB bf;
        load_b(bf, qt, q_kn[j], r0 * QS);
        mma3(tk[j], a, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) flush(dka[j], tk[j]);
  }

  float* dvo = dv_part + ((size_t)range * n + b) * lkv * DV;
  float* dko = dk_part + ((size_t)range * n + b) * lkv * DK;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 16 * m + g + 8 * h;
      if (key >= lkv) continue;
#pragma unroll
      for (int pc = 0; pc < NP; ++pc)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(dvo + (size_t)key * DV + pc * PIECE + 16 * warp + 8 * j +
                                     2 * t4) =
              make_float2(dva[pc][m][j][2 * h], dva[pc][m][j][2 * h + 1]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 16 * mw + g + 8 * h;
    if (key >= lkv) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float2*>(dko + (size_t)key * DK + 16 * nw + 8 * j + 2 * t4) =
          make_float2(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
  }
}

// dq_part[split, b, r, :] = scale sum over the 32-key steps of split blockIdx.y of
// ds[b, r, keys] k[b, keys, :], for rows [64 blockIdx.x, + 64). Warp w: rows 16 (w % 4),
// columns 32 (w / 4).
__global__ void __launch_bounds__(THREADS)
dq_tc(const float* __restrict__ ds, const float* __restrict__ k, float* __restrict__ dq_part,
      int n, int lq, int lkv, int lds, float scale, int steps_per_split) {
  __shared__ __align__(16) float as[2][GM * GAS];  // ds rows x 32 keys
  __shared__ __align__(16) float bs[2][GK * QS];   // 32 keys x 64, swizzled
  const int r0 = blockIdx.x * GM, split = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int mw = warp & 3, nw = warp >> 2;
  const int s_begin = split * steps_per_split;
  const int s_end = min(lds / GK, s_begin + steps_per_split);
  ds += (size_t)b * lq * lds;
  k += (size_t)b * lkv * DK;
  auto stage = [&](int s, int buf) {
    stage_tile<GM, GK, GAS, false>(as[buf], ds, lds, r0, s * GK, lq);
    stage_tile<GK, DK, QS, true>(bs[buf], k, DK, s * GK, 0, lkv);
  };
  stage(s_begin, 0);
  cp_commit();
  const float* a0p = a_ptr(as[0], GAS, 16 * mw);
  int b_kn[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) kn_offsets(b_kn[j], QS, 32 * nw + 8 * j);
  float acc[4][4] = {};
  for (int s = s_begin, it = 0; s < s_end; ++s, ++it) {
    cp_wait_all();
    __syncthreads();
    if (s + 1 < s_end) {
      stage(s + 1, (it + 1) & 1);
      cp_commit();
    }
    const float* at = a0p + (it & 1) * GM * GAS;
    const float* bt = bs[it & 1];
    float tq[4][4] = {};  // the step's 4 k-steps in a fresh accumulator
#pragma unroll
    for (int kk = 0; kk < GK; kk += 8) {
      FragA a;
      load_a(a, at + kk, GAS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bf;
        load_b(bf, bt, b_kn[j], kk * QS);
        mma3(tq[j], a, bf);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) flush(acc[j], tq[j]);
  }
  float* out = dq_part + ((size_t)split * n + b) * lq * DK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * mw + g + 8 * h;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(out + (size_t)r * DK + 32 * nw + 8 * j + 2 * t4) =
          make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int NP, bool DROP>
int backward(const float* q, const float* k, const float* v, const float* o, const float* dy,
             const float* row_max, const float* row_sum, float* dsum, float* ds, float* dq,
             float* dk, float* dv_out, float* dq_part, float* dk_part, float* dv_part, int n,
             int lq, int lkv, float scale, int q_per, int k_per, Drop drop, cudaStream_t st) {
  constexpr int DV = NP * PIECE;
  const int rows = n * lq;
  rowdot_f32<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(dy, o, dsum, rows,
                                                                            DV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int key_blocks = (lkv + BKV - 1) / BKV, lds = key_blocks * BKV;
  const int qsplit = ((lq + BQ - 1) / BQ + q_per - 1) / q_per;
  const int ksplit = (key_blocks + k_per - 1) / k_per;
  constexpr size_t smem = kv_smem<NP>();
  err = cudaFuncSetAttribute(dkdv_tc<NP, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dkdv_tc<NP, DROP><<<dim3(key_blocks, qsplit, n), THREADS, smem, st>>>(
      q, k, v, dy, row_max, row_sum, dsum, ds, dk_part, dv_part, n, lq, lkv, lds, scale, q_per,
      drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_tc<<<dim3((lq + GM - 1) / GM, ksplit, n), THREADS, 0, st>>>(ds, k, dq_part, n, lq, lkv, lds,
                                                                 scale, k_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = (cudaError_t)sum_into(dq_part, dq, ksplit, (size_t)n * lq * DK, st)) != cudaSuccess)
    return (int)err;
  if ((err = (cudaError_t)sum_into(dk_part, dk, qsplit, (size_t)n * lkv * DK, st)) != cudaSuccess)
    return (int)err;
  return sum_into(dv_part, dv_out, qsplit, (size_t)n * lkv * DV, st);
}

template <bool DROP>
int backward_dv(int dv, const float* q, const float* k, const float* v, const float* o,
                const float* dy, const float* row_max, const float* row_sum, float* dsum,
                float* ds, float* dq, float* dk, float* dv_out, float* dq_part, float* dk_part,
                float* dv_part, int n, int lq, int lkv, float scale, int q_per, int k_per,
                Drop drop, cudaStream_t st) {
#define TDNET_BWD(NP)                                                                         \
  backward<NP, DROP>(q, k, v, o, dy, row_max, row_sum, dsum, ds, dq, dk, dv_out, dq_part,     \
                     dk_part, dv_part, n, lq, lkv, scale, q_per, k_per, drop, st)
  switch (dv) {
    case 128: return TDNET_BWD(1);
    case 256: return TDNET_BWD(2);
    case 384: return TDNET_BWD(3);
    case 512: return TDNET_BWD(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDNET_BWD
}


// ---- bf16 (mixed-precision training): the TPU kernels' rounding points on wgmma (bf16
// operands, f32 accumulate), every tile brought in by TMA through a ring of shared-memory
// stages that one producer thread fills (hopper.cuh, attention_bf16.cuh).
//   forward  keep_bits, then K1's bf16 kernels (attention_bf16.cuh) with the mask: stats (m, l
//            in log2 units), then p v with p = 2^(s c - m) (1 / l), c = scale log2 e, times
//            keep ? 1 / (1 - rate) : 0 in f32, rounded to bf16 as the A operand of p v, o
//            summed in f32 and rounded once (_fwd_kernel, propagation_attention_train.py:
//            71-80). Where q blocks alone leave SMs idle (2,145 rows), the keys split into
//            ranges: stats ranges merged in order by the p v kernel, p v ranges summed in order
//            by sum_scaled<0>. The merged (m, l) and the keep bits are saved for the backward;
//            o is not.
//   backward dv = bf16(pd)^T dy; dp = dy v^T in f32 through the mask; t = sum_j dp p in f32 as
//            the TPU kernel forms it; ds = bf16(p (dp - t)); dq = scale ds k and dk = scale
//            ds^T q summed in f32 and rounded once; dv summed in f32 over every q range and
//            rounded once (_bwd_kernel, :83-112, :202-207). p is formed in every pass as the
//            forward forms it, from s (4 k16 steps from zero) and the saved (m, l).
//   keep_bits   the mask once a call as bits [n][lq][words] (dropout_hash.cuh's function of
//               (seed, (b lq + r) lkv + j)): a hash is some 20 integer operations, about an
//               element's share of the products on the tensor cores, so the p v kernel (once
//               a column block) and the backward's passes read bits instead of hashing.
// Three backward passes, no atomics (partials summed in a fixed order; two runs give the same
// bits):
//   rowt_wgmma  t, forward-shaped: a block owns 128 q rows (two consumer warpgroups of 64) and
//               a range of keys; its q tile and dy tile stay in shared memory (dy [128][d_v],
//               128 KB at d_v 512, loaded once: streaming it in d_v slabs beside v's would
//               read it again for every key chunk, twice the L2 traffic of v's chunks), and
//               32-key chunks of k and v stream through the ring; s = q k^T (4 k-steps) and
//               dp = dy v^T (d_v / 16 k-steps, one chain) are wgmma m64n32k16 from shared
//               memory; each thread sums dp p over its keys in key order, a row's quad adds
//               in a fixed order, and each key range writes its partial t.
//   row_terms   (m, 1 / l, t) of each q row, the key ranges' partial t added in order.
//   dkdv_wgmma  KV-major: a block owns 64 keys (the M of s^T and dp^T) and a range of 32-row q
//               chunks. k [64][64] and v [64][d_v] stay in shared memory; each chunk's q, dy,
//               row terms and keep words come through the ring. Both consumer warpgroups form
//               s^T = k q^T and dp^T = v dy^T for the block's 64 keys (wgmma m64n32k16), p, pd
//               and ds in f32 registers; pd^T and ds^T, rounded to bf16 in place, are the A
//               operands of dv += pd^T dy and dk += ds^T q from registers, as K1's p v takes p.
//               The register budget is the hard point: dv [64][d_v] in f32 is 256 registers a
//               thread of one warpgroup at d_v 512, so warpgroup cg owns dv's columns [d_v cg /
//               2, + d_v / 2) (128 registers) and dk over the q rows [16 cg, + 16) of each
//               chunk (32); both form s^T and dp^T, the price of no exchange between them. ds
//               rows [16 cg, + 16) of each chunk go to a bf16 scratch. 168 registers at launch,
//               240 by setmaxnreg, no spills (ptxas).
//   dq_wgmma    dq = ds k: a block owns 64 q rows and a range of 64-key chunks (split at small
//               Lq so that the blocks fill the card), ds's box the A operand (K-major), k's
//               chunk the B operand (N-major), wgmma m64n64k16.
//   sum_scaled<1>  dq, dk, dv: the partials summed in order, times the scale, rounded once.
// Bound by arithmetic at 989 TFLOP/s: 2 Lq Lkv (64 + 512) FLOP forward (0.047 ms at 18,721 x
// 2,145) and 2 Lq Lkv (2 512 + 3 64) backward (0.099 ms). On the tensor cores the backward
// runs 2 Lq Lkv (576 + 1,728 + 64): the t pass repeats s and dp, and both dk/dv warpgroups
// form s^T and dp^T, 1.95x the least work.
// A TMA box starts on a 16-byte boundary of its innermost dimension: the keep words' box is
// the 4 words of the block's 128-key group (a box starting at word 2 never completed its
// barrier, and the producer trapped).
namespace k2 {

using namespace attn;

constexpr int STATS_KEYS = 128;   // keys a chunk of the stats kernel (K1's)
constexpr int AUX_STAGES = 4;     // ring stages of the stats kernel
constexpr int T_ROWS = 128;       // q rows a block of rowt_wgmma: two consumer warpgroups
constexpr int T_KEYS = 32;        // keys a chunk of rowt_wgmma
constexpr int T_STAGES = 2;
constexpr int KV_KEYS = 64;       // keys a block of dkdv_wgmma: the M of s^T and dp^T
constexpr int KV_Q = 32;          // q rows a chunk of dkdv_wgmma: the N of s^T and dp^T
constexpr int KV_STAGES = 4;
constexpr int DQ_KEYS = 64;       // keys a chunk of dq_wgmma
constexpr int DQ_STAGES = 4;
constexpr int ROWS_BYTES = 1024;  // a dkdv stage's row terms (KV_Q float4) and keep words
constexpr int KEEP_BOX = 4;       // keep words a dkdv stage takes a q row: 128 keys

// keep words a row of the keep bits: ceil(lkv / 32) rounded up to 4
__host__ __device__ constexpr int keep_words(int lkv) { return ((lkv + 31) / 32 + 3) / 4 * 4; }

template <int NP>   // d_v = 128 NP
__host__ __device__ constexpr int t_head() {   // q, then dy's slabs
  return T_ROWS * ROW * (1 + 2 * NP);
}
template <int NP>
__host__ __device__ constexpr int t_stage() {   // k, then v's slabs
  return T_KEYS * ROW * (1 + 2 * NP);
}
template <int NP>
__host__ __device__ constexpr int kv_head() {   // k, then v's slabs
  return KV_KEYS * ROW * (1 + 2 * NP);
}
template <int NP>
__host__ __device__ constexpr int kv_stage() {   // q, dy, then the row terms and keep words
  return KV_Q * ROW * (1 + 2 * NP) + ROWS_BYTES;
}
constexpr int DQ_STAGE = 2 * 64 * ROW;                           // ds's box, k's chunk

// The keep bits of a call: bits[b][r][w], bit i = keep(seed, (b lq + r) lkv + 32 w + i) for
// 32 w + i < lkv, else 0; words = ceil(lkv / 32) rounded up to 4 (16-byte rows for TMA). The
// forward forms them once for its p v kernel and the backward's passes (which read them
// instead of hashing each element again: a hash is some 30 integer operations, as many as
// the element's share of the products on the tensor cores).
__global__ void __launch_bounds__(256)
keep_bits(uint32_t* __restrict__ bits, int lkv, int words, size_t total, Drop drop) {
  for (size_t i = blockIdx.x * (size_t)256 + threadIdx.x; i < total;
       i += (size_t)gridDim.x * 256) {
    const size_t row = i / words;
    const int key0 = 32 * (int)(i % words), count = min(32, lkv - key0);
    const uint64_t base = row * (uint64_t)lkv + key0;
    uint32_t word = 0;
    if (count > 0 && (base >> 32) == ((base + count - 1) >> 32)) {
      // the index's high half is the word's: hash(seed, idx) = mix(lo(idx) ^ mh) with mh
      // formed once (dropout_hash.cuh)
      const uint32_t mh = tdnet_mix32((uint32_t)(base >> 32) ^ tdnet_mix32(drop.seed));
      for (int j = 0; j < count; ++j)
        word |= (uint32_t)(tdnet_mix32((uint32_t)(base + j) ^ mh) < drop.threshold) << j;
    } else {
      for (int j = 0; j < count; ++j)
        word |= (uint32_t)tdnet_keep(drop.seed, base + j, drop.threshold) << j;
    }
    bits[i] = word;
  }
}

int launch_keep_bits(uint32_t* bits, int n, int lq, int lkv, const Drop& drop,
                     cudaStream_t st) {
  const int words = keep_words(lkv);
  const size_t total = (size_t)n * lq * words, blocks = (total + 255) / 256;
  keep_bits<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(bits, lkv, words, total,
                                                                        drop);
  return (int)cudaGetLastError();
}

// t_part[range][b][r] = sum_j dp_rj p_rj over the keys of chunks [range k_per, + k_per) for
// rows [128 x, + 128) of batch z (range = y), with p = 2^(s c - m) (1 / l) from the saved
// stats [2][n][lq] and dp = dy . v_j through the mask (DROP): dp keep / (1 - rate).
template <int NP, bool DROP>
__global__ void __launch_bounds__(384, 1)
rowt_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_dy,
           const float* __restrict__ stats, const uint32_t* __restrict__ bits,
           float* __restrict__ t_part, unsigned int* __restrict__ fault, int lq, int lkv,
           float c, int k_per, Drop drop) {
  constexpr int SLABS = 2 * NP, HEAD = t_head<NP>(), STAGE = t_stage<NP>();
  constexpr int Q_BYTES = T_ROWS * ROW, DY_SLAB = T_ROWS * ROW, V_SLAB = T_KEYS * ROW;
  extern __shared__ unsigned char smem_t[];
  const Ring ring(smem_t, T_STAGES, STAGE, HEAD);
  const int n = gridDim.z, b = blockIdx.z, range = blockIdx.y, c0 = range * k_per;
  const int r0 = blockIdx.x * T_ROWS;
  const int chunks = min((lkv + T_KEYS - 1) / T_KEYS - c0, k_per);
  init_ring<2>(ring, T_STAGES);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_K2_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x != 0) return;
    bar_expect(ring.head_full, HEAD);
    tma_load_3d(ring.head, &tm_q, 0, r0, b, ring.head_full);
    for (int j = 0; j < SLABS; ++j)
      tma_load_3d(ring.head + Q_BYTES + j * DY_SLAB, &tm_dy, 64 * j, r0, b, ring.head_full);
    for (int ch = 0; ch < chunks; ++ch) {
      wait_free(ring, ch, T_STAGES);
      const int s = ch % T_STAGES;
      unsigned char* st = ring.base + s * STAGE;
      bar_expect(ring.full + s, STAGE);
      const int key = (c0 + ch) * T_KEYS;
      tma_load_3d(st, &tm_k, 0, key, b, ring.full + s);
      for (int j = 0; j < SLABS; ++j)
        tma_load_3d(st + V_SLAB * (1 + j), &tm_v, 64 * j, key, b, ring.full + s);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS<2>>();
  const int cg = role - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = r0 + 64 * cg + 16 * warp + g;   // and row + 8
  const size_t nlq = (size_t)n * lq;
  float m[2], il[2], tacc[2] = {0.f, 0.f};
  const uint32_t* keep_row[2];
  const int words = keep_words(lkv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const bool ok = r < lq;
    m[h] = ok ? stats[(size_t)b * lq + r] : 0.f;
    il[h] = ok ? 1.f / stats[nlq + (size_t)b * lq + r] : 1.f;
    keep_row[h] = DROP && ok ? bits + ((size_t)b * lq + r) * words : nullptr;
  }
  const uint64_t qd = sw128_desc(ring.head + cg * 64 * ROW);
  bar_wait_or_flag(ring.head_full, 0, fault);
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % T_STAGES;
    bar_wait_or_flag(ring.full + s, (ch / T_STAGES) & 1, fault);
    const unsigned char* st = ring.base + s * STAGE;
    float sc[16], dp[16];
    const uint64_t kd = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_32<0>(sc, qd + 2 * kk, kd + 2 * kk, kk);
#pragma unroll
    for (int j = 0; j < SLABS; ++j) {
      const uint64_t ya = sw128_desc(ring.head + Q_BYTES + j * DY_SLAB + cg * 64 * ROW);
      const uint64_t vb = sw128_desc(st + V_SLAB * (1 + j));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_32<0>(dp, ya + 2 * kk, vb + 2 * kk, j | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(sc);
    fence_regs<16>(dp);
    if (lane == 0) bar_arrive(ring.empty + s);
    const int k0 = (c0 + ch) * T_KEYS;
    uint32_t kw[2] = {0u, 0u};   // the keep bits of the chunk's 32 keys, rows g and g + 8
    if (DROP)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (keep_row[h]) kw[h] = keep_row[h][k0 / 32];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, i = 8 * j + 2 * t + (e & 1);
        if (k0 + i >= lkv) continue;
        const float p = ex2(fmaf(sc[4 * j + e], c, -m[h])) * il[h];
        float d = dp[4 * j + e];
        if (DROP) d *= (kw[h] >> i) & 1u ? drop.inv_keep : 0.f;
        tacc[h] = fmaf(d, p, tacc[h]);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // a row's 4 threads are the 4 lanes of a quad
    tacc[h] += __shfl_xor_sync(0xffffffffu, tacc[h], 1);
    tacc[h] += __shfl_xor_sync(0xffffffffu, tacc[h], 2);
    const int r = row + 8 * h;
    if (t == 0 && r < lq) t_part[range * nlq + (size_t)b * lq + r] = tacc[h];
  }
}

// rows[i] = (m_i, 1 / l_i, sum_p t_part[p][i] in order p = 0, 1, .., 0) for i < count = n lq.
__global__ void __launch_bounds__(256)
row_terms(const float* __restrict__ stats, const float* __restrict__ t_part,
          float4* __restrict__ rows, int count, int ranges) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= count) return;
  float t = t_part[i];
  for (int p = 1; p < ranges; ++p) t += t_part[(size_t)p * count + i];
  rows[i] = make_float4(stats[i], 1.f / stats[count + i], t, 0.f);
}

// Keys [64 x, + 64) of batch z over the 32-row q chunks [range q_per, + q_per), range = y:
//   dv_part[range][b][key][:] = sum_r bf16(pd_rk) dy_r (f32), warpgroup cg columns
//   [64 NP cg, + 64 NP); dk_part[2 range + cg][b][key][:] = sum over the chunks' q rows
//   [16 cg, + 16) of ds_rk q_r (f32, unscaled); ds[b][r][key] = bf16(p (dp - t)) for the rows
//   [16 cg, + 16) of each chunk (0 for keys past lkv). The row terms (m, 1 / l, t) come with
//   each chunk through tm_rows ([n][lq][4] f32).
template <int NP, bool DROP>
__global__ void __launch_bounds__(384, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_dy,
           const __grid_constant__ CUtensorMap tm_rows, const __grid_constant__ CUtensorMap tm_keep,
           bf16* __restrict__ ds,
           float* __restrict__ dk_part, float* __restrict__ dv_part,
           unsigned int* __restrict__ fault, int lq, int lkv, int lds, float c, int q_per,
           Drop drop) {
  constexpr int SLABS = 2 * NP, DV = 128 * NP, HEAD = kv_head<NP>(), STAGE = kv_stage<NP>();
  constexpr int K_BYTES = KV_KEYS * ROW, V_SLAB = KV_KEYS * ROW;
  constexpr int Q_BYTES = KV_Q * ROW, DY_SLAB = KV_Q * ROW, ROWS_AT = Q_BYTES + SLABS * DY_SLAB;
  extern __shared__ unsigned char smem_kv[];
  const Ring ring(smem_kv, KV_STAGES, STAGE, HEAD);
  const int n = gridDim.z, b = blockIdx.z, key0 = blockIdx.x * KV_KEYS, range = blockIdx.y;
  const int qc0 = range * q_per;
  const int chunks = min((lq + KV_Q - 1) / KV_Q - qc0, q_per);
  init_ring<2>(ring, KV_STAGES);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_K2_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x != 0) return;
    bar_expect(ring.head_full, HEAD);
    tma_load_3d(ring.head, &tm_k, 0, key0, b, ring.head_full);
    for (int j = 0; j < SLABS; ++j)
      tma_load_3d(ring.head + K_BYTES + j * V_SLAB, &tm_v, 64 * j, key0, b, ring.head_full);
    for (int ch = 0; ch < chunks; ++ch) {
      wait_free(ring, ch, KV_STAGES);
      const int s = ch % KV_STAGES;
      unsigned char* st = ring.base + s * STAGE;
      bar_expect(ring.full + s, ROWS_AT + KV_Q * 16 + (DROP ? KV_Q * KEEP_BOX * 4 : 0));
      const int q0 = (qc0 + ch) * KV_Q;
      tma_load_3d(st, &tm_q, 0, q0, b, ring.full + s);
      for (int j = 0; j < SLABS; ++j)
        tma_load_3d(st + Q_BYTES + j * DY_SLAB, &tm_dy, 64 * j, q0, b, ring.full + s);
      tma_load_3d(st + ROWS_AT, &tm_rows, 0, q0, b, ring.full + s);
      // the 4 words of the block's 64 keys' 128-key group: a box starts on 16 bytes
      if (DROP) tma_load_3d(st + ROWS_AT + KV_Q * 16, &tm_keep, key0 / 128 * 4, q0, b,
                            ring.full + s);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS<2>>();
  const int cg = role - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint64_t kd = sw128_desc(ring.head);
  float dva[NP][32], dka[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dka[i] = 0.f;
#pragma unroll
    for (int hh = 0; hh < NP; ++hh) dva[hh][i] = 0.f;
  }
  unsigned short* dsb = reinterpret_cast<unsigned short*>(ds) + (size_t)b * lq * lds;
  bar_wait_or_flag(ring.head_full, 0, fault);
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % KV_STAGES;
    bar_wait_or_flag(ring.full + s, (ch / KV_STAGES) & 1, fault);
    const unsigned char* st = ring.base + s * STAGE;
    const int q0 = (qc0 + ch) * KV_Q;
    float sc[16], dp[16];
    const uint64_t qb = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_32<0>(sc, kd + 2 * kk, qb + 2 * kk, kk);
#pragma unroll
    for (int j = 0; j < SLABS; ++j) {
      const uint64_t va = sw128_desc(ring.head + K_BYTES + j * V_SLAB);
      const uint64_t yb = sw128_desc(st + Q_BYTES + j * DY_SLAB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_32<0>(dp, va + 2 * kk, yb + 2 * kk, j | kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(sc);
    fence_regs<16>(dp);
    // s^T[4 j + e]: key key0 + 16 warp + g + 8 (e / 2), q row q0 + 8 j + 2 t + e % 2
    const float4* terms = reinterpret_cast<const float4*>(st + ROWS_AT);
    // the keep words of the chunk's rows: [KV_Q][KEEP_BOX] from key key0 / 128 * 128; key
    // key0 + kl in word (key0 % 128 + kl) / 32
    const uint32_t* keep = reinterpret_cast<const uint32_t*>(st + ROWS_AT + KV_Q * 16);
    uint32_t pa[2][4], da[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pdv[4], dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1), r = q0 + ql;
        const int key = key0 + 16 * warp + g + 8 * (e >> 1);
        const float4 rt = terms[ql];   // (m, 1 / l, t)
        const bool ok = r < lq && key < lkv;
        const float p = ok ? ex2(fmaf(sc[4 * j + e], c, -rt.x)) * rt.y : 0.f;
        float pd = p, d = dp[4 * j + e];
        if (DROP) {
          const int kl = key0 % 128 + 16 * warp + g + 8 * (e >> 1);
          const float ks = (keep[ql * KEEP_BOX + (kl >> 5)] >> (kl & 31)) & 1u ? drop.inv_keep
                                                                            : 0.f;
          pd = p * ks;
          d *= ks;
        }
        pdv[e] = pd;
        dsv[e] = p * (d - rt.z);
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(pdv[0], pdv[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pdv[2], pdv[3]);
      if ((j >> 1) == cg) {
        const uint32_t lo = pack_bf16(dsv[0], dsv[1]), hi = pack_bf16(dsv[2], dsv[3]);
        da[2 * (j % 2)] = lo;
        da[2 * (j % 2) + 1] = hi;
        // lo: keys g of q rows r, r + 1; hi: keys g + 8
        const int r = q0 + 8 * j + 2 * t, key = key0 + 16 * warp + g;
        if (r < lq) {
          dsb[(size_t)r * lds + key] = (unsigned short)(lo & 0xFFFFu);
          dsb[(size_t)r * lds + key + 8] = (unsigned short)(hi & 0xFFFFu);
        }
        if (r + 1 < lq) {
          dsb[(size_t)(r + 1) * lds + key] = (unsigned short)(lo >> 16);
          dsb[(size_t)(r + 1) * lds + key + 8] = (unsigned short)(hi >> 16);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)   // the chunk's q rows [16 kk, + 16)
#pragma unroll
      for (int hh = 0; hh < NP; ++hh)
        wgmma_rs_64<1>(dva[hh], pa[kk],
                       sw128_n_desc(st + Q_BYTES + (NP * cg + hh) * DY_SLAB + kk * 16 * ROW,
                                    DY_SLAB), 1);
    wgmma_rs_64<1>(dka, da, sw128_n_desc(st + cg * 16 * ROW, Q_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NP; ++hh) fence_regs<32>(dva[hh]);
    fence_regs<32>(dka);
    if (lane == 0) bar_arrive(ring.empty + s);
  }
  float* dvo = dv_part + ((size_t)range * n + b) * lkv * DV;
  float* dko = dk_part + ((size_t)(2 * range + cg) * n + b) * lkv * D_K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 16 * warp + g + 8 * h;
    if (key >= lkv) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < NP; ++hh)
        *reinterpret_cast<float2*>(dvo + (size_t)key * DV + 64 * (NP * cg + hh) + 8 * j +
                                   2 * t) = make_float2(dva[hh][4 * j + 2 * h],
                                                        dva[hh][4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dko + (size_t)key * D_K + 8 * j + 2 * t) =
          make_float2(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
    }
  }
}

// dq_part[split][b][r][:] = sum over the 64-key chunks [split k_per, + k_per) of ds[b, r,
// keys] k[b, keys, :] (f32, unscaled) for rows [64 x, + 64) of batch z, split = y; ds through
// tm_ds ([n][lq][lds], boxes of 64 keys x 64 rows), k through tm_k (boxes of 64 x 64).
__global__ void __launch_bounds__(256, 2)
dq_wgmma(const __grid_constant__ CUtensorMap tm_ds, const __grid_constant__ CUtensorMap tm_k,
         float* __restrict__ dq_part, unsigned int* __restrict__ fault, int lq, int lds,
         int k_per) {
  extern __shared__ unsigned char smem_dq[];
  const Ring ring(smem_dq, DQ_STAGES, DQ_STAGE, 0);
  const int n = gridDim.z, b = blockIdx.z, split = blockIdx.y, c0 = split * k_per;
  const int r0 = blockIdx.x * 64;
  const int chunks = min(lds / DQ_KEYS - c0, k_per);
  init_ring<1>(ring, DQ_STAGES);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_K2_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x != 0) return;
    for (int ch = 0; ch < chunks; ++ch) {
      wait_free(ring, ch, DQ_STAGES);
      const int s = ch % DQ_STAGES;
      unsigned char* st = ring.base + s * DQ_STAGE;
      bar_expect(ring.full + s, DQ_STAGE);
      const int key = (c0 + ch) * DQ_KEYS;
      tma_load_3d(st, &tm_ds, key, r0, b, ring.full + s);
      tma_load_3d(st + 64 * ROW, &tm_k, 0, key, b, ring.full + s);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS<1>>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % DQ_STAGES;
    bar_wait_or_flag(ring.full + s, (ch / DQ_STAGES) & 1, fault);
    const unsigned char* st = ring.base + s * DQ_STAGE;
    const uint64_t a = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_64<1>(acc, a + 2 * kk, sw128_n_desc(st + 64 * ROW + kk * 16 * ROW, 64 * ROW), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    if (lane == 0) bar_arrive(ring.empty + s);
  }
  float* out = dq_part + ((size_t)split * n + b) * lq * D_K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + (size_t)r * D_K + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// out = bf16(scale sum_p parts[p]), summed in order p = 0, 1, ..; blockIdx.y picks the job.
// PASS names the caller in a profile: 0 the forward's partial outputs, 1 the backward's
// gradients.
struct SumJob {
  const float4* parts;
  uint2* out;
  int nparts;
  size_t count4;
  float scale;
};
struct SumJobs {
  SumJob job[3];
};

template <int PASS>
__global__ void __launch_bounds__(256)
sum_scaled(SumJobs jobs) {
  const SumJob job = blockIdx.y == 0 ? jobs.job[0] : blockIdx.y == 1 ? jobs.job[1] : jobs.job[2];
  for (size_t i = blockIdx.x * (size_t)256 + threadIdx.x; i < job.count4;
       i += (size_t)gridDim.x * 256) {
    float4 s = job.parts[i];
    for (int p = 1; p < job.nparts; ++p) {
      const float4 x = job.parts[(size_t)p * job.count4 + i];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    job.out[i] = make_uint2(pack_bf16(s.x * job.scale, s.y * job.scale),
                            pack_bf16(s.z * job.scale, s.w * job.scale));
  }
}

// Launch sum_scaled over the first `count` jobs.
template <int PASS>
int launch_sums(const SumJobs& jobs, int count, cudaStream_t st) {
  size_t most = 0;
  for (int i = 0; i < count; ++i) most = jobs.job[i].count4 > most ? jobs.job[i].count4 : most;
  const size_t blocks = (most + 255) / 256;
  sum_scaled<PASS><<<dim3((unsigned)(blocks < 2048 ? blocks : 2048), count), 256, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}

// The forward's tiling: q rows a block (64: one consumer warpgroup), 128 or 256 columns, 64
// keys a chunk and `stages` of the p v kernel, kernels/grid.py:train_forward_plan.
template <bool DROP>
int forward(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* o_part, float* stats,
            float* stats_part, uint32_t* bits, unsigned int* fault, int n, int lq, int lkv,
            int dv, float scale,
            int cols, int keys, int stages, int stat_kper, int pv_kper, const Drop& drop,
            cudaStream_t st) {
  if ((cols != 128 && cols != 256) || keys != 64 || dv % cols || stat_kper < 1 || pv_kper < 1)
    return (int)cudaErrorInvalidValue;
  const size_t nlq = (size_t)n * lq;
  const int stat_ranges = ((lkv + STATS_KEYS - 1) / STATS_KEYS + stat_kper - 1) / stat_kper;
  const int pv_ranges = ((lkv + keys - 1) / keys + pv_kper - 1) / pv_kper;
  if ((stat_ranges > 1 && !stats_part) || (pv_ranges > 1 && !o_part) || (DROP && !bits))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ts, tk, tv;
  int err = bf16_tensor_map(&ts, k, D_K, lkv, n, STATS_KEYS);
  if (err != 0 || (err = bf16_tensor_map(&tk, k, D_K, lkv, n, keys)) != 0 ||
      (err = bf16_tensor_map(&tv, v, dv, lkv, n, keys)) != 0)
    return err;
  const float c = scale * LOG2E;
  float* row_max = stat_ranges > 1 ? stats_part : stats;
  float* row_sum = row_max + (size_t)stat_ranges * nlq;
  const AttnOut so{row_max, row_sum, nullptr, nullptr, nullptr, fault};
  const Drop none{0u, 0u, 1.f};
  err = launch_attn<1, 128, STATS_KEYS, true, false>(q, ts, ts, so, n, lq, lkv, dv, c, AUX_STAGES,
                                                     stat_kper, 1, none, st);
  if (err != 0) return err;
  if (DROP && (err = launch_keep_bits(bits, n, lq, lkv, drop, st)) != 0) return err;
  const AttnOut po{row_max, row_sum, o,     pv_ranges > 1 ? o_part : nullptr,
                   stat_ranges > 1 ? stats : nullptr, fault, bits, keep_words(lkv)};
  err = cols == 128 ? launch_attn<1, 128, 64, false, DROP>(q, tk, tv, po, n, lq, lkv, dv, c,
                                                         stages, pv_kper, stat_ranges, drop, st)
                    : launch_attn<1, 256, 64, false, DROP>(q, tk, tv, po, n, lq, lkv, dv, c,
                                                         stages, pv_kper, stat_ranges, drop, st);
  if (err != 0 || pv_ranges == 1) return err;
  SumJobs jobs{};
  jobs.job[0] = SumJob{reinterpret_cast<const float4*>(o_part), reinterpret_cast<uint2*>(o),
                       pv_ranges, nlq * dv / 4, 1.f};
  return launch_sums<0>(jobs, 1, st);
}

// A failed step of the backward, named on stderr; returns its CUDA error.
inline int report(const char* step, int index, int err) {
  fprintf(stderr, "K2 bf16 backward: %s %d failed: CUDA error %d (%s)\n", step, index, err,
          cudaGetErrorString((cudaError_t)err));
  return err;
}

// The backward's scratch, carved by the caller (kernels/propagation_attention_train.py:
// backward_plan): rows [n][lq][4] f32, t_part [t_ranges][n][lq] f32, ds [n][lq][lds] bf16,
// dq_part [ksplit][n][lq][64], dk_part [2 qsplit][n][lkv][64] and dv_part [qsplit][n][lkv][dv]
// f32.
struct Scratch {
  float* rows;
  float* t_part;
  bf16* ds;
  float* dq_part;
  float* dk_part;
  float* dv_part;
};

template <int NP, bool DROP>
int backward(const bf16* q, const bf16* k, const bf16* v, const bf16* dy, const float* stats,
             const uint32_t* bits, const Scratch& sc, bf16* dq, bf16* dk, bf16* dv_out,
             unsigned int* fault, int n,
             int lq, int lkv, float scale, int t_kper, int q_per, int dq_kper, const Drop& drop,
             cudaStream_t st) {
  constexpr int DV = 128 * NP;
  const int lds = (lkv + KV_KEYS - 1) / KV_KEYS * KV_KEYS;
  const int t_ranges = ((lkv + T_KEYS - 1) / T_KEYS + t_kper - 1) / t_kper;
  const int qsplit = ((lq + KV_Q - 1) / KV_Q + q_per - 1) / q_per;
  const int ksplit = (lds / DQ_KEYS + dq_kper - 1) / dq_kper;
  const float c = scale * LOG2E;
  if (DROP && !bits) return (int)cudaErrorInvalidValue;
  CUtensorMap tq128, tq32, tk32, tk64, tv32, tv64, tdy128, tdy32, trows, tds, tkeep;
  int err = 0;
  const int maps[11] = {bf16_tensor_map(&tq128, q, D_K, lq, n, T_ROWS),
                        bf16_tensor_map(&tq32, q, D_K, lq, n, KV_Q),
                        bf16_tensor_map(&tk32, k, D_K, lkv, n, T_KEYS),
                        bf16_tensor_map(&tk64, k, D_K, lkv, n, KV_KEYS),
                        bf16_tensor_map(&tv32, v, DV, lkv, n, T_KEYS),
                        bf16_tensor_map(&tv64, v, DV, lkv, n, KV_KEYS),
                        bf16_tensor_map(&tdy128, dy, DV, lq, n, T_ROWS),
                        bf16_tensor_map(&tdy32, dy, DV, lq, n, KV_Q),
                        f32_tensor_map(&trows, sc.rows, 4, lq, n, 4, KV_Q),
                        bf16_tensor_map(&tds, sc.ds, lds, lq, n, 64),
                        DROP ? f32_tensor_map(&tkeep, bits, keep_words(lkv), lq, n, KEEP_BOX,
                                              KV_Q)
                             : f32_tensor_map(&tkeep, sc.rows, 4, lq, n, 4, KV_Q)};
  for (int i = 0; i < 11; ++i)
    if (maps[i] != 0) return report("tensor map", i, maps[i]);
  constexpr auto t_kernel = rowt_wgmma<NP, DROP>;
  constexpr auto kv_kernel = dkdv_wgmma<NP, DROP>;
  const size_t t_smem = ring_smem(T_STAGES, t_stage<NP>(), t_head<NP>());
  const size_t kv_smem = ring_smem(KV_STAGES, kv_stage<NP>(), kv_head<NP>());
  const size_t dq_smem = ring_smem(DQ_STAGES, DQ_STAGE, 0);
  if ((err = allow_smem<t_kernel>(t_smem)) != 0) return report("t pass smem", 0, err);
  if ((err = allow_smem<kv_kernel>(kv_smem)) != 0) return report("dk/dv pass smem", 0, err);
  if ((err = allow_smem<dq_wgmma>(dq_smem)) != 0) return report("dq pass smem", 0, err);
  t_kernel<<<dim3((lq + T_ROWS - 1) / T_ROWS, t_ranges, n), 384, t_smem, st>>>(
      tq128, tk32, tv32, tdy128, stats, bits, sc.t_part, fault, lq, lkv, c, t_kper, drop);
  if ((err = (int)cudaGetLastError()) != 0) return report("t pass", 0, err);
  const int count = n * lq;
  row_terms<<<(count + 255) / 256, 256, 0, st>>>(stats, sc.t_part,
                                                 reinterpret_cast<float4*>(sc.rows), count,
                                                 t_ranges);
  if ((err = (int)cudaGetLastError()) != 0) return report("row terms", 0, err);
  kv_kernel<<<dim3(lds / KV_KEYS, qsplit, n), 384, kv_smem, st>>>(
      tq32, tk64, tv64, tdy32, trows, tkeep, sc.ds, sc.dk_part, sc.dv_part, fault, lq, lkv, lds, c,
      q_per, drop);
  if ((err = (int)cudaGetLastError()) != 0) return report("dk/dv pass", 0, err);
  dq_wgmma<<<dim3((lq + 63) / 64, ksplit, n), 256, dq_smem, st>>>(tds, tk64, sc.dq_part, fault,
                                                                 lq, lds, dq_kper);
  if ((err = (int)cudaGetLastError()) != 0) return report("dq pass", 0, err);
  SumJobs jobs{};
  jobs.job[0] = SumJob{reinterpret_cast<const float4*>(sc.dq_part), reinterpret_cast<uint2*>(dq),
                       ksplit, (size_t)count * D_K / 4, scale};
  jobs.job[1] = SumJob{reinterpret_cast<const float4*>(sc.dk_part), reinterpret_cast<uint2*>(dk),
                       2 * qsplit, (size_t)n * lkv * D_K / 4, scale};
  jobs.job[2] = SumJob{reinterpret_cast<const float4*>(sc.dv_part),
                       reinterpret_cast<uint2*>(dv_out), qsplit, (size_t)n * lkv * DV / 4, 1.f};
  if ((err = launch_sums<1>(jobs, 3, st)) != 0) return report("sums", 0, err);
  return 0;
}

template <bool DROP>
int backward_dv(int dv, const bf16* q, const bf16* k, const bf16* v, const bf16* dy,
                const float* stats, const uint32_t* bits, const Scratch& sc, bf16* dq, bf16* dk,
                bf16* dv_out,
                unsigned int* fault, int n, int lq, int lkv, float scale, int t_kper, int q_per,
                int dq_kper, const Drop& drop, cudaStream_t st) {
  if (t_kper < 1 || q_per < 1 || dq_kper < 1) return (int)cudaErrorInvalidValue;
#define TDNET_BWD16(NP)                                                                       \
  backward<NP, DROP>(q, k, v, dy, stats, bits, sc, dq, dk, dv_out, fault, n, lq, lkv, scale,     \
                     t_kper, q_per, dq_kper, drop, st)
  switch (dv) {
    case 128: return TDNET_BWD16(1);
    case 256: return TDNET_BWD16(2);
    case 384: return TDNET_BWD16(3);
    case 512: return TDNET_BWD16(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDNET_BWD16
}

}  // namespace k2

}  // namespace

extern "C" {

// q [n, lq, 64], k [n, lkv, 64], v [n, lkv, dv], out o [n, lq, dv]; stats [2, n, lq] f32
// (row max, row sum; kept for the backward). drop_threshold 0: no dropout. The PV pass takes
// column blocks of `cols` (128, 256 or 512, dividing dv). All f32, contiguous, 16-byte
// aligned. Returns the first CUDA error, 0 if there is none.
int tdnet_attention_train_fwd(const void* q, const void* k, const void* v, void* o, void* stats,
                              int n, int lq, int lkv, int dv, float scale, int cols,
                              unsigned int seed, unsigned int drop_threshold, float inv_keep,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* row_max = (float*)stats;
  float* row_sum = row_max + (size_t)n * lq;
  const Drop drop{seed, drop_threshold, inv_keep};
  auto run = drop_threshold ? forward<true> : forward<false>;
  return run((const float*)q, (const float*)k, (const float*)v, (float*)o, row_max, row_sum, n,
             lq, lkv, dv, scale, cols, drop, st);
}


// The backward of the call above, given its o and stats and the upstream dy [n, lq, dv],
// dv in {128, 256, 384, 512}. Scratch: dsum [n, lq], ds [n, lq, lds] with lds = lkv rounded
// up to 32, dq_part [ksplit, n, lq, 64], dk_part [qsplit, n, lkv, 64], dv_part [qsplit, n,
// lkv, dv], where qsplit = ceil(ceil(lq / 64) / q_per) and ksplit = ceil((lds / 32) / k_per)
// (q_per 64-row q chunks, k_per 32-key steps a split). Outputs dq [n, lq, 64], dk [n, lkv,
// 64], dv [n, lkv, dv].
int tdnet_attention_train_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dy, const void* stats, void* dsum, void* ds, void* dq,
                              void* dk, void* dv_out, void* dq_part, void* dk_part,
                              void* dv_part, int n, int lq, int lkv, int dv, float scale,
                              int q_per, int k_per, unsigned int seed,
                              unsigned int drop_threshold, float inv_keep, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* row_max = (const float*)stats;
  const float* row_sum = row_max + (size_t)n * lq;
  const Drop drop{seed, drop_threshold, inv_keep};
  auto run = drop_threshold ? backward_dv<true> : backward_dv<false>;
  return run(dv, (const float*)q, (const float*)k, (const float*)v, (const float*)o,
             (const float*)dy, row_max, row_sum, (float*)dsum, (float*)ds, (float*)dq,
             (float*)dk, (float*)dv_out, (float*)dq_part, (float*)dk_part, (float*)dv_part, n, lq,
             lkv, scale, q_per, k_per, drop, st);
}

// bf16: q [n, lq, 64], k [n, lkv, 64], v [n, lkv, dv], out o [n, lq, dv], bf16; stats [2, n,
// lq] f32 (the merged row max and sum in log2 units, K1's; kept for the backward); with
// dropout, bits [n, lq, keep_words(lkv)] uint32 out (the keep bits, kept for the backward); the
// error word `fault`. The p v kernel takes `cols` columns (128 or 256, dividing dv) and `keys` keys
// a chunk (64 or 128) in `stages` ring stages; the keys split into ranges of stat_kper
// 128-key chunks (stats) and pv_kper `keys`-key chunks (p v), with more than one range into
// stats_part [2, stat ranges, n, lq] and o_part [pv ranges, n, lq, dv] f32 scratch
// (kernels/grid.py:train_forward_plan).
int tdnet_attention_train_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   void* o_part, void* stats, void* stats_part, void* bits,
                                   void* fault,
                                   int n, int lq, int lkv, int dv, float scale, int cols,
                                   int keys, int stages, int stat_kper, int pv_kper,
                                   unsigned int seed, unsigned int drop_threshold,
                                   float inv_keep, void* stream) {
  const Drop drop{seed, drop_threshold, inv_keep};
  auto run = drop_threshold ? k2::forward<true> : k2::forward<false>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)o_part,
             (float*)stats, (float*)stats_part, (uint32_t*)bits, (unsigned int*)fault, n, lq, lkv,
             dv, scale,
             cols, keys, stages, stat_kper, pv_kper, drop, (cudaStream_t)stream);
}

// The backward of the bf16 call above, given its stats and bits and the upstream dy [n, lq, dv]
// (bf16),
// dv in {128, 256, 384, 512}: dq, dk, dv bf16 out. Scratch (k2::Scratch; sizes from
// kernels/propagation_attention_train.py:backward_plan): rows, t_part, ds, dq_part, dk_part,
// dv_part; the t pass takes key ranges of t_kper 32-key chunks, the dk/dv pass q ranges of
// q_per 32-row chunks, the dq pass key ranges of dq_kper 64-key chunks.
int tdnet_attention_train_bwd_bf16(const void* q, const void* k, const void* v, const void* dy,
                                   const void* stats, const void* bits, void* rows, void* t_part,
                                   void* ds,
                                   void* dq_part, void* dk_part, void* dv_part, void* dq,
                                   void* dk, void* dv_out, void* fault, int n, int lq, int lkv,
                                   int dv, float scale, int t_kper, int q_per, int dq_kper,
                                   unsigned int seed, unsigned int drop_threshold,
                                   float inv_keep, void* stream) {
  const Drop drop{seed, drop_threshold, inv_keep};
  const k2::Scratch sc{(float*)rows, (float*)t_part, (bf16*)ds, (float*)dq_part,
                       (float*)dk_part, (float*)dv_part};
  auto run = drop_threshold ? k2::backward_dv<true> : k2::backward_dv<false>;
  return run(dv, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dy,
             (const float*)stats, (const uint32_t*)bits, sc, (bf16*)dq, (bf16*)dk, (bf16*)dv_out,
             (unsigned int*)fault,
             n, lq, lkv, scale, t_kper, q_per, dq_kper, drop, (cudaStream_t)stream);
}

// Registers a thread at launch and local memory a thread (bytes: spills) of the bf16 kernels
// at d_v 512, with (drop 1) or without the mask: out[2 i], out[2 i + 1] for the stats kernel,
// the p v kernel of 128 and of 256 columns, and the t, dk/dv and dq passes (i = 0 .. 5).
int tdnet_attention_train_bf16_attributes(int drop, int* out) {
  using namespace k2;
  const void* with[6] = {(const void*)attn_bf16<1, 128, STATS_KEYS, true, false>,
                         (const void*)attn_bf16<1, 128, 64, false, true>,
                         (const void*)attn_bf16<1, 256, 64, false, true>,
                         (const void*)rowt_wgmma<4, true>, (const void*)dkdv_wgmma<4, true>,
                         (const void*)dq_wgmma};
  const void* without[6] = {with[0], (const void*)attn_bf16<1, 128, 64, false, false>,
                            (const void*)attn_bf16<1, 256, 64, false, false>,
                            (const void*)rowt_wgmma<4, false>, (const void*)dkdv_wgmma<4, false>,
                            with[5]};
  for (int i = 0; i < 6; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, drop ? with[i] : without[i]);
    if (err != cudaSuccess) return (int)err;
    out[2 * i] = a.numRegs;
    out[2 * i + 1] = (int)a.localSizeBytes;
  }
  return 0;
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
