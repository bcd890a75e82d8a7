// Training propagation attention for Hopper (sm_90a), f32:
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

#include "attention_f32.cuh"
#include "tf32x3.cuh"

namespace {

struct Drop {
  uint32_t seed, threshold;
  float inv_keep;
};

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


// ---- bf16 (mixed-precision training): the TPU kernels' rounding points, on mma.sync
// m16n8k16 bf16 with f32 accumulation, one product where 3xTF32 takes three.
//   forward  s = q k^T (bf16 operands, f32 sums) * scale; p = exp(s - m) / l in f32; the mask
//            and 1 / (1 - rate) in f32 on p; pd rounded to bf16; o = pd v in f32, rounded once
//            to bf16 (_fwd_kernel, propagation_attention_train.py:71-80).
//   backward dv = pd^T dy with pd rounded to bf16; dpd = dy v^T in f32; ds = p (dp - t) rounded
//            to bf16, t = sum_j dp p in f32 as the TPU kernel forms it (rowt_bf16); dq = scale
//            ds k rounded to bf16; dk = scale ds^T q and dv summed in f32 over every q range and
//            rounded to bf16 once (_bwd_kernel, :83-112, :202-207).
// Every s, in the stats, p v and backward passes alike, is the same 4 k16 steps in order
// from a zero accumulator, then the scale: p is the same to the bit in all three.
// Tiles live in shared memory as bf16 rows padded by 16 bytes (row strides 144, 1040 and 80
// bytes), so ldmatrix's eight 16-byte rows fall in distinct banks.
namespace k2bf16 {

using bf16 = __nv_bfloat16;
constexpr int HS = DK + 8;      // row stride (elements) of 64-wide tiles: q, k
constexpr int FKEYS = 64;       // keys a chunk of stats_bf16
constexpr int PKEYS = 32;       // keys a chunk of pv_bf16, and of a dkdv_bf16 / dq_bf16 block
constexpr int PS = PKEYS + 8;   // row stride of 32-wide tiles: pd, ds
constexpr int WARPS4 = 128;     // threads of the 4-warp kernels

__device__ __forceinline__ uint32_t saddr_of(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr_of(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// Rows [r0, r0 + R) x columns [c0, c0 + W) of a row-major bf16 [len, ld] matrix into a shared
// tile of row stride S by 16-byte cp.async copies from `nthreads` threads; rows past len zero.
template <int R, int W, int S>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int ld, int r0, int c0,
                                           int len, int nthreads) {
  constexpr int PER_ROW = W / 8;
  for (int i = threadIdx.x; i < R * PER_ROW; i += nthreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8, gr = r0 + r;
    const bool valid = gr < len;
    cp16(dst + r * S + c, src + (valid ? (size_t)gr * ld + c0 + c : 0), valid);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr_of(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr_of(p)));
}

// c += a b, m16n8k16, bf16 operands, f32 accumulator. In a warp, g = lane / 4, t = lane % 4:
// A regs (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B regs (k 2t.., n g),
// (k 2t + 8.., n g); C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma16(float c[4], const uint32_t a[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix addresses of a lane (lane = threadIdx.x % 32) for one 16 x 16 operand:
// A rows [r0, + 16) x k [c0, + 16) of a tile stored [m][k]:
__device__ __forceinline__ const bf16* a_at(const bf16* t, int s, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return t + (r0 + (lane & 15)) * s + c0 + (lane >> 4) * 8;
}
// A from a tile stored [k][m] (ldsm4_t): k [k0, + 16) x m [m0, + 16):
__device__ __forceinline__ const bf16* a_at_t(const bf16* t, int s, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  return t + (k0 + (lane & 7) + (lane >> 4) * 8) * s + m0 + ((lane >> 3) & 1) * 8;
}
// B for two n-tiles [n0, + 8), [n0 + 8, + 8) and k [k0, + 16) of a tile stored [n][k]
// (ldsm4: regs 0, 1 the first n-tile, 2, 3 the second):
__device__ __forceinline__ const bf16* b_at(const bf16* t, int s, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * s + k0 + ((lane >> 3) & 1) * 8;
}
// the same from a tile stored [k][n] (ldsm4_t):
__device__ __forceinline__ const bf16* b_at_t(const bf16* t, int s, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * s + n0 + (lane >> 4) * 8;
}

// s[j] = q k^T for this warp's 16 q rows (A fragments qa, 4 k16 steps over d_k) and keys
// [key0 + 8 j, + 8) of the k tile kt ([key][d_k], stride HS), unscaled: the one product
// order of every pass.
template <int NT>
__device__ __forceinline__ void scores(float s[NT][4], const uint32_t qa[4][4], const bf16* kt,
                                       int key0) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, b_at(kt, HS, key0 + 8 * j, 16 * kk));
      mma16(s[j], qa[kk], b[0], b[1]);
      mma16(s[j + 1], qa[kk], b[2], b[3]);
    }
}

__device__ __forceinline__ void load_q_frags(uint32_t qa[4][4], const bf16* qt, int r0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm4(qa[kk], a_at(qt, HS, r0, 16 * kk));
}

// The probability of element (row, key) from its unscaled score: exp(s scale - m) / l, 0
// past lkv.
__device__ __forceinline__ float prob(float s, float scale, float m, float l, int key, int lkv) {
  return key < lkv ? expf(s * scale - m) / l : 0.f;
}

// Row statistics of rows [64 blockIdx.x, + 64) of batch blockIdx.y: m = max_j s_ij scale and
// l = sum_j exp(s_ij scale - m). Warp w owns rows 16 w..; 64-key chunks, double-buffered.
__global__ void __launch_bounds__(WARPS4)
stats_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, float* __restrict__ row_max,
           float* __restrict__ row_sum, int lq, int lkv, float scale) {
  __shared__ __align__(16) bf16 qs[64 * HS];
  __shared__ __align__(16) bf16 ks[2][FKEYS * HS];
  const int r0 = blockIdx.x * 64, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunks = (lkv + FKEYS - 1) / FKEYS;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  stage_bf16<64, DK, HS>(qs, q, DK, r0, 0, lq, WARPS4);
  stage_bf16<FKEYS, DK, HS>(ks[0], k, DK, 0, 0, lkv, WARPS4);
  cp_commit();
  uint32_t qa[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < chunks; ++c) {
    cp_wait_all();
    __syncthreads();
    if (c == 0) load_q_frags(qa, qs, 16 * warp);
    if (c + 1 < chunks) {
      stage_bf16<FKEYS, DK, HS>(ks[(c + 1) & 1], k, DK, (c + 1) * FKEYS, 0, lkv, WARPS4);
      cp_commit();
    }
    float s[FKEYS / 8][4];
    scores<FKEYS / 8>(s, qa, ks[c & 1], 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < FKEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c * FKEYS + 8 * j + 2 * t + e;
          const float x = key < lkv ? s[j][2 * h + e] * scale : -INFINITY;
          s[j][2 * h + e] = x;
          mc = fmaxf(mc, x);
        }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      float lc = 0.f;
      if (mc != -INFINITY)
#pragma unroll
        for (int j = 0; j < FKEYS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) lc += expf(s[j][2 * h + e] - mc);
      lc += __shfl_xor_sync(0xffffffffu, lc, 1);
      lc += __shfl_xor_sync(0xffffffffu, lc, 2);
      merge_stats(m[h], l[h], mc, lc);
    }
  }
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * warp + g + 8 * h;
      if (r < lq) {
        row_max[(size_t)b * lq + r] = m[h];
        row_sum[(size_t)b * lq + r] = l[h];
      }
    }
}

template <int NT>  // columns a block: 8 NT
constexpr size_t pv_smem() {
  return sizeof(bf16) * (64 * HS + 2 * PKEYS * HS + 2 * PKEYS * (8 * NT + 8));
}

// o[b, r, c0..c0 + 8 NT) = bf16(sum_j bf16(pd_rj) v[b, j, c0..]) for rows [64 blockIdx.x, + 64),
// c0 = 8 NT blockIdx.y, batch blockIdx.z; pd from the row statistics and, with DROP, the mask
// of (seed, (b lq + r) lkv + j). Warp w owns rows 16 w.. and all 8 NT columns; 32-key chunks of
// k and v double-buffered; p goes from the score accumulators straight into p v's A fragments.
template <int NT, bool DROP>
__global__ void __launch_bounds__(WARPS4, 2)
pv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const float* __restrict__ row_max, const float* __restrict__ row_sum,
        bf16* __restrict__ o, int lq, int lkv, int dv, float scale, Drop drop) {
  constexpr int CW = 8 * NT, VS = CW + 8;
  extern __shared__ __align__(16) bf16 smem_pv[];
  bf16* qs = smem_pv;                  // [64][HS]
  bf16* ks = qs + 64 * HS;             // [2][PKEYS][HS]
  bf16* vs = ks + 2 * PKEYS * HS;      // [2][PKEYS][VS]
  const int r0 = blockIdx.x * 64, c0 = blockIdx.y * CW, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunks = (lkv + PKEYS - 1) / PKEYS;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * dv;
  auto stage_kv = [&](int c, int buf) {
    stage_bf16<PKEYS, DK, HS>(ks + buf * PKEYS * HS, k, DK, c * PKEYS, 0, lkv, WARPS4);
    stage_bf16<PKEYS, CW, VS>(vs + buf * PKEYS * VS, v, dv, c * PKEYS, c0, lkv, WARPS4);
  };
  stage_bf16<64, DK, HS>(qs, q, DK, r0, 0, lq, WARPS4);
  stage_kv(0, 0);
  cp_commit();
  float mr[2], lr[2];
  size_t rid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    mr[h] = r < lq ? row_max[(size_t)b * lq + r] : 0.f;
    lr[h] = r < lq ? row_sum[(size_t)b * lq + r] : 1.f;
    rid[h] = ((size_t)b * lq + r) * (size_t)lkv;
  }
  uint32_t qa[4][4];
  float acc[NT][4] = {};
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    cp_wait_all();
    __syncthreads();
    if (c == 0) load_q_frags(qa, qs, 16 * warp);
    if (c + 1 < chunks) {
      stage_kv(c + 1, buf ^ 1);
      cp_commit();
    }
    float s[PKEYS / 8][4];
    scores<PKEYS / 8>(s, qa, ks + buf * PKEYS * HS, 0);
#pragma unroll
    for (int j = 0; j < PKEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = c * PKEYS + 8 * j + 2 * t + (e & 1);
        float p = prob(s[j][e], scale, mr[h], lr[h], key, lkv);
        if (DROP)
          p = tdnet_keep(drop.seed, rid[h] + key, drop.threshold) ? p * drop.inv_keep : 0.f;
        s[j][e] = p;
      }
    const bf16* vt = vs + buf * PKEYS * VS;
#pragma unroll
    for (int kk = 0; kk < PKEYS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, b_at_t(vt, VS, 16 * kk, 8 * j));
        mma16(acc[j], pa, bb[0], bb[1]);
        mma16(acc[j + 1], pa, bb[2], bb[3]);
      }
    }
  }
  o += (size_t)b * lq * dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(o + (size_t)r * dv + c0 + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

template <int NT, bool DROP>
int launch_pv(const bf16* q, const bf16* k, const bf16* v, const float* row_max,
              const float* row_sum, bf16* o, int n, int lq, int lkv, int dv, float scale,
              Drop drop, cudaStream_t st) {
  constexpr size_t smem = pv_smem<NT>();
  cudaError_t err = cudaFuncSetAttribute(pv_bf16<NT, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pv_bf16<NT, DROP><<<dim3((lq + 63) / 64, dv / (8 * NT), n), WARPS4, smem, st>>>(
      q, k, v, row_max, row_sum, o, lq, lkv, dv, scale, drop);
  return (int)cudaGetLastError();
}

template <bool DROP>
int forward(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* row_max, float* row_sum,
            int n, int lq, int lkv, int dv, float scale, int cols, Drop drop, cudaStream_t st) {
  if ((cols != 128 && cols != 256) || dv % cols) return (int)cudaErrorInvalidValue;
  stats_bf16<<<dim3((lq + 63) / 64, n), WARPS4, 0, st>>>(q, k, row_max, row_sum, lq, lkv,
                                                         scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return cols == 256
             ? launch_pv<32, DROP>(q, k, v, row_max, row_sum, o, n, lq, lkv, dv, scale, drop, st)
             : launch_pv<16, DROP>(q, k, v, row_max, row_sum, o, n, lq, lkv, dv, scale, drop, st);
}

template <int NP>  // d_v = 128 NP
constexpr size_t rowt_smem() {
  return sizeof(bf16) *
         (64 * HS + 64 * (128 * NP + 8) + 2 * PKEYS * HS + 2 * PKEYS * (128 * NP + 8));
}

// t[b, r] = sum_j dp_rj p_rj with dp = dy_r . v_j (f32 sums of bf16 products), through the
// mask and 1 / (1 - rate) with DROP: the TPU kernel's softmax-backward term (:109), for rows
// [64 blockIdx.x, + 64) of batch blockIdx.y. The block's q and dy rows stay in shared memory;
// 32-key chunks of k and v double-buffered; warp w owns rows 16 w... It costs a forward's
// products again (s and dy v^T), where rowsum(dy o) would cost one pass over dy and o: with
// o rounded to bf16 that sum misses t by o's rounding, so sum_j ds_rj, zero in exact arithmetic
// (the gradient of a bias shared by all keys), took a bias on every row.
template <int NP, bool DROP>
__global__ void __launch_bounds__(WARPS4, 1)
rowt_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dy, const float* __restrict__ row_max,
          const float* __restrict__ row_sum, float* __restrict__ t_out, int lq, int lkv,
          float scale, Drop drop) {
  constexpr int DV = 128 * NP, VS = DV + 8;
  extern __shared__ __align__(16) bf16 smem_t[];
  bf16* qs = smem_t;                 // [64][HS]
  bf16* ys = qs + 64 * HS;           // [64][VS]
  bf16* ks = ys + 64 * VS;           // [2][PKEYS][HS]
  bf16* vs = ks + 2 * PKEYS * HS;    // [2][PKEYS][VS]
  const int r0 = blockIdx.x * 64, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunks = (lkv + PKEYS - 1) / PKEYS;
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * DV;
  dy += (size_t)b * lq * DV;
  auto stage_kv = [&](int c, int buf) {
    stage_bf16<PKEYS, DK, HS>(ks + buf * PKEYS * HS, k, DK, c * PKEYS, 0, lkv, WARPS4);
    stage_bf16<PKEYS, DV, VS>(vs + buf * PKEYS * VS, v, DV, c * PKEYS, 0, lkv, WARPS4);
  };
  stage_bf16<64, DK, HS>(qs, q, DK, r0, 0, lq, WARPS4);
  stage_bf16<64, DV, VS>(ys, dy, DV, r0, 0, lq, WARPS4);
  stage_kv(0, 0);
  cp_commit();
  float mr[2], lr[2], acc[2] = {0.f, 0.f};
  size_t rid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    mr[h] = r < lq ? row_max[(size_t)b * lq + r] : 0.f;
    lr[h] = r < lq ? row_sum[(size_t)b * lq + r] : 1.f;
    rid[h] = ((size_t)b * lq + r) * (size_t)lkv;
  }
  uint32_t qa[4][4];
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    cp_wait_all();
    __syncthreads();
    if (c == 0) load_q_frags(qa, qs, 16 * warp);
    if (c + 1 < chunks) {
      stage_kv(c + 1, buf ^ 1);
      cp_commit();
    }
    float s[PKEYS / 8][4];
    scores<PKEYS / 8>(s, qa, ks + buf * PKEYS * HS, 0);
    const bf16* vt = vs + buf * PKEYS * VS;
    float dp[PKEYS / 8][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t ya[4];
      ldsm4(ya, a_at(ys, VS, 16 * warp, 16 * kk));
#pragma unroll
      for (int j = 0; j < PKEYS / 8; j += 2) {
        uint32_t bb[4];
        ldsm4(bb, b_at(vt, VS, 8 * j, 16 * kk));
        mma16(dp[j], ya, bb[0], bb[1]);
        mma16(dp[j + 1], ya, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < PKEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = c * PKEYS + 8 * j + 2 * t + (e & 1);
        const float p = prob(s[j][e], scale, mr[h], lr[h], key, lkv);
        float d = dp[j][e];
        if (DROP) d = tdnet_keep(drop.seed, rid[h] + key, drop.threshold) ? d * drop.inv_keep : 0.f;
        acc[h] = fmaf(d, p, acc[h]);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 1);
    acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], 2);
    const int r = r0 + 16 * warp + g + 8 * h;
    if (t == 0 && r < lq) t_out[(size_t)b * lq + r] = acc[h];
  }
}

template <int NP>  // d_v = 128 NP
constexpr size_t kv_smem() {
  return sizeof(bf16) * (PKEYS * HS + PKEYS * (128 * NP + 8) + 2 * 64 * HS +
                         2 * 64 * (128 * NP + 8) + 2 * 64 * PS);
}

// Keys [32 blockIdx.x, + 32) of batch blockIdx.z over the 64-row q chunks of range blockIdx.y:
//   dv_part[range, b, key, :] = sum_r bf16(pd_rk) dy_r,  dk_part[range, b, key, :] =
//   scale sum_r ds_rk q_r (f32), and ds[b, r, key] = bf16(p (dp - t)) for every r of the range
// (0 for keys past lkv). k and v stay in shared memory; each chunk's q and dy are staged by
// cp.async, the next chunk's during this one. Per chunk, warp w forms s, dpd (K = d_v), p, pd and
// ds for rows 16 (w % 4) x keys 16 (w / 4) and stores pd and ds by row; then dv += pd^T dy for
// keys 16 (w % 2) x columns 32 NP (w / 2) (dv in registers, 16 NP a thread) and dk += ds^T q
// for keys 16 (w % 2) x columns 16 (w / 2).
template <int NP, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dy, const float* __restrict__ row_max,
          const float* __restrict__ row_sum, const float* __restrict__ dsum,
          bf16* __restrict__ ds, float* __restrict__ dk_part, float* __restrict__ dv_part, int n,
          int lq, int lkv, int lds, float scale, int q_per, Drop drop) {
  constexpr int DV = 128 * NP, VS = DV + 8, NTV = 4 * NP;
  extern __shared__ __align__(16) bf16 smem_kv[];
  bf16* ks = smem_kv;                  // [32][HS]
  bf16* vs = ks + PKEYS * HS;          // [32][VS]
  bf16* qs = vs + PKEYS * VS;          // [2][64][HS]
  bf16* ys = qs + 2 * 64 * HS;         // [2][64][VS]
  bf16* pds = ys + 2 * 64 * VS;        // [64][PS]: pd by q row
  bf16* dss = pds + 64 * PS;           // [64][PS]: ds by q row
  const int key0 = blockIdx.x * PKEYS, range = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int am = 16 * (warp & 3), an = 16 * (warp >> 2);
  const int bm = 16 * (warp & 1), bn = 32 * NP * (warp >> 1), cn = 16 * (warp >> 1);
  const int c_begin = range * q_per, c_end = min((lq + 63) / 64, c_begin + q_per);
  q += (size_t)b * lq * DK;
  k += (size_t)b * lkv * DK;
  v += (size_t)b * lkv * DV;
  dy += (size_t)b * lq * DV;
  ds += (size_t)b * lq * lds;
  auto stage_q = [&](int c, int buf) {
    stage_bf16<64, DK, HS>(qs + buf * 64 * HS, q, DK, 64 * c, 0, lq, THREADS);
    stage_bf16<64, DV, VS>(ys + buf * 64 * VS, dy, DV, 64 * c, 0, lq, THREADS);
  };
  stage_bf16<PKEYS, DK, HS>(ks, k, DK, key0, 0, lkv, THREADS);
  stage_bf16<PKEYS, DV, VS>(vs, v, DV, key0, 0, lkv, THREADS);
  stage_q(c_begin, 0);
  cp_commit();
  float dva[NTV][4] = {}, dka[2][4] = {};
  for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
    const int buf = it & 1;
    cp_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's pd, ds and buffers are free
    if (c + 1 < c_end) {
      stage_q(c + 1, buf ^ 1);
      cp_commit();
    }
    const bf16* qt = qs + buf * 64 * HS;
    const bf16* yt = ys + buf * 64 * VS;
    uint32_t qa[4][4];
    load_q_frags(qa, qt, am);
    float s[2][4];
    scores<2>(s, qa, ks, an);
    float dp[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < DV / 16; ++kk) {
      uint32_t ya[4], bb[4];
      ldsm4(ya, a_at(yt, VS, am, 16 * kk));
      ldsm4(bb, b_at(vs, VS, an, 16 * kk));
      mma16(dp[0], ya, bb[0], bb[1]);
      mma16(dp[1], ya, bb[2], bb[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = am + g + 8 * h, r = 64 * c + rl;
      const bool row_ok = r < lq;
      const float m = row_ok ? row_max[(size_t)b * lq + r] : 0.f;
      const float l = row_ok ? row_sum[(size_t)b * lq + r] : 1.f;
      const float dd = row_ok ? dsum[(size_t)b * lq + r] : 0.f;
      const size_t rid = ((size_t)b * lq + r) * (size_t)lkv;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float pdv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + an + 8 * j + 2 * t + e;
          const float p = row_ok ? prob(s[j][2 * h + e], scale, m, l, key, lkv) : 0.f;
          float pd = p, dpv = dp[j][2 * h + e];
          if (DROP) {
            const bool keep = tdnet_keep(drop.seed, rid + key, drop.threshold);
            pd = keep ? p * drop.inv_keep : 0.f;
            dpv = keep ? dpv * drop.inv_keep : 0.f;
          }
          pdv[e] = pd;
          dsv[e] = p * (dpv - dd);
        }
        const int col = an + 8 * j + 2 * t;
        const uint32_t dsw = pack_bf16(dsv[0], dsv[1]);
        *reinterpret_cast<uint32_t*>(pds + rl * PS + col) = pack_bf16(pdv[0], pdv[1]);
        *reinterpret_cast<uint32_t*>(dss + rl * PS + col) = dsw;
        if (row_ok) *reinterpret_cast<uint32_t*>(ds + (size_t)r * lds + key0 + col) = dsw;
      }
    }
    __syncthreads();  // pd and ds stored
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], da[4], bq[4];
      ldsm4_t(pa, a_at_t(pds, PS, 16 * kk, bm));
#pragma unroll
      for (int j = 0; j < NTV; j += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, b_at_t(yt, VS, 16 * kk, bn + 8 * j));
        mma16(dva[j], pa, bb[0], bb[1]);
        mma16(dva[j + 1], pa, bb[2], bb[3]);
      }
      ldsm4_t(da, a_at_t(dss, PS, 16 * kk, bm));
      ldsm4_t(bq, b_at_t(qt, HS, 16 * kk, cn));
      mma16(dka[0], da, bq[0], bq[1]);
      mma16(dka[1], da, bq[2], bq[3]);
    }
  }
  float* dvo = dv_part + ((size_t)range * n + b) * lkv * DV;
  float* dko = dk_part + ((size_t)range * n + b) * lkv * DK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + bm + g + 8 * h;
    if (key >= lkv) continue;
#pragma unroll
    for (int j = 0; j < NTV; ++j)
      *reinterpret_cast<float2*>(dvo + (size_t)key * DV + bn + 8 * j + 2 * t) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float2*>(dko + (size_t)key * DK + cn + 8 * j + 2 * t) =
          make_float2(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
  }
}

// dq[b, r, :] = bf16(scale sum_j ds[b, r, j] k[b, j, :]) for rows [64 blockIdx.x, + 64) of
// batch blockIdx.y over every 32-key step, double-buffered; warp w owns rows 16 w.., all 64
// columns.
__global__ void __launch_bounds__(WARPS4)
dq_bf16(const bf16* __restrict__ ds, const bf16* __restrict__ k, bf16* __restrict__ dq, int lq,
        int lkv, int lds, float scale) {
  __shared__ __align__(16) bf16 as[2][64 * PS];
  __shared__ __align__(16) bf16 bs[2][PKEYS * HS];
  const int r0 = blockIdx.x * 64, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int steps = lds / PKEYS;
  ds += (size_t)b * lq * lds;
  k += (size_t)b * lkv * DK;
  auto stage = [&](int st, int buf) {
    stage_bf16<64, PKEYS, PS>(as[buf], ds, lds, r0, st * PKEYS, lq, WARPS4);
    stage_bf16<PKEYS, DK, HS>(bs[buf], k, DK, st * PKEYS, 0, lkv, WARPS4);
  };
  stage(0, 0);
  cp_commit();
  float acc[8][4] = {};
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    cp_wait_all();
    __syncthreads();
    if (st + 1 < steps) {
      stage(st + 1, buf ^ 1);
      cp_commit();
    }
#pragma unroll
    for (int kk = 0; kk < PKEYS / 16; ++kk) {
      uint32_t a[4];
      ldsm4(a, a_at(as[buf], PS, 16 * warp, 16 * kk));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, b_at_t(bs[buf], HS, 16 * kk, 8 * j));
        mma16(acc[j], a, bb[0], bb[1]);
        mma16(acc[j + 1], a, bb[2], bb[3]);
      }
    }
  }
  dq += (size_t)b * lq * DK;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + (size_t)r * DK + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

// out[i] = bf16(sum_p parts[p * count + i]), summed in order p = 0, 1, ...; 4 a thread.
__global__ void __launch_bounds__(THREADS)
sum_parts_bf16(const float4* __restrict__ parts, uint2* __restrict__ out, int nparts,
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
    out[i] = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  }
}

int sum_into_bf16(const float* parts, bf16* out, int nparts, size_t count, cudaStream_t st) {
  if (count % 4) return (int)cudaErrorInvalidValue;
  const size_t count4 = count / 4, blocks = (count4 + THREADS - 1) / THREADS;
  sum_parts_bf16<<<(int)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(parts), reinterpret_cast<uint2*>(out), nparts, count4);
  return (int)cudaGetLastError();
}

template <int NP, bool DROP>
int backward(const bf16* q, const bf16* k, const bf16* v, const bf16* dy,
             const float* row_max, const float* row_sum, float* dsum, bf16* ds, bf16* dq,
             bf16* dk, bf16* dv_out, float* dk_part, float* dv_part, int n, int lq, int lkv,
             float scale, int q_per, Drop drop, cudaStream_t st) {
  constexpr int DV = 128 * NP;
  constexpr size_t t_smem = rowt_smem<NP>();
  cudaError_t err = cudaFuncSetAttribute(rowt_bf16<NP, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t_smem);
  if (err != cudaSuccess) return (int)err;
  rowt_bf16<NP, DROP><<<dim3((lq + 63) / 64, n), WARPS4, t_smem, st>>>(
      q, k, v, dy, row_max, row_sum, dsum, lq, lkv, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int key_blocks = (lkv + PKEYS - 1) / PKEYS, lds = key_blocks * PKEYS;
  const int qsplit = ((lq + 63) / 64 + q_per - 1) / q_per;
  constexpr size_t smem = kv_smem<NP>();
  err = cudaFuncSetAttribute(dkdv_bf16<NP, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dkdv_bf16<NP, DROP><<<dim3(key_blocks, qsplit, n), THREADS, smem, st>>>(
      q, k, v, dy, row_max, row_sum, dsum, ds, dk_part, dv_part, n, lq, lkv, lds, scale, q_per,
      drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_bf16<<<dim3((lq + 63) / 64, n), WARPS4, 0, st>>>(ds, k, dq, lq, lkv, lds, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = (cudaError_t)sum_into_bf16(dk_part, dk, qsplit, (size_t)n * lkv * DK, st)) !=
      cudaSuccess)
    return (int)err;
  return sum_into_bf16(dv_part, dv_out, qsplit, (size_t)n * lkv * DV, st);
}

template <bool DROP>
int backward_dv(int dv, const bf16* q, const bf16* k, const bf16* v,
                const bf16* dy, const float* row_max, const float* row_sum, float* dsum,
                bf16* ds, bf16* dq, bf16* dk, bf16* dv_out, float* dk_part, float* dv_part,
                int n, int lq, int lkv, float scale, int q_per, Drop drop, cudaStream_t st) {
#define TDNET_BWD16(NP)                                                                       \
  backward<NP, DROP>(q, k, v, dy, row_max, row_sum, dsum, ds, dq, dk, dv_out, dk_part,        \
                     dv_part, n, lq, lkv, scale, q_per, drop, st)
  switch (dv) {
    case 128: return TDNET_BWD16(1);
    case 256: return TDNET_BWD16(2);
    case 384: return TDNET_BWD16(3);
    case 512: return TDNET_BWD16(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDNET_BWD16
}

}  // namespace k2bf16

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

// bf16: q, k, v, o bf16, stats f32 as above; the p v pass takes column blocks of `cols` (128
// or 256, dividing dv).
int tdnet_attention_train_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   void* stats, int n, int lq, int lkv, int dv, float scale,
                                   int cols, unsigned int seed, unsigned int drop_threshold,
                                   float inv_keep, void* stream) {
  using k2bf16::bf16;
  float* row_max = (float*)stats;
  const Drop drop{seed, drop_threshold, inv_keep};
  auto run = drop_threshold ? k2bf16::forward<true> : k2bf16::forward<false>;
  return run((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, row_max,
             row_max + (size_t)n * lq, n, lq, lkv, dv, scale, cols, drop, (cudaStream_t)stream);
}

// The backward of the bf16 call above (its o is not needed): q, k, v, dy and the outputs dq,
// dk, dv bf16; scratch
// dsum [n, lq] f32 (t), ds [n, lq, lds] bf16, dk_part [qsplit, n, lkv, 64] and dv_part [qsplit, n,
// lkv, dv] f32, with lds and qsplit as for the f32 backward.
int tdnet_attention_train_bwd_bf16(const void* q, const void* k, const void* v,
                                   const void* dy, const void* stats, void* dsum, void* ds,
                                   void* dq, void* dk, void* dv_out, void* dk_part,
                                   void* dv_part, int n, int lq, int lkv, int dv, float scale,
                                   int q_per, unsigned int seed, unsigned int drop_threshold,
                                   float inv_keep, void* stream) {
  using k2bf16::bf16;
  const float* row_max = (const float*)stats;
  const Drop drop{seed, drop_threshold, inv_keep};
  auto run = drop_threshold ? k2bf16::backward_dv<true> : k2bf16::backward_dv<false>;
  return run(dv, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dy, row_max,
             row_max + (size_t)n * lq, (float*)dsum, (bf16*)ds, (bf16*)dq, (bf16*)dk,
             (bf16*)dv_out, (float*)dk_part, (float*)dv_part, n, lq, lkv, scale, q_per, drop,
             (cudaStream_t)stream);
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
