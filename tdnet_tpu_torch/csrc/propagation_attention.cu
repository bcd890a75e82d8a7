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
// 512-wide f32 output row per q row is too much register state for one warpgroup. So:
//   1. stats: one pass over K chunks gives each q row its max m and its sum
//      l = sum exp(s - m) (the cheap d_k = 64 product only);
//   2. pv: each block owns q rows and a slice of the d_v columns, walks the K/V chunks,
//      recomputes the score tile, forms p = exp(s - m) / l (no rescaling: p is normalised
//      before it is rounded to the input type, as the reference rounds it), and
//      accumulates p v in f32;
//   3. fc: a tiled GEMM with bias over the [n * Lq, d_v] PV result, which is written
//      in the input type first, as the reference casts it.
// Ragged Lq and Lkv edges are masked inside the kernels; nothing is padded.
// f32 inputs (attention_f32.cuh, pv_tc and fc_tc below): s on the CUDA cores in f32 (the
// softmax's exponent and the training kernel's backward need its exact bits), p v and the
// fc on the tensor cores in 3xTF32 (mma.sync m16n8k8, each operand split into TF32 hi and
// lo; tf32x3.cuh), f32's accuracy, each 32-deep chunk of an 8-column tile one chain added
// in round-to-nearest f32; a block owns all 512 columns, so s is formed twice (stats and
// pv), and key ranges summed in order fill the card where q blocks alone do not.
// bf16 inputs (the streaming path; k1:: below): every product on wgmma (f32 accumulate),
// every tile brought in by TMA through a ring of stages that a producer warpgroup fills
// while the consumer warpgroups compute; s stays in registers and becomes p v's A operand
// in place; p = 2^(s c - m) (1 / l) with c = scale log2 e and m in the same units, one
// ex2.approx a score and one multiply by the row's 1 / l (no division, no slow path for the
// tiny p of a peaked softmax); the block shape, keys a chunk and stages come from
// kernels/grid.py:attention_bf16_plan.
// Blocks run in any order, so each carries nothing to the next: the sequential TPU
// grid becomes a loop over K/V chunks inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bf16.cuh"
#include "attention_f32.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// bf16 (hopper.cuh, attention_bf16.cuh): three kernels on wgmma (f32 accumulate), each fed
// by TMA copies through a ring of `stages` shared-memory stages on mbarriers (full: the copies
// landed; empty: the consumers are done with the stage), which one producer thread fills. A
// block is a producer warpgroup (0) and RW consumer warpgroups (1 ..); consumer warpgroup cg
// owns rows [64 cg, + 64) of the block's rows. setmaxnreg gives the producer's registers to
// the consumers: RW = 1 runs two blocks an SM with 232 registers a consumer thread, RW = 2
// one with 240. The producer's waits trap; a consumer's wait that gives up sets the error word
// `fault` and exits (bar_wait_or_flag in hopper.cuh), which the host reads where it
// synchronizes (kernels/fault.py:check_fault): no launch ends with a tile unwritten and no
// error. A build with -DTDNET_K1_STARVE (and few TDNET_CONSUMER_POLLS) has producers that
// fill nothing, for the check that the word is reported (chip_smoke.py phase 2).
// The stats and p v kernels (attn_bf16, attention_bf16.cuh) are shared with K2's bf16
// forward, which adds the mask and key ranges; K1 runs them without either, so its outputs
// keep PR 10's bits (chip_smoke.py:k1_bf16_digests):
//   attn_bf16<1, -, 128, true, false> (stats): per q row, m = max_j s_j c and l = sum_j
//       2^(s_j c - m) over all keys, s = q k^T, c = scale log2 e: the block's q tile (loaded
//       once) the A operand and a K chunk the B operand, both K-major; each chunk's score tile
//       is issued before the last one is folded, so the tensor cores overlap the CUDA cores;
//   attn_bf16<RW, CW, BK, false, false> (p v): o = p v over the block's CW columns of v, the
//       score tile formed again a chunk, p = 2^(s c - m) (1 / l) in registers and rounded to
//       bf16 in place as the A operand of p v (the accumulator layout of m64nBK is the A
//       layout of m64n16 a k step), v's chunk the B operand, N-major in 64-column slabs
//       (wgmma's transpose bit; no transposing copy);
//   fc_bf16<RW, CW>: y = o w + bias, o's 64-deep chunk the A operand (K-major) and w's the
//       B operand (N-major).
// Bound by arithmetic (0.100 ms at the TD2 hop, all three); the p v kernel does most of it:
// 72.8 GFLOP of p v, the score tile once per column block (9.1 GFLOP each; two blocks of
// 256 columns at TD2) and one ex2 a score and column block on the SFUs (16 a clock an SM),
// which the other block of the SM hides. Each output element is summed by one thread in a
// fixed order: two runs give the same bits.
// ---------------------------------------------------------------------------

namespace k1 {

using namespace attn;

constexpr int AUX_STAGES = 4;                 // ring stages of the stats and fc kernels
constexpr int STATS_KEYS = 128;               // keys a chunk of the stats kernel

template <int RW, int CW>
__host__ __device__ constexpr int fc_stage() {
  return (RW + CW / 64) * 64 * ROW;   // x's 64 RW rows, then w's CW / 64 slabs of 64 k rows
}

// Block (x, y): rows [64 RW x, + 64 RW) and columns [CW y, + CW) of y = x w + bias (bf16
// out, f32 sums); x [m, dv] through tm_x ([1][m][dv], boxes of 64 x 64 RW), w [dv, dv]
// ([in, out]) through tm_w ([1][dv][dv], boxes of 64 x 64); dv % 64 == 0.
template <int RW, int CW>
__global__ void __launch_bounds__(128 * (RW + 1), BLOCKS_PER_SM<RW>)
fc_bf16(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
        const bf16* __restrict__ bias, bf16* __restrict__ y, unsigned int* __restrict__ fault,
        int m, int dv, int stages) {
  constexpr int STAGE = fc_stage<RW, CW>(), A_BYTES = 64 * RW * ROW;
  extern __shared__ unsigned char smem_fc[];
  const Ring ring(smem_fc, stages, STAGE, 0);
  const int row0 = blockIdx.x * 64 * RW, col0 = blockIdx.y * CW, chunks = dv / 64;
  init_ring<RW>(ring, stages);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_K1_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x == 0)
      for (int ch = 0; ch < chunks; ++ch) {
        wait_free(ring, ch, stages);
        const int s = ch % stages;
        unsigned char* st = ring.base + s * STAGE;
        bar_expect(ring.full + s, STAGE);
        tma_load_3d(st, &tm_x, 64 * ch, row0, 0, ring.full + s);
#pragma unroll
        for (int j = 0; j < CW / 64; ++j)
          tma_load_3d(st + A_BYTES + j * 64 * ROW, &tm_w, col0 + 64 * j, 64 * ch, 0, ring.full + s);
      }
    return;
  }
  reg_alloc<CONSUMER_REGS<RW>>();
  const int cg = role - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[CW / 128][64];
#pragma unroll
  for (int hh = 0; hh < CW / 128; ++hh)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch % stages;
    bar_wait_or_flag(ring.full + s, (ch / stages) & 1, fault);
    const unsigned char* st = ring.base + s * STAGE;
    const uint64_t a = sw128_desc(st + cg * 64 * ROW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hh = 0; hh < CW / 128; ++hh)
        wgmma_ss_128<1>(acc[hh], a + 2 * kk,
                        sw128_n_desc(st + A_BYTES + 2 * hh * 64 * ROW + kk * 16 * ROW, 64 * ROW),
                        1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < CW / 128; ++hh) fence_regs<64>(acc[hh]);
    if (lane == 0) bar_arrive(ring.empty + s);
  }
  const int row = row0 + 64 * cg + 16 * warp + g;
#pragma unroll
  for (int hh = 0; hh < CW / 128; ++hh)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 128 * hh + 8 * j + 2 * t;
      const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + 8 * h < m)
          *reinterpret_cast<uint32_t*>(y + (size_t)(row + 8 * h) * dv + col) =
              pack_bf16(acc[hh][4 * j + 2 * h] + b0, acc[hh][4 * j + 2 * h + 1] + b1);
    }
}

template <int RW, int CW>
int launch_fc(const bf16* x, const bf16* w, const bf16* bias, bf16* y, unsigned int* fault,
              int m, int dv, cudaStream_t st) {
  CUtensorMap tx, tw;
  int e = bf16_tensor_map(&tx, x, dv, m, 1, 64 * RW);
  if (e != 0 || (e = bf16_tensor_map(&tw, w, dv, dv, 1, 64)) != 0) return e;
  constexpr int stage = fc_stage<RW, CW>();
  const int stages = ring_smem(AUX_STAGES, stage, 0) <= MAX_SMEM
                         ? AUX_STAGES
                         : (int)((MAX_SMEM - 1032) / (stage + 16));
  const size_t smem = ring_smem(stages, stage, 0);
  constexpr auto kernel = fc_bf16<RW, CW>;
  const int err = allow_smem<kernel>(smem);
  if (err != 0) return err;
  kernel<<<dim3((m + 64 * RW - 1) / (64 * RW), dv / CW), 128 * (RW + 1), smem, st>>>(
      tx, tw, bias, y, fault, m, dv, stages);
  return (int)cudaGetLastError();
}

}  // namespace k1

// The p v kernel's and the fc's tiling: rows a block (64 or 128: one or two consumer
// warpgroups), cols a consumer warpgroup (128 or 256), keys a chunk (p v) and the p v ring's
// stages, as kernels/grid.py:attention_bf16_plan picks them from the tile sweep (PERF.md).
int run_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* w, const bf16* bias,
             bf16* o_tmp, bf16* out, float* row_max, float* row_sum, unsigned int* fault, int n,
             int lq, int lkv, int dv, float scale, int rows, int cols, int keys, int stages,
             cudaStream_t st) {
  using namespace k1;
  const int tiling = rows == 64 && cols == 128 && keys == 64     ? 0
                     : rows == 64 && cols == 128 && keys == 128  ? 1
                     : rows == 64 && cols == 256 && keys == 64   ? 2
                     : rows == 128 && cols == 128 && keys == 64  ? 3
                     : rows == 128 && cols == 128 && keys == 128 ? 4
                     : rows == 128 && cols == 256 && keys == 64  ? 5
                                                                 : -1;
  if (tiling < 0 || dv % cols != 0) return (int)cudaErrorInvalidValue;
  // the stats pass always takes 64 rows and 128 keys a chunk (the tile sweep's fastest)
  CUtensorMap ts, tk, tv;
  int err = bf16_tensor_map(&ts, k, DK, lkv, n, STATS_KEYS);
  if (err != 0 || (err = bf16_tensor_map(&tk, k, DK, lkv, n, keys)) != 0 ||
      (err = bf16_tensor_map(&tv, v, dv, lkv, n, keys)) != 0)
    return err;
  const float c = scale * LOG2E;
  const AttnOut stats{row_max, row_sum, nullptr, nullptr, nullptr, fault};
  const Drop none{0u, 0u, 1.f};
  err = launch_attn<1, 128, STATS_KEYS, true, false>(q, ts, ts, stats, n, lq, lkv, dv, c,
                                                     AUX_STAGES, lkv, 1, none, st);
  if (err != 0) return err;
  const AttnOut pv{row_max, row_sum, w ? o_tmp : out, nullptr, nullptr, fault};
#define K1_PV(RW, CW, BK) \
  launch_attn<RW, CW, BK, false, false>(q, tk, tv, pv, n, lq, lkv, dv, c, stages, lkv, 1, none, \
                                        st)
  switch (tiling) {
    case 0: err = K1_PV(1, 128, 64); break;
    case 1: err = K1_PV(1, 128, 128); break;
    case 2: err = K1_PV(1, 256, 64); break;
    case 3: err = K1_PV(2, 128, 64); break;
    case 4: err = K1_PV(2, 128, 128); break;
    default: err = K1_PV(2, 256, 64); break;
  }
#undef K1_PV
  if (err != 0 || !w) return err;
  const int m = n * lq;
  if (rows == 128)
    return cols == 256 ? launch_fc<2, 256>(o_tmp, w, bias, out, fault, m, dv, st)
                       : launch_fc<2, 128>(o_tmp, w, bias, out, fault, m, dv, st);
  return cols == 256 ? launch_fc<1, 256>(o_tmp, w, bias, out, fault, m, dv, st)
                     : launch_fc<1, 128>(o_tmp, w, bias, out, fault, m, dv, st);
}

}  // namespace

extern "C" {

// q [n, lq, 64], k [n, lkv, 64], v [n, lkv, dv], w [dv, dv] and bias [dv] (both null: no
// fc), out [n, lq, dv], o_tmp [n, lq, dv] (used only with the fc), stats [2, n, lq] f32
// scratch; pointers 16-byte aligned.
// f32: dv % 128 == 0; the PV pass and the fc take column blocks of `cols` and `fc_cols`
// (128, 256 or 512, dividing dv), the PV pass key ranges of k_per 32-key chunks, and o_parts
// [ranges, n, lq, dv] holds the ranges' partial outputs where there is more than one (see
// run_f32).
// Returns the first CUDA error of the launches, 0 if there is none.
int tdnet_propagation_attention_f32(const void* q, const void* k, const void* v,
                                    const void* w, const void* bias, void* o_tmp, void* out,
                                    void* o_parts, void* stats, int n, int lq, int lkv, int dv,
                                    float scale, int cols, int fc_cols, int k_per, void* stream) {
  float* row_max = (float*)stats;
  return run_f32((const float*)q, (const float*)k, (const float*)v, (const float*)w,
                 (const float*)bias, (float*)o_tmp, (float*)out, (float*)o_parts, row_max,
                 row_max + (size_t)n * lq, n, lq, lkv, dv, scale, cols, fc_cols, k_per,
                 (cudaStream_t)stream);
}

// bf16: the same tensors (no o_parts) and the error word `fault` (one uint32 of device memory,
// which a consumer warpgroup that gives up on a barrier sets to 1); the blocks' rows,
// columns, keys a chunk and the p v ring's stages as run_bf16 takes them
// (kernels/grid.py:attention_bf16_plan).
int tdnet_propagation_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* w, const void* bias, void* o_tmp, void* out,
                                     void* stats, void* fault, int n, int lq, int lkv, int dv,
                                     float scale, int rows, int cols, int keys, int stages,
                                     void* stream) {
  float* row_max = (float*)stats;
  return run_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)w,
                  (const bf16*)bias, (bf16*)o_tmp, (bf16*)out, row_max,
                  row_max + (size_t)n * lq, (unsigned int*)fault, n, lq, lkv, dv, scale, rows,
                  cols, keys, stages, (cudaStream_t)stream);
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
