// The bf16 propagation attention's shared part, for the inference kernel's bf16 path
// (propagation_attention.cu, K1) and the training kernel's bf16 forward
// (propagation_attention_train.cu, K2), on wgmma (f32 accumulate) fed by TMA (hopper.cuh):
//   attn_bf16<RW, -, 128, true, false> (stats): per q row, m = max_j s_j c and l = sum_j
//       2^(s_j c - m) over a range of keys, s = q k^T, c = scale log2 e;
//   attn_bf16<RW, CW, BK, false, DROP> (p v): o = pd v over the block's CW columns of v and a
//       range of keys, p = 2^(s c - m) (1 / l) formed in registers from the score tile and, with
//       DROP, pd = keep ? p (1 / (1 - rate)) : 0 in f32 (the keep bits of (seed, (b lq + r)
//       lkv + j), dropout_hash.cuh, formed once a call by K2's keep_bits), then rounded to
//       bf16 in place as the A operand of p v.
// K1 runs one key range (its bits are those of PR 10's kernels); K2 splits the keys into
// ranges where q blocks alone leave SMs idle: each stats range writes its partial (m, l), the
// p v kernel merges them in range order (merge2) and, with more than one p v range, writes
// f32 partial outputs that the caller sums in range order and rounds once.
// A block is a producer warpgroup (0: one thread issues the TMA copies through the Ring of
// hopper.cuh) and RW consumer warpgroups (1 ..); consumer warpgroup cg owns rows [64 cg, + 64)
// of the block's rows. setmaxnreg gives the producer's registers to the consumers: RW = 1 runs
// two blocks an SM with 232 registers a consumer thread, RW = 2 one with 240. The producer's
// waits trap; a consumer's wait that gives up sets the error word `fault` and exits
// (bar_wait_or_flag). A build with -DTDNET_K1_STARVE or -DTDNET_K2_STARVE (and few
// TDNET_CONSUMER_POLLS) has producers that fill nothing, for the check that the word is
// reported. Every tile in shared memory is stored in wgmma's 128-byte swizzle, as the tensor
// maps' SWIZZLE_128B writes it: 128-byte rows of 64 bf16, the 16-byte chunk c of row r at
// c ^ (r % 8), 1024-byte aligned; rows past the tensors read as zeros. Each output element is
// summed by one thread in a fixed order: two runs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "hopper.cuh"

#if defined(TDNET_K1_STARVE) || defined(TDNET_K2_STARVE)
#define TDNET_ATTN_STARVE 1
#endif

namespace {

typedef __nv_bfloat16 bf16;

namespace attn {

constexpr int D_K = 64;                       // the key width
constexpr int ROW = 128;                      // bytes of a swizzle row: 64 bf16
constexpr int MAX_SMEM = 232448;              // bytes of shared memory a block may have
constexpr int PRODUCER_REGS = 24;             // registers a producer thread keeps
template <int RW>
constexpr int BLOCKS_PER_SM = RW == 1 ? 2 : 1;
// a consumer thread's registers: its count at launch (65,536 over the SM's threads, 128 or
// 168) and its share of what the producer gives up
template <int RW>
constexpr int CONSUMER_REGS = RW == 1 ? 232 : 240;
constexpr float LOG2E = 1.4426950408889634f;

// d (a warpgroup's 64 x 32 f32 fragment) = a b + (scale_d ? d : 0): a 64 x 16 bf16 K-major,
// b 32 n x 16 k bf16 K-major (TRANS_B 0) or N-major (1), both from shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_32(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (a warpgroup's 64 x 64 f32 fragment) = a b + (scale_d ? d : 0): a 64 x 16 bf16 K-major,
// b 64 n x 16 k bf16 K-major (TRANS_B 0) or N-major (1), both from shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (a warpgroup's 64 x 64 f32 fragment) = a b + (scale_d ? d : 0): a 64 x 16 bf16 in
// registers (the A fragment of mma.sync m16n8k16 a warp, warp w rows 16 w ..), b 64 n x 16 k
// bf16 from shared memory, K-major (TRANS_B 0) or N-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_64(float* d, const uint32_t a[4], uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// d (a warpgroup's 64 x 128 f32 fragment) = a b + (scale_d ? d : 0): a 64 x 16 bf16 in
// registers (the A fragment of mma.sync m16n8k16 a warp, warp w rows 16 w ..), b 128 n x 16 k
// bf16 from shared memory, K-major (TRANS_B 0) or N-major (1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_128(float* d, const uint32_t a[4], uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The descriptor of an N-major B tile with the 128-byte swizzle: slabs of 64 columns, one
// 128-byte row a k, `slab` bytes apart; groups of 8 k rows 1024 bytes apart in a slab.
__device__ __forceinline__ uint64_t sw128_n_desc(const void* p, int slab) {
  return (uint64_t)((saddr(p) >> 4) & 0x3FFF) | (uint64_t)((slab >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// Issue s (the warpgroup's 64 x BK score tile, unscaled, f32) = q k^T over d_k = 64 as one
// wgmma group: 4 k16 steps, the warpgroup's 64 q rows (descriptor qd) and the K chunk's rows
// at kt both K-major in shared memory. The caller waits for the group and fences s.
template <int BK>
__device__ __forceinline__ void issue_scores(float* s, uint64_t qd, const unsigned char* kt) {
  const uint64_t desc = sw128_desc(kt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {   // 32 bytes a step: 2 in the descriptor's units
    if constexpr (BK == 32) wgmma_ss_32<0>(s, qd + 2 * kk, desc + 2 * kk, kk);
    else if constexpr (BK == 64) wgmma_ss_64<0>(s, qd + 2 * kk, desc + 2 * kk, kk);
    else wgmma_ss_128<0>(s, qd + 2 * kk, desc + 2 * kk, kk);
  }
  wgmma_commit();
}

// p = 2^(s c - m) (1 / l) of the score tile as bf16 A fragments of p v, pa[kk] for keys
// [k0 + 16 kk, + 16); keys from lkv on give 0 (MASK: the chunk reaches past the keys); DROP:
// p times keep ? 1 / (1 - rate) : 0 in f32 before the rounding, the keep bit of key k0 + i in
// bit i % 32 of kw[h][i / 32] for the thread's rows h. s[4 j + e]: row g + 8 (e / 2), key k0 +
// 8 j + 2 t + e % 2.
template <int BK, bool MASK, bool DROP>
__device__ __forceinline__ void probs(uint32_t (*pa)[4], const float* s, float c,
                                      const float m[2], const float il[2], int k0, int lkv,
                                      uint32_t (*kw)[BK / 32], float inv_keep) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * j + 2 * t + (e & 1);
      p[e] = ex2(fmaf(s[4 * j + e], c, -m[e >> 1])) * il[e >> 1];
      if (MASK && k0 + i >= lkv) p[e] = 0.f;
      if (DROP) p[e] *= (kw[e >> 1][i >> 5] >> (i & 31)) & 1u ? inv_keep : 0.f;
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
  }
}

// Issue acc += p v over a chunk as one wgmma group: p's A fragments pa (keys [16 kk, + 16)
// of the chunk), v's chunk the CW / 64 slabs from vt, each a 128-byte row a key.
template <int CW, int BK>
__device__ __forceinline__ void issue_pv(float (*acc)[64], const uint32_t (*pa)[4],
                                         const unsigned char* vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)   // 16 keys: 16 rows of 128 bytes a slab
#pragma unroll
    for (int hh = 0; hh < CW / 128; ++hh)
      wgmma_rs_128<1>(acc[hh], pa[kk],
                      sw128_n_desc(vt + 2 * hh * BK * ROW + kk * 16 * ROW, BK * ROW), 1);
  wgmma_commit();
}

// Fold a chunk's scores into this thread's row statistics: m = max s c, l = sum 2^(s c - m)
// of rows g (h = 0) and g + 8 (h = 1); keys from lkv on left out (MASK: the chunk reaches past
// the keys).
template <int BK, bool MASK>
__device__ __forceinline__ void fold_stats(float m[2], float l[2], const float* s, float c,
                                           int k0, int lkv) {
  const int t = threadIdx.x & 3;
  auto valid = [&](int j, int e) { return !MASK || k0 + 8 * j + 2 * t + e < lkv; };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (valid(j, e)) cm = fmaxf(cm, s[4 * j + 2 * h + e] * c);
    if (cm == -INFINITY) continue;   // no key of this thread in the chunk
    if (cm > m[h]) {
      l[h] *= ex2(m[h] - cm);
      m[h] = cm;
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (valid(j, e)) sum += ex2(fmaf(s[4 * j + 2 * h + e], c, -m[h]));
    l[h] += sum;
  }
}

// Merge two (max, sum of 2^(x - max)) pairs; an empty pair has max -inf.
__device__ __forceinline__ void merge2(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : l * ex2(m - mn);
  const float b = mo == -INFINITY ? 0.f : lo * ex2(mo - mn);
  m = mn;
  l = a + b;
}

template <int CW, int BK, bool STATS>
__host__ __device__ constexpr int attn_stage() {
  return BK * ROW * (1 + (STATS ? 0 : CW / 64));   // the K chunk, then V's CW / 64 slabs
}

// What a launch of attn_bf16 reads and writes besides q, k and v. With DROP the p v kernel
// reads the keep bits [n][lq][keep_words] (uint32, bit i of word w: key 32 w + i). The stats
// kernel writes
// range y's (m, l) of batch b to row_max / row_sum + (y n + b) lq; the p v kernel reads the
// stat_ranges ranges and merges them in order (one range: the values as they are), writes
// the merged (m, l) to saved [2][n][lq] if saved is not null (blocks with y = 0), and writes
// o (bf16 [n, lq, dv]) or, if o_part is not null, its key range's f32 partial to o_part +
// (range n + b) lq dv.
struct AttnOut {
  float* row_max;
  float* row_sum;
  bf16* o;
  float* o_part;
  float* saved;
  unsigned int* fault;
  const uint32_t* keep;
  int keep_words;
};

// Block (x, y, z): q rows [64 RW x, + 64 RW) of batch z; the keys of chunks [range k_per,
// + k_per), range = y (stats) or y / (dv / CW) (p v), and (p v) columns [CW (y % (dv / CW)),
// + CW). q, k and v through tm_q ([n][lq][64], boxes of 64 x 64 RW), tm_k ([n][lkv][64], boxes
// of 64 x BK) and tm_v ([n][lkv][dv], boxes of 64 x BK).
template <int RW, int CW, int BK, bool STATS, bool DROP>
__global__ void __launch_bounds__(128 * (RW + 1), BLOCKS_PER_SM<RW>)
attn_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, AttnOut out, int lq, int lkv, int dv,
          float c, int stages, int k_per, int stat_ranges, Drop drop) {
  constexpr int STAGE = attn_stage<CW, BK, STATS>(), Q_BYTES = 64 * RW * ROW;
  extern __shared__ unsigned char smem_attn[];
  const Ring ring(smem_attn, stages, STAGE, Q_BYTES);
  const int col_blocks = STATS ? 1 : dv / CW, n = gridDim.z;
  const int b = blockIdx.z, d0 = (blockIdx.y % col_blocks) * CW;
  const int range = blockIdx.y / col_blocks, c0 = range * k_per;
  const int chunks = min((lkv + BK - 1) / BK - c0, k_per);   // this block's chunks
  init_ring<RW>(ring, stages);
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);   // warp-uniform
  if (role == 0) {   // the producer
    reg_dealloc<PRODUCER_REGS>();
#ifdef TDNET_ATTN_STARVE
    return;   // the fault check's build: no stage ever fills
#endif
    if (threadIdx.x != 0) return;
    bar_expect(ring.head_full, Q_BYTES);
    tma_load_3d(ring.head, &tm_q, 0, blockIdx.x * 64 * RW, b, ring.head_full);
    for (int ch = 0; ch < chunks; ++ch) {
      wait_free(ring, ch, stages);
      const int s = ch % stages;
      unsigned char* st = ring.base + s * STAGE;
      bar_expect(ring.full + s, STAGE);
      tma_load_3d(st, &tm_k, 0, (c0 + ch) * BK, b, ring.full + s);
      if constexpr (!STATS)
#pragma unroll
        for (int j = 0; j < CW / 64; ++j)
          tma_load_3d(st + (1 + j) * BK * ROW, &tm_v, d0 + 64 * j, (c0 + ch) * BK, b,
                      ring.full + s);
    }
    return;
  }
  reg_alloc<CONSUMER_REGS<RW>>();
  const int cg = role - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = blockIdx.x * 64 * RW + 64 * cg + 16 * warp + g;   // and row + 8
  const uint64_t qd = sw128_desc(ring.head + cg * 64 * ROW);   // rows past lq read as zeros
  unsigned int* fault = out.fault;
  bar_wait_or_flag(ring.head_full, 0, fault);
  // A chunk: its score tile on the tensor cores, then (stats) folded into the row statistics
  // or (p v) exponentiated into p and multiplied into acc. The stats loop runs one chunk
  // ahead: chunk ch + 1's score tile is issued into the other of two buffers before chunk
  // ch is folded, so the tensor cores form it meanwhile (the loop takes two chunks a turn,
  // so that each buffer is a fixed set of registers). The same lookahead in the p v loop,
  // with p in two buffers, measured slower (PERF.md, run P3 of PR 10).
  auto stage = [&](int ch) { return ring.base + (ch % stages) * STAGE; };
  auto wait_chunk = [&](int ch) {
    bar_wait_or_flag(ring.full + ch % stages, (ch / stages) & 1, fault);
  };
  auto release = [&](int ch) {
    if (lane == 0) bar_arrive(ring.empty + ch % stages);
  };
  const size_t nlq = (size_t)n * lq;
  float s0[BK / 2], s1[BK / 2];
  wait_chunk(0);
  issue_scores<BK>(s0, qd, stage(0));
  if constexpr (STATS) {
    float* stats_m = out.row_max + range * nlq + (size_t)b * lq;
    float* stats_l = out.row_sum + range * nlq + (size_t)b * lq;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // chunk ch's scores in cur (issued), chunk ch + 1's go to nxt
    auto step = [&](float* cur, float* nxt, int ch) {
      if (ch >= chunks) return;
      if (ch + 1 < chunks) {
        wait_chunk(ch + 1);
        issue_scores<BK>(nxt, qd, stage(ch + 1));
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs<BK / 2>(cur);
      release(ch);
      const int k0 = (c0 + ch) * BK;
      if (k0 + BK <= lkv) fold_stats<BK, false>(m, l, cur, c, k0, lkv);
      else fold_stats<BK, true>(m, l, cur, c, k0, lkv);
    };
    for (int ch = 0; ch < chunks; ch += 2) {
      step(s0, s1, ch);
      step(s1, s0, ch + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // a row's 4 threads are the 4 lanes of a quad
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
        merge2(m[h], l[h], mo, lo);
      }
      if (t == 0 && row + 8 * h < lq) {
        stats_m[row + 8 * h] = m[h];
        stats_l[row + 8 * h] = l[h];
      }
    }
  } else {
    const float* stats_m = out.row_max + (size_t)b * lq;
    const float* stats_l = out.row_sum + (size_t)b * lq;
    float m[2], il[2];
    const uint32_t* keep_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      keep_row[h] = DROP && r < lq ? out.keep + ((size_t)b * lq + r) * out.keep_words : nullptr;
      if (r < lq) {
        float mm = stats_m[r], ll = stats_l[r];
        for (int p = 1; p < stat_ranges; ++p) merge2(mm, ll, stats_m[p * nlq + r],
                                                     stats_l[p * nlq + r]);
        m[h] = mm;
        il[h] = 1.f / ll;
        if (out.saved && blockIdx.y == 0 && t == 0) {
          out.saved[(size_t)b * lq + r] = mm;
          out.saved[nlq + (size_t)b * lq + r] = ll;
        }
      } else {
        m[h] = 0.f;
        il[h] = 1.f;
      }
    }
    float acc[CW / 128][64];
#pragma unroll
    for (int hh = 0; hh < CW / 128; ++hh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[hh][i] = 0.f;
    wgmma_wait<0>();
    fence_regs<BK / 2>(s0);
    for (int ch = 0; ch < chunks; ++ch) {
      uint32_t pa[BK / 16][4], kw[2][BK / 32] = {};
      const int k0 = (c0 + ch) * BK;
      if constexpr (DROP)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (keep_row[h])
#pragma unroll
            for (int i = 0; i < BK / 32; ++i) kw[h][i] = keep_row[h][k0 / 32 + i];
      if (k0 + BK <= lkv) probs<BK, false, DROP>(pa, s0, c, m, il, k0, lkv, kw, drop.inv_keep);
      else probs<BK, true, DROP>(pa, s0, c, m, il, k0, lkv, kw, drop.inv_keep);
      issue_pv<CW, BK>(acc, pa, stage(ch) + BK * ROW);
      wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < CW / 128; ++hh) fence_regs<64>(acc[hh]);
      release(ch);
      if (ch + 1 < chunks) {
        wait_chunk(ch + 1);
        issue_scores<BK>(s0, qd, stage(ch + 1));
        wgmma_wait<0>();
        fence_regs<BK / 2>(s0);
      }
    }
    if (out.o_part) {
      float* op = out.o_part + ((size_t)range * n + b) * lq * dv + d0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= lq) continue;
#pragma unroll
        for (int hh = 0; hh < CW / 128; ++hh)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(op + (size_t)r * dv + 128 * hh + 8 * j + 2 * t) =
                make_float2(acc[hh][4 * j + 2 * h], acc[hh][4 * j + 2 * h + 1]);
      }
    } else {
      bf16* o = out.o + (size_t)b * lq * dv + d0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= lq) continue;
#pragma unroll
        for (int hh = 0; hh < CW / 128; ++hh)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<uint32_t*>(o + (size_t)r * dv + 128 * hh + 8 * j + 2 * t) =
                pack_bf16(acc[hh][4 * j + 2 * h], acc[hh][4 * j + 2 * h + 1]);
      }
    }
  }
}

// Launch attn_bf16 on grid (q blocks, ranges (stats) or ranges x dv / CW (p v), n) with keys
// in ranges of k_per BK-key chunks; `stages` ring stages.
template <int RW, int CW, int BK, bool STATS, bool DROP>
int launch_attn(const bf16* q, const CUtensorMap& tk, const CUtensorMap& tv, const AttnOut& out,
                int n, int lq, int lkv, int dv, float c, int stages, int k_per, int stat_ranges,
                const Drop& drop, cudaStream_t st) {
  const size_t smem = ring_smem(stages, attn_stage<CW, BK, STATS>(), 64 * RW * ROW);
  const int chunks = (lkv + BK - 1) / BK;
  if (stages < 1 || smem > MAX_SMEM || k_per < 1 || stat_ranges < 1)
    return (int)cudaErrorInvalidValue;
  const int ranges = (chunks + k_per - 1) / k_per;
  CUtensorMap tq;
  int err = bf16_tensor_map(&tq, q, D_K, lq, n, 64 * RW);
  constexpr auto kernel = attn_bf16<RW, CW, BK, STATS, DROP>;
  if (err != 0 || (err = allow_smem<kernel>(smem)) != 0) return err;
  const dim3 grid((lq + 64 * RW - 1) / (64 * RW), ranges * (STATS ? 1 : dv / CW), n);
  kernel<<<grid, 128 * (RW + 1), smem, st>>>(tq, tk, tv, out, lq, lkv, dv, c, stages, k_per,
                                             stat_ranges, drop);
  return (int)cudaGetLastError();
}

}  // namespace attn
}  // namespace
