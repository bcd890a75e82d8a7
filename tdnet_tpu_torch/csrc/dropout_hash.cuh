// The dropout mask shared by the training attention (K2) and the dropout kernel (K3).
//
// The TPU kernels seed the hardware PRNG per (seed, block), so their masks depend on
// the tiling. Here the mask is a pure function of (seed, global element index):
//   keep(seed, idx) = hash(seed, idx) < threshold,  threshold = round((1 - rate) * 2^32),
//   hash(seed, idx) = mix(lo(idx) ^ mix(hi(idx) ^ mix(seed))),
// with mix the 32-bit "lowbias32" integer mixer (two xor-shift-multiply rounds). The
// index is (b * Lq + i) * Lkv + j for attention element (b, i, j) and row * C + c for
// dropout over [rows, C]. Any tiling, the forward and the backward all draw the same
// bits, and `tdnet_tpu_torch/ops/dropout_mask.py` computes the same function in
// PyTorch integer arithmetic, so a kernel and its plain version use the same mask.

#pragma once

#include <stdint.h>

__host__ __device__ __forceinline__ uint32_t tdnet_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t tdnet_dropout_hash(uint32_t seed, uint64_t idx) {
  return tdnet_mix32((uint32_t)idx ^ tdnet_mix32((uint32_t)(idx >> 32) ^ tdnet_mix32(seed)));
}

__host__ __device__ __forceinline__ bool tdnet_keep(uint32_t seed, uint64_t idx,
                                                    uint32_t threshold) {
  return tdnet_dropout_hash(seed, idx) < threshold;
}

// The hash in two halves, for a kernel whose elements share the index's high word:
// tdnet_dropout_hash(seed, idx) == tdnet_hash_low((uint32_t)idx,
//                                                 tdnet_hash_high(tdnet_mix32(seed), idx >> 32)).
// The high half is formed once for all of them (K3: once a 16-byte vector), leaving about one
// mixer an element.
__host__ __device__ __forceinline__ uint32_t tdnet_hash_high(uint32_t seed_mix, uint32_t hi) {
  return tdnet_mix32(hi ^ seed_mix);
}

__host__ __device__ __forceinline__ uint32_t tdnet_hash_low(uint32_t lo, uint32_t high) {
  return tdnet_mix32(lo ^ high);
}

// A launch's dropout: the seed, the keep threshold (0: no dropout) and 1 / (1 - rate) in f32.
struct Drop {
  uint32_t seed, threshold;
  float inv_keep;
};
