// Counter-hash dropout shared by the conv block and MHA block kernels: the
// JAX package's _hash_bits and _mha_hash_bits
// (vslnet_tpu/ops/pallas_kernels.py:622-636, 932-946), a murmur3 finalizer
// over (row, col, seed, salt) in uint32 arithmetic that wraps. The keep
// masks equal the TPU kernels' bit for bit, and a backward regenerates the
// forward's masks from the same seeds: nothing is stored or drawn again.
//
// (i, j) is the position inside one batch row's [T, D] tile (block sites)
// or inside one head's [T, T] probability tile; the row enters only
// through its seed.
#pragma once

#include <cstdint>

namespace vsl {

// The hash in three terms: counter_hash(i, j) = hash_mix(hash_row(i) ^
// hash_col(j, seed, salt_term)), so a loop over a tile computes the row and
// column terms once each and the mix once a (i, j).
__device__ __forceinline__ uint32_t hash_row(uint32_t i) { return i * 0x9E3779B9u; }
__device__ __forceinline__ uint32_t hash_col(uint32_t j, uint32_t seed, uint32_t salt_term) {
  return (j * 0x85EBCA6Bu) ^ (seed * 2654435761u + salt_term);
}
__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t counter_hash(uint32_t i, uint32_t j, uint32_t seed,
                                                 uint32_t salt_term) {
  return hash_mix(hash_row(i) ^ hash_col(j, seed, salt_term));
}

// Salt term of a block site: 0x100 + layer in the conv block, 0x200-0x203
// in the MHA block.
__host__ __device__ constexpr uint32_t site_salt(uint32_t salt) {
  return 0x94D049BBu * (salt + 1u);
}

// Salt term of attention head h's probability tile.
__host__ __device__ constexpr uint32_t head_salt(uint32_t h) { return 0x27D4EB2Fu * (h + 1u); }

struct Dropout {
  const float* seeds;  // [B] float32 holding integers in [0, 2^23); null: off
  uint32_t thresh;     // keep iff bits >= min(int(rate * 2^32), 2^32 - 1)
  float scale;         // 1 / (1 - rate), rounded to fp32 on the host

  __device__ bool on() const { return seeds != nullptr; }
  // the row's seed, cast to int32 as _read_seeds does
  __device__ uint32_t seed(int b) const {
    return on() ? static_cast<uint32_t>(static_cast<int>(seeds[b])) : 0u;
  }
  __device__ bool keep(uint32_t seed, uint32_t salt_term, int i, int j) const {
    return !on() || counter_hash(i, j, seed, salt_term) >= thresh;
  }
  // v as a kept element leaves the dropout: v * scale, or v when it is off
  __device__ float kept(float v) const { return on() ? v * scale : v; }
  // inverted dropout of v at (i, j): v * scale where kept, 0 where dropped,
  // v itself when dropout is off
  __device__ float apply(float v, uint32_t seed, uint32_t salt_term, int i, int j) const {
    if (!on()) return v;
    return counter_hash(i, j, seed, salt_term) >= thresh ? v * scale : 0.f;
  }
};

}  // namespace vsl
