// Reference-exact bloom-filter emulation for the strict-parity mode.
//
// The reference loads the down-weighted k-mer list into a bloom filter
// (reference src/index.c:410-437: projected = max(n, 1000), p = 0.001,
// <= 2 hashes; ext/bloom/bloom_filter.hpp), so its effective down-weight
// set includes the filter's false positives.  Our default is the exact
// sorted set (no FPs -- better weighting); this module reproduces the
// reference filter bit-for-bit (same optimal-parameter solver, same salt
// derivation, same AP-hash) behind the --bloom-filter flag so SAM output
// can be byte-identical to the reference at any scale.
//
// Clean-room re-derivation of the observable behaviour of
// ext/bloom/bloom_filter.hpp (parameter solver bloom_filter.hpp:108-160,
// salt generation :467-520, hash_ap :552-607, compute_indices :461-465,
// insert/contains over the 8 little-endian bytes of the canonical k-mer
// code, bloom_filter.hpp:276-280 POD insert).

#include "wm_base.h"

#include <cmath>
#include <cstring>
#include <limits>

namespace {

// One hash_ap evaluation over an 8-byte little-endian key: exactly one
// iteration of the reference's >=8-bytes loop (bloom_filter.hpp:556-565).
inline uint32_t hash_ap_u64(uint64_t key, uint32_t hash) {
  uint32_t i1 = (uint32_t)(key & 0xFFFFFFFFu);
  uint32_t i2 = (uint32_t)(key >> 32);
  hash ^= (hash << 7) ^ (i1 * (hash >> 3)) ^
          (~((hash << 11) + (i2 ^ (hash >> 5))));
  return hash;
}

}  // namespace

extern "C" {

// Optimal-parameter solve + salt derivation for the reference's exact
// configuration: projected = max(n_kmers, 1000), p = 0.001, hashes
// clamped to [1, 2], default random seed.  Returns the table size in BITS
// (already padded to a byte multiple) and the two derived salts.
void wm_bloom_params(uint64_t n_kmers, uint64_t* table_bits, uint32_t* salt0,
                     uint32_t* salt1) {
  const double projected =
      (double)(n_kmers > 1000 ? n_kmers : (uint64_t)1000);
  const double p = 0.001;
  double min_m = std::numeric_limits<double>::infinity();
  for (double k = 1.0; k < 1000.0; k += 1.0) {
    const double numerator = -k * projected;
    const double denominator = std::log(1.0 - std::pow(p, 1.0 / k));
    const double curr_m = numerator / denominator;
    if (curr_m < min_m) min_m = curr_m;
  }
  uint64_t m = (uint64_t)min_m;
  if (m % 8 != 0) m += 8 - m % 8;
  if (m < 1) m = 1;
  *table_bits = m;

  // salt_count = min(optimal_k, 2) = 2 for p = 0.001 (optimal k ~ 10);
  // seed flows through the ctor transform then truncates to 32 bits at
  // the in-place salt mixing step
  const uint64_t seed64 = 0xA5A5A5A55A5A5A5AULL * 0xA5A5A5A5ULL + 1ULL;
  const uint32_t seed32 = (uint32_t)seed64;
  uint32_t s0 = 0xAAAAAAAAu, s1 = 0x55555555u;
  s0 = s0 * s1 + seed32;  // salt_[0] uses the ORIGINAL salt_[1]
  s1 = s1 * s0 + seed32;  // salt_[1] uses the UPDATED salt_[0]
  *salt0 = s0;
  *salt1 = s1;
}

// Build the bit table (caller allocates table_bits/8 zeroed bytes).
void wm_bloom_build(const uint64_t* kmers, int64_t n, uint64_t table_bits,
                    uint32_t s0, uint32_t s1, uint8_t* table) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t b0 = hash_ap_u64(kmers[i], s0) % table_bits;
    uint64_t b1 = hash_ap_u64(kmers[i], s1) % table_bits;
    table[b0 / 8] |= (uint8_t)(1u << (b0 % 8));
    table[b1 / 8] |= (uint8_t)(1u << (b1 % 8));
  }
}

int wm_bloom_contains(uint64_t key, const uint8_t* table,
                      uint64_t table_bits, uint32_t s0, uint32_t s1) {
  uint64_t b0 = hash_ap_u64(key, s0) % table_bits;
  if (!(table[b0 / 8] >> (b0 % 8) & 1)) return 0;
  uint64_t b1 = hash_ap_u64(key, s1) % table_bits;
  return (table[b1 / 8] >> (b1 % 8) & 1) ? 1 : 0;
}

// Vectorized membership for the device-sketch host tail.
void wm_bloom_contains_batch(const uint64_t* keys, int64_t n,
                             const uint8_t* table, uint64_t table_bits,
                             uint32_t s0, uint32_t s1, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (uint8_t)wm_bloom_contains(keys[i], table, table_bits, s0, s1);
}

}  // extern "C"
