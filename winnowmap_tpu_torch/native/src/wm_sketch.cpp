// Weighted-minimizer sketch, host fallback / bit-exactness oracle.
//
// Robust-winnowing minimizer scan with tf-idf style down-weighting of
// repetitive k-mers (reference: src/sketch.c:128-219, applyWeight
// src/sketch.c:70-89).  One deliberate design change vs the reference: the
// repetitive k-mer set is an *exact* sorted-array membership test instead of
// a bloom filter (reference src/index.c:410-423), which removes bloom
// false-positive nondeterminism.  Everything else matches bit-for-bit,
// including double-precision weight ordering and rightmost tie-breaking.
//
// The production TPU path (winnowmap_tpu/sketch/device.py) implements the
// same semantics with sortable-integer weight keys.

#include "wm_base.h"

#include <algorithm>
#include <vector>

namespace {

// base -> 2-bit code; 4 = ambiguous (reference sketch.c:19-36 table)
const uint8_t* nt4_table() {
  static uint8_t tbl[256];
  static bool init = false;
  if (!init) {
    std::memset(tbl, 4, sizeof(tbl));
    tbl[(uint8_t)'A'] = tbl[(uint8_t)'a'] = 0;
    tbl[(uint8_t)'C'] = tbl[(uint8_t)'c'] = 1;
    tbl[(uint8_t)'G'] = tbl[(uint8_t)'g'] = 2;
    tbl[(uint8_t)'T'] = tbl[(uint8_t)'t'] = 3;
    tbl[(uint8_t)'U'] = tbl[(uint8_t)'u'] = 3;
    init = true;
  }
  return tbl;
}

// MurmurHash3 64-bit finalizer (reference sketch.c:43-51)
inline uint64_t murmur_mix64(uint64_t key) {
  key ^= key >> 33;
  key *= 0xff51afd7ed558ccdULL;
  key ^= key >> 33;
  key *= 0xc4ceb9fe1a85ec53ULL;
  key ^= key >> 33;
  return key;
}

// invertible integer mix used for the stored minimizer key
// (reference sketch.c:53-63)
inline uint64_t mix64_masked(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  key = (key + (key << 31)) & mask;
  return key;
}

// Down-weight membership: the exact sorted set (our default) or, in the
// --bloom-filter strict-parity mode, the reference-exact bloom emulation
// (wm_bloom.cpp; reference bloom_filter.hpp via src/index.c:410-437).
struct WeightMembership {
  const uint64_t* wset = nullptr;
  int64_t n_wset = 0;
  const uint8_t* bloom = nullptr;  // non-null selects bloom mode
  uint64_t bloom_bits = 0;
  uint32_t salt0 = 0, salt1 = 0;

  bool contains(uint64_t kmer) const {
    if (bloom)
      return wm_bloom_contains(kmer, bloom, bloom_bits, salt0, salt1) != 0;
    return n_wset > 0 && std::binary_search(wset, wset + n_wset, kmer);
  }
};

// weight-adjusted selection order in [-1, 0]; smaller = more likely chosen
// (reference applyWeight, sketch.c:70-89: flagged k-mers get -(x^8))
inline double weight_order(uint64_t kmer, const WeightMembership& wm) {
  uint64_t h = murmur_mix64(kmer);
  double x = h * 1.0 / UINT64_MAX;
  if (wm.contains(kmer)) {
    double p2 = x * x;
    double p4 = p2 * p2;
    return -1.0 * (p4 * p4);
  }
  return -1.0 * x;
}

struct HpcQueue {  // tiny ring queue for HPC span bookkeeping
  int front = 0, count = 0;
  int a[32];
  void push(int v) { a[((count++) + front) & 0x1f] = v; }
  int shift() {
    if (count == 0) return -1;
    int v = a[front++];
    front &= 0x1f;
    --count;
    return v;
  }
};

}  // namespace

extern "C" {

// Sketch one sequence.  Returns the number of minimizers written through
// (*out_x, *out_y), each wm_malloc'd:
//   x = mixed_kmer_key<<8 | kmer_span
//   y = rid<<32 | last_base_pos<<1 | strand
int64_t wm_sketch(const char* str, int len, int w, int k, uint32_t rid,
                  int is_hpc, const uint64_t* wset, int64_t n_wset,
                  const uint8_t* bloom, uint64_t bloom_bits, uint32_t salt0,
                  uint32_t salt1, uint64_t** out_x, uint64_t** out_y) {
  *out_x = nullptr;
  *out_y = nullptr;
  if (len <= 0 || w <= 0 || w >= 256 || k <= 0 || k > 28) return 0;
  WeightMembership wm{wset, n_wset, bloom, bloom_bits, salt0, salt1};
  const uint8_t* nt4 = nt4_table();
  const uint64_t shift1 = 2 * (k - 1), mask = (1ULL << 2 * k) - 1;
  uint64_t kmer_f = 0, kmer_r = 0;

  std::vector<uint64_t> rx, ry;
  rx.reserve(len / w + 4);
  ry.reserve(len / w + 4);

  // ring buffers over the current window
  std::vector<uint64_t> bufx(w, UINT64_MAX), bufy(w, UINT64_MAX);
  std::vector<double> buford(w, 2.0);  // 2.0 == uninitialised sentinel
  uint64_t minx = UINT64_MAX, miny = UINT64_MAX;
  double min_order = 2.0;
  int min_pos = 0, buf_pos = 0, l = 0, kmer_span = 0;
  HpcQueue tq;

  for (int i = 0; i < len; ++i) {
    int c = nt4[(uint8_t)str[i]];
    uint64_t infox = UINT64_MAX, infoy = UINT64_MAX;
    double info_order = 2.0;
    if (c < 4) {
      if (is_hpc) {
        int skip_len = 1;
        if (i + 1 < len && nt4[(uint8_t)str[i + 1]] == c) {
          for (skip_len = 2; i + skip_len < len; ++skip_len)
            if (nt4[(uint8_t)str[i + skip_len]] != c) break;
          i += skip_len - 1;  // jump to the end of the homopolymer run
        }
        tq.push(skip_len);
        kmer_span += skip_len;
        if (tq.count > k) kmer_span -= tq.shift();
      } else
        kmer_span = l + 1 < k ? l + 1 : k;
      kmer_f = (kmer_f << 2 | c) & mask;
      kmer_r = (kmer_r >> 2) | (3ULL ^ c) << shift1;
      if (kmer_f == kmer_r) continue;  // strand-ambiguous symmetric k-mer
      int z = kmer_f < kmer_r ? 0 : 1;
      ++l;
      if (l >= k && kmer_span < 256) {
        uint64_t canon = z ? kmer_r : kmer_f;
        infox = mix64_masked(canon, mask) << 8 | kmer_span;
        infoy = (uint64_t)rid << 32 | (uint32_t)i << 1 | z;
        info_order = weight_order(canon, wm);
      }
    } else {
      l = 0;
      tq.count = tq.front = 0;
      kmer_span = 0;
    }
    bufx[buf_pos] = infox;
    bufy[buf_pos] = infoy;
    buford[buf_pos] = info_order;

    if (info_order < min_order) {  // strictly better: new window minimum
      if (l >= w + k && minx != UINT64_MAX) rx.push_back(minx), ry.push_back(miny);
      minx = infox, miny = infoy, min_pos = buf_pos, min_order = info_order;
    } else if (buf_pos == min_pos) {  // old minimum fell out of the window
      if (l >= w + k - 1 && minx != UINT64_MAX)
        rx.push_back(minx), ry.push_back(miny);
      // rescan, ties -> the k-mer closest to the window end (>= comparison)
      minx = UINT64_MAX;
      min_order = 2.0;
      for (int j = buf_pos + 1; j < w; ++j)
        if (min_order >= buford[j])
          minx = bufx[j], miny = bufy[j], min_pos = j, min_order = buford[j];
      for (int j = 0; j <= buf_pos; ++j)
        if (min_order >= buford[j])
          minx = bufx[j], miny = bufy[j], min_pos = j, min_order = buford[j];
    }
    if (++buf_pos == w) buf_pos = 0;
  }
  if (minx != UINT64_MAX) rx.push_back(minx), ry.push_back(miny);

  int64_t cnt = (int64_t)rx.size();
  if (cnt) {
    *out_x = (uint64_t*)wm_malloc(sizeof(uint64_t) * cnt);
    *out_y = (uint64_t*)wm_malloc(sizeof(uint64_t) * cnt);
    std::memcpy(*out_x, rx.data(), sizeof(uint64_t) * cnt);
    std::memcpy(*out_y, ry.data(), sizeof(uint64_t) * cnt);
  }
  return cnt;
}

// Canonical k-mer encoder for the -W list (reference index.c:362-376).
uint64_t wm_encode_kmer(const char* s, int k) {
  const uint8_t* nt4 = nt4_table();
  uint64_t f = 0, r = 0;
  uint64_t shift1 = 2 * (k - 1);
  for (int i = 0; i < k; ++i) {
    int c = nt4[(uint8_t)s[i]];
    f = f << 2 | c;
    r = (r >> 2) | (3ULL ^ c) << shift1;
  }
  return f < r ? f : r;
}

}  // extern "C"

extern "C" {

// Robust-winnowing selection automaton over precomputed per-slot inputs
// (the device sketch path, winnowmap_tpu/sketch/device.py: the heavy
// per-base transform -- k-mer roll, murmur, membership -- runs on the TPU;
// this tail replicates the oracle's window scan, reference
// sketch.c:128-219 selection semantics, bit-for-bit).
//   codes[i]  : nt4 code of slot i (4 = ambiguous resets the window)
//   key[i]    : mixed canonical k-mer key (device)
//   z[i]      : strand bit (device)
//   sym[i]    : strand-symmetric k-mer (skipped without pushing)
//   ordv[i]   : IEEE-double selection order (host f64, oracle-identical)
//   skip_len  : HPC run length per slot (1s when !is_hpc)
//   base_pos  : reference position of the slot's last base
int64_t wm_winnow(int64_t n, const uint8_t* codes, const uint64_t* key,
                  const uint8_t* z, const uint8_t* sym, const double* ordv,
                  const int64_t* skip_len, const int64_t* base_pos, int w,
                  int k, uint32_t rid, int is_hpc, uint64_t** out_x,
                  uint64_t** out_y) {
  *out_x = nullptr;
  *out_y = nullptr;
  std::vector<uint64_t> rx, ry;
  std::vector<uint64_t> bufx(w, UINT64_MAX), bufy(w, UINT64_MAX);
  std::vector<double> buford(w, 2.0);
  uint64_t minx = UINT64_MAX, miny = UINT64_MAX;
  double min_order = 2.0;
  int min_pos = 0, buf_pos = 0, l = 0, kmer_span = 0;
  HpcQueue tq;

  for (int64_t i = 0; i < n; ++i) {
    int c = codes[i];
    uint64_t infox = UINT64_MAX, infoy = UINT64_MAX;
    double info_order = 2.0;
    if (c < 4) {
      if (is_hpc) {
        tq.push((int)skip_len[i]);
        kmer_span += (int)skip_len[i];
        if (tq.count > k) kmer_span -= tq.shift();
      } else
        kmer_span = l + 1 < k ? l + 1 : k;
      if (sym[i]) continue;  // strand-ambiguous symmetric k-mer
      ++l;
      if (l >= k && kmer_span < 256) {
        infox = key[i] << 8 | kmer_span;
        infoy = (uint64_t)rid << 32 | (uint32_t)base_pos[i] << 1 | z[i];
        info_order = ordv[i];
      }
    } else {
      l = 0;
      tq.count = tq.front = 0;
      kmer_span = 0;
    }
    bufx[buf_pos] = infox;
    bufy[buf_pos] = infoy;
    buford[buf_pos] = info_order;

    if (info_order < min_order) {
      if (l >= w + k && minx != UINT64_MAX) rx.push_back(minx), ry.push_back(miny);
      minx = infox, miny = infoy, min_pos = buf_pos, min_order = info_order;
    } else if (buf_pos == min_pos) {
      if (l >= w + k - 1 && minx != UINT64_MAX)
        rx.push_back(minx), ry.push_back(miny);
      minx = UINT64_MAX;
      min_order = 2.0;
      for (int j = buf_pos + 1; j < w; ++j)
        if (min_order >= buford[j])
          minx = bufx[j], miny = bufy[j], min_pos = j, min_order = buford[j];
      for (int j = 0; j <= buf_pos; ++j)
        if (min_order >= buford[j])
          minx = bufx[j], miny = bufy[j], min_pos = j, min_order = buford[j];
    }
    if (++buf_pos == w) buf_pos = 0;
  }
  if (minx != UINT64_MAX) rx.push_back(minx), ry.push_back(miny);

  int64_t cnt = (int64_t)rx.size();
  if (cnt) {
    *out_x = (uint64_t*)wm_malloc(sizeof(uint64_t) * cnt);
    *out_y = (uint64_t*)wm_malloc(sizeof(uint64_t) * cnt);
    std::memcpy(*out_x, rx.data(), sizeof(uint64_t) * cnt);
    std::memcpy(*out_y, ry.data(), sizeof(uint64_t) * cnt);
  }
  return cnt;
}

}  // extern "C"
