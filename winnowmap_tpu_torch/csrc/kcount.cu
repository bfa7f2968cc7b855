// KC: the k-mers of one block of base codes, counted: encode and compact,
// an LSD radix sort, a run-length encode.
//
// Replaces the device function _compiled_count_block
// (winnowmap_tpu/kcount/device.py:28, a jax.jit pass, not Pallas).  Input:
// n codes, 0..3 a base (meryl's A=0 C=1 T=2 G=3) and anything else an
// invalid base.  Window i of the n - k + 1 is valid when its k codes are;
// its key is the forward k-mer f = sum_j c[i+j] << 2(k-1-j), the reverse
// complement r = sum_j (c[i+j] ^ 2) << 2j, or min(f, r) (canonical), in
// u64.  Output: the valid keys' sorted unique values and their counts, and
// how many there are (n_seg).  The JAX function marks an invalid window
// with the all-ones key and so drops a valid all-ones k-mer (k = 32,
// poly-G forward, poly-C reverse); KC never makes such a mark and counts
// it, as the host counter does.
//
// What bounds it on this card: bytes (a code read, a key written and read
// back, a unique k-mer and its count written: ~0.04 ms at 4 Mi codes on an
// H100 SXM's 3.35 TB/s), not operations (5k + 4 integer operations a
// window).  The design keeps every step a stream over device memory that
// no block waits on another for, and the result the same on every run (no
// atomics):
//   * the keys are sorted by LSD radix passes of 8 bits over the 2k
//     significant bits only (k = 15: four passes), each pass three
//     kernels: kc_hist (each tile's digit counts, into a digit x tile
//     table), kc_scan_rows (a block per digit scans its row in place and
//     writes the row's total) and kc_scatter (each tile ranks its keys
//     again and writes each where the digit's base, the tile's prefix,
//     its warp's prefix and its rank within the warp put it);
//   * the ranks are stable: a warp takes its tile's keys 32 at a time in
//     order; __match_any_sync gives the lanes with the same digit, the
//     lanes below with the same digit give the rank in the round, and a
//     per-warp, per-digit counter in shared memory the keys of that digit
//     in the warp's earlier rounds;
//   * the first pass encodes the windows from the codes (staged in shared
//     memory with a k-1 halo) and so compacts the valid keys: an invalid
//     window takes no digit;
//   * the run-length encode is one more pass of the same kernels with one
//     digit, a run's first key the only live one: kc_scatter writes the
//     unique k-mer and the run's start, kc_counts the differences of the
//     starts.
// The number of live keys stays on the card (scal[0], written by the first
// pass's kc_scatter), so the launches need no host round trip.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                  // rounds of 32 keys a warp
constexpr int kWarpItems = 32 * kRounds;     // 512
constexpr int kTile = kWarps * kWarpItems;   // 4096 windows a block
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;      // == kThreads: a digit a thread
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRadix == kThreads, "a thread per digit");

// where a pass takes its keys from
enum Src { kCodes = 0, kKeys = 1, kBounds = 2 };
enum Dir { kCanonical = 0, kForward = 1, kReverse = 2 };

struct KcIn {
  const uint8_t* codes;   // kCodes: the block's codes
  const uint64_t* keys;   // kKeys, kBounds: the previous pass's keys
  int64_t n_win;          // windows
  const uint32_t* n_live; // kKeys, kBounds: live keys (scal[0])
  int k, dir;
};

// window `s` (its k codes from s[0]) as a key; false when a code is invalid
__device__ __forceinline__ bool encode(const uint8_t* s, int k, int dir,
                                       uint64_t& key) {
  uint64_t f = 0, r = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const unsigned c = s[j];
    ok = ok && c <= 3;
    f = (f << 2) | (c & 3);
    r |= (uint64_t)((c & 3) ^ 2) << (2 * j);
  }
  key = dir == kForward ? f : dir == kReverse ? r : (f < r ? f : r);
  return ok;
}

// inclusive prefix sum of v over the block; total gets the block's sum
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* ws,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) ws[w] = v;
  __syncthreads();
  uint32_t before = 0, all = 0;
  for (int j = 0; j < kWarps; ++j) {
    const uint32_t x = ws[j];
    if (j < w) before += x;
    all += x;
  }
  __syncthreads();  // ws is written again by the next call
  total = all;
  return v + before;
}

// The tile's codes and the k - 1 after them (invalid past n) into cs.
__device__ __forceinline__ void stage_codes(const KcIn& in, int64_t first,
                                            uint8_t* cs) {
  const int64_t n = in.n_win + in.k - 1;
  for (int s = threadIdx.x; s < kTile + in.k - 1; s += kThreads) {
    const int64_t p = first + s;
    cs[s] = p < n ? in.codes[p] : 255;
  }
}

// Each of the thread's kRounds keys of the tile from `first`: the key, its
// digit (kRadix when the key is not live) and its rank among the keys of
// that digit before it in its warp; cnt[w][d] ends as warp w's count of
// digit d.
template <int S>
__device__ __forceinline__ void rank_tile(const KcIn& in, int64_t first,
                                          int64_t n_live, int shift,
                                          const uint8_t* cs,
                                          uint32_t (*cnt)[kRadix],
                                          uint64_t (&key)[kRounds],
                                          unsigned (&dig)[kRounds],
                                          unsigned (&rank)[kRounds]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < kWarps * kRadix; d += kThreads)
    cnt[d / kRadix][d % kRadix] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int local = w * kWarpItems + r * 32 + lane;
    const int64_t i = first + local;
    uint64_t x = 0;
    bool live;
    if constexpr (S == kCodes) {
      live = encode(cs + local, in.k, in.dir, x) && i < in.n_win;
    } else {
      live = i < n_live;
      if (live) x = in.keys[i];
      // a run of equal keys: its first key is the one live
      if constexpr (S == kBounds)
        live = live && (i == 0 || in.keys[i - 1] != x);
    }
    const unsigned d =
        !live ? kRadix
              : S == kBounds ? 0u : (unsigned)(x >> shift) & (kRadix - 1);
    const unsigned peers = __match_any_sync(kFull, d);
    const uint32_t seen = live ? cnt[w][d] : 0;
    __syncwarp();
    if (live && (peers & below) == 0) cnt[w][d] = seen + __popc(peers);
    __syncwarp();
    key[r] = x;
    dig[r] = d;
    rank[r] = seen + __popc(peers & below);
  }
  __syncthreads();
}

// Pass of kind S, step 1: tab[d * tiles + tile] = the tile's count of digit
// d, for d < n_digits.
template <int S>
__global__ void __launch_bounds__(kThreads)
    kc_hist(KcIn in, int shift, int n_digits, uint32_t* __restrict__ tab) {
  __shared__ uint8_t cs[kTile + kMaxK];
  __shared__ uint32_t cnt[kWarps][kRadix];
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int64_t n_live = S == kCodes ? in.n_win : (int64_t)*in.n_live;
  const int d = threadIdx.x;
  if (S != kCodes && first >= n_live) {  // the whole block: no key
    if (d < n_digits) tab[(int64_t)d * gridDim.x + blockIdx.x] = 0;
    return;
  }
  if constexpr (S == kCodes) {
    stage_codes(in, first, cs);
    __syncthreads();
  }
  uint64_t key[kRounds];
  unsigned dig[kRounds], rank[kRounds];
  rank_tile<S>(in, first, n_live, shift, cs, cnt, key, dig, rank);
  if (d < n_digits) {
    uint32_t s = 0;
    for (int w = 0; w < kWarps; ++w) s += cnt[w][d];
    tab[(int64_t)d * gridDim.x + blockIdx.x] = s;
  }
}

// Step 2: block d replaces row d of tab (tiles entries) by its exclusive
// prefix sums and writes the row's total to totals[d].
__global__ void __launch_bounds__(kThreads)
    kc_scan_rows(uint32_t* __restrict__ tab, int64_t tiles,
                 uint32_t* __restrict__ totals) {
  __shared__ uint32_t ws[kWarps];
  uint32_t* row = tab + (int64_t)blockIdx.x * tiles;
  uint32_t carry = 0;
  for (int64_t c0 = 0; c0 < tiles; c0 += 4 * kThreads) {
    uint32_t v[4], s = 0;
    for (int q = 0; q < 4; ++q) {
      const int64_t j = c0 + 4 * threadIdx.x + q;
      v[q] = j < tiles ? row[j] : 0;
      s += v[q];
    }
    uint32_t all;
    uint32_t run = carry + block_scan(s, ws, all) - s;
    for (int q = 0; q < 4; ++q) {
      const int64_t j = c0 + 4 * threadIdx.x + q;
      if (j < tiles) row[j] = run;
      run += v[q];
    }
    carry += all;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Step 3: each live key to out_keys[position] (kBounds: also its index to
// out_pos), the position being the sum of its digit's base (the totals of
// the digits below), the tile's prefix in the digit's row, its warp's
// prefix in the tile and its rank in the warp.  Block 0 writes the number
// of live keys to *n_out when n_out is given.
template <int S>
__global__ void __launch_bounds__(kThreads)
    kc_scatter(KcIn in, int shift, int n_digits,
               const uint32_t* __restrict__ tab,
               const uint32_t* __restrict__ totals,
               uint64_t* __restrict__ out_keys,
               int64_t* __restrict__ out_pos, uint32_t* __restrict__ n_out) {
  __shared__ uint8_t cs[kTile + kMaxK];
  __shared__ uint32_t cnt[kWarps][kRadix];
  __shared__ uint32_t base[kRadix];
  __shared__ uint32_t ws[kWarps];
  const int t = threadIdx.x;
  const uint32_t tv = t < n_digits ? totals[t] : 0;
  uint32_t all;
  base[t] = block_scan(tv, ws, all) - tv;
  if (blockIdx.x == 0 && t == 0 && n_out != nullptr) *n_out = all;
  const int64_t first = (int64_t)blockIdx.x * kTile;
  const int64_t n_live = S == kCodes ? in.n_win : (int64_t)*in.n_live;
  if (S != kCodes && first >= n_live) return;  // the whole block: no key
  if constexpr (S == kCodes) stage_codes(in, first, cs);
  __syncthreads();
  uint64_t key[kRounds];
  unsigned dig[kRounds], rank[kRounds];
  rank_tile<S>(in, first, n_live, shift, cs, cnt, key, dig, rank);
  // thread t: digit t's exclusive prefix over the warps, and the tile's
  // place in the digit's order
  {
    uint32_t run = base[t] + (t < n_digits
                                  ? tab[(int64_t)t * gridDim.x + blockIdx.x]
                                  : 0);
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = cnt[w][t];
      cnt[w][t] = run;
      run += c;
    }
  }
  __syncthreads();
  const int w = t >> 5;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dig[r] == kRadix) continue;
    const uint32_t pos = cnt[w][dig[r]] + rank[r];
    out_keys[pos] = key[r];
    if constexpr (S == kBounds)
      out_pos[pos] = first + w * kWarpItems + r * 32 + (t & 31);
  }
}

// counts[j] = start[j + 1] - start[j] for j < n_seg, start[n_seg] being
// the number of sorted keys.
__global__ void __launch_bounds__(kThreads)
    kc_counts(const int64_t* __restrict__ start,
              const uint32_t* __restrict__ scal,
              int64_t* __restrict__ counts) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t n_seg = scal[1];
  if (j < n_seg)
    counts[j] = (j + 1 < n_seg ? start[j + 1] : (int64_t)scal[0]) - start[j];
}

}  // namespace

// KC on n codes at k, direction 0 canonical, 1 forward, 2 reverse, on
// stream.  Scratch: keys (2 x n_win u64), tab (256 x tiles u32, tiles =
// ceil(n_win / 4096)), totals (256 u32).  Out: scal[0] the valid windows,
// scal[1] n_seg, uniq[0 .. n_seg) the sorted unique k-mers, counts[0 ..
// n_seg) their counts (int64).  Returns the CUDA error of the launches.
extern "C" int wm_kcount_launch(const void* codes, int64_t n, int k,
                                int direction, void* keys, void* tab,
                                void* totals, void* scal, void* uniq,
                                void* counts, void* stream) {
  const int64_t n_win = n - k + 1;
  if (k <= 0 || k > kMaxK || direction < 0 || direction > 2 || n_win <= 0 ||
      n_win >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = (n_win + kTile - 1) / kTile;
  uint64_t* buf[2] = {(uint64_t*)keys, (uint64_t*)keys + n_win};
  uint32_t* tb = (uint32_t*)tab;
  uint32_t* tot = (uint32_t*)totals;
  uint32_t* sc = (uint32_t*)scal;
  KcIn in{(const uint8_t*)codes, nullptr, n_win, sc, k, direction};
  const int passes = (2 * k + kDigitBits - 1) / kDigitBits;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    uint64_t* dst = buf[p & 1];
    in.keys = buf[(p + 1) & 1];
    if (p == 0) {
      kc_hist<kCodes><<<(unsigned)tiles, kThreads, 0, st>>>(in, shift,
                                                             kRadix, tb);
    } else {
      kc_hist<kKeys><<<(unsigned)tiles, kThreads, 0, st>>>(in, shift, kRadix,
                                                            tb);
    }
    kc_scan_rows<<<kRadix, kThreads, 0, st>>>(tb, tiles, tot);
    if (p == 0) {
      kc_scatter<kCodes><<<(unsigned)tiles, kThreads, 0, st>>>(
          in, shift, kRadix, tb, tot, dst, nullptr, sc);
    } else {
      kc_scatter<kKeys><<<(unsigned)tiles, kThreads, 0, st>>>(
          in, shift, kRadix, tb, tot, dst, nullptr, nullptr);
    }
  }
  // the sorted keys are in buf[(passes - 1) & 1]; the other holds the
  // runs' starts
  in.keys = buf[(passes - 1) & 1];
  int64_t* start = (int64_t*)buf[passes & 1];
  kc_hist<kBounds><<<(unsigned)tiles, kThreads, 0, st>>>(in, 0, 1, tb);
  kc_scan_rows<<<1, kThreads, 0, st>>>(tb, tiles, tot);
  kc_scatter<kBounds><<<(unsigned)tiles, kThreads, 0, st>>>(
      in, 0, 1, tb, tot, (uint64_t*)uniq, start, sc + 1);
  kc_counts<<<(unsigned)((n_win + kThreads - 1) / kThreads), kThreads, 0,
              st>>>(start, sc, (int64_t*)counts);
  return (int)cudaGetLastError();
}
