// KC: the k-mers of one block of base codes, counted: encode and compact,
// a one-sweep LSD radix sort, a run-length encode.
//
// Replaces the device function _compiled_count_block
// (winnowmap_tpu/kcount/device.py:28, a jax.jit pass, not Pallas).  Input:
// n codes, 0..3 a base (meryl's A=0 C=1 T=2 G=3) and anything else an
// invalid base.  Window i of the n - k + 1 is valid when its k codes are;
// its key is the forward k-mer f = sum_j c[i+j] << 2(k-1-j), the reverse
// complement r = sum_j (c[i+j] ^ 2) << 2j, or min(f, r) (canonical).
// Output: the valid keys' sorted unique values (as u64) and their counts,
// and how many there are (n_seg).  The JAX function marks an invalid
// window with the all-ones key and so drops a valid all-ones k-mer (k = 32,
// poly-G forward, poly-C reverse); KC never makes such a mark and counts
// it, as the host counter does.
//
// What bounds it on this card: bytes (a code read, a key written and read
// back, a unique k-mer and its count written: ~0.04 ms at 4 Mi codes on an
// H100 SXM's 3.35 TB/s), not operations (5k + 4 integer operations a
// window).  So the design moves each key as few times as it can, in as
// few bytes as it can, with every store coalesced:
//   * the key is as wide as k needs: u32 for 2k <= 32 (meryl's and
//     Winnowmap's k = 15), u64 above; one template, two instantiations;
//   * kc_encode, the one upfront pass, reads the codes once (staged in
//     shared memory with the k - 1 halo, each thread rolling the key over
//     16 consecutive windows), compacts the valid windows' keys in window
//     order, writes them once, and counts every sort pass's digits in the
//     same read (shared-memory counters, added into the pass totals at the
//     end of a block's tiles);
//   * the sort takes ceil(2k / 8) passes of equal digits of at most 8 bits
//     (k = 15: four of 8 bits, k = 19: five, k = 32: eight), one kernel
//     each, kc_sort: a tile of 4096 keys is loaded coalesced and ranked
//     once (stable: a warp takes its 512 keys 32 at a time in order; the
//     lanes of one digit are grouped by a ballot a digit bit for u32 keys
//     and by __match_any_sync for u64, whichever ran faster on the H100; a
//     per-warp digit counter in shared memory carries the earlier rounds);
//     the tile's place in each digit's order comes from a decoupled
//     look-back over the previous tiles' per-digit status words (a flag
//     and a count packed in one u32: an aggregate, or the inclusive
//     prefix), kLook statuses a step, so a tile of the first wave, whose
//     predecessors have published only aggregates, walks back in
//     1 / kLook of the round trips; the keys are staged in shared memory
//     in digit order and stored so that neighbouring threads write
//     neighbouring addresses within a digit's bucket;
//   * kc_rle marks each run's first key, compacts the run heads with its
//     own look-back (a flag, the heads so far and the last head's index
//     in one u64 word) and writes each unique k-mer and, from the run
//     starts, the count of the run before it, so no further pass is
//     needed.
// A launch is a memset of the counters and totals and 2 + passes kernels
// (k = 15: seven in all).  8-bit digits took less time than 10 or 11 bits
// with one pass less (a tile's look-back and digit bookkeeping grow with
// the radix).  Tile ids come from an atomic counter, so a tile waits in
// its look-back only on tiles already running; the per-digit status rows
// of the next pass are cleared by the pass before it.  The result is the
// same on every run: the look-backs add exact integers, the tile counters
// decide which block takes which tile and no value, and the digit totals
// are integer atomic sums, the same in any order.
//
// Shared memory, a block of 256 threads: kc_encode 4 B x passes x 2^bits
// of counters, 4096 keys and 4096 + 32 codes (k = 15: 24 KiB; k = 32:
// 44 KiB); kc_sort max(8 warps x 2^bits u16 counters, 4096 keys) + 8 B x
// 2^bits of digit offsets (k = 15: 18 KiB; k = 32: 34 KiB).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;                  // rounds of 32 keys a warp
constexpr int kWarpItems = 32 * kRounds;     // 512
constexpr int kTile = kWarps * kWarpItems;   // 4096 keys a tile
constexpr int kEncItems = kTile / kThreads;  // 16 windows a thread
constexpr int kMaxBits = 8;
constexpr int kLook = 8;                     // statuses a look-back step
constexpr int kMaxK = 32;
constexpr int kCtrWords = 16;
constexpr unsigned kFull = 0xffffffffu;
// a look-back status word: flag in the top two bits, a count below
constexpr uint32_t kAgg = 1u << 30, kIncl = 2u << 30, kVal = kAgg - 1;
constexpr unsigned long long kAgg64 = 1ull << 62, kIncl64 = 2ull << 62;
constexpr unsigned long long kMask31 = (1ull << 31) - 1;

enum Dir { kCanonical = 0, kForward = 1, kReverse = 2 };

// Digits and scratch of a launch: counters (kCtrWords u32), the passes'
// digit totals (passes x radix u32), kc_encode's tile statuses (tiles u32;
// everything so far is zeroed before kc_encode), kc_rle's tile statuses
// (tiles u64), two rows of kc_sort's per-digit statuses (2 x tiles x
// radix u32).  Mirrored by kcount/device.py (kc_scratch_words).
struct Plan {
  int passes, bits, radix;
  int64_t tiles;
  int64_t hist, enc_st, rle_st, sort_st, words;  // offsets in u32 words
};

Plan plan(int64_t n_win, int k) {
  Plan p;
  p.passes = (2 * k + kMaxBits - 1) / kMaxBits;
  p.bits = (2 * k + p.passes - 1) / p.passes;
  p.radix = 1 << p.bits;
  p.tiles = (n_win + kTile - 1) / kTile;
  p.hist = kCtrWords;
  p.enc_st = p.hist + (int64_t)p.passes * p.radix;
  p.rle_st = p.enc_st + p.tiles;
  p.rle_st += p.rle_st & 1;
  p.sort_st = p.rle_st + 2 * p.tiles;
  p.words = p.sort_st + 2 * p.tiles * p.radix;
  return p;
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  *(volatile uint32_t*)p = v;
}
__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  return *(const volatile uint32_t*)p;
}

// The exclusive prefix of the tile before `tile` from statuses st[j *
// stride] (j < tile), published as aggregates or inclusive prefixes: kLook
// statuses loaded at once a step, so a walk over tiles that have only
// published their aggregates takes 1 / kLook of the round trips.
__device__ __forceinline__ uint32_t look_back(const uint32_t* st,
                                              int64_t tile, int64_t stride) {
  uint32_t sum = 0;
  for (int64_t j = tile - 1;;) {
    uint32_t s[kLook];
#pragma unroll
    for (int w = 0; w < kLook; ++w)
      s[w] = j - w >= 0 ? load_status(st + (j - w) * stride) : kIncl;
    int w = 0;
#pragma unroll
    for (; w < kLook; ++w) {
      if (s[w] < kAgg) break;  // not published yet: poll again from it
      sum += s[w] & kVal;
      if (s[w] >= kIncl) return sum;
    }
    j -= w;
  }
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

// The lanes whose digit d (bits wide, or d == 2^bits for a dead lane)
// equals this lane's: a ballot a bit.  Faster than __match_any_sync for u32
// keys on the H100, not for u64 (the registers of 16 u64 keys).
__device__ __forceinline__ unsigned match_bits(uint32_t d, int bits) {
  unsigned m = kFull;
  for (int b = 0; b <= bits; ++b) {
    const unsigned v = __ballot_sync(kFull, d >> b & 1);
    m &= (d >> b & 1) ? v : ~v;
  }
  return m;
}

// The tile id of this block from the counter at *ctr (block-uniform).
__device__ __forceinline__ int64_t next_tile(uint32_t* ctr, uint32_t* s) {
  if (threadIdx.x == 0) *s = atomicAdd(ctr, 1u);
  __syncthreads();
  const int64_t t = *s;
  __syncthreads();  // *s is written again by the next call
  return t;
}

// Upfront pass: blocks take tiles of kTile windows until none is left.  A
// tile's valid keys go to keys[base ...) in window order, base being the
// valid windows of the tiles before it (look-back over enc_st); every
// pass's digits are counted into hist.  The last tile writes scal[0] (the
// valid windows) and scal[1] = 0 (kc_rle writes n_seg); the blocks also
// clear `clear_words` words at `clear` (kc_rle's statuses and the first
// sort pass's status row).
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
    kc_encode(const uint8_t* __restrict__ codes, int64_t n_win, int k,
              int dir, int passes, int bits, int64_t tiles,
              uint32_t* __restrict__ ctr, uint32_t* __restrict__ hist,
              uint32_t* __restrict__ enc_st, uint32_t* __restrict__ clear,
              int64_t clear_words, KeyT* __restrict__ keys,
              uint32_t* __restrict__ scal) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t ws[kWarps];
  __shared__ uint32_t s_tile, s_base;
  const int t = threadIdx.x;
  const int radix = 1 << bits;
  uint32_t* sh = (uint32_t*)smem;  // passes x radix digit counters
  KeyT* stage = (KeyT*)(sh + passes * radix);
  uint8_t* cs = (uint8_t*)(stage + kTile);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + t; i < clear_words;
       i += (int64_t)gridDim.x * kThreads)
    clear[i] = 0;
  for (int i = t; i < passes * radix; i += kThreads) sh[i] = 0;
  const KeyT mask = 2 * k >= 8 * (int)sizeof(KeyT)
                        ? ~(KeyT)0
                        : (((KeyT)1 << (2 * k)) - 1);
  const int top = 2 * (k - 1);
  for (;;) {
    const int64_t tile = next_tile(ctr, &s_tile);
    if (tile >= tiles) break;
    const int64_t first = tile * kTile;
    const int64_t n = n_win + k - 1;
    for (int s = t; s < kTile + k - 1; s += kThreads) {
      const int64_t p = first + s;
      cs[s] = p < n ? codes[p] : 255;
    }
    __syncthreads();
    // the thread's windows first + w0 .. + kEncItems - 1, rolled
    const int w0 = t * kEncItems;
    KeyT f = 0, r = 0;
    int run = 0;
    for (int j = 0; j < k - 1; ++j) {
      const unsigned c = cs[w0 + j];
      run = c <= 3 ? run + 1 : 0;
      f = ((f << 2) | (c & 3)) & mask;
      r = (r >> 2) | ((KeyT)((c & 3) ^ 2) << top);
    }
    KeyT key[kEncItems];
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < kEncItems; ++j) {
      const unsigned c = cs[w0 + j + k - 1];
      run = c <= 3 ? run + 1 : 0;
      f = ((f << 2) | (c & 3)) & mask;
      r = (r >> 2) | ((KeyT)((c & 3) ^ 2) << top);
      key[j] = dir == kForward ? f : dir == kReverse ? r : (f < r ? f : r);
      if (run >= k && first + w0 + j < n_win) valid |= 1u << j;
    }
    const uint32_t nv = __popc(valid);
    uint32_t tot;
    uint32_t o = block_scan(nv, ws, tot) - nv;
    if (t == 0) {
      uint32_t before = 0;
      if (tile == 0) {
        store_status(enc_st, kIncl | tot);
      } else {
        store_status(enc_st + tile, kAgg | tot);
        before = look_back(enc_st, tile, 1);
        store_status(enc_st + tile, kIncl | (before + tot));
      }
      s_base = before;
    }
#pragma unroll
    for (int j = 0; j < kEncItems; ++j) {
      if (!(valid >> j & 1)) continue;
      stage[o++] = key[j];
      for (int p = 0; p < passes; ++p)
        atomicAdd(&sh[p * radix + (int)((key[j] >> (p * bits)) & (radix - 1))],
                  1u);
    }
    __syncthreads();
    const uint32_t base = s_base;
    for (uint32_t i = t; i < tot; i += kThreads) keys[base + i] = stage[i];
    if (tile == tiles - 1 && t == 0) {
      scal[0] = base + tot;
      scal[1] = 0;
    }
    __syncthreads();  // cs, stage and s_base are written again
  }
  for (int i = t; i < passes * radix; i += kThreads)
    if (sh[i] != 0) atomicAdd(&hist[i], sh[i]);
}

// One sort pass: the tile's live keys of `in` (scal[0] of them in all) to
// `out` in the order of their digit (in >> shift) & (2^bits - 1), stably.
// hist: this pass's digit totals; st: its per-digit status row (tiles x
// radix), next: the next pass's, cleared here for this tile.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
    kc_sort(const KeyT* __restrict__ in, KeyT* __restrict__ out,
            const uint32_t* __restrict__ scal, int shift, int bits,
            const uint32_t* __restrict__ hist, uint32_t* __restrict__ ctr,
            uint32_t* __restrict__ st, uint32_t* __restrict__ next) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t ws[kWarps];
  __shared__ uint32_t s_tile;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int radix = 1 << bits;
  const uint32_t dmask = radix - 1;
  const int region = kWarps * radix * 2 > kTile * (int)sizeof(KeyT)
                         ? kWarps * radix * 2
                         : kTile * (int)sizeof(KeyT);
  uint16_t* cnt = (uint16_t*)smem;  // [warp][digit], then the stage
  KeyT* stage = (KeyT*)smem;
  uint32_t* lstart = (uint32_t*)(smem + region);  // the tile's digit starts
  int32_t* off = (int32_t*)(lstart + radix);      // out index - stage index
  const int64_t tile = next_tile(ctr, &s_tile);
  for (int d = t; d < radix; d += kThreads) next[tile * radix + d] = 0;
  const int64_t n_live = scal[0];
  const int64_t first = tile * kTile;
  if (first >= n_live) return;  // the whole block
  for (int i = t; i < kWarps * radix / 2; i += kThreads)
    ((uint32_t*)cnt)[i] = 0;
  __syncthreads();
  // rank: digit << 16 | the key's rank among its warp's keys of the digit
  const unsigned below = (1u << lane) - 1;
  KeyT key[kRounds];
  uint32_t dr[kRounds];
  uint16_t* mine = cnt + w * radix;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = first + w * kWarpItems + r * 32 + lane;
    const bool live = i < n_live;
    const KeyT x = live ? in[i] : 0;
    const uint32_t d = live ? (uint32_t)(x >> shift) & dmask : radix;
    const unsigned peers = sizeof(KeyT) == 4 ? match_bits(d, bits)
                                             : __match_any_sync(kFull, d);
    const int leader = 31 - __clz((int)peers);
    uint32_t seen = 0;
    if (live && lane == leader) {
      seen = mine[d];
      mine[d] = (uint16_t)(seen + __popc(peers));
    }
    seen = __shfl_sync(kFull, seen, leader);
    __syncwarp();
    key[r] = x;
    dr[r] = d << 16 | (seen + __popc(peers & below));
  }
  __syncthreads();
  // each thread's digits: the warps' exclusive prefixes in place, the
  // tile's count of each, published; then the look-back
  const int dpt = (radix + kThreads - 1) / kThreads;
  const int d0 = t * dpt;
  uint32_t csum = 0, hsum = 0;
  for (int q = 0; q < dpt && d0 + q < radix; ++q) {
    const int d = d0 + q;
    uint32_t run = 0;
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = cnt[v * radix + d];
      cnt[v * radix + d] = (uint16_t)run;
      run += c;
    }
    store_status(st + tile * radix + d, (tile == 0 ? kIncl : kAgg) | run);
    lstart[d] = run;  // the count until the scan below
    csum += run;
    hsum += hist[d];
  }
  uint32_t c_all, h_all;
  uint32_t cpre = block_scan(csum, ws, c_all) - csum;
  uint32_t hpre = block_scan(hsum, ws, h_all) - hsum;
  for (int q = 0; q < dpt && d0 + q < radix; ++q) {
    const int d = d0 + q;
    const uint32_t c = lstart[d];
    uint32_t before = 0;
    if (tile > 0) {
      before = look_back(st + d, tile, radix);
      store_status(st + tile * radix + d, kIncl | (before + c));
    }
    lstart[d] = cpre;
    off[d] = (int32_t)(hpre + before) - (int32_t)cpre;
    cpre += c;
    hpre += hist[d];
  }
  __syncthreads();
  uint32_t lpos[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t d = dr[r] >> 16;
    lpos[r] = d == (uint32_t)radix
                  ? kTile
                  : lstart[d] + cnt[w * radix + d] + (dr[r] & 0xffff);
  }
  __syncthreads();  // the counters become the stage
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (lpos[r] < kTile) stage[lpos[r]] = key[r];
  __syncthreads();
  const int n_tile = n_live - first < kTile ? (int)(n_live - first) : kTile;
  for (int i = t; i < n_tile; i += kThreads) {
    const KeyT x = stage[i];
    out[off[(uint32_t)(x >> shift) & dmask] + i] = x;
  }
}

// The run-length encode of the scal[0] sorted keys s: each run's first key
// to uniq[j] and the run's length to counts[j], j the run's order; scal[1]
// = the number of runs.  st: the tiles' statuses, flag << 62 | heads << 31
// | (last head's index + 1, 0 for none).
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
    kc_rle(const KeyT* __restrict__ s, uint32_t* __restrict__ scal,
           uint32_t* __restrict__ ctr, unsigned long long* __restrict__ st,
           uint64_t* __restrict__ uniq, int64_t* __restrict__ counts) {
  __shared__ uint32_t w_cnt[kWarps], w_last[kWarps];
  __shared__ uint32_t s_tile, s_cnt, s_last;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t tile = next_tile(ctr, &s_tile);
  const int64_t n_live = scal[0];
  const int64_t first = tile * kTile;
  if (first >= n_live) return;
  const int64_t wbase = first + w * kWarpItems;
  KeyT key[kRounds];
  uint32_t hb[kRounds];
  uint32_t cnt = 0, last = 0;  // the warp's heads, its last head + 1
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = wbase + r * 32 + lane;
    const bool live = i < n_live;
    const KeyT x = live ? s[i] : 0;
    const bool head = live && (i == 0 || s[i - 1] != x);
    const uint32_t b = __ballot_sync(kFull, head);
    key[r] = x;
    hb[r] = b;
    if (b) {
      cnt += __popc(b);
      last = (uint32_t)(wbase + r * 32 + 31 - __clz((int)b)) + 1;
    }
  }
  if (lane == 0) {
    w_cnt[w] = cnt;
    w_last[w] = last;
  }
  __syncthreads();
  if (t == 0) {
    uint32_t tc = 0, tl = 0;
    for (int v = 0; v < kWarps; ++v) {
      tc += w_cnt[v];
      if (w_last[v]) tl = w_last[v];
    }
    unsigned long long* me = st + tile;
    uint32_t bc = 0, bl = 0;  // the tiles before: heads, last head + 1
    if (tile > 0) {
      *(volatile unsigned long long*)me =
          kAgg64 | (unsigned long long)tc << 31 | tl;
      for (int64_t j = tile - 1; j >= 0;) {
        unsigned long long v[kLook];
#pragma unroll
        for (int w = 0; w < kLook; ++w)
          v[w] = j - w >= 0 ? *(const volatile unsigned long long*)(st + j - w)
                            : kIncl64;
        int w = 0;
#pragma unroll
        for (; w < kLook; ++w) {
          if (v[w] < kAgg64) break;
          bc += (uint32_t)(v[w] >> 31 & kMask31);
          if (bl == 0) bl = (uint32_t)(v[w] & kMask31);
          if (v[w] >= kIncl64) break;
        }
        if (w < kLook && v[w] >= kIncl64) break;
        j -= w;
      }
    }
    *(volatile unsigned long long*)me =
        kIncl64 | (unsigned long long)(bc + tc) << 31 | (tl ? tl : bl);
    s_cnt = bc;
    s_last = bl;
  }
  __syncthreads();
  uint32_t c = s_cnt, l = s_last;
  for (int v = 0; v < w; ++v) {
    c += w_cnt[v];
    if (w_last[v]) l = w_last[v];
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t b = hb[r];
    const int64_t i = wbase + r * 32 + lane;
    const uint32_t rbase = (uint32_t)(wbase + r * 32);
    const uint32_t eb = b & below;  // the heads before this lane
    const uint32_t prev = eb ? rbase + 31 - __clz((int)eb) + 1 : l;
    if (b >> lane & 1) {
      const uint32_t pos = c + __popc(eb);
      uniq[pos] = (uint64_t)key[r];
      if (pos > 0) counts[pos - 1] = i - (prev - 1);
    }
    if (i == n_live - 1) {  // the last key ends the last run
      const uint32_t ib = b & (below | 1u << lane);
      const uint32_t lh = ib ? rbase + 31 - __clz((int)ib) + 1 : l;
      const uint32_t n_seg = c + __popc(ib);
      counts[n_seg - 1] = n_live - (lh - 1);
      scal[1] = n_seg;
    }
    if (b) {
      c += __popc(b);
      l = rbase + 31 - __clz((int)b) + 1;
    }
  }
}

template <typename KeyT>
int run(const Plan& p, const uint8_t* codes, int64_t n_win, int k, int dir,
        KeyT* keys, uint32_t* tab, uint32_t* scal, uint64_t* uniq,
        int64_t* counts, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int enc_smem =
      4 * p.passes * p.radix + kTile * (int)sizeof(KeyT) + kTile + kMaxK;
  const int region = kWarps * p.radix * 2 > kTile * (int)sizeof(KeyT)
                         ? kWarps * p.radix * 2
                         : kTile * (int)sizeof(KeyT);
  const int sort_smem = region + 8 * p.radix;
  cudaFuncSetAttribute(kc_encode<KeyT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, enc_smem);
  cudaFuncSetAttribute(kc_sort<KeyT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       sort_smem);
  uint32_t* ctr = tab;
  uint32_t* hist = tab + p.hist;
  uint32_t* sort_st = tab + p.sort_st;
  const int64_t row = p.tiles * p.radix;
  // blocks to keep the card busy; each adds its digit counters once
  const int64_t enc_grid = p.tiles < 2 * sms ? p.tiles : 2 * (int64_t)sms;
  kc_encode<KeyT><<<(unsigned)enc_grid, kThreads, enc_smem, st>>>(
      codes, n_win, k, dir, p.passes, p.bits, p.tiles, ctr, hist,
      tab + p.enc_st, tab + p.rle_st, 2 * p.tiles + row, keys, scal);
  KeyT* buf[2] = {keys, keys + n_win};
  for (int q = 0; q < p.passes; ++q) {
    kc_sort<KeyT><<<(unsigned)p.tiles, kThreads, sort_smem, st>>>(
        buf[q & 1], buf[(q + 1) & 1], scal, q * p.bits, p.bits,
        hist + q * p.radix, ctr + 1 + q, sort_st + (q & 1) * row,
        sort_st + ((q + 1) & 1) * row);
  }
  kc_rle<KeyT><<<(unsigned)p.tiles, kThreads, 0, st>>>(
      buf[p.passes & 1], scal, ctr + 1 + p.passes,
      (unsigned long long*)(tab + p.rle_st), uniq, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// KC on n codes at k, direction 0 canonical, 1 forward, 2 reverse, on
// stream.  Scratch: keys (2 x n_win u64), tab (tab_bytes, at least
// kcount/device.py's kc_scratch_words x 4: a smaller one is refused).
// Out: scal[0] the valid windows, scal[1] n_seg, uniq[0 .. n_seg) the
// sorted unique k-mers, counts[0 .. n_seg) their counts (int64).  Returns
// the CUDA error of the launches.
extern "C" int wm_kcount_launch(const void* codes, int64_t n, int k,
                                int direction, void* keys, void* tab,
                                int64_t tab_bytes, void* scal, void* uniq,
                                void* counts, void* stream) {
  const int64_t n_win = n - k + 1;
  if (k <= 0 || k > kMaxK || direction < 0 || direction > 2 || n_win <= 0 ||
      n_win >= ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n_win, k);
  if (tab_bytes < 4 * p.words) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(tab, 0, 4 * p.rle_st, st);
  if (e != cudaSuccess) return (int)e;
  if (2 * k <= 32)
    return run<uint32_t>(p, (const uint8_t*)codes, n_win, k, direction,
                         (uint32_t*)keys, (uint32_t*)tab, (uint32_t*)scal,
                         (uint64_t*)uniq, (int64_t*)counts, st);
  return run<uint64_t>(p, (const uint8_t*)codes, n_win, k, direction,
                       (uint64_t*)keys, (uint32_t*)tab, (uint32_t*)scal,
                       (uint64_t*)uniq, (int64_t*)counts, st);
}
