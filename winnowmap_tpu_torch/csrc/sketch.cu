// S1: the sketch's per-base work, a warp a stretch of 512 bases.
//
// Replaces the device function _compiled_transform
// (winnowmap_tpu/sketch/device.py:30, a jax.jit elementwise pass, not
// Pallas) and the per-base host work the JAX package does after it
// (sketch/device.py:157-164 there: the down-weight membership and the
// IEEE-double selection order).  For base i of the (HPC-compacted) code
// string:
//   * the forward k-mer f_i = sum_j c[i-j] << 2j and its reverse
//     complement r_i = sum_j (3 ^ c[i-j]) << 2(k-1-j) over j < k, where an
//     ambiguous code (not 0..3) and a position before the start contribute
//     0; the canonical k-mer min(f, r), its strand z = f >= r and the
//     symmetric flag f == r;
//   * the MurmurHash3 finalizer h of the canonical k-mer (reference
//     sketch.c:43-51) and the invertible key mix masked to 2k bits
//     (sketch.c:53-63), all in u64;
//   * whether the canonical k-mer is down-weighted: in the sorted set
//     (an entry equal to it), or, in --bloom-filter mode, set in both of
//     the AP-hash probes of the reference's bloom table (wm_bloom.cpp);
//   * the selection order of the oracle's weight_order
//     (native/src/wm_sketch.cpp: x = h * 1.0 / UINT64_MAX, then -x, or
//     -(x^2^2)^2 when down-weighted), in f64 rounded as there.
// It writes the key (u64), the order (f64) and a flags byte z | sym << 1:
// what the winnowing automaton (native.winnow) reads.  h and the canonical
// k-mer stay in registers.
//
// What bounds it on this card: bytes (1 read and 17 written a base), with
// a large down-weight set the operations of its search.  The design:
//   * a warp takes 512 consecutive bases, 16 a lane, read as one 16-byte
//     load a lane; the 32 codes before a lane's come from its two
//     neighbours by shuffle, and its starting k-mers are packed from them
//     at once (2-bit fields, a bit reversal), so a base costs one rolling
//     update instead of k shifted terms;
//   * the keys and orders are staged in shared memory (a lane's 16 words
//     at a stride of 17, so neither side of the stage has bank conflicts)
//     and written out as coalesced 16-byte stores; the 16 flags bytes of a
//     lane are packed in registers and stored as one 16-byte store;
//   * the sorted set is searched in two steps: every stride-th entry
//     (at most kTop of them) sits in shared memory, loaded once a block,
//     and picks the stretch of stride entries in device memory (L2 at the
//     sizes in use) that may hold the k-mer; a set that fits whole in
//     shared memory also gets a filter there (two bits an entry of 64 Ki,
//     taken from its finalizer h, which S1 computes anyway), so a base
//     whose two bits are not both set skips the search (most bases: the
//     lists in use hold a few thousand k-mers);
//   * the grid is a few blocks an SM that walk the stretches, so the
//     shared prefix is loaded a few times a launch, not once a stretch.
// The order's division by UINT64_MAX, which converts to the double 2^64, is
// a product with 2^-64: both are exact (a scaling by a power of two that
// stays normal), so the bits equal the oracle's; __dmul_rn keeps the
// compiler from contracting the down-weight powers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 16;             // codes a lane
constexpr int kSeg = 32 * kPer;      // codes a warp's stretch
constexpr int kStage = 32 * 17;      // words of a warp's stage
constexpr int kTop = 2048;           // set entries in shared memory
constexpr int kFilterBits = 1 << 16; // the filter of a set in shared memory
constexpr int kMaxK = 28;

struct Weights {
  const uint64_t* wset;  // the sorted set (n entries; 0: none)
  int64_t n, stride;     // the shared prefix: wset[i * stride], i < ntop
  int ntop;
  const uint8_t* bloom;  // the bloom table in --bloom-filter mode, else null
  uint64_t bits;
  uint32_t s0, s1;
};

__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ codes,
                                        int64_t p, int64_t n) {
  if (p >= 0 && p + 16 <= n)
    return *reinterpret_cast<const uint4*>(codes + p);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int64_t q = p + b;
    const unsigned c = q >= 0 && q < n ? codes[q] : 4u;
    w[b >> 2] |= c << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 3 in each byte of w that holds a code 0..3, else 0
__device__ __forceinline__ unsigned valid3(unsigned w) {
  unsigned t = w & 0xFCFCFCFCu;
  t |= t >> 4;  // bit 0 of a byte ends as the OR of its bits 2..7
  t |= t >> 2;
  t |= t >> 1;
  return (~t & 0x01010101u) * 3u;
}

// the 2-bit fields of four bytes (each 0..3), byte b at bits 2b
__device__ __forceinline__ unsigned pack4(unsigned t) {
  t = (t | (t >> 6)) & 0x000F000Fu;
  return (t | (t >> 12)) & 0xFFu;
}

// the 16 codes of v as 2-bit fields (code b at bits 2b): their own value
// where valid, else 0, and their complement 3 ^ c where valid, else 0
__device__ __forceinline__ void pack16(uint4 v, unsigned& cc, unsigned& rc) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  cc = rc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned m = valid3(w[i]);
    cc |= pack4(w[i] & m) << (8 * i);
    rc |= pack4(~w[i] & m) << (8 * i);
  }
}

__device__ __forceinline__ uint64_t murmur(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

__device__ __forceinline__ uint64_t mix(uint64_t y, uint64_t mask) {
  y = (~y + (y << 21)) & mask;
  y ^= y >> 24;
  y = (y + (y << 3) + (y << 8)) & mask;
  y ^= y >> 14;
  y = (y + (y << 2) + (y << 4)) & mask;
  y ^= y >> 28;
  return (y + (y << 31)) & mask;
}

// the sorted set holds x: the last prefix entry <= x, then a lower bound
// over the stretch after it
__device__ __forceinline__ bool in_set(const Weights& wt,
                                       const uint64_t* top, uint64_t x) {
  if (wt.n == 0 || x < top[0]) return false;
  int a = 0, b = wt.ntop - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (top[m] <= x)
      a = m;
    else
      b = m - 1;
  }
  if (top[a] == x) return true;
  int64_t lo = (int64_t)a * wt.stride + 1;
  const int64_t next = (int64_t)(a + 1) * wt.stride;
  const int64_t end = next < wt.n ? next : wt.n;
  int64_t hi = end;
  while (lo < hi) {
    const int64_t m = lo + ((hi - lo) >> 1);
    if (wt.wset[m] < x)
      lo = m + 1;
    else
      hi = m;
  }
  return lo < end && wt.wset[lo] == x;
}

// one hash_ap round over the 8 little-endian bytes (wm_bloom.cpp)
__device__ __forceinline__ uint32_t hash_ap(uint64_t key, uint32_t h) {
  const uint32_t i1 = (uint32_t)key, i2 = (uint32_t)(key >> 32);
  return h ^ ((h << 7) ^ (i1 * (h >> 3)) ^ ~((h << 11) + (i2 ^ (h >> 5))));
}

__device__ __forceinline__ bool in_bloom(const Weights& wt, uint64_t x) {
  uint64_t b = hash_ap(x, wt.s0) % wt.bits;
  if (!((wt.bloom[b >> 3] >> (b & 7)) & 1)) return false;
  b = hash_ap(x, wt.s1) % wt.bits;
  return (wt.bloom[b >> 3] >> (b & 7)) & 1;
}

// a warp's 512 words (lane l's 16 in v) to out[s0 ...], coalesced
__device__ __forceinline__ void write_words(uint64_t* st,
                                            const uint64_t (&v)[kPer],
                                            uint64_t* __restrict__ out,
                                            int64_t s0, int64_t n,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) st[lane * 17 + j] = v[j];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kSeg / 64; ++q) {
    const int m = q * 64 + 2 * lane;
    const int at = 17 * (m >> 4) + (m & 15);
    const uint64_t a = st[at], b = st[at + 1];
    const int64_t g = s0 + m;
    if (g + 1 < n)
      *reinterpret_cast<uint4*>(out + g) =
          make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b,
                     (unsigned)(b >> 32));
    else if (g < n)
      out[g] = a;
  }
  __syncwarp();
}

// K: k fixed at compile time (the common 15, 19, 28), or 0: k_any
template <int K>
__global__ void __launch_bounds__(kThreads)
    sketch_kernel(const uint8_t* __restrict__ codes, int64_t n, int k_any,
                  Weights wt, uint64_t* __restrict__ key,
                  uint64_t* __restrict__ ordv, uint8_t* __restrict__ flags) {
  const int k = K ? K : k_any;
  __shared__ uint64_t top[kTop];
  __shared__ uint64_t stage[kWarps][kStage];
  __shared__ uint32_t filt[kFilterBits / 32];
  const bool small = wt.n > 0 && wt.stride == 1;
  if (small)
    for (int i = threadIdx.x; i < kFilterBits / 32; i += kThreads) filt[i] = 0;
  __syncthreads();
  if (wt.n > 0)
    for (int i = threadIdx.x; i < wt.ntop; i += kThreads) {
      const uint64_t v = wt.wset[(int64_t)i * wt.stride];
      top[i] = v;
      if (small) {
        const uint64_t hv = murmur(v);
        const unsigned b1 = (unsigned)hv & (kFilterBits - 1);
        const unsigned b2 = (unsigned)(hv >> 32) & (kFilterBits - 1);
        atomicOr(&filt[b1 >> 5], 1u << (b1 & 31));
        atomicOr(&filt[b2 >> 5], 1u << (b2 & 31));
      }
    }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int rshift = 2 * (k - 1);
  const int64_t nseg = (n + kSeg - 1) / kSeg;
  for (int64_t seg = (int64_t)blockIdx.x * kWarps + warp; seg < nseg;
       seg += (int64_t)gridDim.x * kWarps) {
    const int64_t s0 = seg * kSeg, p = s0 + lane * kPer;
    const uint4 own = load16(codes, p, n);
    // the 32 codes before p: lanes l - 2 and l - 1's, or device memory
    uint4 p2, p1;
    p1.x = __shfl_up_sync(0xffffffffu, own.x, 1);
    p1.y = __shfl_up_sync(0xffffffffu, own.y, 1);
    p1.z = __shfl_up_sync(0xffffffffu, own.z, 1);
    p1.w = __shfl_up_sync(0xffffffffu, own.w, 1);
    p2.x = __shfl_up_sync(0xffffffffu, own.x, 2);
    p2.y = __shfl_up_sync(0xffffffffu, own.y, 2);
    p2.z = __shfl_up_sync(0xffffffffu, own.z, 2);
    p2.w = __shfl_up_sync(0xffffffffu, own.w, 2);
    if (lane < 2) p2 = load16(codes, p - 32, n);
    if (lane == 0) p1 = load16(codes, p - 16, n);
    unsigned c2, r2, c1, r1, cc, rc;
    pack16(p2, c2, r2);
    pack16(p1, c1, r1);
    pack16(own, cc, rc);
    // code p - 32 + m at bits 2m: f wants code p - 1 - j at bits 2j (the
    // fields reversed), r wants its complement at bits 2(k - 1 - j)
    uint64_t f = (uint64_t)c1 << 32 | c2;
    f = __brevll(f);
    constexpr uint64_t kLo = 0x5555555555555555ull;
    f = ((f >> 1) & kLo) | ((f & kLo) << 1);
    f &= mask;
    uint64_t r = ((uint64_t)r1 << 32 | r2) >> (64 - 2 * k);
    uint64_t kv[kPer], ov[kPer];
    unsigned fl[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      f = ((f << 2) | ((cc >> (2 * j)) & 3)) & mask;
      r = (r >> 2) | ((uint64_t)((rc >> (2 * j)) & 3) << rshift);
      const uint64_t cn = f < r ? f : r;
      const uint64_t h = murmur(cn);
      kv[j] = mix(cn, mask);
      bool down;
      if (wt.bloom) {
        down = in_bloom(wt, cn);
      } else if (small) {
        const unsigned b1 = (unsigned)h & (kFilterBits - 1);
        const unsigned b2 = (unsigned)(h >> 32) & (kFilterBits - 1);
        down = (filt[b1 >> 5] >> (b1 & 31)) & (filt[b2 >> 5] >> (b2 & 31)) &
               1;
        if (down) down = in_set(wt, top, cn);
      } else {
        down = in_set(wt, top, cn);
      }
      double x = __dmul_rn(__ull2double_rn(h), 0x1p-64);
      if (down) {
        const double p2d = __dmul_rn(x, x);
        const double p4d = __dmul_rn(p2d, p2d);
        x = __dmul_rn(p4d, p4d);
      }
      ov[j] = (uint64_t)__double_as_longlong(-x);
      fl[j >> 2] |= ((f < r ? 0u : 1u) | (f == r ? 2u : 0u)) << (8 * (j & 3));
    }
    uint64_t* st = stage[warp];
    write_words(st, kv, key, s0, n, lane);
    write_words(st, ov, ordv, s0, n, lane);
    if (p + kPer <= n) {
      *reinterpret_cast<uint4*>(flags + p) = make_uint4(fl[0], fl[1], fl[2],
                                                        fl[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (p + j < n) flags[p + j] = (uint8_t)(fl[j >> 2] >> (8 * (j & 3)));
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int K>
int launch(const void* codes, int64_t n, int k, const Weights& wt, void* key,
           void* ordv, void* flags, void* stream) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sketch_kernel<K>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int64_t need = ((n + kSeg - 1) / kSeg + kWarps - 1) / kWarps;
  const int64_t most = (int64_t)sms * (per > 0 ? per : 1);
  const unsigned blocks = (unsigned)(need < most ? need : most);
  sketch_kernel<K><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, k, wt, (uint64_t*)key, (uint64_t*)ordv,
      (uint8_t*)flags);
  return (int)cudaGetLastError();
}

}  // namespace

// codes (n bytes), key and ordv (n words each) and flags (n bytes) must lie
// on 16-byte boundaries; wset holds n_wset sorted u64 (read when bloom is
// null), bloom the bloom table of bloom_bits bits.
extern "C" int wm_sketch_launch(const void* codes, int64_t n, int k,
                                const void* wset, int64_t n_wset,
                                const void* bloom, uint64_t bloom_bits,
                                uint32_t salt0, uint32_t salt1, void* key,
                                void* ordv, void* flags, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || k > kMaxK || n_wset < 0 || (bloom && bloom_bits == 0) ||
      !aligned16(codes) || !aligned16(key) || !aligned16(ordv) ||
      !aligned16(flags))
    return (int)cudaErrorInvalidValue;
  Weights wt{};
  if (bloom) {
    wt.bloom = (const uint8_t*)bloom;
    wt.bits = bloom_bits;
    wt.s0 = salt0;
    wt.s1 = salt1;
  } else if (n_wset > 0) {
    wt.wset = (const uint64_t*)wset;
    wt.n = n_wset;
    wt.stride = (n_wset + kTop - 1) / kTop;
    wt.ntop = (int)((n_wset + wt.stride - 1) / wt.stride);
  }
  switch (k) {
    case 15:
      return launch<15>(codes, n, k, wt, key, ordv, flags, stream);
    case 19:
      return launch<19>(codes, n, k, wt, key, ordv, flags, stream);
    case 28:
      return launch<28>(codes, n, k, wt, key, ordv, flags, stream);
    default:
      return launch<0>(codes, n, k, wt, key, ordv, flags, stream);
  }
}
