// R1: each call's CIGARs built on the card from K2's op rows, in the
// engine's deliver layout.
//
// Replaces no TPU kernel.  The JAX package copies K2's packed op rows to the
// host and run-length-decodes them there (native wm_rle_ops, wm_rle_ops4 in
// native/src/wm_cigar.cpp).  That decode walks every slot of every row, and
// a row is as long as the call's widest job (qlen + tlen - 1): in a spliced
// call with one 200 kb intron the host scans some thirty times the slots
// that hold ops, on the pump's thread, while the card waits.
//
// Semantics: those of wm_rle_ops / wm_rle_ops4 on K2's output.  Job b's op
// bytes ops[b * n_ops + r] (0 M, 1 I, 2 D, 3 N; 255 idle) are walked from
// the highest slot down, idle slots dropped and equal neighbours merged into
// runs; then the remainder runs of fin[b] = (i, j): D of i + 1 (N when
// min_intron > 0 and i >= min_intron), then I of j + 1, each merged into the
// run before it when its op is the same; the list is reversed unless rev.
// Output: BAM CIGAR words len << 4 | op, job b's at blob[off[b]] ...
// blob[off[b] + len[b] - 1], the jobs in order with no gap.  Only slots 0
// ... i0 + j0 are read, (i0, j0) = start[b] being where K2's walk began: K2
// writes op r at the anti-diagonal r of each cell it visits, and every
// visited cell lies on or below the start's.  A start with i0 < 0 or j0 < 0
// has no walk.
//
// What bounds it on this card: bytes, and the widest job's walk.  It reads
// sum_b (i0 + j0 + 1) op bytes (twice: a count pass and a write pass, the
// second mostly from the L2), 16 bytes of fin and start and writes 12 bytes
// of off and len a job, and 4 bytes a run: a few MB a call, microseconds at
// 3.35 TB/s.  A warp walks one job, so a call takes at least its widest
// job's walk: a 200,000-diagonal row is about 100 steps of 2,048 slots.
//
// Design: three launches on the call's stream.  rle_pass<false> counts each
// job's runs: a warp a job, eight a block; lane l takes slots 16l ... 16l +
// 15 of a 512-slot chunk with one 16-byte load, four chunks' loads in
// flight, and walks its 16 bytes from the top, counting its kept ops and the
// op changes among them.  Whether the lane's first kept op starts a run
// depends on the last kept op before it in walk order: that of the nearest
// lane above holding one (ballot and shuffle), or the one carried from the
// chunk before.  rle_scan, one block, turns the counts into off.
// rle_pass<true> walks again; each run start writes the run before it,
// whose length is the difference of the two runs' first kept ordinals: the
// lane's ordinals come from a suffix sum of the lanes' kept counts, and the
// run before a lane's first start is the last start of the nearest lane
// above with one, or the run carried open from the chunk before.  The open
// run and the remainder runs are written after the walk.  Nothing is staged
// in shared memory: each byte is read once a pass, by one lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // jobs a block
constexpr int kChunk = 512;    // slots a warp step, 16 a lane
constexpr int kInFlight = 4;   // chunks whose loads are issued together
constexpr int kScanThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIdle = 255u;  // an idle slot, or no op yet

// the op bytes of slots s0 ... s0 + 15 of a row (s0 >= 0), as read: those
// past `top` are loaded with the rest (vec) or left idle
__device__ __forceinline__ uint4 load16(const uint8_t* row, int64_t s0,
                                        int64_t top, bool vec) {
  if (s0 > top) return make_uint4(kFull, kFull, kFull, kFull);
  if (vec) return *reinterpret_cast<const uint4*>(row + s0);
  unsigned w[4] = {kFull, kFull, kFull, kFull};
  for (int k = 0; k < 16 && s0 + k <= top; ++k)
    w[k >> 2] = (w[k >> 2] & ~(255u << 8 * (k & 3))) |
                (unsigned)row[s0 + k] << 8 * (k & 3);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned byte_at(const uint4& v, int k) {
  const unsigned w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return w >> 8 * (k & 3) & 255u;
}

// the walk so far, the same in every lane of the job's warp
struct Carry {
  unsigned last;     // the last kept op (kIdle: none yet)
  int64_t kept;      // kept ops
  int64_t runs;      // runs started
  int64_t open;      // the open run's first kept ordinal (write pass)
};

// run k of a job whose cnt runs start at blob[base], in the output's order
__device__ __forceinline__ void emit(uint32_t* blob, int64_t cap,
                                     int64_t base, int64_t cnt, bool rev,
                                     int64_t k, unsigned op, uint64_t len) {
  const int64_t at = base + (rev ? k : cnt - 1 - k);
  if (k < cnt && at < cap) blob[at] = (uint32_t)len << 4 | op;
}

// one chunk: lane holds slots s0 ... s0 + 15 in v
template <bool kWrite>
__device__ __forceinline__ void step(const uint4& v, int64_t s0, int64_t top,
                                     int lane, Carry& c, uint32_t* blob,
                                     int64_t cap, int64_t base, int64_t cnt,
                                     bool rev) {
  // the lane's kept ops from the top: how many, the first and the last,
  // and the op changes among them (the last one's kept index)
  unsigned first = kIdle, prev = kIdle;
  int n = 0, inner = 0, inner_at = 0;
#pragma unroll
  for (int k = 15; k >= 0; --k) {
    const unsigned op = s0 + k <= top ? byte_at(v, k) : kIdle;
    if (op == kIdle) continue;
    if (prev == kIdle) {
      first = op;
    } else if (op != prev) {
      ++inner;
      inner_at = n;
    }
    prev = op;
    ++n;
  }
  // the last kept op before this lane's in walk order: the nearest lane
  // above with one, or the chunk before
  const unsigned above = ~((2u << lane) - 1u);
  const unsigned has = __ballot_sync(kFull, n > 0);
  const unsigned up = has & above;
  const unsigned g = __shfl_sync(kFull, prev, up ? __ffs(up) - 1 : lane);
  const unsigned before = up ? g : c.last;
  const int starts = n ? inner + (first != before) : 0;
  // suffix sums over this lane and the lanes above it
  int sn = n, ss = starts;
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_down_sync(kFull, sn, d);
    const int b = __shfl_down_sync(kFull, ss, d);
    if (lane + d < 32) sn += a, ss += b;
  }
  if (kWrite) {
    const int64_t ord0 = c.kept + sn - n;  // this lane's first kept ordinal
    int64_t run = c.runs + ss - starts;    // its first start's run index
    // the lane's last run start (its first kept ordinal), for lanes below
    const int64_t last_start = inner ? ord0 + inner_at : starts ? ord0 : -1;
    const unsigned hs = __ballot_sync(kFull, starts > 0);
    const unsigned hs_up = hs & above;
    const int64_t p = __shfl_sync(kFull, last_start,
                                  hs_up ? __ffs(hs_up) - 1 : lane);
    // the open run before this lane's first start: its first kept ordinal
    // and op (the last kept op before the lane is the open run's op)
    int64_t po = hs_up ? p : c.open;
    unsigned pop = before;
    int64_t ord = ord0;
#pragma unroll
    for (int k = 15; k >= 0; --k) {
      const unsigned op = s0 + k <= top ? byte_at(v, k) : kIdle;
      if (op == kIdle) continue;
      if (op != pop) {
        if (run > 0)
          emit(blob, cap, base, cnt, rev, run - 1, pop, (uint64_t)(ord - po));
        po = ord;
        pop = op;
        ++run;
      }
      ++ord;
    }
    if (hs) c.open = __shfl_sync(kFull, last_start, __ffs(hs) - 1);
  }
  if (has) c.last = __shfl_sync(kFull, prev, __ffs(has) - 1);
  c.kept += __shfl_sync(kFull, sn, 0);
  c.runs += __shfl_sync(kFull, ss, 0);
}

// kWrite false: len[b] = job b's run count; true: its runs at off[b]
template <bool kWrite>
__global__ void __launch_bounds__(kWarps * 32) rle_pass(
    const uint8_t* __restrict__ ops, int64_t n_ops, int B,
    const int32_t* __restrict__ fin, const int32_t* __restrict__ start,
    int rev, int min_intron, uint32_t* __restrict__ blob, int64_t cap,
    const int64_t* __restrict__ off, int32_t* __restrict__ len) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int i0 = start[2 * b], j0 = start[2 * b + 1];
  int64_t top = i0 >= 0 && j0 >= 0 ? (int64_t)i0 + j0 : -1;
  if (top > n_ops - 1) top = n_ops - 1;
  const uint8_t* row = ops + (int64_t)b * n_ops;
  const bool vec = (n_ops & 15) == 0 && ((uintptr_t)ops & 15) == 0;
  const int64_t base = kWrite ? off[b] : 0;
  const int64_t cnt = kWrite ? len[b] : 0;
  Carry c{kIdle, 0, 0, 0};
  for (int64_t ch = top >= 0 ? top / kChunk : -1; ch >= 0; ch -= kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)  // no load below the row's start
      v[u] = ch >= u ? load16(row, (ch - u) * kChunk + 16 * lane, top, vec)
                     : make_uint4(kFull, kFull, kFull, kFull);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (ch >= u)
        step<kWrite>(v[u], (ch - u) * kChunk + 16 * lane, top, lane, c,
                     blob, cap, base, cnt, rev != 0);
  }
  // the remainder runs; the open run's op is the last kept op
  int64_t runs = c.runs;
  unsigned op_open = c.last;
  uint64_t len_open = (uint64_t)(c.kept - c.open);
  const int fi = fin[2 * b], fj = fin[2 * b + 1];
  auto push = [&](unsigned op, uint64_t n) {
    if (runs > 0 && op_open == op) {
      len_open += n;
      return;
    }
    if (kWrite && runs > 0 && lane == 0)
      emit(blob, cap, base, cnt, rev != 0, runs - 1, op_open, len_open);
    op_open = op;
    len_open = n;
    ++runs;
  };
  if (fi >= 0) push(min_intron > 0 && fi >= min_intron ? 3u : 2u,
                    (uint64_t)fi + 1);
  if (fj >= 0) push(1u, (uint64_t)fj + 1);
  if (lane != 0) return;
  if (!kWrite)
    len[b] = (int32_t)runs;
  else if (runs > 0)
    emit(blob, cap, base, cnt, rev != 0, runs - 1, op_open, len_open);
}

// off = the exclusive prefix sums of len
__global__ void __launch_bounds__(kScanThreads) rle_scan(
    const int32_t* __restrict__ len, int B, int64_t* __restrict__ off) {
  __shared__ int64_t warp_sum[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31;
  const int per = (B + kScanThreads - 1) / kScanThreads;
  const int lo = t * per < B ? t * per : B;
  const int hi = lo + per < B ? lo + per : B;
  int64_t s = 0;
  for (int k = lo; k < hi; ++k) s += len[k];
  int64_t inc = s;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t a = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += a;
  }
  if (lane == 31) warp_sum[t >> 5] = inc;
  __syncthreads();
  int64_t run = inc - s;
  for (int w = 0; w < t >> 5; ++w) run += warp_sum[w];
  for (int k = lo; k < hi; ++k) {
    off[k] = run;
    run += len[k];
  }
}

}  // namespace

extern "C" int wm_cigar_rle_launch(const void* ops, int64_t n_ops, int B,
                                   const void* fin, const void* start,
                                   int rev, int min_intron, void* blob,
                                   int64_t cap, void* off, void* len,
                                   void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int grid = (B + kWarps - 1) / kWarps;
  const uint8_t* o = (const uint8_t*)ops;
  const int32_t* f = (const int32_t*)fin;
  const int32_t* s = (const int32_t*)start;
  uint32_t* bl = (uint32_t*)blob;
  int64_t* of = (int64_t*)off;
  int32_t* ln = (int32_t*)len;
  rle_pass<false><<<grid, kWarps * 32, 0, st>>>(o, n_ops, B, f, s, rev,
                                                min_intron, bl, cap, of, ln);
  rle_scan<<<1, kScanThreads, 0, st>>>(ln, B, of);
  rle_pass<true><<<grid, kWarps * 32, 0, st>>>(o, n_ops, B, f, s, rev,
                                               min_intron, bl, cap, of, ln);
  return (int)cudaGetLastError();
}
