// K2: traceback over K1's, K3's or K4's banded direction bytes, one warp
// per job.
//
// Replaces the TPU kernel _compiled_traceback
// (winnowmap_tpu/extend/pallas_kernel.py:1075, pallas_call at :1206), in
// both its forms: min_intron == 0 (extd, extz) and min_intron > 0 (the
// spliced exts traceback).  Semantics are ksw_backtrack's (reference
// src/ksw2.h:119-151, is_rot=1) as wm_ksw.cpp's traceback_intron encodes
// them: from (i0, j0) walk descending anti-diagonals r = i + j, clamp the
// state outside the row's rounded band [st, en] (force D left of it, I
// right of it), run the s1/s2/s3 state machine on the direction byte and
// emit one op per visited diagonal: 0 = M (i-1, j-1), 1 = I (j-1), 2 = D
// (i-1), and with min_intron > 0, 3 = N (i-1) for the long-gap state 3.
// K3's jobs carry w = qlen + tlen, so the same band formulas give its
// unbanded rows.
//
// Output: ops[b * ops_stride + r] = op for each visited r (the caller fills
// the row with 255 first), fin[b] = the (i, j) left when the walk stops;
// R1 (csrc/cigar.cu) turns the walk plus the remainder runs into the CIGAR
// on the card.
//
// What bounds it on this card: latency.  Each step needs the direction
// byte of the step before, and consecutive steps lie in consecutive
// anti-diagonal rows, ncol bytes apart (about min(qlen, tlen) for K3's
// unbanded jobs): a walk that loads its bytes one at a time pays one
// device-memory latency a step.  The bytes moved are tiny.
//
// Design: a warp per job, kWarps jobs a block.  The warp walks by windows
// of 32 anti-diagonals.  From the current (i, r), a path through rows r-1
// ... r-31 reaches in row r-k only lanes i-k ... i (a step moves down one or
// two rows and i down at most one), so lane k of the warp loads row r-k's
// bytes [i-k-st(r-k), i-st(r-k)], clipped to [0, ncol): at most 32 bytes,
// in up to three aligned 16-byte loads issued by all lanes at once, into
// the warp's tile in shared memory.  Then every lane walks the tile in step
// (the state is the same in all lanes; lane 0 writes the ops) at
// shared-memory latency until the path leaves the window, and the warp
// reloads: one memory latency a window of 16-32 steps in place of one a
// step (windows of 64 rows, two a lane, ran 10% slower on the H100).  The load also keeps each window row's band [st, en] and tile
// origin, so a step's chain is two shared loads and the state machine.
// The forced states outside the rounded band need no byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // jobs a block
constexpr int kWin = 32;   // anti-diagonals a window, one a lane
constexpr int kTile = 48;  // bytes a window row: 32 and the 16-byte rounding

struct Band {
  int qlen, tlen, w;
  // the rounded band [st, en] of row r (ksw_extd2_sse's st, en)
  __device__ __forceinline__ void at(int r, int& st, int& en) const {
    st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
    if (en > (r + w) >> 1) en = (r + w) >> 1;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;
  }
};

__global__ void __launch_bounds__(kWarps * 32) traceback_kernel(
    const uint8_t* __restrict__ dirs, const int64_t* __restrict__ dirs_off,
    const int64_t* __restrict__ jobs, const int32_t* __restrict__ start,
    int B, uint8_t* __restrict__ ops, int64_t ops_stride,
    int32_t* __restrict__ fin, int min_intron) {
  __shared__ __align__(16) uint8_t tiles[kWarps][kWin][kTile];
  // per window row: its rounded band [st, en] and the lane of its tile's
  // first byte
  __shared__ int4 rows[kWarps][kWin];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + wid;
  if (b >= B) return;  // whole warps leave together
  uint8_t(*tile)[kTile] = tiles[wid];
  int4* row = rows[wid];
  const int64_t* jb = jobs + (int64_t)b * 8;
  const Band band{(int)jb[1], (int)jb[4], (int)jb[6]};
  const int mn = band.qlen < band.tlen ? band.qlen : band.tlen;
  const int ncol = (((mn < band.w + 1 ? mn : band.w + 1) + 15) / 16 + 1) * 16;
  const uint8_t* p = dirs + dirs_off[b];
  uint8_t* orow = ops + (int64_t)b * ops_stride;
  int i = start[2 * b], j = start[2 * b + 1], state = 0;
  int r0 = 1 << 30;  // the window: rows r0 ... r0 - 31 (none yet)
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    if (r0 - r >= kWin) {
      // load the window: lane k takes row r - k, lanes i - k ... i
      __syncwarp();  // every lane is done with the last window
      r0 = r;
      const int rr = r - lane;
      int st = 0, en = -1, lo = 0;
      if (rr >= 0) {
        band.at(rr, st, en);
        int hi = i - st;
        lo = i - lane - st;
        if (lo < 0) lo = 0;
        if (hi > ncol - 1) hi = ncol - 1;
        lo &= ~15;
        const uint4* src = (const uint4*)(p + (int64_t)rr * ncol + lo);
        uint4* dst = (uint4*)tile[lane];
        for (int m = 0; m < kTile / 16; ++m)
          if (lo + 16 * m <= hi) dst[m] = src[m];
      }
      row[lane] = make_int4(st, en, st + lo, 0);
      __syncwarp();
    }
    const int k = r0 - r;
    const int4 g = row[k];
    // outside the rounded band the state is forced and needs no byte
    const bool forced = i < g.x || i > g.y;
    const unsigned d = forced ? 0u : tile[k][i - g.z];
    if (state == 0)
      state = d & 7;
    else if (!(d >> (state + 2) & 1))
      state = 0;
    if (state == 0) state = d & 7;
    if (i < g.x) state = 2;
    if (i > g.y) state = 1;
    int op;
    if (state == 0) {
      op = 0;
      --i, --j;
    } else if (state == 1 || state == 3) {
      op = state == 3 && min_intron > 0 ? 3 : 2;
      --i;
    } else {
      op = 1;
      --j;
    }
    if (lane == 0) orow[r] = (uint8_t)op;
  }
  if (lane == 0) {
    fin[2 * b] = i;
    fin[2 * b + 1] = j;
  }
}

}  // namespace

extern "C" int wm_traceback_launch(const void* dirs, const void* dirs_off,
                                   const void* jobs, const void* start, int B,
                                   void* ops, int64_t ops_stride, void* fin,
                                   int min_intron, void* stream) {
  if (B <= 0) return 0;
  traceback_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int64_t*)dirs_off, (const int64_t*)jobs,
      (const int32_t*)start, B, (uint8_t*)ops, ops_stride, (int32_t*)fin,
      min_intron);
  return (int)cudaGetLastError();
}
