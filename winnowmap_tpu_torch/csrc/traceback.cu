// K2: traceback over K1's or K3's banded direction bytes, one thread per
// job.
//
// Replaces the TPU kernel _compiled_traceback
// (winnowmap_tpu/extend/pallas_kernel.py:1075, pallas_call at :1206), in
// both its forms: min_intron == 0 (extd) and min_intron > 0 (the spliced
// exts traceback).  Semantics are ksw_backtrack's (reference
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
// the host turns the walk plus the remainder runs into a CIGAR
// (native wm_rle_ops).
//
// What bounds it on this card: latency.  Each step is one dependent byte
// load from the direction buffer (usually an L2 or device-memory miss), so
// a job's walk costs its path length times one load latency; jobs walk in
// parallel, one per thread.  The bytes moved are tiny (one direction byte
// and one op byte per step).  The design keeps the walk in registers and
// touches nothing else; the row geometry is recomputed from (qlen, tlen, w)
// instead of being stored.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void traceback_kernel(const uint8_t* __restrict__ dirs,
                                 const int64_t* __restrict__ dirs_off,
                                 const int64_t* __restrict__ jobs,
                                 const int32_t* __restrict__ start, int B,
                                 uint8_t* __restrict__ ops, int64_t ops_stride,
                                 int32_t* __restrict__ fin, int min_intron) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* jb = jobs + (int64_t)b * 8;
  const int qlen = (int)jb[1], tlen = (int)jb[4], w = (int)jb[6];
  const int mn = qlen < tlen ? qlen : tlen;
  const int64_t ncol = (((mn < w + 1 ? mn : w + 1) + 15) / 16 + 1) * 16;
  const uint8_t* p = dirs + dirs_off[b];
  uint8_t* orow = ops + (int64_t)b * ops_stride;
  int i = start[2 * b], j = start[2 * b + 1], state = 0;
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
    if (en > (r + w) >> 1) en = (r + w) >> 1;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;
    int force_state = -1;
    if (i < st) force_state = 2;
    if (i > en) force_state = 1;
    const unsigned d =
        force_state < 0 ? p[(int64_t)r * ncol + (i - st)] : 0u;
    if (state == 0)
      state = d & 7;
    else if (!(d >> (state + 2) & 1))
      state = 0;
    if (state == 0) state = d & 7;
    if (force_state >= 0) state = force_state;
    if (state == 0) {
      orow[r] = 0;
      --i, --j;
    } else if (state == 1 || state == 3) {
      orow[r] = state == 3 && min_intron > 0 ? 3 : 2;
      --i;
    } else {
      orow[r] = 1;
      --j;
    }
  }
  fin[2 * b] = i;
  fin[2 * b + 1] = j;
}

extern "C" int wm_traceback_launch(const void* dirs, const void* dirs_off,
                                   const void* jobs, const void* start, int B,
                                   void* ops, int64_t ops_stride, void* fin,
                                   int min_intron, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, (const int64_t*)dirs_off, (const int64_t*)jobs,
      (const int32_t*)start, B, (uint8_t*)ops, ops_stride, (int32_t*)fin,
      min_intron);
  return (int)cudaGetLastError();
}
