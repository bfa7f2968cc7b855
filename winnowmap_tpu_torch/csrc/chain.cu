// C1: the chain DP's forward pass, one warp per chain job.
//
// Replaces the device function _compiled_chain_fwd
// (winnowmap_tpu/chain/device.py:54, a jax.jit fori_loop, not Pallas).
// Semantics are the scalar oracle's (native/src/wm_chain.cpp wm_chain_dp,
// :42-111, reference src/chain.c:22-167) for one segment: for each anchor
// i, walk j = i-1 down to the window start st[i] (the host's
// _window_starts: the max_dist_x advance and Winnowmap's min_dist_x rule
// inside repeats), score each passing predecessor with the f64 gap cost,
// keep the strict running max seeded with the anchor's q_span, and stop
// where the max_skip counter passes max_skip.  The counter falls by one
// (floored at 0) on a new max and rises on a scanned predecessor that an
// earlier scanned one points at (the oracle's t[] marks).  Outputs f, pre
// and v; the host's wm_chain_finish (native.chain_finish) does the rest.
//
// What bounds it on this card: latency.  Anchor i needs f, pre and v of
// the anchors before it, so a job is a chain of dependent steps, each a
// few global loads, a window tile and the warp's scans.  A window walk
// breaks after about max_skip + 1 scanned predecessors on a colinear
// chain, so most anchors take one tile of 32.  The bytes and operations
// are few (PERF.md counts the oracle's candidates).
//
// Design: a warp per job, jobs in parallel across warps.  For anchor i the
// warp takes the window in tiles of 32 predecessors, lane l on
// j = base - l.  Each lane scores its candidate, then writes the marks:
// t[pre[j]] = i for each passing j, in global scratch as the oracle does
// (a stamp per anchor, so no clearing).  A mark always lands on a later
// lane than the one that wrote it (pre[j] < j), so after __syncwarp a
// lane's t[j] == i holds exactly when an earlier scanned predecessor
// marked it; marks written past the break land past it too and are never
// read under stamp i.  The tile's running max is a prefix max over the
// lanes seeded with the carried max, the skip counter a prefix sum with
// its floor at 0 taken by a prefix min, P - min(0, min P), from the
// carried count; the first lane past max_skip ends the walk (the lanes
// before it are the oracle's scanned ones; the crossing lane is never a
// new max).  The new max is the last lane that beat its prefix.
//
// Floating point: (int)(dd * .01 * avg_qspan) and
// (int)(gap * gap_scale + .499) round each operation as the oracle's C
// doubles do: __dmul_rn/__dadd_rn keep nvcc from fusing the
// multiply-add, which g++ on x86-64 does not fuse.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // jobs a block
constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
    chain_fwd_kernel(const int32_t* __restrict__ xs,
                     const int32_t* __restrict__ ys,
                     const int32_t* __restrict__ spans,
                     const int32_t* __restrict__ sts,
                     const int64_t* __restrict__ offs,
                     const double* __restrict__ avgq, int n_jobs,
                     int max_dist_x, int max_dist_y, int bw, int max_skip,
                     int is_cdna, double gap_scale, int32_t* f, int32_t* pre,
                     int32_t* v, int32_t* t) {
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (job >= n_jobs) return;  // the whole warp leaves together
  const int64_t o = offs[job];
  const int n = (int)(offs[job + 1] - o);
  const int32_t* x = xs + o;
  const int32_t* y = ys + o;
  const int32_t* span = spans + o;
  const int32_t* st = sts + o;
  f += o;
  pre += o;
  v += o;
  t += o;
  const double aq = avgq[job];
  for (int j = lane; j < n; j += 32) t[j] = -1;
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const int xi = x[i], yi = y[i], q_span = span[i], lo = st[i];
    int max_f = q_span, max_j = -1, n_skip = 0;
    for (int base = i - 1; base >= lo; base -= 32) {
      const int j = base - lane;
      bool ok = false;
      int sc = kNeg;
      if (j >= lo) {
        // the low 32 bits, as the oracle's window keeps dr in [0,
        // max_dist_x] and dq is an int32 difference
        const int dr = (int)((unsigned)xi - (unsigned)x[j]);
        const int dq = (int)((unsigned)yi - (unsigned)y[j]);
        const int dd = (int)(dr > dq ? (unsigned)dr - (unsigned)dq
                                     : (unsigned)dq - (unsigned)dr);
        ok = dr != 0 && dq > 0 && dq <= max_dist_y && dq <= max_dist_x &&
             dd <= bw;
        if (ok) {
          const int min_d = dq < dr ? dq : dr;
          sc = min_d > q_span ? q_span : min_d;
          const int log_dd = dd ? 31 - __clz(dd) : 0;
          const int c_lin =
              (int)__dmul_rn(__dmul_rn((double)dd, .01), aq);
          int gap;
          if (is_cdna && dr > dq)
            gap = c_lin < log_dd ? c_lin : log_dd;
          else
            gap = c_lin + (log_dd >> 1);
          sc -= (int)__dadd_rn(__dmul_rn((double)gap, gap_scale), .499);
          sc += f[j];
          const int pj = pre[j];
          if (pj >= 0) t[pj] = i;
        }
      }
      __syncwarp();
      const bool marked = ok && t[j] == i;
      // prefix max of the passing scores, seeded with the carried max
      int run = sc;
      for (int d = 1; d < 32; d <<= 1) {
        const int r = __shfl_up_sync(kFull, run, d);
        if (lane >= d && r > run) run = r;
      }
      int excl = __shfl_up_sync(kFull, run, 1);
      if (lane == 0 || excl < max_f) excl = max_f;
      const bool better = ok && sc > excl;
      // skip counter: P = carried + prefix sum, floored by its prefix min
      int p = better ? -1 : (marked ? 1 : 0);
      for (int d = 1; d < 32; d <<= 1) {
        const int r = __shfl_up_sync(kFull, p, d);
        if (lane >= d) p += r;
      }
      p += n_skip;
      int m = p;
      for (int d = 1; d < 32; d <<= 1) {
        const int r = __shfl_up_sync(kFull, m, d);
        if (lane >= d && r < m) m = r;
      }
      const int s = p - (m < 0 ? m : 0);
      const unsigned crossed = __ballot_sync(kFull, s > max_skip);
      const unsigned alive =
          crossed ? (1u << (__ffs((int)crossed) - 1)) - 1u : kFull;
      const unsigned bm = __ballot_sync(kFull, better) & alive;
      if (bm) {
        const int lb = 31 - __clz((int)bm);
        max_f = __shfl_sync(kFull, sc, lb);
        max_j = base - lb;
      }
      if (crossed) break;
      n_skip = __shfl_sync(kFull, s, 31);
    }
    if (lane == 0) {
      f[i] = max_f;
      pre[i] = max_j;
      int vi = max_f;
      if (max_j >= 0 && v[max_j] > max_f) vi = v[max_j];
      v[i] = vi;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int wm_chain_fwd_launch(const void* x, const void* y,
                                   const void* span, const void* st,
                                   const void* off, const void* avgq,
                                   int n_jobs, int max_dist_x, int max_dist_y,
                                   int bw, int max_skip, int is_cdna,
                                   double gap_scale, void* f, void* pre,
                                   void* v, void* t, void* stream) {
  if (n_jobs <= 0) return 0;
  chain_fwd_kernel<<<(n_jobs + kWarps - 1) / kWarps, kWarps * 32, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)span,
      (const int32_t*)st, (const int64_t*)off, (const double*)avgq, n_jobs,
      max_dist_x, max_dist_y, bw, max_skip, is_cdna, gap_scale, (int32_t*)f,
      (int32_t*)pre, (int32_t*)v, (int32_t*)t);
  return (int)cudaGetLastError();
}
