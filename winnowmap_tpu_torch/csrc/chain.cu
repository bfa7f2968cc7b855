// C1: the chain DP's forward pass, one block per chain job.
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
// the anchor before it, so a job is a chain of dependent steps, walked by
// one warp, alone on its SM's scheduler: each instruction on that warp's
// path costs its latency.  A window walk breaks after about max_skip + 1
// scanned predecessors on a colinear chain, so most anchors take one step.
// The bytes and operations are few (PERF.md counts the oracle's
// candidates): the time is the instructions on the walking warp, and the
// design takes off it everything that does not need the anchors before.
//
// Design: a block of three warps per job.
//   * Two producer warps score each anchor's first step ahead of the walk:
//     the 64 nearest predecessors, lane l taking positions 2l (slot a) and
//     2l + 1 (slot b), j = i - 1 - position: the distance tests and the
//     score without f[j] (the f64 gap cost), from the inputs in global
//     memory.  They write them to a ring of kGaps anchors in shared memory
//     and publish their progress; the walking warp publishes its own, so
//     a producer waits for a free slot and the walker for a scored anchor
//     (a block fence between data and counter; the walker's load of it an
//     acquire, as a fence there would wait for its own global stores).
//   * The walking warp keeps its last kRing anchors' f, pre, v and the t
//     marks' stamps in shared memory (16 B an anchor: 16 KiB at 1024, 21
//     KiB a block with the scores); a predecessor further back than
//     kReach is read from global memory, where the walker writes f, pre, v
//     and far marks too: one walk with two address cases, so any window
//     width stays exact.
//   * While anchor i is walked, the walker prepares anchor i + 1's first
//     step: f and pre of its candidates (all anchors up to i - 1; position
//     0, anchor i, is taken from registers when i is done), the best score
//     over positions >= 2 (__reduce_max_sync), the in-step marks
//     (t[pre[j]] = i + 1 lands on position i - pre[j]: __reduce_or_sync of
//     the positions' bits).  The two prepared steps swap roles anchor by
//     anchor, so nothing is copied.
//   * The fast case is what is left on the path: no position >= 2 beats
//     the running max after positions 0 and 1, so a new max can only be
//     one of those two and the counter only rises after them; position
//     p's counter is then the marked passing positions up to p
//     (popcounts), and one ballot finds the first past max_skip.
//   * Otherwise, and for steps past the first (positions 64 on, scored on
//     the walk), the general step: marks as stamps (t[pre[j]] = i, a stamp
//     per anchor, so no clearing; a mark always lands on a later position
//     than the one that wrote it, so after __syncwarp t[j] == i holds
//     exactly when an earlier scanned predecessor marked it, and marks
//     written past the break land past it too); the running max as a
//     prefix max over the lanes (a lane's two positions in order) seeded
//     with the carried max; the skip counter x -> max(0, x + d) (d = -1 on
//     a new max, +1 on a marked predecessor) as one scan over pairs (A, B),
//     x -> max(A, x + B); the first position past
//     max_skip ends the walk (it is never a new max); the new max is the
//     last position before it that beat its prefix.  A step where no score
//     beats the carried max takes the fast case's popcounts.
//
// Floating point: (int)(dd * .01 * avg_qspan) and
// (int)(gap * gap_scale + .499) round each operation as the oracle's C
// doubles do: __dmul_rn/__dadd_rn keep nvcc from fusing the
// multiply-add, which g++ on x86-64 does not fuse.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kProducers = 2;
constexpr int kThreads = 32 * (1 + kProducers);  // a job a block
constexpr int kRing = 1024;   // anchors the walker keeps in shared memory
constexpr int kReach = kRing - 1;
constexpr int kGaps = 16;     // anchors scored ahead
constexpr int kNeg = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
static_assert((kRing & (kRing - 1)) == 0, "a power of two");

// An anchor's first step as the producers score it
struct Scored {
  int sa[32], sb[32];  // scores without f, by lane and slot
  int4 in;             // the anchor's x, y, q_span and window start
  uint2 ok;            // the passing lanes of slot a and of slot b
};

struct Shared {
  int f[kRing], pre[kRing], v[kRing], t[kRing];
  Scored g[kGaps];
  int prog[kProducers];  // the last anchor each producer has scored
  int done;              // the last anchor the walker has finished
};

struct Job {
  const int32_t *x, *y, *span, *st;
  int32_t *f, *pre, *v, *t;
  int n;
  double aq;
};

struct Par {
  int max_dist_x, max_dist_y, bw, max_skip, is_cdna;
  double gap_scale;
};

__device__ __forceinline__ int vload(const int* p) {
  return *(const volatile int*)p;
}
// an acquire load of a progress counter: the loads after it see what the
// producer wrote before publishing (no fence, which would also wait for
// the walker's own global stores)
__device__ __forceinline__ int load_acquire(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return vload(p);
#endif
}
__device__ __forceinline__ void vstore(int* p, int v) {
  *(volatile int*)p = v;
}

// Where anchor j's field lives: its ring slot when near, else the global
// array (a generic pointer, so a load needs no branch)
__device__ __forceinline__ int* at(int* ring, int32_t* glob, int j,
                                   bool near) {
  return near ? ring + (j & (kRing - 1)) : glob + j;
}

// A candidate j of anchor i (xi, yi, its q_span and window start lo):
// whether it passes the distance tests and its score without f[j]
struct Gap {
  bool ok;
  int sb;
};

__device__ __forceinline__ Gap gap_score(const Job& jb, const Par& p,
                                         int xi, int yi, int q_span, int lo,
                                         int j) {
  Gap g;
  const bool inwin = j >= lo;
  const int xj = inwin ? jb.x[j] : xi;
  const int yj = inwin ? jb.y[j] : yi;
  // the low 32 bits, as the oracle's window keeps dr in [0, max_dist_x]
  // and dq is an int32 difference
  const int dr = (int)((unsigned)xi - (unsigned)xj);
  const int dq = (int)((unsigned)yi - (unsigned)yj);
  const int dd0 = (int)(dr > dq ? (unsigned)dr - (unsigned)dq
                                : (unsigned)dq - (unsigned)dr);
  g.ok = inwin && dr != 0 && dq > 0 && dq <= p.max_dist_y &&
         dq <= p.max_dist_x && dd0 <= p.bw;
  const int dd = g.ok ? dd0 : 0;  // keeps the conversions in range
  const int min_d = dq < dr ? dq : dr;
  const int log_dd = dd ? 31 - __clz(dd) : 0;
  const int c_lin = (int)__dmul_rn(__dmul_rn((double)dd, .01), jb.aq);
  const int gap = p.is_cdna && dr > dq ? (c_lin < log_dd ? c_lin : log_dd)
                                       : c_lin + (log_dd >> 1);
  g.sb = (min_d > q_span ? q_span : min_d) -
         (int)__dadd_rn(__dmul_rn((double)gap, p.gap_scale), .499);
  return g;
}

// f[j] and pre[j] (j < 0: a ring slot, never used)
__device__ __forceinline__ void load_fp(Shared& sh, const Job& jb, int i,
                                        int j, int& fj, int& pj) {
  const bool near = i - j <= kReach || j < 0;
  fj = *at(sh.f, jb.f, j, near);
  pj = *at(sh.pre, jb.pre, j, near);
}

// t[pj] = i, in the ring or in global memory by i - pj
__device__ __forceinline__ void mark(Shared& sh, const Job& jb, int i,
                                     int pj) {
  *at(sh.t, jb.t, pj, i - pj <= kReach) = i;
}

// The skip counter after a run of positions is x -> max(A, x + B) of the
// counter x before it; (A1, B1) then (A2, B2) is (max(A2, A1 + B2),
// B1 + B2), and (-1, 0) is the identity for x >= 0.

__device__ __forceinline__ unsigned lanes_below(int k) {
  return k >= 32 ? kFull : (1u << k) - 1u;
}

// A step where no candidate beats the carried max: the skip counter only
// rises, by the marked positions (bit l of ma: position 2l, of mb: 2l + 1).
// Returns whether it passed max_skip (n_skip carried on if not).
__device__ __forceinline__ bool step_no_max(int lane, unsigned ma,
                                            unsigned mb, int max_skip,
                                            int& n_skip) {
  const unsigned up = (2u << lane) - 1u, below = (1u << lane) - 1u;
  const int e = n_skip + __popc(ma & up);
  const bool cr = __ballot_sync(kFull, e + __popc(mb & below) > max_skip ||
                                           e + __popc(mb & up) > max_skip) !=
                  0;
  if (!cr) n_skip += __popc(ma) + __popc(mb);
  return cr;
}

// The general step (see above).  sa, sb: the lane's scores (kNeg where
// not passing); ka, kb: marked.  Returns whether the walk broke.
__device__ __forceinline__ bool step(int lane, int base, bool oka, int sa,
                                     bool ka, bool okb, int sb, bool kb,
                                     int max_skip, int& max_f, int& max_j,
                                     int& n_skip) {
  int run = sa > sb ? sa : sb;
  for (int d = 1; d < 32; d <<= 1) {
    const int r = __shfl_up_sync(kFull, run, d);
    if (lane >= d && r > run) run = r;
  }
  int excl = __shfl_up_sync(kFull, run, 1);
  if (lane == 0 || excl < max_f) excl = max_f;
  const bool ba = oka && sa > excl;
  const bool bb = okb && sb > (sa > excl ? sa : excl);
  const int da = ba ? -1 : (ka ? 1 : 0), db = bb ? -1 : (kb ? 1 : 0);
  int A = db > 0 ? db : 0, B = da + db;  // slot a, then slot b
  for (int d = 1; d < 32; d <<= 1) {
    const int ea = __shfl_up_sync(kFull, A, d);
    const int eb = __shfl_up_sync(kFull, B, d);
    if (lane >= d) {
      A = A > ea + B ? A : ea + B;
      B += eb;
    }
  }
  int xa = __shfl_up_sync(kFull, A, 1), xb = __shfl_up_sync(kFull, B, 1);
  if (lane == 0) xa = -1, xb = 0;
  const int s0 = xa > n_skip + xb ? xa : n_skip + xb;
  const int s_a = ba ? (s0 > 0 ? s0 - 1 : 0) : s0 + (ka ? 1 : 0);
  const int s_b = bb ? (s_a > 0 ? s_a - 1 : 0) : s_a + (kb ? 1 : 0);
  const unsigned ca = __ballot_sync(kFull, s_a > max_skip);
  const unsigned cb = __ballot_sync(kFull, s_b > max_skip);
  const int pa = ca ? 2 * (__ffs((int)ca) - 1) : 64;
  const int pb = cb ? 2 * (__ffs((int)cb) - 1) + 1 : 64;
  const int cpos = pa < pb ? pa : pb;
  const unsigned ma = __ballot_sync(kFull, ba) & lanes_below((cpos + 1) >> 1);
  const unsigned mb = __ballot_sync(kFull, bb) & lanes_below(cpos >> 1);
  const int la = ma ? 2 * (31 - __clz((int)ma)) : -1;
  const int lb = mb ? 2 * (31 - __clz((int)mb)) + 1 : -1;
  const int lp = la > lb ? la : lb;
  if (lp >= 0) {
    max_f = __shfl_sync(kFull, lp & 1 ? sb : sa, lp >> 1);
    max_j = base - lp;
  }
  if (cpos == 64) n_skip = __shfl_sync(kFull, s_b, 31);
  return cpos < 64;
}

// An anchor's first step on the walker: its scores, f and pre of its
// candidates, the best passing score over positions >= 2, and the in-step
// marks as bits of the even (ma) and odd (mb) positions
struct First {
  int sa, sb, fa, fb, pa, pb;
  unsigned oka, okb, ma, mb;
  int xi, yi, q_span, lo;
  int sb0, sb1, f1, best2;  // positions 0 and 1, the best past them
};

// anchor i's scores from the producers' ring (i must be scored)
__device__ __forceinline__ void take(const Shared& sh, int lane, int i,
                                     First& q) {
  const Scored& g = sh.g[i % kGaps];
  q.sa = g.sa[lane];
  q.sb = g.sb[lane];
  const uint2 ok = g.ok;
  const int4 in = g.in;
  q.oka = ok.x;
  q.okb = ok.y;
  q.xi = in.x;
  q.yi = in.y;
  q.q_span = in.z;
  q.lo = in.w;
  q.sb0 = g.sa[0];
  q.sb1 = g.sb[0];
}

__device__ __forceinline__ void reduce(First& q, int lane, int i) {
  const bool oka = q.oka >> lane & 1u, okb = q.okb >> lane & 1u;
  const bool upa = lane > 0 && oka;
  const int sa = upa ? q.sa + q.fa : kNeg;
  const int sb = okb ? q.sb + q.fb : kNeg;
  q.best2 = __reduce_max_sync(kFull, lane > 0 && sa < sb ? sb : sa);
  const int ta = i - 1 - q.pa, tb = i - 1 - q.pb;
  const bool wa = upa && q.pa >= 0 && ta < 64;
  const bool wb = okb && q.pb >= 0 && tb < 64;
  const unsigned ea = (wa && !(ta & 1) ? 1u << (ta >> 1) : 0u) |
                      (wb && !(tb & 1) ? 1u << (tb >> 1) : 0u);
  const unsigned eb = (wa && (ta & 1) ? 1u << (ta >> 1) : 0u) |
                      (wb && (tb & 1) ? 1u << (tb >> 1) : 0u);
  q.ma = __reduce_or_sync(kFull, ea);
  q.mb = __reduce_or_sync(kFull, eb);
}

// A producer warp: anchors w, w + kProducers, ... scored into the ring
__device__ void produce(Shared& sh, const Job& jb, const Par& p, int w,
                        int lane) {
  for (int i = w; i < jb.n; i += kProducers) {
    // the slot is free once the walker has read it (a warp-uniform test)
    while (__any_sync(kFull, vload(&sh.done) < i - kGaps - 1))
      __nanosleep(100);
    const int xi = jb.x[i], yi = jb.y[i], q_span = jb.span[i],
              lo = jb.st[i];
    const Gap a = gap_score(jb, p, xi, yi, q_span, lo, i - 1 - 2 * lane);
    const Gap b = gap_score(jb, p, xi, yi, q_span, lo, i - 2 - 2 * lane);
    Scored& g = sh.g[i % kGaps];
    g.sa[lane] = a.sb;
    g.sb[lane] = b.sb;
    const unsigned oka = __ballot_sync(kFull, a.ok);
    const unsigned okb = __ballot_sync(kFull, b.ok);
    if (lane == 0) {
      g.ok = make_uint2(oka, okb);
      g.in = make_int4(xi, yi, q_span, lo);
    }
    __threadfence_block();  // every lane's scores before the progress
    __syncwarp();
    if (lane == 0) vstore(&sh.prog[w], i);
  }
}

// The walking warp
__device__ void walk(Shared& sh, const Job& jb, const Par& p, int lane) {
  const int n = jb.n;
  for (int j = lane; j < n; j += 32) jb.t[j] = -1;
  // stamps: a slot's earlier anchor was marked by anchors before its new
  // one, so only the first use needs a fill
  for (int j = lane; j < kRing; j += 32) sh.t[j] = -1;
  __syncwarp();
  // until anchor a and the same producer's anchors before it are scored (a
  // warp-uniform test)
  auto wait = [&](int a) {
    while (__any_sync(kFull, load_acquire(&sh.prog[a % kProducers]) < a))
      continue;
  };
  // every 8 anchors, for the next 10: m = min(i + 9, n - 1) and m - 1 are
  // each producer's last anchor there (kProducers == 2), so every anchor up
  // to m is scored, also where the chain ends inside the 10
  static_assert(kProducers == 2, "one wait a producer");
  auto wait_ahead = [&](int i) {
    const int m = i + 9 < n ? i + 9 : n - 1;
    wait(m);
    if (m >= 1) wait(m - 1);
  };
  wait_ahead(0);
  First first_a, first_b;
  take(sh, lane, 0, first_a);
  first_a.fa = first_a.fb = first_a.pa = first_a.pb = first_a.f1 = 0;
  reduce(first_a, lane, 0);  // nothing passes at anchor 0
  int prev_f = 0, prev_j = -1, prev_v = 0;  // anchor i - 1's results
  // anchor i, its first step prepared in cur; anchor i + 1's into nxt
  auto anchor = [&](int i, const First& cur, First& nxt) {
    if ((i & 7) == 7) wait_ahead(i + 1);
    if (i + 1 < n) {
      take(sh, lane, i + 1, nxt);
      // the first step's predecessors are always in the ring
      const int ja = (i - 2 * lane) & (kRing - 1);
      const int jb_ = (i - 1 - 2 * lane) & (kRing - 1);
      nxt.fa = sh.f[ja];
      nxt.pa = sh.pre[ja];
      nxt.fb = sh.f[jb_];
      nxt.pb = sh.pre[jb_];
      nxt.f1 = sh.f[(i - 1) & (kRing - 1)];
    }
    // the first step's fast case: no position >= 2 beats the running max
    // after positions 0 and 1, so a new max can only be one of them, and
    // the counter (0 after position 0, which is never marked; 1 after
    // position 1 if it is marked and not a new max) only rises after them
    const bool ok0 = cur.oka & 1u, ok1 = cur.okb & 1u;
    const int sc0 = cur.sb0 + prev_f, sc1 = cur.sb1 + cur.f1;
    const bool better0 = ok0 && sc0 > cur.q_span;
    const int c0 = better0 ? sc0 : cur.q_span;
    const bool better1 = ok1 && sc1 > c0;
    int max_f = better1 ? sc1 : c0;
    int max_j = better1 ? i - 2 : better0 ? i - 1 : -1;
    const int d0 = i - 1 - prev_j;  // the position of position 0's mark
    const bool w0 = ok0 && prev_j >= 0 && d0 < 64;
    const unsigned ma =
        (cur.ma | (w0 && !(d0 & 1) ? 1u << (d0 >> 1) : 0u)) & cur.oka;
    const unsigned mb =
        (cur.mb | (w0 && (d0 & 1) ? 1u << (d0 >> 1) : 0u)) & cur.okb;
    const bool fast = cur.best2 <= max_f;
    int n_skip = !better1 && (mb & 1u) ? 1 : 0;
    bool crossed = step_no_max(lane, ma, mb & ~1u, p.max_skip, n_skip);
    reduce(nxt, lane, i + 1);
    const bool oka = cur.oka >> lane & 1u, okb = cur.okb >> lane & 1u;
    if (!fast) {
      max_f = cur.q_span;
      max_j = -1;
      n_skip = 0;
      const int sa = oka ? cur.sa + (lane == 0 ? prev_f : cur.fa) : kNeg;
      const int sb = okb ? cur.sb + cur.fb : kNeg;
      crossed = step(lane, i - 1, oka, sa, ma >> lane & 1u, okb, sb,
                     mb >> lane & 1u, p.max_skip, max_f, max_j, n_skip);
    }
    if (!crossed && i - 65 >= cur.lo) {
      // later steps: the first step's marks as stamps, then each step's
      const int pa0 = lane == 0 ? prev_j : cur.pa;
      if (oka && pa0 >= 0) mark(sh, jb, i, pa0);
      if (okb && cur.pb >= 0) mark(sh, jb, i, cur.pb);
      for (int base = i - 65; !crossed && base >= cur.lo; base -= 64) {
        const int ja = base - 2 * lane, jb_ = ja - 1;
        const Gap a =
            gap_score(jb, p, cur.xi, cur.yi, cur.q_span, cur.lo, ja);
        const Gap b =
            gap_score(jb, p, cur.xi, cur.yi, cur.q_span, cur.lo, jb_);
        int fa, pa, fb, pb;
        load_fp(sh, jb, i, ja, fa, pa);
        load_fp(sh, jb, i, jb_, fb, pb);
        if (a.ok && pa >= 0) mark(sh, jb, i, pa);
        if (b.ok && pb >= 0) mark(sh, jb, i, pb);
        __syncwarp();
        const bool ka = a.ok && *at(sh.t, jb.t, ja, i - ja <= kReach) == i;
        const bool kb =
            b.ok && *at(sh.t, jb.t, jb_, i - jb_ <= kReach) == i;
        const int sa = a.ok ? a.sb + fa : kNeg;
        const int sb = b.ok ? b.sb + fb : kNeg;
        if (__reduce_max_sync(kFull, sa > sb ? sa : sb) <= max_f)
          crossed = step_no_max(lane, __ballot_sync(kFull, ka),
                                __ballot_sync(kFull, kb), p.max_skip, n_skip);
        else
          crossed = step(lane, base, a.ok, sa, ka, b.ok, sb, kb, p.max_skip,
                         max_f, max_j, n_skip);
      }
    }
    // v: the best f along the chain; anchor i - 1's from registers
    int vi = max_f;
    if (max_j >= 0) {
      const int vj = max_j == i - 1
                         ? prev_v
                         : *at(sh.v, jb.v, max_j, i - max_j <= kReach);
      if (vj > max_f) vi = vj;
    }
    if (lane == 0) {
      const int si = i & (kRing - 1);
      sh.f[si] = max_f;
      sh.pre[si] = max_j;
      sh.v[si] = vi;
      jb.f[i] = max_f;
      jb.pre[i] = max_j;
      jb.v[i] = vi;
      vstore(&sh.done, i);
    }
    prev_f = max_f;
    prev_j = max_j;
    prev_v = vi;
    __syncwarp();
  };
  // two anchors a turn, the two first steps swapping roles (no copies)
  for (int i = 0; i < n; i += 2) {
    anchor(i, first_a, first_b);
    if (i + 1 < n) anchor(i + 1, first_b, first_a);
  }
}

__global__ void __launch_bounds__(kThreads)
    chain_fwd_kernel(const int32_t* __restrict__ xs,
                     const int32_t* __restrict__ ys,
                     const int32_t* __restrict__ spans,
                     const int32_t* __restrict__ sts,
                     const int64_t* __restrict__ offs,
                     const double* __restrict__ avgq, Par p, int32_t* f,
                     int32_t* pre, int32_t* v, int32_t* t) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared& sh = *(Shared*)smem;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t o = offs[blockIdx.x];
  const Job jb{xs + o,  ys + o,  spans + o, sts + o, f + o,
               pre + o, v + o,   t + o,     (int)(offs[blockIdx.x + 1] - o),
               avgq[blockIdx.x]};
  if (threadIdx.x < kProducers) sh.prog[threadIdx.x] = -1;
  if (threadIdx.x == 0) sh.done = -1;
  __syncthreads();
  if (jb.n <= 0) return;
  if (w == 0)
    walk(sh, jb, p, lane);
  else
    produce(sh, jb, p, w - 1, lane);
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
  const int smem = (int)sizeof(Shared);
  cudaFuncSetAttribute(chain_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const Par p{max_dist_x, max_dist_y, bw, max_skip, is_cdna, gap_scale};
  chain_fwd_kernel<<<n_jobs, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)span,
      (const int32_t*)st, (const int64_t*)off, (const double*)avgq, p,
      (int32_t*)f, (int32_t*)pre, (int32_t*)v, (int32_t*)t);
  return (int)cudaGetLastError();
}
