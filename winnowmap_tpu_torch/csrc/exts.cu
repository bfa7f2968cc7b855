// K3: spliced extension DP (exts) for Hopper, one block per job.
//
// Replaces the TPU kernel _build_extd_kernel(splice=...) reached through
// _compiled_exts_pallas (winnowmap_tpu/extend/pallas_kernel.py:879,
// pallas_call at :940), with its site scores _splice_sites (:57).
// Semantics are wm_exts's (native/src/wm_ksw.cpp:1705-1985, reference
// src/ksw2_exts2_sse.c), kept whole: wrapping int8 difference state u, v,
// x, y, x2 and the score row s; the 16-lane band rounding st = st0/16*16,
// en = (en0+16)/16*16-1 with its boundary values; the SSE 4-lane-strided
// row-max tie order (RowOrder); the approx-max H0 walk and its tie rule;
// z-drop with e2 = 0, and mqe/mte.  The spliced cell: no y2; x2 starts at
// -q2; the intron candidate is a2 + acceptor[t]; x2 continues while a2 -
// (z - q2) beats donor[t] (>= with right-aligned gaps) and restarts from
// donor[t]; the boundary after long_thres is 0; z is not clamped; the band
// is the whole anti-diagonal.  Results and direction bytes equal the
// scalar oracle's exactly; the direction bytes keep K1's layout, read by
// traceback.cu (row r at dirs + dirs_off[b] + r * ncol, lane t at column
// t - st).
//
// What bounds it on this card: latency.  A job is a chain of qlen+tlen-1
// dependent anti-diagonal rows, so its time is its rows times one row's
// latency; a row holds up to min(qlen, tlen) independent lanes.  Bytes
// (direction bytes written once, sequences read once) and operations
// (about 38 integer operations a live cell) are 5% of the time.  No tensor
// cores: the cell is max and select on int8, with no product.
//
// Design (each choice against a cost that K1's shared body pays per row):
//   * Ring slots owned by threads.  The band state lives in a ring of
//     `ring` lanes (a power of two >= band + 64, lane t in slot t & (ring -
//     1)); slot k * NT + tid always belongs to thread tid, which keeps the
//     slot's u, v, x, y, x2, s, its target byte, its donor and acceptor
//     scores and (exact max) its H in registers across rows.  A thread
//     computes SPT (1-4, compile time, at 256 or 512 threads) lanes of a
//     row, all independent, in place of a serial walk over ~7 lanes.
//   * One barrier a row.  The only cross-lane read of the recurrence is
//     lane t-1's old x, v, x2 (and H for the exact max's last lane): it
//     comes by __shfl_up_sync inside a warp, and at warp edges and the
//     ring's wrap from `edge`, a double-buffered array that every warp's
//     last lane fills at the end of the row.  The exact max reduces each
//     warp to one (H, rank, lane) by two warp reductions (__reduce_max_sync
//     of H, __reduce_min_sync of the SSE rank among its maxima) into the
//     same double-buffered exchange (`xch`), as do h_en, h_st and the
//     approx walk's two bytes, published by their slots' owners; after the
//     row's one __syncthreads every warp reduces the warps' maxima the same
//     way and keeps the scalar bookkeeping (z-drop, mqe/mte, the walk)
//     redundantly, so z-drop breaks at the reference's row.
//   * No global load in the cell.  The job's query is staged in shared
//     memory once (as the DP reads it, qrev applied); a query longer than
//     `qstage` bytes (kernels.K3_QSTAGE_MAX) keeps the global read.  The
//     target byte and the site scores of a lane ride in its slot, filled
//     when the slot takes the lane (at the start and when its previous
//     lane leaves the band on the left).
//   * Large bands.  A ring wider than the register variants hold (SPT = 0,
//     chosen by kernels.exts_geometry) keeps each slot's state in memory
//     (shared when it fits, else a global scratch slot per block), still
//     owned by one thread, with the same one-barrier exchange.
#include "ext_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// one ring slot's state; int8 values as the cell wraps them
struct Slot {
  int8_t u, v, x, y, x2, s, dn, ac;
  uint8_t tb;  // the lane's target byte (0 beyond tlen)
  int H;       // exact max: the lane's H
};

// the double-buffered per-row exchange: each warp's row max (H, its SSE
// rank, its lane), H at en0 and st0, the approx walk's v and u
struct Xch {
  int4 wmax[32];
  int h_en, h_st, v_walk, u_walk;
};

// the memory path's slot state: nine int8 rows and an int32 H row
constexpr int kMemBytes = 13;

__host__ __device__ constexpr int xch_bytes() {
  return (2 * (int)sizeof(Xch) + 15) / 16 * 16;
}
__host__ __device__ constexpr int edge_bytes(int ring) {
  return 2 * (ring / 32) * 8;
}

__device__ __forceinline__ int pack3(int8_t x, int8_t v, int8_t x2) {
  return (int)(uint8_t)x | (int)(uint8_t)v << 8 | (int)(uint8_t)x2 << 16;
}

// wm_exts's donor[t] and acceptor[t] (wm_ksw.cpp:1743-1803): -noncan by
// default when a splice strand is requested (0 otherwise), 0 at a canonical
// site, the flank semi-cost at a half-canonical one, plus junc_bonus (int8
// wrap) where the junction bytes (by DP target position, or null) mark a
// site.
__device__ void site_scores(const JobTarget& T, const uint8_t* junc,
                            const ExtProf& P, int t, int8_t& dn,
                            int8_t& ac) {
  const bool spl_for = P.flag & EZ_SPLICE_FOR, spl_rev = P.flag & EZ_SPLICE_REV;
  dn = ac = 0;
  if (!(spl_for || spl_rev)) return;
  const int8_t semi = (P.flag & EZ_SPLICE_FLANK) ? (int8_t)(-P.noncan / 2) : 0;
  const bool rev = P.flag & EZ_REV_CIGAR;
  // forward motifs GT..AG (and CT..AC on the reverse strand); reversed ones
  // when the target is read right to left (left extensions)
  const int d1f = 2, d1r = 1, d2 = rev ? 0 : 3;
  const int a0f = 2, a0r = 1, am1 = rev ? 3 : 0;
  dn = ac = (int8_t)(-P.noncan);
  if (t >= 0 && t < T.tlen - 4) {
    const int c1 = T.at(t + 1), c2 = T.at(t + 2), c3 = T.at(t + 3);
    int can = 0;
    if (spl_for && c1 == d1f && c2 == d2) can = 1;
    if (spl_rev && c1 == d1r && c2 == d2) can = 1;
    if (can && (rev ? (c3 == 1 || c3 == 3) : (c3 == 0 || c3 == 2))) can = 2;
    if (can) dn = can == 2 ? 0 : semi;
  }
  if (t >= 2 && t < T.tlen) {
    const int cm2 = T.at(t - 2), cm1 = T.at(t - 1), c0 = T.at(t);
    int can = 0;
    if (spl_for && cm1 == am1 && c0 == a0f) can = 1;
    if (spl_rev && cm1 == am1 && c0 == a0r) can = 1;
    if (can && (rev ? (cm2 == 0 || cm2 == 2) : (cm2 == 1 || cm2 == 3)))
      can = 2;
    if (can) ac = can == 2 ? 0 : semi;
  }
  if (junc) {
    // donor bits (for, rev) = (1, 8), acceptor (2, 4); swapped when reversed
    const int dbf = rev ? 2 : 1, dbr = rev ? 4 : 8;
    const int abf = rev ? 1 : 2, abr = rev ? 8 : 4;
    if (t >= 0 && t < T.tlen - 1) {
      const int j = junc[t + 1];
      if ((spl_for && (j & dbf)) || (spl_rev && (j & dbr)))
        dn = (int8_t)(dn + P.junc_bonus);
    }
    if (t >= 0 && t < T.tlen) {
      const int j = junc[t];
      if ((spl_for && (j & abf)) || (spl_rev && (j & abr)))
        ac = (int8_t)(ac + P.junc_bonus);
    }
  }
}

// the memory path's slot rows: u v x y x2 s dn ac tb, then H
struct SlotMem {
  uint8_t* base;
  int ring;
  __device__ __forceinline__ Slot load(int sl) const {
    const int8_t* m = (const int8_t*)base;
    Slot L;
    L.u = m[sl], L.v = m[ring + sl], L.x = m[2 * ring + sl];
    L.y = m[3 * ring + sl], L.x2 = m[4 * ring + sl], L.s = m[5 * ring + sl];
    L.dn = m[6 * ring + sl], L.ac = m[7 * ring + sl];
    L.tb = base[8 * ring + sl];
    L.H = ((const int*)(base + 9 * ring))[sl];
    return L;
  }
  __device__ __forceinline__ void store(int sl, const Slot& L) const {
    int8_t* m = (int8_t*)base;
    m[sl] = L.u, m[ring + sl] = L.v, m[2 * ring + sl] = L.x;
    m[3 * ring + sl] = L.y, m[4 * ring + sl] = L.x2, m[5 * ring + sl] = L.s;
    m[6 * ring + sl] = L.dn, m[7 * ring + sl] = L.ac;
    base[8 * ring + sl] = L.tb;
    ((int*)(base + 9 * ring))[sl] = L.H;
  }
};

// NT threads a block; SPT ring slots a thread in registers, or 0: the slot
// state in memory (shared when mem_smem, else gscratch), ring / NT slots a
// thread
template <int NT, int SPT>
__global__ void __launch_bounds__(NT, 1) exts_kernel(
    const uint8_t* __restrict__ qpool, const uint8_t* __restrict__ tpool,
    const int64_t* __restrict__ jobs, const int64_t* __restrict__ dirs_off,
    const uint8_t* __restrict__ jpool, const int64_t* __restrict__ joff,
    uint8_t* __restrict__ dirs, int32_t* __restrict__ res,
    uint8_t* __restrict__ gscratch, int ring, int qstage, int mem_smem,
    ExtProf P) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NW = NT / 32;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t* jb = jobs + (int64_t)b * 8;
  const int64_t qo = jb[0];
  const int qlen = (int)jb[1], tlen = (int)jb[4];
  const bool qrev = jb[2] != 0;
  const int zdrop = (int)jb[7];
  const JobTarget T{tpool, jb[3], tlen, jb[5] != 0};
  const uint8_t* junc = (jpool && joff[b] >= 0) ? jpool + joff[b] : nullptr;
  const bool with_cigar = !(P.flag & EZ_SCORE_ONLY);
  const bool approx_max = (P.flag & EZ_APPROX_MAX) != 0;
  const bool approx_drop = (P.flag & EZ_APPROX_DROP) != 0;
  const bool right = (P.flag & EZ_RIGHT) != 0;
  const int q = P.q, q2 = P.q2, e2 = P.e2;
  const int qe = P.q + P.e, qe2 = P.q2 + P.e2;
  const int8_t init1 = (int8_t)(-qe), init2 = (int8_t)(-qe2);
  const int8_t sc_mch = (int8_t)P.sc_mch, sc_mis = (int8_t)P.sc_mis,
               sc_n = (int8_t)P.sc_n;

  ZState zs{0, -1, -1, 0};
  int mqe = WM_NEG_INF, mqe_t = -1, mte = WM_NEG_INF, mte_q = -1;
  int score = WM_NEG_INF;

  if (!P.dead && qlen > 0 && tlen > 0) {
    Xch* xch = (Xch*)smem;
    const int nedge = ring >> 5;
    int2* edge = (int2*)(smem + xch_bytes());
    uint8_t* Qs = smem + xch_bytes() + edge_bytes(ring);
    const bool staged = qlen <= qstage;
    const SlotMem M{
        SPT > 0 ? nullptr
        : mem_smem ? Qs + qstage
                   : gscratch + (size_t)b * ring * kMemBytes,
        ring};
    const int mask = ring - 1;
    const int nk = SPT > 0 ? SPT : ring / NT;

    // a slot's initial values, for the lane `t` next in it
    auto fill = [&](Slot& L, int t) {
      L.u = L.v = L.x = L.y = init1;
      L.x2 = init2;
      L.s = 0;
      site_scores(T, junc, P, t, L.dn, L.ac);
      L.tb = t < tlen ? (uint8_t)T.at(t) : 0;
      L.H = WM_NEG_INF;
    };
    Slot reg[SPT > 0 ? SPT : 1];
    if (staged)
      for (int j = tid; j < qlen; j += NT)
        Qs[j] = qpool[qrev ? qo + qlen - 1 - j : qo + j];
#pragma unroll
    for (int k = 0; k < (SPT > 0 ? SPT : 1); ++k) {
      if constexpr (SPT > 0) fill(reg[k], k * NT + tid);
    }
    if constexpr (SPT == 0) {
      for (int k = 0; k < nk; ++k) {
        Slot L;
        fill(L, k * NT + tid);
        M.store(k * NT + tid, L);
      }
    }
    // the edges as the end of row -1 leaves them: every slot at its start
    for (int i = tid; i < nedge; i += NT)
      edge[i] = make_int2(pack3(init1, init1, init2), WM_NEG_INF);
    const int mn = qlen < tlen ? qlen : tlen;
    const int ncol = ((mn + 15) / 16 + 1) * 16;
    uint8_t* drow0 = dirs + dirs_off[b];
    int H0 = 0, last_H0_t = 0, last_st = -1, last_en = -1;
    __syncthreads();

    const int R = qlen + tlen - 1;
    for (int r = 0; r < R; ++r) {
      const int p = r & 1;
      // the unbanded row [st0, en0] and its 16-lane rounding [st, en]
      const int st0 = r - qlen + 1 > 0 ? r - qlen + 1 : 0;
      const int en0 = tlen - 1 < r ? tlen - 1 : r;
      // (st0, en0 >= 0: the rounding is a mask)
      const int st = st0 & ~15, en = ((en0 + 16) & ~15) - 1;
      const int8_t ub = r == 0              ? init1
                        : r < P.long_thres  ? (int8_t)(-P.e)
                        : r == P.long_thres ? (int8_t)P.long_diff
                                            : (int8_t)(-e2);
      const int g = st0 + ((en0 - st0) & ~15);  // last 16-lane score store
      const int hi = en > g + 15 ? en : g + 15;
      // lanes that left the band on the left take their slot's next lane
      const int rs_lo = last_st - 1 > 0 ? last_st - 1 : 0, rs_hi = st - 2;
      const bool resets = r > 0 && rs_lo <= rs_hi;
      // lane st reads lane st-1 only if the previous row held it
      const bool carry_st = st > 0 && st - 1 >= last_st && st - 1 <= last_en;
      const RowOrder ord(st0, en0);
      // this thread's row max: the largest H, then the smallest rank
      int bH = INT_MIN, bT = 0;
      unsigned bR = 0xFFFFFFFFu;
      uint8_t* drow = drow0 + (int64_t)r * ncol;
      Xch& xo = xch[p ^ 1];

#pragma unroll
      for (int k = 0; k < (SPT > 0 ? SPT : 1); ++k) {
        for (int km = 0; km < (SPT > 0 ? 1 : nk); ++km) {
          const int kk = SPT > 0 ? k : km;
          const int slot = kk * NT + tid;
          Slot L;
          if constexpr (SPT > 0)
            L = reg[k];
          else
            L = M.load(slot);
          if (resets) {
            const int tr = rs_lo + ((slot - rs_lo) & mask);
            if (tr <= rs_hi) fill(L, tr + ring);
          }
          const int t = st + ((slot - st) & mask);  // this slot's lane
          // a warp with no lane of the row skips it (its slots keep their
          // state; the edge below is still published)
          if (__any_sync(kFull, t <= hi)) {
            // lane t-1's values before this row: from the thread below in
            // the warp, else from the edge the row before published
            int c = __shfl_up_sync(kFull, pack3(L.x, L.v, L.x2), 1);
            int cH = approx_max ? 0 : __shfl_up_sync(kFull, L.H, 1);
            if (lane == 0) {
              const int2 e = edge[p * nedge + (((slot - 1) & mask) >> 5)];
              c = e.x, cH = e.y;
            }
            if (t <= hi) {
              int8_t xt1 = (int8_t)c, vt1 = (int8_t)(c >> 8),
                     x2t1 = (int8_t)(c >> 16);
              if (t == st && !carry_st) {
                xt1 = init1, x2t1 = init2;
                vt1 = st > 0 ? init1 : ub;
              }
              int8_t z;
              if (t >= st0 && t <= g + 15) {
                const int j = r - t;  // the query position of lane t
                const int qb = j < 0 || j >= qlen ? 0
                               : staged           ? Qs[j]
                               : qpool[qrev ? qo + qlen - 1 - j : qo + j];
                const int ta = L.tb;
                z = (ta == 4 || qb == 4) ? sc_n : (ta == qb ? sc_mch : sc_mis);
                L.s = z;
              } else {
                z = L.s;
              }
              if (t <= en) {  // lanes past the band keep only their score
                int8_t ut = L.u, yt = L.y;
                if (t == r) ut = ub, yt = init1;
                const int8_t a = (int8_t)(xt1 + vt1);
                const int8_t bb = (int8_t)(yt + ut);
                const int8_t a2 = (int8_t)(x2t1 + vt1);
                // the intron candidate: a2 + acceptor[t]
                const int8_t c3 = (int8_t)(a2 + L.ac);
                uint8_t d;
                if (!right) {
                  d = a > z ? 1 : 0;
                  if (a > z) z = a;
                  if (bb > z) d = 2, z = bb;
                  if (c3 > z) d = 3, z = c3;
                } else {
                  d = z > a ? 0 : 1;
                  if (a > z) z = a;
                  if (!(z > bb)) d = 2;
                  if (bb > z) z = bb;
                  if (!(z > c3)) d = 3;
                  if (c3 > z) z = c3;
                }
                L.u = (int8_t)(z - vt1);
                L.v = (int8_t)(z - ut);
                const int8_t zq = (int8_t)(z - q);
                const int8_t zq2 = (int8_t)(z - q2);
                const int8_t an = (int8_t)(a - zq), bn = (int8_t)(bb - zq);
                const int8_t a2n = (int8_t)(a2 - zq2);
                const bool ax = right ? !(0 > an) : an > 0;
                const bool bx = right ? !(0 > bn) : bn > 0;
                L.x = (int8_t)((ax ? an : 0) - qe);
                L.y = (int8_t)((bx ? bn : 0) - qe);
                if (ax) d |= 0x08;
                if (bx) d |= 0x10;
                // the intron state continues past the donor's score, and
                // restarts from it
                const bool a2x = right ? !(L.dn > a2n) : a2n > L.dn;
                L.x2 = (int8_t)((a2x ? a2n : L.dn) - qe2);
                if (a2x) d |= 0x20;
                if (with_cigar) drow[t - st] = d;
              }
              if (!approx_max && t >= st0 && t <= en0) {
                int hn;
                if (r == 0)
                  hn = L.v - qe;
                else if (t == en0)
                  hn = en0 > 0 ? cH + L.u : L.H + L.v;
                else
                  hn = L.H + L.v;
                L.H = hn;
                const unsigned rk = ord.rank(t);
                if (hn > bH || (hn == bH && rk < bR)) bH = hn, bR = rk, bT = t;
              }
            }
          }
          // publish what the next row and this row's bookkeeping read
          if (lane == 31)
            edge[(p ^ 1) * nedge + (slot >> 5)] =
                make_int2(pack3(L.x, L.v, L.x2), L.H);
          if (!approx_max) {
            if (slot == (en0 & mask)) xo.h_en = L.H;
            if (slot == (st0 & mask)) xo.h_st = L.H;
          } else {
            if (slot == (last_H0_t & mask)) xo.v_walk = L.v;
            if (slot == ((last_H0_t + 1) & mask)) xo.u_walk = L.u;
          }
          if constexpr (SPT > 0)
            reg[k] = L;
          else
            M.store(slot, L);
        }
      }
      if (!approx_max) {
        // the warp's max by two warp reductions; the lane that holds it
        // (ranks are unique) publishes it with its lane t
        const int wH = __reduce_max_sync(kFull, bH);
        const unsigned wR = __reduce_min_sync(kFull, bH == wH ? bR : ~0u);
        if (bH == wH && bR == wR) xo.wmax[warp] = make_int4(wH, (int)wR, bT, 0);
      }
      __syncthreads();  // the row's one barrier

      if (!approx_max) {
        // the block's max over the warps' maxima, in the same order
        const int4 w = lane < NW ? xo.wmax[lane]
                                 : make_int4(INT_MIN, -1, 0, 0);
        const int max_H = __reduce_max_sync(kFull, w.x);
        const unsigned mR =
            __reduce_min_sync(kFull, w.x == max_H ? (unsigned)w.y : ~0u);
        const unsigned win =
            __ballot_sync(kFull, w.x == max_H && (unsigned)w.y == mR);
        const int max_t = __shfl_sync(kFull, w.z, __ffs(win) - 1);
        const int h_en = xo.h_en, h_st = xo.h_st;
        if (en0 == tlen - 1 && h_en > mte) mte = h_en, mte_q = r - en;
        if (r - st0 == qlen - 1 && h_st > mqe) mqe = h_st, mqe_t = st0;
        if (apply_zdrop(zs, max_H, r, max_t, zdrop, e2)) break;
        if (r == qlen + tlen - 2 && en0 == tlen - 1) score = h_en;
      } else {
        const int d0 = xo.v_walk, d1 = xo.u_walk;
        if (r > 0) {
          if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
              last_H0_t + 1 <= en0) {
            if (d0 > d1)
              H0 += d0;
            else
              H0 += d1, ++last_H0_t;
          } else if (last_H0_t >= st0 && last_H0_t <= en0) {
            H0 += d0;
          } else {
            ++last_H0_t;
            H0 += d1;
          }
          if (approx_drop && apply_zdrop(zs, H0, r, last_H0_t, zdrop, e2))
            break;
        } else {
          H0 = d0 - qe;
          last_H0_t = 0;
        }
        if (r == qlen + tlen - 2 && en0 == tlen - 1) score = H0;
      }
      last_st = st, last_en = en;
    }
  }
  if (tid == 0)
    store_result(res + (int64_t)b * 16, zs, mqe, mqe_t, mte, mte_q, score);
}

template <int NT, int SPT>
int launch_variant(const void* qpool, const void* tpool, const void* jobs,
                   int B, const void* dirs_off, const void* jpool,
                   const void* joff, void* dirs, void* res, void* scratch,
                   int ring, int qstage, int mem_smem, int smem,
                   int scratch_bytes, const ExtProf& P, void* stream) {
  size_t shm = (size_t)xch_bytes() + edge_bytes(ring) + qstage;
  const size_t mem = SPT == 0 ? (size_t)ring * kMemBytes : 0;
  if (mem_smem) shm += mem;
  // kernels.exts_geometry sizes the launch from a copy of this layout:
  // refuse a launch whose shared or scratch bytes disagree with it
  if (shm != (size_t)smem || (size_t)scratch_bytes != (mem_smem ? 0 : mem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(exts_kernel<NT, SPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  exts_kernel<NT, SPT><<<B, NT, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)qpool, (const uint8_t*)tpool, (const int64_t*)jobs,
      (const int64_t*)dirs_off, (const uint8_t*)jpool, (const int64_t*)joff,
      (uint8_t*)dirs, (int32_t*)res, (uint8_t*)scratch, ring, qstage,
      mem_smem, P);
  return (int)cudaGetLastError();
}

}  // namespace

// threads and slots a thread, as kernels.exts_geometry chooses them
// (kernels.K3_VARIANTS lists the same): the register variants, none of
// which spills, and SPT 0 (slot state in memory) at 512 threads
#define WM_K3_VARIANTS(X) X(256, 1) X(512, 1) X(512, 2) X(512, 4) X(512, 0)

extern "C" int wm_exts_launch(const void* qpool, const void* tpool,
                              const void* jobs, int B, const void* dirs_off,
                              const void* jpool, const void* joff, void* dirs,
                              void* res, void* scratch, int ring, int threads,
                              int spt, int qstage, int mem_smem, int smem,
                              int scratch_bytes, int q, int e, int q2,
                              int sc_mch, int sc_mis, int sc_n,
                              int long_thres, int long_diff, int noncan,
                              int junc_bonus, int dead, int flag,
                              void* stream) {
  // the intron state has no extension cost: e2 = 0
  const ExtProf P{q,         e,         q2,     0,          sc_mch, sc_mis, sc_n,
                  long_thres, long_diff, noncan, junc_bonus, flag,   dead};
#define WM_K3_CASE(nt, s)                                                  \
  if (threads == nt && spt == s)                                           \
    return launch_variant<nt, s>(qpool, tpool, jobs, B, dirs_off, jpool,   \
                                 joff, dirs, res, scratch, ring, qstage,   \
                                 mem_smem, smem, scratch_bytes, P, stream);
  WM_K3_VARIANTS(WM_K3_CASE)
#undef WM_K3_CASE
  return (int)cudaErrorInvalidValue;
}
