// The extension-DP wavefront of K1 (extd.cu) and K4 (extz.cu): one kernel
// body, ext_kernel<kMode, NT, SPT>, with the cell chosen at compile time,
// and the helpers K3 (exts.cu, a body of its own) shares: ExtProf, ZState
// and apply_zdrop, RowOrder, store_result, JobTarget.  The cost probes
// (probes.cu) take block_max_key.
//
// Semantics are wm_extd's and wm_extz's (native/src/wm_ksw.cpp, reference
// src/ksw2_extd2_sse.c and src/ksw2_extz2_sse.c): wrapping int8
// difference-form state u, v, x, y, x2, y2 (u, v, x, y only for extz) and
// the score row s, the 16-lane band rounding st = st0/16*16, en =
// (en0+16)/16*16-1 with the boundary values and init refill, the SSE
// 4-lane-strided row-max tie order, z-drop, approx-max/approx-drop and
// mqe/mte.  Results and direction bytes equal the scalar oracle's exactly.
//
// The single-cost cell (kExtz, wm_ksw.cpp:1192-1412) keeps its state as
// *biased unsigned* bytes, as ksw_extz2_sse does: u, v, x, y start at 0 (not
// -(q+e)); the boundary is q for r > 0 (0 at r = 0); z = s + 2(q+e) as a
// byte; the direction compares z with a and b signed, but z's max with b is
// unsigned and z is capped unsigned at max_sc = mat[0] + 2(q+e); x and y
// keep an and bn without subtracting q+e; H adds (unsigned) v - (q+e);
// z-drop's gap term is e.  The signed and unsigned views part once
// 2(q+e) + a > 127, so every byte is kept exactly as the reference keeps it.
//
// What bounds it on this card: latency.  A job is a chain of qlen+tlen-1
// dependent anti-diagonal rows, so its time is its rows times one row's
// latency; the card is filled by running many jobs (blocks) at once.
// Bytes (direction bytes written once, sequences read once) and operations
// are under a tenth of the time.
//
// Design, K3's (exts.cu) with K1's band:
//   * Ring slots owned by threads.  The band state lives in a ring of
//     `ring` lanes (a multiple of NT, lane t in slot t mod ring); slot
//     k * NT + tid always belongs to thread tid, which keeps the slot's
//     state packed in registers across rows: u v x y in one word, x2 y2
//     (0 for extz), s and the lane's target byte in another, and the exact
//     max's H.  A slot takes a new lane (fill: the initial values and that
//     lane's target byte) at the start and when its lane leaves the band
//     on the left, so it holds exactly what the scalar code's
//     absolute-indexed arrays hold at every lane a row reads.  The ring
//     holds every row's lanes [last_st - 1, max(en, g + 15)]
//     (kernels.ring_span proves the bound it is sized by).
//   * One barrier a row.  The only cross-lane read of the recurrence is
//     lane t-1's old x, v, x2 (and H for the exact max's last lane): it
//     comes by __shfl_up_sync inside a warp, and at warp edges and the
//     ring's wrap from `edge`, a double-buffered array that every warp's
//     last lane fills at the end of the row.  The exact max reduces each
//     warp to one (H, rank, lane) by __reduce_max_sync of H and
//     __reduce_min_sync of the SSE rank among its maxima, into the same
//     double-buffered exchange (`xch`), as do h_en, h_st and the approx
//     walk's two bytes, published by their slots' owners; after the row's
//     one __syncthreads every warp reduces the warps' maxima the same way
//     and keeps the scalar bookkeeping (z-drop, mqe/mte, the walk), so
//     z-drop breaks at the reference's row.
//   * Branch-free cells.  Every row, a thread computes the cell of each of
//     its slots and keeps the result only where the slot's lane lies in
//     the row, so its SPT cells are independent and interleave; no warp
//     skips a row.
//   * No global load in the cell.  The job's query is staged in shared
//     memory once, as the DP reads it (qrev applied); a query longer than
//     `qstage` bytes (kernels.EXT_QSTAGE_MAX) is read from the pool.
//   * The launch follows the ring: 128 threads x SPT = ring / 128 slots in
//     registers (SPT 1-8, four blocks an SM), so a batch of 512 jobs at w
//     = 500 (rows of up to 545 lanes: a ring of 640, five slots a thread)
//     is one wave on 132 SMs.  The ring is the multiple of 128 that holds
//     the span, not a power of two: at w = 500 a ring of 1024 leaves each
//     thread ~4 slots a row outside the band, each a vote, a publish and
//     its bookkeeping.  A wider ring (SPT = 0, kernels.ext_geometry) keeps
//     each slot's three words in memory (shared when it fits, else a
//     global scratch slot per block) at 512 threads, still owned by one
//     thread, with the same exchange.
//   * Direction bytes go to a per-job banded buffer: row r at
//     dirs + dirs_off[b] + r * ncol, lane t at column t - st (the scalar
//     code's layout), read by K2 (traceback.cu).  K3 writes the same
//     layout.
#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#define WM_NEG_INF (-0x40000000)
#define EZ_SCORE_ONLY 0x01
#define EZ_RIGHT 0x02
#define EZ_APPROX_MAX 0x08
#define EZ_APPROX_DROP 0x10
#define EZ_REV_CIGAR 0x80
#define EZ_SPLICE_FOR 0x100
#define EZ_SPLICE_REV 0x200
#define EZ_SPLICE_FLANK 0x400

// the two cells of the body
enum ExtMode { kExtd = 0, kExtz = 2 };

// Per-call scoring.  exts (exts.cu) has e2 = 0 and no y2; extd has noncan
// and junc_bonus 0; extz has q2 = q, e2 = e and its byte cap max_sc.
struct ExtProf {
  int q, e, q2, e2, sc_mch, sc_mis, sc_n, long_thres, long_diff, noncan,
      junc_bonus, flag;
  int dead;    // the scalar code's empty result (a refused scoring)
  int max_sc;  // extz: mat[0] + 2(q+e) as an unsigned byte
};

struct ZState {
  int mx, max_q, max_t, zdropped;
};

__device__ __forceinline__ bool apply_zdrop(ZState& z, int H, int r, int t,
                                            int zdrop, int e2) {
  // reference ksw2.h:160-176 ksw_apply_zdrop, is_rot=1
  if (H > z.mx) {
    z.mx = H;
    z.max_t = t;
    z.max_q = r - t;
  } else if (t >= z.max_t && r - t >= z.max_q) {
    int tl = t - z.max_t, ql = (r - t) - z.max_q;
    int l = tl > ql ? tl - ql : ql - tl;
    if (zdrop >= 0 && z.mx - H > zdrop + l * e2) {
      z.zdropped = 1;
      return true;
    }
  }
  return false;
}

// Row max over [st0, en0] in the SSE scan's tie order: en0 first, then the
// lanes l = (t - st0) % 4 of [st0, en1) in order with ascending t inside
// each, then the tail [en1, en0).  The row's max is the largest H of the
// smallest rank: the first maximum that order meets.
struct RowOrder {
  int st0, en0, en1, nk;
  __device__ RowOrder(int st0_, int en0_) : st0(st0_), en0(en0_) {
    en1 = st0 + (en0 - st0) / 4 * 4;
    nk = (en1 - st0) / 4;
  }
  __device__ __forceinline__ int rank(int t) const {
    if (t == en0) return 0;
    return t < en1 ? 1 + ((t - st0) & 3) * nk + ((t - st0) >> 2)
                   : 1 + 4 * nk + (t - en1);
  }
};

// Block-wide max of every thread's key; wkey holds >= 32 slots of shared
// memory.  Contains one __syncthreads(); every thread returns the max.
__device__ __forceinline__ long long block_max_key(long long best,
                                                   long long* wkey) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long ot = __shfl_xor_sync(0xffffffffu, best, o);
    if (ot > best) best = ot;
  }
  if ((threadIdx.x & 31) == 0) wkey[threadIdx.x >> 5] = best;
  __syncthreads();
  best = wkey[0];
  for (int i = 1; i < ((int)blockDim.x + 31) / 32; ++i)
    if (wkey[i] > best) best = wkey[i];
  return best;
}

__device__ __forceinline__ void store_result(int32_t* o, const ZState& zs,
                                             int mqe, int mqe_t, int mte,
                                             int mte_q, int score) {
  o[0] = zs.mx;
  o[1] = zs.zdropped;
  o[2] = zs.max_q;
  o[3] = zs.max_t;
  o[4] = mqe;
  o[5] = mqe_t;
  o[6] = mte;
  o[7] = mte_q;
  o[8] = score;
  for (int i = 9; i < 16; ++i) o[i] = 0;
}

struct JobTarget {
  const uint8_t* tpool;
  int64_t to;
  int tlen;
  bool trev;

  __device__ __forceinline__ int at(int k) const {
    return tpool[trev ? to + tlen - 1 - k : to + k];
  }
};


// ---------------------------------------------------------------------------
// K1 and K4: ext_kernel<kMode, NT, SPT>
// ---------------------------------------------------------------------------

constexpr unsigned kWarpAll = 0xffffffffu;

// one ring slot's state: a = u | v << 8 | x << 16 | y << 24, b = x2 | y2 << 8
// | s << 16 | tb << 24 (x2 = y2 = 0 for extz; tb the lane's target byte, 0
// beyond tlen), and the exact max's H
struct ExtSlot {
  uint32_t a, b;
  int H;
};

// the double-buffered per-row exchange: each warp's row max (H, its SSE
// rank, its lane), H at en0 and st0, the approx walk's v and u as H adds
// them
struct ExtXch {
  int4 wmax[32];
  int h_en, h_st, v_walk, u_walk;
};

// the memory path's slot state: the a, b and H words of every slot
constexpr int kExtMemBytes = 12;

__host__ __device__ constexpr int ext_xch_bytes() {
  return (2 * (int)sizeof(ExtXch) + 15) / 16 * 16;
}
__host__ __device__ constexpr int ext_edge_bytes(int ring) {
  return 2 * (ring / 32) * 8;
}

__device__ __forceinline__ uint32_t pack4(int b0, int b1, int b2, int b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}
// the low byte of x as an int8 value, sign-extended
__device__ __forceinline__ int sx8(int x) { return (int)(int8_t)x; }
__device__ __forceinline__ int sx8(uint32_t x) { return (int)(int8_t)x; }
// what lane t+1 reads of lane t: v | x << 8 | x2 << 16
__device__ __forceinline__ int carry_of(const ExtSlot& L) {
  return (int)__byte_perm(L.a, L.b, 0x0421);
}

// the memory path's slot words, three rows of `ring`
struct ExtSlotMem {
  uint32_t* base;
  int ring;
  __device__ __forceinline__ ExtSlot load(int sl) const {
    return {base[sl], base[ring + sl], (int)base[2 * ring + sl]};
  }
  __device__ __forceinline__ void store(int sl, const ExtSlot& L) const {
    base[sl] = L.a, base[ring + sl] = L.b, base[2 * ring + sl] = (uint32_t)L.H;
  }
};

// NT threads a block; SPT ring slots a thread in registers (ring = NT *
// SPT), or 0: the slot state in memory (shared when mem_smem, else
// gscratch), ring / NT slots a thread
template <int kMode, int NT, int SPT>
__global__ void __launch_bounds__(NT, SPT > 0 ? 4 : 1) ext_kernel(
    const uint8_t* __restrict__ qpool, const uint8_t* __restrict__ tpool,
    const int64_t* __restrict__ jobs, const int64_t* __restrict__ dirs_off,
    uint8_t* __restrict__ dirs, int32_t* __restrict__ res,
    uint8_t* __restrict__ gscratch, int ring, int qstage, int mem_smem,
    ExtProf P) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NW = NT / 32;
  constexpr bool kZ = kMode == kExtz;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t* jb = jobs + (int64_t)b * 8;
  const int64_t qo = jb[0];
  const int qlen = (int)jb[1], tlen = (int)jb[4];
  const bool qrev = jb[2] != 0;
  const int w = (int)jb[6];
  const int zdrop = (int)jb[7];
  const JobTarget T{tpool, jb[3], tlen, jb[5] != 0};
  const bool with_cigar = !(P.flag & EZ_SCORE_ONLY);
  const bool approx_max = (P.flag & EZ_APPROX_MAX) != 0;
  const bool approx_drop = (P.flag & EZ_APPROX_DROP) != 0;
  const bool right = (P.flag & EZ_RIGHT) != 0;
  const int q = P.q, q2 = P.q2, e2 = P.e2;
  const int qe = P.q + P.e, qe2 = P.q2 + P.e2;
  const int rgt = right ? 1 : 0;
  // extz's biased state starts at 0
  const int init1 = kZ ? 0 : sx8(-qe), init2 = kZ ? 0 : sx8(-qe2);
  const int sc_mch = sx8(P.sc_mch), sc_mis = sx8(P.sc_mis),
            sc_n = sx8(P.sc_n), max_sc = P.max_sc & 255;

  ZState zs{0, -1, -1, 0};
  int mqe = WM_NEG_INF, mqe_t = -1, mte = WM_NEG_INF, mte_q = -1;
  int score = WM_NEG_INF;

  if (!P.dead && qlen > 0 && tlen > 0) {
    ExtXch* xch = (ExtXch*)smem;
    const int nedge = ring >> 5;
    int2* edge = (int2*)(smem + ext_xch_bytes());
    uint8_t* Qs = smem + ext_xch_bytes() + ext_edge_bytes(ring);
    const bool staged = qlen <= qstage;
    const ExtSlotMem M{
        SPT > 0    ? nullptr
        : mem_smem ? (uint32_t*)(Qs + qstage)
                   : (uint32_t*)(gscratch + (size_t)b * ring * kExtMemBytes),
        ring};
    // lane l lives in slot l mod ring (a multiple of NT): l - q * ring with
    // q = umulhi(l, rmagic), which is floor(l / ring) or one more
    const uint32_t rmagic = 0xFFFFFFFFu / (uint32_t)ring + 1;
    auto slot_of = [&](int l) {
      const int m = l - (int)__umulhi((uint32_t)l, rmagic) * ring;
      return m < 0 ? m + ring : m;
    };
    // the lane base + (slot - slot_of(base)) mod ring, for slot in [0, ring)
    auto lane_from = [&](int base, int base_slot, int slot) {
      const int d = slot - base_slot;
      return base + (d < 0 ? d + ring : d);
    };
    const int nk = SPT > 0 ? SPT : ring / NT;
    // a u or v byte as H adds it: extz reads it unsigned, less q+e
    auto hd = [&](int x) { return kZ ? (x & 255) - qe : x; };
    // a slot's initial values, for the lane `t` next in it
    auto fill = [&](ExtSlot& L, int t) {
      L.a = pack4(init1, init1, init1, init1);
      L.b = pack4(init2, init2, 0, t < tlen ? T.at(t) : 0);
      L.H = WM_NEG_INF;
    };
    ExtSlot reg[SPT > 0 ? SPT : 1];
    if (staged)
      for (int j = tid; j < qlen; j += NT)
        Qs[j] = qpool[qrev ? qo + qlen - 1 - j : qo + j];
#pragma unroll
    for (int k = 0; k < (SPT > 0 ? SPT : 1); ++k) {
      if constexpr (SPT > 0) fill(reg[k], k * NT + tid);
    }
    if constexpr (SPT == 0) {
      for (int k = 0; k < nk; ++k) {
        ExtSlot L;
        fill(L, k * NT + tid);
        M.store(k * NT + tid, L);
      }
    }
    // the edges as the end of row -1 leaves them: every slot at its start
    for (int i = tid; i < nedge; i += NT)
      edge[i] = make_int2((int)pack4(init1, init1, init2, 0), WM_NEG_INF);
    const int mn = qlen < tlen ? qlen : tlen;
    const int ncol = (((mn < w + 1 ? mn : w + 1) + 15) / 16 + 1) * 16;
    uint8_t* drow0 = dirs + dirs_off[b];
    int H0 = 0, last_H0_t = 0, last_st = -1, last_en = -1;
    __syncthreads();

    const int R = qlen + tlen - 1;
    for (int r = 0; r < R; ++r) {
      const int p = r & 1;
      // the banded row [st0, en0] and its 16-lane rounding [st, en]
      int st0 = 0, en0 = tlen - 1;
      if (st0 < r - qlen + 1) st0 = r - qlen + 1;
      if (en0 > r) en0 = r;
      if (st0 < (r - w + 1) >> 1) st0 = (r - w + 1) >> 1;
      if (en0 > (r + w) >> 1) en0 = (r + w) >> 1;
      if (st0 > en0) {
        zs.zdropped = 1;
        break;
      }
      // (st0, en0 >= 0: the rounding is a mask)
      const int st = st0 & ~15, en = ((en0 + 16) & ~15) - 1;
      const int ub = r == 0              ? init1
                     : kZ                ? sx8(q)
                     : r < P.long_thres  ? sx8(-P.e)
                     : r == P.long_thres ? sx8(P.long_diff)
                                         : sx8(-e2);
      const int g = st0 + ((en0 - st0) & ~15);  // last 16-lane score store
      const int hi = en > g + 15 ? en : g + 15;
      // lanes that left the band on the left take their slot's next lane
      const int rs_lo = last_st - 1 > 0 ? last_st - 1 : 0, rs_hi = st - 2;
      const bool resets = r > 0 && rs_lo <= rs_hi;
      const int st_sl = slot_of(st), rs_sl = resets ? slot_of(rs_lo) : 0;
      // lane st reads lane st-1 only if the previous row held it
      const bool carry_st = st > 0 && st - 1 >= last_st && st - 1 <= last_en;
      const RowOrder ord(st0, en0);
      // this thread's row max: the largest H, then the smallest rank
      int bH = INT_MIN, bT = 0;
      unsigned bR = 0xFFFFFFFFu;
      uint8_t* drow = drow0 + (int64_t)r * ncol;
      ExtXch& xo = xch[p ^ 1];

      // lanes that left the band on the left: their slots take the next
      // lane
      if (resets) {
#pragma unroll
        for (int k = 0; k < (SPT > 0 ? SPT : 1); ++k) {
          for (int km = 0; km < (SPT > 0 ? 1 : nk); ++km) {
            const int slot = (SPT > 0 ? k : km) * NT + tid;
            const int tr = lane_from(rs_lo, rs_sl, slot);
            if (tr <= rs_hi) {
              if constexpr (SPT > 0) {
                fill(reg[k], tr + ring);
              } else {
                ExtSlot L;
                fill(L, tr + ring);
                M.store(slot, L);
              }
            }
          }
        }
      }
      // The row's cells.  Every slot computes the cell of its lane and
      // keeps the result only where the lane lies in the row, so a
      // thread's slots are one block of independent work that the
      // compiler interleaves; `qread` reads query position j, and `exact`
      // (a compile-time bool) adds the exact max's H.
      auto cells = [&](auto qread, auto exact) {
        int cout[SPT > 0 ? SPT : 1];
#pragma unroll
        for (int k = 0; k < (SPT > 0 ? SPT : 1); ++k) {
          for (int km = 0; km < (SPT > 0 ? 1 : nk); ++km) {
            const int slot = (SPT > 0 ? k : km) * NT + tid;
            ExtSlot L;
            if constexpr (SPT > 0)
              L = reg[k];
            else
              L = M.load(slot);
            const int t = lane_from(st, st_sl, slot);  // this slot's lane
            // lane t-1's values before this row: from the thread below in
            // the warp, else from the edge the row before published
            int c = __shfl_up_sync(kWarpAll, carry_of(L), 1);
            int cH = 0;
            if constexpr (decltype(exact)::value)
              cH = __shfl_up_sync(kWarpAll, L.H, 1);
            const int2 e =
                edge[p * nedge + (((slot > 0 ? slot : ring) - 1) >> 5)];
            if (lane == 0) c = e.x, cH = e.y;
            int vt1 = sx8(c), xt1 = sx8(c >> 8), x2t1 = sx8(c >> 16);
            if (t == st && !carry_st) {
              xt1 = init1, x2t1 = init2;
              vt1 = st > 0 ? init1 : ub;
            }
            int u = sx8(L.a), v = sx8(L.a >> 8), x = sx8(L.a >> 16),
                y = (int)L.a >> 24;
            int x2 = sx8(L.b), y2 = sx8(L.b >> 8), s = sx8(L.b >> 16);
            const int tb = L.b >> 24;
            // lanes [st0, g + 15] take this row's score (16-lane stores
            // from st0); the others keep the one they hold
            const int j = r - t;  // the query position of lane t
            const int qb = j < 0 || j >= qlen
                               ? 0
                               : qread(j < 0 ? 0 : j >= qlen ? qlen - 1 : j);
            if (t >= st0 && t <= g + 15)
              s = (tb == 4 || qb == 4) ? sc_n : (tb == qb ? sc_mch : sc_mis);
            int z = s;
            int ut = u, yt = y, y2t = y2;
            if (t == r) ut = ub, yt = init1, y2t = init2;
            // the int8 cells on sign-extended ints: every sum wraps through
            // sx8, as the SSE bytes do; a candidate takes the direction
            // when it beats z (ties too with right-aligned gaps: c > z -
            // rgt), and so do the continue tests
            int d, un, vn, xn, yn, x2n = x2, y2n = y2;
            if constexpr (kZ) {
              // wm_extz's cell on the biased bytes (wm_ksw.cpp:1290-1329):
              // the compares are signed, b's max and the cap unsigned
              const int a = sx8(xt1 + vt1), bb = sx8(yt + ut);
              int zb = sx8(z + 2 * qe);
              d = a > zb - rgt;
              zb = max(zb, a);
              if (bb > zb - rgt) d = 2;
              const int zu = min(max(zb & 255, bb & 255), max_sc);
              un = sx8(zu - vt1);
              vn = sx8(zu - ut);
              const int zq = zu - q;
              const int an = sx8(a - zq), bn = sx8(bb - zq);
              const bool ax = an > -rgt, bx = bn > -rgt;
              xn = ax ? an : 0;
              yn = bx ? bn : 0;
              d |= ax << 3 | bx << 4;
            } else {
              // wm_extd's cell (wm_ksw.cpp:1514-1586)
              const int a = sx8(xt1 + vt1), bb = sx8(yt + ut);
              const int a2 = sx8(x2t1 + vt1), b2 = sx8(y2t + ut);
              d = a > z - rgt;
              z = max(z, a);
              if (bb > z - rgt) d = 2;
              z = max(z, bb);
              if (a2 > z - rgt) d = 3;
              z = max(z, a2);
              if (b2 > z - rgt) d = 4;
              z = min(max(z, b2), sc_mch);
              un = sx8(z - vt1);
              vn = sx8(z - ut);
              const int zq = z - q, zq2 = z - q2;
              const int an = sx8(a - zq), bn = sx8(bb - zq);
              const int a2n = sx8(a2 - zq2), b2n = sx8(b2 - zq2);
              const bool ax = an > -rgt, bx = bn > -rgt;
              const bool a2x = a2n > -rgt, b2x = b2n > -rgt;
              xn = sx8((ax ? an : 0) - qe);
              yn = sx8((bx ? bn : 0) - qe);
              x2n = sx8((a2x ? a2n : 0) - qe2);
              y2n = sx8((b2x ? b2n : 0) - qe2);
              d |= ax << 3 | bx << 4 | a2x << 5 | b2x << 6;
            }
            // lanes past the band keep only their score; lanes past the
            // row keep everything
            if (t <= en) {
              u = un, v = vn, x = xn, y = yn, x2 = x2n, y2 = y2n;
              if (with_cigar) drow[t - st] = (uint8_t)d;
            }
            if (t <= hi) {
              L.a = pack4(u, v, x, y);
              L.b = pack4(x2, y2, s, tb);
            }
            if (decltype(exact)::value && t >= st0 && t <= en0) {
              const int hn = r == 0      ? hd(v) - qe
                             : t == en0 ? (en0 > 0 ? cH + hd(u) : L.H + hd(v))
                                        : L.H + hd(v);
              L.H = hn;
              const unsigned rk = ord.rank(t);
              if (hn > bH || (hn == bH && rk < bR)) bH = hn, bR = rk, bT = t;
            }
            if constexpr (SPT > 0) {
              reg[k] = L;
              cout[k] = carry_of(L);
            } else {
              M.store(slot, L);
              if (lane == 31)
                edge[(p ^ 1) * nedge + (slot >> 5)] =
                    make_int2(carry_of(L), L.H);
            }
          }
        }
        // the warps' last lanes publish what the next row's first lanes
        // read
        if constexpr (SPT > 0) {
          if (lane == 31) {
#pragma unroll
            for (int k = 0; k < SPT; ++k)
              edge[(p ^ 1) * nedge + ((k * NT + tid) >> 5)] =
                  make_int2(cout[k], reg[k].H);
          }
        }
      };
      const auto qs = [&](int jj) { return (int)Qs[jj]; };
      const auto qp = [&](int jj) {
        return (int)qpool[qrev ? qo + qlen - 1 - jj : qo + jj];
      };
      const std::true_type exact_max;
      const std::false_type walk;
      if (approx_max) {
        if (staged)
          cells(qs, walk);
        else
          cells(qp, walk);
      } else {
        if (staged)
          cells(qs, exact_max);
        else
          cells(qp, exact_max);
      }

      // the owners of the lanes this row's bookkeeping reads publish them:
      // H at en0 and st0, or the approx walk's v and u
      auto state_of = [&](int sl) {
        if constexpr (SPT > 0) {
          // masks, not an index, so that reg stays in registers
          const int kk = sl / NT;
          ExtSlot L{0, 0, 0};
#pragma unroll
          for (int k = 0; k < SPT; ++k) {
            const uint32_t m = 0u - (uint32_t)(kk == k);
            L.a |= reg[k].a & m, L.b |= reg[k].b & m;
            L.H |= reg[k].H & (int)m;
          }
          return L;
        } else {
          return M.load(sl);
        }
      };
      const int pub0 = slot_of(approx_max ? last_H0_t : en0);
      const int pub1 = approx_max ? (pub0 + 1 == ring ? 0 : pub0 + 1)
                                  : slot_of(st0);
      if (pub0 % NT == tid) {
        const ExtSlot L = state_of(pub0);
        if (approx_max)
          xo.v_walk = hd(sx8(L.a >> 8));
        else
          xo.h_en = L.H;
      }
      if (pub1 % NT == tid) {
        const ExtSlot L = state_of(pub1);
        if (approx_max)
          xo.u_walk = hd(sx8(L.a));
        else
          xo.h_st = L.H;
      }
      if (!approx_max) {
        // the warp's max by two warp reductions; the lane that holds it
        // (ranks are unique) publishes it with its lane t
        const int wH = __reduce_max_sync(kWarpAll, bH);
        const unsigned wR =
            __reduce_min_sync(kWarpAll, bH == wH ? bR : 0xFFFFFFFFu);
        if (bH == wH && bR == wR) xo.wmax[warp] = make_int4(wH, (int)wR, bT, 0);
      }
      __syncthreads();  // the row's one barrier

      if (!approx_max) {
        // the block's max over the warps' maxima, in the same order
        const int4 wm = lane < NW ? xo.wmax[lane]
                                  : make_int4(INT_MIN, -1, 0, 0);
        const int max_H = __reduce_max_sync(kWarpAll, wm.x);
        const unsigned mR = __reduce_min_sync(
            kWarpAll, wm.x == max_H ? (unsigned)wm.y : 0xFFFFFFFFu);
        const unsigned win =
            __ballot_sync(kWarpAll, wm.x == max_H && (unsigned)wm.y == mR);
        const int max_t = __shfl_sync(kWarpAll, wm.z, __ffs(win) - 1);
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

// threads and slots a thread, as kernels.ext_geometry chooses them
// (kernels.EXT_VARIANTS lists the same): 128 threads with 1-8 ring slots
// each in registers, and SPT 0 (slot state in memory) at 512 threads
#define WM_EXT_VARIANTS(X)                                                \
  X(128, 1) X(128, 2) X(128, 3) X(128, 4) X(128, 5) X(128, 6) X(128, 7)  \
  X(128, 8) X(512, 0)

template <int kMode, int NT, int SPT>
int ext_launch_variant(const void* qpool, const void* tpool, const void* jobs,
                       int B, const void* dirs_off, void* dirs, void* res,
                       void* scratch, int ring, int qstage, int mem_smem,
                       int smem, int scratch_bytes, const ExtProf& P,
                       void* stream) {
  // the memory path's slot words lie in shared memory or global scratch
  const size_t mem = SPT == 0 ? (size_t)ring * kExtMemBytes : 0;
  const size_t shm = (size_t)ext_xch_bytes() + ext_edge_bytes(ring) +
                     qstage + (mem_smem ? mem : 0);
  // kernels.ext_geometry sizes the launch from a copy of this layout:
  // refuse a launch whose ring, shared or scratch bytes disagree with it
  const bool ring_ok =
      SPT > 0 ? ring == NT * SPT : ring >= NT && ring % NT == 0;
  if (!ring_ok || shm != (size_t)smem ||
      (mem_smem ? 0 : mem) != (size_t)scratch_bytes || qstage % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(ext_kernel<kMode, NT, SPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  ext_kernel<kMode, NT, SPT><<<B, NT, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)qpool, (const uint8_t*)tpool, (const int64_t*)jobs,
      (const int64_t*)dirs_off, (uint8_t*)dirs, (int32_t*)res,
      (uint8_t*)scratch, ring, qstage, mem_smem, P);
  return (int)cudaGetLastError();
}

// Launches ext_kernel<kMode, threads, spt> on `stream`, one block per job,
// after checking the launch's ring, shared and scratch bytes against its
// layout.  Returns the CUDA error code (0 on success).
template <int kMode>
int ext_launch(const void* qpool, const void* tpool, const void* jobs, int B,
               const void* dirs_off, void* dirs, void* res, void* scratch,
               int ring, int threads, int spt, int qstage, int mem_smem,
               int smem, int scratch_bytes, const ExtProf& P, void* stream) {
#define WM_EXT_CASE(nt, s)                                                 \
  if (threads == nt && spt == s)                                           \
    return ext_launch_variant<kMode, nt, s>(                               \
        qpool, tpool, jobs, B, dirs_off, dirs, res, scratch, ring, qstage, \
        mem_smem, smem, scratch_bytes, P, stream);
  WM_EXT_VARIANTS(WM_EXT_CASE)
#undef WM_EXT_CASE
  return (int)cudaErrorInvalidValue;
}
