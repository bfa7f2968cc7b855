// The extension-DP wavefront shared by K1 (extd.cu) and K4 (extz.cu): one
// kernel body, ext_kernel<kMode>, with the cell and the ring rows chosen at
// compile time.  K3 (exts.cu) has a body of its own, built for the H100,
// and takes from here only the helpers (ExtProf, ZState and apply_zdrop,
// RowOrder and row_key, store_result, JobTarget).
//
// Semantics are wm_extd's and wm_extz's (native/src/wm_ksw.cpp, reference
// src/ksw2_extd2_sse.c and src/ksw2_extz2_sse.c): wrapping int8
// difference-form state u, v, x, y, x2, y2 (u, v, x, y only for extz) and
// the score row s, the
// 16-lane band rounding st = st0/16*16, en = (en0+16)/16*16-1 with the
// boundary values and init refill, the SSE 4-lane-strided row-max tie
// order, z-drop, approx-max/approx-drop and mqe/mte.  Results and direction
// bytes equal the scalar oracle's exactly.
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
// What bounds it on this card: neither bytes nor arithmetic.  Each job is a
// chain of qlen+tlen-1 dependent anti-diagonals, so a job's time is its row
// count times the latency of one row (two or three block barriers, a block
// reduction, shared-memory round trips); the card is filled by running
// many jobs (blocks) at once.  Device-memory traffic is the direction
// bytes written once (one byte per rounded-band cell) plus the query and
// target bytes read.
//
// Design:
//   * Threads split the row's rounded band into contiguous segments of K
//     lanes; inside a segment a thread walks lanes in order with the carry
//     (x, x2, v of lane t-1) in registers, exactly like the scalar loop.
//     Only the first lane of a segment reads its neighbour's old values,
//     before the barrier that precedes the writes: two barriers per row
//     whatever the band width.
//   * Band state lives in a ring of `cap` lanes (a power of two >= band +
//     64) indexed by t & (cap-1), in dynamic shared memory when it fits
//     (else in a global scratch slot per block).  The band only slides
//     right, so lanes that fall off the left are reset to their initial
//     values: the ring then holds exactly what the absolute-indexed arrays
//     of the scalar code hold at every lane that is read.
//   * The query and target are read straight from the device pools through
//     each job's (offset, length, reversed) descriptor.
//   * Row max: every lane of [st0, en0] forms the key H<<32 | ~rank, where
//     rank encodes the SSE tie order (en0 first, then lane l = (t-st0)%4 in
//     order with ascending t inside each, then the tail); one block max
//     reduction gives (max_H, max_t).  The scalar bookkeeping (z-drop,
//     mqe/mte, approx H0 walk) is done redundantly by every thread, so no
//     broadcast barrier is needed.
//   * Direction bytes go to a per-job banded buffer: row r at
//     dirs + dirs_off[b] + r * ncol, lane t at column t - st (the scalar
//     code's layout), read by K2 (traceback.cu).  K3 writes the same
//     layout.
#pragma once

#include <climits>
#include <cstdint>
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

// the two cells of the shared body
enum ExtMode { kExtd = 0, kExtz = 2 };

// Per-call scoring.  exts (exts.cu) has e2 = 0 and no y2; extd has noncan
// and junc_bonus 0; extz has q2 = q, e2 = e and its byte cap max_sc.
struct ExtProf {
  int q, e, q2, e2, sc_mch, sc_mis, sc_n, long_thres, long_diff, noncan,
      junc_bonus, flag;
  int dead;    // the scalar code's empty result (a refused scoring)
  int max_sc;  // extz: mat[0] + 2(q+e) as an unsigned byte
};

// int8 ring rows: u v x y, x2 (extd), s, then y2 (extd); the exact max adds
// an int32 H row (4 bytes a lane)
__host__ __device__ constexpr int ring_rows(int mode) {
  return mode == kExtd ? 7 : 5;
}
__host__ __device__ constexpr int ring_bytes(int cap, int flag, int mode) {
  return cap * (ring_rows(mode) + ((flag & EZ_APPROX_MAX) ? 0 : 4));
}

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
// each, then the tail [en1, en0).  A lane's key is H << 32 | ~rank, so the
// largest key is the first maximum that order meets.
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
  __device__ __forceinline__ int lane(unsigned rk) const {
    if (rk == 0) return en0;
    if ((int)rk <= 4 * nk)
      return st0 + 4 * (((int)rk - 1) % nk) + ((int)rk - 1) / nk;
    return en1 + ((int)rk - 1 - 4 * nk);
  }
};

__device__ __forceinline__ long long row_key(int h, int rank) {
  return (long long)h * 4294967296LL +
         (long long)(0xFFFFFFFFu - (unsigned)rank);
}

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

template <int kMode>
__global__ void __launch_bounds__(256) ext_kernel(
    const uint8_t* __restrict__ qpool, const uint8_t* __restrict__ tpool,
    const int64_t* __restrict__ jobs, const int64_t* __restrict__ dirs_off,
    uint8_t* __restrict__ dirs, int32_t* __restrict__ res,
    uint8_t* __restrict__ gscratch, int cap, int use_smem, ExtProf P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long wkey[32];
  constexpr bool kExtzCell = kMode == kExtz;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
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
  // extz's biased state starts at 0
  const int8_t init1 = kExtzCell ? 0 : (int8_t)(-qe);
  const int8_t init2 = kExtzCell ? 0 : (int8_t)(-qe2);
  const int8_t sc_mch = (int8_t)P.sc_mch, sc_mis = (int8_t)P.sc_mis,
               sc_n = (int8_t)P.sc_n;

  ZState zs{0, -1, -1, 0};
  int mqe = WM_NEG_INF, mqe_t = -1, mte = WM_NEG_INF, mte_q = -1;
  int score = WM_NEG_INF;

  if (!P.dead && qlen > 0 && tlen > 0) {
    uint8_t* base = use_smem
                        ? smem
                        : gscratch + (size_t)b * ring_bytes(cap, P.flag,
                                                             kMode);
    int8_t* U = (int8_t*)base;
    int8_t* V = U + cap;
    int8_t* X = V + cap;
    int8_t* Y = X + cap;
    int8_t* X2 = Y + cap;  // extd only
    int8_t* S = Y + cap * (kExtzCell ? 1 : 2);
    int8_t* Y2 = S + cap;  // extd only
    int32_t* H = (int32_t*)(base + cap * ring_rows(kMode));  // exact max
    const int mask = cap - 1;
    // a u or v byte as H adds it: extz reads it unsigned, less q+e
    auto hd = [&](int8_t x) {
      return kExtzCell ? (int)(uint8_t)x - qe : (int)x;
    };
    // a lane's initial values
    auto reset = [&](int sl) {
      U[sl] = V[sl] = X[sl] = Y[sl] = init1;
      if constexpr (!kExtzCell) X2[sl] = init2, Y2[sl] = init2;
      S[sl] = 0;
      if (!approx_max) H[sl] = WM_NEG_INF;
    };
    for (int i = tid; i < cap; i += nthr) reset(i);
    const int mn = qlen < tlen ? qlen : tlen;
    const int ncol = (((mn < w + 1 ? mn : w + 1) + 15) / 16 + 1) * 16;
    uint8_t* drow0 = dirs + dirs_off[b];
    int H0 = 0, last_H0_t = 0, last_st = -1, last_en = -1;
    __syncthreads();

    const int R = qlen + tlen - 1;
    for (int r = 0; r < R; ++r) {
      int st = 0, en = tlen - 1;
      if (st < r - qlen + 1) st = r - qlen + 1;
      if (en > r) en = r;
      if (st < (r - w + 1) >> 1) st = (r - w + 1) >> 1;
      if (en > (r + w) >> 1) en = (r + w) >> 1;
      if (st > en) {
        zs.zdropped = 1;
        break;
      }
      const int st0 = st, en0 = en;
      st = st / 16 * 16;
      en = (en + 16) / 16 * 16 - 1;
      // lanes that left the band on the left: back to their initial values
      // (their ring slots next hold lanes no row has touched yet)
      if (r > 0)
        for (int t = last_st - 1 + tid; t < st - 1; t += nthr)
          if (t >= 0) reset(t & mask);
      const int8_t ub = r == 0              ? init1
                        : kExtzCell         ? (int8_t)q
                        : r < P.long_thres  ? (int8_t)(-P.e)
                        : r == P.long_thres ? (int8_t)P.long_diff
                                            : (int8_t)(-e2);
      const int g = st0 + (en0 - st0) / 16 * 16;  // last 16-lane score store
      const int hi = en > g + 15 ? en : g + 15;
      const int K = (hi - st + nthr) / nthr;
      const int t_lo = st + tid * K;
      const int t_hi = min(t_lo + K - 1, hi);

      // phase A: carry into my segment's first lane; old H[en0-1]
      int8_t cx = init1, cx2 = init2, cv = init1;
      if (t_lo == st) {
        if (st > 0) {
          if (st - 1 >= last_st && st - 1 <= last_en) {
            const int sl = (st - 1) & mask;
            cx = X[sl], cv = V[sl];
            if constexpr (!kExtzCell) cx2 = X2[sl];
          }
        } else {
          cv = ub;
        }
      } else if (t_lo <= en) {
        const int sl = (t_lo - 1) & mask;
        cx = X[sl], cv = V[sl];
        if constexpr (!kExtzCell) cx2 = X2[sl];
      }
      int hprev = 0;
      if (!approx_max && r > 0 && en0 >= t_lo && en0 <= t_hi)
        hprev = en0 > 0 ? H[(en0 - 1) & mask] : H[en0 & mask];
      __syncthreads();

      // phase B: the cells of my segment, in lane order
      uint8_t* drow = drow0 + (int64_t)r * ncol;
      for (int t = t_lo; t <= t_hi; ++t) {
        const int sl = t & mask;
        int8_t z;
        if (t >= st0 && t <= g + 15) {
          const uint8_t ta = t < tlen ? T.at(t) : 0;
          const int qi = qlen - 1 - r + t;  // index into the reversed query
          const uint8_t qb = (qi >= 0 && qi < qlen)
                                 ? qpool[qrev ? qo + qi : qo + qlen - 1 - qi]
                                 : 0;
          z = (ta == 4 || qb == 4) ? sc_n : (ta == qb ? sc_mch : sc_mis);
          S[sl] = z;
        } else {
          z = S[sl];
        }
        if (t > en) continue;  // score-only lanes beyond the band
        int8_t ut = U[sl], yt = Y[sl], y2t = 0;
        if constexpr (!kExtzCell) y2t = Y2[sl];
        if (t == r) ut = ub, yt = init1, y2t = init2;
        const int8_t xt1 = cx, x2t1 = cx2, vt1 = cv;
        cx = X[sl], cv = V[sl];
        if constexpr (kExtzCell) {
          // wm_extz's cell on the biased bytes (wm_ksw.cpp:1290-1329)
          const uint8_t a = (uint8_t)(xt1 + vt1), bb = (uint8_t)(yt + ut);
          int8_t zs = (int8_t)(z + 2 * qe);
          uint8_t d;
          if (!right) {
            d = (int8_t)a > zs ? 1 : 0;
            if ((int8_t)a > zs) zs = (int8_t)a;
            if ((int8_t)bb > zs) d = 2;
          } else {
            d = zs > (int8_t)a ? 0 : 1;
            if ((int8_t)a > zs) zs = (int8_t)a;
            if (!(zs > (int8_t)bb)) d = 2;
          }
          // b's max is unsigned (_mm_max_epu8), and so is the cap
          uint8_t zu = (uint8_t)zs;
          if (bb > zu) zu = bb;
          if (zu > (uint8_t)P.max_sc) zu = (uint8_t)P.max_sc;
          U[sl] = (int8_t)(uint8_t)(zu - (uint8_t)vt1);
          V[sl] = (int8_t)(uint8_t)(zu - (uint8_t)ut);
          const uint8_t zq = (uint8_t)(zu - (uint8_t)q);
          const int8_t an = (int8_t)(uint8_t)(a - zq);
          const int8_t bn = (int8_t)(uint8_t)(bb - zq);
          const bool ax = right ? !(0 > an) : an > 0;
          const bool bx = right ? !(0 > bn) : bn > 0;
          X[sl] = ax ? an : 0;
          Y[sl] = bx ? bn : 0;
          if (ax) d |= 0x08;
          if (bx) d |= 0x10;
          if (with_cigar) drow[t - st] = d;
          continue;
        }
        cx2 = X2[sl];
        const int8_t a = (int8_t)(xt1 + vt1);
        const int8_t bb = (int8_t)(yt + ut);
        const int8_t a2 = (int8_t)(x2t1 + vt1);
        const int8_t b2 = (int8_t)(y2t + ut);
        uint8_t d;
        if (!right) {
          d = a > z ? 1 : 0;
          if (a > z) z = a;
          if (bb > z) d = 2, z = bb;
          if (a2 > z) d = 3, z = a2;
          if (b2 > z) d = 4, z = b2;
        } else {
          d = z > a ? 0 : 1;
          if (a > z) z = a;
          if (!(z > bb)) d = 2;
          if (bb > z) z = bb;
          if (!(z > a2)) d = 3;
          if (a2 > z) z = a2;
          if (!(z > b2)) d = 4;
          if (b2 > z) z = b2;
        }
        if (z > sc_mch) z = sc_mch;
        U[sl] = (int8_t)(z - vt1);
        V[sl] = (int8_t)(z - ut);
        const int8_t zq = (int8_t)(z - q);
        const int8_t zq2 = (int8_t)(z - q2);
        const int8_t an = (int8_t)(a - zq), bn = (int8_t)(bb - zq);
        const int8_t a2n = (int8_t)(a2 - zq2);
        bool ax, bx;
        if (!right) {
          ax = an > 0, bx = bn > 0;
        } else {
          ax = !(0 > an), bx = !(0 > bn);
        }
        X[sl] = (int8_t)((ax ? an : 0) - qe);
        Y[sl] = (int8_t)((bx ? bn : 0) - qe);
        if (ax) d |= 0x08;
        if (bx) d |= 0x10;
        const int8_t b2n = (int8_t)(b2 - zq2);
        bool a2x, b2x;
        if (!right) {
          a2x = a2n > 0, b2x = b2n > 0;
        } else {
          a2x = !(0 > a2n), b2x = !(0 > b2n);
        }
        X2[sl] = (int8_t)((a2x ? a2n : 0) - qe2);
        Y2[sl] = (int8_t)((b2x ? b2n : 0) - qe2);
        if (a2x) d |= 0x20;
        if (b2x) d |= 0x40;
        if (with_cigar) drow[t - st] = d;
      }
      __syncthreads();

      if (!approx_max) {
        // row max over [st0, en0] with the SSE tie order
        const RowOrder ord(st0, en0);
        long long best = LLONG_MIN;
        const int lo = t_lo > st0 ? t_lo : st0;
        const int hi2 = t_hi < en0 ? t_hi : en0;
        for (int t = lo; t <= hi2; ++t) {
          const int sl = t & mask;
          int hn;
          if (r == 0)
            hn = hd(V[sl]) - qe;
          else if (t == en0)
            hn = hprev + hd(en0 > 0 ? U[sl] : V[sl]);
          else
            hn = H[sl] + hd(V[sl]);
          H[sl] = hn;
          const long long key = row_key(hn, ord.rank(t));
          if (key > best) best = key;
        }
        best = block_max_key(best, wkey);
        const int max_H = (int)(best >> 32);
        const int max_t =
            ord.lane(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFLL));
        const int h_en = H[en0 & mask], h_st = H[st0 & mask];
        if (en0 == tlen - 1 && h_en > mte) mte = h_en, mte_q = r - en;
        if (r - st0 == qlen - 1 && h_st > mqe) mqe = h_st, mqe_t = st0;
        if (apply_zdrop(zs, max_H, r, max_t, zdrop, e2)) break;
        if (r == qlen + tlen - 2 && en0 == tlen - 1) score = h_en;
      } else {
        if (r > 0) {
          if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
              last_H0_t + 1 <= en0) {
            const int d0 = hd(V[last_H0_t & mask]);
            const int d1 = hd(U[(last_H0_t + 1) & mask]);
            if (d0 > d1)
              H0 += d0;
            else
              H0 += d1, ++last_H0_t;
          } else if (last_H0_t >= st0 && last_H0_t <= en0) {
            H0 += hd(V[last_H0_t & mask]);
          } else {
            ++last_H0_t;
            H0 += hd(U[last_H0_t & mask]);
          }
          if (approx_drop && apply_zdrop(zs, H0, r, last_H0_t, zdrop, e2))
            break;
        } else {
          H0 = hd(V[0]) - qe;
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

// Launches ext_kernel<kMode> on `stream`, one block of `threads` per job;
// the ring takes dynamic shared memory when use_smem.  Returns the CUDA
// error code (0 on success).
template <int kMode>
int ext_launch(const void* qpool, const void* tpool, const void* jobs, int B,
               const void* dirs_off, void* dirs, void* res, void* scratch,
               int cap, int use_smem, int threads, const ExtProf& P,
               void* stream) {
  const size_t shm = use_smem ? (size_t)ring_bytes(cap, P.flag, kMode) : 0;
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(ext_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  ext_kernel<kMode><<<B, threads, shm, (cudaStream_t)stream>>>(
      (const uint8_t*)qpool, (const uint8_t*)tpool, (const int64_t*)jobs,
      (const int64_t*)dirs_off, (uint8_t*)dirs, (int32_t*)res,
      (uint8_t*)scratch, cap, use_smem, P);
  return (int)cudaGetLastError();
}
