// Exact banded affine-gap extension DP, host fallback / bit-exactness oracle.
//
// Clean-room scalar re-derivation of the anti-diagonal difference-form DP used
// by the reference SIMD kernels (reference: src/ksw2_extz2_sse.c:101-289 and
// src/ksw2_extd2_sse.c:123-378).  The observable behaviour (scores, CIGARs,
// z-drop truncation points) matches the reference bit-for-bit, including the
// 16-lane band rounding of the SIMD code, because SAM parity depends on it.
//
// Formulation (difference form, anti-diagonal r = i + j, lane t = target i):
//   u(r,t) = H(r,t) - H(r-1,t)        (vertical difference, biased)
//   v(r,t) = H(r,t) - H(r-1,t-1)      (horizontal difference, biased)
//   x/y    = gap-state differences;  x2/y2 = long-gap states (dual cost).
// All state lives in int8 with wrap-around; the band keeps values bounded.
//
// The production TPU path implements the same recurrences as a Pallas kernel
// (winnowmap_tpu/extend/device.py); this file is the semantic reference.

#include "wm_base.h"

#include <algorithm>
#include <cstdlib>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#define WM_SIMD_X86 1
#endif

namespace {

struct CigarBuf {
  std::vector<uint32_t> ops;
  void push(uint32_t op, int len) {
    if (!ops.empty() && (ops.back() & 0xf) == op)
      ops.back() += (uint32_t)len << 4;
    else
      ops.push_back((uint32_t)len << 4 | op);
  }
};

inline void reset_result(wm_ext_result* ez) {
  ez->max_q = ez->max_t = ez->mqe_t = ez->mte_q = -1;
  ez->max = 0;
  ez->score = ez->mqe = ez->mte = WM_NEG_INF;
  ez->n_cigar = 0;
  ez->cigar = nullptr;
  ez->zdropped = 0;
  ez->reach_end = 0;
}

// Z-drop bookkeeping on the running anti-diagonal maximum (reference
// ksw2.h:160-176 ksw_apply_zdrop with is_rot=1).
inline int apply_zdrop(wm_ext_result* ez, int32_t H, int r, int t, int zdrop,
                       int8_t e) {
  if (H > ez->max) {
    ez->max = H;
    ez->max_t = t;
    ez->max_q = r - t;
  } else if (t >= ez->max_t && r - t >= ez->max_q) {
    int tl = t - ez->max_t, ql = (r - t) - ez->max_q;
    int l = tl > ql ? tl - ql : ql - tl;
    if (zdrop >= 0 && ez->max - H > zdrop + l * e) {
      ez->zdropped = 1;
      return 1;
    }
  }
  return 0;
}

// Shared traceback over the per-anti-diagonal direction bytes (reference
// ksw2.h:119-151 ksw_backtrack with is_rot=1, min_intron_len=0).
// Direction byte layout: bits 0-2 = state winning H; bit3 = E-continue,
// bit4 = F-continue, bit5 = E2-continue, bit6 = F2-continue.
void traceback_intron(const uint8_t* p, const int* off, const int* off_end,
                      size_t n_col, int i0, int j0, int rev_cigar,
                      int min_intron_len, CigarBuf* cb) {
  // reference ksw_backtrack (src/ksw2.h:119-151): with min_intron_len > 0
  // (the spliced kernel) the long-gap state emits 'N' ops
  int i = i0, j = j0, state = 0;
  while (i >= 0 && j >= 0) {
    int r = i + j;
    int force_state = -1;
    if (i < off[r]) force_state = 2;
    if (off_end && i > off_end[r]) force_state = 1;
    uint32_t d = force_state < 0 ? p[(size_t)r * n_col + i - off[r]] : 0;
    if (state == 0)
      state = d & 7;
    else if (!(d >> (state + 2) & 1))
      state = 0;
    if (state == 0) state = d & 7;
    if (force_state >= 0) state = force_state;
    if (state == 0)
      cb->push(0, 1), --i, --j;  // match column
    else if (state == 1 || (state == 3 && min_intron_len <= 0))
      cb->push(2, 1), --i;  // deletion (short- or long-gap state)
    else if (state == 3 && min_intron_len > 0)
      cb->push(3, 1), --i;  // intron
    else
      cb->push(1, 1), --j;  // insertion
  }
  if (i >= 0)
    cb->push(min_intron_len > 0 && i >= min_intron_len ? 3 : 2, i + 1);
  if (j >= 0) cb->push(1, j + 1);
  if (!rev_cigar) std::reverse(cb->ops.begin(), cb->ops.end());
}

void traceback(const uint8_t* p, const int* off, const int* off_end,
               size_t n_col, int i0, int j0, int rev_cigar, CigarBuf* cb) {
  traceback_intron(p, off, off_end, n_col, i0, j0, rev_cigar, 0, cb);
}

void finish_cigar(CigarBuf& cb, wm_ext_result* ez) {
  ez->n_cigar = (int32_t)cb.ops.size();
  if (ez->n_cigar) {
    ez->cigar = (uint32_t*)wm_malloc(sizeof(uint32_t) * cb.ops.size());
    std::memcpy(ez->cigar, cb.ops.data(), sizeof(uint32_t) * cb.ops.size());
  }
}

}  // namespace

#ifdef WM_SIMD_X86
namespace {

// 64-lane AVX-512BW re-expression of wm_extd's per-row band core.  The
// semantics the scalar oracle encodes (reference src/ksw2_extd2_sse.c) are
// lane-width independent: the 16-lane band ROUNDING is a fixed quantum of
// the algorithm and is kept; only the processing width changes, so results
// are bit-identical to wm_extd for every input (tests/test_extend.py
// ::test_extd_fast_matches_oracle sweeps profiles x flags x fringe cases).
// Dispatch: wm_extd_fast below (runtime cpuid + WM_NO_SIMD escape hatch).
__attribute__((target("avx512f,avx512bw,avx512vl"))) void wm_extd_avx512(
    int qlen, const uint8_t* query, int tlen, const uint8_t* target, int m,
    const int8_t* mat, int8_t q, int8_t e, int8_t q2, int8_t e2, int w,
    int zdrop, int end_bonus, int flag, wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 1 || qlen <= 0 || tlen <= 0) return;
  if (q2 + e2 < q + e) {
    std::swap(q, q2);
    std::swap(e, e2);
  }
  const int qe = q + e;
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const int8_t sc_mch = mat[0], sc_mis = mat[1];
  const int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)(-e2) : mat[m * m - 1];

  if (w < 0) w = tlen > qlen ? tlen : qlen;
  const int wl = w, wr = w;
  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = (((n_col < w + 1 ? n_col : w + 1) + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > 2 * (q + e)) return;

  int long_thres = e != e2 ? (q2 - q) / (e - e2) - 1 : 0;
  if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) ++long_thres;
  const int long_diff = long_thres * (e - e2) - (q2 - q) - e2;

  // +96 pad: 64-wide loads may read past en (never written there)
  const int PAD = 96;
  std::vector<int8_t> u(tlen16 + PAD), v(tlen16 + PAD), x(tlen16 + PAD),
      y(tlen16 + PAD), x2(tlen16 + PAD), y2(tlen16 + PAD), s(tlen16 + PAD);
  std::fill(u.begin(), u.end(), (int8_t)(-q - e));
  std::fill(v.begin(), v.end(), (int8_t)(-q - e));
  std::fill(x.begin(), x.end(), (int8_t)(-q - e));
  std::fill(y.begin(), y.end(), (int8_t)(-q - e));
  std::fill(x2.begin(), x2.end(), (int8_t)(-q2 - e2));
  std::fill(y2.begin(), y2.end(), (int8_t)(-q2 - e2));
  std::fill(s.begin(), s.end(), (int8_t)0);
  // qr gets a 64-byte FRONT pad: the fused score row loads at qidx =
  // qlen-1-r+t with t down to st (16-rounded below st0), so qidx can dip
  // to -15; the pad keeps those (cover-masked-off) lanes in-bounds
  std::vector<uint8_t> qrbuf(((qlen + 15) / 16) * 16 + PAD + 64, 0);
  uint8_t* qr = qrbuf.data() + 64;
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];
  std::vector<uint8_t> tpad(tlen16 + PAD, 0);
  std::memcpy(tpad.data(), target, tlen);
  // old-row x/x2/v shifted by one lane (carry at [0]); fresh per row
  std::vector<int8_t> tx(n_col + PAD), tx2(n_col + PAD), tv(n_col + PAD);

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16 + 16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  const __m512i vzero = _mm512_setzero_si512();
  const __m512i vone = _mm512_set1_epi8(1);
  const __m512i vtwo = _mm512_set1_epi8(2);
  const __m512i vthree = _mm512_set1_epi8(3);
  const __m512i vfour = _mm512_set1_epi8(4);
  const __m512i vN = _mm512_set1_epi8((char)(m - 1));
  const __m512i vmch = _mm512_set1_epi8(sc_mch);
  const __m512i vmis = _mm512_set1_epi8(sc_mis);
  const __m512i vscN = _mm512_set1_epi8(sc_N);
  const __m512i vq = _mm512_set1_epi8(q);
  const __m512i vq2 = _mm512_set1_epi8(q2);
  const __m512i vqe = _mm512_set1_epi8((char)qe);
  const __m512i vq2e2 = _mm512_set1_epi8((char)(q2 + e2));
  const __m512i vb08 = _mm512_set1_epi8(0x08);
  const __m512i vb10 = _mm512_set1_epi8(0x10);
  const __m512i vb20 = _mm512_set1_epi8(0x20);
  const __m512i vb40 = _mm512_set1_epi8(0x40);

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - wr + 1) >> 1) st = (r - wr + 1) >> 1;
    if (en > (r + wl) >> 1) en = (r + wl) >> 1;
    if (st > en) {
      ez->zdropped = 1;
      break;
    }
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en) {
        x1 = x[st - 1], x21 = x2[st - 1], v1 = v[st - 1];
      } else {
        x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2 - e2);
        v1 = (int8_t)(-q - e);
      }
    } else {
      x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2 - e2);
      v1 = r == 0            ? (int8_t)(-q - e)
           : r < long_thres  ? (int8_t)(-e)
           : r == long_thres ? (int8_t)long_diff
                             : (int8_t)(-e2);
    }
    if (en >= r) {
      y[r] = (int8_t)(-q - e), y2[r] = (int8_t)(-q2 - e2);
      u[r] = r == 0            ? (int8_t)(-q - e)
             : r < long_thres  ? (int8_t)(-e)
             : r == long_thres ? (int8_t)long_diff
                               : (int8_t)(-e2);
    }

    // score row fused into the band loop below: new scores cover exactly
    // [st0, cover] (the scalar oracle's 16-block-covered span); lanes
    // outside keep their stale s values, which later rows read
    const int cover = st0 + (en0 - st0) / 16 * 16 + 15;
    const int bq = qlen - 1 - r;  // qidx = bq + t; front pad covers t >= st

    // ---- old-row shifted x/x2/v (carry at lane 0)
    const int len = en - st + 1;  // multiple of 16
    tx[0] = x1;
    tx2[0] = x21;
    tv[0] = v1;
    std::memcpy(tx.data() + 1, x.data() + st, len - 1);
    std::memcpy(tx2.data() + 1, x2.data() + st, len - 1);
    std::memcpy(tv.data() + 1, v.data() + st, len - 1);

    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; t += 64) {
      int rem = en - t + 1;
      __mmask64 km = rem >= 64 ? ~(__mmask64)0
                               : (((__mmask64)1 << rem) - 1);
      const int o = t - st;
      __m512i xt1 = _mm512_loadu_si512((const void*)(tx.data() + o));
      __m512i x2t1 = _mm512_loadu_si512((const void*)(tx2.data() + o));
      __m512i vt1 = _mm512_loadu_si512((const void*)(tv.data() + o));
      __m512i ut = _mm512_loadu_si512((const void*)(u.data() + t));
      __m512i yt = _mm512_loadu_si512((const void*)(y.data() + t));
      __m512i y2t = _mm512_loadu_si512((const void*)(y2.data() + t));
      // fused score row: fresh scores on the cover lanes, stale elsewhere
      __m512i z = _mm512_loadu_si512((const void*)(s.data() + t));
      {
        int lo = st0 > t ? st0 - t : 0;
        int hi = cover - t < 63 ? cover - t : 63;
        if (hi >= lo) {
          __mmask64 kc =
              (hi - lo == 63 ? ~(__mmask64)0
                             : (((__mmask64)1 << (hi - lo + 1)) - 1))
              << lo;
          __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t));
          __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t));
          __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
          __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                         _mm512_cmpeq_epi8_mask(qb, vN);
          __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
          sc = _mm512_mask_mov_epi8(sc, kn, vscN);
          z = _mm512_mask_mov_epi8(z, kc, sc);
          _mm512_mask_storeu_epi8((void*)(s.data() + t), kc, sc);
        }
      }
      __m512i a = _mm512_add_epi8(xt1, vt1);
      __m512i b = _mm512_add_epi8(yt, ut);
      __m512i a2 = _mm512_add_epi8(x2t1, vt1);
      __m512i b2 = _mm512_add_epi8(y2t, ut);
      __m512i d;
      if (!right_gaps) {
        __mmask64 k = _mm512_cmpgt_epi8_mask(a, z);
        d = _mm512_maskz_mov_epi8(k, vone);
        z = _mm512_max_epi8(z, a);
        k = _mm512_cmpgt_epi8_mask(b, z);
        d = _mm512_mask_mov_epi8(d, k, vtwo);
        z = _mm512_max_epi8(z, b);
        k = _mm512_cmpgt_epi8_mask(a2, z);
        d = _mm512_mask_mov_epi8(d, k, vthree);
        z = _mm512_max_epi8(z, a2);
        k = _mm512_cmpgt_epi8_mask(b2, z);
        d = _mm512_mask_mov_epi8(d, k, vfour);
        z = _mm512_max_epi8(z, b2);
      } else {
        __mmask64 k = _mm512_cmpgt_epi8_mask(z, a);
        d = _mm512_mask_mov_epi8(vone, k, vzero);
        z = _mm512_max_epi8(z, a);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, b));
        d = _mm512_mask_mov_epi8(d, k, vtwo);
        z = _mm512_max_epi8(z, b);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, a2));
        d = _mm512_mask_mov_epi8(d, k, vthree);
        z = _mm512_max_epi8(z, a2);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, b2));
        d = _mm512_mask_mov_epi8(d, k, vfour);
        z = _mm512_max_epi8(z, b2);
      }
      z = _mm512_min_epi8(z, vmch);
      __m512i un = _mm512_sub_epi8(z, vt1);
      __m512i vn = _mm512_sub_epi8(z, ut);
      __m512i zq = _mm512_sub_epi8(z, vq);
      __m512i zq2 = _mm512_sub_epi8(z, vq2);
      __m512i an = _mm512_sub_epi8(a, zq);
      __m512i bn = _mm512_sub_epi8(b, zq);
      __m512i a2n = _mm512_sub_epi8(a2, zq2);
      __m512i b2n = _mm512_sub_epi8(b2, zq2);
      __mmask64 ax, bx, a2x, b2x;
      if (!right_gaps) {
        ax = _mm512_cmpgt_epi8_mask(an, vzero);
        bx = _mm512_cmpgt_epi8_mask(bn, vzero);
        a2x = _mm512_cmpgt_epi8_mask(a2n, vzero);
        b2x = _mm512_cmpgt_epi8_mask(b2n, vzero);
      } else {
        ax = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, an));
        bx = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, bn));
        a2x = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, a2n));
        b2x = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, b2n));
      }
      __m512i xn = _mm512_sub_epi8(_mm512_maskz_mov_epi8(ax, an), vqe);
      __m512i yn = _mm512_sub_epi8(_mm512_maskz_mov_epi8(bx, bn), vqe);
      __m512i x2n = _mm512_sub_epi8(_mm512_maskz_mov_epi8(a2x, a2n), vq2e2);
      __m512i y2n = _mm512_sub_epi8(_mm512_maskz_mov_epi8(b2x, b2n), vq2e2);
      d = _mm512_mask_add_epi8(d, ax, d, vb08);
      d = _mm512_mask_add_epi8(d, bx, d, vb10);
      d = _mm512_mask_add_epi8(d, a2x, d, vb20);
      d = _mm512_mask_add_epi8(d, b2x, d, vb40);
      _mm512_mask_storeu_epi8((void*)(u.data() + t), km, un);
      _mm512_mask_storeu_epi8((void*)(v.data() + t), km, vn);
      _mm512_mask_storeu_epi8((void*)(x.data() + t), km, xn);
      _mm512_mask_storeu_epi8((void*)(y.data() + t), km, yn);
      _mm512_mask_storeu_epi8((void*)(x2.data() + t), km, x2n);
      _mm512_mask_storeu_epi8((void*)(y2.data() + t), km, y2n);
      if (with_cigar)
        _mm512_mask_storeu_epi8((void*)(prow + o), km, d);
    }

    // the scalar score row covers [st0, cover], which can stick out past
    // en by up to 15 lanes; those writes are dead for THIS row but later
    // rows read them as stale values — write them too
    if (cover > en) {
      int t0c = en + 1;
      int hi = cover - t0c;  // 0..14
      __mmask64 kc = (((__mmask64)1 << (hi + 1)) - 1);
      __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t0c));
      __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t0c));
      __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
      __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                     _mm512_cmpeq_epi8_mask(qb, vN);
      __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
      sc = _mm512_mask_mov_epi8(sc, kn, vscN);
      _mm512_mask_storeu_epi8((void*)(s.data() + t0c), kc, sc);
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0]
                                 : H[en0] + (int32_t)v[en0];
        max_t = en0;
        // H update + 4-lane-strided max with the oracle's exact tie order:
        // 16 i32 lanes track (max, first-t); lanes l, l+4, l+8, l+12 fold
        // into stride class l with (H desc, t asc) — equivalent to the
        // scalar first-t-wins scan because each lane keeps its own first
        // achiever and classes partition by (t - st0) & 3
        int en1 = st0 + (en0 - st0) / 4 * 4;
        int32_t HH[4], tt[4];
        for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
        int t = st0;
        int en1_16 = st0 + (en1 - st0) / 16 * 16;
        if (en1_16 - st0 >= 16) {
          __m512i vmax = _mm512_set1_epi32(max_H);
          __m512i vidx = _mm512_set1_epi32(en0);
          const __m512i lane_iota = _mm512_setr_epi32(
              0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
          for (; t < en1_16; t += 16) {
            __m128i v8 = _mm_loadu_si128((const __m128i*)(v.data() + t));
            __m512i Hv = _mm512_add_epi32(
                _mm512_loadu_si512((const void*)(H.data() + t)),
                _mm512_cvtepi8_epi32(v8));
            _mm512_storeu_si512((void*)(H.data() + t), Hv);
            __mmask16 kk = _mm512_cmpgt_epi32_mask(Hv, vmax);
            vmax = _mm512_mask_mov_epi32(vmax, kk, Hv);
            vidx = _mm512_mask_mov_epi32(
                vidx, kk, _mm512_add_epi32(lane_iota, _mm512_set1_epi32(t)));
          }
          int32_t lm[16], li[16];
          _mm512_storeu_si512((void*)lm, vmax);
          _mm512_storeu_si512((void*)li, vidx);
          for (int l = 0; l < 4; ++l)
            for (int j = l; j < 16; j += 4)
              if (lm[j] > HH[l] || (lm[j] == HH[l] && li[j] < tt[l]))
                HH[l] = lm[j], tt[l] = li[j];
        }
        for (; t < en1; t += 4)
          for (int l = 0; l < 4; ++l) {
            H[t + l] += (int32_t)v[t + l];
            if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
          }
        for (int l = 0; l < 4; ++l)
          if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
        for (; t < en0; ++t) {
          H[t] += (int32_t)v[t];
          if (H[t] > max_H) max_H = H[t], max_t = t;
        }
      } else {
        H[0] = (int32_t)v[0] - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte) ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe) ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, e2)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t];
          int32_t d1 = (int32_t)u[last_H0_t + 1];
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t];
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t];
        }
        if ((flag & WM_EZ_APPROX_DROP) &&
            apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2))
          break;
      } else {
        H0 = (int32_t)v[0] - qe;
        last_H0_t = 0;
      }
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY)) {
      traceback(p.data(), off.data(), off_end.data(), n_col, tlen - 1, qlen - 1,
                rev_cigar, &cb);
    } else if (!ez->zdropped && (flag & WM_EZ_EXTZ_ONLY) &&
               ez->mqe + end_bonus > (int32_t)ez->max) {
      ez->reach_end = 1;
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->mqe_t,
                qlen - 1, rev_cigar, &cb);
    } else if (ez->max_t >= 0 && ez->max_q >= 0) {
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                ez->max_q, rev_cigar, &cb);
    }
    finish_cigar(cb, ez);
  }
}

// 64-lane AVX-512BW core for the single-cost kernel (reference
// ksw2_extz2_sse.c as encoded by the scalar wm_extz below).  State is
// biased-unsigned uint8 exactly like the SSE kernel; the mixed
// signed-compare / unsigned-max semantics of the scalar (epi8 compares for
// the direction bits, epu8 max/min for the clamp) are preserved
// instruction-for-instruction.  Bit-identical to wm_extz
// (tests/test_extend.py::test_extz_fast_matches_oracle).
__attribute__((target("avx512f,avx512bw,avx512vl"))) void wm_extz_avx512(
    int qlen, const uint8_t* query, int tlen, const uint8_t* target, int m,
    const int8_t* mat, int8_t q, int8_t e, int w, int zdrop, int end_bonus,
    int flag, wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 0 || qlen <= 0 || tlen <= 0) return;

  const int qe = q + e, qe2 = 2 * (q + e);
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const uint8_t sc_mch = (uint8_t)mat[0];
  const uint8_t sc_mis = (uint8_t)mat[1];
  const uint8_t sc_N =
      mat[m * m - 1] == 0 ? (uint8_t)(-e) : (uint8_t)mat[m * m - 1];
  const uint8_t max_sc = (uint8_t)(mat[0] + qe2);

  if (w < 0) w = tlen > qlen ? tlen : qlen;
  const int wl = w, wr = w;
  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = (((n_col < w + 1 ? n_col : w + 1) + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > qe2) return;

  const int PAD = 96;
  std::vector<uint8_t> u(tlen16 + PAD, 0), v(tlen16 + PAD, 0),
      x(tlen16 + PAD, 0), y(tlen16 + PAD, 0), s(tlen16 + PAD, 0);
  std::vector<uint8_t> qrbuf(((qlen + 15) / 16) * 16 + PAD + 64, 0);
  uint8_t* qr = qrbuf.data() + 64;
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];
  std::vector<uint8_t> tpad(tlen16 + PAD, 0);
  std::memcpy(tpad.data(), target, tlen);
  std::vector<uint8_t> tx(n_col + PAD), tv(n_col + PAD);

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16 + 16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  const __m512i vzero = _mm512_setzero_si512();
  const __m512i vone = _mm512_set1_epi8(1);
  const __m512i vtwo = _mm512_set1_epi8(2);
  const __m512i vN = _mm512_set1_epi8((char)(m - 1));
  const __m512i vmch = _mm512_set1_epi8((char)sc_mch);
  const __m512i vmis = _mm512_set1_epi8((char)sc_mis);
  const __m512i vscN = _mm512_set1_epi8((char)sc_N);
  const __m512i vq = _mm512_set1_epi8(q);
  const __m512i vqe2 = _mm512_set1_epi8((char)qe2);
  const __m512i vmaxsc = _mm512_set1_epi8((char)max_sc);
  const __m512i vb08 = _mm512_set1_epi8(0x08);
  const __m512i vb10 = _mm512_set1_epi8(0x10);

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - wr + 1) >> 1) st = (r - wr + 1) >> 1;
    if (en > (r + wl) >> 1) en = (r + wl) >> 1;
    if (st > en) {
      ez->zdropped = 1;
      break;
    }
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    uint8_t x1, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en)
        x1 = x[st - 1], v1 = v[st - 1];
      else
        x1 = v1 = 0;
    } else {
      x1 = 0;
      v1 = r ? (uint8_t)q : 0;
    }
    if (en >= r) y[r] = 0, u[r] = r ? (uint8_t)q : 0;

    const int cover = st0 + (en0 - st0) / 16 * 16 + 15;
    const int bq = qlen - 1 - r;

    const int len = en - st + 1;
    tx[0] = x1;
    tv[0] = v1;
    std::memcpy(tx.data() + 1, x.data() + st, len - 1);
    std::memcpy(tv.data() + 1, v.data() + st, len - 1);

    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; t += 64) {
      int rem = en - t + 1;
      __mmask64 km = rem >= 64 ? ~(__mmask64)0
                               : (((__mmask64)1 << rem) - 1);
      const int o = t - st;
      __m512i xt1 = _mm512_loadu_si512((const void*)(tx.data() + o));
      __m512i vt1 = _mm512_loadu_si512((const void*)(tv.data() + o));
      __m512i ut = _mm512_loadu_si512((const void*)(u.data() + t));
      __m512i yt = _mm512_loadu_si512((const void*)(y.data() + t));
      __m512i sv = _mm512_loadu_si512((const void*)(s.data() + t));
      {
        int lo = st0 > t ? st0 - t : 0;
        int hi = cover - t < 63 ? cover - t : 63;
        if (hi >= lo) {
          __mmask64 kc =
              (hi - lo == 63 ? ~(__mmask64)0
                             : (((__mmask64)1 << (hi - lo + 1)) - 1))
              << lo;
          __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t));
          __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t));
          __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
          __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                         _mm512_cmpeq_epi8_mask(qb, vN);
          __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
          sc = _mm512_mask_mov_epi8(sc, kn, vscN);
          sv = _mm512_mask_mov_epi8(sv, kc, sc);
          _mm512_mask_storeu_epi8((void*)(s.data() + t), kc, sc);
        }
      }
      __m512i z = _mm512_add_epi8(sv, vqe2);
      __m512i a = _mm512_add_epi8(xt1, vt1);
      __m512i b = _mm512_add_epi8(yt, ut);
      __m512i d;
      if (!right_gaps) {
        __mmask64 k = _mm512_cmpgt_epi8_mask(a, z);
        d = _mm512_maskz_mov_epi8(k, vone);
        z = _mm512_max_epi8(z, a);
        k = _mm512_cmpgt_epi8_mask(b, z);
        d = _mm512_mask_mov_epi8(d, k, vtwo);
      } else {
        __mmask64 k = _mm512_cmpgt_epi8_mask(z, a);
        d = _mm512_mask_mov_epi8(vone, k, vzero);
        z = _mm512_max_epi8(z, a);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, b));
        d = _mm512_mask_mov_epi8(d, k, vtwo);
      }
      z = _mm512_max_epu8(z, b);
      z = _mm512_min_epu8(z, vmaxsc);
      __m512i un = _mm512_sub_epi8(z, vt1);
      __m512i vn = _mm512_sub_epi8(z, ut);
      __m512i zq = _mm512_sub_epi8(z, vq);
      __m512i an = _mm512_sub_epi8(a, zq);
      __m512i bn = _mm512_sub_epi8(b, zq);
      __mmask64 ax, bx;
      if (!right_gaps) {
        ax = _mm512_cmpgt_epi8_mask(an, vzero);
        bx = _mm512_cmpgt_epi8_mask(bn, vzero);
      } else {
        ax = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, an));
        bx = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, bn));
      }
      __m512i xn = _mm512_maskz_mov_epi8(ax, an);
      __m512i yn = _mm512_maskz_mov_epi8(bx, bn);
      d = _mm512_mask_add_epi8(d, ax, d, vb08);
      d = _mm512_mask_add_epi8(d, bx, d, vb10);
      _mm512_mask_storeu_epi8((void*)(u.data() + t), km, un);
      _mm512_mask_storeu_epi8((void*)(v.data() + t), km, vn);
      _mm512_mask_storeu_epi8((void*)(x.data() + t), km, xn);
      _mm512_mask_storeu_epi8((void*)(y.data() + t), km, yn);
      if (with_cigar)
        _mm512_mask_storeu_epi8((void*)(prow + o), km, d);
    }

    if (cover > en) {
      int t0c = en + 1;
      int hi = cover - t0c;
      __mmask64 kc = (((__mmask64)1 << (hi + 1)) - 1);
      __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t0c));
      __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t0c));
      __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
      __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                     _mm512_cmpeq_epi8_mask(qb, vN);
      __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
      sc = _mm512_mask_mov_epi8(sc, kn, vscN);
      _mm512_mask_storeu_epi8((void*)(s.data() + t0c), kc, sc);
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0] - qe
                                 : H[en0] + (int32_t)v[en0] - qe;
        max_t = en0;
        int en1 = st0 + (en0 - st0) / 4 * 4;
        int32_t HH[4], tt[4];
        for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
        int t = st0;
        int en1_16 = st0 + (en1 - st0) / 16 * 16;
        if (en1_16 - st0 >= 16) {
          __m512i vmax = _mm512_set1_epi32(max_H);
          __m512i vidx = _mm512_set1_epi32(en0);
          const __m512i vqe32 = _mm512_set1_epi32(qe);
          const __m512i lane_iota = _mm512_setr_epi32(
              0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
          for (; t < en1_16; t += 16) {
            __m128i v8 = _mm_loadu_si128((const __m128i*)(v.data() + t));
            __m512i Hv = _mm512_sub_epi32(
                _mm512_add_epi32(
                    _mm512_loadu_si512((const void*)(H.data() + t)),
                    _mm512_cvtepu8_epi32(v8)),
                vqe32);
            _mm512_storeu_si512((void*)(H.data() + t), Hv);
            __mmask16 kk = _mm512_cmpgt_epi32_mask(Hv, vmax);
            vmax = _mm512_mask_mov_epi32(vmax, kk, Hv);
            vidx = _mm512_mask_mov_epi32(
                vidx, kk, _mm512_add_epi32(lane_iota, _mm512_set1_epi32(t)));
          }
          int32_t lm[16], li[16];
          _mm512_storeu_si512((void*)lm, vmax);
          _mm512_storeu_si512((void*)li, vidx);
          for (int l = 0; l < 4; ++l)
            for (int j = l; j < 16; j += 4)
              if (lm[j] > HH[l] || (lm[j] == HH[l] && li[j] < tt[l]))
                HH[l] = lm[j], tt[l] = li[j];
        }
        for (; t < en1; t += 4)
          for (int l = 0; l < 4; ++l) {
            H[t + l] += (int32_t)v[t + l] - qe;
            if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
          }
        for (int l = 0; l < 4; ++l)
          if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
        for (; t < en0; ++t) {
          H[t] += (int32_t)v[t] - qe;
          if (H[t] > max_H) max_H = H[t], max_t = t;
        }
      } else {
        H[0] = (int32_t)v[0] - qe - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte) ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe) ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, e)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t] - qe;
          int32_t d1 = (int32_t)u[last_H0_t + 1] - qe;
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t] - qe;
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t] - qe;
        }
        if ((flag & WM_EZ_APPROX_DROP) &&
            apply_zdrop(ez, H0, r, last_H0_t, zdrop, e))
          break;
      } else {
        H0 = (int32_t)v[0] - qe - qe;
        last_H0_t = 0;
      }
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY)) {
      traceback(p.data(), off.data(), off_end.data(), n_col, tlen - 1, qlen - 1,
                rev_cigar, &cb);
    } else if (!ez->zdropped && (flag & WM_EZ_EXTZ_ONLY) &&
               ez->mqe + end_bonus > (int32_t)ez->max) {
      ez->reach_end = 1;
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->mqe_t,
                qlen - 1, rev_cigar, &cb);
    } else if (ez->max_t >= 0 && ez->max_q >= 0) {
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                ez->max_q, rev_cigar, &cb);
    }
    finish_cigar(cb, ez);
  }
}

// 64-lane AVX-512BW core for the spliced kernel (reference
// ksw2_exts2_sse.c semantics as encoded by the scalar wm_exts below):
// x2 is the intron channel opened against the per-position donor floor and
// closed with the acceptor score; unbanded rows; no score clamp; boundary
// ladder tail 0; zdrop gap penalty 0.  Bit-identical to wm_exts
// (tests/test_extend.py::test_exts_fast_matches_oracle).
__attribute__((target("avx512f,avx512bw,avx512vl"))) void wm_exts_avx512(
    int qlen, const uint8_t* query, int tlen, const uint8_t* target, int m,
    const int8_t* mat, int8_t q, int8_t e, int8_t q2, int8_t noncan,
    int zdrop, int8_t junc_bonus, int flag, const uint8_t* junc,
    wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 1 || qlen <= 0 || tlen <= 0 || q2 <= q + e) return;

  const int qe = q + e;
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
  const int8_t sc_mch = mat[0], sc_mis = mat[1];
  const int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)(-e) : mat[m * m - 1];

  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = ((n_col + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > 2 * (q + e)) return;

  int long_thres = (q2 - q) / e - 1;
  if (q2 > q + e + long_thres * e) ++long_thres;
  const int long_diff = long_thres * e - (q2 - q);

  const int PAD = 96;
  std::vector<int8_t> u(tlen16 + PAD), v(tlen16 + PAD), x(tlen16 + PAD),
      y(tlen16 + PAD), x2(tlen16 + PAD), s(tlen16 + PAD, 0),
      donor(tlen16 + PAD, 0), acceptor(tlen16 + PAD, 0);
  std::fill(u.begin(), u.end(), (int8_t)(-q - e));
  std::fill(v.begin(), v.end(), (int8_t)(-q - e));
  std::fill(x.begin(), x.end(), (int8_t)(-q - e));
  std::fill(y.begin(), y.end(), (int8_t)(-q - e));
  std::fill(x2.begin(), x2.end(), (int8_t)(-q2));
  std::vector<uint8_t> qrbuf(((qlen + 15) / 16) * 16 + PAD + 64, 0);
  uint8_t* qr = qrbuf.data() + 64;
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];
  std::vector<uint8_t> tpad(tlen16 + PAD, 0);
  std::memcpy(tpad.data(), target, tlen);
  std::vector<int8_t> tx(n_col + PAD), tx2(n_col + PAD), tv(n_col + PAD);

  // donor/acceptor site scores: identical scalar precompute to wm_exts
  const int spl_for = !!(flag & WM_EZ_SPLICE_FOR);
  const int spl_rev = !!(flag & WM_EZ_SPLICE_REV);
  if (spl_for || spl_rev) {
    int semi_cost = (flag & WM_EZ_SPLICE_FLANK) ? -noncan / 2 : 0;
    std::fill(donor.begin(), donor.begin() + tlen16 + 32, (int8_t)(-noncan));
    std::fill(acceptor.begin(), acceptor.begin() + tlen16 + 32,
              (int8_t)(-noncan));
    if (!rev_cigar) {
      for (int t = 0; t < tlen - 4; ++t) {
        int can_type = 0;
        if (spl_for && target[t + 1] == 2 && target[t + 2] == 3) can_type = 1;
        if (spl_rev && target[t + 1] == 1 && target[t + 2] == 3) can_type = 1;
        if (can_type && (target[t + 3] == 0 || target[t + 3] == 2))
          can_type = 2;
        if (can_type) donor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen - 1; ++t)
          if ((spl_for && (junc[t + 1] & 1)) || (spl_rev && (junc[t + 1] & 8)))
            donor[t] = (int8_t)(donor[t] + junc_bonus);
      for (int t = 2; t < tlen; ++t) {
        int can_type = 0;
        if (spl_for && target[t - 1] == 0 && target[t] == 2) can_type = 1;
        if (spl_rev && target[t - 1] == 0 && target[t] == 1) can_type = 1;
        if (can_type && (target[t - 2] == 1 || target[t - 2] == 3))
          can_type = 2;
        if (can_type) acceptor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen; ++t)
          if ((spl_for && (junc[t] & 2)) || (spl_rev && (junc[t] & 4)))
            acceptor[t] = (int8_t)(acceptor[t] + junc_bonus);
    } else {
      for (int t = 0; t < tlen - 4; ++t) {
        int can_type = 0;
        if (spl_for && target[t + 1] == 2 && target[t + 2] == 0) can_type = 1;
        if (spl_rev && target[t + 1] == 1 && target[t + 2] == 0) can_type = 1;
        if (can_type && (target[t + 3] == 1 || target[t + 3] == 3))
          can_type = 2;
        if (can_type) donor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen - 1; ++t)
          if ((spl_for && (junc[t + 1] & 2)) || (spl_rev && (junc[t + 1] & 4)))
            donor[t] = (int8_t)(donor[t] + junc_bonus);
      for (int t = 2; t < tlen; ++t) {
        int can_type = 0;
        if (spl_for && target[t - 1] == 3 && target[t] == 2) can_type = 1;
        if (spl_rev && target[t - 1] == 3 && target[t] == 1) can_type = 1;
        if (can_type && (target[t - 2] == 0 || target[t - 2] == 2))
          can_type = 2;
        if (can_type) acceptor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen; ++t)
          if ((spl_for && (junc[t] & 1)) || (spl_rev && (junc[t] & 8)))
            acceptor[t] = (int8_t)(acceptor[t] + junc_bonus);
    }
  }

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16 + 16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  const __m512i vzero = _mm512_setzero_si512();
  const __m512i vone = _mm512_set1_epi8(1);
  const __m512i vtwo = _mm512_set1_epi8(2);
  const __m512i vthree = _mm512_set1_epi8(3);
  const __m512i vN = _mm512_set1_epi8((char)(m - 1));
  const __m512i vmch = _mm512_set1_epi8(sc_mch);
  const __m512i vmis = _mm512_set1_epi8(sc_mis);
  const __m512i vscN = _mm512_set1_epi8(sc_N);
  const __m512i vq = _mm512_set1_epi8(q);
  const __m512i vq2 = _mm512_set1_epi8(q2);
  const __m512i vqe = _mm512_set1_epi8((char)qe);
  const __m512i vb08 = _mm512_set1_epi8(0x08);
  const __m512i vb10 = _mm512_set1_epi8(0x10);
  const __m512i vb20 = _mm512_set1_epi8(0x20);

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en)
        x1 = x[st - 1], x21 = x2[st - 1], v1 = v[st - 1];
      else
        x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2), v1 = (int8_t)(-q - e);
    } else {
      x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2);
      v1 = r == 0            ? (int8_t)(-q - e)
           : r < long_thres  ? (int8_t)(-e)
           : r == long_thres ? (int8_t)long_diff
                             : (int8_t)0;
    }
    if (en >= r) {
      y[r] = (int8_t)(-q - e);
      u[r] = r == 0            ? (int8_t)(-q - e)
             : r < long_thres  ? (int8_t)(-e)
             : r == long_thres ? (int8_t)long_diff
                               : (int8_t)0;
    }

    const int cover = st0 + (en0 - st0) / 16 * 16 + 15;
    const int bq = qlen - 1 - r;

    const int len = en - st + 1;
    tx[0] = x1;
    tx2[0] = x21;
    tv[0] = v1;
    std::memcpy(tx.data() + 1, x.data() + st, len - 1);
    std::memcpy(tx2.data() + 1, x2.data() + st, len - 1);
    std::memcpy(tv.data() + 1, v.data() + st, len - 1);

    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; t += 64) {
      int rem = en - t + 1;
      __mmask64 km = rem >= 64 ? ~(__mmask64)0
                               : (((__mmask64)1 << rem) - 1);
      const int o = t - st;
      __m512i xt1 = _mm512_loadu_si512((const void*)(tx.data() + o));
      __m512i x2t1 = _mm512_loadu_si512((const void*)(tx2.data() + o));
      __m512i vt1 = _mm512_loadu_si512((const void*)(tv.data() + o));
      __m512i ut = _mm512_loadu_si512((const void*)(u.data() + t));
      __m512i yt = _mm512_loadu_si512((const void*)(y.data() + t));
      __m512i vdon = _mm512_loadu_si512((const void*)(donor.data() + t));
      __m512i vacc = _mm512_loadu_si512((const void*)(acceptor.data() + t));
      __m512i z = _mm512_loadu_si512((const void*)(s.data() + t));
      {
        int lo = st0 > t ? st0 - t : 0;
        int hi = cover - t < 63 ? cover - t : 63;
        if (hi >= lo) {
          __mmask64 kc =
              (hi - lo == 63 ? ~(__mmask64)0
                             : (((__mmask64)1 << (hi - lo + 1)) - 1))
              << lo;
          __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t));
          __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t));
          __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
          __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                         _mm512_cmpeq_epi8_mask(qb, vN);
          __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
          sc = _mm512_mask_mov_epi8(sc, kn, vscN);
          z = _mm512_mask_mov_epi8(z, kc, sc);
          _mm512_mask_storeu_epi8((void*)(s.data() + t), kc, sc);
        }
      }
      __m512i a = _mm512_add_epi8(xt1, vt1);
      __m512i b = _mm512_add_epi8(yt, ut);
      __m512i a2 = _mm512_add_epi8(x2t1, vt1);
      __m512i a2a = _mm512_add_epi8(a2, vacc);
      __m512i d;
      if (!right_gaps) {
        __mmask64 k = _mm512_cmpgt_epi8_mask(a, z);
        d = _mm512_maskz_mov_epi8(k, vone);
        z = _mm512_max_epi8(z, a);
        k = _mm512_cmpgt_epi8_mask(b, z);
        d = _mm512_mask_mov_epi8(d, k, vtwo);
        z = _mm512_max_epi8(z, b);
        k = _mm512_cmpgt_epi8_mask(a2a, z);
        d = _mm512_mask_mov_epi8(d, k, vthree);
        z = _mm512_max_epi8(z, a2a);
      } else {
        __mmask64 k = _mm512_cmpgt_epi8_mask(z, a);
        d = _mm512_mask_mov_epi8(vone, k, vzero);
        z = _mm512_max_epi8(z, a);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, b));
        d = _mm512_mask_mov_epi8(d, k, vtwo);
        z = _mm512_max_epi8(z, b);
        k = _knot_mask64(_mm512_cmpgt_epi8_mask(z, a2a));
        d = _mm512_mask_mov_epi8(d, k, vthree);
        z = _mm512_max_epi8(z, a2a);
      }
      __m512i un = _mm512_sub_epi8(z, vt1);
      __m512i vn = _mm512_sub_epi8(z, ut);
      __m512i zq = _mm512_sub_epi8(z, vq);
      __m512i zq2 = _mm512_sub_epi8(z, vq2);
      __m512i an = _mm512_sub_epi8(a, zq);
      __m512i bn = _mm512_sub_epi8(b, zq);
      __m512i a2n = _mm512_sub_epi8(a2, zq2);
      __mmask64 ax, bx, a2x;
      if (!right_gaps) {
        ax = _mm512_cmpgt_epi8_mask(an, vzero);
        bx = _mm512_cmpgt_epi8_mask(bn, vzero);
        a2x = _mm512_cmpgt_epi8_mask(a2n, vdon);
      } else {
        ax = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, an));
        bx = _knot_mask64(_mm512_cmpgt_epi8_mask(vzero, bn));
        a2x = _knot_mask64(_mm512_cmpgt_epi8_mask(vdon, a2n));
      }
      __m512i xn = _mm512_sub_epi8(_mm512_maskz_mov_epi8(ax, an), vqe);
      __m512i yn = _mm512_sub_epi8(_mm512_maskz_mov_epi8(bx, bn), vqe);
      __m512i x2n = _mm512_sub_epi8(
          _mm512_mask_mov_epi8(vdon, a2x, a2n), vq2);
      d = _mm512_mask_add_epi8(d, ax, d, vb08);
      d = _mm512_mask_add_epi8(d, bx, d, vb10);
      d = _mm512_mask_add_epi8(d, a2x, d, vb20);
      _mm512_mask_storeu_epi8((void*)(u.data() + t), km, un);
      _mm512_mask_storeu_epi8((void*)(v.data() + t), km, vn);
      _mm512_mask_storeu_epi8((void*)(x.data() + t), km, xn);
      _mm512_mask_storeu_epi8((void*)(y.data() + t), km, yn);
      _mm512_mask_storeu_epi8((void*)(x2.data() + t), km, x2n);
      if (with_cigar)
        _mm512_mask_storeu_epi8((void*)(prow + o), km, d);
    }

    if (cover > en) {
      int t0c = en + 1;
      int hi = cover - t0c;
      __mmask64 kc = (((__mmask64)1 << (hi + 1)) - 1);
      __m512i ta = _mm512_loadu_si512((const void*)(tpad.data() + t0c));
      __m512i qb = _mm512_loadu_si512((const void*)(qr + bq + t0c));
      __mmask64 keq = _mm512_cmpeq_epi8_mask(ta, qb);
      __mmask64 kn = _mm512_cmpeq_epi8_mask(ta, vN) |
                     _mm512_cmpeq_epi8_mask(qb, vN);
      __m512i sc = _mm512_mask_mov_epi8(vmis, keq, vmch);
      sc = _mm512_mask_mov_epi8(sc, kn, vscN);
      _mm512_mask_storeu_epi8((void*)(s.data() + t0c), kc, sc);
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0]
                                 : H[en0] + (int32_t)v[en0];
        max_t = en0;
        int en1 = st0 + (en0 - st0) / 4 * 4;
        int32_t HH[4], tt[4];
        for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
        int t = st0;
        int en1_16 = st0 + (en1 - st0) / 16 * 16;
        if (en1_16 - st0 >= 16) {
          __m512i vmax = _mm512_set1_epi32(max_H);
          __m512i vidx = _mm512_set1_epi32(en0);
          const __m512i lane_iota = _mm512_setr_epi32(
              0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
          for (; t < en1_16; t += 16) {
            __m128i v8 = _mm_loadu_si128((const __m128i*)(v.data() + t));
            __m512i Hv = _mm512_add_epi32(
                _mm512_loadu_si512((const void*)(H.data() + t)),
                _mm512_cvtepi8_epi32(v8));
            _mm512_storeu_si512((void*)(H.data() + t), Hv);
            __mmask16 kk = _mm512_cmpgt_epi32_mask(Hv, vmax);
            vmax = _mm512_mask_mov_epi32(vmax, kk, Hv);
            vidx = _mm512_mask_mov_epi32(
                vidx, kk, _mm512_add_epi32(lane_iota, _mm512_set1_epi32(t)));
          }
          int32_t lm[16], li[16];
          _mm512_storeu_si512((void*)lm, vmax);
          _mm512_storeu_si512((void*)li, vidx);
          for (int l = 0; l < 4; ++l)
            for (int j = l; j < 16; j += 4)
              if (lm[j] > HH[l] || (lm[j] == HH[l] && li[j] < tt[l]))
                HH[l] = lm[j], tt[l] = li[j];
        }
        for (; t < en1; t += 4)
          for (int l = 0; l < 4; ++l) {
            H[t + l] += (int32_t)v[t + l];
            if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
          }
        for (int l = 0; l < 4; ++l)
          if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
        for (; t < en0; ++t) {
          H[t] += (int32_t)v[t];
          if (H[t] > max_H) max_H = H[t], max_t = t;
        }
      } else {
        H[0] = (int32_t)v[0] - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte)
        ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe)
        ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, 0)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t];
          int32_t d1 = (int32_t)u[last_H0_t + 1];
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t];
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t];
        }
      } else {
        H0 = (int32_t)v[0] - qe;
        last_H0_t = 0;
      }
      if ((flag & WM_EZ_APPROX_DROP) &&
          apply_zdrop(ez, H0, r, last_H0_t, zdrop, 0))
        break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY))
      traceback_intron(p.data(), off.data(), off_end.data(), n_col, tlen - 1,
                       qlen - 1, rev_cigar, long_thres, &cb);
    else if (ez->max_t >= 0 && ez->max_q >= 0)
      traceback_intron(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                       ez->max_q, rev_cigar, long_thres, &cb);
    finish_cigar(cb, ez);
  }
}

}  // namespace
#endif  // WM_SIMD_X86

extern "C" {

void* wm_malloc(size_t n) { return std::malloc(n ? n : 1); }
void wm_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Single-gap-cost extension (reference ksw_extz2_sse, src/ksw2_extz2_sse.c).
// State is kept in *biased unsigned* int8 exactly like the SIMD kernel: the
// stored u/v include a +q+e bias so everything is non-negative.
// ---------------------------------------------------------------------------
void wm_extz(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int w, int zdrop,
             int end_bonus, int flag, wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 0 || qlen <= 0 || tlen <= 0) return;

  const int qe = q + e, qe2 = 2 * (q + e);
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const uint8_t sc_mch = (uint8_t)mat[0];
  const uint8_t sc_mis = (uint8_t)mat[1];
  const uint8_t sc_N =
      mat[m * m - 1] == 0 ? (uint8_t)(-e) : (uint8_t)mat[m * m - 1];
  const uint8_t max_sc = (uint8_t)(mat[0] + qe2);

  if (w < 0) w = tlen > qlen ? tlen : qlen;
  const int wl = w, wr = w;
  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = (((n_col < w + 1 ? n_col : w + 1) + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > qe2) return;  // mismatches unreachable; same guard as reference

  // biased-unsigned state rows (zero-initialised like the reference kcalloc)
  std::vector<uint8_t> u(tlen16 + 32, 0), v(tlen16 + 32, 0), x(tlen16 + 32, 0),
      y(tlen16 + 32, 0), s(tlen16 + 32, 0);
  std::vector<uint8_t> qr(((qlen + 15) / 16) * 16 + 16, 0);
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - wr + 1) >> 1) st = (r - wr + 1) >> 1;
    if (en > (r + wl) >> 1) en = (r + wl) >> 1;
    if (st > en) {
      ez->zdropped = 1;
      break;
    }
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    // boundary cell (r-1, st-1)
    uint8_t x1, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en)
        x1 = x[st - 1], v1 = v[st - 1];
      else
        x1 = v1 = 0;
    } else {
      x1 = 0;
      v1 = r ? (uint8_t)q : 0;
    }
    if (en >= r) y[r] = 0, u[r] = r ? (uint8_t)q : 0;

    // score row (chunked stores of 16, replicating the SIMD coverage range)
    if (!(flag & WM_EZ_GENERIC_SC)) {
      for (int t = st0; t <= en0; t += 16)
        for (int l = 0; l < 16; ++l) {
          int tt = t + l;
          uint8_t a = target[tt < tlen ? tt : tlen - 1];
          if (tt >= tlen) a = 0;  // defensive; reference reads past-end pad
          int qidx = qlen - 1 - r + tt;
          uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
          uint8_t sc = (a == m - 1 || b == m - 1) ? sc_N
                       : (a == b)                 ? sc_mch
                                                  : sc_mis;
          if (tt < (int)s.size()) s[tt] = sc;
        }
    } else {
      for (int t = st0; t <= en0; ++t) {
        int qidx = qlen - 1 - r + t;
        uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
        s[t] = (uint8_t)mat[target[t] * m + b];
      }
    }

    // core lane sweep with previous-row carries
    uint8_t carry_x = x1, carry_v = v1;
    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; ++t) {
      const uint8_t xt1 = carry_x, vt1 = carry_v;  // previous row, lane t-1
      const uint8_t ut = u[t];                     // previous row, lane t
      carry_x = x[t];
      carry_v = v[t];
      uint8_t z = (uint8_t)(s[t] + qe2);
      const uint8_t a = (uint8_t)(xt1 + vt1);
      const uint8_t b = (uint8_t)(y[t] + ut);
      uint8_t d;
      if (!right_gaps) {
        d = (int8_t)a > (int8_t)z ? 1 : 0;
        z = (uint8_t)std::max((int8_t)z, (int8_t)a);
        if ((int8_t)b > (int8_t)z) d = 2;
      } else {
        d = (int8_t)z > (int8_t)a ? 0 : 1;
        z = (uint8_t)std::max((int8_t)z, (int8_t)a);
        if (!((int8_t)z > (int8_t)b)) d = 2;
      }
      z = std::max(z, b);  // unsigned, like _mm_max_epu8
      z = std::min(z, max_sc);
      u[t] = (uint8_t)(z - vt1);
      v[t] = (uint8_t)(z - ut);
      const uint8_t zq = (uint8_t)(z - (uint8_t)q);
      const uint8_t an = (uint8_t)(a - zq);
      const uint8_t bn = (uint8_t)(b - zq);
      if (!right_gaps) {
        const bool ax = (int8_t)an > 0, bx = (int8_t)bn > 0;
        x[t] = ax ? an : 0;
        y[t] = bx ? bn : 0;
        if (ax) d |= 0x08;
        if (bx) d |= 0x10;
      } else {
        const bool ax = !(0 > (int8_t)an), bx = !(0 > (int8_t)bn);
        x[t] = ax ? an : 0;
        y[t] = bx ? bn : 0;
        if (ax) d |= 0x08;
        if (bx) d |= 0x10;
      }
      if (with_cigar) prow[t - st] = d;
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0] - qe
                                 : H[en0] + (int32_t)v[en0] - qe;
        max_t = en0;
        // 4-lane strided max like the SIMD reference: per-lane running
        // maxima are combined lane 0..3 with strict >, then a scalar tail.
        // This changes which t wins a tied maximum (lane order, not
        // ascending t), and the tie choice is observable via max_q/max_t.
        {
          int en1 = st0 + (en0 - st0) / 4 * 4;
          int32_t HH[4], tt[4];
          for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
          int t = st0;
          for (; t < en1; t += 4)
            for (int l = 0; l < 4; ++l) {
              H[t + l] += (int32_t)v[t + l] - qe;
              if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
            }
          for (int l = 0; l < 4; ++l)
            if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
          for (; t < en0; ++t) {
            H[t] += (int32_t)v[t] - qe;
            if (H[t] > max_H) max_H = H[t], max_t = t;
          }
        }
      } else {
        H[0] = (int32_t)v[0] - qe - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte) ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe) ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, e)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t] - qe;
          int32_t d1 = (int32_t)u[last_H0_t + 1] - qe;
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t] - qe;
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t] - qe;
        }
        if ((flag & WM_EZ_APPROX_DROP) &&
            apply_zdrop(ez, H0, r, last_H0_t, zdrop, e))
          break;
      } else {
        H0 = (int32_t)v[0] - qe - qe;
        last_H0_t = 0;
      }
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY)) {
      traceback(p.data(), off.data(), off_end.data(), n_col, tlen - 1, qlen - 1,
                rev_cigar, &cb);
    } else if (!ez->zdropped && (flag & WM_EZ_EXTZ_ONLY) &&
               ez->mqe + end_bonus > (int32_t)ez->max) {
      ez->reach_end = 1;
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->mqe_t,
                qlen - 1, rev_cigar, &cb);
    } else if (ez->max_t >= 0 && ez->max_q >= 0) {
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                ez->max_q, rev_cigar, &cb);
    }
    finish_cigar(cb, ez);
  }
}

// ---------------------------------------------------------------------------
// Dual-gap-cost extension (reference ksw_extd2_sse, src/ksw2_extd2_sse.c).
// State is *signed* int8 here (no bias), again matching the SIMD kernel.
// ---------------------------------------------------------------------------
void wm_extd(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int8_t q2,
             int8_t e2, int w, int zdrop, int end_bonus, int flag,
             wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 1 || qlen <= 0 || tlen <= 0) return;

  if (q2 + e2 < q + e) {  // canonicalise: (q,e) is the cheaper open+ext pair
    std::swap(q, q2);
    std::swap(e, e2);
  }
  const int qe = q + e;
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const int8_t sc_mch = mat[0], sc_mis = mat[1];
  const int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)(-e2) : mat[m * m - 1];

  if (w < 0) w = tlen > qlen ? tlen : qlen;
  const int wl = w, wr = w;
  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = (((n_col < w + 1 ? n_col : w + 1) + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > 2 * (q + e)) return;

  // long-gap switch-over diagonal (reference ksw2_extd2_sse.c:94-97)
  int long_thres = e != e2 ? (q2 - q) / (e - e2) - 1 : 0;
  if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) ++long_thres;
  const int long_diff = long_thres * (e - e2) - (q2 - q) - e2;

  std::vector<int8_t> u(tlen16 + 32), v(tlen16 + 32), x(tlen16 + 32),
      y(tlen16 + 32), x2(tlen16 + 32), y2(tlen16 + 32), s(tlen16 + 32);
  std::fill(u.begin(), u.end(), (int8_t)(-q - e));
  std::fill(v.begin(), v.end(), (int8_t)(-q - e));
  std::fill(x.begin(), x.end(), (int8_t)(-q - e));
  std::fill(y.begin(), y.end(), (int8_t)(-q - e));
  std::fill(x2.begin(), x2.end(), (int8_t)(-q2 - e2));
  std::fill(y2.begin(), y2.end(), (int8_t)(-q2 - e2));
  std::fill(s.begin(), s.end(), (int8_t)0);
  std::vector<uint8_t> qr(((qlen + 15) / 16) * 16 + 16, 0);
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    if (st < (r - wr + 1) >> 1) st = (r - wr + 1) >> 1;
    if (en > (r + wl) >> 1) en = (r + wl) >> 1;
    if (st > en) {
      ez->zdropped = 1;
      break;
    }
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en) {
        x1 = x[st - 1], x21 = x2[st - 1], v1 = v[st - 1];
      } else {
        x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2 - e2);
        v1 = (int8_t)(-q - e);
      }
    } else {
      x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2 - e2);
      v1 = r == 0            ? (int8_t)(-q - e)
           : r < long_thres  ? (int8_t)(-e)
           : r == long_thres ? (int8_t)long_diff
                             : (int8_t)(-e2);
    }
    if (en >= r) {
      y[r] = (int8_t)(-q - e), y2[r] = (int8_t)(-q2 - e2);
      u[r] = r == 0            ? (int8_t)(-q - e)
             : r < long_thres  ? (int8_t)(-e)
             : r == long_thres ? (int8_t)long_diff
                               : (int8_t)(-e2);
    }

    if (!(flag & WM_EZ_GENERIC_SC)) {
      for (int t = st0; t <= en0; t += 16)
        for (int l = 0; l < 16; ++l) {
          int tt = t + l;
          uint8_t a = tt < tlen ? target[tt] : 0;
          int qidx = qlen - 1 - r + tt;
          uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
          int8_t sc = (a == m - 1 || b == m - 1) ? sc_N
                      : (a == b)                 ? sc_mch
                                                 : sc_mis;
          if (tt < (int)s.size()) s[tt] = sc;
        }
    } else {
      for (int t = st0; t <= en0; ++t) {
        int qidx = qlen - 1 - r + t;
        uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
        s[t] = mat[target[t] * m + b];
      }
    }

    int8_t carry_x = x1, carry_x2 = x21, carry_v = v1;
    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; ++t) {
      const int8_t xt1 = carry_x, x2t1 = carry_x2, vt1 = carry_v;
      const int8_t ut = u[t];
      carry_x = x[t];
      carry_x2 = x2[t];
      carry_v = v[t];
      int8_t z = s[t];
      const int8_t a = (int8_t)(xt1 + vt1);
      const int8_t b = (int8_t)(y[t] + ut);
      const int8_t a2 = (int8_t)(x2t1 + vt1);
      const int8_t b2 = (int8_t)(y2[t] + ut);
      uint8_t d;
      if (!right_gaps) {
        d = a > z ? 1 : 0;
        if (a > z) z = a;
        if (b > z) d = 2, z = b;
        if (a2 > z) d = 3, z = a2;
        if (b2 > z) d = 4, z = b2;
      } else {
        d = z > a ? 0 : 1;
        if (a > z) z = a;
        if (!(z > b)) d = 2;
        if (b > z) z = b;
        if (!(z > a2)) d = 3;
        if (a2 > z) z = a2;
        if (!(z > b2)) d = 4;
        if (b2 > z) z = b2;
      }
      if (z > sc_mch) z = sc_mch;
      u[t] = (int8_t)(z - vt1);
      v[t] = (int8_t)(z - ut);
      const int8_t zq = (int8_t)(z - q);
      const int8_t zq2 = (int8_t)(z - q2);
      const int8_t an = (int8_t)(a - zq), bn = (int8_t)(b - zq);
      const int8_t a2n = (int8_t)(a2 - zq2), b2n = (int8_t)(b2 - zq2);
      bool ax, bx, a2x, b2x;
      if (!right_gaps) {
        ax = an > 0, bx = bn > 0, a2x = a2n > 0, b2x = b2n > 0;
      } else {
        ax = !(0 > an), bx = !(0 > bn), a2x = !(0 > a2n), b2x = !(0 > b2n);
      }
      x[t] = (int8_t)((ax ? an : 0) - qe);
      y[t] = (int8_t)((bx ? bn : 0) - qe);
      x2[t] = (int8_t)((a2x ? a2n : 0) - (q2 + e2));
      y2[t] = (int8_t)((b2x ? b2n : 0) - (q2 + e2));
      if (ax) d |= 0x08;
      if (bx) d |= 0x10;
      if (a2x) d |= 0x20;
      if (b2x) d |= 0x40;
      if (with_cigar) prow[t - st] = d;
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0]
                                 : H[en0] + (int32_t)v[en0];
        max_t = en0;
        // 4-lane strided max (see wm_extz for why the lane order matters)
        {
          int en1 = st0 + (en0 - st0) / 4 * 4;
          int32_t HH[4], tt[4];
          for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
          int t = st0;
          for (; t < en1; t += 4)
            for (int l = 0; l < 4; ++l) {
              H[t + l] += (int32_t)v[t + l];
              if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
            }
          for (int l = 0; l < 4; ++l)
            if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
          for (; t < en0; ++t) {
            H[t] += (int32_t)v[t];
            if (H[t] > max_H) max_H = H[t], max_t = t;
          }
        }
      } else {
        H[0] = (int32_t)v[0] - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte) ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe) ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, e2)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t];
          int32_t d1 = (int32_t)u[last_H0_t + 1];
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t];
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t];
        }
        if ((flag & WM_EZ_APPROX_DROP) &&
            apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2))
          break;
      } else {
        H0 = (int32_t)v[0] - qe;
        last_H0_t = 0;
      }
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY)) {
      traceback(p.data(), off.data(), off_end.data(), n_col, tlen - 1, qlen - 1,
                rev_cigar, &cb);
    } else if (!ez->zdropped && (flag & WM_EZ_EXTZ_ONLY) &&
               ez->mqe + end_bonus > (int32_t)ez->max) {
      ez->reach_end = 1;
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->mqe_t,
                qlen - 1, rev_cigar, &cb);
    } else if (ez->max_t >= 0 && ez->max_q >= 0) {
      traceback(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                ez->max_q, rev_cigar, &cb);
    }
    finish_cigar(cb, ez);
  }
}

// ---------------------------------------------------------------------------
// Spliced extension (reference ksw_exts2_sse, src/ksw2_exts2_sse.c): the
// dual-gap wavefront with the long-gap state re-purposed as an intron --
// no band, donor/acceptor site scores added on long-gap open/close, and
// the long-gap state floored at the donor score instead of zero.  Signed
// int8 state like wm_extd.  `junc` is an optional per-target-base splice
// junction annotation (reference mm_idx_bed_junc); null means none.
// ---------------------------------------------------------------------------
// Production host extd: the AVX-512BW 64-lane core when the CPU has it
// (runtime cpuid; WM_NO_SIMD=1 forces scalar), the scalar oracle otherwise.
// Bit-identical to wm_extd for every input by construction + committed
// parity sweep; GENERIC_SC scoring stays scalar (cold path).
void wm_extd_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int8_t q2, int8_t e2, int w, int zdrop,
                  int end_bonus, int flag, wm_ext_result* ez) {
#ifdef WM_SIMD_X86
  static int simd_ok = -1;
  if (simd_ok < 0) {
    simd_ok = 0;
    if (!std::getenv("WM_NO_SIMD")) {
      __builtin_cpu_init();
      if (__builtin_cpu_supports("avx512bw") &&
          __builtin_cpu_supports("avx512vl"))
        simd_ok = 1;
    }
  }
  if (simd_ok && !(flag & WM_EZ_GENERIC_SC)) {
    wm_extd_avx512(qlen, query, tlen, target, m, mat, q, e, q2, e2, w, zdrop,
                   end_bonus, flag, ez);
    return;
  }
#endif
  wm_extd(qlen, query, tlen, target, m, mat, q, e, q2, e2, w, zdrop,
          end_bonus, flag, ez);
}

void wm_exts(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int8_t q2,
             int8_t noncan, int zdrop, int8_t junc_bonus, int flag,
             const uint8_t* junc, wm_ext_result* ez) {
  reset_result(ez);
  if (m <= 1 || qlen <= 0 || tlen <= 0 || q2 <= q + e) return;

  const int qe = q + e;
  const int with_cigar = !(flag & WM_EZ_SCORE_ONLY);
  const int approx_max = !!(flag & WM_EZ_APPROX_MAX);
  const int right_gaps = !!(flag & WM_EZ_RIGHT);
  const int rev_cigar = !!(flag & WM_EZ_REV_CIGAR);
  const int8_t sc_mch = mat[0], sc_mis = mat[1];
  const int8_t sc_N = mat[m * m - 1] == 0 ? (int8_t)(-e) : mat[m * m - 1];

  const int tlen16 = (tlen + 15) / 16 * 16;
  int n_col = qlen < tlen ? qlen : tlen;
  n_col = ((n_col + 15) / 16 + 1) * 16;

  int min_sc = mat[1];
  for (int t = 1; t < m * m; ++t) min_sc = min_sc < mat[t] ? min_sc : mat[t];
  if (-min_sc > 2 * (q + e)) return;

  int long_thres = (q2 - q) / e - 1;
  if (q2 > q + e + long_thres * e) ++long_thres;
  const int long_diff = long_thres * e - (q2 - q);

  std::vector<int8_t> u(tlen16 + 32), v(tlen16 + 32), x(tlen16 + 32),
      y(tlen16 + 32), x2(tlen16 + 32), s(tlen16 + 32, 0),
      donor(tlen16 + 32, 0), acceptor(tlen16 + 32, 0);
  std::fill(u.begin(), u.end(), (int8_t)(-q - e));
  std::fill(v.begin(), v.end(), (int8_t)(-q - e));
  std::fill(x.begin(), x.end(), (int8_t)(-q - e));
  std::fill(y.begin(), y.end(), (int8_t)(-q - e));
  std::fill(x2.begin(), x2.end(), (int8_t)(-q2));
  std::vector<uint8_t> qr(((qlen + 15) / 16) * 16 + 16, 0);
  for (int t = 0; t < qlen; ++t) qr[t] = query[qlen - 1 - t];

  // donor/acceptor site scores (reference ksw2_exts2_sse.c:114-166);
  // all-zero when no splice orientation is requested, like the kcalloc'd
  // arrays in the reference
  const int spl_for = !!(flag & WM_EZ_SPLICE_FOR);
  const int spl_rev = !!(flag & WM_EZ_SPLICE_REV);
  if (spl_for || spl_rev) {
    int semi_cost = (flag & WM_EZ_SPLICE_FLANK) ? -noncan / 2 : 0;
    std::fill(donor.begin(), donor.end(), (int8_t)(-noncan));
    std::fill(acceptor.begin(), acceptor.end(), (int8_t)(-noncan));
    if (!rev_cigar) {
      for (int t = 0; t < tlen - 4; ++t) {
        int can_type = 0;
        if (spl_for && target[t + 1] == 2 && target[t + 2] == 3) can_type = 1;
        if (spl_rev && target[t + 1] == 1 && target[t + 2] == 3) can_type = 1;
        if (can_type && (target[t + 3] == 0 || target[t + 3] == 2))
          can_type = 2;
        if (can_type) donor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen - 1; ++t)
          if ((spl_for && (junc[t + 1] & 1)) || (spl_rev && (junc[t + 1] & 8)))
            donor[t] = (int8_t)(donor[t] + junc_bonus);
      for (int t = 2; t < tlen; ++t) {
        int can_type = 0;
        if (spl_for && target[t - 1] == 0 && target[t] == 2) can_type = 1;
        if (spl_rev && target[t - 1] == 0 && target[t] == 1) can_type = 1;
        if (can_type && (target[t - 2] == 1 || target[t - 2] == 3))
          can_type = 2;
        if (can_type) acceptor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen; ++t)
          if ((spl_for && (junc[t] & 2)) || (spl_rev && (junc[t] & 4)))
            acceptor[t] = (int8_t)(acceptor[t] + junc_bonus);
    } else {
      for (int t = 0; t < tlen - 4; ++t) {
        int can_type = 0;
        if (spl_for && target[t + 1] == 2 && target[t + 2] == 0) can_type = 1;
        if (spl_rev && target[t + 1] == 1 && target[t + 2] == 0) can_type = 1;
        if (can_type && (target[t + 3] == 1 || target[t + 3] == 3))
          can_type = 2;
        if (can_type) donor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen - 1; ++t)
          if ((spl_for && (junc[t + 1] & 2)) || (spl_rev && (junc[t + 1] & 4)))
            donor[t] = (int8_t)(donor[t] + junc_bonus);
      for (int t = 2; t < tlen; ++t) {
        int can_type = 0;
        if (spl_for && target[t - 1] == 3 && target[t] == 2) can_type = 1;
        if (spl_rev && target[t - 1] == 3 && target[t] == 1) can_type = 1;
        if (can_type && (target[t - 2] == 0 || target[t - 2] == 2))
          can_type = 2;
        if (can_type) acceptor[t] = can_type == 2 ? 0 : (int8_t)semi_cost;
      }
      if (junc)
        for (int t = 0; t < tlen; ++t)
          if ((spl_for && (junc[t] & 1)) || (spl_rev && (junc[t] & 8)))
            acceptor[t] = (int8_t)(acceptor[t] + junc_bonus);
    }
  }

  std::vector<int32_t> H;
  int32_t H0 = 0, last_H0_t = 0;
  if (!approx_max) H.assign(tlen16, WM_NEG_INF);

  std::vector<uint8_t> p;
  std::vector<int> off, off_end;
  if (with_cigar) {
    p.assign((size_t)(qlen + tlen - 1) * n_col, 0);
    off.assign(qlen + tlen - 1, 0);
    off_end.assign(qlen + tlen - 1, 0);
  }

  int last_st = -1, last_en = -1;
  for (int r = 0; r < qlen + tlen - 1; ++r) {
    int st = 0, en = tlen - 1;
    if (st < r - qlen + 1) st = r - qlen + 1;
    if (en > r) en = r;
    const int st0 = st, en0 = en;
    st = st / 16 * 16;
    en = (en + 16) / 16 * 16 - 1;

    int8_t x1, x21, v1;
    if (st > 0) {
      if (st - 1 >= last_st && st - 1 <= last_en)
        x1 = x[st - 1], x21 = x2[st - 1], v1 = v[st - 1];
      else
        x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2), v1 = (int8_t)(-q - e);
    } else {
      x1 = (int8_t)(-q - e), x21 = (int8_t)(-q2);
      v1 = r == 0            ? (int8_t)(-q - e)
           : r < long_thres  ? (int8_t)(-e)
           : r == long_thres ? (int8_t)long_diff
                             : (int8_t)0;
    }
    if (en >= r) {
      y[r] = (int8_t)(-q - e);
      u[r] = r == 0            ? (int8_t)(-q - e)
             : r < long_thres  ? (int8_t)(-e)
             : r == long_thres ? (int8_t)long_diff
                               : (int8_t)0;
    }

    if (!(flag & WM_EZ_GENERIC_SC)) {
      for (int t = st0; t <= en0; t += 16)
        for (int l = 0; l < 16; ++l) {
          int tt = t + l;
          uint8_t a = tt < tlen ? target[tt] : 0;
          int qidx = qlen - 1 - r + tt;
          uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
          int8_t sc = (a == m - 1 || b == m - 1) ? sc_N
                      : (a == b)                 ? sc_mch
                                                 : sc_mis;
          if (tt < (int)s.size()) s[tt] = sc;
        }
    } else {
      for (int t = st0; t <= en0; ++t) {
        int qidx = qlen - 1 - r + t;
        uint8_t b = (qidx >= 0 && qidx < (int)qr.size()) ? qr[qidx] : 0;
        s[t] = mat[target[t] * m + b];
      }
    }

    int8_t carry_x = x1, carry_x2 = x21, carry_v = v1;
    uint8_t* prow = with_cigar ? p.data() + (size_t)r * n_col : nullptr;
    if (with_cigar) off[r] = st, off_end[r] = en;
    for (int t = st; t <= en; ++t) {
      const int8_t xt1 = carry_x, x2t1 = carry_x2, vt1 = carry_v;
      const int8_t ut = u[t];
      carry_x = x[t];
      carry_x2 = x2[t];
      carry_v = v[t];
      int8_t z = s[t];
      const int8_t a = (int8_t)(xt1 + vt1);
      const int8_t b = (int8_t)(y[t] + ut);
      const int8_t a2 = (int8_t)(x2t1 + vt1);
      const int8_t a2a = (int8_t)(a2 + acceptor[t]);
      uint8_t d;
      if (!right_gaps) {
        d = a > z ? 1 : 0;
        if (a > z) z = a;
        if (b > z) d = 2, z = b;
        if (a2a > z) d = 3, z = a2a;
      } else {
        d = z > a ? 0 : 1;
        if (a > z) z = a;
        if (!(z > b)) d = 2;
        if (b > z) z = b;
        if (!(z > a2a)) d = 3;
        if (a2a > z) z = a2a;
      }
      u[t] = (int8_t)(z - vt1);
      v[t] = (int8_t)(z - ut);
      const int8_t zq = (int8_t)(z - q);
      const int8_t an = (int8_t)(a - zq), bn = (int8_t)(b - zq);
      const int8_t a2n = (int8_t)(a2 - (int8_t)(z - q2));
      bool ax, bx, a2x;
      if (!right_gaps) {
        ax = an > 0, bx = bn > 0, a2x = a2n > donor[t];
      } else {
        ax = !(0 > an), bx = !(0 > bn), a2x = !(donor[t] > a2n);
      }
      x[t] = (int8_t)((ax ? an : 0) - qe);
      y[t] = (int8_t)((bx ? bn : 0) - qe);
      x2[t] = (int8_t)((a2x ? a2n : donor[t]) - q2);
      if (ax) d |= 0x08;
      if (bx) d |= 0x10;
      if (a2x) d |= 0x20;
      if (with_cigar) prow[t - st] = d;
    }

    if (!approx_max) {
      int32_t max_H, max_t;
      if (r > 0) {
        max_H = H[en0] = en0 > 0 ? H[en0 - 1] + (int32_t)u[en0]
                                 : H[en0] + (int32_t)v[en0];
        max_t = en0;
        int en1 = st0 + (en0 - st0) / 4 * 4;
        int32_t HH[4], tt[4];
        for (int l = 0; l < 4; ++l) HH[l] = max_H, tt[l] = max_t;
        int t = st0;
        for (; t < en1; t += 4)
          for (int l = 0; l < 4; ++l) {
            H[t + l] += (int32_t)v[t + l];
            if (H[t + l] > HH[l]) HH[l] = H[t + l], tt[l] = t + l;
          }
        for (int l = 0; l < 4; ++l)
          if (HH[l] > max_H) max_H = HH[l], max_t = tt[l];
        for (; t < en0; ++t) {
          H[t] += (int32_t)v[t];
          if (H[t] > max_H) max_H = H[t], max_t = t;
        }
      } else {
        H[0] = (int32_t)v[0] - qe;
        max_H = H[0];
        max_t = 0;
      }
      if (en0 == tlen - 1 && H[en0] > ez->mte)
        ez->mte = H[en0], ez->mte_q = r - en;
      if (r - st0 == qlen - 1 && H[st0] > ez->mqe)
        ez->mqe = H[st0], ez->mqe_t = st0;
      if (apply_zdrop(ez, max_H, r, max_t, zdrop, 0)) break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H[tlen - 1];
    } else {
      if (r > 0) {
        if (last_H0_t >= st0 && last_H0_t <= en0 && last_H0_t + 1 >= st0 &&
            last_H0_t + 1 <= en0) {
          int32_t d0 = (int32_t)v[last_H0_t];
          int32_t d1 = (int32_t)u[last_H0_t + 1];
          if (d0 > d1)
            H0 += d0;
          else
            H0 += d1, ++last_H0_t;
        } else if (last_H0_t >= st0 && last_H0_t <= en0) {
          H0 += (int32_t)v[last_H0_t];
        } else {
          ++last_H0_t;
          H0 += (int32_t)u[last_H0_t];
        }
      } else {
        H0 = (int32_t)v[0] - qe;
        last_H0_t = 0;
      }
      if ((flag & WM_EZ_APPROX_DROP) &&
          apply_zdrop(ez, H0, r, last_H0_t, zdrop, 0))
        break;
      if (r == qlen + tlen - 2 && en0 == tlen - 1) ez->score = H0;
    }
    last_st = st, last_en = en;
  }

  if (with_cigar) {
    CigarBuf cb;
    if (!ez->zdropped && !(flag & WM_EZ_EXTZ_ONLY))
      traceback_intron(p.data(), off.data(), off_end.data(), n_col, tlen - 1,
                       qlen - 1, rev_cigar, long_thres, &cb);
    else if (ez->max_t >= 0 && ez->max_q >= 0)
      traceback_intron(p.data(), off.data(), off_end.data(), n_col, ez->max_t,
                       ez->max_q, rev_cigar, long_thres, &cb);
    finish_cigar(cb, ez);
  }
}

// ---------------------------------------------------------------------------
// Score-only striped Smith-Waterman (reference ksw_ll_i16,
// src/ksw2_ll_sse.c:80-147), used for inversion detection and anchor
// extension scoring.  The striped lane layout changes which (qe, te) wins a
// tied maximum, so the padding and scan order are reproduced exactly.
// ---------------------------------------------------------------------------
// Production host extz: AVX-512BW when available, scalar oracle otherwise.
void wm_extz_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int w, int zdrop, int end_bonus, int flag,
                  wm_ext_result* ez) {
#ifdef WM_SIMD_X86
  static int simd_ok = -1;
  if (simd_ok < 0) {
    simd_ok = 0;
    if (!std::getenv("WM_NO_SIMD")) {
      __builtin_cpu_init();
      if (__builtin_cpu_supports("avx512bw") &&
          __builtin_cpu_supports("avx512vl"))
        simd_ok = 1;
    }
  }
  if (simd_ok && !(flag & WM_EZ_GENERIC_SC)) {
    wm_extz_avx512(qlen, query, tlen, target, m, mat, q, e, w, zdrop,
                   end_bonus, flag, ez);
    return;
  }
#endif
  wm_extz(qlen, query, tlen, target, m, mat, q, e, w, zdrop, end_bonus, flag,
          ez);
}

// Production host exts: AVX-512BW when available (same dispatch rules as
// wm_extd_fast), scalar oracle otherwise.
void wm_exts_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int8_t q2, int8_t noncan, int zdrop,
                  int8_t junc_bonus, int flag, const uint8_t* junc,
                  wm_ext_result* ez) {
#ifdef WM_SIMD_X86
  static int simd_ok = -1;
  if (simd_ok < 0) {
    simd_ok = 0;
    if (!std::getenv("WM_NO_SIMD")) {
      __builtin_cpu_init();
      if (__builtin_cpu_supports("avx512bw") &&
          __builtin_cpu_supports("avx512vl"))
        simd_ok = 1;
    }
  }
  if (simd_ok && !(flag & WM_EZ_GENERIC_SC)) {
    wm_exts_avx512(qlen, query, tlen, target, m, mat, q, e, q2, noncan,
                   zdrop, junc_bonus, flag, junc, ez);
    return;
  }
#endif
  wm_exts(qlen, query, tlen, target, m, mat, q, e, q2, noncan, zdrop,
          junc_bonus, flag, junc, ez);
}

int wm_sw_i16(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
              int m, const int8_t* mat, int gapo, int gape, int* qe_out,
              int* te_out) {
  *qe_out = *te_out = -1;
  if (qlen <= 0 || tlen <= 0) return 0;
  const int slen = (qlen + 7) / 8;  // stripes of 8 int16 lanes
  const int gapoe = gapo + gape;

  auto sat_add = [](int a, int b) {  // _mm_adds_epi16
    int s = a + b;
    return s > 32767 ? 32767 : (s < -32768 ? -32768 : s);
  };
  auto sat_sub_u = [](int a, int b) {  // _mm_subs_epu16 on non-negative values
    int s = a - b;
    return s < 0 ? 0 : s;
  };

  // Striped storage: element (stripe j, lane l) covers query position
  // j + l*slen; positions >= qlen score 0 (reference pads, and the pads do
  // participate in the running maximum, so they are modelled too).
  auto vec = [&](std::vector<int>& a, int j, int l) -> int& {
    return a[j * 8 + l];
  };
  std::vector<int> H0(slen * 8, 0), H1(slen * 8, 0), E(slen * 8, 0),
      Hmax(slen * 8, 0), S(slen * 8, 0);
  int gmax = 0, te = -1;
  int h_carry[8], f[8], maxv[8];

  for (int i = 0; i < tlen; ++i) {
    const int8_t* ma = mat + target[i] * m;
    for (int j = 0; j < slen; ++j)
      for (int l = 0; l < 8; ++l) {
        int k = j + l * slen;
        vec(S, j, l) = k < qlen ? ma[query[k]] : 0;
      }
    // h = H0[slen-1] shifted up one lane (lane l <- lane l-1, lane 0 <- 0)
    for (int l = 7; l >= 1; --l) h_carry[l] = vec(H0, slen - 1, l - 1);
    h_carry[0] = 0;
    for (int l = 0; l < 8; ++l) f[l] = 0, maxv[l] = 0;
    for (int j = 0; j < slen; ++j) {
      int e_[8], h_[8];
      for (int l = 0; l < 8; ++l) {
        int h = sat_add(h_carry[l], vec(S, j, l));
        int e = vec(E, j, l);
        if (e > h) h = e;
        if (f[l] > h) h = f[l];
        if (h > maxv[l]) maxv[l] = h;
        vec(H1, j, l) = h;
        h_[l] = sat_sub_u(h, gapoe);
        e = sat_sub_u(e, gape);
        if (h_[l] > e) e = h_[l];
        e_[l] = e;
        f[l] = sat_sub_u(f[l], gape);
        if (h_[l] > f[l]) f[l] = h_[l];
      }
      for (int l = 0; l < 8; ++l) {
        vec(E, j, l) = e_[l];
        h_carry[l] = vec(H0, j, l);
      }
    }
    // lazy-F fix-up: rotate f across lanes, keep folding until quiescent
    for (int k = 0; k < 8; ++k) {
      for (int l = 7; l >= 1; --l) f[l] = f[l - 1];
      f[0] = 0;
      bool done = false;
      for (int j = 0; j < slen; ++j) {
        int any = 0;
        for (int l = 0; l < 8; ++l) {
          int h = vec(H1, j, l);
          if (f[l] > h) h = f[l];
          vec(H1, j, l) = h;
          h = sat_sub_u(h, gapoe);
          f[l] = sat_sub_u(f[l], gape);
          if (f[l] > h) any = 1;
        }
        if (!any) {
          done = true;
          break;
        }
      }
      if (done) break;
    }
    int imax = 0;
    for (int l = 0; l < 8; ++l)
      if (maxv[l] > imax) imax = maxv[l];
    if (imax >= gmax) {
      gmax = imax;
      te = i;
      Hmax = H1;
    }
    std::swap(H0, H1);
  }
  // query-end tie-break: last element in striped memory order
  // (memory order = stripe-major, lanes within a stripe)
  int qe = -1;
  for (int mem = 0; mem < slen * 8; ++mem) {
    int j = mem / 8, l = mem % 8;
    if (vec(Hmax, j, l) == gmax) qe = j + l * slen;
  }
  *qe_out = qe;
  *te_out = te;
  return gmax;
}

// ---------------------------------------------------------------------------
// Traceback over an externally-produced direction matrix (the TPU kernel
// writes per-anti-diagonal direction bytes; the path walk is sequential and
// stays on host).  Layout matches the in-process kernels: row r holds lanes
// [off[r], off[r] + n_col).
// ---------------------------------------------------------------------------
int wm_backtrack_band(const uint8_t* p, const int32_t* off,
                      const int32_t* off_end, int64_t n_col, int i0, int j0,
                      int rev_cigar, uint32_t** out_cigar) {
  CigarBuf cb;
  std::vector<int> off_v, off_end_v;
  int rmax = i0 + j0 + 1;
  off_v.reserve(rmax);
  off_end_v.reserve(rmax);
  for (int r = 0; r < rmax; ++r) {
    off_v.push_back(off[r]);
    off_end_v.push_back(off_end[r]);
  }
  traceback(p, off_v.data(), off_end_v.data(), (size_t)n_col, i0, j0, rev_cigar,
            &cb);
  *out_cigar = nullptr;
  if (!cb.ops.empty()) {
    *out_cigar = (uint32_t*)wm_malloc(sizeof(uint32_t) * cb.ops.size());
    std::memcpy(*out_cigar, cb.ops.data(), sizeof(uint32_t) * cb.ops.size());
  }
  return (int)cb.ops.size();
}

// Traceback over the Pallas common-window direction layout: row r holds
// lanes [base[r], base[r] + n_col) while the row's true rounded band is
// [st[r], en[r]] (force_state rules use st/en, matching the reference
// window bounds in ksw_backtrack, src/ksw2.h:119-151).
int wm_backtrack_band2(const uint8_t* p, const int32_t* base,
                       const int32_t* st, const int32_t* en, int64_t n_col,
                       int i0, int j0, int rev_cigar, uint32_t** out_cigar) {
  CigarBuf cb;
  int i = i0, j = j0, state = 0;
  while (i >= 0 && j >= 0) {
    int r = i + j;
    int force_state = -1;
    if (i < st[r]) force_state = 2;
    if (i > en[r]) force_state = 1;
    uint32_t d = force_state < 0 ? p[(size_t)r * n_col + i - base[r]] : 0;
    if (state == 0)
      state = d & 7;
    else if (!(d >> (state + 2) & 1))
      state = 0;
    if (state == 0) state = d & 7;
    if (force_state >= 0) state = force_state;
    if (state == 0)
      cb.push(0, 1), --i, --j;
    else if (state == 1 || state == 3)
      cb.push(2, 1), --i;
    else
      cb.push(1, 1), --j;
  }
  if (i >= 0) cb.push(2, i + 1);
  if (j >= 0) cb.push(1, j + 1);
  if (!rev_cigar) std::reverse(cb.ops.begin(), cb.ops.end());
  *out_cigar = nullptr;
  if (!cb.ops.empty()) {
    *out_cigar = (uint32_t*)wm_malloc(sizeof(uint32_t) * cb.ops.size());
    std::memcpy(*out_cigar, cb.ops.data(), sizeof(uint32_t) * cb.ops.size());
  }
  return (int)cb.ops.size();
}

}  // extern "C"
