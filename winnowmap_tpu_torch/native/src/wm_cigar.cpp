// CIGAR post-processing on the host: z-drop inspection with inversion probe,
// indel normalisation, and score/blen/mlen recomputation.
//
// Ports of reference src/align.c routines (mm_test_zdrop align.c:47-89,
// mm_fix_cigar align.c:91-167, mm_update_cigar_eqx align.c:169-238,
// mm_update_extra align.c:240-286).  These walk one alignment's CIGAR
// sequentially (irreducibly serial, tiny next to the DP itself) and are kept
// on the host while the DP wavefront runs on the TPU.
#include "wm_base.h"

#include <algorithm>
#include <cstring>
#include <vector>

extern "C" {
int wm_sw_i16(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
              int m, const int8_t* mat, int gapo, int gape, int* qe_out,
              int* te_out);
}

namespace {

struct ZdropState {
  int64_t max_score = -(1LL << 31);
  int32_t max_i = -1, max_j = -1;
  int64_t max_zdrop = 0;
  int32_t pos[2][2] = {{-1, -1}, {-1, -1}};
};

inline void update_max_zdrop(int64_t score, int i, int j, ZdropState* st,
                             int e) {
  if (score < st->max_score) {
    int li = i - st->max_i;
    int lj = j - st->max_j;
    int diff = li > lj ? li - lj : lj - li;
    int64_t z = st->max_score - score - (int64_t)diff * e;
    if (z > st->max_zdrop) {
      st->max_zdrop = z;
      st->pos[0][0] = st->max_i;
      st->pos[0][1] = i;
      st->pos[1][0] = st->max_j;
      st->pos[1][1] = j;
    }
  } else {
    st->max_score = score;
    st->max_i = i;
    st->max_j = j;
  }
}

}  // namespace

extern "C" {

// Z-drop inspection + inversion probe (reference mm_test_zdrop,
// align.c:47-89).  Returns 0 (keep), 1 (z-dropped), 2 (inversion found).
// try_inv gates the probe on !(flag & (SPLICE|SR|FOR_ONLY|REV_ONLY)).
int wm_test_zdrop(const uint8_t* qseq, const uint8_t* tseq,
                  const uint32_t* cigar, int32_t n_cigar, const int8_t* mat,
                  int q, int e, int zdrop, int zdrop_inv, int max_gap,
                  int min_inv_score, int min_dp_max, int try_inv) {
  ZdropState st;
  int64_t score = 0;
  int i = 0, j = 0;
  for (int32_t k = 0; k < n_cigar; ++k) {
    uint32_t op = cigar[k] & 0xF, len = cigar[k] >> 4;
    if (op == 0) {
      for (uint32_t l = 0; l < len; ++l) {
        score += mat[tseq[i + l] * 5 + qseq[j + l]];
        update_max_zdrop(score, i + l, j + l, &st, e);
      }
      i += len;
      j += len;
    } else if (op == 1 || op == 2 || op == 3) {
      score -= q + (int64_t)e * len;
      if (op == 1)
        j += len;
      else
        i += len;
      update_max_zdrop(score, i, j, &st, e);
    }
  }
  int q_len = st.pos[1][1] - st.pos[1][0];
  int t_len = st.pos[0][1] - st.pos[0][0];
  if (try_inv && st.max_zdrop > zdrop_inv && q_len < max_gap &&
      t_len < max_gap) {
    std::vector<uint8_t> qseq2(q_len);
    for (int l = 0; l < q_len; ++l) {
      int c = qseq[st.pos[1][1] - l - 1];
      qseq2[l] = c >= 4 ? 4 : 3 - c;
    }
    int qe_out, te_out;
    int sc = wm_sw_i16(q_len, qseq2.data(), t_len, tseq + st.pos[0][0], 5, mat,
                       q, e, &qe_out, &te_out);
    if (sc >= min_inv_score && sc >= min_dp_max) return 2;
  }
  return st.max_zdrop > zdrop ? 1 : 0;
}

// In/out block for wm_update_extra (field layout shared with ctypes).
typedef struct {
  int32_t qs, qe, rs, re;  // in/out: region coords (fix_cigar may shift)
  int32_t rev;             // in: mapped to the reverse strand
  int32_t blen, mlen;      // out
  int32_t n_ambi;          // out: ambiguous-base count delta
  int32_t dp_max;          // out: running clamped max score
  int32_t n_cigar;         // out
  uint32_t* cigar;         // out: malloc'd, caller frees with wm_free
  int32_t qshift, tshift;  // out: leading-indel shifts consumed
} wm_extra_io;

// Indel left-shift + adjacent-indel merge (reference mm_fix_cigar,
// align.c:91-167) followed by blen/mlen/dp_max recomputation and optional
// =/X expansion (reference mm_update_extra align.c:240-286,
// mm_update_cigar_eqx align.c:169-238).  qseq points at the query from the
// alignment start; tseq covers exactly [rs, re).
void wm_update_extra(const uint8_t* qseq_in, const uint8_t* tseq_in,
                     const uint32_t* cigar_in, int32_t n_cigar_in,
                     const int8_t* mat, int q, int e, int is_eqx,
                     wm_extra_io* io) {
  std::vector<int64_t> cig(cigar_in, cigar_in + n_cigar_in);
  int qshift = 0, tshift = 0;

  if (cig.size() > 1) {  // --- mm_fix_cigar ---
    int64_t toff = 0, qoff = 0;
    bool to_shrink = false;
    for (size_t k = 0; k < cig.size(); ++k) {
      int op = cig[k] & 0xF;
      int64_t len = cig[k] >> 4;
      if (len == 0) to_shrink = true;
      if (op == 0) {
        toff += len;
        qoff += len;
      } else if (op == 1 || op == 2) {
        if (k > 0 && k < cig.size() - 1 && (cig[k - 1] & 0xF) == 0 &&
            (cig[k + 1] & 0xF) == 0) {
          int64_t prev_len = cig[k - 1] >> 4;
          int64_t l = 0;
          if (op == 1) {
            while (l < prev_len &&
                   qseq_in[qoff - 1 - l] == qseq_in[qoff + len - 1 - l])
              ++l;
          } else {
            while (l < prev_len &&
                   tseq_in[toff - 1 - l] == tseq_in[toff + len - 1 - l])
              ++l;
          }
          if (l > 0) {
            cig[k - 1] -= l << 4;
            cig[k + 1] += l << 4;
            qoff -= l;
            toff -= l;
          }
          if (l == prev_len) to_shrink = true;
        }
        if (op == 1)
          qoff += len;
        else
          toff += len;
      } else if (op == 3) {
        toff += len;
      }
    }
    // merge runs like 5I6D7I (align.c:126-144)
    for (size_t k = 0; k + 2 < cig.size(); ++k) {
      if ((cig[k] & 0xF) > 0 && (cig[k] & 0xF) + (cig[k + 1] & 0xF) == 3) {
        int64_t s[3] = {0, 0, 0};
        size_t l = k;
        while (l < cig.size()) {
          int op = cig[l] & 0xF;
          if (op == 1 || op == 2 || (cig[l] >> 4) == 0) {
            if (op == 1 || op == 2) s[op] += cig[l] >> 4;
          } else {
            break;
          }
          ++l;
        }
        if (s[1] > 0 && s[2] > 0 && l - k > 2) {
          cig[k] = s[1] << 4 | 1;
          cig[k + 1] = s[2] << 4 | 2;
          for (size_t kk = k + 2; kk < l; ++kk) cig[kk] &= 0xF;
          to_shrink = true;
        }
        k = l;  // loop ++k resumes at l+1 (matches reference align.c:143)
      }
    }
    if (to_shrink) {
      std::vector<int64_t> out;
      for (int64_t c : cig) {
        if ((c >> 4) == 0) continue;
        if (!out.empty() && (out.back() & 0xF) == (c & 0xF))
          out.back() += (c >> 4) << 4;
        else
          out.push_back(c);
      }
      cig.swap(out);
    }
    if (!cig.empty() && ((cig[0] & 0xF) == 1 || (cig[0] & 0xF) == 2)) {
      int64_t l = cig[0] >> 4;
      if ((cig[0] & 0xF) == 1) {
        if (io->rev)
          io->qe -= (int32_t)l;
        else
          io->qs += (int32_t)l;
        qshift = (int32_t)l;
      } else {
        io->rs += (int32_t)l;
        tshift = (int32_t)l;
      }
      cig.erase(cig.begin());
    }
  }
  io->qshift = qshift;
  io->tshift = tshift;
  const uint8_t* qseq = qseq_in + qshift;
  const uint8_t* tseq = tseq_in + tshift;

  // --- mm_update_extra score walk ---
  int64_t blen = 0, mlen = 0, n_ambi = 0;
  int64_t s = 0, max_s = 0;
  int64_t toff = 0, qoff = 0;
  for (int64_t c : cig) {
    int op = c & 0xF;
    int64_t len = c >> 4;
    if (op == 0) {
      int64_t na = 0, nd = 0;
      for (int64_t l = 0; l < len; ++l) {
        uint8_t cq = qseq[qoff + l], ct = tseq[toff + l];
        if (ct > 3 || cq > 3)
          ++na;
        else if (ct != cq)
          ++nd;
        s += mat[ct * 5 + cq];
        if (s < 0)
          s = 0;
        else if (s > max_s)
          max_s = s;
      }
      blen += len - na;
      mlen += len - (na + nd);
      n_ambi += na;
      toff += len;
      qoff += len;
    } else if (op == 1) {
      int64_t na = 0;
      for (int64_t l = 0; l < len; ++l)
        if (qseq[qoff + l] > 3) ++na;
      blen += len - na;
      n_ambi += na;
      s -= q + (int64_t)e * len;
      if (s < 0) s = 0;
      qoff += len;
    } else if (op == 2) {
      int64_t na = 0;
      for (int64_t l = 0; l < len; ++l)
        if (tseq[toff + l] > 3) ++na;
      blen += len - na;
      n_ambi += na;
      s -= q + (int64_t)e * len;
      if (s < 0) s = 0;
      toff += len;
    } else if (op == 3) {
      toff += len;
    }
  }
  io->blen = (int32_t)blen;
  io->mlen = (int32_t)mlen;
  io->n_ambi = (int32_t)n_ambi;
  io->dp_max = (int32_t)max_s;

  if (is_eqx) {  // --- mm_update_cigar_eqx ---
    std::vector<int64_t> out;
    toff = qoff = 0;
    for (int64_t c : cig) {
      int op = c & 0xF;
      int64_t len = c >> 4;
      if (op == 0) {
        while (len > 0) {
          int64_t l = 0;
          while (l < len && qseq[qoff + l] == tseq[toff + l]) ++l;
          if (l > 0) {
            out.push_back(l << 4 | 7);
            len -= l;
            toff += l;
            qoff += l;
          }
          l = 0;
          while (l < len && qseq[qoff + l] != tseq[toff + l]) ++l;
          if (l > 0) {
            out.push_back(l << 4 | 8);
            len -= l;
            toff += l;
            qoff += l;
          }
        }
        continue;
      } else if (op == 1) {
        qoff += len;
      } else if (op == 2 || op == 3) {
        toff += len;
      }
      out.push_back(c);
    }
    cig.swap(out);
  }

  io->n_cigar = (int32_t)cig.size();
  if (cig.empty()) {
    io->cigar = nullptr;
  } else {
    io->cigar = (uint32_t*)wm_malloc(cig.size() * sizeof(uint32_t));
    for (size_t k = 0; k < cig.size(); ++k) io->cigar[k] = (uint32_t)cig[k];
  }
}

}  // extern "C"

extern "C" {

// Batch-decode device traceback outputs: 2-bit-packed op streams (walked in
// descending-diagonal order; 3 = idle) plus per-alignment leading remainder
// runs -> BAM-packed CIGARs, replicating ksw_backtrack's emit order
// (reference src/ksw2.h:144-147).  Outputs are concatenated into `out`
// (capacity-checked by the caller) with per-alignment lengths in out_len.
void wm_rle_ops(const uint8_t* packed, int64_t stride, int64_t n_rows,
                int64_t cols4, const int32_t* i_fin, const int32_t* j_fin,
                const uint8_t* rev_flags, uint32_t* out, int64_t out_cap,
                int32_t* out_len, int64_t* out_off) {
  int64_t w = 0;
  std::vector<uint32_t> ops;
  for (int64_t row = 0; row < n_rows; ++row) {
    ops.clear();
    const uint8_t* pr = packed + row * stride;
    const int64_t n_ops_total = cols4 * 4;
    // walk order = descending diagonal == descending unpacked index
    auto push = [&](uint32_t op, uint32_t len) {
      if (!ops.empty() && (ops.back() & 0xf) == op)
        ops.back() += len << 4;
      else
        ops.push_back(len << 4 | op);
    };
    for (int64_t idx = n_ops_total - 1; idx >= 0; --idx) {
      uint32_t op = (pr[idx >> 2] >> ((idx & 3) * 2)) & 3;
      if (op != 3) push(op, 1);
    }
    if (i_fin[row] >= 0) push(2, (uint32_t)(i_fin[row] + 1));
    if (j_fin[row] >= 0) push(1, (uint32_t)(j_fin[row] + 1));
    if (!rev_flags[row]) std::reverse(ops.begin(), ops.end());
    out_off[row] = w;
    out_len[row] = (int32_t)ops.size();
    if (w + (int64_t)ops.size() > out_cap) {  // caller retries with more room
      out_len[row] = -1;
      return;
    }
    std::memcpy(out + w, ops.data(), ops.size() * sizeof(uint32_t));
    w += ops.size();
  }
}

// 4-bit-packed variant (2 ops/byte, idle 15) for the spliced kernel whose
// op alphabet includes the intron op 3; min_intron applies the reference's
// leading-remainder rule (ksw_backtrack src/ksw2.h:148: an i-remainder of
// length >= min_intron_len becomes one 'N' run).
void wm_rle_ops4(const uint8_t* packed, int64_t stride, int64_t n_rows,
                 int64_t cols2, const int32_t* i_fin, const int32_t* j_fin,
                 const uint8_t* rev_flags, int32_t min_intron, uint32_t* out,
                 int64_t out_cap, int32_t* out_len, int64_t* out_off) {
  int64_t w = 0;
  std::vector<uint32_t> ops;
  for (int64_t row = 0; row < n_rows; ++row) {
    ops.clear();
    const uint8_t* pr = packed + row * stride;
    const int64_t n_ops_total = cols2 * 2;
    auto push = [&](uint32_t op, uint32_t len) {
      if (!ops.empty() && (ops.back() & 0xf) == op)
        ops.back() += len << 4;
      else
        ops.push_back(len << 4 | op);
    };
    for (int64_t idx = n_ops_total - 1; idx >= 0; --idx) {
      uint32_t op = (pr[idx >> 1] >> ((idx & 1) * 4)) & 15;
      if (op != 15) push(op, 1);
    }
    if (i_fin[row] >= 0)
      push(min_intron > 0 && i_fin[row] >= min_intron ? 3u : 2u,
           (uint32_t)(i_fin[row] + 1));
    if (j_fin[row] >= 0) push(1, (uint32_t)(j_fin[row] + 1));
    if (!rev_flags[row]) std::reverse(ops.begin(), ops.end());
    out_off[row] = w;
    out_len[row] = (int32_t)ops.size();
    if (w + (int64_t)ops.size() > out_cap) {  // caller retries with more room
      out_len[row] = -1;
      return;
    }
    std::memcpy(out + w, ops.data(), ops.size() * sizeof(uint32_t));
    w += ops.size();
  }
}

}  // extern "C"
