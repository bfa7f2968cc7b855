// winnowmap-tpu native mapping engine.
//
// The per-read mapping orchestration (reference mm_map_frag, src/map.c:279-981
// and the layers it drives: src/hit.c, src/align.c control flow) re-expressed
// as a C++ engine so nothing per-anchor or per-region runs in Python.  Each
// read (and each MCAS substring trial) runs on its own lightweight thread;
// threads block on a job exchange whenever they need an extension-DP result,
// and the Python side batches those jobs onto the TPU Pallas kernels
// (winnowmap_tpu/map/engine.py).  Jobs that are not device-eligible run
// inline on the host DP kernels (wm_extz/wm_extd in wm_ksw.cpp).
//
// This file is a faithful re-expression of this repo's own Python
// implementation (winnowmap_tpu/map/{frag,hit,align,seeds}.py), which is the
// parity-tested spec; behaviour is byte-identical by construction and
// asserted by tests/test_engine.py differentials.
#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <deque>
#include <iterator>
#include <memory>
#include <mutex>
#include <vector>

#include "wm_base.h"

// ---- natives from the sibling translation units --------------------------
extern "C" {
int64_t wm_chain_dp(int max_dist_x, int min_dist_x, int max_dist_y, int bw,
                    int max_skip, int max_iter, int min_cnt, int min_sc,
                    float gap_scale, int is_cdna, int n_segs, int64_t n,
                    const uint64_t* ax, const uint64_t* ay, uint64_t** out_u,
                    int32_t* out_n_u, uint64_t** out_ax, uint64_t** out_ay);
int64_t wm_sketch(const char* str, int len, int w, int k, uint32_t rid,
                  int is_hpc, const uint64_t* wset, int64_t n_wset,
                  const uint8_t* bloom, uint64_t bloom_bits, uint32_t salt0,
                  uint32_t salt1, uint64_t** out_x, uint64_t** out_y);
int64_t wm_sdust(const uint8_t* seq, int64_t l_seq, int T, int W,
                 uint64_t** out);
void wm_extz(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int w, int zdrop,
             int end_bonus, int flag, wm_ext_result* ez);
void wm_extz_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int w, int zdrop, int end_bonus, int flag,
                  wm_ext_result* ez);
void wm_extd(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int8_t q2,
             int8_t e2, int w, int zdrop, int end_bonus, int flag,
             wm_ext_result* ez);
void wm_extd_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int8_t q2, int8_t e2, int w, int zdrop,
                  int end_bonus, int flag, wm_ext_result* ez);
void wm_exts(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
             int m, const int8_t* mat, int8_t q, int8_t e, int8_t q2,
             int8_t noncan, int zdrop, int8_t junc_bonus, int flag,
             const uint8_t* junc, wm_ext_result* ez);
void wm_exts_fast(int qlen, const uint8_t* query, int tlen,
                  const uint8_t* target, int m, const int8_t* mat, int8_t q,
                  int8_t e, int8_t q2, int8_t noncan, int zdrop,
                  int8_t junc_bonus, int flag, const uint8_t* junc,
                  wm_ext_result* ez);
int wm_sw_i16(int qlen, const uint8_t* query, int tlen, const uint8_t* target,
              int m, const int8_t* mat, int gapo, int gape, int* qe_out,
              int* te_out);
int wm_test_zdrop(const uint8_t* qseq, const uint8_t* tseq,
                  const uint32_t* cigar, int32_t n_cigar, const int8_t* mat,
                  int q, int e, int zdrop, int zdrop_inv, int max_gap,
                  int min_inv_score, int min_dp_max, int try_inv);

typedef struct {
  int32_t qs, qe, rs, re;
  int32_t rev;
  int32_t blen, mlen;
  int32_t n_ambi;
  int32_t dp_max;
  int32_t n_cigar;
  uint32_t* cigar;
  int32_t qshift, tshift;
} wm_extra_io;
void wm_update_extra(const uint8_t* qseq_in, const uint8_t* tseq_in,
                     const uint32_t* cigar_in, int32_t n_cigar_in,
                     const int8_t* mat, int q, int e, int is_eqx,
                     wm_extra_io* io);
}

namespace weng {

// ---- option/flag constants (winnowmap_tpu/options.py) --------------------
enum : int64_t {
  MM_F_NO_DIAG = 0x001,
  MM_F_NO_DUAL = 0x002,
  MM_F_CIGAR = 0x004,
  MM_F_SPLICE = 0x080,
  MM_F_SPLICE_FOR = 0x100,
  MM_F_SPLICE_REV = 0x200,
  MM_F_NO_LJOIN = 0x400,
  MM_F_SR = 0x1000,
  MM_F_SPLICE_FLANK = 0x40000,
  MM_F_FOR_ONLY = 0x100000,
  MM_F_REV_ONLY = 0x200000,
  MM_F_ALL_CHAINS = 0x800000,
  MM_F_EQX = 0x4000000,
  MM_F_NO_END_FLT = 0x10000000,
  MM_F_HARD_MLEVEL = 0x20000000,
};
static const uint64_t MM_SEED_LONG_JOIN = 1ULL << 40;
static const uint64_t MM_SEED_IGNORE = 1ULL << 41;
static const uint64_t MM_SEED_TANDEM = 1ULL << 42;
static const uint64_t MM_SEED_SELF = 1ULL << 43;
static const int MM_SEED_SEG_SHIFT = 48;
static const int32_t PARENT_UNSET = -1;
static const int32_t PARENT_TMP_PRI = -2;

// ---- ctypes-mirrored structs (field order shared with native/__init__.py)
#pragma pack(push, 8)
struct EngOpts {   // subset of MapOptions the mapping path consumes
  int64_t flag;
  int64_t max_sw_mat;
  double chain_gap_scale, mask_level, pri_ratio, alt_drop, max_clip_ratio;
  double min_join_flank_ratio, min_qcov, prefix_increment_factor;
  int32_t seed, sdust_thres, bw, max_gap, min_gap_ref, max_gap_ref,
      max_frag_len, max_chain_skip, max_chain_iter, min_cnt, min_chain_score,
      mask_len, best_n, max_join_long, max_join_short, min_join_flank_sc,
      a, b, q, e, q2, e2, sc_ambi, noncan, junc_bonus, zdrop, zdrop_inv,
      end_bonus, min_dp_max, min_ksw_len, anchor_ext_len, anchor_ext_shift,
      mid_occ, max_occ, min_mapq, min_prefix_length, max_prefix_length,
      suffix_sample_offset, sv_aware, sv_aware_min_read_length, pad_;
};

struct EngIndex {  // flat index view (winnowmap_tpu/index/build.py arrays)
  const uint64_t* keys;
  const int64_t* start;
  const uint64_t* pos;
  const uint8_t* codes;    // packed reference 0..4 codes, all rids concat
  const int64_t* seq_off;  // per-rid offset into codes
  const int32_t* seq_len;  // per-rid length
  const uint64_t* wset;    // sorted down-weight set
  const uint8_t* bloom;    // --bloom-filter parity mode table (else null)
  int64_t n_keys, n_wset;
  uint64_t bloom_bits;
  uint64_t bloom_salts;  // salt1 << 32 | salt0
  int32_t n_seq, w, k, idx_flag;  // idx_flag bit0 = HPC
};

struct RegOut {  // flattened mm_reg1_t for the Python output layer
  int32_t id, cnt, rid, score, qs, qe, rs, re, parent, subsc, as_, mlen,
      blen, n_sub, score0, mapq;
  float div;
  int32_t inv, rev, split, split_inv, sam_pri, seg_split, seg_id, n_segs,
      is_alt, has_p;
  uint32_t hash;
  // Extra fields (valid when has_p)
  int32_t dp_score, dp_max, dp_max2, n_ambi, trans_strand;
  int64_t cigar_off;  // into the per-read cigar blob
  int32_t n_cigar, pad_;
};
#pragma pack(pop)

// exported job row layout (int64 x 12):
//  [id, qoff, qlen, qrev, toff, tlen, trev, w, zdrop, end_bonus, ezflag, prof]
static const int JOB_I64 = 12;

// ---- small helpers -------------------------------------------------------
static inline int32_t i32of(uint64_t v) { return (int32_t)(uint32_t)v; }

static inline uint64_t hash64(uint64_t key) {  // hit.py _hash64
  key = ~key + (key << 21);
  key = key ^ (key >> 24);
  key = (key + (key << 3)) + (key << 8);
  key = key ^ (key >> 14);
  key = (key + (key << 2)) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

static inline uint32_t wang_hash(uint32_t key) {  // frag.py _wang_hash
  key = key + ~(key << 15);
  key ^= key >> 10;
  key = key + (key << 3);
  key ^= key >> 6;
  key = key + ~(key << 11);
  key ^= key >> 16;
  return key;
}

static inline uint32_t frag_hash(uint32_t qname_x31, int qlen_sum,
                                 int seed) {  // frag.py _frag_hash
  uint32_t h = qname_x31;
  h ^= wang_hash((uint32_t)qlen_sum) + wang_hash((uint32_t)seed);
  return wang_hash(h);
}

static void gen_simple_mat(int a, int b, int sc_ambi, int8_t mat[25]) {
  a = a < 0 ? -a : a;
  b = b > 0 ? -b : b;
  sc_ambi = sc_ambi > 0 ? -sc_ambi : sc_ambi;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) mat[i * 5 + j] = (int8_t)(i == j ? a : b);
    mat[i * 5 + 4] = (int8_t)sc_ambi;
  }
  for (int j = 0; j < 5; ++j) mat[20 + j] = (int8_t)sc_ambi;
}

// ---- region record -------------------------------------------------------
struct Extra {
  int32_t dp_score = 0, dp_max = 0, dp_max2 = 0, n_ambi = 0, trans_strand = 0;
  std::vector<uint32_t> cigar;
};

struct Reg {
  int32_t id = 0, cnt = 0, rid = 0, score = 0, qs = 0, qe = 0, rs = 0, re = 0;
  int32_t parent = PARENT_UNSET, subsc = 0, as_ = 0, mlen = 0, blen = 0;
  int32_t n_sub = 0, score0 = 0, mapq = 0;
  float div = -1.0f;
  bool inv = false, rev = false, split_inv = false, sam_pri = false;
  bool seg_split = false, is_alt = false;
  int32_t split = 0, seg_id = 0, n_segs = 1;
  uint32_t hash = 0;
  std::shared_ptr<Extra> p;  // shared so copies mirror Python references
};

static void cal_fuzzy_len(Reg& r, const uint64_t* ax, const uint64_t* ay) {
  r.mlen = r.blen = 0;
  if (r.cnt <= 0) return;
  int64_t a0 = r.as_;
  int64_t blen = (int64_t)(ay[a0] >> 32 & 0xff);
  int64_t mlen = blen;
  for (int64_t i = a0 + 1; i < a0 + r.cnt; ++i) {
    int64_t span = (int64_t)(ay[i] >> 32 & 0xff);
    int64_t tl = (int64_t)i32of(ax[i]) - i32of(ax[i - 1]);
    int64_t ql = (int64_t)i32of(ay[i]) - i32of(ay[i - 1]);
    blen += tl > ql ? tl : ql;
    int64_t mn = tl < ql ? tl : ql;
    mlen += (tl > span && ql > span) ? span : mn;
  }
  r.blen = (int32_t)blen;
  r.mlen = (int32_t)mlen;
}

static void reg_set_coor(Reg& r, int qlen, const uint64_t* ax,
                         const uint64_t* ay) {
  int64_t k = r.as_;
  int q_span = (int)(ay[k] >> 32 & 0xff);
  r.rev = (ax[k] >> 63) != 0;
  r.rid = (int32_t)(ax[k] << 1 >> 33);
  int rs = i32of(ax[k]) + 1 - q_span;
  r.rs = rs > 0 ? rs : 0;
  r.re = i32of(ax[k + r.cnt - 1]) + 1;
  if (!r.rev) {
    r.qs = i32of(ay[k]) + 1 - q_span;
    r.qe = i32of(ay[k + r.cnt - 1]) + 1;
  } else {
    r.qs = qlen - (i32of(ay[k + r.cnt - 1]) + 1);
    r.qe = qlen - (i32of(ay[k]) + 1 - q_span);
  }
  cal_fuzzy_len(r, ax, ay);
}

static std::vector<Reg> gen_regs(uint32_t hash_, int qlen, const uint64_t* u,
                                 int n_u, const uint64_t* ax,
                                 const uint64_t* ay) {
  std::vector<Reg> regs;
  if (n_u == 0) return regs;
  std::vector<std::pair<uint64_t, int64_t>> z(n_u);  // (zx, as_)
  std::vector<int32_t> zcnt(n_u);
  int64_t k = 0;
  for (int i = 0; i < n_u; ++i) {
    uint64_t h =
        hash64((hash64(ax[k]) + hash64(ay[k])) ^ (uint64_t)hash_) & 0xffffffffULL;
    z[i] = {u[i] ^ h, k};
    zcnt[i] = i32of(u[i]);
    k += i32of(u[i]);
  }
  std::vector<int> ord(n_u);
  for (int i = 0; i < n_u; ++i) ord[i] = i;
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int a, int b) { return z[a].first < z[b].first; });
  regs.resize(n_u);
  for (int i = 0; i < n_u; ++i) {
    int oi = ord[n_u - 1 - i];
    Reg& r = regs[i];
    r.id = i;
    r.parent = PARENT_UNSET;
    r.score = r.score0 = (int32_t)(z[oi].first >> 32);
    r.hash = (uint32_t)(z[oi].first & 0xffffffffULL);
    r.cnt = zcnt[oi];
    r.as_ = (int32_t)z[oi].second;
    r.div = -1.0f;
    reg_set_coor(r, qlen, ax, ay);
  }
  return regs;
}

static bool split_reg(Reg& r, Reg& r2_out, int n, int qlen, const uint64_t* ax,
                      const uint64_t* ay) {
  if (n <= 0 || n >= r.cnt) return false;
  Reg r2 = r;  // copies shared p intentionally, then reset below
  r2.id = -1;
  r2.sam_pri = false;
  r2.p = nullptr;
  r2.split_inv = false;
  r2.cnt = r.cnt - n;
  r2.score = (int32_t)((double)r.score * ((double)r2.cnt / (double)r.cnt) + 0.499);
  r2.as_ = r.as_ + n;
  if (r.parent == r.id) r2.parent = PARENT_TMP_PRI;
  reg_set_coor(r2, qlen, ax, ay);
  r.cnt -= r2.cnt;
  r.score -= r2.score;
  reg_set_coor(r, qlen, ax, ay);
  r.split |= 1;
  r2.split |= 2;
  r2_out = std::move(r2);
  return true;
}

static int32_t alt_score(int32_t score, double frac) {
  if (score < 0) return score;
  score = (int32_t)((double)score * (1.0 - frac) + 0.499);
  return score > 0 ? score : 1;
}

static void set_parent(double mask_level, int mask_len, std::vector<Reg>& regs,
                       int sub_diff, bool hard_mask_level, double alt_diff_frac) {
  int n = (int)regs.size();
  if (n <= 0) return;
  for (int i = 0; i < n; ++i) regs[i].id = i;
  std::vector<int> w;
  w.push_back(0);
  regs[0].parent = 0;
  for (int i = 1; i < n; ++i) {
    Reg& ri = regs[i];
    int si = ri.qs, ei = ri.qe;
    int64_t uncov_len = 0;
    int j_break = -1;
    if (!hard_mask_level) {
      std::vector<std::pair<int, int>> cov;
      for (size_t j = 0; j < w.size(); ++j) {
        Reg& rp = regs[w[j]];
        int sj = rp.qs, ej = rp.qe;
        if (ej <= si || sj >= ei) continue;
        cov.push_back({sj > si ? sj : si, ej < ei ? ej : ei});
      }
      if (!cov.empty()) {
        std::sort(cov.begin(), cov.end());
        int x = si;
        for (auto& ce : cov) {
          if (ce.first > x) uncov_len += ce.first - x;
          x = ce.second > x ? ce.second : x;
        }
        if (ei > x) uncov_len += ei - x;
      }
    }
    for (size_t j = 0; j < w.size(); ++j) {
      Reg& rp = regs[w[j]];
      int sj = rp.qs, ej = rp.qe;
      if (ej <= si || sj >= ei) continue;
      int min_ = std::min(ej - sj, ei - si);
      int max_ = std::max(ej - sj, ei - si);
      int ol;
      if (si < sj)
        ol = ei < sj ? 0 : (ei < ej ? ei - sj : ej - sj);
      else
        ol = ej < si ? 0 : (ej < ei ? ej - si : ei - si);
      if ((float)ol / (float)min_ - (float)uncov_len / (float)max_ >
              (float)mask_level &&
          uncov_len <= mask_len) {
        int cnt_sub = 0;
        int32_t sci = ri.score;
        ri.parent = rp.parent;
        if (!rp.is_alt && ri.is_alt) sci = alt_score(sci, alt_diff_frac);
        rp.subsc = std::max(rp.subsc, sci);
        if (ri.cnt >= rp.cnt) cnt_sub = 1;
        if (rp.p && ri.p &&
            (rp.rid != ri.rid || rp.rs != ri.rs || rp.re != ri.re ||
             ol != min_)) {
          sci = ri.p->dp_max;
          if (!rp.is_alt && ri.is_alt) sci = alt_score(sci, alt_diff_frac);
          rp.p->dp_max2 = std::max(rp.p->dp_max2, sci);
          if (rp.p->dp_max - ri.p->dp_max <= sub_diff) cnt_sub = 1;
        }
        if (cnt_sub) rp.n_sub += 1;
        j_break = (int)j;
        break;
      }
    }
    if (j_break < 0) {
      w.push_back(i);
      ri.parent = i;
      ri.n_sub = 0;
    }
  }
}

static std::vector<Reg> hit_sort(std::vector<Reg>& regs, double alt_diff_frac) {
  std::vector<Reg> out;
  if (regs.size() <= 1) {
    for (auto& r : regs)
      if (r.inv || r.cnt > 0) out.push_back(std::move(r));
    return out;
  }
  std::vector<std::pair<uint64_t, int>> aux;
  for (int i = 0; i < (int)regs.size(); ++i) {
    Reg& r = regs[i];
    if (r.inv || r.cnt > 0) {
      int32_t score = r.p ? r.p->dp_max : r.score;
      if (r.is_alt) score = alt_score(score, alt_diff_frac);
      aux.push_back({((uint64_t)(uint32_t)score << 32) | r.hash, i});
    }
  }
  std::stable_sort(aux.begin(), aux.end(),
                   [](const std::pair<uint64_t, int>& a,
                      const std::pair<uint64_t, int>& b) {
                     return a.first < b.first;
                   });
  for (auto it = aux.rbegin(); it != aux.rend(); ++it)
    out.push_back(std::move(regs[it->second]));
  return out;
}

static int set_sam_pri(std::vector<Reg>& regs) {
  int n_pri = 0;
  for (auto& r : regs) {
    if (r.id == r.parent) {
      ++n_pri;
      r.sam_pri = n_pri == 1;
    } else {
      r.sam_pri = false;
    }
  }
  return n_pri;
}

static void sync_regs(std::vector<Reg>& regs) {
  if (regs.empty()) return;
  int max_id = 0;
  for (auto& r : regs) max_id = std::max(max_id, r.id);
  std::vector<int> tmp(max_id + 1, -1);
  for (int i = 0; i < (int)regs.size(); ++i)
    if (regs[i].id >= 0) tmp[regs[i].id] = i;
  for (int i = 0; i < (int)regs.size(); ++i) {
    Reg& r = regs[i];
    r.id = i;
    if (r.parent == PARENT_TMP_PRI)
      r.parent = i;
    else if (r.parent >= 0 && tmp[r.parent] >= 0)
      r.parent = tmp[r.parent];
    else
      r.parent = PARENT_UNSET;
  }
  set_sam_pri(regs);
}

static std::vector<Reg> select_sub(double pri_ratio, int min_diff, int best_n,
                                   std::vector<Reg>& regs) {
  if (pri_ratio <= 0.0 || regs.empty()) return std::move(regs);
  std::vector<Reg> out;
  int n_2nd = 0;
  size_t n_in = regs.size();
  for (int i = 0; i < (int)regs.size(); ++i) {
    Reg& r = regs[i];
    int p = r.parent;
    if (p == i || r.inv) {
      out.push_back(std::move(r));
    } else if (((double)r.score >= (double)regs[p].score * pri_ratio ||
                r.score + min_diff >= regs[p].score) &&
               n_2nd < best_n) {
      if (!(r.qs == regs[p].qs && r.qe == regs[p].qe && r.rid == regs[p].rid &&
            r.rs == regs[p].rs && r.re == regs[p].re)) {
        out.push_back(std::move(r));
        ++n_2nd;
      }
    }
  }
  if (out.size() != n_in) sync_regs(out);
  return out;
}

static std::vector<Reg> filter_regs(const EngOpts& opt, int qlen,
                                    std::vector<Reg>& regs) {
  std::vector<Reg> out;
  for (auto& r : regs) {
    bool flt = false;
    if (!r.inv && !r.seg_split && r.cnt < opt.min_cnt) flt = true;
    if (r.p) {
      if (r.mlen < opt.min_chain_score)
        flt = true;
      else if (r.p->dp_max < opt.min_dp_max)
        flt = true;
      else if ((double)r.qs > (double)qlen * opt.max_clip_ratio &&
               (double)(qlen - r.qe) > (double)qlen * opt.max_clip_ratio)
        flt = true;
    }
    if (!flt) out.push_back(std::move(r));
  }
  return out;
}

static int64_t squeeze_a(std::vector<Reg>& regs, uint64_t* ax, uint64_t* ay) {
  std::vector<int> aux(regs.size());
  for (int i = 0; i < (int)regs.size(); ++i) aux[i] = i;
  std::sort(aux.begin(), aux.end(), [&](int a, int b) {
    return (((int64_t)regs[a].as_ << 32) | a) < (((int64_t)regs[b].as_ << 32) | b);
  });
  int64_t as_ = 0;
  for (int i : aux) {
    Reg& r = regs[i];
    if (r.as_ != as_) {
      std::memmove(ax + as_, ax + r.as_, (size_t)r.cnt * 8);
      std::memmove(ay + as_, ay + r.as_, (size_t)r.cnt * 8);
      r.as_ = (int32_t)as_;
    }
    as_ += r.cnt;
  }
  return as_;
}

static std::vector<Reg> join_long(const EngOpts& opt, int qlen,
                                  std::vector<Reg>& regs, uint64_t* ax,
                                  uint64_t* ay) {
  if (regs.size() < 2) return std::move(regs);
  squeeze_a(regs, ax, ay);
  std::vector<int> aux;
  for (int i = 0; i < (int)regs.size(); ++i)
    if (regs[i].parent == i || regs[i].parent < 0) aux.push_back(i);
  std::sort(aux.begin(), aux.end(), [&](int a, int b) {
    return (((int64_t)regs[a].as_ << 32) | a) < (((int64_t)regs[b].as_ << 32) | b);
  });
  int n_drop = 0;
  for (int idx = (int)aux.size() - 1; idx >= 1; --idx) {
    Reg& r0 = regs[aux[idx - 1]];
    Reg& r1 = regs[aux[idx]];
    if (r0.as_ + r0.cnt != r1.as_) continue;
    if (r0.rid != r1.rid || r0.rev != r1.rev) continue;
    uint64_t a0e_x = ax[r0.as_ + r0.cnt - 1], a0e_y = ay[r0.as_ + r0.cnt - 1];
    uint64_t a1s_x = ax[r1.as_], a1s_y = ay[r1.as_];
    if (a1s_x <= a0e_x || i32of(a1s_y) <= i32of(a0e_y)) continue;
    int64_t gap_q = (int64_t)i32of(a1s_y) - i32of(a0e_y);
    int64_t max_gap = gap_q, min_gap = gap_q;
    max_gap = (int64_t)(a0e_x + max_gap) > (int64_t)a1s_x
                  ? max_gap
                  : (int64_t)(a1s_x - a0e_x);
    min_gap = (int64_t)(a0e_x + min_gap) < (int64_t)a1s_x
                  ? min_gap
                  : (int64_t)(a1s_x - a0e_x);
    if (max_gap > opt.max_join_long || min_gap > opt.max_join_short) continue;
    int sc_thres = (int)((double)((float)opt.min_join_flank_sc /
                                  (float)opt.max_join_long * (float)max_gap) +
                         0.499);
    if (r0.score < sc_thres || r1.score < sc_thres) continue;
    int min_flank_len = (int)((double)max_gap * opt.min_join_flank_ratio);
    if (r0.re - r0.rs < min_flank_len || r0.qe - r0.qs < min_flank_len)
      continue;
    if (r1.re - r1.rs < min_flank_len || r1.qe - r1.qs < min_flank_len)
      continue;
    ay[r1.as_] |= MM_SEED_LONG_JOIN;
    r0.cnt += r1.cnt;
    r0.score += r1.score;
    reg_set_coor(r0, qlen, ax, ay);
    r1.cnt = 0;
    r1.parent = r0.id;
    ++n_drop;
  }
  if (n_drop > 0) {
    for (auto& r : regs) {
      if (r.parent >= 0 && r.id != r.parent) {
        int pp = regs[r.parent].parent;
        if (pp >= 0 && pp != r.parent) r.parent = pp;
      }
    }
    regs = filter_regs(opt, qlen, regs);
    sync_regs(regs);
  }
  return std::move(regs);
}

static void set_inv_mapq(std::vector<Reg>& regs) {
  int n = (int)regs.size();
  if (n < 3) return;
  bool any_inv = false;
  for (auto& r : regs) any_inv |= r.inv;
  if (!any_inv) return;
  std::vector<int> aux;
  for (int i = 0; i < n; ++i)
    if (regs[i].parent == i || regs[i].parent < 0) aux.push_back(i);
  std::stable_sort(aux.begin(), aux.end(), [&](int a, int b) {
    int64_t ka = ((int64_t)regs[a].rid << 32) | (uint32_t)regs[a].rs;
    int64_t kb = ((int64_t)regs[b].rid << 32) | (uint32_t)regs[b].rs;
    return ka != kb ? ka < kb : a < b;
  });
  for (int k = 1; k + 1 < (int)aux.size(); ++k) {
    Reg& inv = regs[aux[k]];
    if (inv.inv) inv.mapq = std::min(regs[aux[k - 1]].mapq, regs[aux[k + 1]].mapq);
  }
}

static void set_mapq(std::vector<Reg>& regs, int min_chain_sc, int match_sc,
                     int rep_len, bool is_sr) {
  if (regs.empty()) return;
  const float q_coef = 40.0f;
  int64_t sum_sc = 0;
  for (auto& r : regs)
    if (r.parent == r.id) sum_sc += r.score;
  float uniq_ratio =
      (sum_sc + rep_len) ? (float)sum_sc / (float)(sum_sc + rep_len) : 0.0f;
  for (auto& r : regs) {
    if (r.inv) {
      r.mapq = 0;
    } else if (r.parent == r.id) {
      float pen_s1 =
          (r.score > 100 ? 1.0f : 0.01f * (float)r.score) * uniq_ratio;
      float pen_cm = r.cnt > 10 ? 1.0f : 0.1f * (float)r.cnt;
      pen_cm = pen_s1 < pen_cm ? pen_s1 : pen_cm;
      int subsc = r.subsc > min_chain_sc ? r.subsc : min_chain_sc;
      int mapq;
      if (r.p && r.p->dp_max2 > 0 && r.p->dp_max > 0) {
        float identity = (float)r.mlen / (float)r.blen;
        float x = (float)r.p->dp_max2 * (float)subsc / (float)r.p->dp_max /
                  (float)r.score0;
        mapq = (int)(identity * pen_cm * q_coef * (1.0f - x * x) *
                     logf((float)r.p->dp_max / (float)match_sc));
        if (!is_sr) {
          int mapq_alt =
              (int)(6.02f * identity * identity *
                        (float)(r.p->dp_max - r.p->dp_max2) / (float)match_sc +
                    0.499f);
          mapq = std::min(mapq, mapq_alt);
        }
      } else {
        float x = (float)subsc / (float)r.score0;
        if (r.p) {
          float identity = (float)r.mlen / (float)r.blen;
          mapq = (int)(identity * pen_cm * q_coef * (1.0f - x) *
                       logf((float)r.p->dp_max / (float)match_sc));
        } else {
          mapq = (int)(pen_cm * q_coef * (1.0f - x) * logf((float)r.score));
        }
      }
      mapq -= (int)(4.343f * logf((float)(r.n_sub + 1)) + 0.499f);
      mapq = mapq > 0 ? mapq : 0;
      r.mapq = mapq < 60 ? mapq : 60;
      if (r.p && r.p->dp_max > r.p->dp_max2 && r.mapq == 0) r.mapq = 1;
    } else {
      r.mapq = 0;
    }
  }
  set_inv_mapq(regs);
}

}  // namespace weng

namespace weng {

// ---- seeding (winnowmap_tpu/map/seeds.py; reference map.c:69-254) --------
struct SeedHits {
  std::vector<uint64_t> ax, ay;
  int64_t rep_len = 0;
};

static int64_t index_lookup(const EngIndex& mi, uint64_t key, int64_t* cnt) {
  const uint64_t* lo =
      std::lower_bound(mi.keys, mi.keys + mi.n_keys, key);
  int64_t i = lo - mi.keys;
  if (i >= mi.n_keys || mi.keys[i] != key) {
    *cnt = 0;
    return 0;
  }
  *cnt = mi.start[i + 1] - mi.start[i];
  return mi.start[i];
}

// sketch + optional sdust filter (seeds.py collect_minimizers, n_segs==1)
static void collect_minimizers(const EngOpts& opt, const EngIndex& mi,
                               const uint8_t* seq, int qlen,
                               std::vector<uint64_t>& mvx,
                               std::vector<uint64_t>& mvy) {
  uint64_t *x = nullptr, *y = nullptr;
  int64_t n = wm_sketch((const char*)seq, qlen, mi.w, mi.k, 0,
                        mi.idx_flag & 1, mi.wset, mi.n_wset, mi.bloom,
                        mi.bloom_bits, (uint32_t)mi.bloom_salts,
                        (uint32_t)(mi.bloom_salts >> 32), &x, &y);
  if (opt.sdust_thres > 0 && n > 0) {
    uint64_t* dreg = nullptr;
    int64_t nd = wm_sdust(seq, qlen, opt.sdust_thres, 64, &dreg);
    if (nd > 0) {
      // keep a minimizer if at most half its span is dust-masked
      // (seeds.py dust_minimizers; reference mm_dust_minier, map.c:43-67)
      std::vector<int64_t> ds(nd), de(nd);
      for (int64_t j = 0; j < nd; ++j) {
        ds[j] = (int64_t)(dreg[j] >> 32);
        de[j] = (int64_t)(dreg[j] & 0xffffffffULL);
      }
      int64_t w_ = 0;
      for (int64_t j = 0; j < n; ++j) {
        int64_t qpos = (int64_t)((y[j] & 0xffffffffULL) >> 1);
        int64_t span = (int64_t)(x[j] & 0xff);
        int64_t s = qpos - (span - 1), e = s + span;
        int64_t v = std::upper_bound(de.begin(), de.end(), s) - de.begin();
        int64_t l = 0;
        while (v < nd && ds[v] < e) {
          l += std::min(e, de[v]) - std::max(s, ds[v]);
          ++v;
        }
        if (l <= (span >> 1)) {
          x[w_] = x[j];
          y[w_] = y[j];
          ++w_;
        }
      }
      n = w_;
    }
    if (dreg) wm_free(dreg);
  }
  mvx.assign(x, x + n);
  mvy.assign(y, y + n);
  if (x) wm_free(x);
  if (y) wm_free(y);
}

// index lookups + anchor construction (seeds.py collect_seed_hits).
// The engine runs only the fast path: qname-dependent skip flags
// (NO_DIAG/NO_DUAL) and FOR/REV_ONLY batches stay on the Python engine
// fallback (map/engine.py gates on those flags).
static SeedHits collect_seed_hits(const EngOpts& opt, int max_occ,
                                  const EngIndex& mi,
                                  const std::vector<uint64_t>& mvx,
                                  const std::vector<uint64_t>& mvy, int qlen) {
  SeedHits sh;
  int64_t n = (int64_t)mvx.size();
  if (n == 0) return sh;
  std::vector<int64_t> rs(n), rc(n);
  std::vector<uint8_t> found(n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cnt;
    rs[i] = index_lookup(mi, mvx[i] >> 8, &cnt);
    rc[i] = cnt;
    found[i] = cnt > 0;
  }
  // rep_len: merged footprint of over-threshold minimizers
  int64_t rep_len = 0, rep_st = 0, rep_en = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!(found[i] && rc[i] >= max_occ)) continue;
    int64_t qpos = (int64_t)(mvy[i] & 0xffffffffULL);
    int64_t span = (int64_t)(mvx[i] & 0xff);
    int64_t en = (qpos >> 1) + 1, st = en - span;
    if (st > rep_en) {
      rep_len += rep_en - rep_st;
      rep_st = st;
      rep_en = en;
    } else {
      rep_en = en;
    }
  }
  rep_len += rep_en - rep_st;
  sh.rep_len = rep_len;

  std::vector<uint8_t> tandem(n, 0);
  for (int64_t i = 1; i < n; ++i)
    if ((mvx[i] >> 8) == (mvx[i - 1] >> 8)) tandem[i] = tandem[i - 1] = 1;

  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i)
    if (found[i] && rc[i] < max_occ) total += rc[i];
  sh.ax.reserve(total);
  sh.ay.reserve(total);
  for (int64_t i = 0; i < n; ++i) {
    if (!found[i] || rc[i] >= max_occ) continue;
    uint64_t qp = mvy[i] & 0xffffffffULL;
    uint64_t span = mvx[i] & 0xff;
    for (int64_t o = rs[i]; o < rs[i] + rc[i]; ++o) {
      uint64_t r = mi.pos[o];
      uint64_t rpos = (r & 0xffffffffULL) >> 1;
      uint64_t rhi = r & 0xffffffff00000000ULL;
      uint64_t xx, yy;
      if ((r & 1) == (qp & 1)) {  // forward
        xx = rhi | rpos;
        yy = (span << 32) | (qp >> 1);
      } else {
        xx = (1ULL << 63) | rhi | rpos;
        yy = (span << 32) |
             (uint64_t)(qlen - (int64_t)((qp >> 1) + 1 - span) - 1);
      }
      if (tandem[i]) yy |= MM_SEED_TANDEM;
      sh.ax.push_back(xx);
      sh.ay.push_back(yy);
    }
  }
  // stable sort by x preserving per-minimizer occurrence order
  int64_t m = (int64_t)sh.ax.size();
  std::vector<int64_t> ord(m);
  for (int64_t i = 0; i < m; ++i) ord[i] = i;
  std::stable_sort(ord.begin(), ord.end(),
                   [&](int64_t a, int64_t b) { return sh.ax[a] < sh.ax[b]; });
  std::vector<uint64_t> ax2(m), ay2(m);
  for (int64_t i = 0; i < m; ++i) {
    ax2[i] = sh.ax[ord[i]];
    ay2[i] = sh.ay[ord[i]];
  }
  sh.ax.swap(ax2);
  sh.ay.swap(ay2);
  return sh;
}

// ---- align-layer helpers (winnowmap_tpu/map/align.py) --------------------

static void append_cigar(Reg& r, const uint32_t* cig, int n) {
  if (n == 0) return;
  if (!r.p) r.p = std::make_shared<Extra>();
  std::vector<uint32_t>& old = r.p->cigar;
  if (!old.empty() && (old.back() & 0xF) == (cig[0] & 0xF)) {
    uint32_t merged0 = cig[0] + ((old.back() >> 4) << 4);
    old.pop_back();
    old.push_back(merged0);
    old.insert(old.end(), cig + 1, cig + n);
  } else {
    old.insert(old.end(), cig, cig + n);
  }
}

static std::vector<int64_t> collect_long_gaps(int64_t as1, int64_t cnt1,
                                              const uint64_t* ax,
                                              const uint64_t* ay,
                                              int min_gap) {
  std::vector<int64_t> K;
  for (int64_t i = 1; i < cnt1; ++i) {
    int64_t gap = ((int64_t)i32of(ay[as1 + i]) - i32of(ay[as1 + i - 1])) -
                  ((int64_t)i32of(ax[as1 + i]) - i32of(ax[as1 + i - 1]));
    if (gap < -min_gap || gap > min_gap) K.push_back(i);
  }
  if (K.size() <= 1) K.clear();
  return K;
}

static void filter_bad_seeds(int64_t as1, int64_t cnt1, const uint64_t* ax,
                             uint64_t* ay, int min_gap, int diff_thres,
                             int max_ext_len, int max_ext_cnt) {
  std::vector<int64_t> K = collect_long_gaps(as1, cnt1, ax, ay, min_gap);
  if (K.empty()) return;
  int64_t n = (int64_t)K.size();
  int64_t max_ = 0, max_st = -1, max_en = -1;
  int64_t k = 0;
  while (true) {
    if (k == n || (max_en >= 0 && k >= max_en)) {
      if (max_en > 0) {
        for (int64_t i = K[max_st]; i < K[max_en]; ++i)
          ay[as1 + i] |= MM_SEED_IGNORE;
      }
      max_ = 0;
      max_st = max_en = -1;
      if (k == n) break;
    }
    int64_t i = K[k];
    int64_t gap = ((int64_t)i32of(ay[as1 + i]) - i32of(ay[as1 + i - 1])) -
                  ((int64_t)i32of(ax[as1 + i]) - i32of(ax[as1 + i - 1]));
    int64_t n_ins = gap > 0 ? gap : 0;
    int64_t n_del = gap <= 0 ? -gap : 0;
    int64_t qs = i32of(ay[as1 + i - 1]);
    int64_t rs = i32of(ax[as1 + i - 1]);
    int64_t max_diff = 0, max_diff_l = -1;
    int64_t l = k + 1;
    while (l < n && l <= k + max_ext_cnt) {
      int64_t j = K[l];
      if ((int64_t)i32of(ay[as1 + j]) - qs > max_ext_len ||
          (int64_t)i32of(ax[as1 + j]) - rs > max_ext_len)
        break;
      int64_t g = ((int64_t)i32of(ay[as1 + j]) - i32of(ay[as1 + j - 1])) -
                  ((int64_t)i32of(ax[as1 + j]) - i32of(ax[as1 + j - 1]));
      if (g > 0)
        n_ins += g;
      else
        n_del += -g;
      int64_t ad = n_ins - n_del;
      if (ad < 0) ad = -ad;
      int64_t diff = n_ins + n_del - ad;
      if (max_diff < diff) {
        max_diff = diff;
        max_diff_l = l;
      }
      ++l;
    }
    if (max_diff > diff_thres && max_diff > max_) {
      max_ = max_diff;
      max_st = k;
      max_en = max_diff_l;
    }
    ++k;
  }
}

static void filter_bad_seeds_alt(int64_t as1, int64_t cnt1, const uint64_t* ax,
                                 uint64_t* ay, int min_gap, int max_ext) {
  std::vector<int64_t> K = collect_long_gaps(as1, cnt1, ax, ay, min_gap);
  if (K.empty()) return;
  int64_t n = (int64_t)K.size();
  int64_t k = 0;
  while (k < n) {
    int64_t i = K[k];
    int64_t gap1 = ((int64_t)i32of(ay[as1 + i]) - i32of(ay[as1 + i - 1])) -
                   ((int64_t)i32of(ax[as1 + i]) - i32of(ax[as1 + i - 1]));
    int64_t re1 = i32of(ax[as1 + i]);
    int64_t qe1 = i32of(ay[as1 + i]);
    gap1 = gap1 < 0 ? -gap1 : gap1;
    int64_t l = k + 1;
    while (l < n) {
      int64_t j = K[l];
      if ((int64_t)i32of(ay[as1 + j]) - qe1 > max_ext ||
          (int64_t)i32of(ax[as1 + j]) - re1 > max_ext)
        break;
      int64_t gap2 = ((int64_t)i32of(ay[as1 + j]) - i32of(ay[as1 + j - 1])) -
                     ((int64_t)i32of(ax[as1 + j]) - i32of(ax[as1 + j - 1]));
      int64_t q_span_pre = (int64_t)(ay[as1 + j - 1] >> 32 & 0xff);
      int64_t rs2 = i32of(ax[as1 + j - 1]) + q_span_pre;
      int64_t qs2 = i32of(ay[as1 + j - 1]) + q_span_pre;
      int64_t m = std::min(rs2 - re1, qs2 - qe1);
      gap2 = gap2 < 0 ? -gap2 : gap2;
      if (m > gap1 + gap2) break;
      re1 = i32of(ax[as1 + j]);
      qe1 = i32of(ay[as1 + j]);
      gap1 = gap2;
      ++l;
    }
    if (l > k + 1) {
      int64_t end = K[l - 1];
      for (int64_t j = K[k]; j < end; ++j) ay[as1 + j] |= MM_SEED_IGNORE;
      ay[as1 + end] |= MM_SEED_LONG_JOIN;
    }
    k = l;
  }
}

static void fix_bad_ends(const Reg& r, const uint64_t* ax, const uint64_t* ay,
                         int bw, int min_match, int64_t* as_out,
                         int64_t* cnt_out) {
  int64_t as_ = r.as_, cnt = r.cnt;
  if (r.cnt < 3) {
    *as_out = as_;
    *cnt_out = cnt;
    return;
  }
  int64_t a0 = r.as_, a1 = r.as_ + r.cnt;
  int64_t m, l;
  m = l = (int64_t)(ay[a0] >> 32 & 0xff);
  for (int64_t i = 1; i < r.cnt - 1; ++i) {
    int64_t q_span = (int64_t)(ay[a0 + i] >> 32 & 0xff);
    if (ay[a0 + i] & MM_SEED_LONG_JOIN) break;
    int64_t lr = (int64_t)i32of(ax[a0 + i]) - i32of(ax[a0 + i - 1]);
    int64_t lq = (int64_t)i32of(ay[a0 + i]) - i32of(ay[a0 + i - 1]);
    int64_t mn = lr < lq ? lr : lq, mx = lr < lq ? lq : lr;
    if (mx - mn > (l >> 1)) as_ = a0 + i;
    l += mn;
    m += mn < q_span ? mn : q_span;
    if (l >= ((int64_t)bw << 1) || (m >= min_match && m >= bw) ||
        m >= (r.mlen >> 1))
      break;
  }
  cnt = a1 - as_;
  m = l = (int64_t)(ay[a0 + r.cnt - 1] >> 32 & 0xff);
  for (int64_t i = r.cnt - 2; i > as_ - a0; --i) {
    int64_t q_span = (int64_t)(ay[a0 + i + 1] >> 32 & 0xff);
    if (ay[a0 + i + 1] & MM_SEED_LONG_JOIN) break;
    int64_t lr = (int64_t)i32of(ax[a0 + i + 1]) - i32of(ax[a0 + i]);
    int64_t lq = (int64_t)i32of(ay[a0 + i + 1]) - i32of(ay[a0 + i]);
    int64_t mn = lr < lq ? lr : lq, mx = lr < lq ? lq : lr;
    if (mx - mn > (l >> 1)) cnt = a0 + i + 1 - as_;
    l += mn;
    m += mn < q_span ? mn : q_span;
    if (l >= ((int64_t)bw << 1) || (m >= min_match && m >= bw) ||
        m >= (r.mlen >> 1))
      break;
  }
  *as_out = as_;
  *cnt_out = cnt;
}

// local-SW score of a single seed's neighbourhood (align.py seed_ext_score;
// reference mm_seed_ext_score, align.c:523-543)
static int seed_ext_score(const EngOpts& opt, const EngIndex& mi,
                          const int8_t* mat, int qlen,
                          const uint8_t* const qseq0[2], uint64_t axv,
                          uint64_t ayv) {
  int q_span = (int)(ayv >> 32 & 0xff);
  int32_t rid = (int32_t)(axv << 1 >> 33);
  int64_t re = i32of(axv) + 1, rs = re - q_span;
  int64_t qe = i32of(ayv) + 1, qs = qe - q_span;
  int ext = opt.anchor_ext_len;
  rs = std::max<int64_t>(rs - ext, 0);
  qs = std::max<int64_t>(qs - ext, 0);
  re = std::min<int64_t>(re + ext, mi.seq_len[rid]);
  qe = std::min<int64_t>(qe + ext, qlen);
  const uint8_t* tseq = mi.codes + mi.seq_off[rid] + rs;
  const uint8_t* qseq = qseq0[(int)(axv >> 63)] + qs;
  int qe_o, te_o;
  return wm_sw_i16((int)(qe - qs), qseq, (int)(re - rs), tseq, 5, mat, opt.q,
                   opt.e, &qe_o, &te_o);
}

// trim weak boundary exon seeds (align.py fix_bad_ends_splice; reference
// mm_fix_bad_ends_splice, align.c:545-563)
static void fix_bad_ends_splice(const EngOpts& opt, const EngIndex& mi,
                                const Reg& r, const int8_t* mat, int qlen,
                                const uint8_t* const qseq0[2],
                                const uint64_t* ax, const uint64_t* ay,
                                int64_t* as_out, int64_t* cnt_out) {
  int64_t as1 = r.as_, cnt1 = r.cnt;
  if (r.cnt >= 3) {
    double log_gap =
        std::log((double)(i32of(ax[r.as_ + 1]) - i32of(ax[r.as_])));
    if ((int)(ay[r.as_] >> 32 & 0xff) < log_gap + opt.anchor_ext_shift) {
      int sc = seed_ext_score(opt, mi, mat, qlen, qseq0, ax[r.as_],
                              ay[r.as_]);
      if ((double)sc / mat[0] < log_gap + opt.anchor_ext_shift) {
        ++as1;
        --cnt1;
      }
    }
    log_gap = std::log((double)(i32of(ax[r.as_ + r.cnt - 1]) -
                                i32of(ax[r.as_ + r.cnt - 2])));
    if ((int)(ay[r.as_ + r.cnt - 1] >> 32 & 0xff) <
        log_gap + opt.anchor_ext_shift) {
      int sc = seed_ext_score(opt, mi, mat, qlen, qseq0,
                              ax[r.as_ + r.cnt - 1], ay[r.as_ + r.cnt - 1]);
      if ((double)sc / mat[0] < log_gap + opt.anchor_ext_shift) --cnt1;
    }
  }
  *as_out = as1;
  *cnt_out = cnt1;
}

static void max_stretch(const Reg& r, const uint64_t* ax, const uint64_t* ay,
                        int64_t* as_out, int64_t* cnt_out) {
  int64_t as_ = r.as_, cnt = r.cnt;
  if (r.cnt < 2) {
    *as_out = as_;
    *cnt_out = cnt;
    return;
  }
  int64_t max_score = -1, max_i = -1, max_len = 0;
  int64_t score = (int64_t)(ay[r.as_] >> 32 & 0xff), length = 1;
  int64_t i = r.as_ + 1;
  for (; i < r.as_ + r.cnt; ++i) {
    int64_t q_span = (int64_t)(ay[i] >> 32 & 0xff);
    int64_t lr = (int64_t)i32of(ax[i]) - i32of(ax[i - 1]);
    int64_t lq = (int64_t)i32of(ay[i]) - i32of(ay[i - 1]);
    if (lq == lr) {
      score += lq < q_span ? lq : q_span;
      length += 1;
    } else {
      if (score > max_score) {
        max_score = score;
        max_len = length;
        max_i = i - length;
      }
      score = q_span;
      length = 1;
    }
  }
  if (score > max_score) {
    max_score = score;
    max_len = length;
    max_i = i - length;
  }
  *as_out = max_i;
  *cnt_out = max_len;
}

// anchor end -> base coordinate (align.py adjust_minier; HPC-aware)
static void adjust_minier(const EngIndex& mi, const uint8_t* const qseq0[2],
                          uint64_t axv, uint64_t ayv, int64_t* r_out,
                          int64_t* q_out) {
  if (mi.idx_flag & 1) {  // HPC
    int rev = (int)(axv >> 63);
    const uint8_t* qseq = qseq0[rev];
    int64_t q = i32of(ayv);
    uint8_t c = qseq[q];
    int64_t i = q - 1;
    while (i > 0 && qseq[i] == c) --i;
    q = i + 1;
    int32_t rid = (int32_t)(axv << 1 >> 33);
    int64_t x = i32of(axv);
    int64_t off0 = mi.seq_off[rid];
    int64_t off = off0 + x;
    c = mi.codes[off];
    i = off - 1;
    while (i >= off0 && mi.codes[i] == c) --i;
    *r_out = x + 1 - (off - i);
    *q_out = q;
    return;
  }
  *r_out = i32of(axv) - (mi.k >> 1);
  *q_out = i32of(ayv) - (mi.k >> 1);
}

}  // namespace weng

namespace weng {

struct ExtJob {
  int64_t qoff;  // offset into qpool (start of the forward-order window)
  int32_t qlen, qrev;
  int64_t toff;  // offset into ref codes
  int32_t tlen, trev;
  int32_t w, zdrop, end_bonus, ezflag, prof;
};

// ---- engine --------------------------------------------------------------
struct Waiter {
  std::condition_variable cv;
  int remaining = 0;
  std::vector<wm_ext_result> res;
};

struct PendingJob {
  ExtJob j;
  Waiter* w;
  int slot;
};

struct ReadState {
  const uint8_t* seq = nullptr;  // ASCII bases
  int qlen = 0;
  const uint8_t* q0[2] = {nullptr, nullptr};  // fwd / revcomp code strands
  uint32_t name_x31 = 0;
  bool sv = false;
  // MCAS stage-1 shared state (reference map.c:305-312)
  int n_starts = 0;
  std::vector<std::vector<uint64_t>> coll_ax, coll_ay;
  std::vector<uint8_t> seq_mapped;
  std::mutex accept_mu;
  // final result
  std::vector<Reg> regs;
  int64_t rep_len = 0;
  int32_t frag_gap = 0;
  bool rep_len_defined = true;
  // flattened output (built lazily by wm_eng_result)
  std::vector<RegOut> out_regs;
  std::vector<uint32_t> out_cigars;
};

class Engine;

struct Task {
  enum Kind { TRIAL, VANILLA, STAGE2 } kind;
  int read;
  int suffix_id;
};

class Engine {
 public:
  EngIndex mi;
  EngOpts opts[3];  // 0 = vanilla, 1 = stage1 (MCAS trials), 2 = stage2
  int8_t mats[3][25];
  const uint8_t* qpool = nullptr;
  int64_t next_id = 0;
  std::vector<std::unique_ptr<ReadState>> reads;

  // perf accounting (ns + calls), summed over all engine threads and read
  // out by wm_eng_perf for the Python STATS breakdown
  std::atomic<int64_t> n_host_dp{0};
  std::atomic<int64_t> ns_chain{0}, n_chain_calls{0};

  std::mutex mu;
  std::condition_variable cv_settled;
  int n_live = 0, n_blocked = 0;

  // thread time of the phases, guarded by mu: each phase adds its threads
  // x (launch to the last thread's exit) to ns_thread, the time its
  // threads waited on an exported job or chain to ns_blocked, and the time
  // between each thread's exit and the last one's to ns_finished.  Stamps
  // are taken only at a launch, a block, a wake and an exit.
  using Clock = std::chrono::steady_clock;
  Clock::time_point phase_t0;
  int phase_threads = 0;
  int64_t phase_exit_ns = 0;  // sum over exited threads of exit - phase_t0
  int64_t ns_thread = 0, ns_blocked = 0, ns_finished = 0;

  int64_t since(Clock::time_point t) const {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() -
                                                                t)
        .count();
  }

  // caller holds mu; the calling thread leaves the phase
  void thread_exit() {
    const int64_t t = since(phase_t0);
    phase_exit_ns += t;
    --n_live;
    if (n_live == 0) {
      ns_thread += (int64_t)phase_threads * t;
      ns_finished += (int64_t)phase_threads * t - phase_exit_ns;
    }
  }
  std::vector<PendingJob> queue;
  std::vector<PendingJob> outstanding;     // slot = id - outstanding_base
  std::vector<uint8_t> outstanding_done;
  int64_t outstanding_base = 0;
  std::vector<int64_t> export_buf;

  // ---- chain exchange: anchor sets routed to the device forward DP
  // (chain/device.py) through the same blocking-thread pattern as the
  // extension-job exchange.  Off (chain_dev_min == 0) unless the Python
  // device driver enables it -- threads then block in chain_submit and the
  // driver batches exported jobs onto the chain kernel.
  struct ChainWaiter {
    std::condition_variable cv;
    bool done = false;
    std::vector<uint64_t> u, ax, ay;
  };
  struct PendingChain {
    int64_t id, n;
    const uint64_t* ax;
    const uint64_t* ay;
    int32_t max_dist_x, min_dist_x, max_dist_y, bw, max_skip, max_iter,
        min_cnt, min_sc, is_cdna;
    double gap_scale;
    ChainWaiter* w;
  };
  int64_t chain_dev_min = 0;
  int64_t next_chain_id = 0;
  std::vector<PendingChain> chain_queue;
  std::deque<PendingChain> chain_outstanding;
  std::vector<int64_t> chain_export_buf;

  bool chain_submit(PendingChain pc, std::vector<uint64_t>& u_out,
                    std::vector<uint64_t>& ax_out,
                    std::vector<uint64_t>& ay_out) {
    ChainWaiter w;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (aborting) return false;
      pc.id = next_chain_id++;
      pc.w = &w;
      chain_queue.push_back(pc);
      ++n_blocked;
      if (n_blocked == n_live) cv_settled.notify_all();
      const Clock::time_point tb = Clock::now();
      w.cv.wait(lk, [&] { return w.done; });
      ns_blocked += since(tb);
      --n_blocked;
      if (aborting) return false;
    }
    u_out.swap(w.u);
    ax_out.swap(w.ax);
    ay_out.swap(w.ay);
    return true;
  }

  int64_t step_chains(const int64_t** out_rows) {
    std::unique_lock<std::mutex> lk(mu);
    cv_settled.wait(lk, [&] { return n_blocked == n_live; });
    chain_export_buf.clear();
    for (auto& pc : chain_queue) {
      int64_t gs_bits;
      std::memcpy(&gs_bits, &pc.gap_scale, 8);
      int64_t row[16] = {pc.id,        pc.n,
                         (int64_t)pc.ax, (int64_t)pc.ay,
                         pc.max_dist_x, pc.min_dist_x,
                         pc.max_dist_y, pc.bw,
                         pc.max_skip,   pc.max_iter,
                         pc.min_cnt,    pc.min_sc,
                         pc.is_cdna,    gs_bits,
                         0,             0};
      chain_export_buf.insert(chain_export_buf.end(), row, row + 16);
      chain_outstanding.push_back(pc);
    }
    chain_queue.clear();
    *out_rows = chain_export_buf.data();
    return (int64_t)chain_export_buf.size() / 16;
  }

  void deliver_chain(int64_t id, int64_t n_u, const uint64_t* u, int64_t n_v,
                     const uint64_t* axp, const uint64_t* ayp) {
    std::lock_guard<std::mutex> lk(mu);
    for (auto it = chain_outstanding.begin(); it != chain_outstanding.end();
         ++it) {
      if (it->id != id) continue;
      it->w->u.assign(u, u + n_u);
      it->w->ax.assign(axp, axp + n_v);
      it->w->ay.assign(ayp, ayp + n_v);
      it->w->done = true;
      it->w->cv.notify_one();
      chain_outstanding.erase(it);
      return;
    }
  }

  std::deque<Task> tasks;
  int max_threads = 0;
  std::vector<pthread_t> threads;
  bool aborting = false;

  ~Engine() {
    // Unblock every waiting thread with zeroed results so join cannot hang
    // if the Python driver tears the engine down mid-batch.
    {
      std::lock_guard<std::mutex> lk(mu);
      aborting = true;
      wm_ext_result zed;
      std::memset(&zed, 0, sizeof(zed));
      for (auto& pc : chain_queue) {
        pc.w->done = true;
        pc.w->cv.notify_one();
      }
      chain_queue.clear();
      for (auto& pc : chain_outstanding) {
        pc.w->done = true;
        pc.w->cv.notify_one();
      }
      chain_outstanding.clear();
      for (auto& pj : queue) {
        pj.w->res[pj.slot] = zed;
        if (--pj.w->remaining == 0) pj.w->cv.notify_one();
      }
      queue.clear();
      for (size_t i = 0; i < outstanding.size(); ++i) {
        if (outstanding_done[i]) continue;
        outstanding_done[i] = 1;
        PendingJob& pj = outstanding[i];
        pj.w->res[pj.slot] = zed;
        if (--pj.w->remaining == 0) pj.w->cv.notify_one();
      }
    }
    join_threads();
  }

  void join_threads() {
    for (pthread_t t : threads) pthread_join(t, nullptr);
    threads.clear();
  }

  bool device_eligible(const ExtJob& j) const {
    if (j.qlen == 0 || j.tlen == 0) return false;
    const EngOpts& o = opts[j.prof];
    // the oracle's own refusal guards decide results, not placement: jobs
    // that wm_exts refuses, and --cap-sw-mem's dummy drop, stay on the host
    if (o.flag & MM_F_SPLICE) {
      if (o.q2 <= o.q + o.e) return false;
      if (std::max(std::abs(o.b), std::abs(o.sc_ambi)) > 2 * (o.q + o.e))
        return false;
    }
    if (o.max_sw_mat > 0 && (int64_t)j.qlen * j.tlen > o.max_sw_mat)
      return false;
    return true;
  }

  void run_host(const ExtJob& j, wm_ext_result* ez) {
    run_host_inner(j, ez);
    n_host_dp.fetch_add(1, std::memory_order_relaxed);
  }

  void run_host_inner(const ExtJob& j, wm_ext_result* ez) {
    const EngOpts& o = opts[j.prof];
    // dummy-drop guard (align.py align_pair; reference --cap-sw-mem)
    if (o.max_sw_mat > 0 && (int64_t)j.qlen * j.tlen > o.max_sw_mat) {
      std::memset(ez, 0, sizeof(*ez));
      ez->zdropped = 1;
      ez->max_q = ez->max_t = ez->mqe_t = ez->mte_q = -1;
      ez->mqe = ez->mte = ez->score = WM_NEG_INF;
      return;
    }
    // materialize operands (JobSeq semantics: reversed view when rev)
    std::vector<uint8_t> qbuf, tbuf;
    const uint8_t* qp = qpool + j.qoff;
    const uint8_t* tp = mi.codes + j.toff;
    if (j.qrev) {
      qbuf.assign(std::make_reverse_iterator(qp + j.qlen),
                  std::make_reverse_iterator(qp));
      qp = qbuf.data();
    }
    if (j.trev) {
      tbuf.assign(std::make_reverse_iterator(tp + j.tlen),
                  std::make_reverse_iterator(tp));
      tp = tbuf.data();
    }
    if (o.flag & MM_F_SPLICE)
      wm_exts_fast(j.qlen, qp, j.tlen, tp, 5, mats[j.prof], (int8_t)o.q,
                   (int8_t)o.e, (int8_t)o.q2, (int8_t)o.noncan, j.zdrop,
                   (int8_t)o.junc_bonus, j.ezflag, nullptr, ez);
    else if (o.q == o.q2 && o.e == o.e2)
      wm_extz_fast(j.qlen, qp, j.tlen, tp, 5, mats[j.prof], (int8_t)o.q,
                   (int8_t)o.e, j.w, j.zdrop, j.end_bonus, j.ezflag, ez);
    else
      wm_extd_fast(j.qlen, qp, j.tlen, tp, 5, mats[j.prof], (int8_t)o.q,
                   (int8_t)o.e, (int8_t)o.q2, (int8_t)o.e2, j.w, j.zdrop,
                   j.end_bonus, j.ezflag, ez);
  }

  // submit a group of jobs; returns when every result is available.
  void submit(std::vector<ExtJob>& jobs, std::vector<wm_ext_result>& out) {
    out.assign(jobs.size(), wm_ext_result());
    std::vector<int> dev;
    for (int i = 0; i < (int)jobs.size(); ++i) {
      if (device_eligible(jobs[i]))
        dev.push_back(i);
      else
        run_host(jobs[i], &out[i]);
    }
    if (dev.empty()) return;
    Waiter w;
    w.remaining = (int)dev.size();
    w.res.resize(jobs.size());
    {
      std::unique_lock<std::mutex> lk(mu);
      if (aborting) {
        for (int slot : dev)
          std::memset(&out[slot], 0, sizeof(wm_ext_result));
        return;
      }
      for (int slot : dev) queue.push_back({jobs[slot], &w, slot});
      ++n_blocked;
      if (n_blocked == n_live) cv_settled.notify_all();
      const Clock::time_point tb = Clock::now();
      w.cv.wait(lk, [&] { return w.remaining == 0; });
      ns_blocked += since(tb);
      --n_blocked;
    }
    for (int slot : dev) out[slot] = w.res[slot];
  }

  // ---- thread pool -------------------------------------------------------
  static void* thread_entry(void* arg);

  void spawn(int n_threads) {
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 1 << 20);
    for (int i = 0; i < n_threads; ++i) {
      pthread_t t;
      if (pthread_create(&t, &attr, thread_entry, this) == 0)
        threads.push_back(t);
    }
    pthread_attr_destroy(&attr);
  }

  void run_tasks();  // thread body: pull tasks until empty

  void launch_phase(std::deque<Task>&& ts) {
    join_threads();
    tasks = std::move(ts);
    int n = std::min<int>((int)tasks.size(), max_threads);
    {
      std::lock_guard<std::mutex> lk(mu);
      n_live = n;
      phase_t0 = Clock::now();
      phase_threads = n;
      phase_exit_ns = 0;
    }
    spawn(n);
  }

  int64_t step(const int64_t** out_rows) {
    std::unique_lock<std::mutex> lk(mu);
    cv_settled.wait(lk, [&] { return n_blocked == n_live; });
    export_buf.clear();
    if (outstanding_base + (int64_t)outstanding.size() == next_id &&
        std::all_of(outstanding_done.begin(), outstanding_done.end(),
                    [](uint8_t d) { return d != 0; })) {
      outstanding.clear();
      outstanding_done.clear();
      outstanding_base = next_id;
    }
    for (auto& pj : queue) {
      int64_t id = next_id++;
      outstanding.push_back(pj);
      outstanding_done.push_back(0);
      const ExtJob& j = pj.j;
      int64_t row[JOB_I64] = {id,     j.qoff, j.qlen,      j.qrev,
                              j.toff, j.tlen, j.trev,      j.w,
                              j.zdrop, j.end_bonus, j.ezflag, j.prof};
      export_buf.insert(export_buf.end(), row, row + JOB_I64);
    }
    queue.clear();
    *out_rows = export_buf.data();
    return (int64_t)export_buf.size() / JOB_I64;
  }

  void finish_job(int64_t id, const wm_ext_result& ez) {
    // caller holds mu
    PendingJob& pj = outstanding[id - outstanding_base];
    outstanding_done[id - outstanding_base] = 1;
    pj.w->res[pj.slot] = ez;
    if (--pj.w->remaining == 0) pj.w->cv.notify_one();
  }

  void deliver(int64_t n, const int64_t* ids, const int32_t* res10,
               const uint32_t* cig_blob, const int64_t* cig_off,
               const int32_t* cig_len) {
    std::lock_guard<std::mutex> lk(mu);
    for (int64_t i = 0; i < n; ++i) {
      wm_ext_result ez;
      const int32_t* r = res10 + i * 10;
      ez.max = r[0];
      ez.zdropped = r[1];
      ez.max_q = r[2];
      ez.max_t = r[3];
      ez.mqe = r[4];
      ez.mqe_t = r[5];
      ez.mte = r[6];
      ez.mte_q = r[7];
      ez.score = r[8];
      ez.reach_end = r[9];
      ez.n_cigar = cig_len[i];
      if (ez.n_cigar > 0) {
        ez.cigar = (uint32_t*)wm_malloc((size_t)ez.n_cigar * 4);
        std::memcpy(ez.cigar, cig_blob + cig_off[i], (size_t)ez.n_cigar * 4);
      } else {
        ez.cigar = nullptr;
      }
      finish_job(ids[i], ez);
    }
  }

  void run_host_ids(int64_t n, const int64_t* ids) {
    std::vector<std::pair<int64_t, ExtJob>> todo;
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int64_t i = 0; i < n; ++i)
        todo.push_back({ids[i], outstanding[ids[i] - outstanding_base].j});
    }
    std::vector<wm_ext_result> ress(todo.size());
    for (size_t i = 0; i < todo.size(); ++i) run_host(todo[i].second, &ress[i]);
    std::lock_guard<std::mutex> lk(mu);
    for (size_t i = 0; i < todo.size(); ++i) finish_job(todo[i].first, ress[i]);
  }
};

static void free_ez(wm_ext_result& ez) {
  if (ez.cigar) {
    wm_free(ez.cigar);
    ez.cigar = nullptr;
  }
}

// ---- per-read mapping (ports of map/{align,frag}.py) ---------------------
struct Ctx {
  Engine* eng;
  int prof;        // which opts/mat
  ReadState* rd;
  const EngOpts* opt() const { return &eng->opts[prof]; }
  const int8_t* mat() const { return eng->mats[prof]; }
};

static void chain_gaps(const EngOpts& o, bool is_sr, int qlen_sum,
                       int* max_gap_qry, int* max_gap_ref, int* min_gap_ref) {
  *max_gap_qry = is_sr ? std::max(qlen_sum, o.max_gap) : o.max_gap;
  if (o.max_gap_ref > 0)
    *max_gap_ref = o.max_gap_ref;
  else if (o.max_frag_len > 0)
    *max_gap_ref = std::max(o.max_frag_len - qlen_sum, o.max_gap);
  else
    *max_gap_ref = o.max_gap;
  *min_gap_ref = std::min(o.min_gap_ref, *max_gap_ref);
}

// align one chain (align.py align1_gen; reference mm_align1, align.c:565-795).
// q0 = {fwd strand codes, revcomp strand codes} of the (sub)query, resident
// in the engine's read pool.  Returns true when a split region was produced.
static bool align1(Ctx& c, int qlen, const uint8_t* const q0[2], Reg& r,
                   Reg& r2, int64_t n_a, uint64_t* ax, uint64_t* ay,
                   int64_t splice_flag, bool* dropped_out) {
  const EngOpts& opt = *c.opt();
  const EngIndex& mi = c.eng->mi;
  bool is_sr = (opt.flag & MM_F_SR) != 0;
  bool is_splice = (opt.flag & MM_F_SPLICE) != 0;
  int32_t rid = (int32_t)(ax[r.as_] << 1 >> 33);
  int rev = (int)(ax[r.as_] >> 63);
  *dropped_out = false;
  if (r.cnt == 0) return false;
  const int8_t* mat = c.mat();
  int bw = (int)((double)opt.bw * 1.5 + 1.0);

  int64_t as1, cnt1, rs, qs, re, qe;
  if (is_sr) {
    max_stretch(r, ax, ay, &as1, &cnt1);
    int span0 = (int)(ay[as1] >> 32 & 0xff);
    rs = i32of(ax[as1]) + 1 - span0;
    qs = i32of(ay[as1]) + 1 - span0;
    re = i32of(ax[as1 + cnt1 - 1]) + 1;
    qe = i32of(ay[as1 + cnt1 - 1]) + 1;
  } else {
    if (!(opt.flag & MM_F_NO_END_FLT)) {
      if (is_splice)
        fix_bad_ends_splice(opt, mi, r, mat, qlen, q0, ax, ay, &as1, &cnt1);
      else
        fix_bad_ends(r, ax, ay, opt.bw, opt.min_chain_score * 2, &as1, &cnt1);
    } else {
      as1 = r.as_;
      cnt1 = r.cnt;
    }
    filter_bad_seeds(as1, cnt1, ax, ay, 10, 40, opt.max_gap >> 1, 10);
    filter_bad_seeds_alt(as1, cnt1, ax, ay, 30, opt.max_gap >> 1);
    adjust_minier(mi, q0, ax[as1], ay[as1], &rs, &qs);
    adjust_minier(mi, q0, ax[as1 + cnt1 - 1], ay[as1 + cnt1 - 1], &re, &qe);
  }
  assert(cnt1 > 0);
  int extra_flag = 0;
  if (is_splice) {  // (align.py align1_gen; reference align.c:602-605)
    if (splice_flag & MM_F_SPLICE_FOR)
      extra_flag |= rev ? WM_EZ_SPLICE_REV : WM_EZ_SPLICE_FOR;
    if (splice_flag & MM_F_SPLICE_REV)
      extra_flag |= rev ? WM_EZ_SPLICE_FOR : WM_EZ_SPLICE_REV;
    if (opt.flag & MM_F_SPLICE_FLANK) extra_flag |= WM_EZ_SPLICE_FLANK;
  }

  // DP region bounds (reference align.c:608-684)
  int64_t tlen_rid = mi.seq_len[rid];
  int64_t rs0, qs0, re0, qe0;
  if (is_sr) {
    qs0 = 0;
    qe0 = qlen;
    int64_t l = qs;
    l += (l * opt.a + opt.end_bonus > opt.q)
             ? (l * opt.a + opt.end_bonus - opt.q) / opt.e
             : 0;
    rs0 = rs - l > 0 ? rs - l : 0;
    l = qlen - qe;
    l += (l * opt.a + opt.end_bonus > opt.q)
             ? (l * opt.a + opt.end_bonus - opt.q) / opt.e
             : 0;
    re0 = re + l < tlen_rid ? re + l : tlen_rid;
  } else {
    int span_as = (int)(ay[r.as_] >> 32 & 0xff);
    rs0 = i32of(ax[r.as_]) + 1 - span_as;
    qs0 = i32of(ay[r.as_]) + 1 - span_as;
    if (rs0 < 0) rs0 = 0;
    assert(qs0 >= 0);
    int64_t rs1b = 0, qs1b = 0;
    {
      int64_t i = r.as_ - 1, l = 0;
      while (i >= 0 && (ax[i] >> 32) == (ax[r.as_] >> 32)) {
        int span = (int)(ay[i] >> 32 & 0xff);
        int64_t x = i32of(ax[i]) + 1 - span;
        int64_t y = i32of(ay[i]) + 1 - span;
        if (x < rs0 && y < qs0) {
          if (++l > opt.min_cnt) {
            int64_t ll = std::max(rs0 - x, qs0 - y);
            rs1b = rs0 - ll;
            qs1b = qs0 - ll;
            if (rs1b < 0) rs1b = 0;
            break;
          }
        }
        --i;
      }
    }
    if (qs > 0 && rs > 0) {
      int64_t l = std::min<int64_t>(qs, opt.max_gap);
      qs1b = std::max(qs1b, qs - l);
      qs0 = std::min(qs0, qs1b);
      l += (l * opt.a > opt.q) ? (l * opt.a - opt.q) / opt.e : 0;
      l = std::min<int64_t>(l, opt.max_gap);
      l = std::min(l, rs);
      rs1b = std::max(rs1b, rs - l);
      rs0 = std::min(rs0, rs1b);
      rs0 = std::min(rs0, rs);
    } else {
      rs0 = rs;
      qs0 = qs;
    }
    re0 = i32of(ax[r.as_ + r.cnt - 1]) + 1;
    qe0 = i32of(ay[r.as_ + r.cnt - 1]) + 1;
    int64_t re1b = tlen_rid, qe1b = qlen;
    {
      int64_t i = r.as_ + r.cnt, l = 0;
      while (i < n_a && (ax[i] >> 32) == (ax[r.as_] >> 32)) {
        int64_t x = i32of(ax[i]) + 1;
        int64_t y = i32of(ay[i]) + 1;
        if (x > re0 && y > qe0) {
          if (++l > opt.min_cnt) {
            int64_t ll = std::max(x - re0, y - qe0);
            re1b = re0 + ll;
            qe1b = qe0 + ll;
            break;
          }
        }
        ++i;
      }
    }
    if (qe < qlen && re < tlen_rid) {
      int64_t l = std::min<int64_t>(qlen - qe, opt.max_gap);
      qe1b = std::min(qe1b, qe + l);
      qe0 = std::max(qe0, qe1b);
      l += (l * opt.a > opt.q) ? (l * opt.a - opt.q) / opt.e : 0;
      l = std::min<int64_t>(l, opt.max_gap);
      l = std::min(l, tlen_rid - re);
      re1b = std::min(re1b, re + l);
      re0 = std::max(re0, re1b);
    } else {
      re0 = re;
      qe0 = qe;
    }
  }
  if (ay[r.as_] & MM_SEED_SELF) {
    int64_t max_ext = std::abs((int64_t)r.qs - r.rs);
    if (r.rs - rs0 > max_ext) rs0 = r.rs - max_ext;
    if (r.qs - qs0 > max_ext) qs0 = r.qs - max_ext;
    max_ext = std::abs((int64_t)r.qe - r.re);
    if (re0 - r.re > max_ext) re0 = r.re + max_ext;
    if (qe0 - r.qe > max_ext) qe0 = r.qe + max_ext;
  }
  assert(re0 > rs0);
  bool dropped = false;
  bool have_r2 = false;
  const uint8_t* qdir = q0[rev];
  int64_t qdir_off = qdir - c.eng->qpool;
  int64_t rid_off = mi.seq_off[rid];

  int64_t rs1, qs1, re1, qe1;
  if (qs > 0 && rs > 0) {  // left extension
    std::vector<ExtJob> g(1);
    ExtJob& j = g[0];
    j.qoff = qdir_off + qs0;
    j.qlen = (int32_t)(qs - qs0);
    j.qrev = 1;
    j.toff = rid_off + rs0;
    j.tlen = (int32_t)(rs - rs0);
    j.trev = 1;
    j.w = bw;
    j.zdrop = r.split_inv ? opt.zdrop_inv : opt.zdrop;
    j.end_bonus = opt.end_bonus;
    j.ezflag = extra_flag | WM_EZ_EXTZ_ONLY | WM_EZ_RIGHT | WM_EZ_REV_CIGAR;
    j.prof = c.prof;
    std::vector<wm_ext_result> ezs;
    c.eng->submit(g, ezs);
    wm_ext_result& ez = ezs[0];
    if (ez.n_cigar > 0) {
      append_cigar(r, ez.cigar, ez.n_cigar);
      r.p->dp_score += ez.max;
    }
    rs1 = rs - (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
    qs1 = qs - (ez.reach_end ? qs - qs0 : ez.max_q + 1);
    free_ez(ez);
  } else {
    rs1 = rs;
    qs1 = qs;
  }
  re1 = rs;
  qe1 = qs;
  assert(qs1 >= 0 && rs1 >= 0);

  // gap filling: segment bounds depend only on the anchors, so all fill
  // segments are submitted as ONE speculative job group, then consumed
  // sequentially with the exact two-pass z-drop / split semantics
  // (align.py align1_gen; reference align.c:665-770)
  struct Seg {
    int64_t i, qs, qe, rs, re;
    int bw1;
  };
  std::vector<Seg> segs;
  int64_t re_e = -1, qe_e = -1;
  {
    int64_t rs_e = rs, qs_e = qs;
    int64_t i = is_sr ? cnt1 - 1 : 1;
    for (; i < cnt1; ++i) {
      if ((ay[as1 + i] & (MM_SEED_IGNORE | MM_SEED_TANDEM)) && i != cnt1 - 1)
        continue;
      if (is_sr && !(mi.idx_flag & 1)) {
        re_e = i32of(ax[as1 + i]) + 1;
        qe_e = i32of(ay[as1 + i]) + 1;
      } else {
        adjust_minier(mi, q0, ax[as1 + i], ay[as1 + i], &re_e, &qe_e);
      }
      if (i == cnt1 - 1 || (ay[as1 + i] & MM_SEED_LONG_JOIN) ||
          (qe_e - qs_e >= opt.min_ksw_len && re_e - rs_e >= opt.min_ksw_len)) {
        int bw1 = bw;
        if (ay[as1 + i] & MM_SEED_LONG_JOIN)
          bw1 = (int)std::max(qe_e - qs_e, re_e - rs_e);
        segs.push_back({i, qs_e, qe_e, rs_e, re_e, bw1});
        rs_e = re_e;
        qs_e = qe_e;
      }
    }
  }

  std::vector<wm_ext_result> ezs;
  if (!segs.empty() && !is_sr) {
    std::vector<ExtJob> g(segs.size());
    for (size_t si = 0; si < segs.size(); ++si) {
      ExtJob& j = g[si];
      j.qoff = qdir_off + segs[si].qs;
      j.qlen = (int32_t)(segs[si].qe - segs[si].qs);
      j.qrev = 0;
      j.toff = rid_off + segs[si].rs;
      j.tlen = (int32_t)(segs[si].re - segs[si].rs);
      j.trev = 0;
      j.w = segs[si].bw1;
      j.zdrop = opt.zdrop;
      j.end_bonus = -1;
      j.ezflag = extra_flag | WM_EZ_APPROX_MAX;
      j.prof = c.prof;
    }
    c.eng->submit(g, ezs);
  }

  for (size_t si = 0; si < segs.size(); ++si) {
    const Seg& sg = segs[si];
    int64_t s_qs = sg.qs, s_qe = sg.qe, s_rs = sg.rs, s_re = sg.re;
    const uint8_t* qseq = qdir + s_qs;
    const uint8_t* tseq = mi.codes + rid_off + s_rs;
    wm_ext_result ez;
    int zdrop_code = 0;
    if (is_sr) {  // ungapped fill (align.py is_sr branch)
      assert(s_qe - s_qs == s_re - s_rs);
      int64_t score = 0;
      for (int64_t jj = 0; jj < s_qe - s_qs; ++jj) {
        if (qseq[jj] >= 4 || tseq[jj] >= 4)
          score += opt.e2;
        else
          score += qseq[jj] == tseq[jj] ? opt.a : -opt.b;
      }
      std::memset(&ez, 0, sizeof(ez));
      ez.score = (int32_t)score;
      ez.n_cigar = 1;
      ez.cigar = (uint32_t*)wm_malloc(4);
      ez.cigar[0] = (uint32_t)((s_qe - s_qs) << 4);
      ez.max_q = ez.max_t = -1;
    } else {
      ez = ezs[si];
      ezs[si].cigar = nullptr;  // ownership moved to ez
      zdrop_code = wm_test_zdrop(
          qseq, tseq, ez.cigar, ez.n_cigar, mat, opt.q, opt.e, opt.zdrop,
          opt.zdrop_inv, opt.max_gap, opt.min_chain_score * opt.a,
          opt.min_dp_max,
          !(opt.flag &
            (MM_F_SPLICE | MM_F_SR | MM_F_FOR_ONLY | MM_F_REV_ONLY)));
      if (zdrop_code != 0) {
        free_ez(ez);
        std::vector<ExtJob> g(1);
        ExtJob& j = g[0];
        j.qoff = qdir_off + s_qs;
        j.qlen = (int32_t)(s_qe - s_qs);
        j.qrev = 0;
        j.toff = rid_off + s_rs;
        j.tlen = (int32_t)(s_re - s_rs);
        j.trev = 0;
        j.w = sg.bw1;
        j.zdrop = zdrop_code == 2 ? opt.zdrop_inv : opt.zdrop;
        j.end_bonus = -1;
        j.ezflag = extra_flag;
        j.prof = c.prof;
        std::vector<wm_ext_result> ez2;
        c.eng->submit(g, ez2);
        ez = ez2[0];
      }
    }
    if (ez.n_cigar > 0) append_cigar(r, ez.cigar, ez.n_cigar);
    if (ez.zdropped) {
      if (!r.p) r.p = std::make_shared<Extra>();
      int64_t jj = sg.i - 1;
      while (jj >= 0) {
        if (i32of(ax[as1 + jj]) <= s_rs + ez.max_t) break;
        --jj;
      }
      dropped = true;
      if (jj < 0) jj = 0;
      r.p->dp_score += ez.max;
      re1 = s_rs + (ez.max_t + 1);
      qe1 = s_qs + (ez.max_q + 1);
      if (cnt1 - (jj + 1) >= opt.min_cnt) {
        if (split_reg(r, r2, (int)(as1 + jj + 1 - r.as_), qlen, ax, ay)) {
          have_r2 = true;
          if (zdrop_code == 2) r2.split_inv = true;
        }
      }
      free_ez(ez);
      break;
    } else {
      if (!r.p) r.p = std::make_shared<Extra>();
      r.p->dp_score += ez.score;
    }
    free_ez(ez);
  }
  for (auto& e2 : ezs) free_ez(e2);
  if (!dropped) {
    if (!segs.empty()) {
      rs = segs.back().re;
      qs = segs.back().qe;
    }
    if (re_e >= 0) {
      re = re_e;
      qe = qe_e;
      re1 = re_e;
      qe1 = qe_e;
    }
  }

  if (!dropped && qe < qe0 && re < re0) {  // right extension
    std::vector<ExtJob> g(1);
    ExtJob& j = g[0];
    j.qoff = qdir_off + qe;
    j.qlen = (int32_t)(qe0 - qe);
    j.qrev = 0;
    j.toff = rid_off + re;
    j.tlen = (int32_t)(re0 - re);
    j.trev = 0;
    j.w = bw;
    j.zdrop = opt.zdrop;
    j.end_bonus = opt.end_bonus;
    j.ezflag = extra_flag | WM_EZ_EXTZ_ONLY;
    j.prof = c.prof;
    std::vector<wm_ext_result> ez1;
    c.eng->submit(g, ez1);
    wm_ext_result& ez = ez1[0];
    if (ez.n_cigar > 0) {
      append_cigar(r, ez.cigar, ez.n_cigar);
      r.p->dp_score += ez.max;
    }
    re1 = re + (ez.reach_end ? ez.mqe_t + 1 : ez.max_t + 1);
    qe1 = qe + (ez.reach_end ? qe0 - qe : ez.max_q + 1);
    free_ez(ez);
  }
  assert(qe1 <= qlen);

  r.rs = (int32_t)rs1;
  r.re = (int32_t)re1;
  if (rev) {
    r.qs = (int32_t)(qlen - qe1);
    r.qe = (int32_t)(qlen - qs1);
  } else {
    r.qs = (int32_t)qs1;
    r.qe = (int32_t)qe1;
  }
  assert(re1 - rs1 <= re0 - rs0);
  if (r.p) {
    wm_extra_io io;
    std::memset(&io, 0, sizeof(io));
    io.qs = r.qs;
    io.qe = r.qe;
    io.rs = r.rs;
    io.re = r.re;
    io.rev = r.rev ? 1 : 0;
    const uint8_t* qfin = q0[r.rev ? 1 : 0] + qs1;
    const uint8_t* tfin = mi.codes + rid_off + rs1;
    wm_update_extra(qfin, tfin, r.p->cigar.data(), (int32_t)r.p->cigar.size(),
                    mat, opt.q, opt.e, (opt.flag & MM_F_EQX) ? 1 : 0, &io);
    r.qs = io.qs;
    r.qe = io.qe;
    r.rs = io.rs;
    r.re = io.re;
    r.blen = io.blen;
    r.mlen = io.mlen;
    r.p->n_ambi += io.n_ambi;
    r.p->dp_max = io.dp_max;
    r.p->cigar.assign(io.cigar, io.cigar + io.n_cigar);
    if (io.cigar) wm_free(io.cigar);
    if (rev && r.p->trans_strand) r.p->trans_strand ^= 3;
  }
  *dropped_out = dropped;
  return have_r2;
}

// inversion rescue between two split regions (align.py align1_inv_gen;
// reference mm_align1_inv, align.c:797-852)
static bool align1_inv(Ctx& c, int qlen, const uint8_t* const q0[2],
                       const Reg& r1, const Reg& r2, Reg& r_inv) {
  const EngOpts& opt = *c.opt();
  const EngIndex& mi = c.eng->mi;
  if (!(r1.split & 1) || !(r2.split & 2)) return false;
  if (r1.id != r1.parent && r1.parent != PARENT_TMP_PRI) return false;
  if (r2.id != r2.parent && r2.parent != PARENT_TMP_PRI) return false;
  if (r1.rid != r2.rid || r1.rev != r2.rev) return false;
  int64_t ql = r1.rev ? (int64_t)r1.qs - r2.qe : (int64_t)r2.qs - r1.qe;
  int64_t tl = (int64_t)r2.rs - r1.re;
  if (ql < opt.min_chain_score || ql > opt.max_gap) return false;
  if (tl < opt.min_chain_score || tl > opt.max_gap) return false;
  const int8_t* mat = c.mat();
  int64_t rid_off = mi.seq_off[r1.rid];
  const uint8_t* tseq = mi.codes + rid_off + r1.re;
  // the query is a slice of a read strand in the read pool
  const uint8_t* qseq = r1.rev ? q0[0] + r2.qe : q0[1] + (qlen - r2.qs);
  std::vector<uint8_t> qr(ql), tr(tl);
  for (int64_t i = 0; i < ql; ++i) qr[i] = qseq[ql - 1 - i];
  for (int64_t i = 0; i < tl; ++i) tr[i] = tseq[tl - 1 - i];
  int q_off, t_off;
  int sc = wm_sw_i16((int)ql, qr.data(), (int)tl, tr.data(), 5, mat, opt.q,
                     opt.e, &q_off, &t_off);
  if (sc < opt.min_dp_max) return false;
  q_off = (int)(ql - (q_off + 1));
  t_off = (int)(tl - (t_off + 1));
  // an ordinary pool job, exported to the device path like every other
  std::vector<ExtJob> g(1);
  ExtJob& j = g[0];
  j.qoff = (qseq - c.eng->qpool) + q_off;
  j.qlen = (int32_t)(ql - q_off);
  j.toff = rid_off + r1.re + t_off;
  j.tlen = (int32_t)(tl - t_off);
  j.qrev = j.trev = 0;
  j.w = (int)((double)opt.bw * 1.5);
  j.zdrop = opt.zdrop;
  j.end_bonus = -1;
  j.ezflag = WM_EZ_EXTZ_ONLY;
  j.prof = c.prof;
  std::vector<wm_ext_result> ezs;
  c.eng->submit(g, ezs);
  wm_ext_result& ez = ezs[0];
  if (ez.n_cigar == 0) {
    free_ez(ez);
    return false;
  }
  r_inv = Reg();
  append_cigar(r_inv, ez.cigar, ez.n_cigar);
  r_inv.p->dp_score = ez.max;
  r_inv.id = -1;
  r_inv.parent = PARENT_UNSET;
  r_inv.inv = true;
  r_inv.rev = !r1.rev;
  r_inv.rid = r1.rid;
  r_inv.div = -1.0f;
  if (!r_inv.rev) {
    r_inv.qs = r2.qe + q_off;
    r_inv.qe = r_inv.qs + ez.max_q + 1;
  } else {
    r_inv.qe = r2.qs - q_off;
    r_inv.qs = r_inv.qe - (ez.max_q + 1);
  }
  r_inv.rs = r1.re + t_off;
  r_inv.re = r_inv.rs + ez.max_t + 1;
  {
    wm_extra_io io;
    std::memset(&io, 0, sizeof(io));
    io.qs = r_inv.qs;
    io.qe = r_inv.qe;
    io.rs = r_inv.rs;
    io.re = r_inv.re;
    io.rev = r_inv.rev ? 1 : 0;
    wm_update_extra(qseq + q_off, tseq + t_off, r_inv.p->cigar.data(),
                    (int32_t)r_inv.p->cigar.size(), mat, opt.q, opt.e,
                    (opt.flag & MM_F_EQX) ? 1 : 0, &io);
    r_inv.qs = io.qs;
    r_inv.qe = io.qe;
    r_inv.rs = io.rs;
    r_inv.re = io.re;
    r_inv.blen = io.blen;
    r_inv.mlen = io.mlen;
    r_inv.p->n_ambi += io.n_ambi;
    r_inv.p->dp_max = io.dp_max;
    r_inv.p->cigar.assign(io.cigar, io.cigar + io.n_cigar);
    if (io.cigar) wm_free(io.cigar);
  }
  free_ez(ez);
  return true;
}

// align all chains + post (align.py align_skeleton_gen + frag.py
// align_regs_gen; reference mm_align_skeleton, align.c:864-920)
static void align_regs(Ctx& c, int qlen, const uint8_t* const q0[2],
                       std::vector<Reg>& regs, std::vector<uint64_t>& ax,
                       std::vector<uint64_t>& ay) {
  const EngOpts& opt = *c.opt();
  if (!(opt.flag & MM_F_CIGAR)) return;
  int64_t n_a = squeeze_a(regs, ax.data(), ay.data());
  bool both_strands = (opt.flag & MM_F_SPLICE) &&
                      (opt.flag & MM_F_SPLICE_FOR) &&
                      (opt.flag & MM_F_SPLICE_REV);
  int i = 0;
  while (i < (int)regs.size()) {
    Reg r2;
    bool has2;
    bool dropped;
    if (both_strands) {
      // one round per transcript strand, keep the higher dp_score
      // (align.py align_skeleton_gen; reference align.c:884-900)
      Reg cand[2] = {regs[i], regs[i]};
      Reg r2s[2];
      bool h2s[2];
      h2s[0] = align1(c, qlen, q0, cand[0], r2s[0], n_a, ax.data(),
                      ay.data(), MM_F_SPLICE_FOR, &dropped);
      h2s[1] = align1(c, qlen, q0, cand[1], r2s[1], n_a, ax.data(),
                      ay.data(), MM_F_SPLICE_REV, &dropped);
      int64_t sc0 = cand[0].p ? cand[0].p->dp_score : -((int64_t)1 << 30);
      int64_t sc1 = cand[1].p ? cand[1].p->dp_score : -((int64_t)1 << 30);
      int which, trans_strand;
      if (sc0 > sc1) {
        which = 0;
        trans_strand = 1;
      } else if (sc0 < sc1) {
        which = 1;
        trans_strand = 2;
      } else {
        trans_strand = 3;
        which = (int)((qlen + sc0) & 1);
      }
      regs[i] = cand[which];
      r2 = r2s[which];
      has2 = h2s[which];
      if (regs[i].p) regs[i].p->trans_strand = trans_strand;
    } else {
      has2 = align1(c, qlen, q0, regs[i], r2, n_a, ax.data(), ay.data(),
                    opt.flag, &dropped);
      if ((opt.flag & MM_F_SPLICE) && regs[i].p)
        regs[i].p->trans_strand = (opt.flag & MM_F_SPLICE_FOR) ? 1 : 2;
    }
    if (has2 && r2.cnt > 0) regs.insert(regs.begin() + i + 1, std::move(r2));
    if (i > 0 && regs[i].split_inv) {
      Reg rinv;
      if (align1_inv(c, qlen, q0, regs[i - 1], regs[i], rinv)) {
        regs.insert(regs.begin() + i + 1, std::move(rinv));
        ++i;
      }
    }
    ++i;
  }
  regs = filter_regs(opt, qlen, regs);
  regs = hit_sort(regs, opt.alt_drop);
  if (!(opt.flag & MM_F_ALL_CHAINS)) {
    set_parent(opt.mask_level, opt.mask_len, regs, opt.a * 2 + opt.b,
               (opt.flag & MM_F_HARD_MLEVEL) != 0, opt.alt_drop);
    regs = select_sub(opt.pri_ratio, c.eng->mi.k * 2, opt.best_n, regs);
    set_sam_pri(regs);
  }
}

// primary/secondary post after chaining (frag.py chain_post)
static void chain_post(Ctx& c, int qlen, std::vector<Reg>& regs,
                       std::vector<uint64_t>& ax, std::vector<uint64_t>& ay) {
  const EngOpts& opt = *c.opt();
  if (!(opt.flag & MM_F_ALL_CHAINS)) {
    set_parent(opt.mask_level, opt.mask_len, regs, opt.a * 2 + opt.b,
               (opt.flag & MM_F_HARD_MLEVEL) != 0, opt.alt_drop);
    regs = select_sub(opt.pri_ratio, c.eng->mi.k * 2, opt.best_n, regs);
    if (!(opt.flag & (MM_F_SPLICE | MM_F_SR | MM_F_NO_LJOIN)))
      regs = join_long(opt, qlen, regs, ax.data(), ay.data());
  }
}

struct PipeOut {
  std::vector<Reg> regs;
  std::vector<uint64_t> ax, ay;
  int64_t rep_len = 0;
  int max_gap_ref = 0;
};

// one seed->chain->post->align->mapq pass (frag.py _pipeline_once_gen;
// reference map.c:343-470).  est_err is intentionally skipped: it only sets
// the div field of MCAS stage-1 trial regs, which are discarded after the
// Chain DP with optional device routing: anchor sets at or above the
// engine's chain_dev_min export through the chain exchange onto the device
// forward kernel (chain/device.py, bit-exact); smaller sets (or a disabled
// exchange) run the scalar host DP inline.  Returns n_v with the chain
// outputs in the vectors.
static int64_t chain_dp_route(Engine* eng, int max_dist_x, int min_dist_x,
                              int max_dist_y, int bw, int max_skip,
                              int max_iter, int min_cnt, int min_sc,
                              double gap_scale, int is_cdna, int64_t n,
                              const uint64_t* axp, const uint64_t* ayp,
                              std::vector<uint64_t>& u_v,
                              std::vector<uint64_t>& ax_v,
                              std::vector<uint64_t>& ay_v) {
  if (eng->chain_dev_min > 0 && n >= eng->chain_dev_min) {
    Engine::PendingChain pc;
    pc.n = n;
    pc.ax = axp;
    pc.ay = ayp;
    pc.max_dist_x = max_dist_x;
    pc.min_dist_x = min_dist_x;
    pc.max_dist_y = max_dist_y;
    pc.bw = bw;
    pc.max_skip = max_skip;
    pc.max_iter = max_iter;
    pc.min_cnt = min_cnt;
    pc.min_sc = min_sc;
    pc.is_cdna = is_cdna;
    pc.gap_scale = gap_scale;
    if (eng->chain_submit(pc, u_v, ax_v, ay_v)) return (int64_t)ax_v.size();
  }
  uint64_t *u = nullptr, *oax = nullptr, *oay = nullptr;
  int32_t n_u = 0;
  auto t0 = std::chrono::steady_clock::now();
  int64_t n_v =
      wm_chain_dp(max_dist_x, min_dist_x, max_dist_y, bw, max_skip, max_iter,
                  min_cnt, min_sc, (float)gap_scale, is_cdna, 1, n, axp, ayp,
                  &u, &n_u, &oax, &oay);
  eng->ns_chain.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(
                              std::chrono::steady_clock::now() - t0)
                              .count(),
                          std::memory_order_relaxed);
  eng->n_chain_calls.fetch_add(1, std::memory_order_relaxed);
  u_v.assign(u, u + n_u);
  ax_v.assign(oax, oax + n_v);
  ay_v.assign(oay, oay + n_v);
  if (u) wm_free(u);
  if (oax) wm_free(oax);
  if (oay) wm_free(oay);
  return n_v;
}

// acceptance test, so output is byte-identical without it.
static void pipeline_once(Ctx& c, int qlen, const uint8_t* seq_ascii,
                          const uint8_t* const q0[2], uint32_t hash_,
                          PipeOut& out) {
  const EngOpts& opt = *c.opt();
  const EngIndex& mi = c.eng->mi;
  bool is_sr = (opt.flag & MM_F_SR) != 0;
  bool is_splice = (opt.flag & MM_F_SPLICE) != 0;
  std::vector<uint64_t> mvx, mvy;
  collect_minimizers(opt, mi, seq_ascii, qlen, mvx, mvy);
  SeedHits sh = collect_seed_hits(opt, opt.mid_occ, mi, mvx, mvy, qlen);
  int max_gap_qry, max_gap_ref, min_gap_ref;
  chain_gaps(opt, is_sr, qlen, &max_gap_qry, &max_gap_ref, &min_gap_ref);
  std::vector<uint64_t> u_v;
  chain_dp_route(c.eng, max_gap_ref, min_gap_ref, max_gap_qry, opt.bw,
                 opt.max_chain_skip, opt.max_chain_iter, opt.min_cnt,
                 opt.min_chain_score, opt.chain_gap_scale,
                 is_splice ? 1 : 0, (int64_t)sh.ax.size(), sh.ax.data(),
                 sh.ay.data(), u_v, out.ax, out.ay);
  out.regs = gen_regs(hash_, qlen, u_v.data(), (int32_t)u_v.size(),
                      out.ax.data(), out.ay.data());
  chain_post(c, qlen, out.regs, out.ax, out.ay);
  align_regs(c, qlen, q0, out.regs, out.ax, out.ay);
  set_mapq(out.regs, opt.min_chain_score, opt.a, (int)sh.rep_len, is_sr);
  out.rep_len = sh.rep_len;
  out.max_gap_ref = max_gap_ref;
}

// vanilla single-pass mapping (frag.py _map_vanilla_gen)
static void run_vanilla(Engine* eng, ReadState* rd) {
  Ctx c{eng, 0, rd};
  uint32_t hash_ = frag_hash(rd->name_x31, rd->qlen, eng->opts[0].seed);
  PipeOut po;
  pipeline_once(c, rd->qlen, rd->seq, rd->q0, hash_, po);
  rd->regs = std::move(po.regs);
  rd->rep_len = po.rep_len;
  rd->frag_gap = po.max_gap_ref;
  rd->rep_len_defined = true;
}

// one MCAS substring trial attempt (frag.py _mcas_try_gen;
// reference map.c:346-515 right, 518-687 left)
static bool mcas_try(Ctx& c, int64_t sub_begin, int64_t sub_len, bool left,
                     int suffix_id, int* n_regs0_out) {
  ReadState* rd = c.rd;
  const EngOpts& o2 = *c.opt();
  int qlen = rd->qlen;
  int64_t start = left ? sub_begin - sub_len + 1 : sub_begin;
  const uint8_t* sub = rd->seq + start;
  uint32_t hash_ = frag_hash(rd->name_x31, (int)sub_len, o2.seed);
  const uint8_t* subq0[2] = {rd->q0[0] + start,
                             rd->q0[1] + (qlen - start - sub_len)};
  PipeOut po;
  pipeline_once(c, (int)sub_len, sub, subq0, hash_, po);
  *n_regs0_out = (int)po.regs.size();
  for (Reg& r : po.regs) {
    if (r.mapq >= o2.min_mapq && (double)r.blen >= o2.min_qcov * (double)sub_len &&
        r.cnt > 0) {
      std::vector<uint64_t> sax(po.ax.begin() + r.as_,
                                po.ax.begin() + r.as_ + r.cnt);
      std::vector<uint64_t> say(po.ay.begin() + r.as_,
                                po.ay.begin() + r.as_ + r.cnt);
      uint64_t shift_fwd, shift_rev;
      if (left) {
        shift_fwd = (uint64_t)(sub_begin - sub_len + 1);
        shift_rev = (uint64_t)((qlen - 1) - sub_begin);
      } else {
        shift_fwd = (uint64_t)sub_begin;
        shift_rev = (uint64_t)(qlen - sub_begin - sub_len);
      }
      for (size_t k = 0; k < say.size(); ++k)
        say[k] += (sax[k] >> 63) ? shift_rev : shift_fwd;
      {
        std::lock_guard<std::mutex> lk(rd->accept_mu);
        rd->coll_ax[suffix_id] = std::move(sax);
        rd->coll_ay[suffix_id] = std::move(say);
        std::memset(rd->seq_mapped.data() + start, 1, (size_t)sub_len);
      }
      return true;
    }
  }
  return false;
}

// all trials for one start position (frag.py McasState._trial_gen;
// reference map.c:334-688 geometric length ladder, right then left)
static void run_trial(Engine* eng, ReadState* rd, int suffix_id) {
  Ctx c{eng, 1, rd};
  const EngOpts& o2 = eng->opts[1];
  int qlen = rd->qlen;
  int64_t sub_begin = (int64_t)suffix_id * o2.suffix_sample_offset;
  if (sub_begin >= qlen) sub_begin = qlen - 1;
  int64_t sub_len = o2.min_prefix_length;
  while (sub_len <= o2.max_prefix_length) {
    int n_regs0;
    if (sub_begin + sub_len <= qlen) {
      bool found = mcas_try(c, sub_begin, sub_len, false, suffix_id, &n_regs0);
      if (found || n_regs0 == 0) return;
    }
    if (sub_begin - sub_len + 1 >= 0) {
      bool found = mcas_try(c, sub_begin, sub_len, true, suffix_id, &n_regs0);
      if (found || n_regs0 == 0) return;
    }
    sub_len = (int64_t)((double)sub_len * o2.prefix_increment_factor);
  }
}

// anchor pooling + stage-2 re-chain/re-align (frag.py mcas_stage2_gen;
// reference map.c:713-954)
static void run_stage2(Engine* eng, ReadState* rd) {
  const EngOpts& o3 = eng->opts[2];
  int qlen = rd->qlen;
  std::vector<uint64_t> ax, ay;
  bool have = false;
  {
    std::vector<std::pair<uint64_t, uint64_t>> pooled;
    for (int sid = 0; sid < rd->n_starts; ++sid)
      for (size_t k = 0; k < rd->coll_ax[sid].size(); ++k)
        pooled.push_back({rd->coll_ax[sid][k], rd->coll_ay[sid][k]});
    if (!pooled.empty()) {
      std::sort(pooled.begin(), pooled.end());
      size_t w_ = 0;
      for (size_t i = 0; i < pooled.size(); ++i) {
        if (i > 0 && pooled[i] == pooled[i - 1]) continue;
        pooled[w_++] = pooled[i];
      }
      pooled.resize(w_);
      if ((int64_t)pooled.size() >= o3.min_cnt) {
        have = true;
        ax.resize(pooled.size());
        ay.resize(pooled.size());
        for (size_t i = 0; i < pooled.size(); ++i) {
          ax[i] = pooled[i].first;
          ay[i] = pooled[i].second;
        }
      }
    }
  }
  int64_t rep_len = 0;
  bool rep_def = false;
  bool all_mapped = true;
  for (uint8_t m : rd->seq_mapped) all_mapped &= (m != 0);
  if (have && !all_mapped) {
    // reseed the unmapped stretches on an 'N'-masked copy
    std::vector<uint8_t> masked(rd->seq, rd->seq + qlen);
    for (int i = 0; i < qlen; ++i)
      if (rd->seq_mapped[i]) masked[i] = 'N';
    Ctx c3{eng, 2, rd};
    std::vector<uint64_t> mvx, mvy;
    collect_minimizers(o3, eng->mi, masked.data(), qlen, mvx, mvy);
    SeedHits sh = collect_seed_hits(o3, o3.mid_occ, eng->mi, mvx, mvy, qlen);
    rep_len = sh.rep_len;
    rep_def = true;
    size_t old_n = ax.size();
    ax.insert(ax.end(), sh.ax.begin(), sh.ax.end());
    ay.insert(ay.end(), sh.ay.begin(), sh.ay.end());
    // stable sort by ax only, preserving pooled-then-new relative order
    std::vector<int64_t> ord(ax.size());
    for (size_t i = 0; i < ord.size(); ++i) ord[i] = (int64_t)i;
    std::stable_sort(ord.begin(), ord.end(),
                     [&](int64_t a, int64_t b) { return ax[a] < ax[b]; });
    std::vector<uint64_t> ax2(ax.size()), ay2(ay.size());
    for (size_t i = 0; i < ord.size(); ++i) {
      ax2[i] = ax[ord[i]];
      ay2[i] = ay[ord[i]];
    }
    ax.swap(ax2);
    ay.swap(ay2);
    (void)old_n;
  }
  if (!have) {  // vanilla fallback with the original options
    run_vanilla(eng, rd);
    return;
  }
  // stage-2 chain/align from the pooled anchors (frag.py _stage2_chain_gen)
  Ctx c{eng, 2, rd};
  bool is_sr = (o3.flag & MM_F_SR) != 0;
  uint32_t hash_ = frag_hash(rd->name_x31, qlen, o3.seed);
  int max_gap_qry, max_gap_ref, min_gap_ref;
  chain_gaps(o3, is_sr, qlen, &max_gap_qry, &max_gap_ref, &min_gap_ref);
  PipeOut po;
  std::vector<uint64_t> u_v;
  chain_dp_route(eng, max_gap_ref, min_gap_ref, max_gap_qry, o3.bw,
                 o3.max_chain_skip, o3.max_chain_iter, o3.min_cnt,
                 o3.min_chain_score, o3.chain_gap_scale, 0,
                 (int64_t)ax.size(), ax.data(), ay.data(), u_v, po.ax,
                 po.ay);
  po.regs = gen_regs(hash_, qlen, u_v.data(), (int32_t)u_v.size(),
                     po.ax.data(), po.ay.data());
  chain_post(c, qlen, po.regs, po.ax, po.ay);
  align_regs(c, qlen, rd->q0, po.regs, po.ax, po.ay);
  set_mapq(po.regs, o3.min_chain_score, o3.a, (int)rep_len, is_sr);
  rd->regs = std::move(po.regs);
  rd->rep_len = rep_len;
  rd->frag_gap = max_gap_ref;
  rd->rep_len_defined = rep_def;
}

void Engine::run_tasks() {
  while (true) {
    Task t;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (tasks.empty()) {
        thread_exit();
        if (n_blocked == n_live) cv_settled.notify_all();
        return;
      }
      t = tasks.front();
      tasks.pop_front();
    }
    ReadState* rd = reads[t.read].get();
    switch (t.kind) {
      case Task::TRIAL:
        run_trial(this, rd, t.suffix_id);
        break;
      case Task::VANILLA:
        run_vanilla(this, rd);
        break;
      case Task::STAGE2:
        run_stage2(this, rd);
        break;
    }
  }
}

void* Engine::thread_entry(void* arg) {
  ((Engine*)arg)->run_tasks();
  return nullptr;
}

}  // namespace weng

// ---- C API ---------------------------------------------------------------
extern "C" {

void* wm_eng_create(const weng::EngIndex* mi, const weng::EngOpts* o0,
                    const weng::EngOpts* o1, const weng::EngOpts* o2,
                    const uint8_t* qpool, int max_threads) {
  auto* e = new weng::Engine();
  e->mi = *mi;
  e->opts[0] = *o0;
  e->opts[1] = *o1;
  e->opts[2] = *o2;
  for (int p = 0; p < 3; ++p)
    weng::gen_simple_mat(e->opts[p].a, e->opts[p].b, e->opts[p].sc_ambi,
                         e->mats[p]);
  e->qpool = qpool;
  e->max_threads = max_threads > 0 ? max_threads : 512;
  return e;
}

void wm_eng_destroy(void* ev) { delete (weng::Engine*)ev; }

// Add one read.  seq = ASCII bases; q0f_off/q0r_off = offsets of the fwd /
// revcomp code strands in the qpool (map/batch.py _build_pools layout).
void wm_eng_add_read(void* ev, const uint8_t* seq, int qlen, int64_t q0f_off,
                     int64_t q0r_off, uint32_t name_x31) {
  auto* e = (weng::Engine*)ev;
  auto rd = std::make_unique<weng::ReadState>();
  rd->seq = seq;
  rd->qlen = qlen;
  rd->q0[0] = e->qpool + q0f_off;
  rd->q0[1] = e->qpool + q0r_off;
  rd->name_x31 = name_x31;
  const weng::EngOpts& o = e->opts[0];
  rd->sv = o.sv_aware && qlen >= o.sv_aware_min_read_length;
  if (rd->sv) {
    const weng::EngOpts& o2 = e->opts[1];
    rd->n_starts = 1 + (int)((qlen + o2.suffix_sample_offset - 1) /
                             o2.suffix_sample_offset);
    rd->coll_ax.resize(rd->n_starts);
    rd->coll_ay.resize(rd->n_starts);
    rd->seq_mapped.assign(qlen, 0);
  }
  e->reads.push_back(std::move(rd));
}

// Launch phase 1: all MCAS substring trials + vanilla reads.
void wm_eng_start_phase1(void* ev) {
  auto* e = (weng::Engine*)ev;
  std::deque<weng::Task> ts;
  for (int i = 0; i < (int)e->reads.size(); ++i) {
    if (e->reads[i]->sv) {
      for (int s = 0; s < e->reads[i]->n_starts; ++s)
        ts.push_back({weng::Task::TRIAL, i, s});
    } else {
      ts.push_back({weng::Task::VANILLA, i, 0});
    }
  }
  e->launch_phase(std::move(ts));
}

// Launch phase 2: MCAS anchor pooling + stage-2 (incl. vanilla fallback).
int wm_eng_start_phase2(void* ev) {
  auto* e = (weng::Engine*)ev;
  std::deque<weng::Task> ts;
  for (int i = 0; i < (int)e->reads.size(); ++i)
    if (e->reads[i]->sv) ts.push_back({weng::Task::STAGE2, i, 0});
  int n = (int)ts.size();
  e->launch_phase(std::move(ts));
  return n;
}

// Block until every live mapping thread is waiting on a device job (or
// finished); returns the newly exported job rows (JOB_I64 int64s each).
int64_t wm_eng_step(void* ev, const int64_t** rows) {
  return ((weng::Engine*)ev)->step(rows);
}

int wm_eng_live(void* ev) {
  auto* e = (weng::Engine*)ev;
  std::lock_guard<std::mutex> lk(e->mu);
  return e->n_live;
}

void wm_eng_deliver(void* ev, int64_t n, const int64_t* ids,
                    const int32_t* res10, const uint32_t* cig_blob,
                    const int64_t* cig_off, const int32_t* cig_len) {
  ((weng::Engine*)ev)->deliver(n, ids, res10, cig_blob, cig_off, cig_len);
}

void wm_eng_run_host_ids(void* ev, int64_t n, const int64_t* ids) {
  ((weng::Engine*)ev)->run_host_ids(n, ids);
}

// perf readout: [0, host_dp_calls, chain_ns, chain_calls,
// thread_ns, blocked_ns, finished_ns, 0] (the last three over the phases
// whose threads have all exited)
void wm_eng_perf(void* ev, int64_t* out8) {
  auto* e = (weng::Engine*)ev;
  out8[0] = 0;
  out8[1] = e->n_host_dp.load();
  out8[2] = e->ns_chain.load();
  out8[3] = e->n_chain_calls.load();
  std::lock_guard<std::mutex> lk(e->mu);
  out8[4] = e->ns_thread;
  out8[5] = e->ns_blocked;
  out8[6] = e->ns_finished;
  out8[7] = 0;
}

// ---- chain exchange (device colinear chaining) ---------------------------
void wm_eng_set_chain_min(void* ev, int64_t min_anchors) {
  auto* e = (weng::Engine*)ev;
  std::lock_guard<std::mutex> lk(e->mu);
  e->chain_dev_min = min_anchors;
}

int64_t wm_eng_step_chains(void* ev, const int64_t** rows) {
  return ((weng::Engine*)ev)->step_chains(rows);
}

void wm_eng_deliver_chain(void* ev, int64_t id, int64_t n_u,
                          const uint64_t* u, int64_t n_v, const uint64_t* ax,
                          const uint64_t* ay) {
  ((weng::Engine*)ev)->deliver_chain(id, n_u, u, n_v, ax, ay);
}

// Flatten one read's result; returns n_regs and exposes the per-read blobs.
int wm_eng_result(void* ev, int read, const weng::RegOut** regs,
                  const uint32_t** cigars, int64_t* n_cigar_total,
                  int64_t* rep_len, int32_t* frag_gap,
                  int32_t* rep_len_defined) {
  auto* e = (weng::Engine*)ev;
  weng::ReadState* rd = e->reads[read].get();
  rd->out_regs.clear();
  rd->out_cigars.clear();
  for (weng::Reg& r : rd->regs) {
    weng::RegOut o;
    std::memset(&o, 0, sizeof(o));
    o.id = r.id;
    o.cnt = r.cnt;
    o.rid = r.rid;
    o.score = r.score;
    o.qs = r.qs;
    o.qe = r.qe;
    o.rs = r.rs;
    o.re = r.re;
    o.parent = r.parent;
    o.subsc = r.subsc;
    o.as_ = r.as_;
    o.mlen = r.mlen;
    o.blen = r.blen;
    o.n_sub = r.n_sub;
    o.score0 = r.score0;
    o.mapq = r.mapq;
    o.div = r.div;
    o.inv = r.inv;
    o.rev = r.rev;
    o.split = r.split;
    o.split_inv = r.split_inv;
    o.sam_pri = r.sam_pri;
    o.seg_split = r.seg_split;
    o.seg_id = r.seg_id;
    o.n_segs = r.n_segs;
    o.is_alt = r.is_alt;
    o.hash = r.hash;
    o.has_p = r.p != nullptr;
    if (r.p) {
      o.dp_score = r.p->dp_score;
      o.dp_max = r.p->dp_max;
      o.dp_max2 = r.p->dp_max2;
      o.n_ambi = r.p->n_ambi;
      o.trans_strand = r.p->trans_strand;
      o.cigar_off = (int64_t)rd->out_cigars.size();
      o.n_cigar = (int32_t)r.p->cigar.size();
      rd->out_cigars.insert(rd->out_cigars.end(), r.p->cigar.begin(),
                            r.p->cigar.end());
    }
    rd->out_regs.push_back(o);
  }
  *regs = rd->out_regs.data();
  *cigars = rd->out_cigars.data();
  *n_cigar_total = (int64_t)rd->out_cigars.size();
  *rep_len = rd->rep_len;
  *frag_gap = rd->frag_gap;
  *rep_len_defined = rd->rep_len_defined;
  return (int)rd->out_regs.size();
}

}  // extern "C"

extern "C" {
// struct-layout handshake with the ctypes layer
void wm_eng_sizes(int64_t* s) {
  s[0] = (int64_t)sizeof(weng::EngOpts);
  s[1] = (int64_t)sizeof(weng::EngIndex);
  s[2] = (int64_t)sizeof(weng::RegOut);
}
}
