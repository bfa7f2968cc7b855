// Exact colinear anchor chaining, host fallback / bit-exactness oracle.
//
// Same observable behaviour as the reference chain DP
// (reference: src/chain.c:22-167), including the Winnowmap-specific
// min_dist_x window-advance rule inside repeats (src/chain.c:51-55), the
// max_skip early-break bookkeeping, float gap-cost rounding, and the final
// chain reordering by first-anchor reference position.
//
// The device path (winnowmap_tpu/chain/device.py) runs the forward DP as
// a batched XLA lane-scan and shares wm_chain_finish below for the tail;
// this scalar routine is the semantic reference and the production path
// for small anchor sets (below the device call overhead).

#include "wm_base.h"

#include <algorithm>
#include <cmath>
#include <vector>

namespace {

inline int ilog2_32(uint32_t v) {
  int r = 0;
  while (v >>= 1) ++r;
  return r;
}

}  // namespace

extern "C" {

int64_t wm_chain_finish(int64_t n, const int32_t* f, const int32_t* pre,
                        const int32_t* v, int min_cnt, int min_sc,
                        const uint64_t* ax, const uint64_t* ay,
                        uint64_t** out_u, int32_t* out_n_u, uint64_t** out_ax,
                        uint64_t** out_ay);

// Returns the number of output anchors (n_v).  Outputs:
//   out_u  : per-chain (score<<32 | count), length *out_n_u (wm_malloc'd)
//   out_ax/out_ay: reordered anchors of all kept chains (wm_malloc'd)
int64_t wm_chain_dp(int max_dist_x, int min_dist_x, int max_dist_y, int bw,
                    int max_skip, int max_iter, int min_cnt, int min_sc,
                    float gap_scale, int is_cdna, int n_segs, int64_t n,
                    const uint64_t* ax, const uint64_t* ay, uint64_t** out_u,
                    int32_t* out_n_u, uint64_t** out_ax, uint64_t** out_ay) {
  *out_u = nullptr;
  *out_n_u = 0;
  *out_ax = nullptr;
  *out_ay = nullptr;
  if (n == 0 || ax == nullptr) return 0;

  std::vector<int32_t> f(n), pre(n), t(n, 0), v(n);

  uint64_t sum_qspan = 0;
  for (int64_t i = 0; i < n; ++i) sum_qspan += ay[i] >> 32 & 0xff;
  const float avg_qspan = (float)sum_qspan / n;

  // forward DP over anchors sorted by (strand<<63|rid<<32|rpos)
  int64_t st = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t ri = ax[i];
    int64_t max_j = -1;
    int32_t qi = (int32_t)ay[i], q_span = ay[i] >> 32 & 0xff;
    int32_t max_f = q_span, n_skip = 0;
    int32_t sidi = (int32_t)((ay[i] & (0xffULL << 48)) >> 48);
    while (st < i && ri > ax[st] + max_dist_x) ++st;
    if (i - st > max_iter) {
      // Winnowmap tweak: keep iterating inside repeats until the window is
      // at least min_dist_x wide (reference chain.c:51-55)
      while (i - st > max_iter && ri > ax[st] + min_dist_x) ++st;
    }
    for (int64_t j = i - 1; j >= st; --j) {
      int64_t dr = ri - ax[j];
      int32_t dq = qi - (int32_t)ay[j], dd, sc, log_dd, gap_cost;
      int32_t sidj = (int32_t)((ay[j] & (0xffULL << 48)) >> 48);
      if ((sidi == sidj && dr == 0) || dq <= 0) continue;
      if ((sidi == sidj && dq > max_dist_y) || dq > max_dist_x) continue;
      dd = dr > dq ? (int32_t)dr - dq : dq - (int32_t)dr;
      if (sidi == sidj && dd > bw) continue;
      if (n_segs > 1 && !is_cdna && sidi == sidj && dr > max_dist_y) continue;
      int32_t min_d = dq < dr ? dq : (int32_t)dr;
      sc = min_d > q_span ? q_span : dq < (int32_t)dr ? dq : (int32_t)dr;
      log_dd = dd ? ilog2_32((uint32_t)dd) : 0;
      gap_cost = 0;
      if (is_cdna || sidi != sidj) {
        int c_lin = (int)(dd * .01 * avg_qspan);
        int c_log = log_dd;
        if (sidi != sidj && dr == 0)
          ++sc;
        else if (dr > dq || sidi != sidj)
          gap_cost = c_lin < c_log ? c_lin : c_log;
        else
          gap_cost = c_lin + (c_log >> 1);
      } else
        gap_cost = (int)(dd * .01 * avg_qspan) + (log_dd >> 1);
      sc -= (int)((double)gap_cost * gap_scale + .499);
      sc += f[j];
      if (sc > max_f) {
        max_f = sc, max_j = j;
        if (n_skip > 0) --n_skip;
      } else if (t[j] == (int32_t)i) {
        if (++n_skip > max_skip) break;
      }
      if (pre[j] >= 0) t[pre[j]] = (int32_t)i;
    }
    f[i] = max_f;
    pre[i] = (int32_t)max_j;
    v[i] = max_j >= 0 && v[max_j] > max_f ? v[max_j] : max_f;
  }

  return wm_chain_finish(n, f.data(), pre.data(), v.data(), min_cnt,
                         min_sc, ax, ay, out_u, out_n_u, out_ax, out_ay);
}

// Chain-end discovery, backtrack, and reordering over a computed forward
// DP (f = best score ending at anchor, pre = predecessor, v = running peak
// score along the chain) -- the tail of the reference chain DP
// (src/chain.c:92-166), shared by the scalar oracle above and the device
// forward kernel (winnowmap_tpu/chain/device.py).
int64_t wm_chain_finish(int64_t n, const int32_t* f, const int32_t* pre,
                        const int32_t* v, int min_cnt, int min_sc,
                        const uint64_t* ax, const uint64_t* ay,
                        uint64_t** out_u, int32_t* out_n_u, uint64_t** out_ax,
                        uint64_t** out_ay) {
  *out_u = nullptr;
  *out_n_u = 0;
  *out_ax = nullptr;
  *out_ay = nullptr;
  std::vector<int32_t> t(n, 0);
    for (int64_t i = 0; i < n; ++i)
    if (pre[i] >= 0) t[pre[i]] = 1;
  int64_t n_u = 0;
  for (int64_t i = 0; i < n; ++i)
    if (t[i] == 0 && v[i] >= min_sc) ++n_u;
  if (n_u == 0) return 0;

  std::vector<uint64_t> u;
  u.reserve(n_u);
  for (int64_t i = 0; i < n; ++i) {
    if (t[i] == 0 && v[i] >= min_sc) {
      int64_t j = i;
      while (j >= 0 && f[j] < v[j]) j = pre[j];  // walk to the peak
      if (j < 0) j = i;
      u.push_back((uint64_t)f[j] << 32 | (uint64_t)j);
    }
  }
  std::sort(u.begin(), u.end());
  std::reverse(u.begin(), u.end());  // best chain first

  // backtrack from each end, highest score first
  std::fill(t.begin(), t.end(), 0);
  std::vector<int32_t> vv;
  vv.reserve(n);
  int64_t k = 0;
  for (int64_t i = 0; i < (int64_t)u.size(); ++i) {
    int64_t n_v0 = (int64_t)vv.size();
    int64_t j = (int32_t)u[i];
    do {
      vv.push_back((int32_t)j);
      t[j] = 1;
      j = pre[j];
    } while (j >= 0 && t[j] == 0);
    int64_t k0 = k;
    if (j < 0) {
      if ((int64_t)vv.size() - n_v0 >= min_cnt)
        u[k++] = u[i] >> 32 << 32 | (uint64_t)((int64_t)vv.size() - n_v0);
    } else if ((int32_t)(u[i] >> 32) - f[j] >= min_sc) {
      if ((int64_t)vv.size() - n_v0 >= min_cnt)
        u[k++] = (uint64_t)((u[i] >> 32) - (uint64_t)f[j]) << 32 |
                 (uint64_t)((int64_t)vv.size() - n_v0);
    }
    if (k0 == k) vv.resize(n_v0);  // chain rejected
  }
  n_u = k;
  if (n_u == 0) return 0;
  const int64_t n_v = (int64_t)vv.size();

  // write chains (anchors re-ordered start-to-end)
  std::vector<uint64_t> bx(n_v), by(n_v);
  {
    int64_t kk = 0;
    for (int64_t i = 0; i < n_u; ++i) {
      int32_t ni = (int32_t)u[i];
      for (int32_t j = 0; j < ni; ++j) {
        int32_t src = vv[kk + (ni - j - 1)];  // vv holds ends-first per chain
        bx[kk + j] = ax[src];
        by[kk + j] = ay[src];
      }
      kk += ni;
    }
  }

  // sort chains by first-anchor position so adjacent chains may be joined
  // (reference chain.c:149-164); stable sort matches the LSD radix sort
  std::vector<int64_t> order(n_u);
  std::vector<int64_t> starts(n_u);
  {
    int64_t kk = 0;
    for (int64_t i = 0; i < n_u; ++i) {
      starts[i] = kk;
      order[i] = i;
      kk += (int32_t)u[i];
    }
  }
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return bx[starts[a]] < bx[starts[b]];
  });

  uint64_t* ru = (uint64_t*)wm_malloc(sizeof(uint64_t) * n_u);
  uint64_t* rax = (uint64_t*)wm_malloc(sizeof(uint64_t) * n_v);
  uint64_t* ray = (uint64_t*)wm_malloc(sizeof(uint64_t) * n_v);
  {
    int64_t kk = 0;
    for (int64_t i = 0; i < n_u; ++i) {
      int64_t src_chain = order[i];
      int32_t ni = (int32_t)u[src_chain];
      ru[i] = u[src_chain];
      std::memcpy(rax + kk, bx.data() + starts[src_chain],
                  sizeof(uint64_t) * ni);
      std::memcpy(ray + kk, by.data() + starts[src_chain],
                  sizeof(uint64_t) * ni);
      kk += ni;
    }
  }
  *out_u = ru;
  *out_n_u = (int32_t)n_u;
  *out_ax = rax;
  *out_ay = ray;
  return n_v;
}

}  // extern "C"
