// SDUST low-complexity masking (symmetric DUST; Morgulis et al. 2006),
// behaviourally equivalent to reference src/sdust.c:134-176: a sliding
// 64-word window of 3-mers, "perfect" high-score intervals tracked in
// descending-start order, and masked regions merged on emission.  Used to
// suppress minimizers inside low-complexity query stretches
// (reference src/map.c:43-67, -T/--dust option).
#include "wm_base.h"

#include <deque>
#include <vector>

namespace {

constexpr int WLEN = 3;
constexpr int WTOT = 1 << (WLEN << 1);
constexpr int WMSK = WTOT - 1;

struct PerfIntv {
  int start, finish;
  int r, l;
};

struct State {
  std::deque<int> w;
  std::vector<PerfIntv> P;  // descending start, then ascending finish
  std::vector<uint64_t> res;
  int cv[WTOT] = {0}, cw[WTOT] = {0};
  int rv = 0, rw = 0, L = 0;
};

const uint8_t NT4[256] = {
    // clang-format off
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,0,4,1,4,4,4,2,4,4,4,4,4,4,4,4, 4,4,4,4,3,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4, 4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,4,
    // clang-format on
};

void shift_window(State& st, int t, int T, int W) {
  if ((int)st.w.size() >= W - WLEN + 1) {
    int s = st.w.front();
    st.w.pop_front();
    st.rw -= --st.cw[s];
    if (st.L > (int)st.w.size()) {
      --st.L;
      st.rv -= --st.cv[s];
    }
  }
  st.w.push_back(t);
  ++st.L;
  st.rw += st.cw[t]++;
  st.rv += st.cv[t]++;
  if (st.cv[t] * 10 > 2 * T) {
    int s;
    do {
      s = st.w[st.w.size() - st.L];
      st.rv -= --st.cv[s];
      --st.L;
    } while (s != t);
  }
}

void save_masked(State& st, int start) {
  if (st.P.empty() || st.P.back().start >= start) return;
  const PerfIntv& p = st.P.back();
  bool saved = false;
  if (!st.res.empty()) {
    int s = (int)(st.res.back() >> 32);
    int f = (int)(uint32_t)st.res.back();
    if (p.start <= f) {  // overlapping or adjacent: extend
      saved = true;
      st.res.back() = (uint64_t)s << 32 | (uint32_t)(f > p.finish ? f : p.finish);
    }
  }
  if (!saved) st.res.push_back((uint64_t)p.start << 32 | (uint32_t)p.finish);
  int i = (int)st.P.size() - 1;
  while (i >= 0 && st.P[i].start < start) --i;
  st.P.resize(i + 1);
}

void find_perfect(State& st, int T, int start) {
  int c[WTOT];
  std::copy(st.cv, st.cv + WTOT, c);
  int r = st.rv, max_r = 0, max_l = 0;
  for (int i = (int)st.w.size() - st.L - 1; i >= 0; --i) {
    int t = st.w[i];
    r += c[t]++;
    int new_r = r, new_l = (int)st.w.size() - i - 1;
    if (new_r * 10 > T * new_l) {
      size_t j = 0;
      for (; j < st.P.size() && st.P[j].start >= i + start; ++j) {
        const PerfIntv& p = st.P[j];
        if (max_r == 0 || (int64_t)p.r * max_l > (int64_t)max_r * p.l) {
          max_r = p.r;
          max_l = p.l;
        }
      }
      if (max_r == 0 || (int64_t)new_r * max_l >= (int64_t)max_r * new_l) {
        max_r = new_r;
        max_l = new_l;
        PerfIntv np{i + start, (int)st.w.size() + (WLEN - 1) + start, new_r,
                    new_l};
        st.P.insert(st.P.begin() + j, np);
      }
    }
  }
}

}  // namespace

extern "C" {

// Mask intervals of `seq` (ASCII) with score threshold T and window W.
// Returns the interval count; *out (start<<32|end pairs) is wm_malloc'd.
int64_t wm_sdust(const uint8_t* seq, int64_t l_seq, int T, int W,
                 uint64_t** out) {
  State st;
  unsigned t = 0;
  int l = 0;
  for (int64_t i = 0; i <= l_seq; ++i) {
    int b = i < l_seq ? NT4[seq[i]] : 4;
    if (b < 4) {
      ++l;
      t = (t << 2 | b) & WMSK;
      if (l >= WLEN) {
        int start = (l - W > 0 ? l - W : 0) + (int)(i + 1 - l);
        save_masked(st, start);
        shift_window(st, t, T, W);
        if (st.rw * 10 > st.L * T) find_perfect(st, T, start);
      }
    } else {  // N breaks the sequence into independent pieces
      int start = (l - W + 1 > 0 ? l - W + 1 : 0) + (int)(i + 1 - l);
      while (!st.P.empty()) save_masked(st, start++);
      l = 0;
      t = 0;
    }
  }
  *out = nullptr;
  if (!st.res.empty()) {
    *out = (uint64_t*)wm_malloc(st.res.size() * sizeof(uint64_t));
    std::memcpy(*out, st.res.data(), st.res.size() * sizeof(uint64_t));
  }
  return (int64_t)st.res.size();
}

}  // extern "C"
