// P1-P3: cost probes of the extension-DP kernels on Hopper.
//
// Replace the TPU probes tests/tools/probe_bisect.py (run, pallas_call at
// :48), tests/tools/probe_l0.py (run, pallas_call at :55) and
// tests/tools/probe_core.py (build :30, run_level's pallas_call at :222).
// Their outputs are those probes' outputs, exactly; the plain versions are
// in winnowmap_tpu_torch/tools/probe_{bisect,l0,core}.py.
//
// What they measure: not bytes nor arithmetic but the fixed costs of the
// row structure the extension kernels run (ext_common.cuh's design notes).
// P3 is built on K1's row: each thread owns a group of 4 consecutive lanes
// and keeps their state in registers across rows; lane t-1's old x, x2, v
// comes by __shfl_up_sync inside a warp and from a double-buffered edge
// array at warp boundaries; a job is five warps and one block barrier a
// row.  P2 keeps a step's state the same way, a thread a 4-lane word.  P1
// keeps the row structure K1 first had: one block of 128 threads per job,
// the state in shared memory, one barrier a step.
//
// What bounds them on this card.  P3 at level 6 and the timed inputs: its
// jobs set done near row 293, so most of its dirs rows are zeros, bytes at
// the memory rate; the rows before are the issue rate of the 16-lane
// integer pipe of each SM's schedulers (a cell is some 65 instructions,
// four jobs an SM).  P2: a launch's own latency (its 63 steps are one
// bytewise add each).
// The TPU grid's sequential step axis (KR steps of ROWS rows) is a loop
// inside the block; TB, the TPU's tile height, has no counterpart.  Every
// probe writes its final state to a device output (the TPU's VMEM scratch),
// so the compiler keeps the timed work.
//
// int32 arithmetic that JAX wraps is done through unsigned (wadd, wsub):
// signed overflow is undefined in C++.  int32 -> int8 keeps the low byte,
// as JAX's astype does.
#include "ext_common.cuh"

#include <type_traits>

namespace {

constexpr int kNeg = -1000000000;  // the probes' -10**9
constexpr int kMaxSeg = 8;         // P1 rolls: lanes a thread holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
// the value as the compiler must recompute it: a loop of adds on it stays
// a loop (the probes time round trips, not their closed form)
template <class T>
__device__ __forceinline__ void opaque(T& v) {
  asm volatile("" : "+r"(v));
}

// ---------------------------------------------------------------------------
// P3: the ladder of stripped extd step kernels (probe_core.py build)
// ---------------------------------------------------------------------------
// level 0 state round trip, 1 + the recurrence, 2 + band masks, 3 + dirs,
// 4 + the approx-max / z-drop walk, 5 + the window slide, 6 + the query
// slice.  DM: dirs 0 none, 1 uint8 rows, 2 int32 words of 4 rows (row j
// at bits 8 (j % 4)).  S32: the state is int32 between steps (no wrap).
//
// Layout.  A job's window holds kCoreLanes = 640 lanes, five chunks of 128;
// Wb is any width from 1 to 640, the last chunk and the last group of 4
// lanes partial where Wb is not a multiple of 128 or of 4 (their lanes past
// Wb are computed in registers, never stored, and no lane below Wb reads
// them).  A job is a block of five warps, one a
// chunk, with one barrier a row, as K1 at 128 threads has: thread tid owns
// the group of 4 lanes 4 tid .. 4 tid + 3, so a u8 dirs row leaves as
// 32-bit words, 128 contiguous bytes a warp instruction, and the band
// (rounded to 16) is skipped chunk by chunk without divergence.  (One warp
// a job, five groups a thread and no block barrier, timed slower at every
// level: its chunks' rows ran one after another on one scheduler; PERF.md.)
//   * u v x y x2 y2 s of a thread's lanes stay in registers as int32 (as
//     the probe computes them), wrapped to int8 at each step's end.
//   * A group's old carries are read before its lanes change, so every
//     cell sees lane t-1's old x, x2, v: by __shfl_up_sync inside a warp;
//     each warp's lane 31 writes its chunk's last lane after the row (after
//     the step's wrap) into `edge`, double-buffered by row parity, and the
//     row's barrier orders it before the next row's reads.
//   * Level 4's walk reads v[lH0t] and u[lH0t + 1] from a mirror of u and
//     v in shared memory: every warp writes its chunk into the buffer of
//     the row's parity before the row's barrier.  mx, H0, lH0t and done are
//     computed alike by every thread.
//   * After done (from the next step on: the state no longer changes) warp
//     0 walks over the mirror while the other warps write the step's dirs
//     rows as 16-byte zero stores: no barrier, no cell.
//   * Level 5's slide moves the state by 16 lanes once a step into shared
//     memory (its result is overwritten at the step's end, as the probe's).
//   * Level 6's query block, roll(qbuf[:, :Wb + 256], 7), is staged in
//     shared memory once a job; a group reads its 4 bytes as two words.
// A wider window takes the wide launch (core_wide_kernel, below).

constexpr int kChunk = 128;                    // lanes of a warp: 32 x 4
constexpr int kCoreLanes = 640;                // a job's window: five chunks
constexpr int kCoreWarps = kCoreLanes / kChunk;
constexpr int kCoreThreads = 32 * kCoreWarps;
constexpr int kWideWarps = 32;                 // the wide launch's most
constexpr int kWideLanesMax = 1 << 24;         // its slot offsets fit int

struct CoreArgs {
  const uint8_t* qbuf;
  int qstride;
  const int32_t* qlen;
  int32_t* res;
  void* dirs;
  void* state;
  long long* work;  // computed cells and rows per job, or null
  int B, Wb, ROWS, KR;
  uint8_t* scratch;  // the wide launch's slots, or null
  long long scratch_bytes;
};

// The offsets of a job's shared memory: the query block, the slide's rows,
// the walk's mirror of u and v, the chunk edges.
struct CoreGeo {
  int q_off, sl_off, m_off, edge_off, shm;
};

__host__ __device__ inline int core_take(int& at, int bytes) {
  const int here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

__host__ __device__ inline CoreGeo core_geo(int L, bool s32, int Wb) {
  CoreGeo g;
  int at = 0;
  g.q_off = core_take(at, L >= 6 ? Wb + 256 + 16 : 0);
  g.sl_off = core_take(at, L >= 5 ? 7 * Wb * (s32 ? 4 : 1) : 0);
  g.m_off = core_take(at, L >= 4 ? 2 * 2 * Wb * 4 : 0);
  g.edge_off = core_take(at, 2 * kCoreWarps * 4 * 4);
  g.shm = at;
  return g;
}

// lanes [at, at + n) of a row of St from int32 values (n <= 4; none for
// n <= 0): one vector store where the group is whole and the rows' stride
// keeps it aligned (vec: Wb % 4 == 0), else a store a lane
template <class St>
__device__ __forceinline__ void put4(St* row, int at, const int (&r)[4],
                                     int n, bool vec) {
  if (vec && n == 4) {
    if constexpr (sizeof(St) == 1)
      *(uint32_t*)(row + at) = (uint32_t)(r[0] & 255) |
                               (uint32_t)(r[1] & 255) << 8 |
                               (uint32_t)(r[2] & 255) << 16 |
                               (uint32_t)r[3] << 24;
    else
      *(uint4*)(row + at) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < n) row[at + q] = (St)r[q];
}

__device__ __forceinline__ void walk_step(int d0, int d1, int l1, int& mx,
                                          int& H0, int& lH0t, int& done) {
  H0 = wadd(H0, max(d0, d1));
  if (d1 > d0) lH0t = l1;
  if (H0 > mx)
    mx = H0;
  else if (wsub(mx, H0) > 400)
    done = 1;
}

// The band a row computes before done: lanes [lo, hi], 16-rounded (hi < lo
// once the band has left the window)
__device__ __forceinline__ void core_band(int r, int ql, int Wb, int& lo,
                                          int& hi) {
  const int st0 = max(max(0, r - ql + 1), (r - 500) >> 1);
  const int en0 = min(min(ql - 1, r), (r + 501) >> 1);
  lo = max((st0 >> 4) * 16, 0);
  hi = min(((en0 + 16) >> 4) * 16 - 1, Wb - 1);
}

template <int L, int DM, bool S32>
__global__ void __launch_bounds__(kCoreThreads) core_kernel(CoreArgs A) {
  using St = typename std::conditional<S32, int32_t, int8_t>::type;
  constexpr int C = kCoreWarps, NT = kCoreThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  const CoreGeo geo = core_geo(L, S32, A.Wb);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            w = tid >> 5;
  const int Wb = A.Wb, ROWS = A.ROWS, B = A.B, QR = Wb + 256;
  const int t0 = 4 * tid;              // my lanes t0 .. t0 + 3
  const bool real = kChunk * w < Wb;  // my chunk lies in the window
  const int nl = min(4, Wb - t0);     // my lanes in the window (<= 0: none)
  const bool vec = (Wb & 3) == 0;     // rows keep 4-lane groups aligned
  const uint32_t* Q32 = (const uint32_t*)(smem + geo.q_off);
  St* Sl = (St*)(smem + geo.sl_off);
  int* mU = (int*)(smem + geo.m_off);       // [2][Wb]: u and v for the walk
  int* mV = mU + 2 * Wb;
  int* edge = (int*)(smem + geo.edge_off);  // [2][C][4]: x x2 v of a last lane
  uint8_t* dirs8 = (uint8_t*)A.dirs;
  int32_t* dirs32 = (int32_t*)A.dirs;

  int u[4], v[4], x[4], y[4], x2[4], y2[4], s[4];
  int pk[4];  // DM 2: the word being packed, per lane
#pragma unroll
  for (int q = 0; q < 4; ++q)
    u[q] = v[q] = x[q] = y[q] = x2[q] = y2[q] = s[q] = pk[q] = 0;
  auto wrap8 = [&]() {  // the step's end: the state as int8
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u[q] = (int8_t)u[q], v[q] = (int8_t)v[q], x[q] = (int8_t)x[q];
      y[q] = (int8_t)y[q], x2[q] = (int8_t)x2[q], y2[q] = (int8_t)y2[q];
      s[q] = (int8_t)s[q];
    }
  };
  // u and v of my lanes into mirror buffer p
  auto mirror = [&](int p) {
    put4(mU + p * Wb, t0, u, nl, vec), put4(mV + p * Wb, t0, v, nl, vec);
  };

  const int ql = A.qlen[b];
  int mx = 0, H0 = 0, lH0t = 0, done = 0;
  long long ncell = L < 2 ? (long long)A.KR * ROWS * Wb : 0;
  int nrow = L < 2 ? A.KR * ROWS : 0;

  if (L >= 6) {  // the query block rolled by 7, and 16 zero bytes after it
    uint8_t* Q = smem + geo.q_off;
    const uint8_t* qb = A.qbuf + (int64_t)b * A.qstride;
    for (int i = tid; i < QR + 16; i += NT)
      Q[i] = i >= QR ? 0 : qb[i >= 7 ? i - 7 : i - 7 + QR];
  }
  if (L >= 1) {  // row 0's carries: the zero state
    for (int i = tid; i < 4 * C; i += NT) edge[4 * C + i] = 0;
    __syncthreads();
  }

  // fast: from the row after done (under DM 2, after its packed row) the
  // state no longer changes: warp 0 walks over u and v as they were then,
  // in mirror buffer 0 (wrapped on the read from the next step on), while
  // the other warps write the dirs rows as 16-byte zero stores
  bool fast = false;
  int kfast = 0;
  for (int k = 0; k < A.KR; ++k) {
    const int r0 = k * ROWS;
    if (L >= 5 && r0 > 0 && real) {
      // the slide: lane l takes lane l + 16, the last 16 lanes 0
      auto slide = [&](int a, const int (&r)[4]) {
        St* row = Sl + a * Wb;
        if (vec && nl == 4) {
          if (t0 >= 16) put4(row, t0 - 16, r, 4, true);
          if (t0 >= Wb - 16) put4(row, t0, {0, 0, 0, 0}, 4, true);
          return;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = t0 + q;
          if (q >= nl) break;
          if (t >= 16) row[t - 16] = (St)r[q];
          if (t >= Wb - 16) row[t] = 0;
        }
      };
      slide(0, u), slide(1, v), slide(2, x), slide(3, y), slide(4, x2);
      slide(5, y2), slide(6, s);
    }
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + j, par = r & 1, jm = j & 3;
      const bool last = j == ROWS - 1;
      if (L >= 4 && fast) {
        // rows j .. ROWS - 1: their dirs as 16-byte zero stores (a store
        // a lane where Wb breaks their alignment), the flat index (row,
        // unit) in strides of the storing threads (every warp but warp 0),
        // then warp 0's walk
        constexpr int kUnit = DM == 1 ? 16 : 4;  // lanes a 16-byte store
        constexpr int NS = NT - 32;
        const int ts = tid - 32;
        const bool zvec = Wb % kUnit == 0;
        if (DM != 0 && ts >= 0) {
          const int units = zvec ? Wb / kUnit : Wb;
          const int ra = DM == 1 ? r : (r + 3) >> 2;  // rows (packed rows)
          const int nr = (DM == 1 ? r0 + ROWS : (r0 + ROWS) >> 2) - ra;
          int jj = ts / units, c = ts % units;
          const int dj = NS / units, dc = NS % units;
          for (; jj < nr; jj += dj, c += dc) {
            if (c >= units) c -= units, ++jj;
            if (jj >= nr) break;
            const int64_t row = (int64_t)(ra + jj) * B + b;
            if (!zvec) {
              if (DM == 1) dirs8[row * Wb + c] = 0;
              else dirs32[row * Wb + c] = 0;
              continue;
            }
            uint4* at = (uint4*)(DM == 1 ? (void*)(dirs8 + row * Wb)
                                         : (void*)(dirs32 + row * Wb));
            at[c] = make_uint4(0, 0, 0, 0);
          }
        }
        if (w == 0) {  // warp 0 holds res
          // the walk over the frozen u and v (wrapped on the read after
          // the step it froze in): the values for both lanes the next row
          // may stand on are loaded ahead, so a row waits on no load
          const bool wrap = !S32 && k > kfast;
          auto at = [&](const int* m, int l) {
            if (l < 0 || l >= Wb) return kNeg;
            const int val = m[l];
            return max(wrap ? (int)(int8_t)val : val, kNeg);
          };
          int cv = at(mV, lH0t), cu = at(mU, wadd(lH0t, 1));
          for (int jj = j; jj < ROWS; ++jj) {
            const int l = lH0t, l1 = wadd(l, 1);
            const int nv = at(mV, l1), nu = at(mU, wadd(l, 2));
            walk_step(cv, cu, l1, mx, H0, lH0t, done);
            if (lH0t != l) cv = nv, cu = nu;
          }
        }
        if (!S32) wrap8();
        break;
      }
      if (L == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          u[q] = wadd(u[q], 1);
          opaque(u[q]);
        }
      } else if (real) {
        int lo = 0, hi = Wb - 1;  // the lanes this row computes
        if (L >= 2) {
          core_band(r, ql, Wb, lo, hi);
          if (done) hi = lo - 1;
          if (hi >= lo) ncell += hi - lo + 1, ++nrow;
        }
        const int l0 = kChunk * w;
        uint32_t dw = 0;  // the u8 dirs of my 4 lanes
        if (L < 2 || (l0 <= hi && l0 + kChunk - 1 >= lo)) {
          // lane t0 - 1's old x, x2, v
          int cx = __shfl_up_sync(kFull, x[3], 1);
          int cx2 = __shfl_up_sync(kFull, x2[3], 1);
          int cv = __shfl_up_sync(kFull, v[3], 1);
          if (lane == 0 && w > 0) {
            const int* e = edge + ((par ^ 1) * C + w - 1) * 4;
            cx = e[0], cx2 = e[1], cv = e[2];
          }
          if (t0 == 0) cx = -6, cx2 = -25, cv = -6;
          const int px[4] = {cx, x[0], x[1], x[2]};
          const int px2[4] = {cx2, x2[0], x2[1], x2[2]};
          const int pv[4] = {cv, v[0], v[1], v[2]};
          uint32_t qw = 0;  // the query bytes of my 4 lanes
          if (L >= 6) {
            const int at = ROWS - 1 - j + t0;
            qw = __byte_perm(Q32[at >> 2], Q32[(at >> 2) + 1],
                             (at & 3) * 0x1111 + 0x3210);
          }
          // the band's ends are 16-lane aligned: my 4 lanes are all in it
          // or all out, so a group, not a lane, skips its cells
          if (L < 2 || (t0 >= lo && t0 <= hi))
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int t = t0 + q;
              const int uu = (L >= 2 && t == r) ? -6 : u[q];
              const int sc = L >= 6 ? ((int)((qw >> (8 * q)) & 255) == s[q]
                                           ? 2
                                           : -4)
                                    : wadd(s[q], 1);
              const int a = wadd(px[q], pv[q]), bb = wadd(y[q], uu);
              const int a2 = wadd(px2[q], pv[q]), b2 = wadd(y2[q], uu);
              int z = sc, d = 0;
              if (L >= 3) {
                d = z > a ? 0 : 1;
                z = max(z, a);
                d = z > bb ? d : 2;
                z = max(z, bb);
                d = z > a2 ? d : 3;
                z = max(z, a2);
                d = z > b2 ? d : 4;
                z = max(z, b2);
              } else {
                z = max(max(max(z, a), max(bb, a2)), b2);
              }
              z = min(z, 2);
              const int zq = z - 6, zq2 = z - 25;
              const int an = wsub(a, zq), bn = wsub(bb, zq);
              const int a2n = wsub(a2, zq2), b2n = wsub(b2, zq2);
              u[q] = wsub(z, pv[q]);
              v[q] = wsub(z, uu);
              x[q] = max(an, 0) - 8;
              y[q] = max(bn, 0) - 8;
              x2[q] = max(a2n, 0) - 26;
              y2[q] = max(b2n, 0) - 26;
              s[q] = sc;
              if (L >= 3)
                dw |= (uint32_t)(d | (an > 0 ? 8 : 0) | (bn > 0 ? 16 : 0) |
                                 (a2n > 0 ? 32 : 0) | (b2n > 0 ? 64 : 0))
                      << (8 * q);
            }
        }
        if (L >= 3 && DM == 1) {  // dirs are 0 outside the band
          uint8_t* at = dirs8 + ((int64_t)r * B + b) * Wb + t0;
          if (vec && nl == 4)
            *(uint32_t*)at = dw;
          else
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < nl) at[q] = (uint8_t)(dw >> (8 * q));
        }
        if (L >= 3 && DM == 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int dv = (int)((dw >> (8 * q)) & 255);
            pk[q] = jm == 0 ? dv : (pk[q] | dv << (8 * jm));
          }
          if (jm == 3)
            put4(dirs32 + ((int64_t)(r >> 2) * B + b) * Wb, t0, pk, nl,
                 vec);
        }
      }
      // the walk: v[lH0t] and u[lH0t + 1] after the row, before the wrap,
      // from mirror buffer par after the row's barrier
      const int l1 = wadd(lH0t, 1);
      if (L >= 4) mirror(par);
      if (!S32 && last) wrap8();
      if (L >= 1) {
        if (lane == 31 && real) {
          int* e = edge + (par * C + w) * 4;
          e[0] = x[3], e[1] = x2[3], e[2] = v[3];
        }
        __syncthreads();
      }
      if (L >= 4) {
        const int* wU = mU + par * Wb;
        const int* wV = mV + par * Wb;
        const int d0 = lH0t >= 0 && lH0t < Wb ? max(wV[lH0t], kNeg) : kNeg;
        const int d1 = l1 >= 0 && l1 < Wb ? max(wU[l1], kNeg) : kNeg;
        walk_step(d0, d1, l1, mx, H0, lH0t, done);
        if (done && (DM != 2 || jm == 3)) {  // the rows left are fast
          __syncthreads();  // every warp has read the mirror
          mirror(0);        // this step's state (wrapped if it ended)
          __syncthreads();
          fast = true;
          kfast = k;
        }
      }
    }
  }

  if (real) {
    St* out = (St*)A.state;
    auto put = [&](int a, const int (&r)[4]) {
      put4(out + ((int64_t)a * B + b) * Wb, t0, r, nl, vec);
    };
    put(0, u), put(1, v), put(2, x), put(3, y), put(4, x2), put(5, y2);
    put(6, s);
  }
  if (tid < 16)
    A.res[b * 16 + tid] = tid == 0   ? mx
                          : tid == 1 ? H0
                          : tid == 2 ? lH0t
                          : tid == 3 ? done
                                     : 0;
  if (tid == 0 && A.work) A.work[2 * b] = ncell, A.work[2 * b + 1] = nrow;
}

// Launches (or, with `blocks`, asks the occupancy of) one instantiation:
// a block a job, kCoreThreads threads.
template <int L, int DM, bool S32>
int core_run(const CoreArgs& A, int* blocks, void* stream) {
  const CoreGeo g = core_geo(L, S32, A.Wb);
  cudaError_t err = cudaSuccess;
  if (g.shm > 48 * 1024)
    err = cudaFuncSetAttribute(core_kernel<L, DM, S32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g.shm);
  if (err != cudaSuccess) return (int)err;
  if (blocks)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, core_kernel<L, DM, S32>, kCoreThreads, g.shm);
  if (A.B <= 0) return 0;
  core_kernel<L, DM, S32><<<A.B, kCoreThreads, g.shm, (cudaStream_t)stream>>>(
      A);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// P3 above kCoreLanes: the wide launch
// ---------------------------------------------------------------------------
// The narrow kernel's row, cell and walk, for a window of any width: a job
// is a block of min(32, ceil(Wb / 128)) warps, and warp w takes the chunks
// w, w + warps, ... of 128 lanes in turn within a row (one chunk a warp up
// to 4,096 lanes).  The query block, the slide's rows, the walk's mirror
// and the chunk edges ([2][chunks][4]) live in a slot of global scratch a
// job (wide_geo's per_job bytes); where a warp holds several chunks, each
// chunk's state and packed dirs words wait in the slot between its turns,
// loaded before and stored after them, as K1's memory path keeps its slot
// state.  A row still has one barrier: a chunk's carry is the edge its
// left neighbour wrote the row before, whichever warp holds it.  The
// narrow kernel stays the timed one: its code does not change for this.

struct WideGeo {
  int q_off, sl_off, m_off, edge_off, st_off, per_job;
};

__host__ __device__ inline int wide_chunks(int Wb) {
  return (Wb + kChunk - 1) / kChunk;
}

__host__ __device__ inline int wide_warps(int Wb) {
  return wide_chunks(Wb) < kWideWarps ? wide_chunks(Wb) : kWideWarps;
}

__host__ __device__ inline WideGeo wide_geo(int L, bool s32, int Wb) {
  WideGeo g;
  int at = 0;
  const int nch = wide_chunks(Wb);
  g.q_off = core_take(at, L >= 6 ? Wb + 256 + 16 : 0);
  g.sl_off = core_take(at, L >= 5 ? 7 * Wb * (s32 ? 4 : 1) : 0);
  g.m_off = core_take(at, L >= 4 ? 2 * 2 * Wb * 4 : 0);
  g.edge_off = core_take(at, 2 * nch * 4 * 4);
  g.st_off = core_take(at, nch > wide_warps(Wb) ? 8 * nch * kChunk * 4 : 0);
  g.per_job = at;
  return g;
}

template <int L, int DM, bool S32>
__global__ void __launch_bounds__(32 * kWideWarps)
    core_wide_kernel(CoreArgs A) {
  using St = typename std::conditional<S32, int32_t, int8_t>::type;
  const int Wb = A.Wb, ROWS = A.ROWS, B = A.B, QR = Wb + 256;
  const WideGeo geo = wide_geo(L, S32, Wb);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            w = tid >> 5;
  // chunks of the window, warps of the block, chunks a warp
  const int NCH = wide_chunks(Wb), C = (int)(blockDim.x >> 5), NT = 32 * C;
  const int G = (NCH + C - 1) / C;
  uint8_t* slot = A.scratch + (int64_t)b * geo.per_job;
  int t0 = 0, nl = 0;                 // the current chunk's lanes
  const bool vec = (Wb & 3) == 0;     // rows keep 4-lane groups aligned
  const uint32_t* Q32 = (const uint32_t*)(slot + geo.q_off);
  St* Sl = (St*)(slot + geo.sl_off);
  int* mU = (int*)(slot + geo.m_off);       // [2][Wb]: u and v for the walk
  int* mV = mU + 2 * Wb;
  int* edge = (int*)(slot + geo.edge_off);  // [2][NCH][4]: x x2 v of a
                                            // chunk's last lane
  int* cst = (int*)(slot + geo.st_off);     // [8][NCH * 128]: held chunks
  const int SW = NCH * kChunk;
  uint8_t* dirs8 = (uint8_t*)A.dirs;
  int32_t* dirs32 = (int32_t*)A.dirs;

  int u[4], v[4], x[4], y[4], x2[4], y2[4], s[4];
  int pk[4];  // DM 2: the word being packed, per lane
#pragma unroll
  for (int q = 0; q < 4; ++q)
    u[q] = v[q] = x[q] = y[q] = x2[q] = y2[q] = s[q] = pk[q] = 0;
  auto ld4 = [&](int a, int (&r)[4]) {
    const int4 q = *(const int4*)(cst + a * SW + t0);
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  };
  auto st4 = [&](int a, const int (&r)[4]) {
    *(int4*)(cst + a * SW + t0) = make_int4(r[0], r[1], r[2], r[3]);
  };
  // chunk c's lanes, and its state from the slot where a warp holds
  // several chunks (ld), and back (st)
  auto ld = [&](int c) {
    t0 = kChunk * c + 4 * lane, nl = min(4, Wb - t0);
    if (G > 1) {
      ld4(0, u), ld4(1, v), ld4(2, x), ld4(3, y), ld4(4, x2);
      ld4(5, y2), ld4(6, s), ld4(7, pk);
    }
  };
  auto st = [&]() {
    if (G > 1) {
      st4(0, u), st4(1, v), st4(2, x), st4(3, y), st4(4, x2);
      st4(5, y2), st4(6, s), st4(7, pk);
    }
  };
  auto wrap8 = [&]() {  // the step's end: the state as int8
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      u[q] = (int8_t)u[q], v[q] = (int8_t)v[q], x[q] = (int8_t)x[q];
      y[q] = (int8_t)y[q], x2[q] = (int8_t)x2[q], y2[q] = (int8_t)y2[q];
      s[q] = (int8_t)s[q];
    }
  };
  // u and v of the chunk's lanes into mirror buffer p
  auto mirror = [&](int p) {
    put4(mU + p * Wb, t0, u, nl, vec), put4(mV + p * Wb, t0, v, nl, vec);
  };
  if (G > 1)  // every chunk starts from the zero state
    for (int c = w; c < NCH; c += C) {
      t0 = kChunk * c + 4 * lane;
      st();
    }

  const int ql = A.qlen[b];
  int mx = 0, H0 = 0, lH0t = 0, done = 0;
  long long ncell = L < 2 ? (long long)A.KR * ROWS * Wb : 0;
  int nrow = L < 2 ? A.KR * ROWS : 0;

  if (L >= 6) {  // the query block rolled by 7, and 16 zero bytes after it
    uint8_t* Q = slot + geo.q_off;
    const uint8_t* qb = A.qbuf + (int64_t)b * A.qstride;
    for (int i = tid; i < QR + 16; i += NT)
      Q[i] = i >= QR ? 0 : qb[i >= 7 ? i - 7 : i - 7 + QR];
  }
  if (L >= 1) {  // row 0's carries: the zero state
    for (int i = tid; i < 4 * NCH; i += NT) edge[4 * NCH + i] = 0;
    __syncthreads();
  }

  // fast: from the row after done (under DM 2, after its packed row) the
  // state no longer changes, as in the narrow kernel
  bool fast = false;
  int kfast = 0;
  for (int k = 0; k < A.KR; ++k) {
    const int r0 = k * ROWS;
    if (L >= 5 && r0 > 0) {
      // the slide: lane l takes lane l + 16, the last 16 lanes 0
      auto slide = [&](int a, const int (&r)[4]) {
        St* row = Sl + a * Wb;
        if (vec && nl == 4) {
          if (t0 >= 16) put4(row, t0 - 16, r, 4, true);
          if (t0 >= Wb - 16) put4(row, t0, {0, 0, 0, 0}, 4, true);
          return;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = t0 + q;
          if (q >= nl) break;
          if (t >= 16) row[t - 16] = (St)r[q];
          if (t >= Wb - 16) row[t] = 0;
        }
      };
      for (int c = w; c < NCH; c += C) {
        ld(c);
        slide(0, u), slide(1, v), slide(2, x), slide(3, y), slide(4, x2);
        slide(5, y2), slide(6, s);
      }
    }
    for (int j = 0; j < ROWS; ++j) {
      const int r = r0 + j, par = r & 1, jm = j & 3;
      const bool last = j == ROWS - 1;
      if (L >= 4 && fast) {
        // rows j .. ROWS - 1: their dirs as 16-byte zero stores (a store
        // a lane where Wb breaks their alignment) by every warp but warp
        // 0, then warp 0's walk
        constexpr int kUnit = DM == 1 ? 16 : 4;  // lanes a 16-byte store
        const int NS = NT - 32, ts = tid - 32;
        const bool zvec = Wb % kUnit == 0;
        if (DM != 0 && ts >= 0) {
          const int units = zvec ? Wb / kUnit : Wb;
          const int ra = DM == 1 ? r : (r + 3) >> 2;  // rows (packed rows)
          const int nr = (DM == 1 ? r0 + ROWS : (r0 + ROWS) >> 2) - ra;
          int jj = ts / units, c = ts % units;
          const int dj = NS / units, dc = NS % units;
          for (; jj < nr; jj += dj, c += dc) {
            if (c >= units) c -= units, ++jj;
            if (jj >= nr) break;
            const int64_t row = (int64_t)(ra + jj) * B + b;
            if (!zvec) {
              if (DM == 1) dirs8[row * Wb + c] = 0;
              else dirs32[row * Wb + c] = 0;
              continue;
            }
            uint4* at = (uint4*)(DM == 1 ? (void*)(dirs8 + row * Wb)
                                         : (void*)(dirs32 + row * Wb));
            at[c] = make_uint4(0, 0, 0, 0);
          }
        }
        if (w == 0) {  // warp 0 holds res
          const bool wrap = !S32 && k > kfast;
          auto at = [&](const int* m, int l) {
            if (l < 0 || l >= Wb) return kNeg;
            const int val = m[l];
            return max(wrap ? (int)(int8_t)val : val, kNeg);
          };
          int cv = at(mV, lH0t), cu = at(mU, wadd(lH0t, 1));
          for (int jj = j; jj < ROWS; ++jj) {
            const int l = lH0t, l1 = wadd(l, 1);
            const int nv = at(mV, l1), nu = at(mU, wadd(l, 2));
            walk_step(cv, cu, l1, mx, H0, lH0t, done);
            if (lH0t != l) cv = nv, cu = nu;
          }
        }
        if (!S32)
          for (int c = w; c < NCH; c += C) ld(c), wrap8(), st();
        break;
      }
      int lo = 0, hi = Wb - 1;  // the lanes this row computes
      if (L >= 2) {
        core_band(r, ql, Wb, lo, hi);
        if (done) hi = lo - 1;
        if (hi >= lo) ncell += hi - lo + 1, ++nrow;
      }
      for (int c = w; c < NCH; c += C) {
        ld(c);
        if (L == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u[q] = wadd(u[q], 1);
            opaque(u[q]);
          }
        } else {
          const int l0 = kChunk * c;
          uint32_t dw = 0;  // the u8 dirs of my 4 lanes
          if (L < 2 || (l0 <= hi && l0 + kChunk - 1 >= lo)) {
            // lane t0 - 1's old x, x2, v
            int cx = __shfl_up_sync(kFull, x[3], 1);
            int cx2 = __shfl_up_sync(kFull, x2[3], 1);
            int cv = __shfl_up_sync(kFull, v[3], 1);
            if (lane == 0 && c > 0) {
              const int* e = edge + ((par ^ 1) * NCH + c - 1) * 4;
              cx = e[0], cx2 = e[1], cv = e[2];
            }
            if (t0 == 0) cx = -6, cx2 = -25, cv = -6;
            const int px[4] = {cx, x[0], x[1], x[2]};
            const int px2[4] = {cx2, x2[0], x2[1], x2[2]};
            const int pv[4] = {cv, v[0], v[1], v[2]};
            uint32_t qw = 0;  // the query bytes of my 4 lanes
            if (L >= 6) {
              const int at = ROWS - 1 - j + t0;
              qw = __byte_perm(Q32[at >> 2], Q32[(at >> 2) + 1],
                               (at & 3) * 0x1111 + 0x3210);
            }
            if (L < 2 || (t0 >= lo && t0 <= hi))
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int t = t0 + q;
                const int uu = (L >= 2 && t == r) ? -6 : u[q];
                const int sc =
                    L >= 6 ? ((int)((qw >> (8 * q)) & 255) == s[q] ? 2 : -4)
                           : wadd(s[q], 1);
                const int a = wadd(px[q], pv[q]), bb = wadd(y[q], uu);
                const int a2 = wadd(px2[q], pv[q]), b2 = wadd(y2[q], uu);
                int z = sc, d = 0;
                if (L >= 3) {
                  d = z > a ? 0 : 1;
                  z = max(z, a);
                  d = z > bb ? d : 2;
                  z = max(z, bb);
                  d = z > a2 ? d : 3;
                  z = max(z, a2);
                  d = z > b2 ? d : 4;
                  z = max(z, b2);
                } else {
                  z = max(max(max(z, a), max(bb, a2)), b2);
                }
                z = min(z, 2);
                const int zq = z - 6, zq2 = z - 25;
                const int an = wsub(a, zq), bn = wsub(bb, zq);
                const int a2n = wsub(a2, zq2), b2n = wsub(b2, zq2);
                u[q] = wsub(z, pv[q]);
                v[q] = wsub(z, uu);
                x[q] = max(an, 0) - 8;
                y[q] = max(bn, 0) - 8;
                x2[q] = max(a2n, 0) - 26;
                y2[q] = max(b2n, 0) - 26;
                s[q] = sc;
                if (L >= 3)
                  dw |= (uint32_t)(d | (an > 0 ? 8 : 0) | (bn > 0 ? 16 : 0) |
                                   (a2n > 0 ? 32 : 0) | (b2n > 0 ? 64 : 0))
                        << (8 * q);
              }
          }
          if (L >= 3 && DM == 1) {  // dirs are 0 outside the band
            uint8_t* at = dirs8 + ((int64_t)r * B + b) * Wb + t0;
            if (vec && nl == 4)
              *(uint32_t*)at = dw;
            else
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (q < nl) at[q] = (uint8_t)(dw >> (8 * q));
          }
          if (L >= 3 && DM == 2) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int dv = (int)((dw >> (8 * q)) & 255);
              pk[q] = jm == 0 ? dv : (pk[q] | dv << (8 * jm));
            }
            if (jm == 3)
              put4(dirs32 + ((int64_t)(r >> 2) * B + b) * Wb, t0, pk, nl,
                   vec);
          }
        }
        if (L >= 4) mirror(par);
        if (!S32 && last) wrap8();
        if (L >= 1 && lane == 31) {
          int* e = edge + (par * NCH + c) * 4;
          e[0] = x[3], e[1] = x2[3], e[2] = v[3];
        }
        st();
      }
      if (L >= 1) __syncthreads();
      if (L >= 4) {
        const int l1 = wadd(lH0t, 1);
        const int* wU = mU + par * Wb;
        const int* wV = mV + par * Wb;
        const int d0 = lH0t >= 0 && lH0t < Wb ? max(wV[lH0t], kNeg) : kNeg;
        const int d1 = l1 >= 0 && l1 < Wb ? max(wU[l1], kNeg) : kNeg;
        walk_step(d0, d1, l1, mx, H0, lH0t, done);
        if (done && (DM != 2 || jm == 3)) {  // the rows left are fast
          __syncthreads();  // every warp has read the mirror
          for (int c = w; c < NCH; c += C)
            ld(c), mirror(0);  // this step's state (wrapped if it ended)
          __syncthreads();
          fast = true;
          kfast = k;
        }
      }
    }
  }

  St* out = (St*)A.state;
  for (int c = w; c < NCH; c += C) {
    ld(c);
    auto put = [&](int a, const int (&r)[4]) {
      put4(out + ((int64_t)a * B + b) * Wb, t0, r, nl, vec);
    };
    put(0, u), put(1, v), put(2, x), put(3, y), put(4, x2), put(5, y2);
    put(6, s);
  }
  if (tid < 16)
    A.res[b * 16 + tid] = tid == 0   ? mx
                          : tid == 1 ? H0
                          : tid == 2 ? lH0t
                          : tid == 3 ? done
                                     : 0;
  if (tid == 0 && A.work) A.work[2 * b] = ncell, A.work[2 * b + 1] = nrow;
}

// Launches (or, with `blocks`, asks the occupancy of) one instantiation:
// a block a job, a warp a chunk up to kWideWarps, a scratch slot a job.
template <int L, int DM, bool S32>
int wide_run(const CoreArgs& A, int* blocks, void* stream) {
  const int threads = 32 * wide_warps(A.Wb);
  if (blocks)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, core_wide_kernel<L, DM, S32>, threads, 0);
  if (A.B <= 0) return 0;
  if (A.scratch == nullptr ||
      A.scratch_bytes < (long long)A.B * wide_geo(L, S32, A.Wb).per_job)
    return (int)cudaErrorInvalidValue;
  core_wide_kernel<L, DM, S32><<<A.B, threads, 0, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// the narrow launch up to kCoreLanes, the wide one above
template <int L, int DM, bool S32>
int core_width(const CoreArgs& A, int* blocks, void* stream) {
  if (A.Wb < 1 || A.Wb > kWideLanesMax) return (int)cudaErrorInvalidValue;
  return A.Wb <= kCoreLanes ? core_run<L, DM, S32>(A, blocks, stream)
                            : wide_run<L, DM, S32>(A, blocks, stream);
}

template <int L>
int core_pick(int dm, int s32, const CoreArgs& A, int* blocks, void* stream) {
  auto pick_s = [&](auto dmc) {
    constexpr int D = decltype(dmc)::value;
    return s32 ? core_width<L, D, true>(A, blocks, stream)
               : core_width<L, D, false>(A, blocks, stream);
  };
  if constexpr (L >= 3) {
    if (dm == 1) return pick_s(std::integral_constant<int, 1>());
    if (dm == 2) return pick_s(std::integral_constant<int, 2>());
  }
  return pick_s(std::integral_constant<int, 0>());  // no dirs below 3
}

int core_level(int level, int dm, int s32, const CoreArgs& A, int* blocks,
               void* stream) {
  switch (level) {
    case 0: return core_pick<0>(dm, s32, A, blocks, stream);
    case 1: return core_pick<1>(dm, s32, A, blocks, stream);
    case 2: return core_pick<2>(dm, s32, A, blocks, stream);
    case 3: return core_pick<3>(dm, s32, A, blocks, stream);
    case 4: return core_pick<4>(dm, s32, A, blocks, stream);
    case 5: return core_pick<5>(dm, s32, A, blocks, stream);
    case 6: return core_pick<6>(dm, s32, A, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// P2: the state floor (probe_l0.py run)
// ---------------------------------------------------------------------------
// A block a job, a thread a 32-bit word (4 lanes) of each state array, in a
// register: array 0's word takes a bytewise +1 a step, threads 0-15 hold
// the job's accumulators.  A step has no cross-lane dependence, so no
// barrier; opaque() keeps each step's round trip in the loop.  Without
// touch the loop is empty: the launch's own floor.  Arrays 1 .. nstate - 1
// never change, so they never enter the loop: nstate scales only the final
// zero stores, not a step's work.
__global__ void __launch_bounds__(1024)
    l0_kernel(int32_t* res, int8_t* state, int nstate, int touch,
              int read_acc, int B, int Wb, int KR) {
  const int b = blockIdx.x, i = threadIdx.x;
  uint32_t w0 = 0;  // array 0's lanes 4i .. 4i + 3
  int acc = 0;      // accumulator i (i < 16)
  if (touch)
    for (int k = 0; k < KR; ++k) {
      w0 = __vadd4(w0, 0x01010101u);
      if (read_acc) acc = wadd(acc, 1);
      opaque(w0);
      opaque(acc);
    }
  if (4 * i < Wb)
    for (int a = 0; a < nstate; ++a) {
      const uint32_t word = a == 0 ? w0 : 0;
      int8_t* row = state + ((int64_t)a * B + b) * Wb;
      if (Wb % 4 == 0) {
        *(uint32_t*)(row + 4 * i) = word;
      } else {
        for (int j = 0; j < 4 && 4 * i + j < Wb; ++j)
          row[4 * i + j] = (int8_t)(word >> (8 * j));
      }
    }
  if (i < 16) res[b * 16 + i] = acc;
}

// ---------------------------------------------------------------------------
// P1: the step-body bisection (probe_bisect.py main's bodies)
// ---------------------------------------------------------------------------
enum Body {
  kEmpty = 0,
  kRwAstype = 1,
  kRwI8 = 2,
  kRwLoop32 = 3,
  kDirsStore = 4,
  kRolls = 5,
  kReduces = 6
};

template <int BODY>
__global__ void __launch_bounds__(128)
    bisect_kernel(int32_t* res, uint8_t* dirs, int8_t* state, int B, int Wb,
                  int ROWS, int KR) {
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* S = (int8_t*)smem;  // 7 rows of Wb
  __shared__ long long wkey[2][32];
  __shared__ int xw[2][33];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 7 * Wb; i += nthr) S[i] = 0;
  int t = 0;  // acc[0], the reduce's walk
  // rolls: my segment of array 0, [lo, lo + n), in registers
  const int K = (Wb + nthr - 1) / nthr, lo = tid * K;
  const int n = max(0, min(K, Wb - lo));
  const int T = (Wb - 1) / K;  // the thread holding lane Wb - 1

  for (int k = 0; k < KR; ++k) {
    __syncthreads();
    if (BODY == kRwAstype || BODY == kRwI8) {
      for (int i = tid; i < 7 * Wb; i += nthr) S[i] = (int8_t)(S[i] + 1);
    } else if (BODY == kRwLoop32) {
      for (int i = tid; i < 7 * Wb; i += nthr) {
        int v = S[i];
        for (int j = 0; j < 32; ++j) v = wadd(v, 1);
        S[i] = (int8_t)v;
      }
    } else if (BODY == kDirsStore) {
      for (int l = tid; l < Wb; l += nthr) {
        const int v = S[l];
        for (int j = 0; j < 32; ++j)
          dirs[((int64_t)(k * ROWS + j) * B + b) * Wb + l] = (uint8_t)(v + j);
      }
    } else if (BODY == kRolls) {
      int seg[kMaxSeg];
#pragma unroll
      for (int i = 0; i < kMaxSeg; ++i) seg[i] = i < n ? S[lo + i] : 0;
      for (int j = 0; j < 32; ++j) {
        // roll by one lane: my first lane takes the lane before it (lane
        // Wb - 1 for lane 0): a shuffle inside the warp, shared memory
        // across warps (two slots, so one barrier a roll)
        int last = 0;
#pragma unroll
        for (int i = 0; i < kMaxSeg; ++i)
          if (i == n - 1) last = seg[i];
        const int p = j & 1;
        if (lane == 31) xw[p][warp] = last;
        if (tid == T) xw[p][32] = last;
        int prev = __shfl_up_sync(0xffffffffu, last, 1);
        __syncthreads();
        if (lane == 0) prev = warp == 0 ? xw[p][32] : xw[p][warp - 1];
#pragma unroll
        for (int i = kMaxSeg - 1; i > 0; --i) seg[i] = wadd(seg[i - 1], 1);
        seg[0] = wadd(prev, 1);
      }
#pragma unroll
      for (int i = 0; i < kMaxSeg; ++i)
        if (i < n) S[lo + i] = (int8_t)seg[i];
    } else if (BODY == kReduces) {
      // t += max over lanes of (lane == t ? v : -10**9), as a block-wide
      // max reduction (two key buffers, so one barrier a reduction)
      for (int j = 0; j < 32; ++j) {
        long long best = LLONG_MIN;
        for (int l = tid; l < Wb; l += nthr) {
          const long long key = l == t ? (long long)S[l] : (long long)kNeg;
          if (key > best) best = key;
        }
        t = wadd(t, (int)block_max_key(best, wkey[j & 1]));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 7 * Wb; i += nthr)
    state[((int64_t)(i / Wb) * B + b) * Wb + i % Wb] = S[i];
  if (tid < 16) res[b * 16 + tid] = tid == 0 ? t : 0;
}

template <int BODY>
int bisect_run(int32_t* res, uint8_t* dirs, int8_t* state, int B, int Wb,
               int ROWS, int KR, void* stream) {
  const size_t shm = (size_t)7 * Wb;
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(bisect_kernel<BODY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  bisect_kernel<BODY><<<B, 128, shm, (cudaStream_t)stream>>>(
      res, dirs, state, B, Wb, ROWS, KR);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wm_probe_core_launch(int level, int dirs_mode, int s32,
                                    const void* qbuf, int qstride,
                                    const void* qlen, void* res, void* dirs,
                                    void* state, void* work, int B, int Wb,
                                    int ROWS, int KR, void* scratch,
                                    long long scratch_bytes, void* stream) {
  const CoreArgs A{(const uint8_t*)qbuf, qstride, (const int32_t*)qlen,
                   (int32_t*)res, dirs, state, (long long*)work, B, Wb,
                   ROWS, KR, (uint8_t*)scratch, scratch_bytes};
  return core_level(level, dirs_mode, s32, A, nullptr, stream);
}

// The scratch bytes a job of the core kernel at (level, s32, Wb) takes:
// 0 up to 640 lanes, else its slot of the wide launch.
extern "C" int wm_probe_core_scratch(int level, int s32, int Wb,
                                     long long* bytes) {
  if (level < 0 || level > 6 || Wb < 1 || Wb > kWideLanesMax)
    return (int)cudaErrorInvalidValue;
  *bytes = Wb > kCoreLanes ? wide_geo(level, s32 != 0, Wb).per_job : 0;
  return 0;
}

// Blocks (jobs) of the core kernel at (level, dirs_mode, s32, Wb) one SM
// holds.
extern "C" int wm_probe_core_occupancy(int level, int dirs_mode, int s32,
                                       int Wb, int* blocks) {
  CoreArgs A{};
  A.Wb = Wb;
  return core_level(level, dirs_mode, s32, A, blocks, nullptr);
}

// P2: a block a job, a thread a word (Wb <= 4096)
extern "C" int wm_probe_l0_launch(void* res, void* state, int nstate,
                                  int touch, int read_acc, int B, int Wb,
                                  int KR, void* stream) {
  const int words = (Wb + 3) / 4;
  if (Wb < 1 || words > 1024) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int threads = words > 32 ? (words + 31) / 32 * 32 : 32;
  l0_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)res, (int8_t*)state, nstate, touch, read_acc, B, Wb, KR);
  return (int)cudaGetLastError();
}

extern "C" int wm_probe_bisect_launch(int body, void* res, void* dirs,
                                      void* state, int B, int Wb, int ROWS,
                                      int KR, void* stream) {
  int32_t* r = (int32_t*)res;
  uint8_t* d = (uint8_t*)dirs;
  int8_t* s = (int8_t*)state;
  switch (body) {
    case kEmpty: return bisect_run<kEmpty>(r, d, s, B, Wb, ROWS, KR, stream);
    case kRwAstype:
      return bisect_run<kRwAstype>(r, d, s, B, Wb, ROWS, KR, stream);
    case kRwI8: return bisect_run<kRwI8>(r, d, s, B, Wb, ROWS, KR, stream);
    case kRwLoop32:
      return bisect_run<kRwLoop32>(r, d, s, B, Wb, ROWS, KR, stream);
    case kDirsStore:
      return bisect_run<kDirsStore>(r, d, s, B, Wb, ROWS, KR, stream);
    case kRolls: return bisect_run<kRolls>(r, d, s, B, Wb, ROWS, KR, stream);
    case kReduces:
      return bisect_run<kReduces>(r, d, s, B, Wb, ROWS, KR, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wm_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
