// P1-P3: cost probes of the extension-DP kernels on Hopper.
//
// Replace the TPU probes tests/tools/probe_bisect.py (run, pallas_call at
// :48), tests/tools/probe_l0.py (run, pallas_call at :55) and
// tests/tools/probe_core.py (build :30, run_level's pallas_call at :222).
// Their outputs are those probes' outputs, exactly; the plain versions are
// in winnowmap_tpu_torch/tools/probe_{bisect,l0,core}.py.
//
// What they measure: not bytes nor arithmetic but the fixed costs of the
// row structure K1 first had (before ext_kernel kept its ring slots in
// registers): one block of 128 threads per job, the state rows in shared
// memory, a carry read, a barrier, the cells of each thread's segment of
// consecutive lanes, a second barrier.
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

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// ---------------------------------------------------------------------------
// P3: the ladder of stripped extd step kernels (probe_core.py build)
// ---------------------------------------------------------------------------
// level 0 state round trip, 1 + the recurrence, 2 + band masks, 3 + dirs,
// 4 + the approx-max / z-drop walk, 5 + the window slide, 6 + the query
// slice.  DM: dirs 0 none, 1 uint8 rows, 2 int32 words of 4 rows (row j
// at bits 8 (j % 4)).  S32: the state rows are int32 (no wrap).

struct CoreArgs {
  const uint8_t* qbuf;
  int qstride;
  const int32_t* qlen;
  int32_t* res;
  void* dirs;
  void* state;
  long long* work;  // computed cells and rows per job, or null
  int B, Wb, ROWS, KR;
};

__host__ __device__ inline size_t core_smem(int Wb, bool s32) {
  // 7 int32 working rows, the packed dirs row, 7 state rows, the query
  // block (Wb + 256 bytes), each 16-byte aligned
  const size_t w = (size_t)8 * Wb * 4;
  const size_t s = ((size_t)7 * Wb * (s32 ? 4 : 1) + 15) / 16 * 16;
  return w + s + ((size_t)Wb + 256 + 15) / 16 * 16;
}

template <int L, int DM, bool S32>
__global__ void __launch_bounds__(128) core_kernel(CoreArgs A) {
  using St = typename std::conditional<S32, int32_t, int8_t>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int Wb = A.Wb, ROWS = A.ROWS, B = A.B, QR = Wb + 256;
  // the i32 values of a step: u v x y x2 y2 s (the TPU's vregs)
  int32_t* W = (int32_t*)smem;
  int32_t *U = W, *V = W + Wb, *X = W + 2 * Wb, *Y = W + 3 * Wb,
          *X2 = W + 4 * Wb, *Y2 = W + 5 * Wb, *Sc = W + 6 * Wb;
  int32_t* Pk = W + 7 * Wb;  // DM 2: the word being packed, per lane
  St* S = (St*)(smem + (size_t)8 * Wb * 4);  // state between steps
  uint8_t* Q = smem + core_smem(Wb, S32) - ((size_t)Wb + 256 + 15) / 16 * 16;
  uint8_t* dirs8 = (uint8_t*)A.dirs;
  int32_t* dirs32 = (int32_t*)A.dirs;

  const int ql = A.qlen[b];
  for (int i = tid; i < 7 * Wb; i += nthr) S[i] = 0;
  int mx = 0, H0 = 0, lH0t = 0, done = 0;
  long long ncell = L < 2 ? (long long)A.KR * ROWS * Wb : 0;
  int nrow = L < 2 ? A.KR * ROWS : 0;

  for (int k = 0; k < A.KR; ++k) {
    const int r0 = k * ROWS;
    __syncthreads();  // last step's reads of W are over
    for (int i = tid; i < 7 * Wb; i += nthr) W[i] = (int32_t)S[i];
    if (L >= 6)  // the query block rolled by 7: roll(qbuf[:, :QR], 7)
      for (int i = tid; i < QR; i += nthr)
        Q[i] = A.qbuf[(int64_t)b * A.qstride + (i >= 7 ? i - 7 : i - 7 + QR)];
    __syncthreads();
    if (L >= 5 && r0 > 0)  // the slide: the step's end overwrites it
      for (int i = tid; i < 7 * Wb; i += nthr)
        S[i] = (i % Wb) >= Wb - 16 ? (St)0 : (St)W[i + 16];

    if (L == 0) {
      for (int j = 0; j < ROWS; ++j)
        for (int l = tid; l < Wb; l += nthr) U[l] = wadd(U[l], 1);
    } else {
      for (int j = 0; j < ROWS; ++j) {
        const int r = r0 + j;
        int lo = 0, hi = Wb - 1;  // the lanes this row computes
        if (L >= 2) {
          const int st0 = max(max(0, r - ql + 1), (r - 500) >> 1);
          const int en0 = min(min(ql - 1, r), (r + 501) >> 1);
          lo = max((st0 >> 4) * 16, 0);
          hi = min(((en0 + 16) >> 4) * 16 - 1, Wb - 1);
          if (done) hi = lo - 1;
          if (hi >= lo) ncell += hi - lo + 1, ++nrow;
        }
        const int n = hi - lo + 1;
        const int K = n > 0 ? (n + nthr - 1) / nthr : 0;
        const int t_lo = lo + tid * K;
        const int t_hi = min(t_lo + K - 1, hi);
        // phase A: the carry into my segment's first lane
        int cx = -6, cx2 = -25, cv = -6;
        if (t_lo <= t_hi && t_lo > 0)
          cx = X[t_lo - 1], cx2 = X2[t_lo - 1], cv = V[t_lo - 1];
        __syncthreads();
        // phase B: my segment's cells in lane order
        const int jm = j & 3;
        for (int t = t_lo; t <= t_hi; ++t) {
          const int u = U[t], sv = Sc[t];
          const int uu = (L >= 2 && t == r) ? -6 : u;
          const int sc = L >= 6 ? ((int)Q[ROWS - 1 - j + t] == sv ? 2 : -4)
                                : wadd(sv, 1);
          const int xt1 = cx, x2t1 = cx2, vt1 = cv;
          cx = X[t], cx2 = X2[t], cv = V[t];
          const int a = wadd(xt1, vt1), bb = wadd(Y[t], uu);
          const int a2 = wadd(x2t1, vt1), b2 = wadd(Y2[t], uu);
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
          U[t] = wsub(z, vt1);
          V[t] = wsub(z, uu);
          const int zq = z - 6, zq2 = z - 25;
          const int an = wsub(a, zq), bn = wsub(bb, zq);
          const int a2n = wsub(a2, zq2), b2n = wsub(b2, zq2);
          X[t] = (an > 0 ? an : 0) - 8;
          Y[t] = (bn > 0 ? bn : 0) - 8;
          X2[t] = (a2n > 0 ? a2n : 0) - 26;
          Y2[t] = (b2n > 0 ? b2n : 0) - 26;
          Sc[t] = sc;
          if (L >= 3) {
            d |= (an > 0 ? 8 : 0) | (bn > 0 ? 16 : 0) | (a2n > 0 ? 32 : 0) |
                 (b2n > 0 ? 64 : 0);
            if (DM == 1)
              dirs8[((int64_t)r * B + b) * Wb + t] = (uint8_t)d;
            else if (DM == 2)
              Pk[t] = jm == 0 ? d : (Pk[t] | (d << (8 * jm)));
          }
        }
        if (L >= 3 && DM != 0)  // dirs are 0 outside the band
          for (int l = tid; l < Wb; l += nthr)
            if (l < lo || l > hi) {
              if (DM == 1)
                dirs8[((int64_t)r * B + b) * Wb + l] = 0;
              else if (jm == 0)
                Pk[l] = 0;
            }
        __syncthreads();
        if (L >= 3 && DM == 2 && jm == 3)
          for (int l = tid; l < Wb; l += nthr)
            dirs32[((int64_t)(r >> 2) * B + b) * Wb + l] = Pk[l];
        if (L >= 4) {
          // the H0 walk: v[lH0t] and u[lH0t + 1], -10**9 off the lanes
          const int l1 = wadd(lH0t, 1);
          const int d0 = (lH0t >= 0 && lH0t < Wb) ? max(V[lH0t], kNeg) : kNeg;
          const int d1 = (l1 >= 0 && l1 < Wb) ? max(U[l1], kNeg) : kNeg;
          H0 = wadd(H0, max(d0, d1));
          if (d1 > d0) lH0t = l1;
          if (H0 > mx)
            mx = H0;
          else if (wsub(mx, H0) > 400)
            done = 1;
        }
      }
    }
    // the step's end: the state as int8 (as int32 under S32)
    for (int i = tid; i < 7 * Wb; i += nthr) S[i] = (St)W[i];
  }

  St* out = (St*)A.state;
  for (int i = tid; i < 7 * Wb; i += nthr)
    out[((int64_t)(i / Wb) * B + b) * Wb + i % Wb] = S[i];
  if (tid < 16)
    A.res[b * 16 + tid] = tid == 0   ? mx
                          : tid == 1 ? H0
                          : tid == 2 ? lH0t
                          : tid == 3 ? done
                                     : 0;
  if (tid == 0 && A.work) A.work[2 * b] = ncell, A.work[2 * b + 1] = nrow;
}

// Launches (or, with `blocks`, asks the occupancy of) one instantiation.
template <int L, int DM, bool S32>
int core_run(const CoreArgs& A, int* blocks, void* stream) {
  const size_t shm = core_smem(A.Wb, S32);
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(core_kernel<L, DM, S32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (blocks)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, core_kernel<L, DM, S32>, 128, shm);
  if (A.B <= 0) return 0;
  core_kernel<L, DM, S32><<<A.B, 128, shm, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

template <int L, int DM>
int core_pick_s(int s32, const CoreArgs& A, int* blocks, void* stream) {
  return s32 ? core_run<L, DM, true>(A, blocks, stream)
             : core_run<L, DM, false>(A, blocks, stream);
}

template <int L>
int core_pick(int dm, int s32, const CoreArgs& A, int* blocks, void* stream) {
  if constexpr (L < 3) {
    return core_pick_s<L, 0>(s32, A, blocks, stream);  // no dirs below 3
  } else {
    if (dm == 1) return core_pick_s<L, 1>(s32, A, blocks, stream);
    if (dm == 2) return core_pick_s<L, 2>(s32, A, blocks, stream);
    return core_pick_s<L, 0>(s32, A, blocks, stream);
  }
}

int core_dispatch(int level, int dm, int s32, const CoreArgs& A, int* blocks,
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
__global__ void __launch_bounds__(128)
    l0_kernel(int32_t* res, int8_t* state, int nstate, int touch,
              int read_acc, int B, int Wb, int KR) {
  extern __shared__ __align__(16) uint8_t smem[];
  volatile int8_t* S = (volatile int8_t*)smem;  // nstate rows of Wb
  __shared__ int acc[16];
  const int b = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < nstate * Wb; i += nthr) S[i] = 0;
  if (tid < 16) acc[tid] = 0;
  for (int k = 0; k < KR; ++k) {
    __syncthreads();
    if (!touch) continue;
    for (int i = tid; i < nstate * Wb; i += nthr) {
      int v = S[i];
      if (i < Wb) v = wadd(v, 1);  // array 0 only
      S[i] = (int8_t)v;
    }
    if (read_acc && tid < 16) acc[tid] = wadd(acc[tid], 1);
  }
  for (int i = tid; i < nstate * Wb; i += nthr)
    state[((int64_t)(i / Wb) * B + b) * Wb + i % Wb] = S[i];
  if (tid < 16) res[b * 16 + tid] = acc[tid];
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
                                    int ROWS, int KR, void* stream) {
  const CoreArgs A{(const uint8_t*)qbuf, qstride, (const int32_t*)qlen,
                   (int32_t*)res, dirs, state, (long long*)work, B, Wb,
                   ROWS, KR};
  return core_dispatch(level, dirs_mode, s32, A, nullptr, stream);
}

// Blocks of the core kernel at (level, dirs_mode, s32, Wb) one SM holds.
extern "C" int wm_probe_core_occupancy(int level, int dirs_mode, int s32,
                                       int Wb, int* blocks) {
  CoreArgs A{};
  A.Wb = Wb;
  return core_dispatch(level, dirs_mode, s32, A, blocks, nullptr);
}

extern "C" int wm_probe_l0_launch(void* res, void* state, int nstate,
                                  int touch, int read_acc, int B, int Wb,
                                  int KR, void* stream) {
  const size_t shm = (size_t)nstate * Wb;
  cudaError_t err = cudaSuccess;
  if (shm > 48 * 1024)
    err = cudaFuncSetAttribute(l0_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  l0_kernel<<<B, 128, shm, (cudaStream_t)stream>>>(
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
