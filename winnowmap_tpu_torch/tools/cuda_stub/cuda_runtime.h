// A stand-in for the CUDA runtime that lets g++ (-std=c++20) compile the
// port's .cu sources and run their kernels on the CPU, for rehearsing a
// kernel against its plain PyTorch version without a card.  Used by
// tools/cuda_stub/__init__.py, which rewrites what the preprocessor cannot
// (the <<<...>>> launch and `extern __shared__`) before compiling.
//
// The model: a launch runs its blocks one after another; a block runs one
// fiber per CUDA thread, all on the calling OS thread, switched at barriers
// only, so a run is deterministic and takes one core.  A fiber starts on
// its own stack by setcontext and is switched by _setjmp/_longjmp, which
// save no signal mask (compile with -U_FORTIFY_SOURCE: the fortified
// longjmp refuses a jump to another stack).  __syncthreads() is a barrier over the block's
// fibers, __syncwarp() one over the warp's 32.  The next fiber to run is
// the longest waiting one, or, after cuda_stub_schedule(seed) with a seed
// other than 0, one picked at random from the runnable ones, each warp of
// a block weighted by a random power of two up to 64 (a seeded generator,
// so a seed's run is still deterministic): a test then tries orders where
// one warp runs far ahead of another it waits on through memory.  A warp operation
// (shuffles, votes, reductions) writes each lane's value into a per-warp
// array, passes the warp's barrier, and reads what it needs; the array is
// double-buffered, so one barrier an operation suffices (the writes of
// operation n + 2 wait for every lane to pass operation n + 1, after its
// reads of operation n).  Every warp operation must be reached by all 32
// lanes, as the full masks the kernels pass require; any other mask
// aborts, and so does a barrier that some thread never reaches (the block
// runs out of runnable fibers).  __shared__ variables are `static` (one
// copy, and one block at a time) and dynamic shared memory is a per-block
// buffer filled with 0xA5, so a read before a write shows.
#pragma once

#include <setjmp.h>
#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct int2 {
  int x, y;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum : int { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// the running fiber's indices (one fiber runs at a time)
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace stub {

constexpr size_t kStack = 256 * 1024;

struct Fiber {
  ucontext_t ctx;  // the fiber's start
  jmp_buf jb;      // where it waits
  std::unique_ptr<char[]> stack;
  int phase = 0;  // which half of the warp's exchange array is next
  bool started = false, done = false;
};

struct Block;
inline Block* block_;

class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait();

 private:
  int n_, arrived_ = 0;
  std::vector<int> waiting_;
};

struct Warp {
  Barrier bar{32};
  uint64_t buf[2][32];
};

struct Block {
  Barrier bar;
  std::vector<Warp> warps;
  std::vector<uint8_t> dyn;
  std::vector<Fiber> fibers;
  std::deque<int> runq;
  int cur = -1;
  jmp_buf main;
  std::function<void()>* body;
  Block(int n, size_t shm)
      : bar(n), warps((n + 31) / 32), dyn(shm, 0xA5), fibers(n) {}

  // back to the scheduler; returns when this fiber runs again
  void yield() {
    if (!_setjmp(fibers[cur].jb)) _longjmp(main, 1);
  }
};

inline void Barrier::wait() {
  if (++arrived_ == n_) {
    arrived_ = 0;
    for (int i : waiting_) block_->runq.push_back(i);
    waiting_.clear();
    return;
  }
  waiting_.push_back(block_->cur);
  block_->yield();
}

inline int last_error = cudaSuccess;

// 0: fibers run in the order they became runnable; else the seed of the
// random order (see the header's note)
inline uint64_t sched_seed = 0;

inline void full_mask(unsigned m) {
  if (m != 0xffffffffu) {
    std::fprintf(stderr, "cuda_stub: warp operation with mask %#x\n", m);
    std::abort();
  }
}

template <class T>
inline uint64_t bits(T v) {
  uint64_t r = 0;
  std::memcpy(&r, &v, sizeof(T));
  return r;
}
template <class T>
inline T from_bits(uint64_t r) {
  T v;
  std::memcpy(&v, &r, sizeof(T));
  return v;
}

// every lane's value of one warp operation
inline const uint64_t* exchange(unsigned mask, uint64_t v) {
  full_mask(mask);
  const int t = block_->cur;
  Warp& w = block_->warps[t >> 5];
  int& ph = block_->fibers[t].phase;
  uint64_t* b = w.buf[ph];
  ph ^= 1;
  b[t & 31] = v;
  w.bar.wait();
  return b;
}

inline uint8_t* dyn_smem() { return block_->dyn.data(); }

inline void fiber_entry() {
  (*block_->body)();
  block_->fibers[block_->cur].done = true;
  _longjmp(block_->main, 1);
}

// runs body() as grid x block threads: blocks in order, a fiber each
template <class F>
void launch(F body, dim3 grid, dim3 block, size_t shm = 0,
            cudaStream_t = nullptr) {
  const int n = (int)(block.x * block.y * block.z);
  if (n % 32 != 0) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  std::function<void()> fn = body;
  for (unsigned b = 0; b < grid.x; ++b) {
    Block blk(n, shm);
    blk.body = &fn;
    block_ = &blk;
    blockIdx = dim3(b);
    blockDim = block;
    gridDim = grid;
    for (int t = 0; t < n; ++t) {
      Fiber& f = blk.fibers[t];
      f.stack.reset(new char[kStack]);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, fiber_entry, 0);
      blk.runq.push_back(t);
    }
    uint64_t rs = sched_seed ? sched_seed * 0x9E3779B97F4A7C15ull + b : 0;
    auto rnd = [&rs] {  // xorshift64
      rs ^= rs << 13;
      rs ^= rs >> 7;
      rs ^= rs << 17;
      return rs;
    };
    std::vector<uint64_t> weight(blk.warps.size(), 1);
    if (rs)
      for (uint64_t& w : weight) w = uint64_t(1) << (rnd() % 7);
    while (!blk.runq.empty()) {
      size_t at = 0;
      if (rs) {
        uint64_t total = 0;
        for (int t : blk.runq) total += weight[t >> 5];
        uint64_t r = rnd() % total;
        while (r >= weight[blk.runq[at] >> 5]) r -= weight[blk.runq[at++] >> 5];
      }
      blk.cur = blk.runq[at];
      blk.runq.erase(blk.runq.begin() + (long)at);
      threadIdx = dim3((unsigned)blk.cur);
      Fiber& f = blk.fibers[blk.cur];
      if (!_setjmp(blk.main)) {
        if (!f.started) {
          f.started = true;
          setcontext(&f.ctx);
        }
        _longjmp(f.jb, 1);
      }
    }
    for (const Fiber& f : blk.fibers)
      if (!f.done) {
        std::fprintf(stderr, "cuda_stub: block %u deadlocked (a barrier or "
                     "warp operation some thread never reaches)\n", b);
        std::abort();
      }
    block_ = nullptr;
  }
}

}  // namespace stub

// the stub's order of fibers (see the header's note); 0 restores the
// default order
extern "C" void cuda_stub_schedule(unsigned long long seed) {
  stub::sched_seed = seed;
}

inline void __syncthreads() { stub::block_->bar.wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  stub::exchange(mask, 0);
}

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src) {
  return stub::from_bits<T>(stub::exchange(mask, stub::bits(v))[src & 31]);
}
template <class T>
inline T __shfl_up_sync(unsigned mask, T v, unsigned d) {
  const uint64_t* b = stub::exchange(mask, stub::bits(v));
  const unsigned l = threadIdx.x & 31;
  return l >= d ? stub::from_bits<T>(b[l - d]) : v;
}
template <class T>
inline T __shfl_down_sync(unsigned mask, T v, unsigned d) {
  const uint64_t* b = stub::exchange(mask, stub::bits(v));
  const unsigned l = threadIdx.x & 31;
  return l + d < 32 ? stub::from_bits<T>(b[l + d]) : v;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int m) {
  const uint64_t* b = stub::exchange(mask, stub::bits(v));
  return stub::from_bits<T>(b[(threadIdx.x ^ m) & 31]);
}
inline unsigned __ballot_sync(unsigned mask, int p) {
  const uint64_t* b = stub::exchange(mask, p != 0);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)(b[i] != 0) << i;
  return r;
}
// the lanes whose v equals this lane's
template <class T>
inline unsigned __match_any_sync(unsigned mask, T v) {
  const uint64_t* b = stub::exchange(mask, stub::bits(v));
  const uint64_t me = b[threadIdx.x & 31];
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)(b[i] == me) << i;
  return r;
}
inline int __any_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) != 0;
}
inline int __all_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) == 0xffffffffu;
}
template <class T, class Op>
inline T reduce_(unsigned mask, T v, Op op) {
  const uint64_t* b = stub::exchange(mask, stub::bits(v));
  T r = stub::from_bits<T>(b[0]);
  for (int i = 1; i < 32; ++i) r = op(r, stub::from_bits<T>(b[i]));
  return r;
}
inline int __reduce_max_sync(unsigned mask, int v) {
  return reduce_(mask, v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return reduce_(mask, v,
                 [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline int __reduce_min_sync(unsigned mask, int v) {
  return reduce_(mask, v, [](int a, int b) { return a < b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return reduce_(mask, v,
                 [](unsigned a, unsigned b) { return a < b ? a : b; });
}
// one fiber runs at a time: an atomic is a plain read-modify-write
template <class T>
inline T atomicAdd(T* p, T v) {
  const T old = *p;
  *p = old + v;
  return old;
}
template <class T>
inline T atomicOr(T* p, T v) {
  const T old = *p;
  *p = old | v;
  return old;
}
// blocks run one after another and fibers switch only at barriers: a
// write is seen by every later read
inline void __threadfence_block() {}
inline void __nanosleep(unsigned) {}
inline unsigned __reduce_or_sync(unsigned mask, unsigned v) {
  return reduce_(mask, v, [](unsigned a, unsigned b) { return a | b; });
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
// bytewise add, each byte wrapping on its own
inline unsigned __vadd4(unsigned a, unsigned b) {
  return ((a & 0x7f7f7f7fu) + (b & 0x7f7f7f7fu)) ^ ((a ^ b) & 0x80808080u);
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
// g++ for x86-64 neither fuses nor reorders these at -O1 without
// -ffast-math: each rounds once, as the intrinsics do on the card
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __ull2double_rn(unsigned long long x) { return (double)x; }
inline long long __double_as_longlong(double x) {
  return stub::from_bits<long long>(stub::bits(x));
}
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i) r |= ((x >> i) & 1ull) << (63 - i);
  return r;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the stub runs one block at a time
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// two "SMs": grids sized by the SM count still take several blocks
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n,
                                   cudaStream_t = nullptr) {
  std::memset(p, v, n);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = stub::last_error;
  stub::last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error (cuda_stub)"
                          : "invalid argument (cuda_stub)";
}
