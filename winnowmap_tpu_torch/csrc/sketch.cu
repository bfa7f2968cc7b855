// S1: the sketch transform, one thread per base.
//
// Replaces the device function _compiled_transform
// (winnowmap_tpu/sketch/device.py:30, a jax.jit elementwise pass, not
// Pallas).  For base i of the (HPC-compacted) code string: the forward
// k-mer f_i = sum_j c[i-j] << 2j and its reverse complement
// r_i = sum_j (3 ^ c[i-j]) << 2(k-1-j) over j < k, where an ambiguous code
// (4) and a position before the start contribute 0; the canonical k-mer
// min(f, r), its strand z = f >= r, the symmetric flag f == r, the
// MurmurHash3 finalizer of the canonical k-mer (reference sketch.c:43-51)
// and the invertible key mix masked to 2k bits (sketch.c:53-63), all in
// u64.  The host then flags the down-weighted k-mers, orders by the f64
// weights and runs the winnowing automaton (sketch/device.py), as the JAX
// package does.
//
// What bounds it on this card: bytes.  Each base reads one code byte and
// writes three u64 words and two bytes; a block stages its codes and the
// k-1 before them in shared memory so each byte is read from device memory
// once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 28;

__global__ void __launch_bounds__(kThreads)
    sketch_kernel(const uint8_t* __restrict__ codes, int64_t n, int k,
                  uint64_t* __restrict__ key, uint64_t* __restrict__ h,
                  uint8_t* __restrict__ z, uint8_t* __restrict__ sym,
                  uint64_t* __restrict__ canon) {
  __shared__ uint8_t tile[kThreads + kMaxK];
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  // tile[s] holds code first - (k - 1) + s; outside [0, n) it is 4
  for (int s = threadIdx.x; s < kThreads + k - 1; s += kThreads) {
    const int64_t p = first - (k - 1) + s;
    tile[s] = p >= 0 && p < n ? codes[p] : 4;
  }
  __syncthreads();
  const int64_t i = first + threadIdx.x;
  if (i >= n) return;
  uint64_t fw = 0, rv = 0;
  for (int j = 0; j < k; ++j) {
    const unsigned c = tile[threadIdx.x + k - 1 - j];
    if (c < 4) {
      fw |= (uint64_t)c << (2 * j);
      rv |= (uint64_t)(3 ^ c) << (2 * (k - 1 - j));
    }
  }
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const uint64_t cn = fw < rv ? fw : rv;
  uint64_t x = cn;
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  uint64_t y = cn;
  y = (~y + (y << 21)) & mask;
  y ^= y >> 24;
  y = (y + (y << 3) + (y << 8)) & mask;
  y ^= y >> 14;
  y = (y + (y << 2) + (y << 4)) & mask;
  y ^= y >> 28;
  y = (y + (y << 31)) & mask;
  key[i] = y;
  h[i] = x;
  z[i] = fw < rv ? 0 : 1;
  sym[i] = fw == rv;
  canon[i] = cn;
}

}  // namespace

extern "C" int wm_sketch_launch(const void* codes, int64_t n, int k,
                                void* key, void* h, void* z, void* sym,
                                void* canon, void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || k > kMaxK) return (int)cudaErrorInvalidValue;
  sketch_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n, k, (uint64_t*)key, (uint64_t*)h, (uint8_t*)z,
      (uint8_t*)sym, (uint64_t*)canon);
  return (int)cudaGetLastError();
}
