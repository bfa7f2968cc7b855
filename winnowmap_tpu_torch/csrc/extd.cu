// K1: banded dual-affine extension DP (extd) for Hopper, one block per job.
//
// Replaces the TPU kernel _build_extd_kernel
// (winnowmap_tpu/extend/pallas_kernel.py:124, pallas_call at :863).
// Semantics are wm_extd's (native/src/wm_ksw.cpp, reference
// src/ksw2_extd2_sse.c).  The kernel body, ext_kernel<kExtd, NT, SPT>, is
// shared with K4 and lives in ext_common.cuh with its design notes.
#include "ext_common.cuh"

extern "C" int wm_extd_launch(const void* qpool, const void* tpool,
                              const void* jobs, int B, const void* dirs_off,
                              void* dirs, void* res, void* scratch, int ring,
                              int threads, int spt, int qstage, int mem_smem,
                              int smem, int scratch_bytes, int q, int e,
                              int q2, int e2, int sc_mch, int sc_mis,
                              int sc_n, int long_thres, int long_diff,
                              int dead, int flag, void* stream) {
  const ExtProf P{q,         e,         q2, e2, sc_mch, sc_mis, sc_n,
                  long_thres, long_diff, 0,  0,  flag,   dead};
  return ext_launch<kExtd>(qpool, tpool, jobs, B, dirs_off, dirs, res,
                           scratch, ring, threads, spt, qstage, mem_smem,
                           smem, scratch_bytes, P, stream);
}

// Blocks of K1 one SM holds at the launch (threads, spt) with `smem` bytes
// of dynamic shared memory: the waves a batch takes.
extern "C" int wm_extd_occupancy(int threads, int spt, int smem,
                                 int* blocks) {
#define WM_EXT_OCC(nt, s)                                                  \
  if (threads == nt && spt == s) {                                         \
    cudaError_t err = cudaSuccess;                                         \
    if (smem > 48 * 1024)                                                  \
      err = cudaFuncSetAttribute(ext_kernel<kExtd, nt, s>,                 \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 smem);                                    \
    if (err != cudaSuccess) return (int)err;                               \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(             \
        blocks, ext_kernel<kExtd, nt, s>, nt, (size_t)smem);               \
  }
  WM_EXT_VARIANTS(WM_EXT_OCC)
#undef WM_EXT_OCC
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
