// K3: spliced extension DP (exts) for Hopper, one block per job.
//
// Replaces the TPU kernel _build_extd_kernel(splice=...) reached through
// _compiled_exts_pallas (winnowmap_tpu/extend/pallas_kernel.py:879,
// pallas_call at :940), with its site scores _splice_sites (:57).
// Semantics are wm_exts's (native/src/wm_ksw.cpp:1705-1985, reference
// src/ksw2_exts2_sse.c).  The kernel body, ext_kernel<true>, is K1's with
// the spliced cell and two ring rows of site scores; it lives in
// ext_common.cuh with its design notes.  The junction bytes (jpool, joff)
// are optional per job and null on the engine path.
#include "ext_common.cuh"

extern "C" int wm_exts_launch(const void* qpool, const void* tpool,
                              const void* jobs, int B, const void* dirs_off,
                              const void* jpool, const void* joff, void* dirs,
                              void* res, void* scratch, int cap, int use_smem,
                              int threads, int q, int e, int q2, int sc_mch,
                              int sc_mis, int sc_n, int long_thres,
                              int long_diff, int noncan, int junc_bonus,
                              int dead, int flag, void* stream) {
  // the intron state has no extension cost: e2 = 0
  const ExtProf P{q,         e,         q2,     0,          sc_mch, sc_mis, sc_n,
                  long_thres, long_diff, noncan, junc_bonus, flag,   dead};
  return ext_launch<kExts>(qpool, tpool, jobs, B, dirs_off, jpool, joff, dirs,
                          res, scratch, cap, use_smem, threads, P, stream);
}
