// K4: banded single-gap-cost extension DP (extz) for Hopper, one block per
// job.
//
// Replaces the TPU kernel _build_extz_kernel
// (winnowmap_tpu/extend/pallas_kernel.py:1969), built by
// _compiled_extz_pallas (:2338, pallas_call at :2389) and chosen by
// DevCallPooled when q == q2 and e == e2 (:1705).  Semantics are wm_extz's
// (native/src/wm_ksw.cpp:1192-1412, reference src/ksw2_extz2_sse.c): the
// state is biased unsigned bytes.  The kernel body, ext_kernel<kExtz, NT,
// SPT>, is K1's with the extz cell (u v x y s in a slot, no x2 y2); it
// lives in ext_common.cuh with its design notes.  None of the TPU kernel's
// own limits (its rank packing, its score range) apply: the row max is
// reduced as (H, rank) and wide bands keep the slot state in memory.
#include "ext_common.cuh"

extern "C" int wm_extz_launch(const void* qpool, const void* tpool,
                              const void* jobs, int B, const void* dirs_off,
                              void* dirs, void* res, void* scratch, int ring,
                              int threads, int spt, int qstage, int mem_smem,
                              int smem, int scratch_bytes, int q, int e,
                              int sc_mch, int sc_mis, int sc_n, int max_sc,
                              int dead, int flag, void* stream) {
  // one gap cost: q2 = q, and z-drop's gap term e2 = e
  const ExtProf P{q, e, q, e,    sc_mch, sc_mis, sc_n, 0,
                  0, 0, 0, flag, dead,   max_sc};
  return ext_launch<kExtz>(qpool, tpool, jobs, B, dirs_off, dirs, res,
                           scratch, ring, threads, spt, qstage, mem_smem,
                           smem, scratch_bytes, P, stream);
}
