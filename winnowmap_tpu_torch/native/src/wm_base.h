// winnowmap-tpu native host library: shared declarations.
//
// This library supplies the irreducibly-sequential host-side pieces of the
// framework (FASTX decode, exact banded-DP fallback, chain-DP fallback,
// minimizer scan fallback) so the Python/JAX layer never loops per-base in
// Python.  The TPU compute path (Pallas kernels) is the production path;
// these routines are the bit-exactness oracle and CPU fallback.
#ifndef WM_BASE_H
#define WM_BASE_H

#include <cstdint>
#include <cstdlib>
#include <cstring>

#define WM_NEG_INF (-0x40000000)

// Alignment result flags (mirrors the semantics of reference ksw2.h:8-17;
// values must match because the Python layer passes them through).
#define WM_EZ_SCORE_ONLY 0x01
#define WM_EZ_RIGHT 0x02
#define WM_EZ_GENERIC_SC 0x04
#define WM_EZ_APPROX_MAX 0x08
#define WM_EZ_APPROX_DROP 0x10
#define WM_EZ_EXTZ_ONLY 0x40
#define WM_EZ_REV_CIGAR 0x80
#define WM_EZ_SPLICE_FOR 0x100
#define WM_EZ_SPLICE_REV 0x200
#define WM_EZ_SPLICE_FLANK 0x400

// Result block for the extension kernels (layout shared with ctypes).
typedef struct {
  int32_t max;       // best score anywhere
  int32_t zdropped;  // 1 if the z-drop test truncated the DP
  int32_t max_q, max_t;
  int32_t mqe, mqe_t;  // best score on the last query row
  int32_t mte, mte_q;  // best score on the last target column
  int32_t score;       // score reaching both ends (or WM_NEG_INF)
  int32_t reach_end;
  int32_t n_cigar;
  uint32_t* cigar;  // BAM packed ops, owned by the callee (wm_free)
} wm_ext_result;

// Reference-exact bloom emulation (wm_bloom.cpp; --bloom-filter parity
// mode): shared with the sketch membership and the map engine.
extern "C" int wm_bloom_contains(uint64_t key, const uint8_t* table,
                                 uint64_t table_bits, uint32_t s0,
                                 uint32_t s1);

extern "C" {

void* wm_malloc(size_t n);
void wm_free(void* p);

}  // extern "C"

#endif  // WM_BASE_H
