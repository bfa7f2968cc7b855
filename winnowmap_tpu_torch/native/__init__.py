"""ctypes bindings for the native host library of the PyTorch/CUDA port.

A copy of winnowmap_tpu/native kept inside this package so the port never
imports the JAX package.  The library is compiled on first use with g++
(cached by source hash in native/_build/) -- no pip/pybind dependency.  It
hosts the irreducibly-sequential pieces (FASTX decode, exact-semantics
banded DP, chain DP, minimizer scan, the mapping engine); the extension DP
of the engine's exported jobs runs on the CUDA kernels in csrc/.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "_build"
_SOURCES = ["wm_ksw.cpp", "wm_chain.cpp", "wm_sketch.cpp", "wm_bloom.cpp",
            "wm_fastx.cpp",
            "wm_meryl.cpp",
            "wm_cigar.cpp", "wm_sdust.cpp", "wm_engine.cpp"]


def _machine_fingerprint() -> bytes:
    """Compiler + machine tag so a cached .so built elsewhere (possibly with
    different -march=native features) is never loaded on this host."""
    import platform

    try:
        cxx = subprocess.run(["g++", "-dumpfullversion", "-dumpversion"],
                             capture_output=True, text=True).stdout.strip()
    except OSError:
        cxx = "unknown"
    return f"{platform.machine()}|{platform.processor()}|g++{cxx}".encode()


def _san_mode() -> str:
    """Sanitizer build mode (reference analogue: asan/tsan debug builds of
    the C core).  WM_NATIVE_SAN=address|thread|undefined rebuilds the native
    library with that sanitizer; the engine's thread pool + job exchange run
    under tsan, the whole host path under asan (tests/test_native_san.py)."""
    import os

    mode = os.environ.get("WM_NATIVE_SAN", "")
    if mode and mode not in ("address", "thread", "undefined"):
        raise ValueError(f"WM_NATIVE_SAN={mode!r}: use address|thread|undefined")
    return mode


def _lib_path() -> Path:
    h = hashlib.sha256()
    for s in _SOURCES + ["wm_base.h"]:
        h.update((_SRC_DIR / s).read_bytes())
    h.update(_machine_fingerprint())
    san = _san_mode()
    tag = f"-{san[:4]}" if san else ""
    return _BUILD_DIR / f"libwmtpu-{h.hexdigest()[:16]}{tag}.so"


def _build() -> Path:
    """Compile the library unless it is cached.  g++ writes a per-process
    temporary name and os.replace puts it on the cached name, so another
    process that finds the cached name always finds a whole library."""
    out = _lib_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    san = _san_mode()
    opt = (["-O1", f"-fsanitize={san}", "-fno-omit-frame-pointer"]
           if san else ["-O3", "-march=native", "-funroll-loops"])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = (
        ["g++", *opt, "-g", "-fPIC",
         "-shared", "-std=c++17", "-pthread", "-o", str(tmp)]
        + [str(_SRC_DIR / s) for s in _SOURCES]
        + ["-lz", "-lpthread"]
    )
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, out)
    return out


class _ExtResult(ctypes.Structure):
    _fields_ = [
        ("max", ctypes.c_int32),
        ("zdropped", ctypes.c_int32),
        ("max_q", ctypes.c_int32),
        ("max_t", ctypes.c_int32),
        ("mqe", ctypes.c_int32),
        ("mqe_t", ctypes.c_int32),
        ("mte", ctypes.c_int32),
        ("mte_q", ctypes.c_int32),
        ("score", ctypes.c_int32),
        ("reach_end", ctypes.c_int32),
        ("n_cigar", ctypes.c_int32),
        ("cigar", ctypes.POINTER(ctypes.c_uint32)),
    ]


class _ExtraIO(ctypes.Structure):
    _fields_ = [
        ("qs", ctypes.c_int32), ("qe", ctypes.c_int32),
        ("rs", ctypes.c_int32), ("re", ctypes.c_int32),
        ("rev", ctypes.c_int32),
        ("blen", ctypes.c_int32), ("mlen", ctypes.c_int32),
        ("n_ambi", ctypes.c_int32), ("dp_max", ctypes.c_int32),
        ("n_cigar", ctypes.c_int32),
        ("cigar", ctypes.POINTER(ctypes.c_uint32)),
        ("qshift", ctypes.c_int32), ("tshift", ctypes.c_int32),
    ]


_lib = None
_lib_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded library.  Its first load (and build) runs under a lock:
    engine driver threads (parallel/multidev.py) may ask for it at once,
    and two builds in one process would share _build's temporary file."""
    if _lib is None:
        with _lib_lock:
            return _load()
    return _lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = _build()
        L = ctypes.CDLL(str(path))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        pu64 = ctypes.POINTER(ctypes.c_uint64)

        L.wm_extz.argtypes = [
            ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int, i8p,
            ctypes.c_int8, ctypes.c_int8, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(_ExtResult),
        ]
        L.wm_extz.restype = None
        L.wm_extz_fast.argtypes = L.wm_extz.argtypes
        L.wm_extz_fast.restype = None
        L.wm_extd.argtypes = [
            ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int, i8p,
            ctypes.c_int8, ctypes.c_int8, ctypes.c_int8, ctypes.c_int8,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_ExtResult),
        ]
        L.wm_extd.restype = None
        L.wm_extd_fast.argtypes = L.wm_extd.argtypes
        L.wm_extd_fast.restype = None
        L.wm_exts.argtypes = [
            ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int, i8p,
            ctypes.c_int8, ctypes.c_int8, ctypes.c_int8, ctypes.c_int8,
            ctypes.c_int, ctypes.c_int8, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(_ExtResult),
        ]
        L.wm_exts.restype = None
        L.wm_exts_fast.argtypes = L.wm_exts.argtypes
        L.wm_exts_fast.restype = None
        L.wm_sw_i16.argtypes = [
            ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_int, i8p,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        L.wm_sw_i16.restype = ctypes.c_int
        L.wm_chain_dp.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            u64p, u64p,
            ctypes.POINTER(pu64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(pu64), ctypes.POINTER(pu64),
        ]
        L.wm_chain_dp.restype = ctypes.c_int64
        L.wm_sketch.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int, u64p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(pu64), ctypes.POINTER(pu64),
        ]
        L.wm_sketch.restype = ctypes.c_int64
        L.wm_bloom_params.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
        L.wm_bloom_build.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, u8p]
        L.wm_bloom_contains.argtypes = [
            ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32]
        L.wm_bloom_contains.restype = ctypes.c_int
        L.wm_bloom_contains_batch.argtypes = [
            u64p, ctypes.c_int64, u8p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint32, u8p]
        L.wm_encode_kmer.argtypes = [ctypes.c_char_p, ctypes.c_int]
        L.wm_encode_kmer.restype = ctypes.c_uint64
        L.wm_free.argtypes = [ctypes.c_void_p]
        L.wm_free.restype = None

        # raw void* argtypes: this is called tens of thousands of times per
        # read batch, and np.ctypeslib's from_param/cast marshaling costs
        # ~9 us/arg -- the wrapper passes arr.ctypes.data ints instead.
        L.wm_test_zdrop.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        L.wm_test_zdrop.restype = ctypes.c_int
        L.wm_update_extra.argtypes = [
            u8p, u8p, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int32, i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_ExtraIO),
        ]
        L.wm_update_extra.restype = None

        L.wm_sdust.argtypes = [u8p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(pu64)]
        L.wm_sdust.restype = ctypes.c_int64
        L.wm_meryl_decode_data.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.POINTER(pu64), ctypes.POINTER(pu64)]
        L.wm_meryl_decode_data.restype = ctypes.c_int64
        L.wm_meryl_encode_block.argtypes = [
            ctypes.c_uint64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int64)]
        L.wm_meryl_encode_block.restype = ctypes.POINTER(ctypes.c_uint8)
        L.wm_rle_ops.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            u8p, np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        L.wm_rle_ops.restype = None
        L.wm_rle_ops4.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            u8p, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        L.wm_rle_ops4.restype = None

        L.wm_fastx_open.argtypes = [ctypes.c_char_p]
        L.wm_fastx_open.restype = ctypes.c_void_p
        L.wm_fastx_close.argtypes = [ctypes.c_void_p]
        L.wm_fastx_read_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.wm_fastx_read_batch.restype = ctypes.c_void_p
        for name in ("names", "comments", "seqs", "quals"):
            fn = getattr(L, f"wm_batch_{name}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_void_p
        for name in ("name_off", "comment_off", "seq_off", "qual_off"):
            fn = getattr(L, f"wm_batch_{name}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.POINTER(ctypes.c_int64)
        L.wm_batch_n.argtypes = [ctypes.c_void_p]
        L.wm_batch_n.restype = ctypes.c_int64
        L.wm_batch_free.argtypes = [ctypes.c_void_p]

        L.wm_winnow.argtypes = [
            ctypes.c_int64, u8p, u64p, u8p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.POINTER(pu64), ctypes.POINTER(pu64),
        ]
        L.wm_winnow.restype = ctypes.c_int64
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        L.wm_chain_finish.argtypes = [
            ctypes.c_int64, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
            u64p, u64p, ctypes.POINTER(pu64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(pu64),
            ctypes.POINTER(pu64),
        ]
        L.wm_chain_finish.restype = ctypes.c_int64

        # ---- mapping engine (wm_engine.cpp) ----
        L.wm_eng_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int]
        L.wm_eng_create.restype = ctypes.c_void_p
        L.wm_eng_destroy.argtypes = [ctypes.c_void_p]
        L.wm_eng_add_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_uint32]
        L.wm_eng_start_phase1.argtypes = [ctypes.c_void_p]
        L.wm_eng_start_phase2.argtypes = [ctypes.c_void_p]
        L.wm_eng_start_phase2.restype = ctypes.c_int
        L.wm_eng_step.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
        L.wm_eng_step.restype = ctypes.c_int64
        L.wm_eng_live.argtypes = [ctypes.c_void_p]
        L.wm_eng_live.restype = ctypes.c_int
        L.wm_eng_perf.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        L.wm_eng_perf.restype = None
        L.wm_eng_deliver.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
        L.wm_eng_set_chain_min.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        L.wm_eng_step_chains.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
        L.wm_eng_step_chains.restype = ctypes.c_int64
        L.wm_eng_deliver_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        L.wm_eng_run_host_ids.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p]
        L.wm_eng_result.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
        L.wm_eng_result.restype = ctypes.c_int
        _lib = L
    return _lib


class EngOptsC(ctypes.Structure):
    """ctypes mirror of weng::EngOpts (wm_engine.cpp) -- field order and
    types must match the C struct exactly."""

    _fields_ = (
        [("flag", ctypes.c_int64), ("max_sw_mat", ctypes.c_int64)]
        + [(n, ctypes.c_double) for n in
           ("chain_gap_scale", "mask_level", "pri_ratio", "alt_drop",
            "max_clip_ratio", "min_join_flank_ratio", "min_qcov",
            "prefix_increment_factor")]
        + [(n, ctypes.c_int32) for n in
           ("seed", "sdust_thres", "bw", "max_gap", "min_gap_ref",
            "max_gap_ref", "max_frag_len", "max_chain_skip",
            "max_chain_iter", "min_cnt", "min_chain_score", "mask_len",
            "best_n", "max_join_long", "max_join_short",
            "min_join_flank_sc", "a", "b", "q", "e", "q2", "e2", "sc_ambi",
            "noncan", "junc_bonus", "zdrop", "zdrop_inv", "end_bonus",
            "min_dp_max", "min_ksw_len", "anchor_ext_len",
            "anchor_ext_shift", "mid_occ", "max_occ", "min_mapq",
            "min_prefix_length", "max_prefix_length",
            "suffix_sample_offset", "sv_aware", "sv_aware_min_read_length",
            "pad_")]
    )


class EngIndexC(ctypes.Structure):
    """ctypes mirror of weng::EngIndex (wm_engine.cpp)."""

    _fields_ = [
        ("keys", ctypes.c_void_p), ("start", ctypes.c_void_p),
        ("pos", ctypes.c_void_p), ("codes", ctypes.c_void_p),
        ("seq_off", ctypes.c_void_p), ("seq_len", ctypes.c_void_p),
        ("wset", ctypes.c_void_p), ("bloom", ctypes.c_void_p),
        ("n_keys", ctypes.c_int64), ("n_wset", ctypes.c_int64),
        ("bloom_bits", ctypes.c_uint64), ("bloom_salts", ctypes.c_uint64),
        ("n_seq", ctypes.c_int32), ("w", ctypes.c_int32),
        ("k", ctypes.c_int32), ("idx_flag", ctypes.c_int32),
    ]


# numpy view dtype of weng::RegOut (keep in sync with wm_engine.cpp):
#   16 x i32 (0..60), f32 div @64, 10 x i32 inv..has_p @68..104,
#   u32 hash @108, 5 x i32 dp_* @112..128, i64 cigar_off @136 (8-aligned),
#   i32 n_cigar @144, pad -> itemsize 152
_REGOUT_NAMES = [
    "id", "cnt", "rid", "score", "qs", "qe", "rs", "re", "parent", "subsc",
    "as_", "mlen", "blen", "n_sub", "score0", "mapq", "div", "inv", "rev",
    "split", "split_inv", "sam_pri", "seg_split", "seg_id", "n_segs",
    "is_alt", "has_p", "hash", "dp_score", "dp_max", "dp_max2", "n_ambi",
    "trans_strand", "cigar_off", "n_cigar",
]
REGOUT_DTYPE = np.dtype({
    "names": _REGOUT_NAMES,
    "formats": ["<i4"] * 16 + ["<f4"] + ["<i4"] * 10 + ["<u4"]
               + ["<i4"] * 5 + ["<i8", "<i4"],
    "offsets": [i * 4 for i in range(28)] + [112, 116, 120, 124, 128, 136,
                                            144],
    "itemsize": 152,
})


_EMPTY_U64 = np.zeros(0, dtype=np.uint64)


class ExtResult:
    """Extension alignment outcome (scores + BAM-packed CIGAR)."""

    __slots__ = (
        "max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte", "mte_q",
        "score", "reach_end", "cigar",
    )

    def __init__(self, c: _ExtResult):
        self.max = c.max
        self.zdropped = bool(c.zdropped)
        self.max_q, self.max_t = c.max_q, c.max_t
        self.mqe, self.mqe_t = c.mqe, c.mqe_t
        self.mte, self.mte_q = c.mte, c.mte_q
        self.score = c.score
        self.reach_end = bool(c.reach_end)
        if c.n_cigar:
            self.cigar = np.ctypeslib.as_array(c.cigar, (c.n_cigar,)).copy()
        else:
            self.cigar = np.zeros(0, dtype=np.uint32)


def extz(qseq, tseq, mat, q, e, w, zdrop, end_bonus, flag,
         fast: bool = False) -> ExtResult:
    L = lib()
    r = _ExtResult()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    fn = L.wm_extz_fast if fast else L.wm_extz
    fn(len(qseq), qseq, len(tseq), tseq, 5, mat, q, e, w, zdrop,
       end_bonus, flag, ctypes.byref(r))
    out = ExtResult(r)
    if r.n_cigar:
        L.wm_free(r.cigar)
    return out


def extd(qseq, tseq, mat, q, e, q2, e2, w, zdrop, end_bonus, flag,
         fast: bool = False) -> ExtResult:
    """Dual-cost extension.  fast=True uses the AVX-512 host kernel
    (wm_extd_fast: runtime dispatch, bit-identical, scalar fallback);
    default is the scalar oracle for parity tests."""
    L = lib()
    r = _ExtResult()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    fn = L.wm_extd_fast if fast else L.wm_extd
    fn(len(qseq), qseq, len(tseq), tseq, 5, mat, q, e, q2, e2, w,
       zdrop, end_bonus, flag, ctypes.byref(r))
    out = ExtResult(r)
    if r.n_cigar:
        L.wm_free(r.cigar)
    return out


def exts(qseq, tseq, mat, q, e, q2, noncan, zdrop, junc_bonus, flag,
         junc=None, fast: bool = False) -> ExtResult:
    """Spliced extension (reference ksw_exts2_sse, src/ksw2_exts2_sse.c).
    fast=True uses the AVX-512 host kernel (bit-identical, dispatching)."""
    L = lib()
    r = _ExtResult()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    jp = None
    if junc is not None:
        junc = np.ascontiguousarray(junc, dtype=np.uint8)
        jp = junc.ctypes.data_as(ctypes.c_void_p)
    fn = L.wm_exts_fast if fast else L.wm_exts
    fn(len(qseq), qseq, len(tseq), tseq, 5, mat, q, e, q2, noncan,
       zdrop, junc_bonus, flag, jp, ctypes.byref(r))
    out = ExtResult(r)
    if r.n_cigar:
        L.wm_free(r.cigar)
    return out


def sw_score(qseq, tseq, mat, gapo, gape):
    """Score-only local SW; returns (score, qe, te)."""
    L = lib()
    qe = ctypes.c_int()
    te = ctypes.c_int()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    sc = L.wm_sw_i16(len(qseq), qseq, len(tseq), tseq, 5, mat, gapo, gape,
                     ctypes.byref(qe), ctypes.byref(te))
    return sc, qe.value, te.value


def chain_dp(ax, ay, *, max_dist_x, min_dist_x, max_dist_y, bw, max_skip,
             max_iter, min_cnt, min_sc, gap_scale=1.0, is_cdna=0, n_segs=1):
    """Exact chain DP.  Returns (u, ax_out, ay_out): per-chain score<<32|cnt
    and the reordered anchors."""
    L = lib()
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    pu = ctypes.POINTER(ctypes.c_uint64)()
    pax = ctypes.POINTER(ctypes.c_uint64)()
    pay = ctypes.POINTER(ctypes.c_uint64)()
    n_u = ctypes.c_int32()
    n_v = L.wm_chain_dp(max_dist_x, min_dist_x, max_dist_y, bw, max_skip,
                        max_iter, min_cnt, min_sc, gap_scale, is_cdna, n_segs,
                        len(ax), ax, ay, ctypes.byref(pu), ctypes.byref(n_u),
                        ctypes.byref(pax), ctypes.byref(pay))
    if n_u.value == 0:
        return _EMPTY_U64, _EMPTY_U64, _EMPTY_U64
    u = np.ctypeslib.as_array(pu, (n_u.value,)).copy()
    axo = np.ctypeslib.as_array(pax, (n_v,)).copy()
    ayo = np.ctypeslib.as_array(pay, (n_v,)).copy()
    L.wm_free(pu)
    L.wm_free(pax)
    L.wm_free(pay)
    return u, axo, ayo


def sketch(seq: bytes, w: int, k: int, rid: int, is_hpc: bool,
           wset: np.ndarray | None = None, bloom=None):
    """Exact weighted-minimizer sketch.  Returns (x, y) uint64 arrays.
    bloom: optional (table u8, table_bits, salt0, salt1) for the
    --bloom-filter strict-parity membership mode (wm_bloom.cpp)."""
    L = lib()
    wset = _EMPTY_U64 if wset is None or len(wset) == 0 else np.ascontiguousarray(wset, dtype=np.uint64)
    px = ctypes.POINTER(ctypes.c_uint64)()
    py = ctypes.POINTER(ctypes.c_uint64)()
    if bloom is not None:
        bt, bbits, s0, s1 = bloom
        bp = np.ascontiguousarray(bt, np.uint8).ctypes.data_as(ctypes.c_void_p)
    else:
        bp, bbits, s0, s1 = None, 0, 0, 0
    n = L.wm_sketch(seq, len(seq), w, k, rid, int(is_hpc), wset, len(wset),
                    bp, bbits, s0, s1,
                    ctypes.byref(px), ctypes.byref(py))
    if n == 0:
        return _EMPTY_U64, _EMPTY_U64
    x = np.ctypeslib.as_array(px, (n,)).copy()
    y = np.ctypeslib.as_array(py, (n,)).copy()
    L.wm_free(px)
    L.wm_free(py)
    return x, y


def winnow(codes, key, flags, ordv, w, k, rid, is_hpc, skip_len=None,
           base_pos=None):
    """Robust-winnowing automaton tail of the device sketch
    (sketch/device.py) over S1's per-slot outputs: key, flags (z in bit 0;
    the symmetric test is the automaton's own, on the oracle's k-mer, see
    wm_sketch.cpp) and ordv.  skip_len and base_pos (int64) are read only
    with HPC; without them a slot's run is 1 and its position its index."""
    L = lib()
    codes = np.ascontiguousarray(codes, np.uint8)
    key = np.ascontiguousarray(key, np.uint64)
    flags = np.ascontiguousarray(flags, np.uint8)
    ordv = np.ascontiguousarray(ordv, np.float64)
    if is_hpc:
        skip_len = np.ascontiguousarray(skip_len, np.int64)
        base_pos = np.ascontiguousarray(base_pos, np.int64)
    sp = None if skip_len is None else skip_len.ctypes.data
    bp = None if base_pos is None else base_pos.ctypes.data
    px = ctypes.POINTER(ctypes.c_uint64)()
    py = ctypes.POINTER(ctypes.c_uint64)()
    n = L.wm_winnow(len(codes), codes, key, flags, ordv, sp, bp, w, k, rid,
                    int(is_hpc), ctypes.byref(px), ctypes.byref(py))
    if n == 0:
        return _EMPTY_U64, _EMPTY_U64
    x = np.ctypeslib.as_array(px, (n,)).copy()
    y = np.ctypeslib.as_array(py, (n,)).copy()
    L.wm_free(px)
    L.wm_free(py)
    return x, y


def chain_finish(f, pre, v, min_cnt, min_sc, ax, ay):
    """Chain-end discovery + backtrack + reorder over a computed forward
    DP (the oracle's own tail, shared with the device chain kernel)."""
    L = lib()
    f = np.ascontiguousarray(f, np.int32)
    pre = np.ascontiguousarray(pre, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    ax = np.ascontiguousarray(ax, np.uint64)
    ay = np.ascontiguousarray(ay, np.uint64)
    pu = ctypes.POINTER(ctypes.c_uint64)()
    pax = ctypes.POINTER(ctypes.c_uint64)()
    pay = ctypes.POINTER(ctypes.c_uint64)()
    n_u = ctypes.c_int32()
    n_v = L.wm_chain_finish(len(f), f, pre, v, min_cnt, min_sc, ax, ay,
                            ctypes.byref(pu), ctypes.byref(n_u),
                            ctypes.byref(pax), ctypes.byref(pay))
    if n_v == 0:
        z = np.zeros(0, np.uint64)
        return z, z, z
    u = np.ctypeslib.as_array(pu, (n_u.value,)).copy()
    oax = np.ctypeslib.as_array(pax, (n_v,)).copy()
    oay = np.ctypeslib.as_array(pay, (n_v,)).copy()
    L.wm_free(pu)
    L.wm_free(pax)
    L.wm_free(pay)
    return u, oax, oay


def encode_kmer(s: bytes) -> int:
    return int(lib().wm_encode_kmer(s, len(s)))


def test_zdrop(qseq, tseq, cigar, mat, *, q, e, zdrop, zdrop_inv, max_gap,
               min_inv_score, min_dp_max, try_inv) -> int:
    """Z-drop inspection + inversion probe (reference mm_test_zdrop,
    align.c:47-89).  Returns 0 (keep), 1 (z-dropped), 2 (inversion)."""
    L = lib()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    return L.wm_test_zdrop(
        qseq.ctypes.data, tseq.ctypes.data, cigar.ctypes.data, len(cigar),
        mat.ctypes.data, q, e, zdrop, zdrop_inv, max_gap, min_inv_score,
        min_dp_max, int(try_inv))


def update_extra(qseq, tseq, cigar, mat, q, e, is_eqx, *, qs, qe, rs, re, rev):
    """CIGAR normalisation + blen/mlen/dp_max recompute (reference
    mm_update_extra, align.c:240-286 incl. mm_fix_cigar and eqx expansion).
    Returns (new_cigar, dict of updated fields)."""
    L = lib()
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    cigar = np.ascontiguousarray(cigar, dtype=np.uint32)
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    io = _ExtraIO(qs=qs, qe=qe, rs=rs, re=re, rev=int(rev))
    L.wm_update_extra(qseq, tseq, cigar, len(cigar), mat, q, e, int(is_eqx),
                      ctypes.byref(io))
    if io.n_cigar:
        new_cigar = np.ctypeslib.as_array(io.cigar, (io.n_cigar,)).copy()
        L.wm_free(io.cigar)
    else:
        new_cigar = np.zeros(0, dtype=np.uint32)
    return new_cigar, {
        "qs": io.qs, "qe": io.qe, "rs": io.rs, "re": io.re,
        "blen": io.blen, "mlen": io.mlen, "n_ambi": io.n_ambi,
        "dp_max": io.dp_max,
    }


def sdust(seq, thres: int, win: int = 64) -> np.ndarray:
    """Low-complexity intervals start<<32|end (reference sdust_core,
    src/sdust.c:134-166)."""
    L = lib()
    seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    out = ctypes.POINTER(ctypes.c_uint64)()
    n = L.wm_sdust(np.ascontiguousarray(seq), len(seq), thres, win,
                   ctypes.byref(out))
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    res = np.ctypeslib.as_array(out, (n,)).copy()
    L.wm_free(out)
    return res


def rle_ops_blob(packed, i_fin, j_fin, rev_flags):
    """Batch traceback-op decode: 2-bit-packed walks -> one flat BAM-CIGAR
    blob (uint32) + per-row (off int64, len int32), exactly the layout the
    engine's deliver boundary consumes (no per-alignment splitting)."""
    L = lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, cols = packed.shape
    i_fin = np.ascontiguousarray(i_fin, dtype=np.int32)
    j_fin = np.ascontiguousarray(j_fin, dtype=np.int32)
    rev_flags = np.ascontiguousarray(rev_flags, dtype=np.uint8)
    # Runs are rarely length-1, so start well under the worst case
    # (cols*4+8 per row) and let the C side signal overflow for a retry.
    cap = max(4096, (int(cols) + 8) * max(n, 1))
    hard_cap = int(cols * 4 + 8) * max(n, 1)
    out_len = np.empty(n, dtype=np.int32)
    out_off = np.empty(n, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.uint32)
        L.wm_rle_ops(packed, cols, n, cols, i_fin, j_fin, rev_flags, out,
                     cap, out_len, out_off)
        if n == 0 or out_len.min() >= 0:
            break
        cap = min(cap * 4, hard_cap)
    return out, out_off, out_len


def rle_ops_batch(packed, i_fin, j_fin, rev_flags):
    """rle_ops_blob split into a list of per-alignment CIGAR arrays
    (replicates the per-alignment _rle_cigar_packed semantics)."""
    out, out_off, out_len = rle_ops_blob(packed, i_fin, j_fin, rev_flags)
    return [out[o:o + ln].copy() for o, ln in zip(out_off, out_len)]


def rle_ops_blob4(packed, i_fin, j_fin, rev_flags, min_intron):
    """rle_ops_blob for 4-bit-packed walks (spliced kernel: intron op 3,
    idle 15); min_intron applies ksw_backtrack's leading-remainder N rule."""
    L = lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    n, cols = packed.shape
    i_fin = np.ascontiguousarray(i_fin, dtype=np.int32)
    j_fin = np.ascontiguousarray(j_fin, dtype=np.int32)
    rev_flags = np.ascontiguousarray(rev_flags, dtype=np.uint8)
    cap = max(4096, (int(cols) + 8) * max(n, 1))
    hard_cap = int(cols * 2 + 8) * max(n, 1)
    out_len = np.empty(n, dtype=np.int32)
    out_off = np.empty(n, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.uint32)
        L.wm_rle_ops4(packed, cols, n, cols, i_fin, j_fin, rev_flags,
                      int(min_intron), out, cap, out_len, out_off)
        if n == 0 or out_len.min() >= 0:
            break
        cap = min(cap * 4, hard_cap)
    return out, out_off, out_len


def rle_ops_batch4(packed, i_fin, j_fin, rev_flags, min_intron):
    """rle_ops_blob4 split into a list of per-alignment CIGAR arrays."""
    out, out_off, out_len = rle_ops_blob4(packed, i_fin, j_fin, rev_flags,
                                          min_intron)
    return [out[o:o + ln].copy() for o, ln in zip(out_off, out_len)]


def meryl_decode_data(buf: bytes, suffix_size: int):
    """Decode one .merylData file -> (kmers u64 asc-by-block, values u64)."""
    L = lib()
    arr = np.frombuffer(buf, dtype=np.uint8)
    pk = ctypes.POINTER(ctypes.c_uint64)()
    pv = ctypes.POINTER(ctypes.c_uint64)()
    n = L.wm_meryl_decode_data(arr, len(arr), suffix_size,
                               ctypes.byref(pk), ctypes.byref(pv))
    if n < 0:
        raise ValueError(f"malformed meryl data file (code {n})")
    if n == 0:
        k = v = np.zeros(0, np.uint64)
    else:
        k = np.ctypeslib.as_array(pk, (n,)).copy()
        v = np.ctypeslib.as_array(pv, (n,)).copy()
    L.wm_free(pk)
    L.wm_free(pv)
    return k, v


def meryl_encode_block(prefix: int, sufs, vals, suffix_size: int,
                       vct: int = 1) -> bytes:
    """Encode one meryl data block as a stuffedBits dump (bytes)."""
    L = lib()
    sufs = np.ascontiguousarray(sufs, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    nb = ctypes.c_int64()
    p = L.wm_meryl_encode_block(prefix, len(sufs), sufs, vals, suffix_size,
                                vct, ctypes.byref(nb))
    out = ctypes.string_at(p, nb.value)
    L.wm_free(p)
    return out
