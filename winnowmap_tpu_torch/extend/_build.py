"""Build and load the CUDA kernels (csrc/*.cu) as plain-C shared libraries.

Each source is compiled by its own nvcc process for sm_90a, all started
together, into csrc/_build/ (cached by source hash and nvcc version), and
loaded with ctypes.  Nothing is built when the package is imported: the
first kernel launch builds.  There is no fallback: a missing nvcc or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("extd.cu", "exts.cu", "extz.cu", "traceback.cu", "cigar.cu",
           "chain.cu", "sketch.cu", "kcount.cu")
# the cost probes (tools/), loaded on their own so that mapping never
# waits on their build
PROBE_SOURCES = ("probes.cu",)
# headers the sources include: a change to one rebuilds every source
HEADERS = ("ext_common.cuh",)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict = {}
# seconds the last build took, and what ptxas said about each kernel
BUILD_INFO: dict = {"seconds": None, "ptxas": {}}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[-1]


def _target(src: str, nvcc_ver: str) -> Path:
    h = hashlib.sha256((CSRC / src).read_bytes())
    for hdr in HEADERS:
        h.update((CSRC / hdr).read_bytes())
    h.update(nvcc_ver.encode())
    h.update(ARCH.encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict:
    """Compile every source not yet built (one nvcc each, in parallel);
    returns {source: path}."""
    nvcc = nvcc_path()
    ver = _nvcc_version(nvcc)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s, ver) for s in sources}
    procs = {}
    t0 = time.perf_counter()
    for src, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-lineinfo", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, out)
    for src, (proc, tmp, out) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{so}\n{se}")
        BUILD_INFO["ptxas"][src] = "\n".join(
            ln for ln in (so + se).splitlines()
            if "ptxas" in ln or "spill" in ln)
        os.replace(tmp, out)
    if procs:
        BUILD_INFO["seconds"] = time.perf_counter() - t0
    return targets


def bind(lib) -> None:
    """Declares the argument and result types of each C entry of the
    kernel sources that `lib` exports (ctypes would pass a pointer as a
    32-bit int without them)."""
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    entries = {
        "wm_extd_launch": [vp, vp, vp, ci, vp, vp, vp, vp] + [ci] * 18
        + [vp],
        "wm_extd_occupancy": [ci, ci, ci, ctypes.POINTER(ci)],
        "wm_exts_launch": [vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
        + [ci] * 19 + [vp],
        "wm_extz_launch": [vp, vp, vp, ci, vp, vp, vp, vp] + [ci] * 15
        + [vp],
        "wm_traceback_launch": [vp, vp, vp, vp, ci, vp, i64, vp, ci, vp],
        "wm_cigar_rle_launch": [vp, i64, ci, vp, vp, ci, ci, vp, i64, vp,
                                vp, vp],
        "wm_chain_fwd_launch": [vp] * 6 + [ci] * 6 + [ctypes.c_double]
        + [vp] * 5,
        "wm_sketch_launch": [vp, i64, ci, vp, i64, vp, ctypes.c_uint64,
                             ctypes.c_uint32, ctypes.c_uint32] + [vp] * 4,
        "wm_kcount_launch": [vp, i64, ci, ci, vp, vp, i64] + [vp] * 4,
        "wm_probe_core_launch": [ci, ci, ci, vp, ci, vp, vp, vp, vp, vp]
        + [ci] * 4 + [vp, ctypes.c_longlong, vp],
        "wm_probe_core_scratch": [ci, ci, ci, ctypes.POINTER(
            ctypes.c_longlong)],
        "wm_probe_core_occupancy": [ci] * 4 + [ctypes.POINTER(ci)],
        "wm_probe_l0_launch": [vp, vp] + [ci] * 6 + [vp],
        "wm_probe_bisect_launch": [ci, vp, vp, vp] + [ci] * 4 + [vp],
    }
    for name, args in entries.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ci
    for name in ("wm_cuda_error_string", "wm_probe_error_string"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [ci], ctypes.c_char_p


def load():
    """The loaded kernel libraries, as one namespace of C entry points."""
    with _lock:
        if "api" in _libs:
            return _libs["api"]
        paths = build()
        extd = ctypes.CDLL(str(paths["extd.cu"]))
        exts = ctypes.CDLL(str(paths["exts.cu"]))
        extz = ctypes.CDLL(str(paths["extz.cu"]))
        tb = ctypes.CDLL(str(paths["traceback.cu"]))
        rle = ctypes.CDLL(str(paths["cigar.cu"]))
        chain = ctypes.CDLL(str(paths["chain.cu"]))
        sketch = ctypes.CDLL(str(paths["sketch.cu"]))
        kcount = ctypes.CDLL(str(paths["kcount.cu"]))
        for lib in (extd, exts, extz, tb, rle, chain, sketch, kcount):
            bind(lib)

        class _Api:
            wm_extd_launch = extd.wm_extd_launch
            wm_extd_occupancy = extd.wm_extd_occupancy
            wm_exts_launch = exts.wm_exts_launch
            wm_extz_launch = extz.wm_extz_launch
            wm_traceback_launch = tb.wm_traceback_launch
            wm_cigar_rle_launch = rle.wm_cigar_rle_launch
            wm_chain_fwd_launch = chain.wm_chain_fwd_launch
            wm_sketch_launch = sketch.wm_sketch_launch
            wm_kcount_launch = kcount.wm_kcount_launch
            wm_cuda_error_string = extd.wm_cuda_error_string
            libs = (extd, exts, extz, tb, rle, chain, sketch, kcount)

        _libs["api"] = _Api
        return _Api


def error_string(rc: int) -> str:
    return load().wm_cuda_error_string(rc).decode()


def load_probes() -> ctypes.CDLL:
    """The cost probes' library (csrc/probes.cu): P1-P3's C entry points."""
    with _lock:
        if "probes" in _libs:
            return _libs["probes"]
        lib = ctypes.CDLL(str(build(PROBE_SOURCES)["probes.cu"]))
        bind(lib)
        _libs["probes"] = lib
        return lib


def probe_error_string(rc: int) -> str:
    return load_probes().wm_probe_error_string(rc).decode()
