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
SOURCES = ("extd.cu", "exts.cu", "extz.cu", "traceback.cu")
# the cost probes (tools/), loaded on their own so that mapping never
# waits on their build
PROBE_SOURCES = ("probes.cu",)
# headers the sources include: a change to one rebuilds every source
HEADERS = ("ext_common.cuh",)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# dynamic shared memory one extd or extz block may take for its band ring;
# wider bands keep the ring in a global scratch slot (K3's limits are in
# kernels.py)
EXTD_SMEM_MAX = 100 * 1024

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
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        extd.wm_extd_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, ci,
                                        ci, ci, ci, ci, ci, ci, ci, ci, ci,
                                        ci, ci, ci, ci, vp]
        extd.wm_extd_launch.restype = ci
        extd.wm_extd_occupancy.argtypes = [ci, ci, ci, ci,
                                           ctypes.POINTER(ci)]
        extd.wm_extd_occupancy.restype = ci
        extd.wm_cuda_error_string.argtypes = [ci]
        extd.wm_cuda_error_string.restype = ctypes.c_char_p
        exts.wm_exts_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, vp,
                                        vp] + [ci] * 19 + [vp]
        exts.wm_exts_launch.restype = ci
        extz.wm_extz_launch.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp, ci,
                                        ci, ci] + [ci] * 8 + [vp]
        extz.wm_extz_launch.restype = ci
        tb.wm_traceback_launch.argtypes = [vp, vp, vp, vp, ci, vp, i64, vp,
                                           ci, vp]
        tb.wm_traceback_launch.restype = ci

        class _Api:
            wm_extd_launch = extd.wm_extd_launch
            wm_extd_occupancy = extd.wm_extd_occupancy
            wm_exts_launch = exts.wm_exts_launch
            wm_extz_launch = extz.wm_extz_launch
            wm_traceback_launch = tb.wm_traceback_launch
            wm_cuda_error_string = extd.wm_cuda_error_string
            libs = (extd, exts, extz, tb)

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
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wm_probe_core_launch.argtypes = ([ci, ci, ci, vp, ci, vp, vp, vp,
                                              vp, vp] + [ci] * 4 + [vp])
        lib.wm_probe_core_occupancy.argtypes = [ci] * 4 + [
            ctypes.POINTER(ci)]
        lib.wm_probe_l0_launch.argtypes = [vp, vp] + [ci] * 6 + [vp]
        lib.wm_probe_bisect_launch.argtypes = [ci, vp, vp, vp] + [ci] * 4 + [
            vp]
        for fn in (lib.wm_probe_core_launch, lib.wm_probe_core_occupancy,
                   lib.wm_probe_l0_launch, lib.wm_probe_bisect_launch):
            fn.restype = ci
        lib.wm_probe_error_string.argtypes = [ci]
        lib.wm_probe_error_string.restype = ctypes.c_char_p
        _libs["probes"] = lib
        return lib


def probe_error_string(rc: int) -> str:
    return load_probes().wm_probe_error_string(rc).decode()
