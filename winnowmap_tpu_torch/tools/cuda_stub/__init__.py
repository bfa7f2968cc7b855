"""Run the port's CUDA sources on the CPU: g++ against a stub CUDA runtime.

The sandbox that develops the kernels has no nvcc and no card.  This
compiles a csrc/*.cu file with `g++ -std=c++20` against the stub
cuda_runtime.h beside this file (one fiber per CUDA thread on one OS
thread, barriers for __syncthreads and the warp operations; see the
header) into a shared library whose C launch entries take host pointers,
so a kernel runs on CPU tensors and can be held to its plain PyTorch
version:

    lib = cuda_stub.load("extd.cu", build_dir)
    rc = lib.wm_extd_launch(<the entry's arguments, CPU data_ptrs>, None)

Before compiling, the local headers ("...") are inlined and two CUDA
forms are rewritten: `kernel<<<g, b, s, st>>>(args);` into
`stub::launch([&] { kernel(args); }, g, b, s, st);`, and `extern __shared__
... name[];` into a pointer to the block's dynamic shared memory.  Keep runs
to a few jobs of some hundred bases: every warp operation of a row
switches through the warp's 32 fibers (about 0.1-0.2 ms a row at 128
threads).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

STUB_DIR = Path(__file__).resolve().parent
CSRC = STUB_DIR.parent.parent / "csrc"

_LAUNCH = re.compile(r"([\w:]+(?:<[^;{}]*?>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                     re.S)
_DYN_SMEM = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s*)?"
                       r"([\w:]+)\s+(\w+)\[\];")
_INCLUDE = re.compile(r'^#include "([^"]+)"\s*$', re.M)


def gxx_path() -> str | None:
    return shutil.which("g++")


def translate(src: Path, seen: set | None = None) -> str:
    """The source with its local headers inlined (each once) and the
    launch and dynamic shared memory rewritten for the stub."""
    seen = set() if seen is None else seen

    def inline(m):
        hdr = src.parent / m.group(1)
        if hdr in seen:
            return ""
        seen.add(hdr)
        return translate(hdr, seen)

    text = _INCLUDE.sub(inline, src.read_text())
    text = _DYN_SMEM.sub(r"\1* \2 = stub::dyn_smem();", text)
    return _LAUNCH.sub(r"stub::launch([&] { \1(\3); }, \2);", text)


def build(source: str, build_dir: Path) -> Path:
    """Compiles csrc/<source> against the stub into build_dir (cached by
    the translated text); returns the library's path."""
    gxx = gxx_path()
    if gxx is None:
        raise RuntimeError("g++ not found: the CUDA stub compiles with g++")
    text = translate(CSRC / source)
    stub = (STUB_DIR / "cuda_runtime.h").read_bytes()
    h = hashlib.sha256(text.encode() + stub).hexdigest()[:16]
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"stub_{Path(source).stem}-{h}.so"
    if out.exists():
        return out
    # per-process names, and the library appears under its own name only
    # whole: another process may be building the same source
    cpp = out.with_suffix(f".{os.getpid()}.cpp")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cpp.write_text(text)
    cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
           "-U_FORTIFY_SOURCE", "-I", str(STUB_DIR), "-o", str(tmp), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {source} under the CUDA stub:\n"
                           f"{proc.stderr[-6000:]}")
    os.replace(tmp, out)
    return out


def load(source: str, build_dir: Path) -> ctypes.CDLL:
    """The stub-built library of csrc/<source>, its C entries bound as
    extend._build binds the card's."""
    from ...extend import _build

    lib = ctypes.CDLL(str(build(source, build_dir)))
    _build.bind(lib)
    return lib
