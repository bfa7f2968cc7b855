"""Phase timers/logging in the reference's [M::func::t*cpu] style
(reference misc.c:96-121 + usage across index.c/main.c)."""
from __future__ import annotations

import os
import resource
import sys
import time

_t0 = time.time()
verbose = int(os.environ.get("WM_VERBOSE", "3"))


def realtime() -> float:
    return time.time() - _t0


def cputime() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def peakrss() -> float:
    """Peak RSS in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0


def phase_log(func: str, msg: str, min_verbose: int = 3) -> None:
    if verbose >= min_verbose:
        rt = realtime()
        cpu_frac = cputime() / rt if rt > 0 else 0.0
        print(f"[M::{func}::{rt:.3f}*{cpu_frac:.2f}] {msg}", file=sys.stderr)


def warn(msg: str) -> None:
    if verbose >= 2:
        print(f"[WARNING] {msg}", file=sys.stderr)
