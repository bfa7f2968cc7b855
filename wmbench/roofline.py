"""The benchmark's frozen yardstick for the DP kernels' roofline shares.

Kept here, with its sources, so that a change to the program cannot move
it.  A kernel's share is the least time its work needs on the card, the
larger of operations over the integer peak and bytes over the memory
bandwidth, over the time the profiler saw the kernel run.
"""
from __future__ import annotations

import numpy as np

# Integer peak of one NVIDIA H100 SXM, derived (NVIDIA publishes no int32
# rate): 132 SMs x 64 int32 lanes an SM x 1.98 GHz boost clock, one
# operation a lane a cycle = 16.73e12 operations a second, at the 700 W
# power limit.  Both kernels are scalar integer code, which the tensor
# cores' int8 rate does not cover.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Published HBM3 bandwidth of one H100 SXM (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12

# Integer operations a live band cell, counted from the scalar reference
# DP (winnowmap_tpu_torch/native/src/wm_ksw.cpp), not from the kernels, as
# chip_smoke.py's OPS_PER_CELL and OPS_PER_CELL_EXTS define them at commit
# fd4ff19 (chip_smoke.py:259-278):
# - extd (K1, wm_extd :1514-1586): score 6, candidates 4, max and
#   direction 12, clamp 1, u v 2, next-row terms 6, continue tests 4,
#   x y x2 y2 8, direction bits 4 = 47;
# - exts (K3, wm_exts :1847-1913): score 6, candidates 4, max and
#   direction 9, u v 2, next-row terms 5, continue tests 3, x y x2 6,
#   direction bits 3 = 38.
OPS_PER_CELL = {"extd": 47, "exts": 38}


def live_cells(qlen, tlen, w, unbanded: bool) -> np.ndarray:
    """Live band cells of each job, (qlen + tlen - 1) * min(qlen, tlen,
    w + 1), without the w term for unbanded (exts) jobs: the port's
    map/engine._est_live_cells at commit fd4ff19."""
    ql = np.asarray(qlen, np.int64)
    tl = np.asarray(tlen, np.int64)
    width = np.minimum(ql, tl)
    if not unbanded:
        width = np.minimum(width, np.asarray(w, np.int64) + 1)
    return (ql + tl - 1) * width


def job_bytes(qlen, tlen, cells) -> np.ndarray:
    """Bytes a job needs to move once: its query and target codes read,
    one direction byte a live cell written for the traceback."""
    return np.asarray(qlen, np.int64) + np.asarray(tlen, np.int64) + cells


def bound_s(kernel: str, cells: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes": which bound it is)."""
    t_ops = cells * OPS_PER_CELL[kernel] / INT32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(kernel: str, rec: dict):
    """The kernel's roofline share in % from a run's record, or None when
    the traced window holds none of its work."""
    k = rec.get("kernels", {}).get(kernel)
    if not k or k.get("device_s", 0) <= 0 or k.get("cells", 0) <= 0:
        return None
    t, _ = bound_s(kernel, k["cells"], k["bytes"])
    return 100.0 * t / k["device_s"]
