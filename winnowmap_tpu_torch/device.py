"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  The CPU
is used only when the caller asks for it explicitly (the tests do); a
request for CUDA on a machine without a card raises instead of quietly
running on the CPU.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

# one lock for every counter of the port (the kernels' LAUNCHES, the
# mapping path's STATS): engines on several host threads bump them at once
_COUNT_LOCK = threading.Lock()

# per-process counters of the mapping path (reset by callers that report);
# map/engine.py and map/batch.py re-export this object
STATS: dict = defaultdict(float)

_profiler_enabled = torch._C._autograd._profiler_enabled


def count(counter: dict, key, n=1) -> None:
    """counter[key] += n, as one step for every thread."""
    with _COUNT_LOCK:
        counter[key] += n


class span:
    """Time a block: its host seconds are added to counter[name + "_s"]
    (through count, so from any thread).  While a torch profiler records,
    the block is also the range "wm." + name, nested under its caller's
    range on the clock of the card's kernels; otherwise the cost is one
    flag test and two clock reads."""

    __slots__ = ("counter", "name", "rf", "t0")

    def __init__(self, counter: dict, name: str):
        self.counter, self.name = counter, name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function("wm." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        count(self.counter, self.name + "_s", time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def resolve_device(device=None) -> torch.device:
    """None -> cuda.  Raises RuntimeError when CUDA is asked for and no card
    is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "winnowmap_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
