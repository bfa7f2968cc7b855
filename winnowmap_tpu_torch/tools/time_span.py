"""What one span of the mapping path costs the host: device.span's enter and
exit timed with no profiler recording, and again under a torch profiler
(CPU activity, and CUDA's where a card is present, as a traced benchmark
run records).

    python winnowmap_tpu_torch/tools/time_span.py

It prints one JSON line: the host's CPU count, and for each case the
nanoseconds of one span's enter and exit (the best of five trains of
20,000), less those of an empty loop as long.
"""
from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path


def span_ns(span, n: int) -> float:
    """Host ns of one span's enter and exit, the best of five trains of n,
    less an empty loop's."""
    c = defaultdict(float)

    def train(body: bool) -> float:
        t0 = time.perf_counter()
        if body:
            for _ in range(n):
                with span(c, "x"):
                    pass
        else:
            for _ in range(n):
                pass
        return time.perf_counter() - t0

    best = min(train(True) for _ in range(5))
    empty = min(train(False) for _ in range(5))
    return (best - empty) / n * 1e9


N = 20_000


def main() -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from winnowmap_tpu_torch.device import span

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {"cpu_count": os.cpu_count(), "n": N,
           "profiler_off_ns": span_ns(span, N)}
    with torch.profiler.profile(activities=acts):
        out["profiler_on_ns"] = span_ns(span, N)
    out["profiler_activities"] = [str(a).split(".")[-1] for a in acts]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
