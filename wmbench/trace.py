"""The benchmark's own spans and the reading of the card's trace.

Spans are recorded from the benchmark's files, around the calls into the
program's layers, by wrapping the names the program's modules call:

- `map.pipeline.map_batch` (the file driver's call into mapping),
- `map.engine.DevCallPooled` (the pump's dispatch: its constructor
  launches a call's kernels) and its `collect_blob` (the pump's wait),

and, by the harness, around each `map_file` call, the window and the index
build.  Each span is a `torch.profiler.record_function` range, so the
card's kernels and the host's spans lie on one clock in the profiler's
trace, and a host-clock interval beside it.  While a trace is on, every
DevCallPooled records its kernel and its jobs' live cells and bytes (the
benchmark's own count, roofline.py) for the roofline shares.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np

from . import roofline

SPAN = "wmbench."
# CUDA kernel names of the DP kernels, as the profiler reports them
KERNEL_RE = {"extd": re.compile(r"\bext_kernel<\s*(\(\w+\))?0\s*,"),
             "exts": re.compile(r"\bexts_kernel<")}
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host span an idle gap falls in, innermost first
GAP_LABELS = (("collect", "collect"), ("dispatch", "dispatch"),
              ("map_batch", "engine_host"), ("map_file", "driver"))


class Spans:
    """Host-clock spans by name, and the DP calls' work while tracing."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = []  # (kernel, cells, bytes)
        self.on = False

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        import torch
        self.rf = torch.profiler.record_function(SPAN + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.seconds[self.name] += time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        return False


def install(spans: Spans):
    """Wrap the program's map_batch (as map.pipeline calls it) and
    DevCallPooled (as map.engine calls it).  Returns an undo function."""
    from winnowmap_tpu_torch.map import engine, pipeline

    base_map_batch = pipeline.map_batch
    base_call = engine.DevCallPooled

    def map_batch(*a, **kw):
        with spans.span("map_batch"):
            return base_map_batch(*a, **kw)

    class DevCallPooled(base_call):
        def __init__(self, pools, jobs, mat, q, e, q2, e2, end_bonus, flag,
                     splice=None, juncs=None):
            with spans.span("dispatch"):
                super().__init__(pools, jobs, mat, q, e, q2, e2, end_bonus,
                                 flag, splice=splice, juncs=juncs)
            if spans.on:
                j = np.asarray(jobs).reshape(-1, 8)
                kernel = ("exts" if splice is not None else
                          "extz" if q == q2 and e == e2 else "extd")
                cells = roofline.live_cells(j[:, 1], j[:, 4], j[:, 6],
                                            splice is not None)
                spans.calls.append(
                    (kernel, float(cells.sum()),
                     float(roofline.job_bytes(j[:, 1], j[:, 4],
                                              cells).sum())))

        def collect_blob(self):
            with spans.span("collect"):
                return super().collect_blob()

    pipeline.map_batch = map_batch
    engine.DevCallPooled = DevCallPooled

    def undo():
        pipeline.map_batch = base_map_batch
        engine.DevCallPooled = base_call

    return undo


def _device_work(e) -> bool:
    """A kernel, copy or set on the card (not an annotation)."""
    act = getattr(e, "activity_type", None)
    if act is None:  # builds whose events do not name their activity
        return not e.is_user_annotation()
    return act() in DEVICE_ACTIVITIES


def _merge(iv):
    """Union of intervals (sorted (start, end) pairs) as a merged list."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(", 1)[0][:120] or name[:120]


def read_trace(prof, spans: Spans) -> dict:
    """busy_s, window_s, the DP kernels' device seconds and work, the top
    device operations and the idle gaps by host span, from a profiler run
    whose window is the `wmbench.window` span."""
    host = defaultdict(list)
    dev, by_op = [], defaultdict(float)
    ksec = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = str(e.device_type()).endswith("CUDA")
        if name.startswith(SPAN):
            # the card's copy of a span (gpu_user_annotation) is no work
            if not on_card:
                host[name[len(SPAN):]].append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif on_card and _device_work(e):
            s, d = e.start_ns(), e.duration_ns()
            dev.append((s, s + d))
            by_op[_short(name)] += d / 1e9
            for k, rx in KERNEL_RE.items():
                if rx.search(name):
                    ksec[k] += d / 1e9
    if not host.get("window"):
        raise RuntimeError("the trace holds no window span")
    w0, w1 = host["window"][0]
    busy = _merge(sorted((max(s, w0), min(e, w1)) for s, e in dev
                         if e > w0 and s < w1))
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(float)
    longest = defaultdict(float)
    marks = {k: np.array(sorted(v), np.int64).reshape(-1, 2)
             for k, v in host.items()}
    for s, e in gaps:
        mid = (s + e) // 2
        label = "outside"
        for span, lab in GAP_LABELS:
            m = marks.get(span)
            if m is not None and len(m):
                i = np.searchsorted(m[:, 0], mid, side="right") - 1
                if i >= 0 and m[i, 1] >= mid:
                    label = lab
                    break
        idle[label] += (e - s) / 1e9
        longest[label] = max(longest[label], (e - s) / 1e9)
    kernels = {}
    for k in ("extd", "exts"):
        cells = sum(c for kk, c, _ in spans.calls if kk == k)
        nbytes = sum(b for kk, _, b in spans.calls if kk == k)
        calls = sum(1 for kk, _, _ in spans.calls if kk == k)
        kernels[k] = {"device_s": ksec.get(k, 0.0), "cells": cells,
                      "bytes": nbytes, "calls": calls}
    gap_list = sorted(([f"{k}.total", v] for k, v in idle.items()),
                      key=lambda x: -x[1])
    gap_list += sorted(([f"{k}.longest", v] for k, v in longest.items()),
                       key=lambda x: -x[1])
    return {
        "busy_s": busy_s,
        "trace_window_s": (w1 - w0) / 1e9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": gap_list[:10],
        },
    }
