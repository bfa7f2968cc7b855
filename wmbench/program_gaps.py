"""The card's idle gaps put down to the program's own spans.

The port times its mapping path in spans (winnowmap_tpu_torch.device.span),
each the profiler range "wm.<name>" while a trace records.  `idle_by_span`
walks a traced window's profiler events once more: the idle gaps are those
of trace.read_trace (the same merged intervals of kernels, copies and
sets), each put down to the innermost wm. range that holds its midpoint,
under the benchmark's own label of the gap (trace.GAP_LABELS), as
"engine_host/eng_step"; a gap no wm. range holds keeps the benchmark's
label alone ("engine_host").  A program without the spans gives the
benchmark's labels alone.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

PROGRAM = "wm."


def _innermost(ranges, points):
    """For sorted points, the name of the latest-started range (s, e, name)
    holding each, or None: a sweep over the ranges sorted by start, the
    open ones on a stack (ranges of one thread nest)."""
    order = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, out, k = [], [], 0
    for p in points:
        while k < len(order) and order[k][0] <= p:
            stack.append(order[k])
            k += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_by_span(prof) -> dict:
    """{"gaps": {label: [total s, longest s]}, "named_pct": {benchmark
    label: % of its idle seconds inside a wm. range}, "unnamed": {"<wm.
    range ending before>..<wm. range starting after>": s of the gaps no
    wm. range holds, ten largest}, "wm_ranges": the wm. ranges that start
    in the window} from a profiler run whose window is the benchmark's
    `wmbench.window` span."""
    from .trace import GAP_LABELS, SPAN, _device_work, _merge

    bench = defaultdict(list)
    prog, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = str(e.device_type()).endswith("CUDA")
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        if name.startswith(SPAN) or name.startswith(PROGRAM):
            if on_card:  # the card's copy of a host range
                continue
            if name.startswith(SPAN):
                bench[name[len(SPAN):]].append(iv)
            else:
                prog.append(iv + (name[len(PROGRAM):],))
        elif on_card and _device_work(e):
            dev.append(iv)
    if not bench.get("window"):
        raise RuntimeError("the trace holds no window span")
    w0, w1 = bench["window"][0]
    busy = _merge(sorted((max(s, w0), min(e, w1)) for s, e in dev
                         if e > w0 and s < w1))
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    mids = [(s + e) // 2 for s, e in gaps]
    outer = [None] * len(gaps)
    for span, lab in reversed(GAP_LABELS):  # innermost label written last
        for i, hit in enumerate(_innermost(
                [iv + (lab,) for iv in bench.get(span, [])], mids)):
            outer[i] = hit or outer[i]
    inner = _innermost(prog, mids)
    by_end = sorted((e, n) for _, e, n in prog)
    by_start = sorted((s, n) for s, _, n in prog)
    total, longest = defaultdict(float), defaultdict(float)
    named, unnamed = defaultdict(float), defaultdict(float)
    for (s, e), mid, out, inn in zip(gaps, mids, outer, inner):
        d = (e - s) / 1e9
        out = out or "outside"
        label = out if inn is None else f"{out}/{inn}"
        total[label] += d
        longest[label] = max(longest[label], d)
        if inn is not None:
            named[out] += d
        else:
            i = bisect.bisect_right(by_end, (mid, "~")) - 1
            j = bisect.bisect_left(by_start, (mid, ""))
            before = by_end[i][1] if i >= 0 else "-"
            after = by_start[j][1] if j < len(by_start) else "-"
            unnamed[f"{before}..{after}"] += d
    by_outer = defaultdict(float)
    for label, d in total.items():
        by_outer[label.split("/")[0]] += d
    return {
        "gaps": {k: [total[k], longest[k]]
                 for k in sorted(total, key=lambda k: -total[k])},
        "named_pct": {k: 100.0 * named[k] / v for k, v in by_outer.items()
                      if v > 0},
        "unnamed": dict(sorted(unnamed.items(), key=lambda x: -x[1])[:10]),
        "wm_ranges": sum(1 for s, _, _ in prog if w0 <= s <= w1),
    }

