"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (the profiler's timeline)."""


def read(rec):
    w = rec.get("trace_window_s")
    if not w or "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
