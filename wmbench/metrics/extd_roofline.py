"""K1 extd DP (csrc/extd.cu, ext_common.cuh): the least time its traced
work needs (the benchmark's own count of live cells, 47 operations a cell,
against 16.73 TOP/s, or its bytes against 3.35 TB/s, whichever is larger;
wmbench/roofline.py) over K1's device time in the profiler's trace."""
from wmbench import roofline


def read(rec):
    return roofline.share_pct("extd", rec)
