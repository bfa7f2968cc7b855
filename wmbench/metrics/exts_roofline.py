"""K3 exts DP (csrc/exts.cu): as extd_roofline, with 38 operations a live
cell of unbanded jobs."""
from wmbench import roofline


def read(rec):
    return roofline.share_pct("exts", rec)
