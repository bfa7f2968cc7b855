"""Anchor sets for holding the chain forward pass (C1, chain/device.py) to
its plain version and to native.chain_dp: chip_smoke.py and the tests
build their inputs here."""
from __future__ import annotations

import numpy as np


def anchor_set(rng, n: int, repeat: bool = False, n_clusters: int = 4):
    """(ax, ay) uint64, sorted by ax: n_clusters colinear runs of anchors
    of q_span 15 on rid 1, each at a random reference and query start with
    a random step of 5-59 and +-20 of jitter (tests/test_chain_device.py's
    sets).  repeat: each run revisits ~50 reference positions 7 apart, so
    the runs stay within Winnowmap's min_dist_x and the windows grow with
    the run."""
    xs, ys = [], []
    for _ in range(n_clusters):
        m = max(1, n // n_clusters)
        rx = rng.integers(0, 1 << 24)
        qy = rng.integers(0, 1 << 16)
        step = rng.integers(5, 60)
        x = rx + np.arange(m) * step + rng.integers(-20, 20, m)
        y = qy + np.arange(m) * step + rng.integers(-20, 20, m)
        if repeat:
            x = rx + (np.arange(m) % 50) * 7 + np.arange(m) // 50
        xs.append(np.maximum(x, 0))
        ys.append(np.maximum(y, 0))
    x = np.concatenate(xs).astype(np.uint64)
    y = np.concatenate(ys).astype(np.uint64)
    span = np.full(len(x), 15, np.uint64)
    rid = np.uint64(1) << np.uint64(32)
    ax = rid | (x & np.uint64(0xFFFFFFFF))
    ay = (span << np.uint64(32)) | (y & np.uint64(0xFFFFFFFF))
    o = np.argsort(ax, kind="stable")
    return ax[o], ay[o]
