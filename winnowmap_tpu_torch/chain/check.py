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



def gapped_set(rng, n_noise: int = 1100, n_c1: int = 60):
    """(ax, ay) uint64, sorted by ax: colinear runs of anchors 5 apart
    (jitter 0-2, q_span 15) in the order of the reference: C0 (200
    anchors), C1 (n_c1 <= 150, below C0 on the query, so no C1 anchor
    chains to C0),
    n_noise anchors whose query positions lie above every other (no later
    anchor takes them as predecessors), and A (60), colinear with C0.  Under
    asm5's stage-2 gaps (max gap 16000, bw 2000) A's first anchor walks
    back over the noise into C1, takes C1's last anchor as its first new
    max and breaks on C1's marked anchors after max_skip (25) of them,
    short of C0, which would score higher: its f, pre and v hold only if
    the marks, f, pre and v of predecessors n_noise back are right.  With
    n_noise past C1's ring (1024 anchors) they are read from global
    memory.  At the largest max_skip whose walk still breaks in C1, one
    mark too few anywhere along C1 reaches C0."""
    def run(n, x0, y0):
        a = np.arange(n) * 5
        return (x0 + a + rng.integers(0, 3, n), y0 + a + rng.integers(0, 3, n))

    c1_end = 1100 + 5 * n_c1  # C1 stays below C0 on the query to 150
    xa = c1_end + 200 + n_noise
    parts = [run(200, 0, 2000), run(n_c1, 1100, 1150),
             (c1_end + 100 + np.arange(n_noise), 10**6 + np.arange(n_noise)),
             run(60, xa, xa + 2000)]
    x = np.concatenate([p[0] for p in parts])
    y = np.concatenate([p[1] for p in parts])
    span = np.full(len(x), 15, np.uint64)
    rid = np.uint64(1) << np.uint64(32)
    ax = rid | (x + (1 << 20)).astype(np.uint64)
    ay = (span << np.uint64(32)) | y.astype(np.uint64)
    o = np.argsort(ax, kind="stable")
    return ax[o], ay[o]


def short_sets(rng):
    """Short anchor sets, where a chain ends inside C1's wait for the
    producer warps' next 10 anchors: a colinear set of each length 1-12 and
    sets of 13-101 anchors whose lengths are not multiples of 8, every
    third repeat-rich."""
    sizes = list(range(1, 13)) + [13, 15, 17, 19, 23, 29, 37, 45, 63, 65,
                                  101]
    return [anchor_set(rng, n, repeat=(t % 3 == 2), n_clusters=1)
            for t, n in enumerate(sizes)]


def chain_sets():
    """chip_smoke.py's C1 check sets (numpy seed 20261016): 64 of 2k-20k
    anchors (every eighth repeat-rich), a repeat cluster of 9,000 anchors
    whose windows pass 8192, and gapped_set, whose walk reads predecessors
    outside C1's ring."""
    rng = np.random.default_rng(20261016)
    jobs = [anchor_set(rng, int(rng.integers(2000, 20000)),
                       repeat=(t % 8 == 0)) for t in range(64)]
    jobs.append(anchor_set(rng, 9000, repeat=True, n_clusters=1))
    jobs.append(gapped_set(rng))
    return jobs
