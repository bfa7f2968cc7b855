"""On-card smoke test of the PyTorch/CUDA port (winnowmap_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++.  Phases, each fatal on failure:
  1. card and toolchain: name and power limit, nvcc/g++ versions, build
     time of the native library and of the CUDA kernels, ptxas's
     registers and spills of every K1, K3, K4 and K2 instantiation;
  2. each kernel against its plain PyTorch version on the card:
     K1 extd DP and K2 traceback at the map-ont path's shape (B=512 jobs of
     length 1000, w=500) and on a ragged batch, map-ont and asm5 profiles,
     flags 0x18 0x0 0xC2 0x40 0x01; K4 extz DP and K2 on the same two
     batches under two single-cost profiles (-O 4,4 -E 2,2, and q = 61,
     e = 2, whose biased score byte wraps: max_sc = 128); K1's and K4's
     other launches (128 threads x 1-4 and 6-8 slots, the slot state in
     shared memory) on batches of 32 jobs whose span takes each, at flags
     0x18 and 0x0, and one long full-band job each (the slot state in
     global scratch) against native.extd / native.extz; K3 exts DP and
     K2's spliced form on B=256 spliced jobs (2-4 exons, 300-800 bases,
     1-3 canonical introns of 100-1500 bases, junction bytes on a third),
     splice profile at flags 0x508 (the splice path's) 0x500 0x600 0x318
     0x1C2 0x101 0x0, splice:hq at 0x508 0x600 0x318 0x1C2, and one long
     unbanded job (K3's large-band path, its slot state in global
     scratch); and K3's other launches (256 threads x 1 slot, 512 x 1,
     512 x 4, the slot state in shared memory) on batches of 32 spliced
     jobs whose widest band takes each, at flags 0x508 and 0x5C2;
     results and CIGARs must be exactly equal to the plain versions and to
     native.extd / native.extz / native.exts on a sample (K3's checks and
     K1's and K4's other launches run in three more processes, beside the
     main K1/K4 checks: the plain versions are bound by the host's Python);
     then kernel times from CUDA events, with the card to themselves;
  3. the port's CLI on the golden corpora (tests/data/golden): --sv-off
     byte-equal to golden_svoff.sam, sv-aware equal to golden_svon.sam up
     to the reference's uninitialised rep_len fields (at most 6 lines);
     -x splice byte-equal to golden_splice.paf and golden_splice_cs.paf
     (--cs), and to golden_splice.sam apart from @PG;
  4. map-ont SV-aware mapping at real read length: a 1 Mbp genome and 1000
     reads of 15 +- 5 kb at 8% error (tests/tools/make_testdata.py, seed 7),
     reads/s, STATS and kernel launch counts of the run, and K1's summed
     device time (CUDA events around its C launch entry) with its launches
     by launch and ring;
  5. spliced mapping (-x splice -a) at a real size: a 4 Mbp genome with 400
     genes and 5000 reads of their transcripts from both strands, made
     with numpy (seed 20261016); reads/s, STATS and launch counts; every
     K3 and traceback launch timed by CUDA events recorded around its C
     launch entry (their summed device time and share of the wall, K3's
     launches by flag and by launch, jobs and longest rows per call);
     then, for each launch K3 took, one of its calls run again through
     K3 and K2 and through their plain versions, exactly equal;
  6. single-cost mapping (map-ont SV-aware with -O 4,4 -E 2,2 -a) of phase
     4's corpus: every DP job through K4, none through K1; K4's device time
     and launches as K1's in phase 4;
  7. the cost probes P1-P3 (csrc/probes.cu): every probe kernel exactly
     equal to its plain version at a small shape (B=16, Wb=128, ROWS=32,
     KR=3, numpy seed 20261016: every P1 body, every P2 case, P3 levels
     0-6 under each dirs mode and the int32 state), and every case again
     at the shape it is timed at (P3 with 8 jobs and ~320 rows), P3 level
     6 once more at the full shape; then the P3 ladder (and again at 288
     rows, where no job stops early) and its variants, the P2 cases and
     the P1 bodies timed through their entry points, beside K1's row time
     from phase 2.
Phases 4-6 keep no DP job on the engine's host DP (eng_host_dp_calls 0).
It prints a "kernels" JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  It imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLD = REPO / "tests" / "data" / "golden"
DATA = REPO / "smoke_data"
DEVICE = "cuda"
MAP_ONT = (2, 4, 4, 2, 24, 1)  # a, b, q, e, q2, e2
ASM5 = (1, 19, 39, 3, 81, 1)
# one gap cost (-O 4,4 -E 2,2), and q + e = 63, where the biased score byte
# of wm_extz wraps (max_sc = 2 + 126 = 128); that profile's scores fall at
# once, so its jobs run without z-drop
EXTZ = (2, 4, 4, 2, 4, 2)
EXTZ_WRAP = (2, 4, 61, 2, 61, 2)
FLAGS = (0x18, 0x0, 0xC2, 0x40, 0x01)
# splice and splice:hq (a, b, q, e, q2, noncan, junc_bonus); the splice
# path's gap-filling jobs carry 0x508 (forward strand, flank, approx max)
SPLICE = (1, 2, 2, 1, 32, 9, 9)
SPLICE_HQ = (1, 4, 6, 1, 24, 9, 5)
SPLICE_FLAGS = (0x508, 0x100 | 0x400, 0x200 | 0x400, 0x300 | 0x18,
                0x100 | 0x40 | 0x02 | 0x80, 0x100 | 0x01, 0x00)
# splice:hq is checked on the flags whose cell paths differ most (the
# path's, the reverse strand, both strands with the approximate max, and
# right-aligned left extensions); splice takes all seven
SPLICE_HQ_FLAGS = (0x508, 0x200 | 0x400, 0x300 | 0x18,
                   0x100 | 0x40 | 0x02 | 0x80)
# H100 SXM peaks at 700 W: HBM3 3.35 TB/s (NVIDIA data sheet), and the
# INT32 ALU rate, 132 SMs x 64 INT32 lanes x 1.98 GHz (the clock behind the
# data sheet's 67 TFLOP/s float32 = 132 x 128 lanes x 2 x 1.98 GHz); both
# kernels are scalar integer code, which the tensor cores' int8 rate does
# not cover
HBM_BPS = 3.35e12
INT32_OPS = 132 * 64 * 1.98e9
# Integer operations the function needs, counted from the scalar reference
# (native/src/wm_ksw.cpp), not from the kernels: no loads or stores, no
# address arithmetic, no range or boundary tests that the reference makes
# once per row, and no row max (the timed flags take the approximate max).
# Per live cell of wm_extd (:1514-1586): score 6 (two N tests, their or,
# the base compare, two selects), candidates a b a2 b2 4, max and
# direction 12 (compare, select, max per candidate), clamp 1, u v 2,
# z-q z-q2 an bn a2n b2n 6, continue tests 4, x y x2 y2 8 (select,
# subtract), direction bits 4.
OPS_PER_CELL = 47
# per live cell of wm_exts (:1847-1913): score 6, candidates a b a2
# a2+acceptor 4, max and direction 9, u v 2, z-q z-q2 an bn a2n 5,
# continue tests 3 (a2n against the donor), x y x2 6, direction bits 3
OPS_PER_CELL_EXTS = 38
# per live cell of wm_extz (:1290-1329): score 6, z = s + 2(q+e) and the
# candidates a b 3, max and direction 6 (compare, select, max for a;
# compare, select for b; b's unsigned max), max_sc cap 1, u v 2, z-q an bn
# 3, continue tests 2, x y selects 2, direction bits 2
OPS_PER_CELL_EXTZ = 27
# per traceback step of traceback_intron (:80-99): r = i + j 1, band tests
# 2 and their selects 2, state machine 8 (state == 0, d & 7, state + 2,
# shift, & 1, select, state == 0, select), forced state 1, op choice 5
# (state == 0, == 1, == 3, two selects), i and j 2, the walk's test 2
OPS_PER_STEP = 23


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True)


def band_cells(jobs_np, res_np):
    """Live band cells (wm_extd's [st0, en0] per computed row) and
    rounded-band cells (direction bytes written) this batch's data needs;
    a z-dropped job is counted up to its maximum's anti-diagonal."""
    live = wide = 0
    for j, r9 in zip(jobs_np, res_np):
        ql, tl, w = int(j[1]), int(j[4]), int(j[6])
        R = ql + tl - 1
        if r9[1]:
            R = max(0, int(r9[2]) + int(r9[3]) + 1)
        r = np.arange(R)
        st0 = np.maximum(np.maximum(0, r - ql + 1), (r - w + 1) >> 1)
        en0 = np.minimum(np.minimum(tl - 1, r), (r + w) >> 1)
        ok = st0 <= en0
        live += int((en0 - st0 + 1)[ok].sum())
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        wide += int((en - st + 1)[ok].sum())
    return live, wide


def phase2(K, check, native, torch, gen_simple_mat, B=512, n=1000, w=500,
           n_ragged=48):
    """K1, K4 and K2 against their plain versions at the main path's shape
    (B jobs of length n, band w) and on a ragged batch; returns the largest
    errors and the main batch, for phase2_times."""
    rng = np.random.default_rng(20261016)
    main = check.random_jobs(rng, [n] * B, w, 400)
    ragged_lens = rng.integers(50, 1500, n_ragged - 1)
    ragged_ws = rng.choice([64, 97, 500, 751, -1], n_ragged)
    ragged = check.random_jobs(rng, ragged_lens, ragged_ws,
                               rng.choice([40, 200, 400], n_ragged),
                               dissimilar=True)
    checks = []
    for name, (qp, tp, jobs, qs, ts) in (("main", main), ("ragged", ragged)):
        for prof in (MAP_ONT, ASM5, EXTZ, EXTZ_WRAP):
            mat = gen_simple_mat(prof[0], prof[1], 1)
            for flag in FLAGS:
                if name == "main" and (prof in (ASM5, EXTZ_WRAP)
                                       or flag not in (0x18, 0x0)):
                    continue
                pj = jobs
                if prof is EXTZ_WRAP:
                    pj = jobs.copy()
                    pj[:, 7] = -1
                eb = rng.integers(0, 60, len(jobs))
                checks.append((name, prof, flag, qp, tp, pj, qs, ts, mat, eb))
    max_err = {"extd": 0, "extz": 0, "traceback": 0}
    for name, prof, flag, qp, tp, jobs, qs, ts, mat, eb in checks:
        c = check.OnDevice(DEVICE, qp, tp, jobs, mat, prof[2:], flag, eb)
        dp = c.dp_name
        err, res_k, ops_k, fin_k = check.check_against_plain(c)
        torch.cuda.synchronize()
        for k in (dp, "traceback"):
            max_err[k] = max(max_err[k], err[k])
        if err[dp] or err["traceback"]:
            fail(f"kernels != plain on {name} {prof} flag {flag:#x}: "
                 f"max abs err {err}")
        res_np = res_k.cpu().numpy()
        if not (flag & K.EZ_SCORE_ONLY):
            cig = c.cigars(native, ops_k, fin_k)
        # the native oracle on a sample of jobs
        sample = range(0, len(jobs), max(1, len(jobs) // 16))
        for i in sample:
            qq = qs[i][::-1] if jobs[i, 2] else qs[i]
            tt = ts[i][::-1] if jobs[i, 5] else ts[i]
            h = c.native(native, i, qq, tt)
            hv = [h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t,
                  h.mte, h.mte_q, h.score]
            if res_np[i, :9].tolist() != hv:
                fail(f"{dp} kernel != native.{dp} on {name} {prof} flag "
                     f"{flag:#x} job {i}: {res_np[i, :9].tolist()} vs {hv}")
            if not (flag & K.EZ_SCORE_ONLY) and not np.array_equal(
                    cig[i], h.cigar):
                fail(f"CIGAR != native.{dp} on {name} {prof} flag "
                     f"{flag:#x} job {i}")
        log(f"[phase 2] {name:6s} {dp} a={prof[0]} q={prof[2]} "
            f"flag={flag:#04x} B={len(jobs)} ({c.ext.path}, ring "
            f"{c.ext.ring}): {dp}, K2 == plain on every job; == native.{dp} "
            f"on a sample")
    return max_err, main


def phase2_times(K, check, torch, gen_simple_mat, max_err, main):
    """K1 and K2, and K4, timed at the main path's shape (map-ont, the
    bench's flag 0x18; K4 on the same batch under -O 4,4 -E 2,2); returns
    their records and K1's launch there (ms, rows, jobs, threads, blocks per
    SM) for phase 7."""
    qp, tp, jobs, _, _ = main
    shape = f"B={len(jobs)} len={jobs[0, 4]} w={jobs[0, 6]} flag=0x18"
    rec, k1 = [], None
    for prof, ops, names in (
            (MAP_ONT, OPS_PER_CELL, (
                ("extd_dp", "extd.cu",
                 "winnowmap_tpu/extend/pallas_kernel.py:124"),
                ("traceback", "traceback.cu",
                 "winnowmap_tpu/extend/pallas_kernel.py:1075"))),
            (EXTZ, OPS_PER_CELL_EXTZ, (
                ("extz_dp", "extz.cu",
                 "winnowmap_tpu/extend/pallas_kernel.py:1969"),))):
        c = check.OnDevice(DEVICE, qp, tp, jobs,
                           gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                           0x18, 0)
        rec += time_kernels(K, torch, c, max_err, ops, names, shape)
        if k1 is None:
            # K1's launch at this batch, for its row time beside P3's
            k1 = {"ms": rec[0]["ms"], "rows": int(c.geo.rows.max()),
                  "B": len(jobs), "launch": c.ext.path, "ring": c.ext.ring,
                  "threads": c.ext.threads,
                  "blocks_per_sm": K.extd_occupancy(c.ext)}
    return rec, k1


def time_kernels(K, torch, c, max_err, ops_per_cell, names, shape):
    """CUDA-event times of the DP kernel and, when names holds a second
    record, K2 on c's batch; their plain versions' host-clock times, and
    each one's bound from this batch's data; returns one record per name."""
    from winnowmap_tpu_torch.tools import time_ms

    dev = torch.device(DEVICE)
    saved = dict(K.LAUNCHES)
    res, dirs = c.k1()
    start = c.starts(res)
    k1_ms = time_ms(c.k1, dev, 5)
    t0 = time.perf_counter()
    c.k1_plain()
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    with_k2 = len(names) > 1
    if with_k2:
        k2_ms = time_ms(lambda: c.k2(dirs, start), dev, 5)
        t0 = time.perf_counter()
        c.k2_plain(dirs, start)
        torch.cuda.synchronize()
        k2_plain_ms = (time.perf_counter() - t0) * 1e3
        fin = c.k2(dirs, start)[1].cpu().numpy()
        st_np = start.cpu().numpy()
        steps = int(((st_np[:, 0] - fin[:, 0])
                     + (st_np[:, 1] - fin[:, 1])).sum())
    res_np = res.cpu().numpy()
    live, wide = band_cells(c.jobs_np, res_np)
    K.LAUNCHES.update(saved)  # comparison launches are not main-path ones
    jobs = c.jobs_np
    B = len(jobs)
    # bytes: each input read once (sequences, job rows, dirs offsets, and
    # junction bytes), each output written once (direction bytes, results)
    jbytes = 0 if c.jpool is None else c.jpool.numel() + 8 * B
    k1_bytes = (int(jobs[:, 1].sum() + jobs[:, 4].sum()) + B * (64 + 8)
                + jbytes + wide + B * 64)
    k1_ops = live * ops_per_cell
    timed = [(k1_ms, k1_plain_ms, k1_bytes, k1_ops, max_err[c.dp_name])]
    if with_k2:
        # one direction byte read and one op byte written per step, plus
        # the job rows, offsets, starts and the remaining (i, j)
        k2_bytes = 2 * steps + B * (64 + 8 + 8) + B * 8
        timed.append((k2_ms, k2_plain_ms, k2_bytes, steps * OPS_PER_STEP,
                      max_err["traceback"]))
    rec = []
    for (nm, src, rep), (ms, pms, by, op, err) in zip(names, timed):
        tb, to = by / HBM_BPS * 1e3, op / INT32_OPS * 1e3
        rec.append({"name": nm, "route": "cuda",
                    "source": f"winnowmap_tpu_torch/csrc/{src}",
                    "replaces": rep, "launches": 0, "max_abs_err": err,
                    "ms": ms, "plain_ms": pms, "bound_ms": max(tb, to),
                    "bound_by": "bytes" if tb >= to else "operations",
                    "library_ms": None})
    log(f"[phase 2] {names[0][0]} at {shape}: {k1_ms:.3f} ms "
        f"({live / k1_ms / 1e6:.2f} Gcells/s live, {wide} dirs bytes); "
        f"plain {k1_plain_ms:.1f} ms; bound {rec[0]['bound_ms']:.4f} ms")
    if with_k2:
        log(f"[phase 2] {names[1][0]}: {k2_ms:.3f} ms ({steps} steps); "
            f"plain {k2_plain_ms:.1f} ms; bound {rec[1]['bound_ms']:.5f} ms")
    return rec


# K1's and K4's launches besides the main batch's (128 x 5), each with the
# job lengths and band widths whose span takes it (rings of 128 x 1-4 and
# 6-8 lanes, and full bands of 1100-1400 bp: the memory path, its slot
# state in shared memory)
EXT_LAUNCH_BATCHES = (("reg128x1", (150, 320), (33, 64)),
                      ("reg128x2", (300, 520), (97, 150)),
                      ("reg128x3", (450, 700), (220, 300)),
                      ("reg128x4", (550, 800), (350, 440)),
                      ("reg128x6", (850, 1100), (600, 700)),
                      ("reg128x7", (1000, 1250), (730, 820)),
                      ("reg128x8", (1100, 1400), (860, 950)),
                      ("mem-smem", (1100, 1400), (-1,)))


def phase2_ext_launches(B=32):
    """K1 (map-ont) and K4 (-O 4,4 -E 2,2) with K2 against their plain
    versions at each launch of EXT_LAUNCH_BATCHES on B jobs at flags 0x18
    and 0x0, and one long full-band job each (16800 bp: the slot state in
    global scratch) against native.extd / native.extz; returns the largest
    errors.  Runs in a process of its own, beside phase2."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(20261018)
    max_err = {"extd": 0, "extz": 0, "traceback": 0}
    for path, (lo, hi), ws in EXT_LAUNCH_BATCHES:
        qp, tp, jobs, _, _ = check.random_jobs(
            rng, rng.integers(lo, hi, B - 1), rng.choice(ws, B),
            rng.choice([40, 200, 400], B), dissimilar=True)
        for prof in (MAP_ONT, EXTZ):
            for flag in (0x18, 0x0):
                c = check.OnDevice(DEVICE, qp, tp, jobs,
                                   gen_simple_mat(prof[0], prof[1], 1),
                                   prof[2:], flag, rng.integers(0, 60, B))
                if c.ext.path != path:
                    fail(f"the batch for K1/K4's {path} launch took "
                         f"{c.ext.path}")
                err, _, _, _ = check.check_against_plain(c)
                torch.cuda.synchronize()
                for k in err:
                    max_err[k] = max(max_err[k], err[k])
                if any(err.values()):
                    fail(f"{c.dp_name}, K2 != plain at {path} flag "
                         f"{flag:#x}: max abs err {err}")
                log(f"[phase 2] {c.dp_name} {path:9s} flag={flag:#04x} B={B} "
                    f"(ring {c.ext.ring}, {int(c.geo.rows.max())} rows): "
                    f"{c.dp_name}, K2 == plain on every job")
    # one long job: a full band of ~16800 lanes, the slot state in global
    # scratch
    t = rng.integers(0, 4, 16800).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    qp = np.concatenate([q, np.zeros(16, np.uint8)])
    tp = np.concatenate([t, np.zeros(16, np.uint8)])
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    for prof in (MAP_ONT, EXTZ):
        c = check.OnDevice(DEVICE, qp, tp, jobs,
                           gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                           0x0, 0)
        saved = dict(K.LAUNCHES)
        res, dirs = c.k1()
        ops, fin = c.k2(dirs, c.starts(res))
        K.LAUNCHES.update(saved)
        h = c.native(native, 0, q, t)
        if c.ext.path != "mem-global" or res[0, :9].tolist() != [
                h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t,
                h.mte, h.mte_q, h.score] or not np.array_equal(
                    c.cigars(native, ops, fin)[0], h.cigar):
            fail(f"the long full-band job differs from native.{c.dp_name} "
                 f"({c.ext.path})")
        log(f"[phase 2] long {c.dp_name} job {len(q)} x {len(t)} "
            f"({c.ext.path}, ring {c.ext.ring}) == native.{c.dp_name}")
    return max_err


def phase2_splice(B=256):
    """K3 and K2's spliced form against their plain versions on B spliced
    jobs per flag and profile, and a long unbanded job against native.exts;
    returns the largest errors.  Runs in a second process while phase2
    checks K1 and K4: the plain versions keep a host core busy and leave
    the card idle, so the two overlap."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(20261016)
    batches = {rev: check.spliced_jobs(rng, B, rev=rev)
               for rev in (False, True)}
    max_err = {"exts": 0, "traceback": 0}
    n_intron = 0
    for pname, prof, flags in (("splice", SPLICE, SPLICE_FLAGS),
                               ("splice:hq", SPLICE_HQ, SPLICE_HQ_FLAGS)):
        a, b, q, e, q2, noncan, jb = prof
        mat = gen_simple_mat(a, b, 1)
        for flag in flags:
            qp, tp, jobs, qs, ts, js = batches[bool(flag & K.EZ_REV_CIGAR)]
            c = check.OnDevice(DEVICE, qp, tp, jobs, mat, (q, e, q2), flag,
                               0, splice=(noncan, jb), juncs=js)
            err, res_k, ops_k, fin_k = check.check_against_plain(c)
            torch.cuda.synchronize()
            for k in max_err:
                max_err[k] = max(max_err[k], err[k])
            if err["exts"] or err["traceback"]:
                fail(f"spliced kernels != plain on {pname} flag {flag:#x}: "
                     f"max abs err {err}")
            res_np = res_k.cpu().numpy()
            cig = (None if flag & K.EZ_SCORE_ONLY
                   else c.cigars(native, ops_k, fin_k))
            for i in range(0, B, B // 16):
                h = native.exts(qs[i], ts[i], mat, q, e, q2, noncan,
                                int(jobs[i, 7]), jb, flag, junc=js[i])
                hv = [h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe,
                      h.mqe_t, h.mte, h.mte_q, h.score]
                if res_np[i, :9].tolist() != hv:
                    fail(f"K3 != native.exts on {pname} flag {flag:#x} job "
                         f"{i}: {res_np[i, :9].tolist()} vs {hv}")
                if cig is not None:
                    if not np.array_equal(cig[i], h.cigar):
                        fail(f"spliced CIGAR != native.exts on {pname} flag "
                             f"{flag:#x} job {i}")
                    n_intron += int(((h.cigar & 15) == 3).any())
            log(f"[phase 2] {pname:9s} flag={flag:#05x} B={B}: K3, K2 "
                f"== plain on every job; == native.exts on a sample")
    if n_intron == 0:
        fail("no sampled spliced job has an intron")
    # one long job: shorter side above 8192 lanes, K3's slot state in
    # global scratch (the large-band path)
    a, b, q, e, q2, noncan, jb = SPLICE
    mat = gen_simple_mat(a, b, 1)
    qp, tp, jobs, qs, ts, _ = check.spliced_jobs(
        rng, 1, junc_frac=0, exon_total=(8600, 8600), n_exons=(4, 4))
    c = check.OnDevice(DEVICE, qp, tp, jobs, mat, (q, e, q2), 0x508, 0,
                       splice=(noncan, jb))
    saved = dict(K.LAUNCHES)
    res, dirs = c.k1()
    ops, fin = c.k2(dirs, c.starts(res))
    K.LAUNCHES.update(saved)
    h = native.exts(qs[0], ts[0], mat, q, e, q2, noncan, int(jobs[0, 7]), jb,
                    0x508)
    if res[0, :9].tolist() != [h.max, int(h.zdropped), h.max_q, h.max_t,
                               h.mqe, h.mqe_t, h.mte, h.mte_q, h.score] \
            or not np.array_equal(c.cigars(native, ops, fin)[0], h.cigar):
        fail("the long unbanded job differs from native.exts")
    log(f"[phase 2] long spliced job {jobs[0, 1]} x {jobs[0, 4]} (K3 "
        f"{c.k3.path}, ring {c.k3.ring} lanes) == native.exts")
    return max_err


# K3's launches besides those of phase2_splice's batches (512 x 2) and
# long job (the memory path in global scratch), each with the exon total
# (check.spliced_jobs) whose widest band needs it: bands up to 192, 448,
# 1984 and 4032 lanes take rings of 256, 512, 2048 and 4096
K3_LAUNCH_BATCHES = (("reg256x1", (100, 170)), ("reg512x1", (260, 420)),
                     ("reg512x4", (1100, 1900)), ("mem-smem", (2200, 3000)))


def phase2_splice_launches(B=32):
    """K3 and K2's spliced form against their plain versions at each of
    K3's launches in K3_LAUNCH_BATCHES: B spliced jobs of 2-3 exons
    (introns of 80-400 bases, junction bytes on a third) at flags 0x508
    (the splice path's) and 0x5C2 (the exact max, right-aligned reversed
    extensions); returns the largest errors.  Runs in a process of its
    own, beside phase2 and phase2_splice."""
    import torch

    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(20261017)
    a, b, q, e, q2, noncan, jb = SPLICE
    mat = gen_simple_mat(a, b, 1)
    max_err = {"exts": 0, "traceback": 0}
    for path, exon_total in K3_LAUNCH_BATCHES:
        for flag in (0x508, 0x5C2):
            qp, tp, jobs, _, _, js = check.spliced_jobs(
                rng, B, rev=bool(flag & K.EZ_REV_CIGAR),
                exon_total=exon_total, n_exons=(2, 3), intron_len=(80, 400))
            c = check.OnDevice(DEVICE, qp, tp, jobs, mat, (q, e, q2), flag,
                               0, splice=(noncan, jb), juncs=js)
            if c.k3.path != path:
                fail(f"the batch for K3's {path} launch took {c.k3.path}")
            err, _, _, _ = check.check_against_plain(c)
            torch.cuda.synchronize()
            for k in max_err:
                max_err[k] = max(max_err[k], err[k])
            if err["exts"] or err["traceback"]:
                fail(f"spliced kernels != plain at K3 {path} flag "
                     f"{flag:#x}: max abs err {err}")
            log(f"[phase 2] K3 {path:9s} flag={flag:#05x} B={B} (ring "
                f"{c.k3.ring}, {int(c.geo.rows.max())} rows): K3, K2 == "
                f"plain on every job")
    return max_err


def phase2_splice_times(K, check, torch, gen_simple_mat, max_err, B=256):
    """K3 and K2's spliced form timed as the engine calls them (flag 0x508,
    no junction bytes) on phase2_splice's first batch; returns their
    records."""
    rng = np.random.default_rng(20261016)
    qp, tp, jobs, _, _, _ = check.spliced_jobs(rng, B)
    c = check.OnDevice(DEVICE, qp, tp, jobs, gen_simple_mat(1, 2, 1),
                       SPLICE[2:5], 0x508, 0, splice=SPLICE[5:])
    return time_kernels(K, torch, c, max_err, OPS_PER_CELL_EXTS, (
        ("exts_dp", "exts.cu", "winnowmap_tpu/extend/pallas_kernel.py:879"),
        ("traceback_splice", "traceback.cu",
         "winnowmap_tpu/extend/pallas_kernel.py:1075")),
        f"B={B} spliced flag=0x508")


# --------------------------------------------------------------------------
# main path
# --------------------------------------------------------------------------

def assert_equal_mod_ub(ours, gold, mapq_field):
    """Byte equality except MAPQ + rl on reads hit by the reference's
    uninitialized-rep_len UB (reference map.c:281 vs 917); returns how many
    lines differ."""
    ol, gl = ours.splitlines(), gold.splitlines()
    if len(ol) != len(gl):
        fail(f"line counts differ: {len(ol)} vs {len(gl)}")
    n_ub = 0
    for o, g in zip(ol, gl):
        if o == g:
            continue
        of, gf = o.split("\t"), g.split("\t")
        if len(of) != len(gf):
            fail(f"field counts differ: {o[:120]} / {g[:120]}")
        diffs = [(i, a, b) for i, (a, b) in enumerate(zip(of, gf)) if a != b]
        if not all((a.startswith("rl:i:") and b.startswith("rl:i:"))
                   or i == mapq_field for i, a, b in diffs):
            fail(f"line differs beyond rl/MAPQ: {diffs[:3]}")
        if not any(a == "rl:i:0" for _, a, b in diffs):
            fail(f"rl/MAPQ difference without rl:i:0: {diffs[:3]}")
        n_ub += 1
    return n_ub


def strip_pg(s):
    return "\n".join(ln for ln in s.splitlines() if not ln.startswith("@PG"))


def phase3(cli):
    args = ["-a", "-W", str(GOLD / "t_rep_k15.txt"), str(GOLD / "t_ref.fa"),
            str(GOLD / "t_reads.fa")]
    for sv in (False, True):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main((["--sv-off"] if sv is False else []) + args)
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI exited {rc}")
        if not sv:
            gold = (GOLD / "golden_svoff.sam").read_text()
            if strip_pg(buf.getvalue()) != strip_pg(gold):
                fail("--sv-off SAM differs from golden_svoff.sam")
            log(f"[phase 3] --sv-off SAM == golden_svoff.sam ({dt:.2f} s)")
        else:
            gold = (GOLD / "golden_svon.sam").read_text()
            n_ub = assert_equal_mod_ub(strip_pg(buf.getvalue()),
                                       strip_pg(gold), 4)
            if n_ub > 6:
                fail(f"{n_ub} sv-aware lines differ mod UB (max 6)")
            log(f"[phase 3] sv-aware SAM == golden_svon.sam mod UB "
                f"({n_ub} lines, {dt:.2f} s)")
    sargs = ["-W", str(GOLD / "s_rep_k15.txt"), str(GOLD / "s_ref.fa"),
             str(GOLD / "s_reads.fa")]
    for extra, golden in ((["-c"], "golden_splice.paf"),
                          (["-a"], "golden_splice.sam"),
                          (["-c", "--cs"], "golden_splice_cs.paf")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-x", "splice"] + extra + sargs)
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI -x splice {extra} exited {rc}")
        gold = (GOLD / golden).read_text()
        ours = buf.getvalue()
        if golden.endswith(".sam"):
            ours, gold = strip_pg(ours), strip_pg(gold)
        if ours != gold:
            fail(f"-x splice {' '.join(extra)} differs from {golden}")
        log(f"[phase 3] -x splice {' '.join(extra)} == {golden} "
            f"({dt:.2f} s)")


def rep_kmers(seqs, k: int, frac: float):
    """Canonical k-mer counts over the 0..3 codes of all sequences, and the
    k-mers whose count is above the threshold that covers `frac` of the
    distinct k-mers (meryl 'print greater-than distinct=frac')."""
    sh = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    cans = []
    for codes in seqs:
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        win = win[(win < 4).all(1)].astype(np.uint64)
        fwd = (win << sh).sum(1, dtype=np.uint64)
        rev = ((3 - win[:, ::-1]) << sh).sum(1, dtype=np.uint64)
        cans.append(np.minimum(fwd, rev))
    kmers, counts = np.unique(np.concatenate(cans), return_counts=True)
    vals, occ = np.unique(counts, return_counts=True)
    idx = int(np.searchsorted(np.cumsum(occ), int(frac * len(kmers))))
    thr = int(vals[min(idx, len(vals) - 1)])
    sel = counts > thr
    return kmers[sel], counts[sel]


def kmer_str(x: int, k: int) -> str:
    return "".join("ACGT"[(x >> (2 * (k - 1 - i))) & 3] for i in range(k))


class EntryTimer:
    """While the block runs: CUDA events recorded on the current stream just
    around each call of the named C launch entries, patched on
    `_build.load()`'s namespace, where the wrappers look them up."""

    def __init__(self, torch, entries):
        from winnowmap_tpu_torch.extend import _build

        self.torch = torch
        self.api = _build.load()
        self.entry = {name: getattr(self.api, name) for name in entries}
        self.events = {name: [] for name in entries}

    def __enter__(self):
        for name in self.entry:
            setattr(self.api, name, self._timed(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.entry.items():
            setattr(self.api, name, fn)

    def _timed(self, name):
        fn, events, torch = self.entry[name], self.events[name], self.torch

        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            rc = fn(*args)
            z.record()
            events.append((a, z))
            return rc
        return timed

    def ms(self, name):
        """The device ms of each timed call of entry `name`."""
        self.torch.cuda.synchronize()
        return [a.elapsed_time(z) for a, z in self.events[name]]


class ExtTimer(EntryTimer):
    """An EntryTimer around K1's (mode "extd") or K4's ("extz") C launch
    entry, and each K.ext_launch call of that mode counted by its
    ExtGeometry's launch and ring."""

    def __init__(self, torch, K, mode):
        import inspect

        self.mode, self.name = mode, f"wm_{mode}_launch"
        super().__init__(torch, (self.name,))
        self.K, self.ext_launch = K, K.ext_launch
        self.sig = inspect.signature(K.ext_launch)
        self.launches = {}

    def __enter__(self):
        self.K.ext_launch = self._count
        return super().__enter__()

    def __exit__(self, *exc):
        self.K.ext_launch = self.ext_launch
        super().__exit__(*exc)

    def _count(self, *args, **kw):
        call = self.sig.bind(*args, **kw).arguments
        if call["mode"] == self.mode:
            key = f"{call['geo'].path}/{call['geo'].ring}"
            self.launches[key] = self.launches.get(key, 0) + 1
        return self.ext_launch(*args, **kw)

    def summary(self, wall_s):
        """Summed device ms, launches, share of the wall, and launches by
        launch/ring."""
        ms = float(sum(self.ms(self.name)))
        return {"ms": ms, "launches": len(self.events[self.name]),
                "share": ms / 1e3 / wall_s, "by_launch": self.launches}


def map_timed(torch, K, batch, mi, mo, seqs, names, mode):
    """map_batch on the reads after a warm-up on eight, with the launch
    counts and STATS zeroed first and the DP kernel (mode "extd" or
    "extz") timed; returns (results, wall s, launches, STATS, the timer's
    summary)."""
    batch.map_batch(mi, mo, seqs[:8], names[:8])
    torch.cuda.synchronize()
    batch.STATS.clear()
    K.reset_launches()
    with ExtTimer(torch, K, mode) as timer:
        t0 = time.perf_counter()
        results = batch.map_batch(mi, mo, seqs, names)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = {k: round(float(v), 6) for k, v in batch.STATS.items()}
    return results, dt, launches, st, timer.summary(dt)


def log_device(phase, kname, dev, st):
    log(f"[{phase}] {kname} device time: {dev['ms']:.3f} ms over "
        f"{dev['launches']} launches ({100 * dev['share']:.2f}% of the "
        f"wall; dispatch_s {st.get('dispatch_s')}, dev_wait_s "
        f"{st.get('dev_wait_s')}); by launch/ring {dev['by_launch']}")
    log(f"[{phase}] JSON " + json.dumps({
        "kernel": kname, "device": dev, "dispatch_s": st.get("dispatch_s"),
        "dev_wait_s": st.get("dev_wait_s")}))


def phase4(torch, K, build, fastx, options, batch, seqcode):
    DATA.mkdir(exist_ok=True)
    pre = DATA / "wmbench2"
    ref, reads = Path(f"{pre}_ref.fa"), Path(f"{pre}_reads.fa")
    if not (ref.exists() and reads.exists()):
        run([sys.executable, str(REPO / "tests/tools/make_testdata.py"),
             "--out-prefix", str(pre), "--genome-len", "1000000",
             "--n-reads", "1000", "--read-len", "15000",
             "--read-len-jitter", "5000", "--error", "0.08", "--seed", "7",
             "--n-chroms", "2"])
    recs = fastx.read_all(str(ref))
    codes = np.concatenate([seqcode.encode(r.seq) for r in recs])
    t0 = time.perf_counter()
    kmers, cnt = rep_kmers([seqcode.encode(r.seq) for r in recs], 15, 0.9998)
    rep = DATA / "wmbench2_rep.txt"
    with open(rep, "w") as f:
        for x, c in zip(kmers.tolist(), cnt.tolist()):
            f.write(f"{kmer_str(x, 15)}\t{c}\n")
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("map-ont", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    wset = build.load_weight_set(str(rep), io_.k)
    mi = build.build_index(recs, io_.w, io_.k, io_.flag, wset)
    options.update_mid_occ(mo, mi)
    log(f"[phase 4] corpus {len(codes)} bp, {len(wset)} repetitive 15-mers,"
        f" index {len(mi.keys)} keys ({time.perf_counter() - t0:.1f} s)")
    rs = fastx.read_all(str(reads))
    seqs, names = [r.seq for r in rs], [r.name for r in rs]
    results, dt, launches, st, dev = map_timed(
        torch, K, batch, mi, mo, seqs, names, "extd")
    n_mapped = sum(1 for r in results if r.regs)
    log(f"[phase 4] mapped {len(seqs)} reads ({sum(map(len, seqs))} bp) in "
        f"{dt:.3f} s -> {len(seqs) / dt:.3f} reads/s; {n_mapped} with hits")
    log(f"[phase 4] launches {launches}; dev_jobs {int(st['dev_jobs'])} vs "
        f"engine host-kept {int(st.get('eng_host_dp_calls', 0))}")
    log("[phase 4] STATS " + json.dumps(st, sort_keys=True))
    log_device("phase 4", "K1", dev, st)
    if launches["extd"] == 0 or launches["traceback"] == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    check_mapped("phase 4", st, results, len(seqs))
    return launches, (mi, seqs, names)


def check_mapped(phase, st, results, n_reads):
    """Every exported DP job came back from the kernel path, none stayed on
    the engine's host DP, at least 90% of the reads mapped, and every
    region carries a well-formed alignment."""
    if st["delivered_jobs"] != st["dev_jobs"] or st["dev_jobs"] <= 0:
        fail(f"{phase}: not every exported DP job was delivered from the "
             "kernel path")
    if st.get("eng_host_dp_calls", 0) != 0:
        fail(f"{phase}: {int(st['eng_host_dp_calls'])} DP jobs stayed on "
             "the engine's host DP")
    n_mapped = sum(1 for r in results if r.regs)
    if n_mapped < 0.9 * n_reads:
        fail(f"{phase}: only {n_mapped} of {n_reads} reads mapped")
    for r in results:
        for g in r.regs:
            if g.p is None or not (0 <= g.qs <= g.qe and g.rs <= g.re):
                fail(f"{phase}: malformed alignment record")


def splice_corpus(check, ref: Path, reads: Path, seed: int = 20261016,
                  genome_len: int = 4_000_000, n_genes: int = 400,
                  n_reads: int = 5000):
    """A genome of two chromosomes with n_genes genes, one per slot of
    genome_len / n_genes bases, half of them on the reverse strand: 4-12
    exons of 60-400 bases joined by canonical GT..AG introns of 80-8000
    bases (log-uniform, scaled down to fit the slot); and n_reads reads,
    each a transcript from either strand cut at its 5' end to 40-100% of
    its length, at 4% substitutions and 2% indels."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    slot = genome_len // n_genes
    tx = []
    for k in range(n_genes):
        ne = int(rng.integers(4, 13))
        exons = [rng.integers(0, 4, int(n)).astype(np.uint8)
                 for n in rng.integers(60, 401, ne)]
        il = np.exp(rng.uniform(np.log(80), np.log(8000), ne - 1))
        room = slot - 400 - sum(map(len, exons))
        if il.sum() > room:
            il = np.maximum(80, il * room / il.sum())
        parts = [exons[0]]
        for n, ex in zip(il.astype(int), exons[1:]):
            intron = rng.integers(0, 4, n).astype(np.uint8)
            intron[:2], intron[-2:] = (2, 3), (0, 2)
            parts += [intron, ex]
        gene = np.concatenate(parts)
        if rng.random() < 0.5:  # reverse strand: CT..AC in the genome
            gene = (3 - gene)[::-1]
        o = k * slot + 200
        g[o:o + len(gene)] = gene
        tx.append(np.concatenate(exons))
    half = genome_len // 2
    with open(ref, "w") as f:
        for i, (a, b) in enumerate(((0, half), (half, genome_len))):
            f.write(f">chr{i + 1}\n")
            f.write("".join("ACGT"[c] for c in g[a:b].tolist()) + "\n")
    with open(reads, "w") as f:
        for i in range(n_reads):
            t = tx[int(rng.integers(0, n_genes))]
            t = t[len(t) - int(len(t) * rng.uniform(0.4, 1.0)):]
            if rng.random() < 0.5:
                t = (3 - t)[::-1]
            r = check.mutate_rates(rng, t, 0.04, 0.02)
            f.write(f">tx{i}\n" + "".join("ACGT"[c] for c in r.tolist())
                    + "\n")


class LaunchTimer(EntryTimer):
    """An EntryTimer around K3's and K2's C launch entries (wm_exts_launch,
    wm_traceback_launch), and each K.exts_dp call's arguments by name (the
    pools are shared), to count launches by flag and by launch and to run
    one call of each launch again after the block."""

    ENTRIES = ("wm_exts_launch", "wm_traceback_launch")

    def __init__(self, K, torch):
        import inspect

        super().__init__(torch, self.ENTRIES)
        self.K = K
        self.exts_dp = K.exts_dp
        self.sig = inspect.signature(K.exts_dp)
        self.calls = []

    def __enter__(self):
        self.K.exts_dp = self._record
        return super().__enter__()

    def __exit__(self, *exc):
        self.K.exts_dp = self.exts_dp
        super().__exit__(*exc)

    def _record(self, *args, **kw):
        call = self.sig.bind(*args, **kw)
        call.apply_defaults()
        self.calls.append(call.arguments)
        return self.exts_dp(*args, **kw)

    def summary(self, wall_s):
        """Summed device ms and share of the wall of K3 and K2s, K3's
        launches by flag and by launch, jobs per call and the longest
        job's rows per call."""
        k3, k2 = (self.ms(name) for name in self.ENTRIES)
        flags, paths, jobs, rows = {}, {}, [], []
        for c in self.calls:
            ja = c["jobs"].cpu().numpy()
            f, g = f"{c['flag']:#x}", c["geo"].path
            flags[f] = flags.get(f, 0) + 1
            paths[g] = paths.get(g, 0) + 1
            jobs.append(len(ja))
            rows.append(int((ja[:, 1] + ja[:, 4] - 1).max()) if len(ja) else 0)
        self.rows = rows
        return {
            "k3_ms": float(sum(k3)), "k3_launches": len(k3),
            "k3_share": sum(k3) / 1e3 / wall_s,
            "k2s_ms": float(sum(k2)), "k2s_launches": len(k2),
            "k2s_share": sum(k2) / 1e3 / wall_s,
            "k3_by_flag": flags, "k3_by_path": paths,
            "jobs_per_call": [min(jobs), float(np.median(jobs)), max(jobs)],
            "rows_per_call": [float(np.median(rows)), max(rows)]}

    def hold_to_plain(self):
        """For each launch K3 took, its call at the median of that launch's
        longest rows, run again through K3 and K2 and through their plain
        versions on the same arguments: the results and the traceback of
        the direction bytes must be exactly equal.  Returns {launch:
        [flag, jobs, rows]} of the calls held."""
        K, torch = self.K, self.torch
        by_path = {}
        for c, r in zip(self.calls, self.rows):
            by_path.setdefault(c["geo"].path, []).append((r, c))
        saved = dict(K.LAUNCHES)
        out = {}
        for p, cs in sorted(by_path.items()):
            cs.sort(key=lambda x: x[0])
            r, c = cs[len(cs) // 2]
            jobs, flag, prof = c["jobs"], c["flag"], c["prof"]
            B = jobs.shape[0]
            res_k, dirs_k = K.exts_dp(**c)
            res_p = torch.zeros((B, 16), dtype=torch.int32,
                                device=jobs.device)
            dirs_p = torch.zeros(max(1, c["dirs_bytes"]), dtype=torch.uint8,
                                 device=jobs.device)
            K.exts_dp_plain(c["qpool"], c["tpool"], jobs, c["dirs_off"],
                            c["ncol"], prof, flag, res_p, dirs_p, c["jpool"],
                            c["joff"])
            same = bool((res_k[:, :9] == res_p[:, :9]).all())
            if not flag & K.EZ_SCORE_ONLY:
                eb = torch.zeros(B, dtype=torch.int64, device=jobs.device)
                n_ops = max(4, (r + 3) // 4 * 4)
                walks = []
                for res, dirs in ((res_k, dirs_k), (res_p, dirs_p)):
                    start = K.select_starts(res, jobs, eb,
                                            bool(flag & K.EZ_EXTZ_ONLY),
                                            prof.dead, True)
                    walks.append((dirs, start))
                ops_k, fin_k = K.traceback(
                    walks[0][0], c["dirs_off"], jobs, c["ncol"], walks[0][1],
                    n_ops, prof.min_intron)
                ops_p = torch.empty((B, n_ops), dtype=torch.uint8,
                                    device=jobs.device)
                fin_p = torch.empty((B, 2), dtype=torch.int32,
                                    device=jobs.device)
                K.traceback_plain(walks[1][0], c["dirs_off"], jobs,
                                  c["ncol"], walks[1][1], ops_p, fin_p,
                                  prof.min_intron)
                same = (same and bool((ops_k == ops_p).all())
                        and bool((fin_k == fin_p).all()))
            if not same:
                fail(f"phase 5's K3 call at {p} (flag {flag:#x}, {B} jobs, "
                     f"{r} rows) != plain")
            out[p] = [f"{flag:#x}", B, r]
        K.LAUNCHES.update(saved)
        return out


def phase5(torch, K, check, build, fastx, options, batch, seqcode):
    """Spliced mapping (-x splice -a) of 5000 transcript reads against a
    4 Mbp genome of 400 genes."""
    DATA.mkdir(exist_ok=True)
    ref, reads = DATA / "splice_ref.fa", DATA / "splice_reads.fa"
    t0 = time.perf_counter()
    if not (ref.exists() and reads.exists()):
        splice_corpus(check, ref, reads)
    recs = fastx.read_all(str(ref))
    kmers, cnt = rep_kmers([seqcode.encode(r.seq) for r in recs], 15, 0.9998)
    rep = DATA / "splice_rep.txt"
    with open(rep, "w") as f:
        for x, c in zip(kmers.tolist(), cnt.tolist()):
            f.write(f"{kmer_str(x, 15)}\t{c}\n")
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("splice", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    wset = build.load_weight_set(str(rep), io_.k)
    mi = build.build_index(recs, io_.w, io_.k, io_.flag, wset)
    options.update_mid_occ(mo, mi)
    rs = fastx.read_all(str(reads))
    seqs, names = [r.seq for r in rs], [r.name for r in rs]
    log(f"[phase 5] corpus {sum(len(r.seq) for r in recs)} bp, "
        f"{len(seqs)} reads ({sum(map(len, seqs))} bp), {len(wset)} "
        f"repetitive 15-mers, index {len(mi.keys)} keys "
        f"({time.perf_counter() - t0:.1f} s)")
    batch.map_batch(mi, mo, seqs[:8], names[:8])
    torch.cuda.synchronize()
    batch.STATS.clear()
    K.reset_launches()
    with LaunchTimer(K, torch) as timer:
        t0 = time.perf_counter()
        results = batch.map_batch(mi, mo, seqs, names)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = {k: round(float(v), 6) for k, v in batch.STATS.items()}
    dev = timer.summary(dt)
    log(f"[phase 5] device time: K3 {dev['k3_ms']:.3f} ms over "
        f"{dev['k3_launches']} launches ({100 * dev['k3_share']:.2f}% of the "
        f"wall), K2s {dev['k2s_ms']:.3f} ms over {dev['k2s_launches']} "
        f"({100 * dev['k2s_share']:.2f}%); K3 by flag {dev['k3_by_flag']}, "
        f"by launch {dev['k3_by_path']}; jobs per call (min, median, max) "
        f"{dev['jobs_per_call']}; longest job's rows per call (median, max) "
        f"{dev['rows_per_call']}")
    t1 = time.perf_counter()
    held = timer.hold_to_plain()
    log(f"[phase 5] K3 and K2 == plain on one call of each launch K3 took "
        f"(launch: flag, jobs, rows) {held} ({time.perf_counter() - t1:.1f} "
        f"s)")
    log("[phase 5] JSON " + json.dumps({
        "wall_s": dt, "reads_per_s": len(seqs) / dt,
        "dispatch_s": st.get("dispatch_s"), "device": dev,
        "held_to_plain": held}))
    mapped = [r for r in results if r.regs]
    n_spliced = sum(1 for r in mapped if any(
        g.p is not None and ((g.p.cigar & 15) == 3).any() for g in r.regs))
    log(f"[phase 5] mapped {len(seqs)} reads in {dt:.3f} s -> "
        f"{len(seqs) / dt:.3f} reads/s; {len(mapped)} with hits, "
        f"{n_spliced} of them with an N op")
    log(f"[phase 5] launches {launches}; dev_jobs {int(st['dev_jobs'])}; "
        f"engine host-kept {int(st.get('eng_host_dp_calls', 0))}")
    log("[phase 5] STATS " + json.dumps(st, sort_keys=True))
    if launches["exts"] == 0 or launches["traceback"] == 0:
        fail(f"a spliced kernel was not launched: {launches}")
    check_mapped("phase 5", st, results, len(seqs))
    if n_spliced < 0.5 * len(mapped):
        fail(f"only {n_spliced} of {len(mapped)} mapped reads are spliced")
    return launches


def phase6(torch, K, options, batch, corpus):
    """Single-cost mapping: phase 4's index and reads, map-ont SV-aware
    with one gap cost (-O 4,4 -E 2,2 -a), every DP job through K4."""
    mi, seqs, names = corpus
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("map-ont", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    mo.q2, mo.e2 = mo.q, mo.e
    options.update_mid_occ(mo, mi)
    results, dt, launches, st, dev = map_timed(
        torch, K, batch, mi, mo, seqs, names, "extz")
    n_mapped = sum(1 for r in results if r.regs)
    log(f"[phase 6] -O {mo.q},{mo.q2} -E {mo.e},{mo.e2}: mapped {len(seqs)} "
        f"reads in {dt:.3f} s -> {len(seqs) / dt:.3f} reads/s; {n_mapped} "
        f"with hits")
    log(f"[phase 6] launches {launches}; dev_jobs {int(st['dev_jobs'])}; "
        f"engine host-kept {int(st.get('eng_host_dp_calls', 0))}")
    log("[phase 6] STATS " + json.dumps(st, sort_keys=True))
    log_device("phase 6", "K4", dev, st)
    if launches["extz"] == 0 or launches["traceback"] == 0:
        fail(f"a single-cost kernel was not launched: {launches}")
    if launches["extd"] != 0:
        fail(f"single-cost mapping launched K1: {launches}")
    check_mapped("phase 6", st, results, len(seqs))
    return launches


# --------------------------------------------------------------------------
# the cost probes
# --------------------------------------------------------------------------

# Integer operations per computed band cell of P3 level 6, counted from the
# Pallas probe (tests/tools/probe_core.py:88-168): score 2 (compare,
# select), the one-hot boundary 2, candidates a b a2 b2 4, max and
# direction 12, clamp 1, u v 2, z-q z-q2 2, an bn a2n b2n 4, continue
# tests 4, x y x2 y2 8 (select, subtract), direction bits 4; and per
# computed row the H0 walk, 10 (two range tests, max, add, compare, two
# selects, compare, subtract, compare).
OPS_PER_CELL_P3 = 45
OPS_PER_ROW_P3 = 10
# the probes' default shape (B, Wb, ROWS, KR): the TPU scripts' own, and
# about K1's phase-2 shape (512 jobs of 1000 bp at w = 500, 1,999 rows)
PROBE_SHAPE = (512, 640, 32, 63)
# the ladder once more at 9 steps (288 rows): at the timed inputs the first
# job sets done at row 293 (level 6), and the band leaves the 640-lane
# window near row 1640, so every level computes every row of this depth
# and its time per row compares level with level
PROBE_SHORT_KR = 9


def probe_record(name, rep, launches, err, ms, plain_ms, nbytes, ops):
    tb, to = nbytes / HBM_BPS * 1e3, ops / INT32_OPS * 1e3
    return {"name": name, "route": "cuda",
            "source": "winnowmap_tpu_torch/csrc/probes.cu", "replaces": rep,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def host_ms(torch, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase7(torch, k1):
    """P1-P3 against their plain versions (every case at a small shape and
    at the shape it is timed at, and P3 level 6 at the full shape), then
    timed through their entry points; returns their records."""
    from winnowmap_tpu_torch import tools
    from winnowmap_tpu_torch.tools import check as PC
    from winnowmap_tpu_torch.tools import probe_bisect as P1
    from winnowmap_tpu_torch.tools import probe_core as P3
    from winnowmap_tpu_torch.tools import probe_l0 as P2

    dev = torch.device(DEVICE)
    err = PC.check_all(dev)
    torch.cuda.synchronize()
    if any(err.values()):
        fail(f"probe kernels != plain at the small shape: {err}")
    log(f"[phase 7] B={PC.B} Wb={PC.WB} ROWS={PC.ROWS} KR={PC.KR}: "
        f"{len(PC.core_cases())} P3 cases, {len(P2.cases)} P2 cases, "
        f"{len(P1.variants)} P1 bodies: kernel == plain (res, state, "
        f"defined dirs)")
    timed = PC.check_timed(dev)
    torch.cuda.synchronize()
    if any(timed.values()):
        fail(f"probe kernels != plain at the timed shapes: {timed}")
    err = {k: max(v, timed[k]) for k, v in err.items()}
    log(f"[phase 7] timed shapes, kernel == plain: "
        f"{len(PC.timed_core_cases())} P3 levels and variants at "
        f"Wb={PC.TIMED_WB} and their ROWS (B={PC.CORE_B}, "
        f"~{PC.CORE_ROWS} rows); every P2 case at B={PC.TIMED_B} "
        f"Wb={PC.TIMED_WB} KR=63/32/16; every P1 body at B={PC.TIMED_B} "
        f"Wb={PC.TIMED_WB} ROWS={PC.TIMED_ROWS} KR={PC.TIMED_KR['bisect']}")
    Bf, Wb, ROWS, KR = PROBE_SHAPE
    qbuf, qlen = PC.small_inputs(dev, B=Bf, Wb=Wb, ROWS=ROWS, KR=KR)
    err["probe_core"] = max(err["probe_core"], PC.check_core(
        qbuf, qlen, 6, "u8", False, Wb=Wb, ROWS=ROWS, KR=KR))
    torch.cuda.synchronize()
    if err["probe_core"]:
        fail(f"P3 level 6 != plain at B={Bf} Wb={Wb} KR*ROWS={KR * ROWS}")
    log(f"[phase 7] P3 level 6 u8 at B={Bf} Wb={Wb} ROWS={ROWS} KR={KR} "
        f"(half the jobs the timed inputs): kernel == plain")
    # the plain versions at the timed inputs (qbuf zeros, qlen 1000)
    zq = torch.zeros((Bf, Wb + 384), dtype=torch.uint8, device=dev)
    qlen = PC.timed_qlen(dev)
    plain = {
        "probe_core": host_ms(torch, lambda: P3.core_plain(
            6, zq, qlen, Wb=Wb, ROWS=ROWS, KR=KR)),
        "probe_l0": host_ms(torch, lambda: P2.l0_plain(qlen, Wb=Wb, KR=KR)),
        "probe_bisect": host_ms(torch, lambda: P1.bisect_plain(
            P1.dirs_store, qlen, Wb=Wb, ROWS=ROWS, KR=16)),
    }

    # comparison launches are not counted
    tools.reset_launches()
    ladder = [P3.run_level(lv, device=DEVICE) for lv in P3.levels]
    short = [P3.run_level(lv, KR=PROBE_SHORT_KR, device=DEVICE)
             for lv in P3.levels]
    variants = [(name, P3.run_level(**kv, device=DEVICE))
                for name, kv in P3.variants]
    l0 = {name: P2.run(**kv, device=DEVICE) for name, kv in P2.cases}
    bis = {tag: P1.run(tag, body, **kv, device=DEVICE)
           for tag, body, kv in P1.variants}
    torch.cuda.synchronize()
    launches = dict(tools.LAUNCHES)
    log(f"[phase 7] launches {launches}")
    if not all(launches.values()):
        fail(f"a probe kernel was not launched: {launches}")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k1_waves = -(-k1["B"] // (k1["blocks_per_sm"] * sms))
    k1_ns = k1["ms"] * 1e6 / (k1["rows"] * k1_waves)
    log(f"[phase 7] K1 (phase 2, B={k1['B']}, {k1['launch']}, ring "
        f"{k1['ring']}, {k1['blocks_per_sm']} blocks/SM, {k1_waves} "
        f"wave(s)): "
        f"{k1['ms']:.3f} ms over {k1['rows']} rows = {k1_ns:.1f} ns/row")
    prev = None
    for o in ladder:
        add = ("" if prev is None else
               f", {o['ns_per_active_row'] - prev:+.1f} over the level below")
        log(f"[phase 7] P3 L{o['level']} {P3.levels[o['level']].strip()}: "
            f"{o['ms']:.3f} ms, {o['gcells_padded']:.2f} Gcells/s padded, "
            f"{o['gcells_band']:.2f} band, {o['ns_per_row']:.1f} ns/row, "
            f"{o['ns_per_active_row']:.1f} ns/active row "
            f"({o['rows_active']} rows{add}); K1 {k1_ns:.1f} ns/row")
        prev = o["ns_per_active_row"]
    prev = None
    for o in short:
        add = ("" if prev is None else
               f", {o['ns_per_row'] - prev:+.1f} over the level below")
        log(f"[phase 7] P3 L{o['level']} at {o['KR'] * o['ROWS']} rows: "
            f"{o['ms']:.4f} ms, {o['gcells_band']:.2f} Gcells/s band, "
            f"{o['ns_per_row']:.1f} ns/row ({o['rows_active']} active{add})"
            f"; K1 {k1_ns:.1f} ns/row")
        prev = o["ns_per_row"]
    for name, o in variants:
        log(f"[phase 7] P3 {name.strip()}: {o['ms']:.3f} ms, "
            f"{o['gcells_padded']:.2f} Gcells/s padded, {o['gcells_band']:.2f}"
            f" band, {o['ns_per_active_row']:.1f} ns/active row")
    for name, o in l0.items():
        log(f"[phase 7] P2 {name.strip()}: {o['ms']:.4f} ms, "
            f"{o['gcells_padded']:.2f} Gcells/s padded")
    log("[phase 7] JSON " + json.dumps({
        "k1": {**k1, "waves": k1_waves, "ns_per_row": k1_ns},
        "ladder": ladder, "short": short, "variants": dict(variants),
        "l0": l0,
        "bisect": bis}))

    top = ladder[6]
    core_bytes = (Bf * (Wb + 384) + 4 * Bf + KR * ROWS * Bf * Wb
                  + 7 * Bf * Wb + 64 * Bf)
    core_ops = (top["cells_band"] * OPS_PER_CELL_P3
                + top["rows_active"] * Bf * OPS_PER_ROW_P3)
    l0_ms = l0[P2.cases[4][0]]["ms"]  # 7 state arrays (=L0)
    ds = bis[P1.variants[4][0]]["ms"]  # 32x dirs row store, KR 16
    return [
        probe_record("probe_bisect", "tests/tools/probe_bisect.py:48",
                     launches["probe_bisect"], err["probe_bisect"], ds,
                     plain["probe_bisect"],
                     16 * 32 * Bf * Wb + 7 * Bf * Wb + 64 * Bf,
                     16 * 32 * Bf * Wb),
        probe_record("probe_l0", "tests/tools/probe_l0.py:55",
                     launches["probe_l0"], err["probe_l0"], l0_ms,
                     plain["probe_l0"], 4 * Bf + 7 * Bf * Wb + 64 * Bf,
                     KR * Bf * (Wb + 16)),
        probe_record("probe_core", "tests/tools/probe_core.py:222",
                     launches["probe_core"], err["probe_core"], top["ms"],
                     plain["probe_core"], core_bytes, core_ops),
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(REPO))
    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch import cli, options
    from winnowmap_tpu_torch.extend import _build, check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io import fastx, seqcode
    from winnowmap_tpu_torch.map import batch
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    log(f"[phase 1] card: {smi}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    log(f"[phase 1] nvcc: {_build._nvcc_version(_build.nvcc_path())}")
    log(f"[phase 1] g++: {run(['g++', '--version']).stdout.splitlines()[0]}")
    t0 = time.perf_counter()
    native.lib()
    log(f"[phase 1] native library: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _build.build(_build.SOURCES + _build.PROBE_SOURCES)
    _build.load()
    _build.load_probes()
    log(f"[phase 1] CUDA kernels and probes: {time.perf_counter() - t0:.1f} "
        f"s (nvcc, in parallel)")
    for src, info in _build.BUILD_INFO["ptxas"].items():
        lines = info.splitlines()
        if src != "probes.cu":
            # every K1, K3 and K4 variant and K2: entry, registers, spills
            lines = [ln for ln in lines if any(
                w in ln for w in ("entry function", "registers", "spill"))]
            for ln in lines:
                log(f"[phase 1] {src}: {ln}")
        else:
            log(f"[phase 1] {src}: " + " | ".join(lines[-2:]))

    # the checks of K1/K4 here, and of K3 and K1/K4's other launches in
    # three more processes at once, then the timings alone on the card
    t0 = time.perf_counter()
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=spawn) as pool:
        spliced = [pool.submit(phase2_splice),
                   pool.submit(phase2_splice_launches)]
        launches = pool.submit(phase2_ext_launches)
        err, main_batch = phase2(K, check, native, torch, gen_simple_mat)
        log(f"[phase 2] K1, K4 checks: {time.perf_counter() - t0:.1f} s")
        s_err = {k: max(f.result()[k] for f in spliced)
                 for k in ("exts", "traceback")}
        for k, v in launches.result().items():
            err[k] = max(err[k], v)
    log(f"[phase 2] K3 checks and K1/K4 launches (three more processes): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records, k1 = phase2_times(K, check, torch, gen_simple_mat, err,
                               main_batch)
    records += phase2_splice_times(K, check, torch, gen_simple_mat, s_err)
    log(f"[phase 2] times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase3(cli)
    ont, corpus = phase4(torch, K, build, fastx, options, batch, seqcode)
    log(f"[phase 3-4] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spl = phase5(torch, K, check, build, fastx, options, batch, seqcode)
    log(f"[phase 5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ext = phase6(torch, K, options, batch, corpus)
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on its own path: K1 and K2 on map-ont (phase
    # 4), K4 on single-cost map-ont (phase 6), K3 and K2's spliced form on
    # splice (phase 5)
    for rec, n in zip(records, (ont["extd"], ont["traceback"], ext["extz"],
                                spl["exts"], spl["traceback"])):
        rec["launches"] = n
    t0 = time.perf_counter()
    records += phase7(torch, k1)
    log(f"[phase 7] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
