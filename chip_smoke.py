"""On-card smoke test of the PyTorch/CUDA port (winnowmap_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++.  Phases, each fatal on failure:
  1. card and toolchain: name and power limit, nvcc/g++ versions, build
     time of the native library and of the CUDA kernels, ptxas's
     registers and spills of every K1, K3, K4 and K2 instantiation;
  2. each kernel against its plain PyTorch version on the card, at every
     launch the default geometry takes, each on a batch whose widest job
     takes that launch with about the fewest rows (the plain versions'
     time follows rows, the launch the band): K1 extd DP and K4 extz DP
     with K2 traceback at 128 threads x 1-8 slots and the shared-memory
     path on 32 jobs, map-ont and -O 4,4 -E 2,2 at flags 0x18 and 0x0;
     at 128 x 5 (the main path's launch) on 48 ragged jobs under map-ont,
     asm5, -O 4,4 -E 2,2 and q = 61, e = 2 (whose biased score byte wraps:
     max_sc = 128), flags 0x18 0x0 0xC2 0x40 0x01; K3 exts DP and K2's
     spliced form at 512 x 2 on 32 spliced jobs (2-3 exons, introns of
     80-120 bases, junction bytes on a third), splice profile at flags
     0x508 (the splice path's) 0x500 0x600 0x318 0x1C2 0x101 0x0,
     splice:hq at 0x508 0x600 0x318 0x1C2, and at 256 x 1, 512 x 1,
     512 x 4 and the shared-memory path at flags 0x508 and 0x5C2; each
     also against native.extd / native.extz / native.exts on a sample,
     where the K3 checks of each process must meet an N op; K1 and K4 with
     K2 on the main batch (512 jobs of length 1000 at w = 500, flag 0x18
     with no end bonus, the timed inputs, and flag 0x0), every job against
     the plain versions; these checks run in worker processes (the plain
     versions are bound by the host's Python).  Meanwhile every job of the
     timed batches (the main batch; K3 with K2 on 256 spliced jobs of 2-4
     exons with introns of 100-1500 bases at 0x508) and one long job each
     of K1, K4 (a full band of 16800 lanes) and K3 (8600 exon bases), their
     slot state in global scratch, against the native oracle, by digest;
     C1 (the chain forward pass) against its plain version on 64 anchor
     sets of 2k-20k anchors, a repeat cluster whose windows pass 8192 and
     a set whose walk takes a predecessor from outside C1's shared-memory
     ring (chain.check.chain_sets; stage 2 fails unless one does), under
     asm5's stage-1 and stage-2 chain parameters (phase 9's), on
     eight under cDNA's gap cost and eight at max_skip 1 (where the
     oracle's break cuts walks short), every job chained to the end
     against native.chain_dp; S1 (the sketch's per-base work: transform,
     down-weight membership, f64 order) against its plain version on 200
     kb with N bases and on 4,000,000 bases, HPC off and on, k = 15, 19,
     28, with no set, a sorted set and its bloom table, and sketch_device
     against native.sketch on the 200 kb with a weighted set and in bloom
     mode; then kernel times from CUDA events, with the card to themselves
     (S1 on 4,000,000 codes at k = 19 with no set and sets of 3, 1,751
     and 1,000,000 k-mers and a bloom table, each held to its plain
     version; sketch_device by stage against native.sketch there), and
     C1, the whole device chain and native.chain_dp on single chains of
     10k, 50k, 100k and 300k anchors under stage 2's parameters, each
     chain against native.chain_dp;
  3. the port's CLI on the golden corpora (tests/data/golden): --sv-off
     byte-equal to golden_svoff.sam, sv-aware equal to golden_svon.sam up
     to the reference's uninitialised rep_len fields (at most 6 lines);
     -x splice byte-equal to golden_splice.paf and golden_splice_cs.paf
     (--cs), and to golden_splice.sam apart from @PG; with each index
     built through S1 (one launch), byte-equal to golden_mappb.paf (-x
     map-pb -c), golden_asm20.paf (-x asm20 -c), golden_svoff_cs.paf,
     golden_svoff_md.paf (--cs, --MD) and golden_svoff_nocig.paf (no
     CIGAR); t_ref.fa's HPC index through S1 equal to the native build;
  4. map-ont SV-aware mapping at real read length: a 1 Mbp genome and 1000
     reads of 15 +- 5 kb at 8% error (tests/tools/make_testdata.py, seed 7),
     its index built through S1 (one launch) and equal to the native
     build, the device sketch by stage against native.sketch,
     reads/s, STATS and kernel launch counts of the run, and K1's, K2's
     and R1's summed device time (CUDA events around their C launch
     entries), K1's launches by flag and by launch, jobs and longest rows
     per call, the runs and bytes brought back a call (collect_runs,
     collect_d2h_bytes); R1 on the run's call with the most op slots
     timed (the kernels line's cigar_rle), beside its plain version and
     its bytes' time, and held to both its plain version and the native
     decode; one R1 launch a K2 launch;
  5. spliced mapping (-x splice -a) at a real size: a 4 Mbp genome with 400
     genes and 5000 reads of their transcripts from both strands, made
     with numpy (seed 20261016; the index through S1 in one launch, equal
     to the native build, the device sketch by stage and native.sketch
     timed on it); reads/s, STATS and launch
     counts; every K3, traceback and R1 launch timed by CUDA events
     recorded around its C launch entry (their summed device time and
     share of the wall, K3's launches by flag and by launch, jobs and
     longest rows per call); R1 on the widest call as in phase 4;
  6. single-cost mapping (map-ont SV-aware with -O 4,4 -E 2,2 -a) of phase
     4's corpus: every DP job through K4, none through K1; K4's device time
     and launches as K1's in phase 4;
  7. the cost probes P1-P3 (csrc/probes.cu): every probe kernel exactly
     equal to its plain version at a small shape (B=16, Wb=128, ROWS=32,
     KR=3, numpy seed 20261016: every P1 body, every P2 case, P3 levels
     0-6 under each dirs mode and the int32 state), and every case again
     at the shape it is timed at (P3 with 8 jobs and ~320 rows), P3 level
     6 once more at the full shape and at every Wb from 1 to 640 (partial
     last chunks and 4-lane groups) and at Wb 641, 1,000, 2,048, 4,096
     and 5,000 (the wide launch) at the small shape, under u8 and
     i32-packed dirs; then the P3 ladder
     (and again at 288 rows, where no job stops early) and its variants,
     the P2 cases (with each kernel's own time by torch.profiler) and the
     P1 bodies timed through their entry points, beside K1's row time from
     phase 2; P2's kernels-line time is its 7-array case with its stores
     written back (a CUDA graph of launches whose outputs pass twice the
     L2), against a bound of its stores at the memory rate or its byte-SIMD
     operations, whichever is larger.
  8. the generator mapping path (--junc-bed, -X, -D, --for-only,
     --rev-only, --sr: map/batch.map_batch_generator) on the card: -x
     splice --junc-bed byte-equal to golden_splice_junc.paf; the generator
     entry with --sv-off -a byte-equal to golden_svoff.sam apart from @PG;
     annotated spliced mapping (-x splice --junc-bed -a) of phase 5's
     reads against its genome with a BED12 of its genes; all-vs-all
     overlap (-X -c) of 100 of phase 4's reads; for both, reads/s, calls,
     jobs a call, host and device seconds and launches, and on the host
     just the jobs that the oracle's refusal guards refuse, counted apart.
  9. assembly-to-reference mapping (-x asm5 -c, SV-aware, the engine): a
     10 Mbp genome in two chromosomes (make_testdata.make_genome) and four
     contigs of 2-3 Mbp cut from a haplotype copy of it (0.1%
     substitutions, 0.01% indels of 1-20 bp, a 5 kb deletion, a 5 kb
     insertion, a 20 kb inversion, a tandem expansion), weighted by the
     canonical 19-mers above distinct=0.9998; the index through S1 (one
     launch for both chromosomes), every
     chain of 50,000 anchors or more through the engine's chain exchange
     onto C1; contigs/s, Mbp/s, the chains exported and their anchors, C1's,
     K1's and K2's device time, eng_chain_s, the index's seconds beside a
     native build (equal arrays); fails unless a chain reached C1, every
     exported chain went through C1, and the PAF equals a second run with
     chain_min = 0 (every chain on the engine's scalar DP).  C1's launch of
     the run is timed again by CUDA events (the kernels line's C1 time) and
     held at the end, in a worker process, to the plain version (whose
     tally of the oracle's candidates gives C1's bound) and its chains to
     native.chain_dp.
 10. k-mer counting (the meryl workflow that makes -W's list): (a) the
     port's meryl_cli on the card on t_ref.fa, count k=15 then print (its
     md5), histogram, print greater-than distinct=0.9998 and greater-than
     4 equal to the reference meryl's goldens, count-forward and
     count-reverse equal to the host counter; (b) a 100 Mbp genome (about
     C. elegans: three chromosomes of make_testdata.make_genome, numpy
     seed 20261017, a run of N in each) through count_kmers on the card,
     equal array for array to the host counter (count_kmers_chunked, run
     meanwhile in a worker process): blocks, KC's summed event ms, the
     host merge's and the other host seconds, Mbp/s, the peak device
     memory, the distinct=0.9998 list's size; (c) KC alone on the
     genome's first block of 4 Mi codes (k = 15, canonical), held to its
     plain version and timed by CUDA events beside the plain version and
     torch.unique on the block's valid keys, and held to its plain version
     there at k = 19 (u64 keys) and on small blocks with N runs at k = 15,
     19, 31, 32, each direction.
 11. prebuilt and multi-part indexes, paired ends and the debug dumps,
     after phase 9: (a) on the goldens, -d to WMTI1 then --sv-off -c from
     it byte-equal to golden_svoff.paf; -a on t_ref.mmi, and on the port's
     dump_mmi of the bloom build, equal to golden_mmi.sam apart from @PG;
     --sv-off -c -I 100k byte-equal to golden_svoff.paf; -a on pe_1.fq
     pe_2.fq equal to golden_pe.sam apart from @PG, and --frag yes on the
     two interleaved giving its body; (b) phase 9's 10 Mbp index built
     again through S1 (one launch), dumped and loaded as WMTI1 (every
     array equal to phase 9's) and as MMI\\2 (every array but the weight
     set), the build, dumps and loads timed, and phase 9's contigs mapped
     from the loaded WMTI1 index with the PAF byte-equal to phase 9's; (c)
     phase 9's genome with -I 4M: two parts of 5 Mbp, each built through
     S1 in one launch and its codes' copy dropped before the next, its
     chains of 50,000 anchors or more through C1; per part contigs/s, S1
     and C1 launches and peak device memory; each part's regions (rids
     shifted) equal to a single-part run against that chromosome alone;
     -I 20M (above the genome) byte-equal to phase 9's PAF; (d) 5,000
     pairs of 2 x 150 bp from fragments of 400 +- 50 bp of phase 4's
     genome with 1% substitutions (numpy seed 20261018) mapped -a from
     two files: pairs/s, K1 and K2 launches and event ms, jobs per call,
     host jobs equal to the refusal guards' count, at least 90% properly
     paired; (e) --print-seeds, --sv-off --print-aln-seq and --dbg-polish
     on the first 4 reads of t_reads.fa (the fourth SV-aware): each trace
     and PAF on the card byte-equal to the port's own with --device cpu,
     the card's run through K1 and K2 on the generator path.
 12. the last modules, after phase 11: (a) minimizer_dist's sketch_dump
     of phase 9's genome through S1 (one launch) equal to the dump from
     native.sketch, and of t_ref.fa with t_rep_k15.txt (natively and
     through S1) equal as a set to golden_ref_minimizers.txt;
     extract_selected_reads on phase 9's PAF; (b) a database counted by
     meryl_cli count k=15 on the card: meryl-lookup's seven reports equal
     the golden_lookup_* files, meryl-import of its print printed again
     equal to the print, meryl-analyze and position-lookup over it; (c)
     phase 4's reads through two engines on the card in two host threads
     (map_batch_multidev over [cuda:0, cuda:0]) and through the split
     driver (ways 2): each read's regions equal phase 4's, no DP job on
     the engine's host DP, K1's and K2's launch counts equal the sum of
     each thread's launches, reads/s beside phase 4's; (d)
     count_kmers_multidev over two slots of the card on phase 9's genome
     (k = 15, canonical and forward) equal to count_kmers, Mbp/s of both;
     (e) two processes on the card joined by gloo on localhost:
     map_file_partitioned of phase 9's contigs, a chromosome a rank (one
     S1 launch each, its long chains through C1), rank 0's PAF byte-equal
     to the single-process n_parts = 2 run, and map_file_sharded of 200
     of phase 4's reads merged by merge_parts byte-equal to map_file.
 13. the genome-scale run (winnowmap_tpu_torch/tools/scale_run.py, the
     port of tests/tools/scale_run.py) at 0.02 Gbp, in a process of its
     own beside the holds: the JAX tool's corpus from its seed (one
     chromosome of 20 Mbp with eight tandem-repeat arrays, 32 reads of 15
     +- 5 kb at 8% substitutions), its 15-mers counted through KC (once a
     block) and the distinct=0.9998 list, the index through S1 (once a
     launch group) equal to the native build, the reads mapped twice with
     -c to one PAF, K1 and K2 held to their plain versions on the
     median-rows call of each launch, no DP job on the engine's host DP,
     at least 98% of the primary hits on the reads' origins; its
     SCALE-SUMMARY line.
The down-weight lists (-W) of phases 4, 5, 8 (d) and 9 are counted on the
card (count_kmers through KC, meryl's distinct=0.9998 selection;
rep_list), and phase 10 (a) holds phase 9's to a numpy selection.
Every DP kernel call of phases 4, 5, 6, 8 (c), (d) and 11 (d) is
recorded; for each launch a run took, its call at the median of that
launch's longest rows (in 8 (c) one that carries junction bytes) is run
again at the end through the kernel, K2 and R1 and through their plain
versions, in worker processes, and must be exactly equal.
Phases 4-6 keep no DP job on the engine's host DP (eng_host_dp_calls 0).
It prints a "kernels" JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  It imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLD = REPO / "tests" / "data" / "golden"
DATA = REPO / "smoke_data"
# phase 5's genome, reads and gene BED (splice_corpus)
SPLICE_CORPUS = (DATA / "splice_ref.fa", DATA / "splice_reads.fa",
                 DATA / "splice_genes.bed")
DEVICE = "cuda"
MAP_ONT = (2, 4, 4, 2, 24, 1)  # a, b, q, e, q2, e2
ASM5 = (1, 19, 39, 3, 81, 1)
# one gap cost (-O 4,4 -E 2,2), and q + e = 63, where the biased score byte
# of wm_extz wraps (max_sc = 2 + 126 = 128); that profile's scores fall at
# once, so its jobs run without z-drop
EXTZ = (2, 4, 4, 2, 4, 2)
EXTZ_WRAP = (2, 4, 61, 2, 61, 2)
FLAGS = (0x18, 0x0, 0xC2, 0x40, 0x01)
# processes that hold the kernels to their plain versions in phase 2
PHASE2_WORKERS = 6
# a worker process's CUDA context and what its cache keeps between calls
HOLD_CONTEXT_BYTES = 1 << 30
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
# FP64 operations at 700 W: 132 SMs x 64 FP64 lanes x 1.98 GHz, one
# multiply or add a lane a cycle (the data sheet's 67 TFLOP/s FP64 counts a
# tensor-core FMA as two)
FP64_OPS = 132 * 64 * 1.98e9
# per candidate the chain oracle evaluates (native/src/wm_chain.cpp:63-99,
# one segment): dr dq 2, the segment id 2, the first two continue tests 10
# (sidi == sidj, dr == 0, dq <= 0, dq > max_dist_y, dq > max_dist_x, their
# ands and ors), dd 3 (compare, subtract, select), dd > bw 3, the n_segs
# test 1, the loop's decrement and test 2; per candidate that passes them,
# also min_d and sc 4, log_dd 3, the gap cost's integer part 6 (the cdna
# test, two conversions, the shift and add), the gap term's conversions
# and subtract 3, f[j] 1, the max test with its updates and the skip
# counter 5, the mark test 1; and 4 f64 operations, dd * .01 * avg_qspan
# and gap * gap_scale + .499
OPS_PER_CANDIDATE = 23
OPS_PER_PASSING = 23
F64_PER_PASSING = 4
# the chain parameters C1 is checked with: asm5's (and map-ont's) stage 1
# (tests/test_chain_device.py: max gap 5000, bw 500, max_skip 25, max_iter
# 5000), and asm5's stage 2 (options.stage2_options: max gap 16000, bw
# 2000), the parameters of phase 9's exported chains
CHAIN_P = dict(max_dist_x=5000, min_dist_x=1000, max_dist_y=5000, bw=500,
               max_skip=25, max_iter=5000, min_cnt=3, min_sc=40,
               gap_scale=1.0, is_cdna=0)
CHAIN_P2 = dict(CHAIN_P, max_dist_x=16000, max_dist_y=16000, bw=2000)
# the single chains C1 and native.chain_dp are timed on side by side, under
# CHAIN_P2 (phase 9's contig chains hold 80-120k anchors)
CHAIN_SIZES = (10_000, 50_000, 100_000, 300_000)
# the codes S1 is timed on: about phase 5's 4 Mbp genome
# (tools/time_sketch.py's timed_seq)
SKETCH_TIMED = 4_000_000
# S1's operations a base, counted from the reference's scalar code
# (sketch.c:43-63, 70-89, 128-160), not from the kernel: the rolling k-mers
# 6 (two shifts, or, and, shift, or), the canonical k-mer, z and sym 3, the
# finalizer 8 (three shifts, three xors, two multiplies), the key mix 23,
# the order 2 (the conversion and the scaling; a down-weighted base's three
# products are not counted) and the flags byte 2; and 3 a probe of the
# sorted set's binary search (load, compare, select), log2 |set| + 1 probes
OPS_PER_BASE_S1 = 44
OPS_PER_PROBE_S1 = 3


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


def check_case(K, check, native, torch, c, name, qs, ts):
    """The DP kernel of OnDevice c and K2 against their plain versions on
    every job, and against the native oracle on a sample of 16; returns
    the largest errors and how many sampled jobs' CIGARs hold an N op."""
    dp = c.dp_name
    err, res_k, ops_k, fin_k = check.check_against_plain(c)
    torch.cuda.synchronize()
    if any(err.values()):
        fail(f"{dp}, K2 != plain on {name}: max abs err {err}")
    res_np = res_k.cpu().numpy()
    cig = None if c.flag & K.EZ_SCORE_ONLY else c.cigars(native, ops_k,
                                                         fin_k)
    B = len(c.jobs_np)
    n_intron = 0
    for i in range(0, B, max(1, B // 16)):
        h = c.native(native, i, *c_seqs(c, i, qs, ts))
        if res_np[i, :9].tolist() != native_fields(h) or (
                cig is not None and not np.array_equal(cig[i], h.cigar)):
            fail(f"{dp} != native.{dp} on {name} job {i}")
        n_intron += int(((h.cigar & 15) == 3).any())
    return err, n_intron


def c_seqs(c, i, qs, ts):
    """Job i's query and target as the DP reads them (spliced batches hold
    them so already)."""
    if c.spliced:
        return qs[i], ts[i]
    jb = c.jobs_np[i]
    return (qs[i][::-1] if jb[2] else qs[i]), (ts[i][::-1] if jb[5] else ts[i])


def native_fields(h):
    return [h.max, int(h.zdropped), h.max_q, h.max_t, h.mqe, h.mqe_t, h.mte,
            h.mte_q, h.score]


def native_digest(K, check, native, c, qs, ts):
    """The kernel chain (DP kernel, start selection, K2, CIGAR decoding)
    on every job of c against the native oracle: fails on any difference;
    returns the sha256 of the results and CIGARs, equal for both."""
    import hashlib

    saved = dict(K.LAUNCHES)
    res, dirs = c.k1()
    ops, fin = c.k2(dirs, c.starts(res))
    cig = c.cigars(native, ops, fin)
    K.LAUNCHES.update(saved)
    res_np = res.cpu().numpy()
    hk, hn = hashlib.sha256(), hashlib.sha256()
    for i in range(len(c.jobs_np)):
        h = c.native(native, i, *c_seqs(c, i, qs, ts))
        kv, nv = res_np[i, :9].astype(np.int64), np.array(native_fields(h))
        hk.update(kv.tobytes() + cig[i].astype(np.uint32).tobytes())
        hn.update(nv.tobytes() + h.cigar.astype(np.uint32).tobytes())
        if not np.array_equal(kv, nv) or not np.array_equal(cig[i], h.cigar):
            fail(f"{c.dp_name} chain != native.{c.dp_name} on job {i}")
    if hk.digest() != hn.digest():
        fail(f"{c.dp_name} digest != native's")
    return hk.hexdigest()[:16]


def main_batch(check, gen_simple_mat, B=512, n=1000, w=500):
    """The main path's shape, B jobs of length n at band w, and the cases
    held on it, (profile, flag, end bonus): K1 (map-ont) and K4 (-O 4,4 -E
    2,2) at flag 0x18 with no end bonus (the inputs phase2_times times) and
    at flag 0x0 with random end bonuses."""
    rng = np.random.default_rng(20261016)
    main = check.random_jobs(rng, [n] * B, w, 400)
    cases = [(prof, flag, np.zeros(B, np.int64) if flag == 0x18
              else rng.integers(0, 60, B))
             for prof in (MAP_ONT, EXTZ) for flag in (0x18, 0x0)]
    return main, cases


def phase2_main(K, check, native, torch, gen_simple_mat):
    """The main batch's four cases, every job against the native oracle,
    by digest (check_main_batch holds them to the plain versions); returns
    the batch for phase2_times."""
    main, cases = main_batch(check, gen_simple_mat)
    qp, tp, jobs, qs, ts = main
    for prof, flag, eb in cases:
        c = check.OnDevice(DEVICE, qp, tp, jobs,
                           gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                           flag, eb)
        d = native_digest(K, check, native, c, qs, ts)
        log(f"[phase 2] main {c.dp_name} a={prof[0]} q={prof[2]} "
            f"flag={flag:#04x} B={len(jobs)} ({c.ext.path}, ring "
            f"{c.ext.ring}): == native.{c.dp_name} on every job (digest {d})")
    return main


def check_main_batch(pname):
    """The main batch's cases of profile `pname` through K1 or K4 and K2
    against their plain versions on every job; returns the largest errors.
    Runs in a process of its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    (qp, tp, jobs, qs, ts), cases = main_batch(check, gen_simple_mat)
    max_err = {"extd": 0, "extz": 0, "traceback": 0}
    for prof, flag, eb in cases:
        if prof is not PROFILES[pname]:
            continue
        c = check.OnDevice(DEVICE, qp, tp, jobs,
                           gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                           flag, eb)
        err, _ = check_case(K, check, native, torch, c,
                            f"main {pname} flag {flag:#x}", qs, ts)
        for k in err:
            max_err[k] = max(max_err[k], err[k])
        log(f"[phase 2] main {c.dp_name} {pname} flag={flag:#04x} "
            f"B={len(jobs)} ({c.ext.path}, ring {c.ext.ring}, "
            f"{int(c.geo.rows.max())} rows): {c.dp_name}, K2 == plain on "
            f"every job; == native on a sample")
    return max_err


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


# The launches the default geometry takes, each with the band (K1, K4:
# min(qlen, tlen, w + 1); K3: min(qlen, tlen)) of the widest job of a batch
# that takes it with few rows: 64 above the bottom of the launch's range
# (the widest job's mutated query may be a few tens of bases short of its
# target).  K1, K4: ring 128 x ceil(span / 128) lanes with span =
# kernels.ring_span(band), the memory path above 1024 (its slot state in
# shared memory here); K3: a ring of the power of two >= band + 64 lanes
# (256 x 1, 512 x 1/2/4, the memory path from 4096).  The plain versions'
# time follows rows (qlen + tlen - 1), the launch follows the band.
EXT_LAUNCH_BANDS = (("reg128x1", 64), ("reg128x2", 145), ("reg128x3", 273),
                    ("reg128x4", 401), ("reg128x5", 529), ("reg128x6", 657),
                    ("reg128x7", 785), ("reg128x8", 913), ("mem-smem", 1041))
K3_LAUNCH_BANDS = (("reg256x1", 160), ("reg512x1", 256), ("reg512x2", 512),
                   ("reg512x4", 1024), ("mem-smem", 2048))
PROFILES = {"map-ont": MAP_ONT, "asm5": ASM5, "extz": EXTZ,
            "extz-wrap": EXTZ_WRAP, "splice": SPLICE, "splice:hq": SPLICE_HQ}


def ext_launch_batch(check, rng, band, B):
    """B jobs whose widest band is `band`: a full-band job of band bases
    leads, B - 2 jobs of band/2 to band bases at mixed band widths (full,
    or narrow up to half the band), and one unrelated pair (150 vs 140
    bases) ends the batch."""
    ws = [w for w in (33, 64, 97, band // 2, -1)
          if (w == -1 and band >= 150) or 0 < w < band]
    lens = np.concatenate([[band], rng.integers(band // 2, band + 1, B - 2)])
    return check.random_jobs(
        rng, lens, np.concatenate([[-1], rng.choice(ws, B - 1)]),
        rng.choice([40, 200, 400], B), dissimilar=True)


def check_ext_launches(seed, launches, cases, B=32):
    """K1 or K4 (by profile) with K2 against their plain versions, at each
    launch of `launches` (names of EXT_LAUNCH_BANDS) on a batch of B jobs
    that takes it, for each (profile name, flag) of `cases`; returns the
    largest errors.  Runs in a process of its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(seed)
    max_err = {"extd": 0, "extz": 0, "traceback": 0}
    for path, band in EXT_LAUNCH_BANDS:
        if path not in launches:
            continue
        qp, tp, jobs, qs, ts = ext_launch_batch(check, rng, band, B)
        for pname, flag in cases:
            prof = PROFILES[pname]
            pj = jobs
            if prof is EXTZ_WRAP:  # its scores fall at once: no z-drop
                pj = jobs.copy()
                pj[:, 7] = -1
            c = check.OnDevice(DEVICE, qp, tp, pj,
                               gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                               flag, rng.integers(0, 60, B))
            if c.ext.path != path:
                fail(f"the batch for K1/K4's {path} launch took {c.ext.path}")
            err, _ = check_case(K, check, native, torch, c,
                                f"{path} {pname} flag {flag:#x}", qs, ts)
            for k in err:
                max_err[k] = max(max_err[k], err[k])
            log(f"[phase 2] {c.dp_name} {path:9s} {pname:9s} "
                f"flag={flag:#04x} B={B} (ring {c.ext.ring}, "
                f"{int(c.geo.rows.max())} rows): {c.dp_name}, K2 == plain on "
                f"every job; == native on a sample")
    return max_err


def check_k3_launches(seed, launches, cases, B=32):
    """K3 and K2's spliced form against their plain versions at each
    launch of `launches` (names of K3_LAUNCH_BANDS) on B spliced jobs of
    2-3 exons (introns of 80-120 bases, junction bytes on a third) that
    take it, for each (profile name, flag) of `cases` (the flag's
    rev_cigar bit picks a batch read reversed); returns the largest
    errors.  Runs in a process of its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(seed)
    max_err = {"exts": 0, "traceback": 0}
    n_intron = 0
    for path, band in K3_LAUNCH_BANDS:
        if path not in launches:
            continue
        batches = {rev: check.spliced_jobs(
            rng, B, rev=rev, exon_total=(band, band + 16), n_exons=(2, 3),
            intron_len=(80, 120)) for rev in (False, True)}
        for pname, flag in cases:
            a, b, q, e, q2, noncan, jb = PROFILES[pname]
            qp, tp, jobs, qs, ts, js = batches[bool(flag & K.EZ_REV_CIGAR)]
            c = check.OnDevice(DEVICE, qp, tp, jobs, gen_simple_mat(a, b, 1),
                               (q, e, q2), flag, 0, splice=(noncan, jb),
                               juncs=js)
            if c.k3.path != path:
                fail(f"the batch for K3's {path} launch took {c.k3.path}")
            err, n = check_case(K, check, native, torch, c,
                                f"K3 {path} {pname} flag {flag:#x}", qs, ts)
            n_intron += n
            for k in err:
                max_err[k] = max(max_err[k], err[k])
            log(f"[phase 2] K3 {path:9s} {pname:9s} flag={flag:#05x} B={B} "
                f"(ring {c.k3.ring}, {int(c.geo.rows.max())} rows): K3, K2 "
                f"== plain on every job; == native.exts on a sample ({n} "
                f"with an N op)")
    if n_intron == 0:
        fail(f"no sampled spliced job of {launches} {cases} has an intron")
    return max_err


def check_long_jobs():
    """One long job each through K1 and K4 (a full band of ~16800 lanes)
    and K3 (shorter side above 8192), their slot state in global scratch,
    against the native oracle; returns the largest errors (0: the native
    oracle, not the plain versions, holds them).  Runs in a process of its
    own."""
    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.map.align import gen_simple_mat

    rng = np.random.default_rng(20261018)
    t = rng.integers(0, 4, 16800).astype(np.uint8)
    q = check.mutate(rng, t, 0.08)
    qp = np.concatenate([q, np.zeros(16, np.uint8)])
    tp = np.concatenate([t, np.zeros(16, np.uint8)])
    jobs = np.array([[0, len(q), 0, 0, len(t), 0, -1, 400]], np.int64)
    for prof in (MAP_ONT, EXTZ):
        c = check.OnDevice(DEVICE, qp, tp, jobs,
                           gen_simple_mat(prof[0], prof[1], 1), prof[2:],
                           0x0, 0)
        if c.ext.path != "mem-global":
            fail(f"the long {c.dp_name} job took {c.ext.path}")
        native_digest(K, check, native, c, [q], [t])
        log(f"[phase 2] long {c.dp_name} job {len(q)} x {len(t)} "
            f"({c.ext.path}, ring {c.ext.ring}) == native.{c.dp_name}")
    a, b, q, e, q2, noncan, jb = SPLICE
    qp, tp, jobs, qs, ts, _ = check.spliced_jobs(
        rng, 1, junc_frac=0, exon_total=(8600, 8600), n_exons=(4, 4))
    c = check.OnDevice(DEVICE, qp, tp, jobs, gen_simple_mat(a, b, 1),
                       (q, e, q2), 0x508, 0, splice=(noncan, jb))
    if c.k3.path != "mem-global":
        fail(f"the long spliced job took K3's {c.k3.path}")
    native_digest(K, check, native, c, qs, ts)
    log(f"[phase 2] long spliced job {jobs[0, 1]} x {jobs[0, 4]} (K3 "
        f"{c.k3.path}, ring {c.k3.ring} lanes) == native.exts")
    return {}


def phase2_tasks():
    """The kernel-against-plain checks, as (function, args) for the worker
    processes, the longest first: the main batch's four cases (the timed
    inputs among them); every K1/K4 launch at map-ont and -O 4,4 -E 2,2
    under flags 0x18 and 0x0, and 128 x 5 (the main batch's launch) under
    every profile and flag; K3 at 512 x 2 (the spliced batches' launch)
    under every splice and splice:hq flag, and every other K3 launch at
    flags 0x508 and 0x5C2; the long jobs."""
    other = [p for p, _ in EXT_LAUNCH_BANDS if p != "reg128x5"]
    k3_other = [p for p, _ in K3_LAUNCH_BANDS if p != "reg512x2"]
    tasks = [(check_main_batch, (pname,)) for pname in ("map-ont", "extz")]
    for i, (pname, flag) in enumerate((("map-ont", 0x18), ("map-ont", 0x0),
                                       ("extz", 0x18), ("extz", 0x0))):
        tasks.append((check_ext_launches, (20261020 + i, other,
                                           [(pname, flag)])))
    tasks.append((check_k3_launches, (20261017, ["reg512x2"],
                                      [("splice", f) for f in SPLICE_FLAGS])))
    for i, flag in enumerate((0x508, 0x5C2)):
        tasks.append((check_k3_launches, (20261030 + i, k3_other,
                                          [("splice", flag)])))
    for i, pname in enumerate(("map-ont", "asm5", "extz", "extz-wrap")):
        tasks.append((check_ext_launches, (20261024 + i, ["reg128x5"],
                                           [(pname, f) for f in FLAGS], 48)))
    tasks.append((check_k3_launches, (20261019, ["reg512x2"],
                                      [("splice:hq", f)
                                       for f in SPLICE_HQ_FLAGS])))
    tasks.append((check_long_jobs, ()))
    return tasks


def phase2_splice_times(K, check, native, torch, gen_simple_mat, max_err,
                        B=256):
    """K3 and K2's spliced form as the engine calls them (flag 0x508, no
    junction bytes) on B spliced jobs of 2-4 exons with introns of 100-1500
    bases: every job against native.exts by digest, then timed; returns
    their records."""
    rng = np.random.default_rng(20261016)
    qp, tp, jobs, qs, ts, _ = check.spliced_jobs(rng, B)
    c = check.OnDevice(DEVICE, qp, tp, jobs, gen_simple_mat(1, 2, 1),
                       SPLICE[2:5], 0x508, 0, splice=SPLICE[5:])
    d = native_digest(K, check, native, c, qs, ts)
    log(f"[phase 2] timed spliced batch B={B} flag=0x508 ({c.k3.path}, "
        f"{int(c.geo.rows.max())} rows): == native.exts on every job "
        f"(digest {d})")
    return time_kernels(K, torch, c, max_err, OPS_PER_CELL_EXTS, (
        ("exts_dp", "exts.cu", "winnowmap_tpu/extend/pallas_kernel.py:879"),
        ("traceback_splice", "traceback.cu",
         "winnowmap_tpu/extend/pallas_kernel.py:1075")),
        f"B={B} spliced flag=0x508")


# --------------------------------------------------------------------------
# C1 (the chain forward pass) and S1 (the sketch transform)
# --------------------------------------------------------------------------

def chain_args(p):
    """chain_fwd's parameters from a CHAIN_P-like dict (gap_scale through
    the oracle's float cast)."""
    return (p["max_dist_x"], p["max_dist_y"], p["bw"], p["max_skip"],
            p["is_cdna"], float(np.float32(p["gap_scale"])))


def chain_batch(p, jobs):
    """chain_dp_device_batch's arguments for jobs under parameters p."""
    return (jobs, p["max_dist_x"], p["min_dist_x"], p["max_dist_y"],
            p["bw"], p["max_skip"], p["max_iter"], p["min_cnt"],
            p["min_sc"], p["gap_scale"], p["is_cdna"], DEVICE)


CHAIN_CHECKS = ("stage 1", "stage 2", "cdna and max_skip 1")


def check_chain(case):
    """C1 against its plain version, exactly, on chain.check's chain_sets:
    all of them under CHAIN_P ("stage 1") or CHAIN_P2 ("stage 2"); or eight
    under cDNA's gap cost with stage-2 gaps and gap scale 0.8 and the eight
    smallest at max_skip 1 (where the oracle's break, its marks and floored
    skip counter, cuts walks short of better predecessors); stage 2 also on
    chain.check's short_sets (chains that end inside the walking warp's
    wait for the producer warps), launched 200 times, each against plain;
    every job chained to the end against native.chain_dp.  Fails unless stage 2 takes
    a predecessor from outside C1's shared-memory ring (RING_REACH back:
    the gapped set).  Runs in a process of its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.chain.check import chain_sets, short_sets

    jobs = chain_sets()
    short = short_sets(np.random.default_rng(20261018))
    cdna = dict(CHAIN_P2, is_cdna=1, gap_scale=0.8)
    skip1 = dict(CHAIN_P, max_skip=1)
    small = sorted(jobs, key=lambda j: len(j[0]))[:8]
    cases = {"stage 1": [("stage 1", CHAIN_P, jobs)],
             "stage 2": [("stage 2", CHAIN_P2, jobs),
                         ("stage 2, short chains", CHAIN_P2, short)],
             "cdna and max_skip 1": [("cdna", cdna, jobs[1:9]),
                                     ("max_skip 1", skip1, small)]}[case]
    for name, p, js in cases:
        cj = CD.chain_jobs(js, p["max_dist_x"], p["min_dist_x"],
                           p["max_iter"], DEVICE)
        local = (torch.arange(cj.x.numel(), device=cj.x.device)
                 - torch.repeat_interleave(cj.off[:-1], cj.off.diff()))
        win = int((local - cj.st).max())
        kern = CD.chain_fwd(cj, *chain_args(p))
        t0 = time.perf_counter()
        plain = CD.chain_fwd_plain(cj, *chain_args(p))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = int((kern.long() - plain.long()).abs().max())
        if js is short:  # a read that races the producers shows by timing
            for _ in range(200):
                again = CD.chain_fwd(cj, *chain_args(p))
                err = max(err, int((again.long() - plain.long()).abs().max()))
        if err:
            fail(f"C1 ({name}) != plain: max abs err {err}")
        has = plain[1] >= 0
        back = int((local - plain[1].long())[has].max()) if has.any() else 0
        if name == "stage 2" and back <= CD.RING_REACH:
            fail(f"C1 ({name}): no predecessor taken from outside the ring "
                 f"({back} back, reach {CD.RING_REACH})")
        res = CD.chain_dp_device_batch(*chain_batch(p, js))
        bad = [i for i, ((ax, ay), r) in enumerate(zip(js, res))
               if not all(np.array_equal(a, b) for a, b in zip(
                   native.chain_dp(ax, ay, n_segs=1, **p), r))]
        if bad:
            fail(f"C1 ({name}): jobs {bad[:8]} differ from native.chain_dp")
        log(f"[phase 2] C1 {name}: {len(js)} anchor sets of "
            f"{min(map(len, (a for a, _ in js)))}-"
            f"{max(map(len, (a for a, _ in js)))} anchors, windows up to "
            f"{win}, predecessors taken up to {back} back (ring reach "
            f"{CD.RING_REACH}): == plain (plain {dt:.1f} s) and == "
            f"native.chain_dp on every job")


def hold_chain(jobs, p):
    """Phase 9's C1 launch (its anchor sets `jobs` under parameters p) run
    again on the card and through the plain version, with its tally of the
    candidates the oracle evaluates and of those that pass its distance
    tests: they must be exactly equal; and each set chained to the end
    through the device against native.chain_dp.  Returns the largest
    difference (0), the plain version's host ms and the tally.  Runs in a
    process of its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.chain import device as CD

    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], DEVICE)
    kern = CD.chain_fwd(cj, *chain_args(p))
    tally = torch.zeros(2, dtype=torch.int64, device=cj.x.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = CD.chain_fwd_plain(cj, *chain_args(p), tally=tally)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((kern.long() - plain.long()).abs().max())
    if err:
        fail(f"phase 9: C1's launch != plain: max abs err {err}")
    res = CD.chain_dp_device_batch(*chain_batch(p, jobs))
    bad = [i for i, ((ax, ay), r) in enumerate(zip(jobs, res))
           if not all(np.array_equal(a, b) for a, b in zip(
               native.chain_dp(ax, ay, n_segs=1, **p), r))]
    if bad:
        fail(f"phase 9: C1's chains {bad} differ from native.chain_dp")
    return err, plain_ms, tally.tolist()


def sketch_seq(rng, n):
    """n bases of A/C/G/T, lower case and N, as tests/test_sketch.py draws
    them."""
    return rng.choice(list(b"ACGTacgtN"), n,
                      p=[.22, .22, .22, .22, .02, .02, .02, .02, .04]
                      ).astype(np.uint8).tobytes()


def s1_diff(torch, a, b) -> int:
    """Words of S1's outputs (key, the order's bits, flags) that differ."""
    return sum(int((x.view(torch.int64) if x.dtype == torch.float64 else x)
                   .ne(y.view(torch.int64) if y.dtype == torch.float64
                       else y).sum()) for x, y in zip(a, b))


def check_sketch():
    """S1 against its plain version on the codes of 200 kb with N bases and
    of the SKETCH_TIMED bases (tools/time_sketch.py's timed_seq), HPC off
    and on, k = 15, 19, 28, with no set, a sorted set of every 37th base's
    canonical k-mer and its bloom table: every output word exactly;
    sketch_device against native.sketch on the 200 kb with such a set and
    in bloom mode (k = 15, w = 50; k = 19, w = 19).  Runs in a process of
    its own."""
    import torch

    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.index.build import weight_bloom
    from winnowmap_tpu_torch.io.seqcode import encode
    from winnowmap_tpu_torch.sketch import device as SD
    from winnowmap_tpu_torch.tools import time_sketch

    small = sketch_seq(np.random.default_rng(20261016), 200_000)
    checked = 0
    for seq in (small, time_sketch.timed_seq(np)):
        for hpc in (False, True):
            codes = encode(seq)
            if hpc:
                codes = SD.compact_hpc(codes)[0]
            ct = torch.from_numpy(codes).to(DEVICE)
            for k in (15, 19, 28):
                canon = SD.transform_plain(ct, k)[4]
                ws = np.unique(canon[::37].cpu().numpy().view(np.uint64))
                for mode, wt in (
                        ("none", SD.weights_on(None, None, DEVICE)),
                        ("set", SD.weights_on(ws, None, DEVICE)),
                        ("bloom", SD.weights_on(None, weight_bloom(ws),
                                                DEVICE))):
                    err = s1_diff(torch, SD.sketch(ct, k, wt),
                                  SD.sketch_plain(ct, k, wt))
                    if err:
                        fail(f"S1 != plain on {len(codes)} codes (k={k}, "
                             f"hpc={hpc}, {mode}): {err} words differ")
                    if mode != "none" and not SD.flagged_plain(
                            canon, wt).any():
                        fail(f"S1's check ({mode}) down-weights nothing")
                    checked += 1
    empty = np.zeros(0, np.uint64)
    for hpc in (False, True):
        for k, w in ((15, 50), (19, 19)):
            ws = np.unique(np.array(
                [native.encode_kmer(small[o:o + k].upper())
                 for o in range(0, len(small) - k, 37)
                 if b"N" not in small[o:o + k]], np.uint64))
            for wset, bloom in ((ws, None), (empty, weight_bloom(ws))):
                want = native.sketch(small, w, k, 0, hpc, wset, bloom)
                got = SD.sketch_device(small, w, k, 0, hpc, wset, bloom,
                                       device=DEVICE)
                if not all(np.array_equal(a, b) for a, b in zip(want, got)):
                    fail(f"sketch_device (k={k}, w={w}, hpc={hpc}, "
                         f"bloom={bloom is not None}) differs from "
                         f"native.sketch")
    log(f"[phase 2] S1: {checked} cases (200 kb with N bases and "
        f"{SKETCH_TIMED} bases, HPC off and on, k = 15, 19, 28, no set, a "
        f"sorted set, its bloom table) == plain; sketch_device == "
        f"native.sketch with a weighted set and in bloom mode (k=15 w=50, "
        f"k=19 w=19, HPC off and on)")


def kernel_record(nm, src, rep, err, ms, pms, tb, to):
    """A kernels-line record of a CUDA kernel: bound_ms is the larger of the
    bytes' time tb and the operations' time to; launches is set from the
    main path's run."""
    return {"name": nm, "route": "cuda",
            "source": f"winnowmap_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def phase2_chain_times(torch, native, CD):
    """C1, the whole device chain (upload, C1, the host's tail) and
    native.chain_dp on single chains of CHAIN_SIZES anchors under CHAIN_P2,
    each chain against native.chain_dp (C1's record for the kernels line
    comes from phase 9's launch, c1_record)."""
    from winnowmap_tpu_torch.chain.check import anchor_set
    from winnowmap_tpu_torch.tools import time_ms

    dev = torch.device(DEVICE)
    saved = dict(CD.LAUNCHES)
    p = CHAIN_P2
    sizes = []
    rng = np.random.default_rng(20261021)
    for n in CHAIN_SIZES:
        ax, ay = anchor_set(rng, n, n_clusters=1)
        cjn = CD.chain_jobs([(ax, ay)], p["max_dist_x"], p["min_dist_x"],
                            p["max_iter"], dev)
        kms = time_ms(lambda: CD.chain_fwd(cjn, *chain_args(p)), dev, 3)
        t0 = time.perf_counter()
        for _ in range(3):
            want = native.chain_dp(ax, ay, n_segs=1, **p)
        host_ms = (time.perf_counter() - t0) * 1e3 / 3
        t0 = time.perf_counter()
        for _ in range(3):
            res = CD.chain_dp_device_batch(*chain_batch(p, [(ax, ay)]))[0]
        dev_ms = (time.perf_counter() - t0) * 1e3 / 3
        if not all(np.array_equal(a, b) for a, b in zip(want, res)):
            fail(f"the device chain of {n} anchors differs from native")
        sizes.append({"anchors": n, "c1_ms": kms, "device_chain_ms": dev_ms,
                      "native_chain_dp_ms": host_ms})
    log("[phase 2] single chains under asm5's stage-2 parameters, C1 (CUDA "
        "events), the whole device chain and native.chain_dp (host clock), "
        "each == native.chain_dp, JSON " + json.dumps(sizes))
    CD.LAUNCHES.update(saved)  # comparison launches are not main-path


def s1_bound(n, n_set):
    """S1's bound on n codes with a sorted set of n_set entries: (bytes ms,
    operations ms).  Each code byte read once, key, order and flags written
    once, the set read once; the operations of OPS_PER_BASE_S1 and the
    set's binary search."""
    probes = int(np.log2(n_set)) + 1 if n_set else 0
    tb = (18 * n + 8 * n_set) / HBM_BPS * 1e3
    to = n * (OPS_PER_BASE_S1 + OPS_PER_PROBE_S1 * probes) / INT32_OPS * 1e3
    return tb, to


def phase2_sketch_times(torch, native, SD, seqcode):
    """S1 on the SKETCH_TIMED codes (k = 19) with tools/time_sketch.py's
    down-weight sets (none; 3 and 1,751, the sizes of phase 4's and phase
    9's repeat lists; 1,000,000; the bloom table of the 1,751), each held
    to its plain version and timed: the kernel by torch.profiler's device
    time (ms), a wrapper call by CUDA events over a train of calls
    (call_ms, which holds the wrapper's host time where the host is the
    slower side); sketch_device by stage
    (encode, upload, S1, copy-back, the automaton; the host clock) against
    native.sketch on the same bases (w = 19, no set), equal.  Returns S1's
    kernels-line record, on the 1,751-entry list."""
    from winnowmap_tpu_torch.index.build import weight_bloom
    from winnowmap_tpu_torch.tools import time_ms, time_sketch

    dev = torch.device(DEVICE)
    saved = dict(SD.LAUNCHES)
    seq = time_sketch.timed_seq(np)
    codes = torch.from_numpy(seqcode.encode(seq)).to(dev)
    k = time_sketch.K
    canon = SD.transform_plain(codes, k)[4]
    sets = time_sketch.weight_sets(np, canon.cpu().numpy().view(np.uint64))
    cases = {"none": SD.weights_on(None, None, dev)}
    cases.update({nm: SD.weights_on(ws, None, dev)
                  for nm, ws in sets.items()})
    cases["bloom1751"] = SD.weights_on(None, weight_bloom(sets["list1751"]),
                                       dev)
    out = {}
    for nm, wt in cases.items():
        plain = SD.sketch_plain(codes, k, wt)
        err = s1_diff(torch, SD.sketch(codes, k, wt), plain)
        if err:
            fail(f"S1 != plain on {SKETCH_TIMED} codes ({nm}): {err} words "
                 f"differ")
        def fn():
            return SD.sketch(codes, k, wt)

        tb, to = s1_bound(SKETCH_TIMED, len(wt.wset))
        if time_sketch.kernel_ms(torch, fn, 2) <= 0:
            fail("phase 2: torch.profiler saw no device time of S1")
        out[nm] = {"ms": time_sketch.kernel_ms(torch, fn, 20),
                   "call_ms": time_ms(fn, dev, 20), "bound_ms": max(tb, to),
                   "down_weighted": int(SD.flagged_plain(canon, wt).sum())}
    wt = cases["list1751"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    SD.sketch_plain(codes, k, wt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    none = np.zeros(0, np.uint64)
    want = native.sketch(seq, 19, k, 0, False, none)
    SD.sketch_device(seq, 19, k, 0, False, none, device=dev)
    stages = {}
    t0 = time.perf_counter()
    got = SD.sketch_device(seq, 19, k, 0, False, none, device=dev,
                           stages=stages)
    dev_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native.sketch(seq, 19, k, 0, False, none)
    nat_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(a, b) for a, b in zip(want, got)):
        fail(f"sketch_device on {SKETCH_TIMED} bases differs from "
             f"native.sketch")
    tb, to = s1_bound(SKETCH_TIMED, len(wt.wset))
    log(f"[phase 2] S1 on {SKETCH_TIMED} codes, k = {k}, each case == plain"
        f", kernel ms: " + ", ".join(
            f"{nm} {o['ms']:.4f} (call {o['call_ms']:.4f}, bound "
            f"{o['bound_ms']:.5f})" for nm, o in out.items())
        + f"; plain {plain_ms:.2f} ms (list1751); sketch_device {dev_ms:.1f}"
        f" ms against native.sketch {nat_ms:.1f} ms (w = 19, no set), == "
        f"there; by stage (ms) " + ", ".join(
            f"{nm} {v * 1e3:.2f}" for nm, v in stages.items()))
    log("[phase 2] S1 JSON " + json.dumps({
        "cases": out, "plain_ms": plain_ms, "sketch_device_ms": dev_ms,
        "native_sketch_ms": nat_ms,
        "stages_ms": {nm: v * 1e3 for nm, v in stages.items()}}))
    SD.LAUNCHES.update(saved)  # comparison launches are not main-path
    return kernel_record("sketch", "sketch.cu",
                         "winnowmap_tpu/sketch/device.py:30", 0,
                         out["list1751"]["ms"], plain_ms, tb, to)


def chain_params(args):
    """A CHAIN_P-like dict from chain_dp_device_batch's positional
    parameters (after the jobs, before the device)."""
    names = ("max_dist_x", "min_dist_x", "max_dist_y", "bw", "max_skip",
             "max_iter", "min_cnt", "min_sc", "gap_scale", "is_cdna")
    return dict(zip(names, args))


def time_chain_launch(torch, CD, launch):
    """C1 on phase 9's launch (its anchor sets and parameters, as
    recorded), timed by CUDA events with the card to itself; returns its
    ms (the launch is not counted as the main path's)."""
    from winnowmap_tpu_torch.tools import time_ms

    jobs, p = launch
    dev = torch.device(DEVICE)
    saved = dict(CD.LAUNCHES)
    cj = CD.chain_jobs(jobs, p["max_dist_x"], p["min_dist_x"],
                       p["max_iter"], dev)
    ms = time_ms(lambda: CD.chain_fwd(cj, *chain_args(p)), dev, 3)
    CD.LAUNCHES.update(saved)
    return ms


def c1_record(launch, ms, held):
    """C1's kernels-line record from phase 9's launch: its CUDA-event ms,
    and from hold_chain the difference from plain, the plain version's ms
    and the oracle's evaluated and passing candidates (the bound's
    count)."""
    jobs, p = launch
    err, plain_ms, (evaluated, passing) = held
    n, B = sum(len(ax) for ax, _ in jobs), len(jobs)
    ops = evaluated * OPS_PER_CANDIDATE + passing * OPS_PER_PASSING
    to = (ops / INT32_OPS + passing * F64_PER_PASSING / FP64_OPS) * 1e3
    # each anchor's x y span st read once, f pre v written once; each
    # job's offset and average q_span
    tb = (28 * n + 16 * B + 8) / HBM_BPS * 1e3
    log(f"[phase 9] C1 on the run's launch ({B} chains, {n} anchors, bw "
        f"{p['bw']}, max gap {p['max_dist_x']}): {ms:.3f} ms; plain "
        f"{plain_ms:.1f} ms, == plain and every chain == native.chain_dp; "
        f"the oracle evaluates {evaluated} candidates ({evaluated / n:.2f} "
        f"an anchor), {passing} pass; bound {max(tb, to):.5f} ms")
    return kernel_record("chain_fwd", "chain.cu",
                         "winnowmap_tpu/chain/device.py:54", err, ms,
                         plain_ms, tb, to)


def build_both(phase, torch, build, recs, io_, wset):
    """The index through S1 (the device gate) and through native.sketch:
    keys, start and pos must be equal, and the build must launch S1 once.
    Logs both builds' seconds, S1's event ms, and the device sketch of the
    same sequences (sketch_records, as build_index calls it) by stage on
    the host clock (encode, upload, S1, copy-back, the automaton) against
    native.sketch; returns the S1-built index."""
    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch.io.seqcode import encode
    from winnowmap_tpu_torch.sketch import device as SD

    SD.reset_launches()
    with EntryTimer(torch, ["wm_sketch_launch"]) as timer:
        t0 = time.perf_counter()
        mi = build.build_index(recs, io_.w, io_.k, io_.flag, wset)
        dev_s = time.perf_counter() - t0
    s1_ms = sum(timer.ms("wm_sketch_launch"))
    n = SD.LAUNCHES["sketch"]
    t0 = time.perf_counter()
    ref = build.build_index(recs, io_.w, io_.k, io_.flag, wset,
                            sketch_min_bp=None)
    host_s = time.perf_counter() - t0
    for f in ("keys", "start", "pos"):
        if not np.array_equal(getattr(mi, f), getattr(ref, f)):
            fail(f"{phase}: the S1-built index's {f} differs from the "
                 f"native build's")
    if n != 1:
        fail(f"{phase}: the index build launched S1 {n} times, not once")
    t0 = time.perf_counter()
    want = [native.sketch(r.seq, io_.w, io_.k, rid, False, wset)
            for rid, r in enumerate(recs)]
    nat_ms = (time.perf_counter() - t0) * 1e3
    wt = SD.weights_on(wset, None, DEVICE)
    torch.cuda.synchronize()
    stages = {}
    t0 = time.perf_counter()
    codes = [encode(r.seq) for r in recs]
    stages["encode"] = time.perf_counter() - t0
    got = SD.sketch_records(codes, io_.w, io_.k, list(range(len(recs))),
                            False, wt, stages)
    dev_ms = sum(stages.values()) * 1e3
    if not all(np.array_equal(a, b) for w_, g in zip(want, got)
               for a, b in zip(w_, g)):
        fail(f"{phase}: sketch_records differs from native.sketch")
    log(f"[{phase}] index of {sum(len(r.seq) for r in recs)} bp in "
        f"{len(recs)} sequences through S1 ({n} launch, {s1_ms:.3f} ms of "
        f"S1 events) == the native build (keys, start, pos); build "
        f"{dev_s:.3f} s against {host_s:.3f} s; the device sketch "
        f"{dev_ms:.1f} ms against native.sketch {nat_ms:.1f} ms on the same "
        f"sequences, by stage (ms) " + ", ".join(
            f"{nm} {v * 1e3:.2f}" for nm, v in stages.items()))
    log(f"[{phase}] sketch JSON " + json.dumps({
        "bp": sum(len(r.seq) for r in recs), "s1_launches": n,
        "s1_event_ms": s1_ms, "build_s": dev_s, "native_build_s": host_s,
        "device_sketch_ms": dev_ms, "native_sketch_ms": nat_ms,
        "stages_ms": {nm: v * 1e3 for nm, v in stages.items()}}))
    SD.reset_launches()
    return mi


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
    phase3_pinned(cli)


# the goldens tests/test_torch_golden_*.py pin on a few reads: the CLI's
# arguments before t_ref.fa and t_reads.fa (list files in GOLD), the golden
PINNED_GOLDENS = (
    (["-x", "map-pb", "-c", "-W", "t_rep_k19_pb.txt"], "golden_mappb.paf"),
    (["-x", "asm20", "-c", "-W", "t_rep_k19_empty.txt"], "golden_asm20.paf"),
    (["--sv-off", "-c", "--cs", "-W", "t_rep_k15.txt"],
     "golden_svoff_cs.paf"),
    (["--sv-off", "-c", "--MD", "-W", "t_rep_k15.txt"],
     "golden_svoff_md.paf"),
    (["--sv-off", "-W", "t_rep_k15.txt"], "golden_svoff_nocig.paf"))


def phase3_pinned(cli):
    """PINNED_GOLDENS in full on the card, each index built through S1
    (sketch_min_bp 0, one launch), byte-equal; and t_ref.fa's index with
    HPC (-H, map-pb's k and w: no golden sketches with HPC) through S1 ==
    the native build."""
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io import fastx
    from winnowmap_tpu_torch.sketch import device as SD

    real = cli.build_index

    def via_s1(*a, **kw):
        return real(*a, **kw, sketch_min_bp=0)

    cli.build_index = via_s1
    try:
        for argv, golden in PINNED_GOLDENS:
            argv = [str(GOLD / a) if a.endswith(".txt") else a for a in argv]
            SD.reset_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + [str(GOLD / "t_ref.fa"),
                                      str(GOLD / "t_reads.fa")])
            dt = time.perf_counter() - t0
            if rc != 0:
                fail(f"CLI {' '.join(argv[:-2])} exited {rc}")
            if SD.LAUNCHES["sketch"] != 1:
                fail(f"phase 3: {golden}'s index launched S1 "
                     f"{SD.LAUNCHES['sketch']} times, not once")
            if buf.getvalue() != (GOLD / golden).read_text():
                fail(f"phase 3: the CLI's PAF differs from {golden}")
            log(f"[phase 3] {' '.join(argv[:-2])} (index through S1) == "
                f"{golden} ({dt:.2f} s)")
    finally:
        cli.build_index = real
    recs = fastx.read_all(str(GOLD / "t_ref.fa"))
    wset = build.load_weight_set(str(GOLD / "t_rep_k15.txt"), 15)
    SD.reset_launches()
    mi = build.build_index(recs, 10, 15, 1, wset, True, sketch_min_bp=0)
    ref = build.build_index(recs, 10, 15, 1, wset, True, sketch_min_bp=None)
    if SD.LAUNCHES["sketch"] != 1 or not all(
            np.array_equal(getattr(mi, f), getattr(ref, f))
            for f in ("keys", "start", "pos")):
        fail("phase 3: t_ref.fa's HPC index through S1 differs from the "
             "native build")
    SD.reset_launches()
    log(f"[phase 3] t_ref.fa with HPC (k = 15, w = 10), index through S1 "
        f"== the native build ({len(mi.keys)} keys)")


def rep_list(seqs, k: int, path: Path):
    """The down-weight list of the sequences (bytes), as meryl makes it
    for -W: their canonical k-mers counted by count_kmers on the card (KC),
    those above the threshold that covers 0.9998 of the distinct k-mers
    (meryl 'print greater-than distinct=0.9998'), written to path as
    'KMER<TAB>count' lines.  Returns the selected KmerCounts."""
    from types import SimpleNamespace

    from winnowmap_tpu_torch.kcount import count_kmers

    kc = count_kmers([SimpleNamespace(seq=s) for s in seqs], k,
                     device=DEVICE)
    sel = kc.greater_than(kc.threshold_distinct(0.9998))
    with open(path, "w") as f:
        f.writelines(ln + "\n" for ln in sel.print_lines())
    return sel


def rep_kmers_numpy(codes_list, k: int, frac: float):
    """rep_list's selection with numpy on 0..3 codes (the list phases 4-9
    once made), for phase 10 (a)'s check: canonical k-mer counts, and the
    k-mers above the threshold that covers `frac` of the distinct ones."""
    sh = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    cans = []
    for codes in codes_list:
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


def map_timed(torch, K, batch, mi, mo, seqs, names, mode):
    """map_batch on the reads after a warm-up on eight, with the launch
    counts and STATS zeroed first, the DP kernel (mode "extd", "extz" or
    "exts") and K2 timed and their calls recorded, and the jobs that the
    refusal guards keep off the device counted (none on the engine path);
    returns (results, wall s, launches, STATS, the timer, that count).  The
    timer's `peak` is the most the run reserved on the card."""
    batch.map_batch(mi, mo, seqs[:8], names[:8])
    torch.cuda.synchronize()
    batch.STATS.clear()
    K.reset_launches()
    # the peak is this run's own, not what an earlier phase left cached
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with GuardCount(batch) as guard, LaunchTimer(K, torch, mode) as timer:
        t0 = time.perf_counter()
        results = batch.map_batch(mi, mo, seqs, names)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    timer.peak = torch.cuda.max_memory_reserved()
    launches = dict(K.LAUNCHES)
    st = {k: round(float(v), 6) for k, v in batch.STATS.items()}
    return results, dt, launches, st, timer, guard.n


def refuses(job):
    """Whether the reference's refusal guards keep a DP job off the device
    (wm_engine.cpp device_eligible): an empty side, a DP matrix above
    --cap-sw-mem, or a spliced profile that wm_exts refuses (q2 <= q + e,
    or a mismatch or N score beyond 2(q + e))."""
    from winnowmap_tpu_torch.options import MM_F_SPLICE

    opt, qlen, tlen = job[0], len(job[1]), len(job[2])
    if qlen == 0 or tlen == 0 or 0 < opt.max_sw_mat < qlen * tlen:
        return True
    qe = opt.q + opt.e
    return bool(opt.flag & MM_F_SPLICE) and (
        opt.q2 <= qe or max(abs(opt.b), abs(opt.sc_ambi)) > 2 * qe)


class GuardCount:
    """While the block runs: how many of the jobs that the generator path's
    tasks yield refuses() keeps off the device, counted from each job's
    options and sizes apart from the path's own test (align.refused)."""

    def __init__(self, batch):
        self.task, self.n = batch._Task, 0

    def __enter__(self):
        self.advance = advance = self.task.advance

        def counted(t, send_val=None):
            advance(t, send_val)
            if t.job is not None:
                jobs = t.job if isinstance(t.job, list) else [t.job]
                self.n += sum(map(refuses, jobs))
        self.task.advance = counted
        return self

    def __exit__(self, *exc):
        self.task.advance = self.advance


def log_device(phase, timer, dt, n, launches, st):
    """Log a timed run's reads/s, device time (summed ms and share of the
    wall of the DP kernel and K2), the DP kernel's launches by flag and by
    launch, jobs and longest rows per call, and the host's seconds; returns
    the timer's summary."""
    dev = timer.summary(dt)
    a, b = LaunchTimer.NAMES[timer.mode]
    A, B = a.upper(), b.upper()
    log(f"[{phase}] {n} reads in {dt:.3f} s -> {n / dt:.3f} reads/s; "
        f"launches {launches}")
    log(f"[{phase}] device time: {A} {dev[f'{a}_ms']:.3f} ms over "
        f"{dev[f'{a}_launches']} launches ({100 * dev[f'{a}_share']:.2f}% of "
        f"the wall), {B} {dev[f'{b}_ms']:.3f} ms over "
        f"{dev[f'{b}_launches']} ({100 * dev[f'{b}_share']:.2f}%), R1 "
        f"{dev['r1_ms']:.3f} ms over {dev['r1_launches']} "
        f"({100 * dev['r1_share']:.2f}%; {dev['r1_bytes']} bytes, bound "
        f"{dev['r1_bound_ms']:.4f} ms); {A} by "
        f"flag {dev[f'{a}_by_flag']}, by launch {dev[f'{a}_by_path']}; jobs "
        f"per call (min, median, max) {dev['jobs_per_call']}; longest job's "
        f"rows per call (median, max) {dev['rows_per_call']}; card memory "
        f"reserved at most {dev['peak_reserved_gib']:.2f} GiB; host: "
        f"dispatch_s {st.get('dispatch_s')}, dev_wait_s "
        f"{st.get('dev_wait_s')}")
    calls = max(1, st.get("dev_calls", 0))
    log(f"[{phase}] collect: dev_calls {int(st.get('dev_calls', 0))}, "
        f"collect_runs {int(st.get('collect_runs', 0))}, collect_d2h_bytes "
        f"{int(st.get('collect_d2h_bytes', 0))} "
        f"({st.get('collect_d2h_bytes', 0) / calls:.0f} a call), "
        f"collect_decode_s {st.get('collect_decode_s')}, collect_copy_s "
        f"{st.get('collect_copy_s')}")
    log(f"[{phase}] STATS " + json.dumps(st, sort_keys=True))
    log(f"[{phase}] JSON " + json.dumps({
        "reads": n, "wall_s": dt, "reads_per_s": n / dt, "device": dev,
        "dispatch_s": st.get("dispatch_s"),
        "dev_wait_s": st.get("dev_wait_s"), "launches": launches}))
    return dev


def phase4(torch, K, build, fastx, options, batch, seqcode, holds, r1):
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
    rep = DATA / "wmbench2_rep.txt"
    rep_list([r.seq for r in recs], 15, rep)
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("map-ont", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    wset = build.load_weight_set(str(rep), io_.k)
    mi = build_both("phase 4", torch, build, recs, io_, wset)
    options.update_mid_occ(mo, mi)
    log(f"[phase 4] corpus {len(codes)} bp, {len(wset)} repetitive 15-mers,"
        f" index {len(mi.keys)} keys ({time.perf_counter() - t0:.1f} s)")
    rs = fastx.read_all(str(reads))
    seqs, names = [r.seq for r in rs], [r.name for r in rs]
    results, dt, launches, st, timer, _ = map_timed(
        torch, K, batch, mi, mo, seqs, names, "extd")
    n_mapped = sum(1 for r in results if r.regs)
    log(f"[phase 4] {n_mapped} of {len(seqs)} reads ({sum(map(len, seqs))} "
        f"bp) with hits; dev_jobs {int(st['dev_jobs'])} vs engine host-kept "
        f"{int(st.get('eng_host_dp_calls', 0))}")
    log_device("phase 4", timer, dt, len(seqs), launches, st)
    holds += timer.pick("phase 4")
    r1.append(r1_record("phase 4", torch, K, timer, launches))
    if launches["extd"] == 0 or launches["traceback"] == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    check_mapped("phase 4", st, results, len(seqs))
    return launches, (mi, seqs, names), {"results": results, "wall_s": dt,
                                         "mo": mo}


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


def splice_corpus(check, ref: Path, reads: Path, bed: Path,
                  seed: int = 20261016, genome_len: int = 4_000_000,
                  n_genes: int = 400, n_reads: int = 5000):
    """A genome of two chromosomes with n_genes genes, one per slot of
    genome_len / n_genes bases, half of them on the reverse strand: 4-12
    exons of 60-400 bases joined by canonical GT..AG introns of 80-8000
    bases (log-uniform, scaled down to fit the slot); a BED12 of the genes
    (one line a gene, its exons as blocks); and n_reads reads, each a
    transcript from either strand cut at its 5' end to 40-100% of its
    length, at 4% substitutions and 2% indels."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome_len).astype(np.uint8)
    slot = genome_len // n_genes
    tx, genes = [], []
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
        starts = np.cumsum([0] + [len(x) for x in parts])[:-1:2]
        sizes = [len(x) for x in exons]
        strand = "+"
        if rng.random() < 0.5:  # reverse strand: CT..AC in the genome
            gene = (3 - gene)[::-1]
            starts = (len(gene) - starts - sizes)[::-1]
            sizes = sizes[::-1]
            strand = "-"
        o = k * slot + 200
        g[o:o + len(gene)] = gene
        tx.append(np.concatenate(exons))
        genes.append((o, len(gene), strand, starts, sizes))
    half = genome_len // 2
    with open(ref, "w") as f:
        for i, (a, b) in enumerate(((0, half), (half, genome_len))):
            f.write(f">chr{i + 1}\n")
            f.write("".join("ACGT"[c] for c in g[a:b].tolist()) + "\n")
    with open(bed, "w") as f:
        for k, (o, n, strand, starts, sizes) in enumerate(genes):
            c, o = (1, o) if o < half else (2, o - half)
            f.write(f"chr{c}\t{o}\t{o + n}\tgene{k}\t0\t{strand}\t{o}\t"
                    f"{o + n}\t0\t{len(sizes)}\t"
                    + "".join(f"{x}," for x in sizes) + "\t"
                    + "".join(f"{x}," for x in starts) + "\n")
    with open(reads, "w") as f:
        for i in range(n_reads):
            t = tx[int(rng.integers(0, n_genes))]
            t = t[len(t) - int(len(t) * rng.uniform(0.4, 1.0)):]
            if rng.random() < 0.5:
                t = (3 - t)[::-1]
            r = check.mutate_rates(rng, t, 0.04, 0.02)
            f.write(f">tx{i}\n" + "".join("ACGT"[c] for c in r.tolist())
                    + "\n")


class RleRecorder:
    """While the block runs: each K.cigar_rle call's starts, row length and
    run counts (R1's bytes, counted after the run), and the arguments of
    the call with the most op slots, kept on the card to time R1 on."""

    def __init__(self, K):
        self.K, self.fn = K, K.cigar_rle
        self.calls, self.widest = [], None

    def __enter__(self):
        self.K.cigar_rle = self._record
        return self

    def __exit__(self, *exc):
        self.K.cigar_rle = self.fn

    def _record(self, ops, fin, start, rev, min_intron=0, cap=None):
        out = self.fn(ops, fin, start, rev, min_intron, cap)
        self.calls.append((start, ops.shape[1], out[2]))
        if self.widest is None or ops.numel() > self.widest[0].numel():
            self.widest = (ops, fin, start, rev, min_intron, cap)
        return out

    def bytes(self):
        """Each call's bytes (rle_bytes)."""
        return [rle_bytes(st, n, ln) for st, n, ln in self.calls]


def rle_bytes(start, n_ops, ln) -> int:
    """R1's bytes in a call: each input read once (the op bytes of the
    walks, slots 0 ... i0 + j0 of each start; fin and start, 16 bytes a
    job) and each output written once (off and len, 12 bytes a job; 4 bytes
    a run)."""
    from winnowmap_tpu_torch.extend import check

    return (int(check.walk_slots(start, n_ops).sum()) + 28 * len(start)
            + 4 * int(ln.sum()))


class LaunchTimer(EntryTimer):
    """An EntryTimer around a DP kernel's, K2's and R1's C launch entries
    (mode "extd": K1, wm_extd_launch; "extz": K4, wm_extz_launch; "exts":
    K3, wm_exts_launch; and wm_traceback_launch, wm_cigar_rle_launch), and
    each K.extd_dp, K.extz_dp or K.exts_dp call's arguments by name
    (check.CallRecorder; the pools are shared), to count launches by flag
    and by launch and to pick one call of each launch to hold to the plain
    versions; R1's calls through RleRecorder."""

    NAMES = {"extd": ("k1", "k2"), "extz": ("k4", "k2"),
             "exts": ("k3", "k2s")}

    def __init__(self, K, torch, mode):
        from winnowmap_tpu_torch.extend import check

        self.mode = mode
        self.entries = (f"wm_{mode}_launch", "wm_traceback_launch",
                        "wm_cigar_rle_launch")
        super().__init__(torch, self.entries)
        self.rec = check.CallRecorder(mode)
        self.rle = RleRecorder(K)
        self.calls = self.rec.calls
        self.peak = 0

    def __enter__(self):
        self.rec.__enter__()
        self.rle.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self.rec.__exit__(*exc)
        self.rle.__exit__(*exc)
        super().__exit__(*exc)

    def sizes(self):
        return self.rec.sizes()

    def summary(self, wall_s):
        """Summed device ms and share of the wall of the DP kernel, K2 and
        R1, R1's bytes and their time at the memory rate, the DP kernel's
        launches by flag and by launch, jobs per call and the longest job's
        rows per call."""
        dp_ms, k2_ms, r1_ms = (self.ms(name) for name in self.entries)
        r1_bytes = sum(self.rle.bytes())
        flags, paths = {}, {}
        for c in self.calls:
            f, g = f"{c['flag']:#x}", c["geo"].path
            flags[f] = flags.get(f, 0) + 1
            paths[g] = paths.get(g, 0) + 1
        sizes = self.sizes() or [(0, 0)]
        jobs = [n for n, _ in sizes]
        rows = [r for _, r in sizes]
        a, b = self.NAMES[self.mode]
        return {
            f"{a}_ms": float(sum(dp_ms)), f"{a}_launches": len(dp_ms),
            f"{a}_share": sum(dp_ms) / 1e3 / wall_s,
            f"{b}_ms": float(sum(k2_ms)), f"{b}_launches": len(k2_ms),
            f"{b}_share": sum(k2_ms) / 1e3 / wall_s,
            "r1_ms": float(sum(r1_ms)), "r1_launches": len(r1_ms),
            "r1_share": sum(r1_ms) / 1e3 / wall_s, "r1_bytes": r1_bytes,
            "r1_bound_ms": r1_bytes / HBM_BPS * 1e3,
            f"{a}_by_flag": flags, f"{a}_by_path": paths,
            "jobs_per_call": [min(jobs), float(np.median(jobs)), max(jobs)],
            "rows_per_call": [float(np.median(rows)), max(rows)],
            "peak_reserved_gib": self.peak / 2**30}

    def pick(self, phase, juncs=False):
        """For each launch the DP kernel took, the call at the median of
        that launch's longest rows (check.CallRecorder.picks), as
        hold_call's arguments with the tensors copied to the host."""
        return [(phase, self.mode, p, r,
                 {k: v.cpu().numpy() if hasattr(v, "cpu") else v
                  for k, v in c.items()})
                for p, r, c in self.rec.picks(juncs)]


def r1_record(phase, torch, K, timer, launches):
    """R1 on the timed run's call with the most op slots: its CUDA-event ms
    over 20 launches, its plain version's host-clock ms and its bytes'
    time at the memory rate (rle_bytes), held to the plain version and to
    the native decode; the kernels line's record, with the run's R1
    launches, which must equal its K2 launches (one a call with a
    CIGAR)."""
    from winnowmap_tpu_torch import native
    from winnowmap_tpu_torch.extend import check
    from winnowmap_tpu_torch.tools import time_ms

    if launches["rle"] != launches["traceback"]:
        fail(f"{phase}: {launches['rle']} R1 launches for "
             f"{launches['traceback']} K2 launches")
    ops, fin, start, rev, min_intron, cap = timer.rle.widest
    saved = dict(K.LAUNCHES)
    err = check.rle_err(ops, fin, start, rev, min_intron)
    blob, off, ln = K.cigar_rle(ops, fin, start, rev, min_intron, cap)
    words = blob.cpu().numpy().view(np.uint32)
    want = check.native_cigars(native, ops, fin, rev, timer.mode == "exts",
                               min_intron)
    err += sum(not np.array_equal(words[o:o + n], w) for o, n, w in
               zip(off.tolist(), ln.tolist(), want))
    ms = time_ms(lambda: K.cigar_rle(ops, fin, start, rev, min_intron, cap),
                 torch.device(DEVICE), 20)
    t0 = time.perf_counter()
    K.cigar_rle_plain(ops, fin, start, rev, min_intron)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    K.LAUNCHES.update(saved)  # comparison launches are not main-path ones
    if err:
        fail(f"{phase}: R1 != plain or native on {err} jobs of its widest "
             "call")
    by = rle_bytes(start, ops.shape[1], ln)
    rec = kernel_record("cigar_rle", "cigar.cu", "none (the JAX package "
                        "decodes K2's packed rows on the host, native "
                        "wm_rle_ops)", err, ms, pms, by / HBM_BPS * 1e3, 0.0)
    rec["launches"] = launches["rle"]
    walked = int(check.walk_slots(start, ops.shape[1]).sum())
    log(f"[{phase}] R1 on the widest call ({ops.shape[0]} jobs x "
        f"{ops.shape[1]} slots, {walked} walked, {int(ln.sum())} runs): "
        f"{ms:.4f} ms; plain {pms:.1f} ms; bound {rec['bound_ms']:.6f} ms "
        f"({by} bytes); equal to plain and native")
    return rec


def hold_call(phase, mode, path, r, args):
    """One recorded call (LaunchTimer.pick) run again on the card through
    its DP kernel and K2 and through their plain versions on the same
    arguments: the results and the walk of the direction bytes must be
    exactly equal.  Returns (phase, mode, launch, [flag, jobs, rows,
    junction bytes], the peak bytes the process reserved on the card).
    Runs in a process of its own."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    held = _hold_call(torch, phase, mode, path, r, args)
    peak = torch.cuda.max_memory_reserved()
    # a worker runs several calls: its cache must not keep this one's peak
    torch.cuda.empty_cache()
    return phase, mode, path, held, peak


def _hold_call(torch, phase, mode, path, r, args):
    from winnowmap_tpu_torch.extend import check

    c = {k: torch.from_numpy(v).to(DEVICE) if isinstance(v, np.ndarray)
         else v for k, v in args.items()}
    if not check.hold_call(c, mode, r):
        fail(f"{phase}: a {mode} call at {path} (flag {c['flag']:#x}, "
             f"{c['jobs'].shape[0]} jobs, {r} rows) != plain")
    return [f"{c['flag']:#x}", c["jobs"].shape[0], r,
            c.get("jpool") is not None]


def hold_bytes(h):
    """A held call's device bytes, bounded from above: its arrays, the
    kernel's and the plain version's direction bytes, and the plain
    version's state by column with its row temporaries (kernels._dp_plain:
    B x T int64 planes for u v x y x2 y2 s, the row max, the splice sites
    and the gathers of a row; a call of 14,638 jobs reserved about 40 such
    planes on an H100, so 64 are counted)."""
    a = h[4]
    jobs = a["jobs"]
    T = int(jobs[:, 4].max()) + int(a["ncol"].max()) + 64
    arrays = sum(v.nbytes for v in a.values() if isinstance(v, np.ndarray))
    return arrays + 2 * a["dirs_bytes"] + 64 * 8 * len(jobs) * T


def hold_all(torch, holds, reserve=0):
    """Every picked call held to the plain versions (hold_call) in worker
    processes, the longest first (the plain versions are bound by the
    host's Python), as many at once as the card's free memory, less
    `reserve` bytes for other processes, holds by hold_bytes; logs each
    phase's calls."""
    t0 = time.perf_counter()
    log(f"[holds] this process reserved at most "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB on the card")
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    budget = free - (PHASE2_WORKERS + 1) * HOLD_CONTEXT_BYTES - reserve
    log(f"[holds] {free / 2**30:.2f} GiB free on the card, "
        f"{budget / 2**30:.2f} GiB for the held calls")
    spawn = multiprocessing.get_context("spawn")
    out, peaks = {}, []
    pending = sorted(holds, key=lambda h: -h[3])
    running = {}
    with concurrent.futures.ProcessPoolExecutor(
            PHASE2_WORKERS, mp_context=spawn) as pool:
        while pending or running:
            for h in list(pending):
                need = hold_bytes(h)
                if len(running) == PHASE2_WORKERS:
                    break
                if running and sum(running.values()) + need > budget:
                    continue
                running[pool.submit(hold_call, *h)] = need
                pending.remove(h)
            done, _ = concurrent.futures.wait(
                running, return_when=concurrent.futures.FIRST_COMPLETED)
            for f in done:
                need = running.pop(f)
                phase, mode, path, held, peak = f.result()
                out.setdefault((phase, mode), {})[path] = held
                peaks.append((peak, need, phase, path))
    for (phase, mode), held in sorted(out.items()):
        a, b = LaunchTimer.NAMES[mode]
        log(f"[{phase}] {a.upper()}, {b.upper()} and R1 == plain on the call "
            f"at the median rows of each launch {a.upper()} took (launch: "
            f"flag, jobs, rows, junction bytes) {dict(sorted(held.items()))}")
    log("[holds] the largest held calls' peak GiB reserved against "
        "hold_bytes: " + ", ".join(
            f"{phase} {path} {peak / 2**30:.2f}/{need / 2**30:.2f}"
            for peak, need, phase, path in sorted(peaks, reverse=True)[:6]))
    log(f"[holds] {len(holds)} recorded calls held to the plain versions in "
        f"{PHASE2_WORKERS} worker processes: {time.perf_counter() - t0:.1f} s")


def phase5(torch, K, check, build, fastx, options, batch, seqcode, holds,
           r1):
    """Spliced mapping (-x splice -a) of 5000 transcript reads against a
    4 Mbp genome of 400 genes."""
    DATA.mkdir(exist_ok=True)
    ref, reads, bed = SPLICE_CORPUS
    t0 = time.perf_counter()
    if not (ref.exists() and reads.exists() and bed.exists()):
        splice_corpus(check, ref, reads, bed)
    recs = fastx.read_all(str(ref))
    rep = DATA / "splice_rep.txt"
    rep_list([r.seq for r in recs], 15, rep)
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("splice", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    wset = build.load_weight_set(str(rep), io_.k)
    mi = build_both("phase 5", torch, build, recs, io_, wset)
    options.update_mid_occ(mo, mi)
    rs = fastx.read_all(str(reads))
    seqs, names = [r.seq for r in rs], [r.name for r in rs]
    log(f"[phase 5] corpus {sum(len(r.seq) for r in recs)} bp, "
        f"{len(seqs)} reads ({sum(map(len, seqs))} bp), {len(wset)} "
        f"repetitive 15-mers, index {len(mi.keys)} keys "
        f"({time.perf_counter() - t0:.1f} s)")
    results, dt, launches, st, timer, _ = map_timed(
        torch, K, batch, mi, mo, seqs, names, "exts")
    log_device("phase 5", timer, dt, len(seqs), launches, st)
    holds += timer.pick("phase 5")
    r1.append(r1_record("phase 5", torch, K, timer, launches))
    mapped = [r for r in results if r.regs]
    n_spliced = sum(1 for r in mapped if any(
        g.p is not None and ((g.p.cigar & 15) == 3).any() for g in r.regs))
    log(f"[phase 5] {len(mapped)} reads with hits, {n_spliced} of them with "
        f"an N op; dev_jobs {int(st['dev_jobs'])}; engine host-kept "
        f"{int(st.get('eng_host_dp_calls', 0))}")
    if launches["exts"] == 0 or launches["traceback"] == 0:
        fail(f"a spliced kernel was not launched: {launches}")
    check_mapped("phase 5", st, results, len(seqs))
    if n_spliced < 0.5 * len(mapped):
        fail(f"only {n_spliced} of {len(mapped)} mapped reads are spliced")
    return launches


def phase6(torch, K, options, batch, corpus, holds):
    """Single-cost mapping: phase 4's index and reads, map-ont SV-aware
    with one gap cost (-O 4,4 -E 2,2 -a), every DP job through K4."""
    mi, seqs, names = corpus
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("map-ont", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    mo.q2, mo.e2 = mo.q, mo.e
    options.update_mid_occ(mo, mi)
    results, dt, launches, st, timer, _ = map_timed(
        torch, K, batch, mi, mo, seqs, names, "extz")
    n_mapped = sum(1 for r in results if r.regs)
    log(f"[phase 6] -O {mo.q},{mo.q2} -E {mo.e},{mo.e2}: {n_mapped} of "
        f"{len(seqs)} reads with hits; dev_jobs {int(st['dev_jobs'])}; "
        f"engine host-kept {int(st.get('eng_host_dp_calls', 0))}")
    log_device("phase 6", timer, dt, len(seqs), launches, st)
    holds += timer.pick("phase 6")
    if launches["extz"] == 0 or launches["traceback"] == 0:
        fail(f"a single-cost kernel was not launched: {launches}")
    if launches["extd"] != 0:
        fail(f"single-cost mapping launched K1: {launches}")
    if launches["rle"] != launches["traceback"]:
        fail(f"phase 6: {launches['rle']} R1 launches for "
             f"{launches['traceback']} K2 launches")
    check_mapped("phase 6", st, results, len(seqs))
    return launches


# --------------------------------------------------------------------------
# the generator path
# --------------------------------------------------------------------------

# phase 4's reads mapped against themselves in phase 8 (d)
PHASE8_OVERLAP_READS = 200


def phase8_goldens(cli, pipeline, batch):
    """(a) -x splice --junc-bed byte-equal to golden_splice_junc.paf; (b)
    the generator entry on t_reads.fa with --sv-off -a (map_file calling
    map_batch_generator) byte-equal to golden_svoff.sam apart from @PG."""
    argv = ["-x", "splice", "--junc-bed", str(GOLD / "s_junc.bed"),
            "--junc-bonus", "9", "-c", "-W", str(GOLD / "s_rep_k15.txt"),
            str(GOLD / "s_ref.fa"), str(GOLD / "s_reads.fa")]
    batch.STATS.clear()
    out, dt = cli_run(cli, argv)
    if out != (GOLD / "golden_splice_junc.paf").read_text():
        fail("-x splice --junc-bed differs from golden_splice_junc.paf")
    if batch.STATS["dev_jobs"] == 0 or batch.STATS["host_jobs"]:
        fail(f"--junc-bed did not take the generator path on the card: "
             f"{dict(batch.STATS)}")
    log(f"[phase 8] -x splice --junc-bed == golden_splice_junc.paf "
        f"({dt:.2f} s; {int(batch.STATS['dev_calls'])} calls, "
        f"{int(batch.STATS['dev_jobs'])} jobs)")
    argv = ["--sv-off", "-a", "-W", str(GOLD / "t_rep_k15.txt"),
            str(GOLD / "t_ref.fa"), str(GOLD / "t_reads.fa")]
    batch.STATS.clear()
    engine = pipeline.map_batch
    pipeline.map_batch = batch.map_batch_generator
    try:
        out, dt = cli_run(cli, argv)
    finally:
        pipeline.map_batch = engine
    if strip_pg(out) != strip_pg((GOLD / "golden_svoff.sam").read_text()):
        fail("the generator entry's --sv-off SAM differs from "
             "golden_svoff.sam")
    if batch.STATS["dev_jobs"] == 0 or "delivered_jobs" in batch.STATS:
        fail("the --sv-off run did not take the generator path")
    log(f"[phase 8] generator entry --sv-off -a == golden_svoff.sam apart "
        f"from @PG ({dt:.2f} s)")


def cli_run(cli, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"CLI {' '.join(argv[:4])} ... exited {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def check_generator(phase, timer, dt, n, launches, st, guard):
    """Log a generator-path run (log_device, then its calls, host jobs and
    Python seconds); fail unless it took the generator path on the card
    and kept on the host just the jobs that the refusal guards refuse."""
    log_device(phase, timer, dt, n, launches, st)
    log(f"[{phase}] {int(st.get('dev_calls', 0))} calls, "
        f"{int(st.get('dev_jobs', 0))} jobs; host_jobs "
        f"{int(st.get('host_jobs', 0))} (refusal guards {guard}); Python "
        f"gen_py_s {st.get('gen_py_s')}")
    if st.get("host_jobs", 0) != guard:
        fail(f"{phase}: {int(st.get('host_jobs', 0))} jobs on the host, the "
             f"refusal guards refuse {guard}")
    if "delivered_jobs" in st or st.get("dev_jobs", 0) == 0:
        fail(f"{phase} did not take the generator path on the card")


def phase8(torch, K, cli, pipeline, build, fastx, options, batch, seqcode,
           corpus, holds):
    """The generator mapping path on the card: the goldens; annotated
    spliced mapping (-x splice --junc-bed, -a) of phase 5's reads against
    its genome with a BED12 of its genes; all-vs-all overlap (-X -c) of
    phase 4's reads.  Returns each run's launches."""
    phase8_goldens(cli, pipeline, batch)

    # (c) annotated spliced mapping at size
    ref, reads, bed = SPLICE_CORPUS
    recs = fastx.read_all(str(ref))
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("splice", io_, mo)
    mo.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
    wset = build.load_weight_set(str(DATA / "splice_rep.txt"), io_.k)
    mi = build.build_index(recs, io_.w, io_.k, io_.flag, wset)
    options.update_mid_occ(mo, mi)
    build.read_bed(mi, str(bed))
    rs = fastx.read_all(str(reads))
    seqs, names = [r.seq for r in rs], [r.name for r in rs]
    results, dt, launches, st, timer, guard = map_timed(
        torch, K, batch, mi, mo, seqs, names, "exts")
    check_generator("phase 8 (c)", timer, dt, len(seqs), launches, st,
                    guard)
    picked = timer.pick("phase 8 (c)", juncs=True)
    if not any(h[4]["jpool"] is not None for h in picked):
        fail("no K3 call of phase 8 (c) picked to hold carries junction "
             "bytes")
    holds += picked
    if launches["exts"] == 0 or launches["traceback"] == 0:
        fail(f"a spliced kernel was not launched in phase 8: {launches}")
    mapped = [r for r in results if r.regs]
    n_spliced = sum(1 for r in mapped if any(
        g.p is not None and ((g.p.cigar & 15) == 3).any() for g in r.regs))
    if len(mapped) < 0.9 * len(seqs) or n_spliced < 0.5 * len(mapped):
        fail(f"phase 8 (c): {len(mapped)} of {len(seqs)} reads mapped, "
             f"{n_spliced} spliced")
    out = {"splice_junc": launches}

    # (d) all-vs-all overlap of phase 4's reads
    _, seqs4, names4 = corpus
    seqs4 = seqs4[:PHASE8_OVERLAP_READS]
    names4 = names4[:PHASE8_OVERLAP_READS]
    rdir = DATA / "overlap"
    rdir.mkdir(exist_ok=True)
    rep = rdir / "rep.txt"
    rep_list(seqs4, 15, rep)
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("map-ont", io_, mo)
    mo.flag |= (options.MM_F_CIGAR | options.MM_F_OUT_CG
                | options.MM_F_ALL_CHAINS | options.MM_F_NO_DIAG
                | options.MM_F_NO_DUAL | options.MM_F_NO_LJOIN)
    recs4 = [fastx.SeqRecord(nm, s, None, None)
             for nm, s in zip(names4, seqs4)]
    mi = build.build_index(recs4, io_.w, io_.k, io_.flag,
                           build.load_weight_set(str(rep), io_.k))
    options.update_mid_occ(mo, mi)
    results, dt, launches, st, timer, guard = map_timed(
        torch, K, batch, mi, mo, seqs4, names4, "extd")
    check_generator("phase 8 (d)", timer, dt, len(seqs4), launches, st,
                    guard)
    holds += timer.pick("phase 8 (d)")
    if launches["extd"] == 0 or launches["traceback"] == 0:
        fail(f"K1 or K2 was not launched in phase 8 (d): {launches}")
    n_pairs = sum(len(r.regs) for r in results)
    if n_pairs == 0:
        fail("phase 8 (d): no overlap found")
    for r in results:
        for g in r.regs:
            if g.p is None or not (0 <= g.qs <= g.qe and g.rs <= g.re):
                fail("phase 8 (d): malformed alignment record")
    log(f"[phase 8 (d)] -X -c: {n_pairs} overlaps among {len(seqs4)} reads")
    out["overlap"] = launches
    return out



# --------------------------------------------------------------------------
# assembly-to-reference mapping
# --------------------------------------------------------------------------

# phase 9's reference (two chromosomes of make_testdata.make_genome, with
# its tandem repeat arrays) and how many of the haplotype's four contigs of
# 2-3 Mbp are mapped: to shorten the phase, cut the contigs, not their
# length
PHASE9_GENOME = 10_000_000
PHASE9_CONTIGS = 4


def _haplotype(rng, g, svs):
    """A haplotype copy of chromosome g: the structural variants `svs`
    ((kind, fraction of the length, length), applied from the end back),
    then 0.1% substitutions and 0.01% indels of 1-20 bp."""
    h = g.copy()
    for kind, frac, ln in sorted(svs, key=lambda v: -v[1]):
        at = int(frac * len(h))
        if kind == "deletion":
            h = np.concatenate([h[:at], h[at + ln:]])
        elif kind == "insertion":
            h = np.concatenate([h[:at], rng.integers(0, 4, ln), h[at:]])
        elif kind == "inversion":
            h = np.concatenate([h[:at], 3 - h[at:at + ln][::-1],
                                h[at + ln:]])
        else:  # a tandem expansion: ln more copies of a 400 bp unit
            unit = h[at:at + 400]
            h = np.concatenate([h[:at]] + [unit] * (ln + 1) + [h[at + 400:]])
    sub = rng.random(len(h)) < 1e-3
    h[sub] = (h[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    pos = np.unique(rng.integers(0, len(h) - 20, rng.binomial(len(h), 1e-4)))
    parts, last = [], 0
    for at in pos:
        if at < last:
            continue
        parts.append(h[last:at])
        ln = int(rng.integers(1, 21))
        if rng.random() < 0.5:
            parts.append(rng.integers(0, 4, ln))
            last = at
        else:
            last = at + ln
    parts.append(h[last:])
    return np.concatenate(parts)


def make_testdata():
    """tests/tools/make_testdata.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_testdata", REPO / "tests" / "tools" / "make_testdata.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    return mk


def asm_corpus():
    """Phase 9's reference and contigs (numpy seed 20261016): a genome of
    PHASE9_GENOME bp in two chromosomes, and a haplotype of it with a 5 kb
    deletion and a 20 kb inversion on chr1, a 5 kb insertion and a tandem
    expansion (12 more copies of a 400 bp unit) on chr2, 0.1% substitutions
    and 0.01% indels of 1-20 bp, cut into four contigs of 2-3 Mbp (each
    chromosome at 45-55% of its length, the second piece reverse
    complemented).  Returns ([(name, codes)] chromosomes, [(name, codes)]
    contigs)."""
    mk = make_testdata()
    rng = np.random.default_rng(20261016)
    chroms = [(f"chr{c + 1}", mk.make_genome(rng, PHASE9_GENOME // 2))
              for c in range(2)]
    svs = ([("deletion", 0.26, 5000), ("inversion", 0.74, 20000)],
           [("insertion", 0.22, 5000), ("tandem", 0.78, 12)])
    contigs = []
    for (name, g), sv in zip(chroms, svs):
        h = _haplotype(rng, g, sv)
        cut = int(len(h) * rng.uniform(0.45, 0.55))
        contigs.append((f"{name}_ctg1", h[:cut]))
        contigs.append((f"{name}_ctg2", 3 - h[cut:][::-1]))
    return chroms, contigs


def phase9(torch, K, build, fastx, options, batch, pipeline):
    """Assembly-to-reference mapping (-x asm5 -c, SV-aware, the engine
    path): the contigs of asm_corpus against its reference, weighted by the
    canonical 19-mers above distinct=0.9998, with the chain exchange at the
    card's gate (every exported chain through C1), then again with
    chain_min = 0 (every chain on the engine's scalar DP): the PAF must be
    byte-equal.  The index build through S1 is part of the run; a native
    build after it must give the same arrays.  Returns the launches of
    every kernel in the run, the run's largest C1 launch (its anchor sets
    and parameters, as chain_dp_device_batch took them) and what phase 11
    maps again (the records, options, weight set, index and results)."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.map import engine
    from winnowmap_tpu_torch.sketch import device as SD

    t0 = time.perf_counter()
    chroms, contigs = asm_corpus()
    contigs = contigs[:PHASE9_CONTIGS]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = [fastx.SeqRecord(n, acgt[c].tobytes(), None, None)
            for n, c in chroms]
    qrecs = [fastx.SeqRecord(n, acgt[c].tobytes(), None, None)
             for n, c in contigs]
    seqs, names = [r.seq for r in qrecs], [r.name for r in qrecs]
    rep = DATA / "asm_rep.txt"
    DATA.mkdir(exist_ok=True)
    rep_list([r.seq for r in recs], 19, rep)
    io_, mo = options.IndexOptions(), options.MapOptions()
    options.set_preset("asm5", io_, mo)
    mo.flag |= options.MM_F_CIGAR
    wset = build.load_weight_set(str(rep), io_.k)
    bp = sum(map(len, seqs))
    log(f"[phase 9] reference {sum(len(r.seq) for r in recs)} bp, "
        f"{len(seqs)} contigs of {min(map(len, seqs))}-"
        f"{max(map(len, seqs))} bp ({bp} bp), {len(wset)} repetitive "
        f"19-mers ({time.perf_counter() - t0:.1f} s)")

    sizes, batches = [], []
    fwd, dev_batch = CD.chain_fwd, engine.chain_dp_device_batch

    def recorded(cj, *a):
        sizes.extend(cj.off.diff().tolist())
        return fwd(cj, *a)

    def recorded_batch(jobs, *a):
        # the engine's anchor arrays are views of its own memory
        batches.append(([(ax.copy(), ay.copy()) for ax, ay in jobs],
                         chain_params(a[:-1])))
        return dev_batch(jobs, *a)

    def paf(results):
        out = io.StringIO()
        for r, res in zip(qrecs, results):
            pipeline._write_read(mi, mo, r, res, out)
        return out.getvalue()

    batch.STATS.clear()
    for m in (K, CD, SD):
        m.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    CD.chain_fwd = recorded
    engine.chain_dp_device_batch = recorded_batch
    try:
        with LaunchTimer(K, torch, "extd") as timer, \
                EntryTimer(torch, ["wm_chain_fwd_launch"]) as ctimer:
            t0 = time.perf_counter()
            mi = build.build_index(recs, io_.w, io_.k, io_.flag, wset)
            options.update_mid_occ(mo, mi)
            t_index = time.perf_counter() - t0
            results = batch.map_batch(mi, mo, seqs, names)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        CD.chain_fwd = fwd
        engine.chain_dp_device_batch = dev_batch
    timer.peak = torch.cuda.max_memory_reserved()
    launches = {**K.LAUNCHES, **CD.LAUNCHES, **SD.LAUNCHES}
    st = {k: round(float(v), 6) for k, v in batch.STATS.items()}
    dev = log_device("phase 9", timer, dt - t_index, len(seqs), launches, st)
    c1_ms = ctimer.ms("wm_chain_fwd_launch")
    exported = int(st.get("chain_dev_jobs", 0))
    log(f"[phase 9] index (S1) {t_index:.2f} s; {len(seqs)} contigs "
        f"mapped in {dt - t_index:.3f} s -> "
        f"{len(seqs) / (dt - t_index):.4f} contigs/s, "
        f"{bp / 1e6 / (dt - t_index):.4f} Mbp/s; {exported} chains exported "
        f"({int(st.get('chain_dev_anchors', 0))} anchors; per chain median "
        f"{float(np.median(sizes)) if sizes else 0}, max "
        f"{max(sizes) if sizes else 0}), C1 {len(c1_ms)} launches, "
        f"{sum(c1_ms):.3f} ms of C1 events; eng_chain_s "
        f"{st.get('eng_chain_s')} over {int(st.get('eng_chain_calls', 0))} "
        f"host chains; chain_dev_s {st.get('chain_dev_s')}; K1 "
        f"{dev['k1_ms']:.3f} ms, K2 {dev['k2_ms']:.3f} ms of events")
    log("[phase 9] JSON " + json.dumps({
        "contigs": len(seqs), "bp": bp, "index_s": t_index,
        "map_s": dt - t_index, "contigs_per_s": len(seqs) / (dt - t_index),
        "mbp_per_s": bp / 1e6 / (dt - t_index), "chains_exported": exported,
        "chain_anchors": sizes, "c1_launches": len(c1_ms),
        "c1_ms": float(sum(c1_ms)), "eng_chain_s": st.get("eng_chain_s"),
        "chain_dev_s": st.get("chain_dev_s"), "k1_ms": dev["k1_ms"],
        "k2_ms": dev["k2_ms"], "launches": launches}))
    if launches["chain_fwd"] == 0 or exported == 0:
        fail(f"phase 9: no chain reached C1 ({launches})")
    if len(sizes) != exported or sum(sizes) != st.get("chain_dev_anchors"):
        fail(f"phase 9: {exported} chains exported with "
             f"{st.get('chain_dev_anchors')} anchors, C1 took {len(sizes)} "
             f"with {sum(sizes)}: an exported chain was chained elsewhere")
    if launches["sketch"] != 1 or launches["extd"] == 0:
        fail(f"phase 9: S1 was not launched once or K1 not at all: "
             f"{launches}")
    if sum(1 for r in results if r.regs) < len(seqs):
        fail("phase 9: a contig did not map")
    check_mapped("phase 9", st, results, len(seqs))
    ours = paf(results)
    t0 = time.perf_counter()
    ref = build.build_index(recs, io_.w, io_.k, io_.flag, wset,
                            sketch_min_bp=None)
    t_native = time.perf_counter() - t0
    for f in ("keys", "start", "pos"):
        if not np.array_equal(getattr(mi, f), getattr(ref, f)):
            fail(f"phase 9: the S1-built index's {f} differs from the "
                 f"native build's")
    log(f"[phase 9] index through S1 ({launches['sketch']} launch) "
        f"{t_index:.3f} s against a native build {t_native:.3f} s: keys, "
        f"start, pos equal")

    batch.STATS.clear()
    t0 = time.perf_counter()
    host = engine.map_batch_engine(mi, mo, seqs, names,
                                   torch.device(DEVICE), chain_min=0)
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t0
    st0 = dict(batch.STATS)
    if st0.get("chain_dev_jobs", 0):
        fail("phase 9: chain_min = 0 exported chains")
    if paf(host) != ours:
        fail("phase 9: the PAF with the chain exchange differs from the PAF "
             "with every chain on the host")
    log(f"[phase 9] chain_min = 0: {dt0:.3f} s, eng_chain_s "
        f"{float(st0.get('eng_chain_s', 0)):.6f} over "
        f"{int(st0.get('eng_chain_calls', 0))} host chains; PAF "
        f"({ours.count(chr(10))} lines) byte-equal to the chain exchange's")
    ctx = {"recs": recs, "qrecs": qrecs, "io": io_, "mo": mo, "wset": wset,
           "mi": mi, "results": results, "paf": ours, "rep": rep}
    return launches, max(batches, key=lambda b: sum(len(ax)
                                                    for ax, _ in b[0])), ctx


# --------------------------------------------------------------------------
# prebuilt and multi-part indexes, paired ends, the debug dumps
# --------------------------------------------------------------------------

# phase 11 (c): the part size of -I (phase 9's two chromosomes of 5 Mbp:
# a part each), and (d): pairs, read and fragment lengths, substitutions
PHASE11_PART_BP = 4_000_000
PHASE11_PAIRS = 5000
PHASE11_READ = 150
PHASE11_FRAG = (400, 50)
PHASE11_SUBST = 0.01
# (e): the first reads of t_reads.fa (the fourth, of 10,185 bases, takes
# the SV-aware MCAS trials: the trial, stage-2 and PO traces) and the dumps
PHASE11_DUMP_READS = 4
PHASE11_DUMPS = (["--print-seeds"], ["--sv-off", "--print-aln-seq"],
                 ["--dbg-polish"])


def write_fasta(path: Path, recs) -> None:
    with open(path, "w") as f:
        for r in recs:
            f.write(f">{r.name}\n{r.seq.decode()}\n")


def reg_fields(regs, shift=0):
    """A read's regions as comparable tuples (rid shifted by `shift`)."""
    return [(g.rid + shift, g.qs, g.qe, g.rs, g.re, g.rev, g.score,
             g.mapq, g.id, g.parent, g.sam_pri,
             None if g.p is None else (g.p.dp_max, g.p.cigar.tobytes()))
            for g in regs]


def phase11_goldens(cli, batch, K):
    """(a) The new CLI paths on the golden corpora, on the card."""
    tmp = DATA / "phase11"
    tmp.mkdir(parents=True, exist_ok=True)
    rep, ref = str(GOLD / "t_rep_k15.txt"), str(GOLD / "t_ref.fa")
    reads = str(GOLD / "t_reads.fa")
    svoff = (GOLD / "golden_svoff.paf").read_text()
    wmi = tmp / "t_ref.wmi"
    cli_run(cli, ["-W", rep, "-d", str(wmi), ref])
    out, dt = cli_run(cli, ["--sv-off", "-c", str(wmi), reads])
    if out != svoff:
        fail("-d to WMTI then --sv-off -c from it differs from "
             "golden_svoff.paf")
    log(f"[phase 11 (a)] -d {wmi.name}, then --sv-off -c from it == "
        f"golden_svoff.paf ({dt:.2f} s)")
    want = strip_pg((GOLD / "golden_mmi.sam").read_text())
    out, dt = cli_run(cli, ["-a", str(GOLD / "t_ref.mmi"), reads])
    if strip_pg(out) != want:
        fail("-a on t_ref.mmi differs from golden_mmi.sam")
    from winnowmap_tpu_torch.index.build import (build_index,
                                                 load_weight_bloom,
                                                 load_weight_set)
    from winnowmap_tpu_torch.index.mmi import dump_mmi
    from winnowmap_tpu_torch.io.fastx import read_all

    own = tmp / "own.mmi"
    dump_mmi(build_index(read_all(ref), 50, 15, 0, load_weight_set(rep, 15),
                         weight_bloom=load_weight_bloom(rep, 15)), str(own))
    out2, dt2 = cli_run(cli, ["-a", str(own), reads])
    if strip_pg(out2) != want:
        fail("-a on the port's dump_mmi of the bloom build differs from "
             "golden_mmi.sam")
    log(f"[phase 11 (a)] -a on t_ref.mmi ({dt:.2f} s) and on the port's "
        f"dump_mmi of the bloom build ({dt2:.2f} s) == golden_mmi.sam apart "
        f"from @PG")
    out, dt = cli_run(cli, ["--sv-off", "-c", "-I", "100k", "-W", rep, ref,
                            reads])
    if out != svoff:
        fail("--sv-off -c -I 100k differs from golden_svoff.paf")
    log(f"[phase 11 (a)] --sv-off -c -I 100k == golden_svoff.paf "
        f"({dt:.2f} s)")
    pe = [str(GOLD / f) for f in ("pe_rep.txt", "pe_ref.fa", "pe_1.fq",
                                  "pe_2.fq")]
    batch.STATS.clear()
    K.reset_launches()
    with GuardCount(batch) as guard:
        out, dt = cli_run(cli, ["-a", "-W"] + pe)
    pe_launch = dict(K.LAUNCHES)
    if strip_pg(out) != strip_pg((GOLD / "golden_pe.sam").read_text()):
        fail("-a on pe_1.fq pe_2.fq differs from golden_pe.sam")
    if pe_launch["extd"] == 0 or batch.STATS.get("host_jobs", 0) != guard.n:
        fail(f"the paired golden's DP did not all run on the card: "
             f"{pe_launch} {dict(batch.STATS)}, refusal guards {guard.n}")
    inter = tmp / "pe_inter.fq"
    l1 = Path(pe[2]).read_text().splitlines()
    l2 = Path(pe[3]).read_text().splitlines()
    with open(inter, "w") as f:
        for i in range(0, len(l1), 4):
            f.write("\n".join(l1[i:i + 4] + l2[i:i + 4]) + "\n")
    out2, dt2 = cli_run(cli, ["-a", "--frag", "yes", "-W", pe[0], pe[1],
                              str(inter)])
    body = [ln for ln in out.splitlines() if not ln.startswith("@")]
    if [ln for ln in out2.splitlines() if not ln.startswith("@")] != body:
        fail("--frag yes on the interleaved pairs differs from the two "
             "files' SAM body")
    log(f"[phase 11 (a)] -a pe_1.fq pe_2.fq == golden_pe.sam apart from @PG "
        f"({dt:.2f} s; launches {pe_launch}), and --frag yes on the two "
        f"interleaved gives its body ({dt2:.2f} s)")


def phase11_prebuilt(torch, build, options, batch, ctx):
    """(b) Phase 9's 10 Mbp index dumped and loaded (WMTI1 and MMI\\2),
    every array equal; its contigs mapped from the loaded WMTI1 index."""
    from winnowmap_tpu_torch.index import io as IO
    from winnowmap_tpu_torch.index import mmi as MMI
    from winnowmap_tpu_torch.sketch import device as SD

    tmp = DATA / "phase11"
    mi, io_ = ctx["mi"], ctx["io"]
    SD.reset_launches()
    t0 = time.perf_counter()
    built = build.build_index(ctx["recs"], io_.w, io_.k, io_.flag,
                              ctx["wset"])
    t_build = time.perf_counter() - t0
    times = {"build": t_build}
    for kind, dump, load, fields in (
            ("WMTI1", IO.dump_index, IO.load_index,
             ("keys", "start", "pos", "codes", "wset")),
            ("MMI\\2", MMI.dump_mmi, MMI.load_mmi,
             ("keys", "start", "pos", "codes"))):
        path = tmp / ("asm.wmi" if kind == "WMTI1" else "asm.mmi")
        t0 = time.perf_counter()
        dump(built, str(path))
        times[f"{kind} dump"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = load(str(path))
        times[f"{kind} load"] = time.perf_counter() - t0
        same = ([(x.name, x.offset, x.length) for x in got.seqs]
                == [(x.name, x.offset, x.length) for x in mi.seqs]
                and (got.w, got.k, got.flag) == (mi.w, mi.k, mi.flag))
        for f in fields:
            same = same and np.array_equal(getattr(got, f), getattr(mi, f))
        if not same:
            fail(f"phase 11 (b): the {kind} index read back differs from "
                 f"phase 9's")
        log(f"[phase 11 (b)] {kind} {path.stat().st_size} bytes: dump "
            f"{times[f'{kind} dump']:.3f} s, load {times[f'{kind} load']:.3f}"
            f" s; {', '.join(fields)} equal to phase 9's index")
        if kind == "WMTI1":
            loaded = got
    if SD.LAUNCHES["sketch"] != 1:
        fail(f"phase 11 (b): the build launched S1 {SD.LAUNCHES['sketch']} "
             f"times")
    mo = copy.copy(ctx["mo"])
    options.update_mid_occ(mo, loaded)
    seqs = [r.seq for r in ctx["qrecs"]]
    batch.STATS.clear()
    t0 = time.perf_counter()
    results = batch.map_batch(loaded, mo, seqs, [r.name for r in
                                                 ctx["qrecs"]])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = io.StringIO()
    for r, res in zip(ctx["qrecs"], results):
        from winnowmap_tpu_torch.map.pipeline import _write_read

        _write_read(loaded, mo, r, res, out)
    if out.getvalue() != ctx["paf"]:
        fail("phase 11 (b): the contigs mapped from the loaded WMTI1 index "
             "differ from phase 9's PAF")
    if batch.STATS.get("eng_host_dp_calls", 0):
        fail("phase 11 (b): DP jobs stayed on the engine's host DP")
    log(f"[phase 11 (b)] build (S1, 1 launch) {t_build:.3f} s; "
        f"{len(seqs)} contigs from the loaded WMTI1 index in {dt:.3f} s: "
        f"PAF byte-equal to phase 9's")
    log("[phase 11 (b)] JSON " + json.dumps({
        "seconds": times, "map_s": dt, "bp": int(loaded.codes.size)}))


def phase11_multipart(torch, cli, pipeline, build, options, batch, ctx):
    """(c) Phase 9's genome in parts of PHASE11_PART_BP (-I): a part a
    chromosome, each built through S1 and mapped in turn; each part's
    regions equal a single-part run against that chromosome alone; -I
    above the genome's size gives phase 9's PAF."""
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.sketch import device as SD

    tmp = DATA / "phase11"
    recs, qrecs, io_ = ctx["recs"], ctx["qrecs"], ctx["io"]
    ref_fa, ctg_fa = tmp / "asm_ref.fa", tmp / "asm_contigs.fa"
    write_fasta(ref_fa, recs)
    write_fasta(ctg_fa, qrecs)
    mo = copy.copy(ctx["mo"])
    mo.flag |= options.MM_F_OUT_CG
    # each part's build and batches, seen through the pipeline's calls
    parts = []
    build_index, map_batch = pipeline.build_index, pipeline.map_batch

    def part_build(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0, c0 = SD.LAUNCHES["sketch"], CD.LAUNCHES["chain_fwd"]
        batch.STATS.clear()
        mi = build_index(*a, **kw)
        parts.append({"s1": SD.LAUNCHES["sketch"] - s0, "c0": c0,
                      "bp": int(mi.codes.size), "t0": time.perf_counter(),
                      "res": []})
        return mi

    def part_map(*a, **kw):
        res = map_batch(*a, **kw)
        torch.cuda.synchronize()
        p = parts[-1]
        p["map_s"] = time.perf_counter() - p["t0"]
        p["c1"] = CD.LAUNCHES["chain_fwd"] - p["c0"]
        p["exported"] = int(batch.STATS.get("chain_dev_jobs", 0))
        p["host_dp"] = int(batch.STATS.get("eng_host_dp_calls", 0))
        p["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        p["res"] += zip(a[3], res)  # rids shifted in place after the call
        return res

    out = io.StringIO()
    pipeline.build_index, pipeline.map_batch = part_build, part_map
    t0 = time.perf_counter()
    try:
        n = pipeline.map_file_multipart(
            recs, io_, mo, ctx["wset"], [str(ctg_fa)], out=out,
            batch_bp=PHASE11_PART_BP)
    finally:
        pipeline.build_index, pipeline.map_batch = build_index, map_batch
    dt = time.perf_counter() - t0
    if len(parts) != 2 or n != len(qrecs):
        fail(f"phase 11 (c): {len(parts)} parts, {n} contigs")
    for pi, p in enumerate(parts):
        p["regs"] = {name: reg_fields(x.regs) for name, x in p.pop("res")}
        log(f"[phase 11 (c)] part {pi + 1}/{len(parts)}: {p['bp']} bp, S1 "
            f"{p['s1']} launch(es), {len(qrecs)} contigs mapped in "
            f"{p['map_s']:.3f} s ({len(qrecs) / p['map_s']:.4f} contigs/s),"
            f" {p['exported']} chains exported, C1 {p['c1']} launch(es), "
            f"peak device memory {p['peak_gib']:.3f} GiB allocated")
        if p["s1"] != 1 or p["c1"] == 0 or p["exported"] == 0 \
                or p["host_dp"]:
            fail(f"phase 11 (c): part {pi + 1}: " + str(
                {k: v for k, v in p.items() if k != "regs"}))
    # each part against a single-part run of its chromosome alone
    for pi, rec in enumerate(recs):
        mi = build.build_index([rec], io_.w, io_.k, io_.flag, ctx["wset"])
        mo1 = copy.copy(ctx["mo"])
        options.update_mid_occ(mo1, mi)
        res = batch.map_batch(mi, mo1, [r.seq for r in qrecs],
                              [r.name for r in qrecs])
        want = {r.name: reg_fields(x.regs, pi) for r, x in zip(qrecs, res)}
        if want != parts[pi]["regs"]:
            fail(f"phase 11 (c): part {pi + 1}'s regions differ from a "
                 f"single-part run against {rec.name} alone")
        del mi
    log(f"[phase 11 (c)] -I {PHASE11_PART_BP}: {len(parts)} parts in "
        f"{dt:.3f} s ({len(qrecs) / dt:.4f} contigs/s end to end, "
        f"{out.getvalue().count(chr(10))} merged PAF lines); each part's "
        f"regions (rids shifted) == a single-part run against its "
        f"chromosome alone")
    # -I above the genome's size: the whole index at once, phase 9's PAF
    # (with -c's cg tags, in the CLI's longest-first order)
    out, dt = cli_run(cli, ["-x", "asm5", "-c", "-I", "20M", "-W",
                            str(ctx["rep"]), str(ref_fa), str(ctg_fa)])
    order = sorted(range(len(qrecs)),
                   key=lambda i: (len(qrecs[i].seq), i), reverse=True)
    want = io.StringIO()
    for i in order:
        pipeline._write_read(ctx["mi"], mo, qrecs[i], ctx["results"][i],
                             want)
    if out != want.getvalue():
        fail("phase 11 (c): -I 20M differs from phase 9's PAF")
    log(f"[phase 11 (c)] -I 20M (above the genome): PAF byte-equal to "
        f"phase 9's ({dt:.2f} s)")
    log("[phase 11 (c)] JSON " + json.dumps({
        "parts": [{k: v for k, v in p.items() if k not in ("regs", "t0",
                                                            "c0")}
                  for p in parts], "wall_s": dt}))


def pe_corpus(fastx, ref: Path, r1: Path, r2: Path):
    """PHASE11_PAIRS pairs of 2 x PHASE11_READ bp from fragments of
    PHASE11_FRAG (mean, sd) bases of phase 4's genome, each read with
    PHASE11_SUBST substitutions, both ends on the fragment's strand
    (numpy seed 20261018)."""
    rng = np.random.default_rng(20261018)
    g = np.concatenate([np.frombuffer(r.seq, np.uint8)
                        for r in fastx.read_all(str(ref))])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lens = np.clip(rng.normal(*PHASE11_FRAG, PHASE11_PAIRS).astype(int),
                   2 * PHASE11_READ, None)
    starts = rng.integers(0, len(g) - lens.max(), PHASE11_PAIRS)
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i, (s, ln) in enumerate(zip(starts, lens)):
            frag = g[s:s + ln]
            for f, rd, end in ((f1, frag[:PHASE11_READ], 1),
                               (f2, frag[-PHASE11_READ:], 2)):
                rd = rd.copy()
                sub = rng.random(len(rd)) < PHASE11_SUBST
                rd[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
                f.write(f"@pair{i}/{end}\n{rd.tobytes().decode()}\n+\n"
                        f"{'I' * len(rd)}\n")


def phase11_pairs(torch, K, pipeline, build, fastx, options, batch, holds):
    """(d) Paired-end mapping (-a, two query files) on phase 4's genome."""
    tmp = DATA / "phase11"
    ref = DATA / "wmbench2_ref.fa"
    r1, r2 = tmp / "pe_1.fq", tmp / "pe_2.fq"
    pe_corpus(fastx, ref, r1, r2)
    io_, mo = options.IndexOptions(), options.MapOptions()
    mo.flag |= options.MM_F_OUT_SAM | options.MM_F_CIGAR
    mi = build.build_index(fastx.read_all(str(ref)), io_.w, io_.k, io_.flag,
                           build.load_weight_set(
                               str(DATA / "wmbench2_rep.txt"), io_.k))
    options.update_mid_occ(mo, mi)
    batch.STATS.clear()
    K.reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with GuardCount(batch) as guard, LaunchTimer(K, torch, "extd") as timer:
        t0 = time.perf_counter()
        n = pipeline.map_file_frag(mi, mo, [str(r1), str(r2)], out=out)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    timer.peak = torch.cuda.max_memory_reserved()
    launches = dict(K.LAUNCHES)
    st = {k: round(float(v), 6) for k, v in batch.STATS.items()}
    check_generator("phase 11 (d)", timer, dt, n, launches, st, guard.n)
    if st.get("eng_host_dp_calls", 0):
        fail("phase 11 (d): DP jobs on the engine's host DP")
    if launches["extd"] == 0 or launches["traceback"] == 0:
        fail(f"phase 11 (d): K1 or K2 was not launched: {launches}")
    holds += timer.pick("phase 11 (d)")
    flags = [int(ln.split("\t")[1]) for ln in out.getvalue().splitlines()
             if not ln.startswith("@")]
    proper = sum(1 for f in flags if f & 0x40 and (f & 0x3) == 0x3
                 and not f & 0x90C)
    log(f"[phase 11 (d)] {PHASE11_PAIRS} pairs in {dt:.3f} s -> "
        f"{PHASE11_PAIRS / dt:.1f} pairs/s; {proper} properly paired "
        f"({100 * proper / PHASE11_PAIRS:.2f}%)")
    if proper < 0.9 * PHASE11_PAIRS:
        fail(f"phase 11 (d): {proper} of {PHASE11_PAIRS} pairs properly "
             f"paired")


def phase11_dumps(cli, batch, K):
    """(e) The debug dumps on the first reads of t_reads.fa: each trace
    (and the PAF) on the card equal to the port's own run with --device
    cpu; the card's run on the generator path through K1 and K2."""
    tmp = DATA / "phase11"
    reads = tmp / "dump_reads.fa"
    recs = (GOLD / "t_reads.fa").read_text().split(">")
    reads.write_text("".join(">" + r
                             for r in recs[1:PHASE11_DUMP_READS + 1]))
    argvs = [flags + ["-c", "-W", str(GOLD / "t_rep_k15.txt"),
                      str(GOLD / "t_ref.fa"), str(reads)]
             for flags in PHASE11_DUMPS]
    # the port's CPU runs (plain versions, bound by the host) in processes
    # of their own, meanwhile, the host's cores shared out among them (each
    # with a thread a core, the three together ran slower than in turn)
    env = dict(os.environ, OMP_NUM_THREADS=str(
        max(1, (os.cpu_count() or 1) // len(argvs))))
    t_cpu = time.perf_counter()
    cpu = [subprocess.Popen([sys.executable, "-m", "winnowmap_tpu_torch.cli",
                             "--device", "cpu"] + argv, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True) for argv in argvs]
    try:
        dump_checks(cli, batch, K, argvs, cpu, t_cpu)
    finally:
        for proc in cpu:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dump_checks(cli, batch, K, argvs, cpu, t_cpu):
    """Phase 11 (e)'s runs on the card, each held to its CPU run."""
    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("[M::")]

    for flags, argv, proc in zip(PHASE11_DUMPS, argvs, cpu):
        batch.STATS.clear()
        K.reset_launches()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with GuardCount(batch) as guard, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        dt = time.perf_counter() - t0
        if rc != 0:
            fail(f"phase 11 (e): {' '.join(flags)} exited {rc}")
        out, trace = out.getvalue(), lines(err.getvalue())
        launches, st = dict(K.LAUNCHES), dict(batch.STATS)
        out_c, err_c = proc.communicate()
        if proc.returncode != 0:
            fail(f"phase 11 (e): {' '.join(flags)} --device cpu exited "
                 f"{proc.returncode}: {err_c[-2000:]}")
        trace_c, dt_c = lines(err_c), time.perf_counter() - t_cpu
        if trace != trace_c or out != out_c:
            fail(f"phase 11 (e): {' '.join(flags)}'s trace on the card "
                 f"differs from --device cpu's")
        if (launches["extd"] == 0 or launches["traceback"] == 0
                or "delivered_jobs" in st
                or st.get("host_jobs", 0) != guard.n):
            fail(f"phase 11 (e): {' '.join(flags)} did not map on the "
                 f"generator path through K1 and K2: {launches} {st}")
        log(f"[phase 11 (e)] {' '.join(flags)}: {len(trace)} trace lines "
            f"on the card ({dt:.2f} s; K1 {launches['extd']}, K2 "
            f"{launches['traceback']} launches) == --device cpu's (a "
            f"process of its own, done {dt_c:.2f} s after the three "
            f"started)")


def phase11(torch, K, cli, pipeline, build, fastx, options, batch, ctx,
            holds):
    """Prebuilt indexes, multi-part indexes, paired ends and the debug
    dumps on the card: (a) the goldens, (b) phase 9's index dumped and
    loaded, (c) phase 9's genome in two parts, (d) 5000 pairs on phase 4's
    genome (its recorded DP calls held at the end), (e) the dumps."""
    t0 = time.perf_counter()
    K.reset_launches()
    phase11_goldens(cli, batch, K)
    log(f"[phase 11 (a)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase11_prebuilt(torch, build, options, batch, ctx)
    log(f"[phase 11 (b)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    K.reset_launches()
    phase11_multipart(torch, cli, pipeline, build, options, batch, ctx)
    log(f"[phase 11 (c)] {time.perf_counter() - t0:.1f} s; launches "
        f"{dict(K.LAUNCHES)}")
    t0 = time.perf_counter()
    phase11_pairs(torch, K, pipeline, build, fastx, options, batch, holds)
    log(f"[phase 11 (d)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase11_dumps(cli, batch, K)
    log(f"[phase 11 (e)] {time.perf_counter() - t0:.1f} s")


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
# timed calls of each ladder level (after a warm-up): a single level-6
# call is ~0.5 ms, and three of them moved 0.46-0.54 ms between runs
PROBE_REPS = 20


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


def check_widths(widths, dirs_mode) -> int:
    """P3 level 6 under `dirs_mode` against plain at each Wb of `widths`
    (tools/check.check_widths), in a worker process; returns the largest
    error."""
    import torch

    from winnowmap_tpu_torch.tools import check as PC

    err = PC.check_widths(torch.device(DEVICE), widths, dirs_mode)
    torch.cuda.synchronize()
    return err


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
    t0 = time.perf_counter()
    # the plain versions are bound by the host's Python: the widths go to
    # worker processes, before anything is timed
    modes = ("u8", "i32")
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            PHASE2_WORKERS, mp_context=spawn) as pool:
        errs = list(pool.map(check_widths, *zip(*[
            (PC.WIDTHS[i::PHASE2_WORKERS], dm) for dm in modes
            for i in range(PHASE2_WORKERS)] + [
            ((wb,), dm) for dm in modes for wb in PC.WIDE_WIDTHS])))
    if any(errs):
        fail(f"P3 level 6 != plain at a Wb from 1 to {P3.NARROW_LANES} or "
             f"of {PC.WIDE_WIDTHS} under dirs {modes}")
    log(f"[phase 7] P3 level 6 at every Wb from 1 to {P3.NARROW_LANES} "
        f"(the narrow launch) and at Wb {PC.WIDE_WIDTHS} (the wide launch), "
        f"dirs u8 and i32-packed (B={PC.B} ROWS={PC.ROWS} KR={PC.KR}, in "
        f"{PHASE2_WORKERS} worker processes): kernel == plain "
        f"({time.perf_counter() - t0:.1f} s)")
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
    ladder = [P3.run_level(lv, reps=PROBE_REPS, device=DEVICE)
              for lv in P3.levels]
    short = [P3.run_level(lv, KR=PROBE_SHORT_KR, reps=PROBE_REPS,
                          device=DEVICE) for lv in P3.levels]
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
        log(f"[phase 7] P2 {name.strip()}: {o['graph_ms']:.5f} ms a launch "
            f"in a CUDA graph, {o['ms']:.4f} ms a wrapper call, "
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
    # 7 state arrays (=L0), its stores written back (graph_ms: a graph of
    # launches whose outputs pass the L2; one launch's kernel time alone
    # ends with its stores in the L2 and can beat the memory rate).  Its
    # bound: the stores (and qlen) at the memory rate, or per step a
    # __vadd4 a 4-lane word (byte-SIMD: 4 lanes an instruction) and the 16
    # accumulators' adds, whichever is larger
    l0_ms = l0[P2.cases[4][0]]["graph_ms"]
    l0_bytes = 4 * Bf + 7 * Bf * Wb + 64 * Bf
    l0_ops = KR * Bf * (Wb // 4 + 16)
    l0_rec = probe_record("probe_l0", "tests/tools/probe_l0.py:55", 0, 0,
                          l0_ms, 0, l0_bytes, l0_ops)
    log(f"[phase 7] P2 7 state arrays (=L0) with its stores written back: "
        f"{l0_ms:.5f} ms a launch (a CUDA graph of launches whose outputs "
        f"pass twice the L2); bound {l0_rec['bound_ms']:.5f} ms "
        f"({l0_rec['bound_by']}: {l0_bytes} bytes stored, {l0_ops} 32-bit "
        f"operations), {100 * l0_rec['bound_ms'] / l0_ms:.1f}% of it")
    ds = bis[P1.variants[4][0]]["ms"]  # 32x dirs row store, KR 16
    return [
        probe_record("probe_bisect", "tests/tools/probe_bisect.py:48",
                     launches["probe_bisect"], err["probe_bisect"], ds,
                     plain["probe_bisect"],
                     16 * 32 * Bf * Wb + 7 * Bf * Wb + 64 * Bf,
                     16 * 32 * Bf * Wb),
        probe_record("probe_l0", "tests/tools/probe_l0.py:55",
                     launches["probe_l0"], err["probe_l0"], l0_ms,
                     plain["probe_l0"], l0_bytes, l0_ops),
        probe_record("probe_core", "tests/tools/probe_core.py:222",
                     launches["probe_core"], err["probe_core"], top["ms"],
                     plain["probe_core"], core_bytes, core_ops),
    ]


# --------------------------------------------------------------------------
# k-mer counting
# --------------------------------------------------------------------------

# phase 10 (b)'s genome: about C. elegans' 100 Mbp, in three chromosomes of
# make_testdata.make_genome (its tandem repeat arrays), each with a run of
# N bases
PHASE10_GENOME = 100_000_000
PHASE10_N_RUN = 5000
# KC held to its plain version on small blocks at each direction: (k,
# codes)
KC_CHECKS = ((15, 300_001), (19, 100_000), (31, 100_000), (32, 50_000))


def kc_ops(k: int) -> int:
    """Integer operations a window of KC's function: for each of its k
    codes the forward roll (shift, or), the reverse roll (shift, or; the
    complement c ^ 2 and the code's valid test are a code's, not a
    window's) and the valid flag's and, 5; then the canonical minimum
    (compare, select), the key's select and the valid test, 4."""
    return 5 * k + 4


def kc_genome():
    """Phase 10 (b)'s genome (numpy seed 20261017): three chromosomes of
    PHASE10_GENOME / 3 bp, upper-case ACGT, a run of PHASE10_N_RUN N
    bases at 40% of each.  Returns SeqRecords."""
    from winnowmap_tpu_torch.io.fastx import SeqRecord

    mk = make_testdata()
    rng = np.random.default_rng(20261017)
    recs = []
    for c in range(3):
        g = np.frombuffer(b"ACGT", np.uint8)[
            mk.make_genome(rng, PHASE10_GENOME // 3)]
        at = int(0.4 * len(g))
        g[at:at + PHASE10_N_RUN] = ord("N")
        recs.append(SeqRecord(f"chr{c + 1}", g.tobytes(), None, None))
    return recs


def host_count(prefix: str) -> float:
    """Phase 10 (b)'s genome counted by the host counter
    (outofcore.count_kmers_chunked), in a worker process: the genome made
    again from its seed, the k-mers and counts saved to prefix_kmers.npy
    and prefix_counts.npy.  Returns the count's seconds."""
    from winnowmap_tpu_torch.kcount.outofcore import count_kmers_chunked

    recs = kc_genome()
    t0 = time.perf_counter()
    kc = count_kmers_chunked(recs, 15)
    dt = time.perf_counter() - t0
    np.save(f"{prefix}_kmers.npy", kc.kmers)
    np.save(f"{prefix}_counts.npy", kc.counts)
    return dt


def meryl_out(meryl_cli, args) -> str:
    """meryl_cli.main(args) in this process; its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = meryl_cli.main(args)
    if rc != 0:
        fail(f"meryl {' '.join(args)} returned {rc}")
    return buf.getvalue()


def phase10_goldens(KD, meryl_cli, fastx, outofcore):
    """(a) The port's meryl on the card on t_ref.fa: count, then print (its
    md5), histogram, print greater-than distinct=0.9998 and greater-than 4
    equal to the reference meryl's goldens; count-forward and
    count-reverse trees equal to the host counter's print.  Returns KC's
    launches."""
    import hashlib

    ref = str(GOLD / "t_ref.fa")
    db = str(DATA / "kc_t_ref")
    KD.reset_launches()
    meryl_out(meryl_cli, ["count", "k=15", "output", db, ref])
    md5 = hashlib.md5(meryl_out(meryl_cli, ["print", db]).encode())
    if md5.hexdigest() != (GOLD / "golden_meryl_print.md5").read_text(
            ).strip():
        fail("phase 10: meryl print differs from golden_meryl_print.md5")
    for args, gold in ((["histogram", db], "golden_meryl_histogram.txt"),
                       (["print", "greater-than", "distinct=0.9998", db],
                        "golden_meryl_rep_distinct9998.txt"),
                       (["print", "greater-than", "4", db],
                        "golden_meryl_gt4.txt")):
        if meryl_out(meryl_cli, args) != (GOLD / gold).read_text():
            fail(f"phase 10: meryl {' '.join(args[:-1])} differs from "
                 f"{gold}")
    recs = fastx.read_all(ref)
    for d in ("forward", "reverse"):
        got = meryl_out(meryl_cli, ["print", "[", f"count-{d}", "k=15", ref,
                                    "]"])
        want = outofcore.count_kmers_chunked(recs, 15, direction=d)
        if got != "".join(ln + "\n" for ln in want.print_lines()):
            fail(f"phase 10: meryl count-{d} differs from the host counter")
    n = KD.LAUNCHES["kcount"]
    if n == 0:
        fail("phase 10: meryl count did not launch KC")
    log(f"[phase 10 (a)] meryl on the card, t_ref.fa: print (md5), "
        f"histogram, greater-than distinct=0.9998 and greater-than 4 == "
        f"the goldens; count-forward and count-reverse == the host "
        f"counter; {n} KC launches")
    return n


def phase10_rep_lists(fastx, seqcode):
    """(a) The down-weight list phases 4-9 make on the card (rep_list:
    count_kmers through KC, meryl's distinct=0.9998 selection) equals the
    numpy selection (rep_kmers_numpy) on phase 9's genome (written by
    phase 12) at k = 19: the same canonical k-mers with the same counts."""
    def canon(s):
        rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        return min(s, rc)

    k = 19
    seqs = [r.seq for r in fastx.read_all(str(DATA / "asm_ref.fa"))]
    card = rep_list(seqs, k, DATA / "rep_check.txt")
    got = {canon(ln.split("\t")[0]): int(ln.split("\t")[1])
           for ln in card.print_lines()}
    kmers, cnt = rep_kmers_numpy([seqcode.encode(s) for s in seqs], k, 0.9998)
    want = {canon(kmer_str(x, k)): c
            for x, c in zip(kmers.tolist(), cnt.tolist())}
    if got != want:
        fail(f"phase 10 (a): the card's k = {k} down-weight list "
             f"({len(got)} k-mers) differs from numpy's ({len(want)})")
    log(f"[phase 10 (a)] down-weight list of {sum(map(len, seqs))} bp at k "
        f"= {k} through count_kmers on the card == numpy's selection: "
        f"{len(got)} k-mers, counts equal")


def phase10_genome(torch, KD, kcount, recs):
    """(b) count_kmers(recs, 15) on the card: KC's launches (a block
    each), their summed CUDA-event ms, the host merge's seconds, the other
    host seconds, Mbp/s, the peak device memory and the distinct=0.9998
    list's size.  Returns (the counted set, KC's launches)."""
    n_bp = sum(len(r.seq) for r in recs)
    merge_s = [0.0]
    merge = KD._merge_two

    def timed_merge(*args):
        t = time.perf_counter()
        out = merge(*args)
        merge_s[0] += time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KD._merge_two = timed_merge
    KD.reset_launches()
    try:
        with EntryTimer(torch, ["wm_kcount_launch"]) as timer:
            t0 = time.perf_counter()
            kc = kcount.count_kmers(recs, 15)
            wall = time.perf_counter() - t0
    finally:
        KD._merge_two = merge
    launches = KD.LAUNCHES["kcount"]
    kc_ms = sum(timer.ms("wm_kcount_launch"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    thr = kc.threshold_distinct(0.9998)
    n_rep = kc.greater_than(thr).n_distinct
    log(f"[phase 10 (b)] {n_bp} bp in {len(recs)} chromosomes, k = 15: "
        f"{kc.n_total} k-mers, {kc.n_distinct} distinct, in {wall:.3f} s "
        f"-> {n_bp / 1e6 / wall:.3f} Mbp/s; {launches} blocks (KC "
        f"launches), KC's events {kc_ms:.3f} ms; host merge "
        f"{merge_s[0]:.3f} s; other host {wall - merge_s[0] - kc_ms / 1e3:.3f}"
        f" s; peak device memory {peak:.3f} GiB; distinct=0.9998 -> "
        f"greater-than {thr}: {n_rep} k-mers")
    log("[phase 10 (b)] JSON " + json.dumps({
        "bp": n_bp, "wall_s": wall, "mbp_per_s": n_bp / 1e6 / wall,
        "blocks": launches, "kc_ms": kc_ms, "merge_s": merge_s[0],
        "other_host_s": wall - merge_s[0] - kc_ms / 1e3,
        "peak_gib": peak, "distinct": kc.n_distinct, "rep_9998": n_rep}))
    if launches == 0:
        fail("phase 10 (b): the count did not launch KC")
    return kc, launches


def kc_small_codes(rng, n):
    """n codes with 40 runs of N (1-200 bases) and a poly-G stretch."""
    c = rng.integers(0, 4, n).astype(np.uint8)
    for at in rng.integers(0, n - 200, 40):
        c[at:at + int(rng.integers(1, 200))] = 255
    c[n // 7:n // 7 + 3000] = 3
    return c


def phase10_kc(torch, KD, recs, launches):
    """(c) KC on the genome's first block (BLOCK codes) at k = 15,
    canonical, held to its plain version and timed by CUDA events, beside
    the plain version and torch.unique on the block's valid keys, and held
    to its plain version there at k = 19 (u64 keys); KC held
    to its plain version on small blocks with N runs at KC_CHECKS, each
    direction.  Returns KC's kernels-line record (launches: (b)'s)."""
    from winnowmap_tpu_torch.tools import time_ms

    dev = torch.device(DEVICE)
    saved = dict(KD.LAUNCHES)
    rng = np.random.default_rng(20261018)
    for k, n in KC_CHECKS:
        c = torch.from_numpy(kc_small_codes(rng, n)).to(dev)
        for d in KD.DIRECTIONS:
            km, ct = KD.count_block(c, k, d)
            pk, pc = KD.count_block_plain(c, k, d)
            if not (torch.equal(km, pk) and torch.equal(ct, pc)):
                fail(f"phase 10 (c): KC != plain on {n} codes at k = {k}, "
                     f"{d}")
    block = next(KD.iter_code_blocks(recs, 15))
    if len(block) != KD.BLOCK:
        fail("phase 10 (c): the genome's first block is not full")
    t = torch.from_numpy(block).to(dev)
    km, ct = KD.count_block(t, 15)
    pk, pc = KD.count_block_plain(t, 15)
    if len(km) != len(pk):
        fail(f"phase 10 (c): KC's n_seg {len(km)} != plain's {len(pk)}")
    err = int((km != pk).sum() + (ct != pc).sum())
    if err:
        fail(f"phase 10 (c): KC != plain on the block: {err} entries")
    # the same block at k = 19: u64 keys, four passes
    km19, ct19 = KD.count_block(t, 19)
    pk19, pc19 = KD.count_block_plain(t, 19)
    if not (torch.equal(km19, pk19) and torch.equal(ct19, pc19)):
        fail("phase 10 (c): KC != plain on the block at k = 19")
    keys = KD.block_keys_plain(t, 15)
    ms = time_ms(lambda: KD.count_block_launch(t, 15), dev, 20)
    plain_ms = time_ms(lambda: KD.count_block_plain(t, 15), dev, 3)
    lib_ms = time_ms(lambda: torch.unique(keys, sorted=True,
                                          return_counts=True), dev, 10)
    n, n_valid, n_seg = len(block), len(keys), len(km)
    # each code read once; each valid key written once and read once; each
    # unique k-mer and its count written once
    nbytes = n + 16 * n_valid + 16 * n_seg
    tb = nbytes / HBM_BPS * 1e3
    to = kc_ops(15) * (n - 14) / INT32_OPS * 1e3
    KD.LAUNCHES.update(saved)  # comparison launches are not main-path
    log(f"[phase 10 (c)] KC == plain on {len(KC_CHECKS)} small blocks with "
        f"N runs (k = {', '.join(str(k) for k, _ in KC_CHECKS)}) at each "
        f"direction and on the genome's first block ({n} codes, {n_valid} "
        f"valid windows, {n_seg} unique 15-mers, canonical; and k = 19): "
        f"KC {ms:.4f} "
        f"ms; plain {plain_ms:.3f} ms; torch.unique on the valid keys "
        f"{lib_ms:.4f} ms; bound {max(tb, to):.5f} ms ({nbytes} bytes "
        f"{tb:.5f} ms, {kc_ops(15) * (n - 14)} operations {to:.5f} ms)")
    rec = kernel_record("kcount_block", "kcount.cu",
                        "winnowmap_tpu/kcount/device.py:28", err, ms,
                        plain_ms, tb, to)
    rec["library_ms"], rec["launches"] = lib_ms, launches
    return rec


def phase10(torch):
    """k-mer counting on the card: (a) the goldens through meryl_cli, (b)
    a 100 Mbp genome through count_kmers against the host counter (run
    meanwhile in a worker process), (c) KC alone.  Returns KC's record."""
    from winnowmap_tpu_torch import kcount, meryl_cli
    from winnowmap_tpu_torch.io import fastx, seqcode
    from winnowmap_tpu_torch.kcount import device as KD
    from winnowmap_tpu_torch.kcount import outofcore

    DATA.mkdir(exist_ok=True)
    prefix = str(DATA / "kc_host")
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        host = pool.submit(host_count, prefix)
        phase10_goldens(KD, meryl_cli, fastx, outofcore)
        phase10_rep_lists(fastx, seqcode)
        recs = kc_genome()
        kc, launches = phase10_genome(torch, KD, kcount, recs)
        host_s = host.result()
    want_k = np.load(f"{prefix}_kmers.npy")
    want_c = np.load(f"{prefix}_counts.npy")
    if not (np.array_equal(kc.kmers, want_k)
            and np.array_equal(kc.counts, want_c)):
        fail("phase 10 (b): the card's counts differ from the host counter's")
    log(f"[phase 10 (b)] == the host counter (count_kmers_chunked, "
        f"{host_s:.3f} s in a worker process meanwhile), array for array")
    return phase10_kc(torch, KD, recs, launches)


# --------------------------------------------------------------------------
# phase 12: the analysis tools, the meryl side tools, several engines,
# several devices' counting and several processes on the card
# --------------------------------------------------------------------------

# (e): phase 4's reads mapped by two processes, a shard each
PHASE12_SHARDED_READS = 200
MERYL_LOOKUP_MODES = ("existence", "include", "exclude", "bed", "bed-runs",
                      "wig-count", "wig-depth")

# what each rank of phase 12 (e) runs: init_distributed (gloo, from the
# environment), map_file_partitioned of phase 9's contigs against its part
# of phase 9's genome on cuda:(rank % cards), then map_file_sharded of its
# shard of the reads against phase 4's index; prints its launches, STATS
# and seconds as JSON
RANK_WORKER = r"""
import json, sys, time
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["repo"])
import torch
import torch.distributed as dist
from winnowmap_tpu_torch import options
from winnowmap_tpu_torch.chain import device as CD
from winnowmap_tpu_torch.extend import kernels as K
from winnowmap_tpu_torch.index.build import build_index, load_weight_set
from winnowmap_tpu_torch.io.fastx import read_all
from winnowmap_tpu_torch.map.engine import STATS
from winnowmap_tpu_torch.parallel import (init_distributed,
                                          map_file_sharded, rank_device)
from winnowmap_tpu_torch.parallel.sharded import map_file_partitioned
from winnowmap_tpu_torch.sketch import device as SD

rank, world = init_distributed()
dev = rank_device(rank)
torch.cuda.set_device(dev)
out = {"rank": rank, "world": world, "device": str(dev),
       "backend": dist.get_backend()}
io_, mo = options.IndexOptions(), options.MapOptions()
options.set_preset("asm5", io_, mo)
mo.flag |= options.MM_F_CIGAR
wset = load_weight_set(cfg["rep19"], io_.k)
records = read_all(cfg["ref"])
for m in (K, CD, SD):
    m.reset_launches()
STATS.clear()
dist.barrier()
t0 = time.perf_counter()
with open(cfg["out"] + f".r{rank}", "w") as f:
    n = map_file_partitioned(records, io_, mo, wset, cfg["contigs"], out=f)
torch.cuda.synchronize()
dist.barrier()
out["partitioned"] = {
    "wall_s": time.perf_counter() - t0, "n": n,
    "sketch": SD.LAUNCHES["sketch"], "chain_fwd": CD.LAUNCHES["chain_fwd"],
    "extd": K.LAUNCHES["extd"], "traceback": K.LAUNCHES["traceback"],
    "chain_dev_jobs": int(STATS["chain_dev_jobs"]),
    "host_dp": int(STATS["eng_host_dp_calls"])}
io4, mo4 = options.IndexOptions(), options.MapOptions()
options.set_preset("map-ont", io4, mo4)
mo4.flag |= options.MM_F_CIGAR | options.MM_F_OUT_SAM
mi4 = build_index(read_all(cfg["ref4"]), io4.w, io4.k, io4.flag,
                  load_weight_set(cfg["rep4"], io4.k))
options.update_mid_occ(mo4, mi4)
K.reset_launches()
STATS.clear()
dist.barrier()
t0 = time.perf_counter()
n = map_file_sharded(mi4, mo4, cfg["reads"], cfg["out"] + f".s{rank}", rank,
                     world)
torch.cuda.synchronize()
dist.barrier()
out["sharded"] = {"wall_s": time.perf_counter() - t0, "n": n,
                  "extd": K.LAUNCHES["extd"],
                  "host_dp": int(STATS["eng_host_dp_calls"])}
print("RANK-RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def phase12_tools(torch, ctx):
    """(a) minimizer_dist's sketch_dump of phase 9's genome on the card
    (one S1 launch) equal to the dump from native.sketch, its density
    finite; on t_ref.fa with t_rep_k15.txt (natively, and through S1 with
    sketch_min_bp 0) equal as a set to golden_ref_minimizers.txt;
    extract_selected_reads on phase 9's PAF."""
    from winnowmap_tpu_torch.sketch import device as SD
    from winnowmap_tpu_torch.tools import extract_selected_reads as ESR
    from winnowmap_tpu_torch.tools import minimizer_dist as MD

    io_ = ctx["io"]
    ref = DATA / "asm_ref.fa"
    hpc = bool(io_.flag & 1)
    SD.reset_launches()
    t0 = time.perf_counter()
    dump = MD.sketch_dump(str(ref), io_.k, io_.w, str(ctx["rep"]), hpc)
    t_card = time.perf_counter() - t0
    n_s1 = SD.LAUNCHES["sketch"]
    t0 = time.perf_counter()
    nat = MD.sketch_dump(str(ref), io_.k, io_.w, str(ctx["rep"]), hpc,
                         sketch_min_bp=None)
    t_nat = time.perf_counter() - t0
    if n_s1 != 1 or not np.array_equal(dump, nat):
        fail(f"phase 12 (a): sketch_dump of phase 9's genome ({n_s1} S1 "
             f"launches) differs from native.sketch's")
    grid, dens = MD.density_grid(dump[dump[:, 0] == 0][:, 1])
    if not (np.isfinite(dens).all() and (dens > 0).any()):
        fail("phase 12 (a): the minimizer density is not finite")
    want = {tuple(r) for r in np.loadtxt(
        GOLD / "golden_ref_minimizers.txt", dtype=np.int64).tolist()}
    for smb in (MD.DEVICE_SKETCH_MIN_BP, 0):
        SD.reset_launches()
        got = MD.sketch_dump(str(GOLD / "t_ref.fa"), 15, 50,
                             str(GOLD / "t_rep_k15.txt"), sketch_min_bp=smb)
        if {tuple(r) for r in got.tolist()} != want or \
                SD.LAUNCHES["sketch"] != (0 if smb else 1):
            fail(f"phase 12 (a): sketch_dump of t_ref.fa (sketch_min_bp "
                 f"{smb}) differs from golden_ref_minimizers.txt")
    paf, ids, kept = (DATA / "p12.paf", DATA / "p12_ids.txt",
                      DATA / "p12_kept.paf")
    paf.write_text(ctx["paf"])
    names = [r.name for r in ctx["qrecs"]][::2]
    ids.write_text("".join(n + "\n" for n in names))
    n_kept = ESR.extract(str(paf), str(ids), str(kept))
    n_want = sum(1 for ln in ctx["paf"].splitlines()
                 if ln.split("\t", 1)[0] in names)
    if n_kept != n_want or n_kept == 0:
        fail(f"phase 12 (a): extract_selected_reads kept {n_kept} lines, "
             f"not {n_want}")
    log(f"[phase 12 (a)] sketch_dump of {sum(len(r.seq) for r in ctx['recs'])}"
        f" bp (k = {io_.k}, w = {io_.w}, phase 9's list): {len(dump)} "
        f"minimizers through S1 (1 launch) in {t_card:.3f} s == "
        f"native.sketch's dump ({t_nat:.3f} s); t_ref.fa's dump natively "
        f"and through S1 == golden_ref_minimizers.txt as a set; "
        f"extract_selected_reads kept {n_kept} of phase 9's PAF lines")
    return {"sketch": n_s1 + 1}


def phase12_meryl(KD, meryl_cli):
    """(b) A database counted by meryl_cli count k=15 on the card from
    t_ref.fa: meryl-lookup's seven reports equal their golden_lookup_*
    files (text or md5), meryl-import of its print printed again equals
    the print, meryl-analyze's GC histogram covers every k-mer, and
    position-lookup reports every read."""
    import hashlib

    from winnowmap_tpu_torch import (meryl_analyze_cli, meryl_import_cli,
                                     meryl_lookup_cli, position_lookup_cli)

    db = DATA / "p12_db"
    KD.reset_launches()
    meryl_out(meryl_cli, ["count", "k=15", "output", str(db),
                          str(GOLD / "t_ref.fa")])
    if KD.LAUNCHES["kcount"] == 0:
        fail("phase 12 (b): meryl count did not launch KC")
    reads = str(GOLD / "t_reads.fa")
    for mode in MERYL_LOOKUP_MODES:
        out = DATA / f"p12_lookup_{mode}.out"
        if meryl_lookup_cli.main([f"-{mode}", "-sequence", reads, "-output",
                                  str(out), "-mers", str(db)]) != 0:
            fail(f"phase 12 (b): meryl-lookup -{mode} failed")
        data = out.read_bytes()
        if mode == "existence":
            ok = data.decode() == (GOLD / "golden_lookup_existence.txt"
                                   ).read_text()
        else:
            ok = hashlib.md5(data).hexdigest() == (
                GOLD / f"golden_lookup_{mode}.md5").read_text().strip()
        if not ok:
            fail(f"phase 12 (b): meryl-lookup -{mode} differs from its "
                 f"golden")
    text = meryl_out(meryl_cli, ["print", str(db)])
    dump, imp = DATA / "p12_print.txt", DATA / "p12_imp"
    dump.write_text(text)
    with contextlib.redirect_stderr(io.StringIO()):
        rc = meryl_import_cli.main(["-k", "15", "-kmers", str(dump),
                                    "-output", str(imp)])
    if rc != 0 or meryl_out(meryl_cli, ["print", str(imp)]) != text:
        fail("phase 12 (b): meryl-import of the print, printed, differs")
    prefix = DATA / "p12_an"
    with contextlib.redirect_stderr(io.StringIO()):
        meryl_analyze_cli.main(["-mers", str(db), "-prefix", str(prefix),
                                "-gc"])
    n_gc = sum(int(ln.split("\t")[2]) for ln in open(f"{prefix}.GC.hist"))
    hpq = DATA / "p12_hpq"
    position_lookup_cli.main(["-m", str(db), "-s", str(GOLD / "t_ref.fa"),
                              "-hpq", str(hpq), reads])
    n_reads = sum(1 for ln in open(reads) if ln.startswith(">"))
    n_distinct = text.count("\n")
    if n_gc != n_distinct or hpq.read_text().count("\n") != n_reads:
        fail(f"phase 12 (b): meryl-analyze counted {n_gc} of {n_distinct} "
             f"k-mers or position-lookup missed a read")
    log(f"[phase 12 (b)] meryl count k=15 on the card ({KD.LAUNCHES['kcount']}"
        f" KC launches): meryl-lookup's {len(MERYL_LOOKUP_MODES)} reports "
        f"== the goldens; meryl-import of the print ({n_distinct} k-mers), "
        f"printed == the print; meryl-analyze -gc over {n_gc} k-mers; "
        f"position-lookup -hpq on {n_reads} reads")
    return {"kcount": KD.LAUNCHES["kcount"]}


def region_key(r):
    """Every field of a region, for phase 12 (c)'s equality."""
    return (r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs, r.re, r.parent,
            r.subsc, r.mlen, r.blen, r.n_sub, r.score0, r.mapq, r.inv,
            r.rev, r.split, r.sam_pri, r.hash, r.div,
            None if r.p is None else (r.p.dp_score, r.p.dp_max,
                                      r.p.dp_max2, r.p.n_ambi,
                                      r.p.trans_strand,
                                      tuple(r.p.cigar.tolist())))


def phase12_engines(torch, K, batch, corpus, p4):
    """(c) Phase 4's reads through the split driver (ways 2), which runs
    map_batch_multidev over [cuda:0, cuda:0]: two engines in two host
    threads, a stream each.  Every read's regions equal phase 4's, no DP
    job on the engine's host DP, and K1's and K2's launch counts equal to
    the sum of what each engine's thread launched (both launched).  Its
    reads/s stand beside one engine's on the same reads, timed just before
    and just after it with the same (launch-counting) instrumentation."""
    import threading

    from winnowmap_tpu_torch.map import engine
    from winnowmap_tpu_torch.parallel import multidev

    mi, seqs, names = corpus
    mo = p4["mo"]
    want = [[region_key(r) for r in res.regs] for res in p4["results"]]
    dev = torch.device(DEVICE, 0)
    seen = []  # (thread, key, n) of each launch counted
    real = K.count
    real_multidev = multidev.map_batch_multidev
    routed = []

    def spy(counter, key, n=1):
        if counter is K.LAUNCHES:
            seen.append((threading.current_thread().name, key, n))
        real(counter, key, n)

    def spy_multidev(*a, **kw):
        routed.append([str(d) for d in a[4]])
        return real_multidev(*a, **kw)

    def run(name, fn, n_threads):
        batch.STATS.clear()
        K.reset_launches()
        seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = dict(batch.STATS)
        if [[region_key(r) for r in x.regs] for x in res] != want:
            fail(f"phase 12 (c): {name}'s regions differ from phase 4's")
        if st.get("eng_host_dp_calls", 0) != 0 or \
                st["delivered_jobs"] != st["dev_jobs"]:
            fail(f"phase 12 (c): {name} kept DP jobs off the card")
        by = {}
        for key in ("extd", "traceback"):
            for t, k, n in seen:
                if k == key:
                    by.setdefault(key, {}).setdefault(t, 0)
                    by[key][t] += n
            if len(by.get(key, {})) != n_threads or \
                    K.LAUNCHES[key] != sum(by[key].values()):
                fail(f"phase 12 (c): {name}: {K.LAUNCHES[key]} {key} "
                     f"launches against the threads' {by.get(key)}")
        log(f"[phase 12 (c)] {name}: {len(seqs)} reads in {dt:.3f} s -> "
            f"{len(seqs) / dt:.3f} reads/s; regions == phase 4's; "
            f"K1/K2 launches {K.LAUNCHES['extd']}/"
            f"{K.LAUNCHES['traceback']} == the threads' sum {by}")
        return {"wall_s": dt, "reads_per_s": len(seqs) / dt,
                "launches": dict(K.LAUNCHES), "by_thread": by,
                "dev_jobs": int(st["dev_jobs"])}

    def one():
        return engine.map_batch_engine(mi, mo, seqs, names, dev)

    rec = {"phase4_reads_per_s": len(seqs) / p4["wall_s"]}
    K.count = spy
    multidev.map_batch_multidev = spy_multidev
    try:
        rec["one_before"] = run("one engine", one, 1)
        rec["split"] = run("split driver", lambda: (
            engine.map_batch_engine_pipelined(mi, mo, seqs, names,
                                              device=dev, ways=2)), 2)
        rec["one_after"] = run("one engine", one, 1)
    finally:
        K.count = real
        multidev.map_batch_multidev = real_multidev
    if routed != [[str(dev)] * 2]:
        fail(f"phase 12 (c): the split driver ran map_batch_multidev over "
             f"{routed}, not [{dev}, {dev}]")
    base = (rec["one_before"]["reads_per_s"]
            + rec["one_after"]["reads_per_s"]) / 2
    rec["split_over_one"] = rec["split"]["reads_per_s"] / base
    log(f"[phase 12 (c)] two engines on one card (map_batch_multidev over "
        f"{routed[0]}): {rec['split_over_one']:.3f} x one engine's mean "
        f"{base:.3f} reads/s")
    log("[phase 12 (c)] JSON " + json.dumps(rec))
    return rec


def phase12_counting(torch, KD, ctx):
    """(d) count_kmers_multidev over [cuda:0, cuda:0] on phase 9's genome,
    k = 15, canonical and forward, equal to count_kmers array for array;
    Mbp/s of both."""
    from winnowmap_tpu_torch.kcount import count_kmers
    from winnowmap_tpu_torch.parallel.kcount import count_kmers_multidev

    recs = ctx["recs"]
    bp = sum(len(r.seq) for r in recs)
    dev = torch.device(DEVICE, 0)
    rec = {}
    for direction in ("canonical", "forward"):
        KD.reset_launches()
        t0 = time.perf_counter()
        one = count_kmers(recs, 15, direction=direction)
        t_one = time.perf_counter() - t0
        n_one = KD.LAUNCHES["kcount"]
        KD.reset_launches()
        t0 = time.perf_counter()
        two = count_kmers_multidev(recs, 15, direction=direction,
                                   devices=[dev, dev])
        t_two = time.perf_counter() - t0
        n_two = KD.LAUNCHES["kcount"]
        if not (np.array_equal(one.kmers, two.kmers)
                and np.array_equal(one.counts, two.counts)):
            fail(f"phase 12 (d): count_kmers_multidev ({direction}) differs "
                 f"from count_kmers")
        if n_two != n_one or n_one == 0:
            fail(f"phase 12 (d): {n_two} KC launches over two slots, "
                 f"{n_one} in one")
        rec[direction] = {"count_kmers_mbp_s": bp / 1e6 / t_one,
                          "multidev_mbp_s": bp / 1e6 / t_two,
                          "kc_launches": n_one,
                          "distinct": int(one.n_distinct)}
        log(f"[phase 12 (d)] {direction}, {bp} bp, k = 15: "
            f"count_kmers_multidev over two slots of the card "
            f"{bp / 1e6 / t_two:.3f} Mbp/s, count_kmers "
            f"{bp / 1e6 / t_one:.3f} Mbp/s; {n_one} KC launches each; "
            f"{one.n_distinct} distinct, equal array for array")
    log("[phase 12 (d)] JSON " + json.dumps(rec))
    return rec


def phase12_processes(torch, pipeline, ctx, corpus, p4):
    """(e) Two processes on the card, joined by gloo on localhost:
    map_file_partitioned of phase 9's contigs, a chromosome (5 Mbp) a rank,
    each part through one S1 launch and its chains of 50,000 anchors or
    more through C1, rank 0's PAF byte-equal to the single-process n_parts
    = 2 run and rank 1's empty; map_file_sharded of PHASE12_SHARDED_READS
    of phase 4's reads, a shard a rank, merged by merge_parts byte-equal
    to map_file on them.  The reads file holds them longest first (reads
    of distinct lengths), the order map_file's longest-first scheduling
    writes, so the rank merge's input order is the same."""
    import socket

    from winnowmap_tpu_torch.parallel import merge_parts
    from winnowmap_tpu_torch.parallel.sharded import map_file_partitioned

    ref, contigs = DATA / "asm_ref.fa", DATA / "asm_contigs.fa"
    write_fasta(contigs, ctx["qrecs"])
    mi4, seqs, names = corpus
    lens, picked = set(), []
    for s, n in zip(seqs, names):
        if len(s) not in lens:
            lens.add(len(s))
            picked.append((n, s))
        if len(picked) == PHASE12_SHARDED_READS:
            break
    picked.sort(key=lambda p: -len(p[1]))
    reads = DATA / "p12_reads.fa"
    with open(reads, "w") as f:
        for n, s in picked:
            f.write(f">{n}\n{s.decode()}\n")

    # the single-process runs, before the ranks start
    t0 = time.perf_counter()
    single = io.StringIO()
    map_file_partitioned(ctx["recs"], ctx["io"], ctx["mo"], ctx["wset"],
                         str(contigs), out=single, n_parts=2, device=DEVICE)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = io.StringIO()
    pipeline.map_file(mi4, p4["mo"], str(reads), whole)
    torch.cuda.synchronize()
    t_whole = time.perf_counter() - t0

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    outp = DATA / "p12_mp"
    cfg = json.dumps({"repo": str(REPO), "ref": str(ref),
                      "contigs": str(contigs),
                      "rep19": str(ctx["rep"]),
                      "ref4": str(DATA / "wmbench2_ref.fa"),
                      "rep4": str(DATA / "wmbench2_rep.txt"),
                      "reads": str(reads), "out": str(outp)})
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_WORKER, cfg],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_procs = time.perf_counter() - t0
    res = []
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "RANK-RESULT " not in o:
            fail(f"phase 12 (e): rank {r} exited {p.returncode}:\n"
                 f"{o[-4000:]}")
        res.append(json.loads(o.split("RANK-RESULT ", 1)[1].splitlines()[0]))
    rank0 = Path(f"{outp}.r0").read_text()
    if rank0 != single.getvalue() or Path(f"{outp}.r1").read_text():
        fail("phase 12 (e): rank 0's PAF differs from the single-process "
             "n_parts = 2 run, or rank 1 wrote")
    for r in res:
        pt = r["partitioned"]
        if r["backend"] != "gloo" or pt["sketch"] != 1 or \
                pt["chain_fwd"] == 0 or pt["chain_dev_jobs"] == 0 or \
                pt["host_dp"] != 0 or r["sharded"]["host_dp"] != 0:
            fail(f"phase 12 (e): rank {r['rank']}: {r}")
    merged = io.StringIO()
    merge_parts(merged, [f"{outp}.s0", f"{outp}.s1"])
    if merged.getvalue() != whole.getvalue() or not whole.getvalue():
        fail("phase 12 (e): map_file_sharded + merge_parts differs from "
             "map_file")
    rec = {"partitioned_single_s": t_single,
           "partitioned_ranks_s": [r["partitioned"]["wall_s"] for r in res],
           "sharded_map_file_s": t_whole,
           "sharded_ranks_s": [r["sharded"]["wall_s"] for r in res],
           "processes_wall_s": t_procs, "ranks": res}
    log(f"[phase 12 (e)] two gloo ranks on {res[0]['device']}: "
        f"map_file_partitioned {max(rec['partitioned_ranks_s']):.3f} s "
        f"(single process, n_parts 2: {t_single:.3f} s), rank 0's PAF "
        f"({rank0.count(chr(10))} lines) byte-equal, each part 1 S1 launch "
        f"and C1 launches {[r['partitioned']['chain_fwd'] for r in res]}; "
        f"map_file_sharded of {len(picked)} reads "
        f"{max(rec['sharded_ranks_s']):.3f} s (map_file {t_whole:.3f} s), "
        f"merged byte-equal; the processes' wall {t_procs:.1f} s")
    log("[phase 12 (e)] JSON " + json.dumps(rec))
    return rec


def phase12(torch, K, batch, pipeline, corpus, p4, ctx):
    """The last modules on the card: (a) the analysis tools, (b) the meryl
    side tools, (c) two engines in threads, (d) counting over two slots,
    (e) two processes."""
    from winnowmap_tpu_torch import meryl_cli
    from winnowmap_tpu_torch.kcount import device as KD

    write_fasta(DATA / "asm_ref.fa", ctx["recs"])
    t0 = time.perf_counter()
    tools_l = phase12_tools(torch, ctx)
    log(f"[phase 12 (a)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    meryl_l = phase12_meryl(KD, meryl_cli)
    log(f"[phase 12 (b)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng = phase12_engines(torch, K, batch, corpus, p4)
    log(f"[phase 12 (c)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cnt = phase12_counting(torch, KD, ctx)
    log(f"[phase 12 (d)] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    procs = phase12_processes(torch, pipeline, ctx, corpus, p4)
    log(f"[phase 12 (e)] {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on phase 12's paths (the one-engine runs of
    # (c), the comparison runs of (d) and the single-process references of
    # (e) not counted)
    ranks = procs["ranks"]
    launches = {
        "sketch": {"a": tools_l["sketch"],
                   "e": [r["partitioned"]["sketch"] for r in ranks]},
        "kcount": {"b": meryl_l["kcount"],
                   "d": {d: v["kc_launches"] for d, v in cnt.items()}},
        "extd": {"c": eng["split"]["launches"]["extd"],
                 "e": [r["partitioned"]["extd"] + r["sharded"]["extd"]
                       for r in ranks]},
        "traceback": {"c": eng["split"]["launches"]["traceback"]},
        "chain_fwd": {"e": [r["partitioned"]["chain_fwd"] for r in ranks]}}
    log("[phase 12] launches JSON " + json.dumps(launches))



# --------------------------------------------------------------------------
# phase 13: the genome-scale run at a small size
# --------------------------------------------------------------------------

# one chromosome of 20 Mbp (the scale tool's corpus: eight tandem-repeat
# arrays) and 32 reads of 15 +- 5 kb, numpy seed 11 (the JAX tool's)
PHASE13_GBP = 0.02
PHASE13_READS = 32
# what phase 13's process may take on the card beside the holds: its own
# peak (0.78 GiB at 0.02 Gbp) and its held calls
PHASE13_RESERVE_BYTES = 8 << 30


def phase13():
    """tools/scale_run.run on the card at PHASE13_GBP with every check of
    its genome-scale run: KC once a block, S1 once a launch group and its
    index equal to the native build, two map passes with one PAF, K1 and K2
    held to plain on the median-rows call of each launch, no DP job on the
    engine's host DP, the primary hits on their origins.  Returns the
    launches of its path, each zeroed just before its phase.  Runs in a
    process of its own beside the holds, so its seconds are no
    measurement."""
    from winnowmap_tpu_torch.tools import scale_run

    t0 = time.perf_counter()
    try:
        s = scale_run.run(DATA / f"scale_{PHASE13_GBP}", gbp=PHASE13_GBP,
                          n_reads=PHASE13_READS, device=DEVICE)
    except scale_run.ScaleCheckFailed as e:
        fail(f"phase 13: {e}")
    log("[phase 13] " + scale_run.summary_line(s))
    return s["launches"], time.perf_counter() - t0


T_START = time.perf_counter()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(REPO))
    import winnowmap_tpu_torch.native as native
    from winnowmap_tpu_torch import cli, options
    from winnowmap_tpu_torch.chain import device as CD
    from winnowmap_tpu_torch.extend import _build, check
    from winnowmap_tpu_torch.extend import kernels as K
    from winnowmap_tpu_torch.index import build
    from winnowmap_tpu_torch.io import fastx, seqcode
    from winnowmap_tpu_torch.map import batch, pipeline
    from winnowmap_tpu_torch.map.align import gen_simple_mat
    from winnowmap_tpu_torch.sketch import device as SD

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
        else:  # the probes' 38 kernels: registers and spills in all
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", info)]
            spill = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                                 info)]
            log(f"[phase 1] {src}: {len(regs)} kernels, {min(regs)}-"
                f"{max(regs)} registers, spill stores up to {max(spill)} "
                f"bytes")

    # the kernel-against-plain checks in worker processes (the plain
    # versions are bound by the host's Python), the timed batches against
    # the native oracle here meanwhile, then the timings alone on the card
    t0 = time.perf_counter()
    err = {"extd": 0, "extz": 0, "traceback": 0}
    s_err = {"exts": 0, "traceback": 0}
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            PHASE2_WORKERS, mp_context=spawn) as pool:
        # C1's checks first: the longest tasks
        cs_futs = [pool.submit(check_chain, c) for c in CHAIN_CHECKS]
        cs_futs.append(pool.submit(check_sketch))
        futs = [pool.submit(fn, *args) for fn, args in phase2_tasks()]
        main_batch = phase2_main(K, check, native, torch, gen_simple_mat)
        for f in futs:
            r = f.result()
            into = s_err if "exts" in r else err
            for k, v in r.items():
                into[k] = max(into[k], v)
        for f in cs_futs:
            f.result()
    log(f"[phase 2] checks ({len(futs) + len(cs_futs)} tasks in "
        f"{PHASE2_WORKERS} worker "
        f"processes): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records, k1 = phase2_times(K, check, torch, gen_simple_mat, err,
                               main_batch)
    records += phase2_splice_times(K, check, native, torch, gen_simple_mat,
                                   s_err)
    phase2_chain_times(torch, native, CD)
    s1_record = phase2_sketch_times(torch, native, SD, seqcode)
    log(f"[phase 2] times: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase3(cli)
    # each timed run's recorded calls to hold to the plain versions at the
    # end, in worker processes (LaunchTimer.pick, hold_all)
    holds, r1 = [], []
    ont, corpus, p4 = phase4(torch, K, build, fastx, options, batch,
                             seqcode, holds, r1)
    log(f"[phase 3-4] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spl = phase5(torch, K, check, build, fastx, options, batch, seqcode,
                 holds, r1)
    log(f"[phase 5] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ext = phase6(torch, K, options, batch, corpus, holds)
    log(f"[phase 6] {time.perf_counter() - t0:.1f} s")
    # each kernel's launches on its own path: K1 and K2 on map-ont (phase
    # 4), K4 on single-cost map-ont (phase 6), K3 and K2's spliced form on
    # splice (phase 5)
    for rec, n in zip(records, (ont["extd"], ont["traceback"], ext["extz"],
                                spl["exts"], spl["traceback"])):
        rec["launches"] = n
    # R1 at phase 4's and phase 5's widest calls, with each run's launches
    records += r1
    t0 = time.perf_counter()
    records += phase7(torch, k1)
    log(f"[phase 7] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gen = phase8(torch, K, cli, pipeline, build, fastx, options, batch,
                 seqcode, corpus, holds)
    log(f"[phase 8] launches on the generator path: {gen}")
    log(f"[phase 8] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    asm, c1_launch, asm_ctx = phase9(torch, K, build, fastx, options, batch,
                                     pipeline)
    c1_ms = time_chain_launch(torch, CD, c1_launch)
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase11(torch, K, cli, pipeline, build, fastx, options, batch, asm_ctx,
            holds)
    log(f"[phase 11] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase12(torch, K, batch, pipeline, corpus, p4, asm_ctx)
    del asm_ctx, p4
    log(f"[phase 12] {time.perf_counter() - t0:.1f} s")
    # C1's launch held to the plain version, and phase 13, beside the DP
    # calls' holds
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn) as pool:
        c1_held = pool.submit(hold_chain, *c1_launch)
        scale = pool.submit(phase13)
        hold_all(torch, holds, PHASE13_RESERVE_BYTES)
        c1 = c1_record(c1_launch, c1_ms, c1_held.result())
        scale, scale_s = scale.result()
    log(f"[phase 13] launches {scale}; {scale_s:.1f} s in its process; the "
        f"holds and phase 13 {time.perf_counter() - t0:.1f} s")
    # C1 and S1's launches on their path: assembly mapping with its index
    # build (phase 9)
    c1["launches"], s1_record["launches"] = asm["chain_fwd"], asm["sketch"]
    records += [c1, s1_record]
    t0 = time.perf_counter()
    records.append(phase10(torch))
    log(f"[phase 10] {time.perf_counter() - t0:.1f} s")
    log(f"[chip_smoke] {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
