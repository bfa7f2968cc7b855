"""Native-engine batched mapping driver, PyTorch/CUDA port.

The per-read orchestration (seeding, chaining, hit bookkeeping, alignment
control flow, MCAS staging -- reference src/map.c:279-981, src/hit.c,
src/align.c) runs inside the C++ engine (native/src/wm_engine.cpp) on its
own threads.  This module pumps it: every extension-DP job the engine
exports goes to extend/kernels.DevCallPooled (the CUDA kernels on a card,
their plain PyTorch versions on the CPU), and the results go back over the
engine's flat deliver boundary.  Spliced profiles (MM_F_SPLICE) send every
job to the exts kernel, unbanded; single-cost profiles (q == q2 and
e == e2) to extz; the others to extd.

Every DP job the engine makes is exported, the inversion rescue's included;
only jobs whose result the oracle's own refusal guards or --cap-sw-mem
decide stay on the engine's host DP (wm_engine.cpp device_eligible), and
they are counted in STATS["eng_host_dp_calls"].

Chains of at least `chain_min` anchors (one segment) leave the engine's
scalar DP through its chain exchange (wm_eng_set_chain_min): their threads
block in chain_submit, the pump takes the exported anchor sets, runs their
forward pass through chain/device.py (C1 on a card, its plain version on
the CPU), the oracle's tail (native.chain_finish) on the host, and hands
the chains back (wm_eng_deliver_chain); STATS["chain_dev_jobs"],
["chain_dev_anchors"] and ["chain_dev_s"] count them.  The gate is
DEVICE_CHAIN_MIN_ANCHORS (50,000) on a card and 0, every chain on the
host, on the CPU, unless the caller gives chain_min.

The pump's work is timed in spans (device.span: STATS["<name>_s"], and the
profiler range "wm.<name>" while one records): eng_setup, eng_launch
(joining a phase's threads, starting the next's), eng_step, eng_group
(grouping a step's jobs and planning their calls; the dispatches nest in
it), dispatch, dev_wait, chain_dev, eng_deliver, eng_results.  The engine's
threads report their time in each phase (wm_eng_perf): eng_thread_s
(threads x the phase's wall), eng_blocked_s (waiting on an exported DP job
or chain) and eng_finished_s (done while others still ran).
"""
from __future__ import annotations

import ctypes
import os
from collections import defaultdict, deque

import numpy as np
import torch

from .. import native
from ..chain.device import chain_dp_device_batch, chain_gate
from ..device import STATS, count, span
from ..extend.kernels import DevCallPooled, PoolContext, job_geometry
from ..io.seqcode import encode
from ..options import (
    MM_F_FOR_ONLY,
    MM_F_NO_DIAG,
    MM_F_NO_DUAL,
    MM_F_REV_ONLY,
    MM_F_SPLICE,
    MM_F_SR,
    MapOptions,
    stage1_options,
    stage2_options,
)
from .align import gen_simple_mat
from .frag import MapResult, _x31_hash
from .hit import Extra, Reg

# job row columns (wm_engine.cpp JOB_I64 layout)
(C_ID, C_QOFF, C_QLEN, C_QREV, C_TOFF, C_TLEN, C_TREV, C_W, C_ZD, C_EB,
 C_FLAG, C_PROF) = range(12)

# direction-buffer bytes one device call may allocate; a group above it is
# split over several calls (a single larger job still gets a call of its own)
MAX_CALL_DIRS_BYTES = 4 << 30

def engine_supported(opt: MapOptions, mi=None) -> bool:
    """Options the native engine handles; map_batch sends the others to the
    generator path (map/batch.py): --sr, -D/-X, --for-only, --rev-only,
    no-dual, and spliced mapping with --junc-bed intervals (their junction
    bytes follow each job's DP window, which the engine does not carry)."""
    unsupported = (MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_FOR_ONLY
                   | MM_F_REV_ONLY | MM_F_SR)
    if opt.flag & unsupported:
        return False
    if (opt.flag & MM_F_SPLICE) and mi is not None and mi.intervals:
        return False
    return True


def _opts_to_c(opt: MapOptions) -> native.EngOptsC:
    o = native.EngOptsC()
    for name, _ in o._fields_:
        if name == "pad_":
            continue
        v = getattr(opt, name)
        setattr(o, name, int(v) if isinstance(v, bool) else v)
    return o


def _index_to_c(mi) -> tuple[native.EngIndexC, list]:
    keep = []

    def ptr(a):
        keep.append(a)
        return a.ctypes.data_as(ctypes.c_void_p) if a.size else None

    seq_off = np.array([s.offset for s in mi.seqs], np.int64)
    seq_len = np.array([s.length for s in mi.seqs], np.int32)
    c = native.EngIndexC()
    c.keys = ptr(np.ascontiguousarray(mi.keys, np.uint64))
    c.start = ptr(np.ascontiguousarray(mi.start, np.int64))
    c.pos = ptr(np.ascontiguousarray(mi.pos, np.uint64))
    c.codes = ptr(np.ascontiguousarray(mi.codes, np.uint8))
    c.seq_off = ptr(seq_off)
    c.seq_len = ptr(seq_len)
    c.wset = ptr(np.ascontiguousarray(mi.wset, np.uint64))
    if getattr(mi, "bloom", None) is not None:
        table, bits, s0, s1 = mi.bloom
        c.bloom = ptr(np.ascontiguousarray(table, np.uint8))
        c.bloom_bits = bits
        c.bloom_salts = (s1 << 32) | s0
    c.n_keys = len(mi.keys)
    c.n_wset = len(mi.wset)
    c.n_seq = len(mi.seqs)
    c.w = mi.w
    c.k = mi.k
    c.idx_flag = mi.flag
    return c, keep


def _check_sizes(L):
    """The ctypes mirrors must match the engine's C structs."""
    s = np.zeros(3, np.int64)
    L.wm_eng_sizes.argtypes = [ctypes.c_void_p]
    L.wm_eng_sizes(s.ctypes.data)
    want = (ctypes.sizeof(native.EngOptsC), ctypes.sizeof(native.EngIndexC),
            native.REGOUT_DTYPE.itemsize)
    if tuple(int(v) for v in s) != want:
        raise RuntimeError(f"engine ABI mismatch: C sizes {s.tolist()}, "
                           f"ctypes sizes {list(want)}")


class MapEngine:
    """One batch's native engine and its device pump."""

    def __init__(self, mi, opt: MapOptions, seqs, qnames, pools: PoolContext,
                 qoffs, qpool_np, chain_min: int | None = None):
        self.L = native.lib()
        _check_sizes(self.L)
        self.opt = opt
        self.pools = pools
        self.n = len(seqs)
        self._keep = [qpool_np]
        self._seqs = seqs  # bytes objects must outlive the engine
        self.opts3 = [opt, stage1_options(opt), stage2_options(opt)]

        # profiles with identical DP scoring share calls: the stage
        # overrides touch zdrop/bw (per-job columns), not the scoring
        def _score_key(o):
            return (o.a, o.b, o.q, o.e, o.q2, o.e2, o.sc_ambi)

        skeys = [_score_key(o) for o in self.opts3]
        self.prof_rep = np.array([skeys.index(k) for k in skeys], np.int64)
        self.c_opts = [_opts_to_c(o) for o in self.opts3]
        self.c_idx, keep = _index_to_c(mi)
        self._keep += keep
        self.h = self.L.wm_eng_create(
            ctypes.byref(self.c_idx), ctypes.byref(self.c_opts[0]),
            ctypes.byref(self.c_opts[1]), ctypes.byref(self.c_opts[2]),
            qpool_np.ctypes.data_as(ctypes.c_void_p),
            int(os.environ.get("WM_ENGINE_THREADS", "512")))
        # anchor sets of at least chain_min anchors (None: the device's
        # default, chain_gate) export through the chain exchange; 0 keeps
        # every chain on the engine's scalar DP
        self.L.wm_eng_set_chain_min(self.h,
                                    chain_gate(chain_min, pools.device))
        for i, (seq, name) in enumerate(zip(seqs, qnames)):
            of, orv = qoffs[i]
            self.L.wm_eng_add_read(
                self.h, ctypes.c_char_p(seq), len(seq), of, orv,
                _x31_hash(name) if name else 0)

    def close(self):
        if self.h:
            self.L.wm_eng_destroy(self.h)
            self.h = None

    def _step(self) -> np.ndarray:
        """Wait until every live engine thread is blocked and take the jobs
        they exported (wm_eng_step)."""
        p = ctypes.POINTER(ctypes.c_int64)()
        with span(STATS, "eng_step"):
            n = self.L.wm_eng_step(self.h, ctypes.byref(p))
        if n == 0:
            return np.zeros((0, 12), np.int64)
        return np.ctypeslib.as_array(p, (n, 12)).copy()

    def _service_chains(self) -> bool:
        """Take the anchor sets the engine's threads exported (once every
        live thread is blocked), chain them on the pool's device in one
        forward pass per parameter set, and deliver each (u, ax, ay) back
        to its thread.  Returns whether there were any."""
        p = ctypes.POINTER(ctypes.c_int64)()
        with span(STATS, "eng_step"):
            n = self.L.wm_eng_step_chains(self.h, ctypes.byref(p))
        if n == 0:
            return False
        rows = np.ctypeslib.as_array(p, (n, 16)).copy()
        with span(STATS, "chain_dev"):
            u64p = ctypes.POINTER(ctypes.c_uint64)
            groups = defaultdict(list)  # parameters -> [(id, ax, ay)]
            for r in rows:
                na = int(r[1])
                ax = np.ctypeslib.as_array(ctypes.cast(int(r[2]), u64p),
                                           (na,))
                ay = np.ctypeslib.as_array(ctypes.cast(int(r[3]), u64p),
                                           (na,))
                # the engine's scalar path takes gap_scale through a float
                # cast
                gs = float(np.float32(np.int64(r[13]).view(np.float64)))
                groups[tuple(int(v) for v in r[4:13]) + (gs,)].append(
                    (int(r[0]), ax, ay))
            for key, members in groups.items():
                mdx, mindx, mdy, bw, mskip, miter, mcnt, msc, is_cdna, gs = \
                    key
                results = chain_dp_device_batch(
                    [(ax, ay) for _, ax, ay in members], mdx, mindx, mdy, bw,
                    mskip, miter, mcnt, msc, gs, is_cdna, self.pools.device)
                for (cid, _, _), (u, oax, oay) in zip(members, results):
                    self.L.wm_eng_deliver_chain(
                        self.h, cid, len(u), u.ctypes.data, len(oax),
                        oax.ctypes.data, oay.ctypes.data)
        count(STATS, "chain_dev_jobs", len(rows))
        count(STATS, "chain_dev_anchors", int(rows[:, 1].sum()))
        return True

    def _deliver(self, rows: np.ndarray, collected) -> None:
        """Feed one call's results back over the flat deliver boundary."""
        with span(STATS, "eng_deliver"):
            res9, blob, off, ln, reach = collected
            n = len(rows)
            ids = np.ascontiguousarray(rows[:, C_ID])
            res = np.zeros((n, 10), np.int32)
            res[:, :9] = res9
            res[:, 9] = reach
            if blob is None:
                blob = np.zeros(1, np.uint32)
                off = np.zeros(n, np.int64)
                ln = np.zeros(n, np.int32)
            else:
                blob = np.ascontiguousarray(blob, np.uint32)
                off = np.ascontiguousarray(off, np.int64)
                ln = np.ascontiguousarray(ln, np.int32)
            self.L.wm_eng_deliver(self.h, n, ids.ctypes.data,
                                  res.ctypes.data, blob.ctypes.data,
                                  off.ctypes.data, ln.ctypes.data)
        count(STATS, "delivered_jobs", n)

    def _dispatch(self, prof: int, flag: int, rows: np.ndarray) -> list:
        """DevCallPooled calls for one group of rows (same scoring class and
        flag; w, zdrop and end_bonus ride per-job columns), longest job
        first, split so no call's direction buffer passes
        MAX_CALL_DIRS_BYTES.  The profile, not the job flag, picks the
        kernel: a spliced profile's jobs all go to exts, as in the engine's
        host DP.  Returns [(call, rows)]."""
        opt = self.opts3[prof]
        mat = gen_simple_mat(opt.a, opt.b, opt.sc_ambi)
        spliced = bool(opt.flag & MM_F_SPLICE)
        splice = (opt.noncan, opt.junc_bonus) if spliced else None
        order = np.argsort(-(rows[:, C_QLEN] + rows[:, C_TLEN]),
                           kind="stable")
        rows = rows[order]
        units = rows[:, [C_QOFF, C_QLEN, C_QREV, C_TOFF, C_TLEN, C_TREV,
                         C_W, C_ZD]]
        nb = np.cumsum(job_geometry(units, unbanded=spliced).nbytes)
        out = []
        lo = 0
        while lo < len(rows):
            base = nb[lo - 1] if lo else 0
            hi = int(np.searchsorted(nb, base + MAX_CALL_DIRS_BYTES,
                                     side="right"))
            hi = max(hi, lo + 1)
            crows = rows[lo:hi]
            with span(STATS, "dispatch"):
                call = DevCallPooled(
                    self.pools, np.ascontiguousarray(units[lo:hi]), mat,
                    opt.q, opt.e, opt.q2, opt.e2,
                    np.ascontiguousarray(crows[:, C_EB]), int(flag),
                    splice=splice)
            count(STATS, "dev_calls")
            count(STATS, "dev_jobs", len(crows))
            out.append((call, crows))
            lo = hi
        return out

    def _drive_phase(self) -> None:
        """Pump the engine until the phase's threads finish: step (take the
        settled round of exported jobs), group by (scoring class, flag),
        dispatch every group, chain the exported anchor sets, collect the
        oldest call and deliver it (its threads resume while later calls
        run), repeat.  A thread blocked on a chain counts as settled, so
        the chains are served on every turn."""
        inflight: deque = deque()
        while True:
            rows = self._step()
            if len(rows):
                with span(STATS, "eng_group"):
                    pf = self.prof_rep[rows[:, C_PROF]]
                    fl = rows[:, C_FLAG]
                    for key in sorted(set(zip(pf.tolist(), fl.tolist()))):
                        m = (pf == key[0]) & (fl == key[1])
                        inflight.extend(
                            self._dispatch(key[0], key[1], rows[m]))
            chained = self._service_chains()
            if inflight:
                call, crows = inflight.popleft()
                with span(STATS, "dev_wait"):
                    collected = call.collect_blob()
                self._deliver(crows, collected)
                continue
            if not chained and self.L.wm_eng_live(self.h) == 0:
                return
            # a step right after a deliver can return before the woken
            # threads have left their wait: step again

    def results(self) -> list[MapResult]:
        out = []
        preg = ctypes.POINTER(ctypes.c_uint8)()
        pcig = ctypes.POINTER(ctypes.c_uint32)()
        ncig = ctypes.c_int64()
        rep_len = ctypes.c_int64()
        frag_gap = ctypes.c_int32()
        rep_def = ctypes.c_int32()
        for i in range(self.n):
            n = self.L.wm_eng_result(
                self.h, i, ctypes.byref(preg), ctypes.byref(pcig),
                ctypes.byref(ncig), ctypes.byref(rep_len),
                ctypes.byref(frag_gap), ctypes.byref(rep_def))
            regs = []
            if n:
                raw = np.ctypeslib.as_array(
                    preg, (n * native.REGOUT_DTYPE.itemsize,))
                rv = raw.view(native.REGOUT_DTYPE)
                cig = (np.ctypeslib.as_array(pcig, (ncig.value,)).copy()
                       if ncig.value else np.zeros(0, np.uint32))
                for j in range(n):
                    f = rv[j]
                    r = Reg(
                        id=int(f["id"]), cnt=int(f["cnt"]), rid=int(f["rid"]),
                        score=int(f["score"]), qs=int(f["qs"]),
                        qe=int(f["qe"]), rs=int(f["rs"]), re=int(f["re"]),
                        parent=int(f["parent"]), subsc=int(f["subsc"]),
                        as_=int(f["as_"]), mlen=int(f["mlen"]),
                        blen=int(f["blen"]), n_sub=int(f["n_sub"]),
                        score0=int(f["score0"]), mapq=int(f["mapq"]),
                        div=float(f["div"]), inv=bool(f["inv"]),
                        rev=bool(f["rev"]), split=int(f["split"]),
                        split_inv=bool(f["split_inv"]),
                        sam_pri=bool(f["sam_pri"]),
                        seg_split=bool(f["seg_split"]),
                        seg_id=int(f["seg_id"]), n_segs=int(f["n_segs"]),
                        is_alt=bool(f["is_alt"]), hash=int(f["hash"]))
                    if f["has_p"]:
                        co, nc = int(f["cigar_off"]), int(f["n_cigar"])
                        r.p = Extra(
                            dp_score=int(f["dp_score"]),
                            dp_max=int(f["dp_max"]),
                            dp_max2=int(f["dp_max2"]),
                            n_ambi=int(f["n_ambi"]),
                            trans_strand=int(f["trans_strand"]),
                            cigar=cig[co:co + nc])
                    regs.append(r)
            out.append(MapResult(regs, int(rep_len.value),
                                 int(frag_gap.value), bool(rep_def.value)))
        return out


def build_read_pool(seqs):
    """Read pool of forward + reverse-complement strand codes per read and
    each read's (fwd_off, rev_off)."""
    total = sum(2 * len(s) for s in seqs)
    step = 4 << 20
    cap = (max(total, 1) + step - 1) // step * step
    qpool = np.zeros(cap, np.uint8)
    qoffs = []
    o = 0
    for seq in seqs:
        L = len(seq)
        fwd = encode(seq)
        qpool[o:o + L] = fwd
        rev = fwd[::-1]
        qpool[o + L:o + 2 * L] = np.where(rev < 4, 3 - rev, rev)
        qoffs.append((o, o + L))
        o += 2 * L
    return qpool, qoffs


def map_batch_engine(mi, opt: MapOptions, seqs, qnames,
                     device: torch.device,
                     chain_min: int | None = None) -> list[MapResult]:
    """Map a batch of reads through the native engine with every exported
    DP job, and every chain of at least chain_min anchors (None: the
    device's default, chain_gate; 0: none), on `device` (reference mm_map
    semantics)."""
    if not engine_supported(opt, mi):
        raise ValueError("the native engine does not take these options; "
                         "map_batch sends them to the generator path")
    with span(STATS, "eng_setup"):
        qpool, qoffs = build_read_pool(seqs)
        pools = PoolContext(qpool, mi, device)
        eng = MapEngine(mi, opt, seqs, qnames, pools, qoffs, qpool,
                        chain_min)
    try:
        with span(STATS, "eng_launch"):
            eng.L.wm_eng_start_phase1(eng.h)
        eng._drive_phase()
        with span(STATS, "eng_launch"):
            phase2 = eng.L.wm_eng_start_phase2(eng.h)
        if phase2:
            eng._drive_phase()
        with span(STATS, "eng_results"):
            results = eng.results()
            perf = np.zeros(8, np.int64)
            eng.L.wm_eng_perf(eng.h, perf.ctypes.data)
        count(STATS, "eng_host_dp_calls", int(perf[1]))
        count(STATS, "eng_chain_s", perf[2] / 1e9)
        count(STATS, "eng_chain_calls", int(perf[3]))
        count(STATS, "eng_thread_s", perf[4] / 1e9)
        count(STATS, "eng_blocked_s", perf[5] / 1e9)
        count(STATS, "eng_finished_s", perf[6] / 1e9)
    finally:
        eng.close()
    for i, seq in enumerate(seqs):
        if len(seq) == 0:
            results[i] = MapResult([], 0, 0)
    return results


def map_batch_engine_pipelined(mi, opt: MapOptions, seqs, qnames,
                               device=None, ways: int = 2,
                               chain_min: int | None = None
                               ) -> list[MapResult]:
    """Interleave `ways` engine drivers in host threads over strided
    sub-batches of one read batch (the JAX package's split driver): while
    one driver waits on its device calls, the others' engine threads and
    pumps use the host -- the single-host analogue of the reference's
    read/map/write pipeline overlap (src/kthread.c:130-159).  This is
    map_batch_multidev over `ways` copies of `device` (None: the card),
    each driver under a CUDA stream of its own, so their kernels overlap
    on the card; at most one driver for every 64 reads.  Results return in
    input order, equal to map_batch_engine's."""
    from ..device import resolve_device
    from ..parallel.multidev import map_batch_multidev

    dev = resolve_device(device)
    ways = max(1, min(ways, (len(seqs) + 63) // 64))
    return map_batch_multidev(mi, opt, seqs, qnames, [dev] * ways, chain_min)
