"""Batched mapping entry points (reference mm_map over a batch of reads,
src/map.c:279-981).

map_batch sends a batch through the native engine (map/engine.py) whenever
engine_supported takes the options and no debug dump is on, and through
the generator path otherwise: --junc-bed, -X, -D, --for-only, --rev-only,
no-dual, --sr and the dumps of utils/dbg.  map_batch_frags maps fragments
of several segments (paired ends) on the generator path too.
On the generator path each read is a Python generator (map/frag.py) that
yields extension-DP jobs; run_ext_tasks gathers the jobs of every read,
groups them by what a call shares (scoring, matrix, flag, splice
parameters), runs each group as DevCallPooled calls on the device (K1, K3
or K4, then the traceback) and feeds the results back.  Only the jobs whose
result the oracle's own refusal guards decide (align.refused) are computed
on the host, and they are counted in STATS["host_jobs"].

The debug dumps keep the JAX package's per-read order although the reads'
generators advance together: each task writes its trace into a buffer of
its own (dbg.sink while its generator runs; the --print-aln-seq lines of a
yield's jobs once all their results are in, in job order), and the
buffers are written to stderr read by read, each read's trials in order,
once the batch is done.
"""
from __future__ import annotations

import contextlib
import io
import sys
from collections import defaultdict
from functools import partial

import numpy as np
import torch

from ..chain.device import chain_dp_auto, chain_gate
from ..device import STATS, count, resolve_device, span
from ..extend.kernels import DevCallPooled, PoolContext, job_geometry
from ..options import MM_F_SPLICE
from ..utils import dbg
from .align import JobSeq, _seq_of, align_pair, refused
from .engine import (MAX_CALL_DIRS_BYTES, build_read_pool,
                     engine_supported, map_batch_engine)
from .frag import (MapResult, McasState, _map_vanilla_gen, map_frag_gen,
                   mcas_stage2_gen, read_prologue)

__all__ = ["map_batch", "map_batch_frags", "map_batch_generator",
           "run_ext_tasks", "STATS"]


def map_batch(mi, opt, seqs, qnames, device=None, chain_min=None):
    """Map a batch of reads; returns one MapResult per read, in order.

    device=None runs the DP on the CUDA card (raises when there is none),
    and a batch the engine takes on every visible card when there are
    several (parallel/multidev.map_batch_multidev); an explicit device
    pins the batch to it; device="cpu" runs the kernels' plain PyTorch
    versions.  The split driver (engine.map_batch_engine_pipelined) is
    called directly, never from here.  One-segment
    anchor sets of at least chain_min anchors chain on the device (None:
    the device's default, chain/device.chain_gate; 0: none).  The debug
    dumps (dbg.flag) map on the generator path, on the same device."""
    if engine_supported(opt, mi) and not dbg.flag:
        if device is None and len(seqs) > 1 and torch.cuda.is_available() \
                and torch.cuda.device_count() > 1:
            # every visible card, an engine each (the JAX package routes
            # to its multi-device driver with more than one local device)
            from ..parallel.multidev import map_batch_multidev

            return map_batch_multidev(mi, opt, seqs, qnames,
                                      chain_min=chain_min)
        return map_batch_engine(mi, opt, seqs, qnames,
                                resolve_device(device), chain_min)
    return map_batch_generator(mi, opt, seqs, qnames, device, chain_min)


class _Task:
    """One generator and the job (or job list) it waits on; `buf`, the text
    buffer its debug-dump lines go to (None: no dump is on)."""

    __slots__ = ("gen", "job", "done", "value", "sub_results", "sub_left",
                 "buf")

    def __init__(self, gen):
        self.gen = gen
        self.job = None
        self.done = False
        self.value = None
        self.sub_results = None
        self.sub_left = 0
        self.buf = io.StringIO() if dbg.flag else None

    def advance(self, send_val=None):
        dbg.sink = self.buf
        if self.buf is not None and self.job is not None and (
                dbg.flag & dbg.DBG_PRINT_ALN_SEQ):
            # the yield's DP calls as the sequential driver dumps them
            # (reference align.c:315-338): each job's sequences, then its
            # score and CIGAR
            jobs, ezs = ((self.job, send_val) if isinstance(self.job, list)
                         else ([self.job], [send_val]))
            for job, ez in zip(jobs, ezs):
                dbg.dump_aln_pre(job[0], job[4], job[7], _seq_of(job[2]),
                                 _seq_of(job[1]))
                dbg.dump_aln_post(ez.score, ez.cigar)
        try:
            if send_val is None and self.job is None:
                self.job = next(self.gen)
            else:
                self.job = self.gen.send(send_val)
        except StopIteration as e:
            self.done = True
            self.value = e.value
            self.job = None
        finally:
            dbg.sink = None
        if isinstance(self.job, list):
            self.sub_results = [None] * len(self.job)
            self.sub_left = len(self.job)

    def deliver(self, k, ez):
        """Deliver one job's result (k: its place in a yielded list, None
        for a single job); returns the value to send when the task is
        ready to advance, else None."""
        if k is None:
            return ez
        self.sub_results[k] = ez
        self.sub_left -= 1
        if self.sub_left == 0:
            return self.sub_results
        return None


def _resolve_job(pools: PoolContext, job) -> list:
    """The job's DevCallPooled row (qoff, qlen, qrev, toff, tlen, trev, w,
    zdrop): its query must be a view into the read pool, its target into
    the reference codes."""
    opt, qseq, tseq, mat, w, end_bonus, zdrop, flag = job[:8]
    qr = pools.resolve(qseq) if isinstance(qseq, JobSeq) else None
    tr = pools.resolve(tseq) if isinstance(tseq, JobSeq) else None
    if qr is None or tr is None or qr[0] != 0 or tr[0] != 1:
        raise RuntimeError("an extension job's sequences are not views into "
                           "the read pool and the reference codes")
    return [qr[1], len(qseq), int(qseq.rev), tr[1], len(tseq), int(tseq.rev),
            int(w), int(zdrop)]


def _group_key(job) -> tuple:
    """What the jobs of one call share: the profile's scoring and splice
    parameters, the matrix and the flag (w, zdrop and end_bonus ride per
    job)."""
    opt, mat, flag = job[0], job[3], job[7]
    spl = ((opt.noncan, opt.junc_bonus) if opt.flag & MM_F_SPLICE else None)
    return (opt.q, opt.e, opt.q2, opt.e2, mat.tobytes(), int(flag), spl)


def _dispatch(pools, key, units) -> list:
    """DevCallPooled calls for one group, longest job first, split so no
    call's direction buffer passes MAX_CALL_DIRS_BYTES (as the engine's
    _dispatch splits).  units: [(task, k, row, job)].  Returns [(call,
    units)]."""
    q, e, q2, e2, _, flag, spl = key
    mat = units[0][3][3]
    units = sorted(units, key=lambda u: -(u[2][1] + u[2][4]))
    rows = np.array([u[2] for u in units], np.int64).reshape(-1, 8)
    eb = np.array([u[3][5] for u in units], np.int64)
    nb = np.cumsum(job_geometry(rows, unbanded=spl is not None).nbytes)
    out = []
    lo = 0
    while lo < len(units):
        base = nb[lo - 1] if lo else 0
        hi = int(np.searchsorted(nb, base + MAX_CALL_DIRS_BYTES,
                                 side="right"))
        hi = max(hi, lo + 1)
        chunk = units[lo:hi]
        juncs = None
        if spl is not None:
            juncs = [u[3][8] if len(u[3]) > 8 else None for u in chunk]
        with span(STATS, "dispatch"):
            call = DevCallPooled(pools, rows[lo:hi], mat, q, e, q2, e2,
                                 eb[lo:hi], flag, splice=spl, juncs=juncs)
        count(STATS, "dev_calls")
        count(STATS, "dev_jobs", len(chunk))
        out.append((call, chunk))
        lo = hi
    return out


def run_ext_tasks(tasks: list[_Task], pools: PoolContext) -> None:
    """Run the tasks' generators to their end with every DP job on the
    device.  Each round dispatches every pending group (however few jobs
    it holds), then collects the calls in order; the tasks a call's
    results complete advance at once and queue their next jobs for the
    next round while the later calls still run."""
    queues: dict = defaultdict(list)  # group key -> [(task, k, row, job)]

    def enqueue(t):
        # queue every job of the task's current yield; refused jobs get
        # their host result at once, and a yield of only those advances
        while not t.done:
            jobs = t.job if isinstance(t.job, list) else [t.job]
            ks = range(len(jobs)) if isinstance(t.job, list) else [None]
            queued = False
            send = None
            for k, job in zip(ks, jobs):
                if refused(job[0], len(job[1]), len(job[2])):
                    with span(STATS, "host"):
                        ez = align_pair(*job)
                    count(STATS, "host_jobs")
                    send = t.deliver(k, ez)
                else:
                    queues[_group_key(job)].append(
                        (t, k, _resolve_job(pools, job), job))
                    queued = True
            if queued:
                return
            if send is None and isinstance(t.job, list) and not jobs:
                send = []
            t.advance(send)

    for t in tasks:
        t.advance()
        enqueue(t)
    while queues:
        calls = []
        for key in sorted(queues, key=repr):
            calls += _dispatch(pools, key, queues[key])
        queues.clear()
        for call, chunk in calls:
            with span(STATS, "dev_wait"):
                ezs = call.collect()
            ready = []
            for (t, k, _, _), ez in zip(chunk, ezs):
                send = t.deliver(k, ez)
                if send is not None:
                    ready.append((t, send))
            for t, send in ready:
                t.advance(send)
                enqueue(t)


@contextlib.contextmanager
def _gen_time():
    """Adds the block's host time to STATS["gen_py_s"], less the dispatch,
    device wait and host DP time spent in it (the profiler's "wm.gen_py"
    range covers the whole block)."""
    s0 = {k: STATS[k] for k in ("dispatch_s", "dev_wait_s", "host_s")}
    with span(STATS, "gen_py"):
        yield
    count(STATS, "gen_py_s", -sum(STATS[k] - v for k, v in s0.items()))


def _read_pool(mi, seqs, device, chain_min):
    """The batch's read pool on `device`, chain_dp on the same device, and
    per read its [forward, reverse] views of the pool (qseq0)."""
    qpool, qoffs = build_read_pool(seqs)
    pools = PoolContext(qpool, mi, resolve_device(device))
    chain_dp = partial(chain_dp_auto, device=pools.device,
                       chain_min=chain_gate(chain_min, pools.device))
    qseq0s = [[qpool[of:of + len(s)], qpool[orv:orv + len(s)]]
              for s, (of, orv) in zip(seqs, qoffs)]
    return pools, chain_dp, qseq0s


def _prologue(opt, qname, qlen) -> str | None:
    """A read's first trace lines (frag.read_prologue), or None without a
    dump."""
    if not dbg.flag:
        return None
    dbg.sink = io.StringIO()
    try:
        read_prologue(opt, qname, qlen)
        return dbg.sink.getvalue()
    finally:
        dbg.sink = None


def _traces(heads, tasks_of) -> list:
    """Each read's trace: its prologue, then its tasks' buffers in order."""
    return [(h or "") + "".join(t.buf.getvalue() for t in ts)
            for h, ts in zip(heads, tasks_of)]


def map_batch_generator(mi, opt, seqs, qnames, device=None,
                        chain_min=None, traces=None) -> list:
    """Map a batch of reads through the generator path (reference mm_map,
    src/map.c:279-981), whatever the options: MCAS stage-1 trials and the
    vanilla reads run together, then every SV-aware read's stage 2.
    device and chain_min as for map_batch.  With a debug dump on, each
    read's trace is written to stderr in read order, or appended to
    `traces` (a list) when one is given."""
    with _gen_time():
        pools, chain_dp, qseq0s = _read_pool(mi, seqs, device, chain_min)
        results: list = [None] * len(seqs)
        heads = [_prologue(opt, qnames[i], len(s))
                 for i, s in enumerate(seqs)]
        tasks_of: list = [[] for _ in seqs]
        trial_tasks, vanilla, stage2_in = [], [], []
        for i, seq in enumerate(seqs):
            qlen = len(seq)
            if qlen == 0:
                results[i] = MapResult([], 0, 0)
                continue
            qseq0 = qseq0s[i]
            if opt.sv_aware and qlen >= opt.sv_aware_min_read_length:
                st = McasState(opt, seq, qseq0, chain_dp)
                stage2_in.append((i, st))
                tasks_of[i] = [_Task(g) for g in
                               st.trial_gens(mi, seq, qnames[i])]
                trial_tasks += tasks_of[i]
            else:
                vanilla.append((i, _Task(_map_vanilla_gen(
                    mi, opt, seq, qnames[i], qseq0, chain_dp))))
                tasks_of[i] = [vanilla[-1][1]]
        run_ext_tasks(trial_tasks + [t for _, t in vanilla], pools)
        for i, t in vanilla:
            results[i] = t.value
        stage2 = [(i, _Task(mcas_stage2_gen(mi, opt, seqs[i], qnames[i],
                                            st)))
                  for i, st in stage2_in]
        for i, t in stage2:
            tasks_of[i].append(t)
        run_ext_tasks([t for _, t in stage2], pools)
        for i, t in stage2:
            results[i] = t.value
        if dbg.flag:
            out = _traces(heads, tasks_of)
            if traces is None:
                sys.stderr.write("".join(out))
            else:
                traces += out
        return results


def map_batch_frags(mi, opt, frags, qnames, device=None,
                    chain_min=None) -> list:
    """Map a batch of fragments (paired ends, --frag; reference worker_for
    with n_seg > 1, src/map.c:1008-1048), as the JAX package's
    map_batch_frags: `frags` is a list of fragments, each a list of segment
    sequences; returns per fragment a list of per-segment MapResults.
    One-segment fragments go through map_batch (the engine, MCAS and all);
    the others through map_frag_gen, their DP jobs batched into the kernels
    by run_ext_tasks, each segment's jobs on its own views of the read
    pool.  device and chain_min as for map_batch; with a debug dump on,
    the traces are written in fragment order."""
    results: list = [None] * len(frags)
    singles = [i for i, fr in enumerate(frags) if len(fr) == 1]
    multi = [i for i, fr in enumerate(frags) if len(fr) > 1]
    traces = [""] * len(frags)
    if singles:
        seqs = [frags[i][0] for i in singles]
        names = [qnames[i] for i in singles]
        if dbg.flag:
            tr: list = []
            res = map_batch_generator(mi, opt, seqs, names, device,
                                      chain_min, traces=tr)
            for i, t in zip(singles, tr):
                traces[i] = t
        else:
            res = map_batch(mi, opt, seqs, names, device, chain_min)
        for i, r in zip(singles, res):
            results[i] = [r]
    if multi:
        with _gen_time():
            pools, chain_dp, qseq0s = _read_pool(
                mi, [s for i in multi for s in frags[i]], device, chain_min)
            tasks = []
            k = 0
            for i in multi:
                q0 = qseq0s[k:k + len(frags[i])]
                k += len(frags[i])
                tasks.append((i, _Task(map_frag_gen(
                    mi, opt, frags[i], qnames[i], q0, chain_dp))))
            run_ext_tasks([t for _, t in tasks], pools)
            for i, t in tasks:
                results[i] = t.value
                if t.buf is not None:
                    traces[i] = t.buf.getvalue()
    if dbg.flag:
        sys.stderr.write("".join(traces))
    return results
