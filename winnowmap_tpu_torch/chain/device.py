"""Colinear anchor chaining on the device: the chain DP's forward pass.

Counterpart of winnowmap_tpu/chain/device.py for PyTorch and CUDA.  The
semantics are the scalar oracle's (native/src/wm_chain.cpp wm_chain_dp;
reference src/chain.c:22-167, with Winnowmap's min_dist_x window rule)
for one segment: window starts on the host (_window_starts), the forward
pass (f, pre, v per anchor) on the device, and the oracle's own tail
(native.chain_finish) on the host, so the output equals native.chain_dp
exactly.

The forward pass has
  * a wrapper, chain_fwd, that launches C1 (csrc/chain.cu, one warp per
    job, its last 1024 anchors in a shared-memory ring) for CUDA tensors
    and counts the launch in LAUNCHES, and uses the plain version only for
    tensors on the CPU;
  * a plain PyTorch version, chain_fwd_plain, batched over jobs of one
    size class and vectorised over each anchor's window, on any device.
Unlike the JAX package's window cap (8192), any window width goes to the
device.

chain_dp_auto routes one anchor set to the device at or above the anchor
gate `chain_min`, as the JAX package's generator path does; the native
engine's chain exchange (map/engine.py) batches its exported chains
through chain_dp_device_batch.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..device import count, resolve_device

NEG = -0x40000000

# anchor sets at or above this many anchors chain on the card (the JAX
# package's DEVICE_CHAIN_MIN_ANCHORS); the CPU default is 0, every chain on
# the host's scalar DP
DEVICE_CHAIN_MIN_ANCHORS = 50_000

# predecessors C1 reads from its shared-memory ring (csrc/chain.cu's
# kRing - 1); older ones it reads from global memory
RING_REACH = 1023

# kernel launches on this process; chip_smoke.py zeroes them around the
# main path to show it went through the kernel
LAUNCHES = {"chain_fwd": 0}


def reset_launches() -> None:
    LAUNCHES["chain_fwd"] = 0


def chain_gate(chain_min: int | None, device: torch.device) -> int:
    """The anchor gate: chain_min, or where it is None the default on
    `device`, DEVICE_CHAIN_MIN_ANCHORS on a card and 0 (no chain leaves the
    host's scalar DP) on the CPU."""
    if chain_min is not None:
        return chain_min
    return DEVICE_CHAIN_MIN_ANCHORS if device.type == "cuda" else 0


class ChainJobs(NamedTuple):
    """A batch of anchor sets, concatenated: the low 32 bits of each
    anchor's x and y, its q_span and window start (a job-local index), all
    int32; off (B + 1) int64 job offsets; avgq (B) f64, each job's average
    q_span as the oracle takes it."""
    x: torch.Tensor
    y: torch.Tensor
    span: torch.Tensor
    st: torch.Tensor
    off: torch.Tensor
    avgq: torch.Tensor


def _window_starts(ax: np.ndarray, max_dist_x: int, min_dist_x: int,
                   max_iter: int) -> np.ndarray:
    """Per-anchor window starts (reference chain.c:45-55: the max_dist_x
    advance plus Winnowmap's keep-iterating-inside-repeats rule).  ax - dist
    saturates at 0 (anchors within dist of the reference start must not wrap
    the unsigned subtraction)."""
    n = len(ax)

    def below(dist):
        d = np.uint64(dist)
        tgt = np.where(ax >= d, ax - d, np.uint64(0))
        return np.searchsorted(ax, tgt, side="left")

    st0 = below(max_dist_x)
    idx = np.arange(n, dtype=np.int64)
    st = st0.astype(np.int64)
    over = idx - st > max_iter
    if over.any():
        J = below(min_dist_x)
        st_over = np.minimum(idx - max_iter, J.astype(np.int64))
        st = np.where(over, np.maximum(st0, st_over), st)
    return st.astype(np.int32)


def _avg_qspan(span: np.ndarray) -> float:
    """The oracle's (float)sum / n in f32, promoted to f64 where it is used
    (wm_chain.cpp:46-48)."""
    s32 = np.float32(span.sum(dtype=np.uint64))
    return float(np.float64(s32 / np.float32(len(span))))


def chain_jobs(jobs, max_dist_x: int, min_dist_x: int, max_iter: int,
               device) -> ChainJobs:
    """ChainJobs on `device` for non-empty (ax, ay) uint64 anchor sets,
    each sorted by ax."""
    lo32 = np.uint64(0xFFFFFFFF)
    xs, ys, sps, sts, avq = [], [], [], [], []
    off = [0]
    for ax, ay in jobs:
        ax = np.ascontiguousarray(ax, np.uint64)
        ay = np.ascontiguousarray(ay, np.uint64)
        xs.append((ax & lo32).astype(np.uint32).view(np.int32))
        ys.append((ay & lo32).astype(np.uint32).view(np.int32))
        span = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
        sps.append(span)
        sts.append(_window_starts(ax, max_dist_x, min_dist_x, max_iter))
        avq.append(_avg_qspan(span))
        off.append(off[-1] + len(ax))

    def up(parts, dtype):
        return torch.from_numpy(np.concatenate(parts).astype(dtype)).to(
            device)

    return ChainJobs(up(xs, np.int32), up(ys, np.int32), up(sps, np.int32),
                     up(sts, np.int32),
                     torch.tensor(off, dtype=torch.int64, device=device),
                     torch.tensor(avq, dtype=torch.float64, device=device))


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken as int32, wrapping (the oracle's int32
    differences of the low coordinate bits)."""
    return ((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _floor_log2(t: torch.Tensor) -> torch.Tensor:
    """floor(log2(t)) for t >= 1 (int64), exactly: frexp's exponent."""
    return torch.frexp(t.to(torch.float64)).exponent.to(torch.int64) - 1


def _fwd_group(cj: ChainJobs, members, n, starts, params, out, tally):
    """The plain forward pass of one size class of jobs (`members`, their
    anchor counts `n`), every anchor's window evaluated as one vector a job,
    the oracle's sequential bookkeeping as prefix scans: the running max as
    a cumulative max seeded with q_span, the marks t[pre[j]] = i as a
    scatter (a mark always lands on a later lane than its source), the
    max_skip counter as a cumulative sum floored at 0 by its cumulative
    min, and the break as the first lane past max_skip."""
    max_dist_x, max_dist_y, bw, max_skip, is_cdna, gap_scale = params
    dev = cj.x.device
    off = cj.off.tolist()
    B, N = len(members), int(max(n))
    pos = np.arange(N)
    valid_np = pos[None, :] < np.asarray(n)[:, None]
    gidx_np = np.where(valid_np,
                       np.asarray([off[b] for b in members])[:, None]
                       + pos[None, :], 0)
    # a padded anchor gets an empty window (st = i)
    st_np = np.where(valid_np, starts[gidx_np], pos[None, :])
    wins = (pos - st_np).max(axis=0)
    gidx = torch.from_numpy(gidx_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    X = cj.x[gidx].to(torch.int64)
    Y = cj.y[gidx].to(torch.int64)
    SP = cj.span[gidx].to(torch.int64)
    ST = torch.from_numpy(st_np.astype(np.int64)).to(dev)
    AQ = cj.avgq[torch.tensor(members, device=dev)][:, None]
    F = torch.zeros((B, N), dtype=torch.int64, device=dev)
    PRE = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    V = torch.zeros((B, N), dtype=torch.int64, device=dev)
    lanes = torch.arange(max(1, int(wins.max())), device=dev)
    negc = torch.full((B, 1), NEG, dtype=torch.int64, device=dev)
    for i in range(N):
        w = int(wins[i])
        spi = SP[:, i]
        if w == 0:
            F[:, i] = spi
            V[:, i] = spi
            continue
        ln = lanes[:w]
        jj = (i - 1 - ln).clamp(min=0)
        inwin = (i - 1 - ln)[None, :] >= ST[:, i:i + 1]
        dr = _wrap32(X[:, i:i + 1] - X[:, jj])
        dq = _wrap32(Y[:, i:i + 1] - Y[:, jj])
        dd = (dr - dq).abs()
        ok = (inwin & (dr != 0) & (dq > 0) & (dq <= max_dist_y)
              & (dq <= max_dist_x) & (dd <= bw))
        sc = torch.minimum(torch.minimum(dq, dr), spi[:, None])
        log_dd = torch.where(dd > 0, _floor_log2(dd.clamp(min=1)), 0)
        c_lin = (dd.to(torch.float64) * 0.01 * AQ).to(torch.int64)
        gap = c_lin + (log_dd >> 1)
        if is_cdna:
            gap = torch.where(dr > dq, torch.minimum(c_lin, log_dd), gap)
        gterm = (gap.to(torch.float64) * gap_scale + 0.499).to(torch.int64)
        sc = torch.where(ok, sc - gterm + F[:, jj], NEG)
        run = torch.cummax(sc, 1).values
        excl = torch.cat([negc, run[:, :-1]], 1).maximum(spi[:, None])
        better = ok & (sc > excl)
        pj = PRE[:, jj]
        src = ok & (pj >= 0)
        tgt = torch.where(src, (i - 1 - pj).clamp(max=w), w)
        mark = torch.zeros((B, w + 1), dtype=torch.bool, device=dev)
        mark.scatter_(1, tgt, True)
        d = torch.where(better, -1, (ok & mark[:, :w]).to(torch.int64))
        P = torch.cumsum(d, 1)
        s = P - torch.cummin(P, 1).values.clamp(max=0)
        crossed = (s > max_skip).to(torch.int64)
        alive = torch.cumsum(crossed, 1) - crossed == 0
        if tally is not None:
            # the oracle's loop runs up to and including the crossing lane
            tally[0] += (alive & inwin).sum()
            tally[1] += (alive & ok).sum()
        lb = torch.where(better & alive, ln, -1).max(1).values
        has = lb >= 0
        lbc = lb.clamp(min=0)[:, None]
        max_f = torch.where(has, sc.gather(1, lbc)[:, 0], spi)
        max_j = torch.where(has, i - 1 - lb, -1)
        vj = V.gather(1, max_j.clamp(min=0)[:, None])[:, 0]
        F[:, i] = max_f
        PRE[:, i] = max_j
        V[:, i] = torch.where(has & (vj > max_f), vj, max_f)
    for k, A in enumerate((F, PRE, V)):
        out[k, gidx[valid]] = A[valid].to(torch.int32)


def chain_fwd_plain(cj: ChainJobs, max_dist_x: int, max_dist_y: int, bw: int,
                    max_skip: int, is_cdna: int, gap_scale: float,
                    tally: torch.Tensor | None = None) -> torch.Tensor:
    """The forward pass in plain PyTorch on cj's device: (3, total) int32,
    rows f, pre, v.  Jobs are grouped by the power of two at or above their
    anchor count (at least 128, the JAX package's shape classes), so a
    group pads little.  tally, an int64 pair on cj's device, gains the
    candidates the oracle evaluates (its loop up to the max_skip break) and
    those among them that pass its distance tests: the work a bound
    counts."""
    dev = cj.x.device
    off = cj.off.tolist()
    out = torch.empty((3, off[-1]), dtype=torch.int32, device=dev)
    starts = cj.st.cpu().numpy()
    groups = defaultdict(list)
    for b in range(len(off) - 1):
        nb = off[b + 1] - off[b]
        if nb:
            groups[max(7, math.ceil(math.log2(nb)))].append(b)
    params = (max_dist_x, max_dist_y, bw, max_skip, int(is_cdna),
              float(gap_scale))
    for _, members in sorted(groups.items()):
        _fwd_group(cj, members, [off[b + 1] - off[b] for b in members],
                   starts, params, out, tally)
    return out


def chain_launch(lib, cj: ChainJobs, max_dist_x: int, max_dist_y: int,
                 bw: int, max_skip: int, is_cdna: int, gap_scale: float, out,
                 stream) -> int:
    """C1's C entry on cj, writing f, pre, v into out (3, total) int32;
    the marks' scratch is allocated here.  Returns the CUDA error code."""
    marks = torch.empty(max(1, cj.x.numel()), dtype=torch.int32,
                        device=cj.x.device)
    return lib.wm_chain_fwd_launch(
        cj.x.data_ptr(), cj.y.data_ptr(), cj.span.data_ptr(),
        cj.st.data_ptr(), cj.off.data_ptr(), cj.avgq.data_ptr(),
        cj.off.numel() - 1, max_dist_x, max_dist_y, bw, max_skip,
        int(is_cdna), float(gap_scale), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), marks.data_ptr(), stream)


def chain_fwd(cj: ChainJobs, max_dist_x: int, max_dist_y: int, bw: int,
              max_skip: int, is_cdna: int, gap_scale: float) -> torch.Tensor:
    """C1: the forward pass of every job in one launch for CUDA tensors (the
    plain version for CPU tensors).  Returns (3, total) int32: f, pre, v."""
    dev = cj.x.device
    if dev.type == "cpu":
        return chain_fwd_plain(cj, max_dist_x, max_dist_y, bw, max_skip,
                               is_cdna, gap_scale)
    for t in cj:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous CUDA "
                             "tensors")
    from ..extend import _build

    out = torch.empty((3, cj.x.numel()), dtype=torch.int32, device=dev)
    rc = chain_launch(_build.load(), cj, max_dist_x, max_dist_y, bw,
                      max_skip, is_cdna, gap_scale, out,
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chain kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, "chain_fwd")
    return out


def chain_dp_device_batch(jobs, max_dist_x, min_dist_x, max_dist_y, bw,
                          max_skip, max_iter, min_cnt, min_sc, gap_scale,
                          is_cdna, device) -> list:
    """Chain a batch of anchor sets (each (ax, ay) uint64, sorted by ax):
    one forward pass on `device` for all of them, then the oracle's tail.
    Returns (u, ax, ay) per job, as native.chain_dp gives them.  gap_scale
    is taken through a float cast, as the oracle's parameter is a float."""
    dev = resolve_device(device)
    empty = np.zeros(0, np.uint64)
    results = [(empty, empty, empty)] * len(jobs)
    live = [i for i, (ax, _) in enumerate(jobs) if len(ax)]
    if not live:
        return results
    gs = float(np.float32(gap_scale))
    cj = chain_jobs([jobs[i] for i in live], max_dist_x, min_dist_x,
                    max_iter, dev)
    fpv = chain_fwd(cj, max_dist_x, max_dist_y, bw, max_skip, is_cdna,
                    gs).cpu().numpy()
    off = cj.off.tolist()
    for b, i in enumerate(live):
        ax, ay = jobs[i]
        f, pre, v = fpv[:, off[b]:off[b + 1]]
        results[i] = native.chain_finish(f, pre, v, min_cnt, min_sc, ax, ay)
    return results


def chain_dp_auto(ax, ay, *, max_dist_x, min_dist_x, max_dist_y, bw,
                  max_skip, max_iter, min_cnt, min_sc, gap_scale, is_cdna,
                  n_segs=1, device, chain_min):
    """native.chain_dp with one-segment anchor sets of at least chain_min
    (> 0) anchors chained on `device`; the others on the host."""
    if n_segs == 1 and 0 < chain_min <= len(ax):
        return chain_dp_device_batch(
            [(ax, ay)], max_dist_x, min_dist_x, max_dist_y, bw, max_skip,
            max_iter, min_cnt, min_sc, gap_scale, is_cdna, device)[0]
    return native.chain_dp(
        ax, ay, max_dist_x=max_dist_x, min_dist_x=min_dist_x,
        max_dist_y=max_dist_y, bw=bw, max_skip=max_skip, max_iter=max_iter,
        min_cnt=min_cnt, min_sc=min_sc, gap_scale=gap_scale,
        is_cdna=is_cdna, n_segs=n_segs)
