"""Weighted-minimizer sketching with the per-base work on the device.

Counterpart of winnowmap_tpu/sketch/device.py for PyTorch and CUDA
(reference src/sketch.c:128-219 with applyWeight, :70-89; host oracle
native/src/wm_sketch.cpp).  S1 (csrc/sketch.cu) computes for each base of
the (HPC-compacted) code string the JAX package's per-base transform
(forward and reverse k-mers, canonical k-mer and strand, the symmetric
flag, the MurmurHash3 finalizer, the invertible key mix) and then what the
JAX package does with it on the host: the down-weight membership of the
canonical k-mer (the sorted set, or the bloom table in --bloom-filter
mode) and the IEEE-double selection order.  It sends back only what the
winnowing automaton (native.winnow, on the host) reads: the key, the order
and a flags byte z | sym << 1.  So the minimizers equal native.sketch's
exactly.

sketch_records sketches many records in one launch: their codes go into
one buffer with k - 1 ambiguous codes before each record (a position
before a record's start contributes 0, so the pad keeps the records
apart), the outputs come back in one copy into pinned memory, and the
automaton runs on each record's slice, the records in threads.
sketch_device is the one-record entry point.  HPC compaction stays on the
host.

S1 has
  * a wrapper, sketch, that launches the kernel for CUDA tensors and counts
    the launch in LAUNCHES, and uses the plain version only for tensors on
    the CPU;
  * a plain PyTorch version, sketch_plain: transform_plain in int64 (a
    product wraps as u64's does, and every right shift is masked, as torch
    has no logical right shift on int64), the membership by
    torch.searchsorted or the bloom probes in int64, the order in float64.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..device import count, resolve_device
from ..io.seqcode import encode

# kernel launches on this process; chip_smoke.py zeroes them around the
# main path to show it went through the kernel
LAUNCHES = {"sketch": 0}

_EMPTY = np.zeros(0, np.uint64)


def reset_launches() -> None:
    LAUNCHES["sketch"] = 0


def _i64(c: int) -> int:
    """A u64 constant as the int64 with its bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _i64(0xFF51AFD7ED558CCD)
_M2 = _i64(0xC4CEB9FE1A85EC53)
_U32 = 0xFFFFFFFF


def _shr(t: torch.Tensor, s: int) -> torch.Tensor:
    """The logical right shift of int64 bits."""
    return (t >> s) & ((1 << (64 - s)) - 1)


@dataclass
class Weights:
    """The down-weighted k-mers on a device: the sorted set (the int64 bits
    of u64 canonical k-mers; empty: none) or, in --bloom-filter mode, the
    bloom table of `bits` bits and its two salts."""
    wset: torch.Tensor
    bloom: torch.Tensor | None = None
    bits: int = 0
    salts: tuple = (0, 0)


def weights_on(wset, bloom, device) -> Weights:
    """The sorted set `wset` (u64) or the bloom tuple (table, bits, salt0,
    salt1) of index/build.py, uploaded to `device`."""
    dev = torch.device(device)
    if bloom is not None:
        table, bits, s0, s1 = bloom
        return Weights(torch.zeros(0, dtype=torch.int64, device=dev),
                       torch.from_numpy(np.ascontiguousarray(
                           table, np.uint8)).to(dev), int(bits),
                       (int(s0), int(s1)))
    ws = _EMPTY if wset is None else np.ascontiguousarray(wset, np.uint64)
    return Weights(torch.from_numpy(ws.view(np.int64)).to(dev))


def transform_plain(codes: torch.Tensor, k: int):
    """The per-base transform in plain PyTorch: codes (n,) uint8 0..4 ->
    key, h, canon (n,) int64 holding u64 bits, z and sym (n,) uint8."""
    c = codes.to(torch.int64)
    valid = c < 4
    cc = torch.where(valid, c, 0)
    rc = torch.where(valid, 3 ^ c, 0)
    n = len(c)
    f = torch.zeros(n, dtype=torch.int64, device=c.device)
    r = torch.zeros_like(f)
    for j in range(min(k, n)):
        # c[i - j] contributes << 2j to f_i, (3 ^ c[i - j]) << 2(k-1-j) to r_i
        f[j:] += cc[:n - j] << (2 * j)
        r[j:] += rc[:n - j] << (2 * (k - 1 - j))
    canon = torch.minimum(f, r)  # both below 2^56: signed order is u64's
    h = canon ^ _shr(canon, 33)
    h = h * _M1
    h = h ^ _shr(h, 33)
    h = h * _M2
    h = h ^ _shr(h, 33)
    mask = (1 << (2 * k)) - 1
    key = (~canon + (canon << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    z = (f >= r).to(torch.uint8)
    sym = (f == r).to(torch.uint8)
    return key, h, z, sym, canon


def _hash_ap(canon: torch.Tensor, salt: int) -> torch.Tensor:
    """wm_bloom.cpp's hash_ap round on the 8 little-endian bytes, in u32
    arithmetic held in int64."""
    i1 = canon & _U32
    i2 = _shr(canon, 32)
    h = torch.full_like(canon, salt)
    t = ((h << 7) & _U32) ^ ((i1 * (h >> 3)) & _U32) ^ (
        ~((h << 11) + (i2 ^ (h >> 5))) & _U32)
    return h ^ t


def flagged_plain(canon: torch.Tensor, wt: Weights) -> torch.Tensor:
    """Which canonical k-mers are down-weighted: both bloom probes set in
    --bloom-filter mode, else an entry of the sorted set equal to it."""
    if wt.bloom is not None:
        out = torch.ones_like(canon, dtype=torch.bool)
        table = wt.bloom.to(torch.int64)
        for salt in wt.salts:
            b = _hash_ap(canon, salt) % wt.bits
            out &= ((table[b >> 3] >> (b & 7)) & 1) == 1
        return out
    if len(wt.wset) == 0:
        return torch.zeros_like(canon, dtype=torch.bool)
    idx = torch.searchsorted(wt.wset, canon).clamp_(max=len(wt.wset) - 1)
    return wt.wset[idx] == canon


def order_plain(h: torch.Tensor, flagged: torch.Tensor) -> torch.Tensor:
    """The oracle's weight_order in float64: x = h * 1.0 / UINT64_MAX (the
    u64 rounded to a double once: its high and low halves are exact, so
    their sum rounds once), -x, or -(p4 * p4) with p2 = x * x, p4 = p2 *
    p2 where flagged."""
    hd = _shr(h, 32).to(torch.float64) * 4294967296.0 \
        + (h & _U32).to(torch.float64)
    x = hd / 18446744073709551616.0
    p2 = x * x
    p4 = p2 * p2
    return torch.where(flagged, -(p4 * p4), -x)


def sketch_plain(codes: torch.Tensor, k: int, wt: Weights):
    """S1's function in plain PyTorch: codes (n,) uint8 -> key (n,) int64
    holding u64 bits, ordv (n,) float64, flags (n,) uint8 (z | sym << 1)."""
    key, h, z, sym, canon = transform_plain(codes, k)
    ordv = order_plain(h, flagged_plain(canon, wt))
    return key, ordv, z | (sym << 1)


def sketch_launch(lib, codes, k: int, wt: Weights, key, ordv, flags,
                  stream) -> int:
    """S1's C entry on codes (n,) uint8 into key (n,) int64, ordv (n,)
    float64 and flags (n,) uint8.  Returns the CUDA error code."""
    bloom = None if wt.bloom is None else wt.bloom.data_ptr()
    return lib.wm_sketch_launch(codes.data_ptr(), codes.numel(), k,
                                wt.wset.data_ptr(), wt.wset.numel(), bloom,
                                wt.bits, wt.salts[0], wt.salts[1],
                                key.data_ptr(), ordv.data_ptr(),
                                flags.data_ptr(), stream)


def sketch(codes: torch.Tensor, k: int, wt: Weights, out=None):
    """S1 for a CUDA tensor (the plain version for a CPU tensor): as
    sketch_plain, written into `out` = (key, ordv, flags) when given."""
    dev = codes.device
    if dev.type == "cpu":
        res = sketch_plain(codes, k, wt)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    if not codes.is_cuda or not codes.is_contiguous() \
            or codes.dtype != torch.uint8:
        raise ValueError("codes must be a contiguous CUDA uint8 tensor")
    if not 0 < k <= 28:
        raise ValueError(f"k = {k} is outside 1..28")
    if wt.wset.device != dev or (wt.bloom is not None
                                 and wt.bloom.device != dev):
        raise ValueError("the weights must be on the codes' device")
    from ..extend import _build

    n = codes.numel()
    if codes.data_ptr() % 16:
        codes = codes.clone()  # the kernel reads 16-byte vectors
    if out is None:
        out = (torch.empty(n, dtype=torch.int64, device=dev),
               torch.empty(n, dtype=torch.float64, device=dev),
               torch.empty(n, dtype=torch.uint8, device=dev))
    key, ordv, flags = out
    if any(t.device != dev or not t.is_contiguous() or t.numel() != n
           or t.data_ptr() % 16 for t in out) \
            or (key.dtype, ordv.dtype, flags.dtype) != (
                torch.int64, torch.float64, torch.uint8):
        raise ValueError("out must be contiguous (n,) int64, float64 and "
                         "uint8 tensors on the codes' device, each on a "
                         "16-byte boundary")
    rc = sketch_launch(_build.load(), codes, k, wt, key, ordv, flags,
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    count(LAUNCHES, "sketch")
    return out


def compact_hpc(codes: np.ndarray):
    """Homopolymer compaction of a record's codes: runs of one valid base
    become their first base (ambiguous bases stay: they reset the window).
    Returns the kept codes, each one's run length (skip_len) and the
    position of its run's last base (the reference reports the run's
    end)."""
    n = len(codes)
    prev = np.concatenate([[255], codes[:-1]])
    keep = (codes != prev) | (codes >= 4)
    pos_all = np.nonzero(keep)[0]
    run_end = np.concatenate([pos_all[1:], [n]])
    return (codes[pos_all], (run_end - pos_all).astype(np.int64),
            (run_end - 1).astype(np.int64))


class _Clock:
    """Seconds by stage into `stages` (None: no timing and no extra
    synchronisation)."""

    def __init__(self, stages, dev):
        self.stages, self.dev = stages, dev
        self.t = time.perf_counter()

    def __call__(self, name):
        if self.stages is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + t - self.t
        self.t = t


def sketch_records(codes_list, w: int, k: int, rids, is_hpc: bool,
                   wt: Weights, stages: dict | None = None):
    """Sketch records (each (n,) uint8 codes 0..4) with one S1 launch on
    wt's device and the automaton on the host.  Returns a list of (x, y)
    uint64 arrays, each equal to native.sketch's for its record.  With
    `stages`, adds each stage's host seconds to it (compact, upload, s1,
    copy_back, automaton), synchronising between them."""
    out = [(_EMPTY, _EMPTY)] * len(codes_list)
    if w <= 0 or w >= 256 or k <= 0 or k > 28:
        return out
    dev = wt.wset.device
    clock = _Clock(stages, dev)
    parts = [compact_hpc(c) if is_hpc else (c, None, None)
             for c in codes_list]
    clock("compact")
    if not any(len(c) for c, _, _ in parts):
        return out
    # each record after k - 1 codes of 4
    lens = np.array([len(c) for c, _, _ in parts], np.int64)
    starts = np.cumsum(lens + (k - 1)) - lens
    n = int(starts[-1] + lens[-1])
    pin = dev.type == "cuda"
    host = torch.empty(n, dtype=torch.uint8, pin_memory=pin)
    hn = host.numpy()
    hn.fill(4)
    for (c, _, _), s in zip(parts, starts.tolist()):
        hn[s:s + len(c)] = c
    codes = host.to(dev, non_blocking=True)
    clock("upload")
    # key, ordv and flags in one buffer, each on a 16-byte boundary, so
    # they come back in one copy
    m = -(-n // 16) * 16
    buf = torch.empty(17 * m, dtype=torch.uint8, device=dev)
    sketch(codes, k, wt, (buf[:8 * m].view(torch.int64)[:n],
                          buf[8 * m:16 * m].view(torch.float64)[:n],
                          buf[16 * m:16 * m + n]))
    clock("s1")
    if pin:
        back = torch.empty(17 * m, dtype=torch.uint8, pin_memory=True)
        back.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
    else:
        back = buf
    clock("copy_back")
    b = back.numpy()
    key = b[:8 * m].view(np.uint64)
    ordv = b[8 * m:16 * m].view(np.float64)
    flags = b[16 * m:17 * m]

    def winnow(i):
        (c, skip, pos), s = parts[i], int(starts[i])
        e = s + len(c)
        return native.winnow(c, key[s:e], flags[s:e], ordv[s:e], w, k,
                             rids[i], is_hpc, skip, pos)

    # the automaton is sequential along a record; records run in threads
    # (ctypes releases the GIL)
    todo = [i for i, (c, _, _) in enumerate(parts) if len(c)]
    native.lib()  # loaded once, before the threads
    with ThreadPoolExecutor(min(len(todo), os.cpu_count() or 1)) as pool:
        for i, res in zip(todo, pool.map(winnow, todo)):
            out[i] = res
    clock("automaton")
    return out


def sketch_device(seq: bytes, w: int, k: int, rid: int, is_hpc: bool,
                  wset: np.ndarray, bloom=None, device=None,
                  stages: dict | None = None):
    """Sketch one sequence with S1 on `device` (None: the card) and the
    automaton on the host.  Returns (x, y) uint64 arrays equal to
    native.sketch's.  `stages` as sketch_records', with the encode."""
    if len(seq) <= 0 or w <= 0 or w >= 256 or k <= 0 or k > 28:
        return _EMPTY, _EMPTY
    dev = resolve_device(device)
    clock = _Clock(stages, dev)
    codes = encode(seq)
    clock("encode")
    wt = weights_on(wset, bloom, dev)
    return sketch_records([codes], w, k, [rid], is_hpc, wt, stages)[0]
