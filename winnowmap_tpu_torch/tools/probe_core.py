"""P3: where the extd kernel's row time goes on the card.  A ladder of
stripped-down step kernels, from the bare state round trip up to the full
recurrence, at K1's phase-2 shape (512 jobs, qlen 1000, band constant 501,
KR * ROWS = 2016 anti-diagonal rows).

Counterpart of tests/tools/probe_core.py (the Pallas probe, pallas_call at
:222); its outputs are that probe's, exactly.  Levels:
  0 rw       : read the 7 state arrays to int32, write back (traffic floor)
  1 core     : + the 5-channel max recurrence (no masks/bounds/dirs)
  2 masks    : + per-row band masks and boundary writes
  3 dirs     : + direction assembly + per-row dirs store
  4 approx   : + approx-max/z-drop bookkeeping (the H0 walk)
  5 slide    : + the between-step window roll
  6 qslide   : + the per-row unaligned query slice

The kernel (csrc/probes.cu, core_kernel) is built on K1's row structure:
one block of 128 threads per job, each thread a segment of consecutive
lanes, the rows in shared memory, a carry read, a barrier, the cells, a
second barrier per row.  From level 2 on only the 16-rounded band lanes
are computed, as K1 does; dirs rows are still written whole (0 outside the
band), as the probe's output holds them.  The TPU grid's sequential step
axis is a loop inside the block.  Level 4's masked lane reductions are the
direct reads of K1's approximate path.  The TPU's tile height TB and the
"parallel" grid semantics change no result and have no counterpart here:
the ``L6 parallel-b`` variant is gone.

Units: ms per call (CUDA events, after a warm-up), Gcells/s over padded
cells (B * KR * ROWS * Wb, the TPU script's unit) and over band cells, and
ns per anti-diagonal row, the call time over KR * ROWS times the waves of
blocks the card runs (occupancy * SMs).
"""
from __future__ import annotations

import functools
import sys

import torch

from .. import tools
from ..device import resolve_device

DIRS_MODES = ("none", "u8", "i32")

levels = {
    0: "rw state only      ",
    1: "+core recurrence   ",
    2: "+band masks        ",
    3: "+dirs assembly+store",
    4: "+approx bookkeeping ",
    5: "+window slide      ",
    6: "+query slice       ",
}
variants = [
    ("L0 nodirs          ", dict(level=0, dirs_mode="none")),
    ("L3 nodirs          ", dict(level=3, dirs_mode="none")),
    ("L6 nodirs          ", dict(level=6, dirs_mode="none")),
    ("L0 dirs i32-packed ", dict(level=0, dirs_mode="i32")),
    ("L3 dirs i32-packed ", dict(level=3, dirs_mode="i32")),
    ("L6 dirs i32-packed ", dict(level=6, dirs_mode="i32")),
    ("L6 ROWS=64         ", dict(level=6, ROWS=64, KR=32)),
    ("L0 i32 scratch     ", dict(level=0, s32=True)),
    ("L6 i32 scratch     ", dict(level=6, s32=True)),
    ("L6 i32 ROWS=64     ", dict(level=6, s32=True, ROWS=64, KR=32)),
]

NEG = -10**9


def _outputs(B, Wb, ROWS, KR, dirs_mode, s32, dev, fill):
    res = torch.zeros((B, 16), dtype=torch.int32, device=dev)
    new = torch.zeros if fill else torch.empty
    dirs = None
    if dirs_mode == "u8":
        dirs = new((KR * ROWS, B, Wb), dtype=torch.uint8, device=dev)
    elif dirs_mode == "i32":
        dirs = new((KR * ROWS // 4, B, Wb), dtype=torch.int32, device=dev)
    state = torch.empty((7, B, Wb), device=dev,
                        dtype=torch.int32 if s32 else torch.int8)
    return res, dirs, state


def _check(level, qbuf, qlen, Wb, ROWS, KR, dirs_mode):
    if level not in levels:
        raise ValueError(f"level {level} not in 0-6")
    if dirs_mode not in DIRS_MODES:
        raise ValueError(f"dirs_mode {dirs_mode!r} not in {DIRS_MODES}")
    if dirs_mode == "i32" and ROWS % 4:
        raise ValueError("dirs_mode 'i32' packs 4 rows a word: ROWS % 4 "
                         "must be 0")
    if not 1 <= ROWS <= 257 or KR < 1 or Wb < 1:
        raise ValueError("needs 1 <= ROWS <= 257 (the query slice reads "
                         "qbuf up to column ROWS - 2 + Wb), KR >= 1, Wb >= 1")
    B = qbuf.shape[0]
    if qbuf.dtype != torch.uint8 or qbuf.dim() != 2 or \
            qbuf.shape[1] < Wb + 256:
        raise ValueError("qbuf must be (B, >= Wb + 256) uint8")
    if qlen.dtype != torch.int32 or tuple(qlen.shape) != (B, 1):
        raise ValueError("qlen must be (B, 1) int32")
    if qlen.device != qbuf.device:
        raise ValueError("qbuf and qlen on different devices")


def core_plain(level, qbuf, qlen, *, Wb, ROWS, KR, dirs_mode="u8",
               s32=False, work=None):
    """The probe's step kernel as torch ops on int32, the state wrapped to
    int8 at each step's end (kept int32 under s32), on any device.  Returns
    (res (B, 16) int32: mx, H0, lH0t, done then zeros; dirs (KR*ROWS, B,
    Wb) uint8, (KR*ROWS/4, B, Wb) int32 rows packed 4 to a word, or None;
    state (7, B, Wb): u v x y x2 y2 s after the last step).  Dirs are
    written from level 3 on (zeros below).  `work`, a (B, 2) int64 tensor,
    receives each job's computed cells and rows: every lane of every row
    below level 2; from level 2 on the band lanes inside the window, and
    the rows with any, before the job sets done."""
    _check(level, qbuf, qlen, Wb, ROWS, KR, dirs_mode)
    dev = qbuf.device
    B = qbuf.shape[0]
    i32 = torch.int32
    sdt = i32 if s32 else torch.int8
    res, dirs, _ = _outputs(B, Wb, ROWS, KR, dirs_mode, s32, dev, True)
    state = torch.zeros((7, B, Wb), dtype=sdt, device=dev)
    acc = torch.zeros((4, B, 1), dtype=i32, device=dev)
    ql = qlen.to(i32)
    lanes = torch.arange(Wb, dtype=i32, device=dev).expand(B, Wb)
    lane0 = lanes == 0
    ncell = torch.full((B,), KR * ROWS * Wb, dtype=torch.int64, device=dev)
    nrow = torch.full((B,), KR * ROWS, dtype=torch.int64, device=dev)
    if level >= 2:
        ncell.zero_()
        nrow.zero_()
    if level >= 6:
        qblk = torch.roll(qbuf[:, :Wb + 256].to(i32), 7, dims=1)

    consts = {}

    def cst(v):  # made once: a new device scalar per use costs a copy
        if v not in consts:
            consts[v] = torch.tensor(v, dtype=i32, device=dev)
        return consts[v]

    def at(arr, idx):  # arr[idx] per job, NEG off the lanes
        ok = (idx >= 0) & (idx < Wb)
        got = arr.gather(1, idx.clamp(0, Wb - 1).long())
        return torch.where(ok, torch.maximum(got, cst(NEG)), cst(NEG))

    for k in range(KR):
        r0 = k * ROWS
        u, v, x, y, x2, y2, s = state.to(i32).unbind(0)
        if level >= 5 and r0 > 0:
            state = torch.where(lanes >= Wb - 16, torch.zeros((), dtype=sdt,
                                                              device=dev),
                                torch.roll(state, -16, dims=2))
        mx, H0, lH0t, done = acc.unbind(0)
        dpack = None
        for j in range(ROWS):
            r = r0 + j
            if level == 0:
                u = u + 1
                continue
            if level >= 6:
                qv = qblk[:, ROWS - 1 - j:ROWS - 1 - j + Wb]
                sc = torch.where(qv == s, cst(2), cst(-4))
            else:
                sc = s + 1
            band = None
            uu = u
            if level >= 2:
                st0 = torch.clamp(r - ql + 1, min=max(0, (r - 500) >> 1))
                en0 = torch.clamp(ql - 1, max=min(r, (r + 501) >> 1))
                st = torch.div(st0, 16, rounding_mode="floor") * 16
                en = torch.div(en0 + 16, 16, rounding_mode="floor") * 16 - 1
                band = (done == 0) & (lanes >= st) & (lanes <= en)
                ncell += band.sum(1)
                nrow += band.any(1)
                uu = torch.where(band & (lanes == r), cst(-6), u)
            xt1 = torch.where(lane0, cst(-6), torch.roll(x, 1, dims=1))
            x2t1 = torch.where(lane0, cst(-25), torch.roll(x2, 1, dims=1))
            vt1 = torch.where(lane0, cst(-6), torch.roll(v, 1, dims=1))
            a_, b_ = xt1 + vt1, y + uu
            a2_, b2_ = x2t1 + vt1, y2 + uu
            z = sc
            if level >= 3:
                d = torch.where(z > a_, cst(0), cst(1))
                z = torch.maximum(z, a_)
                d = torch.where(z > b_, d, cst(2))
                z = torch.maximum(z, b_)
                d = torch.where(z > a2_, d, cst(3))
                z = torch.maximum(z, a2_)
                d = torch.where(z > b2_, d, cst(4))
                z = torch.maximum(z, b2_)
            else:
                z = torch.maximum(torch.maximum(z, a_),
                                  torch.maximum(b_, a2_))
                z = torch.maximum(z, b2_)
            z = torch.clamp(z, max=2)
            u_new, v_new = z - vt1, z - uu
            zq, zq2 = z - 6, z - 25
            an, bn = a_ - zq, b_ - zq
            a2n, b2n = a2_ - zq2, b2_ - zq2
            x_new = torch.clamp(an, min=0) - 8
            y_new = torch.clamp(bn, min=0) - 8
            x2_new = torch.clamp(a2n, min=0) - 26
            y2_new = torch.clamp(b2n, min=0) - 26
            if level >= 3:
                d = (d | (an > 0).to(i32) * 8 | (bn > 0).to(i32) * 16
                     | (a2n > 0).to(i32) * 32 | (b2n > 0).to(i32) * 64)
                dv = d if band is None else torch.where(band, d, cst(0))
                if dirs_mode == "i32":
                    dpack = dv if j % 4 == 0 else dpack | (dv << (8 * (j % 4)))
                    if j % 4 == 3:
                        dirs[r // 4] = dpack
                elif dirs_mode == "u8":
                    dirs[r] = dv.to(torch.uint8)
            if band is not None:
                u = torch.where(band, u_new, uu)
                v = torch.where(band, v_new, v)
                x = torch.where(band, x_new, x)
                y = torch.where(band, y_new, y)
                x2 = torch.where(band, x2_new, x2)
                y2 = torch.where(band, y2_new, y2)
                s = torch.where(band, sc, s)
            else:
                u, v, x, y, x2, y2, s = (u_new, v_new, x_new, y_new, x2_new,
                                         y2_new, sc)
            if level >= 4:
                d0, d1 = at(v, lH0t), at(u, lH0t + 1)
                H0 = H0 + torch.maximum(d0, d1)
                lH0t = torch.where(d1 > d0, lH0t + 1, lH0t)
                better = H0 > mx
                mx = torch.where(better, H0, mx)
                done = torch.where(~better & (mx - H0 > 400), cst(1), done)
        state = torch.stack([u, v, x, y, x2, y2, s]).to(sdt)
        acc = torch.stack([mx, H0, lH0t, done])
    res[:, :4] = acc[:, :, 0].T
    if work is not None:
        work.copy_(torch.stack([ncell, nrow], 1))
    return res, dirs, state


def core_probe(level, qbuf, qlen, *, Wb, ROWS, KR, dirs_mode="u8",
               s32=False, work=None):
    """P3's wrapper: CUDA tensors launch csrc/probes.cu's core kernel,
    CPU tensors run core_plain.  Same outputs as core_plain; below level
    3 the kernel writes no dirs (the tensor is returned unwritten)."""
    if qbuf.device.type == "cpu":
        return core_plain(level, qbuf, qlen, Wb=Wb, ROWS=ROWS, KR=KR,
                          dirs_mode=dirs_mode, s32=s32, work=work)
    _check(level, qbuf, qlen, Wb, ROWS, KR, dirs_mode)
    if not (qbuf.is_contiguous() and qlen.is_contiguous()):
        raise ValueError("qbuf and qlen must be contiguous")
    if work is not None and (work.dtype != torch.int64 or tuple(
            work.shape) != (qbuf.shape[0], 2) or work.device != qbuf.device
            or not work.is_contiguous()):
        raise ValueError("work must be (B, 2) int64 on qbuf's device")
    from ..extend import _build

    B = qbuf.shape[0]
    res, dirs, state = _outputs(B, Wb, ROWS, KR, dirs_mode, s32,
                                qbuf.device, False)
    tools.launch("probe_core", _build.load_probes().wm_probe_core_launch,
                 level, DIRS_MODES.index(dirs_mode), int(s32),
                 qbuf.data_ptr(), qbuf.shape[1], qlen.data_ptr(),
                 res.data_ptr(), dirs.data_ptr() if dirs is not None else None,
                 state.data_ptr(),
                 work.data_ptr() if work is not None else None, B, Wb,
                 ROWS, KR)
    return res, dirs, state


def occupancy(level, Wb, dirs_mode="u8", s32=False) -> int:
    """Blocks of the core kernel one SM holds at once (CUDA occupancy)."""
    import ctypes

    from ..extend import _build

    n = ctypes.c_int(0)
    rc = _build.load_probes().wm_probe_core_occupancy(
        level, DIRS_MODES.index(dirs_mode), int(s32), Wb, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {rc} "
                           f"({_build.probe_error_string(rc)})")
    return n.value


def build(level, Wb, ROWS, KR, dirs_mode="u8", s32=False):
    """The probe at one level and shape: a function (qbuf, qlen) -> (res,
    dirs, state) through core_probe."""
    return functools.partial(core_probe, level, Wb=Wb, ROWS=ROWS, KR=KR,
                             dirs_mode=dirs_mode, s32=s32)


def run_level(level, B=512, Wb=640, ROWS=32, KR=63, reps=3,
              dirs_mode="u8", s32=False, device=None) -> dict:
    """Times one level at the TPU script's inputs (qbuf zeros, qlen 1000):
    ms per call, Gcells/s padded and over the band cells the probe
    computed, and on the card ns per anti-diagonal row and per active row
    (the band leaves the Wb-lane window near row 1640, and from level 4 on
    the jobs set done part way) and the waves of blocks that took."""
    dev = resolve_device(device)
    qbuf = torch.zeros((B, Wb + 384), dtype=torch.uint8, device=dev)
    qlen = torch.full((B, 1), 1000, dtype=torch.int32, device=dev)
    f = build(level, Wb, ROWS, KR, dirs_mode=dirs_mode, s32=s32)
    work = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    ms = tools.time_ms(lambda: f(qbuf, qlen, work=work), dev, reps)
    cells = B * KR * ROWS * Wb
    band = int(work[:, 0].sum())
    rows = int(work[:, 1].max())
    out = {"level": level, "dirs_mode": dirs_mode, "s32": s32, "B": B,
           "Wb": Wb, "ROWS": ROWS, "KR": KR, "ms": ms,
           "cells_padded": cells, "cells_band": band, "rows_active": rows,
           "gcells_padded": cells / ms / 1e6, "gcells_band": band / ms / 1e6,
           "device": dev.type}
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        waves = -(-B // (occupancy(level, Wb, dirs_mode, s32) * sms))
        out["waves"] = waves
        out["ns_per_row"] = ms * 1e6 / (KR * ROWS * waves)
        out["ns_per_active_row"] = ms * 1e6 / (rows * waves)
    return out


def _line(name, o) -> str:
    row = (f", {o['ns_per_row']:.1f} ns/row, {o['ns_per_active_row']:.1f} "
           f"ns/active row ({o['rows_active']} rows, {o['waves']} wave(s))"
           if "ns_per_row" in o else f" ({o['device']}, plain)")
    return (f"{name}: {o['ms']:.3f} ms/call, {o['gcells_padded']:7.2f} "
            f"Gcells/s padded, {o['gcells_band']:7.2f} band{row}")


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    only = None
    for a in argv:
        if a.startswith("--only="):
            only = a.split("=", 1)[1]
    if resolve_device(device).type == "cuda":
        print(tools.card_line(), flush=True)
    if "--variants" in argv:
        for name, kv in variants:
            if only and only not in name:
                continue
            print(_line(name, run_level(**kv, device=device)), flush=True)
        return
    for lv, name in levels.items():
        if only is not None and int(only) != lv:
            continue
        print(_line(f"L{lv} {name}", run_level(lv, device=device)),
              flush=True)


if __name__ == "__main__":
    main()
