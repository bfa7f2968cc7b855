"""P1: the fixed cost of a step on the card, bisected into tiny step bodies
(run at KR = 16).  Prints us per (step, tile), where a tile is TB jobs: TB
is the TPU's tile height, kept only as that divisor (one block per job
here).

Counterpart of tests/tools/probe_bisect.py (the Pallas probe, pallas_call
at :48); its outputs are that probe's, exactly where that probe defines
them: res changes only under `reduces`, dirs are written only by
`dirs_store` (rows 0-31 of each step, so ROWS >= 32), and the state of 7
int8 lane arrays per job only by the rw bodies and `rolls`.

The kernel (csrc/probes.cu, bisect_kernel<BODY>) runs one block of 128
threads per job, the state in shared memory, the TPU grid's sequential
step axis as a loop inside the block with one barrier a step.  A lane roll
is a neighbour exchange of register segments (a shuffle inside a warp,
shared memory across warps); the masked lane reduction is a block-wide
max reduction, as K1's row max does it.  The final state is an output.
"""
from __future__ import annotations

import sys

import torch

from .. import tools
from ..device import resolve_device

NEG = -10**9
N_SCR = 7


def empty(k, state, t, dirs, ROWS):
    return state, t


def rw_astype(k, state, t, dirs, ROWS):
    return (state.to(torch.int32) + 1).to(torch.int8), t


def rw_i8(k, state, t, dirs, ROWS):
    return state + 1, t


def rw_loop32(k, state, t, dirs, ROWS):
    vals = state.to(torch.int32)
    for _ in range(32):
        vals = vals + 1
    return vals.to(torch.int8), t


def dirs_store(k, state, t, dirs, ROWS):
    v = state[0].to(torch.int32)
    for j in range(32):
        dirs[k * ROWS + j] = (v + j).to(torch.uint8)
    return state, t


def rolls(k, state, t, dirs, ROWS):
    v = state[0].to(torch.int32)
    for _ in range(32):
        v = torch.roll(v, 1, dims=1) + 1
    state = state.clone()
    state[0] = v.to(torch.int8)
    return state, t


def reduces(k, state, t, dirs, ROWS):
    v = state[0].to(torch.int32)
    lanes = torch.arange(v.shape[1], dtype=torch.int32, device=v.device)
    neg = torch.tensor(NEG, dtype=torch.int32, device=v.device)
    for _ in range(32):
        t = t + torch.where(lanes == t, v, neg).max(1, keepdim=True).values
    return state, t


BODIES = (empty, rw_astype, rw_i8, rw_loop32, dirs_store, rolls, reduces)
variants = [
    ("empty body                 ", empty, {}),
    ("rw 7 scratch +astype       ", rw_astype, {}),
    ("rw 7 scratch pure i8       ", rw_i8, {}),
    ("rw 7 + 32x i32 adds        ", rw_loop32, {}),
    ("32x dirs row store         ", dirs_store, {}),
    ("32x lane roll (1 array)    ", rolls, {}),
    ("32x masked reduce (1 array)", reduces, {}),
    ("empty, no dirs out         ", empty, dict(with_dirs=False)),
]


def _check(body, qlen, Wb, ROWS, KR):
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}")
    if qlen.dtype != torch.int32 or qlen.dim() != 2 or qlen.shape[1] != 1:
        raise ValueError("qlen must be (B, 1) int32")
    if Wb < 1 or KR < 1 or ROWS < 1:
        raise ValueError("needs Wb, ROWS, KR >= 1")
    if body is dirs_store and ROWS < 32:
        raise ValueError("dirs_store writes 32 rows a step: ROWS >= 32")


def bisect_plain(body, qlen, *, Wb=640, ROWS=32, KR=16, with_dirs=True):
    """The probe's steps with one body, as torch ops on any device.
    Returns (res (B, 16) int32, dirs (KR*ROWS, B, Wb) uint8 or None,
    state (7, B, Wb) int8).  Dirs rows the body does not write are 0."""
    _check(body, qlen, Wb, ROWS, KR)
    B, dev = qlen.shape[0], qlen.device
    if body is dirs_store and not with_dirs:
        raise ValueError("dirs_store needs the dirs output")
    state = torch.zeros((N_SCR, B, Wb), dtype=torch.int8, device=dev)
    t = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    dirs = (torch.zeros((KR * ROWS, B, Wb), dtype=torch.uint8, device=dev)
            if with_dirs else None)
    for k in range(KR):
        state, t = body(k, state, t, dirs, ROWS)
    res = torch.zeros((B, 16), dtype=torch.int32, device=dev)
    res[:, :1] = t
    return res, dirs, state


def bisect_outputs(qlen, Wb, ROWS, KR, with_dirs=True):
    """(res, dirs or None, state) of a launch on qlen's device, unwritten."""
    B, dev = qlen.shape[0], qlen.device
    return (torch.empty((B, 16), dtype=torch.int32, device=dev),
            torch.empty((KR * ROWS, B, Wb), dtype=torch.uint8, device=dev)
            if with_dirs else None,
            torch.empty((N_SCR, B, Wb), dtype=torch.int8, device=dev))


def bisect_launch(lib, body, res, dirs, state, ROWS, KR, stream) -> int:
    """One launch of csrc/probes.cu's bisect kernel for `body` through `lib`
    (the card's library or the CUDA stub's); returns the entry's error
    code."""
    _, B, Wb = state.shape
    return lib.wm_probe_bisect_launch(
        BODIES.index(body), res.data_ptr(),
        dirs.data_ptr() if dirs is not None else None, state.data_ptr(), B,
        Wb, ROWS, KR, stream)


def bisect_probe(body, qlen, *, Wb=640, ROWS=32, KR=16, with_dirs=True):
    """P1's wrapper: CUDA tensors launch csrc/probes.cu's bisect kernel for
    the body, CPU tensors run bisect_plain.  The kernel leaves the dirs
    rows its body does not write unwritten."""
    if qlen.device.type == "cpu":
        return bisect_plain(body, qlen, Wb=Wb, ROWS=ROWS, KR=KR,
                            with_dirs=with_dirs)
    _check(body, qlen, Wb, ROWS, KR)
    if body is rolls and Wb > 1024:
        raise ValueError("rolls keeps a thread's lanes in registers: "
                         "Wb <= 1024")
    if body is dirs_store and not with_dirs:
        raise ValueError("dirs_store needs the dirs output")
    from ..extend import _build

    res, dirs, state = bisect_outputs(qlen, Wb, ROWS, KR, with_dirs)
    tools.launch("probe_bisect", bisect_launch, _build.load_probes(), body,
                 res, dirs, state, ROWS, KR)
    return res, dirs, state


def run(tag, body, B=512, TB=64, Wb=640, ROWS=32, KR=16, with_dirs=True,
        reps=3, device=None) -> dict:
    """Times one body: ms per call and us per (step, tile), a tile being TB
    jobs; prints one line."""
    dev = resolve_device(device)
    qlen = torch.full((B, 1), 1000, dtype=torch.int32, device=dev)
    ms = tools.time_ms(lambda: bisect_probe(body, qlen, Wb=Wb, ROWS=ROWS,
                                            KR=KR, with_dirs=with_dirs),
                       dev, reps)
    per = ms * 1e3 / (B // TB * KR)
    print(f"{tag}: {per:7.2f} us/(step,tile)  ({ms:.3f} ms/call, "
          f"{dev.type})", flush=True)
    return {"ms": ms, "us_per_step_tile": per, "device": dev.type}


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    only = None
    for a in argv:
        if a.startswith("--only="):
            only = a.split("=", 1)[1]
    if resolve_device(device).type == "cuda":
        print(tools.card_line(), flush=True)
    for tag, body, kv in variants:
        if only and only not in tag:
            continue
        run(tag, body, **kv, device=device)


if __name__ == "__main__":
    main()
