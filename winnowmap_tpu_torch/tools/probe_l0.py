"""P2: the state floor of a step on the card.  Each step reads and writes
`nstate` int8 lane arrays of Wb per job (only array 0 gets +1) and, with
`read_acc`, reads and bumps the job's 16 int32 accumulators; with `touch`
off a step does nothing.

Counterpart of tests/tools/probe_l0.py (the Pallas probe, pallas_call at
:55); its outputs are that probe's, exactly: res = KR in every column when
touch and read_acc, else 0.  The kernel (csrc/probes.cu, l0_kernel) runs
one block of 128 threads per job with the state in shared memory; the
TPU grid's sequential step axis is a loop inside the block, one barrier a
step, and the state is read and written through volatile accesses so
that every step's round trip stays in the code.  The final state is an
output.  ROWS only scales the padded-cell unit (the TPU kernel has no row
loop).  TB, the TPU's tile height, has no counterpart (one block per job):
the TPU script's four TB cases would repeat the "7 state arrays" and
"ROWS=64 KR=32" cases here, so the table leaves them out.
"""
from __future__ import annotations

import sys

import torch

from .. import tools
from ..device import resolve_device

cases = [
    ("empty (no touch)        ", dict(touch=False)),
    ("acc only (0 state)      ", dict(nstate=0)),
    ("1 state array           ", dict(nstate=1)),
    ("3 state arrays          ", dict(nstate=3)),
    ("7 state arrays (=L0)    ", dict(nstate=7)),
    ("7 state no-acc-read     ", dict(nstate=7, read_acc=False)),
    ("7 state ROWS=64 KR=32   ", dict(nstate=7, ROWS=64, KR=32)),
    ("7 state ROWS=128 KR=16  ", dict(nstate=7, ROWS=128, KR=16)),
]


def _check(qlen, nstate, Wb, KR):
    if qlen.dtype != torch.int32 or qlen.dim() != 2 or qlen.shape[1] != 1:
        raise ValueError("qlen must be (B, 1) int32")
    if not 0 <= nstate <= 7 or Wb < 1 or KR < 1:
        raise ValueError("needs 0 <= nstate <= 7, Wb >= 1, KR >= 1")


def l0_plain(qlen, *, nstate=7, Wb=640, KR=63, touch=True, read_acc=True):
    """The probe's steps as torch ops, on any device.  Returns (res (B, 16)
    int32, state (nstate, B, Wb) int8)."""
    _check(qlen, nstate, Wb, KR)
    B, dev = qlen.shape[0], qlen.device
    state = torch.zeros((nstate, B, Wb), dtype=torch.int8, device=dev)
    acc = torch.zeros((B, 16), dtype=torch.int32, device=dev)
    for _ in range(KR):
        if not touch:
            continue
        vals = state.to(torch.int32)
        if nstate:
            vals[0] += 1
        state = vals.to(torch.int8)
        if read_acc:
            acc = acc + 1
    return acc, state


def l0_probe(qlen, *, nstate=7, Wb=640, KR=63, touch=True, read_acc=True):
    """P2's wrapper: CUDA tensors launch csrc/probes.cu's l0 kernel, CPU
    tensors run l0_plain."""
    if qlen.device.type == "cpu":
        return l0_plain(qlen, nstate=nstate, Wb=Wb, KR=KR, touch=touch,
                        read_acc=read_acc)
    _check(qlen, nstate, Wb, KR)
    from ..extend import _build

    B = qlen.shape[0]
    res = torch.empty((B, 16), dtype=torch.int32, device=qlen.device)
    state = torch.empty((nstate, B, Wb), dtype=torch.int8,
                        device=qlen.device)
    tools.launch("probe_l0", _build.load_probes().wm_probe_l0_launch,
                 res.data_ptr(), state.data_ptr(), nstate, int(touch),
                 int(read_acc), B, Wb, KR)
    return res, state


def run(nstate=7, Wb=640, ROWS=32, KR=63, B=512, touch=True, reps=3,
        read_acc=True, device=None) -> dict:
    """Times one case: ms per call and Gcells/s over padded cells
    (B * KR * ROWS * Wb)."""
    dev = resolve_device(device)
    qlen = torch.full((B, 1), 1000, dtype=torch.int32, device=dev)
    ms = tools.time_ms(lambda: l0_probe(qlen, nstate=nstate, Wb=Wb, KR=KR,
                                        touch=touch, read_acc=read_acc),
                       dev, reps)
    cells = B * KR * ROWS * Wb
    return {"ms": ms, "gcells_padded": cells / ms / 1e6,
            "device": dev.type}


def main(argv=None, device=None):
    if resolve_device(device).type == "cuda":
        print(tools.card_line(), flush=True)
    for name, kv in cases:
        o = run(**kv, device=device)
        print(f"{name}: {o['gcells_padded']:7.2f} Gcells/s padded "
              f"({o['ms']:.3f} ms/call, {o['device']})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
