"""P2: the state floor of a step on the card.  Each step reads and writes
`nstate` int8 lane arrays of Wb per job (only array 0 gets +1) and, with
`read_acc`, reads and bumps the job's 16 int32 accumulators; with `touch`
off a step does nothing.

Counterpart of tests/tools/probe_l0.py (the Pallas probe, pallas_call at
:55); its outputs are that probe's, exactly: res = KR in every column when
touch and read_acc, else 0.  The kernel (csrc/probes.cu, l0_kernel) keeps
the state as K1 and P3 keep theirs, in registers: a block a job, a thread
a 32-bit word (4 lanes) of each array, array 0's word taking a bytewise
+1 a step, threads 0-15 the accumulators.  The TPU grid's sequential step
axis is a loop of KR round trips inside the thread (no barrier: a step
has no cross-lane dependence), kept a loop by an empty asm on the values;
without touch the loop is empty, so "empty (no touch)" is the launch's
own floor.  Arrays 1 .. nstate - 1 never change and never enter the loop:
the "1/3/7 state arrays" cases differ only in their final stores, so they
read launch plus stores, and nstate no longer scales a step's work (the
Pallas probe's and l0_plain's round trip of every array).  The final state and res are outputs, stored a word a thread.
ROWS only scales the padded-cell unit (the TPU kernel has no row loop).
TB, the TPU's tile height, has no counterpart (one block per job): the
TPU script's four TB cases would repeat the "7 state arrays" and
"ROWS=64 KR=32" cases here, so the table leaves them out.

On the CPU, l0_plain runs (l0_probe and run with device="cpu"), and
tests/test_torch_probes_stub.py runs the CUDA source itself through
tools/cuda_stub; on the card, ``python -m
winnowmap_tpu_torch.tools.probe_l0`` and chip_smoke.py's phase 7.
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


def l0_outputs(qlen, nstate, Wb):
    """(res, state) of a launch on qlen's device, unwritten."""
    B, dev = qlen.shape[0], qlen.device
    return (torch.empty((B, 16), dtype=torch.int32, device=dev),
            torch.empty((nstate, B, Wb), dtype=torch.int8, device=dev))


def l0_launch(lib, res, state, touch, read_acc, KR, stream) -> int:
    """One launch of csrc/probes.cu's l0 kernel through `lib` (the card's
    library or the CUDA stub's); returns the entry's error code."""
    nstate, B, Wb = state.shape
    return lib.wm_probe_l0_launch(res.data_ptr(), state.data_ptr(), nstate,
                                  int(touch), int(read_acc), B, Wb, KR,
                                  stream)


def l0_probe(qlen, *, nstate=7, Wb=640, KR=63, touch=True, read_acc=True):
    """P2's wrapper: CUDA tensors launch csrc/probes.cu's l0 kernel, CPU
    tensors run l0_plain."""
    if qlen.device.type == "cpu":
        return l0_plain(qlen, nstate=nstate, Wb=Wb, KR=KR, touch=touch,
                        read_acc=read_acc)
    _check(qlen, nstate, Wb, KR)
    if Wb > 4096:
        raise ValueError("the kernel takes a thread a 4-lane word: Wb <= "
                         "4096")
    from ..extend import _build

    res, state = l0_outputs(qlen, nstate, Wb)
    tools.launch("probe_l0", l0_launch, _build.load_probes(), res, state,
                 touch, read_acc, KR)
    return res, state


# the card's L2 (H100: 50 MB): the outputs of graph_ms's train pass twice it
L2_BYTES = 50 << 20


def graph_ms(qlen, nstate, Wb, KR, touch, read_acc, reps) -> float:
    """ms a launch on the card with its stores written back to device
    memory: CUDA events over replays of a CUDA graph of launches, each into
    outputs of its own, the train's outputs twice the card's L2.  One
    launch's few MB of stores stay in the L2, so its kernel time alone can
    beat the memory rate; in the train each launch's stores are written
    back while the later launches run, and the graph runs the launches back
    to back (a wrapper call's host time is ~50 us, the kernel's a few).
    The kernel's module must be loaded (a launch made) before the capture.
    """
    from ..extend import _build

    _check(qlen, nstate, Wb, KR)
    lib = _build.load_probes()
    B = qlen.shape[0]
    per = 64 * B + nstate * B * Wb
    outs = [l0_outputs(qlen, nstate, Wb)
            for _ in range(-(-2 * L2_BYTES // per))]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for res, state in outs:
            tools.launch("probe_l0", l0_launch, lib, res, state, touch,
                         read_acc, KR, captured=True)
    ms = tools.time_ms(lambda: tools.replay("probe_l0", g, len(outs)),
                       torch.device("cuda"), reps)
    return ms / len(outs)


def run(nstate=7, Wb=640, ROWS=32, KR=63, B=512, touch=True, reps=3,
        read_acc=True, device=None) -> dict:
    """Times one case: ms per wrapper call and Gcells/s over padded cells
    (B * KR * ROWS * Wb); on the card also graph_ms, a launch's own time
    with its stores written back (graph_ms()): a call's few microseconds
    of kernel are below the wrapper's host time, which the events over a
    train of wrapper calls measure."""
    dev = resolve_device(device)
    qlen = torch.full((B, 1), 1000, dtype=torch.int32, device=dev)

    def call():
        return l0_probe(qlen, nstate=nstate, Wb=Wb, KR=KR, touch=touch,
                        read_acc=read_acc)

    ms = tools.time_ms(call, dev, reps)
    cells = B * KR * ROWS * Wb
    out = {"ms": ms, "gcells_padded": cells / ms / 1e6, "device": dev.type}
    if dev.type == "cuda":
        out["graph_ms"] = graph_ms(qlen, nstate, Wb, KR, touch, read_acc,
                                   max(reps, 5))
    return out


def main(argv=None, device=None):
    if resolve_device(device).type == "cuda":
        print(tools.card_line(), flush=True)
    for name, kv in cases:
        o = run(**kv, device=device)
        kern = (f", {o['graph_ms'] * 1e3:.2f} us a launch in a graph"
                if "graph_ms" in o else "")
        print(f"{name}: {o['gcells_padded']:7.2f} Gcells/s padded "
              f"({o['ms']:.3f} ms/call{kern}, {o['device']})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
