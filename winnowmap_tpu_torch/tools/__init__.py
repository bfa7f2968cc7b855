"""Cost probes of the extension-DP kernels on the card, the timing scripts,
and the two analysis tools of the reference's scripts/ directory
(extract_selected_reads, minimizer_dist).

Counterparts of the JAX package's Pallas probes: probe_bisect (P1, the
fixed cost of a step), probe_l0 (P2, the state floor) and probe_core (P3,
the ladder of stripped extd step kernels).  Each has a plain PyTorch
version and a hand-written CUDA kernel (csrc/probes.cu, built by
extend/_build.load_probes at first launch).  A wrapper launches the kernel
for CUDA tensors and counts the launch in LAUNCHES; for CPU tensors it runs
the plain version.  The entry points (run_level / run / main) take
device=None, which means the card, and raise without one; device="cpu"
times the plain versions on the host, for a rehearsal at a small shape.
There is no fallback: a failed build or launch raises.

    python -m winnowmap_tpu_torch.tools.probe_core [--variants] [--only=X]
    python -m winnowmap_tpu_torch.tools.probe_l0
    python -m winnowmap_tpu_torch.tools.probe_bisect [--only=X]
"""
from __future__ import annotations

import subprocess
import time

import torch

from ..device import count

# kernel launches on this process, by probe; chip_smoke.py zeroes them
# around the probes' entry points
LAUNCHES = {"probe_bisect": 0, "probe_l0": 0, "probe_core": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch(name: str, entry, *args, captured=False) -> None:
    """Calls a C launch entry of csrc/probes.cu on the current stream of
    the card; raises on a CUDA error, else counts the launch.  A launch
    `captured` into a CUDA graph runs only when the graph is replayed, so
    replay() counts it instead."""
    from ..extend import _build

    rc = entry(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({_build.probe_error_string(rc)})")
    if not captured:
        count(LAUNCHES, name)


def replay(name: str, graph, n: int) -> None:
    """Replays a CUDA graph of `n` captured launches of probe `name`, and
    counts them."""
    graph.replay()
    count(LAUNCHES, name, n)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, reps: int) -> float:
    """ms per call of fn after one warm-up call: CUDA events over `reps`
    calls on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps
