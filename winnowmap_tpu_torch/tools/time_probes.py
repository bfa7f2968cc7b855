"""P3 (the extension-row cost ladder) and P2 (the step-state floor) of
csrc/probes.cu timed on the card, and the step loop of P2's kernel in its
SASS.

    python winnowmap_tpu_torch/tools/time_probes.py [--root DIR] [--reps N]
        [--out DIR]

--root is the checkout whose port is timed (default: this one): a `git
archive` of another commit unpacked elsewhere times that commit's probes
through its own wrappers, so two commits compare in one call on one card
(run them in turns: parent, change, change, parent), as time_kc_chain.py
and time_sketch.py do.  First the checkout's P3 (every case of
tools/check.py at its small shape, level 6 u8 at the full shape) and P2
(every case) are held to their plain versions.  Then a memset of P3's
dirs bytes (the card's own write rate); P3 level 6 u8 at (512, 640, 32,
63); the ladder at that depth and at 9 steps (288 rows, before any job
sets done); every P2 case by its kernel's own time (torch.profiler; "not measured"
where the profiler sees none) and by CUDA events over wrapper calls.  It prints the card's name and power
limit, a line a timing, the loops of the l0 kernel's SASS (cuobjdump),
and one JSON line; --out DIR also writes the JSON to
DIR/time_probes.json and the l0 kernel's SASS to DIR/l0_sass.txt.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

SHORT_KR = 9  # 288 rows: at the timed inputs no job has set done


def sass_function(lib_path: Path, pat: str) -> list:
    """The SASS lines of the one kernel of a built library whose mangled
    name matches `pat`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(ln.rstrip())
    names = [n for n in funcs if re.search(pat, n)]
    if len(names) != 1:
        raise RuntimeError(f"SASS: {len(names)} functions match {pat}")
    return funcs[names[0]]


def loops(lines: list) -> list:
    """The backward branches of a function's SASS (cuobjdump gives a
    branch's target as an address): each loop's lines, from its target to
    the branch back to it."""
    addr = [re.search(r"/\*([0-9a-f]{4,})\*/", ln) for ln in lines]
    addr = [int(m.group(1), 16) if m else None for m in addr]
    found = []
    for i, ln in enumerate(lines):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ln)
        if m and addr[i] is not None and int(m.group(1), 16) < addr[i]:
            lo = int(m.group(1), 16)
            found.append([x.strip() for x, a in zip(lines[:i + 1],
                                                    addr[:i + 1])
                          if a is not None and a >= lo])
    return found


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="a directory for the JSON and the SASS")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_probes needs a CUDA card")
    from winnowmap_tpu_torch import tools
    from winnowmap_tpu_torch.extend import _build
    from winnowmap_tpu_torch.tools import check as PC
    from winnowmap_tpu_torch.tools import probe_core as P3
    from winnowmap_tpu_torch.tools import probe_l0 as P2
    from winnowmap_tpu_torch.tools.time_kc_chain import by_kernel

    dev = torch.device("cuda")
    out = {"root": str(args.root), "card": tools.card_line()}
    print(out["card"], flush=True)

    # the kernels against their plain versions first
    qbuf, qlen = PC.small_inputs(dev)
    err = max(PC.check_core(qbuf, qlen, *c) for c in PC.core_cases())
    full = PC.small_inputs(dev, B=512, Wb=640, ROWS=32, KR=63)
    err = max(err, PC.check_core(*full, 6, "u8", False, Wb=640, ROWS=32,
                                 KR=63))
    err = max(err, max(PC.check_l0(qlen, kv) for _, kv in P2.cases))
    torch.cuda.synchronize()
    print(f"P3 and P2 against plain: max error {err}", flush=True)
    if err:
        sys.exit("kernel != plain")

    l0 = sass_function(_build.build(_build.PROBE_SOURCES)["probes.cu"],
                       r"l0_kernel")
    out["l0_sass"] = {"instructions": sum(1 for ln in l0 if "/*" in ln),
                      "loops": loops(l0)}
    print(f"SASS l0_kernel: {out['l0_sass']['instructions']} instructions, "
          f"{len(out['l0_sass']['loops'])} loop(s):", flush=True)
    for lp in out["l0_sass"]["loops"]:
        print("  " + "\n  ".join(lp), flush=True)

    nbytes = 512 * 640 * 32 * 63  # P3's u8 dirs at the timed shape
    zeros = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = tools.time_ms(zeros.zero_, dev, args.reps)
    del zeros
    out["memset"] = {"bytes": nbytes, "ms": ms}
    print(f"memset of P3's {nbytes} dirs bytes: {ms:.4f} ms "
          f"({nbytes / ms / 1e9:.3f} TB/s)", flush=True)

    keep = ("ms", "ns_per_row", "ns_per_active_row", "rows_active", "waves",
            "cells_band")
    for key, kr in (("ladder", 63), ("short", SHORT_KR)):
        out[key] = {}
        for lv in P3.levels:
            o = P3.run_level(lv, KR=kr, reps=args.reps, device="cuda")
            out[key][f"L{lv}"] = {k: o[k] for k in keep}
            print(f"P3 {key} L{lv}: {o['ms']:.4f} ms, {o['ns_per_row']:.1f} "
                  f"ns/row, {o['ns_per_active_row']:.1f} ns/active row, "
                  f"{o['waves']} wave(s)", flush=True)

    out["l0"] = {}
    q512 = torch.full((512, 1), 1000, dtype=torch.int32, device=dev)
    for name, kv in P2.cases:
        kw = {k: kv[k] for k in ("nstate", "KR", "touch", "read_acc")
              if k in kv}
        call = lambda: P2.l0_probe(q512, **kw)  # noqa: E731
        # None where the profiler sees no device time for the kernel
        o = {"kernel_ms": sum(by_kernel(torch, call, args.reps).values())
             or None, "ms": tools.time_ms(call, dev, args.reps)}
        out["l0"][name.strip()] = o
        kern = ("not measured" if o["kernel_ms"] is None
                else f"{o['kernel_ms'] * 1e3:.2f} us")
        print(f"P2 {name.strip()}: kernel {kern}, "
              f"{o['ms'] * 1e3:.2f} us a wrapper call", flush=True)

    line = json.dumps(out)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "time_probes.json").write_text(line + "\n")
        (args.out / "l0_sass.txt").write_text("\n".join(l0) + "\n")
    print(line)


if __name__ == "__main__":
    main()
