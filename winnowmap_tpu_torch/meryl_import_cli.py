"""meryl-import equivalent: load a text list of 'KMER value' lines into a
meryl v1 k-mer database.

Reference: ext/meryl/src/meryl-import/meryl-import.C (CLI surface
:44-78, line format and persistent-value rule :174-193, orientation
selection :203-211, duplicate handling via merylCountArray multiset
:166-169, summary lines :220 and :255).

Usage mirrors the reference:
  meryl-import -k <size> -kmers <input.txt> -output <db.meryl>
               [-multiset] [-forward | -reverse] [-maxvalue N] [-threads N]

The port of winnowmap_tpu/meryl_import_cli.py: it writes a meryl v1 database
(kcount/meryldb.py) from text and counts nothing, so it launches no kernel.
"""
from __future__ import annotations

import sys

import numpy as np

from .kcount import MERYL_CODE


def _encode(kstr: bytes, k: int) -> tuple[int, int]:
    """(forward, revcomp) 2-bit codes of the first k bases (reference
    kmerTiny::addR semantics: bases shift in from the right, masked to k),
    in meryl's encoding (A=0, C=1, T=2, G=3; the complement is code ^ 2,
    reference kmers-tiny.H:86-87), the one the database holds.  (The JAX
    package's tool takes A=0, C=1, G=2, T=3, so its G and T, and its
    canonical choice, differ from the database's: its print of an
    imported list is not the list.)"""
    codes = MERYL_CODE[np.frombuffer(kstr, np.uint8)]
    if np.any(codes == 255):
        raise SystemExit(
            f"[ERROR] non-ACGT base in k-mer {kstr.decode()!r}")
    mask = (1 << (2 * k)) - 1
    f = 0
    for c in codes.tolist():
        f = ((f << 2) | int(c)) & mask
    r = 0
    for j in range(k):
        r = (r << 2) | (((f >> (2 * j)) & 3) ^ 2)
    return f, r


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    inp = out = None
    k = 0
    multiset = False
    orient = "canonical"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-kmers":
            i += 1
            inp = argv[i]
        elif a == "-output":
            i += 1
            out = argv[i]
        elif a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "-multiset":
            multiset = True
        elif a == "-forward":
            orient = "forward"
        elif a == "-reverse":
            orient = "reverse"
        elif a in ("-maxvalue", "-threads", "-memory"):
            i += 1  # accepted for CLI parity; no effect here
        else:
            raise SystemExit(f"Unknown option '{a}'.")
        i += 1
    if not (inp and out and k):
        raise SystemExit(
            "usage: meryl-import [...] -k <kmer-size> -kmers <input-kmers> "
            "-output <db.meryl>")

    kmers: list[int] = []
    values: list[int] = []
    persistent = 1  # reference meryl-import.C:174
    n_in = 0
    with open(inp, "rb") as f:
        for line in f:
            w = line.split()
            if not w:
                continue
            if w[0].startswith(b"#"):
                persistent = int(w[0][1:])
                continue
            vv = int(w[1]) if len(w) > 1 else persistent
            fc, rc = _encode(w[0], k)
            if orient == "forward":
                code = fc
            elif orient == "reverse":
                code = rc
            else:
                code = min(fc, rc)
            kmers.append(code)
            values.append(vv)
            n_in += 1

    ka = np.array(kmers, np.uint64)
    va = np.array(values, np.int64)
    if multiset:
        # duplicate kmers stay individual entries, sorted by code
        order = np.argsort(ka, kind="stable")
        ka, va = ka[order], va[order]
    else:
        # values of duplicate kmers are summed (merylCountArray::countKmers)
        ka, inv = np.unique(ka, return_inverse=True)
        va = np.bincount(inv, weights=va.astype(np.float64),
                         minlength=len(ka)).astype(np.int64)

    from .kcount.meryldb import write_meryl_db

    write_meryl_db(out, k, ka, va)
    print(f"Found {n_in} kmers in the input.", file=sys.stderr)
    print("", file=sys.stderr)
    print("Bye.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
