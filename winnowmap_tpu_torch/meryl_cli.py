"""meryl-compatible command line (reference ext/meryl/src/meryl/meryl.C).

Supports the winnowmap workflow and the common set-algebra surface:

  meryl-tpu count k=15 output DB in.fa
  meryl-tpu print greater-than distinct=0.9998 DB  > repetitive_k15.txt
  meryl-tpu print DB
  meryl-tpu histogram DB
  meryl-tpu statistics DB
  meryl-tpu [print] union-sum DB1 DB2 [output DB3]
  meryl-tpu [print] intersect-min DB1 DB2
  meryl-tpu [print] subtract DB1 DB2
  meryl-tpu [print] difference DB1 DB2

The port of winnowmap_tpu/meryl_cli.py: counting goes through KC on the
card (kcount.count_kmers); `--device cpu` counts with KC's plain version
on the host instead.  Without a card and without `--device cpu` a count
raises.
"""
from __future__ import annotations

import os
import sys

from .io.fastx import read_all
from .kcount import KmerCounts, count_kmers
from .utils.log import phase_log

FILTERS = {
    "greater-than": "greater_than",
    "less-than": "less_than",
    "at-least": "at_least",
    "at-most": "at_most",
    "equal-to": "equal_to",
    "not-equal-to": "not_equal_to",
}
# value ops with a math constant (reference merylOp.H opIncrease..opModulo,
# merylCommandBuilder.C:357-362)
MATHOPS = {
    "increase": "increase",
    "decrease": "decrease",
    "multiply": "multiply",
    "divide": "divide",
    "divide-round": "divide_round",
    "modulo": "modulo",
}
# n-ary merges over sorted streams (reference merylOp.H opUnion..opSubtract,
# merylCommandBuilder.C:364-377; exact count semantics in kcount.nary_merge)
BINOPS = {
    "union": "union",
    "union-min": "union_min",
    "union-max": "union_max",
    "union-sum": "union_sum",
    "intersect": "intersect",
    "intersect-min": "intersect_min",
    "intersect-max": "intersect_max",
    "intersect-sum": "intersect_sum",
    "subtract": "subtract",
    "difference": "difference",
    "symmetric-difference": "symmetric_difference",
}
COUNT_DIRS = {
    "count": "canonical",
    "count-forward": "forward",
    "count-reverse": "reverse",
}


def _is_db(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "merylIndex"))
        or os.path.exists(os.path.join(path, "counts.npz")))


def _load_or_err(path: str) -> KmerCounts:
    if not _is_db(path):
        raise SystemExit(f"ERROR: '{path}' is not a meryl-tpu database")
    return KmerCounts.load(path)


def _apply_filter(kc: KmerCounts, filt, filt_arg) -> KmerCounts:
    if filt is None:
        return kc
    if filt_arg.startswith("distinct="):
        thr = kc.threshold_distinct(float(filt_arg.split("=", 1)[1]))
    elif filt_arg.startswith("word-frequency="):
        thr = kc.threshold_word_freq(float(filt_arg.split("=", 1)[1]))
    else:
        thr = int(filt_arg)
    return getattr(kc, filt)(thr)


def _eval_tree(tokens, device, k_inherit=None):
    """Evaluate one nested meryl command expression (reference
    merylCommandBuilder's [...] operation trees, merylCommandBuilder.C):
    an action (count or a set op), modifiers (k=, output, filters), and
    operands which are databases or bracketed sub-expressions."""
    from .kcount import compare_lines, nary_merge, ploidy_report

    op = None
    count_dir = "canonical"
    filt = filt_arg = None
    math_arg = None
    k = k_inherit
    out_db = None
    do_print = False
    children = []
    files = []
    i = 0
    while i < len(tokens):
        a = tokens[i]
        if a == "[":
            depth, j = 1, i + 1
            while depth:
                if tokens[j] == "[":
                    depth += 1
                elif tokens[j] == "]":
                    depth -= 1
                j += 1
            children.append(_eval_tree(tokens[i + 1:j - 1], device, k))
            i = j
            continue
        if a in COUNT_DIRS:
            op = "count"
            count_dir = COUNT_DIRS[a]
        elif a == "print":
            do_print = True
        elif a in ("histogram", "statistics", "ploidy", "noise", "compare"):
            op = "ploidy" if a == "noise" else a
        elif a in FILTERS:
            filt = FILTERS[a]
            i += 1
            filt_arg = tokens[i]
        elif a in MATHOPS:
            op = MATHOPS[a]
            i += 1
            math_arg = int(tokens[i])
        elif a in BINOPS:
            op = BINOPS[a]
        elif a.startswith("k="):
            k = int(a[2:])
        elif a.startswith("memory=") or a.startswith("threads="):
            pass
        elif a == "output":
            i += 1
            out_db = tokens[i]
        elif _is_db(a):
            children.append(KmerCounts.load(a))
        else:
            files.append(a)
        i += 1

    if op == "count":
        if k is None:
            raise SystemExit("ERROR: count needs k=<size>")
        recs = []
        for f in files:
            recs.extend(read_all(f))
        kc = count_kmers(recs, k, device=device, direction=count_dir)
    elif op in MATHOPS.values():
        if not children:
            raise SystemExit(f"ERROR: {op} needs an operand")
        kc = getattr(children[0], op)(math_arg)
    elif op in BINOPS.values():
        if len(children) < 2:
            raise SystemExit(f"ERROR: {op} needs two operands")
        kc = nary_merge(op, children)
    elif op == "compare":
        if len(children) != 2:
            raise SystemExit("ERROR: compare needs two operands")
        for line in compare_lines(children[0], children[1]):
            sys.stdout.write(line + "\n")
        return children[0]
    elif op == "ploidy":
        if len(children) != 1:
            raise SystemExit("ERROR: ploidy needs one database")
        err_lines, out_line = ploidy_report(children[0])
        for line in err_lines:
            sys.stderr.write(line + "\n")
        sys.stdout.write(out_line + "\n")
        return children[0]
    elif op == "histogram":
        kc = children[0] if children else None
        if kc is None:
            raise SystemExit("ERROR: histogram needs a database")
        vals, occ = kc.histogram()
        for v, o in zip(vals.tolist(), occ.tolist()):
            sys.stdout.write(f"{v}\t{o}\n")
        return kc
    elif children:
        kc = children[0]
    else:
        raise SystemExit("ERROR: empty meryl expression")
    kc = _apply_filter(kc, filt, filt_arg)
    if out_db:
        kc.save(out_db)
    if do_print:
        for line in kc.print_lines():
            sys.stdout.write(line + "\n")
    return kc


def main(argv: list[str] | None = None, device=None) -> int:
    """The meryl command line on args (sys.argv's without one); `--device
    cuda|cpu` (or `device`) is where counting runs, None the card."""
    args = list(sys.argv[1:] if argv is None else argv)
    while "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args):
            raise SystemExit("ERROR: --device needs cuda or cpu")
        device = args[i + 1]
        del args[i:i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 1

    if "[" in args:  # nested operation tree
        _eval_tree(args, device)
        return 0

    do_print = False
    out_db = None

    i = 0
    op = None
    filt = None
    filt_arg = None
    math_arg = None
    count_dir = "canonical"
    k = None
    inputs = []
    while i < len(args):
        a = args[i]
        if a in COUNT_DIRS:
            op = "count"
            count_dir = COUNT_DIRS[a]
        elif a in ("import", "-kmers"):
            op = "import" if a == "import" else op
            if a == "-kmers":
                i += 1
                inputs.append(args[i])
        elif a == "-k":
            i += 1
            k = int(args[i])
        elif a == "-output":
            i += 1
            out_db = args[i]
        elif a == "print":
            do_print = True
        elif a in ("histogram", "statistics", "ploidy", "noise", "compare"):
            op = "ploidy" if a == "noise" else a
        elif a in FILTERS:
            filt = FILTERS[a]
            i += 1
            filt_arg = args[i]
        elif a in MATHOPS:
            op = MATHOPS[a]
            i += 1
            math_arg = int(args[i])
        elif a in BINOPS:
            op = BINOPS[a]
        elif a.startswith("k="):
            k = int(a[2:])
        elif a.startswith("memory=") or a.startswith("threads="):
            pass  # accepted for CLI compatibility; sizing is automatic here
        elif a == "output":
            i += 1
            out_db = args[i]
        else:
            inputs.append(a)
        i += 1

    if op == "count":
        if k is None:
            raise SystemExit("ERROR: count needs k=<size>")
        recs = []
        for f in inputs:
            recs.extend(read_all(f))
        kc = count_kmers(recs, k, device=device, direction=count_dir)
        phase_log(
            "meryl",
            f"counted {kc.n_total} total / {kc.n_distinct} distinct {k}-mers",
        )
        if out_db:
            kc.save(out_db)
        if do_print:
            _emit(kc, filt, filt_arg)
        return 0

    if op == "import":
        # reference meryl-import (ext/meryl/src/meryl-import): text
        # 'KMER<space>count' lines -> database; order is not significant
        if k is None:
            raise SystemExit("ERROR: import needs -k <kmer-size>")
        import numpy as np

        from .kcount import MERYL_CODE, KmerCounts

        words, counts = [], []
        for path in inputs:
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if not parts:
                        continue
                    if len(parts[0]) != k:
                        raise SystemExit(
                            f"ERROR: kmer '{parts[0]}' length != k={k}")
                    words.append(parts[0].encode())
                    counts.append(int(parts[1]) if len(parts) > 1 else 1)
        # every k-mer's canonical code at once (seq_to_kmers' rolls)
        c = MERYL_CODE[np.frombuffer(b"".join(words), np.uint8)].reshape(
            -1, k)
        if (c == 255).any():
            raise SystemExit("ERROR: a kmer holds a base other than ACGT")
        c = c.astype(np.uint64)
        sh = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
        fwd = np.bitwise_or.reduce(c << sh, axis=1)
        rev = np.bitwise_or.reduce((c ^ np.uint64(2)) << sh[::-1], axis=1)
        codes = np.minimum(fwd, rev)
        counts = np.array(counts, np.int64)
        order = np.argsort(codes)
        kc = KmerCounts(k, codes[order], counts[order])
        if out_db:
            kc.save(out_db)
        if do_print:
            _emit(kc, filt, filt_arg)
        return 0

    if op in ("histogram", "statistics"):
        kc = _load_or_err(inputs[0])
        vals, occ = kc.histogram()
        if op == "histogram":
            for v, o in zip(vals.tolist(), occ.tolist()):
                print(f"{v}\t{o}")
        else:
            uniq = int(occ[vals == 1][0]) if (vals == 1).any() else 0
            print(f"Number of {kc.k}-mers that are:")
            print(f"  unique   {uniq:>20}")
            print(f"  distinct {kc.n_distinct:>20}")
            print(f"  present  {kc.n_total:>20}")
        return 0

    if op in BINOPS.values():
        from .kcount import nary_merge

        dbs = [_load_or_err(p) for p in inputs]
        if len(dbs) < 2:
            raise SystemExit(f"ERROR: {op} needs two databases")
        kc = nary_merge(op, dbs)
        if out_db:
            kc.save(out_db)
        if do_print:
            _emit(kc, filt, filt_arg)
        return 0

    if op in MATHOPS.values():
        kc = getattr(_load_or_err(inputs[0]), op)(math_arg)
        if out_db:
            kc.save(out_db)
        if do_print:
            _emit(kc, filt, filt_arg)
        return 0

    if op == "compare":
        from .kcount import compare_lines

        a, b = _load_or_err(inputs[0]), _load_or_err(inputs[1])
        for line in compare_lines(a, b):
            sys.stdout.write(line + "\n")
        return 0

    if op == "ploidy":
        from .kcount import ploidy_report

        err_lines, out_line = ploidy_report(_load_or_err(inputs[0]))
        for line in err_lines:
            sys.stderr.write(line + "\n")
        sys.stdout.write(out_line + "\n")
        return 0

    # bare print / filtered print over a database
    if do_print or filt:
        kc = _load_or_err(inputs[0])
        _emit(kc, filt, filt_arg)
        return 0

    print(__doc__, file=sys.stderr)
    return 1


def _emit(kc: KmerCounts, filt, filt_arg) -> None:
    if filt is not None:
        if filt_arg.startswith("distinct="):
            thr = kc.threshold_distinct(float(filt_arg.split("=", 1)[1]))
        elif filt_arg.startswith("word-frequency="):
            thr = kc.threshold_word_freq(float(filt_arg.split("=", 1)[1]))
        else:
            thr = int(filt_arg)
        kc = getattr(kc, filt)(thr)
    w = sys.stdout.write
    try:
        for line in kc.print_lines():
            w(line)
            w("\n")
    except BrokenPipeError:  # `meryl print ... | head` is normal usage
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass


if __name__ == "__main__":
    sys.exit(main())
