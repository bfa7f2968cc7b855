"""meryl-simple equivalent: standalone one-shot k-mer counter.

Reference ext/meryl/src/meryl-simple/meryl-simple.C: loads every canonical
k-mer of the input, sorts, and writes a text dump (-D, "KMER\\tcount"
ascending) and/or a histogram (-H, "count\\toccurrences").  The reference's
-M (meryl DB) output is accepted-but-unimplemented there; here it writes a
real meryl DB via the container writer.

The port of winnowmap_tpu/meryl_simple_cli.py: it counts through KC on the
card; `--device cpu` counts with KC's plain version on the host.
"""
from __future__ import annotations

import sys


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    k = 0
    s_input = m_out = d_out = h_out = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-k":
            i += 1
            k = int(argv[i])
        elif a == "-S":
            i += 1
            s_input = argv[i]
        elif a == "-M":
            i += 1
            m_out = argv[i]
        elif a == "-D":
            i += 1
            d_out = argv[i]
        elif a == "-H":
            i += 1
            h_out = argv[i]
        elif a == "-m":
            i += 1  # memory limit: not needed
        elif a == "--device":
            i += 1
            device = argv[i]
        else:
            print(f"unknown option '{a}'", file=sys.stderr)
            return 1
        i += 1
    if k == 0 or s_input is None:
        print("usage: meryl-simple -k kmerSize -S input.fasta "
              "[-M out.meryl] [-D out.dump] [-H out.histogram] "
              "[--device cuda|cpu]",
              file=sys.stderr)
        return 1

    from .io.fastx import read_all
    from .kcount import count_kmers

    kc = count_kmers(read_all(s_input), k, device=device)

    if d_out:
        with open(d_out, "w") as f:
            for line in kc.print_lines():
                f.write(line + "\n")
    if h_out:
        vals, occ = kc.histogram()
        with open(h_out, "w") as f:
            for v, o in zip(vals.tolist(), occ.tolist()):
                f.write(f"{v}\t{o}\n")
    if m_out:
        kc.save(m_out)
    print("Bye.", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
