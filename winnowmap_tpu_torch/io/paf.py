"""PAF output (reference format.c:280-339 mm_write_paf3 + write_tags)."""
from __future__ import annotations

import numpy as np

from ..options import (MM_F_OUT_CG, MM_F_OUT_CS, MM_F_OUT_CS_LONG,
                       MM_F_OUT_MD)

CIGAR_CHARS = "MIDNSHP=XB"


def event_identity(r) -> float:
    """(reference mm_event_identity, format.c:268-278)"""
    if r.p is None:
        return -1.0
    n_gapo = n_gap = 0
    for c in r.p.cigar.tolist():
        op, ln = c & 0xF, c >> 4
        if op in (1, 2):
            n_gapo += 1
            n_gap += ln
    return r.mlen / (r.blen + r.p.n_ambi - n_gap + n_gapo)


def _fmt_f4(v: float) -> str:
    return "0" if v == 0.0 else f"{v:.4f}"


def write_tags(out: list, r) -> None:
    """(reference write_tags, format.c:280-306)"""
    if r.id == r.parent:
        tp = "I" if r.inv else "P"
    else:
        tp = "i" if r.inv else "S"
    if r.p is not None:
        out.append(
            f"\tNM:i:{r.blen - r.mlen + r.p.n_ambi}\tms:i:{r.p.dp_max}"
            f"\tAS:i:{r.p.dp_score}\tnn:i:{r.p.n_ambi}"
        )
        if r.p.trans_strand in (1, 2):
            out.append(f"\tts:A:{'?+-?'[r.p.trans_strand]}")
    out.append(f"\ttp:A:{tp}\tcm:i:{r.cnt}\ts1:i:{r.score}")
    if r.parent == r.id:
        out.append(f"\ts2:i:{r.subsc}")
    if r.p is not None:
        div = 1.0 - event_identity(r)
        out.append(f"\tde:f:{_fmt_f4(div)}")
    elif 0.0 <= r.div <= 1.0:
        out.append(f"\tdv:f:{_fmt_f4(r.div)}")
    if r.split:
        out.append(f"\tzd:i:{r.split}")


def cigar_str(cigar: np.ndarray) -> str:
    return "".join(f"{c >> 4}{CIGAR_CHARS[c & 0xF]}" for c in cigar.tolist())


def write_paf(mi, name: str, qlen: int, r, opt_flag: int, rep_len: int,
              comment: str | None = None, copy_comment: bool = False,
              rec=None) -> str:
    """One PAF line (reference mm_write_paf3, format.c:308-334)."""
    if r is None:
        line = f"{name}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0"
        if rep_len >= 0:
            line += f"\trl:i:{rep_len}"
        return line
    out = [
        f"{name}\t{qlen}\t{r.qs}\t{r.qe}\t{'+-'[r.rev]}\t",
        mi.seqs[r.rid].name if mi.seqs[r.rid].name else str(r.rid),
        f"\t{mi.seqs[r.rid].length}\t{r.rs}\t{r.re}",
        f"\t{r.mlen}\t{r.blen}",
        f"\t{r.mapq}",
    ]
    write_tags(out, r)
    if rep_len >= 0:
        out.append(f"\trl:i:{rep_len}")
    if r.p is not None and (opt_flag & MM_F_OUT_CG):
        out.append("\tcg:Z:" + cigar_str(r.p.cigar))
    if r.p is not None and rec is not None and (
            opt_flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
        # (reference mm_write_paf3 tail, format.c:330-331)
        from .sam import _aligned_seqs, _cs_tag, _md_tag

        qseq, tseq = _aligned_seqs(mi, rec, r)
        if opt_flag & MM_F_OUT_MD:
            out.append("\tMD:Z:" + _md_tag(qseq, tseq, r))
        else:
            out.append("\tcs:Z:" + _cs_tag(qseq, tseq, r,
                                            bool(opt_flag & MM_F_OUT_CS_LONG)))
    if copy_comment and comment:
        out.append("\t" + comment)
    return "".join(out)
