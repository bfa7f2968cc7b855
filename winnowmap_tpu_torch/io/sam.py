"""SAM output (reference format.c:341-556 mm_write_sam3, header
format.c:118-139, cs/MD format.c:141-266)."""
from __future__ import annotations

import numpy as np

from ..options import (
    MM_F_COPY_COMMENT,
    MM_F_LONG_CIGAR,
    MM_F_OUT_CS,
    MM_F_OUT_CS_LONG,
    MM_F_OUT_MD,
    MM_F_SOFTCLIP,
)
from .paf import CIGAR_CHARS, write_tags
from .seqcode import NT4, revcomp_bytes

MAX_BAM_CIGAR_OP = 65535


def sam_header(mi, rg: str | None, version: str, cli: str | None) -> str:
    lines = [f"@SQ\tSN:{s.name}\tLN:{s.length}" for s in mi.seqs]
    if rg:
        lines.append(rg.replace("\\t", "\t"))
    pg = f"@PG\tID:Winnowmap\tPN:Winnowmap\tVN:{version}"
    if cli:
        pg += f"\tCL:{cli}"
    lines.append(pg)
    return "\n".join(lines)


def _rg_id(rg: str | None) -> str | None:
    if not rg:
        return None
    for field in rg.replace("\\t", "\t").split("\t"):
        if field.startswith("ID:"):
            return field[3:]
    return None


def _cigar_sam(r, qlen: int, sam_flag: int, opt_flag: int) -> str:
    """(reference write_sam_cigar, format.c:365-389)"""
    if r.p is None:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    clip_char = "H" if (sam_flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) else "S"
    parts = []
    if clip0:
        parts.append(f"{clip0}{clip_char}")
    for c in r.p.cigar.tolist():
        parts.append(f"{c >> 4}{CIGAR_CHARS[c & 0xF]}")
    if clip1:
        parts.append(f"{clip1}{clip_char}")
    return "".join(parts)


def _aligned_seqs(mi, rec, r):
    """query + target codes over the aligned interval, query in target
    orientation (reference write_cs_or_MD, format.c:220-243)."""
    tseq = mi.getseq(r.rid, r.rs, r.re)
    q = NT4[np.frombuffer(rec.seq[r.qs : r.qe], dtype=np.uint8)]
    if r.rev:
        q = q[::-1].copy()
        m = q < 4
        q[m] = 3 - q[m]
    return q, tseq


_B = "ACGTN"
_b = "acgtn"


def _cs_tag(qseq, tseq, r, long_form: bool) -> str:
    """(reference write_cs_core, format.c:141-187)"""
    out = []
    q_off = t_off = 0
    for c in r.p.cigar.tolist():
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            j = 0
            run = []
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    if run:
                        out.append("=" + "".join(run) if long_form else f":{len(run)}")
                        run = []
                    out.append(f"*{_b[tseq[t_off + j]]}{_b[qseq[q_off + j]]}")
                else:
                    run.append(_B[qseq[q_off + j]])
            if run:
                out.append("=" + "".join(run) if long_form else f":{len(run)}")
            q_off += ln
            t_off += ln
        elif op == 1:
            out.append("+" + "".join(_b[x] for x in qseq[q_off : q_off + ln]))
            q_off += ln
        elif op == 2:
            out.append("-" + "".join(_b[x] for x in tseq[t_off : t_off + ln]))
            t_off += ln
        else:  # intron
            out.append(
                f"~{_b[tseq[t_off]]}{_b[tseq[t_off+1]]}{ln}"
                f"{_b[tseq[t_off+ln-2]]}{_b[tseq[t_off+ln-1]]}"
            )
            t_off += ln
    return "".join(out)


def _md_tag(qseq, tseq, r) -> str:
    """(reference write_MD_core, format.c:189-218)"""
    out = []
    l_md = 0
    q_off = t_off = 0
    for c in r.p.cigar.tolist():
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    out.append(f"{l_md}{_B[tseq[t_off + j]]}")
                    l_md = 0
                else:
                    l_md += 1
            q_off += ln
            t_off += ln
        elif op == 1:
            q_off += ln
        elif op == 2:
            out.append(f"{l_md}^" + "".join(_B[x] for x in tseq[t_off : t_off + ln]))
            l_md = 0
            t_off += ln
        elif op == 3:
            t_off += ln
    if l_md > 0:
        out.append(str(l_md))
    return "".join(out)


def _get_sam_pri(regs):
    """(reference get_sam_pri, format.c:355-363)"""
    for q in regs:
        if q.sam_pri:
            return q
    return None


def _qname_len(name: str) -> int:
    """(reference mm_qname_len, bseq.h:31-36: trim a trailing /<digit>)"""
    n = len(name)
    if n >= 3 and name[-1].isdigit() and name[-2] == "/":
        return n - 2
    return n


def qname_same(a: str, b: str) -> bool:
    """(reference mm_qname_same, bseq.h:38-44)"""
    return a[:_qname_len(a)] == b[:_qname_len(b)] \
        and _qname_len(a) == _qname_len(b)


def write_sam(mi, rec, r, regs, opt_flag: int, rep_len: int,
              rg_line: str | None = None, seg_idx: int = 0, n_seg: int = 1,
              regs_all=None) -> str:
    """One SAM line (reference mm_write_sam3, format.c:391-556).  For
    multi-segment fragments pass seg_idx/n_seg and regs_all (the per-
    segment reg lists) so the paired flags/mate fields are emitted."""
    qlen = len(rec.seq)

    # primaries of the previous/next segments (format.c:400-413)
    r_prev = r_next = None
    if n_seg > 1:
        next_sid = (seg_idx + 1) % n_seg
        r_next = _get_sam_pri(regs_all[next_sid])
        if n_seg > 2:
            for i in range(1, n_seg):
                prev_sid = (seg_idx + n_seg - i) % n_seg
                if regs_all[prev_sid]:
                    r_prev = _get_sam_pri(regs_all[prev_sid])
                    break
        else:
            r_prev = r_next

    name = rec.name if n_seg <= 1 else rec.name[:_qname_len(rec.name)]
    out = [name]

    flag = 0x1 if n_seg > 1 else 0x0
    if r is None:
        flag |= 0x4
    else:
        if r.rev:
            flag |= 0x10
        if r.parent != r.id:
            flag |= 0x100
        elif not r.sam_pri:
            flag |= 0x800
    if n_seg > 1:
        if r is not None and r.proper_frag:
            flag |= 0x2
        if seg_idx == 0:
            flag |= 0x40
        elif seg_idx == n_seg - 1:
            flag |= 0x80
        if r_next is None:
            flag |= 0x8
        elif r_next.rev:
            flag |= 0x20
    out.append(f"\t{flag}")

    cigar_in_tag = False
    this_rid, this_pos = -1, -1
    if r is None:
        if r_prev is not None:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            out.append(f"\t{mi.seqs[this_rid].name}\t{this_pos + 1}\t0\t*")
        else:
            out.append("\t*\t0\t0\t*")
    else:
        this_rid, this_pos = r.rid, r.rs
        out.append(f"\t{mi.seqs[r.rid].name}\t{r.rs + 1}\t{r.mapq}\t")
        if (opt_flag & MM_F_LONG_CIGAR) and r.p is not None and len(r.p.cigar) > MAX_BAM_CIGAR_OP - 2:
            n_cigar = len(r.p.cigar)
            if r.qs != 0:
                n_cigar += 1
            if r.qe != qlen:
                n_cigar += 1
            if n_cigar > MAX_BAM_CIGAR_OP:
                cigar_in_tag = True
        if cigar_in_tag:
            if (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
                slen = qlen
            elif flag & 0x100:
                slen = 0
            else:
                slen = r.qe - r.qs
            out.append(f"{slen}S{r.re - r.rs}N")
        else:
            out.append(_cigar_sam(r, qlen, flag, opt_flag))

    # mate position + TLEN (format.c:465-483)
    if n_seg > 1:
        tlen = 0
        if this_rid >= 0 and r_next is not None:
            if this_rid == r_next.rid:
                if r is not None:
                    this_pos5 = r.re - 1 if r.rev else this_pos
                    next_pos5 = r_next.re - 1 if r_next.rev else r_next.rs
                    tlen = next_pos5 - this_pos5
                out.append("\t=\t")
            else:
                out.append(f"\t{mi.seqs[r_next.rid].name}\t")
            out.append(f"{r_next.rs + 1}\t")
        elif r_next is not None:  # this_rid < 0
            out.append(f"\t{mi.seqs[r_next.rid].name}\t{r_next.rs + 1}\t")
        elif this_rid >= 0:  # r_next is None
            out.append(f"\t=\t{this_pos + 1}\t")
        else:
            out.append("\t*\t0\t")
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        out.append(f"{tlen}\t")
    else:
        out.append("\t*\t0\t0\t")

    # SEQ + QUAL
    if r is None:
        out.append(rec.seq.decode())
        out.append("\t")
        out.append(rec.qual.decode() if rec.qual else "*")
    else:
        if (flag & 0x900) == 0 or (opt_flag & MM_F_SOFTCLIP):
            s = rec.seq
            q = rec.qual
            if r.rev:
                s = revcomp_bytes(s)
                q = q[::-1] if q else None
            out.append(s.decode())
            out.append("\t")
            out.append(q.decode() if q else "*")
        elif flag & 0x100:
            out.append("*\t*")
        else:
            s = rec.seq[r.qs : r.qe]
            q = rec.qual[r.qs : r.qe] if rec.qual else None
            if r.rev:
                s = revcomp_bytes(s)
                q = q[::-1] if q else None
            out.append(s.decode())
            out.append("\t")
            out.append(q.decode() if q else "*")

    rg_id = _rg_id(rg_line)
    if rg_id:
        out.append(f"\tRG:Z:{rg_id}")
    if n_seg > 2:
        out.append(f"\tFI:i:{seg_idx}")
    if r is not None:
        write_tags(out, r)
        if r.parent == r.id and r.p is not None and len(regs) > 1:
            sa = []
            for q in regs:
                if q is r or q.parent != q.id or q.p is None:
                    continue
                if q.qe - q.qs < q.re - q.rs:
                    l_m = q.qe - q.qs
                    l_d = (q.re - q.rs) - l_m
                    l_i = 0
                else:
                    l_m = q.re - q.rs
                    l_i = (q.qe - q.qs) - l_m
                    l_d = 0
                clip5 = qlen - q.qe if q.rev else q.qs
                clip3 = q.qs if q.rev else qlen - q.qe
                part = f"{mi.seqs[q.rid].name},{q.rs + 1},{'+-'[q.rev]},"
                if clip5:
                    part += f"{clip5}S"
                if l_m:
                    part += f"{l_m}M"
                if l_i:
                    part += f"{l_i}I"
                if l_d:
                    part += f"{l_d}D"
                if clip3:
                    part += f"{clip3}S"
                part += f",{q.mapq},{q.blen - q.mlen + q.p.n_ambi};"
                sa.append(part)
            if sa:
                out.append("\tSA:Z:" + "".join(sa))
        if r.p is not None and (opt_flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
            qseq, tseq = _aligned_seqs(mi, rec, r)
            if opt_flag & MM_F_OUT_MD:
                out.append("\tMD:Z:" + _md_tag(qseq, tseq, r))
            else:
                out.append("\tcs:Z:" + _cs_tag(qseq, tseq, r, bool(opt_flag & MM_F_OUT_CS_LONG)))
        if cigar_in_tag:
            clip_char = 5 if (flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) else 4
            clip0 = qlen - r.qe if r.rev else r.qs
            clip1 = r.qs if r.rev else qlen - r.qe
            vals = []
            if clip0:
                vals.append(clip0 << 4 | clip_char)
            vals.extend(int(c) for c in r.p.cigar)
            if clip1:
                vals.append(clip1 << 4 | clip_char)
            out.append("\tCG:B:I" + "".join(f",{v}" for v in vals))
    if rep_len >= 0:
        out.append(f"\trl:i:{rep_len}")
    if (opt_flag & MM_F_COPY_COMMENT) and rec.comment:
        out.append("\t" + rec.comment)
    return "".join(out)
