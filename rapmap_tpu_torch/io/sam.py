"""SAM emission from device result records (SEMANTICS.md §6).

Copy of rapmap_tpu.io.sam. Host-side rendering of compact device outputs
(RapMapUtils::writeAlignmentsToStream rebuild, SURVEY.md §2.1 #8). Record
content rules live in SEMANTICS.md; the device never formats text.
"""

from __future__ import annotations

from typing import IO

import numpy as np

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100

_COMP = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def revcomp_seq(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def sam_header(txp_names: list[str], txp_lens: np.ndarray, version: str, cl: str) -> str:
    lines = ["@HD\tVN:1.0\tSO:unknown"]
    for name, ln in zip(txp_names, txp_lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    lines.append(f"@PG\tID:tqm\tPN:tqm\tVN:{version}\tCL:{cl}")
    return "\n".join(lines) + "\n"


def _pos1(p: int) -> int:
    return max(int(p), 0) + 1


def write_se_records(
    out: IO[str],
    names: list[str],
    seqs: list[bytes],
    quals: list[bytes],
    mo,  # MapOut (numpy)
    txp_names: list[str],
    write_unmapped: bool = True,
) -> int:
    """Render single-end MapOut rows to SAM lines. Returns records written."""
    n = 0
    t, pos, strand = mo.t, mo.pos, mo.strand
    MO = t.shape[1]
    for i, name in enumerate(names):
        seq = seqs[i]
        qual = quals[i].decode()
        if not mo.mapped[i]:
            if write_unmapped:
                out.write(f"{name}\t{FLAG_UNMAPPED}\t*\t0\t0\t*\t*\t0\t0\t{seq.decode()}\t{qual}\n")
            continue
        rc_seq = None
        first = True
        for j in range(MO):
            if t[i, j] == -1:
                break
            flags = 0 if first else FLAG_SECONDARY
            if strand[i, j] == 1:
                flags |= FLAG_REVERSE
                if rc_seq is None:
                    rc_seq = revcomp_seq(seq).decode()
                s, q = rc_seq, qual[::-1]
            else:
                s, q = seq.decode(), qual
            mapq = 1 if first else 0
            out.write(
                f"{name}\t{flags}\t{txp_names[t[i, j]]}\t{_pos1(pos[i, j])}\t{mapq}\t"
                f"{len(seq)}M\t*\t0\t0\t{s}\t{q}\n"
            )
            n += 1
            first = False
    return n


def get_native_formatter(txp_names: list[str]):
    """Native C++ SAM renderer (native/sam.cpp) or None when unavailable.
    Pass the result as `formatter=` to the dense writers; the Python loops
    below remain the executable spec and the byte-parity oracle."""
    try:
        from rapmap_tpu_torch.native.bindings import SamFormatter, available

        if available():
            return SamFormatter(txp_names)
    except Exception as exc:  # toolchain-less hosts: fall back silently
        import logging

        logging.getLogger("tqm.sam").debug("native SAM formatter unavailable: %s", exc)
    return None


def write_se_records_dense(
    out: IO[str],
    names: list[str],
    seqs: list[bytes],
    quals: list[bytes],
    recs: np.ndarray,    # (cap, 4) int32 t,pos,strand,score (row-major by read)
    counts: np.ndarray,  # (B,)
    txp_names: list[str],
    write_unmapped: bool = True,
    formatter=None,
    with_score: bool = False,
) -> int:
    """SAM from device-compacted SERecords (production path). with_score
    appends the record's alignment score as an `AS:i` tag (--mappingScore,
    SEMANTICS.md §9)."""
    if formatter is not None:
        out.write(
            formatter.se(names, seqs, quals, recs, counts, write_unmapped,
                         with_score=with_score).decode("ascii")
        )
        return formatter.last_n_records
    n = 0
    off = 0
    for i, name in enumerate(names):
        c = int(counts[i])
        seq = seqs[i]
        qual = quals[i].decode()
        if c == 0:
            if write_unmapped:
                out.write(f"{name}\t{FLAG_UNMAPPED}\t*\t0\t0\t*\t*\t0\t0\t{seq.decode()}\t{qual}\n")
            continue
        rc_seq = None
        for j in range(c):
            t, pos, strand, score = recs[off + j]
            flags = 0 if j == 0 else FLAG_SECONDARY
            if strand == 1:
                flags |= FLAG_REVERSE
                if rc_seq is None:
                    rc_seq = revcomp_seq(seq).decode()
                s, q = rc_seq, qual[::-1]
            else:
                s, q = seq.decode(), qual
            mapq = 1 if j == 0 else 0
            tag = f"\tAS:i:{score}" if with_score else ""
            out.write(
                f"{name}\t{flags}\t{txp_names[t]}\t{_pos1(pos)}\t{mapq}\t"
                f"{len(seq)}M\t*\t0\t0\t{s}\t{q}{tag}\n"
            )
            n += 1
        off += c
    return n


def write_pe_records_dense(
    out: IO[str],
    names: list[str],
    seqs1: list[bytes], quals1: list[bytes],
    seqs2: list[bytes], quals2: list[bytes],
    recs: np.ndarray,    # (cap, 7|9) int32 t,p1,s1,has1,p2,s2,has2[,sc1,sc2]
    counts: np.ndarray,
    txp_names: list[str],
    write_unmapped: bool = True,
    formatter=None,
    with_score: bool = False,
) -> int:
    """SAM from device-compacted PERecords (production path). with_score
    appends each mapped mate's alignment score as AS:i (--mappingScore)."""
    if formatter is not None:
        out.write(
            formatter.pe(names, seqs1, quals1, seqs2, quals2, recs, counts,
                         write_unmapped, with_score=with_score).decode("ascii")
        )
        return formatter.last_n_records
    n = 0
    off = 0
    for i, name in enumerate(names):
        c = int(counts[i])
        s1b, q1 = seqs1[i], quals1[i].decode()
        s2b, q2 = seqs2[i], quals2[i].decode()
        L1, L2 = len(s1b), len(s2b)
        if c == 0:
            if write_unmapped:
                f1 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_FIRST
                f2 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_SECOND
                out.write(f"{name}\t{f1}\t*\t0\t0\t*\t*\t0\t0\t{s1b.decode()}\t{q1}\n")
                out.write(f"{name}\t{f2}\t*\t0\t0\t*\t*\t0\t0\t{s2b.decode()}\t{q2}\n")
            continue
        for j in range(c):
            row = recs[off + j]
            t, p1, st1, h1, p2, st2, h2 = (int(x) for x in row[:7])
            tg1 = f"\tAS:i:{int(row[7])}" if with_score else ""
            tg2 = f"\tAS:i:{int(row[8])}" if with_score else ""
            tname = txp_names[t]
            sec = 0 if j == 0 else FLAG_SECONDARY
            mapq = 1 if j == 0 else 0
            if h1 and h2:
                r1, r2 = st1 == 1, st2 == 1
                t1, t2 = _tlen(p1, L1, p2, L2)
                f1 = FLAG_PAIRED | FLAG_PROPER | FLAG_FIRST | sec
                f2 = FLAG_PAIRED | FLAG_PROPER | FLAG_SECOND | sec
                if r1:
                    f1 |= FLAG_REVERSE
                    f2 |= FLAG_MATE_REVERSE
                if r2:
                    f2 |= FLAG_REVERSE
                    f1 |= FLAG_MATE_REVERSE
                seq1 = revcomp_seq(s1b).decode() if r1 else s1b.decode()
                qq1 = q1[::-1] if r1 else q1
                seq2 = revcomp_seq(s2b).decode() if r2 else s2b.decode()
                qq2 = q2[::-1] if r2 else q2
                out.write(
                    f"{name}\t{f1}\t{tname}\t{_pos1(p1)}\t{mapq}\t{L1}M\t=\t{_pos1(p2)}\t{t1}\t{seq1}\t{qq1}{tg1}\n"
                )
                out.write(
                    f"{name}\t{f2}\t{tname}\t{_pos1(p2)}\t{mapq}\t{L2}M\t=\t{_pos1(p1)}\t{t2}\t{seq2}\t{qq2}{tg2}\n"
                )
                n += 2
            else:
                if h1:
                    p, rev, Lm, sb, qb, fl_this, fl_other = p1, st1 == 1, L1, s1b, q1, FLAG_FIRST, FLAG_SECOND
                    so, qo = s2b, q2
                    tgm = tg1
                else:
                    p, rev, Lm, sb, qb, fl_this, fl_other = p2, st2 == 1, L2, s2b, q2, FLAG_SECOND, FLAG_FIRST
                    so, qo = s1b, q1
                    tgm = tg2
                f_m = FLAG_PAIRED | FLAG_MATE_UNMAPPED | fl_this | sec
                if rev:
                    f_m |= FLAG_REVERSE
                seqm = revcomp_seq(sb).decode() if rev else sb.decode()
                qqm = qb[::-1] if rev else qb
                out.write(
                    f"{name}\t{f_m}\t{tname}\t{_pos1(p)}\t{mapq}\t{Lm}M\t=\t{_pos1(p)}\t0\t{seqm}\t{qqm}{tgm}\n"
                )
                n += 1
                if j == 0:
                    f_u = FLAG_PAIRED | FLAG_UNMAPPED | fl_other | (FLAG_MATE_REVERSE if rev else 0)
                    out.write(
                        f"{name}\t{f_u}\t{tname}\t{_pos1(p)}\t0\t*\t=\t{_pos1(p)}\t0\t{so.decode()}\t{qo}\n"
                    )
                    n += 1
        off += c
    return n


def _tlen(p1: int, l1: int, p2: int, l2: int) -> tuple[int, int]:
    """Signed TLEN for (left record, right record) per SEMANTICS.md §5."""
    span = max(p1 + l1, p2 + l2) - min(p1, p2)
    if p1 < p2 or (p1 == p2):
        return span, -span
    return -span, span


def write_pe_records(
    out: IO[str],
    names: list[str],
    seqs1: list[bytes], quals1: list[bytes],
    seqs2: list[bytes], quals2: list[bytes],
    po,  # PairOut (numpy)
    txp_names: list[str],
    write_unmapped: bool = True,
) -> int:
    n = 0
    MO = po.t.shape[1]
    for i, name in enumerate(names):
        s1b, q1 = seqs1[i], quals1[i].decode()
        s2b, q2 = seqs2[i], quals2[i].decode()
        L1, L2 = len(s1b), len(s2b)
        if not po.any_record[i]:
            if write_unmapped:
                f1 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_FIRST
                f2 = FLAG_PAIRED | FLAG_UNMAPPED | FLAG_MATE_UNMAPPED | FLAG_SECOND
                out.write(f"{name}\t{f1}\t*\t0\t0\t*\t*\t0\t0\t{s1b.decode()}\t{q1}\n")
                out.write(f"{name}\t{f2}\t*\t0\t0\t*\t*\t0\t0\t{s2b.decode()}\t{q2}\n")
            continue
        first = True
        for j in range(MO):
            if po.t[i, j] == -1:
                break
            tname = txp_names[po.t[i, j]]
            sec = 0 if first else FLAG_SECONDARY
            mapq = 1 if first else 0
            h1, h2 = bool(po.has1[i, j]), bool(po.has2[i, j])
            if h1 and h2:
                p1, p2 = int(po.p1[i, j]), int(po.p2[i, j])
                r1, r2 = po.s1[i, j] == 1, po.s2[i, j] == 1
                t1, t2 = _tlen(p1, L1, p2, L2)
                f1 = FLAG_PAIRED | FLAG_PROPER | FLAG_FIRST | sec
                f2 = FLAG_PAIRED | FLAG_PROPER | FLAG_SECOND | sec
                if r1:
                    f1 |= FLAG_REVERSE
                    f2 |= FLAG_MATE_REVERSE
                if r2:
                    f2 |= FLAG_REVERSE
                    f1 |= FLAG_MATE_REVERSE
                seq1 = revcomp_seq(s1b).decode() if r1 else s1b.decode()
                qq1 = q1[::-1] if r1 else q1
                seq2 = revcomp_seq(s2b).decode() if r2 else s2b.decode()
                qq2 = q2[::-1] if r2 else q2
                out.write(
                    f"{name}\t{f1}\t{tname}\t{_pos1(p1)}\t{mapq}\t{L1}M\t=\t{_pos1(p2)}\t{t1}\t{seq1}\t{qq1}\n"
                )
                out.write(
                    f"{name}\t{f2}\t{tname}\t{_pos1(p2)}\t{mapq}\t{L2}M\t=\t{_pos1(p1)}\t{t2}\t{seq2}\t{qq2}\n"
                )
                n += 2
            else:
                # orphan: mapped mate + unmapped mate placeholder at same coords
                if h1:
                    p, rev, Lm, sb, qb, fl_this, fl_other = (
                        int(po.p1[i, j]), po.s1[i, j] == 1, L1, s1b, q1, FLAG_FIRST, FLAG_SECOND
                    )
                    so, qo = s2b, q2
                else:
                    p, rev, Lm, sb, qb, fl_this, fl_other = (
                        int(po.p2[i, j]), po.s2[i, j] == 1, L2, s2b, q2, FLAG_SECOND, FLAG_FIRST
                    )
                    so, qo = s1b, q1
                f_m = FLAG_PAIRED | FLAG_MATE_UNMAPPED | fl_this | sec
                if rev:
                    f_m |= FLAG_REVERSE
                seqm = revcomp_seq(sb).decode() if rev else sb.decode()
                qqm = qb[::-1] if rev else qb
                out.write(
                    f"{name}\t{f_m}\t{tname}\t{_pos1(p)}\t{mapq}\t{Lm}M\t=\t{_pos1(p)}\t0\t{seqm}\t{qqm}\n"
                )
                n += 1
                if first:
                    # one unmapped placeholder for the orphaned mate (rank 0 only)
                    f_u = FLAG_PAIRED | FLAG_UNMAPPED | fl_other | (FLAG_MATE_REVERSE if rev else 0)
                    out.write(
                        f"{name}\t{f_u}\t{tname}\t{_pos1(p)}\t0\t*\t=\t{_pos1(p)}\t0\t{so.decode()}\t{qo}\n"
                    )
                    n += 1
            first = False
    return n
