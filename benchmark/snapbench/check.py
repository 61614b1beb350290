"""How `correct` is decided: the window's SAM records against the plain
reference (benchmark/reference).

Three numbers, each beside its limit (benchmark/limits/<cell>.json):

  missing_records       records due that did not come: |records received
                        - records due| plus judged reads whose record
                        does not carry the read's name in input order.
                        Exact: limit 0.
  inconsistent_records  judged records that contradict themselves or
                        the genome: SEQ/QUAL not the read as sent (or its
                        reverse complement under 0x10), a CIGAR that does
                        not span the read or leaves the contig, an NM:i
                        that differs from the edits the CIGAR makes
                        against the genome at POS, MAPQ outside 0-70.
                        Exact: limit 0.
  wrong_share           of the judged reads (a sample drawn from the
                        seed, and every read of the window that carries
                        an indel), those the reference finds placed
                        wrong or given a MAPQ their placement belies.
                        The reference aligns the read at its own seed
                        loci, at the truth and at the program's locus,
                        and takes its best placement. (a) worse: where
                        that is unique (no other placement within MARGIN
                        edits of it) and within max_judged edits, the
                        program must report it: mapped, at that locus,
                        with fewer than MARGIN edits more. (b)
                        overconfident: a MAPQ of 10 or more needs no
                        other placement at no more edits than the
                        program's. (c) underconfident: where no other
                        placement lies within MARGIN + 1 edits of the
                        best and the program reports the best, its MAPQ
                        is 10 or more.
                        Limit set from readings (PERF.md).

MARGIN is 2 because the program ranks placements by affine-gap score,
not edit count: a 1-3 base gap can win over one substitution fewer.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from reference.align import MERGE, KmerIndex, Candidates, revcomp, score_loci

DECODE = np.frombuffer(b"ACGTN", np.uint8)
CIGAR_OP = re.compile(rb"(\d+)([MIDNSHP=X])")
MARGIN = 2
MAPQ_CONFIDENT = 10
K, N_SEEDS, HIT_CAP, PER_READ, PAD = 16, 8, 32, 48, 32


def max_judged(read_len: int) -> int:
    """Edits within which a read must be placed: 8 for 100 bases."""
    return max(8, read_len // 12)


@dataclass
class Rec:
    qname: bytes
    flag: int
    rname: bytes
    pos: int
    mapq: int
    cigar: bytes
    rnext: bytes
    pnext: int
    tlen: int
    seq: bytes
    qual: bytes
    nm: int | None

    @property
    def mapped(self) -> bool:
        return not self.flag & 0x4

    @property
    def rc(self) -> int:
        return 1 if self.flag & 0x10 else 0


def parse(line: bytes) -> Rec:
    t = line.rstrip(b"\r\n").split(b"\t")
    nm = None
    for tag in t[11:]:
        if tag.startswith(b"NM:i:"):
            nm = int(tag[5:])
    return Rec(t[0], int(t[1]), t[2], int(t[3]), int(t[4]), t[5], t[6], int(t[7]),
               int(t[8]), t[9], t[10], nm)


def cigar_ops(cigar: bytes) -> list[tuple[int, bytes]]:
    ops = [(int(n), op) for n, op in CIGAR_OP.findall(cigar)]
    if b"".join(b"%d%s" % o for o in ops) != cigar:
        raise ValueError(f"malformed CIGAR {cigar!r}")
    return ops


def ref_span(ops) -> int:
    return sum(n for n, op in ops if op in b"MDN=X")


def query_len(ops) -> int:
    return sum(n for n, op in ops if op in b"MIS=X")


def edits(ops, seq: np.ndarray, genome: np.ndarray, start: int) -> int:
    """Substitutions plus inserted and deleted bases of the alignment
    `ops` of seq (codes) at genome position `start` (0-based)."""
    qi, gi, n_ed = 0, start, 0
    for n, op in ops:
        if op in b"M=X":
            a, b = seq[qi : qi + n], genome[gi : gi + n]
            n_ed += int(((a != b) | (a >= 4)).sum())
            qi += n
            gi += n
        elif op == b"I":
            n_ed += n
            qi += n
        elif op == b"D":
            n_ed += n
            gi += n
        elif op == b"N":
            gi += n
        elif op == b"S":
            qi += n
    return n_ed


def record_faults(r: Rec, read: np.ndarray, qual: np.ndarray, genome: np.ndarray,
                  contig: bytes) -> list[str]:
    """What is wrong with one record on its own."""
    out = []
    seq = revcomp(read) if r.rc else read
    q = qual[::-1] if r.rc else qual
    if r.seq != DECODE[seq].tobytes() or r.qual != q.tobytes():
        out.append("SEQ/QUAL not the read")
    if not r.mapped:
        if r.cigar != b"*":
            out.append("unmapped with a CIGAR")
        return out
    try:
        ops = cigar_ops(r.cigar)
    except ValueError as e:
        return out + [str(e)]
    if r.rname != contig:
        out.append(f"RNAME {r.rname!r}")
    if query_len(ops) != read.size:
        out.append(f"CIGAR {r.cigar!r} spans {query_len(ops)} of {read.size} bases")
    if r.pos < 1 or r.pos - 1 + ref_span(ops) > genome.size:
        out.append(f"POS {r.pos} with CIGAR {r.cigar!r} leaves the contig")
    elif r.nm is None or r.nm != edits(ops, seq, genome, r.pos - 1):
        out.append(f"NM {r.nm} but the CIGAR makes {edits(ops, seq, genome, r.pos - 1)} edits")
    if not 0 <= r.mapq <= 70:
        out.append(f"MAPQ {r.mapq}")
    return out


@dataclass
class Judged:
    missing_records: int = 0
    inconsistent_records: int = 0
    wrong: int = 0
    judged: int = 0
    worse: int = 0
    overconfident: int = 0
    underconfident: int = 0
    notes: dict[str, list[str]] = field(default_factory=dict)

    @property
    def wrong_share(self) -> float:
        return self.wrong / self.judged if self.judged else 1.0

    def note(self, kind: str, msg: str) -> None:
        """Keep the first few notes of each kind for the run's log."""
        kept = self.notes.setdefault(kind, [])
        if len(kept) < 4:
            kept.append(msg)


def _loci(index, genome, reads, forced, device):
    """Scored loci of each read, the forced (read, strand, start) rows
    and the reference's own seed loci: a list over the reads of
    (strand, genome end, dist) arrays."""
    cand = Candidates(index, reads, N_SEEDS, HIT_CAP, PER_READ)
    r, s, st = cand.pick(*forced)
    dist, end = score_loci(genome, reads, r, s, st, PAD, device)
    cut = np.searchsorted(r, np.arange(len(reads) + 1))
    return [(s[a:b], end[a:b], dist[a:b]) for a, b in zip(cut[:-1], cut[1:])]


def _distinct(strand_a, end_a, strand_b, end_b):
    return (strand_a != strand_b) | (np.abs(end_a - end_b) > MERGE)


def judge(genome: np.ndarray, contig: bytes, pool, prefix: bytes,
          reads: dict[int, bytes | None], pool_units: int, records_due: int,
          records_seen: int, device="cpu", index: KmerIndex | None = None) -> Judged:
    """Judge the records of the reads `reads` maps (read number in the
    window -> its record line, None where none came) against the Pool."""
    from .traffic import pool_name

    out = Judged(missing_records=abs(records_seen - records_due))
    if out.missing_records:
        out.note("missing", f"{records_seen} records for {records_due} due")
    L = pool.bases.shape[1]
    parsed: dict[int, Rec] = {}
    for u, line in sorted(reads.items()):
        pi = u % pool_units
        r = parse(line) if line is not None else None
        if r is None or r.qname != pool_name(prefix, pi):
            out.missing_records += 1
            out.note("missing", f"read {u}: record {None if r is None else r.qname}")
            continue
        bad = [f"flag {r.flag}"] if r.flag & 0x901 else []
        bad += record_faults(r, pool.bases[pi], pool.quals[pi], genome, contig)
        if bad:
            out.inconsistent_records += 1
            out.note("inconsistent", f"read {u}: {'; '.join(bad)}: "
                     + line.decode(errors="replace")[:200])
            continue
        parsed[u] = r
    if not parsed:
        return out
    if index is None:
        index = KmerIndex(genome, K, device)
    us = np.array(sorted(parsed), np.int64)
    pis = us % pool_units
    recs = [parsed[u] for u in us]
    rows = np.arange(len(us))
    # forced loci: the truth, and the program's own placement
    f_read = [rows, rows[[r.mapped for r in recs]]]
    f_strand = [pool.rc[pis].astype(np.int64),
                np.array([r.rc for r in recs if r.mapped], np.int64)]
    f_start = [pool.start[pis],
               np.array([r.pos - 1 - _lead_clip(r) for r in recs if r.mapped], np.int64)]
    forced = (np.concatenate(f_read), np.concatenate(f_strand), np.concatenate(f_start))
    loci = _loci(index, genome, pool.bases[pis], forced, device)
    lim = max_judged(L)
    for row, u in enumerate(us):
        r = recs[row]
        worse, over, under = _judge_read(r, loci[row], lim)
        out.judged += 1
        out.worse += int(worse)
        out.overconfident += int(over)
        out.underconfident += int(under)
        if worse or over or under:
            out.wrong += 1
            kind = "worse" if worse else "overconfident" if over else "underconfident"
            out.note(kind, f"read {u}: {r.flag} {r.pos} {r.mapq} {r.cigar.decode()} NM {r.nm}")
    return out


def _end_of(r: Rec) -> int:
    """The genome position one past the record's last aligned base."""
    return r.pos - 1 + ref_span(cigar_ops(r.cigar))


def _judge_read(r: Rec, loci, lim: int) -> tuple[bool, bool, bool]:
    """(worse, overconfident, underconfident) of one read, from the
    reference's loci (strand, end, edits)."""
    s, end, d = loci
    b = int(np.argmin(d))
    others = _distinct(s, end, s[b], end[b])
    unique = not (others & (d <= d[b] + MARGIN)).any()
    clear = not (others & (d <= d[b] + MARGIN + 1)).any()
    worse = over = under = False
    if unique and d[b] <= lim:
        worse = (not r.mapped or bool(_distinct(r.rc, _end_of(r), s[b], end[b]))
                 or r.nm >= d[b] + MARGIN)
        under = clear and not worse and r.mapq < MAPQ_CONFIDENT
    if r.mapped and r.mapq >= MAPQ_CONFIDENT:
        over = bool((_distinct(s, end, r.rc, _end_of(r)) & (d <= r.nm)).any())
    return worse, over, under


def _lead_clip(r: Rec) -> int:
    m = re.match(rb"(\d+)S", r.cigar)
    return int(m.group(1)) if m else 0
