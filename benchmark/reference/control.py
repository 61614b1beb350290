"""The control: the reference put in the program's place with one stated
guarantee broken. It places each read by substitutions alone (gapless,
at the exact seed start), so a read with an indel is never aligned
through its gap: the configuration's guarantee that alignments score
insertions and deletions is what it drops. It writes SAM records as the
program does, and the benchmark's check must find them not correct.
"""

from __future__ import annotations

import numpy as np

from .align import MERGE, Candidates, KmerIndex, hamming, revcomp, windows

DECODE = np.frombuffer(b"ACGTN", np.uint8)
MAX_DIST = 27          # the program's default -d


def _place(index, genome, reads, n_seeds, cap, per_read):
    """Per read: arrays (strand, start, mismatches) of its seed loci."""
    r, s, st = Candidates(index, reads, n_seeds, cap, per_read).pick(
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
    seqs = reads[r]
    seqs[s == 1] = revcomp(seqs[s == 1])
    d = hamming(seqs, windows(genome, st, reads.shape[1]))
    cut = np.searchsorted(r, np.arange(len(reads) + 1))
    return [(s[a:b], st[a:b], d[a:b]) for a, b in zip(cut[:-1], cut[1:])]


def _mapq(strand, start, d, i):
    other = (strand != strand[i]) | (np.abs(start - start[i]) > MERGE)
    second = d[other].min() if other.any() else MAX_DIST + 10
    return 0 if second <= d[i] else 3 if second == d[i] + 1 else 60


def _line(name, flag, contig, pos, mapq, cigar, rnext, pnext, tlen, seq, qual, nm):
    tags = b"" if nm is None else b"\tNM:i:%d" % nm
    return b"%s\t%d\t%s\t%d\t%d\t%s\t%s\t%d\t%d\t%s\t%s%s" % (
        name, flag, contig, pos, mapq, cigar, rnext, pnext, tlen, seq, qual, tags)


def _seq_qual(read, qual, rc):
    s = revcomp(read) if rc else read
    return DECODE[s].tobytes(), (qual[::-1] if rc else qual).tobytes()


def align_single(index: KmerIndex, genome, contig: bytes, names, reads, quals,
                 n_seeds=8, cap=32, per_read=48, mapq: int | None = None) -> list[bytes]:
    """One SAM record a read. `mapq`, where given, is written for every
    mapped read in place of the control's own (a second broken
    guarantee, for the MAPQ half of the check)."""
    L = reads.shape[1]
    out = []
    for i, (s, st, d) in enumerate(_place(index, genome, reads, n_seeds, cap, per_read)):
        if d.size == 0 or d.min() > MAX_DIST:
            seq, q = _seq_qual(reads[i], quals[i], False)
            out.append(_line(names[i], 4, b"*", 0, 0, b"*", b"*", 0, 0, seq, q, None))
            continue
        b = int(np.argmin(d))
        seq, q = _seq_qual(reads[i], quals[i], s[b])
        mq = _mapq(s, st, d, b) if mapq is None else mapq
        out.append(_line(names[i], 16 * int(s[b]), contig, int(st[b]) + 1, mq, b"%dM" % L,
                         b"*", 0, 0, seq, q, int(d[b])))
    return out
