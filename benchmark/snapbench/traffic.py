"""The general read generator: a traffic file's parameters and a seed
in, a pool of reads and their truth out.

The read model is chip_smoke.py's (simulate_reads): uniform start
positions over the genome's stretches without N; in `indel_share` of
the reads one deletion or insertion of `indel_len` bases at least
`indel_margin` bases from either end; `rc_share` of the reads from the
reverse strand; a random base drawn at `sub_rate` of the positions (so
3/4 of those differ); phred scores normal(mean, sd) rounded and
clipped. Unlike chip_smoke's per-read loops, every draw here is one
numpy call over the pool, so a pool of a million reads takes about two
seconds.

Read names carry no truth: a read is `r` and its index in the pool,
zero-padded to 9 digits. The truth stays in the Pool.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DECODE = np.frombuffer(b"ACGTN", np.uint8)
NAME_DIGITS = 9


@dataclass
class Pool:
    """Reads of one end: codes [n, L], phred+33 bytes [n, L], and truth:
    reverse strand [n] bool, leftmost reference base (0-based) [n], and
    the reference bases the read spans [n]."""

    bases: np.ndarray
    quals: np.ndarray
    rc: np.ndarray
    start: np.ndarray
    span: np.ndarray


def _indels(rng, n: int, L: int, err: dict):
    """(kind [n]: 0 none, 1 deletion, 2 insertion; position; length)."""
    u = rng.random(n)
    share = err["indel_share"]
    kind = np.where(u < share / 2, 1, np.where(u < share, 2, 0)).astype(np.int64)
    lo, hi = err["indel_len"]
    m = err["indel_margin"]
    p = rng.integers(m, L - m, n)
    k = rng.integers(lo, hi + 1, n)
    return kind, p, np.where(kind > 0, k, 0)


def _cut(rng, genome: np.ndarray, start, kind, p, k, L: int) -> np.ndarray:
    """The forward-strand bases of reads that start at `start` with the
    given indels (before substitutions)."""
    j = np.arange(L, dtype=np.int32)[None, :]
    s = start.astype(np.int32)[:, None]
    p, k = p.astype(np.int32)[:, None], k.astype(np.int32)[:, None]
    shift = np.where((kind == 1)[:, None] & (j >= p), k, 0)
    shift = np.where((kind == 2)[:, None] & (j >= p + k), -k, shift)
    bases = genome[np.clip(s + j + shift, 0, genome.size - 1)]
    rows, cols = np.nonzero((kind == 2)[:, None] & (j >= p) & (j < p + k))
    bases[rows, cols] = rng.integers(0, 4, rows.size)
    return bases


def _phred_table(err: dict) -> np.ndarray:
    """Inverse CDF of the rounded, clipped normal(phred_mean, phred_sd)
    over 2^16 equal steps: a uniform uint16 through it draws a score."""
    from math import erf, sqrt

    lo, hi = err["phred_min"], err["phred_max"]
    mu, sd = err["phred_mean"], err["phred_sd"]
    q = np.arange(lo, hi + 1)
    # P(round(x) <= q) = P(x < q + 0.5); the clip puts the tails on lo, hi
    cdf = np.array([0.5 * (1 + erf((v + 0.5 - mu) / (sd * sqrt(2)))) for v in q])
    cdf[-1] = 1.0
    u = (np.arange(1 << 16) + 0.5) / (1 << 16)
    return q[np.searchsorted(cdf, u)].astype(np.uint8)


def _finish(rng, fwd: np.ndarray, rc: np.ndarray, err: dict):
    """Reverse-complement the rc rows, add substitutions and qualities."""
    reads = fwd
    reads[rc] = (3 - fwd[rc])[:, ::-1]
    flat = reads.reshape(-1)
    n_sub = rng.binomial(flat.size, err["sub_rate"])
    flat[rng.integers(0, flat.size, n_sub)] = rng.integers(0, 4, n_sub)
    u = rng.integers(0, 1 << 16, reads.shape, dtype=np.uint16)
    return reads, _phred_table(err)[u] + np.uint8(33)


def _span(kind, k, L):
    return L + np.where(kind == 1, k, np.where(kind == 2, -k, 0))


def _starts(rng, genome: np.ndarray, span: int, n: int) -> np.ndarray:
    """n uniform starts of windows of `span` bases that hold no N (with
    no N in the genome: rng.integers(0, genome.size - span, n))."""
    edges = np.flatnonzero(np.diff(np.concatenate(([0], genome < 4, [0])).astype(np.int8)))
    lo, hi = edges[0::2], edges[1::2]
    room = np.maximum(hi - lo - span, 0)
    u = rng.integers(0, int(room.sum()), n)
    cum = np.cumsum(room)
    k = np.searchsorted(cum, u, side="right")
    return lo[k] + u - (cum[k] - room[k])


def draw_reads(rng, genome: np.ndarray, n: int, traffic: dict) -> Pool:
    L, err = traffic["read_len"], traffic["errors"]
    kind, p, k = _indels(rng, n, L, err)
    start = _starts(rng, genome, L + 2 * err["indel_len"][1], n)
    fwd = _cut(rng, genome, start, kind, p, k, L)
    rc = rng.random(n) < err["rc_share"]
    reads, quals = _finish(rng, fwd, rc, err)
    return Pool(reads, quals, rc, start, _span(kind, k, L))


def names(prefix: bytes, first: int, n: int) -> np.ndarray:
    """[n, 1 + NAME_DIGITS] uint8: prefix and the zero-padded index."""
    idx = np.arange(first, first + n, dtype=np.int64)[:, None]
    digits = (idx // 10 ** np.arange(NAME_DIGITS - 1, -1, -1)) % 10 + ord("0")
    out = np.empty((n, 1 + NAME_DIGITS), np.uint8)
    out[:, 0] = prefix[0]
    out[:, 1:] = digits
    return out


def fastq_bytes(prefix: bytes, first: int, reads: np.ndarray, quals: np.ndarray) -> bytes:
    """FASTQ records of equal-length reads, named by pool index."""
    n, L = reads.shape
    w = 1 + NAME_DIGITS
    rec = np.empty((n, 1 + w + 1 + L + 3 + L + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1 : 1 + w] = names(prefix, first, n)
    o = 1 + w
    rec[:, o] = ord("\n")
    rec[:, o + 1 : o + 1 + L] = DECODE[reads]
    o += 1 + L
    rec[:, o : o + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + 3 : o + 3 + L] = quals
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def pool_name(prefix: bytes, i: int) -> bytes:
    return prefix + b"%0*d" % (NAME_DIGITS, i)
