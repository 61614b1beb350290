"""Plain alignment: a sorted k-mer index, seed candidates, and the
unit-cost edit distance of a whole read against a genome window whose
ends are free (semi-global), for many read-window pairs at once.

Base codes are 0-3 (A, C, G, T) and 4 (N); a window position outside
the genome holds OUTSIDE, which matches nothing, as a read's N matches
nothing.
"""

from __future__ import annotations

import numpy as np
import torch

OUTSIDE = 5
MERGE = 48          # candidates ending within this many bases are one locus


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of [..., L] codes (N stays N)."""
    return np.where(codes < 4, 3 - codes, codes)[..., ::-1].astype(np.uint8)


class KmerIndex:
    """Every k-mer of the genome sorted by its 2-bit key (k <= 31), the
    positions of equal keys in genome order."""

    def __init__(self, genome: np.ndarray, k: int, device="cpu"):
        self.k, self.device = k, torch.device(device)
        g = torch.from_numpy(np.ascontiguousarray(genome)).to(self.device)
        n = g.numel() - k + 1
        key = torch.zeros(n, dtype=torch.int64, device=self.device)
        ok = torch.ones(n, dtype=torch.bool, device=self.device)
        for j in range(k):
            c = g[j : j + n].to(torch.int64)
            ok &= c < 4
            key = key * 4 + (c & 3)
        key = torch.where(ok, key, torch.full_like(key, -1))
        self.keys, self.pos = torch.sort(key, stable=True)

    def keys_of(self, seqs: np.ndarray) -> torch.Tensor:
        """2-bit keys of [Q, k] codes; -1 where a code is N."""
        s = torch.from_numpy(np.ascontiguousarray(seqs)).to(self.device).to(torch.int64)
        key = torch.zeros(s.shape[0], dtype=torch.int64, device=self.device)
        for j in range(self.k):
            key = key * 4 + (s[:, j] & 3)
        return torch.where((s < 4).all(dim=1), key, torch.full_like(key, -1))

    def hits(self, qkeys: torch.Tensor, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """(query index [H], genome position [H]): the first `cap`
        occurrences (in genome order) of each query key."""
        lo = torch.searchsorted(self.keys, qkeys)
        hi = torch.searchsorted(self.keys, qkeys, right=True)
        cnt = torch.where(qkeys < 0, torch.zeros_like(lo), (hi - lo).clamp(max=cap))
        q = torch.repeat_interleave(torch.arange(qkeys.numel(), device=self.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(q.numel(), device=self.device) - first[q]
        return q.cpu().numpy(), self.pos[lo[q] + off].cpu().numpy()


def windows(genome: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """[N, width] genome codes from each start, OUTSIDE beyond the ends."""
    idx = starts[:, None] + np.arange(width)[None, :]
    inside = (idx >= 0) & (idx < genome.size)
    return np.where(inside, genome[np.clip(idx, 0, genome.size - 1)], OUTSIDE).astype(np.uint8)


def semiglobal(pattern: np.ndarray, text: np.ndarray, device="cpu",
               block: int = 65536) -> tuple[np.ndarray, np.ndarray]:
    """For each row, the fewest edits (substitutions, inserted and
    deleted bases) that align the whole pattern [N, L] to some stretch
    of the text [N, W], and the end of that stretch (exclusive column,
    the leftmost end among the best)."""
    n, L = pattern.shape
    W = text.shape[1]
    dist = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    col = torch.arange(W + 1, device=device, dtype=torch.int32)
    for b0 in range(0, n, block):
        p = torch.from_numpy(pattern[b0 : b0 + block]).to(device)
        t = torch.from_numpy(text[b0 : b0 + block]).to(device)
        m = p.shape[0]
        # D[j]: edits of the read's first i bases ending at text column j
        D = torch.zeros((m, W + 1), dtype=torch.int32, device=device)
        for i in range(L):
            c = p[:, i : i + 1]
            sub = ((t != c) | (c >= 4)).to(torch.int32)
            diag = D[:, :-1] + sub
            up = D[:, 1:] + 1
            nxt = torch.cat((D[:, :1] + 1, torch.minimum(diag, up)), dim=1)
            # a deleted text base costs 1 along the row: a running min of
            # nxt[k] + (j - k)
            D = torch.cummin(nxt - col, dim=1).values + col
        best, where = D.min(dim=1)
        dist[b0 : b0 + m] = best.cpu().numpy()
        end[b0 : b0 + m] = where.cpu().numpy()
    return dist, end


def hamming(pattern: np.ndarray, text: np.ndarray) -> np.ndarray:
    """Mismatches of each pattern row against its text row (same width);
    a read's N and OUTSIDE mismatch everything."""
    return ((pattern != text) | (pattern >= 4) | (text >= 4)).sum(axis=1)


class Candidates:
    """Loci of reads on both strands: for each read, rows of (strand,
    start of the read's first base on the genome's forward strand)."""

    def __init__(self, index: KmerIndex, reads: np.ndarray, n_seeds: int, cap: int,
                 per_read: int):
        n, L = reads.shape
        k = index.k
        offs = np.linspace(0, L - k, n_seeds).round().astype(np.int64)
        rows, strands, starts, support = [], [], [], []
        for strand, seqs in ((0, reads), (1, revcomp(reads))):
            seeds = np.stack([seqs[:, o : o + k] for o in offs], axis=1).reshape(-1, k)
            q, pos = index.hits(index.keys_of(seeds), cap)
            rows.append(q // n_seeds)
            starts.append(pos - offs[q % n_seeds])
            strands.append(np.full(q.size, strand))
        self.read = np.concatenate(rows)
        self.strand = np.concatenate(strands)
        self.start = np.concatenate(starts)
        self.per_read = per_read

    def pick(self, forced_read, forced_strand, forced_start):
        """(read, strand, start) rows: the forced loci first, then the
        seed loci with the most seeds behind them, at most per_read a
        read, duplicates dropped."""
        r = np.concatenate([forced_read, self.read])
        s = np.concatenate([forced_strand, self.strand])
        st = np.concatenate([forced_start, self.start])
        forced = np.concatenate([np.ones(len(forced_read), bool), np.zeros(len(self.read), bool)])
        key = np.stack([r, s, st], axis=1)
        uniq, inv, cnt = np.unique(key, axis=0, return_inverse=True, return_counts=True)
        prio = cnt.astype(np.int64)
        np.maximum.at(prio, inv.reshape(-1), np.where(forced, 1 << 30, 0))
        order = np.lexsort((-prio, uniq[:, 0]))
        uniq, prio = uniq[order], prio[order]
        rank = np.arange(len(uniq)) - np.searchsorted(uniq[:, 0], uniq[:, 0])
        keep = rank < self.per_read
        return uniq[keep, 0], uniq[keep, 1], uniq[keep, 2]


def score_loci(genome, reads, read, strand, start, pad: int, device="cpu"):
    """Semi-global edit distance of each (read, strand) at a window of
    `pad` bases around `start`: (dist, genome end of the alignment)."""
    L = reads.shape[1]
    seqs = reads[read]
    rc = strand == 1
    seqs[rc] = revcomp(seqs[rc])
    text = windows(genome, start - pad, L + 2 * pad)
    dist, end = semiglobal(seqs, text, device)
    return dist, start - pad + end
