"""Host-side (numpy) index lookups over the full CSR hit lists.

The device lookup path (index.py probe/gather_hits) gathers a fixed cap
of hits per seed — right for the single-end wavefront, wrong for the
paired-end fuzzy set intersection, which must walk the FULL per-seed hit
lists (reference: IntersectingPairedEndAligner.cpp:455-502 records up to
maxBigHits=4000 hits per (seed, direction)). This module probes the same
bucketed hash table with vectorized numpy and exposes the raw CSR
extents, so host code can slice complete hit lists at C speed.

Also used by the wide-hit redo pass for single-end reads whose seeds
overflowed the device gather cap (BaseAligner.cpp:574-579 scores up to
maxHits=300 hits per seed).
"""

from __future__ import annotations

import numpy as np

from .build import BUCKET_SLOTS, murmur_finalize64


class HostIndex:
    """Numpy view of the index tables (shares the GenomeIndex arrays)."""

    def __init__(self, arrays: dict, seed_len: int, max_probe: int):
        self.table: np.ndarray = np.asarray(arrays["table"])
        self.hits: np.ndarray = np.asarray(arrays["hits"])
        self.seed_len = seed_len
        self.max_probe = max_probe
        # [total_buckets, 8, 4] bucket-row view (format v3, build.py)
        self._t3 = self.table.reshape(-1, BUCKET_SLOTS, 4)

    def probe(
        self, queries: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized bucket probe, mirroring index.probe (v3 layout).

        queries: [N] uint64 canonical seed keys. Returns
        (found [N] bool, start [N] int64, n0 [N] int32, n1 [N] int32).
        """
        from .build import SPAN_SLACK

        span = max(1, self.max_probe)
        n_banks, bank_slots, _ = self.table.shape
        bank_buckets = bank_slots // BUCKET_SLOTS - SPAN_SLACK
        log2b = (n_banks - 1).bit_length()
        stride = bank_slots // BUCKET_SLOTS
        h = murmur_finalize64(queries)
        bank = (h & np.uint64(n_banks - 1)).astype(np.int64)
        home = ((h >> np.uint64(log2b)) & np.uint64(bank_buckets - 1)).astype(
            np.int64
        )
        brow = bank * stride + home
        q_lo = (queries & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        q_hi = (queries >> np.uint64(32)).astype(np.uint32)
        nrows = self._t3.shape[0]
        N = queries.shape[0]
        found = np.zeros(N, dtype=bool)
        start = np.zeros(N, dtype=np.int64)
        packed = np.zeros(N, dtype=np.uint32)
        for j in range(span):
            rows = self._t3[np.minimum(brow + j, nrows - 1)]  # [N, 8, 4]
            hit = (rows[:, :, 0] == q_lo[:, None]) & (
                rows[:, :, 1] == q_hi[:, None]
            )
            anyhit = hit.any(axis=1)
            new = anyhit & ~found
            if new.any():
                s = np.argmax(hit[new], axis=1)
                start[new] = rows[new, s, 2].astype(np.int64)
                packed[new] = rows[new, s, 3]
            found |= anyhit
        n0 = np.where(found, packed & np.uint32(0xFFFF), 0).astype(np.int32)
        n1 = np.where(found, packed >> np.uint32(16), 0).astype(np.int32)
        return found, np.where(found, start, 0), n0, n1


def pack_seeds_at(
    bases: np.ndarray, offsets: np.ndarray, seed_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack 2-bit seeds of a read batch at per-row offset sets.

    bases: [R, L] uint8 codes. offsets: [R, S] int32 (may be < 0 for
    unused slots). Returns (fwd [R, S] uint64, rc [R, S] uint64,
    valid [R, S] bool) — valid means the offset was >= 0 and the
    seed window is all-ACGT.
    """
    R, L = bases.shape
    off_ok = offsets >= 0
    offc = np.clip(offsets, 0, max(L - seed_len, 0)).astype(np.int64)
    fwd = np.zeros(offsets.shape, dtype=np.uint64)
    rc = np.zeros(offsets.shape, dtype=np.uint64)
    valid = off_ok.copy()
    for i in range(seed_len):
        b = np.take_along_axis(bases, offc + i, axis=1).astype(np.uint64)
        ok = b < 4
        valid &= ok
        bs = np.where(ok, b, 0)
        fwd = (fwd << np.uint64(2)) | bs
        rc |= (np.uint64(3) - bs) << np.uint64(2 * i)
    return fwd, rc, valid


def host_clip_back(quals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Numpy twin of pipeline.clip_back (ClipBack, Read.h:88-108)."""
    QUAL_CLIP = ord("#")
    R, L = quals.shape
    pos = np.arange(L, dtype=np.int32)[None, :]
    good = (quals != QUAL_CLIP) & (pos < lens[:, None])
    last_good = np.max(np.where(good, pos, -1), axis=1)
    return (last_good + 1).astype(np.int32)
