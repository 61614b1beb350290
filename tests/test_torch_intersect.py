"""The host paired-end fuzzy set intersection (align/intersect.py) in
snap_tpu_torch against snap_tpu (the twins of tests/test_intersect.py):
the seed offsets and disjoint sets, the candidate tiles on a genome
dominated by a repeat (every field of PairedCandidates), the pair bound
of a read that lost a seed, and the full paired driver on that genome
(the port's PairedEndAligner with its host intersection against
snap_tpu's, on the CPU).
"""

import numpy as np
import pytest
import torch

import snap_tpu.align.intersect as JI
import snap_tpu_torch.align.intersect as TI
from snap_tpu.constants import PAD
from snap_tpu.genome import Contig, Genome
from snap_tpu.index.index import GenomeIndex as JIndex
from snap_tpu_torch.index.index import GenomeIndex as TIndex
from test_torch_index import port_genome
from test_torch_pipeline import same_logq  # noqa: F401

torch.set_num_threads(1)

FIELDS = ("loc", "off", "dir", "valid", "weight", "has_mate", "pair_bound",
          "bps", "big_indel", "popular", "n_lookups")


@pytest.mark.parametrize("n_possible, seed_len, max_seeds", [
    (77, 24, 8), (3, 24, 8), (81, 20, 8), (81, 20, 25), (1, 20, 8),
    (100, 16, 32), (230, 20, 12),
])
def test_seed_offsets_spacing_and_sets(n_possible, seed_len, max_seeds):
    got = TI.intersect_seed_offsets(n_possible, seed_len, max_seeds)
    assert got == JI.intersect_seed_offsets(n_possible, seed_len, max_seeds)
    offs, sets = got
    assert len(offs) == min(max_seeds, n_possible)
    assert len(set(offs)) == len(offs) and all(0 <= o < n_possible for o in offs)


def _revcomp(codes):
    return (3 - codes[::-1]).astype(np.uint8)


@pytest.fixture(scope="module")
def repetitive():
    """tests/test_intersect.py's genome: 80 copies of a 400 bp repeat
    between unique flanks, each copy marked by its index at 8 bases."""
    rng = np.random.default_rng(11)
    rep = rng.integers(0, 4, size=400).astype(np.uint8)
    parts = [rng.integers(0, 4, size=3000).astype(np.uint8)]
    for i in range(80):
        c = rep.copy()
        for d, p in enumerate([40, 55, 70, 85]):
            c[p] = (i >> (2 * d)) & 3
        for d, p in enumerate([260, 275, 290, 305]):
            c[p] = (i >> (2 * d)) & 3
        parts.append(c)
    parts.append(rng.integers(0, 4, size=3000).astype(np.uint8))
    codes = np.concatenate(parts)
    bases = np.full(codes.size + 2000, PAD, dtype=np.uint8)
    bases[1000 : 1000 + codes.size] = codes
    genome = Genome(bases=bases, contigs=[Contig(name="chr1", start=1000, length=codes.size)])
    return (JIndex.build(genome, seed_len=24),
            TIndex.build(port_genome(genome), seed_len=24, device="cpu"), codes)


def same_candidates(repetitive, bases, len_eff, n_pairs, **kw):
    jidx, tidx, _ = repetitive
    ref = JI.paired_candidates(jidx.host, bases, len_eff, n_pairs, JI.IntersectParams(**kw))
    got = TI.paired_candidates(tidx.host, bases, len_eff, n_pairs, TI.IntersectParams(**kw))
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    return got


def test_repetitive_pair_candidates(repetitive):
    codes = repetitive[2]
    B, L = 4, 100
    bases = np.full((2 * B, L), 4, dtype=np.uint8)
    true0 = np.zeros(B, np.int64)
    for i in range(B):
        start0 = 3000 + 400 * (10 + 7 * i) + 20
        true0[i] = 1000 + start0
        bases[i] = codes[start0 : start0 + L]
        bases[B + i] = _revcomp(codes[start0 + 250 : start0 + 250 + L])
    len_eff = np.full(2 * B, L, dtype=np.int32)
    len_eff[3] = 80  # a clipped end probes fewer seeds
    pc = same_candidates(repetitive, bases, len_eff, B, seed_len=24, num_seeds=8, max_cand=16)
    for i in range(B):
        got0 = pc.loc[i][pc.valid[i] & pc.has_mate[i]]
        assert np.any(np.abs(got0 - true0[i]) <= 31), (i, got0, true0[i])
    # a phase-2a detection bound raises big_indel somewhere
    same_candidates(repetitive, bases, len_eff, B, seed_len=24, num_seeds=8,
                    max_cand=16, max_k_indels=40)


def test_pair_bound_reflects_disjoint_misses(repetitive):
    codes = repetitive[2]
    L, start = 100, 500
    read = codes[start : start + L].copy()
    read[12] = (read[12] + 1) % 4  # kill the first seed
    bases = np.stack([read, _revcomp(codes[start + 300 : start + 400])])
    pc = same_candidates(repetitive, bases, np.full(2, L, np.int32), 1,
                         seed_len=24, num_seeds=8, max_cand=16)
    sel = pc.valid[0] & (np.abs(pc.loc[0] - (1000 + start)) <= 31)
    assert sel.any() and pc.bps[0][sel].min() >= 1


def test_end_to_end_repetitive_pairing(repetitive, same_logq):
    """The paired driver with its host intersection on the repetitive
    genome: the same results as snap_tpu's, pairs at their true loci."""
    from snap_tpu.align.paired_driver import PairedEndAligner as JP
    from snap_tpu.align.pipeline import AlignParams as JA
    from snap_tpu.io.fastq import ReadBatch as JR
    from snap_tpu_torch.align.paired_driver import PairedEndAligner as TP
    from snap_tpu_torch.align.pipeline import AlignParams as TA
    from snap_tpu_torch.io.fastq import ReadBatch as TR

    jidx, tidx, codes = repetitive
    B, L, ML = 4, 100, 128
    ids, s0, s1, true_pos = [], [], [], []
    for i in range(B):
        start0 = 3000 + 400 * (12 + 9 * i) + 30
        ids.append(f"pair{i}".encode())
        s0.append(codes[start0 : start0 + L])
        s1.append(_revcomp(codes[start0 + 220 : start0 + 320]))
        true_pos.append((start0 + 1, start0 + 221))

    def batch(cls, seqs):
        bases = np.full((B, ML), 4, dtype=np.uint8)
        quals = np.zeros((B, ML), dtype=np.uint8)
        bases[:, :L] = np.stack(seqs)
        quals[:, :L] = ord("I")
        return cls(ids=ids, bases=bases, quals=quals, lengths=np.full(B, L, np.int32))

    res = []
    for P, A, R, idx in ((JP, JA, JR, jidx), (TP, TA, TR, tidx)):
        al = P(idx, A(seed_len=24, max_probe=idx.max_probe, num_seeds=8),
               batch_size=B, max_read_len=ML)
        al.device_intersect = False
        res.append(al.align_batch(batch(R, s0), batch(R, s1)))
    keys = ("status", "start_loc", "mapq", "direction", "aligned_as_pair", "cigar", "nm")
    for (j0, j1), (t0, t1), tp in zip(*res, true_pos):
        for jr, tr in ((j0, t0), (j1, t1)):
            for k in keys:
                assert (k in tr) == (k in jr), k
                if k in jr:
                    assert np.asarray(tr[k]).tolist() == np.asarray(jr[k]).tolist(), k
        assert t0.get("aligned_as_pair") and t1.get("aligned_as_pair")
        assert abs(int(t0["start_loc"]) - 1000 + 1 - tp[0]) <= 2
