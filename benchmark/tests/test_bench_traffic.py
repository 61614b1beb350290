"""The traffic generator and the frozen genome generator, against counts
worked out by hand."""

import hashlib

import numpy as np

from reference.align import revcomp
from snapbench import genome, traffic

ERR = {"sub_rate": 0.01, "indel_share": 0.25, "indel_len": [1, 3], "indel_margin": 20,
       "rc_share": 0.5, "phred_mean": 36, "phred_sd": 5, "phred_min": 2, "phred_max": 41}
TR = {"read_len": 100, "errors": ERR}


def test_repeat_genome_copies_and_draws_frozen():
    # 100 kbp at 25%: 12,500 bases a family -> 41 SINE copies of 300 bp,
    # 2 LINE copies of 6 kb, 5 microsatellites; the draws pinned
    g = genome.gen_repeat_genome(np.random.default_rng(7), 100_000, 0.25)
    assert g.dtype == np.uint8 and g.size == 100_000 and g.max() <= 3
    # chip_smoke.gen_repeat_genome gives the same draws (checked when copied)
    assert hashlib.sha256(g.tobytes()).hexdigest()[:16] == "bc1838099bd273cc"
    rng = np.random.default_rng(7)
    rng.integers(0, 4, size=100_000)
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    starts = []
    for _ in range(12_500 // 300):
        p = int(rng.integers(0, 100_000 - 300))
        d = rng.random(300) < 0.01
        rng.integers(0, 4, int(d.sum()))
        starts.append(p)
    assert len(starts) == 41
    # the last SINE copy planted differs from the unit in ~1% of bases
    # unless a LINE or microsatellite was planted over it later
    diff = (g[starts[-1]:starts[-1] + 300] != alu).mean()
    assert diff < 0.05 or diff > 0.5


def test_reads_follow_the_model():
    g = np.random.default_rng(1).integers(0, 4, 1_000_000).astype(np.uint8)
    n, L = 20_000, 100
    p = traffic.draw_reads(np.random.default_rng(2), g, n, TR)
    assert p.bases.shape == (n, L) and p.quals.shape == (n, L)
    # a quarter of the reads carry an indel of 1-3 bases: spans L-3..L+3
    d = p.span - L
    assert set(np.unique(d)) <= {-3, -2, -1, 0, 1, 2, 3}
    assert abs((d != 0).mean() - 0.25) < 0.015
    assert abs((d > 0).mean() - (d < 0).mean()) < 0.015
    assert abs(p.rc.mean() - 0.5) < 0.015
    # reads without an indel: the genome (rc: its reverse complement)
    # with substitutions at 1% of the positions, 3/4 of which differ
    clean = np.flatnonzero(d == 0)
    fwd = np.where(p.rc[clean, None], revcomp(p.bases[clean]), p.bases[clean])
    ref = g[p.start[clean, None] + np.arange(L)]
    mism = (fwd != ref).mean()
    assert 0.006 < mism < 0.009
    q = p.quals.astype(float) - 33
    assert q.min() >= 2 and q.max() <= 41 and abs(q.mean() - 35.6) < 0.2


def test_deletion_and_insertion_cut_by_hand():
    g = np.arange(40, dtype=np.uint8) % 4
    rng = np.random.default_rng(0)
    start = np.array([2, 2])
    kind = np.array([1, 2])
    pos, k = np.array([3, 3]), np.array([2, 2])
    out = traffic._cut(rng, g, start, kind, pos, k, 8)
    # deletion of 2 after 3 bases: genome 2,3,4 then 7,8,9,10,11
    assert out[0].tolist() == (np.array([2, 3, 4, 7, 8, 9, 10, 11]) % 4).tolist()
    # insertion of 2 after 3 bases: genome 2,3,4, two drawn, then 5,6,7
    assert out[1][:3].tolist() == [2, 3, 0] and out[1][5:].tolist() == [1, 2, 3]


def test_family_genome_by_hand():
    fam = [{"name": "a", "length": 500, "copies": 4, "divergence": 0.0},
           {"name": "b", "length": 300, "copies": 3, "divergence": 0.1}]
    g = genome.gen_family_genome(np.random.default_rng(3), 70_000, fam)
    assert g.size == 70_000 and g.max() <= 3
    rng = np.random.default_rng(3)
    rng.integers(0, 4, size=70_000)
    cons_a = rng.integers(0, 4, size=500).astype(np.uint8)

    # the identical family's consensus is planted 4 times, on either strand
    k = np.lib.stride_tricks.sliding_window_view(g, 500)
    fwd = (k == cons_a).all(axis=1).sum()
    rev = (k == (3 - cons_a)[::-1]).all(axis=1).sum()
    assert fwd + rev == 4


def test_n_runs_and_reads_avoid_them():
    cfg = {"genome_bp": 50_000, "repeat_frac": 0.1, "genome_seed": 4,
           "n_runs": [[0, 5_000], [20_000, 300], [49_900, 100]]}
    g = genome.make_genome(cfg)
    plain = genome.gen_repeat_genome(np.random.default_rng(4), 50_000, 0.1)
    n = g == 4
    assert n.sum() == 5_400 and n[:5_000].all() and n[20_000:20_300].all() and n[-100:].all()
    assert (g[~n] == plain[~n]).all()
    p = traffic.draw_reads(np.random.default_rng(2), g, 5_000, TR)
    # no read spans an N, and reads start in every stretch between them
    for s, e in zip(p.start, p.start + p.span):
        assert not n[s:e].any()
    assert ((p.start > 5_000) & (p.start < 20_000)).any() and (p.start > 20_300).any()
    # without N the starts are the plain draw
    q = traffic.draw_reads(np.random.default_rng(2), plain, 5_000, TR)
    rng = np.random.default_rng(2)
    traffic._indels(rng, 5_000, 100, ERR)
    assert (q.start == rng.integers(0, 50_000 - 106, 5_000)).all()


def test_fastq_bytes_by_hand():
    reads = np.array([[0, 1, 2, 3], [3, 3, 0, 4]], np.uint8)
    quals = np.array([b"IIII", b"#I5I"]).view(np.uint8).reshape(2, 4)
    out = traffic.fastq_bytes(b"r", 41, reads, quals)
    assert out == b"@r000000041\nACGT\n+\nIIII\n@r000000042\nTTAN\n+\n#I5I\n"
    assert traffic.pool_name(b"p", 7) == b"p000000007"


def test_same_seed_same_reads():
    g = np.random.default_rng(1).integers(0, 4, 100_000).astype(np.uint8)
    x = traffic.draw_reads(np.random.default_rng(2**31 + 5), g, 100, TR)
    y = traffic.draw_reads(np.random.default_rng(2**31 + 5), g, 100, TR)
    assert (x.bases == y.bases).all() and (x.quals == y.quals).all()


def test_window_judges_the_sample_and_an_indel_sample():
    from snapbench import runner

    g = np.random.default_rng(1).integers(0, 4, 100_000).astype(np.uint8)
    tr = dict(TR, batch=64, pool_batches=3, sample=50, indel_sample=30,
              sizing_reads_per_s=64 * 5, pool_seed=9)
    w = runner.draw_window(tr, g, 2**31 + 7, 1.0)
    # 5 batches cycle through the pool of 3
    assert w.n_batches == 5 and w.pool_units == 192
    indel = np.flatnonzero(w.pool.span[np.arange(5 * 64) % 192] != 100)
    assert indel.size > 50
    picked = np.isin(indel, w.judged).sum()
    assert 30 <= picked <= 45 and 70 <= w.judged.size <= 80
    assert (np.diff(w.judged) > 0).all() and w.judged.max() < 5 * 64
    # the seed orders the same pool
    v = runner.draw_window(tr, g, 3, 1.0)
    assert sorted(map(bytes, w.pool.bases)) == sorted(map(bytes, v.pool.bases))
