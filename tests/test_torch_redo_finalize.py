"""post.finalize_exact_batch, the wide redo's batch finalize, against the
port's finalize_read row by row: every field equal with ==, match_prob
and prob_all bit for bit (the redo's records must stay byte-identical to
snap_tpu's, which finalizes each redo row with finalize_read).

The rows plant what finalize_read handles one read at a time: duplicate
slots at one locus, chains of 3+ reps in adjacent 48 bp bins at dist < 2
(the adjacent-element merge, whose losers drop out of the chain), ties
in dist, probability and AG score, ALT loci, LV distances above the
final ones (the Ukkonen gate), rows with no valid slot, a row whose
every rep the gate drops, a row with one likely rep (a unique MAPQ),
and a -dp fraction on half the rows.

The AG restructure screen of a chunk's or a batch's winners in one call
(SingleEndAligner._ag_flips) is held against the one-row screen
winner_record runs without it.
"""

import numpy as np
import pytest

import snap_tpu_torch.align.post as T

OFFSETS = np.array([0, 0, 0, 3, 20, 44, 47, 49, 70, 95, 96, 140, 300])
DISTS = np.array([0, 1, 1, 1, 2, 3, 5, 8, 12, 30])


def _rows(seed: int, K: int):
    rng = np.random.default_rng(seed)
    M = 48 if K == 16 else 6
    n_sites = max(3, K // 8)
    base = rng.integers(1_000, 2_000_000, size=(M, n_sites))
    site = rng.integers(0, n_sites, size=(M, K))
    cl = base[np.arange(M)[:, None], site] + rng.choice(OFFSETS, size=(M, K))
    dist = rng.choice(DISTS, size=(M, K)).astype(np.int32)
    # quantized probabilities and AG scores, so ties are common
    logp = (-0.5 * rng.integers(0, 8, size=(M, K))).astype(np.float32)
    logp = np.where(rng.random((M, K)) < 0.3,
                    -rng.random((M, K)).astype(np.float32) * 6, logp)
    ag = (100 - 5 * dist + rng.integers(0, 2, size=(M, K))).astype(np.int32)
    end = cl + 100 + rng.integers(-2, 3, size=(M, K))
    dirs = ((site + (rng.random((M, K)) < 0.1)) % 2).astype(np.uint8)
    lv = dist + np.where(rng.random((M, K)) < 0.2,
                         rng.integers(1, 40, size=(M, K)), 0)
    valid = rng.random((M, K)) < 0.85
    valid[0] = False                  # no valid slot
    lv[1] = 500                       # the gate drops every rep
    logp[2] = -20.0                   # one rep far likelier than the rest
    logp[2, 5], dist[2, 5], lv[2, 5], valid[2, 5] = 0.0, 0, 0, True
    ag[2, 5], cl[2, 5], end[2, 5] = 105, 500_000, 500_100
    # a -dp fraction on half the rows, as the redo applies it
    len_eff = rng.integers(50, 101, size=M).astype(np.int32)
    limit = np.minimum(127, (len_eff * 0.08).astype(np.int64))
    half = np.arange(M) >= M // 2
    valid &= ~half[:, None] | (dist <= limit[:, None])
    is_alt = cl > 1_600_000
    popular = rng.integers(0, 16, size=M).astype(np.int32)
    return (dist, logp, ag, end, cl, dirs, valid, popular), is_alt, lv


@pytest.mark.parametrize("K", [16, 512])
@pytest.mark.parametrize("use_affine_gap", [True, False])
@pytest.mark.parametrize("alt_awareness", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_equals_finalize_read(seed, alt_awareness, use_affine_gap, K):
    args, is_alt, lv = _rows(seed, K)
    kw = dict(
        use_affine_gap=use_affine_gap, is_alt=is_alt,
        alt_awareness=alt_awareness,
        max_score_gap_to_prefer_non_alt=64 if seed == 0 else 1,
        max_k=127 if seed == 0 else 20, extra_search_depth=1,
    )
    got, near = T.finalize_exact_batch(*args, lv_dists=lv, **kw)
    M = args[0].shape[0]
    assert len(got) == M and near.shape == (M,)
    assert near.any()                 # the adjacent merge fired
    kinds = set()
    for i in range(M):
        want, supp = T.finalize_read(
            *(a[i] for a in args[:7]), int(args[7][i]), lv_dists=lv[i],
            **{**kw, "is_alt": is_alt[i]},
        )
        assert supp is None
        assert got[i] == want, i
        kinds.add(want.status)
    assert got[0].status == got[1].status == "notfound"
    assert {"single", "multi"} <= kinds


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_ag_screen_equals_the_row_screen(seed):
    """SingleEndAligner._ag_flips screens a redo chunk's (or a two-phase
    batch's) winners in one ag_restructure_possible call: the rows
    winner_record would screen (found, dist >= 2, no indel, no clip) get
    the flag the one-row screen inside winner_record gives; the others
    get none."""
    from types import SimpleNamespace

    from snap_tpu_torch.align import single as S

    rng = np.random.default_rng(seed)
    G = rng.integers(0, 4, 20_000).astype(np.uint8)
    n, L, K = 40, 104, 4
    bases = rng.integers(0, 4, (n, L)).astype(np.uint8)
    fes = rng.choice([0, 2], n)
    plens = L - fes - rng.choice([0, 4], n)
    dirs = rng.integers(0, 2, n)
    starts = rng.integers(100, 19_000, n)
    dists = np.zeros(n, np.int64)
    for i in range(n):
        s, p = int(starts[i]), int(plens[i])
        kind = i % 4
        if kind == 0:      # a deletion of 1-3 bases near the end
            c, g = p - rng.integers(3, 9), rng.integers(1, 4)
            pat = np.concatenate([G[s:s + c], G[s + c + g:s + p + g]])
        elif kind == 1:    # an insertion of 1-3 bases near the end
            c, g = p - rng.integers(4, 9), rng.integers(1, 4)
            pat = np.concatenate([G[s:s + c], rng.integers(0, 4, g),
                                  G[s + c:s + p - g]]).astype(np.uint8)
        else:              # 0-4 substitutions
            pat = G[s:s + p].copy()
            at = rng.choice(p, kind + rng.integers(0, 3), replace=False)
            pat[at] = (pat[at] + 1) % 4
        dists[i] = int((pat != G[s:s + p]).sum())
        read = (3 - pat)[::-1] if dirs[i] else pat
        bases[i, fes[i]:fes[i] + p] = read
    batch = SimpleNamespace(bases=bases)
    rows = list(rng.permutation(n))
    chunk = list(rng.permutation(n))
    ks = rng.integers(0, K, n)
    indels = np.zeros((n, K), np.int32)
    clip_before = np.zeros((n, K), np.int16)
    clip_after = np.zeros((n, K), np.int16)
    finals = []
    for j in range(n):
        i = rows[chunk[j]]
        status = "notfound" if j % 9 == 8 else "single"
        if j % 7 == 3:
            indels[j, ks[j]] = 1
        if j % 11 == 5:
            (clip_before if j % 2 else clip_after)[j, ks[j]] = 3
        finals.append((T.ReadAlignment(
            status=status, cand_index=int(ks[j]), direction=int(dirs[i]),
            end_loc=int(starts[i] + plens[i]), dist=int(dists[i])), None))
    arrays = {"len_eff": plens[[rows[c] for c in chunk]],
              "indels": indels, "clip_before": clip_before,
              "clip_after": clip_after}
    me = SimpleNamespace(params=SimpleNamespace(use_affine_gap=True),
                         genome_np=G)
    winners = [(j, rows[c], ra) for j, (c, (ra, _)) in
               enumerate(zip(chunk, finals))]
    flips = S.SingleEndAligner._ag_flips(me, batch, arrays, winners, fes)
    want = {}
    for j, (ra, _) in enumerate(finals):
        k = ra.cand_index
        if (ra.status == "notfound" or ra.dist < 2 or indels[j, k]
                or clip_before[j, k] or clip_after[j, k]):
            continue
        i = rows[chunk[j]]
        p = int(arrays["len_eff"][j])
        want[j] = bool(S.ag_restructure_possible(
            G, bases, [i], [ra.direction], [ra.end_loc - p], [p],
            [int(fes[i])], [ra.dist])[0])
    assert flips == want
    assert set(want.values()) == {True, False}
    me.params.use_affine_gap = False
    assert S.SingleEndAligner._ag_flips(me, batch, arrays, winners, fes) == {}
