"""Host-side result finalization: merge, best selection, MAPQ.

Behavioral reference: SNAP's ScoreSet (BaseAligner.h:260-329):
- candidates aligning to nearby locations (within maxMergeDist=48) merge,
  keeping the better one and backing the loser's probability out of pAll
  (BaseAligner.cpp:1353-1443);
- best selection in the default affine-gap mode: higher agScore wins,
  ties by higher matchProbability (ScoreSet::updateBestScore); in LV
  mode (-G-): lower edit distance, ties by probability;
- MAPQ = min(70, -10*log10(1 - pBest/pAll)) - max(0, popular-10)/2
  (mapq.h:32-68), in float64 like the reference.

Merging uses the DP-reported LV alignment END location, identical for
duplicate discoveries of the same alignment regardless of seed anchor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..constants import MAPQ_MAX, MAX_MERGE_DIST


def ukkonen_included(
    rep_mask: np.ndarray,   # [B, K] bool, reps in original (weight-rank) slots
    d: np.ndarray,          # [B, K] int final distances (post AG clipping)
    alt: np.ndarray,        # [B, K] bool
    max_k: int,
    extra_search_depth: int,
    max_score_gap: int,
    lv: np.ndarray | None = None,  # [B, K] pre-clipping LV distances (gate
                                   # key; SNAP's limit applies inside
                                   # computeEditDistance before AG clipping)
) -> np.ndarray:
    """Which reps SNAP would have scored within its dynamic limit.

    SNAP scores candidates in weight order under a running Ukkonen
    limit (BaseAligner::scoreLimit, BaseAligner.cpp:2556-2570):
    extraSearchDepth + min(maxK, min(bestAll + gap, bestNonAlt)) for
    non-ALT locations (ALT variant symmetric). Candidates above the
    limit at their turn get ScoreAboveLimit — no result, no pAll
    contribution. Our candidate slots come out of top_k by weight, so
    slot order IS SNAP's weight order; the running bests update only
    with candidates that scored within their limit, exactly like
    ScoreSet::bestScore. Without this, pAll (and therefore MAPQ) is
    deflated on repetitive genomes where many in-budget but worse
    candidates exist.
    """
    B, K = d.shape
    if lv is None:
        lv = d
    INF = np.int64(1 << 40)
    run_all = np.full(B, INF)
    run_na = np.full(B, INF)
    inc = np.zeros((B, K), dtype=bool)
    D = np.int64(extra_search_depth)
    gap = np.int64(max_score_gap)
    mk = np.int64(max_k)
    for k in range(K):
        m = rep_mask[:, k]
        if not m.any():
            continue
        a = alt[:, k]
        lim_na = D + np.minimum(mk, np.minimum(run_all + gap, run_na))
        lim_alt = D + np.minimum(
            mk, np.minimum(run_all, run_na - np.minimum(gap, run_na))
        )
        lim = np.where(a, lim_alt, lim_na)
        ok = m & (lv[:, k] <= lim)
        inc[:, k] = ok
        run_all = np.where(ok, np.minimum(run_all, d[:, k]), run_all)
        run_na = np.where(
            ok & ~a, np.minimum(run_na, d[:, k]), run_na
        )
    return inc


@dataclass
class ReadAlignment:
    status: str            # 'single' | 'multi' | 'notfound' | 'filtered'
    cand_index: int = -1   # index into the read's candidate arrays
    direction: int = 0
    end_loc: int = 0
    dist: int = -1
    mapq: int = 0
    match_prob: float = 0.0
    prob_all: float = 0.0
    supplementary: bool = False  # ALT supplementary emission (-ea)


def compute_mapq(p_all: float, p_best: float, popular_skipped: int) -> int:
    p_all = max(p_all, p_best)
    if p_best <= 0.0:
        return 0
    ratio = p_best / p_all
    if ratio >= 1.0:
        base = MAPQ_MAX
    else:
        base = min(MAPQ_MAX, int(-10.0 * math.log10(1.0 - ratio)))
    return max(0, base - max(0, popular_skipped - 10) // 2)


def compute_mapq_array(
    p_all: np.ndarray, p_best: np.ndarray, popular: np.ndarray
) -> np.ndarray:
    """Vectorized compute_mapq (mapq.h:32-68) over [B] arrays."""
    p_all = np.maximum(p_all, p_best)
    ratio = np.where(p_all > 0, p_best / np.maximum(p_all, 1e-300), 0.0)
    with np.errstate(divide="ignore"):
        base = np.where(
            ratio >= 1.0,
            MAPQ_MAX,
            np.minimum(
                MAPQ_MAX,
                (-10.0 * np.log10(np.maximum(1.0 - ratio, 1e-300))).astype(
                    np.int64
                ),
            ),
        )
    base = np.where(p_best <= 0.0, 0, base)
    return np.maximum(0, base - np.maximum(0, popular - 10) // 2).astype(
        np.int64
    )


def finalize_batch(
    dists: np.ndarray,        # [B, K]
    log_probs: np.ndarray,
    ag_scores: np.ndarray,
    end_locs: np.ndarray,
    cand_locs: np.ndarray,
    directions: np.ndarray,
    valid: np.ndarray,
    popular: np.ndarray,      # [B]
    use_affine_gap: bool = True,
    is_alt: np.ndarray | None = None,
    alt_awareness: bool = True,
    max_score_gap_to_prefer_non_alt: int = 64,
    max_k: int = 127,
    extra_search_depth: int = 1,
    lv_dists: np.ndarray | None = None,
    use_ukkonen: bool = True,
) -> list[tuple[ReadAlignment, None]]:
    """Vectorized finalize_read over a whole batch.

    Same semantics as finalize_read (bin merge, dual ALT score sets,
    MAPQ) but as a handful of global lexsorts + segment reductions over
    [B*K] flattened candidates instead of a Python loop per read. Rows
    needing the rare nearby-bin merge (adjacent 48bp elements with
    score < 2, BaseAligner.cpp:1396-1435) fall back to the exact
    per-read path, as do rows needing supplementary ALT emission.

    Returns a list of (primary, None) tuples aligned with rows.
    """
    B, K = dists.shape
    rows = np.repeat(np.arange(B, dtype=np.int64), K)
    d = dists.reshape(-1).astype(np.int64)
    lp = log_probs.reshape(-1).astype(np.float64)
    ag = ag_scores.reshape(-1).astype(np.int64)
    e = end_locs.reshape(-1).astype(np.int64)
    cl = cand_locs.reshape(-1).astype(np.int64)
    dr = directions.reshape(-1).astype(np.int64)
    v = valid.reshape(-1).astype(bool)
    alt = (
        is_alt.reshape(-1).astype(bool)
        if is_alt is not None
        else np.zeros(B * K, dtype=bool)
    )
    probs = np.exp(lp)
    bins = cl // MAX_MERGE_DIST

    # push invalid entries to the end of each row's sort block
    dr_k = np.where(v, dr, 9)
    # rep selection inside each (row, dir, bin) cluster: lowest dist,
    # then highest prob (BaseAligner.cpp:1363-1371)
    order = np.lexsort((cl, -probs, d, bins, dr_k, rows))
    orig_of_sorted = order  # sorted slot -> original flat [B*K] index
    ro, dro, bo, do_, po, eo, clo, ago, alto, vo = (
        rows[order], dr_k[order], bins[order], d[order], probs[order],
        e[order], cl[order], ag[order], alt[order], v[order],
    )
    first = np.ones(B * K, dtype=bool)
    first[1:] = (
        (ro[1:] != ro[:-1]) | (dro[1:] != dro[:-1]) | (bo[1:] != bo[:-1])
    )
    reps = first & vo
    ri = np.flatnonzero(reps)

    # rows that need the exact nearby-element merge: consecutive reps in
    # the same (row, dir) within 48bp where the better score < 2
    fallback = np.zeros(B, dtype=bool)
    if ri.size > 1:
        a, b = ri[:-1], ri[1:]
        near = (
            (ro[a] == ro[b]) & (dro[a] == dro[b])
            & (np.abs(clo[b] - clo[a]) <= MAX_MERGE_DIST)
            & (np.minimum(do_[a], do_[b]) < 2)
        )
        fallback[ro[a[near]]] = True

    # Ukkonen dynamic score limit (see ukkonen_included): reps SNAP
    # would never have scored are dropped from results and pAll alike
    rep_mask2 = np.zeros(B * K, dtype=bool)
    rep_mask2[orig_of_sorted[ri]] = True
    alt_orig = (
        is_alt.astype(bool)
        if is_alt is not None
        else np.zeros((B, K), dtype=bool)
    )
    if use_ukkonen:
        inc = ukkonen_included(
            rep_mask2.reshape(B, K), dists.astype(np.int64), alt_orig,
            max_k, extra_search_depth, max_score_gap_to_prefer_non_alt,
            lv=(
                lv_dists.astype(np.int64) if lv_dists is not None else None
            ),
        )
        ri = ri[inc.reshape(-1)[orig_of_sorted[ri]]]

    p_all = np.bincount(ri_rows := ro[ri], weights=po[ri], minlength=B)

    def best_of(sel_reps: np.ndarray):
        """Per-row best rep among sel_reps by (ag desc, prob desc, e asc)
        [or (d asc, prob desc, e asc) in -G- mode]. Returns index arrays
        aligned to rows (or -1)."""
        if use_affine_gap:
            o2 = np.lexsort(
                (eo[sel_reps], -po[sel_reps], -ago[sel_reps], ro[sel_reps])
            )
        else:
            o2 = np.lexsort(
                (eo[sel_reps], -po[sel_reps], do_[sel_reps], ro[sel_reps])
            )
        s = sel_reps[o2]
        f2 = np.ones(len(s), dtype=bool)
        f2[1:] = ro[s][1:] != ro[s][:-1]
        chosen = s[f2]
        out = np.full(B, -1, dtype=np.int64)
        out[ro[chosen]] = chosen
        return out

    best_all = best_of(ri)
    if alt_awareness and alt.any():
        na = ri[~alto[ri]]
        best_na = best_of(na) if na.size else np.full(B, -1, np.int64)
        p_all_na = (
            np.bincount(ro[na], weights=po[na], minlength=B)
            if na.size
            else np.zeros(B)
        )
        use_na = (best_na >= 0) & (
            np.where(best_na >= 0, do_[np.maximum(best_na, 0)], 1 << 30)
            <= np.where(best_all >= 0, do_[np.maximum(best_all, 0)], 0)
            + max_score_gap_to_prefer_non_alt
        )
        chosen = np.where(use_na, best_na, best_all)
        chosen_pall = np.where(use_na, p_all_na, p_all)
    else:
        chosen = best_all
        chosen_pall = p_all

    p_best = np.where(chosen >= 0, po[np.maximum(chosen, 0)], 0.0)
    mapq = compute_mapq_array(chosen_pall, p_best, popular.astype(np.int64))

    results: list[tuple[ReadAlignment, None]] = []
    orig_index = order  # position in flattened [B*K] for each sorted slot
    for i in range(B):
        c = chosen[i]
        if c < 0:
            results.append((ReadAlignment(status="notfound"), None))
            continue
        if fallback[i]:
            results.append(
                finalize_read(
                    dists[i], log_probs[i], ag_scores[i], end_locs[i],
                    cand_locs[i], directions[i], valid[i], int(popular[i]),
                    use_affine_gap=use_affine_gap,
                    is_alt=is_alt[i] if is_alt is not None else None,
                    alt_awareness=alt_awareness,
                    max_score_gap_to_prefer_non_alt=(
                        max_score_gap_to_prefer_non_alt
                    ),
                    max_k=max_k,
                    extra_search_depth=extra_search_depth,
                    lv_dists=(
                        lv_dists[i] if lv_dists is not None else None
                    ),
                    use_ukkonen=use_ukkonen,
                )
            )
            continue
        flat = orig_index[c]
        results.append((
            ReadAlignment(
                status="single" if mapq[i] >= 10 else "multi",
                cand_index=int(flat % K),
                direction=int(dro[c]),
                end_loc=int(eo[c]),
                dist=int(do_[c]),
                mapq=int(mapq[i]),
                match_prob=float(po[c]),
                prob_all=float(chosen_pall[i]),
            ),
            None,
        ))
    return results


def finalize_exact_batch(
    dists: np.ndarray,        # [M, K]
    log_probs: np.ndarray,
    ag_scores: np.ndarray,
    end_locs: np.ndarray,
    cand_locs: np.ndarray,
    directions: np.ndarray,
    valid: np.ndarray,
    popular: np.ndarray,      # [M]
    use_affine_gap: bool = True,
    is_alt: np.ndarray | None = None,
    alt_awareness: bool = True,
    max_score_gap_to_prefer_non_alt: int = 64,
    max_k: int = 127,
    extra_search_depth: int = 1,
    lv_dists: np.ndarray | None = None,
    use_ukkonen: bool = True,
) -> tuple[list[ReadAlignment], np.ndarray]:
    """finalize_read(..., emit_alt=False) over M rows at once, exactly.

    Every field of every row equals finalize_read's, match_prob and
    prob_all bit for bit (finalize_batch sums pAll with a bincount and
    falls back to finalize_read on rows needing the adjacent-element
    merge; this twin does neither):
    - one stable sort of the valid slots by (row, direction, bin, dist,
      -probability, cand_loc) lists the clusters in finalize_read's
      order, each led by its rep (lower dist, higher probability, then
      earlier in cluster order);
    - the adjacent-element merge finds its near pairs vectorized and
      walks only those, in order, so a loser drops out of the chain
      exactly as in finalize_read's keep[] loop;
    - the Ukkonen replay runs once over [M, K];
    - pAll is np.sum over one contiguous float64 array of a row's
      surviving reps in cluster order, as finalize_read's pick sums it,
      and MAPQ is the scalar compute_mapq.

    Returns (alignments aligned with rows, [M] bool rows in which the
    adjacent-element merge fired).
    """
    M, K = dists.shape
    flat = np.flatnonzero(np.asarray(valid, dtype=bool).reshape(-1))
    row = flat // K
    slot = flat % K
    d = dists.reshape(-1)[flat].astype(np.int64)
    probs = np.exp(log_probs.reshape(-1)[flat].astype(np.float64))
    ag = ag_scores.reshape(-1)[flat].astype(np.int64)
    e = end_locs.reshape(-1)[flat].astype(np.int64)
    cl = cand_locs.reshape(-1)[flat].astype(np.int64)
    dr = directions.reshape(-1)[flat].astype(np.int64)
    alt_orig = (
        is_alt.astype(bool) if is_alt is not None
        else np.zeros((M, K), dtype=bool)
    )
    alt = alt_orig.reshape(-1)[flat]
    bins = cl // MAX_MERGE_DIST

    # clusters in finalize_read's order; within a cluster the rep sorts
    # first by (dist, -prob), ties kept in cluster order (cand_loc, slot)
    order = np.lexsort((cl, -probs, d, bins, dr, row))
    ro, bo, dro = row[order], bins[order], dr[order]
    first = np.ones(order.size, dtype=bool)
    first[1:] = (
        (ro[1:] != ro[:-1]) | (dro[1:] != dro[:-1]) | (bo[1:] != bo[:-1])
    )
    reps = order[first]  # one per cluster, in cluster order

    # adjacent-element merge (finalize_read's keep[] loop): consecutive
    # reps of a row and direction within 48 bp, the better score < 2
    near_rows = np.zeros(M, dtype=bool)
    keep = np.ones(reps.size, dtype=bool)
    if reps.size > 1:
        a, b = reps[:-1], reps[1:]
        near = (
            (row[a] == row[b]) & (dr[a] == dr[b])
            & (np.abs(cl[b] - cl[a]) <= MAX_MERGE_DIST)
            & (np.minimum(d[a], d[b]) < 2)
        )
        pairs = np.flatnonzero(near)
        if pairs.size:
            near_rows[row[a[pairs]]] = True
            # (d[j], -p[j]) < (d[i], -p[i]): the later rep wins
            later = (d[b] < d[a]) | ((d[b] == d[a]) & (-probs[b] < -probs[a]))
            for p, w in zip(pairs.tolist(), later[pairs].tolist()):
                if keep[p]:
                    keep[p if w else p + 1] = False
    reps = reps[keep]

    if use_ukkonen:
        rep_mask = np.zeros((M, K), dtype=bool)
        rep_mask[row[reps], slot[reps]] = True
        inc = ukkonen_included(
            rep_mask, dists.astype(np.int64), alt_orig, max_k,
            extra_search_depth, max_score_gap_to_prefer_non_alt,
            lv=lv_dists.astype(np.int64) if lv_dists is not None else None,
        )
        reps = reps[inc[row[reps], slot[reps]]]

    # per-row best in the order finalize_read's pick uses; reps stay in
    # cluster order, so the stable sort breaks full ties the same way
    def best_of(sel: np.ndarray) -> np.ndarray:
        if use_affine_gap:
            o = np.lexsort((e[sel], -probs[sel], -ag[sel], row[sel]))
        else:
            o = np.lexsort((e[sel], -probs[sel], d[sel], row[sel]))
        s = sel[o]
        f = np.ones(s.size, dtype=bool)
        f[1:] = row[s][1:] != row[s][:-1]
        out = np.full(M, -1, dtype=np.int64)
        out[row[s[f]]] = s[f]
        return out

    def bounds(sel: np.ndarray) -> np.ndarray:
        return np.searchsorted(row[sel], np.arange(M + 1))

    best_all = best_of(reps)
    p_reps = probs[reps]  # contiguous, rows in cluster order
    cut = bounds(reps)
    use_alt_sets = alt_awareness and bool(alt[reps].any())
    if use_alt_sets:
        na = reps[~alt[reps]]
        best_na = best_of(na)
        p_na = probs[na]
        cut_na = bounds(na)
        row_has_alt = np.zeros(M, dtype=bool)
        row_has_alt[row[reps[alt[reps]]]] = True

    out: list[ReadAlignment] = []
    for i in range(M):
        r = int(best_all[i])
        if r < 0:
            out.append(ReadAlignment(status="notfound"))
            continue
        p_all = float(np.sum(p_reps[cut[i]:cut[i + 1]]))
        if use_alt_sets and row_has_alt[i]:
            # finalize_read's two score sets: the non-ALT best unless it
            # is more than the gap worse than the overall best
            r_na = int(best_na[i])
            if r_na >= 0 and not (
                int(d[r_na]) > int(d[r]) + max_score_gap_to_prefer_non_alt
            ):
                r = r_na
                p_all = float(np.sum(p_na[cut_na[i]:cut_na[i + 1]]))
        p_best = float(probs[r])
        mapq = compute_mapq(p_all, p_best, int(popular[i]))
        out.append(ReadAlignment(
            status="single" if mapq >= 10 else "multi",
            cand_index=int(slot[r]),
            direction=int(dr[r]),
            end_loc=int(e[r]),
            dist=int(d[r]),
            mapq=mapq,
            match_prob=p_best,
            prob_all=p_all,
        ))
    return out, near_rows


def collect_secondary_results(
    dists: np.ndarray,
    log_probs: np.ndarray,
    ag_scores: np.ndarray,
    end_locs: np.ndarray,
    cand_locs: np.ndarray,
    directions: np.ndarray,
    valid: np.ndarray,
    primary_cand_index: int,
    best_dist: int,
    max_k: int,
    max_edit_distance_for_secondary: int,
    max_secondary: int = 0x7FFFFFFF,
    is_alt: np.ndarray | None = None,
    alt_awareness: bool = True,
) -> list[ReadAlignment]:
    """Secondary alignments within -om edit distance of the best.

    Mirrors BaseAligner::finalizeSecondaryResults (BaseAligner.cpp:
    2423-2553): keep merged candidates scoring <= min(maxK, best + om),
    drop the primary itself, sort by score, truncate to -omax. ALT
    locations are flagged supplementary under ALT awareness
    (BaseAligner.cpp:2482). The per-contig cap (-mpc) is applied by the
    driver, which knows the contig map.
    """
    sel = np.flatnonzero(valid)
    if sel.size == 0 or max_edit_distance_for_secondary < 0:
        return []
    d = dists[sel].astype(np.int64)
    lp = log_probs[sel].astype(np.float64)
    e = end_locs[sel].astype(np.int64)
    cl = cand_locs[sel].astype(np.int64)
    dr = directions[sel].astype(np.int64)
    alt = (
        is_alt[sel].astype(bool)
        if is_alt is not None
        else np.zeros(sel.size, dtype=bool)
    )
    probs = np.exp(lp)

    # same bin-merge topology as finalize_read so secondaries are the
    # non-winning merged representatives
    bins = cl // MAX_MERGE_DIST
    order = np.lexsort((cl, bins, dr))
    d, probs, e, cl, dr, bins, sel2, alt = (
        d[order], probs[order], e[order], cl[order], dr[order],
        bins[order], sel[order], alt[order],
    )
    new_cluster = np.ones(len(d), dtype=bool)
    new_cluster[1:] = (dr[1:] != dr[:-1]) | (bins[1:] != bins[:-1])
    cluster_id = np.cumsum(new_cluster) - 1
    reps = []
    for c in range(cluster_id[-1] + 1):
        idxs = np.flatnonzero(cluster_id == c)
        reps.append(idxs[np.lexsort((-probs[idxs], d[idxs]))[0]])
    reps = np.array(reps)

    worst = min(max_k, best_dist + max_edit_distance_for_secondary)
    out: list[ReadAlignment] = []
    for r in reps:
        if int(sel2[r]) == primary_cand_index or int(d[r]) > worst:
            continue
        out.append(
            ReadAlignment(
                status="multi",
                cand_index=int(sel2[r]),
                direction=int(dr[r]),
                end_loc=int(e[r]),
                dist=int(d[r]),
                mapq=0,
                match_prob=float(probs[r]),
                supplementary=alt_awareness and bool(alt[r]),
            )
        )
    out.sort(key=lambda ra: ra.dist)
    return out[:max_secondary]


def finalize_read(
    dists: np.ndarray,
    log_probs: np.ndarray,
    ag_scores: np.ndarray,
    end_locs: np.ndarray,
    cand_locs: np.ndarray,
    directions: np.ndarray,
    valid: np.ndarray,
    popular: int,
    use_affine_gap: bool = True,
    is_alt: np.ndarray | None = None,
    alt_awareness: bool = True,
    emit_alt: bool = False,
    max_score_gap_to_prefer_non_alt: int = 64,
    max_k: int = 127,
    extra_search_depth: int = 1,
    lv_dists: np.ndarray | None = None,
    use_ukkonen: bool = True,
) -> tuple[ReadAlignment, ReadAlignment | None]:
    """Merge scored candidates of one read and pick the primary.

    Merge topology mirrors SNAP's candidate hash table: candidates bin
    by (direction, candidate_location // 48) (hashTableElementSize,
    BaseAligner.h:174-258); in-bin duplicates keep (lower dist, higher
    prob). Bins in ADJACENT elements additionally merge only when the
    better rep's score < 2 (BaseAligner.cpp:1396-1407 nearby-element
    check is gated on `score < 2`), backing the loser's probability out
    of pAll.

    ALT awareness (BaseAligner.cpp:1028-1056, 1766-1783): two score
    sets accumulate in parallel — all candidates, and non-ALT only.
    The non-ALT set is emitted unless its best score (edit distance) is
    more than max_score_gap_to_prefer_non_alt worse than the overall
    best. When the non-ALT set wins but the overall best is a distinct
    ALT location and emit_alt is set, that ALT alignment is returned as
    a supplementary result (firstALTResult).

    Returns (primary, alt_supplementary | None).
    """
    sel = np.flatnonzero(valid)
    if sel.size == 0:
        return ReadAlignment(status="notfound"), None
    d = dists[sel].astype(np.int64)
    lp = log_probs[sel].astype(np.float64)
    ag = ag_scores[sel].astype(np.int64)
    e = end_locs[sel].astype(np.int64)
    cl = cand_locs[sel].astype(np.int64)
    dr = directions[sel].astype(np.int64)
    alt = (
        is_alt[sel].astype(bool)
        if is_alt is not None
        else np.zeros(sel.size, dtype=bool)
    )
    probs = np.exp(lp)

    bins = cl // MAX_MERGE_DIST
    order = np.lexsort((cl, bins, dr))
    d, probs, e, cl, dr, ag, bins, sel, alt = (
        d[order], probs[order], e[order], cl[order], dr[order], ag[order],
        bins[order], sel[order], alt[order],
    )

    new_cluster = np.ones(len(d), dtype=bool)
    new_cluster[1:] = (dr[1:] != dr[:-1]) | (bins[1:] != bins[:-1])
    cluster_id = np.cumsum(new_cluster) - 1

    # in-bin rep: lower edit distance, ties by higher probability
    # (the element merge compares (bestScore, matchProbability),
    # BaseAligner.cpp:1363-1371)
    reps = []
    for c in range(cluster_id[-1] + 1):
        idxs = np.flatnonzero(cluster_id == c)
        r = idxs[np.lexsort((-probs[idxs], d[idxs]))[0]]
        reps.append(r)
    reps = np.array(reps)

    # adjacent-element merge, only when the surviving rep's score < 2
    keep = np.ones(len(reps), dtype=bool)
    for a in range(len(reps) - 1):
        i, j = reps[a], reps[a + 1]
        if not (keep[a] and dr[i] == dr[j]):
            continue
        if abs(int(cl[j]) - int(cl[i])) <= MAX_MERGE_DIST and (
            min(d[i], d[j]) < 2
        ):
            # keep the better one (lower dist, then higher prob)
            if (d[j], -probs[j]) < (d[i], -probs[i]):
                keep[a] = False
            else:
                keep[a + 1] = False

    reps = reps[keep]

    # Ukkonen dynamic score limit: drop reps SNAP would never have
    # scored (see ukkonen_included) — they exist neither as results
    # nor in pAll
    K_all = len(dists)
    rep_mask = np.zeros((1, K_all), dtype=bool)
    rep_mask[0, sel[reps]] = True
    alt_orig = (
        is_alt.astype(bool)
        if is_alt is not None
        else np.zeros(K_all, dtype=bool)
    )
    if use_ukkonen:
        inc = ukkonen_included(
            rep_mask, dists.astype(np.int64)[None], alt_orig[None],
            max_k, extra_search_depth, max_score_gap_to_prefer_non_alt,
            lv=(
                lv_dists.astype(np.int64)[None]
                if lv_dists is not None
                else None
            ),
        )
        reps = reps[inc[0, sel[reps]]]
    if reps.size == 0:
        return ReadAlignment(status="notfound"), None

    def pick(subset: np.ndarray):
        """Best rep + (pBest, pAll) over a score-set subset of reps."""
        if subset.size == 0:
            return None
        p_all = float(np.sum(probs[subset]))
        if use_affine_gap:
            keys = np.lexsort((e[subset], -probs[subset], -ag[subset]))
        else:
            keys = np.lexsort((e[subset], -probs[subset], d[subset]))
        r = subset[keys[0]]
        return r, float(probs[r]), p_all

    def mk(r: int, p_best: float, p_all: float, supplementary: bool = False):
        mapq = compute_mapq(p_all, p_best, popular)
        return ReadAlignment(
            status="single" if mapq >= 10 else "multi",
            cand_index=int(sel[r]),
            direction=int(dr[r]),
            end_loc=int(e[r]),
            dist=int(d[r]),
            mapq=mapq,
            match_prob=p_best,
            prob_all=p_all,
            supplementary=supplementary,
        )

    all_set = pick(reps)
    assert all_set is not None
    r_all, pb_all, pa_all = all_set
    non_alt = pick(reps[~alt[reps]]) if alt_awareness else None

    if non_alt is None or (
        int(d[non_alt[0]]) > int(d[r_all]) + max_score_gap_to_prefer_non_alt
    ):
        # emit the all-candidates set (no usable non-ALT alignment)
        return mk(r_all, pb_all, pa_all), None

    r_na, pb_na, pa_na = non_alt
    primary = mk(r_na, pb_na, pa_na)
    alt_supp = None
    if emit_alt:
        # firstALTResult (BaseAligner.cpp:1040-1043): the best ALT
        # alignment, emitted when it scores at least as well as the
        # non-ALT primary. MAPQ uses the all-candidates probability mass.
        alt_best = pick(reps[alt[reps]])
        if alt_best is not None and int(d[alt_best[0]]) <= int(d[r_na]):
            alt_supp = mk(alt_best[0], alt_best[1], pa_all, supplementary=True)
    return primary, alt_supp
