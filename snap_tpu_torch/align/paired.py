"""Paired-end alignment: batched intersection + chimeric fallback.

Behavioral reference: SNAP's IntersectingPairedEndAligner (the fuzzy
set-intersection algorithm, IntersectingPairedEndAligner.cpp) wrapped by
ChimericPairedEndAligner (ChimericPairedEndAligner.cpp:126-460).

TPU-first re-expression: instead of the sequential dual-cursor
binary-search walk over per-seed hit lists (Phase 2,
IntersectingPairedEndAligner.cpp:530-717), both ends run the standard
batched candidate+scoring wavefront (one device batch holding all ends),
and pairing is a windowed join over each pair's K x K scored candidates:
opposite directions, spacing within [minSpacing, maxSpacing]
(PairedAligner.cpp:55-56 defaults 0/1000). Pair selection, merge anchors
(50bp on both ends, IntersectingPairedEndAligner.h:517-548), pair MAPQ
from pairProbability sums, and the chimeric single-end fallback with the
MAPQ/3 penalty (ChimericPairedEndAligner.cpp:421) follow the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    DEFAULT_MAX_SPACING,
    DEFAULT_MIN_SPACING,
    PAIRED_MERGE_ANCHOR_DIST,
    SNP_PROB,
    indel_probability_table,
    phred_to_probability_table,
)
from ..genome import reverse_complement_codes
from .post import ReadAlignment, compute_mapq, finalize_read

MIN_SCORE_REALIGNMENT = 3       # ChimericPairedEndAligner.h:60
MIN_AG_SCORE_IMPROVEMENT = 24   # ChimericPairedEndAligner.h:62


@dataclass
class PairEndResult:
    status: str                  # 'single' | 'multi' | 'notfound' | 'filtered'
    cand_index: int = -1
    direction: int = 0
    end_loc: int = 0
    dist: int = -1
    mapq: int = 0
    aligned_as_pair: bool = False
    supplementary: bool = False  # ALT supplementary emission (-ea)


def _pair_combos(c0: dict, c1: dict, min_spacing: int, max_spacing: int):
    """All valid pair candidate combinations for one read pair.

    c0/c1: dicts of per-candidate numpy arrays (dist, log_prob, ag_score,
    end_loc, cand_loc, direction, valid). Returns index arrays (i0, i1).
    """
    v0 = np.flatnonzero(c0["valid"])
    v1 = np.flatnonzero(c1["valid"])
    if v0.size == 0 or v1.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    l0 = c0["cand_loc"][v0][:, None]
    l1 = c1["cand_loc"][v1][None, :]
    d0 = c0["direction"][v0][:, None]
    d1 = c1["direction"][v1][None, :]
    delta = np.abs(l0.astype(np.int64) - l1.astype(np.int64))
    ok = (d0 != d1) & (delta <= max_spacing) & (delta >= min_spacing)
    i0, i1 = np.nonzero(ok)
    return v0[i0], v1[i1]


def finalize_pair(
    c0: dict,
    c1: dict,
    popular0: int,
    popular1: int,
    min_spacing: int = DEFAULT_MIN_SPACING,
    max_spacing: int = DEFAULT_MAX_SPACING,
    len_ok0: bool = True,
    len_ok1: bool = True,
    first_alt_start: int | None = None,
    alt_awareness: bool = True,
    emit_alt: bool = False,
    max_score_gap_to_prefer_non_alt: int = 64,
    force_spacing: bool = False,
    min_score_realignment: int = MIN_SCORE_REALIGNMENT,   # -en
    min_ag_improvement: int = MIN_AG_SCORE_IMPROVEMENT,   # -eg
    flatten_mapq_at_or_below: int = 3,                    # -fmb
    max_secondary_edit: int = -1,                         # -om
    max_secondary: int = 0x7FFFFFFF,                      # -omax
    max_k: int = 127,
    extra_search_depth: int = 1,
    use_ukkonen: bool = True,
    counters: dict | None = None,
) -> tuple[
    PairEndResult, PairEndResult,
    tuple[PairEndResult, PairEndResult] | None,
    list[tuple[PairEndResult, PairEndResult]],
]:
    """Pick the pair (or chimeric single) results for one read pair.

    Returns (end0, end1, alt_supplementary_pair | None, secondaries).
    ALT handling mirrors the intersecting aligner's dual score sets
    (IntersectingPairedEndAligner.cpp:834,1211,1251-1257): a pair is
    non-ALT when its location is below the first-ALT boundary; the
    non-ALT set is emitted unless its best pair score is more than
    max_score_gap worse, and the distinct best ALT pair becomes a
    supplementary result under emit_alt.

    Secondaries (-om): merge-anchor representative pairs other than the
    primary whose pair score is within max_secondary_edit of the best
    pair (and <= 2*max_k), sorted by pair score, truncated to -omax and
    emitted with MAPQ 0 (IntersectingPairedEndAligner.cpp:999-1049).
    """
    if not (len_ok0 or len_ok1):
        return (
            PairEndResult("filtered"), PairEndResult("filtered"), None, []
        )

    alt_boundary = (
        first_alt_start
        if (first_alt_start is not None and alt_awareness)
        else None
    )

    pair_found = False
    best = None
    best_alt = None  # distinct best ALT pair (for emit_alt)
    p_all_pairs = 0.0
    p_best_pair = 0.0
    alt_mapqs = (0, 0)
    if len_ok0 and len_ok1:
        i0s, i1s = _pair_combos(c0, c1, min_spacing, max_spacing)
        if i0s.size:
            pair_found = True
            # Phase-3 parity: SNAP selects pairs on the LANDAU-VISHKIN
            # values — agScore is the LV approximation readLen*match -
            # score*(match+sub) (IntersectingPairedEndAligner.cpp:
            # 3352-3359) and matchProbability is the LV one; affine
            # values only replace the winner's in phase 4 (:2509-2626).
            if "lv_ag_score" in c0:
                ag = c0["lv_ag_score"][i0s] + c1["lv_ag_score"][i1s]
                lp = (
                    c0["lv_log_prob"][i0s].astype(np.float64)
                    + c1["lv_log_prob"][i1s].astype(np.float64)
                )
                dsum = (
                    c0["lv_dist"][i0s].astype(np.int64)
                    + c1["lv_dist"][i1s].astype(np.int64)
                )
            else:  # legacy callers without LV-side arrays
                ag = c0["ag_score"][i0s] + c1["ag_score"][i1s]
                lp = c0["log_prob"][i0s].astype(np.float64) + c1[
                    "log_prob"
                ][i1s].astype(np.float64)
                dsum = c0["dist"][i0s].astype(np.int64) + c1["dist"][
                    i1s
                ].astype(np.int64)
            probs = np.exp(lp)
            # phase-4 comparison values (per-end affine when escalated)
            ag_aff = c0["ag_score"][i0s] + c1["ag_score"][i1s]
            lp_aff = c0["log_prob"][i0s].astype(np.float64) + c1[
                "log_prob"
            ][i1s].astype(np.float64)
            probs_aff = np.exp(lp_aff)
            e0 = c0["end_loc"][i0s].astype(np.int64)
            e1 = c1["end_loc"][i1s].astype(np.int64)
            pair_is_alt = (
                (c0["cand_loc"][i0s].astype(np.int64) >= alt_boundary)
                | (c1["cand_loc"][i1s].astype(np.int64) >= alt_boundary)
                if alt_boundary is not None
                else np.zeros(i0s.size, dtype=bool)
            )
            # merge anchors: pairs with both ends within 50 collapse,
            # keeping the better (agScore, probability)
            order = np.lexsort((e1, e0))
            reps: list[int] = []
            for oi in order:
                merged = False
                for rj in reps:
                    if (
                        abs(int(e0[oi]) - int(e0[rj])) <= PAIRED_MERGE_ANCHOR_DIST
                        and abs(int(e1[oi]) - int(e1[rj])) <= PAIRED_MERGE_ANCHOR_DIST
                    ):
                        merged = True
                        # keep the better of the two as the rep
                        if (-ag[oi], -probs[oi]) < (-ag[rj], -probs[rj]):
                            reps[reps.index(rj)] = oi
                        break
                if not merged:
                    reps.append(oi)
            reps_arr = np.array(reps)
            nonalt_reps = reps_arr[~pair_is_alt[reps_arr]]

            def set_best(subset):
                if subset.size == 0:
                    return None
                p_all = float(np.sum(probs[subset]))
                bi = min(subset, key=lambda r: (-ag[r], -probs[r]))
                return int(bi), float(probs[bi]), p_all

            all_best = set_best(reps_arr)
            na_best = set_best(nonalt_reps)
            bi_all = all_best[0]
            if na_best is None or (
                int(dsum[na_best[0]])
                > int(dsum[bi_all]) + max_score_gap_to_prefer_non_alt
            ):
                bi, p_best_pair, p_all_pairs = all_best
                chosen_subset = reps_arr
            else:
                bi, p_best_pair, p_all_pairs = na_best
                chosen_subset = nonalt_reps
                if emit_alt:
                    # best ALT pair as supplementary when it scores at
                    # least as well as the non-ALT primary pair
                    alt_best = set_best(reps_arr[pair_is_alt[reps_arr]])
                    if alt_best is not None and int(dsum[alt_best[0]]) <= int(
                        dsum[bi]
                    ):
                        amapq0 = compute_mapq(
                            all_best[2], alt_best[1], popular0
                        )
                        amapq1 = compute_mapq(
                            all_best[2], alt_best[1], popular1
                        )
                        alt_mapqs = (amapq0, amapq1)
                        best_alt = (
                            int(i0s[alt_best[0]]), int(i1s[alt_best[0]]),
                        )
            # Phase 4: candidates whose LV pair score is within
            # extraSearchDepth of the winner's get the affine-gap
            # comparison and may flip the result
            # (IntersectingPairedEndAligner.cpp:1036-1040, 2736-2820);
            # the winner's pair probability is then swapped from its LV
            # to its affine value in both pBest and pAll (:2712-2726)
            flip = chosen_subset[
                dsum[chosen_subset] <= int(dsum[bi]) + extra_search_depth
            ]
            bi = int(min(flip, key=lambda r: (-ag_aff[r], -probs_aff[r])))
            p_best_pair = float(probs_aff[bi])
            p_all_pairs = float(p_all_pairs - probs[bi] + p_best_pair)
            best = (int(i0s[bi]), int(i1s[bi]))

    # single-end results (for fallback and the min-MAPQ rule)
    def single_end(c, popular, len_ok):
        if not len_ok:
            return ReadAlignment(status="filtered")
        is_alt = (
            (c["cand_loc"].astype(np.int64) >= alt_boundary)
            if alt_boundary is not None
            else None
        )
        ra, _ = finalize_read(
            c["dist"], c["log_prob"], c["ag_score"], c["end_loc"],
            c["cand_loc"], c["direction"], c["valid"], popular,
            is_alt=is_alt, alt_awareness=alt_awareness,
            max_score_gap_to_prefer_non_alt=max_score_gap_to_prefer_non_alt,
            max_k=max_k, extra_search_depth=extra_search_depth,
            lv_dists=c.get("lv_dist"), use_ukkonen=use_ukkonen,
        )
        return ra

    s0 = single_end(c0, popular0, len_ok0)
    s1 = single_end(c1, popular1, len_ok1)

    def _end_secondaries(c, s, which):
        """Single-end -om secondaries for the chimeric fallback path
        (the reference's BaseAligner collects these via the secondary
        buffers ChimericPairedEndAligner passes through)."""
        if max_secondary_edit < 0 or s.status in ("notfound", "filtered"):
            return []
        from .post import collect_secondary_results

        secs = collect_secondary_results(
            c["dist"], c["log_prob"], c["ag_score"], c["end_loc"],
            c["cand_loc"], c["direction"], c["valid"], s.cand_index,
            s.dist, max_k, max_secondary_edit, max_secondary,
        )
        out = []
        for sec in secs:
            pr = PairEndResult(
                status="multi", cand_index=sec.cand_index,
                direction=sec.direction, end_loc=sec.end_loc,
                dist=sec.dist, mapq=0, aligned_as_pair=False,
            )
            out.append((pr, None) if which == 0 else (None, pr))
        return out

    def single_fallback():
        out = []
        for s, ok in ((s0, len_ok0), (s1, len_ok1)):
            if not ok or s.status in ("notfound", "filtered"):
                out.append(PairEndResult("filtered" if not ok else "notfound"))
                continue
            if s.dist > max_k // 2:
                # the chimeric single-end realignment runs with
                # maxKSingleEnd = maxK/2 (ChimericPairedEndAligner.cpp:75)
                out.append(PairEndResult("notfound"))
                continue
            mapq = s.mapq // 3  # chimeric penalty (ChimericPairedEndAligner.cpp:421)
            mapq = 0 if mapq <= flatten_mapq_at_or_below else mapq
            out.append(
                PairEndResult(
                    status="single" if mapq >= 10 else "multi",
                    cand_index=s.cand_index,
                    direction=s.direction,
                    end_loc=s.end_loc,
                    dist=s.dist,
                    mapq=mapq,
                    aligned_as_pair=False,
                )
            )
        secs = _end_secondaries(c0, s0, 0) + _end_secondaries(c1, s1, 1)
        return out[0], out[1], None, secs

    if not pair_found:
        if force_spacing:
            # -fs: either both ends align as a pair or neither does
            # (PairedAligner.cpp:826-834; the chimeric fallback is off)
            return (
                PairEndResult("notfound"), PairEndResult("notfound"),
                None, [],
            )
        return single_fallback()

    i0, i1 = best
    mapq0 = compute_mapq(p_all_pairs, p_best_pair, popular0)
    mapq1 = compute_mapq(p_all_pairs, p_best_pair, popular1)
    esc0 = bool(c0["escalated"][i0])
    esc1 = bool(c1["escalated"][i1])
    sc0, sc1 = int(c0["dist"][i0]), int(c1["dist"][i1])

    # chimeric double-check (ChimericPairedEndAligner.cpp:230-243, 404-412;
    # disabled under -fs, which bypasses the chimeric aligner entirely)
    compare_single = (
        not force_spacing
        and (esc0 or esc1)
        and max(sc0, sc1) >= min_score_realignment
    )
    if compare_single:
        # -proAg: the AG-suspicion single-end comparison was forced
        # (PairedAligner.cpp:1003-1007 counts both ends)
        if counters is not None:
            counters["ag_forced_single"] = (
                counters.get("ag_forced_single", 0) + 2
            )
        pair_ag = int(c0["ag_score"][i0]) + int(c1["ag_score"][i1])
        single_ag = 0
        choose_single_mapq = True
        for s, ci, cn in ((s0, i0, c0), (s1, i1, c1)):
            if s.status not in ("notfound", "filtered"):
                sag = int(cn["ag_score"][s.cand_index])
            else:
                sag = 0
            single_ag += sag
            if int(cn["ag_score"][ci]) >= sag:
                choose_single_mapq = False
        if choose_single_mapq:
            if s0.status not in ("notfound", "filtered"):
                mapq0 = min(mapq0, s0.mapq)
            if s1.status not in ("notfound", "filtered"):
                mapq1 = min(mapq1, s1.mapq)
        if single_ag >= pair_ag + min_ag_improvement:
            if counters is not None:
                counters["ag_used_single"] = (
                    counters.get("ag_used_single", 0) + 2
                )
            return single_fallback()

    # -om pair secondaries: non-primary merge-anchor reps within the
    # edit-distance window (IntersectingPairedEndAligner.cpp:999-1049)
    secondaries: list[tuple[PairEndResult, PairEndResult]] = []
    if max_secondary_edit >= 0:
        worst = min(2 * max_k, int(dsum[bi]) + max_secondary_edit)
        cands = [
            int(r) for r in reps_arr
            if int(r) != int(bi) and int(dsum[r]) <= worst
        ]
        cands.sort(key=lambda r: (int(dsum[r]), -float(probs[r])))
        for r in cands[:max_secondary]:
            j0, j1 = int(i0s[r]), int(i1s[r])
            secondaries.append((
                PairEndResult(
                    status="multi", cand_index=j0,
                    direction=int(c0["direction"][j0]),
                    end_loc=int(c0["end_loc"][j0]),
                    dist=int(c0["dist"][j0]), mapq=0,
                    aligned_as_pair=True,
                ),
                PairEndResult(
                    status="multi", cand_index=j1,
                    direction=int(c1["direction"][j1]),
                    end_loc=int(c1["end_loc"][j1]),
                    dist=int(c1["dist"][j1]), mapq=0,
                    aligned_as_pair=True,
                ),
            ))

    r0 = PairEndResult(
        status="single" if mapq0 >= 10 else "multi",
        cand_index=i0,
        direction=int(c0["direction"][i0]),
        end_loc=int(c0["end_loc"][i0]),
        dist=sc0,
        mapq=mapq0,
        aligned_as_pair=True,
    )
    r1 = PairEndResult(
        status="single" if mapq1 >= 10 else "multi",
        cand_index=i1,
        direction=int(c1["direction"][i1]),
        end_loc=int(c1["end_loc"][i1]),
        dist=sc1,
        mapq=mapq1,
        aligned_as_pair=True,
    )

    alt_pair = None
    if best_alt is not None:
        a0, a1 = best_alt
        alt_pair = (
            PairEndResult(
                status="multi",
                cand_index=a0,
                direction=int(c0["direction"][a0]),
                end_loc=int(c0["end_loc"][a0]),
                dist=int(c0["dist"][a0]),
                mapq=alt_mapqs[0],
                aligned_as_pair=True,
                supplementary=True,
            ),
            PairEndResult(
                status="multi",
                cand_index=a1,
                direction=int(c1["direction"][a1]),
                end_loc=int(c1["end_loc"][a1]),
                dist=int(c1["dist"][a1]),
                mapq=alt_mapqs[1],
                aligned_as_pair=True,
                supplementary=True,
            ),
        )
    return r0, r1, alt_pair, secondaries


# ---------------------------------------------------------------------------
# -eh Hamming rescue (ChimericPairedEndAligner.cpp:330-363)
# ---------------------------------------------------------------------------

_PHRED_ERR = phred_to_probability_table()
_INDEL_PROB = indel_probability_table()


def _gapless_extend(match: np.ndarray, quals: np.ndarray,
                    ag_match: int, ag_sub: int):
    """One directional computeGaplessScore scan
    (AffineGapVectorized.h:139-248): walk the extent accumulating
    +match/-sub, keep the best-scoring prefix, soft-clip the rest.

    Returns (ok, kept, edits_kept, log_prob) — ok False when no prefix
    scores above zero (could not extend past the seed).
    """
    n = match.shape[0]
    if n == 0:
        return True, 0, 0, 0.0
    scores = np.cumsum(np.where(match, ag_match, -ag_sub))
    best = int(np.argmax(scores))
    if scores[best] <= 0:
        return False, 0, 0, 0.0
    kept = best + 1
    mis = ~match[:kept]
    edits = int(mis.sum())
    log_prob = float(
        np.log(_PHRED_ERR[quals[:kept][mis]]).sum()
        + (kept - edits) * np.log1p(-SNP_PROB)
    )
    clip = n - kept
    if clip:
        log_prob += float(np.log(_INDEL_PROB[min(clip, len(_INDEL_PROB) - 1)]))
    return True, kept, edits, log_prob


def hamming_rescue(
    genome_np: np.ndarray,
    bases: np.ndarray,       # [L] uint8 read codes (unoriented)
    quals: np.ndarray,       # [L] uint8 raw phred+33
    plen: int,               # quality-clipped effective length
    seed_len: int,
    cand_loc: np.ndarray,    # [K] int64 candidate locations (oriented)
    seed_off: np.ndarray,    # [K] int32 oriented anchor offsets
    direction: np.ndarray,   # [K] int32
    cand_ok: np.ndarray,     # [K] bool candidate slots that exist
    score_limit: int,        # maxKSingleEnd = maxK/2
    popular: int,
    ag_match: int = 1,
    ag_sub: int = 4,
):
    """Rescore an unmapped end's candidates with gapless soft-clip
    scoring. Reads whose tails are unalignable under the LV/AG edit
    budget (e.g. adapter or chimera tails) often fit once the tail is
    clipped; SNAP reruns BaseAligner with useHamming for exactly this
    case (ChimericPairedEndAligner.cpp:330-363). Returns
    (best_result_dict | None) with MAPQ already computed (before the
    chimeric /3 penalty).
    """
    accepted = []
    fwd = np.ascontiguousarray(bases[:plen])
    fq = np.ascontiguousarray(quals[:plen])
    rc = reverse_complement_codes(fwd.copy())
    rq = fq[::-1].copy()
    G = genome_np.shape[0]
    for k in np.flatnonzero(cand_ok):
        loc = int(cand_loc[k])
        off = int(seed_off[k])
        d = int(direction[k])
        if loc < 0 or loc + plen > G:
            continue
        pat = rc if d else fwd
        pq = rq if d else fq
        text = genome_np[loc : loc + plen]
        match = (text == pat) & (pat < 4) & (text < 4)
        tail_start = min(off + seed_len, plen)
        # the anchoring seed's bases match the genome exactly at a real
        # hit (candidates are normalized hit - seedOffset); a window
        # that doesn't is a fuzzy-merged alias — don't rescue off it
        if not match[off:tail_start].all():
            continue
        ok1, kept1, e1, lp1 = _gapless_extend(
            match[tail_start:], pq[tail_start:], ag_match, ag_sub
        )
        if not ok1 and tail_start < plen:
            continue
        if e1 > score_limit:
            continue
        ok2, kept2, e2, lp2 = _gapless_extend(
            match[:off][::-1], pq[:off][::-1], ag_match, ag_sub
        )
        if not ok2 and off > 0:
            continue
        if e2 > score_limit - e1:
            continue
        clip_after = (plen - tail_start) - kept1
        clip_before = off - kept2
        dist = e1 + e2 + clip_after + clip_before
        log_prob = (
            lp1 + lp2 + seed_len * float(np.log1p(-SNP_PROB))
        )
        accepted.append({
            "cand_index": int(k),
            "direction": d,
            "loc": loc,
            "start_loc": loc + clip_before,
            "clip_before": clip_before,
            "clip_after": clip_after,
            "dist": dist,
            "nm": e1 + e2,
            "log_prob": log_prob,
            "ref_span": plen - clip_before - clip_after,
        })
    if not accepted:
        return None
    probs = np.exp(np.array([a["log_prob"] for a in accepted]))
    p_all = float(probs.sum())
    bi = min(
        range(len(accepted)),
        key=lambda j: (accepted[j]["dist"], -probs[j]),
    )
    best = accepted[bi]
    best["mapq"] = compute_mapq(p_all, float(probs[bi]), popular)
    return best
