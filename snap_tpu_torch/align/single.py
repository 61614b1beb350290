"""End-to-end single-end alignment driver.

Counterpart of snap_tpu.align.single. Behavioral reference: SNAP's
SingleAlignerContext::runIterationThreadImpl (SingleAligner.cpp:91-374):
read supply -> short/N filter -> align -> write -> stats. Here the loop
is batch-wise: FASTQ batches are padded to a fixed shape, aligned on the
index's device in one step (pipeline.align_winners_device), or over a
(data x index) mesh of devices (parallel.mesh.align_winners_sharded, the
monolithic full-depth step), and finalized (merge/MAPQ/CIGAR/SAM) on the
host.

`SingleEndAligner.branches` counts how many reads took each host branch
(planned native emission, per-read records, the batched AG CIGARs,
fallback rows, the wide redo of truncated and edge-indel rows, the
dp_overflow redo, the two-phase path, `non_fast`: the batches that
-om/-ea/-dp send down the two-phase path from the start) and which
FASTQ reader parsed them (`reader_serial`, or `reader_range_split` for
the -t N parse threads), and how many batches were finalized, so a run
can show which paths it exercised.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..constants import (
    DEFAULT_MIN_READ_LENGTH,
    MAPQ_LIMIT_FOR_SINGLE_HIT,
    MAX_K as MAX_K_TRACEBACK,
)
from ..genome import reverse_complement_codes
from ..index.index import GenomeIndex
from ..io.fastq import ReadBatch
from ..io.readers import single_batches
from ..io.sam import FLAG_RC, FLAG_UNMAPPED, SamWriter
from ..options import pass_filter
from ..stats import RECORDER, AlignerStats, ProgressReporter
from .agcigar import compute_ag_cigar_at
from .cigar import compute_cigar
from . import pipeline
from .pipeline import AlignParams
from .post import collect_secondary_results, finalize_read

# sentinel distinguishing "no batched AG result for this row" from
# "the batch tried and failed" (None)
_AG_NOT_CACHED = ("__ag_not_cached__",)


def winner_record(
    genome_np: np.ndarray,
    max_k: int,
    batch: "ReadBatch",
    i: int,
    arrays: dict,
    k: int,
    direction: int,
    dist: int,
    end_loc: int,
    arr_i: int | None = None,
    use_m: bool = True,
    front_extra: int = 0,
    contig_bounds: tuple[np.ndarray, np.ndarray] | None = None,
    use_affine_gap: bool = True,
    precomputed_ag=_AG_NOT_CACHED,
    ag_restructure: bool | None = None,
    ag_penalties: tuple[int, int, int, int] = (1, 4, 6, 1),
) -> dict:
    """Compute (start_loc, cigar, nm) for a chosen candidate of read i.

    arrays: numpy views of SingleAlignOut fields (len_eff, clip_before,
    clip_after, escalated, body_loc). Mirrors the SAM-write path: AG
    CIGAR for any nonzero score (SAM.cpp:1653,2678), LV traceback start
    recovery for non-escalated winners. contig_bounds = (starts, ends)
    sorted arrays enabling the AlignmentAdjuster contig-edge re-clip
    (AlignmentAdjuster.h:33-41); a fully-off-contig alignment comes back
    with start_loc -1 (the writer emits it unmapped).
    """
    ai = i if arr_i is None else arr_i
    orig_len = int(batch.lengths[i])
    plen = int(arrays["len_eff"][ai])
    back_q = orig_len - front_extra - plen  # trailing quality clip

    # fast path: a GAPLESS alignment (no indels on the LV path, no
    # aligner soft clips) needs no traceback — the CIGAR is fully
    # determined and NM equals the edit distance. This is the
    # overwhelmingly common case for short reads.
    indels = arrays.get("indels")
    fast_ok = (
        indels is not None
        and int(indels[ai, k]) == 0
        and int(arrays["clip_before"][ai, k]) == 0
        and int(arrays["clip_after"][ai, k]) == 0
    )
    if fast_ok and use_affine_gap and dist >= 2:
        # the reference recomputes every score>0 CIGAR with affine gap
        # at emission (ReadWriter.cpp:231, SAM.cpp:1653): when a
        # single-gap interpretation ties/beats the substitutions, take
        # the real AG traceback below instead of emitting {plen}M.
        # Callers holding the device-computed flag (winner_flags) pass
        # it via ag_restructure and skip the per-row screen.
        if ag_restructure is None:
            ag_restructure = bool(
                ag_restructure_possible(
                    genome_np, batch.bases, [i], [direction],
                    [end_loc - plen], [plen], [front_extra], [dist],
                )[0]
            )
        fast_ok = not ag_restructure
    if fast_ok:
        start_loc = end_loc - plen
        if contig_bounds is None or _inside_one_contig(
            start_loc, plen, contig_bounds
        ):
            if direction:
                fs, bs = back_q, front_extra
            else:
                fs, bs = front_extra, back_q
            if use_m:
                body_cig = f"{plen}M"
            else:
                cl2 = batch.bases[i, front_extra : front_extra + plen]
                pat = (
                    reverse_complement_codes(cl2.copy())
                    if direction
                    else cl2
                )
                from .adjust import _split_eq_x, render_cigar

                body_cig = render_cigar(
                    _split_eq_x(
                        [[plen, "M"]], start_loc, pat, genome_np
                    )
                )
            cigar = (
                (f"{fs}S" if fs else "") + body_cig + (f"{bs}S" if bs else "")
            )
            return {
                "start_loc": start_loc,
                "cigar": cigar,
                "nm": dist,
                "front_soft": fs,
                "ref_span": plen,
            }

    clipped = batch.bases[i, front_extra : front_extra + plen]
    cquals = batch.quals[i, front_extra : front_extra + plen]
    if direction:
        pattern = reverse_complement_codes(clipped.copy())
        oquals = cquals[::-1].copy()
        front0, back0 = back_q, front_extra
    else:
        pattern = np.ascontiguousarray(clipped)
        oquals = cquals.copy()
        front0, back0 = front_extra, back_q
    cb = int(arrays["clip_before"][ai, k])
    ca = int(arrays["clip_after"][ai, k])
    body = pattern[cb : plen - ca]
    bquals = oquals[cb : plen - ca]
    front_clip = front0 + cb
    back_clip = back0 + ca
    res = None
    if dist > 0 or cb or ca:
        if precomputed_ag is not _AG_NOT_CACHED:
            # batched native AG CIGAR already computed for this row
            # (compute_ag_cigar_batch); None means the batch failed to
            # stabilize it, same as a per-row failure below
            res = precomputed_ag
        else:
            loc0 = int(arrays["body_loc"][ai, k])
            if not bool(arrays["escalated"][ai, k]):
                # a path of edit cost `dist` ending at end_loc uses at
                # most `dist` net deletions, so the recovery window
                # only needs dist (+slack) extra text, not max_k
                loc0, _, _ = compute_cigar(
                    pattern, genome_np, end_loc,
                    min(max_k, dist + 2),
                )
            res = compute_ag_cigar_at(
                genome_np, loc0, body, bquals, front_clip, back_clip,
                use_m=use_m,
                # the fixup loop can shift loc forward by leading
                # deletions, so give it the known distance budget plus
                # slack (reference emission AG is score-limited too)
                text_margin=min(MAX_K_TRACEBACK, max(8, 2 * dist + 8)),
            )
    if res is None:
        start_loc, cigar, nm = compute_cigar(
            pattern, genome_np, end_loc,
            min(max_k, 2 * dist + 16),
            front_clip=front0, back_clip=back0, use_m=use_m,
        )
        used_body = pattern
        base_front, base_back = front0, back0
    else:
        start_loc, cigar, nm = res
        used_body = body
        base_front, base_back = front_clip, back_clip

    if use_affine_gap and "D" in cigar and start_loc >= 0:
        # phase-4 re-emission: an over-budget deletion (one only the
        # phase-2a big-indel raise could admit, run length > maxK)
        # becomes its soft-clip twin when the clipped side's matches
        # outscore paying the gap (deletion_clip_twin docstring).
        # Within-budget deletions keep the reference's standard
        # emission (golden-stable since round 3).
        twin = deletion_clip_twin(
            genome_np, used_body, start_loc, cigar, nm,
            *ag_penalties, min_run=max_k + 1,
        )
        if twin is not None:
            start_loc, cigar, nm = twin

    if contig_bounds is not None:
        # the AG fixup loop may have soft-clipped extra leading/trailing
        # pattern bases beyond the known clips; derive the body actually
        # consumed by the CIGAR from its final soft-clip counts
        lead_s = _leading_soft(cigar)
        import re as _re

        m = _re.search(r"(\d+)S(?:\d+H)?$", cigar)
        tail_s = int(m.group(1)) if m else 0
        k_front = max(0, lead_s - base_front)
        k_back = max(0, tail_s - base_back)
        used_body = used_body[k_front : len(used_body) - k_back or None]
        from .adjust import adjust_to_contig

        starts, ends = contig_bounds
        span = _ref_span(cigar)
        ci = int(starts.searchsorted(start_loc, side="right")) - 1
        best, best_ov = None, 0
        for j in (ci, ci + 1):
            if 0 <= j < len(starts):
                ov = min(int(ends[j]), start_loc + span) - max(
                    int(starts[j]), start_loc
                )
                if ov > best_ov:
                    best, best_ov = j, ov
        if best is None:
            return {"start_loc": -1, "cigar": "*", "nm": None,
                    "front_soft": 0, "ref_span": 0}
        adj = adjust_to_contig(
            start_loc, cigar, used_body, genome_np,
            int(starts[best]), int(ends[best]), use_m=use_m,
        )
        if adj is None:
            return {"start_loc": -1, "cigar": "*", "nm": None,
                    "front_soft": 0, "ref_span": 0}
        start_loc, cigar, nm = adj

    return {
        "start_loc": start_loc,
        "cigar": cigar,
        "nm": nm,
        "front_soft": _leading_soft(cigar),
        "ref_span": _ref_span(cigar),
    }


def ag_restructure_possible(
    genome_np: np.ndarray,
    bases_arr: np.ndarray,   # [B, L] raw read codes
    rows, dirs, start_locs, plens, fes, dists,
    match: int = 1, sub: int = 4, gap_open: int = 6, gap_extend: int = 1,
) -> np.ndarray:
    """Which gapless dist-m winners could the affine-gap CIGAR pass
    restructure?

    The reference recomputes every score>0 record's CIGAR with
    AffineGapVectorizedWithCigar at emission time (SimpleReadWriter
    ReadWriter.cpp:231, paired SAM.cpp:1653), so a record whose best
    AFFINE interpretation is a single gap (e.g. 96M3D4M at penalty
    open+3*ext = 9) beats its all-substitution twin (2*(sub+match) =
    10) even though the Landau-Vishkin score kept the substitutions
    (PARITY.md p89/r179 class). This screen computes the exact best
    single-gap-plus-substitutions penalty over gap lengths 1..3 and
    every split point (prefix on the anchor diagonal, suffix on the
    shifted diagonal, via cumulative mismatch counts) and flags rows
    where it ties or beats the all-substitution penalty — those rows
    take the real AG traceback instead of the fast {plen}M path.
    Multi-gap-preferred-but-no-single-gap cases are not screened
    (vanishingly rare); over-flagging only costs a traceback.

    Returns a bool mask over `rows`.
    """
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=bool)
    MS = 3
    eq, in_read, plens = _oriented_vs_genome(
        genome_np, bases_arr, rows, dirs, start_locs, plens, fes,
        max_shift=MS,
    )
    plens = np.asarray(plens, dtype=np.int64)
    dists = np.asarray(dists, dtype=np.int64)
    L = bases_arr.shape[1]
    unit = sub + match
    baseline = unit * dists

    def cum(shift):  # [n, L+1] prefix mismatch counts on a diagonal
        mism = ~eq(shift)  # past-plen positions read as matches
        c = np.zeros((n, L + 1), dtype=np.int64)
        np.cumsum(mism, axis=1, out=c[:, 1:])
        return c

    c0 = cum(0)
    kpos = np.arange(L + 1, dtype=np.int64)[None, :]
    in_split = kpos <= plens[:, None]
    BIG = np.int64(1 << 30)
    best = np.full(n, BIG)
    for s in range(1, MS + 1):
        # deletion of s genome bases at split k: read[:k] on diag 0,
        # read[k:] on diag +s
        cs = cum(s)
        tot_s = cs[np.arange(n), plens]
        cost_d = (
            gap_open + s * gap_extend
            + unit * np.min(
                np.where(in_split, c0 + (tot_s[:, None] - cs), BIG),
                axis=1,
            )
        )
        best = np.minimum(best, cost_d)
        # insertion of s read bases at split k: read[:k] on diag 0,
        # read[k+s:] on diag -s; the s inserted bases lose match reward
        cm = cum(-s)
        tot_m = cm[np.arange(n), plens]
        suf = tot_m[:, None] - cm[:, s:]  # suffix from read pos k+s
        pre = c0[:, : L + 1 - s]
        ok_k = kpos[:, : L + 1 - s] <= (plens[:, None] - s)
        cost_i = (
            gap_open + s * gap_extend + s * match
            + unit * np.min(np.where(ok_k, pre + suf, BIG), axis=1)
        )
        best = np.minimum(best, cost_i)
    return best <= baseline


# sentinel marking a row handled by the vectorized emission plan
_PLANNED = {"status": "planned"}


def _oriented_vs_genome(
    genome_np: np.ndarray,
    bases_arr: np.ndarray,   # [B, L] raw read codes
    rows, dirs, start_locs, plens, fes,
    max_shift: int = 3,
):
    """Oriented pattern rows and their per-diagonal match planes.

    Returns (eq, in_read, plens) where eq(shift) gives the [n, L]
    match-vector of the oriented pattern against the genome shifted by
    `shift` in -max_shift..+max_shift (positions past plen read True).
    Shared by the one-indel detector and the AG-restructure screen.
    """
    n = len(rows)
    L = bases_arr.shape[1]
    G = genome_np
    rows = np.asarray(rows, dtype=np.int64)
    dirs = np.asarray(dirs, dtype=np.int64)
    s = np.asarray(start_locs, dtype=np.int64)
    plens = np.asarray(plens, dtype=np.int64)
    fes = np.asarray(fes, dtype=np.int64)

    pos = np.arange(L, dtype=np.int64)[None, :]
    src = np.where(
        dirs[:, None] == 1,
        fes[:, None] + plens[:, None] - 1 - pos,
        fes[:, None] + pos,
    )
    srcc = np.clip(src, 0, L - 1)
    P = np.take_along_axis(bases_arr[rows], srcc, axis=1)
    P = np.where(
        dirs[:, None] == 1,
        np.where(P < 4, 3 - P, P),
        P,
    )
    in_read = pos < plens[:, None]

    M = max_shift
    gi = np.clip(
        s[:, None] + np.arange(-M, L + M + 1)[None, :], 0, len(G) - 1
    )
    Gw = G[gi]

    def m(a, b):  # codes match (N/PAD never match)
        return (a == b) & (a < 4) & (b < 4)

    TRUE = ~in_read  # positions past plen count as matched

    def eq(shift):  # pattern vs genome shifted by `shift`
        return m(P, Gw[:, M + shift : L + M + shift]) | TRUE

    return eq, in_read, plens


def one_indel_improves(
    genome_np: np.ndarray,
    bases_arr: np.ndarray,   # [B, L] raw read codes
    rows, dirs, start_locs, plens, fes,
) -> np.ndarray:
    """Which of these gapless dist-2 alignments admit an LV dist-1
    alignment (one 1-base indel, no mismatches)?

    SNAP always scores candidates with the full Landau-Vishkin DP
    (BaseAligner.cpp:1160-1173), so it reports the dist-1 indel
    alignment where our gapless tier-1 reports 2 edge mismatches and
    skips the DP (dist <= maxKForSameAlignment). A one-indel dist-1
    alignment exists iff the pattern splits into a prefix on one
    diagonal and a suffix on an adjacent diagonal with no mismatches;
    that reduces to prefix/suffix-run-length tests on the three
    diagonal match vectors. Flagged rows are re-scored exactly
    (force_dp), so over-flagging is safe.

    Returns a bool mask over `rows`.
    """
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=bool)
    L = bases_arr.shape[1]
    eq, in_read, plens = _oriented_vs_genome(
        genome_np, bases_arr, rows, dirs, start_locs, plens, fes,
        max_shift=1,
    )
    plens = np.asarray(plens, dtype=np.int64)

    eq0 = eq(0)
    eqm = eq(-1)

    def pref(a):  # length of leading all-True run, capped at plen
        return np.minimum(
            np.where(a.all(axis=1), L, np.argmin(a, axis=1)), plens
        )

    def suff(a):  # length of trailing all-True run within [0, plen)
        ar = a[:, ::-1]
        tail_pad = L - plens  # reversed array leads with padding Trues
        run = np.where(ar.all(axis=1), L, np.argmin(ar, axis=1))
        return np.clip(run - tail_pad, 0, plens)

    L0, R0 = pref(eq0), suff(eq0)
    eqp = eq(1)
    ok = (
        (L0 + suff(eqp) >= plens)        # 1D: tail on +1 diagonal
        | (L0 + suff(eqm) >= plens - 1)  # 1I: tail on -1 diagonal
        | (pref(eqp) + R0 >= plens - 1)  # 1I: head on +1 diagonal
        | (pref(eqm) + R0 >= plens)      # 1D: head on -1 diagonal
    )
    # a dist-2 gapless alignment has 2 mismatches on its own diagonal,
    # so a single-diagonal full match is impossible; the conditions
    # only pass when a genuine one-indel split exists
    return ok


def deletion_clip_twin(
    genome_np: np.ndarray,
    body: np.ndarray,        # oriented pattern bases the CIGAR consumes
    start_loc: int,
    cigar: str,
    nm: int,
    match: int = 1,
    sub: int = 4,
    gap_open: int = 6,
    gap_extend: int = 1,
    min_run: int = 0,
):
    """Reference phase-4 re-emission rule for over-costly deletions
    (scoreLocationWithAffineGap under scoreLimit,
    IntersectingPairedEndAligner.cpp:2581-2626, single-end twin
    BaseAligner.cpp:1594): when soft-clipping everything on one side
    of a deletion run scores better under the affine model than paying
    the gap (plen*m - open - D*ext - subs*unit vs the kept side's
    matches), the reference emits the clip twin (e.g. 31S69M NM:0
    instead of 31M33D69M NM:33). Insertions never flip: their clip
    twin forfeits the far side's matches without genome-span savings,
    so the full representation always survives the comparison the way
    the reference's candidate set resolves it (both anchors score, the
    LV stage kills the clipped-anchor candidate).

    Returns (new_start_loc, new_cigar, new_nm) when a strictly better
    deletion clip twin exists, else None.
    """
    import re

    ops = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)]
    if not any(op == "D" for _, op in ops):
        return None
    G = genome_np
    unit_scores = []  # per-op: (op, n, score_delta, mism, rp, gp)
    rp, gp = 0, start_loc
    lead_s = tail_s = 0
    core = []  # non-clip ops with positions
    for i, (n, op) in enumerate(ops):
        if op in "SH":
            if not core:
                lead_s += n
            else:
                tail_s += n
            continue
        if op in "M=X":
            if op == "=":
                mism = 0
            elif op == "X":
                mism = n
            else:
                seg = body[rp : rp + n]
                gseg = G[gp : gp + n]
                mism = int(
                    (
                        (seg != gseg[: len(seg)])
                        | (seg >= 4)
                        | (gseg[: len(seg)] >= 4)
                    ).sum()
                )
            score = (n - mism) * match - mism * sub
            core.append((op, n, score, mism, rp, gp))
            rp += n
            gp += n
        elif op == "I":
            core.append((op, n, -(gap_open + n * gap_extend), n, rp, gp))
            rp += n
        elif op in "DN":
            core.append((op, n, -(gap_open + n * gap_extend), n, rp, gp))
            gp += n
    full_score = sum(c[2] for c in core)
    total_read = rp

    best = None  # (score, start, cigar, nm)
    for k, (op, n, _sc, _mm, rpk, gpk) in enumerate(core):
        if op not in "DN" or n < min_run:
            continue
        # head twin: clip the read consumed before this run
        after = core[k + 1 :]
        s_head = sum(c[2] for c in after)
        if s_head > full_score and (best is None or s_head > best[0]):
            clip = lead_s + rpk
            cig = (f"{clip}S" if clip else "") + "".join(
                f"{c[1]}{c[0]}" for c in after
            ) + (f"{tail_s}S" if tail_s else "")
            nm2 = sum(c[3] for c in after)
            best = (s_head, gpk + n, cig, nm2)
        # tail twin: clip the read consumed from this run on
        before = core[:k]
        s_tail = sum(c[2] for c in before)
        if s_tail > full_score and (best is None or s_tail > best[0]):
            clip = tail_s + (total_read - rpk)
            cig = (f"{lead_s}S" if lead_s else "") + "".join(
                f"{c[1]}{c[0]}" for c in before
            ) + (f"{clip}S" if clip else "")
            nm2 = sum(c[3] for c in before)
            best = (s_tail, start_loc, cig, nm2)
    if best is None:
        return None
    return best[1], best[2], best[3]


def _inside_one_contig(start_loc: int, span: int, contig_bounds) -> bool:
    starts, ends = contig_bounds
    # ndarray.searchsorted avoids the np.searchsorted dispatch overhead
    # (this runs once per aligned read)
    ci = int(starts.searchsorted(start_loc, side="right")) - 1
    return (
        0 <= ci < len(starts)
        and start_loc >= int(starts[ci])
        and start_loc + span <= int(ends[ci])
    )


def _leading_soft(cigar: str) -> int:
    import re

    m = re.match(r"^(\d+)S", cigar)
    return int(m.group(1)) if m else 0


def _ref_span(cigar: str) -> int:
    import re

    return sum(
        int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
        if op in "MD=XN"
    )


class SingleEndAligner:
    def __init__(
        self,
        index: GenomeIndex,
        params: AlignParams | None = None,
        batch_size: int = 1024,
        max_read_len: int = 128,
        min_read_length: int = DEFAULT_MIN_READ_LENGTH,
        alt_awareness: bool = True,
        emit_alt: bool = False,
        max_score_gap_to_prefer_non_alt: int = 64,
        use_m: bool = True,
        filter_flags: int = 0,
        stop_on_first_hit: bool = False,
        max_secondary_edit: int = -1,          # -om
        max_secondary: int = 0x7FFFFFFF,       # -omax
        max_secondary_per_contig: int = -1,    # -mpc
        clip_front: bool = False,              # -C x- / -C xx
        max_dist_fraction: float = 0.0,        # -dp (long reads)
        internal_score_tag: str | None = None, # -is
        read_secondary: bool = False,          # -sa
        attach_times: bool = False,            # -at
        kill_if_too_slow: bool = False,        # -kts
        force_kind: str | None = None,         # -fastq
        force_gzip: bool = False,              # -compressedFastq
        mesh=None,                             # multi-device (data x index)
        threads: int = 1,                      # -t: input parser threads
        adaptive: bool = True,                 # SNAP seed-loop early stop
    ):
        self.index = index
        self.mesh = mesh
        if mesh is not None and mesh.multiprocess:
            # as in snap_tpu, SAM is written by one process: a mesh over
            # several processes runs parallel.mesh's steps directly
            raise ValueError(
                "SingleEndAligner writes SAM from one process; its mesh "
                "spans several ranks"
            )
        # on a mesh the host-gated tiers run on its primary device
        self.device = index.torch_device if mesh is None else mesh.primary
        self.params = params or AlignParams(
            seed_len=index.seed_len, max_probe=index.max_probe
        )
        self.batch_size = batch_size
        self.max_read_len = max_read_len
        # two-phase adaptive seeding (SNAP's early termination,
        # BaseAligner.cpp:1028): device-only path; the sharded mesh
        # step and the host two-phase tier run full-depth
        self.adaptive = adaptive
        self.min_read_length = min_read_length
        self.genome_np = np.asarray(index.genome_meta.bases)
        self.first_alt_start = index.genome_meta.first_alt_start()
        self._fas_dev = torch.tensor(
            self.first_alt_start, dtype=torch.int64, device=self.device
        )
        self.alt_awareness = alt_awareness
        self.emit_alt = emit_alt
        self.max_score_gap = max_score_gap_to_prefer_non_alt
        self.use_m = use_m
        self.filter_flags = filter_flags
        self.stop_on_first_hit = stop_on_first_hit
        self.max_secondary_edit = max_secondary_edit
        self.max_secondary = max_secondary
        self.max_secondary_per_contig = max_secondary_per_contig
        self.clip_front = clip_front
        self.max_dist_fraction = max_dist_fraction
        self.internal_score_tag = internal_score_tag
        self.read_secondary = read_secondary
        self.attach_times = attach_times
        self.kill_if_too_slow = kill_if_too_slow
        self.force_kind = force_kind
        self.force_gzip = force_gzip
        self.threads = threads
        self._kts_last_check = 0.0
        self._kts_writes = 0
        self._batch_us_per_read = 0
        # winners prefetch: the packed winners of a dispatched batch are
        # copied into pinned host memory without blocking, and a CUDA
        # event marks the copy's end; _finalize_fast waits on it
        self._win_futures: dict[int, tuple] = {}
        # per-file adaptive policy: once a batch shows a material
        # truncated fraction (repeat-dense genome), later batches run
        # the phase-C wide tile on device instead of shipping those
        # rows to the host wide redo; clean genomes never pay for it
        self._use_phase_c = False
        cs = sorted(index.genome_meta.contigs, key=lambda c: c.start)
        self.contig_bounds = (
            np.array([c.start for c in cs], dtype=np.int64),
            np.array([c.start + c.length for c in cs], dtype=np.int64),
        )
        self._sorted_contig_names = [
            c.name.encode() if isinstance(c.name, str) else c.name
            for c in cs
        ]
        self.stats = AlignerStats()
        self.branches: Counter = Counter()

    def _pad(self, batch: ReadBatch):
        n = len(batch)
        B, L = self.batch_size, self.max_read_len
        bases = np.full((B, L), 4, dtype=np.uint8)
        quals = np.zeros((B, L), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        bases[:n] = batch.bases[:, :L]
        quals[:n] = batch.quals[:, :L]
        lens[:n] = np.minimum(batch.lengths, L)
        return bases, quals, lens

    @property
    def _scoring_didx(self):
        """DeviceIndex for scoring-only consumers (two_phase_merge /
        score_candidates use the genome arrays, never the hash table);
        in mesh mode that's the flat view of the sharded index."""
        if self.mesh is not None:
            from ..parallel.mesh import local_index_view

            return local_index_view(self.index.device_sharded)
        return self.index.device

    @property
    def _fast_ok(self) -> bool:
        """Device-finalize fast path applies under default modes; the
        per-candidate extras (-om secondaries, -ea ALT supplementaries,
        -dp fractional caps) still take the full host-merge path."""
        return (
            self.max_secondary_edit < 0
            and not self.emit_alt
            and self.max_dist_fraction == 0.0
        )

    def _start_win_prefetch(self, win):
        """Begin the packed-winners device->host copy (keyed by tensor
        identity; _finalize_fast consumes it): on CUDA a non-blocking
        copy into pinned memory and an event recorded after it."""
        # pin `win` in the value so its id can't be reused while queued;
        # a single-slot pipeline never holds more than 2 entries — if an
        # abandoned batch (exception mid-loop, discarded handles) left
        # stale entries behind, drop them
        if len(self._win_futures) >= 2:
            self._win_futures.clear()
        if win.is_cuda:
            host = torch.empty(win.shape, dtype=win.dtype, pin_memory=True)
            host.copy_(win, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = win, None
        self._win_futures[id(win)] = (win, host, done)

    def _fetch_winners(self, win):
        """The packed winners as numpy, waiting for the prefetch copy."""
        pf = self._win_futures.pop(id(win), None)
        if pf is None:
            with RECORDER.span("finalize.winners_wait"):
                return win.cpu().numpy()
        _, host, done = pf
        if done is not None:
            with RECORDER.span("finalize.winners_wait"):
                done.synchronize()
        return host.numpy()

    def close(self) -> None:
        """Drop pending winners prefetches. Idempotent; align_file calls
        it on exit."""
        self._win_futures.clear()

    def _submit(self, batch: ReadBatch):
        """Dispatch the device step (or tier 1) for a batch; returns
        handles."""
        bases, quals, lens = self._pad(batch)
        if self.clip_front:
            from .pipeline import apply_front_clip

            bases, quals, lens, front_clips = apply_front_clip(
                bases, quals, lens
            )
        else:
            front_clips = np.zeros(len(lens), dtype=np.int32)
        dev_bases = torch.from_numpy(bases).to(self.device)
        dev_quals = torch.from_numpy(quals).to(self.device)
        dev_lens = torch.from_numpy(lens).to(self.device)
        if self.mesh is not None:
            # multi-device: reads data-parallel, index sharded over the
            # 'index' mesh axis; the same align + device-finalize step
            # at every mesh position
            from ..parallel.mesh import (
                align_tier1_sharded, align_winners_sharded,
            )

            didx_sh = self.index.device_sharded
            if self._fast_ok:
                win, out = align_winners_sharded(
                    didx_sh, dev_bases, dev_quals, dev_lens,
                    self._fas_dev, self.params, self.mesh,
                    alt_awareness=self.alt_awareness,
                    max_score_gap=self.max_score_gap,
                )
                self._start_win_prefetch(win)
                return (
                    ("fast", win, out, dev_bases, dev_quals, dev_lens),
                    front_clips,
                )
            self.branches["non_fast"] += len(batch)
            t1 = align_tier1_sharded(
                didx_sh, dev_bases, dev_quals, dev_lens, self.params,
                self.mesh,
            )
            return (t1, dev_bases, dev_quals), front_clips
        if self._fast_ok:
            win, out = pipeline.align_winners_device(
                self.index.device, dev_bases, dev_quals, dev_lens,
                self._fas_dev, self.params,
                alt_awareness=self.alt_awareness,
                max_score_gap=self.max_score_gap,
                adaptive=self.adaptive,
                phase_c=self._use_phase_c,
            )
            self._start_win_prefetch(win)
            return (
                ("fast", win, out, dev_bases, dev_quals, dev_lens),
                front_clips,
            )
        # -om / -ea / -dp: the per-candidate extras need every scored
        # candidate on the host, so the batch takes the two-phase path
        self.branches["non_fast"] += len(batch)
        t1 = pipeline.align_tier1(
            self.index.device, dev_bases, dev_quals, dev_lens, self.params,
        )
        return (t1, dev_bases, dev_quals), front_clips

    def align_batch(self, batch: ReadBatch):
        """Returns a list of per-read dicts ready for SAM emission."""
        out, front_clips = self._submit(batch)
        return self._finalize(batch, out, front_clips)

    def _plan_ok(self, writer) -> bool:
        """Whether batched native SAM emission applies: the default
        streaming-SAM config with no per-read variable tags/filters."""
        from ..io.native import has_sam_formatter

        return (
            self._fast_ok
            and self.use_m
            and self.internal_score_tag is None
            and not self.attach_times
            and self.filter_flags == 0
            and getattr(writer, "_stream_sam", False)
            and not getattr(writer, "preserve_fastq_comments", False)
            and has_sam_formatter()
        )

    def _finalize(
        self, batch: ReadBatch, handles, front_clips, plan_writer=None
    ):
        if isinstance(handles[0], str) and handles[0] == "fast":
            return self._finalize_fast(
                batch, handles, front_clips, plan_writer=plan_writer
            )
        if plan_writer is not None:
            return (
                self._finalize(batch, handles, front_clips),
                None,
            )
        (t1, dev_bases, dev_quals) = handles
        self.branches["two_phase"] += len(batch)
        with RECORDER.span("two_phase.merge", reads=len(batch)):
            merged = pipeline.two_phase_merge(
                self._scoring_didx, t1, dev_bases, dev_quals, self.params
            )
        dist = merged["dist"]
        logp = merged["log_prob"]
        ag_score = merged["ag_score"]
        end_loc = merged["end_loc"]
        body_loc = merged["body_loc"]
        cand_loc = merged["cand_loc"]
        clip_before = merged["clip_before"]
        clip_after = merged["clip_after"]
        escalated = merged["escalated"]
        direction = merged["direction"]
        valid = merged["valid"]
        len_eff = merged["len_eff"]
        popular = merged["popular"]

        with RECORDER.span("two_phase.per_read", rows=len(batch)):
            is_alt = cand_loc >= self.first_alt_start
            if self.max_dist_fraction > 0.0:
                # -dp: per-read edit-distance cap of fraction * read length
                # (SingleAligner.cpp:243-248, LONG_READS builds)
                limit = np.minimum(
                    self.params.max_k,
                    (len_eff.astype(np.float64) * self.max_dist_fraction).astype(
                        np.int64
                    ),
                )
                valid = valid & (dist <= limit[:, None])
            n = len(batch)
            self.stats.lv_calls += int(valid[:n].sum())
            self.stats.affine_gap_calls += int((escalated & valid)[:n].sum())

            results = []
            arrays = {
                "len_eff": len_eff,
                "clip_before": clip_before,
                "clip_after": clip_after,
                "escalated": escalated,
                "body_loc": body_loc,
                "indels": merged["indels"],
            }
            # vectorized batch finalization when no per-read extras are on
            batch_finalized = None
            if not self.emit_alt:
                from .post import finalize_batch

                batch_finalized = finalize_batch(
                    dist[:n], logp[:n], ag_score[:n], end_loc[:n], cand_loc[:n],
                    direction[:n], valid[:n], popular[:n],
                    is_alt=is_alt[:n],
                    alt_awareness=self.alt_awareness,
                    max_score_gap_to_prefer_non_alt=self.max_score_gap,
                    max_k=self.params.max_k,
                    extra_search_depth=self.params.extra_search_depth,
                    use_ukkonen=self.params.use_ukkonen,
                    lv_dists=merged["lv_dist"][:n],
                )
            for i in range(len(batch)):
                orig_len = int(batch.lengths[i])
                if orig_len < self.min_read_length:
                    results.append({"status": "filtered"})
                    continue
                if batch_finalized is not None:
                    ra, alt_supp = batch_finalized[i]
                else:
                    ra, alt_supp = finalize_read(
                        dist[i], logp[i], ag_score[i], end_loc[i], cand_loc[i],
                        direction[i], valid[i], int(popular[i]),
                        is_alt=is_alt[i],
                        alt_awareness=self.alt_awareness,
                        emit_alt=self.emit_alt,
                        max_score_gap_to_prefer_non_alt=self.max_score_gap,
                        max_k=self.params.max_k,
                        extra_search_depth=self.params.extra_search_depth,
                        use_ukkonen=self.params.use_ukkonen,
                        lv_dists=merged["lv_dist"][i],
                    )
                if ra.status == "notfound":
                    results.append({"status": "notfound"})
                    continue
                if self.stop_on_first_hit:
                    # -f: any in-budget hit, MAPQ forced 0 / MultipleHits
                    # (BaseAligner.cpp:1490-1505)
                    ra.mapq = 0
                    ra.status = "multi"
                    alt_supp = None
                rec = winner_record(
                    self.genome_np, self.params.max_k, batch, i, arrays,
                    ra.cand_index, ra.direction, ra.dist, int(ra.end_loc),
                    use_m=self.use_m, front_extra=int(front_clips[i]),
                    contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                )
                rec.update(
                    status=ra.status, direction=ra.direction, mapq=ra.mapq,
                    dist=ra.dist,
                )
                if alt_supp is not None:
                    srec = winner_record(
                        self.genome_np, self.params.max_k, batch, i, arrays,
                        alt_supp.cand_index, alt_supp.direction, alt_supp.dist,
                        int(alt_supp.end_loc), use_m=self.use_m,
                        front_extra=int(front_clips[i]),
                        contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                    )
                    srec.update(
                        status=alt_supp.status, direction=alt_supp.direction,
                        mapq=alt_supp.mapq, dist=alt_supp.dist,
                    )
                    rec["alt_supplementary"] = srec
                if self.max_secondary_edit >= 0:
                    secs = collect_secondary_results(
                        dist[i], logp[i], ag_score[i], end_loc[i], cand_loc[i],
                        direction[i], valid[i], ra.cand_index, ra.dist,
                        self.params.max_k, self.max_secondary_edit,
                        self.max_secondary, is_alt=is_alt[i],
                        alt_awareness=self.alt_awareness,
                    )
                    sec_recs = []
                    for s in secs:
                        sr = winner_record(
                            self.genome_np, self.params.max_k, batch, i, arrays,
                            s.cand_index, s.direction, s.dist, int(s.end_loc),
                            use_m=self.use_m, front_extra=int(front_clips[i]),
                            contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                        )
                        sr.update(
                            status=s.status, direction=s.direction, mapq=0,
                            dist=s.dist, supplementary=s.supplementary,
                        )
                        sec_recs.append(sr)
                    if sec_recs:
                        rec["secondaries"] = sec_recs
                results.append(rec)
        self._redo_wide(
            batch, results,
            np.flatnonzero(np.asarray(merged["truncated"][:n])),
            front_clips,
        )
        # edge-indel honesty (same rule as the fast path): gapless
        # dist-2 winners where one indel explains both mismatches
        if self.params.max_k_same >= 2:
            import re as _re

            rows, dirs_l, starts_l, plens_l, fes_l = [], [], [], [], []
            for i, rec in enumerate(results):
                if (
                    rec.get("status") in ("single", "multi")
                    and rec.get("nm") == 2
                    and not _re.search(r"[IDSH]", rec.get("cigar", "S"))
                ):
                    rows.append(i)
                    dirs_l.append(rec["direction"])
                    starts_l.append(rec["start_loc"])
                    plens_l.append(rec["ref_span"])
                    fes_l.append(int(front_clips[i]))
            if rows:
                ok = self._one_indel_improves(
                    batch, rows, dirs_l, starts_l, plens_l, fes_l
                )
                hit = [r for r, o in zip(rows, ok) if o]
                if hit:
                    self._redo_wide(
                        batch, results, hit, front_clips, force_dp=True
                    )
        return results

    def _one_indel_improves(
        self, batch, rows, dirs, start_locs, plens, fes
    ) -> np.ndarray:
        return one_indel_improves(
            self.genome_np, batch.bases, rows, dirs, start_locs, plens,
            fes,
        )

    def _redo_wide(self, batch, results, rows, front_clips, force_dp=False):
        """maxHits=300 honesty pass: reads whose device gather cap
        dropped hits are re-run over the FULL hit lists (host candidate
        generation, device scoring), replacing their results.

        Mirrors BaseAligner scoring up to maxHits hits per seed
        (BaseAligner.cpp:574-579); without this, pAll — and therefore
        MAPQ — is wrong wherever a seed has hit_cap..maxHits hits.

        With force_dp (edge-indel redo rows) every imperfect candidate
        is scored with the full DP — SNAP's always-LV semantics
        (BaseAligner.cpp:1160-1173) — so a 1-base-indel alignment that
        beats the gapless interpretation is found exactly.
        """
        rows = [
            int(i) for i in rows
            if results[i].get("status") != "filtered"
        ]
        if not rows:
            return
        self.branches[
            "redo_edge_indel" if force_dp else "redo_truncated"
        ] += len(rows)
        with RECORDER.span(
            "redo.wide", reads=len(rows), force_dp=int(force_dp)
        ) as sp:
            from ..index.host_lookup import host_clip_back
            from .intersect import wide_single_candidates

            bases, quals, lens = self._pad(batch)
            if self.clip_front:
                from .pipeline import apply_front_clip

                bases, quals, lens, _ = apply_front_clip(bases, quals, lens)
            sub_b = bases[rows]
            sub_q = quals[rows]
            sub_l = lens[rows]
            len_eff = (
                host_clip_back(sub_q, sub_l)
                if self.params.clip_back
                else sub_l.astype(np.int32)
            )
            with RECORDER.span("redo.candidates"):
                wc = wide_single_candidates(
                    self.index.host, sub_b, len_eff,
                    self.params.num_lookups, self.params.seed_len,
                    self.params.max_hits, self.params.explore_popular,
                )
            # pow2-bucketed shapes so recurring redo sizes hit the jit
            # cache; rows are processed in chunks bounded by rows*K so a
            # repeat-heavy batch (every read truncated, hundreds of wide
            # candidates each) can't ask the device for one giant graph —
            # the unchunked form compiled a >16GB tier on the 25%-repeat
            # bench and OOMed HBM
            per_row_valid = wc.valid.sum(axis=1)
            order = np.argsort(per_row_valid, kind="stable")
            CAP = 1 << 18  # max rows*K per scoring call
            chunks: list[list[int]] = []
            cur: list[int] = []
            cur_k = 16
            for oi in order:
                nv = int(per_row_valid[oi])
                k_need = 16
                while k_need < nv:
                    k_need <<= 1
                k_new = max(cur_k, k_need)
                m_new = len(cur) + 1
                mp = 1
                while mp < m_new:
                    mp <<= 1
                if cur and mp * k_new > CAP:
                    chunks.append(cur)
                    cur = [int(oi)]
                    cur_k = k_need
                else:
                    cur.append(int(oi))
                    cur_k = k_new
            if cur:
                chunks.append(cur)
            sp.count(
                candidates=int(per_row_valid.sum()), chunks=len(chunks)
            )
            for chunk in chunks:
                self._redo_wide_chunk(
                    batch, results, rows, front_clips, force_dp, wc,
                    sub_b, sub_q, len_eff, chunk,
                )

    def _redo_wide_chunk(
        self, batch, results, rows, front_clips, force_dp, wc,
        sub_b, sub_q, len_eff, chunk,
    ):
        from .post import collect_secondary_results, finalize_read

        ridx = np.asarray(chunk, dtype=np.int64)
        nvalid = int(wc.valid[ridx].sum(axis=1).max())
        K = 16
        while K < nvalid:
            K <<= 1
        K = min(K, wc.loc.shape[1])
        M = len(chunk)
        Mp = 1
        while Mp < M:
            Mp <<= 1
        with RECORDER.span("redo.score", rows=M):
            pad2 = lambda a: torch.from_numpy(np.concatenate(
                [a[ridx], np.zeros((Mp - M,) + a.shape[1:], a.dtype)]
            )).to(self.device)
            dev_b, dev_q = pad2(sub_b), pad2(sub_q)
            t1 = pipeline.score_candidates(
                self._scoring_didx, dev_b, dev_q, pad2(len_eff),
                pad2(wc.loc[:, :K]), pad2(wc.off[:, :K]), pad2(wc.dir[:, :K]),
                pad2(wc.valid[:, :K]), pad2(wc.weight[:, :K]),
                pad2(wc.popular), self.params, tier1_only=True,
            )
            merged = pipeline.two_phase_merge(
                self._scoring_didx, t1, dev_b, dev_q, self.params,
                force_dp=force_dp,
            )
        with RECORDER.span("redo.finalize", rows=M):
            arrays = {
                k: merged[k]
                for k in ("len_eff", "clip_before", "clip_after", "escalated",
                          "body_loc", "indels")
            }
            is_alt = merged["cand_loc"] >= self.first_alt_start
            for j, ci in enumerate(chunk):
                i = rows[ci]
                dist = merged["dist"][j]
                logp = merged["log_prob"][j]
                ag = merged["ag_score"][j]
                e = merged["end_loc"][j]
                cl = merged["cand_loc"][j]
                dr = merged["direction"][j]
                v = merged["valid"][j]
                if self.max_dist_fraction > 0.0:
                    limit = min(
                        self.params.max_k,
                        int(len_eff[ci] * self.max_dist_fraction),
                    )
                    v = v & (dist <= limit)
                ra, alt_supp = finalize_read(
                    dist, logp, ag, e, cl, dr, v, int(wc.popular[ci]),
                    is_alt=is_alt[j],
                    alt_awareness=self.alt_awareness,
                    emit_alt=self.emit_alt,
                    max_score_gap_to_prefer_non_alt=self.max_score_gap,
                    max_k=self.params.max_k,
                    extra_search_depth=self.params.extra_search_depth,
                    use_ukkonen=self.params.use_ukkonen,
                    lv_dists=merged["lv_dist"][j],
                )
                if ra.status == "notfound":
                    results[i] = {"status": "notfound"}
                    continue
                if self.stop_on_first_hit:
                    ra.mapq = 0
                    ra.status = "multi"
                    alt_supp = None
                rec = winner_record(
                    self.genome_np, self.params.max_k, batch, i, arrays,
                    ra.cand_index, ra.direction, ra.dist, int(ra.end_loc),
                    arr_i=j, use_m=self.use_m,
                    front_extra=int(front_clips[i]),
                    contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                )
                rec.update(
                    status=ra.status, direction=ra.direction, mapq=ra.mapq,
                    dist=ra.dist,
                )
                if alt_supp is not None:
                    srec = winner_record(
                        self.genome_np, self.params.max_k, batch, i, arrays,
                        alt_supp.cand_index, alt_supp.direction, alt_supp.dist,
                        int(alt_supp.end_loc), arr_i=j, use_m=self.use_m,
                        front_extra=int(front_clips[i]),
                        contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                    )
                    srec.update(
                        status=alt_supp.status, direction=alt_supp.direction,
                        mapq=alt_supp.mapq, dist=alt_supp.dist,
                    )
                    rec["alt_supplementary"] = srec
                if self.max_secondary_edit >= 0:
                    secs = collect_secondary_results(
                        dist, logp, ag, e, cl, dr, v, ra.cand_index, ra.dist,
                        self.params.max_k, self.max_secondary_edit,
                        self.max_secondary, is_alt=is_alt[j],
                        alt_awareness=self.alt_awareness,
                    )
                    sec_recs = []
                    for s in secs:
                        sr = winner_record(
                            self.genome_np, self.params.max_k, batch, i,
                            arrays, s.cand_index, s.direction, s.dist,
                            int(s.end_loc), arr_i=j, use_m=self.use_m,
                            front_extra=int(front_clips[i]),
                            contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                        )
                        sr.update(
                            status=s.status, direction=s.direction, mapq=0,
                            dist=s.dist, supplementary=s.supplementary,
                        )
                        sec_recs.append(sr)
                    if sec_recs:
                        rec["secondaries"] = sec_recs
                results[i] = rec

    def _finalize_fast(
        self, batch: ReadBatch, handles, front_clips, plan_writer=None
    ):
        """Host half of the device-finalize path: fetch compact per-read
        winners, re-finalize the rare flagged rows exactly, emit.

        With plan_writer set (batched native SAM emission eligible),
        "simple" rows — found, gapless, unclipped, inside one contig —
        are returned as a vectorized emission plan instead of per-read
        dicts; results holds the _PLANNED sentinel at those indices."""
        from .pipeline import HostWinners, gather_merged_rows
        from .post import finalize_read

        (_, win_dev, out_dev, dev_bases, dev_quals, dev_lens) = handles
        packed = self._fetch_winners(win_dev)
        with RECORDER.span("finalize.unpack"):
            win = HostWinners(packed)
        if bool(win.dp_overflow):
            # DP tier truncated (extremely gappy batch): redo through the
            # host-gated two-phase path, which sizes the tier exactly
            self.branches["dp_overflow"] += len(batch)
            with RECORDER.span("redo.dp_overflow", reads=len(batch)):
                if self.mesh is not None:
                    from ..parallel.mesh import align_tier1_sharded

                    t1 = align_tier1_sharded(
                        self.index.device_sharded, dev_bases, dev_quals,
                        dev_lens, self.params, self.mesh,
                    )
                else:
                    t1 = pipeline.align_tier1(
                        self.index.device, dev_bases, dev_quals, dev_lens,
                        self.params,
                    )
                return self._finalize(
                    batch, (t1, dev_bases, dev_quals), front_clips,
                    plan_writer=plan_writer,
                )
        n = len(batch)
        with RECORDER.span("finalize.unpack"):
            self.stats.lv_calls += int(
                win.valid_count[:n].astype(np.int64).sum()
            )
            self.stats.affine_gap_calls += int(
                win.esc_count[:n].astype(np.int64).sum()
            )
            if not self._use_phase_c and n > 0:
                trunc_frac = float(win.truncated[:n].sum()) / n
                if trunc_frac > 0.03:
                    self._use_phase_c = True

            len_eff = np.asarray(win.len_eff).astype(np.int64)
            arrays = {
                "len_eff": len_eff,
                "clip_before": np.array(win.clip_before)[:, None],
                "clip_after": np.array(win.clip_after)[:, None],
                "escalated": np.array(win.escalated)[:, None],
                "body_loc": np.array(win.body_loc).astype(np.int64)[:, None],
                "indels": np.array(win.indels)[:, None],
            }
            found = np.asarray(win.found)
            mapqs = np.asarray(win.mapq).astype(np.int64)
            dists = np.asarray(win.dist).astype(np.int64)
            dirs = np.asarray(win.direction).astype(np.int64)
            end_locs = np.asarray(win.end_loc).astype(np.int64)
            popular = np.asarray(win.popular).astype(np.int64)

        with RECORDER.span("finalize.fallback") as sp:
            fb_rows = np.flatnonzero(np.asarray(win.fallback[:n]))
            sp.count(rows=int(fb_rows.size))
            fb = None
            fb_pos = {}
            if fb_rows.size:
                P2 = 1
                while P2 < fb_rows.size:
                    P2 <<= 1
                pad_rows = np.zeros(P2, np.int64)
                pad_rows[: fb_rows.size] = fb_rows
                from .pipeline import unpack_merged_rows

                fb = unpack_merged_rows(
                    gather_merged_rows(
                        out_dev, torch.from_numpy(pad_rows).to(self.device)
                    ).cpu().numpy()
                )
                fb_pos = {int(r): j for j, r in enumerate(fb_rows)}
                self.branches["fallback"] += int(fb_rows.size)

        # -- edge-indel honesty: gapless dist-2 winners where one
        # 1-base indel explains both mismatches get SNAP's always-LV
        # treatment via an exact force-DP redo. The screen itself ran
        # on device (pipeline.winner_flags, the one_indel_improves
        # twin); the flag rides the packed winners.
        edge_mask = np.asarray(win.edge_indel[:n]).astype(bool)

        # -- batched-emission plan: the overwhelmingly common case of a
        # found, gapless, unclipped, single-contig primary alignment is
        # fully determined by the packed winner columns — vectorize it
        # and skip the per-read Python below (the e2e hot path)
        with RECORDER.span("finalize.plan") as sp:
            n_planned = 0
            plan = None
            simple_mask = None
            # SAM-input aux passthrough needs per-read variable tags: take
            # the per-record path for this batch (plan stays None)
            plan_batch_ok = plan_writer is not None and batch.aux is None
            if plan_batch_ok:
                orig = np.asarray(batch.lengths[:n]).astype(np.int64)
                plen = len_eff[:n]
                fe = np.asarray(front_clips[:n]).astype(np.int64)
                back_q = orig - fe - plen
                start_loc = end_locs[:n] - plen
                starts, ends = self.contig_bounds
                ci = np.searchsorted(starts, start_loc, side="right") - 1
                cis = np.clip(ci, 0, len(starts) - 1)
                inside = (
                    (ci >= 0)
                    & (start_loc >= starts[cis])
                    & (start_loc + plen <= ends[cis])
                )
                simple_mask = (
                    found[:n]
                    & ~np.asarray(win.fallback[:n]).astype(bool)
                    & ~np.asarray(win.truncated[:n]).astype(bool)
                    & (orig >= self.min_read_length)
                    & (np.asarray(win.indels[:n]) == 0)
                    & (np.asarray(win.clip_before[:n]) == 0)
                    & (np.asarray(win.clip_after[:n]) == 0)
                    & (back_q >= 0)
                    & inside
                    & ~edge_mask
                )
                if self.params.use_affine_gap:
                    # emission-time AG CIGAR rule (ReadWriter.cpp:231):
                    # dist>=2 rows where a single gap ties/beats the
                    # substitutions leave the vectorized plan and take the
                    # per-read AG traceback in winner_record. Screened on
                    # device (pipeline.winner_flags, the
                    # ag_restructure_possible twin).
                    simple_mask &= ~np.asarray(win.ag_flip[:n]).astype(bool)
                srows = np.flatnonzero(simple_mask)
                n_planned = int(srows.size)
                sp.count(rows=n_planned)
                self.branches["planned"] += n_planned
                if srows.size:
                    mq = mapqs[srows].astype(np.int32)
                    if self.stop_on_first_hit:
                        mq = np.zeros_like(mq)
                    d = dirs[srows]
                    plan = {
                        "mask": simple_mask,
                        "rows": srows.astype(np.int32),
                        "flag": (d.astype(np.int32) * 16),
                        "rname_id": cis[srows].astype(np.int32),
                        "pos": (
                            start_loc[srows] - starts[cis[srows]] + 1
                        ).astype(np.int64),
                        "mapq": mq,
                        "fs": np.where(
                            d == 1, back_q[srows], fe[srows]
                        ).astype(np.int32),
                        "mlen": plen[srows].astype(np.int32),
                        "bs": np.where(
                            d == 1, fe[srows], back_q[srows]
                        ).astype(np.int32),
                        "nm": dists[srows].astype(np.int32),
                        "rlen": orig[srows].astype(np.int32),
                    }
                else:
                    simple_mask = None

        # -- batched AG CIGARs for escalated winners AND device-flagged
        # gapless restructure rows (win.ag_flip): one LV start-recovery
        # sweep + one native AG call replace the per-row traceback
        # pipeline (the emission hot path for the ~4% of reads whose
        # alignment needed gaps or a restructured CIGAR)
        ag_cache: dict[int, tuple | None] = {}
        with RECORDER.span("finalize.ag_batch") as sp:
            esc_flags = np.asarray(win.escalated[:n]).astype(bool)
            flip_flags = np.asarray(win.ag_flip[:n]).astype(bool)
            flag_known = (
                ~np.asarray(win.fallback[:n]).astype(bool)
                & ~np.asarray(win.truncated[:n]).astype(bool)
            )
            if self.params.use_affine_gap:
                ag_base = (
                    found[:n]
                    & flag_known
                    & ~edge_mask
                    & (np.asarray(batch.lengths[:n]) >= self.min_read_length)
                    & (dists[:n] > 0)
                )
                ag_rows = np.flatnonzero(ag_base & (esc_flags | flip_flags))
                ag_rows = [i for i in ag_rows if i not in fb_pos]
                sp.count(rows=len(ag_rows))
                if ag_rows:
                    self.branches["ag_batch_escalated"] += int(esc_flags[ag_rows].sum())
                    self.branches["ag_batch_flip"] += int(
                        (flip_flags[ag_rows] & ~esc_flags[ag_rows]).sum()
                    )
                    from .agcigar import compute_ag_cigar_batch
                    from .cigar import recover_starts_batch

                    bodies, bquals_l, fcs, bcs, mgs = [], [], [], [], []
                    lv_pats, lv_sub = [], []  # start recovery for flip rows
                    locs_arr = np.empty(len(ag_rows), np.int64)
                    for t, i in enumerate(ag_rows):
                        plen_i = int(len_eff[i])
                        fe_i = int(front_clips[i])
                        back_q_i = int(batch.lengths[i]) - fe_i - plen_i
                        clipped = batch.bases[i, fe_i : fe_i + plen_i]
                        cq = batch.quals[i, fe_i : fe_i + plen_i]
                        if dirs[i]:
                            pat = reverse_complement_codes(clipped.copy())
                            oq = cq[::-1].copy()
                            f0, b0 = back_q_i, fe_i
                        else:
                            pat, oq = clipped, cq
                            f0, b0 = fe_i, back_q_i
                        cb = int(arrays["clip_before"][i, 0])
                        ca = int(arrays["clip_after"][i, 0])
                        bodies.append(pat[cb : plen_i - ca])
                        bquals_l.append(oq[cb : plen_i - ca])
                        if esc_flags[i]:
                            locs_arr[t] = int(arrays["body_loc"][i, 0])
                        else:
                            # flip row: recover the LV alignment start in
                            # the batched sweep below (winner_record's
                            # non-escalated branch, done once for all rows)
                            lv_pats.append(bodies[-1])
                            lv_sub.append(t)
                        fcs.append(f0 + cb)
                        bcs.append(b0 + ca)
                        mgs.append(
                            min(MAX_K_TRACEBACK, max(8, 2 * int(dists[i]) + 8))
                        )
                    if lv_sub:
                        sub = np.asarray(lv_sub)
                        rws = np.asarray(ag_rows)[sub]
                        locs_arr[sub] = recover_starts_batch(
                            lv_pats, self.genome_np, end_locs[rws],
                            np.minimum(
                                self.params.max_k, dists[rws] + 2
                            ),
                        )
                    res_b = compute_ag_cigar_batch(
                        self.genome_np, bodies, bquals_l, locs_arr,
                        np.asarray(fcs, np.int32), np.asarray(bcs, np.int32),
                        np.asarray(mgs, np.int32), use_m=self.use_m,
                    )
                    for i, r in zip(ag_rows, res_b):
                        ag_cache[int(i)] = r

        with RECORDER.span("finalize.per_read", rows=n - n_planned):
            results = []
            for i in range(n):
                if simple_mask is not None and simple_mask[i]:
                    results.append(_PLANNED)
                    continue
                orig_len = int(batch.lengths[i])
                if orig_len < self.min_read_length:
                    results.append({"status": "filtered"})
                    continue
                arr_i, k = i, 0
                if i in fb_pos:
                    j = fb_pos[i]
                    ra, _ = finalize_read(
                        fb["dist"][j], fb["log_prob"][j], fb["ag_score"][j],
                        fb["end_loc"][j], fb["cand_loc"][j], fb["direction"][j],
                        fb["valid"][j], int(popular[i]),
                        is_alt=(
                            fb["cand_loc"][j] >= self.first_alt_start
                        ),
                        alt_awareness=self.alt_awareness,
                        max_score_gap_to_prefer_non_alt=self.max_score_gap,
                        max_k=self.params.max_k,
                        extra_search_depth=self.params.extra_search_depth,
                        use_ukkonen=self.params.use_ukkonen,
                        lv_dists=np.asarray(fb["lv_dist"][j]),
                    )
                    if ra.status == "notfound":
                        results.append({"status": "notfound"})
                        continue
                    # rebuild the winner-row view from the exact result
                    kk = ra.cand_index
                    arrays["clip_before"][i, 0] = fb["clip_before"][j, kk]
                    arrays["clip_after"][i, 0] = fb["clip_after"][j, kk]
                    arrays["escalated"][i, 0] = fb["escalated"][j, kk]
                    arrays["body_loc"][i, 0] = fb["body_loc"][j, kk]
                    arrays["indels"][i, 0] = fb["indels"][j, kk]
                    status, mapq, direction = ra.status, ra.mapq, ra.direction
                    dist, end_loc = ra.dist, int(ra.end_loc)
                else:
                    if not found[i]:
                        results.append({"status": "notfound"})
                        continue
                    mapq = int(mapqs[i])
                    status = "single" if mapq >= 10 else "multi"
                    direction = int(dirs[i])
                    dist = int(dists[i])
                    end_loc = int(end_locs[i])
                if self.stop_on_first_hit:
                    mapq, status = 0, "multi"
                self.branches["per_read"] += 1
                rec = winner_record(
                    self.genome_np, self.params.max_k, batch, i, arrays,
                    k, direction, dist, end_loc, arr_i=arr_i,
                    use_m=self.use_m, front_extra=int(front_clips[i]),
                    contig_bounds=self.contig_bounds,
                    use_affine_gap=self.params.use_affine_gap,
                    ag_penalties=(self.params.ag_match, self.params.ag_sub,
                                  self.params.ag_open, self.params.ag_extend),
                    precomputed_ag=ag_cache.get(i, _AG_NOT_CACHED),
                    # device-screened restructure flag (winner_flags);
                    # unknown (None -> row screen) for fallback-redone rows
                    ag_restructure=(
                        bool(flip_flags[i])
                        if flag_known[i] and i not in fb_pos
                        else None
                    ),
                )
                rec.update(
                    status=status, direction=direction, mapq=mapq, dist=dist,
                )
                results.append(rec)
        self._redo_wide(
            batch, results,
            np.flatnonzero(np.asarray(win.truncated[:n])),
            front_clips,
        )
        if edge_mask.any():
            self._redo_wide(
                batch, results, np.flatnonzero(edge_mask), front_clips,
                force_dp=True,
            )
        if plan_writer is not None:
            return results, plan
        return results

    def align_file(self, fastq_path: str, writer: SamWriter) -> AlignerStats:
        writer.write_header()
        t0 = time.time()
        plan_ok = self._plan_ok(writer)
        progress = ProgressReporter()
        from ..io.readers import ReadAheadQueue, input_kind

        if (
            self.threads > 1
            and (self.force_kind or input_kind(fastq_path)) == "fastq"
            and not self.force_gzip
            and not fastq_path.endswith(".gz")
        ):
            # -t N: RangeSplitter parse threads over record-aligned
            # byte ranges (RangeSplitter.h:38); output order unchanged.
            # Every range ends in a short batch, and the batches are
            # aligned as they come, as snap_tpu aligns them: a batch's
            # make-up decides its batch-level paths (the DP tier's
            # overflow, the phase-C switch), so -t N may write other
            # records than -t 1, and the same as snap_tpu's -t N
            from ..io.range_split import parallel_read_batches

            reader = "reader_range_split"
            source = parallel_read_batches(
                fastq_path, self.batch_size, self.max_read_len,
                threads=self.threads,
            )
        else:
            reader = "reader_serial"
            source = single_batches(
                fastq_path, self.batch_size, self.max_read_len,
                keep_secondary=self.read_secondary,
                force_kind=self.force_kind, force_gzip=self.force_gzip,
            )
        batches = iter(ReadAheadQueue(self._count_reads(source, reader)))
        # pipelined loop: batch i+1 is dispatched to the device before
        # batch i's host finalization/emission (double-buffered, the
        # moral equivalent of SNAP's reader/aligner thread decoupling)
        try:
            self._align_file_loop(batches, writer, plan_ok, progress)
        finally:
            self.close()
        self.stats.align_seconds = time.time() - t0
        return self.stats

    def _count_reads(self, source, branch: str):
        """The batches of `source`, their reads counted in branches[branch]."""
        for batch in source:
            self.branches[branch] += len(batch)
            yield batch

    def _align_file_loop(self, batches, writer, plan_ok, progress):
        """The stages tile the loop, each a span with its batch number:
        single.read_wait, single.submit, single.finalize, single.emit;
        their seconds are AlignerStats' reading, aligning and writing."""
        pending = None
        n_read = 0  # the number of the batch read next
        while True:
            with RECORDER.timed("single.read_wait", batch=n_read) as sp:
                batch = next(batches, None)
            self.stats.seconds_reading += sp.seconds
            if batch is not None:
                with RECORDER.timed(
                    "single.submit", batch=n_read, reads=len(batch)
                ) as sp:
                    sub = (n_read, batch, *self._submit(batch))
                self.stats.seconds_aligning += sp.seconds
                n_read += 1
            else:
                sub = None
            if pending is not None:
                k, pbatch, pout, pfc = pending
                self.branches["batches"] += 1
                with RECORDER.timed(
                    "single.finalize", batch=k, reads=len(pbatch)
                ) as sp:
                    pw = writer if plan_ok else None
                    if pw is not None:
                        results, plan = self._finalize(
                            pbatch, pout, pfc, plan_writer=pw
                        )
                    else:
                        results, plan = self._finalize(pbatch, pout, pfc), None
                dt = sp.seconds
                self.stats.seconds_aligning += dt
                if self.attach_times:
                    # -at: batched alignment has no per-read clock; tag
                    # the batch-average microseconds per read
                    self._batch_us_per_read = int(
                        dt * 1e6 / max(len(pbatch), 1)
                    )
                planned = 0 if plan is None else len(plan["rows"])
                with RECORDER.timed(
                    "single.emit", batch=k, reads=len(pbatch), planned=planned
                ) as sp:
                    if plan is not None:
                        self._emit_planned(writer, pbatch, results, plan)
                    else:
                        with RECORDER.span("emit.per_read", rows=len(results)):
                            for i, res in enumerate(results):
                                self._emit(writer, pbatch, i, res)
                self.stats.seconds_writing += sp.seconds
                progress.update(len(pbatch))
                if self.kill_if_too_slow:
                    # -kts watchdog (ReadWriter.cpp:144-165): fewer than
                    # 1000 writes/s over a 5-minute check period usually
                    # means memory thrash; give up instead of crawling
                    self._kts_writes += len(pbatch)
                    now = time.time()
                    if self._kts_last_check == 0.0:
                        self._kts_last_check = now
                    elif now - self._kts_last_check >= 300.0:
                        if self._kts_writes < 5 * 60 * 1000:
                            from ..errors import write_error

                            write_error(
                                f"Only wrote {self._kts_writes} reads "
                                "during a 5 minute check period; "
                                "probably out of memory — giving up "
                                "because of -kts"
                            )
                            raise SystemExit(1)
                        self._kts_last_check = now
                        self._kts_writes = 0
            if sub is None:
                break
            pending = sub

    def _emit_planned(self, writer, batch: ReadBatch, results, plan):
        """Batched emission: format every planned (simple) record in one
        native call, update stats vectorized, and interleave the blob's
        runs with the per-read path for the remaining rows so output
        order is exactly the input read order."""
        from ..io import native as _native

        with RECORDER.span("emit.format") as sp:
            ids = batch.ids
            qname_off = np.zeros(len(ids) + 1, dtype=np.int64)
            np.cumsum([len(x) for x in ids], out=qname_off[1:])
            qname_buf = b"".join(ids)
            names = self._sorted_contig_names
            rname_off = np.zeros(len(names) + 1, dtype=np.int64)
            np.cumsum([len(x) for x in names], out=rname_off[1:])
            rname_buf = b"".join(names)
            tag_pg = f"PG:Z:{writer.program_id}".encode()
            rg = [f"RG:Z:{writer.read_group.rg_id}"] + [
                f"{k}:Z:{v}" for k, v in writer.read_group.attrs
            ]
            tag_tail = ("\t" + "\t".join(rg)).encode()
            formatted = _native.format_sam_simple(
                batch.bases, batch.quals, qname_buf, qname_off,
                rname_buf, rname_off, plan["rows"], plan["flag"],
                plan["rname_id"], plan["pos"], plan["mapq"], plan["fs"],
                plan["mlen"], plan["bs"], plan["nm"], plan["rlen"],
                tag_pg, tag_tail,
            )
            if formatted is not None:
                sp.count(bytes=len(formatted[0]))
        if formatted is None:  # native library vanished mid-run
            for i, res in enumerate(results):
                if res is _PLANNED:
                    raise RuntimeError(
                        "native SAM formatter unavailable after planning"
                    )
                self._emit(writer, batch, i, res)
            return
        blob, rec_end = formatted
        srows = plan["rows"]
        mq = plan["mapq"]
        ns = len(srows)
        self.stats.total += ns
        n_single = int((mq >= MAPQ_LIMIT_FOR_SINGLE_HIT).sum())
        self.stats.single += n_single
        self.stats.multi += ns - n_single
        self.stats.mapq_histogram += np.bincount(
            np.minimum(mq, 70), minlength=71
        )
        out = writer.out
        complex_rows = np.flatnonzero(~plan["mask"])
        k = 0  # planned records already flushed
        with RECORDER.span("emit.per_read", rows=len(complex_rows)):
            for i in complex_rows:
                j = int(np.searchsorted(srows, i))
                if j > k:
                    a = 0 if k == 0 else int(rec_end[k - 1])
                    with RECORDER.span("emit.write"):
                        out.write(blob[a : int(rec_end[j - 1])])
                    k = j
                self._emit(writer, batch, int(i), results[int(i)])
        if k < ns:
            a = 0 if k == 0 else int(rec_end[k - 1])
            with RECORDER.span("emit.write"):
                out.write(blob[a:])

    def _emit(self, writer: SamWriter, batch: ReadBatch, i: int, res: dict):
        from ..constants import BASE_DECODE

        self.stats.total += 1
        qname = batch.ids[i]
        L = int(batch.lengths[i])
        seq = BASE_DECODE[batch.bases[i, :L]].tobytes()
        qual = batch.quals[i, :L].tobytes()
        in_aux = batch.aux[i] if batch.aux is not None else b""
        status = res["status"]
        if status in ("filtered", "notfound"):
            if status == "filtered":
                self.stats.too_short += 1
            else:
                self.stats.not_found += 1
            if pass_filter(self.filter_flags, status):
                writer.write_record(
                    qname, FLAG_UNMAPPED, "*", 0, 0, "*", seq, qual,
                    nm=None, input_aux=in_aux,
                )
            else:
                self.stats.filtered += 1
            return
        loc = writer.locate(res["start_loc"])
        if loc is None:  # aligned into padding: emit unmapped (junk filter)
            self.stats.not_found += 1
            if pass_filter(self.filter_flags, "notfound"):
                writer.write_record(
                    qname, FLAG_UNMAPPED, "*", 0, 0, "*", seq, qual,
                    nm=None, input_aux=in_aux,
                )
            else:
                self.stats.filtered += 1
            return
        rname, pos = loc
        mapq = res["mapq"]
        if mapq >= MAPQ_LIMIT_FOR_SINGLE_HIT:
            self.stats.single += 1
        else:
            self.stats.multi += 1
        self.stats.mapq_histogram[min(70, mapq)] += 1
        if pass_filter(self.filter_flags, res["status"]):
            flag = FLAG_RC if res["direction"] else 0
            extra = (
                [f"{self.internal_score_tag}:i:{res['dist']}"]
                if self.internal_score_tag
                else []
            )
            if self.attach_times:
                extra = list(extra) + [f"AT:i:{self._batch_us_per_read}"]
            writer.write_record(
                qname, flag, rname, pos, mapq, res["cigar"], seq, qual,
                nm=res["nm"], extra_tags=extra, input_aux=in_aux,
            )
        else:
            self.stats.filtered += 1
        supp = res.get("alt_supplementary")
        if supp is not None:
            sloc = writer.locate(supp["start_loc"])
            if sloc is not None:
                from ..io.sam import FLAG_SUPPLEMENTARY

                sflag = FLAG_SUPPLEMENTARY | (FLAG_RC if supp["direction"] else 0)
                writer.write_record(
                    qname, sflag, sloc[0], sloc[1], supp["mapq"],
                    supp["cigar"], seq, qual, nm=supp["nm"],
                )
                self.stats.extra_alignments += 1
        self._emit_secondaries(writer, qname, rname, seq, qual, res)

    def _emit_secondaries(self, writer, qname, primary_rname, seq, qual, res):
        """Secondary (-om) emission with the -mpc per-contig cap."""
        secs = res.get("secondaries")
        if not secs:
            return
        from ..io.sam import FLAG_SECONDARY, FLAG_SUPPLEMENTARY

        contig_counts: dict[str, int] = {primary_rname: 1}
        emitted = 0
        for s in secs:
            sloc = writer.locate(s["start_loc"])
            if sloc is None:
                continue
            rname, pos = sloc
            if self.max_secondary_per_contig > 0:
                n = contig_counts.get(rname, 0) + 1
                if n > self.max_secondary_per_contig + (
                    1 if rname == primary_rname else 0
                ):
                    continue
                contig_counts[rname] = n
            if not pass_filter(self.filter_flags, "multi", secondary=True):
                continue
            flag = (
                FLAG_SUPPLEMENTARY if s.get("supplementary") else FLAG_SECONDARY
            ) | (FLAG_RC if s["direction"] else 0)
            writer.write_record(
                qname, flag, rname, pos, 0, s["cigar"], seq, qual,
                nm=s["nm"],
            )
            emitted += 1
        self.stats.extra_alignments += emitted
