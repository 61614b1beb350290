"""Write-time CIGAR via affine-gap global alignment (host, numpy).

Behavioral reference: SNAP emits CIGARs for any read with
usedAffineGapScoring || score > 0 through
AffineGapVectorizedWithCigar::computeGlobalScoreNormalized
(SAM.cpp:2678, AffineGapVectorized.cpp:1043) and loops on
addFrontClipping, shifting POS / adding soft clips until stable
(SAM.cpp:1966-2050). Mirrored here:

- global-in-pattern affine DP (no 0-floor; leading gaps charged),
  text end free with ties preferring the latest row
  (AffineGapVectorized.cpp:351-356);
- traceback with the reference's tie rules (E beats M only if
  strictly greater, F beats max(M,E) only if strictly greater;
  gap runs continue while gap-matrix value strictly beats reopening);
- leading (in traceback order) insertions become soft clip
  (tail insertions, AffineGapVectorized.cpp:450-457);
- the two insertion-normalization passes over (action, count) runs
  (AffineGapVectorized.cpp:459-509);
- first-op D => addFrontClipping>0 (shift POS), first-op I =>
  negative (extra soft clip) (AffineGapVectorized.cpp:1080-1092).
"""

from __future__ import annotations

import numpy as np

from ..constants import AG_GAP_EXTEND, AG_GAP_OPEN, AG_MATCH, AG_MISMATCH, MAX_K

OPEN = AG_GAP_OPEN + AG_GAP_EXTEND
EXT = AG_GAP_EXTEND
NEG = -(10 ** 7)


def _tscore(a: np.ndarray, b) -> np.ndarray:
    """Transition score; any N/pad involvement scores -1."""
    return np.where(
        (a >= 4) | (b >= 4),
        -1,
        np.where(a == b, AG_MATCH, -AG_MISMATCH),
    )


def ag_global_alignment(text: np.ndarray, pattern: np.ndarray):
    """Global-in-pattern affine DP + traceback.

    Returns (ops, text_used, n_edits_will_be_recomputed) where ops is a
    list of (action, count) with actions in 'MID', in alignment order.
    Returns None if no alignment (shouldn't happen with enough text).
    """
    L, T = len(pattern), len(text)
    if L == 0:
        return [], 0
    from ..io.native import ag_traceback

    nat = ag_traceback(text, pattern, OPEN, EXT, AG_MATCH, AG_MISMATCH)
    if nat is not None:
        return nat
    # DP matrices: H/E/F over [T, L]; E[i][j] from row i-1, F within row.
    M = np.full((T, L), NEG, dtype=np.int64)   # H actually (max of M,E,F)
    Mm = np.full((T, L), NEG, dtype=np.int64)  # the match-state component
    Ee = np.full((T, L), NEG, dtype=np.int64)
    Ff = np.full((T, L), NEG, dtype=np.int64)

    h_prev = -(OPEN + np.arange(L, dtype=np.int64) * EXT)  # row -1
    e = np.full(L, NEG, dtype=np.int64)
    best, best_row = NEG, -1
    jix = np.arange(L, dtype=np.int64)
    for i in range(T):
        h_init = 0 if i == 0 else -(OPEN + (i - 1) * EXT)
        hdiag = np.concatenate(([h_init], h_prev[:-1]))
        m = hdiag + _tscore(pattern, text[i])
        # F recurrence f[j] = max(f[j-1]-EXT, m[j-1]-OPEN) as a prefix
        # max: f[j] = max_{l<j}(m[l] - OPEN + l*EXT) - (j-1)*EXT
        f = np.full(L, NEG, dtype=np.int64)
        if L > 1:
            p = np.maximum.accumulate(m - OPEN + jix * EXT)
            f[1:] = p[:-1] - (jix[1:] - 1) * EXT
        h = np.maximum(np.maximum(m, e), f)
        Mm[i] = m
        Ee[i] = e
        Ff[i] = f
        M[i] = h
        if h[L - 1] >= best:
            best, best_row = h[L - 1], i
        e = np.maximum(e - EXT, m - OPEN)
        h_prev = h

    # traceback from (best_row, L-1), starting in H
    i, j = best_row, L - 1
    raw: list[str] = []  # actions in reverse order
    state = "H"
    while i >= 0 and j >= 0:
        if state == "H":
            m, ev, fv = Mm[i, j], Ee[i, j], Ff[i, j]
            if fv > max(m, ev):
                state = "I"
            elif ev > m:
                state = "D"
            else:
                raw.append("M")
                i -= 1
                j -= 1
        elif state == "D":
            # E[i][j] came from max(E[i-1][j]-EXT, M-ish[i-1][j]-OPEN)
            raw.append("D")
            cont = i >= 1 and (Ee[i - 1, j] - EXT > Mm[i - 1, j] - OPEN)
            i -= 1
            state = "D" if cont else "H"
        else:  # I
            raw.append("I")
            cont = j >= 1 and (Ff[i, j - 1] - EXT > Mm[i, j - 1] - OPEN)
            j -= 1
            state = "I" if cont else "H"
    if i >= 0:
        raw.extend(["D"] * (i + 1))
    if j >= 0:
        raw.extend(["I"] * (j + 1))

    # run-length encode in reverse (traceback) order, like SNAP's res[]
    runs: list[list] = []
    for a in raw:
        if runs and runs[-1][0] == a:
            runs[-1][1] += 1
        else:
            runs.append([a, 1])
    return runs, best_row + 1


def ag_global_cigar_ops(
    text: np.ndarray,
    pattern: np.ndarray,
    quality: np.ndarray,
    aln=None,
):
    """Returns (ops_list [(action, count)...] alignment order, tail_ins,
    n_edits, net_del). Mirrors computeGlobalScore's post-processing.
    aln: ag_global_alignment's (runs, text_used) for these arguments,
    where the caller has it already (the card's batch)."""
    runs, text_used = ag_global_alignment(text, pattern) if aln is None else aln
    if not runs:
        return [], 0, 0, 0
    # runs are in traceback (reverse) order; runs[0] is the END of the
    # alignment. A trailing insertion run becomes a soft clip.
    min_i = 0
    tail_ins = 0
    if runs[0][0] == "I":
        min_i = 1
        tail_ins = runs[0][1]

    # --- normalization pass 1: flip insertion-before-substitution ---
    # (AffineGapVectorized.cpp:459-482). Walk runs from the start of the
    # alignment (end of list), tracking pattern/text cursors.
    n = len(runs)
    row = col = 0
    for i in range(n - 1, min_i - 1, -1):
        a, c = runs[i]
        if a == "M":
            row += c
            col += c
        elif a == "D":
            row += c
        else:
            if i > 0 and row < text_used - 1 and col < len(pattern) - 1:
                if (
                    pattern[col + 1] == pattern[col]
                    and pattern[col + 1] != text[row]
                    and quality[col] < 65
                ):
                    if i + 1 <= n - 1 and runs[i + 1][0] == "M" and runs[i - 1][1] > 1:
                        runs[i + 1][1] += 1
                        row += 1
                        col += 1
                    if runs[i - 1][0] == "M" and runs[i - 1][1] > 1:
                        runs[i - 1][1] -= 1
            col += c
    # --- normalization pass 2 (AffineGapVectorized.cpp:485-509) ---
    row = col = 0
    for i in range(n - 1, min_i - 1, -1):
        a, c = runs[i]
        if a == "M":
            row += c
            col += c
        elif a == "D":
            row += c
        else:
            if i > 0 and row + 1 < text_used - 1 and col + c < len(pattern) - 1:
                if (
                    pattern[col + c] == pattern[col]
                    and pattern[col + c + 1] != text[row + 1]
                    and quality[col] < 65
                ):
                    if i + 1 <= n - 1 and runs[i + 1][0] == "M" and runs[i - 1][1] > 2:
                        runs[i + 1][1] += 2
                        row += 2
                        col += 2
                    if runs[i - 1][0] == "M" and runs[i - 1][1] > 2:
                        runs[i - 1][1] -= 2
            col += c

    # --- final: reverse to alignment order, compute edits/netDel ---
    ops = []
    n_edits = 0
    net_del = 0
    row = col = 0
    for i in range(n - 1, min_i - 1, -1):
        a, c = runs[i]
        if a == "D":
            row += c
            net_del += c
            n_edits += c
        elif a == "I":
            col += c
            n_edits += c
        else:
            n_edits += int(np.sum(text[row : row + c] != pattern[col : col + c]))
            row += c
            col += c
        if ops and ops[-1][0] == a:
            ops[-1][1] += c
        else:
            ops.append([a, c])
    return ops, tail_ins, n_edits, net_del


def compute_ag_cigar_at(
    genome: np.ndarray,
    genome_loc: int,
    pattern: np.ndarray,
    quality: np.ndarray,
    front_clip: int,
    back_clip: int,
    use_m: bool = True,
    max_iters: int = 8,
    text_margin: int = MAX_K,
):
    """Full writer-side CIGAR with the addFrontClipping fixup loop.

    pattern/quality: the aligned body (oriented, aligner clips removed).
    Returns (final_loc, cigar, nm) or None if it failed to stabilize.

    text_margin bounds extra reference beyond the pattern span — the
    net deletions the alignment may use. The reference's emission AG is
    score-limited the same way (SAM.cpp:2520 passes the known score as
    w), so callers that know the edit distance pass dist + slack and
    the DP shrinks from O((L+MAX_K)*L) to O((L+d)*L).
    """
    state = (int(genome_loc), pattern, quality, front_clip)
    for _ in range(max_iters):
        loc, pattern, quality, fclip = state
        if len(pattern) == 0:
            return None
        text = np.asarray(
            genome[loc : loc + len(pattern) + text_margin], dtype=np.uint8
        )
        res, state = _fixup_round(
            text, ag_global_alignment(text, pattern), loc, pattern, quality,
            fclip, back_clip, use_m,
        )
        if state is None:
            return res
    return None


def _fixup_round(text, aln, loc, pattern, quality, fclip, bclip, use_m):
    """One round of compute_ag_cigar_at's addFrontClipping loop on the
    alignment `aln` (ag_global_alignment's answer) of pattern against
    text = genome[loc:...]. Returns (result, None) when the row is done,
    result (final_loc, cigar, nm) or None if it failed, else (None,
    (loc, pattern, quality, fclip)) for the next round."""
    ops, tail_ins, n_edits, _ = ag_global_cigar_ops(text, pattern, quality, aln)
    if not ops:
        return None, None
    add_front = 0
    if ops[0][0] == "D":
        add_front = ops[0][1]
    elif ops[0][0] == "I":
        add_front = -ops[0][1]
    if add_front > 0:
        # alignment really starts later: shift location
        return None, (loc + add_front, pattern, quality, fclip)
    if add_front < 0:
        # leading insertion: soft-clip those pattern bases
        k = -add_front
        return None, (loc, pattern[k:], quality[k:], fclip + k)
    if tail_ins:
        bclip += tail_ins
    # strip trailing deletions (never emitted)
    while ops and ops[-1][0] == "D":
        n_edits -= ops[-1][1]
        ops.pop()
    parts = []
    if fclip:
        parts.append(f"{fclip}S")
    if use_m:
        parts += [f"{c}{a}" for a, c in ops]
    else:
        parts += _eq_x_ops(ops, text, pattern)
    if bclip:
        parts.append(f"{bclip}S")
    return (loc, "".join(parts), n_edits), None


def _eq_x_ops(ops, text, pattern):
    parts = []
    row = col = 0
    for a, c in ops:
        if a == "D":
            parts.append(f"{c}D")
            row += c
        elif a == "I":
            parts.append(f"{c}I")
            col += c
        else:
            run_is_x = None
            run = 0
            for j in range(c):
                x = text[row + j] != pattern[col + j]
                if run_is_x is None or x == run_is_x:
                    run_is_x = x
                    run += 1
                else:
                    parts.append(f"{run}{'X' if run_is_x else '='}")
                    run_is_x = x
                    run = 1
            if run:
                parts.append(f"{run}{'X' if run_is_x else '='}")
            row += c
            col += c
    return parts


def compute_ag_cigar_batch(
    genome: np.ndarray,
    bodies: list,      # [n] oriented body code arrays (clips removed)
    quals: list,       # [n] matching quality byte arrays
    locs: np.ndarray,  # [n] starting body locations
    fclips: np.ndarray,
    bclips: np.ndarray,
    margins: np.ndarray,
    use_m: bool = True,
    genome_t=None,
):
    """Batched compute_ag_cigar_at over n rows.

    `genome_t`: the index's genome tensor. On the card, the DP and
    traceback of every row run there, one kernel launch a round of the
    fixup loop (_card_batch). Otherwise one native call
    (snapio_ag_cigar_batch) replaces the per-row Python
    fixup/normalize/render pipeline; rows the native path could not
    stabilize (or the whole batch, when the library is missing) fall
    back to the per-row Python implementation. Returns a list of
    (final_loc, cigar, nm) | None per row.
    """
    if genome_t is not None and genome_t.is_cuda:
        return _card_batch(genome, genome_t, bodies, quals, locs, fclips,
                           bclips, margins, use_m)
    from ..io.native import ag_cigar_batch

    n = len(bodies)
    out: list = [None] * n
    native = None
    if n:
        pat_off = np.zeros(n + 1, np.int64)
        for i, b in enumerate(bodies):
            pat_off[i + 1] = pat_off[i] + len(b)
        pat_buf = np.concatenate([np.asarray(b, np.uint8) for b in bodies])
        qual_buf = np.concatenate([np.asarray(q, np.uint8) for q in quals])
        native = ag_cigar_batch(
            genome, pat_buf, qual_buf, pat_off,
            np.asarray(locs, np.int64),
            np.asarray(fclips, np.int32), np.asarray(bclips, np.int32),
            np.asarray(margins, np.int32),
            OPEN, EXT, AG_MATCH, AG_MISMATCH, use_m=use_m,
        )
    if native is not None:
        out_loc, out_nm, cigars = native
        for i in range(n):
            if out_loc[i] >= 0:
                out[i] = (int(out_loc[i]), cigars[i], int(out_nm[i]))
        return out
    for i in range(n):
        out[i] = compute_ag_cigar_at(
            genome, int(locs[i]), bodies[i], quals[i],
            int(fclips[i]), int(bclips[i]), use_m=use_m,
            text_margin=int(margins[i]),
        )
    return out


def _card_batch(genome, genome_t, bodies, quals, locs, fclips, bclips,
                margins, use_m, max_iters: int = 8):
    """compute_ag_cigar_batch with the DP on genome_t's device (the
    card; the plain version for a CPU tensor): each round of the fixup
    loop aligns its rows in one ops.agcigar_cuda call, and the
    host normalizes, renders and shifts or clips each row as
    _fixup_round does; the rows whose first op is D or I go round again,
    up to max_iters rounds, as in snapio_ag_cigar_batch. Rows of any
    length run there (a row whose traceback plane does not fit one
    block's shared memory runs the kernel's global-plane case). Counts
    on the open span: `iters` (rounds launched) and `rerun_rows` (rows
    aligned again after the first round)."""
    from ..ops.agcigar_cuda import OPS, ag_traceback_rows
    from ..stats import RECORDER

    n = len(bodies)
    out: list = [None] * n
    glen = len(genome)
    loc = [int(x) for x in locs]
    pat = [np.asarray(b, np.uint8) for b in bodies]
    qual = [np.asarray(q, np.uint8) for q in quals]
    fc = [int(x) for x in fclips]
    mg = [int(x) for x in margins]

    def tlen(r):
        return min(len(pat[r]) + mg[r], glen - loc[r])

    def alive(r):  # snapio_ag_cigar_batch's guards: else the row fails
        return len(pat[r]) > 0 and 0 <= loc[r] < glen

    active = list(range(n))
    for it in range(max_iters):
        active = [r for r in active if alive(r)]
        if not active:
            break
        T = [tlen(r) for r in active]
        P = [len(pat[r]) for r in active]
        meta = np.empty((len(active), 4), np.int64)
        meta[:, 0] = np.concatenate(([0], np.cumsum(P)[:-1]))
        meta[:, 1] = P
        meta[:, 2] = [loc[r] for r in active]
        meta[:, 3] = T
        res = ag_traceback_rows(
            genome_t, meta, np.concatenate([pat[r] for r in active]),
            OPEN, EXT, AG_MATCH, AG_MISMATCH,
        )
        RECORDER.tally("iters")
        if it:
            RECORDER.tally("rerun_rows", len(active))
        nxt = []
        for t, r in enumerate(active):
            nr = int(res[t, 0])
            if nr <= 0:
                continue
            runs = [[OPS[v & 3], v >> 2] for v in res[t, 2 : 2 + nr].tolist()]
            text = np.asarray(genome[loc[r] : loc[r] + T[t]], dtype=np.uint8)
            done, again = _fixup_round(
                text, (runs, int(res[t, 1])), loc[r], pat[r], qual[r], fc[r],
                int(bclips[r]), use_m,
            )
            if again is None:
                out[r] = done
            else:
                loc[r], pat[r], qual[r], fc[r] = again
                nxt.append(r)
        active = nxt
    return out
