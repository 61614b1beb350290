"""Winner traceback: CIGAR + exact start position (host, numpy).

Behavioral reference: SNAP recomputes the CIGAR at SAM-emission time
from (location, direction) via LandauVishkinWithCigar
(SAM.cpp:2354-2660), left-normalizing indels per the BWA/VCF convention
(computeEditDistanceNormalized, LandauVishkin.cpp:507-610) and emitting
'M'-style ops by default (useM, AlignerOptions.cpp:58).

The aligner's DP reports the alignment END location; this traceback
re-runs a small anchored DP over text ending there, walks the path back
(prefer match/sub, then fewest indels — the same tie-break as the
scoring kernel), then left-shifts indel runs.
"""

from __future__ import annotations

import numpy as np

OP_M, OP_I, OP_D = 0, 1, 2  # alignment column ops (M = match or mismatch)

_INDEL_BITS = 10
_UNIT = 1 << _INDEL_BITS       # one edit
_STEP = _UNIT + 1              # one edit + one indel base (lexicographic pack)
_INF = np.int64(1) << 40


def anchored_dp(pattern: np.ndarray, text: np.ndarray) -> np.ndarray:
    """Packed-cost DP matrix [plen+1, tl+1], free text start, all ends."""
    plen, tl = len(pattern), len(text)
    dp = np.full((plen + 1, tl + 1), _INF, dtype=np.int64)
    dp[0, :] = 0
    jidx = np.arange(tl + 1, dtype=np.int64) * _STEP
    for i in range(1, plen + 1):
        sub = np.where(text != pattern[i - 1], _UNIT, 0).astype(np.int64)
        row = np.full(tl + 1, _INF, dtype=np.int64)
        row[1:] = np.minimum(dp[i - 1, :-1] + sub, dp[i - 1, 1:] + _STEP)
        row[0] = dp[i - 1, 0] + _STEP
        # in-row deletions: row[j] = min_{l<=j} row[l] + (j-l)*STEP
        row = np.minimum.accumulate(row - jidx) + jidx
        dp[i] = row
    return dp


def traceback_ops(
    pattern: np.ndarray, text: np.ndarray, dp: np.ndarray
) -> tuple[int, np.ndarray, int]:
    """Walk back from (plen, tl). Returns (start_col, ops, dist)."""
    plen, tl = len(pattern), len(text)
    i, j = plen, tl
    ops: list[int] = []
    while i > 0:
        cur = dp[i, j]
        sub = _UNIT if (j < 1 or text[j - 1] != pattern[i - 1]) else 0
        if j >= 1 and dp[i - 1, j - 1] + sub == cur:
            ops.append(OP_M)
            i -= 1
            j -= 1
        elif dp[i - 1, j] + _STEP == cur:
            ops.append(OP_I)
            i -= 1
        elif j >= 1 and dp[i, j - 1] + _STEP == cur:
            ops.append(OP_D)
            j -= 1
        else:  # shouldn't happen; keep walking diagonally
            ops.append(OP_M)
            i -= 1
            j = max(0, j - 1)
    ops.reverse()
    dist = int(dp[plen, tl]) >> _INDEL_BITS
    return j, np.array(ops, dtype=np.int8), dist


def left_normalize(
    ops: np.ndarray, pattern: np.ndarray, text: np.ndarray, start_col: int
) -> np.ndarray:
    """Shift indel runs as far left as possible (BWA/VCF convention;
    ref: LandauVishkin.cpp:507-610 computeEditDistanceNormalized).

    A deletion of text[t0:t0+r) shifts one left iff
    text[t0-1] == text[t0+r-1] (the pattern base formerly matched to
    text[t0-1] then matches the equal base text[t0+r-1]); insertions
    shift iff pattern[p0-1] == pattern[p0+r-1]. The preceding op must
    be M in both cases.
    """
    ops = list(int(o) for o in ops)

    def positions(ops_list):
        p, t = 0, start_col
        pos = []
        for op in ops_list:
            pos.append((p, t))
            if op == OP_M:
                p += 1
                t += 1
            elif op == OP_I:
                p += 1
            else:
                t += 1
        return pos

    k = 0
    while k < len(ops):
        if ops[k] in (OP_I, OP_D):
            r = k
            while r < len(ops) and ops[r] == ops[k]:
                r += 1
            rlen = r - k
            pos = positions(ops)
            p0, t0 = pos[k]
            s = 0
            if ops[k] == OP_D:
                while (
                    k - 1 - s >= 0
                    and ops[k - 1 - s] == OP_M
                    and t0 - s - 1 >= 0
                    and text[t0 - s - 1] == text[t0 + rlen - 1 - s]
                ):
                    s += 1
            else:
                while (
                    k - 1 - s >= 0
                    and ops[k - 1 - s] == OP_M
                    and p0 - s - 1 >= 0
                    and pattern[p0 - s - 1] == pattern[p0 + rlen - 1 - s]
                ):
                    s += 1
            if s:
                ops[k - s : r] = ops[k:r] + ops[k - s : k]
            k = r
        else:
            k += 1
    return np.array(ops, dtype=np.int8)


def _anchored_dp_batch(patterns: np.ndarray, texts: np.ndarray) -> np.ndarray:
    """anchored_dp vectorized over rows.

    patterns [n, P] / texts [n, T] are right-padded; dp[r, :plen+1,
    :tl+1] equals anchored_dp(pattern_r, text_r) exactly, because every
    recurrence at (i, j) reads only pattern[:i] and text[:j] (padding
    can never flow left or up).
    """
    n, P = patterns.shape
    T = texts.shape[1]
    dp = np.full((n, P + 1, T + 1), _INF, dtype=np.int64)
    dp[:, 0, :] = 0
    jidx = np.arange(T + 1, dtype=np.int64) * _STEP
    row = np.empty((n, T + 1), dtype=np.int64)
    for i in range(1, P + 1):
        prev = dp[:, i - 1]
        sub = np.where(
            texts != patterns[:, i - 1 : i], _UNIT, 0
        ).astype(np.int64)
        np.minimum(prev[:, :-1] + sub, prev[:, 1:] + _STEP, out=row[:, 1:])
        row[:, 0] = prev[:, 0] + _STEP
        row -= jidx
        np.minimum.accumulate(row, axis=1, out=row)
        row += jidx
        dp[:, i] = row
    return dp


def recover_starts_batch(
    patterns: list,
    genome: np.ndarray,
    end_locs: np.ndarray,
    windows: np.ndarray,
) -> np.ndarray:
    """Batched LV start recovery.

    For each row, returns the start_loc that compute_cigar(pattern,
    genome, end_loc, window) would return — the anchored DP, the
    tie-broken traceback, left normalization, and the leading-deletion
    strip are identical — without rendering the CIGAR. One vectorized
    DP sweep replaces the per-row anchored_dp calls, which dominate
    the host emission cost for indel-bearing winners.
    """
    n = len(patterns)
    if n == 0:
        return np.empty(0, np.int64)
    end_locs = np.asarray(end_locs, np.int64)
    windows = np.asarray(windows, np.int64)
    plens = np.array([len(p) for p in patterns], np.int64)
    wstarts = np.maximum(0, end_locs - plens - windows - 1)
    tls = end_locs - wstarts
    P, T = int(plens.max()), int(tls.max())
    pat = np.full((n, P), 4, np.uint8)
    txt = np.full((n, T), 4, np.uint8)
    for r in range(n):
        pat[r, : plens[r]] = patterns[r]
        txt[r, : tls[r]] = genome[wstarts[r] : end_locs[r]]
    dp = _anchored_dp_batch(pat, txt)
    starts = np.empty(n, np.int64)
    for r in range(n):
        plen, tl = int(plens[r]), int(tls[r])
        text_r = txt[r, :tl]
        start_col, ops, _ = traceback_ops(
            patterns[r], text_r, dp[r, : plen + 1, : tl + 1]
        )
        ops = left_normalize(ops, patterns[r], text_r, start_col)
        lead = 0
        while lead < len(ops) and ops[lead] == OP_D:
            lead += 1
        starts[r] = wstarts[r] + start_col + lead
    return starts


def ops_to_cigar(
    ops: np.ndarray,
    front_clip: int = 0,
    back_clip: int = 0,
    use_m: bool = True,
    pattern: np.ndarray | None = None,
    text: np.ndarray | None = None,
    start_col: int = 0,
) -> str:
    """Render ops (+ soft clips) as a CIGAR string, merging runs.

    With use_m=False (`-=` style, SAM.cpp useM false branch), M columns
    split into '='/'X' runs by comparing pattern vs text; requires
    pattern/text/start_col.
    """
    parts: list[str] = []
    if front_clip:
        parts.append(f"{front_clip}S")
    p, t = 0, start_col
    run_op, run_len = None, 0

    def flush():
        if run_op is not None:
            parts.append(f"{run_len}{run_op}")

    for op in ops:
        op = int(op)
        if op == OP_M:
            if use_m:
                ch = "M"
            else:
                ch = "X" if text[t] != pattern[p] else "="
            p += 1
            t += 1
        elif op == OP_I:
            ch = "I"
            p += 1
        else:
            ch = "D"
            t += 1
        if ch == run_op:
            run_len += 1
        else:
            flush()
            run_op, run_len = ch, 1
    flush()
    if back_clip:
        parts.append(f"{back_clip}S")
    return "".join(parts) if parts else "*"


def compute_cigar(
    pattern: np.ndarray,   # aligned (possibly RC'd) clipped read codes
    genome: np.ndarray,
    end_loc: int,
    max_k: int,
    front_clip: int = 0,
    back_clip: int = 0,
    use_m: bool = True,
) -> tuple[int, str, int]:
    """Returns (start_loc, cigar, nm) for an alignment ending at end_loc."""
    plen = len(pattern)
    wstart = max(0, end_loc - plen - max_k - 1)
    text = np.asarray(genome[wstart:end_loc], dtype=np.uint8)
    dp = anchored_dp(pattern, text)
    start_col, ops, dist = traceback_ops(pattern, text, dp)
    ops = left_normalize(ops, pattern, text, start_col)
    # left-normalization can move a leading deletion to the alignment edge;
    # strip leading/trailing deletions (they just shift the start).
    lead = 0
    while lead < len(ops) and ops[lead] == OP_D:
        lead += 1
    tail = len(ops)
    while tail > lead and ops[tail - 1] == OP_D:
        tail -= 1
    trimmed = int((ops[:lead] == OP_D).sum())
    dist -= trimmed + int((ops[tail:] == OP_D).sum())
    start_col += lead
    ops = ops[lead:tail]
    cigar = ops_to_cigar(
        ops, front_clip, back_clip, use_m,
        pattern=pattern, text=text, start_col=start_col,
    )
    return wstart + start_col, cigar, dist
