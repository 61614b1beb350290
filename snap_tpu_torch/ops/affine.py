"""Batched affine-gap extension scoring (Smith-Waterman-Gotoh variant).

Counterpart of snap_tpu.ops.affine. Behavioral reference: SNAP's
AffineGapVectorized<±1>::computeScore (AffineGapVectorized.h:821-1345),
used when a candidate's Landau-Vishkin distance exceeds
maxKForSameAlignment (BaseAligner.cpp:1203-1290):

- scoring: match +1, mismatch -4, first gap base -(6+1), extension -1,
  any N/pad involvement -1 (-gm/-gs/-go/-ge override them);
- gaps open only from the M state; H floored at 0 against scoreInit;
- global-vs-local end choice: the pattern tail is soft-clipped iff
  bestLocal >= bestGlobal + endBonus; global ties prefer the latest text
  row, local ties the earliest row and then the largest pattern offset;
- match probability along the argmax path, carried through the
  recurrences with the same tie rules (no traceback storage).

This module is the plain PyTorch version: `affine_extend_plain` runs
the recurrence (`affine_extend_core_plain`) and then the torch epilogue
`finish_extend`, which ops.affine_cuda's kernel path shares.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import (
    AG_GAP_EXTEND,
    AG_GAP_OPEN,
    AG_MATCH,
    AG_MISMATCH,
    GAP_EXTEND_PROB,
    GAP_OPEN_PROB,
    SNP_PROB,
)

NEG_I = -(1 << 29)
NEG_F = float(np.float32(-1e30))

LOG_GAP_OPEN = float(np.float32(math.log(GAP_OPEN_PROB)))
LOG_GAP_EXTEND = float(np.float32(math.log(GAP_EXTEND_PROB)))
LOG_PERFECT = float(np.float32(math.log(1.0 - SNP_PROB)))

_COL_BITS = 10
_COL_MASK = (1 << _COL_BITS) - 1


def _pack(mism, ins, dl):
    """packed counts: (mism << 20) | (ins << 10) | del"""
    return (mism << 20) | (ins << 10) | dl


class ExtendResult(NamedTuple):
    score: torch.Tensor         # [N] i32 chosen alignment score (DP units)
    valid: torch.Tensor         # [N] bool (score > score_init)
    edits: torch.Tensor         # [N] i32 mismatches + gap bases
    log_prob: torch.Tensor      # [N] f32 ln match probability of this part
    pattern_clip: torch.Tensor  # [N] i32 soft-clipped pattern tail bases
    text_used: torch.Tensor     # [N] i32 text rows consumed


class ExtendBest(NamedTuple):
    """What the recurrence hands the epilogue (the kernel's outputs)."""

    best_g: torch.Tensor      # [N] i32
    best_g_row: torch.Tensor  # [N] i32
    best_g_lp: torch.Tensor   # [N] f32
    best_g_ct: torch.Tensor   # [N] i32 packed counts
    best_l: torch.Tensor      # [N] i32
    best_l_row: torch.Tensor  # [N] i32
    best_l_col: torch.Tensor  # [N] i32
    best_l_lp: torch.Tensor   # [N] f32
    best_l_ct: torch.Tensor   # [N] i32


def affine_extend_core_plain(
    pattern, pat_logq, plen, text, tlen, score_init,
    match=AG_MATCH, sub=AG_MISMATCH, gap_open=AG_GAP_OPEN,
    gap_extend=AG_GAP_EXTEND,
) -> ExtendBest:
    """The recurrence over text rows, plain PyTorch."""
    OPEN = gap_open + gap_extend
    EXT = gap_extend
    N = pattern.shape[0]
    T = text.shape[1]
    dev = pattern.device
    i32, f32 = torch.int32, torch.float32
    plen = plen.to(i32)
    tlen = tlen.to(i32)
    score_init = score_init.to(i32)
    # columns past the longest pattern and text rows past the longest
    # text change no readout (every cell there is outside its row's
    # pattern, every row past tlen is frozen), so they are not computed
    L = max(1, min(pattern.shape[1], int(plen.max()) if N else 0))
    pattern, pat_logq = pattern[:, :L], pat_logq[:, :L]
    n_text = max(0, min(T, int(tlen.max()) if N else 0))
    jc = torch.arange(L, dtype=i32, device=dev)[None, :]
    jc64 = jc.to(torch.int64)
    in_pat = jc < plen[:, None]
    pat = pattern.to(i32)

    # row -1 init: leading pattern insertions from scoreInit
    h_prev = torch.clamp_min(score_init[:, None] - OPEN - jc * EXT, 0)
    h_prev = torch.where(in_pat, h_prev, NEG_I).to(i32)
    hlp_prev = (jc.to(f32) * LOG_GAP_EXTEND + LOG_GAP_OPEN).expand(N, L)
    hct_prev = _pack(0, jc + 1, 0).to(i32).expand(N, L)
    e = torch.zeros((N, L), dtype=i32, device=dev)
    elp = torch.full((N, L), NEG_F, dtype=f32, device=dev)
    ect = torch.zeros((N, L), dtype=i32, device=dev)

    last_col = torch.clamp_min(plen - 1, 0).to(torch.int64)[:, None]

    best_g = torch.full((N,), -1, dtype=i32, device=dev)
    best_g_row = torch.zeros((N,), dtype=i32, device=dev)
    best_g_lp = torch.full((N,), NEG_F, dtype=f32, device=dev)
    best_g_ct = torch.zeros((N,), dtype=i32, device=dev)
    best_l = torch.full((N,), -1, dtype=i32, device=dev)
    best_l_row = torch.zeros((N,), dtype=i32, device=dev)
    best_l_col = torch.zeros((N,), dtype=i32, device=dev)
    best_l_lp = torch.full((N,), NEG_F, dtype=f32, device=dev)
    best_l_ct = torch.zeros((N,), dtype=i32, device=dev)

    zero_f = torch.zeros((), dtype=f32, device=dev)
    negi_col = torch.full((N, 1), NEG_I, dtype=i32, device=dev)
    negf_col = torch.full((N, 1), NEG_F, dtype=f32, device=dev)
    zero_col = torch.zeros((N, 1), dtype=i32, device=dev)
    pos_j = (jc > 0).to(i32)

    for i in range(n_text):
        tb = text[:, i : i + 1].to(i32)
        is_n = (tb >= 4) | (pat >= 4)
        eq = tb == pat
        s = torch.where(is_n, -1, torch.where(eq, match, -sub)).to(i32)
        mism = ~eq  # probability model: code inequality (N==N matches)

        if i == 0:
            h_init = score_init
            hlp_init = 0.0
            hct_init = 0
        else:
            h_init = torch.clamp_min(score_init - OPEN - (i - 1) * EXT, 0)
            hlp_init = float(
                np.float32(LOG_GAP_OPEN)
                + np.float32(i - 1) * np.float32(LOG_GAP_EXTEND)
            )
            hct_init = _pack(0, 0, i)

        hdiag = torch.cat([h_init.to(i32)[:, None], h_prev[:, :-1]], dim=1)
        hdlp = torch.cat(
            [torch.full((N, 1), hlp_init, dtype=f32, device=dev),
             hlp_prev[:, :-1]], dim=1,
        )
        hdct = torch.cat(
            [torch.full((N, 1), hct_init, dtype=i32, device=dev),
             hct_prev[:, :-1]], dim=1,
        )

        m = torch.where(hdiag > 0, hdiag + s, 0).to(i32)
        mlp = hdlp + torch.where(mism, pat_logq, zero_f)
        mct = hdct + torch.where(mism, _pack(1, 0, 0), 0).to(i32)

        # F (insertion, within-row):
        # F[j] = max_{l<j}(max(M[l]-OPEN, 0) - (j-1-l)*EXT), ties prefer
        # the later run start
        t_ins = torch.clamp_min(m - OPEN, 0)
        adj = (t_ins + jc * EXT).to(torch.int64)
        key = torch.cummax((adj << _COL_BITS) | jc64, dim=1).values
        cum_v = (key >> _COL_BITS).to(i32)
        cum_j = key & _COL_MASK
        src_lp = mlp + LOG_GAP_OPEN
        cum_lp = torch.gather(src_lp, 1, cum_j)
        cum_ct = torch.gather(mct, 1, cum_j)
        f = torch.cat([negi_col, cum_v[:, :-1] - (jc[:, 1:] - 1) * EXT], dim=1)
        run_m1 = torch.cat(
            [zero_col, (jc64[:, 1:] - cum_j[:, :-1] - 1).to(i32)], dim=1
        )
        flp = torch.cat([negf_col, cum_lp[:, :-1]], dim=1) + (
            run_m1.to(f32) * LOG_GAP_EXTEND
        )
        fct = torch.cat([zero_col, cum_ct[:, :-1]], dim=1) + (
            _pack(0, run_m1 + 1, 0) * pos_j
        )

        # H = max(m, e, f); e wins only if > m; f only if > max(m, e)
        take_e = e > m
        h = torch.where(take_e, e, m)
        hlp = torch.where(take_e, elp, mlp)
        hct = torch.where(take_e, ect, mct)
        take_f = f > h
        h = torch.where(take_f, f, h)
        hlp = torch.where(take_f, flp, hlp)
        hct = torch.where(take_f, fct, hct)
        h = torch.where(in_pat, h, NEG_I).to(i32)

        # E for the next row: max(e - EXT, m - OPEN, 0); a tie opens
        e_ext = e - EXT
        t_del = torch.clamp_min(m - OPEN, 0)
        take_ext = e_ext > t_del
        e_new = torch.where(take_ext, e_ext, t_del)
        elp_new = torch.where(take_ext, elp + LOG_GAP_EXTEND, mlp + LOG_GAP_OPEN)
        ect_new = torch.where(take_ext, ect, mct) + _pack(0, 0, 1)

        row_live = i < tlen

        # global readout at column plen-1
        g = torch.gather(h, 1, last_col)[:, 0]
        glp = torch.gather(hlp, 1, last_col)[:, 0]
        gct = torch.gather(hct, 1, last_col)[:, 0]
        upd_g = row_live & (g >= best_g)
        best_g = torch.where(upd_g, g, best_g)
        best_g_row = torch.where(upd_g, i, best_g_row)
        best_g_lp = torch.where(upd_g, glp, best_g_lp)
        best_g_ct = torch.where(upd_g, gct, best_g_ct)

        # local: max over valid columns; ties -> largest column
        hm = torch.where(in_pat, h, NEG_I)
        rowmax = hm.max(dim=1).values
        colmax = torch.where(hm == rowmax[:, None], jc, -1).max(dim=1).values
        cm = colmax.to(torch.int64)[:, None]
        l_lp = torch.gather(hlp, 1, cm)[:, 0]
        l_ct = torch.gather(hct, 1, cm)[:, 0]
        upd_l = row_live & (rowmax > best_l)
        best_l = torch.where(upd_l, rowmax, best_l)
        best_l_row = torch.where(upd_l, i, best_l_row)
        best_l_col = torch.where(upd_l, colmax.to(i32), best_l_col)
        best_l_lp = torch.where(upd_l, l_lp, best_l_lp)
        best_l_ct = torch.where(upd_l, l_ct, best_l_ct)

        # freeze state for dead rows
        live = row_live[:, None]
        h_prev = torch.where(live, h, h_prev)
        hlp_prev = torch.where(live, hlp, hlp_prev)
        hct_prev = torch.where(live, hct, hct_prev)
        e = torch.where(live, e_new, e)
        elp = torch.where(live, elp_new, elp)
        ect = torch.where(live, ect_new, ect)

    return ExtendBest(
        best_g, best_g_row, best_g_lp, best_g_ct,
        best_l, best_l_row, best_l_col, best_l_lp, best_l_ct,
    )


def _hq_log_err() -> float:
    """log-error threshold equivalent to the reference's raw-byte test
    qualityString[i] >= 65 (AffineGapVectorized.h:698)."""
    from ..constants import phred_to_probability_table

    return float(np.float32(math.log(phred_to_probability_table()[65]) + 1e-6))


HQ_LOG_ERR = _hq_log_err()


def finish_extend(best: ExtendBest, plen, score_init, end_bonus, pat_logq=None) -> ExtendResult:
    """Global-vs-local choice + probability epilogue (torch code shared
    by the kernel and plain paths)."""
    (best_g, best_g_row, best_g_lp, best_g_ct,
     best_l, best_l_row, best_l_col, best_l_lp, best_l_ct) = best
    plen = plen.to(torch.int32)
    score_init = score_init.to(torch.int32)
    end_bonus = end_bonus.to(torch.int32)
    f32 = torch.float32
    # choose local iff different and local >= global + endBonus
    choose_local = (best_l != best_g) & (best_l >= best_g + end_bonus)
    if pat_logq is not None:
        # "Try not to clip high quality bases (>= 65) from the read"
        # (AffineGapVectorized.h:692-720): when every base from the clip
        # column to the pattern end is high quality, the local clip is
        # abandoned and the full pattern is consumed.
        N, L = pat_logq.shape
        pos = torch.arange(L, dtype=torch.int32, device=plen.device)[None, :]
        hq = (pat_logq <= HQ_LOG_ERR) & (pos < plen[:, None])
        pre = torch.cumsum(hq.to(torch.int32), dim=1)
        total = pre[:, -1]
        start = best_l_col.clamp(0, L - 1)
        before = torch.where(
            start > 0,
            torch.gather(pre, 1, (start - 1).clamp_min(0).to(torch.int64)[:, None])[:, 0],
            0,
        )
        hq_from_col = total - before           # hq count in [col, plen)
        span = (plen - start).clamp_min(0)     # bases in [col, plen)
        all_hq_to_end = hq_from_col == span
        clip_len = (plen - 1 - best_l_col).clamp_min(0)
        choose_local = choose_local & ~(all_hq_to_end & (clip_len > 0))
    score = torch.where(choose_local, best_l, best_g)
    row_used = torch.where(choose_local, best_l_row, best_g_row)
    col_used = torch.where(choose_local, best_l_col, (plen - 1).clamp_min(0))
    lp = torch.where(choose_local, best_l_lp, best_g_lp)
    ct = torch.where(choose_local, best_l_ct, best_g_ct)

    clip = plen - 1 - col_used  # soft-clipped pattern tail
    mismatches = ct >> 20
    ins = (ct >> 10) & 0x3FF
    dl = ct & 0x3FF
    consumed = plen - clip
    n_matches = (consumed - mismatches - ins).clamp_min(0)
    lp = lp + n_matches.to(f32) * LOG_PERFECT
    # clipped tail charged as one indel run (AffineGapVectorized.h:1331)
    zero_f = torch.zeros((), dtype=f32, device=plen.device)
    lp = lp + torch.where(
        clip > 0,
        (clip - 1).clamp_min(0).to(f32) * LOG_GAP_EXTEND + LOG_GAP_OPEN,
        zero_f,
    )

    valid = score > score_init
    empty = plen <= 0
    return ExtendResult(
        score=torch.where(empty, score_init, score),
        valid=valid | empty,
        edits=torch.where(empty, 0, mismatches + ins + dl).to(torch.int32),
        log_prob=torch.where(empty, zero_f, lp),
        pattern_clip=torch.where(empty, 0, clip).to(torch.int32),
        text_used=torch.where(empty, 0, row_used + 1).to(torch.int32),
    )


def affine_extend_plain(
    pattern: torch.Tensor,    # [N, L] uint8 codes
    pat_logq: torch.Tensor,   # [N, L] f32 ln P(error)
    plen: torch.Tensor,       # [N] i32 pattern length (0 => no extension)
    text: torch.Tensor,       # [N, T] uint8 codes
    tlen: torch.Tensor,       # [N] i32 usable text length
    score_init: torch.Tensor, # [N] i32
    end_bonus: torch.Tensor,  # [N] i32
    match: int = AG_MATCH,
    sub: int = AG_MISMATCH,
    gap_open: int = AG_GAP_OPEN,
    gap_extend: int = AG_GAP_EXTEND,
) -> ExtendResult:
    """The plain recurrence and its epilogue, whatever the device."""
    best = affine_extend_core_plain(
        pattern, pat_logq, plen, text, tlen, score_init,
        match=match, sub=sub, gap_open=gap_open, gap_extend=gap_extend,
    )
    return finish_extend(best, plen, score_init, end_bonus, pat_logq=pat_logq)
