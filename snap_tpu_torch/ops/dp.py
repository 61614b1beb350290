"""Batched fitting-alignment edit-distance DP with match probability.

Counterpart of snap_tpu.ops.dp — the replacement for SNAP's
Landau-Vishkin scorer (LandauVishkin.h:100 computeEditDistance):

- unit-cost edit distance of the (clipped) read against a reference
  window, the read fully aligned;
- fewest-indels tie-break among minimum-edit paths
  (LandauVishkin.h:238-257) via a lexicographic packed (edits, indels)
  DP value;
- match probability along the chosen path (LandauVishkin.h:275-342):
  per-mismatch phred error, per-indel-run GAP_OPEN * GAP_EXTEND^(len-1)
  and the (1-SNP_PROB)^(len-edits) perfect-match prior, carried by a
  3-state (M/I/D) DP.

This module is the plain PyTorch version; ops.dp_cuda holds the
kernel's wrapper.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import GAP_EXTEND_PROB, GAP_OPEN_PROB, SNP_PROB

# Packed DP value: (edits << INDEL_BITS) | indel_count, so integer min is
# lexicographic (fewest edits, then fewest indels).
INDEL_BITS = 10
EDIT_UNIT = 1 << INDEL_BITS
PINF = 1 << 29
STEP = EDIT_UNIT + 1  # one edit + one indel base

# float32 values of the log-probability constants (the kernels use the
# same bits)
LOG_GAP_OPEN = float(np.float32(math.log(GAP_OPEN_PROB)))
LOG_GAP_EXTEND = float(np.float32(math.log(GAP_EXTEND_PROB)))
LOG_PERFECT = float(np.float32(math.log(1.0 - SNP_PROB)))
NEG = float(np.float32(-1e30))

# packed (cost, column) scan keys: the column rides in the low bits so
# one cummin gives the lexicographic (cost, earliest column) prefix min
_COL_BITS = 10
_COL_MASK = (1 << _COL_BITS) - 1


class DPResult(NamedTuple):
    dist: torch.Tensor      # [N] int32 edit distance (>= huge when plen==0)
    log_prob: torch.Tensor  # [N] float32 natural-log match probability
    end_col: torch.Tensor   # [N] int32 text chars consumed at alignment end
    indels: torch.Tensor    # [N] int32 total indel bases on the chosen path


def _min_lp(a, alp, b, blp):
    """Lexicographic min of packed values, carrying logp; ties prefer a."""
    take_a = a <= b
    return torch.minimum(a, b), torch.where(take_a, alp, blp)


def _min3_with_logp(a, alp, b, blp, c, clp):
    """Ties prefer a, then b (a is the diagonal/M state: SNAP prefers
    fewest-indel moves)."""
    ab, ablp = _min_lp(a, alp, b, blp)
    return _min_lp(ab, ablp, c, clp)


def fitting_edit_distance_core_plain(pattern, pat_logq, plen, text, anchored):
    """The DP proper: returns (packed answer [N] i32, answer log-prob
    [N] f32, end column [N] i32). Plain PyTorch; the CUDA kernel computes
    the same three arrays bit for bit."""
    N, L = pattern.shape
    W = text.shape[1]
    dev = pattern.device
    i32, f32 = torch.int32, torch.float32
    jc = torch.arange(W + 1, dtype=i32, device=dev)[None, :]  # [1, W+1]

    if anchored:
        m = torch.where(jc == 0, 0, PINF).to(i32).expand(N, W + 1)
        d = torch.where(jc > 0, jc * STEP, PINF).to(i32).expand(N, W + 1)
        dlp = torch.where(
            jc > 0,
            (jc - 1).to(f32) * LOG_GAP_EXTEND + LOG_GAP_OPEN,
            torch.tensor(NEG, dtype=f32, device=dev),
        ).expand(N, W + 1)
    else:
        m = torch.zeros((N, W + 1), dtype=i32, device=dev)
        d = torch.full((N, W + 1), PINF, dtype=i32, device=dev)
        dlp = torch.full((N, W + 1), NEG, dtype=f32, device=dev)
    i_ = torch.full((N, W + 1), PINF, dtype=i32, device=dev)
    mlp = torch.zeros((N, W + 1), dtype=f32, device=dev)
    ilp = torch.full((N, W + 1), NEG, dtype=f32, device=dev)

    ans_packed = torch.full((N,), PINF, dtype=i32, device=dev)
    ans_lp = torch.full((N,), NEG, dtype=f32, device=dev)
    ans_end = torch.zeros((N,), dtype=i32, device=dev)

    pinf_col = torch.full((N, 1), PINF, dtype=i32, device=dev)
    neg_col = torch.full((N, 1), NEG, dtype=f32, device=dev)
    pinf_t = torch.full((N, W + 1), PINF, dtype=i32, device=dev)
    neg_t = torch.full((N, W + 1), NEG, dtype=f32, device=dev)
    jc64 = jc.to(torch.int64)
    text_i = text.to(i32)

    # rows past the longest pattern set no answer (is_last never holds)
    n_rows = min(L, int(plen.max())) if N else 0
    for i in range(n_rows):
        pb = pattern[:, i : i + 1].to(i32)
        lq = pat_logq[:, i : i + 1]
        mism = text_i != pb                                     # [N, W]
        subp = torch.where(mism, EDIT_UNIT, 0).to(i32)
        sublp = torch.where(mism, lq, torch.zeros_like(lq))

        prev_best, prev_lp = _min3_with_logp(m, mlp, i_, ilp, d, dlp)
        m_new = torch.cat([pinf_col, prev_best[:, :-1] + subp], dim=1)
        mlp_new = torch.cat([neg_col, prev_lp[:, :-1] + sublp], dim=1)

        # insertion (pattern consumed, no text): open from M, extend
        # from I; a tie prefers continuing the run
        i_open = m + STEP
        i_ext = i_ + STEP
        take_ext = i_ext <= i_open
        i_new = torch.where(take_ext, i_ext, i_open)
        ilp_new = torch.where(
            take_ext, ilp + LOG_GAP_EXTEND, mlp + LOG_GAP_OPEN
        )

        # deletion (text consumed, no pattern): in-row min-plus prefix
        # scan over run starts from min(M, I) of THIS row; ties keep the
        # earlier run start
        mi, milp = _min3_with_logp(
            m_new, mlp_new, i_new, ilp_new, pinf_t, neg_t
        )
        adj = (mi - jc * STEP).to(torch.int64)
        key = torch.cummin((adj << _COL_BITS) | jc64, dim=1).values
        cum = (key >> _COL_BITS).to(i32)
        cumcol = key & _COL_MASK
        cumlp = torch.gather(milp, 1, cumcol)
        # D[j] extends the run started at l = cumcol[j-1]:
        # cost mi[l] + (j-l)*STEP, log-prob open + (j-l-1)*extend
        d_new = torch.cat([pinf_col, cum[:, :-1] + jc[:, 1:] * STEP], dim=1)
        dels_m1 = (jc64[:, 1:] - cumcol[:, :-1] - 1).to(f32)
        dlp_new = torch.cat(
            [neg_col, (cumlp[:, :-1] + LOG_GAP_OPEN) + dels_m1 * LOG_GAP_EXTEND],
            dim=1,
        )

        # harvest at the last real pattern row: min over columns, ties
        # to the smallest end column
        fkey = torch.min((mi.to(torch.int64) << _COL_BITS) | jc64, dim=1).values
        best = (fkey >> _COL_BITS).to(i32)
        bidx = fkey & _COL_MASK
        blp = torch.gather(milp, 1, bidx[:, None])[:, 0]
        is_last = plen == (i + 1)
        ans_packed = torch.where(is_last, best, ans_packed)
        ans_lp = torch.where(is_last, blp, ans_lp)
        ans_end = torch.where(is_last, bidx.to(i32), ans_end)

        m, i_, d, mlp, ilp, dlp = m_new, i_new, d_new, mlp_new, ilp_new, dlp_new

    return ans_packed, ans_lp, ans_end


def finish_dp(ans_packed, ans_lp, ans_end, plen) -> DPResult:
    dist = ans_packed >> INDEL_BITS
    indels = ans_packed & (EDIT_UNIT - 1)
    # perfect-match prior on the matching bases (LandauVishkin.h:341)
    log_prob = ans_lp + (plen - dist).to(torch.float32) * LOG_PERFECT
    return DPResult(dist=dist, log_prob=log_prob, end_col=ans_end, indels=indels)


def fitting_edit_distance_plain(
    pattern: torch.Tensor,    # [N, L] uint8 base codes (4=N, 5=pad)
    pat_logq: torch.Tensor,   # [N, L] float32 log P(error)
    plen: torch.Tensor,       # [N] int32 effective (clipped) pattern length
    text: torch.Tensor,       # [N, W] uint8 base codes (5=pad never matches)
    anchored: bool = False,
) -> DPResult:
    """Fitting alignment: pattern fully aligned, free text end.

    anchored=False: free placement in text (both ends free).
    anchored=True: the text START is pinned at column 0 — SNAP's
    seed-anchored Landau-Vishkin extension (LandauVishkin.h:100,
    BaseAligner.cpp:1160-1176): a path may begin with a deletion run,
    each deleted base costing an edit.
    """
    packed, lp, end = fitting_edit_distance_core_plain(
        pattern, pat_logq, plen.to(torch.int32), text, anchored
    )
    return finish_dp(packed, lp, end, plen.to(torch.int32))

