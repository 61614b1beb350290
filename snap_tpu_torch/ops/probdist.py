"""ProbabilityDistance: phred-aware alignment probability scorer.

Counterpart of snap_tpu.ops.probdist. Behavioral reference:
SNAPLib/ProbabilityDistance.{h,cpp} — a 3-state (NO_GAP / READ_GAP /
REF_GAP) dynamic program over [readPos][shift in -maxShift..+maxShift],
where shift is the net indel displacement between read and reference.
Transition model (ProbabilityDistance.cpp:92-110):

- NO_GAP from any state at the same shift, paying the match/mismatch
  log probability of the current base (match prob =
  (1-errorProb)*(1-snpProb), ctor at :31-45);
- READ_GAP (deletion in the read) from shift+1, gap open from
  NO_GAP/REF_GAP, extension from READ_GAP;
- REF_GAP (insertion in the read) from shift-1 within the same row.

compute() returns the max log probability over all shifts and states at
the final row (ProbabilityDistance.cpp:126-134). Here it is batched on
the tensors' device: [N] (reference window, read, quality) triples score
together, one row of tensor operations per read position.

Wiring parity: the reference constructs a ProbabilityDistance in every
BaseAligner (BaseAligner.cpp:134) but never calls compute() on the
production path; alignment probabilities come from the LandauVishkin
matchProbability path instead. This port keeps the scorer implemented
and tested (tests/test_torch_probdist.py), and — like the reference —
unwired.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import SNP_PROB

MAX_SHIFT = 20     # ProbabilityDistance.h:16
NO_PROB = -1.0e6   # ProbabilityDistance.h NO_PROB


def match_mismatch_log_tables(
    snp_prob: float = SNP_PROB,
) -> tuple[np.ndarray, np.ndarray]:
    """log P(match) / log P(mismatch) indexed by raw phred+33 byte."""
    q = np.arange(256, dtype=np.float64)
    error = np.power(10.0, -(q - 33) / 10.0)
    match = (1.0 - error) * (1.0 - snp_prob)
    with np.errstate(divide="ignore", invalid="ignore"):
        mlp = np.where(q < 33, NO_PROB, np.log(match))
        xlp = np.where(q < 33, NO_PROB, np.log(1.0 - match))
    return mlp.astype(np.float32), xlp.astype(np.float32)


def probability_distance(
    reference: torch.Tensor,  # [N, W] uint8 codes, W >= read_len + max_shift
    read: torch.Tensor,       # [N, L] uint8 codes
    quality: torch.Tensor,    # [N, L] uint8 raw phred+33
    read_len: torch.Tensor,   # [N] int32 effective lengths
    max_start_shift: int = 2,
    max_shift: int = 5,
    gap_open_prob: float = 0.001,
    gap_extension_prob: float = 0.5,
    snp_prob: float = SNP_PROB,
) -> torch.Tensor:
    """Batched ProbabilityDistance::compute on the inputs' device.
    Returns [N] float32 natural log of the best alignment probability
    (NO_PROB when none)."""
    assert max_start_shift <= max_shift < MAX_SHIFT
    dev = read.device
    N, L = read.shape
    S = 2 * max_shift + 1
    W = reference.shape[1]
    f32 = torch.float32
    go = torch.tensor(np.float32(np.log(gap_open_prob)), device=dev)
    ge = torch.tensor(np.float32(np.log(gap_extension_prob)), device=dev)
    mlp_np, xlp_np = match_mismatch_log_tables(snp_prob)
    mlp_t = torch.from_numpy(mlp_np).to(dev)
    xlp_t = torch.from_numpy(xlp_np).to(dev)
    NOP = float(np.float32(NO_PROB))

    shifts = torch.arange(-max_shift, max_shift + 1, device=dev)[None, :]  # [1, S]
    start_ok = shifts.abs() <= max_start_shift
    no_gap = torch.where(start_ok, 0.0, NOP).to(f32).expand(N, S)
    read_gap = torch.full((N, S), NOP, dtype=f32, device=dev)
    ref_gap = torch.full((N, S), NOP, dtype=f32, device=dev)
    ans = torch.full((N,), NOP, dtype=f32, device=dev)
    nop_col = torch.full((N, 1), NOP, dtype=f32, device=dev)
    steps = torch.arange(S, dtype=f32, device=dev)[None, :] * ge
    ref = reference.to(torch.int64)
    rd_all = read.to(torch.int64)
    q_all = quality.to(torch.int64)
    rlen = read_len.to(torch.int64)

    def shift_left(x):  # value at s+1, NO_PROB past the band edge
        return torch.cat([x[:, 1:], nop_col], dim=1)

    for r in range(L):
        # reference base at column r + shift (0-based read pos r)
        colr = r + shifts
        ref_b = torch.gather(ref, 1, colr.clamp(0, W - 1).expand(N, S))
        in_ref = (colr >= 0) & (colr < W)
        rd = rd_all[:, r : r + 1]
        qv = q_all[:, r]
        is_match = (ref_b == rd) & in_ref & (rd < 4)
        base_lp = torch.where(is_match, mlp_t[qv][:, None], xlp_t[qv][:, None])

        best_prev = torch.maximum(torch.maximum(no_gap, read_gap), ref_gap)
        no_gap_n = best_prev + base_lp
        read_gap_n = torch.maximum(
            torch.maximum(shift_left(no_gap), shift_left(ref_gap)) + go,
            shift_left(read_gap) + ge,
        )
        # REF_GAP is an in-row recurrence from shift-1:
        #   ref[s] = max(src[s-1], ref[s-1] + ge)   (open vs extend)
        # which expands to ref[s] = max_{l<s} src[l] + (s-1-l)*ge — a
        # running max along the shift axis.
        src = torch.maximum(no_gap_n, read_gap_n) + go
        prefix = torch.cummax(src - steps, dim=1).values
        ref_gap_n = torch.cat([nop_col, prefix[:, :-1] + steps[:, :-1]], dim=1)

        fin = torch.maximum(torch.maximum(no_gap_n, read_gap_n), ref_gap_n).amax(dim=1)
        ans = torch.where(rlen == r + 1, fin, ans)
        no_gap, read_gap, ref_gap = no_gap_n, read_gap_n, ref_gap_n
    return ans
