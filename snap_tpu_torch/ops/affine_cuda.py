"""ctypes wrapper of the CUDA affine-gap extension (csrc/affine.cu).

`affine_extend_core_cuda` has the signature of
ops.affine.affine_extend_core_plain (the recurrence) and
`affine_extend_cuda` that of ops.affine.affine_extend_plain (the
recurrence and the shared torch epilogue finish_extend). CUDA tensors
launch the kernel; CPU tensors run the plain version. Rows of more than
MAX_L pattern columns run one block a row, with scratch planes that the
wrapper allocates when the pattern is that wide.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .affine import (
    LOG_GAP_EXTEND,
    LOG_GAP_OPEN,
    NEG_F,
    ExtendBest,
    ExtendResult,
    affine_extend_core_plain,
    finish_extend,
)
from ..constants import AG_GAP_EXTEND, AG_GAP_OPEN, AG_MATCH, AG_MISMATCH

MAX_L = 512  # 16 pattern columns per lane of a 32-lane row; longer: big rows


def plan_ints(N: int) -> int:
    """int32 words of the kernel's out_i: the N x 7 outputs, then at a
    16-byte boundary the device-side pass plan (an 8-int header, up to
    N records of 8 ints and N xl or big rows; csrc/affine.cu
    plan_offset)."""
    return ((7 * N + 3) & ~3) + 8 + 9 * N


KERNEL = _build.Kernel(
    "affine", "affine_extend_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def affine_extend_core_cuda(
    pattern, pat_logq, plen, text, tlen, score_init,
    match=AG_MATCH, sub=AG_MISMATCH, gap_open=AG_GAP_OPEN,
    gap_extend=AG_GAP_EXTEND,
) -> ExtendBest:
    if not pattern.is_cuda:
        return affine_extend_core_plain(
            pattern, pat_logq, plen, text, tlen, score_init,
            match=match, sub=sub, gap_open=gap_open, gap_extend=gap_extend,
        )
    N, L = pattern.shape
    T = text.shape[1]
    dev = pattern.device
    for name, t, shape, dt in (
        ("pattern", pattern, (N, L), torch.uint8),
        ("pat_logq", pat_logq, (N, L), torch.float32),
        ("plen", plen, (N,), torch.int32),
        ("text", text, (N, T), torch.uint8),
        ("tlen", tlen, (N,), torch.int32),
        ("score_init", score_init, (N,), torch.int32),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"affine_extend_core_cuda: {name} must be {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"affine_extend_core_cuda: {name} not contiguous")
    blocks, scratch = 0, None
    if L > MAX_L:
        blocks = _build.long_row_blocks(N, dev)
        scratch = torch.empty((blocks, 9, L), dtype=torch.int32, device=dev)
    out_i = torch.empty((plan_ints(N),), dtype=torch.int32, device=dev)
    out_f = torch.empty((N, 2), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = KERNEL(
        p(pattern), p(pat_logq), p(plen), p(text), p(tlen), p(score_init),
        p(out_i), p(out_f), N, L, T, match, sub, gap_open + gap_extend,
        gap_extend, LOG_GAP_OPEN, LOG_GAP_EXTEND, NEG_F,
        None if scratch is None else p(scratch), blocks,
        _build.stream_ptr(dev),
    )
    _build.check(err, "affine_extend")
    affine_extend_core_cuda.launches += 1
    out_i = out_i[: 7 * N].view(N, 7)
    return ExtendBest(
        out_i[:, 0], out_i[:, 1], out_f[:, 0], out_i[:, 2],
        out_i[:, 3], out_i[:, 4], out_i[:, 5], out_f[:, 1], out_i[:, 6],
    )


affine_extend_core_cuda.launches = 0


def affine_extend_cuda(
    pattern, pat_logq, plen, text, tlen, score_init, end_bonus,
    match=AG_MATCH, sub=AG_MISMATCH, gap_open=AG_GAP_OPEN,
    gap_extend=AG_GAP_EXTEND,
) -> ExtendResult:
    best = affine_extend_core_cuda(
        pattern, pat_logq, plen, text, tlen, score_init,
        match=match, sub=sub, gap_open=gap_open, gap_extend=gap_extend,
    )
    return finish_extend(best, plen, score_init, end_bonus, pat_logq=pat_logq)
