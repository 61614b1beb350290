"""ctypes wrapper of the CUDA gapless prescreen (csrc/gapless.cu).

Same signature as ops.gapless.gapless_prescreen_plain. CUDA tensors
launch the kernel; CPU tensors run the plain version. The kernel takes
reads of any length up to MAX_L positions (its log-error sums nest up
to four levels of 32-term windows), so no read length leaves it: up to
ONE_THREAD_L positions one thread a (read, candidate) pair, beyond that
split_threads(L, pairs) threads a pair, each whole 32-position windows.
"""

from __future__ import annotations

import ctypes

import torch

from ..stats import RECORDER
from . import _build
from .gapless import gapless_prescreen_plain
from .sums import WINDOW, window_origin

MAX_L = 32 ** 5  # four window levels of ops/sums.py, then <= 32 sums
# csrc/gapless.cu kOneThreadL, kFillPairs, kMaxSplit, kWindowsPerThread,
# kMaxChunk
ONE_THREAD_L = 128
FILL_PAIRS, MAX_SPLIT, WINDOWS_PER_THREAD, MAX_CHUNK = 1 << 16, 16, 16, 64


def split_threads(L: int, pairs: int) -> int:
    """Threads a pair (warps a block) of the split kernel at L >
    ONE_THREAD_L positions over `pairs` (read, candidate) pairs:
    FILL_PAIRS / pairs, so that a launch fills the card, as a power of two
    from 1 to MAX_SPLIT, and fewer than twice ops/sums.py's first-level
    windows. A block sums split_chunk(split) windows at a time."""
    windows = (L + window_origin(L) + WINDOW - 1) // WINDOW
    split = MAX_SPLIT
    while split > 1 and (split * pairs > FILL_PAIRS or split >= 2 * windows):
        split //= 2
    return split


def split_chunk(split: int) -> int:
    """First-level windows the split kernel's block stages and sums at a
    time: WINDOWS_PER_THREAD a thread, at most MAX_CHUNK."""
    return min(WINDOWS_PER_THREAD * split, MAX_CHUNK)


def route(L: int) -> str:
    """The span count a launch at L positions adds to: one thread a pair
    (gapless_kernel) or the split kernel (gapless_split_kernel)."""
    return "launch.gapless" if L <= ONE_THREAD_L else "launch.gapless_split"


KERNEL = _build.Kernel(
    "gapless", "gapless_prescreen_launch",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def gapless_prescreen_cuda(
    text_words, bad_words, fwd_words, rc_words, fwd_bad, rc_bad,
    logq_f, logq_r, dirs, plen, K: int, PW: int,
):
    if not text_words.is_cuda:
        return gapless_prescreen_plain(
            text_words, bad_words, fwd_words, rc_words, fwd_bad, rc_bad,
            logq_f, logq_r, dirs, plen, K, PW,
        )
    B = text_words.shape[0]
    L = logq_f.shape[1]
    dev = text_words.device
    for name, t, shape, dt in (
        ("text_words", text_words, (B, K * PW), torch.int32),
        ("bad_words", bad_words, (B, K * PW), torch.int32),
        ("fwd_words", fwd_words, (B, PW), torch.int32),
        ("rc_words", rc_words, (B, PW), torch.int32),
        ("fwd_bad", fwd_bad, (B, PW), torch.int32),
        ("rc_bad", rc_bad, (B, PW), torch.int32),
        ("logq_f", logq_f, (B, L), torch.float32),
        ("logq_r", logq_r, (B, L), torch.float32),
        ("dirs", dirs, (B, K), torch.int32),
        ("plen", plen, (B,), torch.int32),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"gapless_prescreen_cuda: {name} must be {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"gapless_prescreen_cuda: {name} not contiguous")
    if L > 16 * PW or L > MAX_L:
        raise ValueError(f"gapless_prescreen_cuda: L = {L} exceeds 16*PW or {MAX_L}")
    dist = torch.empty((B, K), dtype=torch.int32, device=dev)
    logp = torch.empty((B, K), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = KERNEL(
        p(text_words), p(bad_words), p(fwd_words), p(rc_words),
        p(fwd_bad), p(rc_bad), p(logq_f), p(logq_r), p(dirs), p(plen),
        p(dist), p(logp), B, K, PW, L, _build.stream_ptr(dev),
    )
    _build.check(err, "gapless_prescreen")
    gapless_prescreen_cuda.launches += 1
    RECORDER.tally(route(L))
    return dist, logp


gapless_prescreen_cuda.launches = 0
