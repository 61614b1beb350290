"""The order of float adds of the split gapless kernel (csrc/gapless.cu
gapless_split_kernel, reads past ONE_THREAD_L positions), emulated in
torch on the CPU, against the plain version bit for bit.

The kernel runs only on the card, where tests/test_torch_kernels_cuda.py
holds it to the plain version. This emulation walks its steps: a pair's
threads each own a run of whole first-level windows of ops/sums.py,
each window's 32 mismatch bits taken from the up to
three packed words it straddles (`lo` zeros padded in front), the terms
of its set bits added from +0.0 in position order (the plain version's
+0.0 terms skipped: no partial sum is -0.0), each word's mismatches
counted by the thread of the window that owns it, and the window sums
folded by the first thread in window order, split_chunk(split) windows
at a time, one open window a level. So a fault in that order
shows here, at small shapes. The plain version is held to snap_tpu's in
tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.ops.gapless import EVEN, U32, gapless_prescreen_plain, popcount32
from snap_tpu_torch.ops.gapless_cuda import ONE_THREAD_L, split_chunk, split_threads
from snap_tpu_torch.ops.sums import WINDOW, window_origin

torch.set_num_threads(1)

MAX_LEVELS = 4  # csrc/gapless.cu kMaxLevels


def _even_below(r: torch.Tensor) -> torch.Tensor:
    r = r.clamp(0, 16)
    return ((torch.ones_like(r) << (2 * r)) - 1) & EVEN


def _pack_even(m: torch.Tensor) -> torch.Tensor:
    m = (m | (m >> 1)) & 0x33333333
    m = (m | (m >> 2)) & 0x0F0F0F0F
    m = (m | (m >> 4)) & 0x00FF00FF
    return (m | (m >> 8)) & 0x0000FFFF


def split_emulation(text_words, bad_words, fwd_words, rc_words, fwd_bad, rc_bad,
                    logq_f, logq_r, dirs, plen, K, PW, split):
    """(dist [B, K] int32, logp_err [B, K] f32) as gapless_split_kernel
    computes them with `split` threads a pair, every pair at once."""
    B, L = logq_f.shape
    n = B * K
    w = lambda a: a.to(torch.int64) & U32
    read = torch.arange(n) // K
    rc = (dirs.reshape(n) == 1)[:, None]
    t = w(text_words).reshape(n, PW)
    tb = w(bad_words).reshape(n, PW)
    pw = torch.where(rc, w(rc_words)[read], w(fwd_words)[read])
    pb = torch.where(rc, w(rc_bad)[read], w(fwd_bad)[read])
    lq = torch.where(rc, logq_r[read], logq_f[read])
    pl = plen.to(torch.int64)[read]
    los, m = [], L
    while m > WINDOW:  # the launcher's SumPlan
        los.append(window_origin(m))
        m = (m + WINDOW - 1) // WINDOW
    levels = len(los)
    lo = los[0] if levels else 0
    nw = (L + lo + WINDOW - 1) // WINDOW

    def mism(q):  # no length mask yet
        x = t[:, q] ^ pw[:, q]
        return ((x | (x >> 1)) | tb[:, q] | pb[:, q]) & EVEN

    def below(r):  # the first r (clamped to 0..32) bits
        r = r.clamp(0, 32)
        return (torch.ones_like(r) << r) - 1

    d = torch.zeros(n, dtype=torch.int64)
    acc = [torch.zeros(n, dtype=torch.float32) for _ in range(MAX_LEVELS + 1)]
    cur = [0] * MAX_LEVELS  # the window indices are the same for every pair
    chunk = split_chunk(split)
    for c0 in range(0, nw, chunk):
        sums = [None] * min(chunk, nw - c0)
        # thread g's windows: a run of consecutive ones
        run = -(-len(sums) // split)
        wins = [win for g in range(split)
                for win in range(c0 + g * run, min(c0 + len(sums), c0 + (g + 1) * run))]
        for win in wins:
            ps = 32 * win - lo
            q0 = (ps + 16) // 16 - 1
            bits = torch.zeros(n, dtype=torch.int64)
            for j in range(3):
                q = q0 + j
                if q < 0 or q >= PW or 16 * q > ps + 31:
                    continue
                bits |= _pack_even(mism(q)) << (16 * j)
            # words 2w and 2w + 1 (positions 32w ..), within plen
            d += popcount32((bits >> (32 * win - 16 * q0)) & below(pl - 32 * win))
            if win == nw - 1:
                for q in range(2 * win + 2, PW):
                    d += popcount32(mism(q) & _even_below(pl - 16 * q))
            wb = (bits >> (ps - 16 * q0)) & below(pl.clamp(max=L) - ps)
            s = torch.zeros(n, dtype=torch.float32)
            for u in range(32):
                term = lq[:, min(max(ps + u, 0), L - 1)]
                s = torch.where(((wb >> u) & 1) != 0, s + term, s)
            sums[win - c0] = s
        for j, v in enumerate(sums):  # the first thread's fold
            win = c0 + j
            for lv in range(1, levels):
                win = (win + los[lv]) >> 5
                if win != cur[lv]:
                    acc[lv + 1] = acc[lv + 1] + acc[lv]
                    acc[lv] = torch.zeros(n, dtype=torch.float32)
                    cur[lv] = win
            acc[1] = acc[1] + v
    total = acc[1]
    for lv in range(1, levels):
        acc[lv + 1] = acc[lv + 1] + acc[lv]
        total = acc[lv + 1]
    return d.to(torch.int32).reshape(B, K), total.reshape(B, K)


def _inputs(L: int, K: int, seed: int):
    """Reads whose plen sits at 0, 1, L and the window and word edges (the
    first window's end 32 - lo, +-1; a word's end), K candidates each:
    random text words against random patterns, and every other candidate
    a copy of its read's pattern with a few positions changed, so that
    windows with no mismatch and windows full of them meet."""
    rng = np.random.default_rng(seed)
    PW = (L + 15) // 16
    lo = window_origin(L)
    edges = [0, 1, L, L - 1, 32 - lo, 31 - lo, 33 - lo, 16, 17]
    if L >= 1000:
        edges = [0, 1, L, 32 - lo]
    plens = sorted({e for e in edges if 0 <= e <= L})
    B = len(plens)
    words = lambda *s: rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64).astype(np.int32)
    fwd, rcw = words(B, PW), words(B, PW)
    dirs = rng.integers(0, 2, (B, K)).astype(np.int32)
    text = words(B, K, PW)
    pat = np.where(dirs[:, :, None] == 1, rcw[:, None, :], fwd[:, None, :])
    flip = np.zeros((B, K, PW), np.int64)
    pos = rng.integers(0, 16 * PW, (B, K, 3))
    for c in range(3):
        np.bitwise_or.at(flip, (*np.indices((B, K)), pos[:, :, c] // 16),
                         1 << (2 * (pos[:, :, c] % 16)))
    near = (pat.astype(np.int64) ^ flip).astype(np.uint32).astype(np.int32)
    text[:, 1::2] = near[:, 1::2]
    even = np.int32(EVEN)
    bad = words(B, K, PW) & even & np.int32(0x00010001)
    bad[:, 1::2] = 0
    arrays = (
        text.reshape(B, K * PW), bad.reshape(B, K * PW), fwd, rcw,
        words(B, PW) & even & np.int32(0x01000000), words(B, PW) & even & np.int32(0x00000010),
        np.log(rng.uniform(1e-4, 0.3, (B, L))).astype(np.float32),
        np.log(rng.uniform(1e-4, 0.3, (B, L))).astype(np.float32),
        dirs, np.array(plens, np.int32),
    )
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], PW


def _same(got, ref):
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))


@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("L", [20, 32, 33, 129, 256, 400, 1025, 1500, 20000])
def test_split_order_matches_plain(L, K):
    """Bit for bit at one window (L <= 32), one level with lo = 15 (33,
    129: the first window holds 17 positions), lo = 0 (256, 20000), lo = 8
    (400: every window starts in a word's second half, three words
    each), and nested levels (1025, 1500: lo 15 and 2; 20000: three
    levels)."""
    args, PW = _inputs(L, K, L + K)
    split = split_threads(max(L, ONE_THREAD_L + 1), args[0].shape[0] * K)
    got = split_emulation(*args, K, PW, split)
    _same(got, gapless_prescreen_plain(*args, K, PW))


@pytest.mark.parametrize("split", [1, 2, 16])
@pytest.mark.parametrize("L", [129, 400, 1500])
def test_split_order_any_threads(L, split):
    """The order, and so every bit, is the same for every count of threads
    a pair the kernel is built for: one thread (it takes every window) or
    more threads than windows (threads idle)."""
    args, PW = _inputs(L, 16, 7 * L)
    _same(split_emulation(*args, 16, PW, split), gapless_prescreen_plain(*args, 16, PW))


def test_split_threads_and_window_origin():
    """A window straddles at most three words: the zeros padded in front
    of a row (lo) are at most 15 positions. The threads a pair fill the
    card (the fewer, the more pairs) and stay below twice the windows."""
    assert max(window_origin(n) for n in range(1, 4 * 1024)) == 15
    got = [split_threads(L, pairs) for L, pairs in (
        (256, 4096), (256, 8192), (256, 16384), (256, 65536), (400, 16384),
        (400, 131072), (1500, 1024), (1500, 2048), (20000, 48))]
    assert got == [8, 8, 4, 1, 4, 1, 16, 16, 16]
