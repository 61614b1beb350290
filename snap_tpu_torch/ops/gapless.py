"""Tier-1 gapless prescreen over 2-bit-packed words.

For every (read, candidate) pair: XOR the funnel-aligned text words
with the forward or RC pattern words (chosen by `dirs`), OR in the text
and pattern N bits, mask to the read length, and return the mismatch
count and the sum of ln P(error) over the mismatching positions — the
form of SNAP's 64-bit XOR scan (LandauVishkin.h:377-407) that
snap_tpu's prescreen computes (the jnp branch of
snap_tpu.align.pipeline._score_from_candidates, and its Pallas kernel
gapless_prescreen_pallas).

This module is the plain PyTorch version; ops.gapless_cuda holds the
kernel's wrapper. Words are uint32 bit patterns held in int32 tensors.
"""

from __future__ import annotations

import torch

from .sums import ordered_sum

EVEN = 0x55555555
U32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor."""
    x = x & U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def lane_masks(plen: torch.Tensor, PW: int) -> torch.Tensor:
    """[B, PW] int64 in-read masks at even bit positions."""
    wbase = 16 * torch.arange(PW, dtype=torch.int64, device=plen.device)
    r16 = (plen.to(torch.int64)[:, None] - wbase[None, :]).clamp(0, 16)
    return ((torch.ones_like(r16) << (2 * r16)) - 1) & EVEN


def gapless_prescreen_plain(
    text_words: torch.Tensor,  # [B, K*PW] int32 funnel-aligned text words
    bad_words: torch.Tensor,   # [B, K*PW] int32 text invalid bits (even)
    fwd_words: torch.Tensor,   # [B, PW] int32 packed forward pattern
    rc_words: torch.Tensor,    # [B, PW] int32 packed RC pattern
    fwd_bad: torch.Tensor,     # [B, PW] int32 pattern N bits
    rc_bad: torch.Tensor,      # [B, PW] int32
    logq_f: torch.Tensor,      # [B, L] f32
    logq_r: torch.Tensor,      # [B, L] f32
    dirs: torch.Tensor,        # [B, K] int32
    plen: torch.Tensor,        # [B] int32
    K: int,
    PW: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dist [B, K] int32, logp_err [B, K] f32); logp_err sums
    ln P(error) over mismatching in-read positions in the order of
    ops.sums.ordered_sum."""
    B = text_words.shape[0]
    L = logq_f.shape[1]
    w = lambda a: a.to(torch.int64) & U32
    t = w(text_words).reshape(B, K, PW)
    b = w(bad_words).reshape(B, K, PW)
    rc = (dirs == 1)[:, :, None]
    pw = torch.where(rc, w(rc_words)[:, None, :], w(fwd_words)[:, None, :])
    pb = torch.where(rc, w(rc_bad)[:, None, :], w(fwd_bad)[:, None, :])
    x = t ^ pw
    mism = (((x | (x >> 1)) & EVEN) | b | pb) & lane_masks(plen, PW)[:, None, :]
    dist = popcount32(mism).sum(dim=2).to(torch.int32)
    lq = torch.where(rc, logq_r[:, None, :], logq_f[:, None, :])  # [B,K,L]
    sh = 2 * torch.arange(16, dtype=torch.int64, device=mism.device)
    bits = ((mism[:, :, :, None] >> sh) & 1).reshape(B, K, PW * 16)[:, :, :L]
    zero = torch.zeros((), dtype=torch.float32, device=logq_f.device)
    return dist, ordered_sum(torch.where(bits != 0, lq, zero))

