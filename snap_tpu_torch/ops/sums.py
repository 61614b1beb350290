"""Floating-point sums in a fixed order.

A float sum's last bits depend on the order of its additions. The port
sums in one documented order everywhere (plain versions and CUDA
kernels alike), the order snap_tpu's sums take on its CPU backend, so
the port reproduces snap_tpu's log-probabilities and MAPQs bit for bit:

- up to 32 terms: left to right from +0.0;
- more: the row is zero-padded to a multiple of 32 (pad // 2 zeros in
  front, the rest behind), each window of 32 is summed left to right
  from +0.0, and the window sums are summed by the same rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW = 32


def window_origin(n: int) -> int:
    """Zeros padded in front of an n-term row (0 when n <= 32)."""
    return 0 if n <= WINDOW else ((-n) % WINDOW) // 2


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in the order above."""
    n = x.shape[-1]
    if n <= WINDOW:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for p in range(n):
            acc = acc + x[..., p]
        return acc
    pad = (-n) % WINDOW
    lo = pad // 2
    w = F.pad(x, (lo, pad - lo)).reshape(*x.shape[:-1], -1, WINDOW)
    acc = torch.zeros(w.shape[:-1], dtype=x.dtype, device=x.device)
    for p in range(WINDOW):
        acc = acc + w[..., p]
    return ordered_sum(acc)
