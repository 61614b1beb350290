"""ctypes wrapper of the CUDA fitting edit distance (csrc/dp.cu).

Same signature as ops.dp.fitting_edit_distance_plain. CUDA tensors
launch the kernel; CPU tensors run the plain version. Rows of more than
MAX_COLS DP columns (W + 1) run one block a row, with scratch planes
that the wrapper allocates.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dp import (
    LOG_GAP_EXTEND,
    LOG_GAP_OPEN,
    NEG,
    DPResult,
    finish_dp,
    fitting_edit_distance_core_plain,
)

MAX_COLS = 512  # W + 1 of the one-warp kernel: 16 columns per lane


KERNEL = _build.Kernel(
    "dp", "fitting_dp_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def fitting_edit_distance_core_cuda(pattern, pat_logq, plen, text, anchored):
    """Kernel launch: (packed answer [N] i32, log-prob [N] f32, end
    column [N] i32), the outputs of ops.dp.fitting_edit_distance_core_plain.
    CPU tensors run that plain version."""
    if not pattern.is_cuda:
        return fitting_edit_distance_core_plain(
            pattern, pat_logq, plen.to(torch.int32), text, anchored
        )
    N, L = pattern.shape
    W = text.shape[1]
    dev = pattern.device
    for name, t, shape, dt in (
        ("pattern", pattern, (N, L), torch.uint8),
        ("pat_logq", pat_logq, (N, L), torch.float32),
        ("plen", plen, (N,), torch.int32),
        ("text", text, (N, W), torch.uint8),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"fitting_edit_distance_cuda: {name} must be {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fitting_edit_distance_cuda: {name} not contiguous")
    blocks, scratch = 0, None
    if W + 1 > MAX_COLS:
        blocks = _build.long_row_blocks(N, dev)
        scratch = torch.empty((blocks, 6, W + 1), dtype=torch.int32, device=dev)
    packed = torch.empty((N,), dtype=torch.int32, device=dev)
    lp = torch.empty((N,), dtype=torch.float32, device=dev)
    end = torch.empty((N,), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = KERNEL(
        p(pattern), p(pat_logq), p(plen), p(text), p(packed), p(lp), p(end),
        N, L, W, int(bool(anchored)), LOG_GAP_OPEN, LOG_GAP_EXTEND, NEG,
        None if scratch is None else p(scratch), blocks,
        _build.stream_ptr(dev),
    )
    _build.check(err, "fitting_edit_distance")
    fitting_edit_distance_core_cuda.launches += 1
    return packed, lp, end


fitting_edit_distance_core_cuda.launches = 0


def fitting_edit_distance_cuda(
    pattern: torch.Tensor,
    pat_logq: torch.Tensor,
    plen: torch.Tensor,
    text: torch.Tensor,
    anchored: bool = False,
) -> DPResult:
    packed, lp, end = fitting_edit_distance_core_cuda(
        pattern, pat_logq, plen, text, anchored
    )
    return finish_dp(packed, lp, end, plen.to(torch.int32))
