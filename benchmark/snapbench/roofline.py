"""The least time each kernel's work could take on one H100, counted
from the inputs of each launch (copied from chip_smoke.py's kernel
table arithmetic, frozen here).

Peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): HBM at 3.35 TB/s,
and 67 TFLOP/s of float32 outside the tensor cores, which counts a fused
multiply-add as two operations, so one float32 operation per lane per
clock is half of it; an SM has half as many INT32 lanes as FP32 lanes,
so integer operations, compares and selects run at a quarter of it.

Operations per cell, as (integer/compare/select, float32), are those of
the port's plain recurrences (ops/dp.py, ops/affine.py, ops/gapless.py)
counted once per elementwise step, as the kernel table in PERF.md gives
them. A launch's bound is the larger of its bytes (each input read once,
each output written once) over the bandwidth and its operations over
the lanes' rates.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4

DP_OPS_PER_CELL = (26, 7)       # fitting_edit_distance: per (pattern base, text column)
AG_OPS_PER_CELL = (44, 7)       # affine_extend: per (pattern base, text base)
GL_OPS_PER_WORD = 11            # gapless_prescreen: per (read, candidate, 16-base word)
GL_OPS_PER_MISMATCH = (3, 1)    # find the set bit, add its ln P(error)


def bound_ms(nbytes: float, int_ops: float, fp_ops: float) -> float:
    """Milliseconds: the longer of the bytes at HBM bandwidth and the
    integer and float operations on their own lanes (side by side)."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S,
                     fp_ops / FP32_OPS_PER_S)


def gapless_work(B: int, K: int, PW: int, mismatches: float) -> tuple[float, float]:
    """(integer, float) operations of one gapless_prescreen launch."""
    return (B * K * (GL_OPS_PER_WORD * PW + 1) + GL_OPS_PER_MISMATCH[0] * mismatches,
            GL_OPS_PER_MISMATCH[1] * mismatches)


def dp_work(cells: float) -> tuple[float, float]:
    return cells * DP_OPS_PER_CELL[0], cells * DP_OPS_PER_CELL[1]


def affine_work(cells: float) -> tuple[float, float]:
    return cells * AG_OPS_PER_CELL[0], cells * AG_OPS_PER_CELL[1]
