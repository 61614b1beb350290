"""The roofline arithmetic, by hand, and the traced run's device-side
accumulation against it."""

import pytest
import torch

from snapbench import roofline
from snapbench.trace import Tracer


def test_bound_ms_by_hand():
    assert roofline.bound_ms(3.35e9, 0, 0) == pytest.approx(1.0)          # bytes
    assert roofline.bound_ms(0, 16.75e9, 0) == pytest.approx(1.0)         # integer lanes
    assert roofline.bound_ms(0, 0, 33.5e9) == pytest.approx(1.0)          # float lanes
    assert roofline.bound_ms(3.35e9, 33.5e9, 33.5e9) == pytest.approx(2.0)


def test_work_by_hand():
    # gapless: B=2 reads x K=3 candidates x (11 ops a word x 4 words + 1),
    # and 3 + 1 operations for each of 5 mismatches
    assert roofline.gapless_work(2, 3, 4, 5) == (2 * 3 * 45 + 15, 5)
    assert roofline.dp_work(10) == (260, 70)
    assert roofline.affine_work(10) == (440, 70)


def test_tracer_accumulates_the_same_bound(cpu):
    tr = Tracer(cpu)
    i_ops, f_ops = roofline.dp_work(torch.tensor(1e9, dtype=torch.float64))
    tr._accumulate("dp", 2e9, i_ops, f_ops)
    tr._accumulate("dp", 3.35e12, *roofline.dp_work(torch.tensor(1.0, dtype=torch.float64)))
    n, acc = tr.work["dp"]
    assert n == 2
    assert float(acc) == pytest.approx(roofline.bound_ms(2e9, 26e9, 7e9)
                                       + roofline.bound_ms(3.35e12, 26, 7))
