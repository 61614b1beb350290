"""align/adjust.py (the AlignmentAdjuster equivalent: contig-edge soft
clipping) in snap_tpu_torch against snap_tpu (the twins of
tests/test_adjust.py): each case gives the same (start, CIGAR, NM) or
None in both packages, and the value the reference test expects."""

import numpy as np
import pytest

import snap_tpu.align.adjust as J
import snap_tpu_torch.align.adjust as T
from snap_tpu_torch.constants import PAD


def _genome():
    g = np.full(200, PAD, dtype=np.uint8)
    g[50:150] = np.random.default_rng(2).integers(0, 4, size=100)
    return g


def _mut(a, *ps):
    a = a.copy()
    for p in ps:
        a[p] = (a[p] + 1) % 4
    return a


G = _genome()
Z = lambda n: np.zeros(n, np.uint8)  # noqa: E731
CASES = {
    "inside_contig_unchanged": (60, "30M", G[60:90].copy(), {}, (60, "30M", 0)),
    "trailing_overhang_clipped": (130, "30M", np.concatenate([G[130:150], Z(10)]), {}, (130, "20M10S", 0)),
    "leading_overhang_clipped_and_pos_shifts": (40, "30M", np.concatenate([Z(10), G[50:70]]), {}, (50, "10S20M", 0)),
    "existing_soft_clips_compose": (140, "3S15M2S", np.concatenate([G[140:150], Z(5)]), {}, (140, "3S10M7S", 0)),
    "deletion_at_boundary_dropped": (138, "10M5D10M", np.concatenate([G[138:148], G[153:163]]), {}, (138, "10M10S", 0)),
    "fully_off_contig_is_none": (160, "30M", Z(30), {}, None),
    "nm_recomputed_on_clip": (130, "30M", _mut(np.concatenate([G[130:150], Z(10)]), 5, 25), {}, (130, "20M10S", 1)),
    "eq_x_style_preserved": (130, "30M", _mut(np.concatenate([G[130:150], Z(10)]), 5), {"use_m": False},
                             (130, "5=1X14=10S", 1)),
    "insertion_across_edge": (135, "10M3I12M", np.concatenate([G[135:145], Z(3), G[145:150], Z(7)]), {}, None),
    "leading_deletion": (45, "2S8M4D20M", np.concatenate([Z(2), G[45:53], G[57:77]]), {}, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_adjust_matches_reference(name):
    start, cigar, body, kw, want = CASES[name]
    ref = J.adjust_to_contig(start, cigar, body, G, 50, 150, **kw)
    got = T.adjust_to_contig(start, cigar, body, G, 50, 150, **kw)
    assert got == ref
    if name not in ("insertion_across_edge", "leading_deletion"):
        assert got == want


@pytest.mark.parametrize("cigar", ["3S10M2I5M1S", "100M", "5=1X14=10S", "10M5D10M", "1I1M1D"])
def test_cigar_roundtrip_helpers(cigar):
    assert T.parse_cigar(cigar) == J.parse_cigar(cigar)
    assert T.render_cigar(T.parse_cigar(cigar)) == J.render_cigar(J.parse_cigar(cigar)) == cigar
    ops = [[2, "M"], [3, "M"], [0, "I"]]
    assert T.render_cigar(ops) == J.render_cigar(ops) == "5M"
