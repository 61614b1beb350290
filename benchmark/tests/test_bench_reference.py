"""The plain reference by hand, and against the port on the CPU at a
tiny genome: a whole run of each tiny cell, added to a copy of the
benchmark as files alone, comes out correct; the traced run reports the
cell's per-layer metrics, the added one among them."""

import numpy as np
import pytest

from conftest import EXTRA_METRIC, run_tiny
from reference.align import KmerIndex, hamming, revcomp, semiglobal
from snapbench import check
from snapbench.layout import load_cell, metric_reader


def test_semiglobal_by_hand():
    # ACGT inside TTACGTTT: no edit, ending at column 6
    d, e = semiglobal(np.array([[0, 1, 2, 3]], np.uint8), np.array([[3, 3, 0, 1, 2, 3, 3, 3]], np.uint8))
    assert (d[0], e[0]) == (0, 6)
    # the text holds one base more than the read (a deletion): 1 edit
    d, _ = semiglobal(np.array([[0, 1, 2, 3, 0, 1, 2, 3]], np.uint8),
                      np.array([[0, 1, 2, 3, 3, 0, 1, 2, 3, 0, 0]], np.uint8))
    assert d[0] == 1
    # a read's N matches nothing
    d, _ = semiglobal(np.array([[0, 4, 2]], np.uint8), np.array([[0, 1, 2]], np.uint8))
    assert d[0] == 1
    assert hamming(np.array([[0, 1, 2, 3]], np.uint8), np.array([[0, 1, 1, 5]], np.uint8))[0] == 2
    assert revcomp(np.array([0, 1, 4, 3], np.uint8)).tolist() == [0, 4, 2, 3]


def test_kmer_index_hits_in_genome_order():
    g = np.array([0, 1, 2, 3] * 10, np.uint8)
    idx = KmerIndex(g, 4)
    q, pos = idx.hits(idx.keys_of(np.array([[0, 1, 2, 3], [1, 1, 1, 1]], np.uint8)), cap=3)
    assert q.tolist() == [0, 0, 0] and pos.tolist() == [0, 4, 8]


def test_nm_by_hand():
    g = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8)
    seq = np.array([0, 1, 2, 2, 0, 1], np.uint8)
    # 3M1D3M at 0: ACG matches, T deleted, then GAC against ACG: 1 + 3
    ops = check.cigar_ops(b"3M1D3M")
    assert check.ref_span(ops) == 7 and check.query_len(ops) == 6
    assert check.edits(ops, seq, g, 0) == 1 + 3
    assert check.edits(check.cigar_ops(b"2S4M"), seq, g, 2) == 1
    with pytest.raises(ValueError):
        check.cigar_ops(b"3M1Q")


@pytest.mark.parametrize("seed", [2**31 + 11, 12])
def test_port_on_cpu_is_correct(seed, tiny_root, tiny_cache, cpu):
    r, rec, log = run_tiny(tiny_root, tiny_cache, "tiny.single", seed, False, cpu)
    assert r["correct"], log
    checks = {k: v["value"] for k, v in r["checks"].items()}
    assert checks["missing_records"] == 0 and checks["inconsistent_records"] == 0
    assert list(r["checks"]) == ["missing_records", "inconsistent_records", "wrong_share"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["attempted"] == rec["reads"] > 0


def test_traced_run_reports_the_cells_metrics(tiny_root, tiny_cache, cpu):
    r, rec, log = run_tiny(tiny_root, tiny_cache, "tiny.single", 7, True, cpu)
    assert r["correct"], log
    cell = load_cell("tiny.single", tiny_root)
    # on the CPU the readers of the card's trace find nothing to read
    want = {m["name"] for m in cell.per_layer} - {
        "gapless_roofline", "dp_roofline", "affine_roofline", "device_idle_frac",
        "card_peak_gib"}
    assert EXTRA_METRIC in want
    assert set(r["metrics"]) == want
    assert r["metrics"][EXTRA_METRIC]["value"] == rec["reads"]
    assert metric_reader(EXTRA_METRIC, tiny_root)(rec) == rec["reads"]
    assert all(w["launches"] > 0 for w in rec["kernel_work"].values())
    assert any(n.startswith("pipeline.") for n, _, _ in rec["spans"])
    assert "breakdown" in r and r["device"]["window_s"] > 0
