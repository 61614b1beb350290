"""Every per-layer metric's reader on a recorded trace, with the values
worked out by hand, and the breakdown of the same record."""

import json
import os

import pytest

from snapbench.layout import BENCH_DIR, ROOT, metric_reader
from snapbench.trace import breakdown, union_ns

MS = 1_000_000
RECORD = {
    "mode": "single", "reads": 1000, "window_s": 0.1,
    "window_ns": [0, 100 * MS],
    "stats": {"total": 1000, "seconds_reading": 0.01, "seconds_writing": 0.03,
              "align_seconds": 0.08},
    "branches": {"planned": 900, "redo_truncated": 60, "fallback": 15, "two_phase": 0,
                 "redo_edge_indel": 5, "per_read": 100},
    "card_peak_bytes": 3 * 2**30, "index_load_s": 1.5,
    "device_ops": [
        ["void gapless_kernel(Args)", 10 * MS, 12 * MS],
        ["void fitting_dp_kernel(Args)", 11 * MS, 15 * MS],
        ["void (anonymous namespace)::pass_kernel<8>(Args)", 30 * MS, 36 * MS],
        ["void (anonymous namespace)::plan_kernel(Args)", 29 * MS, 30 * MS],
        ["Memcpy DtoH (Device -> Pinned)", 60 * MS, 62 * MS],
    ],
    "spans": [["pipeline.align_winners_device", 5 * MS, 25 * MS],
              ["single._submit", 4 * MS, 26 * MS],
              ["pipeline.gather_merged_rows", 55 * MS, 65 * MS],
              ["single._finalize", 50 * MS, 90 * MS]],
    "kernel_work": {"gapless": {"launches": 3, "bound_ms": 0.5},
                    "dp": {"launches": 6, "bound_ms": 1.0},
                    "affine": {"launches": 0, "bound_ms": 0.0}},
}
EXPECTED = {
    "io_wait_frac": 0.5,                       # (0.01 + 0.03) / 0.08
    "pipeline_call_frac": 0.3,                 # 20 + 10 of 100 ms
    "slow_read_frac.single": 0.08,             # (60 + 15 + 0 + 5) / 1000
    "gapless_roofline": 25.0,                  # 0.5 of 2 ms
    "dp_roofline": 25.0,                       # 1.0 of 4 ms
    "affine_roofline": None,                   # no launch recorded
    "device_idle_frac": 0.86,                  # busy 10..15, 29..36, 60..62: 14 of 100 ms
    "card_peak_gib": 3.0,
    "index_load_s": 1.5,
}


def test_every_metric_has_a_reader_and_every_reader_a_case():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = {m["name"] for m in json.load(f)["per_layer"]}
    readers = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics")) if f.endswith(".py")}
    assert names <= readers
    assert readers == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_recorded_trace(name):
    got = metric_reader(name)(RECORD)
    if EXPECTED[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(EXPECTED[name])


def test_readers_find_nothing_in_an_untraced_record():
    rec = {k: v for k, v in RECORD.items() if k not in ("device_ops", "kernel_work")}
    rec["card_peak_bytes"] = 0
    for name in ("gapless_roofline", "dp_roofline", "affine_roofline", "card_peak_gib"):
        assert metric_reader(name)(rec) is None


def test_union_and_breakdown():
    assert union_ns([(0, 5), (3, 8), (10, 12)]) == 10
    b = breakdown(RECORD)
    assert b["device_ops"][0] == ["void (anonymous namespace)::pass_kernel<8>(Args)", 0.006]
    gaps = dict((round(s * 1e3), n) for n, s in b["idle_gaps"])
    # the longest gap, 62..100 ms, is inside _finalize (its middle, 81 ms)
    assert gaps[38] == "single._finalize"
    # 15..29 ms: the middle (22 ms) lies in align_winners_device, the
    # innermost span open then; 36..60 ms: the middle (48 ms) in none
    assert gaps[14] == "pipeline.align_winners_device"
    assert gaps[24] == "outside the traced spans"
