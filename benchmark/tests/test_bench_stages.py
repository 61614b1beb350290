"""The stage metrics' readers (benchmark/metrics/*_frac.py over
snapbench/stages.py) on a record of the port's spans with the values
worked out by hand, the idle gaps named by the innermost program span,
and the readers on a port's live recorder and on a port without one."""

import sys
import time
import types

import pytest

from snapbench import stages
from snapbench.layout import metric_reader
from snapbench.trace import breakdown

MS = 1_000_000
STAGES = ("read_wait_frac", "submit_frac", "winners_wait_frac", "redo_frac",
          "finalize_frac", "emit_frac")


def _sp(name, a, b, parent=None, batch=0, **counts):
    return [name, a * MS, b * MS, parent, batch, counts]


RECORD = {
    "window_ns": [0, 100 * MS],
    "device_ops": [["k", 10 * MS, 12 * MS], ["k", 30 * MS, 32 * MS],
                   ["k", 60 * MS, 62 * MS]],
    "spans": [["pipeline.align_winners_device", 6 * MS, 19 * MS],
              ["single._finalize", 21 * MS, 69 * MS]],
    "program_spans": [
        _sp("single.read_wait", 1, 5),
        _sp("single.submit", 5, 20, reads=64),
        _sp("finalize.winners_wait", 20, 25, "single.finalize"),
        _sp("finalize.unpack", 25, 27, "single.finalize"),
        _sp("redo.score", 41, 50, "redo.wide", rows=3),
        _sp("redo.finalize", 50, 59, "redo.wide", rows=3),
        _sp("redo.wide", 40, 60, "single.finalize", reads=3, force_dp=0),
        _sp("single.finalize", 20, 70, reads=64),
        _sp("emit.format", 70, 75, "single.emit"),
        _sp("emit.write", 80, 90, "emit.per_read"),
        _sp("single.emit", 70, 95, reads=64, planned=60),
    ],
}
EXPECTED = {
    "read_wait_frac": 0.04,
    "submit_frac": 0.15,
    "winners_wait_frac": 0.05,
    "redo_frac": 0.20,
    "finalize_frac": 0.25,     # 50 ms of single.finalize less 5 waiting, 20 in redo
    "emit_frac": 0.25,
}


@pytest.mark.parametrize("name", STAGES)
def test_stage_reader_on_a_record(name):
    assert metric_reader(name)(RECORD) == pytest.approx(EXPECTED[name])


def test_a_disjoint_tiling_sums_to_its_cover():
    # the loop's stages cover 1..95 ms, and the six metrics tile them
    total = sum(metric_reader(n)(RECORD) for n in STAGES)
    loop = [(s, e) for n, s, e, *_ in RECORD["program_spans"] if n.startswith("single.")]
    assert total == pytest.approx(stages.union_ns(loop) / (100 * MS)) == pytest.approx(0.94)
    own = stages.self_seconds(RECORD)
    assert own["finalize.unpack"] == pytest.approx(0.002)
    assert own["redo.wide"] == pytest.approx(0.002)    # 40-41 and 59-60 ms
    assert own["outside the program's spans"] == pytest.approx(0.006)   # 0-1, 95-100 ms
    assert sum(own.values()) == pytest.approx(0.1)


def test_readers_give_zero_without_their_spans_and_none_without_any():
    rec = dict(RECORD, program_spans=[_sp("single.submit", 0, 50)])
    got = {n: metric_reader(n)(rec) for n in STAGES}
    assert got == {**{n: 0.0 for n in STAGES}, "submit_frac": 0.5}
    rec = dict(RECORD, program_spans=[])
    assert {metric_reader(n)(rec) for n in STAGES} == {None}


def test_idle_gaps_named_by_the_innermost_program_span():
    both = {**RECORD, "spans": RECORD["spans"] + RECORD["program_spans"]}
    gaps = {round(s * 1e3): n for n, s in breakdown(both)["idle_gaps"]}
    # 62..100 ms: its middle (81) in emit.write; 32..60 (46) in redo.score,
    # inside the benchmark's single._finalize; 12..30 (21) in the
    # benchmark's span, which began after single.finalize; 0..10 (5) in
    # single.submit
    assert gaps == {38: "emit.write", 28: "redo.score", 18: "single._finalize",
                    10: "single.submit"}
    # idle: 0-10, 12-30, 32-60, 62-100 ms (94 ms); outside the program's
    # spans: 0-1 and 95-100
    assert stages.idle_coverage(RECORD) == pytest.approx(88 / 94)
    idle = stages.self_seconds(RECORD, within=[(0, 10 * MS), (62 * MS, 100 * MS)])
    assert idle == pytest.approx({"outside the program's spans": 0.006,
                                  "single.read_wait": 0.004,
                                  "single.submit": 0.005, "single.finalize": 0.008,
                                  "emit.format": 0.005, "single.emit": 0.010,
                                  "emit.write": 0.010})


def test_readers_read_the_ports_recorder():
    from snap_tpu_torch.stats import RECORDER

    RECORDER.drain()
    RECORDER.enable()
    try:
        t0 = time.time_ns()
        with RECORDER.timed("single.submit", batch=0):
            time.sleep(0.01)
        with RECORDER.timed("single.emit", batch=0):
            time.sleep(0.01)
        t1 = time.time_ns()
    finally:
        RECORDER.disable()
    rec = {"window_ns": [t0, t1]}
    try:
        assert 0 < metric_reader("submit_frac")(rec) < 1
        assert metric_reader("redo_frac")(rec) == 0.0
        assert metric_reader("read_wait_frac")({"window_ns": [t1 + 1, t1 + 2]}) is None
    finally:
        RECORDER.drain()


def test_readers_find_nothing_in_a_port_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "snap_tpu_torch.stats", types.ModuleType("stats"))
    rec = {"window_ns": [0, 100 * MS], "device_ops": RECORD["device_ops"]}
    assert {metric_reader(n)(rec) for n in STAGES} == {None}
    assert stages.idle_coverage(rec) is None
