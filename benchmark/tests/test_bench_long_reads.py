"""The ecoli.single250 cell's traffic, and the three readers of the DP
tier and the two-phase path (dp_tier_demand, tier1_frac, two_phase_frac)
on saved records: with the port's tier counts, without them, and with a
batch that overflowed its tier."""

import json
import os

import numpy as np
import pytest

from snapbench import genome, runner, traffic
from snapbench.layout import ROOT, metric_reader

READERS = ("dp_tier_demand", "tier1_frac", "two_phase_frac")
MS = 1_000_000


def _unpack(batch, start, **counts):
    return ["finalize.unpack", start, start + MS, "single.finalize", batch, counts]


def _record(spans):
    return {"mode": "single", "reads": 3, "window_ns": [0, 100 * MS],
            "program_spans": spans, "device_ops": []}


# three batches: phase A held 4,096 rows, phase B 32,768; batch 1 needed
# 5,000 in phase A (its tier overflowed) and took the two-phase path from
# 40 to 70 ms, 5 ms of it the device re-run
CLEAN = [_unpack(b, 10 * b, dp_need_a=2048, dp_rows_a=4096, dp_need_b=100 * b,
                 dp_rows_b=32768) for b in range(3)]
OVERFLOW = [CLEAN[0], _unpack(1, 30, dp_need_a=5000, dp_rows_a=4096, dp_need_b=8192,
                              dp_rows_b=32768), CLEAN[2],
            ["redo.dp_overflow", 40 * MS, 70 * MS, "single.finalize", 1, {"reads": 16384}],
            ["two_phase.tier1", 41 * MS, 46 * MS, "redo.dp_overflow", 1,
             {"reads": 16384}]]


def _read(record):
    return {name: metric_reader(name, ROOT)(record) for name in READERS}


def test_readers_with_clean_tier_counts():
    assert _read(_record(CLEAN)) == {"dp_tier_demand": 0.5, "tier1_frac": 0.0,
                                     "two_phase_frac": 0.0}


def test_readers_find_nothing_without_tier_counts():
    # the parent's spans: finalize.unpack without counts, and a redo
    bare = [s[:5] + [{}] for s in OVERFLOW[:3]] + OVERFLOW[3:4]
    for rec in (_record(bare), _record([]), {"mode": "single", "reads": 3}):
        assert _read(rec) == dict.fromkeys(READERS)


def test_readers_with_an_overflowed_batch():
    got = _read(_record(OVERFLOW))
    assert got["dp_tier_demand"] == pytest.approx(5000 / 4096)
    assert got["tier1_frac"] == pytest.approx(0.05)
    assert got["two_phase_frac"] == pytest.approx(0.25)


def test_long_read_traffic():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == "ecoli.single250")
    with open(os.path.join(ROOT, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        tr = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "configs", cell["config"] + ".json")) as f:
        cfg = json.load(f)
    assert tr["read_len"] == 250 and tr["options"] == ["-rl", "256"]
    assert tr["batch"] == 16384
    # the window holds at least 3 whole batches
    assert round(bench["run_seconds"] * tr["sizing_reads_per_s"] / tr["batch"]) >= 3
    codes = genome.make_genome(cfg)
    w = runner.draw_window(tr, codes, 3418000001, bench["run_seconds"])
    assert w.pool.bases.shape[1] == 250
    share = float(np.mean(w.pool.span != 250))
    assert 0.001 <= share <= 0.004, share
    # every indel read of a window this size is judged
    units = w.n_batches * w.batch
    indel = np.flatnonzero(w.pool.span[np.arange(units) % w.pool_units] != 250)
    assert np.isin(indel, w.judged).all() and indel.size <= tr["indel_sample"]
