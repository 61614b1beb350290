"""The check against broken runs: the control (the reference put in the
program's place, gapless), and the port with its timed path broken
underneath, each run on the CPU past the harness's look for a card;
`correct` has to come out false for each."""

import numpy as np
import pytest

import readings
from conftest import run_tiny
from snapbench.layout import load_cell


@pytest.mark.parametrize("mapq", [None, 0])
def test_control_is_not_correct(mapq, tiny_root, tiny_cache, cpu):
    c = load_cell("tiny.single", tiny_root)
    shares = [readings.control_reading(c, seed, 1.0, cpu, cache_dir=tiny_cache, mapq=mapq)
              for seed in (1, 2, 3)]
    for s in shares:
        assert s["missing_records"] == 0 and s["inconsistent_records"] == 0, s
    # over the three seeds the control reads far above the tiny cell's
    # limit: reads with indels are placed worse; with MAPQ 0 written,
    # reads placed uniquely are besides underconfident
    total = sum(s["wrong_share"] * s["judged"] for s in shares) / sum(s["judged"] for s in shares)
    assert total > c.limits["wrong_share"]
    if mapq == 0:
        assert sum(s["underconfident"] for s in shares) > sum(s["judged"] for s in shares) / 2


def _half_batches(fn):
    from snap_tpu_torch.io.fastq import ReadBatch

    def half(b):
        n = len(b) // 2
        return ReadBatch(b.ids[:n], b.bases[:n], b.quals[:n], b.lengths[:n], b.aux)

    def wrapped(*a, **kw):
        for x in fn(*a, **kw):
            yield tuple(half(y) for y in x) if isinstance(x, tuple) else half(x)

    return wrapped


def test_half_of_each_batch_left_out(tiny_root, tiny_cache, cpu, monkeypatch):
    from snap_tpu_torch.align import single

    monkeypatch.setattr(single, "single_batches", _half_batches(single.single_batches))
    r, _, log = run_tiny(tiny_root, tiny_cache, "tiny.single", 5, False, cpu)
    assert not r["correct"], log
    assert r["checks"]["missing_records"]["value"] > 0


def _altered(field, how):
    from snap_tpu_torch.align.single import SingleEndAligner

    emit = SingleEndAligner._emit_planned

    def wrapped(self, *a):
        plan = a[-1]
        plan = dict(plan, **{field: how(np.asarray(plan[field]))})
        return emit(self, *a[:-1], plan)

    return wrapped


@pytest.mark.parametrize("field, check", [("pos", "inconsistent_records"),
                                          ("mapq", "wrong_share")])
def test_answers_altered_where_produced(field, check, tiny_root, tiny_cache, cpu, monkeypatch):
    from snap_tpu_torch.align.single import SingleEndAligner

    # POS one base on, or MAPQ 0, in every record the planned emit writes
    how = (lambda x: x + 1) if field == "pos" else np.zeros_like
    monkeypatch.setattr(SingleEndAligner, "_emit_planned", _altered(field, how))
    r, _, log = run_tiny(tiny_root, tiny_cache, "tiny.single", 6, False, cpu)
    assert not r["correct"], log
    c = r["checks"][check]
    assert c["value"] > c["limit"], log
