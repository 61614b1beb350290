"""The stage spans of the port's align loops (snap_tpu_torch.stats:
Recorder, RECORDER) on the CPU: the recorder's nesting, parent, batch
and counts; a single-end CLI run with it on, whose spans tile each batch
and sum to AlignerStats' seconds, whose redo spans count the reads of
the aligner's branches, and whose SAM equals the run with it off; the
writer's queue wait; the -trace exporter's ranges.

One test is marked `cuda` and skips without a card: a span and
torch.profiler's interval of a kernel share one clock. On a machine with
a card (and no JAX, so without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_stage_spans.py -s
"""

import json
import os
import time
from collections import Counter, defaultdict

import pytest
import torch

from snap_tpu_torch import cli
from snap_tpu_torch.align import pipeline as TP
from snap_tpu_torch.align import single as tsingle
from snap_tpu_torch.stats import _OFF, RECORDER, Recorder
from test_torch_cli_cuda import write_inputs

torch.set_num_threads(1)

N_READS = 192   # three batches of -b 64
SINGLE = ["single", "idx", "r.fq", "-o", "out.sam", "-b", "64"]


def test_recorder_nesting_parent_batch_and_counts():
    rec = Recorder()
    rec.enable()
    with rec.timed("loop", batch=3, reads=5) as outer:
        with rec.span("inner", rows=2) as sp:
            sp.count(more=1)
            with rec.span("leaf"):
                pass
        with rec.span("other", batch=4):
            pass
    spans = rec.drain()
    assert [s[0] for s in spans] == ["leaf", "inner", "other", "loop"]
    by = {s[0]: s for s in spans}
    assert by["loop"][3:] == (None, 3, {"reads": 5})
    assert by["inner"][3:] == ("loop", 3, {"rows": 2, "more": 1})
    assert by["leaf"][3:] == ("inner", 3, {})
    assert by["other"][3:] == ("loop", 4, {})
    for child, parent in (("inner", "loop"), ("leaf", "inner"), ("other", "loop")):
        assert by[parent][1] <= by[child][1] <= by[child][2] <= by[parent][2]
    assert outer.seconds == (by["loop"][2] - by["loop"][1]) / 1e9
    assert rec.drain() == [] and rec.spans() == []


def test_recorder_off_keeps_nothing():
    rec = Recorder()
    assert rec.span("a", rows=1) is rec.span("b") is _OFF
    with rec.timed("loop") as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002
    rec.enable()
    with rec.span("kept"):
        pass
    rec.disable()
    with rec.span("dropped"):
        pass
    assert [s[0] for s in rec.drain()] == ["kept"]


def test_recorder_records_while_a_profiler_collects():
    from torch.profiler import ProfilerActivity, profile

    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        assert rec.on
        with rec.span("profiled"):
            pass
    assert not rec.on
    with rec.span("after"):
        pass
    assert [s[0] for s in rec.drain()] == ["profiled"]


def test_recorder_without_the_profilers_flag(monkeypatch):
    # torch keeps the flag private; without it only enable() turns it on
    from snap_tpu_torch import stats

    monkeypatch.delattr(stats._torch_profiler, "_is_profiler_enabled")
    rec = Recorder()
    assert not rec.on and rec.span("a") is _OFF
    rec.enable()
    with rec.span("kept"):
        pass
    assert [s[0] for s in rec.drain()] == ["kept"]


def _run(argv, directory, overflow=False) -> tuple:
    """The port's CLI on the CPU in `directory`: (its aligner, the SAM)."""
    made = []
    align_file = tsingle.SingleEndAligner.align_file

    def keep(self, *a, **kw):
        made.append(self)
        return align_file(self, *a, **kw)

    class Overflowed(TP.HostWinners):
        def __init__(self, packed):
            super().__init__(packed)
            self.dp_overflow = True

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        mp.setattr(tsingle.SingleEndAligner, "align_file", keep)
        if overflow:
            mp.setattr(TP, "HostWinners", Overflowed)
        assert cli.main(argv, device="cpu") == 0
    (aligner,) = made
    return aligner, (directory / "out.sam").read_bytes()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 25%-repeat genome; `single` with the recorder off and on, and
    on with the DP tier of a batch of the first 64 reads overflowed:
    (aligner, SAM, spans) each."""
    d = tmp_path_factory.mktemp("spans")
    write_inputs(str(d), "repeat25", N_READS)
    with open(d / "r.fq", "rb") as f:
        first = [f.readline() for _ in range(4 * 64)]
    (d / "r64.fq").write_bytes(b"".join(first))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        assert cli.main(["index", "g.fa", "idx", "-s", "20"], device="cpu") == 0
    out = {"dir": d}
    for name in ("off", "on", "overflow"):
        RECORDER.drain()
        if name != "off":
            RECORDER.enable()
        argv = SINGLE if name != "overflow" else [
            "single", "idx", "r64.fq", "-o", "out.sam", "-b", "64"]
        try:
            aligner, sam = _run(argv, d, overflow=name == "overflow")
        finally:
            RECORDER.disable()
        out[name] = (aligner, sam, RECORDER.drain())
    return out


def test_spans_tile_every_batch(runs):
    aligner, _, spans = runs["on"]
    loop = [s for s in spans if s[0].startswith("single.")]
    batches = defaultdict(set)
    for name, _, _, parent, batch, counts in loop:
        assert parent is None
        batches[batch].add(name)
    stages = {"single.read_wait", "single.submit", "single.finalize", "single.emit"}
    assert {k: batches[k] for k in range(3)} == {k: stages for k in range(3)}
    assert batches[3] == {"single.read_wait"}   # the read that found no batch
    # one after another on the main thread, none overlapping
    ordered = sorted(loop, key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(ordered, ordered[1:]))
    for s in spans:
        if s[0].startswith("finalize.") and s[0] != "finalize.winners_wait":
            assert s[3] == "single.finalize", s
        if s[0].startswith("emit."):
            assert s[3] in ("single.emit", "emit.per_read"), s
        if s[0] in ("redo.candidates", "redo.score", "redo.finalize"):
            assert s[3] == "redo.wide", s
    reads = {s[4]: s[5]["reads"] for s in loop if s[0] == "single.finalize"}
    assert reads == {0: 64, 1: 64, 2: 64}
    planned = sum(s[5]["planned"] for s in loop if s[0] == "single.emit")
    assert planned == aligner.branches["planned"] > 0


@pytest.mark.parametrize("run", ["on", "overflow"])
def test_stats_seconds_are_the_spans_sums(runs, run):
    aligner, _, spans = runs[run]
    secs = Counter()
    for name, s, e, *_ in spans:
        secs[name] += (e - s) / 1e9
    st = aligner.stats
    assert st.seconds_reading == pytest.approx(secs["single.read_wait"], abs=1e-6)
    assert st.seconds_aligning == pytest.approx(
        secs["single.submit"] + secs["single.finalize"], abs=1e-6)
    assert st.seconds_writing == pytest.approx(secs["single.emit"], abs=1e-6)
    assert 0 < st.seconds_reading + st.seconds_aligning + st.seconds_writing <= st.align_seconds


@pytest.mark.parametrize("run", ["on", "overflow"])
def test_redo_spans_count_the_branches_reads(runs, run):
    aligner, _, spans = runs[run]
    br = aligner.branches
    wide = Counter()
    for name, _, _, _, _, counts in spans:
        if name == "redo.wide":
            wide[counts["force_dp"]] += counts["reads"]
            assert counts["chunks"] >= 1 and counts["candidates"] >= 1
    assert wide[0] == br["redo_truncated"] > 0
    assert wide[1] == br["redo_edge_indel"]
    ovf = [s for s in spans if s[0] == "redo.dp_overflow"]
    assert sum(s[5]["reads"] for s in ovf) == br["dp_overflow"]
    if run == "overflow":
        assert br["dp_overflow"] == 64 and len(ovf) == 1
        inner = [s[3] for s in spans if s[0].startswith("two_phase.")]
        assert inner == ["redo.dp_overflow"] * 2
    else:
        assert not ovf and br["dp_overflow"] == 0 and br["redo_edge_indel"] > 0


def test_sam_is_the_same_with_the_recorder_on(runs):
    (_, off, spans), (_, on, _) = runs["off"], runs["on"]
    assert spans == []
    assert on == off and off.count(b"\n") > N_READS


def test_trace_dir_holds_the_stage_ranges(runs):
    d = runs["dir"]
    with open(d / "r.fq", "rb") as f:
        head = b"".join(f.readline() for _ in range(32))   # 8 reads
    (d / "r8.fq").write_bytes(head)
    argv = ["single", "idx", "r8.fq", "-o", "out.sam", "-b", "8", "-rl", "32",
            "-trace", "trace"]
    _run(argv, d)
    assert not (RECORDER.enabled or RECORDER.ranges) and RECORDER.drain() == []
    with open(d / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"single.submit", "single.finalize", "single.emit"} <= names
    os.remove(d / "trace" / "trace.json")


def test_writer_queue_wait_is_a_span():
    """A write that hands a full buffer to the writer's thread while
    `depth` buffers are in flight waits in write.queue_wait."""
    from snap_tpu_torch.io.bufferedasync import BufferedAsyncWriter

    class Slow:
        def write(self, b):
            time.sleep(0.05)

    RECORDER.drain()
    RECORDER.enable()
    try:
        w = BufferedAsyncWriter(Slow(), buffer_size=8, depth=2)
        with RECORDER.span("emit.write"):
            for _ in range(3):
                w.write(b"x" * 8)
        w.close()
    finally:
        RECORDER.disable()
    waits = [s for s in RECORDER.drain() if s[0] == "write.queue_wait"]
    assert [(s[3], s[5]) for s in waits] == [("emit.write", {"bytes": 8})] * 3
    # the third waits while the thread writes the first
    assert max(s[2] - s[1] for s in waits) >= 20_000_000


@pytest.mark.cuda
def test_spans_and_device_events_share_one_clock():
    """A span around a host sleep, one kernel and a synchronize encloses
    the kernel's torch.profiler interval, and the sleep ends before the
    kernel starts. Prints both margins: the device clock's offset from
    the host's lies between minus the first and the second."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    x.mul_(2)   # the kernel's first launch loads its module
    torch.cuda.synchronize()
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x.mul_(2)   # the profiler's first launch, which it pays for once
        torch.cuda.synchronize()
        with rec.span("outer"):
            with rec.span("sleep"):
                time.sleep(0.05)
            x.mul_(2)
            torch.cuda.synchronize()
    by = {s[0]: s for s in rec.drain()}
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    assert len(kernels) == 2, kernels
    (k0, k1), outer, sleep = kernels[1], by["outer"], by["sleep"]
    print(f"kernel start - sleep end: {(k0 - sleep[2]) / 1e3:.1f} us; "
          f"span end - kernel end: {(outer[2] - k1) / 1e3:.1f} us")
    assert outer[1] <= sleep[2] <= k0 <= k1 <= outer[2]
