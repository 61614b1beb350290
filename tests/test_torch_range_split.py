"""The port's -t N FASTQ reader (io/range_split.py): twin of
tests/test_range_split.py, and `single -t 3` through the CLI.

The parallel parse over record-aligned byte ranges reproduces the
single reader's stream exactly, in order (records straddling range
boundaries, quality strings starting with '@' or '+'), with snap_tpu's
ranges and batches. The aligner re-cuts those batches into the serial
reader's, so `single -t 3` writes the SAM bytes of `-t 1` but for the
@PG command line; the aligner's branches name the reader that parsed
the reads. snap_tpu aligns the ranges' batches as they come, so the
port's `-t N` equals snap_tpu's `-t N` only where no batch-level path
(the DP tier's overflow, phase B's and C's row caps) turns on a batch's
make-up: it does on the 128 reads twinned here, and not on the repeat
reads of test_t3_keeps_t1_dp_overflow (ROADMAP C).
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.io import native as native_io
from snap_tpu_torch.io.fastq import read_batches
from snap_tpu_torch.io.range_split import parallel_read_batches, split_fastq_ranges
from test_torch_cli_cuda import write_inputs
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)


def _write_fastq(path, n, rng):
    with open(path, "wb") as f:
        for i in range(n):
            ln = int(rng.integers(40, 120))
            seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, ln)].tobytes()
            q = bytes(int(x) for x in rng.integers(33, 74, ln))
            if i % 3 == 0:
                q = b"@" + q[1:]
            elif i % 3 == 1:
                q = b"+" + q[1:]
            f.write(b"@read%d some comment\n%s\n+\n%s\n" % (i, seq, q))


def _drain(it):
    ids, seqs = [], []
    for b in it:
        for j in range(len(b)):
            ids.append(bytes(b.ids[j]))
            L = int(b.lengths[j])
            seqs.append(b.bases[j, :L].tobytes() + b.quals[j, :L].tobytes())
    return ids, seqs


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
@pytest.mark.parametrize("threads", [2, 3, 5])
def test_parallel_matches_serial(tmp_path, threads):
    """The parallel parse equals the serial reader and snap_tpu's
    parallel parse; the ranges are snap_tpu's and tile the file."""
    from snap_tpu.io.range_split import (
        parallel_read_batches as jparallel,
        split_fastq_ranges as jsplit,
    )

    rng = np.random.default_rng(threads)
    fq = tmp_path / "r.fq"
    _write_fastq(str(fq), 257, rng)
    ranges = split_fastq_ranges(str(fq), threads)
    assert ranges == jsplit(str(fq), threads)
    assert ranges[0][0] == 0 and ranges[-1][1] == fq.stat().st_size
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    want = _drain(read_batches(str(fq), batch_size=64, max_len=128))
    got = _drain(parallel_read_batches(str(fq), batch_size=64, max_len=128, threads=threads))
    assert got == want
    assert got == _drain(jparallel(str(fq), batch_size=64, max_len=128, threads=threads))


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
@pytest.mark.parametrize("threads", [3, 5])
def test_rebatch_gives_serial_batches(tmp_path, threads):
    """The aligner re-cuts the ranges' batches (each range ends in a
    short one) into the serial reader's: the same reads in the same
    batches, so -t N aligns the batches -t 1 aligns."""
    from snap_tpu_torch.align.single import _rebatch

    rng = np.random.default_rng(threads + 10)
    fq = tmp_path / "r.fq"
    _write_fastq(str(fq), 301, rng)
    serial = list(read_batches(str(fq), batch_size=64, max_len=128))
    raw = list(parallel_read_batches(str(fq), batch_size=64, max_len=128, threads=threads))
    assert [len(b) for b in raw] != [len(b) for b in serial]
    got = list(_rebatch(iter(raw), 64))
    assert [len(b) for b in got] == [len(b) for b in serial] == [64] * 4 + [45]
    for g, w in zip(got, serial):
        assert list(g.ids) == list(w.ids)
        for f in ("bases", "quals", "lengths"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
def test_boundary_snapping_on_at_quality(tmp_path):
    """A cut inside a record whose quality starts with '@' makes no
    phantom record, for every thread count."""
    rng = np.random.default_rng(0)
    fq = tmp_path / "r.fq"
    _write_fastq(str(fq), 40, rng)
    for n in range(2, 9):
        ids, _ = _drain(parallel_read_batches(str(fq), batch_size=7, max_len=128, threads=n))
        assert len(ids) == 40, n


@pytest.fixture(scope="module")
def threaded_runs(same_logq, tmp_path_factory):
    dirs = {}
    branches = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"threads_{side}")
        write_inputs(str(d), "random", 128)
        run(d, ["index", "g.fa", "idx", "-s", "20"])
        for t in (1, 3):
            br = run(d, ["single", "idx", "r.fq", "-o", f"t{t}.sam", "-b", "128", "-t", str(t)])
            if side == "torch":
                branches[t] = br
        dirs[side] = d
    return dirs, branches


def test_single_t3_matches_snap_tpu(threaded_runs):
    """On these 128 reads no batch-level path turns on the ranges'
    batches, so the port's -t 3 equals snap_tpu's."""
    dirs, _ = threaded_runs
    assert (dirs["torch"] / "t3.sam").read_bytes() == (dirs["jax"] / "t3.sam").read_bytes()


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
def test_single_t3_matches_t1(threaded_runs):
    """-t 3 gives -t 1's records, and the branches name each reader."""
    dirs, branches = threaded_runs
    body = lambda p: [ln for ln in p.read_bytes().split(b"\n") if not ln.startswith(b"@PG")]
    assert body(dirs["torch"] / "t3.sam") == body(dirs["torch"] / "t1.sam")
    assert branches[1].get("reader_serial") == 128 and "reader_range_split" not in branches[1]
    assert branches[3].get("reader_range_split") == 128 and "reader_serial" not in branches[3]


def _write_repeat_inputs(directory, n, seed=3):
    """g.fa: one 20 kbp random contig holding eight copies (1% diverged)
    of a 300 bp element; r.fq: n 100 bp reads from inside the copies,
    each with a 2 bp deletion at its middle, so each has four or more
    candidates that all need the DP."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    elem = rng.integers(0, 4, 300).astype(np.uint8)
    starts = 1000 + 2200 * np.arange(8)
    for p in starts:
        u = elem.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        codes[p : p + 300] = u
    dec = np.frombuffer(b"ACGT", np.uint8)
    with open(directory / "g.fa", "wb") as f:
        f.write(b">c1\n" + dec[codes].tobytes() + b"\n")
    with open(directory / "r.fq", "wb") as f:
        for i in range(n):
            s = int(starts[i % 8] + rng.integers(0, 190))
            r = np.delete(codes[s : s + 102], [50, 51])
            q = rng.choice(np.frombuffer(b"5?II", np.uint8), 100)
            f.write(b"@q%d_%d\n%s\n+\n%s\n" % (i, s, dec[r].tobytes(), q.tobytes()))


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
def test_t3_keeps_t1_dp_overflow(tmp_path, monkeypatch):
    """A case where the range split changes a batch-level path: 160
    repeat reads at -b 160 need more DP rows than phase A's tier holds
    (512) in -t 1's one batch, and fewer in each of the three ranges'
    batches. -t 3 re-cut into -t 1's batch takes the same dp_overflow
    redo and writes -t 1's SAM; aligned as the ranges cut them (as
    snap_tpu aligns them), no batch overflows."""
    import snap_tpu_torch.align.single as single

    _write_repeat_inputs(tmp_path, 160)
    run_torch(tmp_path, ["index", "g.fa", "idx", "-s", "20"])
    argv = ["single", "idx", "r.fq", "-b", "160", "-t"]
    t1 = run_torch(tmp_path, argv + ["1", "-o", "t1.sam"])
    t3 = run_torch(tmp_path, argv + ["3", "-o", "t3.sam"])
    monkeypatch.setattr(single, "_rebatch", lambda source, batch_size: source)
    ranges = run_torch(tmp_path, argv + ["3", "-o", "ranges.sam"])
    assert t1.get("dp_overflow") == t3.get("dp_overflow") == 160, (t1, t3)
    assert t3["batches"] == 1 and ranges["batches"] == 3, (t3, ranges)
    assert "dp_overflow" not in ranges, ranges
    body = lambda p: [ln for ln in p.read_bytes().split(b"\n") if not ln.startswith(b"@PG")]
    assert body(tmp_path / "t3.sam") == body(tmp_path / "t1.sam")
