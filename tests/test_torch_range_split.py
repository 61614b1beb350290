"""The port's -t N FASTQ reader (io/range_split.py): twin of
tests/test_range_split.py, and `single -t 3` through the CLI.

The parallel parse over record-aligned byte ranges reproduces the
single reader's stream exactly, in order (records straddling range
boundaries, quality strings starting with '@' or '+'), with snap_tpu's
ranges and batches. Every range ends in a short batch, and the aligner
takes the ranges' batches as they come, as snap_tpu's does: a batch's
make-up decides its batch-level paths (the DP tier's overflow, phase
B's and C's row caps), so the port's `-t 3` writes snap_tpu's `-t 3`
SAM bytes, and `-t 1`'s records only where no such path turns (it does
not on the 128 reads here, and does on the repeat reads of
test_t3_keeps_t1_dp_overflow). The aligner's branches name the reader
that parsed the reads.
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
def test_boundary_snapping_on_at_quality(tmp_path):
    """A cut inside a record whose quality starts with '@' makes no
    phantom record, for every thread count."""
    rng = np.random.default_rng(0)
    fq = tmp_path / "r.fq"
    _write_fastq(str(fq), 40, rng)
    for n in range(2, 9):
        ids, _ = _drain(parallel_read_batches(str(fq), batch_size=7, max_len=128, threads=n))
        assert len(ids) == 40, n


def _run_counted(side, directory, argv):
    """One CLI run of `side` ("jax" or "torch"); returns the sizes of the
    batches its aligner received (SingleEndAligner._submit), the reads
    its fast path sent down the dp_overflow redo, and (the port) its
    branch counts."""
    import snap_tpu.align.pipeline as jpipeline
    import snap_tpu.align.single as jsingle
    import snap_tpu_torch.align.single as tsingle

    mod = jsingle if side == "jax" else tsingle
    sizes, flags = [], []
    submit = mod.SingleEndAligner._submit

    def counted(self, batch):
        sizes.append(len(batch))
        return submit(self, batch)

    class Winners(jpipeline.HostWinners):
        def __init__(self, packed):
            super().__init__(packed)
            flags.append(self.dp_overflow)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.SingleEndAligner, "_submit", counted)
        if side == "jax":
            mp.setattr(jpipeline, "HostWinners", Winners)
            run_jax(directory, argv)
            # one HostWinners per fast-path batch, in submit order
            overflow = sum(n for n, f in zip(sizes, flags) if f)
            return {"sizes": sizes, "dp_overflow": overflow, "branches": {}}
        br = run_torch(directory, argv)
    return {"sizes": sizes, "dp_overflow": br.get("dp_overflow", 0), "branches": br}


@pytest.fixture(scope="module")
def threaded_runs(same_logq, tmp_path_factory):
    dirs = {}
    runs = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"threads_{side}")
        write_inputs(str(d), "random", 128)
        (run_jax if side == "jax" else run_torch)(d, ["index", "g.fa", "idx", "-s", "20"])
        for t in (1, 3):
            runs[side, t] = _run_counted(
                side, d, ["single", "idx", "r.fq", "-o", f"t{t}.sam", "-b", "128", "-t", str(t)])
        dirs[side] = d
    return dirs, {t: runs["torch", t]["branches"] for t in (1, 3)}, runs


def test_single_t3_matches_snap_tpu(threaded_runs):
    """On these 128 reads no batch-level path turns on the ranges'
    batches, so the port's -t 3 equals snap_tpu's."""
    dirs, _, _ = threaded_runs
    assert (dirs["torch"] / "t3.sam").read_bytes() == (dirs["jax"] / "t3.sam").read_bytes()


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
def test_single_t3_matches_t1(threaded_runs):
    """-t 3 gives -t 1's records, and the branches name each reader."""
    dirs, branches, _ = threaded_runs
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


@pytest.fixture(scope="module")
def repeat_runs(same_logq, tmp_path_factory):
    """Both CLIs on the repeat inputs: 160 reads at -b 160, -t 1 and
    -t 3."""
    dirs, runs = {}, {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"repeat_{side}")
        _write_repeat_inputs(d, 160)
        (run_jax if side == "jax" else run_torch)(d, ["index", "g.fa", "idx", "-s", "20"])
        for t in (1, 3):
            runs[side, t] = _run_counted(
                side, d, ["single", "idx", "r.fq", "-b", "160", "-t", str(t), "-o", f"t{t}.sam"])
        dirs[side] = d
    return dirs, runs


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
def test_t3_keeps_t1_dp_overflow(repeat_runs):
    """A case where the range split changes a batch-level path: 160
    repeat reads at -b 160 need more DP rows than phase A's tier holds
    (512) in -t 1's one batch, and fewer in each of the three ranges'
    batches. -t 1 sends all 160 reads down the dp_overflow redo in both
    packages; -t 3 aligns the ranges' batches as they come, in both, so
    no batch overflows and the port writes snap_tpu's -t 3 SAM byte for
    byte."""
    dirs, runs = repeat_runs
    for side in ("jax", "torch"):
        assert runs[side, 1]["dp_overflow"] == 160, (side, runs[side, 1])
        assert runs[side, 3]["dp_overflow"] == 0, (side, runs[side, 3])
    assert runs["torch", 1]["branches"]["batches"] == 1
    assert runs["torch", 3]["branches"]["batches"] == 3
    assert (dirs["torch"] / "t3.sam").read_bytes() == (dirs["jax"] / "t3.sam").read_bytes()
    assert (dirs["torch"] / "t1.sam").read_bytes() == (dirs["jax"] / "t1.sam").read_bytes()


@pytest.mark.skipif(not native_io.available(), reason="native runtime absent")
@pytest.mark.parametrize("case", ["random", "repeat"])
def test_range_batches_as_snap_tpu(case, request):
    """The -t 3 aligner receives the range reader's batches as they
    come (each range ends in a short one), the batches snap_tpu's -t 3
    aligner receives; -t 1's are the serial reader's."""
    runs = (request.getfixturevalue("threaded_runs")[2] if case == "random"
            else request.getfixturevalue("repeat_runs")[1])
    n, b = (128, 128) if case == "random" else (160, 160)
    assert runs["torch", 3]["sizes"] == runs["jax", 3]["sizes"]
    assert runs["torch", 1]["sizes"] == runs["jax", 1]["sizes"] == [b]
    assert sum(runs["torch", 3]["sizes"]) == n and len(runs["torch", 3]["sizes"]) == 3
