"""Run statistics and the end-of-run table.

Behavioral reference: SNAP's AlignerStats (AlignerStats.h:43-66) and
AlignerContext::printStats (AlignerContext.cpp:488-573): Total Reads,
Aligned MAPQ>=10 / MAPQ<10, Unaligned, Too Short/Too Many Ns, optional
Filtered and Extra Alignments columns, %Pairs for paired runs, Reads/s,
Time in Aligner, and optional -pro %Read/%Align/%Write columns; the -pf
perf-file rows mirror AlignerContext.cpp:554-573.

Also the stage spans of the align loops (`RECORDER`), whose durations
are AlignerStats' seconds.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch.autograd.profiler as _torch_profiler


def _commas(n: int) -> str:
    return f"{int(n):,}"


def _num_pct(n: int, total: int) -> str:
    return f"{_commas(n)} ({100.0 * n / max(1, total):.2f}%)"


@dataclass
class AlignerStats:
    """Mirrors the reference's end-of-run table (AlignerStats.h:43-66)."""

    total: int = 0
    single: int = 0       # MAPQ >= 10
    multi: int = 0        # MAPQ < 10
    not_found: int = 0
    too_short: int = 0
    filtered: int = 0             # dropped by -F/-E output filters
    extra_alignments: int = 0     # secondary/supplementary records emitted
    aligned_as_pairs: int = 0
    lv_calls: int = 0
    affine_gap_calls: int = 0
    # -proAg counters (AlignerStats.h:62-63): pairs where the chimeric
    # aligner was forced into a single-end comparison by affine-gap
    # suspicion, and pairs where that single-end result won
    ag_forced_single: int = 0
    ag_used_single: int = 0
    # device-intersection health (VERDICT r4 #4): pairs whose device
    # phases 1-2 overflowed (gather cap / compaction cut) and were
    # redone by the exact host intersection, and pairs that declined
    # the vectorized finalize plan into the per-pair Python path
    intersect_overflow_pairs: int = 0
    intersect_wide_pairs: int = 0    # redone on-device at HP=512/C=256
    paired_slow_rows: int = 0
    paired_planned_rows: int = 0
    seconds_reading: float = 0.0
    seconds_aligning: float = 0.0
    seconds_writing: float = 0.0
    align_seconds: float = 0.0    # wall time of the whole align loop
    is_paired: bool = False
    profile: bool = False
    profile_ag: bool = False      # -proAg (AlignerContext.cpp:547-549)
    mapq_histogram: np.ndarray = field(
        default_factory=lambda: np.zeros(71, dtype=np.int64)
    )

    def add(self, other: "AlignerStats") -> None:
        """Sum per-worker stats (AlignerContext::finishThread reduction)."""
        for f in (
            "total", "single", "multi", "not_found", "too_short",
            "filtered", "extra_alignments", "aligned_as_pairs",
            "lv_calls", "affine_gap_calls",
            "ag_forced_single", "ag_used_single",
            "intersect_overflow_pairs", "intersect_wide_pairs",
            "paired_slow_rows", "paired_planned_rows",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in (
            "seconds_reading", "seconds_aligning", "seconds_writing",
            "align_seconds",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.mapq_histogram += other.mapq_histogram

    def print_table(self, out=sys.stderr) -> None:
        rs = self.total / self.align_seconds if self.align_seconds else 0
        header = [
            "Total Reads", "Aligned, MAPQ >= 10", "Aligned, MAPQ < 10",
            "Unaligned", "Too Short/Too Many Ns",
        ]
        row = [
            _commas(self.total),
            _num_pct(self.single, self.total),
            _num_pct(self.multi, self.total),
            _num_pct(self.not_found, self.total),
            _num_pct(self.too_short, self.total),
        ]
        if self.filtered > 0:
            header.append("Filtered")
            row.append(_num_pct(self.filtered, self.total))
        if self.extra_alignments > 0:
            header.append("Extra Alignments")
            row.append(_commas(self.extra_alignments))
        if self.is_paired:
            header.append("%Pairs")
            row.append(
                f"{100.0 * self.aligned_as_pairs / max(1, self.total):0.2f}%"
            )
        header += ["Reads/s", "Time in Aligner (s)"]
        row += [_commas(int(rs)), _commas(int(self.align_seconds + 0.5))]
        if self.profile:
            t = max(
                1e-9,
                self.seconds_reading + self.seconds_aligning
                + self.seconds_writing,
            )
            header += ["%Read", "%Align", "%Write"]
            row += [
                f"{100.0 * self.seconds_reading / t:.0f}%",
                f"{100.0 * self.seconds_aligning / t:.0f}%",
                f"{100.0 * self.seconds_writing / t:.0f}%",
            ]
            if self.is_paired:
                # device-intersection health: fraction of pairs redone
                # on the host (overflow) and fraction taking the
                # per-pair Python finalize instead of the plan
                pairs = max(1, self.total // 2)
                slow_base = max(
                    1, self.paired_slow_rows + self.paired_planned_rows
                )
                header += ["%IsectOverflow", "%SlowFinalize"]
                row += [
                    f"{100.0 * self.intersect_overflow_pairs / pairs:0.2f}%",
                    f"{100.0 * self.paired_slow_rows / slow_base:0.2f}%",
                ]
        if self.profile_ag:
            # AlignerContext.cpp:547-549: paired runs additionally show
            # how often affine-gap suspicion forced (and won) the
            # single-end comparison; AG/Edit = AG calls per LV call
            if self.is_paired:
                header += ["%AgSingle", "%AgUsedSingle"]
                row += [
                    f"{100.0 * self.ag_forced_single / max(1, self.total):0.2f}%",
                    f"{100.0 * self.ag_used_single / max(1, self.total):0.2f}%",
                ]
            header.append("AG/Edit")
            row.append(
                f"{100.0 * self.affine_gap_calls / max(1, self.lv_calls):0.2f}%"
            )
        print("\t".join(header), file=out)
        print("\t".join(row), file=out)

    def write_perf_file(
        self, path: str, max_hits: int, max_dist: int
    ) -> None:
        """-pf: append the machine-readable row
        (AlignerContext.cpp:554-573)."""
        total = max(1, self.total)
        rs = (
            (self.total - self.too_short) / self.align_seconds
            if self.align_seconds
            else 0
        )
        with open(path, "a") as f:
            f.write(
                "maxHits\tmaxDist\t% reads not useless\t% reads single hit\t"
                "% reads multi hit\t% reads not found\tLV calls\t"
                "affine gap calls\t% aligned as pairs\ttotal reads\treads/s\n"
            )
            f.write(
                f"{max_hits}\t{max_dist}\t"
                f"{100.0 * (self.total - self.too_short) / total:0.2f}%\t"
                f"{100.0 * self.single / total:0.2f}%\t"
                f"{100.0 * self.multi / total:0.2f}%\t"
                f"{100.0 * self.not_found / total:0.2f}%\t"
                f"{_commas(self.lv_calls)}\t"
                f"{_commas(self.affine_gap_calls)}\t"
                f"{100.0 * self.aligned_as_pairs / total:0.2f}%\t"
                f"{_commas(self.total)}\t{_commas(int(rs))}\n\n"
            )


class Span:
    """One stage of an align loop; a `with` block. Its clock pair always
    runs (`seconds` after the block); it is recorded when its recorder
    was on as it began."""

    __slots__ = ("_rec", "name", "batch", "counts", "parent", "start_ns",
                 "end_ns", "_kept", "_range")

    def __init__(self, rec: "Recorder", name: str, batch, counts: dict):
        self._rec, self.name, self.batch, self.counts = rec, name, batch, counts
        self.parent = self._range = None
        self.start_ns = self.end_ns = 0

    def count(self, **counts) -> None:
        """Set work counts known only inside the block."""
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        rec = self._rec
        self._kept = rec.on
        if self._kept:
            stack = rec._stack()
            if stack:
                self.parent = stack[-1].name
                if self.batch is None:
                    self.batch = stack[-1].batch
            stack.append(self)
            if rec.ranges:
                self._range = _torch_profiler.record_function(self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._kept:
            rec = self._rec
            if self._range is not None:
                self._range.__exit__(None, None, None)
            rec._stack().pop()
            rec._spans.append((self.name, self.start_ns, self.end_ns,
                               self.parent, self.batch, self.counts))
        return False


class _Off:
    """The span of a recorder that is off: no clock read, nothing kept."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class Recorder:
    """Stage spans on the Unix clock in nanoseconds (time.time_ns, the
    clock torch.profiler puts its device events on). A recorded span is
    (name, start_ns, end_ns, parent, batch, counts): the name of the span
    open on the same thread as it began (None at the top), the align
    loop's batch number (given, else the parent's), and the work counts
    at that boundary. Spans stay in memory until drain().

    The recorder is on while enable()d and while a torch.profiler session
    collects in this process (the benchmark's traced window starts one),
    so any profiled run of the align loops records its spans; read them
    with drain(). With `ranges` set (the CLI's -trace) each span also
    opens a torch.profiler record_function range, so the stages sit
    beside the kernels in the profiler's trace."""

    def __init__(self):
        self.enabled = False
        self.ranges = False
        self._spans: list[tuple] = []
        self._local = threading.local()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    @property
    def on(self) -> bool:
        # torch keeps this flag private: a torch without it records only
        # while enable()d
        return self.enabled or getattr(_torch_profiler, "_is_profiler_enabled", False)

    def drain(self) -> list[tuple]:
        """The recorded spans, in the order they ended; empties the list."""
        spans, self._spans = self._spans, []
        return spans

    def spans(self) -> list[tuple]:
        """The recorded spans so far, left in place."""
        return list(self._spans)

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, /, batch=None, **counts):
        """An inner stage: recorded when on, else the shared no-op span."""
        if not self.on:
            return _OFF
        return Span(self, name, batch, counts)

    def timed(self, name: str, /, batch=None, **counts) -> Span:
        """A loop-level stage, whose seconds feed AlignerStats: timed
        whether the recorder is on or not, recorded when on."""
        return Span(self, name, batch, counts)

    def tally(self, name: str, n: int = 1) -> None:
        """Add n to the count `name` of the innermost span open on this
        thread; nothing when off or when no span is open."""
        if not self.on:
            return
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


RECORDER = Recorder()


class ProgressReporter:
    """Status line every interval seconds
    (SingleAligner.cpp:206-210: 'Aligned %lld reads @ %lld reads/s')."""

    def __init__(self, interval: float = 10.0, out=sys.stderr):
        import time

        self.interval = interval
        self.out = out
        self.start = time.time()
        self.last = self.start
        self.count = 0

    def update(self, n: int) -> None:
        import time

        self.count += n
        now = time.time()
        if now - self.last >= self.interval:
            rate = self.count / max(1e-9, now - self.start)
            print(
                f"Aligned {self.count:,} reads @ {int(rate):,} reads/s",
                file=self.out,
            )
            self.last = now


def reduce_across_hosts(stats: "AlignerStats") -> "AlignerStats":
    """Multi-process stats reduction: sum counters across the processes
    of an initialised torch.distributed group.

    The reference sums per-thread AlignerStats in finishThread
    (AlignerContext.cpp:241-249); over several processes the analogue is
    an all_gather of each process's counters and MAPQ histogram. On an
    nccl group the tensors live on the rank's card. No-op in a single
    process.
    """
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return stats
    world = dist.get_world_size()
    if world <= 1:
        return stats
    fields = [
        "total", "single", "multi", "not_found", "too_short",
        "filtered", "extra_alignments", "aligned_as_pairs",
        "lv_calls", "affine_gap_calls",
        "ag_forced_single", "ag_used_single",
    ]
    dev = (
        torch.device("cuda", torch.cuda.current_device())
        if dist.get_backend() == "nccl" else torch.device("cpu")
    )

    def summed(vec: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(vec, dtype=np.int64)).to(dev)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.stack(parts).sum(dim=0).cpu().numpy()

    vec = np.array([getattr(stats, f) for f in fields], dtype=np.int64)
    for f, v in zip(fields, summed(vec).tolist()):
        setattr(stats, f, int(v))
    stats.mapq_histogram = summed(np.asarray(stats.mapq_histogram))
    return stats
