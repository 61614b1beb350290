"""The port's own stage spans in a traced window, and the shares of the
window the per-layer stage metrics read (benchmark/metrics/*_frac.py).

The port records its spans in snap_tpu_torch.stats.RECORDER while it is
enabled and while torch.profiler collects in the process, as it does
over a traced run's window on the card. A span is (name, start_ns,
end_ns, parent, batch, counts) on the clock of the benchmark's own spans
and of the device intervals (time.time_ns). The stages of the
single-end loop tile it: single.read_wait, single.submit,
single.finalize (with finalize.*, redo.* and two_phase.* inside) and
single.emit (with emit.* and write.queue_wait inside). The idle gaps
named by program stage are trace.breakdown's over the record's spans
and these together.
"""

from __future__ import annotations

import heapq

from .trace import union_ns


def program_spans(record: dict):
    """The port's spans that overlap the window: the record's
    `program_spans` where it holds them, else those the port's recorder
    holds now; None where there are none (an untraced run, a run on the
    CPU, or a port without the recorder)."""
    spans = record.get("program_spans")
    if spans is None and "window_ns" in record:
        try:
            from snap_tpu_torch.stats import RECORDER
        except ImportError:
            return None
        t0, t1 = record["window_ns"]
        spans = [list(s) for s in RECORDER.spans() if s[2] > t0 and s[1] < t1]
    return spans or None


def _clipped(spans, t0: int, t1: int, keep):
    return [(max(s[1], t0), min(s[2], t1)) for s in spans
            if keep(s[0]) and s[2] > t0 and s[1] < t1]


def share(record: dict, keep, less=None):
    """The window's share inside the union of the program's spans whose
    name `keep` accepts, less the part inside those `less` accepts; 0.0
    where the window has program spans but none of these, None where it
    has none."""
    spans = program_spans(record)
    t0, t1 = record["window_ns"]
    if spans is None or t1 <= t0:
        return None
    a = _clipped(spans, t0, t1, keep)
    if less is None:
        return union_ns(a) / (t1 - t0)
    b = _clipped(spans, t0, t1, less)
    return (union_ns(a + b) - union_ns(b)) / (t1 - t0)


def is_redo(name: str) -> bool:
    return name.startswith("redo.")


def idle_intervals(record: dict) -> list[tuple[int, int]]:
    """The window's intervals in which no operation ran on the card."""
    t0, t1 = record["window_ns"]
    gaps, last = [], t0
    for s, e in sorted((s, e) for _, s, e, *_ in record.get("device_ops", [])):
        if s > last:
            gaps.append((last, min(s, t1)))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    return gaps


def self_seconds(record: dict, within=None) -> dict:
    """Seconds of the window, or of its disjoint intervals `within`, by
    the innermost program span open there: each stage's self time."""
    t0, t1 = record["window_ns"]
    spans = sorted((max(sp[1], t0), min(sp[2], t1), sp[0])
                   for sp in program_spans(record) or [] if sp[2] > t0 and sp[1] < t1)
    inside = sorted(within) if within is not None else [(t0, t1)]
    cuts = sorted({t for s, e, _ in spans for t in (s, e)}
                  | {t for a, b in inside for t in (a, b)})
    out: dict[str, float] = {}
    open_: list = []   # max-heap on start: the innermost span on top
    i = j = 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= a:
            heapq.heappush(open_, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        while j < len(inside) and inside[j][1] <= a:
            j += 1
        if j < len(inside) and inside[j][0] <= a:
            name = open_[0][2] if open_ else "outside the program's spans"
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def idle_coverage(record: dict):
    """The share of the card's idle time in the window that falls inside
    a program span; None without program spans or a device trace."""
    spans = program_spans(record)
    if spans is None or not record.get("device_ops"):
        return None
    idle = idle_intervals(record)
    total = sum(b - a for a, b in idle)
    t0, t1 = record["window_ns"]
    cover = _clipped(spans, t0, t1, lambda n: True)
    covered = union_ns(idle) + union_ns(cover) - union_ns(idle + cover)
    return covered / total if total else None
