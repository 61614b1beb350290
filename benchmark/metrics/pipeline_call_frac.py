"""Share of the window's wall time inside the host's outermost calls
into align/pipeline.py (the benchmark's `pipeline.*` spans)."""

from snapbench.trace import union_ns


def read(record):
    t0, t1 = record["window_ns"]
    spans = [(s, e) for n, s, e in record["spans"] if n.startswith("pipeline.")]
    if not spans or t1 <= t0:
        return None
    return union_ns((max(s, t0), min(e, t1)) for s, e in spans) / (t1 - t0)
