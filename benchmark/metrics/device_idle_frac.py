"""Share of the traced window in which no operation ran on the card:
1 - (union of torch.profiler's device intervals) / window."""

from snapbench.trace import union_ns


def read(record):
    t0, t1 = record["window_ns"]
    ops = record.get("device_ops", [])
    if not ops or t1 <= t0:
        return None
    return 1.0 - union_ns((s, e) for _, s, e in ops) / (t1 - t0)
