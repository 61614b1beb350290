"""The DP tier's demand in the traced window: the largest, over the
window's batches and the device step's phases, of the rows a phase
needed over the rows its tier held (the port's dp_need_<phase> and
dp_rows_<phase> counts on each batch's finalize.unpack span). Above 1
a batch overflowed its tier and took the two-phase path
(redo.dp_overflow)."""

from snapbench.tiers import demand, tier_counts


def read(record):
    counts = tier_counts(record)
    return None if counts is None else max(demand(c) for c in counts)
