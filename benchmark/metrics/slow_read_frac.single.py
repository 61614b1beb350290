"""Reads of a single-end window that left the fast finalize, over the
window's reads: SingleEndAligner.branches redo_truncated (the wide redo
of truncated reads), redo_edge_indel, fallback (the device fallback
rows) and two_phase (the host-gated path, which every read of a
DP-tier overflow batch takes). A read counted in two of them counts
twice."""

SLOW = ("redo_truncated", "redo_edge_indel", "fallback", "two_phase")


def read(record):
    if record["mode"] != "single" or not record["reads"]:
        return None
    b = record["branches"]
    return sum(b.get(k, 0) for k in SLOW) / record["reads"]
