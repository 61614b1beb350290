"""Share of the traced window in the single-end slow paths: the wide
redo of truncated and edge-indel reads and the DP-tier overflow redo
(the union of the port's redo.* spans, so a redo inside another counts
once)."""

from snapbench.stages import is_redo, share


def read(record):
    return share(record, is_redo)
