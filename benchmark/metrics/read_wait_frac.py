"""Share of the traced window in which the single-end loop waited for
its next batch of reads (the port's single.read_wait spans)."""

from snapbench.stages import share


def read(record):
    return share(record, lambda n: n == "single.read_wait")
