"""Share of the traced window in which the single-end loop wrote a
batch's SAM records: formatting and the writer's queue (the port's
single.emit spans)."""

from snapbench.stages import share


def read(record):
    return share(record, lambda n: n == "single.emit")
