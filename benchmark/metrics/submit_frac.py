"""Share of the traced window in which the host padded, uploaded and
dispatched a batch's device step (the port's single.submit spans)."""

from snapbench.stages import share


def read(record):
    return share(record, lambda n: n == "single.submit")
