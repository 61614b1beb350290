"""Share of the traced window in which the host waited for the card to
finish a batch's step and copy its packed winners back (the port's
finalize.winners_wait spans)."""

from snapbench.stages import share


def read(record):
    return share(record, lambda n: n == "finalize.winners_wait")
