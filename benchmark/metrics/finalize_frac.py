"""Share of the traced window in the fast finalize of a batch on the
host: the port's single.finalize spans less their winners wait
(finalize.winners_wait) and their slow paths (redo.*)."""

from snapbench.stages import is_redo, share


def read(record):
    return share(record, lambda n: n == "single.finalize",
                 less=lambda n: n == "finalize.winners_wait" or is_redo(n))
