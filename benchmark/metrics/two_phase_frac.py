"""Share of the traced window in the two-phase path's host part: the
port's redo.dp_overflow spans less their device re-run
(two_phase.tier1). 0.0 where no batch overflowed its DP tier; None
where the window holds no DP-tier counts (a port that does not give
them)."""

from snapbench.stages import share
from snapbench.tiers import tier_counts


def read(record):
    if tier_counts(record) is None:
        return None
    return share(record, lambda n: n == "redo.dp_overflow",
                 less=lambda n: n == "two_phase.tier1")
