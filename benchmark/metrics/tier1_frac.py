"""Share of the traced window in the two-phase path's device re-run:
the port's two_phase.tier1 spans (align_tier1 inside redo.dp_overflow).
0.0 where no batch overflowed its DP tier; None where the window holds
no DP-tier counts (a port that does not give them)."""

from snapbench.stages import share
from snapbench.tiers import tier_counts


def read(record):
    if tier_counts(record) is None:
        return None
    return share(record, lambda n: n == "two_phase.tier1")
