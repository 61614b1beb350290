"""The DP tier's counts of a traced window: the port gives each batch's
first finalize.unpack span the rows each phase of the device step needed
(dp_need_<phase>) and held (dp_rows_<phase>), phases a, b and, where
it ran, c; the metrics dp_tier_demand, tier1_frac and two_phase_frac
read them."""

from __future__ import annotations

from .stages import program_spans


def tier_counts(record: dict):
    """The counts of the window's batches, one dict each; None where no
    span holds them (an untraced run, or a port without them)."""
    spans = program_spans(record)
    if spans is None:
        return None
    out = [s[5] for s in spans if s[0] == "finalize.unpack" and "dp_rows_a" in s[5]]
    return out or None


def demand(counts: dict) -> float:
    """The largest over a batch's phases of rows needed over rows held."""
    return max(counts["dp_need_" + k[len("dp_rows_"):]] / v
               for k, v in counts.items() if k.startswith("dp_rows_"))
