"""Output filtering and shared aligner option structures.

Behavioral reference: SNAP's AlignerOptions::FilterFlags / passFilter
(AlignerOptions.h:174-183, AlignerOptions.cpp passFilter): -F a|s|u|l
select preset flag sets, -E smxub composes them; too-short reads pass
only under FilterTooShort; low-MAPQ secondary alignments always pass a
FilterSingleHit filter.
"""

from __future__ import annotations

FILTER_UNALIGNED = 0x0001
FILTER_SINGLE_HIT = 0x0002
FILTER_MULTIPLE_HITS = 0x0004
FILTER_BOTH_MATES_MATCH = 0x0008
FILTER_TOO_SHORT = 0x0010

# -F presets (AlignerOptions.cpp:516-548)
FILTER_PRESETS = {
    "a": FILTER_SINGLE_HIT | FILTER_MULTIPLE_HITS | FILTER_TOO_SHORT,
    "s": FILTER_SINGLE_HIT | FILTER_TOO_SHORT,
    "u": FILTER_UNALIGNED | FILTER_TOO_SHORT,
    "l": FILTER_SINGLE_HIT | FILTER_MULTIPLE_HITS | FILTER_UNALIGNED,
}

# -E characters (AlignerOptions.cpp:558-566)
FILTER_CHARS = {
    "s": FILTER_SINGLE_HIT,
    "m": FILTER_MULTIPLE_HITS,
    "x": FILTER_TOO_SHORT,
    "u": FILTER_UNALIGNED,
    "b": FILTER_BOTH_MATES_MATCH,
}


def pass_filter(
    filter_flags: int,
    status: str,
    too_short: bool = False,
    secondary: bool = False,
) -> bool:
    """Mirror of AlignerOptions::passFilter. status is our driver-side
    'single' | 'multi' | 'notfound' | 'filtered' string."""
    if filter_flags == 0:
        return True
    if too_short or status == "filtered":
        return (filter_flags & FILTER_TOO_SHORT) != 0
    if status == "multi" and secondary and (filter_flags & FILTER_SINGLE_HIT):
        # don't filter out secondary alignments for low MAPQ
        return True
    if status == "notfound":
        return (filter_flags & FILTER_UNALIGNED) != 0
    if status == "single":
        return (filter_flags & FILTER_SINGLE_HIT) != 0
    if status == "multi":
        return (filter_flags & FILTER_MULTIPLE_HITS) != 0
    return False
