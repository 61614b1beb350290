"""Global constants: base encoding, defaults, scoring parameters.

Behavioral reference: SNAP's Tables.h:14-64 (base<->2-bit code tables),
GenomeIndex.cpp:46 (default seed size 24), AlignerOptions.cpp:107-117
(aligner defaults), BaseAligner.h:368-370 (probability model constants),
LandauVishkin.cpp initializeLVProbabilitiesToPhredPlus33 (phred tables).
"""

import numpy as np

# ---------------------------------------------------------------------------
# Base encoding. 0..3 = A,C,G,T; 4 = N / invalid / pad.
# The complement of code b (b < 4) is 3 - b, so A<->T, C<->G.
# ---------------------------------------------------------------------------
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

# ASCII -> code. Uppercase and lowercase both map, EXCEPT that lowercase 'n'
# is used by the genome loader for padding (ref: GenomeIndex.h:171 — padding
# is lowercase so read Ns never match pad Ns). At the array level we encode
# pad as a distinct code PAD=5 so pad never equals read N (4).
PAD = 5

_enc = np.full(256, BASE_N, dtype=np.uint8)
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _enc[ord(ch)] = code
    _enc[ord(ch.lower())] = code
_enc[ord("n")] = PAD  # lowercase n = padding (never matches anything)
BASE_ENCODE = _enc

BASE_DECODE = np.frombuffer(b"ACGTNn", dtype=np.uint8)

# ---------------------------------------------------------------------------
# Index defaults (ref: GenomeIndex.cpp:46-56, 430-453)
# ---------------------------------------------------------------------------
DEFAULT_SEED_LEN = 24
DEFAULT_CONTIG_PADDING = 2000  # ref: GenomeIndex.cpp:48

# ---------------------------------------------------------------------------
# Aligner defaults (ref: AlignerOptions.cpp:107-117, PairedAligner.cpp:55-56)
# ---------------------------------------------------------------------------
DEFAULT_MAX_DIST = 27            # -d
DEFAULT_MAX_DIST_INDELS = 40     # -i
DEFAULT_NUM_SEEDS_SINGLE = 25    # -n single
DEFAULT_NUM_SEEDS_PAIRED = 8     # -n paired
DEFAULT_MAX_HITS = 300           # -h
DEFAULT_MAX_BIG_HITS_PAIRED = 4000
DEFAULT_EXTRA_SEARCH_DEPTH = 1   # -D
DEFAULT_MIN_READ_LENGTH = 50     # -mrl, ref: Read.cpp:53
DEFAULT_MIN_SPACING = 0          # paired -s
DEFAULT_MAX_SPACING = 1000
MAX_MERGE_DIST = 48              # single-end candidate bin width, ref: BaseAligner.h:177
PAIRED_FUZZY_WINDOW = 31         # ref: IntersectingPairedEndAligner.cpp:3990
PAIRED_MERGE_ANCHOR_DIST = 50    # ref: IntersectingPairedEndAligner.h:535-539
MAX_K = 127                      # ref: LandauVishkin.h:8-12

# MAPQ (ref: mapq.h:32-68)
MAPQ_MAX = 70
MAPQ_LIMIT_FOR_SINGLE_HIT = 10   # ref: AlignerOptions.h:49

# Probability model (ref: BaseAligner.h:368-370)
SNP_PROB = 0.001
GAP_OPEN_PROB = 0.001
GAP_EXTEND_PROB = 0.5

# Affine-gap scoring defaults — CLI defaults from AlignerOptions.cpp:79-81:
# match 1, mismatch 4, gap open 6, gap extend 1, 5' end bonus 10, 3' bonus 7.
AG_MATCH = 1
AG_MISMATCH = 4
AG_GAP_OPEN = 6
AG_GAP_EXTEND = 1
AG_END_BONUS_5 = 10
AG_END_BONUS_3 = 7

# LV -> affine-gap escalation threshold: gapOpen / (sub - gapExtend)
# (ref: BaseAligner.cpp:1148)
def max_k_for_same_alignment() -> int:
    return AG_GAP_OPEN // (AG_MISMATCH - AG_GAP_EXTEND)


# ---------------------------------------------------------------------------
# LV probability tables, mirrored from the reference's semantics
# (LandauVishkin.cpp:727-760). We keep them as float64 numpy host tables;
# the device kernels work in log space float32.
# ---------------------------------------------------------------------------
def phred_to_probability_table() -> np.ndarray:
    """P(base is wrong) indexed by raw phred+33 byte value."""
    t = np.full(256, SNP_PROB, dtype=np.float64)
    i = np.arange(33, 127)
    t[i] = 1.0 - (1.0 - np.power(10.0, -(i - 33) / 10.0)) * (1.0 - SNP_PROB)
    return t


def indel_probability_table(max_indels: int = 1024) -> np.ndarray:
    """P(an indel run of length i), i >= 1. [0] = 1.0 sentinel."""
    t = np.empty(max_indels + 1, dtype=np.float64)
    t[0] = 1.0
    t[1] = GAP_OPEN_PROB
    for i in range(2, max_indels + 1):
        t[i] = t[i - 1] * GAP_EXTEND_PROB
    return t


def perfect_match_probability_table(max_read_len: int = 20000) -> np.ndarray:
    """(1 - SNP_PROB)^n prior for n matching bases."""
    n = np.arange(max_read_len + 1)
    return np.power(1.0 - SNP_PROB, n)
