"""True paired-end fuzzy set intersection over full per-seed hit lists.

Behavioral reference: SNAP's IntersectingPairedEndAligner phases 1-2
(IntersectingPairedEndAligner.cpp:406-717) and the HashTableHitSet
iteration contract (.cpp:3516-3814, SURVEY Appendix B):

- up to maxSeeds lookups per end; probe order starts at 0 and advances
  by seedLen (stretched evenly when the remaining seeds would not reach
  the read end), then wrapped rounds at the SeedSequencer midpoints
  (.cpp:416-501);
- FULL per-seed hit lists are recorded (no gather cap); a (seed,
  direction) with nHits >= maxBigHits (default 4000) is skipped and
  counted toward the popular-seed MAPQ penalty (.cpp:480-489); a
  recorded lookup with 0 hits in a direction counts as a miss;
- candidate locations are read-start-normalized: hit - seedOffset
  forward, hit - (readLen - seedLen - seedOffset) for RC (.cpp:471-476);
- the lookups of one wrap pass form one DISJOINT HIT SET (their seeds
  share no read bases, beginsDisjointHitSet .cpp:414-421);
  bestPossibleScore(loc) = max over disjoint sets of the number of
  recorded lookups in the set with no hit within maxMergeDistance=31
  of loc (.cpp:3585-3625) — a lower bound on that end's edit distance;
- a pair candidate needs a mate hit on the other end, opposite
  direction, within [minSpacing, maxSpacing] (set pairs F/RC and RC/F,
  .cpp:530-717); candidates are prioritized by the pair-sum
  bestPossibleScore (.cpp:664-711).

TPU-first re-expression: instead of the sequential dual-cursor
descending walk with interleaved per-lookup binary searches, ALL rows'
hit lists are expanded once into a flat (row, dir, lookup,
normalized-loc) table, and every per-candidate query — fuzzy seed-match
counting, mate-window existence, mate bestPossibleScore range-min —
becomes a batched np.searchsorted over row-keyed sorted arrays (a
sparse min-table provides O(1) range minima). The output is a fixed
[rows, K] candidate tile (location, anchor offset, direction, weight)
that feeds the same device scoring wavefront as single-end alignment:
host work is O(total hits) vectorized numpy; the scoring FLOPs stay on
the TPU.

Known deviation: reads containing N skip those seeds without
re-spacing the probe sequence (the reference advances to the next
offset and keeps probing; .cpp:446-451), so N-bearing reads may probe
slightly different offsets. Hit-set semantics are otherwise identical.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..constants import (
    DEFAULT_MAX_SPACING,
    DEFAULT_MIN_SPACING,
    DEFAULT_NUM_SEEDS_PAIRED,
)
from .pipeline import snap_seed_wrap_order

MAX_BIG_HITS = 4000            # IntersectingPairedEndAligner.h:34
FUZZY_DIST = 31                # maxMergeDistance (.cpp:3990)
_INF16 = np.int32(1 << 14)
_NOPAIR_PENALTY = np.int64(1 << 10)
_LOC_BIAS = np.int64(4096)     # normalized locs can be slightly negative
_ROW_KEY = np.int64(1) << 36   # > genome size + bias; keys rows apart


@dataclass(frozen=True)
class IntersectParams:
    seed_len: int
    num_seeds: int = DEFAULT_NUM_SEEDS_PAIRED   # maxSeeds (-n paired)
    max_big_hits: int = MAX_BIG_HITS
    fuzzy_dist: int = FUZZY_DIST
    max_cand: int = 16
    min_spacing: int = DEFAULT_MIN_SPACING
    max_spacing: int = DEFAULT_MAX_SPACING
    max_k_indels: int = 0        # -i maxDistForIndels: phase-2a marks
                                 # candidates within this distance of
                                 # another candidate and raises their
                                 # score limits by the detected spread
                                 # (IntersectingPairedEndAligner.cpp:
                                 # 720-801); 0 disables detection


@functools.lru_cache(maxsize=512)
def intersect_seed_offsets(
    n_possible: int, seed_len: int, max_seeds: int
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The probe offset sequence and per-lookup disjoint-set ids.

    Mirrors the phase-1 loop (IntersectingPairedEndAligner.cpp:416-501)
    for an N-free read: offsets advance by seedLen (or stretched evenly
    when the remaining lookups would undershoot the read end); on
    running off the end, wrap to the SeedSequencer midpoint for that
    wrap count. Each wrap pass starts a new disjoint hit set.
    """
    if n_possible <= 0 or max_seeds <= 0:
        return (), ()
    wrap_of_residue = snap_seed_wrap_order(seed_len)
    # inverse: wrap count -> starting residue
    residue_of_wrap = np.empty(seed_len, dtype=np.int64)
    residue_of_wrap[wrap_of_residue] = np.arange(seed_len)
    offsets: list[int] = []
    sets: list[int] = []
    used = set()
    next_s, wrap = 0, 0
    while len(offsets) < n_possible and len(offsets) < max_seeds:
        if next_s >= n_possible:
            wrap += 1
            if wrap >= seed_len:
                break
            next_s = int(residue_of_wrap[wrap])
        while next_s < n_possible and next_s in used:
            next_s += 1
        if next_s >= n_possible:
            continue
        used.add(next_s)
        offsets.append(next_s)
        sets.append(wrap)
        count = len(offsets)
        if (max_seeds - count + 1) * seed_len + next_s < n_possible:
            next_s += (n_possible - next_s - 1) // (max_seeds - count + 1)
        else:
            next_s += seed_len
    return tuple(offsets), tuple(sets)


def _sparse_min_table(vals: np.ndarray) -> list[np.ndarray]:
    """Sparse table for O(1) range-min over a static array."""
    levels = [vals]
    half = 1
    while 2 * half <= len(vals):
        prev = levels[-1]
        levels.append(np.minimum(prev[: len(prev) - half], prev[half:]))
        half *= 2
    return levels


def _range_min(
    levels: list[np.ndarray], lo: np.ndarray, hi: np.ndarray
) -> np.ndarray:
    """Vectorized min over [lo, hi); empty ranges return _INF16."""
    out = np.full(lo.shape, _INF16, dtype=np.int32)
    n = hi - lo
    nz = np.flatnonzero(n > 0)
    if nz.size == 0:
        return out
    nn = n[nz]
    k = np.frexp(nn.astype(np.float64))[1] - 1  # floor(log2(nn))
    res = np.full(nn.shape, _INF16, dtype=np.int32)
    for kk in range(len(levels)):
        m = k == kk
        if not m.any():
            continue
        lvl = levels[kk]
        a = lvl[lo[nz][m]]
        b = lvl[hi[nz][m] - (1 << kk)]
        res[m] = np.minimum(a, b)
    out[nz] = res
    return out


class PairedCandidates:
    """Fixed [R, K] candidate tile for the device scoring wavefront.

    Rows 0..B-1 are first ends, B..2B-1 second ends (the paired-driver
    batch layout). Slot order is selection priority: best pair-bound
    candidates first (so slot < 2 is the DP promotion set downstream).
    """

    def __init__(self, R: int, K: int):
        self.loc = np.zeros((R, K), dtype=np.int64)
        self.off = np.zeros((R, K), dtype=np.int32)
        self.dir = np.zeros((R, K), dtype=np.int32)
        self.valid = np.zeros((R, K), dtype=bool)
        self.weight = np.zeros((R, K), dtype=np.int32)
        self.has_mate = np.zeros((R, K), dtype=bool)
        self.pair_bound = np.full((R, K), _INF16, dtype=np.int32)
        self.bps = np.full((R, K), _INF16, dtype=np.int32)
        self.big_indel = np.zeros((R, K), dtype=np.int32)
        self.popular = np.zeros(R, dtype=np.int32)
        self.n_lookups = np.zeros(R, dtype=np.int32)


class WideCandidates:
    """[R, K] candidate tile from the full hit lists (single-end redo)."""

    def __init__(self, R: int, K: int):
        self.loc = np.zeros((R, K), dtype=np.int64)
        self.off = np.zeros((R, K), dtype=np.int32)
        self.dir = np.zeros((R, K), dtype=np.int32)
        self.valid = np.zeros((R, K), dtype=bool)
        self.weight = np.zeros((R, K), dtype=np.int32)
        self.popular = np.zeros(R, dtype=np.int32)


def wide_single_candidates(
    hidx,
    bases: np.ndarray,      # [R, L] uint8 (rows needing the wide pass)
    len_eff: np.ndarray,    # [R] int32
    num_lookups: int,       # AlignParams.num_lookups
    seed_len: int,
    max_hits: int,          # popular-seed skip threshold (-h, default 300)
    explore_popular: bool = False,   # -x
    max_cand: int = 512,
) -> WideCandidates:
    """Single-end candidate generation over the FULL hit lists.

    The device wavefront gathers a fixed hit_cap per (seed, direction);
    reads where some lookup overflowed the cap are re-run through this
    host path, which evaluates every hit up to maxHits per seed like
    BaseAligner (BaseAligner.cpp:574-579). Same seed order (wrap-rank
    top-S) and RC offset mapping as the device path; weight = number of
    identical-location discoveries; candidates capped at max_cand by
    weight (SNAP's weight-ordered scoring reaches low-weight candidates
    only until its early-outs fire; pAll >= 4.9 forces MAPQ 0 long
    before 512 candidates score).
    """
    R, L = bases.shape
    seed = seed_len
    S = num_lookups
    K = max_cand
    out = WideCandidates(R, K)
    P = L - seed + 1
    if P <= 0:
        return out

    wrap_of_residue = snap_seed_wrap_order(seed)
    pos = np.arange(P, dtype=np.int64)
    rank_static = wrap_of_residue[pos % seed] * (P // seed + 2) + pos // seed
    INF = np.int64(1 << 30)

    # per-row usable positions (N-free seed windows, inside len_eff)
    fwd_all = np.zeros((R, P), dtype=np.uint64)
    rc_all = np.zeros((R, P), dtype=np.uint64)
    valid_all = np.ones((R, P), dtype=bool)
    for i in range(seed):
        b = bases[:, i : i + P].astype(np.uint64)
        ok = b < 4
        valid_all &= ok
        bs = np.where(ok, b, 0)
        fwd_all = (fwd_all << np.uint64(2)) | bs
        rc_all |= (np.uint64(3) - bs) << np.uint64(2 * i)

    usable = valid_all & (pos[None, :] <= (len_eff - seed)[:, None])
    ranks = np.where(usable, rank_static[None, :], INF)
    order = np.argsort(ranks, axis=1)[:, :S]              # [R, S]
    offsets = order.astype(np.int32)
    seed_ok = np.take_along_axis(ranks, order, axis=1) < INF

    take = lambda a: np.take_along_axis(a, order, axis=1)
    fwd = take(fwd_all)
    rc = take(rc_all)
    canonical = np.minimum(fwd, rc)
    ric = fwd <= rc

    found, start, n0, n1 = hidx.probe(canonical.reshape(-1))
    found = (found & seed_ok.reshape(-1)).reshape(R, S)
    start = start.reshape(R, S)
    n0 = n0.reshape(R, S)
    n1 = n1.reshape(R, S)
    f_start = np.where(ric, start, start + n0)
    f_n = np.where(found & ric, n0, np.where(found, n1, 0))
    r_start = np.where(ric, start + n0, start)
    r_n = np.where(found & ric, n1, np.where(found, n0, 0))

    pop_f = f_n > max_hits
    pop_r = r_n > max_hits
    out.popular[:] = (pop_f.sum(axis=1) + pop_r.sum(axis=1)).astype(
        np.int32
    )
    if explore_popular:
        f_use = np.minimum(f_n, max_hits)
        r_use = np.minimum(r_n, max_hits)
    else:
        f_use = np.where(pop_f, 0, f_n)
        r_use = np.where(pop_r, 0, r_n)

    le = len_eff.astype(np.int64)[:, None]
    off64 = offsets.astype(np.int64)
    parts = []
    for d, (d_start, d_n, sub) in enumerate(
        ((f_start, f_use, off64), (r_start, r_use, le - seed - off64))
    ):
        use_n = d_n.astype(np.int64).reshape(-1)
        tot = int(use_n.sum())
        if tot == 0:
            continue
        run_id = np.repeat(np.arange(R * S), use_n)
        csum = np.concatenate(([0], np.cumsum(use_n)))
        within = np.arange(tot) - csum[run_id]
        locs = hidx.hits[d_start.reshape(-1)[run_id] + within].astype(
            np.int64
        )
        norm = np.maximum(locs - sub.reshape(-1)[run_id], -_LOC_BIAS)
        parts.append(
            (run_id // S, np.full(tot, d, np.int8), run_id % S, norm)
        )
    if not parts:
        return out
    e_row = np.concatenate([p[0] for p in parts])
    e_dir = np.concatenate([p[1] for p in parts])
    e_s = np.concatenate([p[2] for p in parts]).astype(np.int64)
    e_norm = np.concatenate([p[3] for p in parts])

    keyed = (e_row * 2 + e_dir) * _ROW_KEY + (e_norm + _LOC_BIAS)
    o2 = np.lexsort((e_s, keyed))
    keyed_s, e_s_s = keyed[o2], e_s[o2]
    e_row_s, e_dir_s, e_norm_s = e_row[o2], e_dir[o2], e_norm[o2]
    first = np.ones(keyed_s.shape[0], dtype=bool)
    first[1:] = keyed_s[1:] != keyed_s[:-1]
    uq = np.flatnonzero(first)
    weight = np.diff(np.append(uq, keyed_s.shape[0])).astype(np.int32)
    c_row, c_dir, c_norm = e_row_s[uq], e_dir_s[uq], e_norm_s[uq]
    c_s = e_s_s[uq]

    sel = np.lexsort((c_norm, -weight.astype(np.int64), c_row))
    rs = c_row[sel]
    first_r = np.ones(rs.shape[0], dtype=bool)
    first_r[1:] = rs[1:] != rs[:-1]
    run_start = np.maximum.accumulate(
        np.where(first_r, np.arange(rs.shape[0]), 0)
    )
    slot = np.arange(rs.shape[0]) - run_start
    keep = slot < K
    ks = sel[keep]
    rowk = c_row[ks]
    slotk = slot[keep]
    out.loc[rowk, slotk] = c_norm[ks]
    o = offsets[rowk, c_s[ks]].astype(np.int64)
    d = c_dir[ks].astype(np.int64)
    le_k = len_eff[rowk].astype(np.int64)
    out.off[rowk, slotk] = np.where(d == 1, le_k - seed - o, o).astype(
        np.int32
    )
    out.dir[rowk, slotk] = c_dir[ks]
    out.valid[rowk, slotk] = True
    out.weight[rowk, slotk] = weight[ks]
    return out


def paired_candidates(
    hidx,                      # index.host_lookup.HostIndex
    bases: np.ndarray,         # [R, L] uint8, R = 2 * n_pairs
    len_eff: np.ndarray,       # [R] int32 (clipped lengths)
    n_pairs: int,
    params: IntersectParams,
) -> PairedCandidates:
    """Phase 1 + 2 of the intersecting aligner for a whole batch."""
    R, L = bases.shape
    B = n_pairs
    seed = params.seed_len
    S = params.num_seeds
    K = params.max_cand
    out = PairedCandidates(R, K)

    # ---- phase 1: seed offsets, packing, probing -------------------------
    offsets = np.full((R, S), -1, dtype=np.int32)
    set_ids = np.zeros((R, S), dtype=np.int32)
    n_poss = (np.minimum(len_eff, L) - seed + 1).astype(np.int64)
    for npos in np.unique(n_poss):
        if npos <= 0:
            continue
        offs, sets = intersect_seed_offsets(int(npos), seed, S)
        rows = np.flatnonzero(n_poss == npos)
        offsets[rows[:, None], np.arange(len(offs))[None, :]] = offs
        set_ids[rows[:, None], np.arange(len(offs))[None, :]] = sets

    from ..index.host_lookup import pack_seeds_at

    fwd, rc, seed_ok = pack_seeds_at(bases, offsets, seed)
    canonical = np.minimum(fwd, rc)
    read_is_canon = fwd <= rc

    flat_keys = canonical.reshape(-1)
    found, start, n0, n1 = hidx.probe(flat_keys)
    found = (found & seed_ok.reshape(-1)).reshape(R, S)
    start = start.reshape(R, S)
    n0 = n0.reshape(R, S)
    n1 = n1.reshape(R, S)
    ric = read_is_canon
    # orientation mapping: dir0 (read forward) hits = the list matching
    # the read seed; dir1 = the other (pipeline.py same mapping)
    f_start = np.where(ric, start, start + n0)
    f_n = np.where(ric, n0, n1)
    r_start = np.where(ric, start + n0, start)
    r_n = np.where(ric, n1, n0)
    # missing seeds (not in the genome at all): 0 hits both directions
    f_n = np.where(found, f_n, 0)
    r_n = np.where(found, r_n, 0)

    big_f = seed_ok & (f_n >= params.max_big_hits)
    big_r = seed_ok & (r_n >= params.max_big_hits)
    out.popular[:] = (big_f.sum(axis=1) + big_r.sum(axis=1)).astype(
        np.int32
    )
    out.n_lookups[:] = seed_ok.sum(axis=1).astype(np.int32)

    # recorded lookups per direction (0-hit lookups count: they are
    # misses at every locus)
    rec_f = seed_ok & ~big_f
    rec_r = seed_ok & ~big_r

    le = len_eff.astype(np.int64)[:, None]
    off64 = offsets.astype(np.int64)
    norm_sub = np.stack([off64, le - seed - off64], axis=0)  # [2, R, S]

    # number of recorded lookups per (row, dir, set): misses are counted
    # against this
    n_sets = int(set_ids.max()) + 1 if R else 1
    rec_by_set = np.zeros((2, R, n_sets), dtype=np.int32)
    row_of = np.repeat(np.arange(R), S)
    sid_flat = set_ids.reshape(-1)
    for d, rec in ((0, rec_f), (1, rec_r)):
        m = rec.reshape(-1)
        rec_by_set[d] = np.bincount(
            row_of[m] * n_sets + sid_flat[m], minlength=R * n_sets
        ).reshape(R, n_sets)

    # ---- expand all hits into one flat table -----------------------------
    exp_rows = []
    hits_csr = hidx.hits
    for d, (d_start, d_n, rec) in enumerate(
        ((f_start, f_n, rec_f), (r_start, r_n, rec_r))
    ):
        use_n = np.where(rec, d_n, 0).astype(np.int64).reshape(-1)
        tot = int(use_n.sum())
        if tot == 0:
            exp_rows.append(None)
            continue
        run_id = np.repeat(np.arange(R * S), use_n)
        csum = np.concatenate(([0], np.cumsum(use_n)))
        within = np.arange(tot) - csum[run_id]
        hit_idx = d_start.reshape(-1)[run_id] + within
        locs = hits_csr[hit_idx].astype(np.int64)
        row = run_id // S
        s_ix = run_id % S
        norm = np.maximum(
            locs - norm_sub[d].reshape(-1)[run_id], -_LOC_BIAS
        )
        exp_rows.append((row, s_ix, norm))

    # single flat table over both directions
    parts_row, parts_dir, parts_s, parts_norm = [], [], [], []
    for d in (0, 1):
        if exp_rows[d] is None:
            continue
        row, s_ix, norm = exp_rows[d]
        parts_row.append(row)
        parts_dir.append(np.full(row.shape, d, dtype=np.int8))
        parts_s.append(s_ix)
        parts_norm.append(norm)
    if not parts_row:
        return out
    e_row = np.concatenate(parts_row)
    e_dir = np.concatenate(parts_dir)
    e_s = np.concatenate(parts_s).astype(np.int32)
    e_norm = np.concatenate(parts_norm)

    rowdir = e_row * 2 + e_dir
    keyed = rowdir.astype(np.int64) * _ROW_KEY + (e_norm + _LOC_BIAS)
    # secondary key = probe order, so each dedup group's first entry is
    # the earliest-probed seed (SNAP's candidate seedOffset comes from
    # the inserting seed)
    order = np.lexsort((e_s, keyed))
    keyed_s = keyed[order]
    e_s_s = e_s[order]
    e_row_s = e_row[order]
    e_dir_s = e_dir[order]
    e_norm_s = e_norm[order]

    # ---- dedup to unique (rowdir, normalized loc) candidates -------------
    first = np.ones(keyed_s.shape[0], dtype=bool)
    first[1:] = keyed_s[1:] != keyed_s[:-1]
    uq = np.flatnonzero(first)          # indices of group starts
    c_key = keyed_s[uq]
    c_row = e_row_s[uq]
    c_dir = e_dir_s[uq]
    c_norm = e_norm_s[uq]
    c_off = e_s_s[uq]                   # earliest probing lookup index
    N = uq.size

    # ---- fuzzy per-lookup match mask + bestPossibleScore ----------------
    fz = params.fuzzy_dist
    matched_sets = np.zeros((N, n_sets), dtype=np.int32)  # per-set hits
    weight = np.zeros(N, dtype=np.int32)
    nidx = np.arange(N)
    for s in range(S):
        m = e_s_s == s
        if not m.any():
            continue
        vals = keyed_s[m]               # sorted (subset of sorted array)
        lo = np.searchsorted(vals, c_key - fz, side="left")
        hi = np.searchsorted(vals, c_key + fz, side="right")
        has = hi > lo
        weight += has
        # the lookup's disjoint set varies per row; (nidx, sid) pairs
        # are unique within one s, so fancy += is safe
        sid = set_ids[c_row, s]
        matched_sets[nidx, sid] += has.astype(np.int32)

    rec_here = np.where(
        (c_dir == 0)[:, None],
        rec_by_set[0][c_row],
        rec_by_set[1][c_row],
    )                                    # [N, n_sets]
    misses = rec_here - matched_sets
    bps = misses.max(axis=1).astype(np.int32)

    # ---- pair join: mate-window existence + mate bps range-min ----------
    # combos: (end0 d0 <-> end1 d1) and (end0 d1 <-> end1 d0)
    side = (c_row >= B).astype(np.int8)          # 0 = first end
    pair_ix = np.where(side == 0, c_row, c_row - B).astype(np.int64)
    combo = np.where(side.astype(np.int32) == c_dir.astype(np.int32), 0, 1)
    # combo 0: side0/dir0 & side1/dir1 -> side == dir
    # combo 1: side0/dir1 & side1/dir0 -> side != dir
    pair_key = (
        (combo.astype(np.int64) * (B + 1) + pair_ix) * _ROW_KEY
        + (c_norm + _LOC_BIAS)
    )

    has_mate = np.zeros(N, dtype=bool)
    mate_min_bps = np.full(N, _INF16, dtype=np.int32)
    min_sp = np.int64(params.min_spacing)
    max_sp = np.int64(params.max_spacing)
    for qside in (0, 1):
        qm = np.flatnonzero(side == qside)
        tm = np.flatnonzero(side == 1 - qside)
        if qm.size == 0 or tm.size == 0:
            continue
        t_order = np.argsort(pair_key[tm], kind="stable")
        t_sorted = tm[t_order]
        t_keys = pair_key[t_sorted]
        t_bps = bps[t_sorted]
        levels = _sparse_min_table(t_bps)
        q_keys = pair_key[qm]
        # two windows: [x-max, x-min] and [x+min, x+max] (same row via
        # the pair-keyed transform; _ROW_KEY >> max_spacing)
        for sgn in (-1, 1):
            lo_v = q_keys + (sgn * max_sp if sgn < 0 else sgn * min_sp)
            hi_v = q_keys + (sgn * min_sp if sgn < 0 else sgn * max_sp)
            lo = np.searchsorted(t_keys, lo_v, side="left")
            hi = np.searchsorted(t_keys, hi_v, side="right")
            nonempty = hi > lo
            has_mate[qm] |= nonempty
            mmin = _range_min(levels, lo, hi)
            mate_min_bps[qm] = np.minimum(mate_min_bps[qm], mmin)

    pair_bound = np.where(
        has_mate,
        bps.astype(np.int64) + mate_min_bps.astype(np.int64),
        bps.astype(np.int64) + _NOPAIR_PENALTY,
    )

    # ---- phase 2a: big-indel detection ----------------------------------
    # For every scoring-pool candidate (mate window exists), the largest
    # spread to another pool candidate of the same (row, dir) within
    # maxDistForIndels marks how far its score limit may be raised
    # (IntersectingPairedEndAligner.cpp:720-801 two-pointer; on the
    # sorted keyed array the farthest-in-window neighbors are the window
    # edges, so two searchsorteds replace the pointer walk).
    big_indel = np.zeros(N, dtype=np.int32)
    mki = np.int64(params.max_k_indels)
    if mki > 0:
        pm = np.flatnonzero(has_mate)
        if pm.size:
            vals = c_key[pm]  # ascending; rowdir-keyed so windows
            #                   never cross a (row, dir) boundary
            lo = np.searchsorted(vals, vals - (mki - 1), side="left")
            hi = np.searchsorted(vals, vals + mki, side="left") - 1
            spread = np.maximum(vals - vals[lo], vals[hi] - vals)
            big_indel[pm] = spread.astype(np.int32)

    # ---- top-K selection per row ----------------------------------------
    sel = np.lexsort((c_norm, -weight.astype(np.int64), pair_bound, c_row))
    rs = c_row[sel]
    first_r = np.ones(rs.shape[0], dtype=bool)
    first_r[1:] = rs[1:] != rs[:-1]
    run_start = np.maximum.accumulate(
        np.where(first_r, np.arange(rs.shape[0]), 0)
    )
    slot = np.arange(rs.shape[0]) - run_start
    keep = slot < K
    ks = sel[keep]
    rowk = c_row[ks]
    slotk = slot[keep]

    out.loc[rowk, slotk] = c_norm[ks]
    # oriented anchor offset: dir0 -> seed offset, dir1 ->
    # len_eff - seed - offset (pipeline cand_off convention)
    o = offsets[rowk, c_off[ks]].astype(np.int64)
    d = c_dir[ks].astype(np.int64)
    le_k = len_eff[rowk].astype(np.int64)
    out.off[rowk, slotk] = np.where(d == 1, le_k - seed - o, o).astype(
        np.int32
    )
    out.dir[rowk, slotk] = c_dir[ks]
    out.valid[rowk, slotk] = True
    out.weight[rowk, slotk] = weight[ks]
    out.has_mate[rowk, slotk] = has_mate[ks]
    out.pair_bound[rowk, slotk] = np.minimum(
        pair_bound[ks], _INF16
    ).astype(np.int32)
    out.bps[rowk, slotk] = bps[ks]
    out.big_indel[rowk, slotk] = big_indel[ks]
    return out
