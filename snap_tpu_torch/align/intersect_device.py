"""Paired-end fuzzy set intersection as tensor ops on the index's device.

Counterpart of snap_tpu.align.intersect_device (without the sharded
phase-1 merge). Device twin of align/intersect.paired_candidates (phases
1-2 of SNAP's IntersectingPairedEndAligner,
IntersectingPairedEndAligner.cpp:406-717): read-start-normalized
locations, disjoint-hit-set bestPossibleScore lower bounds
(.cpp:3585-3625), [minSpacing, maxSpacing] mate windows on the opposite
end and direction (.cpp:530-717), pair-bound priority ordering:

- per-seed hit lists arrive as capped row gathers ([R, S, HP]); rows
  where a recorded lookup overflows the cap are flagged for the exact
  host redo;
- the host path's per-lookup searchsorted fuzzy windows become
  inclusive running max/min scans (torch.cummax, and torch.cummin over
  the flipped row) over per-row sorted entry tables;
- the mate-window existence and mate bestPossibleScore range-min are a
  masked compare-and-reduce against the mate row's full entry table.
  Eager torch materialises the [rows, 2, C, M] compare that XLA fuses
  away, so it runs in row chunks of at most _CHUNK_ELEMS elements, as
  does the [2R, C, C] phase-2a spread;
- the final per-row top-K by (pair_bound, -weight, loc) is one packed
  int64 key; jax.lax.sort with payload operands becomes one stable
  torch.sort of the key and a gather of each payload.

uint64 seed keys live in int64 tensors (index.index: u64_min, u64_le).
For rows that are not flagged the outputs match paired_candidates bit
for bit, as snap_tpu's do.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..index.index import DeviceIndex, gather_hits, probe, u64_le, u64_min
from .intersect import (
    FUZZY_DIST,
    MAX_BIG_HITS,
    _INF16,
    _LOC_BIAS,
    _NOPAIR_PENALTY,
)

i32, i64 = torch.int32, torch.int64

_INF_KEY = 1 << 62
_NEG_INF = -(1 << 40)
_POS_INF = 1 << 40
_SB = 5                  # lookup-index bits in the entry key
_CHUNK_ELEMS = 1 << 26   # live elements of one chunk of a broadcast compare


@dataclass(frozen=True)
class DeviceIntersectParams:
    """Static geometry of the device intersection."""

    seed_len: int
    max_probe: int = 32          # index bucket span (probe geometry)
    num_seeds: int = 8           # S: lookups per end (-n paired)
    hit_cap: int = 64            # HP: gathered hits per (lookup, dir)
    cand_width: int = 64         # C: compacted candidates per (row, dir)
    max_cand: int = 16           # K: output tile width
    fuzzy_dist: int = FUZZY_DIST
    max_big_hits: int = MAX_BIG_HITS
    max_k_indels: int = 0        # phase-2a detection bound (-i); see
                                 # intersect.IntersectParams.max_k_indels


def _row_chunks(n_rows: int, per_row: int):
    """Row slices whose broadcast intermediates hold at most
    _CHUNK_ELEMS elements (at least one row each)."""
    step = max(1, _CHUNK_ELEMS // max(1, per_row))
    for r0 in range(0, n_rows, step):
        yield slice(r0, min(n_rows, r0 + step))


def _sorted_with(key: torch.Tensor, *payload: torch.Tensor):
    """Stable ascending sort of key along dim 1 and each payload in the
    same order (jax.lax.sort(..., num_keys=1, is_stable=True))."""
    srt = torch.sort(key, dim=1, stable=True)
    return (srt.values, *(torch.gather(x, 1, srt.indices) for x in payload))


def _phase1_entries(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [R, L] uint8, R = 2B (side0 rows then side1)
    len_eff: torch.Tensor,   # [R] int32
    offsets: torch.Tensor,   # [R, S] int32 probe offsets (-1 = unused)
    set_ids: torch.Tensor,   # [R, S] int32 disjoint-set id per lookup
    p: DeviceIntersectParams,
):
    """Phase 1: pack seeds at the probe offsets, probe, gather hits,
    normalize into per-(row, dir) entry-key tables.

    Returns (e_key [2R, M] UNSORTED, rec_by_set [2, R, NS] i32,
    popular [R] i32, n_lookups [R] i32, over [R] bool)."""
    R, L = bases.shape
    S = p.num_seeds
    HP = p.hit_cap
    M = S * HP
    seed = p.seed_len
    NS = S  # disjoint-set ids are < number of lookups
    dev = bases.device

    # ---- pack seeds at the probe offsets, probe ----
    off_ok = offsets >= 0
    offc = offsets.clamp(0, max(L - seed, 0)).to(i64)
    fwd = torch.zeros((R, S), dtype=i64, device=dev)
    rc = torch.zeros((R, S), dtype=i64, device=dev)
    seed_ok = off_ok
    for i in range(seed):
        b = torch.gather(bases, 1, offc + i)
        ok = b < 4
        seed_ok = seed_ok & ok
        bs = torch.where(ok, b, 0).to(i64)
        fwd = (fwd << 2) | bs
        rc = rc | ((3 - bs) << (2 * i))
    # in-read bounds: offset + seed must fit the clipped read
    seed_ok = seed_ok & (offsets + seed <= len_eff[:, None])

    canonical = u64_min(fwd, rc)
    ric = u64_le(fwd, rc).reshape(-1)
    found, start, n0, n1 = probe(didx, canonical.reshape(-1), p.max_probe)
    found = found & seed_ok.reshape(-1)
    n0_64 = n0.to(i64)
    f_start = torch.where(ric, start, start + n0_64)
    f_n = torch.where(ric, n0, n1)
    r_start = torch.where(ric, start + n0_64, start)
    r_n = torch.where(ric, n1, n0)
    f_n = torch.where(found, f_n, 0)
    r_n = torch.where(found, r_n, 0)

    so = seed_ok.reshape(-1)
    big_f = so & (f_n >= p.max_big_hits)
    big_r = so & (r_n >= p.max_big_hits)
    popular = (
        big_f.reshape(R, S).sum(dim=1) + big_r.reshape(R, S).sum(dim=1)
    ).to(i32)
    n_lookups = seed_ok.sum(dim=1).to(i32)
    rec_f = so & ~big_f
    rec_r = so & ~big_r

    # overflow: a recorded lookup has more hits than the gather cap
    over = (
        (rec_f & (f_n > HP)).reshape(R, S).any(dim=1)
        | (rec_r & (r_n > HP)).reshape(R, S).any(dim=1)
    )

    # recorded lookups per disjoint set: [2, R, NS]
    sid1h = set_ids[:, :, None] == torch.arange(NS, device=dev)[None, None, :]
    rec_by_set = torch.stack(
        [
            (rec_f.reshape(R, S, 1) & sid1h).sum(dim=1),
            (rec_r.reshape(R, S, 1) & sid1h).sum(dim=1),
        ],
        dim=0,
    ).to(i32)

    # ---- gather hits, normalize ----
    le = len_eff.to(i64)[:, None]
    sub = torch.stack([offc, le - seed - offc], dim=0)  # [2, R, S]
    s_ix = torch.arange(S, dtype=i64, device=dev)[None, :, None].expand(R, S, HP)
    s_ix = s_ix.reshape(R * S, HP)
    ents = []
    for d, (d_start, d_n, rec) in enumerate(
        ((f_start, f_n, rec_f), (r_start, r_n, rec_r))
    ):
        cnt = torch.where(rec, torch.clamp_max(d_n, HP), 0)
        locs, lvalid = gather_hits(didx.hits, d_start, cnt, HP)  # [R*S, HP]
        norm = torch.clamp_min(locs - sub[d].reshape(-1, 1), -int(_LOC_BIAS))
        key = torch.where(
            lvalid, ((norm + int(_LOC_BIAS)) << _SB) | s_ix, _INF_KEY
        )
        ents.append(key.reshape(R, M))

    e_key = torch.stack(ents, dim=1).reshape(R * 2, M)  # [2R, M]
    return e_key, rec_by_set, popular, n_lookups, over


def _mate_windows(c_norm, mate_norm, mate_bps, mate_val, min_sp, max_sp):
    """has_mate and the mate's least bestPossibleScore in the spacing
    window of each compacted candidate: [R, 2, C] against the mate rows'
    [R, 2, M] entry tables, reduced over M in row chunks."""
    R, _, C = c_norm.shape
    M = mate_norm.shape[2]
    has_mate = torch.empty((R, 2, C), dtype=torch.bool, device=c_norm.device)
    mate_min = torch.empty((R, 2, C), dtype=i32, device=c_norm.device)
    inf16 = int(_INF16)
    for rs in _row_chunks(R, 2 * C * M):
        q = c_norm[rs, :, :, None]
        d_ = mate_norm[rs, :, None, :] - q  # biased norms: bias cancels
        in_win = mate_val[rs, :, None, :] & (
            ((d_ >= min_sp) & (d_ <= max_sp))
            | ((d_ >= -max_sp) & (d_ <= -min_sp))
        )
        del d_
        has_mate[rs] = in_win.any(dim=3)
        mate_min[rs] = torch.where(in_win, mate_bps[rs, :, None, :], inf16).amin(dim=3)
    return has_mate, mate_min


def _big_indel(c_norm, has_mate, mki: int):
    """Phase 2a: the largest spread to another mate-bearing candidate of
    the same (row, dir) within maxDistForIndels
    (IntersectingPairedEndAligner.cpp:720-801), in row chunks."""
    R2, C = c_norm.shape
    out = torch.empty((R2, C), dtype=i64, device=c_norm.device)
    for rs in _row_chunks(R2, C * C):
        cn, hm = c_norm[rs], has_mate[rs]
        sp = (cn[:, :, None] - cn[:, None, :]).abs()
        okw = hm[:, :, None] & hm[:, None, :] & (sp < mki)
        out[rs] = torch.where(okw, sp, 0).amax(dim=2)
    return out


def _phase2_from_entries(
    e_key: torch.Tensor,      # [2R, M] entry keys (any order; sorted here)
    rec_by_set: torch.Tensor,  # [2, R, NS] i32 recorded lookups per set
    popular: torch.Tensor,     # [R] i32
    n_lookups: torch.Tensor,   # [R] i32
    over: torch.Tensor,        # [R] bool (phase-1 gather-cap overflow)
    len_eff: torch.Tensor,     # [R] i32
    offsets: torch.Tensor,     # [R, S] i32 probe offsets
    set_ids: torch.Tensor,     # [R, S] i32
    min_sp: int,
    max_sp: int,
    p: DeviceIntersectParams,
    L: int,
) -> dict:
    """Phase 2 from the entry tables: fuzzy match, bestPossibleScore,
    dedup/compaction, mate windows, phase 2a, top-K."""
    R2, M = e_key.shape
    R = R2 // 2
    B = R // 2
    S = p.num_seeds
    C = p.cand_width
    K = p.max_cand
    seed = p.seed_len
    NS = S
    dev = e_key.device
    offc = offsets.clamp(0, max(L - seed, 0)).to(i64)
    fz = p.fuzzy_dist

    e_key = torch.sort(e_key, dim=1).values
    e_valid = e_key < _INF_KEY
    e_norm = torch.where(e_valid, e_key >> _SB, _POS_INF)  # biased norm
    e_s = (e_key & ((1 << _SB) - 1)).to(i32)

    # ---- fuzzy per-lookup match via nearest-entry scans ----
    matched = torch.empty((S, R2, M), dtype=i32, device=dev)
    for s in range(S):
        msk = e_valid & (e_s == s)
        prev = torch.cummax(torch.where(msk, e_norm, _NEG_INF), dim=1).values
        nv = torch.where(msk, e_norm, _POS_INF)
        nxt = torch.flip(torch.cummin(torch.flip(nv, dims=(1,)), dim=1).values, dims=(1,))
        matched[s] = (((e_norm - prev) <= fz) | ((nxt - e_norm) <= fz)).to(i32)
    weight = matched.sum(dim=0, dtype=i32)  # [2R, M]

    # ---- bestPossibleScore: per-set misses, max over sets ----
    # set id of lookup s varies per row: set_ids [R, S], the same for
    # both directions of a row
    sid_rd = set_ids[:, None, :].expand(R, 2, S).reshape(R2, S).to(i64)
    rec_rd = rec_by_set.permute(1, 0, 2).reshape(R2, NS)  # [2R, NS]
    bps = torch.zeros((R2, M), dtype=i32, device=dev)
    for w in range(NS):
        in_w = (sid_rd == w).T.to(i32)[:, :, None]  # [S, 2R, 1]
        mw = (matched * in_w).sum(dim=0, dtype=i32)
        bps = torch.maximum(bps, rec_rd[:, w : w + 1] - mw)
    bps = torch.clamp_min(bps, 0)
    del matched

    # ---- dedup + compact top-C per (row, dir) ----
    is_start = torch.cat(
        [
            torch.ones((R2, 1), dtype=torch.bool, device=dev),
            e_norm[:, 1:] != e_norm[:, :-1],
        ],
        dim=1,
    ) & e_valid
    n_start = is_start.sum(dim=1).reshape(R, 2)

    # compaction priority: (bps, -weight, norm) — bps ascending keeps
    # every candidate that can beat the kept ones on pair_bound lower
    # bound; weight/norm break ties the same way the host top-K does
    wcap = torch.clamp_max(weight, 255).to(i64)
    bps64 = bps.to(i64)
    ckey = torch.where(
        is_start, (bps64 << 44) | ((255 - wcap) << 36) | e_norm, _INF_KEY
    )
    c_key, c_norm, c_s, c_bps, c_w = (
        x[:, :C] for x in _sorted_with(ckey, e_norm, e_s.to(i64), bps64, wcap)
    )
    c_live = c_key < _INF_KEY

    # ---- mate windows: compare vs the mate row's full entry table ----
    # mate of (pair i, side s, dir d) = (pair i, side 1-s, dir 1-d)
    def mate_view(x):
        x2 = x.reshape(R, 2, M)
        return torch.flip(torch.cat([x2[B:], x2[:B]], dim=0), dims=(1,))

    has_mate, mate_min = _mate_windows(
        c_norm.reshape(R, 2, C), mate_view(e_norm), mate_view(bps),
        mate_view(e_valid), int(min_sp), int(max_sp),
    )
    has_mate = has_mate.reshape(R2, C)
    mate_min = mate_min.reshape(R2, C)

    pair_bound = torch.where(
        has_mate, c_bps + mate_min.to(i64), c_bps + int(_NOPAIR_PENALTY)
    )

    if p.max_k_indels > 0:
        big_indel = _big_indel(c_norm, has_mate, p.max_k_indels)
    else:
        big_indel = torch.zeros_like(c_norm)

    # ---- top-K per row over both directions ----
    # host order: lexsort((norm, -weight, pair_bound)) per row
    fkey = torch.where(
        c_live, (pair_bound << 44) | ((255 - c_w) << 36) | c_norm, _INF_KEY
    ).reshape(R, 2 * C)
    dirs2 = torch.arange(2, dtype=i64, device=dev)[None, :, None].expand(R, 2, C)
    f_key, k_norm, k_s, k_dir, k_w, k_pb, k_bi = (
        x[:, :K] for x in _sorted_with(
            fkey, *(t.reshape(R, 2 * C) for t in (
                c_norm, c_s, dirs2, c_w, pair_bound, big_indel
            ))
        )
    )
    k_norm = k_norm - int(_LOC_BIAS)
    k_dir = k_dir.to(i32)
    k_w = k_w.to(i32)
    k_bi = k_bi.to(i32)
    k_live = f_key < _INF_KEY

    # oriented anchor offset == the normalization offset for that dir
    o_of_s = torch.gather(offc, 1, k_s)  # [R, K]
    k_off = torch.where(
        k_dir == 1, len_eff.to(i64)[:, None] - seed - o_of_s, o_of_s
    ).to(i32)

    # compaction-cut honesty: if a (row, dir) had more than C distinct
    # candidates, a cut one (bps >= the C-th kept bps) could still out-
    # rank the K-th kept candidate on pair_bound; flag those rows
    kth_bound = torch.where(k_live[:, K - 1], k_pb[:, K - 1], 1 << 40)
    cut_possible = (n_start > C).reshape(R, 2)
    cut_min_bound = torch.where(
        c_live[:, C - 1].reshape(R, 2), c_bps[:, C - 1].reshape(R, 2), 1 << 40
    )
    over = over | (cut_possible & (cut_min_bound < kth_bound[:, None])).any(dim=1)
    if p.max_k_indels > 0:
        # a cut (beyond-C) mate-bearing candidate could contribute a
        # phase-2a spread the compacted view cannot see
        over = over | cut_possible.any(dim=1)

    zero = torch.zeros((), dtype=i32, device=dev)
    return {
        "loc": torch.where(k_live, k_norm, 0),
        "off": torch.where(k_live, torch.clamp_min(k_off, 0), zero),
        "dir": k_dir,
        "valid": k_live,
        "weight": torch.where(k_live, k_w, zero),
        "big_indel": torch.where(k_live, k_bi, zero),
        "popular": popular,
        "n_lookups": n_lookups,
        "overflow": over,
    }


def paired_candidates_device(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [R, L] uint8, R = 2B (side0 rows then side1)
    len_eff: torch.Tensor,   # [R] int32
    offsets: torch.Tensor,   # [R, S] int32 probe offsets (-1 = unused)
    set_ids: torch.Tensor,   # [R, S] int32 disjoint-set id per lookup
    min_sp: int,             # minSpacing (-ins adapts it)
    max_sp: int,             # maxSpacing
    p: DeviceIntersectParams,
) -> dict:
    """Phases 1-2 on the tensors' device. Returns a dict of tensors:

    loc[R,K] i64 (normalized start), off[R,K] i32 (oriented anchor =
    the normalization offset), dir[R,K] i32, valid[R,K] bool,
    weight[R,K] i32, big_indel[R,K] i32, popular[R] i32,
    n_lookups[R] i32, overflow[R] bool (needs exact host redo).
    """
    S = p.num_seeds
    if S > 32:
        raise ValueError(
            f"device intersection packs the lookup index in 5 bits; "
            f"num_seeds={S} > 32 (use the host path)"
        )
    e_key, rec_by_set, popular, n_lookups, over = _phase1_entries(
        didx, bases, len_eff, offsets, set_ids, p
    )
    return _phase2_from_entries(
        e_key, rec_by_set, popular, n_lookups, over, len_eff,
        offsets, set_ids, min_sp, max_sp, p, bases.shape[1],
    )


def _paired_candidates_rows(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [2B, L] full batch rows (side0 then side1)
    len_eff: torch.Tensor,
    offsets: torch.Tensor,
    set_ids: torch.Tensor,
    rows: torch.Tensor,      # [M2] i64 pair ids to (re)intersect
    live: torch.Tensor,      # [M2] bool
    min_sp: int,
    max_sp: int,
    p: DeviceIntersectParams,
) -> dict:
    """Run the device intersection on a gathered subset of pairs (both
    sides of each selected pair), under `p`'s (typically wider)
    geometry. Dead pad rows run with len_eff=0."""
    B = bases.shape[0] // 2
    sub = torch.cat([rows, rows + B])
    le = torch.where(torch.cat([live, live]), len_eff[sub], 0).to(len_eff.dtype)
    return paired_candidates_device(
        didx, bases[sub], le, offsets[sub], set_ids[sub], min_sp, max_sp, p,
    )


def paired_wide_redo(
    didx: DeviceIndex,
    bases: torch.Tensor,
    len_eff: torch.Tensor,
    offsets: torch.Tensor,
    set_ids: torch.Tensor,
    pcd: dict,
    over_rows: np.ndarray,   # host row ids of overflowed pairs
    min_sp: int,
    max_sp: int,
    p: DeviceIntersectParams,
    hit_cap: int = 512,
    cand_width: int = 512,
) -> dict:
    """Second, wider device tier for pairs the standard intersection
    flagged (gather-cap or compaction-cut overflow) — the paired analogue
    of the single-end adaptive phase B: the flagged pairs rerun at
    HP=512/C=512, and pairs that overflow even the wide geometry keep
    their flag and take the host path.

    Row counts are padded to a power of two (>= 64), as snap_tpu pads
    them for its compiled shapes. Returns pcd with the redone rows'
    fields overwritten and `overflow` updated.
    """
    wide_p = dataclasses.replace(p, hit_cap=hit_cap, cand_width=cand_width)
    dev = bases.device
    # chunk so the wide entry tables ([4*M2, S*HP] i64) stay bounded
    CHUNK = 2048
    for c0 in range(0, over_rows.size, CHUNK):
        chunk = over_rows[c0 : c0 + CHUNK]
        nb = chunk.size
        M2 = 1 << max(6, int(np.ceil(np.log2(max(nb, 1)))))
        rows = np.zeros(M2, np.int64)
        rows[:nb] = chunk
        live = np.zeros(M2, bool)
        live[:nb] = True
        rows_t = torch.from_numpy(rows).to(dev)
        live_t = torch.from_numpy(live).to(dev)
        sub = _paired_candidates_rows(
            didx, bases, len_eff, offsets, set_ids, rows_t, live_t,
            min_sp, max_sp, wide_p,
        )
        pcd = _scatter_pcd(pcd, sub, rows_t, live_t)
    return pcd


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx] = vals, where a row index given more than once
    takes its LAST value (what snap_tpu's XLA scatter does with the pad
    rows, which all point at pair 0), deterministically on any device."""
    n = idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    last = torch.full((dst.shape[0],), -1, dtype=i64, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, reduce="amax")
    keep = last[idx] == pos
    out = dst.clone()
    out[idx[keep]] = vals[keep]
    return out


def _scatter_pcd(pcd: dict, sub: dict, rows: torch.Tensor, live: torch.Tensor) -> dict:
    B = pcd["overflow"].shape[0] // 2
    M2 = rows.shape[0]
    out = dict(pcd)
    for k in ("loc", "off", "dir", "valid", "weight", "big_indel"):
        for side, base in ((0, 0), (1, B)):
            new = sub[k][side * M2 : (side + 1) * M2]
            old = pcd[k][rows + base]
            out[k] = _set_rows(out[k], rows + base, torch.where(live[:, None], new, old))
    ov_new = sub["overflow"][:M2] | sub["overflow"][M2:]
    for base in (0, B):
        out["overflow"] = _set_rows(
            out["overflow"], rows + base,
            torch.where(live, ov_new, pcd["overflow"][rows + base]),
        )
    return out


def probe_offsets_for(
    len_eff: np.ndarray, L: int, seed_len: int, num_seeds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: per-row probe offsets + disjoint-set ids (the
    phase-1 sequence, IntersectingPairedEndAligner.cpp:416-501) for a
    batch of clipped lengths. Cheap: one cached sequence per distinct
    length."""
    from .intersect import intersect_seed_offsets

    R = len_eff.shape[0]
    S = num_seeds
    offsets = np.full((R, S), -1, dtype=np.int32)
    set_ids = np.zeros((R, S), dtype=np.int32)
    n_poss = (np.minimum(len_eff, L) - seed_len + 1).astype(np.int64)
    for npos in np.unique(n_poss):
        if npos <= 0:
            continue
        offs, sets = intersect_seed_offsets(int(npos), seed_len, S)
        rows = np.flatnonzero(n_poss == npos)
        cols = np.arange(len(offs))
        offsets[rows[:, None], cols[None, :]] = offs
        set_ids[rows[:, None], cols[None, :]] = sets
    return offsets, set_ids
