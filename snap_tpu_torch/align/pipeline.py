"""Single-end alignment device step in PyTorch: the adaptive fast path.

Counterpart of snap_tpu.align.pipeline (the production fast path only).
Behavioral reference: SNAP's BaseAligner::AlignRead (BaseAligner.cpp:273)
as fixed-shape tensor wavefronts:

  clip -> seed pack -> hash probe -> hit gather -> candidate
  sort/dedup/top-K -> tier-1 gapless prescreen -> tier-2 affine-gap and
  seed-anchored fitting DP on a compacted row subset -> device finalize
  (winner choice, MAPQ) -> [B+1, 6] int32 packed winners

The three scoring kernels (ops.gapless, ops.dp, ops.affine) launch the
hand-written CUDA kernels when their tensors are on CUDA and run their
plain PyTorch versions on the CPU. Each jit unit of snap_tpu
(_awd_candidates, _awd_score, _awd_finalize, _awd_route, _awd_merge,
...) is a plain function here.

Tie rules kept from snap_tpu: stable multi-key sorts become chained
stable torch.sort calls (least significant key first); top_k becomes a
stable descending sort (equal values lowest index first); float sort
keys use the IEEE total order (-0.0 before +0.0), as lax.sort does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import (
    DEFAULT_MAX_DIST,
    DEFAULT_MAX_HITS,
    DEFAULT_NUM_SEEDS_SINGLE,
    DEFAULT_SEED_LEN,
    MAPQ_MAX,
    MAX_MERGE_DIST,
    SNP_PROB,
)
from ..index.index import (
    DeviceIndex,
    gather_hits,
    pack_read_seeds,
    probe,
    u64_le,
    u64_min,
)
from ..ops.affine_cuda import affine_extend_cuda
from ..ops.dp import LOG_PERFECT
from ..ops.dp_cuda import fitting_edit_distance_cuda
from ..ops.gapless_cuda import gapless_prescreen_cuda
from ..ops.sums import ordered_sum

QUAL_CLIP = ord("#")  # ClipBack threshold quality (Read.h:88-108)
U32 = 0xFFFFFFFF

i32, i64, f32, f64 = torch.int32, torch.int64, torch.float32, torch.float64


@dataclass(frozen=True)
class AlignParams:
    seed_len: int = DEFAULT_SEED_LEN
    num_seeds: int = DEFAULT_NUM_SEEDS_SINGLE  # SNAP -n (per-direction applications)
    hit_cap: int = 16                 # fixed gather width per (seed, dir)
    max_hits: int = DEFAULT_MAX_HITS  # popular-seed skip threshold
    max_k: int = DEFAULT_MAX_DIST
    max_cand: int = 16                # candidates scored per read
    max_probe: int = 32
    explore_popular: bool = False     # -x: score popular seeds' first hits
    extra_search_depth: int = 1       # -D
    max_k_indels: int | None = None   # -i maxDistForIndels (single-end: 0)
    use_affine_gap: bool = True       # -G- disables AG escalation
    clip_back: bool = True            # default ClipBack (Read.h:88-108)
    # affine-gap penalties (-gm/-gs/-go/-ge/-g5/-g3; AlignerOptions.cpp:79-81)
    ag_match: int = 1
    ag_sub: int = 4
    ag_open: int = 6
    ag_extend: int = 1
    ag_b5: int = 10
    ag_b3: int = 7
    min_weight: int = 1               # -ms minWeightToCheck
    use_ukkonen: bool = True          # -nu disables the score-limit replay

    @property
    def num_lookups(self) -> int:
        # each clean lookup applies the seed in both directions
        # (BaseAligner.cpp:451,669), so -n 25 means 13 lookups
        return self.num_seeds // 2 + 1

    @property
    def mki(self) -> int:
        return self.max_k_indels or 0

    @property
    def max_k_same(self) -> int:
        # maxKForSameAlignment = gapOpen/(sub - gapExtend) (BaseAligner.cpp:1148)
        return self.ag_open // max(self.ag_sub - self.ag_extend, 1)


def snap_seed_wrap_order(seed_len: int) -> np.ndarray:
    """residue -> wrap round, from SNAP's SeedSequencer BFS bisection
    (SeedSequencer.cpp:36-103). Round 0 is residue 0; round w starts at
    the w-th midpoint of the BFS over [1, seed_len-1]."""
    from collections import deque

    order = np.zeros(seed_len, dtype=np.int32)
    q = deque([(1, seed_len - 1)])
    w = 1
    while q:
        lo, hi = q.popleft()
        mid = (lo + hi) // 2
        order[mid] = w
        w += 1
        if hi > mid:
            q.append((mid + 1, hi))
        if lo < mid:
            q.append((lo, mid - 1))
    return order


class SingleAlignOut(NamedTuple):
    """Per-candidate scoring results, K per read."""

    dist: torch.Tensor       # [B, K] int32 edit distance (AG edits if escalated)
    lv_dist: torch.Tensor    # [B, K] int32 pre-clipping LV distance
    indels: torch.Tensor     # [B, K] int32 indel bases on the LV path
    log_prob: torch.Tensor   # [B, K] float32 ln match probability
    ag_score: torch.Tensor   # [B, K] int32 affine-gap score (selection key)
    end_loc: torch.Tensor    # [B, K] int64 exclusive alignment end in genome
    body_loc: torch.Tensor   # [B, K] int64 alignment body start
    cand_loc: torch.Tensor   # [B, K] int64 raw candidate location
    escalated: torch.Tensor  # [B, K] bool affine-gap rescoring used
    clip_before: torch.Tensor  # [B, K] int32 AG soft clip (pattern head)
    clip_after: torch.Tensor   # [B, K] int32 AG soft clip (pattern tail)
    seed_off: torch.Tensor   # [B, K] int32 anchoring seed offset
    direction: torch.Tensor  # [B, K] int32 0=forward 1=RC
    valid: torch.Tensor      # [B, K] bool candidate existed and scored <= max_k
    len_eff: torch.Tensor    # [B] int32 clipped length
    popular: torch.Tensor    # [B] int32 popular seeds skipped
    n_lookups: torch.Tensor  # [B] int32 seed lookups performed (stats)
    truncated: torch.Tensor  # [B] bool some lookup overflowed the gather cap


class Tier1Out(NamedTuple):
    """Candidate generation + gapless prescreen results (two-phase API).

    The host inspects gapless_dist/weight, decides which candidates need
    the DP tier, and calls score_rows on just those. Integer fields keep
    snap_tpu's narrow types, except cand_loc: int64 holding uint32 values
    (torch has no usable uint32)."""

    cand_loc: torch.Tensor      # [B, K] int64 (uint32 values)
    seed_off: torch.Tensor      # [B, K] int16
    direction: torch.Tensor     # [B, K] uint8
    valid: torch.Tensor         # [B, K] bool candidate exists
    weight: torch.Tensor        # [B, K] uint8 seed votes (saturated)
    gapless_dist: torch.Tensor  # [B, K] int16 mismatches at anchored offset
    gapless_logp: torch.Tensor  # [B, K] float32
    len_eff: torch.Tensor       # [B] int32
    popular: torch.Tensor       # [B] int32
    n_lookups: torch.Tensor     # [B] int32
    truncated: torch.Tensor     # [B] bool gather cap overflowed (redo wide)
    big_indel: torch.Tensor     # [B, K] int16 phase-2a score-raise bonus


class SubsetOut(NamedTuple):
    """Full DP + affine-gap results for a compacted row subset."""

    dist: torch.Tensor
    lv_dist: torch.Tensor
    indels: torch.Tensor
    log_prob: torch.Tensor
    ag_score: torch.Tensor
    end_loc: torch.Tensor
    body_loc: torch.Tensor
    escalated: torch.Tensor
    clip_before: torch.Tensor
    clip_after: torch.Tensor
    valid: torch.Tensor
    lv_log_prob: torch.Tensor


# ------------------------------------------------------------ small helpers


def _arange(n: int, like: torch.Tensor, dtype=i64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)


def _topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, equal values lowest
    index first (jax.lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose order is the IEEE total order of float32 x."""
    b = x.contiguous().view(i32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _lexsort_rows(keys) -> torch.Tensor:
    """Per-row permutation sorting [B, K] rows lexicographically by keys
    (most significant first), stable: chained stable sorts from the
    least significant key."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else torch.gather(k, 1, perm)
        idx = torch.sort(kk, dim=1, stable=True).indices
        perm = idx if perm is None else torch.gather(perm, 1, idx)
    return perm


def _u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor as int32 bits (uint32 bitcast)."""
    lo = v.to(i64) & U32
    return (lo - ((lo >> 31) << 32)).to(i32)


def _logq_table_np() -> np.ndarray:
    """[256] float32 ln P(base wrong) for every phred+33 byte: snap_tpu's
    float32 formula step for step, with exp and log evaluated in float64
    and rounded once to float32, so the values do not depend on any
    device's float32 exp/log approximation."""
    q = np.arange(256, dtype=np.float32)
    arg = np.float32(-np.log(10.0) / 10.0) * (q - np.float32(33.0))
    e10 = np.exp(arg.astype(np.float64)).astype(np.float32)
    err = np.float32(1.0) - (np.float32(1.0) - e10) * np.float32(1.0 - SNP_PROB)
    ok = (q >= 33) & (q < 127)
    x = np.where(ok, err, np.float32(SNP_PROB)).astype(np.float32)
    return np.log(x.astype(np.float64)).astype(np.float32)


_LOGQ_TABLES: dict[torch.device, torch.Tensor] = {}


def device_logq(quals: torch.Tensor) -> torch.Tensor:
    """ln P(base wrong) from raw phred+33 bytes (the log of
    constants.phred_to_probability_table): a lookup in a 256-entry table
    made once on the host, so the CPU and the card give the same bits.
    snap_tpu computes the formula elementwise only because a gather is
    slow on the TPU."""
    tab = _LOGQ_TABLES.get(quals.device)
    if tab is None:
        tab = torch.from_numpy(_logq_table_np()).to(quals.device)
        _LOGQ_TABLES[quals.device] = tab
    return tab[quals.to(i64)]


def clip_back(quals: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Default ClipBack: drop the trailing run of '#'-quality bases."""
    B, L = quals.shape
    pos = _arange(L, quals, i32)[None, :]
    good = (quals != QUAL_CLIP) & (pos < lens[:, None])
    last_good = torch.where(good, pos, -1).max(dim=1).values
    return (last_good + 1).to(i32)


def apply_front_clip(
    bases: np.ndarray, quals: np.ndarray, lens: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side ClipFront (Read.h:88-108): shift each read left past its
    leading run of '#'-quality bases. Returns (bases, quals, lens,
    front_clip) as fresh arrays."""
    B, L = bases.shape
    pos = np.arange(L, dtype=np.int32)[None, :]
    good = (quals != QUAL_CLIP) & (pos < lens[:, None])
    first_good = np.where(
        good.any(axis=1), good.argmax(axis=1), lens
    ).astype(np.int32)
    fc = np.minimum(first_good, lens)
    src = pos + fc[:, None]
    srcc = np.minimum(src, L - 1)
    valid = src < lens[:, None]
    out_b = np.where(valid, np.take_along_axis(bases, srcc, axis=1), 4)
    out_q = np.where(valid, np.take_along_axis(quals, srcc, axis=1), 0)
    return (
        out_b.astype(np.uint8),
        out_q.astype(np.uint8),
        (lens - fc).astype(np.int32),
        fc,
    )


def reverse_complement_reads(
    bases: torch.Tensor, quals: torch.Tensor, len_eff: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RC of the clipped read, left-aligned; quals reversed to match."""
    B, L = bases.shape
    pos = _arange(L, bases)[None, :]
    le = len_eff.to(i64)[:, None]
    src = (le - 1 - pos).clamp(0, L - 1)
    valid = pos < le
    fb = torch.gather(bases, 1, src)
    fq = torch.gather(quals, 1, src)
    comp = torch.where(fb < 4, 3 - fb, fb)
    rc_bases = torch.where(valid, comp, 4).to(torch.uint8)
    rc_quals = torch.where(valid, fq, 0).to(torch.uint8)
    return rc_bases, rc_quals


def window_words(arr: torch.Tensor, w0: torch.Tensor, WW: int) -> torch.Tensor:
    """[N, WW] consecutive words from per-row word index w0 (clamped)."""
    idx = (w0[:, None] + _arange(WW, w0)[None, :]).clamp(0, arr.shape[0] - 1)
    return arr[idx]


def align_words(w: torch.Tensor, ph: torch.Tensor, lane_bits: int) -> torch.Tensor:
    """Funnel-shift adjacent uint32 words (int32 bits) by the per-row
    phase so lane 0 holds the window's first base. Returns int32 bits."""
    w = w.to(i64) & U32
    sh = (lane_bits * ph).to(i64)[:, None]
    lo = w[:, :-1] >> sh
    hi = (w[:, 1:] << (32 - sh)) & U32
    return _u32_to_i32(lo | hi)


def _pack_pat16(mat: torch.Tensor, PW: int) -> tuple[torch.Tensor, torch.Tensor]:
    """2-bit-packed pattern words and N bits (even positions), 16 bases
    per word, padded with N. Returns int32 bits [B, PW] each."""
    B, L = mat.shape
    m = torch.full((B, PW * 16), 4, dtype=mat.dtype, device=mat.device)
    m[:, :L] = mat
    w = m.reshape(B, PW, 16).to(i64)
    sh = 2 * _arange(16, mat)[None, None, :]
    codes = (torch.where(w < 4, w, 0) << sh).sum(dim=2)
    nb = ((w >= 4).to(i64) << sh).sum(dim=2)
    return _u32_to_i32(codes), _u32_to_i32(nb)


# ----------------------------------------------------------- tier 2 scoring


def _score_rows(
    didx: DeviceIndex,
    s_pat: torch.Tensor,    # [M, L] oriented pattern codes (uint8)
    s_logq: torch.Tensor,   # [M, L] f32 ln P(error)
    s_plen: torch.Tensor,   # [M] i32 clipped lengths
    s_loc: torch.Tensor,    # [M] i64 candidate locations
    s_off: torch.Tensor,    # [M] i32 anchoring seed offsets
    s_dir: torch.Tensor,    # [M] i32 directions
    sel_live: torch.Tensor, # [M] bool
    params: AlignParams,
    L: int,
    s_bonus: torch.Tensor | None = None,  # [M] i32 phase-2a score raise
) -> SubsetOut:
    """Tier 2: affine-gap head/tail extensions and seed-anchored
    Landau-Vishkin (BaseAligner.cpp:1160-1290) on M rows."""
    AG_W = max(params.max_k, params.mki)
    if s_bonus is None:
        s_bonus = torch.zeros_like(s_plen)
    s_plen = s_plen.to(i32)
    mk_eff = torch.clamp_max(params.max_k + s_bonus, 126)
    TW = L + AG_W + 1

    G = didx.genome.shape[0]
    seed = params.seed_len
    tail_start = (s_off + seed).to(i32)
    jj = _arange(L, s_pat, i32)[None, :]
    tcols = _arange(TW, s_pat)[None, :]

    def gather_window(start):
        """[M, TW] forward genome window; out-of-bounds reads PAD (5)."""
        pos = start[:, None] + tcols
        inb = (pos >= 0) & (pos < G)
        return torch.where(inb, didx.genome[pos.clamp(0, G - 1)], 5).to(torch.uint8)

    def take(a, idx, ok, fill):
        v = torch.gather(a, 1, idx.clamp(0, L - 1).to(i64))
        return torch.where(ok, v, fill).contiguous()

    t_idx = jj + tail_start[:, None]
    t_ok = t_idx < s_plen[:, None]
    tail_pat = take(s_pat, t_idx, t_ok, 4).to(torch.uint8)
    tail_logq = take(s_logq, t_idx, t_ok, 0.0)
    tail_plen = torch.clamp_min(s_plen - tail_start, 0).to(i32)
    tail_text = gather_window(s_loc + tail_start.to(i64))
    tail_tlen = torch.clamp_max(tail_plen + params.max_k + s_bonus, TW - 1).to(i32)
    ebonus_tail = torch.where(s_dir == 1, params.ag_b5, params.ag_b3).to(i32)
    tail = affine_extend_cuda(
        tail_pat, tail_logq, tail_plen, tail_text, tail_tlen,
        s_plen, ebonus_tail,
        match=params.ag_match, sub=params.ag_sub,
        gap_open=params.ag_open, gap_extend=params.ag_extend,
    )

    h_idx = s_off[:, None] - 1 - jj
    h_ok = h_idx >= 0
    head_pat = take(s_pat, h_idx, h_ok, 4).to(torch.uint8)
    head_logq = take(s_logq, h_idx, h_ok, 0.0)
    head_plen = s_off.to(i32)
    head_text = torch.flip(
        gather_window(s_loc + s_off.to(i64) - TW), dims=(1,)
    ).contiguous()
    head_tlen = torch.clamp_max(head_plen + params.max_k + s_bonus, TW - 1).to(i32)
    ebonus_head = torch.where(s_dir == 1, params.ag_b3, params.ag_b5).to(i32)
    head = affine_extend_cuda(
        head_pat, head_logq, head_plen, head_text, head_tlen,
        s_plen, ebonus_head,
        match=params.ag_match, sub=params.ag_sub,
        gap_open=params.ag_open, gap_extend=params.ag_extend,
    )

    # seed-anchored Landau-Vishkin: tail forward from the seed end plus
    # reverse LV over the head, on the rows the affine extensions use
    # (BaseAligner.cpp:1160-1176, LandauVishkin.h:100)
    lv_tail = fitting_edit_distance_cuda(tail_pat, tail_logq, tail_plen, tail_text, anchored=True)
    lv_head = fitting_edit_distance_cuda(head_pat, head_logq, head_plen, head_text, anchored=True)
    t_empty = tail_plen == 0
    h_empty = head_plen == 0
    zf = torch.zeros((), dtype=f32, device=s_pat.device)
    t_dist = torch.where(t_empty, 0, lv_tail.dist)
    h_dist = torch.where(h_empty, 0, lv_head.dist)
    t_lp = torch.where(t_empty, zf, lv_tail.log_prob)
    h_lp = torch.where(h_empty, zf, lv_head.log_prob)
    seed_lp = float(np.float32(seed) * np.float32(LOG_PERFECT))
    s_lv_dist = (t_dist + h_dist).to(i32)
    s_lv_logp = t_lp + h_lp + seed_lp
    lv_indels = torch.where(t_empty, 0, lv_tail.indels) + torch.where(
        h_empty, 0, lv_head.indels
    )
    s_end = (
        s_loc
        + (s_off + seed).to(i64)
        + torch.where(t_empty, 0, lv_tail.end_col).to(i64)
    )

    s_lv_ok = sel_live & (s_lv_dist <= mk_eff)
    ag_ok = tail.valid & head.valid
    ag_score = tail.score + head.score + seed - 2 * s_plen
    ag_edits = tail.edits + head.edits
    ag_logp = tail.log_prob + head.log_prob + seed_lp
    ag_body_loc = s_loc + (s_off - head.text_used).to(i64)

    if params.use_affine_gap:
        # escalation gate: score1 + score2 > maxKForSameAlignment
        # (BaseAligner.cpp:1204)
        s_esc = s_lv_ok & (s_lv_dist > params.max_k_same)
    else:  # -G-: never escalate to affine gap
        s_esc = torch.zeros_like(s_lv_ok)
    s_dist = torch.where(s_esc, ag_edits, s_lv_dist).to(i32)
    s_logp = torch.where(s_esc, ag_logp, s_lv_logp)
    s_agsc = torch.where(
        s_esc, ag_score,
        s_plen - (params.ag_match + params.ag_sub) * s_lv_dist,
    ).to(i32)
    s_ok = s_lv_ok & torch.where(s_esc, ag_ok, True)
    s_clip_b = torch.where(s_esc, head.pattern_clip, 0).to(i32)
    s_clip_a = torch.where(s_esc, tail.pattern_clip, 0).to(i32)
    s_body = torch.where(s_esc, ag_body_loc, s_loc)
    s_indels = torch.where(s_esc, 1 << 20, lv_indels).to(i32)
    return SubsetOut(
        dist=s_dist, lv_dist=s_lv_dist, indels=s_indels,
        log_prob=s_logp, ag_score=s_agsc,
        end_loc=s_end, body_loc=s_body, escalated=s_esc,
        clip_before=s_clip_b, clip_after=s_clip_a, valid=s_ok,
        lv_log_prob=s_lv_logp,
    )


# ----------------------------------------------------- candidate generation


def _align_impl(
    didx: DeviceIndex,
    bases: torch.Tensor,   # [B, L] uint8
    quals: torch.Tensor,   # [B, L] uint8
    lens: torch.Tensor,    # [B] int32
    params: AlignParams,
    return_lowest: bool = False,
):
    """Candidate generation (snap_tpu's _align_impl with cand_only=True):
    returns the 9-array candidate bundle, and SNAP's seed-loop stop
    bound when return_lowest."""
    B, L = bases.shape
    S = params.num_lookups
    H = params.hit_cap
    K = params.max_cand
    seed = params.seed_len

    len_eff = clip_back(quals, lens) if params.clip_back else lens.to(i32)

    # seed offsets in SNAP probe order (first pass 0, s, 2s, ..., then
    # wrapped rounds; BaseAligner.cpp:451-526)
    fwd_all, rc_all, valid_all = pack_read_seeds(bases, seed)  # [B, P]
    P = L - seed + 1
    wrap_of_residue = snap_seed_wrap_order(seed)
    pos = np.arange(P, dtype=np.int32)
    rank_static = wrap_of_residue[pos % seed] * (P // seed + 2) + pos // seed
    rank = torch.as_tensor(rank_static, dtype=i32, device=bases.device)[None, :]
    INF_RANK = 1 << 30
    posP = _arange(P, bases, i32)[None, :]
    usable = valid_all & (posP <= (len_eff - seed)[:, None])
    ranks = torch.where(usable, rank, INF_RANK).to(i32)
    # the S smallest ranks = the offsets SNAP would probe, in order
    order = torch.sort(ranks, dim=1, stable=True).indices[:, :S]
    rank_s = torch.gather(ranks, 1, order)
    offsets = order.to(i32)
    seed_fwd = torch.gather(fwd_all, 1, order)
    seed_rc = torch.gather(rc_all, 1, order)
    seed_ok = rank_s < INF_RANK

    canonical = u64_min(seed_fwd, seed_rc)
    read_is_canon = u64_le(seed_fwd, seed_rc)

    found, start, n0, n1 = probe(didx, canonical.reshape(-1), params.max_probe)
    found = found & seed_ok.reshape(-1)
    start0 = start
    start1 = start + n0.to(i64)
    ric = read_is_canon.reshape(-1)
    f_start = torch.where(ric, start0, start1)
    f_n = torch.where(ric, n0, n1)
    r_start = torch.where(ric, start1, start0)
    r_n = torch.where(ric, n1, n0)

    # popular-seed skip, per direction
    pop_f = found & (f_n > params.max_hits)
    pop_r = found & (r_n > params.max_hits)
    popular = (
        pop_f.reshape(B, S).sum(dim=1) + pop_r.reshape(B, S).sum(dim=1)
    ).to(i32)
    if params.explore_popular:
        f_n = torch.where(found, f_n, 0)
        r_n = torch.where(found, r_n, 0)
    else:
        f_n = torch.where(found & ~pop_f, f_n, 0)
        r_n = torch.where(found & ~pop_r, r_n, 0)

    lowest_possible = None
    if return_lowest:
        # SNAP's seed-loop stop bound: after each applied seed,
        # lowestPossibleScoreOfAnyUnseenLocation[dir] = max over rounds
        # of nSeedsApplied[dir] // (wrapCount + 1) (BaseAligner.cpp:993-1012)
        DIV = P // seed + 2
        wrap_round = torch.where(seed_ok, torch.div(rank_s, DIV, rounding_mode="floor"), 0).to(i32)
        if params.explore_popular:
            ap_f = seed_ok.to(i32)
            ap_r = ap_f
        else:
            ap_f = (seed_ok & ~pop_f.reshape(B, S)).to(i32)
            ap_r = (seed_ok & ~pop_r.reshape(B, S)).to(i32)
        den = wrap_round + 1
        low_f = torch.where(
            seed_ok, torch.div(torch.cumsum(ap_f, dim=1), den, rounding_mode="floor"), 0
        ).max(dim=1).values
        low_r = torch.where(
            seed_ok, torch.div(torch.cumsum(ap_r, dim=1), den, rounding_mode="floor"), 0
        ).max(dim=1).values
        lowest_possible = torch.minimum(low_f, low_r).to(i32)

    f_locs, f_valid = gather_hits(didx.hits, f_start, f_n, H)  # [B*S, H]
    r_locs, r_valid = gather_hits(didx.hits, r_start, r_n, H)

    # candidate locations
    off_flat = offsets.reshape(-1, 1).to(i64)
    le_flat = torch.repeat_interleave(len_eff, S).reshape(-1, 1).to(i64)
    cand_f = f_locs - off_flat
    cand_r = r_locs - (le_flat - seed - off_flat)

    # key packs (dir, location, probe-order index, offset value); dedup
    # ignores everything below the location, so each candidate carries
    # the FIRST-probed seed's offset (SNAP's candidate->seedOffset)
    OFFV_BITS = 10 if L <= 1024 else 0
    PROBE_BITS = 10
    OFF_BITS = PROBE_BITS + OFFV_BITS
    BIG = 1 << (42 + OFF_BITS)
    INF_KEY = 3 << 61  # sorts after every valid key
    probe_ix = _arange(S, bases)[None, :, None].expand(B, S, H).reshape(B * S, H)
    if OFFV_BITS:
        payload = (probe_ix << OFFV_BITS) | off_flat
    else:
        payload = probe_ix
    key_f = torch.where(f_valid, (cand_f << OFF_BITS) | payload, INF_KEY)
    key_r = torch.where(r_valid, ((cand_r << OFF_BITS) | payload) + BIG, INF_KEY)
    keys = torch.cat([key_f.reshape(B, S * H), key_r.reshape(B, S * H)], dim=1)
    M = 2 * S * H
    keys = torch.sort(keys, dim=1).values

    # run-length dedup + weights on (dir, location) only
    kid = keys >> OFF_BITS
    is_start = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=bases.device),
         kid[:, 1:] != kid[:, :-1]], dim=1,
    )
    posm = _arange(M, bases, i32)[None, :]
    start_pos = torch.where(is_start, posm, M)
    # next run start after each position: reverse cummin
    nxt = torch.flip(torch.cummin(torch.flip(start_pos, dims=(1,)), dim=1).values, dims=(1,))
    next_start = torch.cat(
        [nxt[:, 1:], torch.full((B, 1), M, dtype=nxt.dtype, device=bases.device)], dim=1
    )
    weight = torch.where(is_start & (keys < INF_KEY), next_start - posm, -1).to(i32)

    wi = _topk_indices(weight, K)  # [B, K]
    wv = torch.gather(weight, 1, wi)
    cand_keys = torch.gather(keys, 1, wi)
    # -ms minWeightToCheck: candidates below the seed-vote floor are
    # never scored
    cand_valid = wv >= max(1, params.min_weight)
    cand_weight = torch.clamp_min(wv, 0).to(i32)
    cand_dir = (cand_keys >= BIG).to(i32)
    stripped = torch.where(cand_dir == 1, cand_keys - BIG, cand_keys)
    cand_loc = stripped >> OFF_BITS
    cand_loc = torch.where(cand_valid, cand_loc, 0)
    # offset payload -> oriented read offset; RC-oriented patterns
    # anchor at len_eff - seed_len - offset (BaseAligner.cpp:591-606)
    if OFFV_BITS:
        off_of_probe = stripped & ((1 << OFFV_BITS) - 1)
    else:
        cand_probe = stripped & ((1 << PROBE_BITS) - 1)
        off_of_probe = torch.gather(offsets.to(i64), 1, cand_probe)
    cand_off = torch.where(
        cand_dir == 1, len_eff[:, None].to(i64) - seed - off_of_probe, off_of_probe
    ).to(i32)
    cand_off = torch.where(cand_valid, torch.clamp_min(cand_off, 0), 0).to(i32)

    # per-read truncation: some usable lookup had more hits than the
    # gather cap, or more distinct in-budget candidates than the K tile
    n_cand = (weight >= max(1, params.min_weight)).sum(dim=1)
    trunc = (
        (f_n > H).reshape(B, S).any(dim=1)
        | (r_n > H).reshape(B, S).any(dim=1)
        | (n_cand > K)
    )
    bundle = (
        cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
        popular, trunc, len_eff, seed_ok.sum(dim=1).to(i32),
    )
    if return_lowest:
        return bundle, lowest_possible
    return bundle


# ------------------------------------------------------------ two-tier score


def _tier1_gapless(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [B, L] uint8
    rc_bases: torch.Tensor,  # [B, L] uint8
    logq_f: torch.Tensor,    # [B, L] f32
    logq_r: torch.Tensor,    # [B, L] f32
    len_eff: torch.Tensor,   # [B] int32
    cand_loc: torch.Tensor,  # [B, K] int64
    cand_dir: torch.Tensor,  # [B, K] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tier 1: the gapless prescreen over packed words (SNAP's 64-bit XOR
    scan, LandauVishkin.h:377-407) of every candidate at its anchored
    offset. Returns (gapless_dist [B*K] i32, gapless_logp [B*K] f32)."""
    B, L = bases.shape
    K = cand_loc.shape[1]
    G = didx.genome.shape[0]
    loc_c = cand_loc.reshape(-1).clamp(0, G - 1)
    w0 = torch.div(loc_c, 16, rounding_mode="floor")
    phase = (loc_c % 16).to(i32)
    WW = L // 16 + 2
    PW = (L + 15) // 16
    t_w = align_words(window_words(didx.genome_packed, w0, WW), phase, 2)[:, :PW]
    bad_w = align_words(window_words(didx.genome_bad16, w0, WW), phase, 2)[:, :PW]
    fw, fbad = _pack_pat16(bases, PW)
    rw, rbad = _pack_pat16(rc_bases, PW)
    gd2, glp_err = gapless_prescreen_cuda(
        t_w.reshape(B, K * PW).contiguous(), bad_w.reshape(B, K * PW).contiguous(),
        fw, rw, fbad, rbad, logq_f.contiguous(), logq_r.contiguous(),
        cand_dir.to(i32).contiguous(), len_eff.to(i32).contiguous(), K, PW,
    )
    dist = gd2.reshape(-1)
    plen = len_eff.to(i32).repeat_interleave(K)
    logp = glp_err.reshape(-1) + (plen - dist).to(f32) * LOG_PERFECT
    return dist, logp


def _score_from_candidates(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [B, L] uint8
    rc_bases: torch.Tensor,  # [B, L] uint8 (RC of clipped read)
    quals: torch.Tensor,
    rc_quals: torch.Tensor,
    len_eff: torch.Tensor,   # [B] int32
    cand_loc: torch.Tensor,  # [B, K] int64
    cand_off: torch.Tensor,  # [B, K] int32
    cand_dir: torch.Tensor,  # [B, K] int32
    cand_valid: torch.Tensor,
    cand_weight: torch.Tensor,
    popular: torch.Tensor,
    truncated: torch.Tensor,
    n_lookups: torch.Tensor,
    params: AlignParams,
    dp_rows: int | None = None,
    tier1_only: bool = False,
    max_k_bonus: torch.Tensor | None = None,  # [B, K] i32 phase-2a raises
):
    """Two-tier scoring of a [B, K] candidate set. Returns
    (SingleAlignOut, needs_total [] int32), or Tier1Out after the
    gapless tier when tier1_only."""
    B, L = bases.shape
    K = cand_loc.shape[1]
    BK = B * K
    dev = bases.device
    if max_k_bonus is None:
        flat_bonus = torch.zeros((BK,), dtype=i32, device=dev)
    else:
        flat_bonus = max_k_bonus.reshape(-1).to(i32)
    flat_mk_eff = torch.clamp_max(params.max_k + flat_bonus, 126)

    flat_dir = cand_dir.reshape(-1)
    read_ix = torch.repeat_interleave(_arange(B, bases), K)
    logq_f = device_logq(quals)
    logq_r = device_logq(rc_quals)
    plen = len_eff[read_ix]
    flat_loc = cand_loc.reshape(-1)
    flat_off = cand_off.reshape(-1)
    flat_valid = cand_valid.reshape(-1)

    gapless_dist, gapless_logp = _tier1_gapless(
        didx, bases, rc_bases, logq_f, logq_r, len_eff, cand_loc, cand_dir
    )

    if tier1_only:
        return Tier1Out(
            cand_loc=cand_loc.to(i64) & U32,
            seed_off=cand_off.to(torch.int16),
            direction=cand_dir.to(torch.uint8),
            valid=cand_valid,
            weight=torch.clamp_max(cand_weight, 255).to(torch.uint8),
            gapless_dist=torch.clamp_max(gapless_dist.reshape(B, K), 1 << 14).to(
                torch.int16
            ),
            gapless_logp=gapless_logp.reshape(B, K),
            len_eff=len_eff,
            popular=popular,
            n_lookups=n_lookups,
            truncated=truncated,
            big_indel=torch.clamp_max(flat_bonus, 1023).to(torch.int16).reshape(B, K),
        )

    # ---- tier 2: compact the candidates that need gaps
    GAPLESS_OK = params.max_k_same
    flat_weight = cand_weight.reshape(-1)
    needs_dp = flat_valid & (gapless_dist > GAPLESS_OK)
    # a read with NO good gapless candidate gets its top-2 weight-ranked
    # candidates through the DP regardless of weight
    read_min_gapless = torch.where(
        cand_valid, gapless_dist.reshape(B, K), 1 << 20
    ).min(dim=1).values
    read_needs = (read_min_gapless > GAPLESS_OK)[:, None]
    kpos = _arange(K, bases, i32)[None, :]
    promote = (read_needs & (kpos < 2)).reshape(-1)
    needs_dp = needs_dp & ((flat_weight >= 2) | promote)
    M = min(dp_rows, BK) if dp_rows is not None else max(BK // 8, min(BK, 64))
    # overflow priority: promoted top-2 first, then by weight
    sel_key = torch.where(
        needs_dp, flat_weight + torch.where(promote, 1 << 20, 0), 0
    ).to(i32)
    sel_idx = _topk_indices(sel_key, M)
    sel_live = needs_dp[sel_idx]

    sel_read = read_ix[sel_idx]
    sel_rc = (flat_dir[sel_idx] == 1)[:, None]
    pat_sel = torch.where(sel_rc, rc_bases[sel_read], bases[sel_read])
    logq_sel = torch.where(sel_rc, logq_r[sel_read], logq_f[sel_read])
    sub = _score_rows(
        didx, pat_sel, logq_sel, plen[sel_idx],
        flat_loc[sel_idx], flat_off[sel_idx], flat_dir[sel_idx],
        sel_live, params, L, s_bonus=flat_bonus[sel_idx],
    )

    # ---- combine tiers: scatter the subset results over the gapless
    def scatter(base, vals):
        out = base.clone()
        out[sel_idx] = torch.where(sel_live, vals.to(base.dtype), base[sel_idx])
        return out

    gl_ok = flat_valid & ~needs_dp & (gapless_dist <= flat_mk_eff)
    zeros_i = torch.zeros((BK,), dtype=i32, device=dev)
    dist = scatter(gapless_dist, sub.dist)
    lv_dist = scatter(gapless_dist, sub.lv_dist)
    log_prob = scatter(gapless_logp, sub.log_prob)
    agsc = scatter(
        (plen - (params.ag_match + params.ag_sub) * gapless_dist).to(i32), sub.ag_score
    )
    end_loc = scatter(flat_loc + plen.to(i64), sub.end_loc)
    body_loc = scatter(flat_loc, sub.body_loc)
    ok = scatter(gl_ok, sub.valid)
    esc = scatter(torch.zeros_like(gl_ok), sub.escalated)
    clip_b = scatter(zeros_i, sub.clip_before)
    clip_a = scatter(zeros_i, sub.clip_after)
    indels = scatter(zeros_i, sub.indels)

    out = SingleAlignOut(
        dist=dist.reshape(B, K),
        lv_dist=lv_dist.reshape(B, K),
        indels=indels.reshape(B, K),
        log_prob=log_prob.reshape(B, K),
        ag_score=agsc.reshape(B, K),
        end_loc=end_loc.reshape(B, K),
        body_loc=body_loc.reshape(B, K),
        cand_loc=cand_loc,
        escalated=esc.reshape(B, K),
        clip_before=clip_b.reshape(B, K),
        clip_after=clip_a.reshape(B, K),
        seed_off=cand_off,
        direction=cand_dir,
        valid=ok.reshape(B, K),
        len_eff=len_eff,
        popular=popular,
        n_lookups=n_lookups,
        truncated=truncated,
    )
    return out, needs_dp.sum().to(i32)


# ------------------------------------------------------- two-phase host API


def score_candidates(
    didx: DeviceIndex,
    bases: torch.Tensor,       # [B, L] uint8
    quals: torch.Tensor,       # [B, L] uint8
    len_eff: torch.Tensor,     # [B] int32 (host-computed clip)
    cand_loc: torch.Tensor,    # [B, K] int64
    cand_off: torch.Tensor,    # [B, K] int32 oriented anchor offsets
    cand_dir: torch.Tensor,    # [B, K] int32
    cand_valid: torch.Tensor,  # [B, K] bool
    cand_weight: torch.Tensor, # [B, K] int32
    popular: torch.Tensor,     # [B] int32
    params: AlignParams,
    tier1_only: bool = True,
    truncated: torch.Tensor | None = None,    # [B] bool
    max_k_bonus: torch.Tensor | None = None,  # [B, K] i32 phase-2a raises
) -> Tier1Out | SingleAlignOut:
    """Score an injected candidate set (the wide-hit redo pass and, later,
    the paired-end intersection): the same two-tier scoring the device
    candidate path uses, on candidates generated elsewhere."""
    rc_bases, rc_quals = reverse_complement_reads(bases, quals, len_eff)
    B = bases.shape[0]
    dev = bases.device
    res = _score_from_candidates(
        didx, bases, rc_bases, quals, rc_quals, len_eff,
        cand_loc, cand_off, cand_dir, cand_valid, cand_weight, popular,
        torch.zeros((B,), dtype=torch.bool, device=dev) if truncated is None else truncated,
        torch.zeros((B,), dtype=i32, device=dev),
        params, tier1_only=tier1_only, max_k_bonus=max_k_bonus,
    )
    return res if tier1_only else res[0]


def align_single_device(
    didx: DeviceIndex,
    bases: torch.Tensor,   # [B, L] uint8
    quals: torch.Tensor,   # [B, L] uint8
    lens: torch.Tensor,    # [B] int32
    params: AlignParams,
) -> SingleAlignOut:
    """Monolithic single call (the mesh / dry-run / tests path):
    candidates, then both scoring tiers on every candidate."""
    (cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
     popular, trunc, len_eff, n_lookups) = _align_impl(didx, bases, quals, lens, params)
    rc_bases, rc_quals = reverse_complement_reads(bases, quals, len_eff)
    return _score_from_candidates(
        didx, bases, rc_bases, quals, rc_quals, len_eff,
        cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
        popular, trunc, n_lookups, params, tier1_only=False,
    )[0]


def align_tier1(
    didx: DeviceIndex,
    bases: torch.Tensor,
    quals: torch.Tensor,
    lens: torch.Tensor,
    params: AlignParams,
) -> Tier1Out:
    """Phase 1 of the two-phase driver path: candidates + gapless."""
    (cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
     popular, trunc, len_eff, n_lookups) = _align_impl(didx, bases, quals, lens, params)
    rc_bases, rc_quals = reverse_complement_reads(bases, quals, len_eff)
    return _score_from_candidates(
        didx, bases, rc_bases, quals, rc_quals, len_eff,
        cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
        popular, trunc, n_lookups, params, tier1_only=True,
    )


def score_rows(
    didx: DeviceIndex,
    bases: torch.Tensor,     # [B, L] (possibly front-clipped) read codes
    quals: torch.Tensor,
    len_eff: torch.Tensor,   # [B] i32 from Tier1Out
    read_ix: torch.Tensor,   # [M] i64 row index per selected candidate
    dirs: torch.Tensor,      # [M] i32
    locs: torch.Tensor,      # [M] i64
    offs: torch.Tensor,      # [M] i32
    live: torch.Tensor,      # [M] bool
    params: AlignParams,
    bonus: torch.Tensor | None = None,  # [M] i32 phase-2a score raises
) -> SubsetOut:
    """Phase 2: DP + affine-gap scoring of host-selected candidate rows
    (M is a power of two; dead rows, live=False, are padding)."""
    L = bases.shape[1]
    rc_bases, rc_quals = reverse_complement_reads(bases, quals, len_eff)
    ri = read_ix.to(i64)
    rc = (dirs == 1)[:, None]
    pat = torch.where(rc, rc_bases[ri], bases[ri]).contiguous()
    pat_logq = device_logq(torch.where(rc, rc_quals[ri], quals[ri]))
    return _score_rows(
        didx, pat, pat_logq, len_eff[ri], locs.to(i64), offs.to(i32),
        dirs.to(i32), live, params, L,
        s_bonus=None if bonus is None else bonus.to(i32),
    )


def _pack_subset(sub: SubsetOut) -> torch.Tensor:
    """[M, 9] int32 view of a SubsetOut, fetched to the host in one copy
    (snap_tpu's layout: dist, lv_dist and ag_score at full width; indels
    saturated at 0x7FFF, since the host only tests zero/nonzero)."""
    w7 = (
        torch.clamp_max(sub.indels.to(i32), 0x7FFF)
        | (sub.escalated.to(i32) << 16)
        | (sub.valid.to(i32) << 17)
    )
    return torch.stack(
        [
            _u32_to_i32(sub.end_loc),
            _u32_to_i32(sub.body_loc),
            sub.log_prob.to(f32).contiguous().view(i32),
            sub.dist.to(i32),
            sub.lv_dist.to(i32),
            sub.ag_score.to(i32),
            (sub.clip_before.to(i32) & 0xFFFF) | (sub.clip_after.to(i32) << 16),
            w7,
            sub.lv_log_prob.to(f32).contiguous().view(i32),
        ],
        dim=1,
    )


def fetch_subset(sub: SubsetOut) -> SubsetOut:
    """device SubsetOut -> numpy SubsetOut via the packed transfer."""
    pk = np.ascontiguousarray(_pack_subset(sub).cpu().numpy())
    sx = lambda x: ((x & 0xFFFF) ^ 0x8000) - 0x8000
    return SubsetOut(
        dist=pk[:, 3],
        lv_dist=pk[:, 4],
        indels=(pk[:, 7] & 0x7FFF).astype(np.int32),
        log_prob=np.ascontiguousarray(pk[:, 2]).view(np.float32),
        ag_score=pk[:, 5],
        end_loc=pk[:, 0].astype(np.int64) & 0xFFFFFFFF,
        body_loc=pk[:, 1].astype(np.int64) & 0xFFFFFFFF,
        escalated=((pk[:, 7] >> 16) & 1).astype(bool),
        clip_before=sx(pk[:, 6]).astype(np.int32),
        clip_after=(pk[:, 6] >> 16).astype(np.int32),
        valid=((pk[:, 7] >> 17) & 1).astype(bool),
        lv_log_prob=np.ascontiguousarray(pk[:, 8]).view(np.float32),
    )


def _pack_tier1(t1: Tier1Out) -> tuple[torch.Tensor, torch.Tensor]:
    """Tier1Out's host-bound fields as two dense int32 tensors (snap_tpu's
    layout). cand words: w0 cand_loc (uint32 bits); w1 gapless_logp
    (float32 bits); w2 seed_off(0..15) | weight(16..23) | direction(24) |
    valid(25); w3 gapless_dist(0..15, saturated at 1<<14) |
    big_indel(16..25). Per read: len_eff | popular << 16, truncated."""
    w2 = (
        (t1.seed_off.to(i32) & 0xFFFF)
        | ((t1.weight.to(i32) & 0xFF) << 16)
        | (t1.direction.to(i32) << 24)
        | (t1.valid.to(i32) << 25)
    )
    cand = torch.stack(
        [
            _u32_to_i32(t1.cand_loc),
            t1.gapless_logp.to(f32).contiguous().view(i32),
            w2,
            t1.gapless_dist.to(i32) | (t1.big_indel.to(i32) << 16),
        ],
        dim=2,
    )
    per_read = torch.stack(
        [
            (t1.len_eff.to(i32) & 0xFFFF) | (t1.popular.to(i32) << 16),
            t1.truncated.to(i32),
        ],
        dim=1,
    )
    return cand, per_read


def two_phase_merge(
    didx: DeviceIndex,
    t1: Tier1Out,
    dev_bases: torch.Tensor,   # [B, L] device tensor from the tier-1 dispatch
    dev_quals: torch.Tensor,
    params: AlignParams,
    force_dp: bool = False,
) -> dict:
    """Host half of the two-phase path: fetch tier-1 results, decide which
    candidates need the DP tier (the rule _score_from_candidates applies
    on device), run score_rows on a power-of-two-padded subset, and merge
    into flat numpy [B, K] arrays for the record writers. force_dp (the
    edge-indel redo rows) sends every imperfect candidate to the DP,
    SNAP's always-LV scoring (BaseAligner.cpp:1160-1173)."""
    cand_pk, read_pk = (t.cpu().numpy() for t in _pack_tier1(t1))
    cand_pk = np.ascontiguousarray(cand_pk)
    cand_loc = (cand_pk[:, :, 0].astype(np.int64)) & 0xFFFFFFFF
    B, K = cand_loc.shape
    glp = np.ascontiguousarray(cand_pk[:, :, 1]).view(np.float32)
    w2 = cand_pk[:, :, 2]
    seed_off = (((w2 & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int32)
    weight = ((w2 >> 16) & 0xFF).astype(np.int32)
    direction = ((w2 >> 24) & 1).astype(np.int32)
    valid = ((w2 >> 25) & 1).astype(bool)
    gd = (cand_pk[:, :, 3] & 0xFFFF).astype(np.int32)
    big_indel = (cand_pk[:, :, 3] >> 16).astype(np.int32)
    mk_eff = np.minimum(params.max_k + big_indel, 126)
    r0 = read_pk[:, 0]
    len_eff = (((r0 & 0xFFFF) ^ 0x8000) - 0x8000).astype(np.int32)
    popular = (r0 >> 16).astype(np.int32)
    truncated = read_pk[:, 1].astype(bool)

    GOK = params.max_k_same
    if force_dp:
        needs = valid & (gd > 0)
    else:
        needs = valid & (gd > GOK)
        read_min = np.min(np.where(valid, gd, np.int32(1 << 20)), axis=1)
        promote = (read_min > GOK)[:, None] & (
            np.arange(K, dtype=np.int32)[None, :] < 2
        )
        needs &= (weight >= 2) | promote

    plen2 = len_eff[:, None].astype(np.int64)
    merged = {
        "dist": gd.astype(np.int64).copy(),
        "lv_dist": gd.astype(np.int64).copy(),
        "indels": np.zeros((B, K), np.int32),
        "log_prob": glp.astype(np.float64).copy(),
        "lv_log_prob": glp.astype(np.float64).copy(),
        "ag_score": (plen2 - (params.ag_match + params.ag_sub) * gd).astype(np.int64),
        "end_loc": cand_loc + plen2,
        "body_loc": cand_loc.copy(),
        "cand_loc": cand_loc,
        "escalated": np.zeros((B, K), bool),
        "clip_before": np.zeros((B, K), np.int32),
        "clip_after": np.zeros((B, K), np.int32),
        "seed_off": seed_off,
        "direction": direction,
        "valid": valid & ~needs & (gd <= mk_eff),
        "len_eff": len_eff,
        "popular": popular,
        "weight": weight,
        "truncated": truncated,
        "big_indel": big_indel,
    }

    idx = np.flatnonzero(needs.reshape(-1))
    if idx.size:
        M = 1 << max(5, int(np.ceil(np.log2(idx.size))))
        M = min(M, B * K)
        sel = np.zeros(M, dtype=np.int64)
        sel[: idx.size] = idx[:M]
        live = np.zeros(M, dtype=bool)
        live[: min(idx.size, M)] = True
        dev = dev_bases.device
        flat = lambda a: torch.from_numpy(np.ascontiguousarray(a.reshape(-1)[sel])).to(dev)
        sub = score_rows(
            didx, dev_bases, dev_quals, t1.len_eff,
            torch.from_numpy(sel // K).to(dev), flat(direction), flat(cand_loc),
            flat(seed_off), torch.from_numpy(live).to(dev), params,
            bonus=flat(big_indel),
        )
        sub = fetch_subset(sub)
        n = min(idx.size, M)
        rows, cols = idx[:n] // K, idx[:n] % K
        for name in ("dist", "lv_dist", "indels", "log_prob", "lv_log_prob",
                     "ag_score", "end_loc", "body_loc", "escalated",
                     "clip_before", "clip_after", "valid"):
            merged[name][rows, cols] = np.asarray(getattr(sub, name))[:n]
    return merged


# ---------------------------------------------------------- device finalize


class WinnerOut(NamedTuple):
    """Compact per-read winner (packed by pack_winners)."""

    found: torch.Tensor        # [B] bool any surviving candidate
    fallback: torch.Tensor     # [B] bool needs exact host finalize_read
    cand_k: torch.Tensor       # [B] int32 winner's candidate slot
    direction: torch.Tensor    # [B] uint8
    dist: torch.Tensor         # [B] int16
    mapq: torch.Tensor         # [B] uint8
    end_loc: torch.Tensor      # [B] int64 holding uint32 values
    body_loc: torch.Tensor     # [B] int64 holding uint32 values
    clip_before: torch.Tensor  # [B] int16
    clip_after: torch.Tensor   # [B] int16
    escalated: torch.Tensor    # [B] bool
    indels: torch.Tensor       # [B] int32
    len_eff: torch.Tensor      # [B] int16
    popular: torch.Tensor      # [B] int16
    valid_count: torch.Tensor  # [B] int16
    esc_count: torch.Tensor    # [B] int16
    truncated: torch.Tensor    # [B] bool hit-cap overflow: redo via wide pass
    edge_indel: torch.Tensor   # [B] bool gapless dist-2 winner with a
                               # one-indel dist-1 twin
    ag_flip: torch.Tensor      # [B] bool a single gap ties/beats the
                               # winner's substitutions
    dp_overflow: torch.Tensor  # [] bool DP tier truncated


def winner_flags(
    didx: DeviceIndex,
    bases: torch.Tensor,    # [B, L] device reads (front-clipped layout)
    len_eff: torch.Tensor,  # [B] effective (back-clipped) length
    dirs: torch.Tensor,     # [B] winner direction
    end_loc: torch.Tensor,  # [B] winner end location (int64)
    dist: torch.Tensor,     # [B] winner edit distance (int64)
    params: AlignParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two host emission screens on each read's chosen winner:
    one_indel_improves (a gapless dist-2 alignment admitting a one-indel
    dist-1 twin) and ag_restructure_possible (ReadWriter.cpp:231: the
    best single-gap(1..3)-plus-substitutions penalty ties/beats the
    all-substitution penalty). Returns ungated (edge_raw, ag_raw)."""
    B, L = bases.shape
    M3 = 3
    W = L + 2 * M3 + 1
    plen = torch.clamp_min(len_eff.to(i64), 0)
    start = end_loc.to(i64) - plen
    Gn = didx.genome.shape[0]
    ws = (start - M3).clamp(0, Gn - 1)
    # window from the packed words: lane unpack of the funnel-aligned
    # code and bad planes
    WN = W // 16 + 2
    w0 = torch.div(ws, 16, rounding_mode="floor")
    phase = (ws % 16).to(i32)
    aw = align_words(window_words(didx.genome_packed, w0, WN), phase, 2).to(i64) & U32
    ab16 = align_words(window_words(didx.genome_bad16, w0, WN), phase, 2).to(i64) & U32
    sh = 2 * _arange(16, bases)
    cw = (aw[:, :, None] >> sh[None, None, :]) & 3
    bw = (ab16[:, :, None] >> sh[None, None, :]) & 1
    Gw = torch.where(bw != 0, 4, cw).reshape(B, -1)[:, :W].to(torch.uint8)

    # oriented pattern: forward reads as-is, reverse = RC left-aligned
    rc, _ = reverse_complement_reads(bases, bases, len_eff.to(i32))
    P = torch.where((dirs == 1)[:, None], rc, bases)
    pos = _arange(L, bases)[None, :]
    in_read = pos < plen[:, None]
    plen32 = plen.to(i32)

    def eq(shift):  # pattern vs genome shifted by `shift` diagonals
        gs = Gw[:, M3 + shift : M3 + shift + L]
        return ((P == gs) & (P < 4) & (gs < 4)) | ~in_read

    eqs = {s: eq(s) for s in range(-M3, M3 + 1)}
    zero_col = torch.zeros((B, 1), dtype=i32, device=bases.device)
    cums = {
        s: torch.cat([zero_col, torch.cumsum((~eqs[s]).to(i32), dim=1).to(i32)], dim=1)
        for s in eqs
    }

    # ag_restructure screen: exact best single-gap cost
    unit = params.ag_match + params.ag_sub
    c0 = cums[0]
    kpos = _arange(L + 1, bases, i32)[None, :]
    in_split = kpos <= plen32[:, None]
    BIG = 1 << 30
    best = torch.full((B,), BIG, dtype=i32, device=bases.device)
    pidx = plen[:, None]

    def at_plen(c):
        return torch.gather(c, 1, pidx)[:, 0]

    for s in range(1, M3 + 1):
        base_pen = params.ag_open + s * params.ag_extend
        cs = cums[s]
        tot_s = at_plen(cs)
        cost_d = base_pen + unit * torch.where(
            in_split, c0 + (tot_s[:, None] - cs), BIG
        ).min(dim=1).values
        best = torch.minimum(best, cost_d.to(i32))
        cm = cums[-s]
        tot_m = at_plen(cm)
        suf = tot_m[:, None] - cm[:, s:]
        pre = c0[:, : L + 1 - s]
        ok_k = kpos[:, : L + 1 - s] <= (plen32[:, None] - s)
        cost_i = base_pen + s * params.ag_match + unit * torch.where(
            ok_k, pre + suf, BIG
        ).min(dim=1).values
        best = torch.minimum(best, cost_i.to(i32))
    ag_raw = best <= unit * dist.to(i32)

    # one-indel screen: diagonal prefix/suffix runs
    posi = _arange(L, bases, i32)[None, :]

    def pref(a):  # leading all-True run, capped at plen
        fp = torch.where(~a, posi, L).min(dim=1).values
        return torch.minimum(fp, plen32)

    def suff(a):  # trailing all-True run within [0, plen)
        lf = torch.where(~a, posi, -1).max(dim=1).values
        return torch.clamp(plen32 - 1 - lf, min=torch.zeros_like(plen32), max=plen32)

    eq0, eqp, eqm = eqs[0], eqs[1], eqs[-1]
    L0, R0 = pref(eq0), suff(eq0)
    edge_raw = (
        (L0 + suff(eqp) >= plen32)          # 1D: tail on +1 diagonal
        | (L0 + suff(eqm) >= plen32 - 1)    # 1I: tail on -1 diagonal
        | (pref(eqp) + R0 >= plen32 - 1)    # 1I: head on +1 diagonal
        | (pref(eqm) + R0 >= plen32)        # 1D: head on -1 diagonal
    )
    return edge_raw, ag_raw


def _device_finalize(
    out: SingleAlignOut,
    first_alt_start: torch.Tensor,
    alt_awareness: bool,
    max_score_gap: int,
    use_affine_gap: bool,
    needs_total: torch.Tensor,
    dp_rows: int,
    max_k: int = 127,
    extra_search_depth: int = 1,
    return_scores: bool = False,
    use_ukkonen: bool = True,
    didx: DeviceIndex | None = None,
    bases: torch.Tensor | None = None,
    flag_params: AlignParams | None = None,
):
    """Winner selection and MAPQ on device: the ScoreSet semantics
    (BaseAligner.h:260-329), the 48 bp bin merge detection
    (BaseAligner.cpp:1353-1443), the Ukkonen score-limit replay
    (BaseAligner.cpp:2556-2570) and mapq.h:32-68, in float64."""
    d = out.dist.to(i64)
    lp = out.log_prob.to(f32)
    ag = out.ag_score.to(i64)
    e = out.end_loc.to(i64)
    cl = out.cand_loc.to(i64)
    dr = out.direction.to(i32)
    v = out.valid
    B, K = d.shape
    dev = d.device
    alt = cl >= first_alt_start.to(i64)
    bins = torch.div(cl, MAX_MERGE_DIST, rounding_mode="floor")
    dr_k = torch.where(v, dr, 9)
    karr = _arange(K, d, i32)[None, :].expand(B, K)

    # per-row stable sort by (dr_k, bins, d, -lp, cl) (host parity:
    # np.lexsort((cl, -probs, d, bins, dr_k, rows)))
    perm = _lexsort_rows((dr_k, bins, d, _f32_order_key(-lp), cl))
    g = lambda a: torch.gather(a, 1, perm)
    dr_s, bins_s, d_s, cl_s, k_s = g(dr_k), g(bins), g(d), g(cl), g(karr)
    lp_s, ag_s, e_s, alt_s, v_s = g(lp), g(ag), g(e), g(alt), g(v)

    first = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev),
         (dr_s[:, 1:] != dr_s[:, :-1]) | (bins_s[:, 1:] != bins_s[:, :-1])],
        dim=1,
    )
    reps = first & v_s

    # nearby-element merge detection (BaseAligner.cpp:1396-1435): two
    # consecutive reps in one direction within 48 bp where the better
    # score < 2 => the read takes the exact host path
    repos = torch.where(reps, karr, -1)
    prev_incl = torch.cummax(repos, dim=1).values
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=prev_incl.dtype, device=dev), prev_incl[:, :-1]], dim=1
    )
    prev_c = prev.clamp(0, K - 1).to(i64)
    near = (
        reps
        & (prev >= 0)
        & (torch.gather(dr_s, 1, prev_c) == dr_s)
        & ((cl_s - torch.gather(cl_s, 1, prev_c)).abs() <= MAX_MERGE_DIST)
        & (torch.minimum(torch.gather(d_s, 1, prev_c), d_s) < 2)
    )
    fallback = near.any(dim=1)

    # Ukkonen dynamic score limit: replay the running limit over the
    # original (weight-ordered) slots
    inv = torch.sort(k_s, dim=1, stable=True).indices  # sorted pos of slot k
    rep_orig = torch.gather(reps, 1, inv)
    INF = 1 << 40
    d_orig = torch.where(rep_orig, d, INF)
    lv_orig = torch.where(rep_orig, out.lv_dist.to(i64), INF)
    D64, gap64, mk64 = extra_search_depth, max_score_gap, max_k
    run_all = torch.full((B,), INF, dtype=i64, device=dev)
    run_na = torch.full((B,), INF, dtype=i64, device=dev)
    inc_cols = []
    for k in range(K):
        dk = d_orig[:, k]
        ak = alt[:, k]
        lim_na = D64 + torch.clamp_max(torch.minimum(run_all + gap64, run_na), mk64)
        lim_alt = D64 + torch.clamp_max(
            torch.minimum(run_all, run_na - torch.clamp_max(run_na, gap64)), mk64
        )
        lim = torch.where(ak, lim_alt, lim_na)
        # gate on the PRE-clipping LV distance; running bests update
        # with the final score
        ok = rep_orig[:, k] & (lv_orig[:, k] <= lim)
        inc_cols.append(ok)
        run_all = torch.where(ok, torch.minimum(run_all, dk), run_all)
        run_na = torch.where(ok & ~ak, torch.minimum(run_na, dk), run_na)
    if use_ukkonen:
        inc_orig = torch.stack(inc_cols, dim=1)
        reps = reps & torch.gather(inc_orig, 1, k_s.to(i64))

    zero64 = torch.zeros((), dtype=f64, device=dev)
    probs = torch.where(reps, torch.exp(lp_s.to(f64)), zero64)
    p_all = ordered_sum(probs)

    sel_key = -ag_s if use_affine_gap else d_s
    neg_lp_key = _f32_order_key(-lp_s)

    def best_fields(active):
        # host parity: np.lexsort((e, -prob, key, row)) over reps; ties
        # by position in the first sort
        gate = torch.where(active, 0, 1)
        p2 = _lexsort_rows((gate, sel_key, neg_lp_key, e_s))[:, :1]
        pick = lambda a: torch.gather(a, 1, p2)[:, 0]
        return {
            "k": pick(k_s), "d": pick(d_s), "lp": pick(lp_s),
            "e": pick(e_s), "cl": pick(cl_s), "dr": pick(dr_s),
        }

    best_all = best_fields(reps)
    found = reps.any(dim=1)

    if alt_awareness:
        na = reps & ~alt_s
        best_na = best_fields(na)
        exists_na = na.any(dim=1)
        p_all_na = ordered_sum(torch.where(na, probs, zero64))
        use_na = exists_na & (best_na["d"] <= best_all["d"] + max_score_gap)
        chosen = {
            key: torch.where(use_na, best_na[key], best_all[key])
            for key in best_all
        }
        chosen_pall = torch.where(use_na, p_all_na, p_all)
    else:
        chosen = best_all
        chosen_pall = p_all

    p_best = torch.exp(chosen["lp"].to(f64))
    p_all_c = torch.maximum(chosen_pall, p_best)
    ratio = torch.where(
        p_all_c > 0, p_best / torch.clamp_min(p_all_c, 1e-300), zero64
    )
    base = torch.where(
        ratio >= 1.0,
        MAPQ_MAX,
        torch.clamp_max(
            (-10.0 * torch.log10(torch.clamp_min(1.0 - ratio, 1e-300))).to(i64),
            MAPQ_MAX,
        ),
    )
    base = torch.where(p_best <= 0.0, 0, base)
    popular = out.popular.to(i64)
    mapq = torch.clamp_min(
        base - torch.div(torch.clamp_min(popular - 10, 0), 2, rounding_mode="floor"), 0
    )

    wk = chosen["k"].to(i64)[:, None]

    def at_w(a):
        return torch.gather(a, 1, wk)[:, 0]

    # emission screens (host twins: single.one_indel_improves /
    # single.ag_restructure_possible), gated as the host plan path does
    no_flags = torch.zeros_like(found)
    edge_indel = ag_flip = no_flags
    if didx is not None and bases is not None and flag_params is not None:
        w_indels = at_w(out.indels)
        w_cb = at_w(out.clip_before)
        w_ca = at_w(out.clip_after)
        base_gate = (
            found & ~fallback & ~out.truncated
            & (w_indels == 0) & (w_cb == 0) & (w_ca == 0)
        )
        want_edge = flag_params.max_k_same >= 2
        want_ag = use_affine_gap
        if want_edge or want_ag:
            edge_raw, ag_raw = winner_flags(
                didx, bases, out.len_eff, chosen["dr"], chosen["e"],
                chosen["d"], flag_params,
            )
            if want_edge:
                edge_indel = base_gate & (chosen["d"] == 2) & edge_raw
            if want_ag:
                ag_flip = base_gate & (chosen["d"] >= 2) & ag_raw

    win = WinnerOut(
        found=found,
        fallback=fallback,
        cand_k=chosen["k"].to(i32),
        direction=chosen["dr"].to(torch.uint8),
        dist=chosen["d"].to(torch.int16),
        mapq=mapq.to(torch.uint8),
        end_loc=chosen["e"] & U32,
        body_loc=at_w(out.body_loc).to(i64) & U32,
        clip_before=at_w(out.clip_before).to(torch.int16),
        clip_after=at_w(out.clip_after).to(torch.int16),
        escalated=at_w(out.escalated),
        indels=at_w(out.indels).to(i32),
        len_eff=out.len_eff.to(torch.int16),
        popular=out.popular.to(torch.int16),
        valid_count=out.valid.sum(dim=1).to(torch.int16),
        esc_count=(out.escalated & out.valid).sum(dim=1).to(torch.int16),
        truncated=out.truncated,
        edge_indel=edge_indel,
        ag_flip=ag_flip,
        dp_overflow=needs_total > dp_rows,
    )
    if return_scores:
        # running bests of the Ukkonen replay ((1<<40) when none)
        return win, run_all, run_na
    return win


WINNER_COLS = (
    "found", "fallback", "cand_k", "direction", "dist", "mapq",
    "end_loc", "body_loc", "clip_before", "clip_after", "escalated",
    "indels", "len_eff", "popular", "valid_count", "esc_count",
    "truncated", "edge_indel", "ag_flip",
)

PACK_WORDS = 6


def pack_winners(win: WinnerOut) -> torch.Tensor:
    """[B+1, 6] int32 bit-packed winner fields; dp_overflow in the extra
    row's column 0. Word layout (low|high):
      w0 end_loc (uint32 bits)         w1 body_loc (uint32 bits)
      w2 dist | clip_before            w3 clip_after | len_eff
      w4 valid_count | esc_count | cand_k | popular (8 bits each,
         saturated at 255)
      w5 mapq(0..7) | flags(8..14: found, fallback, direction,
         escalated, truncated, edge_indel, ag_flip) | indels_nonzero(15)
    """

    def lo16(name):
        return getattr(win, name).to(i32) & 0xFFFF

    def pair(lo, hi):
        return lo16(lo) | (lo16(hi) << 16)

    def b8(name, b):
        return getattr(win, name).to(i32).clamp(0, 255) << b

    def bit(name, b):
        return getattr(win, name).to(i32) << b

    w4 = (
        b8("valid_count", 0) | b8("esc_count", 8)
        | b8("cand_k", 16) | b8("popular", 24)
    )
    w5 = (
        (win.mapq.to(i32) & 0xFF)
        | bit("found", 8) | bit("fallback", 9) | bit("direction", 10)
        | bit("escalated", 11) | bit("truncated", 12)
        | bit("edge_indel", 13) | bit("ag_flip", 14)
        | ((win.indels.to(i32) != 0).to(i32) << 15)
    )
    arr = torch.stack(
        [
            _u32_to_i32(win.end_loc),
            _u32_to_i32(win.body_loc),
            pair("dist", "clip_before"),
            pair("clip_after", "len_eff"),
            w4,
            w5,
        ],
        dim=1,
    )
    tail = torch.zeros((1, PACK_WORDS), dtype=i32, device=arr.device)
    tail[0, 0] = win.dp_overflow.to(i32)
    return torch.cat([arr, tail], dim=0)


def _sext16(x: np.ndarray) -> np.ndarray:
    """Low 16 bits of an int32 column, sign-extended."""
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


class HostWinners:
    """Host-side view of a fetched packed-winner array, presenting the
    WinnerOut field names as numpy columns."""

    def __init__(self, packed):
        if isinstance(packed, torch.Tensor):
            packed = packed.cpu().numpy()
        body, meta = packed[:-1].astype(np.int32), packed[-1]
        self.dp_overflow = bool(meta[0])
        self.end_loc = body[:, 0].astype(np.int64) & 0xFFFFFFFF
        self.body_loc = body[:, 1].astype(np.int64) & 0xFFFFFFFF
        self.dist = _sext16(body[:, 2])
        self.clip_before = body[:, 2] >> 16  # arithmetic: sign-extends
        self.clip_after = _sext16(body[:, 3])
        self.len_eff = body[:, 3] >> 16
        w4 = body[:, 4]
        self.valid_count = w4 & 0xFF
        self.esc_count = (w4 >> 8) & 0xFF
        self.cand_k = (w4 >> 16) & 0xFF
        self.popular = (w4 >> 24) & 0xFF
        w5 = body[:, 5]
        self.mapq = w5 & 0xFF
        self.found = ((w5 >> 8) & 1).astype(bool)
        self.fallback = ((w5 >> 9) & 1).astype(bool)
        self.direction = (w5 >> 10) & 1
        self.escalated = ((w5 >> 11) & 1).astype(bool)
        self.truncated = ((w5 >> 12) & 1).astype(bool)
        self.edge_indel = ((w5 >> 13) & 1).astype(bool)
        self.ag_flip = ((w5 >> 14) & 1).astype(bool)
        self.indels = (w5 >> 15) & 1  # zero/nonzero only


# ---------------------------------------------------------- the fast path


def _awd_candidates(didx, bases, quals, lens, params, return_lowest=False):
    return _align_impl(didx, bases, quals, lens, params, return_lowest)


def _awd_score(didx, bases, quals, bundle, params, dp_rows):
    (cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
     popular, trunc, len_eff, n_lookups) = bundle
    rc_bases, rc_quals = reverse_complement_reads(bases, quals, len_eff)
    return _score_from_candidates(
        didx, bases, rc_bases, quals, rc_quals, len_eff,
        cand_loc, cand_off, cand_dir, cand_valid, cand_weight,
        popular, trunc, n_lookups, params, dp_rows=dp_rows,
    )


def _awd_finalize(
    didx, bases, out, first_alt_start, needs_total, params, dp_rows,
    alt_awareness, max_score_gap, return_scores=False,
):
    res = _device_finalize(
        out, first_alt_start, alt_awareness, max_score_gap,
        params.use_affine_gap, needs_total, dp_rows,
        max_k=params.max_k,
        extra_search_depth=params.extra_search_depth,
        use_ukkonen=params.use_ukkonen,
        return_scores=return_scores,
        didx=didx, bases=bases, flag_params=params,
    )
    if return_scores:
        win, run_all, run_na = res
        return pack_winners(win), win, run_all, run_na
    return pack_winners(res), res


def _awd_fused(
    didx, bases, quals, lens, first_alt_start, params,
    dp_rows, alt_awareness, max_score_gap,
):
    bundle = _awd_candidates(didx, bases, quals, lens, params)
    out, needs_total = _awd_score(didx, bases, quals, bundle, params, dp_rows)
    packed, _ = _awd_finalize(
        didx, bases, out, first_alt_start, needs_total, params, dp_rows,
        alt_awareness, max_score_gap,
    )
    return packed, out, needs_total


def _phase_b_params(params: AlignParams) -> AlignParams:
    """Phase-B tile geometry: wide enough for repeat-family hit counts
    (SINE/LINE copies) that overflow the phase-A caps."""
    return dataclasses.replace(
        params,
        max_cand=min(64, max(32, 2 * params.max_cand)),
        hit_cap=max(32, 4 * params.hit_cap),
    )


class ABOut(NamedTuple):
    """Lazy adaptive-step per-candidate output: the phase-A tile plus the
    phase-B (and optional phase-C) row sets, merged on demand by
    gather_merged_rows."""

    a: SingleAlignOut
    b: SingleAlignOut
    rows: torch.Tensor       # [B2] int64 phase-B row ids
    live: torch.Tensor       # [B2] bool
    overflow: torch.Tensor   # [B] bool phase-B-capacity overflow rows
    c: SingleAlignOut | None = None
    rows_c: torch.Tensor | None = None
    live_c: torch.Tensor | None = None


def align_winners_device(
    didx: DeviceIndex,
    bases: torch.Tensor,            # [B, L] uint8 read codes
    quals: torch.Tensor,            # [B, L] uint8 phred+33 bytes
    lens: torch.Tensor,             # [B] int32
    first_alt_start: torch.Tensor,  # [] int64
    params: AlignParams,
    dp_rows: int | None = None,
    alt_awareness: bool = True,
    max_score_gap: int = 64,
    adaptive: bool = False,
    phase_b_rows: int | None = None,
    phase_c: bool = False,
):
    """Production fast path: align + device finalize on the device the
    index and reads live on. Returns (packed winners [B+1, 6] int32,
    per-candidate output: SingleAlignOut, or ABOut when adaptive, the DP
    tier of each phase that ran as (phase, rows needed: [] int on the
    step's device, rows held) triples). A phase overflowed where it
    needed more rows than it held; the packed winners' dp_overflow bit
    is then set.

    adaptive=True replays SNAP's seed-loop early termination
    (BaseAligner.cpp:1028): phase A probes the first unwrapped seed pass
    with a K=4 tile; reads SNAP would have kept seeding (or whose tile
    overflowed) rerun at full depth in a phase_b_rows-wide phase B whose
    winners scatter over phase A's. phase_c reruns still-truncated rows
    at hit_cap=128 / K=64.
    """
    for name, t in (("bases", bases), ("quals", quals), ("lens", lens)):
        if t.device != didx.genome.device:
            raise ValueError(
                f"align_winners_device: {name} is on {t.device}, the index "
                f"on {didx.genome.device}"
            )
    first_alt_start = torch.as_tensor(first_alt_start, dtype=i64, device=bases.device)
    B, L = bases.shape
    if dp_rows is None:
        dp_rows = max(1024, (B * params.max_cand) // 128)
    P = L - params.seed_len + 1
    s1_lookups = (P - 1) // params.seed_len + 1 if P > 0 else 1
    if not adaptive or s1_lookups >= params.num_lookups:
        packed, out, needs = _awd_fused(
            didx, bases, quals, lens, first_alt_start, params,
            dp_rows, alt_awareness, max_score_gap,
        )
        return packed, out, (("a", needs, dp_rows),)

    B2 = phase_b_rows or max(min(256, B), B // 4)
    out_a, win_a, needs_a, rows, live, overflow = _awd_phase_a(
        didx, bases, quals, lens, first_alt_start, params,
        alt_awareness, max_score_gap, s1_lookups, B2,
    )
    packed, win_ab, ab, needs_b = _awd_phase_b(
        didx, bases, quals, lens, first_alt_start, params,
        alt_awareness, max_score_gap, B2,
        out_a, win_a, needs_a, rows, live, overflow,
    )
    demand = [("a", needs_a, _dp_rows_a(B, params)),
              ("b", needs_b, _dp_rows_b(B, B2, params))]
    out = ab
    if phase_c:
        packed, out, needs_c = _awd_phase_c(
            didx, bases, quals, lens, first_alt_start, params,
            alt_awareness, max_score_gap, packed, win_ab, ab,
        )
        demand.append(("c", needs_c, _dp_rows_c(_phase_c_rows(B))))
    return packed, out, tuple(demand)


def _dp_rows_a(B: int, params: AlignParams) -> int:
    return max(512, (B * min(4, params.max_cand)) // 16)


def _dp_rows_b(B: int, B2: int, params: AlignParams) -> int:
    return max(2048, (B2 * _phase_b_params(params).max_cand) // 4,
               (B * params.max_cand) // 128)


def _phase_c_rows(B: int) -> int:
    return max(min(128, B), B // 16)


def _dp_rows_c(B3: int) -> int:
    return max(1024, (B3 * 64) // 4)


def _awd_phase_a(
    didx, bases, quals, lens, first_alt_start, params,
    alt_awareness, max_score_gap, s1_lookups, B2,
):
    B, L = bases.shape
    # phase A narrows the candidate tile to K=4; reads with more
    # candidates are flagged by the K-overflow bit and rerun in phase B
    K_A = min(4, params.max_cand)
    params_a = dataclasses.replace(
        params, num_seeds=2 * s1_lookups - 2, max_cand=K_A
    )
    dp_a = _dp_rows_a(B, params)
    bundle, lowest = _awd_candidates(
        didx, bases, quals, lens, params_a, return_lowest=True
    )
    out_a, needs_a = _awd_score(didx, bases, quals, bundle, params_a, dp_a)
    _, win_a, run_all, run_na = _awd_finalize(
        didx, bases, out_a, first_alt_start, needs_a, params, dp_a,
        alt_awareness, max_score_gap, return_scores=True,
    )
    out_a, rows, live, overflow = _awd_route(
        out_a, lowest, run_all, run_na, params,
        alt_awareness, max_score_gap, B2,
        _phase_b_params(params).max_cand,
    )
    return out_a, win_a, needs_a, rows, live, overflow


def _awd_route(
    out_a, lowest, run_all, run_na, params,
    alt_awareness, max_score_gap, B2, K_full,
):
    """Phase-A epilogue: SNAP's stop rule picks the unresolved reads,
    compacts them into the phase-B row set, and widens the phase-A
    candidate tile to the full K for the later merge."""
    B = out_a.len_eff.shape[0]
    K_A = out_a.dist.shape[1]
    if K_A != K_full:
        def _pad_k(a):
            if a.dim() == 2 and a.shape[1] == K_A:
                return torch.cat(
                    [a, torch.zeros((B, K_full - K_A), dtype=a.dtype, device=a.device)],
                    dim=1,
                )
            return a

        out_a = SingleAlignOut(*(_pad_k(x) for x in out_a))

    # SNAP's stop rule (BaseAligner.cpp:1028): quit seeding when
    # min_dir(lowestPossibleScoreOfAnyUnseenLocation) exceeds
    # max(scoreLimit(true), scoreLimit(false))
    D64, mk64, gap64 = params.extra_search_depth, params.max_k, max_score_gap
    if alt_awareness:
        lim_na = D64 + torch.clamp_max(torch.minimum(run_all + gap64, run_na), mk64)
        lim_alt = D64 + torch.clamp_max(
            torch.minimum(run_all, run_na - torch.clamp_max(run_na, gap64)), mk64
        )
        lim = torch.maximum(lim_na, lim_alt)
    else:
        lim = D64 + torch.clamp_max(run_all, mk64)
    resolved = lowest.to(i64) > lim
    unres = (~resolved | out_a.truncated) & (out_a.len_eff >= params.seed_len)

    rows = _topk_indices(unres.to(i32), B2)
    live = unres[rows]
    sel = torch.zeros((B,), dtype=torch.bool, device=unres.device)
    sel[rows] = live
    overflow = unres & ~sel
    return out_a, rows, live, overflow


def _merge_rows(a, b, rows, live):
    out = a.clone()
    msk = live.reshape((-1,) + (1,) * (b.dim() - 1))
    out[rows] = torch.where(msk, b.to(a.dtype), a[rows])
    return out


def _awd_phase_b(
    didx, bases, quals, lens, first_alt_start, params,
    alt_awareness, max_score_gap, B2,
    out_a, win_a, needs_a, rows, live, overflow,
):
    B, L = bases.shape
    params_b = _phase_b_params(params)
    dp_b = _dp_rows_b(B, B2, params)
    b_b, q_b, l_b = bases[rows], quals[rows], lens[rows]
    bundle = _awd_candidates(didx, b_b, q_b, l_b, params_b)
    out_b, needs_b = _awd_score(didx, b_b, q_b, bundle, params_b, dp_b)
    _, win_b = _awd_finalize(
        didx, b_b, out_b, first_alt_start, needs_b, params_b, dp_b,
        alt_awareness, max_score_gap,
    )
    packed, win_ab = _awd_merge(
        out_a, win_a, out_b, win_b, rows, live, overflow,
        needs_a, needs_b, _dp_rows_a(B, params), dp_b,
    )
    return packed, win_ab, ABOut(out_a, out_b, rows, live, overflow), needs_b


def _awd_merge(
    out_a, win_a, out_b, win_b, rows, live, overflow,
    needs_a, needs_b, dp_a, dp_b,
):
    merged = {
        name: _merge_rows(getattr(win_a, name), getattr(win_b, name), rows, live)
        for name in WINNER_COLS
    }
    merged["truncated"] = merged["truncated"] | overflow
    win = WinnerOut(**merged, dp_overflow=(needs_a > dp_a) | (needs_b > dp_b))
    return pack_winners(win), win


def _awd_pick_rows(flags, B3: int):
    rows = _topk_indices(flags.to(i32), B3)
    return rows, flags[rows]


def _awd_phase_c(
    didx, bases, quals, lens, first_alt_start, params,
    alt_awareness, max_score_gap, packed, win_ab, ab,
):
    """Optional third tier: reads still truncated after phase B rerun
    at hit_cap=128 / K=64 on B/16 rows. Residual truncation keeps the
    flag and takes the host wide redo."""
    B = bases.shape[0]
    B3 = _phase_c_rows(B)
    params_c = dataclasses.replace(
        params, hit_cap=max(128, params.hit_cap), max_cand=64
    )
    dp_c = _dp_rows_c(B3)
    rows3, live3 = _awd_pick_rows(win_ab.truncated, B3)
    b_c, q_c, l_c = bases[rows3], quals[rows3], lens[rows3]
    bundle = _awd_candidates(didx, b_c, q_c, l_c, params_c)
    out_c, needs_c = _awd_score(didx, b_c, q_c, bundle, params_c, dp_c)
    _, win_c = _awd_finalize(
        didx, b_c, out_c, first_alt_start, needs_c, params_c, dp_c,
        alt_awareness, max_score_gap,
    )
    packed2 = _awd_merge_c(win_ab, win_c, rows3, live3, needs_c, dp_c)
    return packed2, ab._replace(c=out_c, rows_c=rows3, live_c=live3), needs_c


def _awd_merge_c(win_ab, win_c, rows, live, needs_c, dp_c):
    merged = {
        name: _merge_rows(getattr(win_ab, name), getattr(win_c, name), rows, live)
        for name in WINNER_COLS
    }
    win = WinnerOut(**merged, dp_overflow=win_ab.dp_overflow | (needs_c > dp_c))
    return pack_winners(win)


# --------------------------------------------------------- fallback rows


def gather_merged_rows(out, rows: torch.Tensor) -> torch.Tensor:
    """Pack full candidate rows for host-side exact finalization:
    [M, K, 9] int32 (unpack with unpack_merged_rows). `out` is a
    SingleAlignOut or the adaptive step's ABOut; for the latter each row
    selects its phase-A tile row or its phase-B (or phase-C) rerun."""
    r = rows.to(i64)
    if isinstance(out, ABOut):
        B = out.a.len_eff.shape[0]
        B2 = out.rows.shape[0]
        dev = out.a.len_eff.device
        posB = torch.full((B,), -1, dtype=i32, device=dev)
        posB[out.rows] = torch.where(out.live, _arange(B2, out.rows, i32), -1).to(i32)
        pb = posB[r]
        useB = pb >= 0
        pbc = pb.clamp_min(0).to(i64)

        def sel(fa, fb):
            va, vb = fa[r], fb[pbc]
            m = useB.reshape((-1,) + (1,) * (va.dim() - 1))
            return torch.where(m, vb.to(va.dtype), va)

        sub = SingleAlignOut(*(sel(fa, fb) for fa, fb in zip(out.a, out.b)))
        sub = sub._replace(truncated=sub.truncated | out.overflow[r])
        if out.c is not None:
            B3 = out.rows_c.shape[0]
            posC = torch.full((B,), -1, dtype=i32, device=dev)
            posC[out.rows_c] = torch.where(
                out.live_c, _arange(B3, out.rows_c, i32), -1
            ).to(i32)
            pc = posC[r]
            useC = pc >= 0
            pcc = pc.clamp_min(0).to(i64)
            Kc = out.c.dist.shape[1]

            def selc(fs, fc):
                vc = fc[pcc]
                vs = fs
                if vs.dim() == 2 and vs.shape[1] != Kc:
                    vs = torch.cat(
                        [vs, torch.zeros((vs.shape[0], Kc - vs.shape[1]),
                                         dtype=vs.dtype, device=vs.device)],
                        dim=1,
                    )
                m = useC.reshape((-1,) + (1,) * (vs.dim() - 1))
                return torch.where(m, vc.to(vs.dtype), vs)

            sub = SingleAlignOut(*(selc(fs, fc) for fs, fc in zip(sub, out.c)))
        out = sub
        r = _arange(rows.shape[0], rows)
    u32 = lambda a: _u32_to_i32(a[r])
    w8 = (
        torch.clamp_max(out.indels[r].to(i32), 0x7FFF)
        | (out.escalated[r].to(i32) << 16)
        | (out.valid[r].to(i32) << 17)
        | (out.direction[r].to(i32) << 18)
    )
    return torch.stack(
        [
            u32(out.end_loc),
            u32(out.body_loc),
            u32(out.cand_loc),
            out.log_prob[r].to(f32).contiguous().view(i32),
            out.dist[r].to(i32),
            out.lv_dist[r].to(i32),
            out.ag_score[r].to(i32),
            (out.clip_before[r].to(i32) & 0xFFFF)
            | (out.clip_after[r].to(i32) << 16),
            w8,
        ],
        dim=2,
    )


def unpack_merged_rows(pk: np.ndarray) -> dict:
    """numpy dict view of a fetched gather_merged_rows array."""
    pk = np.ascontiguousarray(pk)
    sx = lambda x: ((x & 0xFFFF) ^ 0x8000) - 0x8000
    return {
        "dist": pk[:, :, 4],
        "lv_dist": pk[:, :, 5],
        "log_prob": np.ascontiguousarray(pk[:, :, 3]).view(np.float32),
        "ag_score": pk[:, :, 6],
        "end_loc": pk[:, :, 0].astype(np.int64) & 0xFFFFFFFF,
        "body_loc": pk[:, :, 1].astype(np.int64) & 0xFFFFFFFF,
        "cand_loc": pk[:, :, 2].astype(np.int64) & 0xFFFFFFFF,
        "escalated": ((pk[:, :, 8] >> 16) & 1).astype(bool),
        "clip_before": sx(pk[:, :, 7]).astype(np.int32),
        "clip_after": (pk[:, :, 7] >> 16).astype(np.int32),
        "indels": (pk[:, :, 8] & 0x7FFF).astype(np.int32),
        "direction": ((pk[:, :, 8] >> 18) & 1).astype(np.int32),
        "valid": ((pk[:, :, 8] >> 17) & 1).astype(bool),
    }
