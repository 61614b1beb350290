"""The two-phase API of snap_tpu_torch's pipeline against snap_tpu's, on
the CPU, on a random and a 25%-repeat genome.

align_tier1, score_candidates (tier 1 only, and both tiers), score_rows
with fetch_subset, and two_phase_merge with force_dp off and on get the
same inputs in both packages and must give the same numbers bit for bit.
These are the device calls of the host redo paths: the wide redo of
truncated and edge-indel rows (score_candidates, then two_phase_merge)
and the dp_overflow redo (align_tier1, then two_phase_merge). The reads,
the index and the shared ln P(error) table come from
test_torch_pipeline's fixtures.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.align import pipeline as J
from snap_tpu.align.intersect import wide_single_candidates as j_wide
from snap_tpu.index.build import build_index
from snap_tpu.index.host_lookup import HostIndex as JHost
from snap_tpu.index.index import make_device_index as jmake
from snap_tpu_torch.align import pipeline as T
from snap_tpu_torch.align.intersect import wide_single_candidates as t_wide
from snap_tpu_torch.index.host_lookup import HostIndex as THost
from snap_tpu_torch.index.index import make_device_index as tmake
from test_torch_index import make_codes, padded_genome
from test_torch_pipeline import assert_same, sample_reads, same_logq  # noqa: F401

torch.set_num_threads(1)

B, L, ML = 160, 100, 128
M_READS = 48   # reads given to the wide candidate path (padded to 64)


@pytest.fixture(scope="module", params=["random", "repeat25"])
def case(request, same_logq):
    """test_torch_pipeline's inputs, with the host arrays kept."""
    rng = np.random.default_rng(7)
    codes = make_codes(request.param, rng, 60_000)
    genome = padded_genome(codes)
    arrays = build_index(genome, seed_len=20)
    seqs = sample_reads(codes, np.random.default_rng(11), B)
    bases = np.full((B, ML), 4, np.uint8)
    bases[:, :L] = seqs
    quals = np.zeros((B, ML), np.uint8)
    quals[:, :L] = np.random.default_rng(3).choice(
        np.array([35, 43, 53, 63, 73], np.uint8), (B, L)
    )
    lens = np.full(B, L, np.int32)
    kw = dict(seed_len=20, max_probe=arrays["max_probe"], num_seeds=25,
              hit_cap=8, max_cand=16)
    return {
        "jax": (jmake(arrays, genome.bases), *map(jnp.asarray, (bases, quals, lens)),
                J.AlignParams(**kw)),
        "torch": (tmake(arrays, genome.bases, "cpu"),
                  *map(torch.from_numpy, (bases, quals, lens)), T.AlignParams(**kw)),
        "arrays": arrays, "bases": bases, "quals": quals, "lens": lens,
        "kind": request.param,
    }


def _tier1_pair(case):
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    return J.align_tier1(jd, jb, jq, jl, jp), T.align_tier1(td, tb, tq, tl, tp)


# ROADMAP C, "XLA rounding of one escalated candidate": in the repeat25
# case, snap_tpu's compiled graphs round the affine-gap log-prob of read
# 1's candidate at genome location 9240 (escalated, dist 23) once where
# the port, and snap_tpu run without jit, round twice: 1 ulp apart
XLA_RESIDUAL = {"repeat25": (1, 9240)}


def residual(case, read_ix, locs, escalated):
    """Mask of the log_prob elements that are the recorded residual."""
    if case["kind"] not in XLA_RESIDUAL:
        return None
    r, loc = XLA_RESIDUAL[case["kind"]]
    return (np.asarray(read_ix) == r) & (np.asarray(locs) == loc) & np.asarray(escalated)


def same_log_prob(a, b, allow):
    """float32/64 log-probs bit for bit, except the `allow` elements,
    which must lie within 4 ulps of float32."""
    a, b = np.array(a), np.array(b)
    if allow is not None and allow.any():
        ulps = np.abs(a[allow].astype(np.float32).view(np.int32).astype(np.int64)
                      - b[allow].astype(np.float32).view(np.int32).astype(np.int64))
        assert ulps.max() <= 4, ulps
        b[allow] = a[allow]
    assert_same(a, b, "log_prob")


def assert_same_tuple(ref, got, allow=None):
    assert tuple(got._fields) == tuple(ref._fields)
    for f in ref._fields:
        if f == "log_prob":
            same_log_prob(ref.log_prob, got.log_prob.numpy()
                          if torch.is_tensor(got.log_prob) else got.log_prob, allow)
        else:
            assert_same(getattr(ref, f), getattr(got, f), f)


def test_align_tier1_matches(case):
    jt, tt = _tier1_pair(case)
    assert_same_tuple(jt, tt)
    assert tt.seed_off.dtype == torch.int16 and tt.weight.dtype == torch.uint8
    assert np.asarray(jt.valid).sum() > 0


def _wide_inputs(case):
    """The wide redo's inputs for the first M_READS reads, as
    SingleEndAligner._redo_wide_chunk builds them: host candidates over
    the full hit lists, padded to a power of two of rows and of K."""
    arrays = case["arrays"]
    rows = np.arange(M_READS)
    bases, quals, lens = case["bases"][rows], case["quals"][rows], case["lens"][rows]
    from snap_tpu.index.host_lookup import host_clip_back

    len_eff = host_clip_back(quals, lens)
    params = case["jax"][4]
    args = (bases, len_eff, params.num_lookups, params.seed_len,
            params.max_hits, params.explore_popular)
    wj = j_wide(JHost(arrays, arrays["seed_len"], arrays["max_probe"]), *args)
    wt = t_wide(THost(arrays, arrays["seed_len"], arrays["max_probe"]), *args)
    for f in ("loc", "off", "dir", "valid", "weight", "popular"):
        np.testing.assert_array_equal(getattr(wt, f), getattr(wj, f), err_msg=f)
    K = 16
    while K < int(wj.valid.sum(axis=1).max()):
        K <<= 1
    Mp = 64
    pad = lambda a: np.concatenate([a, np.zeros((Mp - M_READS,) + a.shape[1:], a.dtype)])
    return [pad(a) for a in (
        bases, quals, len_eff, wj.loc[:, :K], wj.off[:, :K], wj.dir[:, :K],
        wj.valid[:, :K], wj.weight[:, :K], wj.popular,
    )]


@pytest.mark.parametrize("tier1_only", [True, False], ids=["tier1", "two_tier"])
def test_score_candidates_matches(case, tier1_only):
    ins = _wide_inputs(case)
    jd, tp = case["jax"][0], case["torch"][4]
    td, jp = case["torch"][0], case["jax"][4]
    ref = J.score_candidates(jd, *map(jnp.asarray, ins), jp, tier1_only=tier1_only)
    got = T.score_candidates(td, *map(torch.from_numpy, ins), tp, tier1_only=tier1_only)
    allow = None if tier1_only else residual(
        case, np.arange(ins[3].shape[0])[:, None], ins[3], ref.escalated
    )
    assert_same_tuple(ref, got, allow)
    assert np.asarray(ref.valid).sum() > M_READS


def _needs_rows(t1):
    """The candidate rows two_phase_merge(force_dp=True) sends to
    score_rows: every valid candidate with a mismatch."""
    cand_pk, _ = (np.asarray(x) for x in J._pack_tier1(t1))
    w2 = cand_pk[:, :, 2]
    valid = ((w2 >> 25) & 1).astype(bool)
    gd = (cand_pk[:, :, 3] & 0xFFFF).astype(np.int32)
    idx = np.flatnonzero((valid & (gd > 0)).reshape(-1))
    M = 1 << max(5, int(np.ceil(np.log2(idx.size))))
    sel = np.zeros(M, np.int64)
    sel[: idx.size] = idx[:M]
    live = np.zeros(M, bool)
    live[: min(M, idx.size)] = True
    K = cand_pk.shape[1]
    flat = lambda c: cand_pk[:, :, c].reshape(-1)[sel]
    dirs = ((flat(2) >> 24) & 1).astype(np.int32)
    locs = flat(0).astype(np.int64) & 0xFFFFFFFF
    offs = ((((flat(2) & 0xFFFF) ^ 0x8000) - 0x8000)).astype(np.int32)
    return sel // K, dirs, locs, offs, live


def test_score_rows_and_fetch_subset_match(case):
    jt, tt = _tier1_pair(case)
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    rows = _needs_rows(jt)
    assert rows[4].sum() >= 32
    ref = J.score_rows(jd, jb, jq, jt.len_eff, *map(jnp.asarray, rows), jp)
    got = T.score_rows(td, tb, tq, tt.len_eff, *map(torch.from_numpy, rows), tp)
    allow = residual(case, rows[0], rows[2], ref.escalated)
    assert_same_tuple(ref, got, allow)
    assert_same_tuple(J.fetch_subset(ref), T.fetch_subset(got), allow)
    jpk, tpk = np.asarray(J._pack_subset(ref)), T._pack_subset(got).numpy()
    if allow is not None:  # column 2 holds the log-prob bits
        tpk[allow, 2] = jpk[allow, 2]
    np.testing.assert_array_equal(tpk, jpk)
    assert np.asarray(ref.escalated).any()


@pytest.mark.parametrize("force_dp", [False, True], ids=["gated", "force_dp"])
def test_two_phase_merge_matches(case, force_dp):
    jt, tt = _tier1_pair(case)
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    ref = J.two_phase_merge(jd, jt, jb, jq, jp, force_dp=force_dp)
    got = T.two_phase_merge(td, tt, tb, tq, tp, force_dp=force_dp)
    assert sorted(got) == sorted(ref)
    allow = residual(case, np.arange(ref["dist"].shape[0])[:, None],
                     ref["cand_loc"], ref["escalated"])
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "log_prob":
            same_log_prob(a, b, allow)
            continue
        if a.dtype.kind == "f":
            a, b = a.view(np.int64), b.view(np.int64)
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert ref["escalated"].any() and ref["valid"].any()


def paired_params(case):
    """The case's parameters as the paired driver sets them: -i 40
    widens the DP/affine text window to TW = L + 41."""
    return (dataclasses.replace(case["jax"][4], max_k_indels=40),
            dataclasses.replace(case["torch"][4], max_k_indels=40))


def test_score_candidates_bonus_matches(case):
    """score_candidates(tier1_only=True) with phase-2a bonuses (0-120)
    and -i 40, as the paired driver calls it: the bonus rides in
    Tier1Out.big_indel to two_phase_merge."""
    ins = _wide_inputs(case)
    bonus = np.random.default_rng(5).integers(0, 121, size=ins[3].shape).astype(np.int32)
    jp, tp = paired_params(case)
    ref = J.score_candidates(case["jax"][0], *map(jnp.asarray, ins), jp,
                             tier1_only=True, max_k_bonus=jnp.asarray(bonus))
    got = T.score_candidates(case["torch"][0], *map(torch.from_numpy, ins), tp,
                             tier1_only=True, max_k_bonus=torch.from_numpy(bonus))
    assert_same_tuple(ref, got)
    np.testing.assert_array_equal(got.big_indel.numpy(), bonus)


def test_score_rows_bonus_matches(case):
    """score_rows with per-row bonuses 0-120 and -i 40 (text window TW =
    L + 41, raised tlen and mk_eff), then the packed fetch, as the
    paired driver's two_phase_merge and edge-indel fix call it; on the
    first 128 candidate rows that need the DP."""
    jt, tt = _tier1_pair(case)
    jd, jb, jq = case["jax"][:3]
    td, tb, tq = case["torch"][:3]
    rows = tuple(r[:128] for r in _needs_rows(jt))
    bonus = np.random.default_rng(6).integers(0, 121, size=128).astype(np.int32)
    jp, tp = paired_params(case)
    ref = J.score_rows(jd, jb, jq, jt.len_eff, *map(jnp.asarray, rows), jp,
                       bonus=jnp.asarray(bonus))
    got = T.score_rows(td, tb, tq, tt.len_eff, *map(torch.from_numpy, rows), tp,
                       bonus=torch.from_numpy(bonus))
    # the residual of XLA_RESIDUAL lies among these rows, 1 ulp apart
    # again with the bonuses
    allow = residual(case, rows[0], rows[2], ref.escalated)
    assert_same_tuple(ref, got, allow)
    assert_same_tuple(J.fetch_subset(ref), T.fetch_subset(got), allow)
    assert np.asarray(ref.valid).sum() > np.asarray(ref.escalated).sum() > 0
