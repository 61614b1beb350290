"""The slice as a whole: snap_tpu_torch's single-end device step against
snap_tpu's, on the CPU, on a random and a 25%-repeat genome.

Both packages get the same index dict (built once by snap_tpu) and the
same reads, with 1-3 bp indels in half of them. The candidate bundle,
SingleAlignOut and the packed [B+1, 6] winners of align_winners_device
in its three modes are held equal bit for bit; the fallback-row fetch
in its integer fields (its test says why).

One input is made equal on purpose. snap_tpu computes ln P(error) from
the quality bytes with XLA's float32 exp/log approximations, whose last
bits depend on how XLA fuses the surrounding graph; the port looks it up
in a table of correctly rounded values (the two agree within 1e-5
relative: test_torch_ops.test_device_logq_close_to_reference). The
`same_logq` fixture points snap_tpu's device_logq at the port's table,
so any remaining difference is the port's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.align import pipeline as J
from snap_tpu.index.build import build_index
from snap_tpu.index.index import make_device_index as jmake
from snap_tpu_torch.align import pipeline as T
from snap_tpu_torch.index.index import make_device_index as tmake
from test_torch_index import make_codes, padded_genome

torch.set_num_threads(1)

B, L, ML = 160, 100, 128


@pytest.fixture(scope="module")
def same_logq():
    table = T.device_logq(torch.arange(256, dtype=torch.uint8)).numpy()
    original = J.device_logq
    # traced functions read device_logq when they are traced: drop any
    # earlier traces, and ours afterwards
    jax.clear_caches()
    J.device_logq = lambda q: jnp.asarray(table)[q.astype(jnp.int32)]
    yield
    J.device_logq = original
    jax.clear_caches()


def sample_reads(codes, rng, n, L=100, err=0.02, indel_every=4):
    """tests/test_adaptive.py's read model: a deletion or an insertion
    of 1-3 bases in half the reads, then substitutions."""
    seqs = np.empty((n, L), np.uint8)
    for i in range(n):
        s = int(rng.integers(0, codes.size - L - 10))
        r = codes[s : s + L + 8].copy()
        if i % indel_every == 1:
            p = int(rng.integers(20, L - 20))
            r = np.delete(r, slice(p, p + int(rng.integers(1, 4))))
        elif i % indel_every == 2:
            p = int(rng.integers(20, L - 20))
            r = np.insert(r, p, rng.integers(0, 4, int(rng.integers(1, 4))))
        r = r[:L]
        mut = rng.random(L) < err
        seqs[i] = np.where(mut, rng.integers(0, 4, L), r)
    return seqs


@pytest.fixture(scope="module", params=["random", "repeat25"])
def case(request, same_logq):
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
        "fas": int(genome.bases.shape[0]),
    }


def assert_same(ref, got, what):
    a = np.asarray(ref)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":  # bit for bit
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64), err_msg=what)


def test_candidates_match(case):
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    jbund, jlow = J._awd_candidates(jd, jb, jq, jl, jp, return_lowest=True)
    tbund, tlow = T._awd_candidates(td, tb, tq, tl, tp, return_lowest=True)
    assert len(tbund) == len(jbund) == 9
    for i, (a, b) in enumerate(zip(jbund, tbund)):
        assert_same(a, b, f"bundle[{i}]")
    assert_same(jlow, tlow, "lowest")
    assert np.asarray(jbund[3]).sum() > B  # candidates exist


def test_score_matches(case):
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    dp_rows = max(1024, (B * 16) // 128)
    jo, jn = J._awd_score(jd, jb, jq, J._awd_candidates(jd, jb, jq, jl, jp), jp, dp_rows)
    to, tn = T._awd_score(td, tb, tq, T._awd_candidates(td, tb, tq, tl, tp), tp, dp_rows)
    assert tuple(to._fields) == tuple(jo._fields)
    for f in jo._fields:
        assert_same(getattr(jo, f), getattr(to, f), f)
    assert int(jn) == int(tn) > 0  # the DP tier ran
    assert np.asarray(jo.escalated).any()  # so did the affine-gap tier


@pytest.mark.parametrize(
    "mode",
    [dict(adaptive=False), dict(adaptive=True), dict(adaptive=True, phase_c=True)],
    ids=["full_depth", "adaptive", "adaptive_phase_c"],
)
def test_packed_winners_bit_identical(case, mode):
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    jpk, jout = J.align_winners_device(jd, jb, jq, jl, jnp.int64(case["fas"]), jp, **mode)
    tpk, tout, _ = T.align_winners_device(td, tb, tq, tl, torch.tensor(case["fas"]), tp, **mode)
    jpk = np.asarray(jpk)
    assert tpk.dtype == torch.int32 and tuple(tpk.shape) == (B + 1, T.PACK_WORDS)
    np.testing.assert_array_equal(tpk.numpy(), jpk)
    w = T.HostWinners(tpk)
    assert w.found.sum() > 0.9 * B and (w.mapq >= 10).sum() > B // 2
    # the fallback-row fetch over every read (host exact-finalize input):
    # integer fields exactly; log_prob (column 3, float32 bits) within 4
    # ulps, because XLA compiles each phase's graph on its own and may
    # round a float32 multiply-add of the affine-gap epilogue once
    # instead of twice (seen: 3 escalated phase-B rows of the repeat
    # genome, 1-2 ulps apart; the winners above stay bit-identical)
    rows = np.arange(B)
    jm = np.asarray(J.gather_merged_rows(jout, jnp.asarray(rows)))
    tm = T.gather_merged_rows(tout, torch.from_numpy(rows)).numpy()
    ints = [c for c in range(jm.shape[2]) if c != 3]
    np.testing.assert_array_equal(tm[:, :, ints], jm[:, :, ints])
    ulps = np.abs(tm[:, :, 3].astype(np.int64) - jm[:, :, 3].astype(np.int64))
    assert ulps.max() <= 4, np.argwhere(ulps > 4)[:8]
    um, ut = J.unpack_merged_rows(jm), T.unpack_merged_rows(tm)
    for k in um:
        if k != "log_prob":
            np.testing.assert_array_equal(ut[k], um[k], err_msg=k)


@pytest.mark.parametrize(
    "mode",
    [dict(adaptive=False), dict(adaptive=True), dict(adaptive=True, phase_c=True)],
    ids=["full_depth", "adaptive", "adaptive_phase_c"],
)
def test_demand_leaves_the_packed_winners_bit_identical(case, mode, monkeypatch):
    """The step's third value, the DP tier of each phase that ran, leaves
    the packed winners snap_tpu's bit for bit; each phase needed the rows
    its _awd_score computed and held the rows it was given, and the
    dp_overflow bit is set exactly where a phase needed more than it held."""
    jd, jb, jq, jl, jp = case["jax"]
    td, tb, tq, tl, tp = case["torch"]
    scores, score = [], T._awd_score

    def counted(didx, bases, quals, bundle, params, dp_rows):
        out, needs = score(didx, bases, quals, bundle, params, dp_rows)
        scores.append((int(needs), dp_rows))
        return out, needs

    monkeypatch.setattr(T, "_awd_score", counted)
    jpk, _ = J.align_winners_device(jd, jb, jq, jl, jnp.int64(case["fas"]), jp, **mode)
    tpk, _, demand = T.align_winners_device(
        td, tb, tq, tl, torch.tensor(case["fas"]), tp, **mode)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    phases = ("a", "b", "c") if mode.get("phase_c") else ("a", "b") if mode["adaptive"] else ("a",)
    assert tuple(p for p, _, _ in demand) == phases
    assert [(int(n), r) for _, n, r in demand] == scores
    overflow = any(n > r for n, r in scores)
    assert T.HostWinners(tpk).dp_overflow == overflow
