"""The plain PyTorch versions of the three scoring kernels against
snap_tpu's references, on the same numpy inputs.

- fitting_edit_distance and affine_extend against snap_tpu's jnp
  recurrences (which tests/test_dp_pallas.py and
  tests/test_affine_pallas.py hold equal to the Pallas kernels in
  interpret mode);
- the gapless prescreen against the Pallas kernel in interpret mode and
  against the jnp branch that snap_tpu runs off the TPU
  (align/pipeline.py:947-1004, reached with tier1_only=True).

Integers are compared exactly. Floats (log-probabilities) within 1e-5
absolute: both sides add the same float32 terms, but XLA may fuse or
reorder a float32 sum, which moves its last bits. The CUDA kernels are
held bit-exact against these plain versions on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snap_tpu.ops import affine as jaf
from snap_tpu.ops import dp as jdp
from snap_tpu_torch.ops import affine as taf
from snap_tpu_torch.ops import dp as tdp
from snap_tpu_torch.ops import gapless as tgl

torch.set_num_threads(1)

ATOL = 1e-5


def assert_fields(ref, got, fields):
    for f in fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f)


def dp_rows(rng, N, L, W, sub=0.1):
    """Patterns of 0..L bases against texts that copy them at a small
    offset with substitutions, an indel in some rows, N (4) and pad (5)
    codes sprinkled in."""
    pat = rng.integers(0, 4, (N, L)).astype(np.uint8)
    pat[rng.random((N, L)) < 0.02] = 4
    txt = rng.integers(0, 6, (N, W)).astype(np.uint8)
    for n in range(N):
        src = pat[n].copy()
        if n % 3 == 1:
            p = int(rng.integers(3, L - 6))
            src = np.delete(src, slice(p, p + int(rng.integers(1, 4))))
        elif n % 3 == 2:
            p = int(rng.integers(3, L - 6))
            src = np.insert(src, p, rng.integers(0, 4, int(rng.integers(1, 4))))
        s = int(rng.integers(0, 4))
        k = min(src.size, W - s)
        keep = rng.random(k) >= sub
        txt[n, s : s + k] = np.where(keep, src[:k], txt[n, s : s + k])
    logq = np.log(rng.uniform(1e-4, 0.3, (N, L))).astype(np.float32)
    plen = rng.integers(0, L + 1, N).astype(np.int32)
    plen[:3] = [0, 1, L]
    return pat, logq, plen, txt


@pytest.mark.parametrize("anchored", [False, True])
def test_fitting_edit_distance_matches_reference(anchored):
    rng = np.random.default_rng(11 + anchored)
    pat, logq, plen, txt = dp_rows(rng, 96, 40, 60)
    ref = jdp.fitting_edit_distance(
        jnp.asarray(pat), jnp.asarray(logq), jnp.asarray(plen),
        jnp.asarray(txt), anchored=anchored,
    )
    got = tdp.fitting_edit_distance_plain(
        torch.from_numpy(pat), torch.from_numpy(logq), torch.from_numpy(plen),
        torch.from_numpy(txt), anchored=anchored,
    )
    live = plen > 0  # plen == 0 rows carry the "no answer" sentinel
    assert (np.asarray(ref.dist)[live] <= 40).all()
    assert_fields(ref, got, ref._fields)


@pytest.mark.parametrize(
    "penalties", [(1, 4, 6, 1), (2, 6, 8, 2)], ids=["default", "gm2-gs6-go8-ge2"]
)
def test_affine_extend_matches_reference(penalties):
    match, sub, gap_open, gap_extend = penalties
    rng = np.random.default_rng(sum(penalties))
    N, L, T = 96, 40, 70
    pat, logq, plen, txt = dp_rows(rng, N, L, T)
    tlen = np.minimum(plen + 27, T - 1).astype(np.int32)
    sinit = rng.integers(0, 120, N).astype(np.int32)
    bonus = rng.integers(5, 11, N).astype(np.int32)
    args = (pat, logq, plen, txt, tlen, sinit, bonus)
    kw = dict(match=match, sub=sub, gap_open=gap_open, gap_extend=gap_extend)
    ref = jaf.affine_extend(*(jnp.asarray(a) for a in args), **kw)
    got = taf.affine_extend_plain(*(torch.from_numpy(a) for a in args), **kw)
    assert np.asarray(ref.pattern_clip).any()  # local ends exercised
    assert_fields(ref, got, ref._fields)


def _gapless_inputs(rng, B, K, L):
    """Packed words for B reads x K candidates, in the layout the
    pipeline hands the prescreen (tests/test_gapless_pallas.py's)."""
    PW = (L + 15) // 16
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.01] = 4
    plen = rng.integers(L // 2, L + 1, B).astype(np.int32)
    rc = np.full_like(bases, 4)
    for i in range(B):
        r = bases[i, : plen[i]][::-1]
        rc[i, : plen[i]] = np.where(r < 4, 3 - r, 4)
    dirs = rng.integers(0, 2, (B, K)).astype(np.int32)
    text = np.where(
        rng.random((B, K, L)) < 0.97,
        np.where(dirs[:, :, None] == 1, rc[:, None], bases[:, None]),
        rng.integers(0, 4, (B, K, L)),
    ).astype(np.uint8)
    tbad = rng.random((B, K, L)) < 0.02

    def pack(codes, nbits):  # [..., L] -> [..., PW] uint32
        m = np.zeros(codes.shape[:-1] + (PW * 16,), np.uint32)
        m[..., :L] = codes
        sh = (nbits * np.arange(16)).astype(np.uint32)
        return (m.reshape(m.shape[:-1] + (PW, 16)) << sh).sum(-1, dtype=np.uint32)

    def pack_pat(mat):
        return pack(np.where(mat < 4, mat, 0), 2), pack((mat >= 4).astype(np.uint8), 2)

    fw, fb = pack_pat(bases)
    rw, rb = pack_pat(rc)
    tw = pack(np.where(text < 4, text, 0), 2).reshape(B, K * PW)
    bw = pack(tbad.astype(np.uint8), 2).reshape(B, K * PW)
    logq_f = np.log(rng.uniform(1e-4, 0.3, (B, L))).astype(np.float32)
    logq_r = logq_f[:, ::-1].copy()
    return (tw, bw, fw, rw, fb, rb, logq_f, logq_r, dirs, plen), PW


def test_gapless_prescreen_matches_pallas_interpret():
    from snap_tpu.ops.gapless_pallas import gapless_prescreen_pallas

    rng = np.random.default_rng(2)
    B, K, L = 24, 8, 100
    arrays, PW = _gapless_inputs(rng, B, K, L)
    rd, rl = gapless_prescreen_pallas(
        *(jnp.asarray(a) for a in arrays), K, PW, interpret=True
    )
    as_t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32 else a
    )
    d, lp = tgl.gapless_prescreen_plain(*(as_t(a) for a in arrays), K, PW)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_allclose(lp.numpy(), np.asarray(rl), rtol=0, atol=ATOL)
    assert (np.asarray(rd) > 0).any() and (np.asarray(rd) == 0).any()


def test_gapless_tier1_matches_jnp_branch():
    """The port's tier 1 against the jnp branch snap_tpu runs off the
    TPU, on real candidates from an index, with both sides given the
    same log-error arrays."""
    from snap_tpu.align import pipeline as J
    from snap_tpu.index.build import build_index
    from snap_tpu.index.index import make_device_index as jmake
    from snap_tpu_torch.align import pipeline as T
    from snap_tpu_torch.index.index import make_device_index as tmake
    from test_torch_index import make_codes, padded_genome

    rng = np.random.default_rng(17)
    codes = make_codes("repeat25", rng, 30_000)
    genome = padded_genome(codes)
    arrays = build_index(genome, seed_len=20)
    jd, td = jmake(arrays, genome.bases), tmake(arrays, genome.bases, "cpu")
    B, L, ML = 48, 100, 112
    starts = rng.integers(0, codes.size - L, B)
    seqs = codes[starts[:, None] + np.arange(L)[None, :]]
    seqs = np.where(rng.random(seqs.shape) < 0.03, rng.integers(0, 4, seqs.shape), seqs)
    bases = np.full((B, ML), 4, np.uint8)
    bases[:, :L] = seqs
    quals = np.zeros((B, ML), np.uint8)
    quals[:, :L] = rng.integers(35, 75, (B, L))
    lens = np.full(B, L, np.int32)
    params = J.AlignParams(seed_len=20, max_probe=arrays["max_probe"], hit_cap=8, max_cand=8)

    bundle = J._awd_candidates(jd, jnp.asarray(bases), jnp.asarray(quals), jnp.asarray(lens), params)
    loc, off, cdir, valid, weight, pop, trunc, len_eff, nlk = bundle
    tb, tq = torch.from_numpy(bases), torch.from_numpy(quals)
    tle = torch.from_numpy(np.array(len_eff))
    rcb, rcq = T.reverse_complement_reads(tb, tq, tle)
    lf, lr = T.device_logq(tq), T.device_logq(rcq)
    t1 = J._score_from_candidates(
        jd, jnp.asarray(bases), jnp.asarray(rcb.numpy()),
        jnp.asarray(lf.numpy()), jnp.asarray(lr.numpy()),
        jnp.asarray(quals), jnp.asarray(rcq.numpy()), len_eff,
        loc, off, cdir, valid, weight, pop, trunc, nlk, params, tier1_only=True,
    )
    d, lp = T._tier1_gapless(
        td, tb, rcb, lf, lr, tle,
        torch.from_numpy(np.array(loc)), torch.from_numpy(np.array(cdir)),
    )
    ok = np.asarray(valid).reshape(-1)
    ref_d = np.asarray(t1.gapless_dist).reshape(-1)
    np.testing.assert_array_equal(np.minimum(d.numpy(), 1 << 14)[ok], ref_d[ok])
    np.testing.assert_allclose(
        lp.numpy()[ok], np.asarray(t1.gapless_logp).reshape(-1)[ok], rtol=0, atol=ATOL
    )
    assert ok.sum() > B and (ref_d[ok] > 2).any()


def test_device_logq_close_to_reference():
    """The port takes ln P(error) from a 256-entry table (exp and log in
    float64, one rounding to float32), so the CPU and the card agree bit
    for bit; snap_tpu evaluates the float32 formula with its backend's
    exp/log approximations. Both round the formula's float32 steps,
    whose 1 - (1 - 10^(-q/10)) * (1 - SNP_PROB) cancels at low phred and
    magnifies a one-ulp exp difference well above one ulp of the result."""
    from snap_tpu.align.pipeline import device_logq as jlogq
    from snap_tpu.constants import phred_to_probability_table
    from snap_tpu_torch.align.pipeline import device_logq as tlogq

    q = np.arange(256, dtype=np.uint8).reshape(2, 128)
    got = tlogq(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlogq(jnp.asarray(q))), rtol=1e-5, atol=0)
    truth = np.log(phred_to_probability_table()[q.reshape(-1)]).reshape(q.shape)
    np.testing.assert_allclose(got, truth, rtol=1e-5, atol=0)


def test_device_logq_has_no_negative_zero():
    """The gapless kernel sums ln P(error) over the set bits only and
    skips the plain version's +0.0 terms and empty windows: exact only
    if no partial sum is -0.0, which holds when every table entry is
    <= 0 and none is -0.0 (a sum from +0.0 of such values never is)."""
    from snap_tpu_torch.align.pipeline import device_logq as tlogq

    got = tlogq(torch.arange(256, dtype=torch.uint8)).numpy()
    assert (got <= 0).all()
    assert not (np.signbit(got) & (got == 0)).any()
