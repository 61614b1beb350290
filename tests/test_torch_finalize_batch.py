"""post.finalize_batch (vectorized) in snap_tpu_torch against snap_tpu's
and against the port's finalize_read per row (the twin of
tests/test_finalize_batch.py::test_batch_matches_per_read). Both are
numpy float64 host code, and the port's batch must equal snap_tpu's in
every field, probabilities included. Against the port's own per-read
path the probabilities are held as the reference test holds them
(pytest.approx): the vectorized sum adds the same terms in another
order, a last-bit difference in prob_all."""

import numpy as np
import pytest

import snap_tpu.align.post as J
import snap_tpu_torch.align.post as T


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("alt_awareness", [True, False])
def test_batch_matches_per_read(seed, alt_awareness):
    rng = np.random.default_rng(seed)
    B, K = 40, 16
    base = rng.integers(1000, 1_000_000, size=(B, K)).astype(np.int64)
    dup = rng.random((B, K)) < 0.3
    base = np.where(dup, np.roll(base, 1, axis=1), base)
    near = rng.random((B, K)) < 0.2
    base = np.where(near, np.roll(base, 2, axis=1) + rng.integers(1, 60, (B, K)), base)
    dist = rng.integers(0, 12, size=(B, K)).astype(np.int32)
    logp = -rng.random((B, K)).astype(np.float32) * 10
    ag = (100 - 5 * dist + rng.integers(0, 3, (B, K))).astype(np.int32)
    end = base + 100
    dirs = rng.integers(0, 2, size=(B, K)).astype(np.int32)
    valid = rng.random((B, K)) < 0.8
    valid[:, 0] = True
    valid[3] = False  # a notfound row
    popular = rng.integers(0, 15, size=B).astype(np.int32)
    is_alt = base > 800_000
    args = (dist, logp, ag, end, base, dirs, valid, popular)
    ref = J.finalize_batch(*args, is_alt=is_alt, alt_awareness=alt_awareness)
    got = T.finalize_batch(*args, is_alt=is_alt, alt_awareness=alt_awareness)
    assert len(got) == len(ref) == B
    fields = ("status", "mapq", "dist", "end_loc", "direction", "match_prob", "prob_all")
    for i in range(B):
        want, _ = T.finalize_read(
            dist[i], logp[i], ag[i], end[i], base[i], dirs[i], valid[i],
            int(popular[i]), is_alt=is_alt[i], alt_awareness=alt_awareness,
        )
        g, r = got[i][0], ref[i][0]
        for f in fields:
            assert getattr(g, f) == getattr(r, f), (i, f)
        assert g.status == want.status, i
        if want.status == "notfound":
            continue
        for f in fields[:5]:
            assert getattr(g, f) == getattr(want, f), (i, f)
        assert g.match_prob == pytest.approx(want.match_prob), i
        assert g.prob_all == pytest.approx(want.prob_all), i
