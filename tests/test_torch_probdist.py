"""ops.probdist: snap_tpu_torch's ProbabilityDistance scorer against
snap_tpu's, and its match/mismatch tables.

Both packages score the same reference windows, reads and qualities
(tests/test_probdist.py's inputs: substitutions, a deletion or an
insertion per read) and must agree bit for bit: every row adds the same
float32 log probabilities in the same order in both, and a running max
(snap_tpu's associative scan, the port's cummax) is exact in any order.
The tables are numpy in both and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snap_tpu.ops import probdist as J
from snap_tpu_torch.ops import probdist as T

torch.set_num_threads(1)


def make_case(seed, N=6, L=30, shift=4):
    rng = np.random.default_rng(seed)
    W = L + shift + 2
    ref = rng.integers(0, 4, size=(N, W)).astype(np.uint8)
    read = np.zeros((N, L), dtype=np.uint8)
    for i in range(N):
        r = list(ref[i, :L])
        if i % 3 == 1:  # deletion in the read
            del r[10]
            r.append(int(rng.integers(0, 4)))
        if i % 3 == 2:  # insertion in the read
            r.insert(15, int(rng.integers(0, 4)))
            r = r[:L]
        for _ in range(2):
            p = int(rng.integers(0, L))
            r[p] = int(rng.integers(0, 4))
        read[i] = r
    qual = rng.integers(ord("#"), ord("J"), size=(N, L)).astype(np.uint8)
    # shorter effective lengths and an N base exercise the early answer
    # rows and the never-matching code
    lens = np.full(N, L, dtype=np.int32)
    lens[1] = L - 7
    read[2, 5] = 4
    return ref, read, qual, lens


def test_tables_equal():
    for snp in (0.001, 0.01):
        for a, b in zip(J.match_mismatch_log_tables(snp), T.match_mismatch_log_tables(snp)):
            np.testing.assert_array_equal(a, b)
    assert J.NO_PROB == T.NO_PROB and J.MAX_SHIFT == T.MAX_SHIFT


@pytest.mark.parametrize("seed, start_shift, shift", [
    (0, 2, 4), (1, 2, 4), (2, 0, 5), (3, 3, 3),
])
def test_probability_distance_matches_reference(seed, start_shift, shift):
    ref, read, qual, lens = make_case(seed, shift=shift)
    want = np.asarray(J.probability_distance(
        jnp.asarray(ref), jnp.asarray(read), jnp.asarray(qual),
        jnp.asarray(lens), max_start_shift=start_shift, max_shift=shift,
    ))
    got = T.probability_distance(
        *map(torch.from_numpy, (ref, read, qual, lens)),
        max_start_shift=start_shift, max_shift=shift,
    )
    assert got.dtype == torch.float32 and got.shape == (ref.shape[0],)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (got.numpy() > T.NO_PROB / 2).all()
