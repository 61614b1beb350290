"""pipeline.winner_flags in snap_tpu_torch against snap_tpu's and against
the host screens it replaces (the twin of
tests/test_winner_packing.py::test_winner_flags_match_host_screens):
one_indel_improves and ag_restructure_possible on forward and RC rows,
with planted 1 bp deletions near the tail (edge indel) and 3 bp
deletions mid-tail (affine-gap restructure). Boolean flags: equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snap_tpu.align.pipeline as JP
import snap_tpu_torch.align.pipeline as TP
import snap_tpu_torch.align.single as TS
from snap_tpu.index.build import build_index
from snap_tpu.index.index import make_device_index as jmake
from snap_tpu_torch.index.index import make_device_index as tmake
from test_torch_index import padded_genome

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [5, 6])
def test_winner_flags_match_host_screens(seed):
    rng = np.random.default_rng(seed)
    glen = 20000
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    genome = padded_genome(codes)
    gbases = np.asarray(genome.bases)
    arrays = build_index(genome, seed_len=20)
    B, L = 48, 100
    starts = rng.integers(0, glen - L - 10, size=B)
    reads = codes[starts[:, None] + np.arange(L)[None, :]].copy()
    for i in range(B):
        s = starts[i]
        if i % 4 == 0:      # two substitutions (screen negatives)
            for p in (20, 60):
                reads[i, p] = (reads[i, p] + 1) % 4
        elif i % 4 == 1:    # 1 bp deletion near the tail
            reads[i, L - 3 :] = codes[s + L - 2 : s + L + 1]
        elif i % 4 == 2:    # 3 bp deletion mid-tail
            reads[i, 90:] = codes[s + 93 : s + 103]
    dirs = (np.arange(B) % 2).astype(np.int32)
    dec_rc = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)
    oriented = reads.copy()
    rc_rows = np.flatnonzero(dirs == 1)
    oriented[rc_rows] = dec_rc[reads[rc_rows, ::-1]]
    plens = np.full(B, L, np.int64)
    start_locs = starts.astype(np.int64) + 1000
    end_locs = start_locs + plens
    dists = np.full(B, 2, np.int64)
    fes = np.zeros(B, np.int64)
    rows = np.arange(B)

    kw = dict(seed_len=20, max_probe=arrays["max_probe"])
    j_edge, j_ag = JP.winner_flags(
        jmake(arrays, gbases), *map(jnp.asarray, (
            oriented, plens.astype(np.int32), dirs, end_locs, dists)),
        JP.AlignParams(**kw),
    )
    tp = TP.AlignParams(**kw)
    t_edge, t_ag = TP.winner_flags(
        tmake(arrays, gbases, "cpu"), *map(torch.from_numpy, (
            oriented, plens.astype(np.int32), dirs, end_locs, dists)),
        tp,
    )
    edge_host = TS.one_indel_improves(gbases, oriented, rows, dirs, start_locs, plens, fes)
    ag_host = TS.ag_restructure_possible(
        gbases, oriented, rows, dirs, start_locs, plens, fes, dists,
        match=tp.ag_match, sub=tp.ag_sub, gap_open=tp.ag_open, gap_extend=tp.ag_extend,
    )
    np.testing.assert_array_equal(t_edge.numpy(), np.asarray(j_edge), err_msg="edge_indel")
    np.testing.assert_array_equal(t_ag.numpy(), np.asarray(j_ag), err_msg="ag_flip")
    np.testing.assert_array_equal(t_edge.numpy(), edge_host, err_msg="edge_indel host")
    np.testing.assert_array_equal(t_ag.numpy(), ag_host, err_msg="ag_flip host")
    assert edge_host[1::4].all() and ag_host[2::4].all()
