"""The emission-time affine-gap alignment on the card
(ops/agcigar_cuda.py, csrc/agcigar.cu) on the CPU: its plain version
against the host's row-at-a-time DP (native/snapio.cpp ag_tb_core through
io.native.ag_traceback, and agcigar.ag_global_alignment's numpy twin),
and the batched CIGARs built on it (agcigar._card_batch, the path
compute_ag_cigar_batch takes for a genome on the card) against
compute_ag_cigar_at row by row.

Two tests are marked `cuda` and skip without a card: the kernel against
the plain version bit for bit, on rows of 1 to 1500 bp. On a machine with a card (and no JAX, so
without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_agcigar_kernel.py
"""

import numpy as np
import pytest
import torch

from snap_tpu_torch.align import agcigar
from snap_tpu_torch.constants import MAX_K
from snap_tpu_torch.io import native
from snap_tpu_torch.ops import agcigar_cuda
from snap_tpu_torch.stats import RECORDER

torch.set_num_threads(1)

CODES = {c: i for i, c in enumerate("ACGTN")}
GLEN = 4000


def _codes(s: str) -> np.ndarray:
    return np.array([CODES[c] for c in s], np.uint8)


def _genome(seed=3) -> np.ndarray:
    g = np.random.default_rng(seed).integers(0, 4, GLEN).astype(np.uint8)
    g[200:204] = 4
    return g


def _mutate(rng, ref: np.ndarray, L: int, indel: bool) -> np.ndarray:
    """L bases read from ref with substitutions and, if indel, one
    1-3 bp deletion or insertion."""
    p = ref[: L + 3].copy()
    for q in rng.integers(0, L, int(rng.integers(0, 5))):
        p[q] = rng.integers(0, 4)
    if indel:
        k, at = int(rng.integers(1, 4)), int(rng.integers(5, L - 5))
        if rng.random() < 0.5:
            p = np.delete(p, slice(at, at + k))
        else:
            p = np.insert(p, at, rng.integers(0, 4, k))
    return p[:L].astype(np.uint8)


def _rows(case: str):
    """(genome, [(pattern, loc, T)]) of a planted case."""
    g = _genome()
    rng = np.random.default_rng(sum(map(ord, case)))
    if case in ("random100", "random250"):
        L = int(case[6:])
        rows = []
        for r in range(12):
            loc = int(rng.integers(0, GLEN - L - 200))
            rows.append((_mutate(rng, g[loc:], L, r % 2 == 1), loc,
                         L + int(rng.integers(8, 40))))
        return g, rows
    if case == "ties":
        # homopolymers and tandem repeats: equal-score M, D and I cells,
        # and a gap whose place in the run is a tie
        g = g.copy()
        g[1000:1060] = np.tile(_codes("AAAAACACACGGGGG"), 4)
        return g, [(np.delete(g[1000:1060], [3, 8]), 1000, 66),
                   (np.insert(g[1000:1060], 12, [0, 1]), 1000, 64),
                   (_codes("CAACAAC"), 0, 8)]
    if case == "readout_tie":
        # the last column's best value at text rows 4 and 6: the later wins
        g = g.copy()
        g[500:508] = _codes("CAAACACA")
        return g, [(_codes("CAACAAC"), 500, 8)]
    if case == "n_bases":
        p = g[300:400].copy()
        p[[5, 50, 99]] = 4
        return g, [(p, 300, 110), (g[190:290].copy(), 190, 105), (p[:10], 198, 12)]
    if case == "leading_gaps":
        # the alignment starts with deletions (loc too early) or with
        # insertions (pattern bases before loc)
        return g, [(g[700:800].copy(), 697, 110), (g[700:800].copy(), 702, 110)]
    if case in ("long400", "long1500"):
        # rows whose plane does not fit a block's shared memory: the
        # kernel's global plane, in one stripe (400) and in three (1500)
        L = int(case[4:])
        rows = []
        for r in range(4):
            loc = int(rng.integers(0, GLEN - L - 200))
            rows.append((_mutate(rng, g[loc:], L, r % 2 == 1), loc, L + MAX_K))
        return g, rows
    if case == "margins":
        # T = L (margin 0) and the MAX_K cap of the text margin
        p = _mutate(rng, g[900:], 100, True)
        return g, [(p, 900, 100), (p, 900, 100 + MAX_K), (p[:1], 900, 1)]
    raise ValueError(case)


CASES = ["random100", "random250", "ties", "readout_tie", "n_bases", "leading_gaps", "margins",
         "long400", "long1500"]


def _meta(rows):
    off = np.cumsum([0] + [len(p) for p, _, _ in rows])[:-1]
    meta = np.array([(o, len(p), loc, T) for o, (p, loc, T) in zip(off, rows)], np.int64)
    return meta, np.concatenate([p for p, _, _ in rows])


def _decode(res_row):
    nr = int(res_row[0])
    runs = [[agcigar_cuda.OPS[v & 3], int(v >> 2)] for v in res_row[2 : 2 + nr]]
    return runs, int(res_row[1])


def _readout(text, pat):
    """h at the last pattern column of every text row (agcigar's DP)."""
    hp = -(agcigar.OPEN + np.arange(len(pat)) * agcigar.EXT)
    e = np.full(len(pat), agcigar.NEG)
    out = []
    for i, tb in enumerate(text):
        h0 = 0 if i == 0 else -(agcigar.OPEN + (i - 1) * agcigar.EXT)
        m = np.concatenate(([h0], hp[:-1])) + agcigar._tscore(pat, tb)
        p = np.maximum.accumulate(m - agcigar.OPEN + np.arange(len(pat)) * agcigar.EXT)
        f = np.concatenate(([agcigar.NEG], p[:-1] - np.arange(len(pat) - 1) * agcigar.EXT))
        hp = np.maximum(np.maximum(m, e), f)
        e = np.maximum(e - agcigar.EXT, m - agcigar.OPEN)
        out.append(hp[-1])
    return np.array(out)


def test_readout_tie_is_planted():
    g, [(p, loc, T)] = _rows("readout_tie")
    h = _readout(g[loc : loc + T], p)
    assert list(np.flatnonzero(h == h.max())) == [4, 6]


@pytest.mark.parametrize("reference", ["native", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_is_the_hosts_dp(case, reference, monkeypatch):
    g, rows = _rows(case)
    meta, pat = _meta(rows)
    res = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g), meta, pat, agcigar.OPEN,
                                         agcigar.EXT, agcigar.AG_MATCH, agcigar.AG_MISMATCH)
    assert res.shape == (len(rows), int((meta[:, 1] + meta[:, 3]).max()) + 2)
    if reference == "numpy":
        monkeypatch.setattr(native, "ag_traceback", lambda *a: None)
    for r, (p, loc, T) in enumerate(rows):
        text = g[loc : loc + T]
        if reference == "native":
            want = native.ag_traceback(text, p, agcigar.OPEN, agcigar.EXT,
                                       agcigar.AG_MATCH, agcigar.AG_MISMATCH)
            assert want is not None, native.BUILD_ERROR
        else:
            want = agcigar.ag_global_alignment(text, p)
        assert _decode(res[r]) == (want[0], want[1]), (case, r)


def test_empty_rows_fail():
    g = _genome()
    meta = np.array([(0, 0, 10, 20), (0, 5, 10, 0), (0, 5, 10, 6)], np.int64)
    res = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g), meta, g[10:15].copy(),
                                         agcigar.OPEN, agcigar.EXT, 1, 4)
    assert list(res[:, 0]) == [-1, -1, 1] and res[2, 2] == (5 << 2)


def test_launch_plan_groups_rows_by_lane_columns(monkeypatch):
    assert [agcigar_cuda.lane_cols(L) for L in (1, 32, 33, 100, 129, 250, 256, 257, 512)] == [
        1, 1, 2, 4, 6, 8, 8, 12, 16]
    assert agcigar_cuda.lane_cols(513) is None
    meta = np.array([(0, 100, 0, 120), (0, 120, 0, 130), (0, 250, 0, 280),
                     (0, 400, 0, 400 + MAX_K), (0, 1500, 0, 1500 + MAX_K)], np.int64)
    R, groups = agcigar_cuda.launch_plan(meta)
    slot = agcigar_cuda.slot_bytes(1500 + MAX_K, 1500)
    assert R == 3000 + MAX_K + 2 and groups == [
        (0, 2, 4, agcigar_cuda.smem_bytes(130, 4), 0, 2),
        (2, 3, 8, agcigar_cuda.smem_bytes(280, 8), 0, 1),
        (3, 5, 16, 0, slot, 2)]
    assert slot == 16 * (1500 + MAX_K) + (1500 + MAX_K) * 1536
    with pytest.raises(ValueError):
        agcigar_cuda.launch_plan(meta[::-1])
    # -rl 256's rows fit a block; a 400 bp row at the MAX_K margin does not
    assert agcigar_cuda.fits(256 + MAX_K, 256) and not agcigar_cuda.fits(400 + MAX_K, 400)
    assert [agcigar_cuda.case_of(T, L) for L, T in meta[:, [1, 3]]] == [4, 4, 8, 0, 0]
    G = agcigar_cuda.GLOBAL_KEY
    assert list(agcigar_cuda._order_keys(meta)) == [4, 4, 8, G, G]
    # the global plane's blocks: as many slots as the scratch holds, at least one
    monkeypatch.setattr(agcigar_cuda, "SCRATCH_BYTES", slot - 1)
    assert agcigar_cuda.launch_plan(meta)[1][-1] == (3, 5, 16, 0, slot, 1)


def test_rows_go_in_order_of_their_case():
    """ag_traceback_rows sorts its rows by case for the launches (the
    global plane's last) and hands the results back in the caller's
    order."""
    g, rows = _rows("long400")
    _, short = _rows("random100")
    mixed = [rows[0], short[0], rows[1], short[1]]
    meta, pat = _meta(mixed)
    args = (agcigar.OPEN, agcigar.EXT, agcigar.AG_MATCH, agcigar.AG_MISMATCH)
    res = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g), meta, pat, *args)
    for r, (p, loc, T) in enumerate(mixed):
        want = native.ag_traceback(g[loc : loc + T], p, *args)
        assert _decode(res[r]) == (want[0], want[1]), r


def _batch_rows(case):
    """compute_ag_cigar_batch's arguments for the case's rows, with the
    clips and margins of winner_record."""
    g, rows = _rows(case)
    rng = np.random.default_rng(7)
    bodies = [p for p, _, _ in rows]
    quals = [rng.integers(2, 70, len(p)).astype(np.uint8) for p in bodies]
    locs = np.array([loc for _, loc, _ in rows], np.int64)
    margins = np.array([max(T - len(p), 0) for p, _, T in rows], np.int32)
    fcl = rng.integers(0, 3, len(rows)).astype(np.int32)
    bcl = rng.integers(0, 3, len(rows)).astype(np.int32)
    return g, bodies, quals, locs, fcl, bcl, margins


@pytest.mark.parametrize("use_m", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_card_batch_is_compute_ag_cigar_at(case, use_m):
    g, bodies, quals, locs, fcl, bcl, margins = _batch_rows(case)
    RECORDER.drain()
    RECORDER.enable()
    try:
        with RECORDER.span("outer"):
            got = agcigar._card_batch(g, torch.from_numpy(g), bodies, quals, locs, fcl, bcl,
                                      margins, use_m)
    finally:
        RECORDER.disable()
    (span,) = RECORDER.drain()
    want = [agcigar.compute_ag_cigar_at(g, int(locs[i]), bodies[i], quals[i], int(fcl[i]),
                                        int(bcl[i]), use_m=use_m, text_margin=int(margins[i]))
            for i in range(len(bodies))]
    assert got == want
    assert all(x is not None for x in got) or case == "margins"
    if case == "leading_gaps":
        # both rows went round the fixup loop again: one launch more
        assert span[5] == {"iters": 2, "rerun_rows": 2}
        assert got[0][0] == 700 and got[1][1].startswith(f"{2 + fcl[1]}S")
    else:
        assert span[5]["iters"] >= 1


def test_card_batch_sends_every_row_to_the_card(monkeypatch):
    """No row of _card_batch goes to the host's native batch: rows of
    400 and 1500 bp (the global plane) beside 100 bp ones run the
    kernel's path, and equal compute_ag_cigar_at."""
    seen = []
    rows_fn = agcigar_cuda.ag_traceback_rows

    def spy(genome_t, meta, *a):
        seen.append(sorted(int(L) for L in meta[:, 1]))
        return rows_fn(genome_t, meta, *a)

    monkeypatch.setattr(agcigar_cuda, "ag_traceback_rows", spy)
    monkeypatch.setattr(agcigar, "compute_ag_cigar_batch", None)
    g, b4, q4, l4, f4, c4, m4 = _batch_rows("long400")
    _, b15, q15, l15, f15, c15, m15 = _batch_rows("long1500")
    _, b1, q1, l1, f1, c1, m1 = _batch_rows("random100")
    bodies, quals = b4[:2] + b15[:2] + b1[:2], q4[:2] + q15[:2] + q1[:2]
    locs = np.concatenate([l4[:2], l15[:2], l1[:2]])
    fcl, bcl, margins = (np.concatenate([x[:2], y[:2], z[:2]])
                         for x, y, z in ((f4, f15, f1), (c4, c15, c1), (m4, m15, m1)))
    got = agcigar._card_batch(g, torch.from_numpy(g), bodies, quals, locs, fcl, bcl,
                              margins, True)
    want = [agcigar.compute_ag_cigar_at(g, int(locs[i]), bodies[i], quals[i], int(fcl[i]),
                                        int(bcl[i]), text_margin=int(margins[i]))
            for i in range(len(bodies))]
    assert got == want and all(x is not None for x in got)
    assert seen[0] == [100, 100, 400, 400, 1500, 1500]


def test_a_cpu_genome_tensor_keeps_the_host_batch(monkeypatch):
    g, *args = _batch_rows("random100")
    monkeypatch.setattr(agcigar, "_card_batch", None)
    assert agcigar.compute_ag_cigar_batch(g, *args, genome_t=torch.from_numpy(g)) == \
        agcigar.compute_ag_cigar_batch(g, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_is_the_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, rows = _rows(case)
    meta, pat = _meta(rows)
    args = (agcigar.OPEN, agcigar.EXT, agcigar.AG_MATCH, agcigar.AG_MISMATCH)
    before = agcigar_cuda.ag_traceback_cuda.launches
    card = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g).cuda(), meta, pat, *args)
    plain = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g), meta, pat, *args)
    groups = len({agcigar_cuda.case_of(int(T), int(L)) for L, T in meta[:, [1, 3]]})
    assert agcigar_cuda.ag_traceback_cuda.launches - before == groups
    assert [_decode(x) for x in card] == [_decode(x) for x in plain]


@pytest.mark.cuda
def test_global_plane_blocks_take_several_rows(monkeypatch):
    """The global plane with fewer blocks than rows: each block's slot
    serves row after row (400 and 1500 bp rows and short ones beside them
    in one call, scratch for one slot), bit for bit with the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, long_rows = _rows("long1500")
    _, mid = _rows("long400")
    _, short = _rows("random250")
    rows = long_rows + mid + short[:3]
    meta, pat = _meta(rows)
    monkeypatch.setattr(agcigar_cuda, "SCRATCH_BYTES", 1)
    assert agcigar_cuda.launch_plan(meta[[8, 9, 10, 4, 5, 6, 7, 0, 1, 2, 3]])[1][-1][-1] == 1
    args = (agcigar.OPEN, agcigar.EXT, agcigar.AG_MATCH, agcigar.AG_MISMATCH)
    card = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g).cuda(), meta, pat, *args)
    plain = agcigar_cuda.ag_traceback_rows(torch.from_numpy(g), meta, pat, *args)
    assert [_decode(x) for x in card] == [_decode(x) for x in plain]
