"""tests/test_adaptive.py for snap_tpu_torch, on the CPU: the adaptive
two-phase step must match the full-depth wavefront, flag phase-B
overflow as truncated, and let phase C resolve repeat-truncated rows
exactly as a wide non-adaptive run does."""

import dataclasses

import numpy as np
import pytest
import torch

from snap_tpu_torch.align.pipeline import (
    AlignParams,
    HostWinners,
    align_winners_device,
)
from snap_tpu_torch.constants import PAD
from snap_tpu_torch.genome import Contig, Genome
from snap_tpu_torch.index.build import build_index
from snap_tpu_torch.index.index import GenomeIndex, make_device_index
from test_torch_pipeline import sample_reads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rand_index():
    rng = np.random.default_rng(7)
    glen = 60_000
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    bases = np.full(glen + 2000, PAD, dtype=np.uint8)
    bases[1000 : 1000 + glen] = codes
    genome = Genome(
        bases=bases, contigs=[Contig(name="chr1", start=1000, length=glen)]
    )
    return GenomeIndex.build(genome, seed_len=20, device="cpu"), codes


def _align(idx, seqs, params, **kw):
    B, L = seqs.shape
    ML = 128
    bases = np.full((B, ML), 4, np.uint8)
    bases[:, :L] = seqs
    quals = np.zeros((B, ML), np.uint8)
    quals[:, :L] = ord("I")
    win, _, _ = align_winners_device(
        idx.device,
        torch.from_numpy(bases),
        torch.from_numpy(quals),
        torch.from_numpy(np.full(B, L, np.int32)),
        torch.tensor(idx.genome_meta.first_alt_start()),
        params,
        **kw,
    )
    return HostWinners(win)


def _params(idx):
    return AlignParams(
        seed_len=20, max_probe=idx.max_probe, num_seeds=25,
        hit_cap=8, max_cand=16,
    )


def test_adaptive_matches_full_depth(rand_index):
    idx, codes = rand_index
    seqs = sample_reads(codes, np.random.default_rng(11), 96)
    full = _align(idx, seqs, _params(idx), adaptive=False)
    adap = _align(idx, seqs, _params(idx), adaptive=True)
    for name in (
        "found", "direction", "dist", "mapq", "end_loc", "body_loc",
        "clip_before", "clip_after", "indels", "truncated",
    ):
        np.testing.assert_array_equal(
            getattr(full, name), getattr(adap, name), err_msg=name
        )


def test_adaptive_phase_b_overflow_flags_truncated(rand_index):
    """With a phase-B capacity of 1 row, every read is either truncated
    (the host wide redo takes over) or equal to the full-depth answer,
    and the tiny capacity really overflows."""
    idx, codes = rand_index
    # a high error rate leaves many reads unresolved after phase A
    seqs = sample_reads(codes, np.random.default_rng(13), 64, err=0.08)
    full = _align(idx, seqs, _params(idx), adaptive=False)
    tiny = _align(idx, seqs, _params(idx), adaptive=True, phase_b_rows=1)
    ok = tiny.truncated | (
        (tiny.found == full.found)
        & (tiny.body_loc == full.body_loc)
        & (tiny.mapq == full.mapq)
        & (tiny.dist == full.dist)
    )
    assert ok.all(), np.flatnonzero(~ok)
    assert tiny.truncated.sum() > full.truncated.sum()


def test_phase_c_wide_tile_recovers_truncated_rows():
    """Phase C (hit_cap=128 / K=64 on truncated rows) resolves most
    repeat-truncated reads on the device and agrees exactly with a
    non-adaptive run at the same wide geometry."""
    rng = np.random.default_rng(29)
    glen = 600_000
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    # a 300 bp unit planted 60 times: its hits overflow the phase-B caps
    # (32) but stay under maxHits=300, so only phase C resolves them
    unit = codes[1000:1300].copy()
    for k in range(60):
        p = 5000 + 9500 * k
        codes[p : p + 300] = unit
    bases_g = np.full(glen + 2000, PAD, np.uint8)
    bases_g[1000 : 1000 + glen] = codes
    genome = Genome(
        bases=bases_g, contigs=[Contig(name="c1", start=1000, length=glen)]
    )
    arrays = build_index(genome, seed_len=20)
    didx = make_device_index(arrays, bases_g, device="cpu")
    params = AlignParams(
        seed_len=20, max_probe=arrays["max_probe"], num_seeds=25,
        hit_cap=8, max_cand=16,
    )

    B, L = 256, 100
    # half the reads overlap planted repeat copies
    starts = np.where(
        np.arange(B) % 2 == 0,
        5000 + 9500 * rng.integers(0, 60, B) + rng.integers(0, 250, B),
        rng.integers(0, glen - L - 1, B),
    )
    reads = codes[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random(reads.shape) < 0.01
    reads = np.where(mut, rng.integers(0, 4, reads.shape), reads).astype(np.uint8)
    b = torch.from_numpy(reads)
    q = torch.from_numpy(np.full((B, L), ord("I"), np.uint8))
    ln = torch.from_numpy(np.full(B, L, np.int32))
    fas = torch.tensor(bases_g.shape[0])

    base, _, _ = align_winners_device(didx, b, q, ln, fas, params, adaptive=True)
    wb = HostWinners(base)
    assert wb.truncated.sum() > 10, "repeat reads must truncate at A/B"

    wc_packed, _, _ = align_winners_device(
        didx, b, q, ln, fas, params, adaptive=True, phase_c=True
    )
    wc = HostWinners(wc_packed)
    assert wc.truncated.sum() < wb.truncated.sum() * 0.4, (
        int(wc.truncated.sum()), int(wb.truncated.sum())
    )

    wide = dataclasses.replace(params, hit_cap=128, max_cand=64)
    ref_packed, _, _ = align_winners_device(
        didx, b, q, ln, fas, wide, adaptive=False, dp_rows=4096
    )
    wr = HostWinners(ref_packed)
    fixed = np.flatnonzero(wb.truncated & ~wc.truncated & ~wc.fallback & ~wr.fallback)
    assert fixed.size > 0
    for f in ("found", "direction", "dist", "mapq", "end_loc"):
        np.testing.assert_array_equal(
            np.asarray(getattr(wc, f))[fixed],
            np.asarray(getattr(wr, f))[fixed], err_msg=f,
        )
