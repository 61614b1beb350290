"""Paired-end options in snap_tpu_torch against snap_tpu, on the CPU:
twins of tests/test_paired_options.py (-fs, -om/-omax, the chimeric
fallback's maxK/2, the hamming rescue, -pfc), tests/test_ins_spacing.py
(-ins insert-size inference) and tests/test_planned_pairs.py (planned
native paired emission against the per-pair path, byte for byte).

Each case runs the port's function and snap_tpu's on the same inputs:
the results must be equal field for field, and the port's must pass the
original test's assertions.
"""

import dataclasses
import io
import math
import os
import sys

import numpy as np
import pytest
import torch

import snap_tpu.align.paired as JPA
import snap_tpu.align.paired_driver as jpd
import snap_tpu_torch.align.paired as TPA
import snap_tpu_torch.align.paired_driver as tpd
from snap_tpu_torch.genome import Contig, Genome
from snap_tpu_torch.io import native as tnative
from snap_tpu_torch.io.output import OutputWriter

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

torch.set_num_threads(1)


def _cand(locs, dists, dirs, ag=None):
    n = len(locs)
    return {
        "dist": np.asarray(dists, dtype=np.int64),
        "log_prob": np.full(n, -1.0, dtype=np.float64),
        "ag_score": np.asarray(ag if ag is not None else [90] * n, dtype=np.int64),
        "end_loc": np.asarray(locs, dtype=np.int64) + 100,
        "cand_loc": np.asarray(locs, dtype=np.int64),
        "direction": np.asarray(dirs, dtype=np.int64),
        "valid": np.ones(n, dtype=bool),
        "escalated": np.zeros(n, dtype=bool),
    }


def as_plain(x):
    """Results as comparable plain values (dataclasses as dicts)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [as_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: as_plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def pair(*args, **kw):
    """finalize_pair in both packages: the port's result, after holding
    it equal to snap_tpu's."""
    ref = JPA.finalize_pair(*args, **kw)
    got = TPA.finalize_pair(*args, **kw)
    assert as_plain(got) == as_plain(ref)
    return got


FAR = ([1000], [0], [0]), ([900000], [0], [1])


@pytest.mark.parametrize("force", [False, True], ids=["default", "fs"])
def test_force_spacing_unpaired(force):
    r0, r1, _, _ = pair(_cand(*FAR[0]), _cand(*FAR[1]), 0, 0, 0, 1000, force_spacing=force)
    if force:
        assert r0.status == "notfound" and r1.status == "notfound"
    else:
        # chimeric single fallback keeps both ends
        assert r0.status in ("single", "multi") and not r0.aligned_as_pair


def test_force_spacing_keeps_real_pairs():
    r0, r1, _, _ = pair(_cand([1000], [0], [0]), _cand([1300], [0], [1]),
                        0, 0, 0, 1000, force_spacing=True)
    assert r0.aligned_as_pair and r1.aligned_as_pair


def test_pair_secondaries_om():
    c0 = _cand([1000, 5000, 9000], [0, 1, 5], [0, 0, 0], ag=[100, 95, 60])
    c1 = _cand([1300, 5300, 9300], [0, 1, 5], [1, 1, 1], ag=[100, 95, 60])
    r0, r1, _, secs = pair(c0, c1, 0, 0, 0, 1000, max_secondary_edit=3)
    assert r0.aligned_as_pair and r0.cand_index == 0
    assert len(secs) == 1
    s0, s1 = secs[0]
    assert s0.cand_index == 1 and s1.cand_index == 1
    assert s0.mapq == 0 and s0.aligned_as_pair
    _, _, _, secs0 = pair(c0, c1, 0, 0, 0, 1000, max_secondary_edit=30, max_secondary=1)
    assert len(secs0) == 1
    _, _, _, secs_off = pair(c0, c1, 0, 0, 0, 1000)
    assert secs_off == []


def test_fallback_single_end_secondaries_om():
    c0 = _cand([1000, 4000], [0, 1], [0, 0], ag=[100, 95])
    r0, r1, _, secs = pair(c0, _cand(*FAR[1]), 0, 0, 0, 1000, max_secondary_edit=2)
    assert not r0.aligned_as_pair
    assert len(secs) == 1
    s0, s1 = secs[0]
    assert s1 is None and s0.cand_index == 1 and s0.mapq == 0


@pytest.mark.parametrize("max_k", [8, 12])
def test_fallback_maxk_half_cap(max_k):
    # the chimeric fallback realigns with maxKSingleEnd = maxK/2
    # (ChimericPairedEndAligner.cpp:75)
    r0, r1, _, _ = pair(_cand([1000], [5], [0]), _cand(*FAR[1]), 0, 0, 0, 1000, max_k=max_k)
    if max_k == 8:
        assert r0.status == "notfound" and r1.status in ("single", "multi")
    else:
        assert r0.status in ("single", "multi")


def rescue(genome, read, **kw):
    args = dict(
        cand_loc=np.array([1200], dtype=np.int64),
        seed_off=np.array([0], dtype=np.int32),
        direction=np.array([0], dtype=np.int32),
        cand_ok=np.array([True]), score_limit=13, popular=0,
    )
    args.update(kw)
    quals = np.full(read.size, ord("I"), dtype=np.uint8)
    ref = JPA.hamming_rescue(genome, read, quals, read.size, 24, **args)
    got = TPA.hamming_rescue(genome, read, quals, read.size, 24, **args)
    assert as_plain(got) == as_plain(ref)
    return got


@pytest.mark.parametrize("case", ["bad_tail", "garbage"])
def test_hamming_rescue(case):
    rng = np.random.default_rng(7 if case == "bad_tail" else 8)
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    if case == "garbage":
        assert rescue(genome, rng.integers(0, 4, size=100).astype(np.uint8)) is None
        return
    loc = 1200
    read = genome[loc : loc + 100].copy()
    # trash the last 30 bases: the gapless scorer soft-clips them away
    read[70:] = (read[70:] + 1 + rng.integers(0, 3, 30).astype(np.uint8)) % 4
    res = rescue(genome, read)
    assert res is not None and res["start_loc"] == loc and res["clip_before"] == 0
    assert 25 <= res["clip_after"] <= 31
    assert res["nm"] <= 2 and res["mapq"] > 0


@pytest.mark.parametrize("keep", [True, False], ids=["pfc", "default"])
def test_preserve_fastq_comments(keep):
    g = Genome(bases=np.zeros(100, dtype=np.uint8),
               contigs=[Contig(name="c", start=0, length=100)])
    buf = io.BytesIO()
    w = OutputWriter(out=buf, genome=g, preserve_fastq_comments=keep)
    w.write_header()
    w.write_record(b"r1 BC:Z:ACGT extra", 0, "c", 1, 60, "4M", b"ACGT", b"IIII", nm=0)
    line = [ln for ln in buf.getvalue().decode().splitlines() if not ln.startswith("@")][0]
    assert line.startswith("r1\t")
    assert line.endswith("\tBC:Z:ACGT extra") == keep and ("BC:Z" in line) == keep


# --------------------------------------------------------------- -ins


def reference_spacing(spacing_sorted):
    """computeSpacingDist transliterated (tests/test_ins_spacing.py)."""
    n = len(spacing_sorted)
    s25 = spacing_sorted[int(0.25 * n)]
    s75 = spacing_sorted[int(0.75 * n)]
    min0 = max(s25 - 2 * (s75 - s25), 1)
    max0 = s75 + 2 * (s75 - s25)
    inliers = [x for x in spacing_sorted if min0 <= x <= max0]
    avg = sum(inliers) / len(inliers)
    stddev = math.sqrt(sum((x - avg) ** 2 for x in inliers) / len(inliers))
    mn = min(int(avg - 4 * stddev), int(s25 - 3 * (s75 - s25)))
    mx = max(int(avg + 4 * stddev), int(s75 + 3 * (s75 - s25)))
    return max(mn, 1), mx


def spacing_after(samples, batch, start=(50, 1000)):
    """(min, max) spacing after _update_spacing in both packages."""
    out = []
    for mod in (jpd, tpd):
        a = mod.PairedEndAligner.__new__(mod.PairedEndAligner)
        a.infer_spacing_batch = batch
        a._spacing_samples = []
        a.min_spacing, a.max_spacing = start
        a._update_spacing(list(samples))
        out.append((a.min_spacing, a.max_spacing, list(a._spacing_samples)))
    assert out[1] == out[0]
    return out[1][:2]


def test_ins_matches_reference_math():
    rng = np.random.default_rng(9)
    n = 1024
    samples = np.concatenate([
        rng.normal(320, 40, size=n - 32).astype(np.int64),
        rng.integers(1, 5000, size=32),  # outliers
    ]).tolist()
    assert spacing_after(samples[: n + 5], n) == reference_spacing(sorted(samples[:n]))


@pytest.mark.parametrize("case", ["below_batch", "floor_at_one", "quartiles"])
def test_ins_update_rules(case):
    if case == "below_batch":
        assert spacing_after([300] * 100, 256) == (50, 1000)
    elif case == "floor_at_one":
        assert spacing_after([1] * 32 + [9] * 32, 64)[0] == 1
    else:
        samples = np.random.default_rng(3).normal(400, 30, size=1000).astype(int)
        lo, hi = spacing_after(samples.tolist(), 1000, start=(0, 1000))
        assert 1 <= lo < 300 and 500 < hi < 1200
        assert lo <= 400 - 3 * 40 and hi >= 400 + 3 * 40


# ------------------------------------------------------ planned emission


def test_planned_pairs_vs_per_pair_byte_parity(tmp_path):
    """The port's batched native paired emission against its per-pair
    path (PairedEndAligner._plan_ok forced False): the same records."""
    if not tnative.has_paired_formatter():
        pytest.skip(f"native paired formatter absent: {tnative.BUILD_ERROR}")
    from golden_harness import gen_genome, gen_pairs, write_fasta, write_fastq

    from snap_tpu_torch.cli import main

    rng = np.random.default_rng(21)
    contigs = gen_genome(rng, 120_000, n_contigs=2, repeat_frac=0.15)
    fa = tmp_path / "g.fa"
    write_fasta(contigs, str(fa))
    idx = tmp_path / "idx"
    assert main(["index", str(fa), str(idx), "-s", "20"], device="cpu") == 0
    r1, r2 = gen_pairs(rng, contigs, 180, 100, 0.015, 0.004)
    junk = lambda: "".join("ACGT"[c] for c in rng.integers(0, 4, 100))
    for k in range(6):
        r1.append((f"junkpair{k}", junk(), "I" * 100))
        r2.append((f"junkpair{k}", r2[k][1], "I" * 100))
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    write_fastq(r1, str(fq1))
    write_fastq(r2, str(fq2))

    o1, o2 = tmp_path / "a.sam", tmp_path / "b.sam"
    used = tnative.USED["sam_formatter_paired"]
    assert main(["paired", str(idx), str(fq1), str(fq2), "-o", str(o1)], device="cpu") == 0
    assert tnative.USED["sam_formatter_paired"] == used + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpd.PairedEndAligner, "_plan_ok", lambda self, w: False)
        assert main(["paired", str(idx), str(fq1), str(fq2), "-o", str(o2)], device="cpu") == 0

    def body(p):  # @PG embeds the output path in CL
        return [ln for ln in p.read_bytes().split(b"\n") if not ln.startswith(b"@PG")]

    b1, b2 = body(o1), body(o2)
    assert len(b1) == len(b2) and len(b1) > 2 * len(r1)
    for x, y in zip(b1, b2):
        assert x == y, (x, y)


def test_mesh_raises_naming_a13(tmp_path, monkeypatch):
    """A PairedEndAligner runs on its mesh's primary device; given a mesh
    over several processes it raises (SAM is written by one process, as
    in snap_tpu). Such a mesh needs an initialised group: without one
    the mesh itself raises; the aligner's refusal is checked as rank 0
    of a two-rank group (the group's size, rank and subgroups stubbed)."""
    import torch

    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.parallel import mesh as tmesh
    from snap_tpu_torch.parallel.mesh import make_mesh

    g = Genome(bases=np.random.default_rng(1).integers(0, 4, 4096).astype(np.uint8),
               contigs=[Contig(name="c", start=0, length=4096)])
    idx = GenomeIndex.build(g, seed_len=20, device="cpu")
    cpu4 = [torch.device("cpu")] * 4
    with pytest.raises(RuntimeError, match="initialised torch.distributed group"):
        make_mesh(2, 2, cpu4, ranks=[0, 0, 1, 1])
    with monkeypatch.context() as mp:
        mp.setattr(tmesh, "_group_size", lambda: 2)
        mp.setattr(tmesh, "_group_rank", lambda: 0)
        mp.setattr(torch.distributed, "new_group", lambda ranks: None)
        two_procs = make_mesh(2, 2, cpu4, ranks=[0, 0, 1, 1])
    assert two_procs.multiprocess and two_procs.local_rows == (0,)
    with pytest.raises(ValueError, match="one process"):
        tpd.PairedEndAligner(idx, AlignParams(seed_len=20), mesh=two_procs)
    mesh = make_mesh(2, 2, cpu4)
    idx.to_mesh(mesh, 2)
    al = tpd.PairedEndAligner(idx, AlignParams(seed_len=20), mesh=mesh)
    assert al.device == mesh.primary and al.device.type == "cpu"
    assert tpd.PairedEndAligner(idx, AlignParams(seed_len=20)).device.type == "cpu"
