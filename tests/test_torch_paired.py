"""The paired-end path end to end: `index` and `paired` through
snap_tpu_torch's CLI on the CPU against snap_tpu's, byte for byte.

Each package builds its own index from the same FASTA (tools/
golden_harness.py: two contigs, uniform random or 25% repeats) and
aligns the same 180 simulated pairs (wgsim-style, 1.5% substitutions,
0.4% indels), plus pairs whose first end is junk (the hamming rescue
and the unmapped-mate fields) and clean pairs whose first end lost one
base 2-6 from its end so that its gapless alignment has exactly two
mismatches (the edge-indel fix), in a directory of its own under the
same relative paths. The SAM files must be identical.

On the repeat genome the two device tiers get narrower geometry in both
packages (hit_cap 32 / cand_width 32, and a wide tier of 96 / 64), so
that a genome this small overflows the standard tier on some pairs and
the wide tier on a few: the wide tier and the exact host redo both run.
The same genome then runs with the device intersection off (the host
intersection for every pair). The port's branch counts
(PairedEndAligner.branches) say which paths ran. The reference runs
without a mesh and with the port's ln P(error) table (see
test_torch_single.py).
"""

import functools
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import snap_tpu.align.intersect_device as JD
import snap_tpu.align.paired_driver as jpd
import snap_tpu.cli as jcli
import snap_tpu_torch.align.intersect_device as TD
import snap_tpu_torch.align.paired_driver as tpd
import snap_tpu_torch.cli as tcli
from snap_tpu_torch.io import native as tnative
from test_torch_pipeline import same_logq  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from golden_harness import gen_genome, gen_pairs, write_fasta, write_fastq  # noqa: E402

torch.set_num_threads(1)

N_PAIRS = 180
INDEX = ["index", "g.fa", "idx", "-s", "20"]
PAIRED = ["paired", "idx", "r1.fq", "r2.fq", "-o", "out.sam"]
RC = str.maketrans("ACGT", "TGCA")


def edge_deletion_pairs(rng, contigs, n, L=100):
    """Clean pairs whose first end lost one base near its end, at the
    place where the shifted tail gives exactly two mismatches."""
    out1, out2 = [], []
    names = list(contigs)
    while len(out1) < n:
        cname = names[int(rng.integers(0, len(names)))]
        seq = contigs[cname]
        pos = int(rng.integers(0, len(seq) - 400))
        ref = seq[pos : pos + L + 1]
        for p in range(L - 2, L - 7, -1):
            read = ref[:p] + ref[p + 1 : L + 1]
            if sum(a != b for a, b in zip(read[p:], ref[p:L])) == 2:
                break
        else:
            continue
        mate = seq[pos + 300 - L : pos + 300].translate(RC)[::-1]
        name = f"edge{len(out1)}_{cname}_{pos + 1}"
        out1.append((name, read, "I" * L))
        out2.append((name, mate, "I" * L))
    return out1, out2


def write_inputs(directory, kind):
    rng = np.random.default_rng(21)
    contigs = gen_genome(rng, 240_000, n_contigs=2,
                         repeat_frac=0.25 if kind == "repeat25" else 0.0)
    r1, r2 = gen_pairs(rng, contigs, N_PAIRS, 100, 0.015, 0.004)
    e1, e2 = edge_deletion_pairs(rng, contigs, 8)
    r1 += e1
    r2 += e2
    for k in range(6):
        junk = "".join("ACGT"[c] for c in rng.integers(0, 4, 100))
        r1.append((f"junkpair{k}", junk, "I" * 100))
        r2.append((f"junkpair{k}", r2[k][1], "I" * 100))
    write_fasta(contigs, os.path.join(directory, "g.fa"))
    write_fastq(r1, os.path.join(directory, "r1.fq"))
    write_fastq(r2, os.path.join(directory, "r2.fq"))
    return len(r1)


@pytest.fixture(scope="module", params=["random", "repeat25"])
def kind(request):
    return request.param


def narrow_tiers(mp):
    """Both packages: standard tier 32/32, wide tier 96/64."""
    for m in (JD, TD):
        mp.setattr(m, "DeviceIntersectParams",
                   functools.partial(m.DeviceIntersectParams, hit_cap=32, cand_width=32))
        mp.setattr(m, "paired_wide_redo",
                   functools.partial(m.paired_wide_redo, hit_cap=96, cand_width=64))


def run_both(dirs, argv, kind, device_intersect=True) -> Counter:
    """`argv` through both CLIs (snap_tpu with no mesh); returns the
    port's PairedEndAligner.branches."""
    made = []

    def keeping(cls):
        align_files = cls.align_files

        def keep(self, *a, **kw):
            self.device_intersect = device_intersect
            made.append(self)
            return align_files(self, *a, **kw)

        return keep

    with pytest.MonkeyPatch.context() as mp:
        if kind == "repeat25":
            narrow_tiers(mp)
        mp.setattr(jcli, "_maybe_mesh", lambda opts: (None, 1))
        for cls in (jpd.PairedEndAligner, tpd.PairedEndAligner):
            mp.setattr(cls, "align_files", keeping(cls))
        mp.chdir(dirs["jax"])
        assert jcli.main(argv) == 0
        mp.chdir(dirs["torch"])
        assert tcli.main(argv, device="cpu") == 0
    return made[-1].branches


@pytest.fixture(scope="module")
def runs(kind, same_logq, tmp_path_factory):
    dirs = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"paired_{kind}_{side}")
        n = write_inputs(str(d), kind)
        dirs[side] = d
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(dirs["jax"])
        assert jcli.main(INDEX) == 0
        mp.chdir(dirs["torch"])
        assert tcli.main(INDEX, device="cpu") == 0
    used0 = dict(tnative.USED)
    branches = run_both(dirs, PAIRED, kind)
    return {
        "kind": kind, "pairs": n, **dirs, "branches": branches,
        "native": {k: v - used0[k] for k, v in tnative.USED.items()},
    }


def same_sam(runs, name, pairs):
    ref = (runs["jax"] / name).read_bytes()
    got = (runs["torch"] / name).read_bytes()
    lines = got.split(b"\n")
    assert sum(1 for ln in lines if ln and not ln.startswith(b"@")) >= 2 * pairs
    if got != ref:
        diff = [(a, b) for a, b in zip(ref.split(b"\n"), lines) if a != b]
        pytest.fail(f"{len(diff)} SAM lines differ, first: {diff[:2]}")


def test_paired_sam_byte_identical(runs):
    same_sam(runs, "out.sam", runs["pairs"])


def test_paired_branches_ran(runs):
    """Every pair through the device intersection; the edge-indel fix,
    the hamming rescue and the per-pair emission on both genomes, the
    planned native emission where the library built; on the repeat
    genome the wide tier and the host overflow redo."""
    br = runs["branches"]
    assert br["batches"] == 1 and br["device_intersect"] == runs["pairs"], br
    assert br["planned"] + br["per_pair"] == runs["pairs"], br
    want = ["edge_indel_fix", "hamming_rescue", "per_pair"]
    if runs["kind"] == "repeat25":
        want += ["wide_tier", "host_overflow_redo"]
    if tnative.has_paired_formatter():
        want.append("planned")
        assert runs["native"]["sam_formatter_paired"] == 1, runs["native"]
    missing = [k for k in want if br.get(k, 0) < 1]
    assert not missing, (missing, br)


def test_paired_host_intersection_matches(runs):
    """device_intersect off: the host intersection for every pair."""
    argv = PAIRED[:-1] + ["host.sam"]
    br = run_both(runs, argv, runs["kind"], device_intersect=False)
    assert br["host_intersect"] == runs["pairs"] and "device_intersect" not in br, br
    same_sam(runs, "host.sam", runs["pairs"])
