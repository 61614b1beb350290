"""The single-end main path end to end: `index` and `single` through
snap_tpu_torch's CLI on the CPU against snap_tpu's, byte for byte.

Each package builds its own index from the same FASTA (two contigs of
30 kbp, uniform random or 25% repeats) and aligns the same 192 reads
(exact, reverse-complemented, substituted, 1-3 bp indels, junk, with N,
shorter than -mrl, across the contig boundary) with -b 64, in a
directory of its own under the same relative paths, so even the @PG
line's CL: field is the same. The index files must hold the same arrays
and JSON, and the SAM files must be identical.

This file runs the 25%-repeat genome and a forced dp_overflow redo;
test_torch_single_random.py runs the same tests on the random genome.
The reference runs as the command line runs it on one device: no mesh
(tests/conftest.py gives JAX eight virtual CPU devices). Both packages
get the same ln P(error) table (test_torch_pipeline's same_logq says
why). On the port side the test reads which host branches ran
(SingleEndAligner.branches) and whether the native FASTQ
scanner and SAM formatter did the work (snap_tpu_torch.io.native.USED).
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import snap_tpu.align.pipeline as JP
import snap_tpu.cli as jcli
import snap_tpu_torch.align.pipeline as TP
import snap_tpu_torch.cli as tcli
from snap_tpu_torch.align import single as tsingle
from snap_tpu_torch.io import native as tnative
from test_torch_cli_cuda import write_inputs
from test_torch_pipeline import same_logq  # noqa: F401

torch.set_num_threads(1)

N_READS = 192   # three batches of -b 64
INDEX = ["index", "g.fa", "idx", "-s", "20"]
SINGLE = ["single", "idx", "r.fq", "-o", "out.sam", "-b", "64"]


def run_jax(directory, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        mp.setattr(jcli, "_maybe_mesh", lambda opts: (None, 1))
        assert jcli.main(argv) == 0


def run_torch(directory, argv) -> dict:
    """The port's CLI on the CPU; returns the host branch counts of the
    aligners it ran (SingleEndAligner.branches)."""
    made = []
    align_file = tsingle.SingleEndAligner.align_file

    def keep(self, *a, **kw):
        made.append(self)
        return align_file(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        mp.setattr(tsingle.SingleEndAligner, "align_file", keep)
        assert tcli.main(argv, device="cpu") == 0
    return dict(sum((a.branches for a in made), Counter()))


@pytest.fixture(scope="module")
def kind():
    """The genome of this file's runs (test_torch_single_random.py runs
    the same tests on the random genome, on another worker)."""
    return "repeat25"


@pytest.fixture(scope="module")
def runs(kind, same_logq, tmp_path_factory):
    """Both CLIs on one genome: the directories, and the port's branch
    and native-library counts of its `single` run."""
    dirs = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"{kind}_{side}")
        write_inputs(str(d), kind, N_READS)
        dirs[side] = d
    run_jax(dirs["jax"], INDEX)
    run_jax(dirs["jax"], SINGLE)
    run_torch(dirs["torch"], INDEX)
    used0 = dict(tnative.USED)
    branches = run_torch(dirs["torch"], SINGLE)
    return {
        "kind": kind, **dirs,
        "branches": branches,
        "native": {k: v - used0[k] for k, v in tnative.USED.items()},
    }


def test_index_files_match(runs):
    jd, td = runs["jax"] / "idx", runs["torch"] / "idx"
    names = sorted(os.listdir(jd))
    assert sorted(os.listdir(td)) == names
    assert {"index_arrays.npz", "index_meta.json", "genome_bases.npy",
            "genome_meta.json"} <= set(names)
    for n in names:
        a, b = jd / n, td / n
        if n.endswith(".json"):
            assert json.loads(b.read_text()) == json.loads(a.read_text()), n
        elif n.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(zb.files) == sorted(za.files), n
            for k in za.files:
                assert zb[k].dtype == za[k].dtype, (n, k)
                np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{n}:{k}")
        elif n.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert y.dtype == x.dtype
            np.testing.assert_array_equal(y, x, err_msg=n)
        else:
            assert b.read_bytes() == a.read_bytes(), n


def test_sam_byte_identical(runs):
    ref = (runs["jax"] / "out.sam").read_bytes()
    got = (runs["torch"] / "out.sam").read_bytes()
    lines = got.split(b"\n")
    assert sum(1 for ln in lines if ln and not ln.startswith(b"@")) == N_READS
    assert any(ln.startswith(b"@PG\t") and b"CL:single idx r.fq" in ln for ln in lines)
    if got != ref:
        diff = [(a, b) for a, b in zip(ref.split(b"\n"), lines) if a != b]
        pytest.fail(f"{len(diff)} SAM lines differ, first: {diff[:2]}")


def test_host_branches_ran(runs):
    """Pipelining over three batches, the per-read records, the batched
    AG CIGARs of escalated rows and the edge-indel redo on every genome,
    with the planned native emission and the native FASTQ scanner where
    the native library built; on the repeat genome also ag_flip rows,
    the fallback rows and the wide redo of truncated rows."""
    br, used = runs["branches"], runs["native"]
    assert br.get("batches") == N_READS // 64, br
    want = ["per_read", "ag_batch_escalated", "redo_edge_indel"]
    if runs["kind"] == "repeat25":
        want += ["ag_batch_flip", "fallback", "redo_truncated"]
    if tnative.has_sam_formatter():  # else both packages emit per read
        want.append("planned")
        assert used["fastq_scanner"] >= 1, used
        assert used["sam_formatter"] == N_READS // 64, used
    missing = [k for k in want if br.get(k, 0) < 1]
    assert not missing, (missing, br)


def test_dp_overflow_redo_matches(runs):
    """A batch whose DP tier overflowed is redone on both sides through
    _finalize: align_tier1 -> two_phase_merge -> finalize_batch, then the
    wide redos. dp_overflow is forced by a HostWinners that sets it."""
    def forced(base):
        class Overflowed(base):
            def __init__(self, packed):
                super().__init__(packed)
                self.dp_overflow = True

        return Overflowed

    argv = ["single", "idx", "r.fq", "-o", "ovf.sam", "-b", "64"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP, "HostWinners", forced(JP.HostWinners))
        mp.setattr(TP, "HostWinners", forced(TP.HostWinners))
        run_jax(runs["jax"], argv)
        br = run_torch(runs["torch"], argv)
    assert br.get("dp_overflow") == N_READS and br.get("two_phase") == N_READS, br
    assert "planned" not in br
    ref = (runs["jax"] / "ovf.sam").read_bytes()
    got = (runs["torch"] / "ovf.sam").read_bytes()
    assert got == ref
