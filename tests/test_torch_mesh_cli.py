"""`single` and `paired` with -ishards 2 through snap_tpu_torch's CLI on
a mesh of CPU devices against snap_tpu's CLI on conftest's virtual
devices, byte for byte.

On eight devices both CLIs build a data = 4 x index = 2 mesh (the port
through main(..., devices=[cpu] * 8), snap_tpu over jax.devices()) and
round -b up to a multiple of 4; on one device -ishards 2 falls back to
one index shard and both run a 1 x 1 mesh (snap_tpu sees one device
through a patched jax.devices). Each package builds its own index from
the same FASTA (a 25%-repeat genome) in a directory of its own, and runs
the same relative argv, so the @PG line's CL: field is the same. The
reference gets the port's ln P(error) table (test_torch_single.py says
why). The port's aligners must have run on their mesh, and its
SingleEndAligner must have taken the dp_overflow redo through
align_tier1_sharded on a batch whose DP tier overflows.

BASELINE config 5 in one run (tools/demo_config5.py's shape): `paired
-ishards 2 -so` on the 4 x 2 mesh to a sorted, duplicate-marked BAM with
its .bai, on the fixture's pairs plus 8% of them planted again under new
names, .bam and .bai byte for byte.
"""

import os
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import snap_tpu.cli as jcli
import snap_tpu_torch.align.paired_driver as tpd
import snap_tpu_torch.cli as tcli
from snap_tpu_torch.align import single as tsingle
from snap_tpu_torch.parallel import mesh as tmesh
from test_torch_cli_cuda import write_inputs, write_pair_inputs
from test_torch_pipeline import same_logq  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 JAX devices")

INDEX = ["index", "g.fa", "idx", "-s", "20"]
SINGLE = ["single", "idx", "r.fq", "-o", "out.sam", "-b", "62", "-ishards", "2"]
PAIRED = ["paired", "idx", "r1.fq", "r2.fq", "-o", "pairs.sam", "-b", "32", "-ishards", "2"]
CONFIG5 = ["paired", "idx", "c5_1.fq", "c5_2.fq", "-o", "c5.bam", "-so", "-b", "32",
           "-ishards", "2"]
DUP_FRAC = 0.08  # tools/demo_config5.py's --dup-frac


def run_jax(directory, argv, n_dev=8):
    real = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        if n_dev < 8:
            mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:n_dev])
        assert jcli.main(argv) == 0


def run_torch(directory, argv, n_dev=8, spy=None):
    """The port's CLI on n_dev CPU devices; returns the aligners it made
    and the sharded steps' calls."""
    made, calls = [], Counter()
    wrap = {}
    for cls, meth in ((tsingle.SingleEndAligner, "align_file"),
                      (tpd.PairedEndAligner, "align_files")):
        orig = getattr(cls, meth)

        def keep(self, *a, _orig=orig, **kw):
            made.append(self)
            return _orig(self, *a, **kw)

        wrap[(cls, meth)] = keep
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(directory)
        for (cls, meth), f in wrap.items():
            mp.setattr(cls, meth, f)
        for name in ("align_winners_sharded", "align_tier1_sharded",
                     "paired_candidates_sharded"):
            orig = getattr(tmesh, name)

            def counted(*a, _orig=orig, _name=name, **kw):
                calls[_name] += 1
                return _orig(*a, **kw)

            mp.setattr(tmesh, name, counted)
        if spy is not None:
            spy(mp)
        assert tcli.main(argv, device="cpu", devices=[torch.device("cpu")] * n_dev) == 0
    return made, calls


@pytest.fixture(scope="module")
def dirs(same_logq, tmp_path_factory):
    out = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"mesh_{side}")
        write_pair_inputs(str(d), "repeat25", 96)  # writes an empty r.fq
        write_inputs(str(d), "repeat25", 248)
        run(d, INDEX)
        out[side] = d
    return out


def same_file(dirs, name):
    ref = (dirs["jax"] / name).read_bytes()
    got = (dirs["torch"] / name).read_bytes()
    assert got == ref, next(
        (i, a, b) for i, (a, b) in enumerate(zip(got.split(b"\n"), ref.split(b"\n")))
        if a != b
    )
    return got


def test_single_ishards2_on_eight_devices(dirs):
    run_jax(dirs["jax"], SINGLE)
    made, calls = run_torch(dirs["torch"], SINGLE)
    (al,) = made
    assert (al.mesh.shape["data"], al.mesh.shape["index"]) == (4, 2)
    assert al.batch_size == 64  # -b 62 rounded up to a multiple of 4
    assert calls["align_winners_sharded"] == 4 and al.branches["batches"] == 4
    sam = same_file(dirs, "out.sam")
    assert sam.count(b"\n") > 248


def test_single_dp_overflow_redo_on_mesh(dirs):
    """A 16-row DP tier overflows on every batch: both packages redo the
    batches through the sharded tier 1 and the host-gated path."""
    argv = SINGLE[:4] + ["over.sam"] + SINGLE[5:]

    def small_tier(mp, mod):
        orig = mod.align_winners_sharded

        def f(*a, **kw):
            kw["dp_rows"] = 16
            return orig(*a, **kw)

        mp.setattr(mod, "align_winners_sharded", f)

    from snap_tpu.parallel import mesh as jmesh

    with pytest.MonkeyPatch.context() as mp:
        small_tier(mp, jmesh)
        run_jax(dirs["jax"], argv)
    made, calls = run_torch(dirs["torch"], argv, spy=lambda mp: small_tier(mp, tmesh))
    (al,) = made
    assert al.branches["dp_overflow"] == 248, al.branches
    assert calls["align_tier1_sharded"] == 4
    same_file(dirs, "over.sam")


def test_paired_ishards2_on_eight_devices(dirs):
    run_jax(dirs["jax"], PAIRED)
    made, calls = run_torch(dirs["torch"], PAIRED)
    (al,) = made
    assert (al.mesh.shape["data"], al.mesh.shape["index"]) == (4, 2)
    assert calls["paired_candidates_sharded"] == 3  # 96 pairs at -b 32
    assert al.branches["device_intersect"] == 96, al.branches
    same_file(dirs, "pairs.sam")


def plant_duplicates(directory, seed: int = 5) -> np.ndarray:
    """Config 5's inputs as tools/demo_config5.py plants them: the pairs
    of r1.fq / r2.fq, then int(DUP_FRAC * pairs) of them again under the
    names dup0, dup1, ... (the same bases and qualities), in c5_1.fq /
    c5_2.fq. Returns the source pair of each duplicate."""
    ends = []
    for k in (1, 2):
        lines = (directory / f"r{k}.fq").read_bytes().split(b"\n")
        ends.append([lines[i:i + 4] for i in range(0, len(lines) - 3, 4)])
    n = len(ends[0])
    src = np.random.default_rng(seed).choice(n, size=int(n * DUP_FRAC), replace=False)
    for k in (0, 1):
        recs = ends[k] + [[b"@dup%d" % j, *ends[k][i][1:]] for j, i in enumerate(src)]
        (directory / f"c5_{k + 1}.fq").write_bytes(b"".join(b"\n".join(r) + b"\n" for r in recs))
    return src


def test_config5_sorted_dupmarked_bam_on_eight_devices(dirs):
    """Paired alignment over the data 4 x index 2 mesh to a sorted,
    duplicate-marked BAM and its .bai in one run: snap_tpu's bytes. Every
    mapped record of a planted duplicate carries 0x400, save where its
    source pair is itself a duplicate of another pair by chance (both
    mates at the same place and strand): there are none of those in this
    input. An unmapped end is never marked (SNAP marks mapped reads
    only); one planted pair has one, its source's junk first end."""
    from snap_tpu_torch.io.bam import read_bam

    src = plant_duplicates(dirs["jax"])
    assert np.array_equal(plant_duplicates(dirs["torch"]), src) and src.size == 7
    run_jax(dirs["jax"], CONFIG5)
    made, calls = run_torch(dirs["torch"], CONFIG5)
    (al,) = made
    assert isinstance(al, tpd.PairedEndAligner)
    assert (al.mesh.shape["data"], al.mesh.shape["index"]) == (4, 2)
    assert calls["paired_candidates_sharded"] == 4  # 103 pairs at -b 32
    for suffix in (".bam", ".bam.bai"):
        got = (dirs["torch"] / f"c5{suffix}").read_bytes()
        assert got == (dirs["jax"] / f"c5{suffix}").read_bytes(), suffix
    header, _, recs = read_bam(str(dirs["torch"] / "c5.bam"))
    assert "SO:coordinate" in header and len(recs) == 2 * 103
    # mapped records in coordinate order (tools/demo_config5.py's check)
    placed = [(r.ref_id, r.pos0) for r in recs if not r.flag & 0x4]
    assert placed == sorted(placed)
    where = {}
    for r in recs:
        where.setdefault(r.qname.split(b"_")[0], []).append(
            (r.flag & 0x40, r.ref_id, r.pos0, bool(r.flag & 0x10)))
    originals = {k: sorted(v) for k, v in where.items() if not k.startswith(b"dup")}
    chance = [i for i in src if sum(v == originals[b"p%d" % i] for v in originals.values()) > 1]
    assert not chance, chance
    unmapped = 0
    for j, i in enumerate(src):
        dup = [r for r in recs if r.qname == b"dup%d" % j]
        assert len(dup) == 2, (j, i)
        for r in dup:
            assert bool(r.flag & 0x400) != bool(r.flag & 0x4), (j, i, r.flag)
            unmapped += bool(r.flag & 0x4)
    assert unmapped == 1


def test_single_ishards2_on_one_device(dirs):
    """-ishards 2 on one device: a 1 x 1 mesh in both packages."""
    argv = SINGLE[:4] + ["one.sam"] + SINGLE[5:]
    run_jax(dirs["jax"], argv, n_dev=1)
    made, calls = run_torch(dirs["torch"], argv, n_dev=1)
    (al,) = made
    assert (al.mesh.shape["data"], al.mesh.shape["index"]) == (1, 1)
    assert al.batch_size == 62 and calls["align_winners_sharded"] == 4
    same_file(dirs, "one.sam")


def test_index_files_match(dirs):
    names = sorted(os.listdir(dirs["jax"] / "idx"))
    assert names == sorted(os.listdir(dirs["torch"] / "idx"))
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(dirs["torch"] / "idx" / n), np.load(dirs["jax"] / "idx" / n)
            )
