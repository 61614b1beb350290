"""Twins, in the port, of snap_tpu's host tests of the single-end path.

- tests/test_planned_emit.py: the planned native SAM emission is byte
  identical to the per-read Python emission, through the CLI and
  through a bare SamWriter.
- tests/test_wide_redo.py: a read whose seeds overflow the gather cap is
  realigned over the full hit lists to its true locus.
- tests/test_finalize_batch.py::test_emission_ag_restructure_3bp_deletion:
  a gapless dist-2 winner whose single 3-base gap scores better is
  emitted with the affine-gap CIGAR.
- the native FASTQ scanner against the pure-Python reader.

They run snap_tpu_torch alone, on the CPU (device="cpu").
"""

import io

import numpy as np
import pytest
import torch

from snap_tpu_torch.align.pipeline import AlignParams
from snap_tpu_torch.align.single import SingleEndAligner, ag_restructure_possible
from snap_tpu_torch.constants import PAD
from snap_tpu_torch.genome import Contig, Genome, load_fasta
from snap_tpu_torch.index.index import GenomeIndex
from snap_tpu_torch.io import native
from snap_tpu_torch.io.fastq import ReadBatch
from snap_tpu_torch.io.sam import SamWriter

torch.set_num_threads(1)

needs_formatter = pytest.mark.skipif(
    not native.has_sam_formatter(), reason="native SAM formatter absent"
)


def rc(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def planted_reads(rng, seq: str, n: int, span: int):
    """test_planned_emit's read mix: exact, reverse complement,
    substitutions, a 3-base deletion, a 2-base insertion, junk."""
    reads = []
    for i in range(n):
        p = int(rng.integers(0, span))
        r = seq[p : p + 100]
        kind = i % 6
        if kind == 1:
            r = rc(r)
        elif kind == 2:
            rl = list(r)
            for _ in range(3):
                rl[int(rng.integers(0, 100))] = "ACGT"[int(rng.integers(0, 4))]
            r = "".join(rl)
        elif kind == 3:  # deletion: a non-gapless CIGAR (a per-read row)
            r = seq[p : p + 50] + seq[p + 53 : p + 103]
        elif kind == 4:  # insertion
            r = seq[p : p + 50] + "AC" + seq[p + 50 : p + 98]
        elif kind == 5 and i % 12 == 5:  # junk: unmapped (a per-read row)
            r = "".join("ACGT"[c] for c in rng.integers(0, 4, size=100))
        reads.append((f"rd{i} comment", r))
    return reads


def write_fastq(path, reads):
    path.write_text("".join(f"@{n}\n{r}\n+\n{'I' * len(r)}\n" for n, r in reads))


@needs_formatter
@pytest.mark.parametrize("through", ["cli", "bare_samwriter"])
def test_planned_vs_per_read_byte_parity(tmp_path, monkeypatch, through):
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=12000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">c1\n{seq[:6000]}\n>c2\n{seq[6000:]}\n")
    fq = tmp_path / "r.fq"
    write_fastq(fq, planted_reads(rng, seq, 96, 11800))

    if through == "cli":
        from snap_tpu_torch.cli import main

        idx = tmp_path / "idx"
        assert main(["index", str(fa), str(idx), "-s", "20"], device="cpu") == 0

        def run(allow_plan):
            out = tmp_path / f"{allow_plan}.sam"
            if not allow_plan:
                monkeypatch.setattr(SingleEndAligner, "_plan_ok", lambda self, w: False)
            used = native.USED["sam_formatter"]
            assert main(["single", str(idx), str(fq), "-o", str(out), "-b", "32"],
                        device="cpu") == 0
            assert (native.USED["sam_formatter"] > used) == allow_plan
            # @PG embeds the output path in CL
            return [ln for ln in out.read_bytes().split(b"\n") if not ln.startswith(b"@PG")]
    else:
        genome = load_fasta(str(fa))
        index = GenomeIndex.build(genome, 20, device="cpu")
        params = AlignParams(seed_len=20, max_probe=index.max_probe)

        def run(allow_plan):
            aligner = SingleEndAligner(index, params, batch_size=32, max_read_len=128)
            if not allow_plan:
                aligner._plan_ok = lambda w: False
            sink = io.BytesIO()
            aligner.align_file(str(fq), SamWriter(out=sink, genome=genome, command_line="t"))
            return sink.getvalue()

    assert run(True) == run(False)


def repeat30_index():
    """tests/test_wide_redo.py's genome: a 300 bp unit in 30 copies (17..300
    hits per seed: above the gather cap, below the popular skip), each
    copy marked inside its first 100 bp."""
    rng = np.random.default_rng(23)
    rep = rng.integers(0, 4, size=300).astype(np.uint8)
    parts = [rng.integers(0, 4, size=2000).astype(np.uint8)]
    for i in range(30):
        c = rep.copy()
        for d, p in enumerate([40, 55, 70]):
            c[p] = (i >> (2 * d)) & 3
        parts.append(c)
    parts.append(rng.integers(0, 4, size=2000).astype(np.uint8))
    codes = np.concatenate(parts)
    bases = np.full(codes.size + 2000, PAD, dtype=np.uint8)
    bases[1000 : 1000 + codes.size] = codes
    genome = Genome(bases=bases, contigs=[Contig(name="chr1", start=1000, length=codes.size)])
    return GenomeIndex.build(genome, seed_len=24, device="cpu"), codes


@pytest.mark.parametrize("path", ["defaults", "wide_redo"])
def test_truncated_read_realigned_to_true_locus(path):
    """With the defaults the adaptive phase B (hit cap 64) covers the 30
    copies on the device; with a hit cap of 8 and no phase B the read
    is flagged truncated and the host's wide redo finds copy 0."""
    idx, codes = repeat30_index()
    L, ML = 100, 128
    true_start = 2000 + 10  # inside copy 0, the lowest location
    bases = np.full((1, ML), 4, np.uint8)
    bases[0, :L] = codes[true_start : true_start + L]
    quals = np.zeros((1, ML), np.uint8)
    quals[0, :L] = ord("I")
    batch = ReadBatch(ids=[b"r0"], bases=bases, quals=quals,
                      lengths=np.full(1, L, np.int32))
    wide = path == "wide_redo"
    params = AlignParams(seed_len=24, max_probe=idx.max_probe,
                         **({"hit_cap": 8} if wide else {}))
    aligner = SingleEndAligner(idx, params, batch_size=8, max_read_len=ML,
                               adaptive=not wide)
    res = aligner.align_batch(batch)[0]
    assert aligner.branches["redo_truncated"] == int(wide)
    assert res["status"] in ("single", "multi")
    assert abs(int(res["start_loc"]) - (1000 + true_start)) <= 2, res
    assert res["nm"] == 0


def test_emission_ag_restructure_3bp_deletion(tmp_path):
    """A read with a 3-base deletion whose tail nearly matches unshifted
    (2 mismatches): the single 3D gap (6 + 3 = 9) beats two substitutions
    (2 * 5 = 10), so the record is 96M3D4M NM:3, not 100M NM:2."""
    rng = np.random.default_rng(89)
    g, s = 30000, 12000
    codes = rng.integers(0, 4, size=g).astype(np.uint8)
    codes[s + 96] = codes[s + 99]
    codes[s + 97] = codes[s + 100]
    codes[s + 98] = (codes[s + 101] + 1) % 4
    read = np.concatenate([codes[s : s + 96], codes[s + 99 : s + 103]])
    if codes[s + 99] == read[99]:
        codes[s + 99] = (read[99] + 1) % 4
        read = np.concatenate([codes[s : s + 96], codes[s + 99 : s + 103]])
    bases = np.full(g + 4000, PAD, dtype=np.uint8)
    bases[2000 : 2000 + g] = codes
    genome = Genome(bases=bases, contigs=[Contig(name="c1", start=2000, length=g)])

    flagged = ag_restructure_possible(
        bases, read[None, :], [0], [0], [2000 + s], [100], [0], [2],
    )
    assert bool(flagged[0])

    index = GenomeIndex.build(genome, 20, device="cpu")
    params = AlignParams(seed_len=20, max_probe=index.max_probe)
    aligner = SingleEndAligner(index, params, batch_size=4, max_read_len=100)
    DEC = np.frombuffer(b"ACGT", np.uint8)
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@d3\n" + DEC[read].tobytes() + b"\n+\n" + b"I" * 100 + b"\n")
    out = tmp_path / "out.sam"
    with open(out, "wb") as f:
        aligner.align_file(str(fq), SamWriter(out=f, genome=genome, command_line="t"))
    body = [ln for ln in out.read_text().splitlines() if not ln.startswith("@")]
    assert len(body) == 1
    t = body[0].split("\t")
    assert t[3] == str(s + 1) and t[5] == "96M3D4M", t[:6]
    assert "NM:i:3" in t


@pytest.mark.skipif(not native.available(), reason="native library unavailable")
@pytest.mark.parametrize("batch_size, max_len", [(7, 128), (64, 60)])
def test_native_fastq_scanner_matches_python_reader(tmp_path, batch_size, max_len):
    from snap_tpu_torch.io.fastq import _native_read_batches, _to_batch, iter_fastq_records

    rng = np.random.default_rng(5)
    recs = []
    for i in range(50):
        n = int(rng.integers(1, 150))
        seq = bytes(rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), n))
        qual = bytes(rng.integers(33, 74, n).astype(np.uint8))
        eol = b"\r\n" if i % 7 == 3 else b"\n"
        name = b"r%d comment %d" % (i, i) if i % 3 else b"r%d" % i
        recs.append(b"@" + name + eol + seq + eol + b"+" + eol + qual + eol)
    path = tmp_path / "x.fq"
    path.write_bytes(b"".join(recs))

    got = list(_native_read_batches(str(path), batch_size, max_len))
    records = list(iter_fastq_records(str(path)))
    want = [_to_batch(records[i : i + batch_size], max_len)
            for i in range(0, len(records), batch_size)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ids == w.ids
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.bases, w.bases)
        np.testing.assert_array_equal(g.quals, w.quals)


def test_cli_refuses_missing_cuda(tmp_path):
    """main() runs on the card unless told device="cpu": without CUDA it
    raises before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from snap_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["index", str(tmp_path / "g.fa"), str(tmp_path / "idx")])
    assert not (tmp_path / "idx").exists()


def test_cli_multi_run_and_trace(tmp_path):
    """`index ... , single ... -trace DIR` in one call (the comma multi-run
    keeps the index loaded): the SAM has a record per read, and -trace
    writes a torch.profiler Chrome trace."""
    from snap_tpu_torch.cli import main

    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=8000))
    (tmp_path / "g.fa").write_text(f">c1\n{seq}\n")
    write_fastq(tmp_path / "r.fq", planted_reads(rng, seq, 12, 7800))
    d = str(tmp_path)
    argv = ["index", f"{d}/g.fa", f"{d}/idx", "-s", "20", ",",
            "single", f"{d}/idx", f"{d}/r.fq", "-o", f"{d}/out.sam", "-b", "16",
            "-trace", f"{d}/trace"]
    assert main(argv, device="cpu") == 0
    body = [ln for ln in (tmp_path / "out.sam").read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 12
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
