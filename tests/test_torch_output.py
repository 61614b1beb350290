"""The port's output stack against snap_tpu's: twins of
tests/test_output.py, test_sort_spill.py and test_bufferedasync.py, and
the CLI's sorted, duplicate-marked BAM with its .bai.

Every writer case runs the same records through both packages'
OutputWriter (BGZF, BAM encoding, sort, duplicate marking, the -sm
spill) and holds the bytes equal, besides the original test's own
assertions. The CLI cases run `single -so` to a .bam in both packages,
in memory and through the spill (-sm 0), on reads of which a third
are duplicates of others: the .bam and .bai bytes are equal, the
records sorted, the duplicates flagged, and the spill gives the same
records as the in-memory sort.
"""

import io
import threading

import numpy as np
import pytest
import torch

from snap_tpu.genome import Contig as JContig, Genome as JGenome
from snap_tpu.io.output import OutputWriter as JWriter
from snap_tpu_torch.constants import PAD
from snap_tpu_torch.genome import Contig, Genome
from snap_tpu_torch.io.bam import read_bam, reg2bin
from snap_tpu_torch.io.bgzf import BgzfWriter, decompress_all
from snap_tpu_torch.io.bufferedasync import BufferedAsyncReader, BufferedAsyncWriter
from snap_tpu_torch.io.output import OutputWriter, OutRecord, unclipped_5prime
from test_torch_cli_cuda import simulate_reads, write_inputs
from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)


def genomes(contigs, size, fill=PAD):
    """The same genome as the port's and snap_tpu's Genome."""
    bases = np.full(size, fill, dtype=np.uint8)
    return (Genome(bases=bases, contigs=[Contig(**c) for c in contigs]),
            JGenome(bases=bases, contigs=[JContig(**c) for c in contigs]))


SMALL = [dict(name="c1", start=100, length=1000, original_index=0),
         dict(name="c2", start=1200, length=1000, original_index=1)]
SPILL = [dict(name="chr1", start=0, length=2000, original_index=0),
         dict(name="chr2", start=2500, length=2000, original_index=1)]


def both_bytes(records, contigs, size, fill=PAD, **kw):
    """Each package's OutputWriter over `records`: (port bytes,
    snap_tpu bytes)."""
    outs = []
    for cls, g in zip((OutputWriter, JWriter), genomes(contigs, size, fill)):
        buf = io.BytesIO()
        w = cls(buf, g, **kw)
        for r in records:
            w.write_record(*r)
        w.close()
        outs.append(buf.getvalue())
    return outs


def bam_records(data: bytes, tmp_path, name="x.bam"):
    p = tmp_path / name
    p.write_bytes(data)
    return read_bam(str(p))


def test_bgzf_roundtrip_and_eof():
    from snap_tpu.io.bgzf import BgzfWriter as JBgzf

    data = bytes(range(256)) * 1000
    outs = []
    for cls in (BgzfWriter, JBgzf):
        buf = io.BytesIO()
        w = cls(buf)
        w.write(data)
        w.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert decompress_all(outs[0]) == data
    buf = io.BytesIO()
    BgzfWriter(buf).close()
    assert buf.getvalue().endswith(
        bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000"))


def test_reg2bin():
    from snap_tpu.io.bam import reg2bin as jreg2bin

    assert reg2bin(0, 1) == 4681 and reg2bin(0, (1 << 14) + 1) == 585
    assert reg2bin(-1, 0) == 4680
    for beg, end in ((0, 1), (5, 1 << 14), (1 << 20, (1 << 20) + 150), (-1, 0), (123456, 223456)):
        assert reg2bin(beg, end) == jreg2bin(beg, end)


RECS = [
    (b"r1", 0, "c2", 50, 60, "10M", b"ACGTACGTAC", b"IIIIIIIIII", 0),
    (b"r2", 16, "c1", 200, 60, "8M2S", b"ACGTACGTAC", b"IIIIIIIIII", 1),
    (b"r3", 4, "*", 0, 0, "*", b"ACGTACGTAC", b"IIIIIIIIII", None),
    (b"r4", 0, "c1", 10, 60, "10M", b"ACGTACGTAC", b"IIIIIIIIII", 0),
]
DUPS = [
    (b"d0", 0, "c1", 100, 60, "10M", b"ACGTACGTAC", b"I" * 10, 0),
    (b"d1", 0, "c1", 100, 60, "10M", b"ACGTACGTAC", b"J" * 10, 0),
    (b"d2", 0, "c1", 100, 60, "10M", b"ACGTACGTAC", b"5" * 10, 0),
    (b"d3", 0, "c1", 102, 60, "2S8M", b"ACGTACGTAC", b"A" * 10, 0),
    (b"x", 0, "c1", 500, 60, "10M", b"ACGTACGTAC", b"I" * 10, 0),
]


@pytest.mark.parametrize("bam", [False, True])
def test_sort_matches(tmp_path, bam):
    """test_output.py's sort case, as SAM and as BAM: the same bytes."""
    port, ref = both_bytes(RECS, SMALL, 3000, bam=bam, sort=True, build_bai=False)
    assert port == ref
    if bam:
        _, refs, out = bam_records(port, tmp_path)
        assert refs == ["c1", "c2"]
        assert [r.qname for r in out] == [b"r4", b"r2", b"r1", b"r3"]
        assert out[0].pos0 == 9 and out[1].seq == b"GTACGTACGT"
        assert out[3].ref_id == -1 and out[3].pos0 == -1


@pytest.mark.parametrize("bam", [False, True])
def test_dup_marking_matches(tmp_path, bam):
    """test_output.py's duplicates: the best quality sum survives, the
    soft-clipped read with the same unclipped start is marked."""
    port, ref = both_bytes(DUPS, SMALL, 3000, bam=bam, sort=True, mark_duplicates=True,
                           build_bai=False)
    assert port == ref
    if bam:
        flags = {r.qname: r.flag for r in bam_records(port, tmp_path)[2]}
        assert not flags[b"d1"] & 0x400 and not flags[b"x"] & 0x400
        assert all(flags[q] & 0x400 for q in (b"d0", b"d2", b"d3"))


def test_unclipped_5prime_rc():
    rec = OutRecord(qname=b"r", flag=16, rname="c1", pos=100, mapq=60, cigar="2S8M3S",
                    rnext="*", pnext=0, tlen=0, seq=b"A" * 13, qual=b"I" * 13, nm=0)
    assert unclipped_5prime(rec) == 110


def test_streaming_unsorted_bam(tmp_path):
    """Unsorted BAM streams (nothing buffered), in write order, with
    snap_tpu's bytes."""
    from snap_tpu_torch.io.bam import open_bam_stream

    port, ref = both_bytes(RECS[:1] + RECS[3:], SMALL, 3000, bam=True, sort=False)
    assert port == ref
    g = genomes(SMALL, 3000)[0]
    w = OutputWriter(out=io.BytesIO(), genome=g, bam=True, sort=False)
    w.write_header()
    assert w._bw is not None
    w.write_record(*RECS[0])
    assert not w._records
    p = tmp_path / "u.bam"
    p.write_bytes(port)
    _, _, it = open_bam_stream(str(p))
    assert [r.qname for r in it] == [b"r1", b"r4"]


def test_paired_matcher_quick_drop_and_ku(tmp_path):
    """Paired SAM input: records without RNEXT/PNEXT are dropped unless
    -ku, as in snap_tpu."""
    from snap_tpu.io.readers import paired_batches as jpaired
    from snap_tpu_torch.io.readers import paired_batches

    sam = tmp_path / "in.sam"
    sam.write_text("\n".join([
        "@HD\tVN:1.6", "@SQ\tSN:c1\tLN:1000",
        "p1\t65\tc1\t10\t60\t5M\t=\t50\t45\tACGTA\tIIIII",
        "p1\t129\tc1\t50\t60\t5M\t=\t10\t-45\tTTGCA\tIIIII",
        "p2\t65\tc1\t99\t60\t5M\t*\t0\t0\tCCCCC\tIIIII",
        "p2\t129\tc1\t120\t60\t5M\t*\t0\t0\tGGGGG\tIIIII",
    ]) + "\n")
    for ku, want in ((False, [b"p1"]), (True, [b"p1", b"p2"])):
        got = [i for b0, _ in paired_batches(str(sam), None, batch_size=8, max_len=16,
                                             keep_unpaired=ku) for i in b0.ids]
        ref = [i for b0, _ in jpaired(str(sam), None, batch_size=8, max_len=16,
                                      keep_unpaired=ku) for i in b0.ids]
        assert sorted(got) == sorted(ref) == want


def test_sam_input_aux_passthrough(tmp_path):
    """Input SAM aux fields ride through to the output record ahead of
    the aligner's own tags (test_output.py's case, on the port)."""
    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.align.single import SingleEndAligner
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.io.sam import SamWriter

    rng = np.random.default_rng(11)
    g = 6000
    codes = rng.integers(0, 4, size=g).astype(np.uint8)
    seq = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    bases = np.full(g + 4000, PAD, dtype=np.uint8)
    bases[2000 : 2000 + g] = codes
    genome = Genome(bases=bases, contigs=[Contig(name="c1", start=2000, length=g)])
    index = GenomeIndex.build(genome, 20, device="cpu")
    read = seq[1000:1100]
    sam_in = tmp_path / "in.sam"
    sam_in.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:c1\tLN:6000\n"
        f"r1\t0\tc1\t1001\t60\t100M\t*\t0\t0\t{read}\t{'I' * 100}\t"
        "XA:Z:keepme\tBC:Z:ACGT\n"
    )
    aligner = SingleEndAligner(index, AlignParams(seed_len=20, max_probe=index.max_probe),
                               batch_size=4, max_read_len=100)
    out = tmp_path / "out.sam"
    with open(out, "wb") as f:
        aligner.align_file(str(sam_in), SamWriter(out=f, genome=genome, command_line="t"))
    body = [ln for ln in out.read_text().splitlines() if not ln.startswith("@")]
    assert len(body) == 1
    fields = body[0].split("\t")
    assert fields[3] == "1001" and fields[11] == "XA:Z:keepme" and fields[12] == "BC:Z:ACGT"
    assert any(f.startswith("PG:Z:") for f in fields[13:])


def _spill_records(n=500, seed=42):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        contig = "chr1" if rng.random() < 0.5 else "chr2"
        pos = int(rng.integers(1, 1900))
        if i % 7 == 0:
            pos, contig = 100, "chr1"
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=20)).encode()
        qual = bytes(int(q) for q in rng.integers(40, 70, size=20))
        out.append((b"r%d" % i, 0, contig, pos, 60, "20M", seq, qual, 0))
    return out


@pytest.mark.parametrize("mark_dups", [False, True])
def test_spill_matches_in_memory(mark_dups):
    """test_sort_spill.py: the -sm spill gives the in-memory sort's
    bytes, in both packages, duplicates marked across blocks."""
    recs = _spill_records()
    mem = both_bytes(recs, SPILL, 5000, fill=0, sort=True, mark_duplicates=mark_dups)
    spill = both_bytes(recs, SPILL, 5000, fill=0, sort=True, mark_duplicates=mark_dups,
                       sort_memory_mb=0)
    assert mem[0] == mem[1] == spill[0] == spill[1]
    lines = [ln for ln in mem[0].decode().splitlines() if not ln.startswith("@")]
    assert len(lines) == 500
    if mark_dups:
        assert sum(1 for ln in lines if int(ln.split("\t")[1]) & 0x400) >= 60


def test_spill_bam_with_index(tmp_path):
    """The spilled, duplicate-marked BAM and its .bai: snap_tpu's bytes."""
    recs = _spill_records(200, seed=7)
    outs = {}
    for side, cls, g in zip(("torch", "jax"), (OutputWriter, JWriter),
                            genomes(SPILL, 5000, fill=0)):
        path = tmp_path / f"{side}.bam"
        with open(path, "wb") as fh:
            w = cls(out=fh, genome=g, bam=True, sort=True, mark_duplicates=True,
                    build_bai=True, bai_path=str(path) + ".bai", sort_memory_mb=0)
            for r in recs:
                w.write_record(*r)
            assert len(w._spill_files) > 1
            w.close()
        outs[side] = (path.read_bytes(), (tmp_path / f"{side}.bam.bai").read_bytes())
    assert outs["torch"] == outs["jax"]
    _, _, records = read_bam(str(tmp_path / "torch.bam"))
    poss = [(r.ref_id, r.pos0) for r in records]
    assert len(records) == 200 and poss == sorted(poss)


def test_writer_roundtrip_and_flush(tmp_path):
    p = tmp_path / "o.bin"
    payload = bytes(range(256)) * 5000
    with open(p, "wb") as raw:
        w = BufferedAsyncWriter(raw, buffer_size=4096, depth=3)
        mv = memoryview(payload)
        for i in range(0, len(payload), 1000):
            w.write(mv[i : i + 1000])
        w.close()
    assert p.read_bytes() == payload
    f = tmp_path / "f.bin"
    raw = open(f, "wb")
    w = BufferedAsyncWriter(raw, buffer_size=1 << 20)
    w.write(b"abc")
    w.flush()
    assert f.read_bytes() == b"abc"
    w.write(b"def")
    w.close()
    raw.close()
    assert f.read_bytes() == b"abcdef"


def test_writer_propagates_errors():
    class Boom(io.RawIOBase):
        def write(self, b):
            raise OSError("disk full")

    w = BufferedAsyncWriter(Boom(), buffer_size=1)
    with pytest.raises(OSError, match="disk full"):
        for _ in range(100):
            w.write(b"x")
        w.close()


def test_writer_backpressure_bounded():
    """At most `depth` buffers in flight."""
    gate = threading.Event()
    seen = []

    class Slow(io.RawIOBase):
        def write(self, b):
            gate.wait(5)
            seen.append(len(b))

    w = BufferedAsyncWriter(Slow(), buffer_size=10, depth=2)
    t = threading.Thread(target=lambda: [w.write(b"0123456789") for _ in range(5)])
    t.start()
    t.join(0.5)
    assert t.is_alive()
    gate.set()
    t.join(5)
    assert not t.is_alive()
    w.close()
    assert sum(seen) == 50


def test_reader_chunks_and_read(tmp_path):
    p = tmp_path / "r.bin"
    data = b"0123456789abcdef" * 1000
    p.write_bytes(data)
    with open(p, "rb") as f:
        r = BufferedAsyncReader(f, chunk_size=100, depth=4)
        assert r.read(5) == b"01234" and r.read(11) == b"56789abcdef"
        assert b"0123456789abcdef" + r.read() == data
    with open(p, "rb") as f:
        assert b"".join(BufferedAsyncReader(f, chunk_size=333).chunks()) == data


N_READS = 96
SORTED_RUNS = {"mem": ["-so"], "spill": ["-so", "-sm", "0"]}


def write_dup_reads(d):
    """test_torch_single.py's genome and 64 of its reads, then 32
    duplicates of them (same bases, other names and qualities)."""
    write_inputs(str(d), "repeat25", 0)
    from test_torch_cli_cuda import genome_codes

    reads = simulate_reads(genome_codes("repeat25"), 64)
    rng = np.random.default_rng(5)
    for j, i in enumerate(rng.choice(64, 32, replace=False)):
        name, seq, _ = reads[int(i)]
        q = rng.choice(np.frombuffer(b"#+5?II", np.uint8), len(seq)).tobytes()
        reads.append((b"dup%d_%s" % (j, name), seq, q))
    with open(d / "r.fq", "wb") as f:
        for name, seq, qual in reads:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))


@pytest.fixture(scope="module")
def sorted_runs(same_logq, tmp_path_factory):
    dirs = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"sorted_{side}")
        write_dup_reads(d)
        run(d, ["index", "g.fa", "idx", "-s", "20"])
        for name, extra in SORTED_RUNS.items():
            run(d, ["single", "idx", "r.fq", "-o", f"{name}.bam", "-b", "96", *extra])
        dirs[side] = d
    return dirs


@pytest.mark.parametrize("name", sorted(SORTED_RUNS))
def test_cli_sorted_bam_matches(sorted_runs, name):
    """`single -so` to a .bam (and through the spill): the .bam and .bai
    bytes of snap_tpu, records sorted, duplicates flagged."""
    jd, td = sorted_runs["jax"], sorted_runs["torch"]
    for suffix in (".bam", ".bam.bai"):
        got, ref = (td / f"{name}{suffix}").read_bytes(), (jd / f"{name}{suffix}").read_bytes()
        assert got == ref, suffix
    _, refs, recs = read_bam(str(td / f"{name}.bam"))
    assert len(recs) == N_READS
    placed = [(r.ref_id, r.pos0) for r in recs if r.ref_id >= 0]
    assert placed == sorted(placed) and all(r.ref_id == -1 for r in recs[len(placed):])
    assert sum(1 for r in recs if r.flag & 0x400) >= 16


def test_cli_spill_gives_in_memory_records(sorted_runs):
    td = sorted_runs["torch"]
    mem = read_bam(str(td / "mem.bam"))[2]
    spill = read_bam(str(td / "spill.bam"))[2]
    assert [vars(r) for r in mem] == [vars(r) for r in spill]


def test_cli_stdout_identical_to_file(same_logq, tmp_path, monkeypatch):
    """test_bufferedasync.py's CLI case: the async-buffered file output
    and -o - (stdout) give the same records."""
    import sys

    from snap_tpu_torch.cli import main

    (tmp_path / "g.fa").write_text(">c1\n" + "ACGTTGCAAGGCTTAGCCGATT" * 40 + "\n")
    seq = "ACGTTGCAAGGCTTAGCCGATT" * 4
    (tmp_path / "r.fq").write_text(f"@q1\n{seq}\n+\n{'I' * len(seq)}\n")
    monkeypatch.chdir(tmp_path)
    assert main(["index", "g.fa", "idx", "-s", "16"], device="cpu") == 0
    assert main(["single", "idx", "r.fq", "-o", "o.sam"], device="cpu") == 0

    class Out:
        buffer = io.BytesIO()

    monkeypatch.setattr(sys, "stdout", Out)
    assert main(["single", "idx", "r.fq", "-o", "-"], device="cpu") == 0
    monkeypatch.undo()
    body = lambda b: [ln for ln in b.splitlines() if not ln.startswith(b"@PG")]
    assert body((tmp_path / "o.sam").read_bytes()) == body(Out.buffer.getvalue())
