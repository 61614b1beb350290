"""The port's CLI on the card against the port's CLI on the CPU.

Also holds the test inputs of tests/test_torch_single.py (a genome of two
contigs written as FASTA, reads of every kind written as FASTQ) and of
tests/test_torch_long_reads_1500.py, here because this file imports no
JAX, and a pair simulator for the `paired` twin. The test is marked `cuda` and skips
where torch sees no CUDA device. On a machine with a card (and no JAX,
so without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py
"""

import os
import time

import numpy as np
import pytest
import torch

CONTIG = 30_000        # two contigs of this length
READ_LEN = 100
DEC = np.frombuffer(b"ACGTN", np.uint8)


def genome_codes(kind: str, seed: int = 7) -> np.ndarray:
    """2 * CONTIG base codes: uniform random, or 25% repeats (the model of
    bench.py's _gen_repeat_genome)."""
    rng = np.random.default_rng(seed)
    glen = 2 * CONTIG
    seq = rng.integers(0, 4, size=glen).astype(np.uint8)
    if kind == "random":
        return seq
    budget = glen // 4
    alu = rng.integers(0, 4, size=300).astype(np.uint8)
    for _ in range(budget // 2 // 300):
        p = int(rng.integers(0, glen - 300))
        u = alu.copy()
        d = rng.random(300) < 0.01
        u[d] = rng.integers(0, 4, int(d.sum()))
        seq[p : p + 300] = u
    line = rng.integers(0, 4, size=6000).astype(np.uint8)
    for _ in range(max(1, budget // 2 // 6000)):
        p = int(rng.integers(0, glen - 6000))
        seq[p : p + 6000] = line
    for _ in range(max(1, glen // 20000)):
        unit = rng.integers(0, 4, size=4).astype(np.uint8)
        reps = int(rng.integers(20, 60))
        p = int(rng.integers(0, glen - 4 * reps))
        seq[p : p + 4 * reps] = np.tile(unit, reps)
    return seq


READ_KINDS = (
    "exact", "deletion", "insertion", "substitutions", "end_deletion",
    "junk", "with_n", "short", "exact", "across_contigs",
)


def simulate_reads(codes: np.ndarray, n: int, seed: int = 11):
    """n reads cycling through READ_KINDS (end_deletion: 2-3 bases
    deleted 4-6 from the end, where one gap may beat the mismatches
    a gapless alignment sees), every other one reverse complemented;
    qualities mix low ('#') and high bytes. Returns
    [(name, seq bytes, qual bytes)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = READ_KINDS[i % len(READ_KINDS)]
        s = int(rng.integers(0, codes.size - READ_LEN - 10))
        if kind == "across_contigs":
            s = CONTIG - int(rng.integers(20, 80))
        r = codes[s : s + READ_LEN + 8].copy()
        if kind == "deletion":
            p = int(rng.integers(20, READ_LEN - 20))
            r = np.delete(r, slice(p, p + int(rng.integers(1, 4))))
        elif kind == "end_deletion":  # a single gap may beat mismatches
            p = READ_LEN - int(rng.integers(4, 7))
            r = np.delete(r, slice(p, p + int(rng.integers(2, 4))))
        elif kind == "insertion":
            p = int(rng.integers(20, READ_LEN - 20))
            r = np.insert(r, p, rng.integers(0, 4, int(rng.integers(1, 4))))
        r = r[:READ_LEN]
        if kind == "substitutions":
            m = rng.random(READ_LEN) < 0.03
            r = np.where(m, rng.integers(0, 4, READ_LEN), r)
        elif kind == "junk":
            r = rng.integers(0, 4, READ_LEN)
        elif kind == "with_n":
            r = r.copy()
            r[rng.integers(0, READ_LEN, 3)] = 4
        elif kind == "short":
            r = r[:40]
        if i % 2:
            r = np.where(r < 4, 3 - r, r)[::-1]
        q = rng.choice(np.frombuffer(b"#+5?II", np.uint8), len(r))
        out.append((f"r{i}_{kind}_{s}".encode(), DEC[r].tobytes(), q.tobytes()))
    return out


def simulate_long_reads(codes, n, read_len, seed):
    """n reads of read_len bases from the two-contig genome: 1%
    substitutions, a 1-3 bp deletion or insertion in every third read,
    every other read reverse complemented. Names carry the start."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = int(rng.integers(0, codes.size - read_len - 10))
        r = codes[s : s + read_len + 8].copy()
        p = int(rng.integers(30, read_len - 30))
        if i % 3 == 1:
            r = np.delete(r, slice(p, p + int(rng.integers(1, 4))))
        elif i % 3 == 2:
            r = np.insert(r, p, rng.integers(0, 4, int(rng.integers(1, 4))))
        r = r[:read_len]
        m = rng.random(read_len) < 0.01
        r = np.where(m, rng.integers(0, 4, read_len), r)
        if i % 2:
            r = (3 - r)[::-1]
        q = rng.choice(np.frombuffer(b"#+5?II", np.uint8), read_len)
        out.append((b"l%d_%d" % (i, s), DEC[r].tobytes(), q.tobytes()))
    return out


def write_inputs(directory: str, kind: str, n_reads: int) -> None:
    """g.fa (contigs c1, c2) and r.fq in `directory`."""
    codes = genome_codes(kind)
    with open(os.path.join(directory, "g.fa"), "wb") as f:
        for ci in range(2):
            f.write(b">c%d\n" % (ci + 1))
            t = DEC[codes[ci * CONTIG : (ci + 1) * CONTIG]].tobytes()
            for i in range(0, len(t), 80):
                f.write(t[i : i + 80] + b"\n")
    with open(os.path.join(directory, "r.fq"), "wb") as f:
        for name, seq, qual in simulate_reads(codes, n_reads):
            f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, qual))


def write_pair_inputs(directory: str, kind: str, n_pairs: int, seed: int = 13) -> None:
    """g.fa (as write_inputs) and r1.fq / r2.fq: pairs of READ_LEN bases
    from inserts of 220-500 bp, the second end reverse complemented, 1%
    substitutions, every eighth first end replaced by junk."""
    codes = genome_codes(kind)
    write_inputs(directory, kind, 0)
    rng = np.random.default_rng(seed)
    ends = ([], [])
    for i in range(n_pairs):
        insert = int(rng.integers(220, 500))
        s = int(rng.integers(0, codes.size - insert))
        r1 = codes[s : s + READ_LEN].copy()
        r2 = codes[s + insert - READ_LEN : s + insert][::-1].copy()
        r2 = np.where(r2 < 4, 3 - r2, r2)
        if i % 8 == 7:
            r1 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
        for k, r in enumerate((r1, r2)):
            m = rng.random(READ_LEN) < 0.01
            r = np.where(m, rng.integers(0, 4, READ_LEN), r)
            q = rng.choice(np.frombuffer(b"#+5?II", np.uint8), READ_LEN)
            ends[k].append(b"@p%d_%d\n%s\n+\n%s\n" % (i, s + 1, DEC[r].tobytes(), q.tobytes()))
    for k in range(2):
        with open(os.path.join(directory, f"r{k + 1}.fq"), "wb") as f:
            f.write(b"".join(ends[k]))


def same_but_mapq(card: list[bytes], cpu: list[bytes]) -> None:
    """At most 2 lines differ, in MAPQ by at most 1 (the card's float
    sums may round differently)."""
    assert len(card) == len(cpu)
    diff = [(a, b) for a, b in zip(card, cpu) if a != b]
    assert len(diff) <= 2, diff
    for a, b in diff:
        fa, fb = a.split(b"\t"), b.split(b"\t")
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (a, b)
        assert abs(int(fa[4]) - int(fb[4])) <= 1, (a, b)


@pytest.mark.cuda
def test_cli_card_matches_cpu(tmp_path, monkeypatch):
    """index + single -b 64 on the card and on the CPU: SAM records that
    differ at most in MAPQ by 1 (the card's float sums may round
    differently) in at most 2 records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snap_tpu_torch.cli import main

    sams = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        write_inputs(str(d), "repeat25", 192)
        monkeypatch.chdir(d)
        assert main(["index", "g.fa", "idx", "-s", "20"], device=dev) == 0
        assert main(["single", "idx", "r.fq", "-o", "out.sam", "-b", "64"], device=dev) == 0
        sams[dev] = (d / "out.sam").read_bytes().split(b"\n")
    same_but_mapq(sams["cuda"], sams["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rl256", "om3"])
def test_single_options_card_matches_cpu(tmp_path, monkeypatch, case):
    """`single -rl 256` on 250 bp reads (the affine and DP kernels at
    the long-read shapes) and `single -om 3 -omax 2` (the non-fast
    path) on the card and on the CPU: the same SAM but for MAPQ +-1 in
    at most 2 records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snap_tpu_torch.cli import main

    sams = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        if case == "rl256":
            write_inputs(str(d), "repeat25", 0)
            reads = simulate_long_reads(genome_codes("repeat25"), 48, 250, 256)
            with open(d / "r.fq", "wb") as f:
                f.write(b"".join(b"@%s\n%s\n+\n%s\n" % r for r in reads))
            extra = ["-rl", "256"]
        else:
            write_inputs(str(d), "repeat25", 128)
            extra = ["-om", "3", "-omax", "2"]
        monkeypatch.chdir(d)
        assert main(["index", "g.fa", "idx", "-s", "20"], device=dev) == 0
        assert main(["single", "idx", "r.fq", "-o", "out.sam", "-b", "64", *extra],
                    device=dev) == 0
        sams[dev] = (d / "out.sam").read_bytes().split(b"\n")
    assert sum(1 for ln in sams["cpu"] if ln and not ln.startswith(b"@")) >= 48
    same_but_mapq(sams["cuda"], sams["cpu"])


@pytest.mark.cuda
def test_paired_card_matches_cpu(tmp_path, monkeypatch):
    """index + paired -b 64 on the card and on the CPU, 192 pairs on the
    25%-repeat genome: the same SAM but for MAPQ +-1 in at most 2
    records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snap_tpu_torch.cli import main

    sams = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        write_pair_inputs(str(d), "repeat25", 192)
        monkeypatch.chdir(d)
        assert main(["index", "g.fa", "idx", "-s", "20"], device=dev) == 0
        argv = ["paired", "idx", "r1.fq", "r2.fq", "-o", "out.sam", "-b", "64"]
        assert main(argv, device=dev) == 0
        sams[dev] = (d / "out.sam").read_bytes().split(b"\n")
    assert sum(1 for ln in sams["cpu"] if ln and not ln.startswith(b"@")) >= 2 * 192
    same_but_mapq(sams["cuda"], sams["cpu"])


def write_long_inputs(directory, glen, read_len, seed, starts, kinds, width=70):
    """g.fa (one random contig chr1), and one read per start, kind
    'clean', 'snp' (2% substitutions) or a deletion of k bases at the
    read's midpoint ('del<k>'): test_long_reads.py's inputs."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=glen).astype(np.uint8)
    seq = DEC[codes].tobytes()
    with open(directory / "g.fa", "wb") as f:
        f.write(b">chr1\n")
        for i in range(0, glen, width):
            f.write(seq[i : i + width] + b"\n")
    reads = []
    for s, kind in zip(starts, kinds):
        if kind == "snp":
            r = codes[s : s + read_len].copy()
            snp = rng.choice(read_len, size=read_len // 50, replace=False)
            r[snp] = (r[snp] + 1) % 4
        elif kind.startswith("del"):
            k, half = int(kind[3:]), read_len // 2
            r = np.concatenate([codes[s : s + half], codes[s + half + k : s + k + read_len]])
        else:
            r = codes[s : s + read_len]
        reads.append(r)
    return reads


def write_fq(path, reads, prefix):
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix, i, DEC[r].tobytes(), b"I" * len(r)))


def parse_sam_bytes(sam: bytes) -> dict:
    recs = {}
    for ln in sam.decode().splitlines():
        if ln.startswith("@"):
            continue
        t = ln.split("\t")
        recs[t[0]] = (int(t[1]), int(t[3]), t[5])
    return recs


@pytest.mark.cuda
def test_snapxl_card_matches_cpu(tmp_path, monkeypatch):
    """tests/test_torch_long_reads_1500.py's snapxl case (single -rl
    20000 -d 1000 -i 1100 -dp 0.15 -mrl 100, two 20 kb reads, -b 2) on
    the card and on the CPU: the DP and affine long-row kernels across
    their strips. The same SAM bytes; on both devices the two-phase merge
    finds each read's best candidate at its locus, 400 edits for the
    2%-SNP read and 200 (one 200-base deletion) for the other. Both
    records stay unmapped, on both devices, as in snap_tpu: its merge
    keeps distances up to MAX_K - 1 = 126 (two_phase_merge's mk_eff).
    Prints each device's wall time of the `single` command (`-rP`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snap_tpu_torch.align import pipeline
    from snap_tpu_torch.cli import main
    from snap_tpu_torch.constants import DEFAULT_CONTIG_PADDING

    read_len, starts = 20_000, [10_000, 60_000]
    merge = pipeline.two_phase_merge
    sams, best = {}, {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        reads = write_long_inputs(d, 120_000, read_len, 11, starts, ["snp", "del200"])
        write_fq(d / "r.fq", reads, b"xl")
        merged = []
        monkeypatch.setattr(pipeline, "two_phase_merge",
                            lambda *a, **kw: merged.append(merge(*a, **kw)) or merged[-1])
        monkeypatch.chdir(d)
        assert main(["index", "g.fa", "idx", "-s", "24"], device=dev) == 0
        t0 = time.perf_counter()
        assert main(["single", "idx", "r.fq", "-o", "out.sam", "-b", "2", "-rl",
                     str(read_len), "-d", "1000", "-i", "1100", "-dp", "0.15",
                     "-mrl", "100"], device=dev) == 0
        print(f"snapxl single on {dev}: {time.perf_counter() - t0:.2f} s wall")
        sams[dev] = (d / "out.sam").read_bytes()
        m = merged[0]
        k = np.argmin(m["dist"], axis=1)
        r = np.arange(2)
        best[dev] = [m[f][r, k].tolist() for f in ("cand_loc", "dist", "indels")]
    assert sams["cuda"] == sams["cpu"]
    assert best["cuda"] == best["cpu"]
    assert best["cuda"] == [[DEFAULT_CONTIG_PADDING + s for s in starts], [400, 200], [0, 200]]
    assert sorted(parse_sam_bytes(sams["cuda"])) == ["xl0", "xl1"]


@pytest.mark.cuda
def test_mesh_card_matches_cpu(tmp_path, monkeypatch):
    """The multi-device path on one card: `single` and `paired` with
    -ishards 2 over devices=[cuda:0, cuda:0] (a data = 1 x index = 2
    mesh: two index shards, the K axis merged across them) against the
    same mesh of two CPU devices, the same SAM but for MAPQ +-1 in at
    most 2 records; and align_winners_sharded on those meshes, whose
    packed winners are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from snap_tpu_torch.align.pipeline import AlignParams
    from snap_tpu_torch.cli import main
    from snap_tpu_torch.index.index import GenomeIndex
    from snap_tpu_torch.parallel import mesh

    sams, winners = {}, {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        write_pair_inputs(str(d), "repeat25", 128)  # writes an empty r.fq
        write_inputs(str(d), "repeat25", 192)
        monkeypatch.chdir(d)
        devices = [torch.device("cuda", 0) if dev == "cuda" else torch.device("cpu")] * 2
        assert main(["index", "g.fa", "idx", "-s", "20"], device=dev) == 0
        assert main(["single", "idx", "r.fq", "-o", "s.sam", "-b", "64", "-ishards", "2"],
                    device=dev, devices=devices) == 0
        assert main(["paired", "idx", "r1.fq", "r2.fq", "-o", "p.sam", "-b", "64",
                     "-ishards", "2"], device=dev, devices=devices) == 0
        sams[dev] = [(d / n).read_bytes().split(b"\n") for n in ("s.sam", "p.sam")]
        idx = GenomeIndex.load("idx", device=dev)
        m = mesh.make_mesh(1, 2, devices)
        idx.to_mesh(m, 2)
        codes = genome_codes("repeat25")
        rng = np.random.default_rng(3)
        starts = rng.integers(0, codes.size - 200, 256)
        b = np.full((256, 128), 4, np.uint8)
        b[:, :100] = codes[starts[:, None] + np.arange(100)]
        q = np.full((256, 128), 0, np.uint8)
        q[:, :100] = ord("I")
        win, _ = mesh.align_winners_sharded(
            idx.device_sharded, *(torch.from_numpy(x).to(devices[0]) for x in (
                b, q, np.full(256, 100, np.int32))),
            idx.genome_meta.first_alt_start(),
            AlignParams(seed_len=20, max_probe=idx.max_probe), m,
        )
        winners[dev] = win.cpu().numpy()
    for card, cpu in zip(sams["cuda"], sams["cpu"]):
        assert sum(1 for ln in cpu if ln and not ln.startswith(b"@")) >= 192
        same_but_mapq(card, cpu)
    np.testing.assert_array_equal(winners["cuda"], winners["cpu"])


@pytest.mark.cuda
def test_daemon_on_card(tmp_path, monkeypatch):
    """`daemon` on the card in a thread: `single` sent through `command`
    writes the SAM a direct run on the card writes (but for @PG, whose
    CL: holds the output path), and the index stays cached between
    commands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading

    from snap_tpu_torch import apps
    from snap_tpu_torch.cli import _INDEX_CACHE, main

    write_inputs(str(tmp_path), "repeat25", 128)
    monkeypatch.chdir(tmp_path)
    assert main(["index", "g.fa", "idx", "-s", "20"], device="cuda") == 0
    sock = str(tmp_path / "d.sock")
    srv = threading.Thread(target=apps.cmd_daemon, args=([sock], "cuda"), daemon=True)
    srv.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    assert apps.cmd_command([sock, "single", "idx", "r.fq", "-o", "d1.sam"]) == 0
    cached = dict(_INDEX_CACHE)
    assert all(i.torch_device.type == "cuda" for i in cached.values())
    assert apps.cmd_command([sock, "single", "idx", "r.fq", "-o", "d2.sam"]) == 0
    assert dict(_INDEX_CACHE) == cached
    assert apps.cmd_command([sock, "exit"]) == 0
    srv.join(timeout=30)
    assert not srv.is_alive()
    assert main(["single", "idx", "r.fq", "-o", "direct.sam"], device="cuda") == 0

    def body(n):
        return [ln for ln in (tmp_path / n).read_bytes().split(b"\n")
                if not ln.startswith(b"@PG")]

    assert body("d1.sam") == body("direct.sam") == body("d2.sam")
