"""The port's CLI on the card against the port's CLI on the CPU.

Also holds the test inputs of tests/test_torch_single.py (a genome of two
contigs written as FASTA, reads of every kind written as FASTQ), here
because this file imports no JAX, and a pair simulator for the `paired`
twin. The test is marked `cuda` and skips
where torch sees no CUDA device. On a machine with a card (and no JAX,
so without tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py
"""

import os

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
