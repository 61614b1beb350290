"""Twins of tests/test_long_reads.py's CLI runs.

- The 1500 bp run (-rl 1500 -d 160 -i 200 -dp 0.15 -mrl 100) in both
  packages: the same SAM bytes, and the reads where the original test
  wants them. On the card its reads take all three kernels at
  L = 1500: the DP and affine rows past 512 columns a block a row.
- The snapxl-style 20 kb run, marked slow as the original is.

Both packages run as tests/test_torch_single.py runs them (see
tests/test_torch_long_reads.py).
"""

import numpy as np
import pytest
import torch

from test_torch_cli_cuda import DEC
from test_torch_long_reads import assert_same_sam, run_twins
from test_torch_pipeline import same_logq  # noqa: F401

torch.set_num_threads(1)


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


def test_long_read_cli_twin(same_logq, tmp_path_factory):
    """test_long_reads.py's 1500 bp run in both packages: a clean, a
    2%-SNP and a 30 bp-deletion read; the same SAM, each read at its
    locus, the deletion in its CIGAR."""
    read_len, starts = 1500, [5000, 20000, 40000]

    def write(d):
        reads = write_long_inputs(d, 60000, read_len, 7, starts, ["clean", "snp", "del30"])
        write_fq(d / "r.fq", reads, b"lr")

    ref, got, _ = run_twins(
        tmp_path_factory, "lr1500", write, ["index", "g.fa", "idx", "-s", "24"],
        ["single", "idx", "r.fq", "-o", "out.sam", "-b", "4", "-rl", str(read_len),
         "-d", "160", "-i", "200", "-dp", "0.15", "-mrl", "100"],
    )
    assert_same_sam(ref, got, 3)
    recs = parse_sam_bytes(got)
    for i, s in enumerate(starts):
        flag, pos, _ = recs[f"lr{i}"]
        assert not flag & 0x4 and abs(pos - (s + 1)) <= 2, (i, pos, s)
    assert "D" in recs["lr2"][2], recs["lr2"]


@pytest.mark.slow
def test_snapxl_20kb_twin(same_logq, tmp_path_factory):
    """test_long_reads.py's snapxl case (-rl 20000 -d 1000 -i 1100) in
    both packages: the same SAM, both reads at their loci."""
    read_len, starts = 20_000, [10_000, 60_000]

    def write(d):
        reads = write_long_inputs(d, 120_000, read_len, 11, starts, ["snp", "del200"])
        write_fq(d / "r.fq", reads, b"xl")

    ref, got, _ = run_twins(
        tmp_path_factory, "xl", write, ["index", "g.fa", "idx", "-s", "24"],
        ["single", "idx", "r.fq", "-o", "out.sam", "-b", "2", "-rl", str(read_len),
         "-d", "1000", "-i", "1100", "-dp", "0.15", "-mrl", "100"],
    )
    assert_same_sam(ref, got, 2)
    recs = parse_sam_bytes(got)
    for i, s in enumerate(starts):
        flag, pos, _ = recs[f"xl{i}"]
        assert not flag & 0x4 and abs(pos - (s + 1)) <= 2
    assert "D" in recs["xl1"][2]


def parse_sam_bytes(sam: bytes) -> dict:
    recs = {}
    for ln in sam.decode().splitlines():
        if ln.startswith("@"):
            continue
        t = ln.split("\t")
        recs[t[0]] = (int(t[1]), int(t[3]), t[5])
    return recs
