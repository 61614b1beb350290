"""Phase-2a big-indel score raises in the port's paired path: the
planted harness of tests/test_big_indel.py (40 pairs on a 120 kbp
genome, 25-35 bp deletions or insertions planted in read 1 of half of
them) through `paired` in both packages, SAM equal byte for byte.

test_big_indel.py holds snap_tpu to the SNAP binary; here both sides
are this repository's, so no binary is needed. The port must also save
the planted ends as snap_tpu does: most come out mapped with an indel
CIGAR. `paired -t 2` runs as snap_tpu runs it (the option is parsed and
ignored).
"""

import numpy as np
import torch

from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import run_jax, run_torch

torch.set_num_threads(1)

BASES = "ACGT"
RC = str.maketrans("ACGT", "TGCA")


def write_planted(d) -> list[str]:
    """test_big_indel.py's genome and pairs in `d`; returns the names of
    the pairs with a planted indel."""
    rng = np.random.default_rng(17)
    G, L = 120_000, 100
    seq = "".join(BASES[i] for i in rng.integers(0, 4, G))
    with open(d / "g.fa", "w") as f:
        f.write(">chr1\n")
        for i in range(0, G, 80):
            f.write(seq[i : i + 80] + "\n")
    planted = []
    with open(d / "r1.fq", "w") as r1, open(d / "r2.fq", "w") as r2:
        for i in range(40):
            st = int(rng.integers(1000, G - 2000))
            ins = int(rng.integers(260, 500))
            a = seq[st : st + L]
            b = seq[st + ins - L : st + ins].translate(RC)[::-1]
            kind = i % 4
            indel = int(rng.integers(25, 36))
            p = int(rng.integers(30, 60))
            if kind == 0:
                a = seq[st : st + p] + seq[st + p + indel : st + p + indel + (L - p)]
                planted.append(f"p{i:04d}")
            elif kind == 1:
                insert = "".join(BASES[j] for j in rng.integers(0, 4, indel))
                a = (seq[st : st + p] + insert + seq[st + p :])[:L]
                planted.append(f"p{i:04d}")
            r1.write(f"@p{i:04d}/1\n{a}\n+\n{'I' * len(a)}\n")
            r2.write(f"@p{i:04d}/2\n{b}\n+\n{'I' * len(b)}\n")
    return planted


def test_paired_big_indel_matches(same_logq, tmp_path_factory):
    dirs = {}
    for side, run in (("jax", run_jax), ("torch", run_torch)):
        d = tmp_path_factory.mktemp(f"bigindel_{side}")
        planted = write_planted(d)
        run(d, ["index", "g.fa", "idx", "-s", "20"])
        # -t 2: accepted and ignored by `paired`, in both packages
        run(d, ["paired", "idx", "r1.fq", "r2.fq", "-o", "out.sam", "-t", "2"])
        dirs[side] = d
    ref = (dirs["jax"] / "out.sam").read_bytes()
    got = (dirs["torch"] / "out.sam").read_bytes()
    if got != ref:
        diff = [(a, b) for a, b in zip(ref.split(b"\n"), got.split(b"\n")) if a != b]
        raise AssertionError(f"{len(diff)} SAM lines differ, first: {diff[:2]}")
    first = {}
    for ln in got.decode().splitlines():
        f = ln.split("\t")
        if ln.startswith("@") or int(f[1]) & 0x900 or not int(f[1]) & 0x40:
            continue
        first[f[0]] = (int(f[1]), f[5])
    assert len(first) == 40
    saved = [q for q in planted
             if not first[q][0] & 0x4 and ("D" in first[q][1] or "I" in first[q][1])]
    assert len(saved) >= len(planted) // 2, (saved, planted)
