"""250 bp reads through the port's CLI at -rl 256 on the CPU, judged by
the benchmark's plain reference (benchmark/snapbench/check.py, which
imports nothing of the port or of JAX), as the ecoli.single250 cell
judges a window on the card.

The genome is 150 kbp of the benchmark's family model (gen_family_genome:
two 5 kb rRNA-like copies at 0.3% divergence, three identical IS-like
copies); the reads follow the cell's traffic file
(benchmark/traffic/refstrain250.b16384.json) but with an indel in a
quarter of them, as the benchmark's CPU tests draw their tiny cells, so
that a few dozen reads hold gaps to judge. The device step's DP tiers
are held at 128 rows (phase A) and 256 (phase B) in place of their
floors of 512 and 2,048, which the CPU's plain DP pays in full whatever
a batch of 128 reads needs (~40 s); a batch that needed more would take
the two-phase path, as it does on the card.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from snap_tpu_torch import cli
from snap_tpu_torch.align import pipeline as TP

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from snapbench import check, genome, traffic  # noqa: E402

torch.set_num_threads(1)

N_READS = 128
FAMILIES = [{"name": "rrn", "length": 5000, "copies": 2, "divergence": 0.003},
            {"name": "IS", "length": 1200, "copies": 3, "divergence": 0.0}]


def _bench_json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def judged(tmp_path_factory):
    d = tmp_path_factory.mktemp("long_ref")
    tr = _bench_json("traffic", "refstrain250.b16384.json")
    tr["errors"] = dict(tr["errors"], indel_share=0.25)
    codes = genome.gen_family_genome(np.random.default_rng(1655), 150_000, FAMILIES)
    genome.write_fasta(str(d / "g.fa"), "tiny", codes)
    pool = traffic.draw_reads(np.random.default_rng(tr["pool_seed"]), codes, N_READS, tr)
    (d / "r.fq").write_bytes(traffic.fastq_bytes(b"r", 0, pool.bases, pool.quals))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.setattr(TP, "_dp_rows_a", lambda B, params: 128)
        mp.setattr(TP, "_dp_rows_b", lambda B, B2, params: 256)
        assert cli.main(["index", "g.fa", "idx", "-s", "24"], device="cpu") == 0
        argv = ["single", "idx", "r.fq", "-o", "out.sam", "-b", str(N_READS), *tr["options"]]
        assert cli.main(argv, device="cpu") == 0
    lines = [x for x in (d / "out.sam").read_bytes().split(b"\n") if x and x[:1] != b"@"]
    out = check.judge(codes, b"tiny", pool, b"r", dict(enumerate(lines)), N_READS,
                      N_READS, len(lines))
    return out, pool, tr


def test_the_reads_are_long_and_hold_gaps(judged):
    _, pool, tr = judged
    assert tr["read_len"] == 250 and tr["options"] == ["-rl", "256"]
    assert pool.bases.shape == (N_READS, 250)
    assert (pool.span != 250).sum() >= 10


def test_records_are_whole_and_consistent(judged):
    out, _, _ = judged
    assert out.missing_records == 0, out.notes
    assert out.inconsistent_records == 0, out.notes
    assert out.judged == N_READS


def test_placements_within_the_cells_limit(judged):
    out, _, _ = judged
    limit = _bench_json("limits", "ecoli.single250.json")["wrong_share"]
    assert out.wrong_share <= limit, out.notes
