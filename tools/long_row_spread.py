#!/usr/bin/env python3
"""Rows per launch and plen/tlen spread of the DP and affine calls of a
1500 bp `single` run, on the CPU: the count that sizes the long-row
kernels' parallelism (one block a row).

    python3 tools/long_row_spread.py --workdir /tmp/spread

Writes a 25%-repeat genome (chip_smoke's model) and 1500 bp reads
(chip_smoke's error model), indexes it with the port's `index`, runs
`single` with chip_smoke's 1500 bp options at -b 64 on the CPU (the
plain recurrences), and prints one JSON line per DP or affine call of
the first batch: rows, widths, plen (and tlen) quantiles and the rows
past 512 pattern columns. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--genome-len", type=int, default=3_000_000)
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import chip_smoke as cs
    from snap_tpu_torch.align.single import SingleEndAligner as cls
    from snap_tpu_torch.cli import main as cli_main

    os.makedirs(args.workdir, exist_ok=True)
    fa, idx, fq = (os.path.join(args.workdir, n) for n in ("g.fa", "idx", "r.fq"))
    codes = cs.gen_repeat_genome(np.random.default_rng(args.seed), args.genome_len, 0.25)
    cs.write_fasta(fa, "chr", codes)
    assert cli_main(["index", fa, idx, "-s", "24"], device="cpu") == 0
    reads, quals, _, _ = cs.simulate_reads(np.random.default_rng(args.seed + 3), codes, 0,
                                           args.reads, cs.XL_LEN)
    cs.write_fastq(fq, reads, quals)

    calls = {n: [] for n in cs.KERNEL_SOURCES}
    with cs.recording(calls, inside={(cls, "_submit"): 1, (cls, "_finalize"): 1}):
        assert cli_main(["single", idx, fq, "-o", os.path.join(args.workdir, "out.sam"),
                         *cs.XL_OPTS, "-b", "64"], device="cpu") == 0
    for name, rows in cs.launch_spread(calls).items():
        for r in rows:
            print(json.dumps({"kernel": name, **r}), flush=True)


if __name__ == "__main__":
    main()
