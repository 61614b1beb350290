"""Align one benchmark cell's read pool with two checkouts of the port,
each through its own CLI in a process of its own on the card, and
compare the SAM files byte for byte.

  python3 tools/cmp_sam_torch.py --other <checkout> --workload chr21.single \
      --seed <n> --out <dir>

from the root of a checkout. The genome and index come from this
checkout's benchmark cache (`benchmark/.cache`, built on first use); the
reads are the cell's whole pool in the seed's order, as a window of
`benchmark/run.py` aligns them, written once to `<dir>/r.fq`. Each side
runs `single <index> r.fq -o out.sam -b <batch> <cell options>` in
`<dir>/<side>/`, so the @PG lines match. Prints each side's CLI seconds
(a side's first run on a fresh checkout includes its kernel build) and
exits 0 when the SAM files are identical, 1 when they differ, 2 without
a card or when a side fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = (
    "import sys, time\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from snap_tpu_torch import cli\n"
    "t = time.perf_counter()\n"
    "rc = cli.main(sys.argv[2:])\n"
    "print(f'cli seconds {time.perf_counter() - t:.3f}')\n"
    "sys.exit(rc)\n"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    sys.path.insert(1, ROOT)
    import torch

    from snapbench import genome, runner
    from snapbench.layout import CACHE_DIR, load_cell

    if not torch.cuda.is_available():
        print("no CUDA device: the comparison runs only on a card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    cfg, tr = cell.config, cell.traffic
    codes, fasta = genome.prepare_genome(cfg, CACHE_DIR)
    idx, _ = genome.prepare_index(cfg, fasta, torch.device("cuda", 0), CACHE_DIR)
    w = runner.draw_window(tr, codes, args.seed, 0.0)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    fastq = os.path.join(out, "r.fq")
    with open(fastq, "wb") as f:
        f.writelines(w.batches)
    cli_argv = ["single", idx, "r.fq", "-o", "out.sam", "-b", str(tr["batch"]),
                *tr["options"]]
    sams = []
    for side, root in (("other", os.path.abspath(args.other)), ("this", ROOT)):
        d = os.path.join(out, side)
        os.makedirs(d, exist_ok=True)
        if not os.path.lexists(os.path.join(d, "r.fq")):
            os.symlink(fastq, os.path.join(d, "r.fq"))
        r = subprocess.run([sys.executable, "-c", RUN, root, *cli_argv], cwd=d,
                           capture_output=True, text=True)
        said = r.stdout.strip().splitlines()[-1:] or [""]
        print(f"{side} ({root}): exit {r.returncode}, {said[0]}", flush=True)
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return 2
        sams.append(os.path.join(d, "out.sam"))
    r = subprocess.run(["cmp", *sams], capture_output=True, text=True)
    with open(sams[1], "rb") as f:
        lines = sum(1 for _ in f)
    print(f"cmp exit {r.returncode} {r.stdout.strip()}; {os.path.getsize(sams[1])} bytes, "
          f"{lines} lines", flush=True)
    return 0 if r.returncode == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
