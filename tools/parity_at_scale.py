"""snap_tpu_torch against snap_tpu at a larger scale than the Tier-1 twins,
on the CPU: both packages' `index`, `single` and `paired` commands on a
25%-repeat genome of a few Mbp (chip_smoke.py's genome and read models)
with thousands of reads at -b 1024, so that the DP tier's overflow redo
and the phase-C step fire. Prints one JSON line: the records that differ
between the two SAM files of each command (with the first few), and the
port's host branches and phase-C steps, so a run shows which paths it
exercised.

    python tools/parity_at_scale.py                  # 2 Mbp, 4096 reads, 2048 pairs
    python tools/parity_at_scale.py --genome-len 4000000 --reads 8192

snap_tpu runs on one JAX CPU device (no mesh) with the port's ln P(error)
table (tests/test_torch_pipeline.py's same_logq says why); with
--same-logq off the differing records also hold the float noise of
XLA's exp/log. Each package runs in a directory of its own with the same
relative argv, so the @PG line's CL: field is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def write_inputs(directory: str, args) -> None:
    from chip_smoke import (gen_repeat_genome, simulate_pairs, simulate_reads,
                            write_fasta, write_fastq)

    rng = np.random.default_rng(args.seed)
    codes = gen_repeat_genome(rng, args.genome_len, 0.25)
    write_fasta(os.path.join(directory, "g.fa"), "chrsim", codes)
    from snap_tpu_torch.constants import DEFAULT_CONTIG_PADDING

    reads, quals, _, starts = simulate_reads(rng, codes, DEFAULT_CONTIG_PADDING,
                                             args.reads, 100)
    names = [b"r%d_%d" % (i, s + 1) for i, s in enumerate(starts.tolist())]
    write_fastq(os.path.join(directory, "r.fq"), reads, quals, names)
    ends, pquals, pos = simulate_pairs(rng, codes, args.pairs, 100)
    pnames = [b"p%d_%d_%d" % (i, a, b) for i, (a, b) in enumerate(zip(*pos.tolist()))]
    for e in range(2):
        write_fastq(os.path.join(directory, f"r{e + 1}.fq"), ends[e], pquals[e], pnames)


def run_jax(directory: str, argvs: list, same_logq: bool) -> float:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import torch

    import snap_tpu.align.pipeline as JP
    import snap_tpu.cli as jcli
    from snap_tpu_torch.align.pipeline import device_logq

    if same_logq:
        table = device_logq(torch.arange(256, dtype=torch.uint8)).numpy()
        jax.clear_caches()
        JP.device_logq = lambda q: jnp.asarray(table)[q.astype(jnp.int32)]
    cwd = os.getcwd()
    os.chdir(directory)
    t0 = time.time()
    try:
        for argv in argvs:
            assert jcli.main(argv) == 0, argv
    finally:
        os.chdir(cwd)
    return time.time() - t0


def run_torch(directory: str, argvs: list) -> dict:
    import torch

    import snap_tpu_torch.cli as tcli
    from snap_tpu_torch.align import paired_driver, pipeline, single

    made = []
    for cls, meth in ((single.SingleEndAligner, "align_file"),
                      (paired_driver.PairedEndAligner, "align_files")):
        orig = getattr(cls, meth)

        def keep(self, *a, _orig=orig, **kw):
            made.append(self)
            return _orig(self, *a, **kw)

        setattr(cls, meth, keep)
    steps = Counter()
    step = pipeline.align_winners_device

    def counted(*a, **kw):
        steps["phase_c" if kw.get("phase_c") else "without_phase_c"] += 1
        return step(*a, **kw)

    pipeline.align_winners_device = counted
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    cwd = os.getcwd()
    os.chdir(directory)
    t0 = time.time()
    try:
        for argv in argvs:
            assert tcli.main(argv, device="cpu") == 0, argv
    finally:
        os.chdir(cwd)
    return {"seconds": time.time() - t0, "steps": dict(steps),
            "branches": [dict(a.branches) for a in made]}


def differing(a_path: str, b_path: str, show: int = 5) -> dict:
    a = open(a_path, "rb").read().split(b"\n")
    b = open(b_path, "rb").read().split(b"\n")
    rows = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    first = []
    for i in rows[:show]:
        fa, fb = a[i].split(b"\t"), b[i].split(b"\t")
        field = next((k for k, (x, y) in enumerate(zip(fa, fb)) if x != y), None)
        first.append({"line": i, "first_field": field,
                      "snap_tpu": a[i][:300].decode(), "port": b[i][:300].decode()})
    return {"lines": len(a), "lines_port": len(b), "records_differ": len(rows),
            "first": first}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-len", type=int, default=2_000_000)
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--pairs", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--same-logq", choices=("on", "off"), default="on")
    ap.add_argument("--workdir", help="keep the inputs and outputs here")
    args = ap.parse_args()

    work = args.workdir or tempfile.mkdtemp(prefix="parity_")
    dirs = {side: os.path.join(work, side) for side in ("snap_tpu", "port")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
        write_inputs(d, args)
    b = ["-b", str(args.batch)]
    argvs = [
        ["index", "g.fa", "idx", "-s", "24"],
        ["single", "idx", "r.fq", "-o", "single.sam", *b],
        ["paired", "idx", "r1.fq", "r2.fq", "-o", "paired.sam", *b],
    ]
    port = run_torch(dirs["port"], argvs)
    jax_s = run_jax(dirs["snap_tpu"], argvs, args.same_logq == "on")
    out = {
        "genome_len": args.genome_len, "reads": args.reads, "pairs": args.pairs,
        "batch": args.batch, "same_logq": args.same_logq, "workdir": work,
        "single": differing(*(os.path.join(dirs[s], "single.sam") for s in dirs)),
        "paired": differing(*(os.path.join(dirs[s], "paired.sam") for s in dirs)),
        "port": port, "snap_tpu_seconds": jax_s,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
