"""snap_tpu_torch against snap_tpu at a larger scale than the Tier-1 twins,
on the CPU: both packages' `index`, `single` and `paired` commands on
chip_smoke.py's 25%-repeat genome and read models with thousands of
reads at -b 1024, so that the DP tier's overflow redo and the phase-C
step fire. Prints one JSON line: the records that differ between the two
SAM files of each command (with the first few), each side's placement
against the truth in the read names, and the port's host branches and
phase-C steps, so a run shows which paths it exercised.

    python tools/parity_at_scale.py                  # 2 Mbp, 4096 reads, 2048 pairs
    python tools/parity_at_scale.py --genome-len 4000000 --reads 8192
    python tools/parity_at_scale.py --layout hg38    # GRCh38 coordinates
    python tools/parity_at_scale.py --config ecoli.miseq250 \
        --traffic refstrain250.b16384 --reads 2048    # a benchmark cell's reads

--config and --traffic take a benchmark configuration's genome
(benchmark/configs/<name>.json, made by benchmark/snapbench's
synthesizer) and the first --reads reads of a traffic file's pool
(benchmark/traffic/<name>.json, drawn from its pool_seed as a benchmark
run draws them), and run `index` with the configuration's options and
`single` with the traffic's, and no `paired`.

--layout hg38 lays the reads out at GRCh38's coordinates (chip_smoke's
hg38 layout: the 25 contigs of the primary assembly at their lengths,
3,088,338,401 bases; sequence in four windows, one of them 2 Mbp centred
on location 2^31 and one the whole of chr21, N elsewhere), with reads
and pairs that straddle 2^31 among the others, and adds `single
-ishards 2` on two devices (a data 1 x index 2 mesh: two CPU positions
in the port, two XLA CPU devices in snap_tpu). --chr21-len shortens the
chr21 window. Each side runs in processes of its own, so the two
packages never hold the 3.1 GB genome at once; snap_tpu's host-side
genome packing (pack_genome_words, pack_bad16) runs 2^24 bases at a
time through snap_tpu's own functions, the words stitched together
(checked against whole-genome calls at the start of each run), since
its whole-genome uint32 temporaries would take ~28 GB.

snap_tpu runs with the port's ln P(error) table (tests/test_torch_
pipeline.py's same_logq says why); with --same-logq off the differing
records also hold the float noise of XLA's exp/log. Each package runs
in a directory of its own with the same relative argv, so the @PG
line's CL: field is the same.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

INPUTS = ("g.fa", "r.fq", "r1.fq", "r2.fq")
BENCH = os.path.join(REPO, "benchmark")


def bench_file(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def write_bench_inputs(directory: str, config: dict, tr: dict, n: int) -> None:
    """A benchmark configuration's genome and its traffic's first n reads."""
    sys.path.insert(1, BENCH)
    from snapbench import genome, traffic

    codes = genome.make_genome(config)
    genome.write_fasta(os.path.join(directory, "g.fa"), config["contig"], codes)
    pool = traffic.draw_reads(np.random.default_rng(tr["pool_seed"]), codes, n, tr)
    with open(os.path.join(directory, "r.fq"), "wb") as f:
        f.write(traffic.fastq_bytes(b"r", 0, pool.bases, pool.quals))


def write_inputs(directory: str, args) -> None:
    from chip_smoke import (gen_repeat_genome, hg38_pairs, hg38_reads, hg38_windows,
                            simulate_pairs, simulate_reads, write_fasta, write_fastq,
                            write_hg38_fasta, HG38_STRADDLE)

    if args.layout == "hg38":
        chr21 = gen_repeat_genome(np.random.default_rng(args.seed), args.chr21_len, 0.25)
        windows = hg38_windows(args.seed, chr21)
        write_hg38_fasta(os.path.join(directory, "g.fa"), windows)
        rng = np.random.default_rng(args.seed + 9)
        reads, quals, names = hg38_reads(rng, windows, args.reads - HG38_STRADDLE, 100)
        ends, pquals, pnames = hg38_pairs(rng, windows, args.pairs - HG38_STRADDLE, 100)
    else:
        rng = np.random.default_rng(args.seed)
        codes = gen_repeat_genome(rng, args.genome_len, 0.25)
        write_fasta(os.path.join(directory, "g.fa"), "chrsim", codes)
        from snap_tpu_torch.constants import DEFAULT_CONTIG_PADDING

        reads, quals, _, starts = simulate_reads(rng, codes, DEFAULT_CONTIG_PADDING,
                                                 args.reads, 100)
        names = [b"r%d_%d" % (i, s + 1) for i, s in enumerate(starts.tolist())]
        ends, pquals, pos = simulate_pairs(rng, codes, args.pairs, 100)
        pnames = [b"p%d_%d_%d" % (i, a, b) for i, (a, b) in enumerate(zip(*pos.tolist()))]
    write_fastq(os.path.join(directory, "r.fq"), reads, quals, names)
    for e in range(2):
        write_fastq(os.path.join(directory, f"r{e + 1}.fq"), ends[e], pquals[e], pnames)


JAX_PACK_CHUNK = 1 << 24  # bases a chunk of snap_tpu's packers (a multiple of 32)


def chunked_jax_packers(chunk: int = JAX_PACK_CHUNK):
    """snap_tpu's own pack_genome_words / pack_bad16, called on `chunk`
    bases at a time and their words stitched together (a chunk of 32 k
    bases fills 2 k whole packed words and k whole bad words), after
    checking the stitched words against the whole-genome calls on a small
    genome cut into many chunks."""
    import snap_tpu.index.index as JI

    whole_words, whole_bad16 = JI.pack_genome_words, JI.pack_bad16

    def pack_genome_words(bases, chunk=chunk):
        g = np.asarray(bases)
        G = g.shape[0]
        n16, n32 = (G + 15) // 16, (G + 31) // 32
        packed = np.zeros(n16 + 8 + (-(n16 + 8)) % 8, dtype=np.uint32)
        bad = np.zeros(n32 + 8 + (-(n32 + 8)) % 8, dtype=np.uint32)
        for lo in range(0, G, chunk):
            c = g[lo : lo + chunk]
            p, b = whole_words(c)
            k16, k32 = (c.shape[0] + 15) // 16, (c.shape[0] + 31) // 32
            packed[lo // 16 : lo // 16 + k16] = p[:k16]
            bad[lo // 32 : lo // 32 + k32] = b[:k32]
        return packed, bad

    def pack_bad16(bases, n_words, chunk=chunk):
        g = np.asarray(bases)
        out = np.full(n_words, 0x55555555, dtype=np.uint32)  # all-bad padding
        for lo in range(0, g.shape[0], chunk):
            c = g[lo : lo + chunk]
            k16 = (c.shape[0] + 15) // 16
            out[lo // 16 : lo // 16 + k16] = whole_bad16(c, k16)
        return out

    assert chunk % 32 == 0
    g = np.random.default_rng(0).integers(0, 6, 10_007).astype(np.uint8)
    want_p, want_b = whole_words(g)
    got_p, got_b = pack_genome_words(g, chunk=96)
    assert np.array_equal(want_p, got_p) and np.array_equal(want_b, got_b)
    assert np.array_equal(whole_bad16(g, want_p.shape[0]),
                          pack_bad16(g, want_p.shape[0], chunk=96))
    JI.pack_genome_words = pack_genome_words
    JI.pack_bad16 = pack_bad16


def run_jax(directory: str, argvs: list, same_logq: bool, layout: str) -> dict:
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
    if layout == "hg38":
        chunked_jax_packers()
    cwd = os.getcwd()
    os.chdir(directory)
    t0 = time.time()
    try:
        for argv in argvs:
            assert jcli.main(argv) == 0, argv
    finally:
        os.chdir(cwd)
    return {"seconds": time.time() - t0, "devices": len(jax.devices())}


def run_torch(directory: str, argvs: list, n_devices: int) -> dict:
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
    devices = [torch.device("cpu")] * n_devices
    cwd = os.getcwd()
    os.chdir(directory)
    t0 = time.time()
    try:
        for argv in argvs:
            assert tcli.main(argv, device="cpu", devices=devices) == 0, argv
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


def side_main(args) -> None:
    """One side's command group in this process; prints its JSON line."""
    argvs = json.loads(args.argvs)
    d = os.path.join(args.workdir, args.side)
    if args.side == "port":
        out = run_torch(d, argvs, args.devices)
    else:
        out = run_jax(d, argvs, args.same_logq == "on", args.layout)
    out["peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(out))


def run_side(args, work: str, side: str, argvs: list, devices: int = 1) -> dict:
    """A child process of this script running `argvs` on one side."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if side == "snap_tpu":
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    cmd = [sys.executable, os.path.abspath(__file__), "--side", side,
           "--workdir", work, "--argvs", json.dumps(argvs), "--devices", str(devices),
           "--layout", args.layout, "--same-logq", args.same_logq]
    r = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, check=True)
    return json.loads(r.stdout.decode().strip().splitlines()[-1])


def main() -> None:
    from chip_smoke import CHR21_BP

    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", choices=("flat", "hg38"), default="flat")
    ap.add_argument("--genome-len", type=int, default=2_000_000,
                    help="the flat layout's genome length")
    ap.add_argument("--chr21-len", type=int, default=CHR21_BP,
                    help="the hg38 layout's chr21 window length")
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--pairs", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--config", help="a benchmark configuration's genome (with --traffic)")
    ap.add_argument("--traffic", help="a benchmark traffic file's reads and options")
    ap.add_argument("--same-logq", choices=("on", "off"), default="on")
    ap.add_argument("--sides", default="port,snap_tpu",
                    help="which packages run (the comparison needs both)")
    ap.add_argument("--workdir", help="keep the inputs and outputs here")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--argvs", help=argparse.SUPPRESS)
    ap.add_argument("--devices", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        side_main(args)
        return

    work = args.workdir or tempfile.mkdtemp(prefix="parity_")
    sides = args.sides.split(",")
    inputs = os.path.join(work, "inputs")
    os.makedirs(inputs, exist_ok=True)
    b = ["-b", str(args.batch)]
    t0 = time.time()
    if args.traffic:
        config, tr = bench_file("configs", args.config), bench_file("traffic", args.traffic)
        write_bench_inputs(inputs, config, tr, args.reads)
        groups = {"main": [["index", "g.fa", "idx", *config["index_options"]],
                           ["single", "idx", "r.fq", "-o", "single.sam", *b, *tr["options"]]]}
        sams = ["single"]
    else:
        write_inputs(inputs, args)
        groups = {"main": [["index", "g.fa", "idx", "-s", "24"],
                           ["single", "idx", "r.fq", "-o", "single.sam", *b],
                           ["paired", "idx", "r1.fq", "r2.fq", "-o", "paired.sam", *b]]}
        if args.layout == "hg38":
            groups["ishards2"] = [["single", "idx", "r.fq", "-o", "ishards2.sam", *b,
                                   "-ishards", "2"]]
        sams = ["single", "paired"] + (["ishards2"] if args.layout == "hg38" else [])
    inputs_s = time.time() - t0
    for side in sides:  # the same inputs, linked into each side's directory
        os.makedirs(os.path.join(work, side), exist_ok=True)
        for f in INPUTS:
            link = os.path.join(work, side, f)
            if os.path.exists(os.path.join(inputs, f)) and not os.path.lexists(link):
                os.symlink(os.path.join(inputs, f), link)
    runs = {side: {g: run_side(args, work, side, argvs, 2 if g == "ishards2" else 1)
                   for g, argvs in groups.items()} for side in sides}
    out = {
        "layout": args.layout, "reads": args.reads, "pairs": args.pairs,
        "batch": args.batch, "same_logq": args.same_logq, "workdir": work,
        "inputs_s": inputs_s, "runs": runs,
    }
    if args.traffic:
        out.update(config=args.config, traffic=args.traffic, pairs=0)
    elif args.layout == "hg38":
        from chip_smoke import HG38_BP, hg38_summary

        out.update(genome_bp=HG38_BP, chr21_len=args.chr21_len)
        out["truth"] = {side: {s: hg38_summary(os.path.join(work, side, f"{s}.sam"))
                               for s in sams} for side in sides}
    else:
        out["genome_len"] = args.genome_len
    if len(sides) == 2:
        for s in sams:
            out[s] = differing(*(os.path.join(work, side, f"{s}.sam")
                                 for side in ("snap_tpu", "port")))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
